// Connected-component labeling and Canny hysteresis reach on Hopper.
//
// Replaces the TPU kernels `_cc_kernel` (cartseg_tpu/ops/pallas/cc.py:170)
// and `_reach_kernel` (cartseg_tpu/ops/pallas/cc.py:181). Both ran a
// min-propagation fixpoint with one image's whole [H,W] label plane and
// its working planes resident in VMEM (several MB at 512x512). An SM has
// at most 227 KB of shared memory, so that layout does not carry over.
//
// What bounds it on this card: the bytes are few (a 1-byte mask in, a
// 4-byte label or a 1-byte flag out: 0.025 / 0.015 ms at [64,512,512] at
// 3.35 TB/s); the time goes to latency, the dependent steps of each block
// (loads, unions, flattening, the chases through the forest where tiles
// meet) and the gaps between dependent launches.
//
// Design: union-find inside the SM; device memory only where tiles meet.
// A planner (ops/cuda/cc.py `plan`) cuts each image into tiles of R rows
// by C columns (C = W up to 1024 columns: strips; 32 x 512 at 512^2, three
// 512-thread blocks an SM). Union-find roots are always the smaller index,
// so every root is its component's minimum flat index (h*W + w): exactly
// the JAX label (cc.py:176, :196-202), bit for bit and deterministic
// although the link order is not.
//   cc_tiles: one block a tile. It reads the mask with 16-byte loads into
//     a bitmask, gives each foreground pixel its run's first pixel (bit
//     scans; no per-pixel unions), unites runs with the row above in
//     shared memory (atomicMin; a run's first pixel takes the runs over
//     it, a later pixel only a run that starts over it) and flattens the
//     run starts; each root's own entry then holds its record, so one
//     int32 a pixel is all the shared memory a tile needs beside its bits.
//     Index arithmetic comes from blockIdx (image, tile), none per pixel.
//     Pass 1 writes, for the pixels on sides that face another tile, a
//     link to their tile root into device memory (CC: the output plane
//     itself, H*W on background; reach: a slot array of the tile sides,
//     -1 on background). Pass 3 recomputes the tile's labels from the
//     mask (cheaper than storing and rereading them), resolves each tile
//     root that touches such a side once through the global forest, and
//     writes the tile's output.
//   cc_borders: one thread a pixel of the rows and columns where tiles
//     meet: it unites its tile-run with the other side's tile-runs by the
//     same first-pixel rule (runs cut at tile edges, so every union joins
//     two tile-local components), smaller root wins, through L2 atomics.
// Finds hang the nodes they pass under their grandparents, which keeps
// the forests shallow that min-index linking (no rank) would leave deep.
// cc_borders and pass 3 start early by programmatic dependent launch and
// wait for the launch before them only where they first need its memory:
// pass 3 labels its tile while cc_borders runs. An image that fits one
// tile runs pass 3 alone: 1 launch, else 3.
//
// Reach labels `weak` (8-connectivity) with one extra node 0, smaller than
// every pixel: each seed (weak & strong) unites its run with node 0, in
// shared memory and, through the slot of a side pixel of a seeded
// component, in the global forest. A pixel is reached when its root is
// node 0: `_reach_kernel`'s `fg & (lab == 0)` (cc.py:186-189), bit for
// bit. Pass 1 writes every pixel's local answer; pass 3 labels a tile
// again only when a component on its sides without a seed of its own
// reaches node 0 through another tile. It writes no int32 label plane and
// needs no memset; the slots are 4 (2C + 2R) bytes a tile.
//
// Measured history (NVIDIA H100 80GB HBM3, 700 W, [64,512,512]): a first
// version that united every pixel with W and N took 34.5 ms on all-fg
// masks; the first port's union-find in device memory, one thread a
// pixel over three passes (reach: six and a memset, through an int32
// label plane), took 0.30 ms for CC on all-fg masks, 0.66 on mixed
// masks and 0.48 for reach on Canny maps. This design, against that one
// in one call (tools/cc_timing.py, parent change change parent): CC
// 0.106 ms on all-fg masks (from 0.299), 0.092 on blobs (0.185), 0.296
// on mixed masks (0.664), reach 0.143 on Canny maps (0.479).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;              // cc_tiles: 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBorderThreads = 256;
constexpr int kMaxSmem = 232448;           // an sm_90 block's dynamic smem
constexpr unsigned kFull = 0xffffffffu;
// After the flatten step a root's own entry holds its record, a negative
// value (a pixel's entry holds its run start, >= 1); background pixels have
// no entry: every reader tests the tile's bitmask first
constexpr int kFree = -2;                  // a root no side pixel claimed
constexpr int kClaimed = -3;               // pass 3, CC: then -3 - label
constexpr int kReached = -4;               // pass 3, reach: else kNotReached
constexpr int kNotReached = -5;

struct Geometry {
  int H, W, R, C;   // image, tile
  int nty, ntx;     // tiles down and across
  int words;        // 32-bit words of a tile row's bitmask
  int stride;       // reach: slots of one tile's sides
};

// ---------------------------------------------------------------- forests

// Every parent is at most its child and in the child's set, so a find
// may hang each node it passes under its grandparent (intermediate
// pointer jumping, as ECL-CC): concurrent finds then halve each other's
// paths, which min-index linking, having no rank, would leave deep.
// Parent reads in device memory go through L2 (__ldcg): atomics update
// L2, and a stale L1 copy would only cost retries. CC's last pass finds
// without jumping: its forest is the label plane, which other blocks are
// then overwriting with final labels.
template <bool kJump = true>
__device__ __forceinline__ int find_root(int* par, int x) {
  int p = __ldcg(par + x);
  if (p == x) return x;
  int next;
  while (p > (next = __ldcg(par + p))) {
    if (kJump) par[x] = next;
    x = p;
    p = next;
  }
  return p;
}

__device__ __forceinline__ void unite(int* par, int a, int b) {
  a = find_root(par, a);
  b = find_root(par, b);
  while (a != b) {
    if (a < b) {
      int t = a;
      a = b;
      b = t;
    }
    // a > b: hang root a under b. If a stopped being a root meanwhile,
    // atomicMin returns its new parent (< a) and the merge continues
    // from there; values only ever decrease, so this terminates.
    int old = atomicMin(par + a, b);
    if (old == a) return;
    a = find_root(par, old);
    b = find_root(par, b);
  }
}

// The same in shared memory: volatile accesses see other warps' links.
// A pixel's own entry keeps pointing at its run's start, and the finds of
// the flatten step do not jump (a jump there could hang a start that
// another thread has just flattened under a node above its root), so
// after it the root of pixel id is par[par[id]].
template <bool kJump>
__device__ __forceinline__ int sfind(volatile int* par, int x) {
  int p = par[x];
  if (p == x) return x;
  int next;
  while (p > (next = par[p])) {
    if (kJump) par[x] = next;
    x = p;
    p = next;
  }
  return p;
}

// unite the sets of pixels (or node 0) a and b; the finds start at their
// run starts
__device__ __forceinline__ void sunite(int* par, int a, int b) {
  volatile int* v = par;
  a = sfind<true>(v, v[a]);
  b = sfind<true>(v, v[b]);
  while (a != b) {
    if (a < b) {
      int t = a;
      a = b;
      b = t;
    }
    int old = atomicMin(par + a, b);
    if (old == a) return;
    a = sfind<true>(v, old);
    b = sfind<true>(v, b);
  }
}

// Programmatic dependent launch (sm_90): a kernel launched after another
// with programmatic stream serialization may start once every block of
// the one before has released it, and waits for that one's end and its
// memory where it first needs them. Both are no-ops in a plain launch.
__device__ __forceinline__ void release_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" :::);
}

__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// ------------------------------------------------------------- bit moves

// bit j = byte j != 0, for the 4 bytes of w
__device__ __forceinline__ uint32_t nibble(uint32_t w) {
  uint32_t t = __vcmpne4(w, 0u) & 0x01010101u;
  return (t * 0x01020408u) >> 24;
}

// byte j = bit j, for the 4 bits of m
__device__ __forceinline__ uint32_t bytes4(uint32_t m) {
  return (m * 0x00204081u) & 0x01010101u;
}

// bits of row[x .. x+16), columns >= n as 0; one 16-byte load when `vec`
// (row + x is then 16-byte aligned)
__device__ __forceinline__ uint32_t load16(const uint8_t* row, int x, int n,
                                           bool vec) {
  if (x >= n) return 0;
  if (vec && x + 16 <= n) {
    uint4 v = __ldg(reinterpret_cast<const uint4*>(row + x));
    return nibble(v.x) | nibble(v.y) << 4 | nibble(v.z) << 8 |
           nibble(v.w) << 12;
  }
  uint32_t m = 0;
  for (int j = 0; j < 16 && x + j < n; ++j)
    m |= (uint32_t)(row[x + j] != 0) << j;
  return m;
}

__device__ __forceinline__ void store16(uint8_t* row, int x, int n,
                                        uint32_t m, bool vec) {
  if (x >= n) return;
  if (vec && x + 16 <= n) {
    *reinterpret_cast<uint4*>(row + x) =
        make_uint4(bytes4(m & 15u), bytes4(m >> 4 & 15u),
                   bytes4(m >> 8 & 15u), bytes4(m >> 12 & 15u));
    return;
  }
  for (int j = 0; j < 16 && x + j < n; ++j) row[x + j] = (uint8_t)(m >> j & 1u);
}

// The i-th pixel of the tile's sides that face another tile: top row,
// bottom row, left column, right column, in that order. Its (r, c) and its
// slot within the tile's sides; false for a side at the image's edge.
__device__ __forceinline__ bool side_pixel(int i, int rows, int cols,
                                           const Geometry& g, int ty, int tx,
                                           int& r, int& c, int& slot) {
  if (i < cols) {
    r = 0, c = i, slot = i;
    return ty > 0;
  }
  if (i < 2 * cols) {
    r = rows - 1, c = i - cols, slot = g.C + c;
    return ty + 1 < g.nty;
  }
  if (i < 2 * cols + rows) {
    r = i - 2 * cols, c = 0, slot = 2 * g.C + r;
    return tx > 0;
  }
  r = i - 2 * cols - rows, c = cols - 1, slot = 2 * g.C + g.R + r;
  return tx + 1 < g.ntx;
}

// ------------------------------------------------------------- cc_tiles

// One block a tile. final_pass 0: link the sides' pixels to their tile
// roots in device memory (pass 1). final_pass 1: resolve and write the
// tile's output (pass 3). CC: lab is the [B,H,W] output and, between the
// passes, the global forest. Reach: fg = weak, seed = strong, slots the
// [B, nslots] forest of the sides, out the [B,H,W] result.
template <bool kConn8, bool kReach>
__global__ void __launch_bounds__(kThreads)
cc_tiles(const uint8_t* __restrict__ fg, const uint8_t* __restrict__ seed,
         int* lab, int* slots, uint8_t* __restrict__ out, Geometry g,
         int nslots, int final_pass, int aligned) {
  extern __shared__ uint32_t smem[];
  const int R = g.R, C = g.C, W = g.W, WW = g.words;
  const int tiles = g.nty * g.ntx;
  const int b = blockIdx.x / tiles;
  const int ti = blockIdx.x - b * tiles;
  const int ty = ti / g.ntx, tx = ti - ty * g.ntx;
  const int y0 = ty * R, x0 = tx * C;
  const int rows = min(R, g.H - y0), cols = min(C, W - x0);
  const long long img = (long long)b * g.H * W;
  const bool vec = aligned && W % 16 == 0 && x0 % 16 == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // bits: the mask, a row of WW words; sbits: reach's seeds (weak &
  // strong); par: the forest over node 0 and pixel ids r*C + c + 1
  uint32_t* bits = smem;
  uint32_t* sbits = bits + R * WW;
  int* par = reinterpret_cast<int*>(sbits + (kReach ? R * WW : 0));
  volatile int* vpar = par;
  if (threadIdx.x == 0) par[0] = 0;
  if (!final_pass) release_dependents();
  // reach: the slots of this tile's sides
  int* uimg = slots + (long long)b * nslots;
  const int sbase = 1 + ti * g.stride;
  const int sides = 2 * cols + 2 * rows;

  if (kReach && final_pass && tiles > 1) {
    // 0. pass 3 of reach: pass 1 wrote each pixel's local answer, so
    // the tile needs labelling again only when a component on a side that
    // holds no seed of its own reaches node 0 through the forest
    __shared__ int relabel;
    if (threadIdx.x == 0) relabel = 0;
    wait_prior_grid();
    __syncthreads();
    for (int i = threadIdx.x; i < sides; i += kThreads) {
      int r, c, slot;
      if (!side_pixel(i, rows, cols, g, ty, tx, r, c, slot)) continue;
      int s = sbase + slot;
      if (__ldcg(uimg + s) >= 0 &&
          !out[img + (long long)(y0 + r) * W + x0 + c] &&
          find_root(uimg, s) == 0)
        relabel = 1;
    }
    __syncthreads();
    if (!relabel) return;
  }

  // 1. a warp a row: the mask's bits by 16-byte loads (lane l: 16
  // columns), then each pixel's run start from the bits
  for (int r = warp; r < rows; r += kWarps) {
    const long long off = img + (long long)(y0 + r) * W + x0;
    for (int cx = 0; cx < C; cx += 512) {
      int x = cx + 16 * lane;
      uint32_t m = load16(fg + off, x, cols, vec);
      uint32_t word = m | __shfl_down_sync(kFull, m, 1) << 16;
      uint32_t s = 0;
      if (kReach) {
        uint32_t sm = load16(seed + off, x, cols, vec);
        s = (sm | __shfl_down_sync(kFull, sm, 1) << 16) & word;
      }
      if (!(lane & 1) && x < C) {
        bits[r * WW + (x >> 5)] = word;
        if (kReach) sbits[r * WW + (x >> 5)] = s;
      }
    }
    __syncwarp();
    int carry = 0;              // the start of a run entering word w
    for (int w = 0; w < WW; ++w) {
      uint32_t word = bits[r * WW + w];
      uint32_t bg = ~word;
      uint32_t upto = bg & (kFull >> (31 - lane));      // lanes 0..lane
      int start = upto ? 32 * w + 32 - __clz(upto) : carry;
      int c = 32 * w + lane;
      if (c < cols && (word >> lane & 1u))
        par[r * C + c + 1] = r * C + start + 1;
      if (bg) carry = 32 * w + 32 - __clz(bg);
    }
  }
  __syncthreads();

  // 2. unite each run with the runs of the row above that touch it: N
  // for 4-connectivity; for 8, a run's first pixel takes N, else NW and
  // NE, a later pixel only a run that starts at its NE. Reach: the first
  // pixel of each stretch of seeds takes node 0.
  for (int i = threadIdx.x; i < (rows - 1) * WW; i += kThreads) {
    int r = i / WW + 1, w = i - (r - 1) * WW;
    const uint32_t* cu = bits + r * WW;
    const uint32_t* up = cu - WW;
    uint32_t cur = cu[w], u = up[w];
    uint32_t left = cur << 1 | (w ? cu[w - 1] >> 31 : 0u);
    uint32_t ul = u << 1 | (w ? up[w - 1] >> 31 : 0u);
    uint32_t ur = u >> 1 | (w + 1 < WW ? up[w + 1] << 31 : 0u);
    int id0 = r * C + 32 * w + 1;
    if (!kConn8) {
      for (uint32_t m = cur & u & ~(left & ul); m; m &= m - 1) {
        int id = id0 + __ffs(m) - 1;
        sunite(par, id, id - C);
      }
    } else {
      uint32_t first = cur & ~left;
      for (uint32_t m = first & u; m; m &= m - 1) {
        int id = id0 + __ffs(m) - 1;
        sunite(par, id, id - C);
      }
      for (uint32_t m = first & ~u & ul; m; m &= m - 1) {
        int id = id0 + __ffs(m) - 1;
        sunite(par, id, id - C - 1);
      }
      for (uint32_t m = cur & ~u & ur; m; m &= m - 1) {
        int id = id0 + __ffs(m) - 1;
        sunite(par, id, id - C + 1);
      }
    }
  }
  if (kReach) {
    for (int i = threadIdx.x; i < rows * WW; i += kThreads) {
      int r = i / WW, w = i - r * WW;
      uint32_t s = sbits[i];
      uint32_t first = s & ~(s << 1 | (w ? sbits[i - 1] >> 31 : 0u));
      for (; first; first &= first - 1)
        sunite(par, r * C + 32 * w + __ffs(first), 0);
    }
  }
  __syncthreads();

  // 3. flatten the run starts: the root of pixel id is then
  // par[par[id]] (a start's own entry is its root)
  for (int i = threadIdx.x; i < rows * WW; i += kThreads) {
    int r = i / WW, w = i - r * WW;
    uint32_t cur = bits[i];
    uint32_t m = cur & ~(cur << 1 | (w ? bits[i - 1] >> 31 : 0u));
    for (; m; m &= m - 1) {
      int id = r * C + 32 * w + __ffs(m);
      par[id] = sfind<false>(vpar, id);
    }
  }
  __syncthreads();

  // 4. each root's own entry becomes its record: kFree, or for reach's
  // pass 1 INT_MIN, below -2 - slot for every slot; a pixel's root is then
  // `root_of`
  const int fresh = (kReach && !final_pass) ? INT_MIN : kFree;
  for (int i = threadIdx.x; i < rows * WW; i += kThreads) {
    int r = i / WW, w = i - r * WW;
    uint32_t cur = bits[i];
    uint32_t m = cur & ~(cur << 1 | (w ? bits[i - 1] >> 31 : 0u));
    for (; m; m &= m - 1) {
      int id = r * C + 32 * w + __ffs(m);
      if (par[id] == id) par[id] = fresh;
    }
  }
  if (threadIdx.x == 0) par[0] = fresh;
  __syncthreads();
  // the root of foreground pixel id: its start's entry, unless the start
  // or the pixel is the root itself
  auto root_of = [&](int id) {
    int v = par[id];
    if (v < 0) return id;
    int w = par[v];
    return w < 0 ? v : w;
  };
  auto on_fg = [&](int r, int c) {
    return bits[r * WW + (c >> 5)] >> (c & 31) & 1u;
  };

  // pass 3 has labelled its tile while cc_borders ran: only now does it
  // need the forest
  if (final_pass) wait_prior_grid();
  const int n = g.H * W;
  // image-local flat index of tile id t (t >= 1)
  auto flat = [&](int t) {
    int loc = t - 1;
    if (C == W) return y0 * W + loc;
    int rt = loc / C;
    return (y0 + rt) * W + x0 + (loc - rt * C);
  };

  if (!kReach) {
    int* limg = lab + img;
    if (!final_pass) {
      // 4. pass 1: the sides' pixels link to their tile root, H*W on
      // background; the first to reach a root makes it a root of the
      // global forest
      for (int i = threadIdx.x; i < sides; i += kThreads) {
        int r, c, slot;
        if (!side_pixel(i, rows, cols, g, ty, tx, r, c, slot)) continue;
        int f = (y0 + r) * W + x0 + c;
        if (!on_fg(r, c)) {
          limg[f] = n;
          continue;
        }
        int t = root_of(r * C + c + 1);
        int ft = flat(t);
        limg[f] = ft;
        if (atomicCAS(par + t, kFree, kClaimed) == kFree) limg[ft] = ft;
      }
      return;
    }
    // 4. pass 3: each tile root on such a side is resolved once; its
    // record then holds -3 - its global root
    for (int i = threadIdx.x; i < sides; i += kThreads) {
      int r, c, slot;
      if (!side_pixel(i, rows, cols, g, ty, tx, r, c, slot)) continue;
      if (!on_fg(r, c)) continue;
      int t = root_of(r * C + c + 1);
      if (atomicCAS(par + t, kFree, kClaimed) == kFree)
        par[t] = kClaimed - find_root<false>(limg, flat(t));
    }
    __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {
      int* orow = limg + (long long)(y0 + r) * W + x0;
      for (int c = lane; c < cols; c += 32) {
        int o = n;
        if (on_fg(r, c)) {
          int t = root_of(r * C + c + 1);
          int a = par[t];
          o = a == kFree ? flat(t) : kClaimed - a;
        }
        orow[c] = o;
      }
    }
    return;
  }

  // reach's output, a warp a row: lanes gather 32 pixels a ballot, then
  // store 16 bytes; pass 1 writes each pixel's local answer (its root is
  // node 0), pass 3 the global one
  auto write_out = [&]() {
    for (int r = warp; r < rows; r += kWarps) {
      uint8_t* orow = out + img + (long long)(y0 + r) * W + x0;
      for (int cx = 0; cx < cols; cx += 512) {
        uint32_t mine = 0;
        for (int j = 0; j < 16; ++j) {
          int c = cx + 32 * j + lane;
          bool on = false;
          if (c < cols && on_fg(r, c)) {
            int t = root_of(r * C + c + 1);
            on = t == 0 || (final_pass && par[t] == kReached);
          }
          uint32_t word = __ballot_sync(kFull, on);
          if ((lane >> 1) == j) mine = word;
        }
        store16(orow, cx + 16 * lane, cols,
                mine >> (16 * (lane & 1)) & 0xffffu, vec);
      }
    }
  };
  if (!final_pass) {
    // 4. pass 1: each tile-local component on a side takes its smallest
    // slot as representative; the other slots link to it, and it links to
    // node 0 when the component holds a seed
    for (int i = threadIdx.x; i < sides; i += kThreads) {
      int r, c, slot;
      if (!side_pixel(i, rows, cols, g, ty, tx, r, c, slot)) continue;
      if (on_fg(r, c))
        atomicMax(par + root_of(r * C + c + 1), -2 - (sbase + slot));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < sides; i += kThreads) {
      int r, c, slot;
      if (!side_pixel(i, rows, cols, g, ty, tx, r, c, slot)) continue;
      int s = sbase + slot;
      if (!on_fg(r, c)) {
        uimg[s] = -1;
        continue;
      }
      int t = root_of(r * C + c + 1);
      int rep = -2 - par[t];
      uimg[s] = s != rep ? rep : (t == 0 ? 0 : s);
    }
    if (ti == 0 && threadIdx.x == 0) uimg[0] = 0;
    write_out();
    return;
  }
  // 4. pass 3: a tile root on a side is reached when its global root is
  // node 0; a root that is node 0 is reached
  for (int i = threadIdx.x; i < sides; i += kThreads) {
    int r, c, slot;
    if (!side_pixel(i, rows, cols, g, ty, tx, r, c, slot)) continue;
    if (!on_fg(r, c)) continue;
    int t = root_of(r * C + c + 1);
    if (t != 0 && atomicCAS(par + t, kFree, kClaimed) == kFree)
      par[t] = find_root(uimg, sbase + slot) == 0 ? kReached : kNotReached;
  }
  __syncthreads();
  write_out();
}

// ------------------------------------------------------------ cc_borders

// One thread a pixel of the first row of every tile row but the first
// (against the row above) and of the first column of every tile column
// but the first (against the column to its left). Along such a line,
// runs are cut at the tiles' edges; the first pixel of a run unites with
// each distinct run of the other side among its 3 neighbours (N alone for
// 4-connectivity), a later pixel only with a run that starts at its next
// neighbour. Each union joins two tile-local components, and every
// adjacent pair of them across the line gets one.
template <bool kConn8, bool kReach>
__global__ void __launch_bounds__(kBorderThreads)
cc_borders(int* forest, Geometry g, int nslots, long long total,
           long long per_img) {
  release_dependents();
  wait_prior_grid();
  long long gi = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (gi >= total) return;
  const int b = (int)(gi / per_img);
  long long i = gi - b * per_img;
  const int H = g.H, W = g.W, R = g.R, C = g.C;
  const long long nh = (long long)(g.nty - 1) * W;
  const bool horiz = i < nh;
  int k, pos, N, S;
  if (horiz) {
    k = (int)(i / W) + 1;                  // the tile row below the line
    pos = (int)(i - (long long)(k - 1) * W);
    N = W, S = C;
  } else {
    i -= nh;
    k = (int)(i / H) + 1;                  // the tile column right of it
    pos = (int)(i - (long long)(k - 1) * H);
    N = H, S = R;
  }
  int* base = forest + (kReach ? (long long)b * nslots : (long long)b * H * W);
  // the entry of position p on the line's lower / right side (near) or
  // upper / left side (far)
  auto entry = [&](bool near, int p) -> int {
    if (!kReach) {
      return horiz ? (near ? k * R : k * R - 1) * W + p
                   : p * W + (near ? k * C : k * C - 1);
    }
    if (horiz) {
      int tx = p / C;
      int ty = near ? k : k - 1;
      return 1 + (ty * g.ntx + tx) * g.stride + (near ? 0 : C) + (p - tx * C);
    }
    int ty = p / R;
    int tx = near ? k : k - 1;
    return 1 + (ty * g.ntx + tx) * g.stride + 2 * C + (near ? 0 : R) +
           (p - ty * R);
  };
  const int bg = kReach ? -1 : H * W;
  // a foreground entry only ever moves between foreground values, so a
  // stale L1 copy answers this as well
  auto on = [&](int e) { return base[e] != bg; };
  const int ln = entry(true, pos);
  if (!on(ln)) return;
  const bool sl = pos % S != 0;                 // pos - 1 in pos's tile
  const bool sr = pos + 1 < N && (pos + 1) % S != 0;
  const bool u = on(entry(false, pos));
  const bool ul = pos > 0 && on(entry(false, pos - 1));
  const bool ur = pos + 1 < N && on(entry(false, pos + 1));
  const bool ll = sl && on(entry(true, pos - 1));
  bool linked = false;
  auto link = [&](int d) {
    unite(base, ln, entry(false, pos + d));
    linked = true;
  };
  if (!kConn8) {
    if (u && !(ll && ul)) link(0);
  } else if (!ll) {                             // first pixel of its run
    if (u) {
      link(0);
      if (ul && !sl) link(-1);
      if (ur && !sr) link(1);
    } else {
      if (ul) link(-1);
      if (ur) link(1);
    }
  } else if (ur && (!u || !sr)) {
    link(1);
  }
  // CC's last pass walks this forest without jumping: one more find from
  // every linked pixel, once every link of this thread is in, halves the
  // chains that concurrent links left
  if (!kReach && linked) find_root(base, ln);
}

size_t tile_smem(int R, int C, bool reach) {
  size_t words = (size_t)R * ((C + 31) / 32);
  return 4 * (words * (reach ? 2 : 1) + (size_t)R * C + 1);
}

// launch kernel after the stream's last one, with programmatic stream
// serialization
template <typename... Params, typename... Args>
cudaError_t launch_after(void (*kernel)(Params...), unsigned grid,
                         int threads, size_t smem, cudaStream_t s,
                         Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <bool kConn8, bool kReach>
int run(const uint8_t* fg, const uint8_t* seed, int* lab, int* slots,
        uint8_t* out, int B, int H, int W, int R, int C, int nslots,
        int aligned, cudaStream_t s) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
  if (R <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  Geometry g{H, W, R, C, (H + R - 1) / R, (W + C - 1) / C, (C + 31) / 32, 0};
  g.stride = 2 * C + (g.ntx > 1 ? 2 * R : 0);
  const int tiles = g.nty * g.ntx;
  const size_t smem = tile_smem(R, C, kReach);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (kReach && (1 + (long long)tiles * g.stride > nslots ||
                 nslots >= INT_MAX))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      cc_tiles<kConn8, kReach>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((long long)B * tiles);
  if (tiles == 1) {
    cc_tiles<kConn8, kReach><<<blocks, kThreads, smem, s>>>(
        fg, seed, lab, slots, out, g, nslots, 1, aligned);
    return (int)cudaGetLastError();
  }
  cc_tiles<kConn8, kReach><<<blocks, kThreads, smem, s>>>(
      fg, seed, lab, slots, out, g, nslots, 0, aligned);
  long long per = (long long)(g.nty - 1) * W + (long long)(g.ntx - 1) * H;
  long long total = per * B;
  e = launch_after(cc_borders<kConn8, kReach>,
                   (unsigned)((total + kBorderThreads - 1) / kBorderThreads),
                   kBorderThreads, 0, s, kReach ? slots : lab, g, nslots,
                   total, per);
  if (e != cudaSuccess) return (int)e;
  e = launch_after(cc_tiles<kConn8, kReach>, blocks, kThreads, smem, s, fg,
                   seed, lab, slots, out, g, nslots, 1, aligned);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* cartseg_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

// fg: [B,H,W] bool; labels: [B,H,W] int32 out; tiles of R x C (plan())
extern "C" int cartseg_cc_label(const uint8_t* fg, int* labels, int B, int H,
                                int W, int connectivity, int R, int C,
                                int aligned, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return connectivity == 8
             ? run<true, false>(fg, nullptr, labels, nullptr, nullptr, B, H,
                                W, R, C, 0, aligned, s)
             : run<false, false>(fg, nullptr, labels, nullptr, nullptr, B, H,
                                 W, R, C, 0, aligned, s);
}

// weak, strong: [B,H,W] bool; slots: [B, nslots] int32 scratch; out:
// [B,H,W] bool; tiles of R x C (plan(..., reach=True))
extern "C" int cartseg_reach(const uint8_t* weak, const uint8_t* strong,
                             int* slots, uint8_t* out, int B, int H, int W,
                             int R, int C, int nslots, int aligned,
                             void* stream) {
  return run<true, true>(weak, strong, nullptr, slots, out, B, H, W, R, C,
                         nslots, aligned, (cudaStream_t)stream);
}
