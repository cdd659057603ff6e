"""Two of the port's kernels emulated on the CPU in their own order of
operations: the per-channel sums (ops/cuda/csrc/channel_sums.cu) and the
LSR forward's vector route (`lsr_fwd_vec`, ops/cuda/csrc/lsr.cu).

The sums: `plan`'s CTAs and columns, each row lane's walk over its rows
(UNROLL loads issued, then added in order; the remainder one by one),
the row lanes of a warp by down-shuffles, the warps (or, at tc >= 32,
the row lanes) in order, and the last CTA's fixed-order finish over the
P partial rows (float4 columns, J lanes each taking every J-th row, the
lanes in order). Held within 1e-5 of the per-channel sum of |.| against
`channel_sums_plain`, at the path's BN shapes scaled down, in both
memory orders and with narrowed columns forced through `_plan`; run
twice for the same bits, and on ones for an exact count of the elements
(every row or element summed once). The card holds the kernel itself
against `channel_sums_plain` (tests/test_torch_kernels_cuda.py).

The LSR forward: the C / 4 lanes of a row combine its max, its sum of
exp, its sum of x - max and its x - max at the label by xor-shuffles
(at C = 2 a lane holds two rows), and sum logp = sum(x - max) - C lse.
Held within 1e-5 against `lsr_fwd_plain` and the JAX package's Pallas
forward (`lsr_ce_pallas`, interpret mode on the CPU) at C in {2, 4, 8,
16}, with int32 and int64 labels, ignored rows and a label past C.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartseg_tpu.ops.pallas import lsr_ce_pallas

from cartseg_tpu_torch.ops.channel_sums import channel_sums_plain
from cartseg_tpu_torch.ops.cuda.channel_sums import (THREADS, UNROLL, Plan,
                                                     _plan, memory_order,
                                                     plan)
from cartseg_tpu_torch.ops.cuda.lsr import (VEC_CLASSES, lsr_fwd_plain,
                                            route)
from torch_port_helpers import one_torch_thread  # noqa: F401

WARPS = THREADS // 32
SUMS_TOL = 1e-5


def _fma(x: torch.Tensor, y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """fmaf(x, y, s) in fp32: the product of two fp32 values is exact in
    float64, so one float64 add and one rounding to fp32 (ties of that
    double rounding aside, far rarer than the tolerance needs)."""
    return (x.double() * y.double() + s.double()).float()


def _walk(xs: torch.Tensor, ys: torch.Tensor, same: bool):
    """A thread's (sum a, sum a*b) over its steps [steps, lanes..., V]:
    the main loop UNROLL steps at a time (the loads, then the adds in
    step order), then the remainder one step at a time; the adds of the
    two loops fall in step order. Returns the sums and the number of
    unrolled rounds and remainder steps."""
    steps = xs.shape[0]
    sa = torch.zeros(xs.shape[1:], dtype=torch.float32)
    sab = torch.zeros_like(sa)
    k = 0
    rounds = 0
    while k + UNROLL <= steps:
        chunk = [(xs[k + u], xs[k + u] if same else ys[k + u])
                 for u in range(UNROLL)]
        for x, y in chunk:
            sa = sa + x
            sab = _fma(x, y, sab)
        k += UNROLL
        rounds += 1
    rest = steps - k
    for k in range(k, steps):
        y = xs[k] if same else ys[k]
        sa = sa + xs[k]
        sab = _fma(xs[k], y, sab)
    return sa, sab, rounds, rest


def _down_shuffle(v: torch.Tensor) -> torch.Tensor:
    """[32 // tc, tc, ...] lanes of one warp (row lane j, group lane c at
    lane j * tc + c) -> [tc, ...]: __shfl_down_sync at offsets 16, 8, ...,
    tc, as the lanes below each offset add the lane that far above."""
    rows = v.shape[0]
    while rows > 1:
        rows //= 2
        v = v[:rows] + v[rows:2 * rows]
    return v[0]


def _finish(rows: torch.Tensor) -> torch.Tensor:
    """The last CTA of a column: rows [P, K] -> [K], float4 column q
    summed over p by J = 256 / span lanes each taking every J-th row from
    its own lane index, then the lanes in order (J = 1 where a chunk of
    256 float4 columns is full)."""
    P, K = rows.shape
    Q = K // 4
    out = torch.zeros(K, dtype=torch.float32)
    for q0 in range(0, Q, THREADS):
        span = min(Q - q0, THREADS)
        J = 1 if span == THREADS else THREADS // span
        cols = rows[:, 4 * q0:4 * (q0 + span)]
        lanes = []
        for j in range(J):
            t = torch.zeros(4 * span, dtype=torch.float32)
            for p in range(j, P, J):
                t = t + cols[p]
            lanes.append(t)
        t = lanes[0]
        for lane in lanes[1:]:
            t = t + lane
        out[4 * q0:4 * (q0 + span)] = t
    return out


def schedule_nhwc(a: torch.Tensor, b: torch.Tensor, p: Plan, same: bool):
    """The NHWC kernel on plan p -> ((sum a, sum a*b), unrolled rounds and
    remainder steps of the busiest lane)."""
    N, C, H, W = a.shape
    M, V, tc, R = N * H * W, p.vec, p.tc, p.rows
    G, Wd = C // V, p.width
    K = 2 * Wd
    ra = a.permute(0, 2, 3, 1).reshape(M, C).float()
    rb = b.permute(0, 2, 3, 1).reshape(M, C).float()
    rpb = -(-M // p.P)
    out = torch.zeros((2, C), dtype=torch.float32)
    walk = (0, 0)
    for y in range(p.gy):
        c0 = y * Wd
        lane_ch = torch.arange(c0, c0 + Wd)
        live = lane_ch < G * V                # groups g < G load
        part = torch.zeros((p.P, K), dtype=torch.float32)
        for cta in range(p.P):
            r0, r1 = cta * rpb, min(M, (cta + 1) * rpb)
            steps = max(0, -(-(r1 - r0) // R))
            # [steps, R, Wd]: row lane l at step k reads row r0 + l + k R
            idx = r0 + torch.arange(R)[None, :] + R * torch.arange(steps)[:, None]
            ok = (idx < r1)[..., None] & live
            safe = idx.clamp(max=M - 1)
            ch = lane_ch.clamp(max=C - 1)
            xs = torch.where(ok, ra[safe][..., ch], 0.0)
            ys = torch.where(ok, rb[safe][..., ch], 0.0)
            sa, sab, rounds, rest = _walk(xs, ys, same)
            walk = max(walk, (rounds, rest))
            if tc < 32:
                # warp w holds row lanes w * 32 / tc ... : shuffles, then
                # the warps in order
                per = 32 // tc
                red = [torch.stack([_down_shuffle(s[w * per:(w + 1) * per])
                                    for w in range(WARPS)])
                       for s in (sa, sab)]
            else:
                red = [sa, sab]
            row = []
            for r in red:
                t = torch.zeros(Wd, dtype=torch.float32)
                for lane in r:
                    t = t + lane
                row.append(t)
            part[cta] = torch.cat(row)
        total = _finish(part)
        for s in range(2):
            for w in range(Wd):
                if c0 + w < C:
                    out[s, c0 + w] = total[s * Wd + w]
    return (out[0], out[1]), walk


def _warp_sum(v: torch.Tensor) -> torch.Tensor:
    """[..., 32] -> [...]: __shfl_down_sync at 16, 8, 4, 2, 1, lane 0."""
    n = 32
    while n > 1:
        n //= 2
        v = v[..., :n] + v[..., n:2 * n]
    return v[..., 0]


def _block_sum(t: torch.Tensor) -> torch.Tensor:
    """[256] thread values -> the warps' shuffles, then warps in order."""
    w = _warp_sum(t.reshape(WARPS, 32))
    s = torch.zeros((), dtype=torch.float32)
    for x in w:
        s = s + x
    return s


def schedule_nchw(a: torch.Tensor, b: torch.Tensor, p: Plan, same: bool):
    """The NCHW kernel on plan p: CTA (q, c) sums channel c's elements
    [q L, (q + 1) L), thread t the vectors at t V + k 256 V."""
    N, C, H, W = a.shape
    HW, V = H * W, p.vec
    NHW = N * HW
    L = -(-(-(-NHW // p.P)) // V) * V
    step = THREADS * V
    out = torch.zeros((2, C), dtype=torch.float32)
    for c in range(C):
        xa = a[:, c].reshape(-1).float()
        xb = b[:, c].reshape(-1).float()
        rows = []
        for q in range(p.P):
            j0, j1 = q * L, min(NHW, (q + 1) * L)
            steps = max(0, -(-(j1 - j0) // step))
            j = j0 + (torch.arange(THREADS)[None, :, None] * V
                      + step * torch.arange(steps)[:, None, None]
                      + torch.arange(V)[None, None, :])
            ok = j < j1
            safe = j.clamp(max=NHW - 1)
            xs = torch.where(ok, xa[safe], 0.0)
            ys = torch.where(ok, xb[safe], 0.0)
            sa, sab, _, _ = _walk(xs, ys, same)      # [256, V]
            ta = torch.zeros(THREADS, dtype=torch.float32)
            tb = torch.zeros_like(ta)
            for i in range(V):
                ta = ta + sa[:, i]
                tb = tb + sab[:, i]
            rows.append((_block_sum(ta), _block_sum(tb)))
        for s in range(2):
            t = torch.zeros(THREADS, dtype=torch.float32)
            for q0 in range(0, p.P, THREADS):
                chunk = torch.stack([r[s] for r in rows[q0:q0 + THREADS]])
                t[:len(chunk)] = t[:len(chunk)] + chunk
            out[s, c] = _block_sum(t)
    return (out[0], out[1]), None


def schedule(a, b, p, same):
    return (schedule_nhwc if p.nhwc else schedule_nchw)(a, b, p, same)


def _inputs(shape, dtype, layout, seed):
    r = np.random.default_rng(seed)
    a = torch.from_numpy((r.standard_normal(shape) * 2 + 0.5)
                         .astype(np.float32)).to(dtype)
    b = torch.from_numpy(r.standard_normal(shape).astype(np.float32)
                         ).to(dtype)
    if layout == "nhwc":
        a = a.contiguous(memory_format=torch.channels_last)
        b = b.contiguous(memory_format=torch.channels_last)
    return a, b


def _close(got, a, b):
    want = channel_sums_plain(a, b)
    af, bf = a.float(), b.float()
    tol = (SUMS_TOL * af.abs().sum((0, 2, 3)),
           SUMS_TOL * (af * bf).abs().sum((0, 2, 3)))
    for g, w, t in zip(got, want, tol):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert bool(((g - w).abs() <= t).all()), float((g - w).abs().max())


# the path's BN inputs (resnet34-UNet, 512^2 bs6) scaled down: the
# decoder top's 16 channels, the stem's 64, layer3's 256, layer4's 512
SHAPES = [(2, 16, 24, 20), (2, 64, 16, 12), (2, 256, 4, 6), (1, 512, 3, 4)]


@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("shape", SHAPES)
def test_sums_schedule_equals_plain_twice(shape, layout, same):
    """At the plan the wrapper makes for these sizes, bf16 inputs, forced
    to several CTAs (MIN_LOADS 1) and narrow columns (a small finish)."""
    a, b = _inputs(shape, torch.bfloat16, layout, seed=sum(shape))
    if same:
        b = a
    assert memory_order(a) == layout
    p = _plan(shape, layout == "nhwc", (a.dtype, b.dtype), (256, 512), 4,
              1, 256)
    assert p.P * p.gy > 1
    got, _ = schedule(a, b, p, same)
    _close(got, a, b)
    again, _ = schedule(a, b, p, same)
    assert all(torch.equal(g, h) for g, h in zip(got, again))


@pytest.mark.parametrize("shape,dtypes,layout", [
    ((2, 16, 24, 20), (torch.float32,) * 2, "nhwc"),
    ((2, 24, 6, 5), (torch.bfloat16, torch.float32), "nhwc"),
    ((2, 24, 6, 5), (torch.float32, torch.bfloat16), "nchw"),
    ((2, 3, 7, 5), (torch.float32,) * 2, "nhwc"),      # one element a load
    ((3, 40, 5, 7), (torch.bfloat16,) * 2, "nhwc")])   # 5 groups in 8 lanes
def test_sums_schedule_types_and_ragged_groups(shape, dtypes, layout):
    """Mixed types (4 a load), C = 3 (one element a load) and a group
    count below the next power of two (idle group lanes), at the plan's
    own sizing and at one CTA a column."""
    r = np.random.default_rng(7)
    a = torch.from_numpy(r.standard_normal(shape).astype(np.float32)
                         ).to(dtypes[0])
    b = torch.from_numpy(r.standard_normal(shape).astype(np.float32)
                         ).to(dtypes[1])
    if layout == "nhwc":
        a = a.contiguous(memory_format=torch.channels_last)
        b = b.contiguous(memory_format=torch.channels_last)
    for p in (plan(shape, layout == "nhwc", dtypes, (256, 512)),
              _plan(shape, layout == "nhwc", dtypes, (256, 512), 2, 1, 64)):
        got, _ = schedule(a, b, p, False)
        _close(got, a, b)


@pytest.mark.parametrize("shape,sms,min_loads,finish,walk", [
    ((2, 16, 24, 20), 4, 1, 8192, (0, 1)),   # the remainder loop alone
    ((2, 16, 64, 40), 1, 8, 8192, (2, 2)),   # unrolled rounds, remainder
    ((2, 16, 64, 42), 1, 8, 8192, (2, 3)),
    ((1, 512, 8, 8), 1, 1, 8192, (1, 0)),    # tc 64: row lanes in order
    ((2, 64, 16, 16), 4, 1, 64, (0, 1))])    # columns narrowed to tc 1
def test_sums_schedule_counts_every_element_once(shape, sms, min_loads,
                                                 finish, walk):
    """On ones the schedule's sums are exact counts: N*H*W for every
    channel, whatever the CTAs, columns, unrolled rounds and remainder."""
    a = torch.ones(shape, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    p = _plan(shape, True, (a.dtype,) * 2, (256, 512), sms, min_loads,
              finish)
    (s, ss), got_walk = schedule(a, a, p, True)
    n = shape[0] * shape[2] * shape[3]
    assert torch.equal(s, torch.full((shape[1],), float(n)))
    assert torch.equal(ss, s)
    assert got_walk == walk


# ------------------------------------------------------------------- LSR

def schedule_lsr_fwd(x: torch.Tensor, labels: torch.Tensor, lb_smooth: float,
                     ignore: int) -> torch.Tensor:
    """`lsr_fwd_vec<C>`: [n, C] fp32 -> [n], lane by lane."""
    n, C = x.shape
    lb_pos, lb_neg = 1.0 - lb_smooth, lb_smooth / C
    lab = labels.long()
    if C == 2:
        m = torch.maximum(x[:, 0], x[:, 1])
        z = x - m[:, None]
        lse = torch.log(torch.exp(z[:, 0]) + torch.exp(z[:, 1]))
        sum_z = z[:, 0] + z[:, 1]
        z_l = torch.where(lab == 0, z[:, 0], z[:, 1])
        hit = (lab == 0) | (lab == 1)
    else:
        lanes = C // 4
        v = x.reshape(n, lanes, 4)                 # a float4 a lane
        m = v.amax(-1)
        o = 1
        while o < lanes:                           # xor-shuffle max
            m = torch.maximum(m, m[:, torch.arange(lanes) ^ o])
            o <<= 1
        z = v - m[..., None]
        e = torch.exp(z)
        s = (e[..., 0] + e[..., 1]) + (e[..., 2] + e[..., 3])
        sz = (z[..., 0] + z[..., 1]) + (z[..., 2] + z[..., 3])
        k = lab[:, None] - 4 * torch.arange(lanes)[None, :]
        zl = torch.zeros_like(s)
        for i in range(4):
            zl = torch.where(k == i, z[..., i], zl)
        o = 1
        while o < lanes:                           # xor-shuffle sums
            perm = torch.arange(lanes) ^ o
            s, sz, zl = s + s[:, perm], sz + sz[:, perm], zl + zl[:, perm]
            o <<= 1
        lse, sum_z, z_l = torch.log(s[:, 0]), sz[:, 0], zl[:, 0]
        hit = (lab >= 0) & (lab < C)
    sum_logp = sum_z - C * lse
    logp_l = torch.where(hit, z_l - lse, 0.0)
    loss = -(lb_neg * sum_logp + (lb_pos - lb_neg) * logp_l)
    return torch.where(lab == ignore, 0.0, loss)


@pytest.mark.parametrize("label_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("C", VEC_CLASSES)
def test_lsr_fwd_vec_lanes_equal_plain_and_jax(C, label_dtype):
    r = np.random.default_rng(C)
    n = 1030
    x = (r.standard_normal((n, C)) * 3).astype(np.float32)
    lab = r.integers(0, C, n)
    lab[::7] = 255
    lab[3] = C + 2                    # a label past C: no class term
    xt = torch.from_numpy(x)
    lt = torch.from_numpy(lab).to(label_dtype)
    assert route(xt) == "vector"
    got = schedule_lsr_fwd(xt, lt, 0.2, 255)
    plain = lsr_fwd_plain(xt, lt, 0.2, 255)
    assert (got - plain).abs().max() <= 1e-5
    jax_loss = np.asarray(lsr_ce_pallas(jnp.asarray(x),
                                        jnp.asarray(lab.astype(np.int32)),
                                        0.2, 255))
    assert np.abs(got.numpy() - jax_loss).max() <= 1e-5
    assert torch.all(got[::7] == 0)
