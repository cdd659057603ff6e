// Exact Euclidean distance transform (Felzenszwalb & Huttenlocher,
// "Distance Transforms of Sampled Functions") — the native host oracle
// for the on-device jump-flood EDT, and the fast path for offline mask
// tooling. Two separable 1-D passes of lower-envelope parabolas; exact
// (matches scipy.ndimage.distance_transform_edt) in O(N) per axis.
//
// Exposed C ABI (ctypes):
//   void edt_sq(const uint8_t* seeds, float* out_sq, int h, int w)
//     squared distance from every pixel to the nearest seeds!=0 pixel
//     (INF when there is no seed).

#include <cstdint>
#include <cstring>
#include <vector>
#include <cmath>
#include <limits>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr float INF = std::numeric_limits<float>::max() / 4.0f;

// 1-D squared distance transform of a sampled function f (in place via
// out); v/z are scratch of size n and n+1.
void dt1d(const float* f, float* out, int* v, float* z, int n) {
  int k = 0;
  v[0] = 0;
  z[0] = -INF;
  z[1] = INF;
  for (int q = 1; q < n; ++q) {
    float s;
    while (true) {
      int p = v[k];
      s = ((f[q] + q * (float)q) - (f[p] + p * (float)p)) / (2.0f * (q - p));
      if (s <= z[k]) {
        --k;
      } else {
        break;
      }
    }
    ++k;
    v[k] = q;
    z[k] = s;
    z[k + 1] = INF;
  }
  k = 0;
  for (int q = 0; q < n; ++q) {
    while (z[k + 1] < q) ++k;
    int p = v[k];
    out[q] = (q - p) * (float)(q - p) + f[p];
  }
}

}  // namespace

extern "C" {

void edt_sq(const uint8_t* seeds, float* out_sq, int h, int w) {
  std::vector<float> g((size_t)h * w);

  // column pass
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<float> f(h), d(h);
    std::vector<int> v(h);
    std::vector<float> z(h + 1);
#ifdef _OPENMP
#pragma omp for
#endif
    for (int x = 0; x < w; ++x) {
      for (int y = 0; y < h; ++y)
        f[y] = seeds[(size_t)y * w + x] ? 0.0f : INF;
      dt1d(f.data(), d.data(), v.data(), z.data(), h);
      for (int y = 0; y < h; ++y) g[(size_t)y * w + x] = d[y];
    }
  }

  // row pass
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<float> d(w);
    std::vector<int> v(w);
    std::vector<float> z(w + 1);
#ifdef _OPENMP
#pragma omp for
#endif
    for (int y = 0; y < h; ++y) {
      dt1d(&g[(size_t)y * w], d.data(), v.data(), z.data(), w);
      std::memcpy(&out_sq[(size_t)y * w], d.data(), w * sizeof(float));
    }
  }
}

}  // extern "C"
