// Fused letterbox + resize — the host data-loader hot path.
//
// The reference's per-sample pipeline allocates a padded canvas, then a
// square canvas, then resizes (train_bce_dice.py:42-85 + cv2.resize) —
// three full-image passes and two temporaries per sample. This kernel
// produces each OUTPUT pixel directly: it inverts the resize+letterbox
// mapping and samples the source image once (bilinear, cv2
// INTER_LINEAR half-pixel convention; padding color where the inverse
// lands outside the content box). One pass, no temporaries, OpenMP
// over output rows.
//
// C ABI:
//   void letterbox_resize_u8(const uint8_t* src, int sh, int sw,
//                            uint8_t* dst, int dh, int dw,
//                            float side_ratio, uint8_t pad_r,
//                            uint8_t pad_g, uint8_t pad_b)
//   void resize_nearest_u8(const uint8_t* src, int sh, int sw,
//                          uint8_t* dst, int dh, int dw)  // 1 channel

#include <cstdint>
#include <cmath>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

void letterbox_resize_u8(const uint8_t* src, int sh, int sw,
                         uint8_t* dst, int dh, int dw,
                         float side_ratio, uint8_t pad_r, uint8_t pad_g,
                         uint8_t pad_b) {
  // reference integer geometry (LetterboxSpec): round() side padding,
  // floor-div centering
  const int side = (int)std::lround((double)sw * side_ratio);
  const int pw = sw + 2 * side;
  const int ph = sh;
  const int md = pw > ph ? pw : ph;
  const int x_off = (md - pw) / 2 + side;  // content box x0
  const int y_off = (md - ph) / 2;
  const uint8_t pad[3] = {pad_r, pad_g, pad_b};

  const double sx = (double)md / dw;
  const double sy = (double)md / dh;

#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int oy = 0; oy < dh; ++oy) {
    // cv2 INTER_LINEAR half-pixel centers: src = (dst + 0.5)*scale - 0.5
    double fy = (oy + 0.5) * sy - 0.5 - y_off;
    int y0 = (int)std::floor(fy);
    float wy = (float)(fy - y0);
    for (int ox = 0; ox < dw; ++ox) {
      double fx = (ox + 0.5) * sx - 0.5 - x_off;
      int x0 = (int)std::floor(fx);
      float wx = (float)(fx - x0);
      uint8_t* out = &dst[((size_t)oy * dw + ox) * 3];
      for (int c = 0; c < 3; ++c) {
        float acc = 0.0f;
        for (int dy2 = 0; dy2 < 2; ++dy2) {
          int yy = y0 + dy2;
          float wyy = dy2 ? wy : 1.0f - wy;
          for (int dx2 = 0; dx2 < 2; ++dx2) {
            int xx = x0 + dx2;
            float wxx = dx2 ? wx : 1.0f - wx;
            float v;
            if (yy < 0 || yy >= sh || xx < 0 || xx >= sw) {
              v = (float)pad[c];
            } else {
              v = (float)src[((size_t)yy * sw + xx) * 3 + c];
            }
            acc += wyy * wxx * v;
          }
        }
        int r = (int)std::lround(acc);
        out[c] = (uint8_t)std::min(255, std::max(0, r));
      }
    }
  }
}

void resize_nearest_u8(const uint8_t* src, int sh, int sw,
                       uint8_t* dst, int dh, int dw) {
  const double sx = (double)sw / dw;
  const double sy = (double)sh / dh;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int oy = 0; oy < dh; ++oy) {
    // cv2 INTER_NEAREST convention: floor(dst * scale)
    int yy = std::min(sh - 1, (int)std::floor(oy * sy));
    for (int ox = 0; ox < dw; ++ox) {
      int xx = std::min(sw - 1, (int)std::floor(ox * sx));
      dst[(size_t)oy * dw + ox] = src[(size_t)yy * sw + xx];
    }
  }
}

}  // extern "C"
