// Outer contours of a binary mask and thick closed polylines, without
// OpenCV: what the pseudo-labeller's overlays and mining's previews draw
// (cartseg_tpu/infer/pseudo_labels.py `_overlay`, cartseg_tpu/infer/
// mining.py `_save_previews`):
//
//   cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)
//   cv2.drawContours(img, contours, -1, colour, thickness)
//
// The contours follow OpenCV's Suzuki-Abe border following over
// 8-connected components (the legacy `cvFindNextContour` /
// `icvFetchContour`): a raster scan of the mask padded by one zero pixel,
// a border followed counter-clockwise from its top-left pixel, each
// followed pixel marked (2, or -126 where it is a right bound), the
// points written where the chain code changes direction. An outer border
// is skipped, as RETR_EXTERNAL does, when the last marked pixel left of
// it in its row (`lnbd`) is a marked non-right-bound pixel: the component
// then lies in a hole of one already followed.
//
// The drawing is OpenCV's `ThickLine` for thickness > 1, segment by
// segment (each contour's point j to j + 1, the last back to the first):
// the segment's rectangle, offset by half the thickness along the normal
// in 1/65536 pixel units, filled by `FillConvexPoly` (its edges drawn by
// the 8-connected fixed-point `Line2` first), and a filled `Circle` of
// radius (thickness + 1) / 2 at the segment's end. Everything is integer
// arithmetic but the normal's length (double, rounded half to even), as
// in OpenCV.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int XY_SHIFT = 16;
const int64_t XY_ONE = int64_t(1) << XY_SHIFT;
// chain code 0..7: right, up-right, up, up-left, left, down-left, down,
// down-right
const int CODE_DX[8] = {1, 1, 0, -1, -1, -1, 0, 1};
const int CODE_DY[8] = {0, -1, -1, -1, 0, 1, 1, 1};

struct Points {
    int32_t* out;
    int64_t cap;
    int64_t n;
    void push(int x, int y) {
        if (n < cap) {
            out[2 * n] = x;
            out[2 * n + 1] = y;
        }
        n++;
    }
};

// Follow the outer border whose top-left pixel is *i0 (at px, py of the
// padded image), mark it, and write its CHAIN_APPROX_SIMPLE points
// (unpadded coordinates).
void fetch_contour(int8_t* i0, const int* deltas, int px, int py,
                   Points& pts) {
    const int8_t nbd = 2;
    const int8_t right_bound = (int8_t)(nbd | -128);
    int s = 4, s_end = 4;
    int8_t* i1;
    do {
        s = (s - 1) & 7;
        i1 = i0 + deltas[s];
    } while (*i1 == 0 && s != s_end);

    if (s == s_end) {                      // a single pixel
        *i0 = right_bound;
        pts.push(px - 1, py - 1);
        return;
    }
    int8_t* i3 = i0;
    int8_t* i4 = nullptr;
    int prev_s = s ^ 4;
    for (;;) {
        s_end = s;
        while (s < 15) {
            i4 = i3 + deltas[++s];
            if (*i4 != 0) break;
        }
        s &= 7;
        if ((unsigned)(s - 1) < (unsigned)s_end)
            *i3 = right_bound;
        else if (*i3 == 1)
            *i3 = nbd;
        if (s != prev_s) {
            pts.push(px - 1, py - 1);
            prev_s = s;
        }
        px += CODE_DX[s];
        py += CODE_DY[s];
        if (i4 == i0 && i3 == i1) break;
        i3 = i4;
        s = (s + 4) & 7;
    }
}

struct Canvas {
    uint8_t* p;
    int w, h, cn;
    const uint8_t* colour;
    void put(int64_t x, int64_t y) {
        if (0 <= x && x < w && 0 <= y && y < h)
            std::memcpy(p + ((size_t)y * w + x) * cn, colour, cn);
    }
    void hline(int y, int x1, int x2) {     // x1..x2 inclusive, in range
        uint8_t* row = p + (size_t)y * w * cn;
        for (int x = x1; x <= x2; x++) std::memcpy(row + x * cn, colour, cn);
    }
};

inline int64_t round_half_even(double v) { return (int64_t)std::nearbyint(v); }

// cv::clipLine on a size in 1/65536 pixel units
bool clip_line(int64_t width, int64_t height, int64_t& x1, int64_t& y1,
               int64_t& x2, int64_t& y2) {
    const int64_t right = width - 1, bottom = height - 1;
    int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
    int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
        int64_t a;
        if (c1 & 12) {
            a = c1 < 8 ? 0 : bottom;
            x1 += (int64_t)((double)(a - y1) * (x2 - x1) / (y2 - y1));
            y1 = a;
            c1 = (x1 < 0) + (x1 > right) * 2;
        }
        if (c2 & 12) {
            a = c2 < 8 ? 0 : bottom;
            x2 += (int64_t)((double)(a - y2) * (x2 - x1) / (y2 - y1));
            y2 = a;
            c2 = (x2 < 0) + (x2 > right) * 2;
        }
        if ((c1 & c2) == 0 && (c1 | c2) != 0) {
            if (c1) {
                a = c1 == 1 ? 0 : right;
                y1 += (int64_t)((double)(a - x1) * (y2 - y1) / (x2 - x1));
                x1 = a;
                c1 = 0;
            }
            if (c2) {
                a = c2 == 1 ? 0 : right;
                y2 += (int64_t)((double)(a - x2) * (y2 - y1) / (x2 - x1));
                x2 = a;
                c2 = 0;
            }
        }
    }
    return (c1 | c2) == 0;
}

// cv's Line2: an 8-connected line between two points in 1/65536 units
void line2(Canvas& c, int64_t x1, int64_t y1, int64_t x2, int64_t y2) {
    if (!clip_line((int64_t)c.w << XY_SHIFT, (int64_t)c.h << XY_SHIFT, x1, y1,
                   x2, y2))
        return;
    int64_t dx = x2 - x1, dy = y2 - y1;
    int64_t j = dx < 0 ? -1 : 0, ax = (dx ^ j) - j;
    int64_t i = dy < 0 ? -1 : 0, ay = (dy ^ i) - i;
    int64_t x_step, y_step;
    int ecount;
    if (ax > ay) {
        dy = (dy ^ j) - j;
        x1 ^= x2 & j; x2 ^= x1 & j; x1 ^= x2 & j;
        y1 ^= y2 & j; y2 ^= y1 & j; y1 ^= y2 & j;
        x_step = XY_ONE;
        y_step = (dy << XY_SHIFT) / (ax | 1);
        ecount = (int)((x2 - x1) >> XY_SHIFT);
    } else {
        dx = (dx ^ i) - i;
        x1 ^= x2 & i; x2 ^= x1 & i; x1 ^= x2 & i;
        y1 ^= y2 & i; y2 ^= y1 & i; y1 ^= y2 & i;
        x_step = (dx << XY_SHIFT) / (ay | 1);
        y_step = XY_ONE;
        ecount = (int)((y2 - y1) >> XY_SHIFT);
    }
    x1 += XY_ONE >> 1;
    y1 += XY_ONE >> 1;
    c.put((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT);
    if (ax > ay) {
        x1 >>= XY_SHIFT;
        for (; ecount >= 0; ecount--) {
            c.put(x1, y1 >> XY_SHIFT);
            x1++;
            y1 += y_step;
        }
    } else {
        y1 >>= XY_SHIFT;
        for (; ecount >= 0; ecount--) {
            c.put(x1 >> XY_SHIFT, y1);
            x1 += x_step;
            y1++;
        }
    }
}

// cv's FillConvexPoly for LINE_8 with points in 1/65536 units
void fill_convex_poly(Canvas& c, const int64_t (*v)[2], int npts) {
    const int shift = XY_SHIFT;
    const int64_t delta = XY_ONE >> 1;
    const int64_t delta1 = XY_ONE >> 1, delta2 = XY_ONE >> 1;
    struct Edge { int idx, di; int64_t x, dx; int ye; } edge[2];
    int64_t xmin = v[0][0], xmax = v[0][0], ymin = v[0][1], ymax = v[0][1];
    int imin = 0, edges = npts;
    int64_t p0x = v[npts - 1][0], p0y = v[npts - 1][1];
    for (int i = 0; i < npts; i++) {
        int64_t px = v[i][0], py = v[i][1];
        if (py < ymin) {
            ymin = py;
            imin = i;
        }
        if (py > ymax) ymax = py;
        if (px > xmax) xmax = px;
        if (px < xmin) xmin = px;
        line2(c, p0x, p0y, px, py);
        p0x = px;
        p0y = py;
    }
    xmin = (xmin + delta) >> shift;
    xmax = (xmax + delta) >> shift;
    ymin = (ymin + delta) >> shift;
    ymax = (ymax + delta) >> shift;
    if (npts < 3 || (int)xmax < 0 || (int)ymax < 0 || (int)xmin >= c.w ||
        (int)ymin >= c.h)
        return;
    if (ymax > c.h - 1) ymax = c.h - 1;
    edge[0].idx = edge[1].idx = imin;
    int y = (int)ymin;
    edge[0].ye = edge[1].ye = y;
    edge[0].di = 1;
    edge[1].di = npts - 1;
    edge[0].x = edge[1].x = -XY_ONE;
    edge[0].dx = edge[1].dx = 0;
    do {
        for (int i = 0; i < 2; i++) {
            if (y >= edge[i].ye) {
                int idx0 = edge[i].idx, di = edge[i].di;
                int idx = idx0 + di;
                if (idx >= npts) idx -= npts;
                for (; edges-- > 0;) {
                    int ty = (int)((v[idx][1] + delta) >> shift);
                    if (ty > y) {
                        int64_t xs = v[idx0][0], xe = v[idx][0];
                        edge[i].ye = ty;
                        edge[i].dx = ((xe - xs) * 2 + ((int64_t)ty - y)) /
                                     (2 * ((int64_t)ty - y));
                        edge[i].x = xs;
                        edge[i].idx = idx;
                        break;
                    }
                    idx0 = idx;
                    idx += di;
                    if (idx >= npts) idx -= npts;
                }
            }
        }
        if (edges < 0) break;
        if (y >= 0) {
            int left = 0, right = 1;
            if (edge[0].x > edge[1].x) {
                left = 1;
                right = 0;
            }
            int xx1 = (int)((edge[left].x + delta1) >> XY_SHIFT);
            int xx2 = (int)((edge[right].x + delta2) >> XY_SHIFT);
            if (xx2 >= 0 && xx1 < c.w) {
                if (xx1 < 0) xx1 = 0;
                if (xx2 >= c.w) xx2 = c.w - 1;
                c.hline(y, xx1, xx2);
            }
        }
        edge[0].x += edge[0].dx;
        edge[1].x += edge[1].dx;
    } while (++y <= (int)ymax);
}

// cv's Circle, filled: horizontal spans of the midpoint circle
void filled_circle(Canvas& c, int cx, int cy, int radius) {
    int err = 0, dx = radius, dy = 0, plus = 1, minus = (radius << 1) - 1;
    while (dx >= dy) {
        int y11 = cy - dy, y12 = cy + dy, y21 = cy - dx, y22 = cy + dx;
        int x11 = cx - dx, x12 = cx + dx, x21 = cx - dy, x22 = cx + dy;
        if (x11 < c.w && x12 >= 0 && y21 < c.h && y22 >= 0) {
            x11 = x11 < 0 ? 0 : x11;
            x12 = x12 > c.w - 1 ? c.w - 1 : x12;
            if ((unsigned)y11 < (unsigned)c.h) c.hline(y11, x11, x12);
            if ((unsigned)y12 < (unsigned)c.h) c.hline(y12, x11, x12);
            if (x21 < c.w && x22 >= 0) {
                x21 = x21 < 0 ? 0 : x21;
                x22 = x22 > c.w - 1 ? c.w - 1 : x22;
                if ((unsigned)y21 < (unsigned)c.h) c.hline(y21, x21, x22);
                if ((unsigned)y22 < (unsigned)c.h) c.hline(y22, x21, x22);
            }
        }
        dy++;
        err += plus;
        plus += 2;
        int mask = (err <= 0) - 1;
        err -= minus & mask;
        dx += mask;
        minus -= mask & 2;
    }
}

// cv's ThickLine for thickness > 1, LINE_8, flags 2 (a round cap at the
// end point only), points in whole pixels
void thick_line(Canvas& c, int64_t x0, int64_t y0, int64_t x1, int64_t y1,
                int thickness) {
    x0 <<= XY_SHIFT;
    y0 <<= XY_SHIFT;
    x1 <<= XY_SHIFT;
    y1 <<= XY_SHIFT;
    const double inv_one = 1. / (double)XY_ONE;
    double dx = (double)(x0 - x1) * inv_one, dy = (double)(y1 - y0) * inv_one;
    double r = dx * dx + dy * dy;
    int odd = thickness & 1;
    int64_t th = (int64_t)thickness << (XY_SHIFT - 1);
    if (std::fabs(r) > 2.220446049250313e-16) {
        r = ((double)th + odd * (double)XY_ONE * 0.5) / std::sqrt(r);
        int64_t dpx = round_half_even(dy * r), dpy = round_half_even(dx * r);
        int64_t pt[4][2] = {{x0 + dpx, y0 + dpy}, {x0 - dpx, y0 - dpy},
                            {x1 - dpx, y1 - dpy}, {x1 + dpx, y1 + dpy}};
        fill_convex_poly(c, pt, 4);
    }
    int cx = (int)((x1 + (XY_ONE >> 1)) >> XY_SHIFT);
    int cy = (int)((y1 + (XY_ONE >> 1)) >> XY_SHIFT);
    filled_circle(c, cx, cy, (int)((th + (XY_ONE >> 1)) >> XY_SHIFT));
}

}  // namespace

extern "C" {

// The outer contours of `mask` (h x w, nonzero is foreground) in
// cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)'s points, in the
// order the raster scan finds them. Writes up to `pts_cap` (x, y) int32
// pairs to `pts` and up to `lens_cap` point counts to `lens`; returns the
// number of contours and stores the number of points in *n_pts, so a
// caller whose buffers were short calls again with both sizes.
int64_t cartseg_find_external_contours(const uint8_t* mask, int h, int w,
                                       int32_t* pts, int64_t pts_cap,
                                       int32_t* lens, int64_t lens_cap,
                                       int64_t* n_pts) {
    const int step = w + 2;
    std::vector<int8_t> img((size_t)step * (h + 2), 0);
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++)
            img[(size_t)(y + 1) * step + x + 1] = mask[(size_t)y * w + x] != 0;
    int deltas[16] = {1, -step + 1, -step, -step - 1, -1, step - 1, step,
                      step + 1};
    for (int k = 0; k < 8; k++) deltas[k + 8] = deltas[k];

    Points points{pts, pts_cap, 0};
    int64_t n_cnt = 0;
    int8_t* img0 = img.data();
    for (int y = 1; y <= h; y++) {
        int8_t* row = img0 + (size_t)y * step;
        int prev = 0;
        int lnbd_x = 0;                    // last marked pixel in this row
        for (int x = 1; x <= w; x++) {
            int p = row[x];
            if (p == prev) continue;
            if (prev == 0 && p == 1) {     // an outer border starts
                if (row[lnbd_x] <= 0) {
                    int64_t before = points.n;
                    fetch_contour(row + x, deltas, x, y, points);
                    if (n_cnt < lens_cap)
                        lens[n_cnt] = (int32_t)(points.n - before);
                    n_cnt++;
                    prev = row[x];
                    continue;
                }
            } else if (p == 0 && prev >= 1) {  // a hole's border: skipped
                if (prev & -2) lnbd_x = x - 1;
            }
            prev = p;
            if (prev & -2) lnbd_x = x;
        }
    }
    *n_pts = points.n;
    return n_cnt;
}

// Draw each contour (lens[k] points from `pts`, (x, y) int32 pairs) as a
// closed polyline of `thickness` > 1 in `colour` (cn bytes) onto `img`
// (h x w x cn, uint8), as cv2.drawContours(img, contours, -1, colour,
// thickness) does with LINE_8.
void cartseg_draw_contours(uint8_t* img, int h, int w, int cn,
                           const int32_t* pts, const int32_t* lens,
                           int64_t n_cnt, const uint8_t* colour,
                           int thickness) {
    Canvas c{img, w, h, cn, colour};
    const int32_t* p = pts;
    for (int64_t k = 0; k < n_cnt; k++) {
        int n = lens[k];
        for (int j = 0; j < n; j++) {
            const int32_t* a = p + 2 * j;
            const int32_t* b = p + 2 * (j + 1 < n ? j + 1 : 0);
            thick_line(c, a[0], a[1], b[0], b[1], thickness);
        }
        p += 2 * n;
    }
}

}  // extern "C"
