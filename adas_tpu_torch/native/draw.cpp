// Stroke rasterizer of the port's HUD renderer: lines (4- and 8-connected,
// thick with round caps, anti-aliased), polylines, circles, convex and
// general filled polygons on 8-bit images of 1, 3 or 4 channels, in the
// 16.16 fixed point (XY_SHIFT) of OpenCV's imgproc/drawing.cpp, so that a
// frame drawn here equals the frame the JAX package draws with cv2.  The
// algorithms and the two anti-aliasing tables follow OpenCV's drawing.cpp
// (Apache License 2.0); the sine table is sin(degrees) rounded to seven
// decimals, as OpenCV's is.  Also cv2's 8-bit addWeighted, and the host
// I420 -> BGR decode of the Y4M reader, cv2's COLOR_YUV2BGR_I420 in 20-bit
// fixed point.
//
// Exported C ABI (images are row-major, tightly packed h x w x nch uint8;
// points are int64 (x, y) pairs carrying `shift` fractional bits; a
// colour is nch bytes, already saturated by the caller):
//   void draw_polylines(img, h, w, nch, pts, npts, ncontours, closed,
//                       color, thickness, line_type, shift)
//   void draw_fill_convex(img, h, w, nch, pts, n, color, line_type, shift)
//   void draw_fill_poly(img, h, w, nch, pts, npts, ncontours, color,
//                       line_type, shift, off_x, off_y)
//   void draw_circles(img, h, w, nch, centers, radii, thicknesses, n, color,
//                     line_type, shift)
//   void blend_glyphs(img, h, w, nch, alpha, offs, gh, gw, gx, gy, n, color)
//   void resize_linear_u8(src, sh, sw, nch, dst, dh, dw, x taps, y taps)
//   void add_weighted_u8(a, alpha, b, beta, gamma, out, n)
//   void i420_to_bgr(yuv, h, w, out)
// line_type: 4 or 8 (connectivity; 0 and 1 alias 8 and 4) or 16 (LINE_AA).

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

typedef int64_t i64;

const int XY_SHIFT = 16;
const i64 XY_ONE = (i64)1 << XY_SHIFT;
const int LINE_AA = 16;

struct P {
  i64 x, y;
};

struct Img {
  uint8_t* data;
  int h, w, nch;
  size_t step;
  uint8_t* px(int x, int y) const { return data + (size_t)y * step + (size_t)x * nch; }
};

// sin(k degrees), k = 0..450, rounded to seven decimals as OpenCV's table is
struct SinTab {
  float v[451];
  SinTab() {
    for (int k = 0; k <= 450; ++k) v[k] = (float)(std::round(std::sin(k * M_PI / 180.0) * 1e7) / 1e7);
  }
};
const SinTab kSin;

const int kFilter[64] = {
    168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252, 254, 254,
    254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202, 194, 185, 177, 168,
    158, 149, 140, 131, 122, 114, 105, 97,  89,  82,  75,  68,  62,  56,  50,  45,
    40,  36,  32,  28,  25,  22,  19,  16,  14,  12,  11,  9,   8,   7,   5,   5};

const int kSlopeCorr[32] = {181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190,
                            192, 194, 196, 198, 201, 203, 206, 209, 211, 214, 218,
                            221, 224, 227, 231, 235, 238, 242, 246, 250, 254};

inline int round_half_even(double v) { return (int)std::lrint(v); }

inline void put(const Img& im, int x, int y, const uint8_t* c) { std::memcpy(im.px(x, y), c, im.nch); }

inline void hline(const Img& im, int y, int x1, int x2, const uint8_t* c) {
  uint8_t* p = im.px(x1, y);
  for (int x = x1; x <= x2; ++x, p += im.nch) std::memcpy(p, c, im.nch);
}

// Cohen-Sutherland clip of a segment to [0, w-1] x [0, h-1]; false when the
// segment lies wholly outside.
bool clip_line(i64 w, i64 h, P& p1, P& p2) {
  if (w <= 0 || h <= 0) return false;
  i64 right = w - 1, bottom = h - 1;
  i64 &x1 = p1.x, &y1 = p1.y, &x2 = p2.x, &y2 = p2.y;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    i64 a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += (i64)((double)(a - y1) * (x2 - x1) / (y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += (i64)((double)(a - y2) * (x2 - x1) / (y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += (i64)((double)(a - x1) * (y2 - y1) / (x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += (i64)((double)(a - x2) * (y2 - y1) / (x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

// Integer Bresenham line (OpenCV's LineIterator, left to right).
void line_int(const Img& im, P p1, P p2, const uint8_t* c, int connectivity) {
  if (connectivity == 0) connectivity = 8;
  else if (connectivity == 1) connectivity = 4;
  if ((uint64_t)p1.x >= (uint64_t)im.w || (uint64_t)p2.x >= (uint64_t)im.w ||
      (uint64_t)p1.y >= (uint64_t)im.h || (uint64_t)p2.y >= (uint64_t)im.h) {
    if (!clip_line(im.w, im.h, p1, p2)) return;
  }
  int dx = (int)(p2.x - p1.x), dy = (int)(p2.y - p1.y);
  int delta_x = 1, delta_y = 1;
  if (dx < 0) {
    dx = -dx;
    dy = -dy;
    std::swap(p1, p2);
  }
  if (dy < 0) {
    dy = -dy;
    delta_y = -1;
  }
  bool vert = dy > dx;
  if (vert) {
    std::swap(dx, dy);
    std::swap(delta_x, delta_y);
  }
  int err, plus_delta, minus_delta, minus_shift, plus_shift, minus_step, plus_step, count;
  if (connectivity == 8) {
    err = dx - (dy + dy);
    plus_delta = dx + dx;
    minus_delta = -(dy + dy);
    minus_shift = delta_x;
    plus_shift = 0;
    minus_step = 0;
    plus_step = delta_y;
    count = dx + 1;
  } else {
    err = 0;
    plus_delta = (dx + dx) + (dy + dy);
    minus_delta = -(dy + dy);
    minus_shift = delta_x;
    plus_shift = -delta_x;
    minus_step = 0;
    plus_step = delta_y;
    count = dx + dy + 1;
  }
  if (vert) {
    std::swap(plus_step, plus_shift);
    std::swap(minus_step, minus_shift);
  }
  int x = (int)p1.x, y = (int)p1.y;
  for (int i = 0; i < count; ++i) {
    put(im, x, y, c);
    int mask = err < 0 ? -1 : 0;
    err += minus_delta + (plus_delta & mask);
    x += minus_shift + (plus_shift & mask);
    y += minus_step + (plus_step & mask);
  }
}

// 8-connected DDA line between fixed-point end points (OpenCV's Line2).
void line_fixed(const Img& im, P pt1, P pt2, const uint8_t* c) {
  if (!clip_line((i64)im.w << XY_SHIFT, (i64)im.h << XY_SHIFT, pt1, pt2)) return;
  i64 dx = pt2.x - pt1.x, dy = pt2.y - pt1.y;
  i64 j = dx < 0 ? -1 : 0, ax = (dx ^ j) - j;
  i64 i = dy < 0 ? -1 : 0, ay = (dy ^ i) - i;
  i64 x_step, y_step;
  int ecount;
  if (ax > ay) {
    dy = (dy ^ j) - j;
    if (j) std::swap(pt1, pt2);
    x_step = XY_ONE;
    y_step = (dy << XY_SHIFT) / (ax | 1);
    ecount = (int)((pt2.x - pt1.x) >> XY_SHIFT);
  } else {
    dx = (dx ^ i) - i;
    if (i) std::swap(pt1, pt2);
    x_step = (dx << XY_SHIFT) / (ay | 1);
    y_step = XY_ONE;
    ecount = (int)((pt2.y - pt1.y) >> XY_SHIFT);
  }
  pt1.x += XY_ONE >> 1;
  pt1.y += XY_ONE >> 1;
  auto put_clipped = [&](i64 x, i64 y) {
    if (0 <= x && x < im.w && 0 <= y && y < im.h) put(im, (int)x, (int)y, c);
  };
  put_clipped((pt2.x + (XY_ONE >> 1)) >> XY_SHIFT, (pt2.y + (XY_ONE >> 1)) >> XY_SHIFT);
  if (ax > ay) {
    pt1.x >>= XY_SHIFT;
    for (; ecount >= 0; --ecount) {
      put_clipped(pt1.x, pt1.y >> XY_SHIFT);
      pt1.x++;
      pt1.y += y_step;
    }
  } else {
    pt1.y >>= XY_SHIFT;
    for (; ecount >= 0; --ecount) {
      put_clipped(pt1.x >> XY_SHIFT, pt1.y);
      pt1.x += x_step;
      pt1.y++;
    }
  }
}

// Anti-aliased line between fixed-point end points (OpenCV's LineAA): each
// step blends the colour into three pixels across the line, twice.
void line_aa(const Img& im, P pt1, P pt2, const uint8_t* c) {
  if (!clip_line((i64)im.w << XY_SHIFT, (i64)im.h << XY_SHIFT, pt1, pt2)) return;
  i64 dx = pt2.x - pt1.x, dy = pt2.y - pt1.y;
  i64 j = dx < 0 ? -1 : 0, ax = (dx ^ j) - j;
  i64 i = dy < 0 ? -1 : 0, ay = (dy ^ i) - i;
  i64 x_step, y_step;
  int ecount, scount = 0, slope;
  if (ax > ay) {
    dy = (dy ^ j) - j;
    if (j) std::swap(pt1, pt2);
    x_step = XY_ONE;
    y_step = (dy << XY_SHIFT) / (ax | 1);
    pt2.x += XY_ONE;
    ecount = (int)((pt2.x >> XY_SHIFT) - (pt1.x >> XY_SHIFT));
    j = -(pt1.x & (XY_ONE - 1));
    pt1.y += ((y_step * j) >> XY_SHIFT) + (XY_ONE >> 1);
    slope = (y_step >> (XY_SHIFT - 5)) & 0x3f;
    slope ^= (y_step < 0 ? 0x3f : 0);
    i = (pt1.x >> (XY_SHIFT - 7)) & 0x78;
    j = (pt2.x >> (XY_SHIFT - 7)) & 0x78;
  } else {
    dx = (dx ^ i) - i;
    if (i) std::swap(pt1, pt2);
    x_step = (dx << XY_SHIFT) / (ay | 1);
    y_step = XY_ONE;
    pt2.y += XY_ONE;
    ecount = (int)((pt2.y >> XY_SHIFT) - (pt1.y >> XY_SHIFT));
    j = -(pt1.y & (XY_ONE - 1));
    pt1.x += ((x_step * j) >> XY_SHIFT) + (XY_ONE >> 1);
    slope = (x_step >> (XY_SHIFT - 5)) & 0x3f;
    slope ^= (x_step < 0 ? 0x3f : 0);
    i = (pt1.y >> (XY_SHIFT - 7)) & 0x78;
    j = (pt2.y >> (XY_SHIFT - 7)) & 0x78;
  }
  slope = (slope & 0x20) ? 0x100 : kSlopeCorr[slope];
  int ep[9];
  {
    int t0 = slope << 7;
    int t1 = ((0x78 - (int)i) | 4) * slope;
    int t2 = ((int)j | 4) * slope;
    ep[0] = 0;
    ep[8] = slope;
    ep[1] = ep[3] = ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1ff;
    ep[2] = (t1 >> 8) & 0x1ff;
    ep[4] = ((((j - i) + 0x80) | 4) * slope >> 8) & 0x1ff;
    ep[5] = ((t1 + t0) >> 8) & 0x1ff;
    ep[6] = (t2 >> 8) & 0x1ff;
    ep[7] = ((t2 + t0) >> 8) & 0x1ff;
  }
  auto blend = [&](int x, int y, int a) {
    uint8_t* p = im.px(x, y);
    for (int k = 0; k < im.nch; ++k) {
      int v = p[k];
      v += ((c[k] - v) * a + 127) >> 8;
      v += ((c[k] - v) * a + 127) >> 8;
      p[k] = (uint8_t)v;
    }
  };
  if (ax > ay) {
    int x = (int)(pt1.x >> XY_SHIFT);
    for (; ecount >= 0; x++, pt1.y += y_step, scount++, ecount--) {
      if ((unsigned)x >= (unsigned)im.w) continue;
      int y = (int)((pt1.y >> XY_SHIFT) - 1);
      int ep_corr = ep[(((scount >= 2) + 1) & (scount | 2)) * 3 + (((ecount >= 2) + 1) & (ecount | 2))];
      int dist = (int)((pt1.y >> (XY_SHIFT - 5)) & 31);
      int a = (ep_corr * kFilter[dist + 32] >> 8) & 0xff;
      if ((unsigned)y < (unsigned)im.h) blend(x, y, a);
      a = (ep_corr * kFilter[dist] >> 8) & 0xff;
      if ((unsigned)(y + 1) < (unsigned)im.h) blend(x, y + 1, a);
      a = (ep_corr * kFilter[63 - dist] >> 8) & 0xff;
      if ((unsigned)(y + 2) < (unsigned)im.h) blend(x, y + 2, a);
    }
  } else {
    int y = (int)(pt1.y >> XY_SHIFT);
    for (; ecount >= 0; y++, pt1.x += x_step, scount++, ecount--) {
      if ((unsigned)y >= (unsigned)im.h) continue;
      int x = (int)((pt1.x >> XY_SHIFT) - 1);
      int ep_corr = ep[(((scount >= 2) + 1) & (scount | 2)) * 3 + (((ecount >= 2) + 1) & (ecount | 2))];
      int dist = (int)((pt1.x >> (XY_SHIFT - 5)) & 31);
      int a = (ep_corr * kFilter[dist + 32] >> 8) & 0xff;
      if ((unsigned)x < (unsigned)im.w) blend(x, y, a);
      a = (ep_corr * kFilter[dist] >> 8) & 0xff;
      if ((unsigned)(x + 1) < (unsigned)im.w) blend(x + 1, y, a);
      a = (ep_corr * kFilter[63 - dist] >> 8) & 0xff;
      if ((unsigned)(x + 2) < (unsigned)im.w) blend(x + 2, y, a);
    }
  }
}

// Midpoint circle, outlined or filled, with integer centre and radius
// (OpenCV's Circle).
void circle_int(const Img& im, P center, int radius, const uint8_t* c, bool fill) {
  int err = 0, dx = radius, dy = 0, plus = 1, minus = (radius << 1) - 1;
  int cx = (int)center.x, cy = (int)center.y;
  bool inside = cx >= radius && cx < im.w - radius && cy >= radius && cy < im.h - radius;
  while (dx >= dy) {
    int y11 = cy - dy, y12 = cy + dy, y21 = cy - dx, y22 = cy + dx;
    int x11 = cx - dx, x12 = cx + dx, x21 = cx - dy, x22 = cx + dy;
    if (inside) {
      if (!fill) {
        put(im, x11, y11, c);
        put(im, x11, y12, c);
        put(im, x12, y11, c);
        put(im, x12, y12, c);
        put(im, x21, y21, c);
        put(im, x21, y22, c);
        put(im, x22, y21, c);
        put(im, x22, y22, c);
      } else {
        hline(im, y11, x11, x12, c);
        hline(im, y12, x11, x12, c);
        hline(im, y21, x21, x22, c);
        hline(im, y22, x21, x22, c);
      }
    } else if (x11 < im.w && x12 >= 0 && y21 < im.h && y22 >= 0) {
      if (fill) {
        x11 = std::max(x11, 0);
        x12 = std::min(x12, im.w - 1);
      }
      for (int yy : {y11, y12}) {
        if ((unsigned)yy < (unsigned)im.h) {
          if (!fill) {
            if (x11 >= 0) put(im, x11, yy, c);
            if (x12 < im.w) put(im, x12, yy, c);
          } else {
            hline(im, yy, x11, x12, c);
          }
        }
      }
      if (x21 < im.w && x22 >= 0) {
        if (fill) {
          x21 = std::max(x21, 0);
          x22 = std::min(x22, im.w - 1);
        }
        for (int yy : {y21, y22}) {
          if ((unsigned)yy < (unsigned)im.h) {
            if (!fill) {
              if (x21 >= 0) put(im, x21, yy, c);
              if (x22 < im.w) put(im, x22, yy, c);
            } else {
              hline(im, yy, x21, x22, c);
            }
          }
        }
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

// Scan-converts a convex polygon (OpenCV's FillConvexPoly).
void fill_convex(const Img& im, const P* v, int npts, const uint8_t* c, int line_type, int shift) {
  struct Edge {
    int idx, di;
    i64 x, dx;
    int ye;
  } edge[2];
  int delta = 1 << shift >> 1;
  int imin = 0, edges = npts;
  int delta1, delta2;
  if (line_type < LINE_AA) delta1 = delta2 = XY_ONE >> 1;
  else delta1 = XY_ONE - 1, delta2 = 0;
  P p0 = v[npts - 1];
  p0.x <<= XY_SHIFT - shift;
  p0.y <<= XY_SHIFT - shift;
  i64 xmin = v[0].x, xmax = v[0].x, ymin = v[0].y, ymax = v[0].y;
  for (int i = 0; i < npts; ++i) {
    P p = v[i];
    if (p.y < ymin) {
      ymin = p.y;
      imin = i;
    }
    ymax = std::max(ymax, p.y);
    xmax = std::max(xmax, p.x);
    xmin = std::min(xmin, p.x);
    p.x <<= XY_SHIFT - shift;
    p.y <<= XY_SHIFT - shift;
    if (line_type <= 8) {
      if (shift == 0) {
        line_int(im, P{p0.x >> XY_SHIFT, p0.y >> XY_SHIFT}, P{p.x >> XY_SHIFT, p.y >> XY_SHIFT}, c,
                 line_type);
      } else {
        line_fixed(im, p0, p, c);
      }
    } else {
      line_aa(im, p0, p, c);
    }
    p0 = p;
  }
  xmin = (xmin + delta) >> shift;
  xmax = (xmax + delta) >> shift;
  ymin = (ymin + delta) >> shift;
  ymax = (ymax + delta) >> shift;
  if (npts < 3 || (int)xmax < 0 || (int)ymax < 0 || (int)xmin >= im.w || (int)ymin >= im.h) return;
  ymax = std::min<i64>(ymax, im.h - 1);
  edge[0].idx = edge[1].idx = imin;
  int y = (int)ymin;
  edge[0].ye = edge[1].ye = y;
  edge[0].di = 1;
  edge[1].di = npts - 1;
  edge[0].x = edge[1].x = -XY_ONE;
  edge[0].dx = edge[1].dx = 0;
  do {
    if (line_type < LINE_AA || y < (int)ymax || y == (int)ymin) {
      for (int i = 0; i < 2; ++i) {
        if (y >= edge[i].ye) {
          int idx0 = edge[i].idx, di = edge[i].di;
          int idx = idx0 + di;
          if (idx >= npts) idx -= npts;
          int ty = 0;
          for (; edges-- > 0;) {
            ty = (int)((v[idx].y + delta) >> shift);
            if (ty > y) {
              i64 xs = v[idx0].x, xe = v[idx].x;
              if (shift != XY_SHIFT) {
                xs <<= XY_SHIFT - shift;
                xe <<= XY_SHIFT - shift;
              }
              edge[i].ye = ty;
              edge[i].dx = ((xe - xs) * 2 + ((i64)ty - y)) / (2 * ((i64)ty - y));
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
    }
    if (edges < 0) break;
    if (y >= 0) {
      int left = 0, right = 1;
      if (edge[0].x > edge[1].x) left = 1, right = 0;
      int xx1 = (int)((edge[left].x + delta1) >> XY_SHIFT);
      int xx2 = (int)((edge[right].x + delta2) >> XY_SHIFT);
      if (xx2 >= 0 && xx1 < im.w) {
        if (xx1 < 0) xx1 = 0;
        if (xx2 >= im.w) xx2 = im.w - 1;
        hline(im, y, xx1, xx2, c);
      }
    }
    edge[0].x += edge[0].dx;
    edge[1].x += edge[1].dx;
  } while (++y <= (int)ymax);
}

struct PolyEdge {
  int y0 = 0, y1 = 0;
  i64 x = 0, dx = 0;
  PolyEdge* next = nullptr;
};

// Edges of one contour for the general polygon fill (OpenCV's
// CollectPolyEdges); draws the outline as it goes.
void collect_edges(const Img& im, const P* v, int count, std::vector<PolyEdge>& edges,
                   const uint8_t* c, int line_type, int shift, P offset) {
  i64 delta = offset.y + ((1 << shift) >> 1);
  P pt0 = v[count - 1], pt1;
  pt0.x = (pt0.x + offset.x) << (XY_SHIFT - shift);
  pt0.y = (pt0.y + delta) >> shift;
  for (int i = 0; i < count; i++, pt0 = pt1) {
    pt1 = v[i];
    pt1.x = (pt1.x + offset.x) << (XY_SHIFT - shift);
    pt1.y = (pt1.y + delta) >> shift;
    P pt0c = pt0, pt1c = pt1;
    if (line_type < LINE_AA) {
      P t0{(pt0.x + (XY_ONE >> 1)) >> XY_SHIFT, pt0.y}, t1{(pt1.x + (XY_ONE >> 1)) >> XY_SHIFT, pt1.y};
      line_int(im, t0, t1, c, line_type);
      if ((uint64_t)t0.x >= (uint64_t)im.w || (uint64_t)t1.x >= (uint64_t)im.w ||
          (uint64_t)t0.y >= (uint64_t)im.h || (uint64_t)t1.y >= (uint64_t)im.h) {
        clip_line(im.w, im.h, t0, t1);
        if (t0.y != t1.y) {
          pt0c.y = t0.y;
          pt1c.y = t1.y;
          pt0c.x = t0.x << XY_SHIFT;
          pt1c.x = t1.x << XY_SHIFT;
        }
      }
    } else {
      line_aa(im, P{pt0.x, pt0.y << XY_SHIFT}, P{pt1.x, pt1.y << XY_SHIFT}, c);
    }
    if (pt0.y == pt1.y) continue;
    PolyEdge e;
    e.dx = (pt1c.x - pt0c.x) / (pt1c.y - pt0c.y);
    if (pt0.y < pt1.y) {
      e.y0 = (int)pt0.y;
      e.y1 = (int)pt1.y;
      e.x = pt0c.x + (pt0.y - pt0c.y) * e.dx;
    } else {
      e.y0 = (int)pt1.y;
      e.y1 = (int)pt0.y;
      e.x = pt1c.x + (pt1.y - pt1c.y) * e.dx;
    }
    edges.push_back(e);
  }
}

// Even-odd scanline fill of an edge list (OpenCV's FillEdgeCollection).
void fill_edges(const Img& im, std::vector<PolyEdge>& edges, const uint8_t* c) {
  int total = (int)edges.size();
  if (total < 2) return;
  int y_max = INT_MIN, y_min = INT_MAX;
  i64 x_max = (i64)0xFFFFFFFFFFFFFFFF, x_min = (i64)0x7FFFFFFFFFFFFFFF;
  const i64 delta = XY_ONE - 1;  // spans from ceil(left) to floor(right)
  for (auto& e1 : edges) {
    i64 x1 = e1.x + (e1.y1 - e1.y0) * e1.dx;
    y_min = std::min(y_min, e1.y0);
    y_max = std::max(y_max, e1.y1);
    x_min = std::min(x_min, e1.x);
    x_max = std::max(x_max, e1.x);
    x_min = std::min(x_min, x1);
    x_max = std::max(x_max, x1);
  }
  if (y_max < 0 || y_min >= im.h || x_max < 0 || x_min >= ((i64)im.w << XY_SHIFT)) return;
  std::sort(edges.begin(), edges.end(), [](const PolyEdge& e1, const PolyEdge& e2) {
    return e1.y0 - e2.y0 ? e1.y0 < e2.y0 : e1.x - e2.x ? e1.x < e2.x : e1.dx < e2.dx;
  });
  PolyEdge tmp;
  tmp.y0 = INT_MAX;
  edges.push_back(tmp);
  int i = 0;
  tmp.next = nullptr;
  PolyEdge* e = &edges[i];
  y_max = std::min(y_max, im.h);
  for (int y = e->y0; y < y_max; y++) {
    PolyEdge *last, *prelast, *keep_prelast;
    int draw = 0;
    bool clipline = y < 0;
    prelast = &tmp;
    last = tmp.next;
    while (last || e->y0 == y) {
      if (last && last->y1 == y) {
        prelast->next = last->next;
        last = last->next;
        continue;
      }
      keep_prelast = prelast;
      if (last && (e->y0 > y || last->x < e->x)) {
        prelast = last;
        last = last->next;
      } else if (i < total) {
        prelast->next = e;
        e->next = last;
        prelast = e;
        e = &edges[++i];
      } else {
        break;
      }
      if (draw) {
        if (!clipline) {
          int x1, x2;
          if (keep_prelast->x > prelast->x) {
            x1 = (int)((prelast->x + delta) >> XY_SHIFT);
            x2 = (int)(keep_prelast->x >> XY_SHIFT);
          } else {
            x1 = (int)((keep_prelast->x + delta) >> XY_SHIFT);
            x2 = (int)(prelast->x >> XY_SHIFT);
          }
          if (x1 < im.w && x2 >= 0) {
            if (x1 < 0) x1 = 0;
            if (x2 >= im.w) x2 = im.w - 1;
            hline(im, y, x1, x2, c);
          }
        }
        keep_prelast->x += keep_prelast->dx;
        prelast->x += prelast->dx;
      }
      draw ^= 1;
    }
    keep_prelast = nullptr;
    do {
      prelast = &tmp;
      last = tmp.next;
      PolyEdge* last_exchange = nullptr;
      while (last != keep_prelast && last->next != nullptr) {
        PolyEdge* te = last->next;
        if (last->x > te->x) {
          prelast->next = te;
          last->next = te->next;
          te->next = last;
          prelast = te;
          last_exchange = prelast;
        } else {
          prelast = last;
          last = te;
        }
      }
      if (last_exchange == nullptr) break;
      keep_prelast = last_exchange;
    } while (keep_prelast != tmp.next && keep_prelast != &tmp);
  }
}

void ellipse_ex(const Img& im, P center, P axes, int angle, int arc_start, int arc_end,
                const uint8_t* c, int thickness, int line_type);

// A line of any thickness; flags bit 0 / bit 1 cap the start / end with a
// disc (OpenCV's ThickLine).
void thick_line(const Img& im, P p0, P p1, const uint8_t* c, int thickness, int line_type, int flags,
                int shift) {
  const double INV_XY_ONE = 1. / XY_ONE;
  if (shift == 0 && thickness > 1) {
    // cv2 clips an integer thick line to the canvas grown by its thickness
    P o{thickness, thickness};
    P q0{p0.x + o.x, p0.y + o.y}, q1{p1.x + o.x, p1.y + o.y};
    if (!clip_line(im.w + 2 * (i64)thickness, im.h + 2 * (i64)thickness, q0, q1)) return;
    p0 = P{q0.x - o.x, q0.y - o.y};
    p1 = P{q1.x - o.x, q1.y - o.y};
  }
  p0.x <<= XY_SHIFT - shift;
  p0.y <<= XY_SHIFT - shift;
  p1.x <<= XY_SHIFT - shift;
  p1.y <<= XY_SHIFT - shift;
  if (thickness <= 1) {
    if (line_type < LINE_AA) {
      if (shift == 0) {  // fixed-point end points take the 8-connected DDA
        p0.x = (p0.x + (XY_ONE >> 1)) >> XY_SHIFT;
        p0.y = (p0.y + (XY_ONE >> 1)) >> XY_SHIFT;
        p1.x = (p1.x + (XY_ONE >> 1)) >> XY_SHIFT;
        p1.y = (p1.y + (XY_ONE >> 1)) >> XY_SHIFT;
        line_int(im, p0, p1, c, line_type);
      } else {
        line_fixed(im, p0, p1, c);
      }
    } else {
      line_aa(im, p0, p1, c);
    }
    return;
  }
  double dx = (p0.x - p1.x) * INV_XY_ONE, dy = (p1.y - p0.y) * INV_XY_ONE;
  double r = dx * dx + dy * dy;
  int odd = thickness & 1;
  thickness <<= XY_SHIFT - 1;
  if (std::fabs(r) > 2.220446049250313e-16) {
    r = (thickness + odd * XY_ONE * 0.5) / std::sqrt(r);
    P dp{round_half_even(dy * r), round_half_even(dx * r)};
    P pt[4] = {{p0.x + dp.x, p0.y + dp.y},
               {p0.x - dp.x, p0.y - dp.y},
               {p1.x - dp.x, p1.y - dp.y},
               {p1.x + dp.x, p1.y + dp.y}};
    fill_convex(im, pt, 4, c, line_type, XY_SHIFT);
  }
  for (int i = 0; i < 2; ++i) {
    if (flags & (i + 1)) {
      if (line_type < LINE_AA) {
        P center{(p0.x + (XY_ONE >> 1)) >> XY_SHIFT, (p0.y + (XY_ONE >> 1)) >> XY_SHIFT};
        circle_int(im, center, (int)((thickness + (XY_ONE >> 1)) >> XY_SHIFT), c, true);
      } else {
        ellipse_ex(im, p0, P{thickness, thickness}, 0, 0, 360, c, -1, line_type);
      }
    }
    p0 = p1;
  }
}

void poly_line(const Img& im, const P* v, int count, bool closed, const uint8_t* c, int thickness,
               int line_type, int shift) {
  if (count <= 0) return;
  int i = closed ? count - 1 : 0;
  int flags = 2 + !closed;
  P p0 = v[i];
  for (i = !closed; i < count; ++i) {
    thick_line(im, p0, v[i], c, thickness, line_type, flags, shift);
    p0 = v[i];
    flags = 2;
  }
}

// Polygon of an elliptic arc, `delta` degrees a step (OpenCV's double
// ellipse2Poly).
void ellipse_poly(double cx, double cy, double ax, double ay, int angle, int arc_start, int arc_end,
                  int delta, std::vector<double>& pts) {
  while (angle < 0) angle += 360;
  while (angle > 360) angle -= 360;
  if (arc_start > arc_end) std::swap(arc_start, arc_end);
  while (arc_start < 0) {
    arc_start += 360;
    arc_end += 360;
  }
  while (arc_end > 360) {
    arc_end -= 360;
    arc_start -= 360;
  }
  if (arc_end - arc_start > 360) {
    arc_start = 0;
    arc_end = 360;
  }
  float alpha = kSin.v[450 - angle], beta = kSin.v[angle];
  pts.clear();
  for (int i = arc_start; i < arc_end + delta; i += delta) {
    int a = i;
    if (a > arc_end) a = arc_end;
    if (a < 0) a += 360;
    double x = ax * kSin.v[450 - a];
    double y = ay * kSin.v[a];
    pts.push_back(cx + x * alpha - y * beta);
    pts.push_back(cy + x * beta + y * alpha);
  }
  if (pts.size() == 2) {
    pts.assign({cx, cy, cx, cy});
  }
}

// An ellipse or arc from fixed-point centre and axes (OpenCV's EllipseEx).
void ellipse_ex(const Img& im, P center, P axes, int angle, int arc_start, int arc_end,
                const uint8_t* c, int thickness, int line_type) {
  axes.x = std::llabs(axes.x);
  axes.y = std::llabs(axes.y);
  int delta = (int)((std::max(axes.x, axes.y) + (XY_ONE >> 1)) >> XY_SHIFT);
  delta = delta < 3 ? 90 : delta < 10 ? 30 : delta < 15 ? 18 : 5;
  std::vector<double> d;
  ellipse_poly((double)center.x, (double)center.y, (double)axes.x, (double)axes.y, angle, arc_start,
               arc_end, delta, d);
  std::vector<P> v;
  P prev{(i64)0xFFFFFFFFFFFFFFFF, (i64)0xFFFFFFFFFFFFFFFF};
  for (size_t k = 0; k < d.size(); k += 2) {
    P pt;
    pt.x = (i64)round_half_even(d[k] / XY_ONE) << XY_SHIFT;
    pt.y = (i64)round_half_even(d[k + 1] / XY_ONE) << XY_SHIFT;
    pt.x += round_half_even(d[k] - pt.x);
    pt.y += round_half_even(d[k + 1] - pt.y);
    if (pt.x != prev.x || pt.y != prev.y) {
      v.push_back(pt);
      prev = pt;
    }
  }
  if (v.size() == 1) v.assign(2, center);
  if (thickness >= 0) {
    poly_line(im, v.data(), (int)v.size(), false, c, thickness, line_type, XY_SHIFT);
  } else if (arc_end - arc_start >= 360) {
    fill_convex(im, v.data(), (int)v.size(), c, line_type, XY_SHIFT);
  } else {
    v.push_back(center);
    std::vector<PolyEdge> edges;
    collect_edges(im, v.data(), (int)v.size(), edges, c, line_type, XY_SHIFT, P{0, 0});
    fill_edges(im, edges, c);
  }
}

// cv::circle's dispatch: the midpoint circle for thin or filled 8-connected
// circles at integer coordinates, the ellipse polygon otherwise.
void circle_any(const Img& im, P center, int radius, const uint8_t* c, int thickness, int line_type,
                int shift) {
  if (thickness > 1 || line_type != 8 || shift > 0) {
    center.x <<= XY_SHIFT - shift;
    center.y <<= XY_SHIFT - shift;
    i64 r = (i64)radius << (XY_SHIFT - shift);
    ellipse_ex(im, center, P{r, r}, 0, 0, 360, c, thickness, line_type);
  } else {
    circle_int(im, center, radius, c, thickness < 0);
  }
}

inline uint8_t sat8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

}  // namespace

extern "C" {

void draw_polylines(uint8_t* data, int h, int w, int nch, const int64_t* pts, const int32_t* npts,
                    int ncontours, int closed, const uint8_t* color, int thickness, int line_type,
                    int shift) {
  Img im{data, h, w, nch, (size_t)w * nch};
  const P* v = reinterpret_cast<const P*>(pts);
  for (int k = 0; k < ncontours; ++k) {
    poly_line(im, v, npts[k], closed != 0, color, thickness, line_type, shift);
    v += npts[k];
  }
}

void draw_fill_convex(uint8_t* data, int h, int w, int nch, const int64_t* pts, int n,
                      const uint8_t* color, int line_type, int shift) {
  Img im{data, h, w, nch, (size_t)w * nch};
  if (n > 0) fill_convex(im, reinterpret_cast<const P*>(pts), n, color, line_type, shift);
}

void draw_fill_poly(uint8_t* data, int h, int w, int nch, const int64_t* pts, const int32_t* npts,
                    int ncontours, const uint8_t* color, int line_type, int shift, int off_x,
                    int off_y) {
  Img im{data, h, w, nch, (size_t)w * nch};
  const P* v = reinterpret_cast<const P*>(pts);
  std::vector<PolyEdge> edges;
  for (int k = 0; k < ncontours; ++k) {
    if (npts[k] > 0) collect_edges(im, v, npts[k], edges, color, line_type, shift, P{off_x, off_y});
    v += npts[k];
  }
  fill_edges(im, edges, color);
}

void draw_circles(uint8_t* data, int h, int w, int nch, const int64_t* centers,
                  const int32_t* radii, const int32_t* thicknesses, int n, const uint8_t* color,
                  int line_type, int shift) {
  Img im{data, h, w, nch, (size_t)w * nch};
  const P* v = reinterpret_cast<const P*>(centers);
  for (int k = 0; k < n; ++k) circle_any(im, v[k], radii[k], color, thicknesses[k], line_type, shift);
}

// Blends n glyph coverage bitmaps (alpha + offs[k], gh[k] x gw[k], top-left
// at (gx[k], gy[k])) into the image: dst + ((color - dst) * a + 127) / 255
// (floor) on the first three channels; a fourth channel takes the coverage
// where it is non-zero.
void blend_glyphs(uint8_t* data, int h, int w, int nch, const uint8_t* alpha, const int64_t* offs,
                  const int32_t* gh, const int32_t* gw, const int32_t* gx, const int32_t* gy,
                  int n, const uint8_t* color) {
  Img im{data, h, w, nch, (size_t)w * nch};
  int nc = std::min(nch, 3);
  for (int k = 0; k < n; ++k) {
    int y0 = std::max(0, -gy[k]), y1 = std::min(gh[k], h - gy[k]);
    int x0 = std::max(0, -gx[k]), x1 = std::min(gw[k], w - gx[k]);
    for (int y = y0; y < y1; ++y) {
      const uint8_t* arow = alpha + offs[k] + (int64_t)y * gw[k];
      for (int x = x0; x < x1; ++x) {
        int a = arow[x];
        if (a == 0) continue;
        uint8_t* p = im.px(gx[k] + x, gy[k] + y);
        for (int c = 0; c < nc; ++c) {
          int d = p[c], num = (color[c] - d) * a + 127;
          p[c] = (uint8_t)(d + (num >= 0 ? num / 255 : -((-num + 254) / 255)));
        }
        if (nch == 4) p[3] = (uint8_t)a;
      }
    }
  }
}

// cv2.resize(INTER_LINEAR) of uint8 from precomputed taps: rows in 11-bit
// fixed point (sum of two taps), then the vertical pass as cv2's
// VResizeLinear rounds it: ((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16)
// + 2 >> 2, saturated.
void resize_linear_u8(const uint8_t* src, int sh, int sw, int nch, uint8_t* dst, int dh, int dw,
                      const int32_t* xo0, const int32_t* xo1, const int32_t* wx0,
                      const int32_t* wx1, const int32_t* yo0, const int32_t* yo1,
                      const int32_t* wy0, const int32_t* wy1) {
  std::vector<int32_t> r0((size_t)dw * nch), r1((size_t)dw * nch);
  int c0 = -1, c1 = -1;
  auto hpass = [&](int sy, std::vector<int32_t>& row) {
    const uint8_t* s = src + (size_t)sy * sw * nch;
    for (int x = 0; x < dw; ++x)
      for (int c = 0; c < nch; ++c)
        row[(size_t)x * nch + c] = s[(size_t)xo0[x] * nch + c] * wx0[x] + s[(size_t)xo1[x] * nch + c] * wx1[x];
  };
  for (int y = 0; y < dh; ++y) {
    if (yo0[y] != c0) {
      if (yo0[y] == c1) std::swap(r0, r1), std::swap(c0, c1);
      else hpass(yo0[y], r0), c0 = yo0[y];
    }
    if (yo1[y] != c1) hpass(yo1[y], r1), c1 = yo1[y];
    uint8_t* d = dst + (size_t)y * dw * nch;
    for (int i = 0; i < dw * nch; ++i) {
      int v = (((wy0[y] * (r0[i] >> 4)) >> 16) + ((wy1[y] * (r1[i] >> 4)) >> 16) + 2) >> 2;
      d[i] = sat8(v);
    }
  }
}

// cv2.addWeighted on uint8: fma(a, alpha, fma(b, beta, gamma)) in float32,
// rounded half to even and saturated, as cv2's vector path computes it.
void add_weighted_u8(const uint8_t* a, float alpha, const uint8_t* b, float beta, float gamma,
                     uint8_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    float v = std::fma((float)a[i], alpha, std::fma((float)b[i], beta, gamma));
    out[i] = sat8((int)std::nearbyint(v));
  }
}

// cv2.cvtColor(COLOR_YUV2BGR_I420): BT.601 studio swing, 20-bit fixed
// point, each chroma sample shared by its 2x2 block.
void i420_to_bgr(const uint8_t* yuv, int h, int w, uint8_t* out) {
  const int CY = 1220542, CUB = 2116026, CUG = -409993, CVG = -852492, CVR = 1673527, SHIFT = 20;
  const uint8_t* u_plane = yuv + (size_t)h * w;
  const uint8_t* v_plane = u_plane + (size_t)(h / 2) * (w / 2);
  for (int y = 0; y < h; ++y) {
    const uint8_t* yrow = yuv + (size_t)y * w;
    const uint8_t* urow = u_plane + (size_t)(y / 2) * (w / 2);
    const uint8_t* vrow = v_plane + (size_t)(y / 2) * (w / 2);
    uint8_t* o = out + (size_t)y * w * 3;
    for (int x = 0; x < w; ++x) {
      int uu = (int)urow[x / 2] - 128, vv = (int)vrow[x / 2] - 128;
      int ruv = (1 << (SHIFT - 1)) + CVR * vv;
      int guv = (1 << (SHIFT - 1)) + CVG * vv + CUG * uu;
      int buv = (1 << (SHIFT - 1)) + CUB * uu;
      int yy = std::max(0, (int)yrow[x] - 16) * CY;
      o[3 * x + 0] = sat8((yy + buv) >> SHIFT);
      o[3 * x + 1] = sat8((yy + guv) >> SHIFT);
      o[3 * x + 2] = sat8((yy + ruv) >> SHIFT);
    }
  }
}

}  // extern "C"
