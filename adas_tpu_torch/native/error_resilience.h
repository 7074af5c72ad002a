// FFmpeg's error resilience (libavcodec/error_resilience.c) as cv2's build
// runs it: error_concealment 3 (FF_EC_GUESS_MVS | FF_EC_DEBLOCK), frames
// only, no data partitioning.  Shared by the MPEG-4 Part 2 decoder
// (mpeg4.cpp) and the H.264 decoder (h264.cpp).
//
// A decoder marks, per slice or video packet, where its macroblocks started,
// ended or failed (add_slice, FFmpeg's ff_er_add_slice); at the end of a
// picture frame_end (ff_er_frame_end) decides whether anything was lost,
// spreads the marks as FFmpeg does, guesses the type of each lost
// macroblock (is_intra_more_likely), conceals the inter ones by motion
// compensation from a guessed vector (guess_mv, through the decoder's
// decode_mb), the intra ones by a flat block of a guessed DC (guess_dc,
// filter181, put_dc), and smooths the edges of what it concealed
// (h_block_filter, v_block_filter).  The decoder hands over its picture
// planes, macroblock types and motion vectors in FFmpeg's layouts.
#pragma once

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace er {

// the status bits of a macroblock
enum : uint8_t {
  kVpStart = 1,  // the first macroblock after a resync (a slice or video packet)
  kAcError = 2,
  kDcError = 4,
  kMvError = 8,
  kAcEnd = 16,
  kDcEnd = 32,
  kMvEnd = 64,
  kMbError = kAcError | kDcError | kMvError,
  kMbEnd = kAcEnd | kDcEnd | kMvEnd,
};

// what concealment reads of a macroblock's type (FFmpeg's MB_TYPE_ bits it
// tests without data partitioning): intra or inter
enum : uint8_t { kTypeInter = 0, kTypeIntra = 1 };

enum { kMvDirForward = 1, kMvDirBackward = 2 };

struct Plane3 {
  uint8_t* data[3] = {nullptr, nullptr, nullptr};
  int linesize[3] = {0, 0, 0};
  bool valid() const { return data[0] != nullptr; }
};

// A picture as concealment reads it: planes, and the motion of list 0 in
// FFmpeg's layout (MPEG-4: one vector per 8x8 block, stride b8_stride;
// H.264: one per 4x4 block, stride 4 * mb_width) with a reference index per
// 8x8 block (4 per macroblock, by mb_xy).  Null fields are absent.
struct Pic {
  Plane3 planes;
  int16_t (*motion_val)[2] = nullptr;
  int8_t* ref_index = nullptr;
};

class Context {
 public:
  virtual ~Context() = default;

  // the geometry; mb_stride is mb_width + 1 as in FFmpeg
  void init(int mb_width, int mb_height, bool h264_layout) {
    mb_w = mb_width;
    mb_h = mb_height;
    mb_stride = mb_w + 1;
    mb_num = mb_w * mb_h;
    b8_stride = 2 * mb_w + 1;
    h264 = h264_layout;
    status.assign(size_t(mb_stride) * mb_h + 1, 0);
    index2xy.resize(size_t(mb_num) + 1);
    for (int y = 0; y < mb_h; y++)
      for (int x = 0; x < mb_w; x++) index2xy[size_t(x) + size_t(y) * mb_w] = x + y * mb_stride;
    index2xy[size_t(mb_num)] = (mb_h - 1) * mb_stride + mb_w;
    // the DC tables with FFmpeg's geometry: luma per 8x8 block (stride
    // b8_stride, one padding row and column before), chroma per macroblock
    dc_base[0].assign(size_t(b8_stride) * (2 * mb_h + 1) + 2, 1024);
    dc_base[1].assign(size_t(mb_stride) * (mb_h + 1) + 2, 1024);
    dc_base[2].assign(size_t(mb_stride) * (mb_h + 1) + 2, 1024);
    dc[0] = dc_base[0].data() + b8_stride + 1;
    dc[1] = dc_base[1].data() + mb_stride + 1;
    dc[2] = dc_base[2].data() + mb_stride + 1;
    fixed.assign(size_t(mb_stride) * mb_h, 0);
    blocklist.resize(size_t(mb_stride) * mb_h);
    next_blocklist.resize(size_t(mb_stride) * mb_h);
  }

  // ff_er_frame_start
  void frame_start() {
    std::fill(status.begin(), status.begin() + long(mb_stride) * mb_h,
              uint8_t(kMbError | kVpStart | kMbEnd));
    error_count = 3L * mb_num;
  }

  // ff_er_add_slice: macroblocks (startx, starty) up to (endx, endy) ended
  // with `st` (end or error bits) at the last
  void add_slice(int startx, int starty, int endx, int endy, int st) {
    const int start_i = std::min(std::max(startx + starty * mb_w, 0), mb_num - 1);
    const int end_i = std::min(std::max(endx + endy * mb_w, 0), mb_num);
    const int start_xy = index2xy[size_t(start_i)];
    const int end_xy = index2xy[size_t(end_i)];
    int mask = -1;
    if (start_i > end_i || start_xy > end_xy) return;  // "slice end before start"
    mask &= ~kVpStart;
    if (st & (kAcError | kAcEnd)) {
      mask &= ~(kAcError | kAcEnd);
      error_count += start_i - end_i - 1;
    }
    if (st & (kDcError | kDcEnd)) {
      mask &= ~(kDcError | kDcEnd);
      error_count += start_i - end_i - 1;
    }
    if (st & (kMvError | kMvEnd)) {
      mask &= ~(kMvError | kMvEnd);
      error_count += start_i - end_i - 1;
    }
    if (st & kMbError) error_count = INT_MAX;
    if (mask == ~0x7F) {
      std::memset(&status[size_t(start_xy)], 0, size_t(end_xy - start_xy));
    } else {
      for (int i = start_xy; i < end_xy; i++) status[size_t(i)] &= uint8_t(mask);
    }
    if (end_i == mb_num) {
      error_count = INT_MAX;
    } else {
      status[size_t(end_xy)] &= uint8_t(mask);
      status[size_t(end_xy)] |= uint8_t(st);
    }
    status[size_t(start_xy)] |= kVpStart;
    if (start_xy > 0 && start_i > 0) {
      int prev = status[size_t(index2xy[size_t(start_i - 1)])] & ~kVpStart;
      if (prev != kMbEnd) error_count = INT_MAX;
    }
  }

  // ff_er_frame_end over `cur` (with `mb_type`, one per mb_xy), `last` and
  // `next` (absent: planes null); returns the number of macroblocks it
  // concealed, 0 when it did not run
  long frame_end() {
    if (!error_count) return 0;
    return conceal();
  }

  // the decoder's side
  int mb_w = 0, mb_h = 0, mb_stride = 0, mb_num = 0, b8_stride = 0;
  bool h264 = false;
  std::vector<uint8_t> status;
  std::vector<int> index2xy;
  long error_count = 0;
  Pic cur, last, next;
  uint8_t* mb_type = nullptr;            // cur's, per mb_xy
  uint8_t* mbskip = nullptr;             // the decoder's skip table (MPEG-4), or null
  bool b_picture = false, i_picture = false;
  int pp_time = 0, pb_time = 0;          // MPEG-4 B-VOP times (0: none)
  int mv[2][2] = {};  // the vector of each direction

 protected:
  // render macroblock (mb_x, mb_y) as one 16x16 partition predicted along
  // mv_dir with mv[direction] (no residual), list 0 from reference `ref`
  virtual void decode_mb(int ref, int mv_dir, const int (*mv)[2], int mb_x, int mb_y) = 0;

 private:
  std::vector<int16_t> dc_base[3];
  int16_t* dc[3] = {nullptr, nullptr, nullptr};
  std::vector<uint8_t> fixed;
  std::vector<std::pair<int, int>> blocklist, next_blocklist;

  static bool is_intra(uint8_t t) { return t & kTypeIntra; }

  void mv_strides(int& step, int& stride) const {
    if (h264) {
      step = 4;
      stride = mb_w * 4;
    } else {
      step = 2;
      stride = b8_stride;
    }
  }

  static uint8_t clip_u8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

  void put_dc(uint8_t* dy, uint8_t* dcb, uint8_t* dcr, int mb_x, int mb_y) {
    const int* ls = cur.planes.linesize;
    for (int i = 0; i < 4; i++) {
      int d = dc[0][mb_x * 2 + (i & 1) + (mb_y * 2 + (i >> 1)) * b8_stride];
      d = d < 0 ? 0 : d > 2040 ? 2040 : d;
      for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) dy[x + (i & 1) * 8 + (y + (i >> 1) * 8) * ls[0]] = uint8_t(d / 8);
    }
    int du = dc[1][mb_x + mb_y * mb_stride], dv = dc[2][mb_x + mb_y * mb_stride];
    du = du < 0 ? 0 : du > 2040 ? 2040 : du;
    dv = dv < 0 ? 0 : dv > 2040 ? 2040 : dv;
    for (int y = 0; y < 8; y++)
      for (int x = 0; x < 8; x++) {
        dcb[x + y * ls[1]] = uint8_t(du / 8);
        dcr[x + y * ls[2]] = uint8_t(dv / 8);
      }
  }

  static int clip_filter(int v) {
    const int lo = INT_MIN / 10923, hi = INT_MAX / 10923 - 32768;
    v = v < lo ? lo : v > hi ? hi : v;
    return (v * 10923 + 32768) >> 16;
  }

  static void filter181(int16_t* d, int w, int h, int stride) {
    for (int y = 1; y < h - 1; y++) {
      int prev = d[y * stride];
      for (int x = 1; x < w - 1; x++) {
        int v = -prev + d[x + y * stride] * 8 - d[x + 1 + y * stride];
        prev = d[x + y * stride];
        d[x + y * stride] = int16_t(clip_filter(v));
      }
    }
    for (int x = 1; x < w - 1; x++) {
      int prev = d[x];
      for (int y = 1; y < h - 1; y++) {
        int v = -prev + d[x + y * stride] * 8 - d[x + (y + 1) * stride];
        prev = d[x + y * stride];
        d[x + y * stride] = int16_t(clip_filter(v));
      }
    }
  }

  // guess_dc over a w x h grid of 8x8 blocks (luma: is_luma, two per
  // macroblock side)
  void guess_dc(int16_t* d, int w, int h, int stride, int is_luma) {
    std::vector<int16_t> col(size_t(stride) * h * 4);
    std::vector<uint32_t> dist(size_t(stride) * h * 4);
    auto source = [&](int bx, int by) {
      int xy = (bx >> is_luma) + (by >> is_luma) * mb_stride;
      return !is_intra(mb_type[xy]) || !(status[size_t(xy)] & kDcError);
    };
    for (int by = 0; by < h; by++) {
      int color = 1024, distance = -1;
      for (int bx = 0; bx < w; bx++) {
        if (source(bx, by)) {
          color = d[bx + by * stride];
          distance = bx;
        }
        size_t k = size_t(bx + by * stride) * 4;
        col[k + 1] = int16_t(color);
        dist[k + 1] = distance >= 0 ? uint32_t(bx - distance) : 9999;
      }
      color = 1024;
      distance = -1;
      for (int bx = w - 1; bx >= 0; bx--) {
        if (source(bx, by)) {
          color = d[bx + by * stride];
          distance = bx;
        }
        size_t k = size_t(bx + by * stride) * 4;
        col[k + 0] = int16_t(color);
        dist[k + 0] = distance >= 0 ? uint32_t(distance - bx) : 9999;
      }
    }
    for (int bx = 0; bx < w; bx++) {
      int color = 1024, distance = -1;
      for (int by = 0; by < h; by++) {
        if (source(bx, by)) {
          color = d[bx + by * stride];
          distance = by;
        }
        size_t k = size_t(bx + by * stride) * 4;
        col[k + 3] = int16_t(color);
        dist[k + 3] = distance >= 0 ? uint32_t(by - distance) : 9999;
      }
      color = 1024;
      distance = -1;
      for (int by = h - 1; by >= 0; by--) {
        if (source(bx, by)) {
          color = d[bx + by * stride];
          distance = by;
        }
        size_t k = size_t(bx + by * stride) * 4;
        col[k + 2] = int16_t(color);
        dist[k + 2] = distance >= 0 ? uint32_t(distance - by) : 9999;
      }
    }
    for (int by = 0; by < h; by++)
      for (int bx = 0; bx < w; bx++) {
        int xy = (bx >> is_luma) + (by >> is_luma) * mb_stride;
        if (!is_intra(mb_type[xy]) || !(status[size_t(xy)] & kDcError)) continue;
        int64_t guess = 0, weight_sum = 0;
        size_t k = size_t(bx + by * stride) * 4;
        for (int j = 0; j < 4; j++) {
          int64_t weight = int64_t(256) * 256 * 256 * 16 / std::max<uint32_t>(dist[k + j], 1);
          guess += weight * int64_t(col[k + j]);
          weight_sum += weight;
        }
        d[bx + by * stride] = int16_t((guess + weight_sum / 2) / weight_sum);
      }
  }

  // h_block_filter (vertical edges, horizontal smoothing) when !vertical,
  // v_block_filter (horizontal edges) when vertical
  void block_filter(uint8_t* dst, int w, int h, int stride, int is_luma, bool vertical) {
    int step, mstride;
    mv_strides(step, mstride);
    int mvx_stride = step >> is_luma;
    int mvy_stride = mstride * mvx_stride;
    const int16_t(*mvs)[2] = cur.motion_val;
    for (int by = 0; by < h - (vertical ? 1 : 0); by++)
      for (int bx = 0; bx < w - (vertical ? 0 : 1); bx++) {
        int ax = bx >> is_luma, ay = by >> is_luma;
        int cx = (bx + !vertical) >> is_luma, cy = (by + vertical) >> is_luma;
        int sa = status[size_t(ax + ay * mb_stride)], sb = status[size_t(cx + cy * mb_stride)];
        bool ia = is_intra(mb_type[ax + ay * mb_stride]), ib = is_intra(mb_type[cx + cy * mb_stride]);
        int da = sa & kMbError, db = sb & kMbError;
        int off = bx * 8 + by * stride * 8;
        const int16_t* ma = mvs[mvy_stride * by + mvx_stride * bx];
        const int16_t* mb = vertical ? mvs[mvy_stride * (by + 1) + mvx_stride * bx]
                                     : mvs[mvy_stride * by + mvx_stride * (bx + 1)];
        if (!(da || db)) continue;
        // FFmpeg's filters compare the vertical components by their sum
        if (!ia && !ib && std::abs(ma[0] - mb[0]) + std::abs(ma[1] + mb[1]) < 2) continue;
        int s = vertical ? stride : 1, t = vertical ? 1 : stride;
        for (int k = 0; k < 8; k++) {
          uint8_t* p = dst + off + k * t;
          int a = p[7 * s] - p[6 * s], b = p[8 * s] - p[7 * s], c = p[9 * s] - p[8 * s];
          int d = std::abs(b) - ((std::abs(a) + std::abs(c) + 1) >> 1);
          d = std::max(d, 0);
          if (b < 0) d = -d;
          if (d == 0) continue;
          if (!(da && db)) d = d * 16 / 9;
          if (da) {
            p[7 * s] = clip_u8(p[7 * s] + ((d * 7) >> 4));
            p[6 * s] = clip_u8(p[6 * s] + ((d * 5) >> 4));
            p[5 * s] = clip_u8(p[5 * s] + ((d * 3) >> 4));
            p[4 * s] = clip_u8(p[4 * s] + ((d * 1) >> 4));
          }
          if (db) {
            p[8 * s] = clip_u8(p[8 * s] - ((d * 7) >> 4));
            p[9 * s] = clip_u8(p[9 * s] - ((d * 5) >> 4));
            p[10 * s] = clip_u8(p[10 * s] - ((d * 3) >> 4));
            p[11 * s] = clip_u8(p[11 * s] - ((d * 1) >> 4));
          }
        }
      }
  }

  bool is_intra_more_likely() {
    if (!last.planes.valid()) return true;
    int undamaged = 0;
    for (int i = 0; i < mb_num; i++) {
      int e = status[size_t(index2xy[size_t(i)])];
      if (!((e & kDcError) && (e & kMvError))) undamaged++;
    }
    if (undamaged < 5) return false;
    int skip_amount = std::max(undamaged / 50, 1);
    int likely = 0, j = 0;
    for (int y = 0; y < mb_h - 1; y++)
      for (int x = 0; x < mb_w; x++) {
        int xy = x + y * mb_stride;
        int e = status[size_t(xy)];
        if ((e & kDcError) && (e & kMvError)) continue;
        j++;
        if (j % skip_amount) continue;
        if (i_picture) {
          int ls = cur.planes.linesize[0];
          const uint8_t* p = cur.planes.data[0] + x * 16 + y * 16 * ls;
          const uint8_t* q = last.planes.data[0] + x * 16 + y * 16 * ls;
          likely += sad16(q, p, ls);
          likely -= sad16(q, q + ls * 16, ls);
        } else {
          likely += is_intra(mb_type[xy]) ? 1 : -1;
        }
      }
    return likely > 0;
  }

  static int sad16(const uint8_t* a, const uint8_t* b, int ls) {
    int s = 0;
    for (int y = 0; y < 16; y++)
      for (int x = 0; x < 16; x++) s += std::abs(a[x + y * ls] - b[x + y * ls]);
    return s;
  }

  enum { kFrozen = 8, kChanged = 4, kUnchanged = 2, kListed = 1 };

  void add_blocklist(std::vector<std::pair<int, int>>& list, int& n, int x, int y, int xy) {
    if (fixed[size_t(xy)]) return;
    fixed[size_t(xy)] = kListed;
    list[size_t(n++)] = {x, y};
  }

  // (FFmpeg clips the rows to its references' heights: the decoders hand
  // over references of the picture's size only)
  void guess_mv() {
    const int height = mb_h;
    int step, mstride;
    mv_strides(step, mstride);
    int16_t(*mvs)[2] = cur.motion_val;
    int num_avail = 0;
    for (int i = 0; i < mb_w * height; i++) {
      const int xy = index2xy[size_t(i)];
      int f = 0;
      if (is_intra(mb_type[xy])) f = kFrozen;
      if (!(status[size_t(xy)] & kMvError)) f = kFrozen;
      fixed[size_t(xy)] = uint8_t(f);
      if (f == kFrozen) {
        num_avail++;
      } else if (last.planes.valid() && last.motion_val) {
        int y = xy / mb_stride, x = xy % mb_stride;
        int mi = (x + y * mstride) * step;
        mvs[mi][0] = last.motion_val[mi][0];
        mvs[mi][1] = last.motion_val[mi][1];
        cur.ref_index[4 * xy] = last.ref_index[4 * xy];
      }
    }
    if (num_avail <= std::max(mb_w, height) / 2) {
      for (int y = 0; y < height; y++)
        for (int x = 0; x < mb_w; x++) {
          int xy = x + y * mb_stride;
          int dir = last.planes.valid() ? kMvDirForward : kMvDirBackward;
          if (is_intra(mb_type[xy])) continue;
          if (!(status[size_t(xy)] & kMvError)) continue;
          mv[0][0] = mv[0][1] = 0;
          decode_mb(0, dir, mv, x, y);
        }
      return;
    }
    int n = 0;
    for (int y = 0; y < height; y++)
      for (int x = 0; x < mb_w; x++) {
        int xy = x + y * mb_stride;
        if (fixed[size_t(xy)] == kFrozen) {
          if (x) add_blocklist(blocklist, n, x - 1, y, xy - 1);
          if (y) add_blocklist(blocklist, n, x, y - 1, xy - mb_stride);
          if (x + 1 < mb_w) add_blocklist(blocklist, n, x + 1, y, xy + 1);
          if (y + 1 < height) add_blocklist(blocklist, n, x, y + 1, xy + mb_stride);
        }
      }
    for (;;) {
      bool none_left = true;
      int changed = 1;
      for (int pass = 0; (changed || pass < 2) && pass < 10; pass++) {
        changed = 0;
        for (int bi = 0; bi < n; bi++) {
          const int x = blocklist[size_t(bi)].first, y = blocklist[size_t(bi)].second;
          const int xy = x + y * mb_stride;
          if ((x ^ y ^ pass) & 1) continue;
          int j = 0;
          if (x > 0) j |= fixed[size_t(xy - 1)];
          if (x + 1 < mb_w) j |= fixed[size_t(xy + 1)];
          if (y > 0) j |= fixed[size_t(xy - mb_stride)];
          if (y + 1 < height) j |= fixed[size_t(xy + mb_stride)];
          if (!(j & kChanged) && pass > 1) continue;
          none_left = false;
          int pred[8][2], ref[8], pc = 0;
          const int mi = (x + y * mstride) * step;
          auto take = [&](int m, int rxy) {
            pred[pc][0] = mvs[m][0];
            pred[pc][1] = mvs[m][1];
            ref[pc] = cur.ref_index[4 * rxy];
            pc++;
          };
          if (x > 0 && fixed[size_t(xy - 1)] > 1) take(mi - step, xy - 1);
          if (x + 1 < mb_w && fixed[size_t(xy + 1)] > 1) take(mi + step, xy + 1);
          if (y > 0 && fixed[size_t(xy - mb_stride)] > 1) take(mi - mstride * step, xy - mb_stride);
          if (y + 1 < height && fixed[size_t(xy + mb_stride)] > 1)
            take(mi + mstride * step, xy + mb_stride);
          if (pc == 0) continue;
          if (pc > 1) {
            int sx = 0, sy = 0, sr = 0, k = 0;
            bool same = true;
            for (k = 0; k < pc; k++) {
              sx += pred[k][0];
              sy += pred[k][1];
              sr += ref[k];
              if (k && ref[k] != ref[k - 1]) {
                same = false;
                break;
              }
            }
            if (same) {
              pred[pc][0] = sx / k;
              pred[pc][1] = sy / k;
              ref[pc] = sr / k;
              int maxx, maxy, minx, miny, maxr, minr;
              if (pc >= 3) {
                miny = minx = minr = 99999;
                maxy = maxx = maxr = -99999;
              } else {
                minx = miny = maxx = maxy = minr = maxr = 0;
              }
              for (k = 0; k < pc; k++) {
                maxx = std::max(maxx, pred[k][0]);
                maxy = std::max(maxy, pred[k][1]);
                maxr = std::max(maxr, ref[k]);
                minx = std::min(minx, pred[k][0]);
                miny = std::min(miny, pred[k][1]);
                minr = std::min(minr, ref[k]);
              }
              pred[pc + 1][0] = sx - maxx - minx;
              pred[pc + 1][1] = sy - maxy - miny;
              ref[pc + 1] = sr - maxr - minr;
              if (pc == 4) {
                pred[pc + 1][0] /= 2;
                pred[pc + 1][1] /= 2;
                ref[pc + 1] /= 2;
              }
              pc += 2;
            }
          }
          // the zero vector, then the vector this macroblock had
          pred[pc][0] = pred[pc][1] = ref[pc] = 0;
          pc++;
          const int prev_x = mvs[mi][0], prev_y = mvs[mi][1], prev_ref = cur.ref_index[4 * xy];
          pred[pc][0] = prev_x;
          pred[pc][1] = prev_y;
          ref[pc] = prev_ref;
          pc++;
          int best_pred = 0, best_score = 256 * 256 * 256 * 64;
          const int ls = cur.planes.linesize[0];
          const uint8_t* src = cur.planes.data[0] + x * 16 + y * 16 * ls;
          for (int k = 0; k < pc; k++) {
            mvs[mi][0] = int16_t(mv[0][0] = pred[k][0]);
            mvs[mi][1] = int16_t(mv[0][1] = pred[k][1]);
            if (ref[k] < 0) continue;
            decode_mb(ref[k], kMvDirForward, mv, x, y);
            int score = 0;
            if (x > 0 && fixed[size_t(xy - 1)] > 1)
              for (int q = 0; q < 16; q++) score += std::abs(src[q * ls - 1] - src[q * ls]);
            if (x + 1 < mb_w && fixed[size_t(xy + 1)] > 1)
              for (int q = 0; q < 16; q++) score += std::abs(src[q * ls + 15] - src[q * ls + 16]);
            if (y > 0 && fixed[size_t(xy - mb_stride)] > 1)
              for (int q = 0; q < 16; q++) score += std::abs(src[q - ls] - src[q]);
            if (y + 1 < height && fixed[size_t(xy + mb_stride)] > 1)
              for (int q = 0; q < 16; q++) score += std::abs(src[q + ls * 15] - src[q + ls * 16]);
            if (score <= best_score) {  // <= favours the last vector
              best_score = score;
              best_pred = k;
            }
          }
          mv[0][0] = pred[best_pred][0];
          mv[0][1] = pred[best_pred][1];
          for (int a = 0; a < step; a++)
            for (int b = 0; b < step; b++) {
              mvs[mi + a + b * mstride][0] = int16_t(mv[0][0]);
              mvs[mi + a + b * mstride][1] = int16_t(mv[0][1]);
            }
          decode_mb(ref[best_pred], kMvDirForward, mv, x, y);
          if (mv[0][0] != prev_x || mv[0][1] != prev_y) {
            fixed[size_t(xy)] = kChanged;
            changed++;
          } else {
            fixed[size_t(xy)] = kUnchanged;
          }
        }
      }
      if (none_left) return;
      int nn = 0;
      for (int bi = 0; bi < n; bi++) {
        const int x = blocklist[size_t(bi)].first, y = blocklist[size_t(bi)].second;
        const int xy = x + y * mb_stride;
        if (fixed[size_t(xy)] & (kChanged | kUnchanged | kFrozen)) {
          fixed[size_t(xy)] = kFrozen;
          if (x > 0) add_blocklist(next_blocklist, nn, x - 1, y, xy - 1);
          if (y > 0) add_blocklist(next_blocklist, nn, x, y - 1, xy - mb_stride);
          if (x + 1 < mb_w) add_blocklist(next_blocklist, nn, x + 1, y, xy + 1);
          if (y + 1 < height) add_blocklist(next_blocklist, nn, x, y + 1, xy + mb_stride);
        }
      }
      std::swap(blocklist, next_blocklist);
      n = nn;
    }
  }

  long conceal() {
    const int threshold = 50;
    // handle overlapping slices
    for (int type = 1; type <= 3; type++) {
      bool end_ok = false;
      for (int i = mb_num - 1; i >= 0; i--) {
        const int xy = index2xy[size_t(i)];
        int e = status[size_t(xy)];
        if (e & (1 << type)) end_ok = true;
        if (e & (8 << type)) end_ok = true;
        if (!end_ok) status[size_t(xy)] |= uint8_t(1 << type);
        if (e & kVpStart) end_ok = false;
      }
    }
    // backward mark errors
    int distance = 9999999;
    for (int type = 1; type <= 3; type++)
      for (int i = mb_num - 1; i >= 0; i--) {
        const int xy = index2xy[size_t(i)];
        int e = status[size_t(xy)];
        if (!mbskip || !mbskip[xy]) distance++;
        if (e & (1 << type)) distance = 0;
        if (distance < threshold) status[size_t(xy)] |= uint8_t(1 << type);
        if (e & kVpStart) distance = 9999999;
      }
    // forward mark errors
    int err = 0;
    for (int i = 0; i < mb_num; i++) {
      const int xy = index2xy[size_t(i)];
      int old = status[size_t(xy)];
      if (old & kVpStart) {
        err = old & kMbError;
      } else {
        err |= old & kMbError;
        status[size_t(xy)] |= uint8_t(err);
      }
    }
    // not partitioned: one error of a macroblock is all three
    long concealed = 0;
    for (int i = 0; i < mb_num; i++) {
      const int xy = index2xy[size_t(i)];
      int e = status[size_t(xy)];
      if (e & kMbError) {
        e |= kMbError;
        concealed++;
      }
      status[size_t(xy)] = uint8_t(e);
    }
    const bool intra_likely = is_intra_more_likely();
    for (int i = 0; i < mb_num; i++) {
      const int xy = index2xy[size_t(i)];
      int e = status[size_t(xy)];
      if (!((e & kDcError) && (e & kMvError))) continue;
      mb_type[xy] = intra_likely ? kTypeIntra : kTypeInter;
    }
    // inter blocks become intra without a reference
    if (!last.planes.valid() && !next.planes.valid())
      for (int i = 0; i < mb_num; i++) {
        const int xy = index2xy[size_t(i)];
        if (!is_intra(mb_type[xy])) mb_type[xy] = kTypeIntra;
      }
    // (inter macroblocks with a damaged residual but sound vectors only
    // arise in partitioned frames)
    if (b_picture) {
      for (int y = 0; y < mb_h; y++)
        for (int x = 0; x < mb_w; x++) {
          const int xy = x + y * mb_stride;
          const int b8 = x * 2 + y * 2 * b8_stride;
          int e = status[size_t(xy)];
          int dir = kMvDirForward | kMvDirBackward;
          if (is_intra(mb_type[xy])) continue;
          if (!(e & kMvError)) continue;
          if (!(e & kAcError)) continue;
          if (!last.planes.valid()) dir &= ~kMvDirForward;
          if (!next.planes.valid()) dir &= ~kMvDirBackward;
          if (pp_time) {
            mv[0][0] = next.motion_val[b8][0] * pb_time / pp_time;
            mv[0][1] = next.motion_val[b8][1] * pb_time / pp_time;
            mv[1][0] = next.motion_val[b8][0] * (pb_time - pp_time) / pp_time;
            mv[1][1] = next.motion_val[b8][1] * (pb_time - pp_time) / pp_time;
          } else {
            mv[0][0] = mv[0][1] = mv[1][0] = mv[1][1] = 0;
          }
          decode_mb(0, dir, mv, x, y);
        }
    } else {
      guess_mv();
    }
    // fill DC for every block
    const int* ls = cur.planes.linesize;
    for (int y = 0; y < mb_h; y++)
      for (int x = 0; x < mb_w; x++) {
        const uint8_t* dy = cur.planes.data[0] + x * 16 + y * 16 * ls[0];
        const uint8_t* du = cur.planes.data[1] + x * 8 + y * 8 * ls[1];
        const uint8_t* dv = cur.planes.data[2] + x * 8 + y * 8 * ls[2];
        int16_t* dp = &dc[0][x * 2 + y * 2 * b8_stride];
        for (int n = 0; n < 4; n++) {
          int s = 0;
          for (int yy = 0; yy < 8; yy++)
            for (int xx = 0; xx < 8; xx++) s += dy[xx + (n & 1) * 8 + (yy + (n >> 1) * 8) * ls[0]];
          dp[(n & 1) + (n >> 1) * b8_stride] = int16_t((s + 4) >> 3);
        }
        int su = 0, sv = 0;
        for (int yy = 0; yy < 8; yy++)
          for (int xx = 0; xx < 8; xx++) {
            su += du[xx + yy * ls[1]];
            sv += dv[xx + yy * ls[2]];
          }
        dc[1][x + y * mb_stride] = int16_t((su + 4) >> 3);
        dc[2][x + y * mb_stride] = int16_t((sv + 4) >> 3);
      }
    guess_dc(dc[0], mb_w * 2, mb_h * 2, b8_stride, 1);
    guess_dc(dc[1], mb_w, mb_h, mb_stride, 0);
    guess_dc(dc[2], mb_w, mb_h, mb_stride, 0);
    filter181(dc[0], mb_w * 2, mb_h * 2, b8_stride);
    // render the DC of damaged intra macroblocks
    for (int y = 0; y < mb_h; y++)
      for (int x = 0; x < mb_w; x++) {
        const int xy = x + y * mb_stride;
        if (!is_intra(mb_type[xy])) continue;
        if (!(status[size_t(xy)] & kAcError)) continue;
        put_dc(cur.planes.data[0] + x * 16 + y * 16 * ls[0],
               cur.planes.data[1] + x * 8 + y * 8 * ls[1],
               cur.planes.data[2] + x * 8 + y * 8 * ls[2], x, y);
      }
    // smooth the concealed edges (FF_EC_DEBLOCK)
    block_filter(cur.planes.data[0], mb_w * 2, mb_h * 2, ls[0], 1, false);
    block_filter(cur.planes.data[0], mb_w * 2, mb_h * 2, ls[0], 1, true);
    for (int c = 1; c < 3; c++) block_filter(cur.planes.data[c], mb_w, mb_h, ls[c], 0, false);
    for (int c = 1; c < 3; c++) block_filter(cur.planes.data[c], mb_w, mb_h, ls[c], 0, true);
    // clean a few tables
    for (int i = 0; i < mb_num; i++) {
      const int xy = index2xy[size_t(i)];
      if (mbskip && !b_picture && (status[size_t(xy)] & kMbError)) mbskip[xy] = 0;
    }
    return concealed;
  }
};

}  // namespace er
