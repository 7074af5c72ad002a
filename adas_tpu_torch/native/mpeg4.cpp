// MPEG-4 Part 2 video (ISO/IEC 14496-2, the `mp4v` of cv2.VideoWriter,
// XviD and DivX): a decoder of Simple and Advanced Simple streams and an
// encoder of Simple ones that writes what the decoder reads, for
// render/mpeg4.py.
//
// Decoder: VOS/VO/VOL/GOV/user-data headers; rectangular progressive VOLs
// with H.263 or MPEG quantisation (default and loaded matrices, FFmpeg's
// MPEG-2 unquantisers with their mismatch control); I-, P- and B-VOPs:
// intra DC VLCs with DC prediction, AC prediction, the TCOEF VLCs and
// their three escapes; 1MV and 4MV vectors with FFmpeg's median prediction,
// half- or quarter-sample (qpeldsp's 8-tap filter with mirrored edges, its
// rounding and no-rounding forms), f_code 1-7, unrestricted vectors through
// FFmpeg's edge emulation; not_coded and intra macroblocks; B-VOPs' direct
// (from the next P-VOP's co-located vectors and the VOP times),
// interpolated, forward and backward macroblocks, and those skipped in the
// next P-VOP; N-VOPs; resync markers (video packets, HEC); FFmpeg's output
// order, delay and flush, DivX's packed B-VOPs included.  From the user
// data (Lavc, XviD, DivX builds) and the AVI fourcc it picks, as
// libavcodec's ff_mpeg4_workaround_bugs does, the IDCT (FFmpeg's simple
// IDCT, or XviD's for XviD streams) and the build workarounds that change
// pictures (the edge, DC clipping, quarter-sample chroma).  Data
// partitioning (RVLC), sprites / GMC, OBMC, the short video header,
// NEWPRED, reduced resolution, scalability and other tools fail with an
// error that names them.  A VOP's damaged or cut data is decoded as
// FFmpeg's h263dec.c decodes it: the bit reader reads past the end as
// zeros, a video packet that fails marks its macroblocks and decoding goes
// on at the next resync marker, and at the VOP's end FFmpeg's error
// concealment (error_resilience.h) fills what was lost; headers FFmpeg
// refuses still fail.  No read leaves the input.  Errors are C++
// exceptions caught at the C entry points, which return -1 and keep the
// message.
//
// Encoder: an I-VOP every `gop` frames and P-VOPs between, a fixed
// vop_quant, 1MV half-pel motion search (diamond + half-pel refinement) in
// the f_code range, an intra / inter / not_coded decision per macroblock, a
// float forward DCT; every macroblock is reconstructed by the decoder's own
// routines (DC/AC prediction, dequantisation, IDCT, motion compensation),
// so decoding the stream gives the encoder's reference frames to the bit.
//
// Planes are macroblock-aligned inside and cropped to the VOL size at the
// C boundary: Y (w x h), then U and V ((w+1)/2 x (h+1)/2), packed.
#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// the largest picture decoded or encoded, in pixels (8K UHD fits)
constexpr long kMaxPixels = 1L << 25;

struct Error : std::runtime_error {
    using std::runtime_error::runtime_error;
};
[[noreturn]] void fail(const std::string& msg) { throw Error(msg); }

// ---------------------------------------------------------------- tables

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kAltHorizontal[64] = {
    0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14,
    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t kAltVertical[64] = {
    0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3,  11, 4,  12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};

struct Code {
    uint16_t code;
    uint8_t len;
};

// mcbpc of I-VOPs (Table B-6): 0-3 intra with cbpc 0-3, 4-7 intra+q, 8 stuffing
const Code kIntraMcbpc[9] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                             {1, 6}, {2, 6}, {3, 6}, {1, 9}};
constexpr int kIntraMcbpcStuffing = 8;
// mcbpc of P-VOPs (Table B-7), indexed by cbpc | 4 (intra) | 8 (dquant) |
// 16 (inter4v); 20 is stuffing; 24-27, H.263's inter4v+q, are not MPEG-4's
// but FFmpeg's table, shared by both, reads them (a damaged stream's)
const Code kInterMcbpc[28] = {
    {1, 1}, {3, 4}, {2, 4}, {5, 6},       // inter
    {3, 5}, {4, 8}, {3, 8}, {3, 7},       // intra
    {3, 3}, {7, 7}, {6, 7}, {5, 9},       // inter+q
    {4, 6}, {4, 9}, {3, 9}, {2, 9},       // intra+q
    {2, 3}, {5, 7}, {4, 7}, {5, 8},       // inter4v
    {1, 9}, {0, 0}, {0, 0}, {0, 0},       // stuffing
    {2, 11}, {12, 13}, {14, 13}, {15, 13}};  // inter4v+q
constexpr int kInterMcbpcStuffing = 20;
// cbpy (Table B-8) of intra macroblocks; inter ones code 15 - cbpy
const Code kCbpy[16] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4}, {2, 6}, {11, 4},
                        {2, 5}, {3, 6}, {5, 4}, {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};
// motion vector data (Table B-12) by |motion_code| 0..32; a sign bit follows
const Code kMvd[33] = {
    {1, 1},   {1, 2},   {1, 3},   {1, 4},   {3, 6},   {5, 7},   {4, 7},   {3, 7},
    {11, 9},  {10, 9},  {9, 9},   {17, 10}, {16, 10}, {15, 10}, {14, 10}, {13, 10},
    {12, 10}, {11, 10}, {10, 10}, {9, 10},  {8, 10},  {7, 10},  {6, 10},  {5, 10},
    {4, 10},  {7, 11},  {6, 11},  {5, 11},  {4, 11},  {3, 11},  {2, 11},  {3, 12},
    {2, 12}};
// dct_dc_size of luma (Table B-13) and chroma (Table B-14), sizes 0..12
const Code kDcLuma[13] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3}, {1, 4}, {1, 5},
                          {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const Code kDcChroma[13] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4},  {1, 5}, {1, 6},
                            {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};

// TCOEF of intra blocks (Table B-16) and of inter blocks (Table B-17): 102
// (last, run, level) codes and the escape (index 102); entries before
// `last_start` have last = 0
struct RunLevel {
    Code codes[103];
    int8_t run[102];
    int8_t level[102];
    int last_start;
};
const RunLevel kIntraTcoef = {
    {{0x2, 2},  {0x6, 3},  {0xf, 4},  {0xd, 5},  {0xc, 5},  {0x15, 6}, {0x13, 6}, {0x12, 6},
     {0x17, 7}, {0x1f, 8}, {0x1e, 8}, {0x1d, 8}, {0x25, 9}, {0x24, 9}, {0x23, 9}, {0x21, 9},
     {0x21, 10}, {0x20, 10}, {0xf, 10}, {0xe, 10}, {0x7, 11}, {0x6, 11}, {0x20, 11}, {0x21, 11},
     {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4}, {0x14, 6}, {0x16, 7}, {0x1c, 8}, {0x20, 9},
     {0x1f, 9}, {0xd, 10}, {0x22, 11}, {0x53, 12}, {0x55, 12}, {0xb, 5}, {0x15, 7}, {0x1e, 9},
     {0xc, 10}, {0x56, 12}, {0x11, 6}, {0x1b, 8}, {0x1d, 9}, {0xb, 10}, {0x10, 6}, {0x22, 9},
     {0xa, 10}, {0xd, 6}, {0x1c, 9}, {0x8, 10}, {0x12, 7}, {0x1b, 9}, {0x54, 12}, {0x14, 7},
     {0x1a, 9}, {0x57, 12}, {0x19, 8}, {0x9, 10}, {0x18, 8}, {0x23, 11}, {0x17, 8}, {0x19, 9},
     {0x18, 9}, {0x7, 10}, {0x58, 12}, {0x7, 4}, {0xc, 6}, {0x16, 8}, {0x17, 9}, {0x6, 10},
     {0x5, 11}, {0x4, 11}, {0x59, 12}, {0xf, 6}, {0x16, 9}, {0x5, 10}, {0xe, 6}, {0x4, 10},
     {0x11, 7}, {0x24, 11}, {0x10, 7}, {0x25, 11}, {0x13, 7}, {0x5a, 12}, {0x15, 8}, {0x5b, 12},
     {0x14, 8}, {0x13, 8}, {0x1a, 8}, {0x15, 9}, {0x14, 9}, {0x13, 9}, {0x12, 9}, {0x11, 9},
     {0x26, 11}, {0x27, 11}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}},
    {0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,
     0,  0,  0,  0,  0,  0,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  2,  2,  2,  2,  2,
     3,  3,  3,  3,  4,  4,  4,  5,  5,  5,  6,  6,  6,  7,  7,  7,  8,  8,  9,  9,  10,
     11, 12, 13, 14, 0,  0,  0,  0,  0,  0,  0,  0,  1,  1,  1,  2,  2,  3,  3,  4,  4,
     5,  5,  6,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20},
    {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
     22, 23, 24, 25, 26, 27, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3, 4, 5,
     1, 2, 3, 4, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1,
     1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 1, 2, 1, 2, 1, 2,
     1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1},
    67};
const RunLevel kInterTcoef = {
    {{0x2, 2},  {0xf, 4},  {0x15, 6}, {0x17, 7}, {0x1f, 8}, {0x25, 9}, {0x24, 9}, {0x21, 10},
     {0x20, 10}, {0x7, 11}, {0x6, 11}, {0x20, 11}, {0x6, 3}, {0x14, 6}, {0x1e, 8}, {0xf, 10},
     {0x21, 11}, {0x50, 12}, {0xe, 4}, {0x1d, 8}, {0xe, 10}, {0x51, 12}, {0xd, 5}, {0x23, 9},
     {0xd, 10}, {0xc, 5}, {0x22, 9}, {0x52, 12}, {0xb, 5}, {0xc, 10}, {0x53, 12}, {0x13, 6},
     {0xb, 10}, {0x54, 12}, {0x12, 6}, {0xa, 10}, {0x11, 6}, {0x9, 10}, {0x10, 6}, {0x8, 10},
     {0x16, 7}, {0x55, 12}, {0x15, 7}, {0x14, 7}, {0x1c, 8}, {0x1b, 8}, {0x21, 9}, {0x20, 9},
     {0x1f, 9}, {0x1e, 9}, {0x1d, 9}, {0x1c, 9}, {0x1b, 9}, {0x1a, 9}, {0x22, 11}, {0x23, 11},
     {0x56, 12}, {0x57, 12}, {0x7, 4}, {0x19, 9}, {0x5, 11}, {0xf, 6}, {0x4, 11}, {0xe, 6},
     {0xd, 6}, {0xc, 6}, {0x13, 7}, {0x12, 7}, {0x11, 7}, {0x10, 7}, {0x1a, 8}, {0x19, 8},
     {0x18, 8}, {0x17, 8}, {0x16, 8}, {0x15, 8}, {0x14, 8}, {0x13, 8}, {0x18, 9}, {0x17, 9},
     {0x16, 9}, {0x15, 9}, {0x14, 9}, {0x13, 9}, {0x12, 9}, {0x11, 9}, {0x7, 10}, {0x6, 10},
     {0x5, 10}, {0x4, 10}, {0x24, 11}, {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12},
     {0x5a, 12}, {0x5b, 12}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}},
    {0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  1,  1,  1,  1,  1,  1,  2,  2,  2,
     2,  3,  3,  3,  4,  4,  4,  5,  5,  5,  6,  6,  6,  7,  7,  8,  8,  9,  9,  10, 10,
     11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 0,  0,  0,  1,  1,
     2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
     23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40},
    {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3,
     4, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 3, 1, 2,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1},
    58};
constexpr int kEscape = 102;

// intra_dc_vlc_thr: the intra DC VLC serves while QP is below this
const int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};
const int kDquant[4] = {-1, -2, 1, 2};

int luma_dc_scale(int q) { return q <= 4 ? 8 : q <= 8 ? 2 * q : q <= 24 ? q + 8 : 2 * q - 16; }
int chroma_dc_scale(int q) { return q <= 4 ? 8 : q <= 24 ? (q + 13) / 2 : q - 6; }

// ------------------------------------------------------------ bit reader

struct BitReader {
    const uint8_t* p;  // followed by at least 8 readable bytes
    size_t nbits;
    size_t pos = 0;
    // FFmpeg's unchecked reader (mpeg4videodec.c): reads past the end give
    // zeros and move on, as over the input's zero padding; `avail` bounds
    // the bytes actually read
    bool unchecked = false;
    size_t avail;

    BitReader(const uint8_t* data, size_t nbytes) : p(data), nbits(nbytes * 8), avail(nbytes + 8) {}
    uint32_t peek(int n) const {  // n <= 32; bits past the end read as 0
        size_t at = pos >> 3;
        uint64_t v = 0;
        if (at + 8 <= avail) {
            const uint8_t* b = p + at;
            for (int i = 0; i < 8; i++) v = v << 8 | b[i];
        } else {
            for (size_t i = 0; i < 8; i++) v = v << 8 | (at + i < avail ? p[at + i] : 0);
        }
        return uint32_t((v << (pos & 7)) >> (64 - n));
    }
    void skip(int n) {
        if (!unchecked && pos + n > nbits) fail("truncated MPEG-4 video data");
        pos += n;
    }
    uint32_t get(int n) {
        if (n == 0) return 0;
        uint32_t v = peek(n);
        skip(n);
        return v;
    }
    int get1() { return int(get(1)); }
    int sget(int n) {  // two's complement
        int v = int(get(n));
        return v >= (1 << (n - 1)) ? v - (1 << n) : v;
    }
    void marker(const char* where) {
        if (!get1()) fail(std::string("corrupt MPEG-4 video: marker bit missing in ") + where);
    }
    size_t left() const { return nbits > pos ? nbits - pos : 0; }
    long bits_left() const { return long(nbits) - long(pos); }  // FFmpeg's get_bits_left
};

struct Vlc {
    int bits = 0;
    std::vector<int16_t> sym;
    std::vector<uint8_t> len;

    Vlc(const Code* codes, int n) {
        for (int i = 0; i < n; i++) bits = std::max(bits, int(codes[i].len));
        sym.assign(size_t(1) << bits, -1);
        len.assign(size_t(1) << bits, 0);
        for (int i = 0; i < n; i++) {
            int l = codes[i].len;
            if (!l) continue;
            uint32_t first = uint32_t(codes[i].code) << (bits - l);
            for (uint32_t j = 0; j < (1u << (bits - l)); j++) {
                if (len[first | j]) std::abort();  // the table is not prefix-free
                sym[first | j] = int16_t(i);
                len[first | j] = uint8_t(l);
            }
        }
    }
    int decode(BitReader& br, const char* what) const {
        uint32_t v = br.peek(bits);
        if (!len[v]) {
            if (br.left() < size_t(bits)) fail("truncated MPEG-4 video data");
            fail(std::string("corrupt MPEG-4 video: invalid ") + what + " code");
        }
        br.skip(len[v]);
        return sym[v];
    }
};

// the largest level of each (last, run) and the largest run of each
// (last, level), for the first and second escapes
struct Escapes {
    int max_level[2][64];
    int max_run[2][65];
    explicit Escapes(const RunLevel& t) {
        std::memset(max_level, 0, sizeof max_level);
        std::memset(max_run, 0, sizeof max_run);
        for (int i = 0; i < kEscape; i++) {
            int last = i >= t.last_start, run = t.run[i], level = t.level[i];
            max_level[last][run] = std::max(max_level[last][run], level);
            max_run[last][level] = std::max(max_run[last][level], run);
        }
    }
};

struct Tables {
    Vlc intra_mcbpc{kIntraMcbpc, 9}, inter_mcbpc{kInterMcbpc, 28}, cbpy{kCbpy, 16},
        mvd{kMvd, 33}, dc_luma{kDcLuma, 13}, dc_chroma{kDcChroma, 13},
        intra_tcoef{kIntraTcoef.codes, 103}, inter_tcoef{kInterTcoef.codes, 103};
    Escapes intra_esc{kIntraTcoef}, inter_esc{kInterTcoef};
    // the encoder's index of each (last, run, level), -1 where none
    int16_t intra_index[2][64][28], inter_index[2][64][28];
    Tables() {
        for (auto* idx : {&intra_index, &inter_index}) std::memset(idx, 0xff, sizeof *idx);
        for (int i = 0; i < kEscape; i++) {
            intra_index[i >= kIntraTcoef.last_start][kIntraTcoef.run[i]][kIntraTcoef.level[i]] =
                int16_t(i);
            inter_index[i >= kInterTcoef.last_start][kInterTcoef.run[i]][kInterTcoef.level[i]] =
                int16_t(i);
        }
    }
};
const Tables& tables() {
    static const Tables t;
    return t;
}

// ------------------------------------------------- FFmpeg's simple IDCT

#include "simple_idct.h"

// ------------------------------------------------------------ shared state

int median(int a, int b, int c) {
    return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// one bw x bh half-sample prediction from the (bw + 1) x (bh + 1) window.
// Without rounding, x86 libavcodec's 8-wide x2 and y2 averages are pavgb of
// one operand less 1 (saturated): the left sample, and of two rows the odd
// one (put_no_rnd_pixels8_{x2,y2}_mmxext), a level off where that sample is 0
void hpel_mc(const uint8_t* s, int ss, int bw, int bh, int dxy, int rnd, uint8_t* o) {
    bool approx = !rnd && bw == 8;
    auto dec1 = [](int v) { return v ? v - 1 : 0; };
    for (int j = 0; j < bh; j++)
        for (int i = 0; i < bw; i++) {
            const uint8_t* p = s + j * ss + i;
            int v;
            switch (dxy) {
                case 0: v = p[0]; break;
                case 1: v = approx ? (dec1(p[0]) + p[1] + 1) >> 1 : (p[0] + p[1] + rnd) >> 1; break;
                case 2:
                    v = !approx ? (p[0] + p[ss] + rnd) >> 1
                        : (j & 1) ? (dec1(p[0]) + p[ss] + 1) >> 1 : (p[0] + dec1(p[ss]) + 1) >> 1;
                    break;
                default: v = (p[0] + p[1] + p[ss] + p[ss + 1] + 1 + rnd) >> 2;
            }
            o[j * bw + i] = uint8_t(v);
        }
}

// decoder counters, read by the tests to show which tools a stream used
enum Stat {
    kIVops, kPVops, kRound0, kRound1, kIntraMbI, kIntraMbP, kInterMb, kNotCoded, kAcPredOn,
    kAcPredOff, kEsc1, kEsc2, kEsc3, kMaxFcode, kMvOutside, kDquantMb, kBVops, kNVops,
    kInter4vMb, kDirectMb, kDirect8x8Mb, kForwardMb, kBackwardMb, kInterpolateMb, kBSkippedMb,
    kDbquantMb, kMaxBcode, kQpelVops, kMpegQuantVops, kCustomMatrices, kPackets, kHecPackets,
    kPackedBVops, kXvidIdctVops, kInterlacedVops, kAltScanVops, kFieldMb, kFieldDctMb,
    kFieldDirectMb, kConcealedMbs, kDamagedVops, kDamagedPackets, kResyncs, kConcealUs,
    kTimeBitsGuessed, kDamagedHeaders, kNumStats
};

struct Codec {
    int w = 0, h = 0, mbw = 0, mbh = 0;
    int ys = 0, cs = 0;        // strides of the MB-aligned planes
    int edge_w = 0, edge_h = 0;  // luma clamp edges of motion compensation
    std::vector<uint8_t> cur[3], ref[3];
    std::vector<int16_t> dc[3], ac[3];  // per 8x8 block (chroma: per MB)
    std::vector<int8_t> mbq;
    std::vector<int16_t> mvs;  // per MB, (x, y) in half-pels
    bool have_ref = false;
    long stats[kNumStats] = {};

    void init(int width, int height) {
        if (width <= 0 || height <= 0 || long(width) * height > kMaxPixels)
            fail("MPEG-4 video of " + std::to_string(width) + "x" + std::to_string(height) +
                 " pixels is empty or larger than " + std::to_string(kMaxPixels));
        w = width;
        h = height;
        mbw = (w + 15) / 16;
        mbh = (h + 15) / 16;
        ys = mbw * 16;
        cs = mbw * 8;
        // FFmpeg's h_edge_pos / v_edge_pos: the macroblock-aligned size
        edge_w = mbw * 16;
        edge_h = mbh * 16;
        for (int c = 0; c < 3; c++) {
            size_t n = c ? size_t(cs) * mbh * 8 : size_t(ys) * mbh * 16;
            cur[c].assign(n, 0);
            ref[c].assign(n, 0);
            size_t nb = c ? size_t(mbw) * mbh : size_t(4) * mbw * mbh;
            dc[c].assign(nb, 1024);
            ac[c].assign(nb * 16, 0);
        }
        mbq.assign(size_t(mbw) * mbh, 1);
        mvs.assign(size_t(mbw) * mbh * 2, 0);
        have_ref = false;
    }

    // block geometry: component and position on that component's block grid
    static int comp(int n) { return n < 4 ? 0 : n - 3; }
    int bgw(int c) const { return c ? mbw : 2 * mbw; }
    void block_xy(int mbx, int mby, int n, int& bx, int& by) const {
        if (n < 4) {
            bx = 2 * mbx + (n & 1);
            by = 2 * mby + (n >> 1);
        } else {
            bx = mbx;
            by = mby;
        }
    }
    int dc_at(int c, int bx, int by) const {
        return bx < 0 || by < 0 ? 1024 : dc[c][size_t(by) * bgw(c) + bx];
    }

    // DC prediction (7.4.3.1): the predicted level and its direction
    // (0: from the left, 1: from above)
    int dc_predict(int c, int bx, int by, int scale, int& dir) const {
        int a = dc_at(c, bx - 1, by), b = dc_at(c, bx - 1, by - 1), cc = dc_at(c, bx, by - 1);
        int pred;
        if (std::abs(a - b) < std::abs(b - cc)) {
            pred = cc;
            dir = 1;
        } else {
            pred = a;
            dir = 0;
        }
        return (pred + (scale >> 1)) / scale;
    }
    void dc_store(int c, int bx, int by, int level, int scale) {
        int v = level * scale;
        if (v & ~2047) v = v < 0 ? 0 : 2047;
        dc[c][size_t(by) * bgw(c) + bx] = int16_t(v);
    }

    // AC prediction (7.4.3.3) of the first column (dir 0) or row (dir 1)
    // of `blk` (natural order, quantised levels) from the neighbour's
    // stored values, rescaled from its QP; then stores this block's values
    void ac_predict(int c, int bx, int by, int mbx, int mby, int q, int dir, bool on,
                    int16_t* blk) {
        int16_t* mine = &ac[c][(size_t(by) * bgw(c) + bx) * 16];
        if (on) {
            if (dir == 0 && bx > 0) {
                const int16_t* left = mine - 16;
                int nq = (c == 0 && (bx & 1)) ? q : mbq[size_t(mby) * mbw + mbx - 1];
                for (int i = 1; i < 8; i++)
                    blk[i * 8] = int16_t(blk[i * 8] + rescale(left[i], nq, q));
            } else if (dir == 1 && by > 0) {
                const int16_t* up = mine - size_t(bgw(c)) * 16;
                int nq = (c == 0 && (by & 1)) ? q : mbq[size_t(mby - 1) * mbw + mbx];
                for (int i = 1; i < 8; i++)
                    blk[i] = int16_t(blk[i] + rescale(up[8 + i], nq, q));
            }
        }
        for (int i = 1; i < 8; i++) {
            mine[i] = blk[i * 8];
            mine[8 + i] = blk[i];
        }
    }
    static int rescale(int v, int nq, int q) {
        if (nq == q) return v;
        int p = v * nq;
        return (p >= 0 ? p + (q >> 1) : p - (q >> 1)) / q;
    }

    // an inter, skipped or out-of-VOP macroblock predicts as nothing coded
    void clear_intra(int mbx, int mby) {
        for (int n = 0; n < 6; n++) {
            int bx, by, c = comp(n);
            block_xy(mbx, mby, n, bx, by);
            size_t i = size_t(by) * bgw(c) + bx;
            dc[c][i] = 1024;
            std::memset(&ac[c][i * 16], 0, 16 * sizeof(int16_t));
        }
    }

    // the median motion vector predictor of macroblock (mbx, mby) (7.6.5)
    void mv_predict(int mbx, int mby, int& px, int& py) const {
        auto mv = [&](int x, int y, int k) { return int(mvs[(size_t(y) * mbw + x) * 2 + k]); };
        if (mby == 0) {
            px = mbx ? mv(mbx - 1, 0, 0) : 0;
            py = mbx ? mv(mbx - 1, 0, 1) : 0;
            return;
        }
        for (int k = 0; k < 2; k++) {
            int a = mbx ? mv(mbx - 1, mby, k) : 0;
            int b = mv(mbx, mby - 1, k);
            int c = mbx + 1 < mbw ? mv(mbx + 1, mby - 1, k) : 0;
            (k ? py : px) = median(a, b, c);
        }
    }

    // half-pel prediction of a bw x bh block at integer (x, y) with
    // half-pel flags dxy from `src` (clamped at the edges ew x eh)
    static void mc_block(const uint8_t* src, int stride, int ew, int eh, int x, int y, int dxy,
                         int bw, int bh, int rounding, uint8_t* dst, int dstride) {
        uint8_t win[17 * 17], out[256];
        for (int j = 0; j <= bh; j++) {
            int yy = std::min(std::max(y + j, 0), eh - 1);
            for (int i = 0; i <= bw; i++) {
                int xx = std::min(std::max(x + i, 0), ew - 1);
                win[j * 17 + i] = src[size_t(yy) * stride + xx];
            }
        }
        hpel_mc(win, 17, bw, bh, dxy, 1 - rounding, out);
        for (int j = 0; j < bh; j++) std::memcpy(dst + j * dstride, out + j * bw, size_t(bw));
    }

    // the motion-compensated macroblock (mx, my half-pels) into `cur`;
    // true when the luma reference block reaches past the picture
    bool predict_mb(int mbx, int mby, int mx, int my, int rounding) {
        int sx = mbx * 16 + (mx >> 1), sy = mby * 16 + (my >> 1);
        int dxy = ((my & 1) << 1) | (mx & 1);
        mc_block(ref[0].data(), ys, edge_w, edge_h, sx, sy, dxy, 16, 16, rounding,
                 &cur[0][size_t(mby) * 16 * ys + mbx * 16], ys);
        int uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
        for (int c = 1; c < 3; c++)
            mc_block(ref[c].data(), cs, edge_w >> 1, edge_h >> 1, sx >> 1, sy >> 1, uvdxy, 8, 8,
                     rounding, &cur[c][size_t(mby) * 8 * cs + mbx * 8], cs);
        return sx < 0 || sy < 0 || sx + 16 + (mx & 1) > edge_w || sy + 16 + (my & 1) > edge_h;
    }

    uint8_t* block_ptr(int mbx, int mby, int n, int& stride) {
        if (n < 4) {
            stride = ys;
            return &cur[0][size_t(mby * 16 + (n >> 1) * 8) * ys + mbx * 16 + (n & 1) * 8];
        }
        stride = cs;
        return &cur[n - 3][size_t(mby) * 8 * cs + mbx * 8];
    }

    // intra block: levels (after AC prediction) -> dequantised -> IDCT put
    void recon_intra(int mbx, int mby, int n, int q, int16_t* blk) {
        int scale = n < 4 ? luma_dc_scale(q) : chroma_dc_scale(q);
        int qmul = 2 * q, qadd = (q - 1) | 1;
        blk[0] = int16_t(blk[0] * scale);
        for (int i = 1; i < 64; i++)
            if (blk[i]) blk[i] = int16_t(blk[i] > 0 ? blk[i] * qmul + qadd : blk[i] * qmul - qadd);
        int stride;
        uint8_t* dst = block_ptr(mbx, mby, n, stride);
        idct<false>(blk, dst, stride);
    }
    // inter block: dequantised coefficients -> IDCT added onto the prediction
    void recon_inter(int mbx, int mby, int n, int16_t* blk) {
        int stride;
        uint8_t* dst = block_ptr(mbx, mby, n, stride);
        idct<true>(blk, dst, stride);
    }

    void swap_frames() {
        for (int c = 0; c < 3; c++) std::swap(cur[c], ref[c]);
        have_ref = true;
    }

    // the reference picture cropped to w x h, packed Y, U, V
    void crop(const std::vector<uint8_t>* planes, uint8_t* out) const {
        for (int y = 0; y < h; y++) std::memcpy(out + size_t(y) * w, &planes[0][size_t(y) * ys], w);
        int cw = (w + 1) / 2, ch = (h + 1) / 2;
        uint8_t* o = out + size_t(w) * h;
        for (int c = 1; c < 3; c++)
            for (int y = 0; y < ch; y++, o += cw) std::memcpy(o, &planes[c][size_t(y) * cs], cw);
    }
};

// ---------------------------------------------------------------- decoder
//
// The decoder follows libavcodec's mpeg4 decoder (mpeg4videodec.c,
// h263dec.c, mpegvideo_motion.c) wherever a legal stream leaves it a
// choice: the picture it outputs when, the IDCT and the bug workarounds it
// picks from the user data, and the edge handling of motion compensation.

#include "xvid_idct.h"
#include "error_resilience.h"

// libavcodec's workaround_bugs flags that change the pictures of the
// tools decoded here
enum Bug : unsigned {
    kBugEdge = 1,             // FF_BUG_EDGE: the picture edge is the VOL size
    kBugDcClip = 2,           // FF_BUG_DC_CLIP: intra DC predictors kept past 2047
    kBugQpelChroma = 4,       // FF_BUG_QPEL_CHROMA
    kBugQpelChroma2 = 8,      // FF_BUG_QPEL_CHROMA2
    kBugStdQpel = 16,         // FF_BUG_STD_QPEL: old Lavc's quarter-sample filter
    kBugUmp4 = 32,            // FF_BUG_UMP4
    kBugXvidIlace = 64,       // FF_BUG_XVID_ILACE: interlaced_dct read without a cbp
    kBugHpelChroma = 128,     // FF_BUG_HPEL_CHROMA: DivX's field chroma vectors
    kBugIedge = 256,          // FF_BUG_IEDGE: an emulated chroma edge one row short
};

enum MbKind : uint8_t { kMbIntra, kMb16x16, kMb8x8, kMbField };

// a decoded picture with what a later B-VOP reads of it
struct Picture {
    std::vector<uint8_t> p[3];
    std::vector<int16_t> mv;    // (x, y) per 8x8 block, FFmpeg's motion_val layout
    std::vector<uint8_t> kind;  // MbKind per macroblock
    std::vector<uint8_t> skip;  // not_coded per macroblock (P-VOPs)
    // a field-predicted P macroblock's field selects and vectors
    // (FFmpeg's p_field_mv_table), and FFmpeg's ref_index[0], which
    // concealment reads: 4 per macroblock (a padding column a row), a field
    // macroblock's selects over what the pooled table held (Decoder::ref_free)
    std::vector<uint8_t> field_sel;
    std::vector<int16_t> field_mv;
    std::vector<int8_t> ref_index;
    int vop_type = 0;
};
using PicturePtr = std::shared_ptr<Picture>;

const uint8_t kDefaultIntraMatrix[64] = {
    8,  17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28,
    20, 21, 22, 23, 24, 26, 28, 30, 21, 22, 23, 24, 26, 28, 30, 32,
    22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28, 30, 32, 35, 38,
    25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45};
const uint8_t kDefaultInterMatrix[64] = {
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24,
    18, 19, 20, 21, 22, 23, 24, 25, 19, 20, 21, 22, 23, 24, 26, 27,
    20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24, 26, 27, 28, 30,
    22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33};

// mb_type of B-VOPs (Table B-4): direct, interpolate, backward, forward
const Code kBMbType[4] = {{1, 1}, {1, 2}, {1, 3}, {1, 4}};
enum BMbType { kBDirect, kBInterpolate, kBBackward, kBForward };
const Vlc& b_mb_type_vlc() {
    static const Vlc v(kBMbType, 4);
    return v;
}

// the vector of an 8x8 chroma block from the sum of four luma vectors
// (H.263's table of sixteenths)
int round_chroma(int x) {
    static const uint8_t kRound[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
    return kRound[x & 15] + ((x >> 3) & ~1);
}

inline uint8_t clip8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// the MPEG-4 8-tap quarter-sample lowpass of n + 1 samples (step `d`) into
// n, the samples mirrored past both ends (qpeldsp.c)
template <int n>
inline void qpel_lowpass(const uint8_t* s, int d, uint8_t* o, int od, int rnd) {
    auto at = [&](int i) { return int(s[(i < 0 ? -1 - i : i > n ? 2 * n + 1 - i : i) * d]); };
    for (int i = 0; i < n; i++) {
        int v = (at(i) + at(i + 1)) * 20 - (at(i - 1) + at(i + 2)) * 6 +
                (at(i - 2) + at(i + 3)) * 3 - (at(i - 3) + at(i + 4));
        o[i * od] = clip8((v + 15 + rnd) >> 5);
    }
}
// the lowpass of `rows` rows (horizontal) or of n columns (vertical)
template <int n>
void qpel_h(const uint8_t* s, int ss, int rows, uint8_t* o, int os, int rnd) {
    for (int j = 0; j < rows; j++) qpel_lowpass<n>(s + j * ss, 1, o + j * os, 1, rnd);
}
template <int n>
void qpel_v(const uint8_t* s, int ss, uint8_t* o, int os, int rnd) {
    for (int i = 0; i < n; i++) qpel_lowpass<n>(s + i, ss, o + i, os, rnd);
}
// the average of two n-wide blocks, rounded up (rnd) or down
template <int n>
void avg2(const uint8_t* a, int as, const uint8_t* b, int bs, int rows, uint8_t* o, int os,
          int rnd) {
    for (int j = 0; j < rows; j++)
        for (int i = 0; i < n; i++) o[j * os + i] = uint8_t((a[j * as + i] + b[j * bs + i] + rnd) >> 1);
}

// one n x n quarter-sample prediction (FFmpeg's qpelN_mcXY, X = dxy & 3,
// Y = dxy >> 2) from the (n + 1)^2 window `w` of stride `ws`
template <int n>
void qpel_mc(const uint8_t* w, int ws, int dxy, int rnd, uint8_t* o) {
    constexpr int m = n + 1;
    uint8_t hh[m * n], hv[n * n];
    int x = dxy & 3, y = dxy >> 2;
    if (!y) {
        if (!x) {
            for (int j = 0; j < n; j++) std::memcpy(o + j * n, w + j * ws, n);
        } else if (x == 2) {
            qpel_h<n>(w, ws, n, o, n, rnd);
        } else {
            qpel_h<n>(w, ws, n, hh, n, rnd);
            avg2<n>(w + (x == 3), ws, hh, n, n, o, n, rnd);
        }
        return;
    }
    if (!x) {
        if (y == 2) {
            qpel_v<n>(w, ws, o, n, rnd);
        } else {
            qpel_v<n>(w, ws, hv, n, rnd);
            avg2<n>(w + (y == 3) * ws, ws, hv, n, n, o, n, rnd);
        }
        return;
    }
    qpel_h<n>(w, ws, m, hh, n, rnd);  // n + 1 rows
    if (x != 2) avg2<n>(hh, n, w + (x == 3), ws, m, hh, n, rnd);
    if (y == 2) {
        qpel_v<n>(hh, n, o, n, rnd);
        return;
    }
    qpel_v<n>(hh, n, hv, n, rnd);
    avg2<n>(hh + (y == 3) * n, n, hv, n, n, o, n, rnd);
}

// how a prediction is stored: put with rounding (rnd 1) or without, or the
// rounded average with what is there (the second direction of a B-VOP)
struct McOp {
    int rnd;
    bool avg;
};
void store(const uint8_t* v, int bw, int bh, McOp op, uint8_t* d, int ds) {
    for (int j = 0; j < bh; j++)
        for (int i = 0; i < bw; i++)
            d[j * ds + i] = op.avg ? uint8_t((d[j * ds + i] + v[j * bw + i] + 1) >> 1) : v[j * bw + i];
}

struct Vol {
    int width = 0, height = 0, time_bits = 1, resolution = 0, verid = 1, vo_type = 0;
    bool control = false, resync = false, mpeg_quant = false, quarter = false,
         interlaced = false;
};

struct Decoder : Codec {
    bool have_vol = false;
    Vol vol;
    std::string error;
    uint32_t codec_tag = 0;
    // what the user data tells (-1: nothing)
    int divx_version = -1, divx_build = -1, lavc_build = -1, xvid_build = -1;
    bool divx_packed = false;
    unsigned bugs = 0;
    bool use_xvid_idct = false, low_delay = false;
    long picture_number = 0;
    int intra_matrix[64], inter_matrix[64];  // natural order
    // VOP times (FFmpeg's time_base, time, last_non_b_time, pp/pb_time)
    long time_base = 0, last_time_base = 0, time = 0, last_non_b_time = 0, pp_time = 0,
         pb_time = 0;
    int b8s = 0;  // the stride of Picture::mv in blocks
    PicturePtr last, next, cur;
    std::vector<PicturePtr> out;  // pictures let out, in order
    std::vector<uint8_t> stash;   // a packed B-VOP kept for the next sample
    bool skipped_last = false;
    // the VOP being decoded
    int type = 0, q = 1, rounding = 0, fcode = 1, bcode = 1, dc_thr = 99;
    int edge_w = 0, edge_h = 0;
    int resync_x = 0, resync_y = 0;
    bool first_line = true;
    int last_mv[2][2][2] = {};  // B-VOP vector predictors: direction, field, x / y
    // interlace: the VOP's top_field_first and alternate scan, the
    // macroblock's field DCT, the B-VOP field times
    bool tff = false, alt_scan = false, idct_field = false;
    // error resilience: the macroblock being decoded (FFmpeg's mb_x, mb_y),
    // where the video packet's data began, the padding bug detection, the
    // motion state FFmpeg writes back for a macroblock that fails (its
    // mb_intra, mv_type and mv[0][0..1]), FFmpeg's
    // decoder-wide skip table (1 for a skipped or B macroblock, kept across
    // VOPs), and the VOP's tables in concealment's layout (one padding
    // column a row)
    int cx = 0, cy = 0;
    size_t last_resync_pos = 0;
    int padding_bug_score = 0;
    bool no_padding = false;
    enum { kFf16x16, kFfField, kFf8x8 };  // FFmpeg's MV_TYPE_16X16, _FIELD, _8X8
    bool ff_intra = false;
    int ff_mv_type = kFf16x16;
    int ff_mv[2][2] = {};
    std::vector<uint8_t> mbskip, er_type;
    // FFmpeg's pool of ref_index tables: one goes back when no work picture
    // (cur, last, next) holds its picture, and the last given back is handed
    // out first, as it was left (its pool does not clear them; the motion
    // tables' pool does)
    std::vector<std::vector<int8_t>> ref_free;
    struct Er : er::Context {
        Decoder* d = nullptr;
        void decode_mb(int, int mv_dir, const int (*mv)[2], int x, int y) override {
            d->er_decode_mb(mv_dir, mv, x, y);
        }
    } er;
    long t_frame = 0, pp_field_time = 0, pb_field_time = 0;

    void init_size(int width, int height) {
        init(width, height);
        b8s = 2 * mbw + 1;
        er.d = this;
        er.init(mbw, mbh, false);
        mbskip.assign(size_t(mbw + 1) * mbh, 0);
        er_type.assign(size_t(mbw + 1) * mbh, 0);
        ref_free.clear();
        last.reset();
        next.reset();
        cur.reset();
    }

    // ---- headers

    void parse_vol(BitReader& br) {
        Vol v;
        br.skip(1);  // random_accessible_vol
        v.vo_type = int(br.get(8));
        if (v.vo_type == 0x12) fail("MPEG-4 fine granularity scalable video is not supported");
        if (br.get1()) {  // is_object_layer_identifier
            v.verid = int(br.get(4));
            br.skip(3);
        }
        if (br.get(4) == 15) br.skip(16);  // aspect_ratio_info, extended PAR
        bool delay = low_delay;
        if ((v.control = br.get1())) {  // vol_control_parameters
            if (br.get(2) != 1)
                fail("MPEG-4 video chroma formats other than 4:2:0 are not supported");
            delay = br.get1();
            if (br.get1()) {  // vbv_parameters
                for (int bits : {15, 15, 15, 3 + 11, 15}) {
                    br.skip(bits);
                    br.marker("VOL");
                }
            }
        } else if (!picture_number) {
            // FFmpeg: Simple and Advanced Simple without the flag are low delay
            delay = v.vo_type == 1 || v.vo_type == 17;
        }
        int shape = int(br.get(2));
        if (shape != 0)
            fail("MPEG-4 video object shapes other than rectangular (binary or grayscale "
                 "shape coding) are not supported");
        br.marker("VOL");
        v.resolution = int(br.get(16));
        if (!v.resolution) fail("corrupt MPEG-4 video: vop_time_increment_resolution of 0");
        int bits = 0;
        while ((1 << bits) < v.resolution) bits++;  // FFmpeg: av_log2(resolution - 1) + 1
        v.time_bits = std::max(bits, 1);
        br.marker("VOL");
        if (br.get1()) br.skip(v.time_bits);  // fixed_vop_rate
        br.marker("VOL");
        v.width = int(br.get(13));
        br.marker("VOL");
        v.height = int(br.get(13));
        br.marker("VOL");
        v.interlaced = br.get1();
        if (!br.get1()) fail("MPEG-4 overlapped block motion compensation (OBMC) is not supported");
        int sprite = int(br.get(v.verid == 1 ? 1 : 2));
        if (sprite) fail("MPEG-4 sprites and global motion compensation (GMC) are not supported");
        if (br.get1())
            fail("MPEG-4 video with other than 8-bit samples (not_8_bit) is not supported");
        int intra[64], inter[64];
        std::memcpy(intra, intra_matrix, sizeof intra);
        std::memcpy(inter, inter_matrix, sizeof inter);
        if ((v.mpeg_quant = br.get1())) {  // quant_type: MPEG, with its matrices
            for (int i = 0; i < 64; i++) {
                intra[i] = kDefaultIntraMatrix[i];
                inter[i] = kDefaultInterMatrix[i];
            }
            for (int* m : {intra, inter}) {
                if (!br.get1()) continue;  // load_*_quant_mat
                int i = 0, last_v = 0;
                for (; i < 64; i++) {
                    if (br.left() < 8)
                        fail("truncated MPEG-4 video: a MPEG quantisation matrix cut short");
                    int val = int(br.get(8));
                    if (!val) break;
                    last_v = val;
                    m[kZigzag[i]] = val;
                }
                for (; i < 64; i++) m[kZigzag[i]] = last_v;
                stats[kCustomMatrices]++;
            }
        }
        v.quarter = v.verid != 1 && br.get1();
        if (!br.get1()) fail("MPEG-4 complexity estimation headers are not supported");
        v.resync = !br.get1();
        if (br.get1()) fail("MPEG-4 data partitioning is not supported");
        if (v.verid != 1) {
            if (br.get1()) fail("MPEG-4 NEWPRED is not supported");
            if (br.get1()) fail("MPEG-4 reduced resolution VOPs are not supported");
        }
        if (br.get1()) fail("MPEG-4 scalability (enhancement layers) is not supported");
        if (!have_vol || v.width != vol.width || v.height != vol.height)
            init_size(v.width, v.height);
        vol = v;
        have_vol = true;
        low_delay = delay;
        std::memcpy(intra_matrix, intra, sizeof intra);
        std::memcpy(inter_matrix, inter, sizeof inter);
    }

    // FFmpeg's decode_user_data: the encoder's name and build
    void parse_user_data(const uint8_t* d, size_t n) {
        char buf[256];
        BitReader br(d, n);
        int i = 0;
        for (; i < 255 && br.pos < br.nbits; i++) {
            if (br.peek(23) == 0) break;
            buf[i] = char(br.get(8));
        }
        buf[i] = 0;
        int ver = 0, build = 0, ver2 = 0, ver3 = 0;
        char lastc = 0;
        int e = std::sscanf(buf, "DivX%dBuild%d%c", &ver, &build, &lastc);
        if (e < 2) e = std::sscanf(buf, "DivX%db%d%c", &ver, &build, &lastc);
        if (e >= 2) {
            divx_version = ver;
            divx_build = build;
            divx_packed = e == 3 && lastc == 'p';
        }
        e = std::sscanf(buf, "FFmpe%*[^b]b%d", &build) + 3;
        if (e != 4)
            e = std::sscanf(buf, "FFmpeg v%d.%d.%d / libavcodec build: %d", &ver, &ver2, &ver3,
                            &build);
        if (e != 4) {
            e = std::sscanf(buf, "Lavc%d.%d.%d", &ver, &ver2, &ver3) + 1;
            if (e > 1) build = ((ver & 0xFF) << 16) + ((ver2 & 0xFF) << 8) + (ver3 & 0xFF);
        }
        if (e != 4 && !std::strcmp(buf, "ffmpeg")) lavc_build = 4600;
        if (e == 4) lavc_build = build;
        if (std::sscanf(buf, "XviD%d", &build) == 1) xvid_build = build;
    }

    // FFmpeg's ff_mpeg4_workaround_bugs, run before each VOP's macroblocks
    void workaround_bugs() {
        auto tag = [&](const char* t) {
            return codec_tag == (uint32_t(uint8_t(t[0])) | uint32_t(uint8_t(t[1])) << 8 |
                                 uint32_t(uint8_t(t[2])) << 16 | uint32_t(uint8_t(t[3])) << 24);
        };
        if (xvid_build == -1 && divx_version == -1 && lavc_build == -1) {
            if (tag("XVID") || tag("XVIX") || tag("RMP4") || tag("ZMP4") || tag("SIPP"))
                xvid_build = 0;
            else if (tag("DIVX") && vol.vo_type == 0 && !vol.control)
                divx_version = 400;
        }
        if (xvid_build >= 0 && divx_version >= 0) divx_version = divx_build = -1;
        if (tag("UMP4")) bugs |= kBugUmp4;
        if (tag("XVIX")) bugs |= kBugXvidIlace;
        auto below = [](int v, unsigned limit) { return unsigned(v) < limit; };
        if (divx_version >= 500 && divx_build < 1814) bugs |= kBugQpelChroma;
        if (divx_version > 502 && divx_build < 1814) bugs |= kBugQpelChroma2;
        if (below(xvid_build, 2)) bugs |= kBugQpelChroma;
        if (below(xvid_build, 13)) bugs |= kBugEdge;
        if (below(xvid_build, 33)) bugs |= kBugDcClip;
        if (below(lavc_build, 4653)) bugs |= kBugStdQpel;
        if (below(lavc_build, 4670)) bugs |= kBugEdge;
        if (below(lavc_build, 4713)) bugs |= kBugDcClip;
        if (below(divx_version, 500)) bugs |= kBugEdge;
        if (divx_version >= 0) bugs |= kBugHpelChroma;
        if (unsigned(xvid_build) <= 3 || (divx_version == 501 && divx_build == 20020416))
            padding_bug_score = 256 * 256 * 256 * 64;
        if ((lavc_build & 0xFF) >= 100 && lavc_build > 3621476 && lavc_build < 3752552 &&
            (lavc_build < 3752037 || lavc_build > 3752191))
            bugs |= kBugIedge;
        if (xvid_build >= 0) use_xvid_idct = true;  // FF_IDCT_XVID, kept from here on
    }

    // ---- prediction state

    int16_t* mv_at(Picture& p, int bx, int by) {  // block (bx, by); by may be -1
        return &p.mv[(size_t(by + 1) * b8s + bx) * 2];
    }
    int16_t* block_mv(int mbx, int mby, int n) {
        return mv_at(*cur, 2 * mbx + (n & 1), 2 * mby + (n >> 1));
    }

    // FFmpeg's ff_h263_pred_motion: the predictor of block n's vector, with
    // its cases at the first row of a video packet
    void pred_motion(int mbx, int mby, int n, int& px, int& py) {
        static const int kOff[4] = {2, 1, 1, -1};
        int16_t* mv = block_mv(mbx, mby, n);
        int16_t* a = mv - 2;
        int16_t* b = mv - b8s * 2;
        int16_t* c = mv + (kOff[n] - b8s) * 2;
        if (first_line && n < 3) {
            if (n == 0) {
                if (mbx == resync_x) {
                    px = py = 0;
                } else if (mbx + 1 == resync_x) {
                    if (mbx == 0) {
                        px = c[0];
                        py = c[1];
                    } else {
                        px = median(a[0], 0, c[0]);
                        py = median(a[1], 0, c[1]);
                    }
                } else {
                    px = a[0];
                    py = a[1];
                }
            } else if (n == 1) {
                if (mbx + 1 == resync_x) {
                    px = median(a[0], 0, c[0]);
                    py = median(a[1], 0, c[1]);
                } else {
                    px = a[0];
                    py = a[1];
                }
            } else {
                if (mbx == resync_x) a[0] = a[1] = 0;  // FFmpeg writes the 0 back
                px = median(a[0], b[0], c[0]);
                py = median(a[1], b[1], c[1]);
            }
            return;
        }
        px = median(a[0], b[0], c[0]);
        py = median(a[1], b[1], c[1]);
    }

    // FFmpeg's ff_mpeg4_pred_dc: the DC predictor of block n (0 from the
    // left, 1 from above), with its cases at the first row of a video packet
    int dc_pred(int mbx, int mby, int n, int scale, int& dir) {
        int c = comp(n), bx, by;
        block_xy(mbx, mby, n, bx, by);
        int a = dc_at(c, bx - 1, by), b = dc_at(c, bx - 1, by - 1), cc = dc_at(c, bx, by - 1);
        if (first_line && n != 3) {
            if (n != 2) b = cc = 1024;
            if (n != 1 && mbx == resync_x) b = a = 1024;
        }
        if (mbx == resync_x && mby == resync_y + 1 && (n == 0 || n == 4 || n == 5)) b = 1024;
        int pred;
        if (std::abs(a - b) < std::abs(b - cc)) {
            pred = cc;
            dir = 1;
        } else {
            pred = a;
            dir = 0;
        }
        return (pred + (scale >> 1)) / scale;
    }
    void dc_keep(int mbx, int mby, int n, int level, int scale) {
        int c = comp(n), bx, by;
        block_xy(mbx, mby, n, bx, by);
        int v = level * scale;
        if (v & ~2047) v = v < 0 ? 0 : (bugs & kBugDcClip) ? v : 2047;
        dc[c][size_t(by) * bgw(c) + bx] = int16_t(v);
    }

    // FFmpeg's ff_mpeg4_clean_buffers at a video packet: the DC and AC
    // predictors around the packet's first macroblock, and the B vectors
    void clean_buffers(int mbx, int mby) {
        // cols [x0, x1) of block row `by` of component c
        auto clean = [&](int c, int by, int x0, int x1) {
            int gw = bgw(c), gh = c ? mbh : 2 * mbh;
            if (by < 0 || by >= gh) return;
            for (int bx = std::max(x0, 0); bx < std::min(x1, gw); bx++) {
                size_t i = size_t(by) * gw + bx;
                dc[c][i] = 1024;
                std::memset(&ac[c][i * 16], 0, 16 * sizeof(int16_t));
            }
        };
        // FFmpeg's runs from the block above-left to the block left of the
        // macroblock's lower row (its rows carry one padding column)
        clean(0, 2 * mby - 1, 2 * mbx - 1, 2 * mbw);
        clean(0, 2 * mby, 0, 2 * mbw);
        clean(0, 2 * mby + 1, 0, 2 * mbx);
        for (int c = 1; c < 3; c++) {
            clean(c, mby - 1, mbx - 1, mbw);
            clean(c, mby, 0, mbx);
        }
        // the B vector predictors of the first field only, as FFmpeg clears them
        for (int d = 0; d < 2; d++) last_mv[d][0][0] = last_mv[d][0][1] = 0;
    }

    // ---- motion compensation

    // FFmpeg's edge emulation: a window of `src` at (x, y), its samples
    // clamped at (ew, eh) when `emu`, else read as they lie (the plane's
    // macroblock-aligned size bounds the read)
    void fetch(int c, const Picture& ref, bool emu, int x, int y, int bw, int bh,
               uint8_t* win) const {
        int stride = c ? cs : ys, pw = c ? cs : ys, ph = c ? mbh * 8 : mbh * 16;
        int ew = c ? edge_w >> 1 : edge_w, eh = c ? edge_h >> 1 : edge_h;
        int mw = emu ? ew : pw, mh = emu ? eh : ph;
        const uint8_t* s = ref.p[c].data();
        for (int j = 0; j < bh; j++) {
            int yy = std::min(std::max(y + j, 0), mh - 1);
            for (int i = 0; i < bw; i++) {
                int xx = std::min(std::max(x + i, 0), mw - 1);
                win[j * bw + i] = s[size_t(yy) * stride + xx];
            }
        }
    }
    uint8_t* dst_ptr(int c, int mbx, int mby, int& stride) {
        stride = c ? cs : ys;
        return c ? &cur->p[c][size_t(mby) * 8 * cs + mbx * 8]
                 : &cur->p[0][size_t(mby) * 16 * ys + mbx * 16];
    }
    void note_outside(int x, int y, int bw, int bh) {
        if (x < 0 || y < 0 || x + bw > edge_w || y + bh > edge_h) stats[kMvOutside]++;
    }

    // mpeg_motion: a 16x16 half-sample vector, the chroma's from it
    void mc_hpel16(const Picture& ref, int mbx, int mby, int mx, int my, McOp op) {
        uint8_t win[17 * 17], v[256];
        int dxy = ((my & 1) << 1) | (mx & 1);
        int sx = mbx * 16 + (mx >> 1), sy = mby * 16 + (my >> 1);
        bool emu = unsigned(sx) >= unsigned(std::max(edge_w - (mx & 1) - 15, 0)) ||
                   unsigned(sy) >= unsigned(std::max(edge_h - (my & 1) - 15, 0));
        note_outside(sx, sy, 16 + (mx & 1), 16 + (my & 1));
        fetch(0, ref, emu, sx, sy, 17, 17, win);
        hpel_mc(win, 17, 16, 16, dxy, op.rnd, v);
        int ds;
        uint8_t* d = dst_ptr(0, mbx, mby, ds);
        store(v, 16, 16, op, d, ds);
        int uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
        for (int c = 1; c < 3; c++) {
            fetch(c, ref, emu, sx >> 1, sy >> 1, 9, 9, win);
            hpel_mc(win, 9, 8, 8, uvdxy, op.rnd, v);
            d = dst_ptr(c, mbx, mby, ds);
            store(v, 8, 8, op, d, ds);
        }
    }

    // qpel_motion: a 16x16 quarter-sample vector, the chroma's from it
    // with FFmpeg's rounding and the XviD / DivX build workarounds
    void mc_qpel16(const Picture& ref, int mbx, int mby, int mx, int my, McOp op) {
        uint8_t win[17 * 17], v[256];
        int dxy = ((my & 3) << 2) | (mx & 3);
        int sx = mbx * 16 + (mx >> 2), sy = mby * 16 + (my >> 2);
        int cx, cy;
        if (bugs & kBugQpelChroma2) {
            static const int kRtab[8] = {0, 0, 1, 1, 0, 0, 0, 1};
            cx = (mx >> 1) + kRtab[mx & 7];
            cy = (my >> 1) + kRtab[my & 7];
        } else if (bugs & kBugQpelChroma) {
            cx = (mx >> 1) | (mx & 1);
            cy = (my >> 1) | (my & 1);
        } else {
            cx = mx / 2;
            cy = my / 2;
        }
        cx = (cx >> 1) | (cx & 1);
        cy = (cy >> 1) | (cy & 1);
        int uvdxy = (cx & 1) | ((cy & 1) << 1);
        cx >>= 1;
        cy >>= 1;
        bool emu = unsigned(sx) > unsigned(std::max(edge_w - (mx & 3) - 16, 0)) ||
                   unsigned(sy) > unsigned(std::max(edge_h - (my & 3) - 16, 0));
        note_outside(sx, sy, 16 + !!(mx & 3), 16 + !!(my & 3));
        fetch(0, ref, emu, sx, sy, 17, 17, win);
        qpel_mc<16>(win, 17, dxy, op.avg ? 1 : op.rnd, v);
        int ds;
        uint8_t* d = dst_ptr(0, mbx, mby, ds);
        store(v, 16, 16, op, d, ds);
        for (int c = 1; c < 3; c++) {
            fetch(c, ref, emu, mbx * 8 + cx, mby * 8 + cy, 9, 9, win);
            hpel_mc(win, 9, 8, 8, uvdxy, op.rnd, v);
            d = dst_ptr(c, mbx, mby, ds);
            store(v, 8, 8, op, d, ds);
        }
    }

    // one field of a macroblock (`bottom`) predicted from field `sel` of
    // `ref` by a vector in field units (mpeg_motion_field, or qpel_motion
    // with field_based: two 8x8 quarter-sample blocks).  The windows are
    // read in frame rows and the field's rows taken from them, so that an
    // emulated edge replicates the frame's last row, as FFmpeg's does
    void mc_field(const Picture& ref, int mbx, int mby, int bottom, int sel, int mx, int my,
                  McOp op) {
        uint8_t win[18 * 17], fw[9 * 17], v[128], cw[2][10 * 9], cf[5 * 9];
        const int field_h = edge_h >> 1;
        int sx, sy, dxy, cx, cy, uvdxy;
        bool emu;
        if (vol.quarter) {
            dxy = ((my & 3) << 2) | (mx & 3);
            sx = mbx * 16 + (mx >> 2);
            sy = mby * 8 + (my >> 2);
            int tx = mx / 2, ty = my >> 1;
            tx = (tx >> 1) | (tx & 1);
            ty = (ty >> 1) | (ty & 1);
            uvdxy = (tx & 1) | ((ty & 1) << 1);
            cx = mbx * 8 + (tx >> 1);
            cy = mby * 4 + (ty >> 1);
            emu = unsigned(sx) > unsigned(std::max(edge_w - (mx & 3) - 16, 0)) ||
                  unsigned(sy) > unsigned(std::max(field_h - (my & 3) - 8, 0));
        } else {
            dxy = ((my & 1) << 1) | (mx & 1);
            sx = mbx * 16 + (mx >> 1);
            sy = mby * 8 + (my >> 1);
            if (bugs & kBugHpelChroma) {
                int tx = (mx >> 1) | (mx & 1), ty = my >> 1;
                uvdxy = ((ty & 1) << 1) | (tx & 1);
                cx = mbx * 8 + (tx >> 1);
                cy = mby * 4 + (ty >> 1);
            } else {
                uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
                cx = sx >> 1;
                cy = sy >> 1;
            }
            emu = unsigned(sx) >= unsigned(std::max(edge_w - (mx & 1) - 15, 0)) ||
                  unsigned(sy) >= unsigned(std::max(field_h - (my & 1) - 7, 0));
        }
        note_outside(sx, 2 * sy, 17, 18);
        fetch(0, ref, emu, sx, 2 * sy, 17, 18, win);
        for (int j = 0; j < 9; j++) std::memcpy(fw + j * 17, win + (sel + 2 * j) * 17, 17);
        if (vol.quarter) {
            uint8_t half[64];
            qpel_mc<8>(fw, 17, dxy, op.avg ? 1 : op.rnd, half);
            for (int j = 0; j < 8; j++) std::memcpy(v + j * 16, half + j * 8, 8);
            qpel_mc<8>(fw + 8, 17, dxy, op.avg ? 1 : op.rnd, half);
            for (int j = 0; j < 8; j++) std::memcpy(v + j * 16 + 8, half + j * 8, 8);
        } else {
            hpel_mc(fw, 17, 16, 8, dxy, op.rnd, v);
        }
        int ds;
        uint8_t* d = dst_ptr(0, mbx, mby, ds);
        store(v, 16, 8, op, d + bottom * ds, 2 * ds);
        for (int c = 1; c < 3; c++) fetch(c, ref, emu, cx, 2 * cy, 9, 10, cw[c - 1]);
        if (emu && (bugs & kBugIedge)) std::memcpy(cw[0] + 9 * 9, cw[1], 9);  // vbuf's first row
        for (int c = 1; c < 3; c++) {
            for (int j = 0; j < 5; j++) std::memcpy(cf + j * 9, cw[c - 1] + (sel + 2 * j) * 9, 9);
            hpel_mc(cf, 9, 8, 4, uvdxy, op.rnd, v);
            d = dst_ptr(c, mbx, mby, ds);
            store(v, 8, 4, op, d + bottom * ds, 2 * ds);
        }
    }

    // apply_8x8: four 8x8 vectors (half- or quarter-sample) and the chroma
    // vector from their sum
    void mc_8x8(const Picture& ref, int mbx, int mby, const int (*mv)[2], McOp op) {
        uint8_t win[9 * 9], v[64];
        int sumx = 0, sumy = 0, ds;
        uint8_t* d0 = dst_ptr(0, mbx, mby, ds);
        for (int i = 0; i < 4; i++) {
            int mx = mv[i][0], my = mv[i][1], dxy, sx, sy;
            bool emu;
            if (vol.quarter) {
                dxy = ((my & 3) << 2) | (mx & 3);
                sx = mbx * 16 + (mx >> 2) + (i & 1) * 8;
                sy = mby * 16 + (my >> 2) + (i >> 1) * 8;
                sx = std::min(std::max(sx, -16), w);
                if (sx == w) dxy &= ~3;
                sy = std::min(std::max(sy, -16), h);
                if (sy == h) dxy &= ~12;
                emu = unsigned(sx) >= unsigned(std::max(edge_w - (mx & 3) - 7, 0)) ||
                      unsigned(sy) >= unsigned(std::max(edge_h - (my & 3) - 7, 0));
                note_outside(sx, sy, 8 + !!(dxy & 3), 8 + !!(dxy & 12));
                fetch(0, ref, emu, sx, sy, 9, 9, win);
                qpel_mc<8>(win, 9, dxy, op.avg ? 1 : op.rnd, v);
                sumx += mx / 2;
                sumy += my / 2;
            } else {
                sx = mbx * 16 + (i & 1) * 8 + (mx >> 1);
                sy = mby * 16 + (i >> 1) * 8 + (my >> 1);
                dxy = 0;
                sx = std::min(std::max(sx, -16), w);
                if (sx != w) dxy |= mx & 1;
                sy = std::min(std::max(sy, -16), h);
                if (sy != h) dxy |= (my & 1) << 1;
                emu = unsigned(sx) >= unsigned(std::max(edge_w - (mx & 1) - 7, 0)) ||
                      unsigned(sy) >= unsigned(std::max(edge_h - (my & 1) - 7, 0));
                note_outside(sx, sy, 8 + (dxy & 1), 8 + (dxy >> 1));
                fetch(0, ref, emu, sx, sy, 9, 9, win);
                hpel_mc(win, 9, 8, 8, dxy, op.rnd, v);
                sumx += mx;
                sumy += my;
            }
            store(v, 8, 8, op, d0 + (i >> 1) * 8 * ds + (i & 1) * 8, ds);
        }
        // chroma_4mv_motion
        int mx = round_chroma(sumx), my = round_chroma(sumy);
        int dxy = ((my & 1) << 1) | (mx & 1);
        mx >>= 1;
        my >>= 1;
        int sx = mbx * 8 + mx, sy = mby * 8 + my;
        sx = std::min(std::max(sx, -8), w >> 1);
        if (sx == (w >> 1)) dxy &= ~1;
        sy = std::min(std::max(sy, -8), h >> 1);
        if (sy == (h >> 1)) dxy &= ~2;
        bool emu = unsigned(sx) >= unsigned(std::max((edge_w >> 1) - (dxy & 1) - 7, 0)) ||
                   unsigned(sy) >= unsigned(std::max((edge_h >> 1) - (dxy >> 1) - 7, 0));
        for (int c = 1; c < 3; c++) {
            fetch(c, ref, emu, sx, sy, 9, 9, win);
            hpel_mc(win, 9, 8, 8, dxy, op.rnd, v);
            uint8_t* d = dst_ptr(c, mbx, mby, ds);
            store(v, 8, 8, op, d, ds);
        }
    }

    // a macroblock's prediction from `ref` along one direction
    void predict(const Picture& ref, int mbx, int mby, bool four, const int (*mv)[2], McOp op) {
        if (four)
            mc_8x8(ref, mbx, mby, mv, op);
        else if (vol.quarter)
            mc_qpel16(ref, mbx, mby, mv[0][0], mv[0][1], op);
        else
            mc_hpel16(ref, mbx, mby, mv[0][0], mv[0][1], op);
    }

    // ---- residual

    void idct_put(int16_t* blk, uint8_t* d, int s) {
        if (use_xvid_idct)
            xvid_idct<false>(blk, d, s);
        else
            idct<false>(blk, d, s);
    }
    void idct_add(int16_t* blk, uint8_t* d, int s) {
        if (use_xvid_idct)
            xvid_idct<true>(blk, d, s);
        else
            idct<true>(blk, d, s);
    }
    uint8_t* block_dst(int mbx, int mby, int n, int& stride) {
        if (n < 4 && idct_field) {  // field DCT: blocks 0-1 the top field, 2-3 the bottom
            stride = 2 * ys;
            return &cur->p[0][size_t(mby * 16 + (n >> 1)) * ys + mbx * 16 + (n & 1) * 8];
        }
        if (n < 4) {
            stride = ys;
            return &cur->p[0][size_t(mby * 16 + (n >> 1) * 8) * ys + mbx * 16 + (n & 1) * 8];
        }
        return dst_ptr(n - 3, mbx, mby, stride);
    }

    // an intra block's levels (after AC prediction) -> dequantised -> put
    void intra_block(int mbx, int mby, int n, int16_t* blk) {
        int scale = n < 4 ? luma_dc_scale(q) : chroma_dc_scale(q);
        blk[0] = int16_t(blk[0] * scale);
        if (vol.mpeg_quant) {  // dct_unquantize_mpeg2_intra_mmx, its qscale doubled
            for (int i = 1; i < 64; i++)
                if (blk[i]) {
                    // 16-bit lanes: |level| * q wraps, then an arithmetic shift
                    uint16_t qm = uint16_t(2 * q * intra_matrix[i]);
                    int l = int16_t(uint16_t(uint32_t(uint16_t(std::abs(int(blk[i])))) * qm)) >> 4;
                    blk[i] = int16_t(blk[i] < 0 ? -l : l);
                }
        } else {
            int qmul = 2 * q, qadd = (q - 1) | 1;
            for (int i = 1; i < 64; i++)
                if (blk[i]) blk[i] = int16_t(blk[i] > 0 ? blk[i] * qmul + qadd : blk[i] * qmul - qadd);
        }
        int stride;
        uint8_t* d = block_dst(mbx, mby, n, stride);
        idct_put(blk, d, stride);
    }
    // an inter block (H.263: dequantised as read; MPEG: dequantised here
    // with the mismatch control) -> added to the prediction
    void inter_block(int mbx, int mby, int n, int16_t* blk) {
        if (vol.mpeg_quant) {  // dct_unquantize_mpeg2_inter, its qscale doubled
            int sum = -1;
            for (int i = 0; i < 64; i++)
                if (blk[i]) {
                    // dct_unquantize_mpeg2_inter_mmx's 16-bit lanes: (2|level| + 1) * q
                    // wraps, then a logical shift
                    uint16_t qm = uint16_t(2 * q * inter_matrix[i]);
                    int l = uint16_t(uint32_t(uint16_t(2 * std::abs(int(blk[i])))) * qm + qm) >> 5;
                    blk[i] = int16_t(blk[i] < 0 ? -l : l);
                    sum += blk[i];
                }
            blk[63] = int16_t(blk[63] ^ (sum & 1));
        }
        int stride;
        uint8_t* d = block_dst(mbx, mby, n, stride);
        idct_add(blk, d, stride);
    }

    int decode_dc_diff(BitReader& br, bool luma) {
        const Tables& t = tables();
        int size = (luma ? t.dc_luma : t.dc_chroma).decode(br, "DC size");
        if (!size) return 0;
        if (size > 9) fail("corrupt MPEG-4 video: an intra DC size over 9");
        int diff = int(br.get(size));
        if (!(diff >> (size - 1))) diff = diff - (1 << size) + 1;
        if (size > 8) br.skip(1);  // the marker bit: FFmpeg does not check it
        return diff;
    }

    // TCOEF events into blk (natural order) from scan position `i` + 1 on;
    // intra and MPEG-quantised inter: levels; H.263 inter: dequantised
    void decode_coeffs(BitReader& br, bool intra, const uint8_t* scan, int i, int qmul, int qadd,
                       int16_t* blk) {
        const Tables& t = tables();
        const Vlc& vlc = intra ? t.intra_tcoef : t.inter_tcoef;
        const RunLevel& rl = intra ? kIntraTcoef : kInterTcoef;
        const Escapes& esc = intra ? t.intra_esc : t.inter_esc;
        for (;;) {
            int sym = vlc.decode(br, "TCOEF"), last, run, level;
            bool clamp = false;
            if (sym != kEscape) {
                last = sym >= rl.last_start;
                run = rl.run[sym];
                level = rl.level[sym];
                if (br.get1()) level = -level;
            } else if (!br.get1()) {  // first escape: level offset
                sym = vlc.decode(br, "TCOEF");
                if (sym == kEscape) fail("corrupt MPEG-4 video: escape inside an escape");
                last = sym >= rl.last_start;
                run = rl.run[sym];
                level = rl.level[sym] + esc.max_level[last][run];
                if (br.get1()) level = -level;
                stats[kEsc1]++;
            } else if (!br.get1()) {  // second escape: run offset
                sym = vlc.decode(br, "TCOEF");
                if (sym == kEscape) fail("corrupt MPEG-4 video: escape inside an escape");
                last = sym >= rl.last_start;
                level = rl.level[sym];
                run = rl.run[sym] + esc.max_run[last][level] + 1;
                if (br.get1()) level = -level;
                stats[kEsc2]++;
            } else {  // third escape: fixed length
                last = br.get1();
                run = int(br.get(6));
                br.marker("third escape");
                level = br.sget(12);
                br.marker("third escape");
                clamp = true;
                stats[kEsc3]++;
            }
            i += run + 1;
            if (i > 63 || (i == 63 && !last))
                fail("corrupt MPEG-4 video: more than 64 coefficients in a block");
            if (qmul > 1 || qadd) {
                level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
                if (clamp && (level < -2048 || level > 2047)) level = level < 0 ? -2048 : 2047;
            }
            blk[scan[i]] = int16_t(level);
            if (last) return;
        }
    }

    void set_q(int v) { q = std::min(std::max(v, 1), 31); }

    void intra_mb(BitReader& br, int mbx, int mby, int cbpc, bool dquant) {
        const Tables& t = tables();
        bool ac_pred = br.get1();
        int cbp = (t.cbpy.decode(br, "cbpy") << 2) | (cbpc & 3);
        bool dc_vlc = q < dc_thr;
        if (dquant) {
            set_q(q + kDquant[br.get(2)]);
            stats[kDquantMb]++;
        }
        idct_field = vol.interlaced && br.get1();
        if (idct_field) stats[kFieldDctMb]++;
        size_t mi = size_t(mby) * mbw + mbx;
        mbq[mi] = int8_t(q);
        for (int n = 0; n < 6; n++) {
            int16_t blk[64] = {};
            int c = comp(n), bx, by, dir;
            block_xy(mbx, mby, n, bx, by);
            int scale = n < 4 ? luma_dc_scale(q) : chroma_dc_scale(q);
            int pred = dc_pred(mbx, mby, n, scale, dir);
            int i = -1;
            if (dc_vlc) {
                blk[0] = int16_t(pred + decode_dc_diff(br, n < 4));
                i = 0;
                // FFmpeg's mpeg4_decode_block takes a negative DC level for an error
                if (blk[0] < 0) fail("corrupt MPEG-4 video: a negative intra DC level");
            }
            const uint8_t* scan = alt_scan || (ac_pred && dir == 0) ? kAltVertical
                                  : ac_pred ? kAltHorizontal : kZigzag;
            if (cbp & (32 >> n)) decode_coeffs(br, true, scan, i, 1, 0, blk);
            if (!dc_vlc) blk[0] = int16_t(blk[0] + pred);
            dc_keep(mbx, mby, n, blk[0], scale);
            ac_predict(c, bx, by, mbx, mby, q, dir, ac_pred, blk);
            intra_block(mbx, mby, n, blk);
        }
        cur->kind[mi] = kMbIntra;
        for (int n = 0; n < 4; n++) {
            int16_t* mv = block_mv(mbx, mby, n);
            mv[0] = mv[1] = 0;
        }
        stats[type ? kIntraMbP : kIntraMbI]++;
        stats[ac_pred ? kAcPredOn : kAcPredOff]++;
    }

    // the coded blocks of an inter macroblock
    void inter_blocks(BitReader& br, int mbx, int mby, int cbp) {
        int qmul = vol.mpeg_quant ? 1 : 2 * q, qadd = vol.mpeg_quant ? 0 : (q - 1) | 1;
        for (int n = 0; n < 6; n++) {
            if (!(cbp & (32 >> n))) continue;
            int16_t blk[64] = {};
            decode_coeffs(br, false, alt_scan ? kAltVertical : kZigzag, -1, qmul, qadd, blk);
            inter_block(mbx, mby, n, blk);
        }
    }

    // ff_h263_decode_motion; an invalid code fails, or in B-VOPs (whose
    // vectors FFmpeg does not check) gives its 0xffff after the 9 bits its
    // table reads
    int decode_motion(BitReader& br, int pred, int code_f, bool lax = false) {
        if (lax && br.peek(11) == 0) {
            br.skip(9);
            return 0xffff;
        }
        int code = tables().mvd.decode(br, "motion vector");
        if (!code) return pred;
        bool sign = br.get1();
        int shift = code_f - 1, val = code;
        if (shift) val = (((val - 1) << shift) | int(br.get(shift))) + 1;
        if (sign) val = -val;
        val += pred;
        int bits = 5 + code_f;  // the range wraps
        return int(uint32_t(val) << (32 - bits)) >> (32 - bits);
    }

    void p_mb(BitReader& br, int mbx, int mby) {
        const Tables& t = tables();
        size_t mi = size_t(mby) * mbw + mbx;
        int cbpc;
        do {
            if (br.get1()) {  // not_coded
                ff_intra = false;
                ff_mv[0][0] = ff_mv[0][1] = 0;
                int zero[1][2] = {{0, 0}};
                for (int n = 0; n < 4; n++) {
                    int16_t* mv = block_mv(mbx, mby, n);
                    mv[0] = mv[1] = 0;
                }
                mbq[mi] = int8_t(q);
                cur->kind[mi] = kMb16x16;
                cur->skip[mi] = 1;
                predict(*last, mbx, mby, false, zero, {!rounding, false});
                clear_intra(mbx, mby);
                stats[kNotCoded]++;
                return;
            }
            cbpc = t.inter_mcbpc.decode(br, "mcbpc");
        } while (cbpc == kInterMcbpcStuffing);
        bool dquant = cbpc & 8;
        ff_intra = cbpc & 4;
        if (cbpc & 4) {
            intra_mb(br, mbx, mby, cbpc, dquant);
            return;
        }
        int cbp = ((t.cbpy.decode(br, "cbpy") ^ 15) << 2) | (cbpc & 3);
        if (dquant) {
            set_q(q + kDquant[br.get(2)]);
            stats[kDquantMb]++;
        }
        mbq[mi] = int8_t(q);
        idct_field = vol.interlaced && (cbp || (bugs & kBugXvidIlace)) && br.get1();
        if (idct_field) stats[kFieldDctMb]++;
        int mv[4][2];
        bool four = cbpc & 16;
        if (four) ff_mv_type = kFf8x8;
        if (!four && vol.interlaced && br.get1()) {  // 16x8 field prediction
            ff_mv_type = kFfField;
            int sel[2] = {br.get1(), br.get1()};
            int8_t* ri = &cur->ref_index[size_t(mby * (mbw + 1) + mbx) * 4];
            ri[0] = ri[1] = int8_t(sel[0]);
            ri[2] = ri[3] = int8_t(sel[1]);
            int px, py;
            pred_motion(mbx, mby, 0, px, py);
            for (int i = 0; i < 2; i++) {
                mv[i][0] = decode_motion(br, px, fcode);
                mv[i][1] = decode_motion(br, py / 2, fcode);
                ff_mv[i][0] = mv[i][0];
                ff_mv[i][1] = mv[i][1];
                cur->field_sel[mi * 2 + i] = uint8_t(sel[i]);
                cur->field_mv[mi * 4 + i * 2] = int16_t(mv[i][0]);
                cur->field_mv[mi * 4 + i * 2 + 1] = int16_t(mv[i][1]);
            }
            // ff_h263_update_motion_val: x averaged (odd rounded up), y summed
            int ax = mv[0][0] + mv[1][0], ay = mv[0][1] + mv[1][1];
            ax = (ax >> 1) | (ax & 1);
            for (int n = 0; n < 4; n++) {
                int16_t* m = block_mv(mbx, mby, n);
                m[0] = int16_t(ax);
                m[1] = int16_t(ay);
            }
            cur->kind[mi] = kMbField;
            for (int i = 0; i < 2; i++)
                mc_field(*last, mbx, mby, i, sel[i], mv[i][0], mv[i][1], {!rounding, false});
            clear_intra(mbx, mby);
            inter_blocks(br, mbx, mby, cbp);
            stats[kInterMb]++;
            stats[kFieldMb]++;
            return;
        }
        for (int n = 0; n < (four ? 4 : 1); n++) {
            int px, py;
            pred_motion(mbx, mby, n, px, py);
            mv[n][0] = decode_motion(br, px, fcode);
            mv[n][1] = decode_motion(br, py, fcode);
            if (n < 2) {
                ff_mv[n][0] = mv[n][0];
                ff_mv[n][1] = mv[n][1];
            }
            if (four) {
                int16_t* m = block_mv(mbx, mby, n);
                m[0] = int16_t(mv[n][0]);
                m[1] = int16_t(mv[n][1]);
            }
        }
        if (!four)
            for (int n = 0; n < 4; n++) {
                int16_t* m = block_mv(mbx, mby, n);
                m[0] = int16_t(mv[0][0]);
                m[1] = int16_t(mv[0][1]);
            }
        cur->kind[mi] = four ? kMb8x8 : kMb16x16;
        predict(*last, mbx, mby, four, mv, {!rounding, false});
        clear_intra(mbx, mby);
        inter_blocks(br, mbx, mby, cbp);
        stats[kInterMb]++;
        if (four) stats[kInter4vMb]++;
    }

    // ff_mpeg4_set_direct_mv: the two directions' vectors of a direct
    // macroblock from the co-located one of the next picture; its kind
    // (kMb8x8, kMb16x16, or kMbField with the field selects in `sel`)
    int direct_mv(int mbx, int mby, int dx, int dy, int (*f)[2], int (*b)[2], int (*sel)[2]) {
        Picture& nx = *next;
        size_t mi = size_t(mby) * mbw + mbx;
        if (nx.kind[mi] == kMbField) {
            for (int i = 0; i < 2; i++) {
                int fs = nx.field_sel[mi * 2 + i];
                sel[0][i] = fs;
                sel[1][i] = i;
                uint16_t tpp, tpb;
                if (tff) {
                    tpp = uint16_t(pp_field_time - fs + i);
                    tpb = uint16_t(pb_field_time - fs + i);
                } else {
                    tpp = uint16_t(pp_field_time + fs - i);
                    tpb = uint16_t(pb_field_time + fs - i);
                }
                if (!tpp) fail("corrupt MPEG-4 video: a field direct time of 0");
                int d[2] = {dx, dy};
                for (int k = 0; k < 2; k++) {
                    int pv = nx.field_mv[mi * 4 + i * 2 + k];
                    f[i][k] = pv * int(tpb) / int(tpp) + d[k];
                    b[i][k] = d[k] ? f[i][k] - pv : pv * (int(tpb) - int(tpp)) / int(tpp);
                }
            }
            return kMbField;
        }
        bool eight = nx.kind[mi] == kMb8x8;
        auto one = [&](int i) {
            const int16_t* p = mv_at(nx, 2 * mbx + (i & 1), 2 * mby + (i >> 1));
            int d[2] = {dx, dy};
            for (int k = 0; k < 2; k++) {
                long pv = p[k];
                f[i][k] = int(pv * pb_time / pp_time) + d[k];
                b[i][k] = d[k] ? f[i][k] - int(pv) : int(pv * (pb_time - pp_time) / pp_time);
            }
        };
        if (eight) {
            for (int i = 0; i < 4; i++) one(i);
            return kMb8x8;
        }
        one(0);
        for (int i = 1; i < 4; i++)
            for (int k = 0; k < 2; k++) {
                f[i][k] = f[0][k];
                b[i][k] = b[0][k];
            }
        // quarter-sample: four equal 8x8 vectors (FFmpeg tests
        // FF_BUG_DIRECT_BLOCKSIZE in the user's flags, which its detection
        // never sets)
        return vol.quarter ? kMb8x8 : kMb16x16;
    }

    void b_mb(BitReader& br, int mbx, int mby) {
        size_t mi = size_t(mby) * mbw + mbx;
        if (mbx == 0) std::memset(last_mv, 0, sizeof last_mv);
        cur->kind[mi] = kMb16x16;
        clear_intra(mbx, mby);
        if (next->skip[mi]) {  // skipped in the next P-VOP: a copy of the past one
            int zero[1][2] = {{0, 0}};
            predict(*last, mbx, mby, false, zero, {1, false});
            stats[kBSkippedMb]++;
            return;
        }
        int kind, cbp = 0;
        bool field = false;
        int sel[2][2] = {};
        idct_field = false;
        if (br.get1()) {  // modb '1': direct, no vectors or blocks
            kind = -1;
        } else {
            bool no_cbp = br.get1();
            kind = b_mb_type_vlc().decode(br, "B mb_type");
            if (!no_cbp) cbp = int(br.get(6));
            if (kind != kBDirect && cbp && br.get1()) {
                set_q(q + br.get1() * 4 - 2);
                stats[kDbquantMb]++;
            }
            if (vol.interlaced) {
                idct_field = cbp && br.get1();
                if (idct_field) stats[kFieldDctMb]++;
                if (kind != kBDirect && br.get1()) {
                    field = true;
                    for (int d = 0; d < 2; d++)
                        if (kind != (d ? kBForward : kBBackward)) {
                            sel[d][0] = br.get1();
                            sel[d][1] = br.get1();
                        }
                }
            }
        }
        int f[4][2], b[4][2];
        int mode = kMb16x16;
        int dir = 0;  // 1 forward, 2 backward, 3 both
        if (kind == kBDirect || kind == -1) {
            int dx = 0, dy = 0;
            if (kind == kBDirect) {
                dx = decode_motion(br, 0, 1, true);
                dy = decode_motion(br, 0, 1, true);
            }
            mode = direct_mv(mbx, mby, dx, dy, f, b, sel);
            dir = 3;
            stats[kDirectMb]++;
            if (mode == kMb8x8) stats[kDirect8x8Mb]++;
            if (mode == kMbField) stats[kFieldDirectMb]++;
        } else {
            for (int d = 0; d < 2; d++) {
                if (kind == (d ? kBForward : kBBackward)) continue;
                int(*mv)[2] = d ? b : f;
                int code = d ? bcode : fcode;
                if (!field) {
                    for (int k = 0; k < 2; k++)
                        mv[0][k] = last_mv[d][0][k] = last_mv[d][1][k] =
                            decode_motion(br, last_mv[d][0][k], code, true);
                } else {
                    for (int i = 0; i < 2; i++) {
                        mv[i][0] = last_mv[d][i][0] = decode_motion(br, last_mv[d][i][0], code, true);
                        mv[i][1] = decode_motion(br, last_mv[d][i][1] / 2, code, true);
                        last_mv[d][i][1] = mv[i][1] * 2;
                    }
                }
                dir |= 1 << d;
            }
            if (field) {
                mode = kMbField;
                stats[kFieldMb]++;
            }
            stats[kind == kBForward ? kForwardMb : kind == kBBackward ? kBackwardMb
                                                                       : kInterpolateMb]++;
        }
        for (int d = 0; d < 2; d++) {
            if (!(dir & (1 << d))) continue;
            const Picture& ref = d ? *next : *last;
            McOp op = {1, d == 1 && dir == 3};
            if (mode == kMbField) {
                for (int i = 0; i < 2; i++) {
                    const int* mv = d ? b[i] : f[i];
                    mc_field(ref, mbx, mby, i, sel[d][i], mv[0], mv[1], op);
                }
            } else {
                predict(ref, mbx, mby, mode == kMb8x8, d ? b : f, op);
            }
        }
        inter_blocks(br, mbx, mby, cbp);
    }

    // ---- video packets and error resilience (h263dec.c's decode_slice and
    // the resync loop of ff_h263_decode_frame, mpeg4videodec.c's
    // mpeg4_is_resync and video packet header)

    enum { kSliceOk, kSliceEnd };

    int packet_prefix() const {
        return type == 0 ? 16 : type == 1 ? fcode + 15 : std::max(std::max(fcode, bcode), 2) + 15;
    }
    int mb_num_bits() const {
        int n = mbw * mbh, bits = 0;
        while ((1 << bits) < n) bits++;
        return std::max(bits, 1);
    }
    static void align(BitReader& br) { br.pos = (br.pos + 7) & ~size_t(7); }

    // the first macroblock of the video packet a resync marker at the
    // current position starts, the VOP's macroblock count at its end, 0
    // when neither follows (stuffing macroblock types are skipped first)
    int is_resync(BitReader& br) {
        if (no_padding && !vol.resync) return 0;
        uint32_t v = br.peek(16);
        int pict_type = type + 1;  // FFmpeg's I 1, P 2, B 3
        while (v <= 0xFF) {
            if (type == 2 || (v >> (8 - pict_type)) != 1) break;
            br.skip(8 + pict_type);
            v = br.peek(16);
        }
        long bits = long(br.pos);
        if (bits + 8 >= long(br.nbits)) {
            v >>= 8;
            v |= 0x7F >> (7 - (bits & 7));
            if (v == 0x7F) return mbw * mbh;
        } else {
            static const uint16_t kPrefix[8] = {0x7F00, 0x7E00, 0x7C00, 0x7800,
                                                0x7000, 0x6000, 0x4000, 0x0000};
            if (v == kPrefix[bits & 7]) {
                BitReader g = br;
                g.skip(1);
                align(g);
                int len = 0;
                for (; len < 32; len++)
                    if (g.get1()) break;
                int mb = int(g.get(mb_num_bits()));
                if (!mb || mb > mbw * mbh || long(g.pos) + 6 > long(g.nbits)) mb = -1;
                if (len >= packet_prefix()) return mb;
            }
        }
        return 0;
    }

    // the video packet header after a resync marker (0 when it is one,
    // FFmpeg's checks): its first macroblock into (cx, cy), its quantiser
    int packet_header(BitReader& br) {
        if (long(br.pos) > long(br.nbits) - 20) return -1;
        int len = 0;
        for (; len < 32; len++)
            if (br.get1()) break;
        if (len != packet_prefix()) return -1;
        int mb = int(br.get(mb_num_bits()));
        if (mb >= mbw * mbh || !mb) return -1;
        cx = mb % mbw;
        cy = mb / mbw;
        int qs = int(br.get(5));
        if (qs) q = qs;
        if (br.get1()) {  // header_extension_code: the VOP header again (FFmpeg skips it)
            while (br.get1()) {
            }
            br.skip(1);
            br.skip(vol.time_bits);
            br.skip(1);
            br.skip(2 + 3);  // vop_coding_type, intra_dc_vlc_thr
            if (type) br.skip(3);
            if (type == 2) br.skip(3);
            stats[kHecPackets]++;
        }
        stats[kPackets]++;
        return 0;
    }

    // ff_h263_resync: the next video packet, at the current position or
    // searched byte by byte from where the last one's data began
    bool resync(BitReader& br) {
        br.skip(1);
        align(br);
        if (br.peek(16) == 0 && packet_header(br) == 0) return true;
        br.pos = last_resync_pos;
        align(br);
        for (long left = br.bits_left(); left > 16 + 1 + 5 + 5; left -= 8) {
            if (br.peek(16) == 0) {
                size_t bak = br.pos;
                if (packet_header(br) == 0) return true;
                br.pos = bak;
            }
            br.skip(8);
        }
        return false;
    }

    // one macroblock, then FFmpeg's end-of-packet check
    int decode_mb(BitReader& br) {
        if (type == 0) {
            int cbpc;
            do cbpc = tables().intra_mcbpc.decode(br, "mcbpc");
            while (cbpc == kIntraMcbpcStuffing);
            ff_intra = true;
            intra_mb(br, cx, cy, cbpc & 3, cbpc & 4);
        } else if (type == 1) {
            p_mb(br, cx, cy);
        } else {
            b_mb(br, cx, cy);
        }
        int next_mb = is_resync(br);
        if (!next_mb) return kSliceOk;
        if (cx + cy * mbw + 1 >= next_mb) return kSliceEnd;
        if (type == 2) {  // the next macroblock skipped: no marker yet
            size_t k = size_t(cy) * mbw + cx + 1;
            if (k < size_t(mbw) * mbh && next->skip[k]) return kSliceOk;
        }
        return kSliceEnd;
    }

    // ff_h263_update_motion_val for a macroblock that failed, on the state
    // its parse left (decode_slice sets mv_type to 16X16 before each
    // macroblock; mv keeps the last vectors written, of any macroblock):
    // nothing if the vectors were 8x8, else 0 if intra, mv[0][0], or the
    // two field vectors' x averaged (odd rounded up) and y summed
    void failed_motion(int mbx, int mby) {
        if (ff_mv_type == kFf8x8) return;
        int x = ff_mv[0][0], y = ff_mv[0][1];
        if (ff_intra) {
            x = y = 0;
        } else if (ff_mv_type == kFfField) {
            x += ff_mv[1][0];
            y += ff_mv[1][1];
            x = (x >> 1) | (x & 1);
        }
        for (int n = 0; n < 4; n++) {
            int16_t* m = block_mv(mbx, mby, n);
            m[0] = int16_t(x);
            m[1] = int16_t(y);
        }
    }

    // decode_slice: macroblocks from (cx, cy) to the packet's end; -1 when
    // the packet failed or did not end where its data did
    int decode_slice(BitReader& br) {
        last_resync_pos = br.pos;
        first_line = true;
        resync_x = cx;
        resync_y = cy;
        for (; cy < mbh; cy++) {
            for (; cx < mbw; cx++) {
                if (resync_x == cx && resync_y + 1 == cy) first_line = false;
                ff_mv_type = kFf16x16;
                int r;
                try {
                    r = decode_mb(br);
                } catch (const Error& e) {
                    r = -1;
                    error = e.what();
                }
                if (r >= 0) mbskip[size_t(cx + cy * (mbw + 1))] = type == 2 || cur->skip[size_t(cy) * mbw + cx];
                if (r < 0) {
                    if (type != 2) failed_motion(cx, cy);
                    er.add_slice(resync_x, resync_y, cx, cy, er::kMbError);
                    stats[kDamagedPackets]++;
                    return -1;
                }
                if (r == kSliceEnd) {
                    er.add_slice(resync_x, resync_y, cx, cy, er::kMbEnd);
                    padding_bug_score--;
                    if (++cx >= mbw) {
                        cx = 0;
                        cy++;
                    }
                    return 0;
                }
            }
            cx = 0;
        }
        // the end of the picture without the packet's end: FFmpeg's padding
        // bug detection, then its verdict
        long left = br.bits_left();
        if (left >= 48 && br.peek(24) == 0x4010) padding_bug_score += 32;
        if (left >= 0 && left < 137) {
            long bits = long(br.pos);
            if (left == 0) {
                padding_bug_score += 16;
            } else if (left != 1) {
                int v = int(br.peek(8));
                v |= 0x7F >> (7 - (bits & 7));
                if (v == 0x7F && left <= 8)
                    padding_bug_score--;
                else if (v == 0x7F && ((bits + 8) & 8) && left <= 16)
                    padding_bug_score += 4;
                else
                    padding_bug_score++;
            }
        }
        no_padding = padding_bug_score > -2;
        if (no_padding) {
            // FF_BUG_NO_PADDING: the picture may end anywhere before its
            // packet's end (FFmpeg's max_extra is 7 + 2^30 bits unless
            // err_recognition asks for AV_EF_BUFFER or AV_EF_AGGRESSIVE,
            // which cv2 does not); an overread leaves the packet unmarked
            if (left >= 0) er.add_slice(resync_x, resync_y, cx - 1, cy, er::kMbEnd);
            return 0;
        }
        er.add_slice(resync_x, resync_y, cx, cy, er::kMbEnd);  // "slice end not reached"
        stats[kDamagedPackets]++;
        return -1;
    }

    // one VOP's macroblocks into `cur`, packet by packet, then concealment
    void vop_data(BitReader& br) {
        edge_w = (bugs & kBugEdge) ? w : mbw * 16;
        edge_h = (bugs & kBugEdge) ? h : mbh * 16;
        std::memset(last_mv, 0, sizeof last_mv);
        er.frame_start();
        cx = cy = 0;
        bool failed = decode_slice(br) < 0;
        while (cy < mbh) {
            if (!resync(br)) break;
            if (failed) stats[kResyncs]++;
            clean_buffers(cx, cy);
            failed = decode_slice(br) < 0;
        }
        conceal();
    }

    // FFmpeg's ff_er_frame_end over the VOP
    void conceal() {
        const int ms = mbw + 1;
        for (int y = 0; y < mbh; y++)
            for (int x = 0; x < mbw; x++) {
                uint8_t k = cur->kind[size_t(y) * mbw + x];
                er_type[size_t(x + y * ms)] = k == kMbIntra ? er::kTypeIntra : er::kTypeInter;
            }
        auto pic = [&](Picture* p) {
            er::Pic e;
            if (!p) return e;
            for (int c = 0; c < 3; c++) {
                e.planes.data[c] = p->p[c].data();
                e.planes.linesize[c] = c ? cs : ys;
            }
            e.motion_val = reinterpret_cast<int16_t(*)[2]>(p->mv.data() + size_t(b8s) * 2);
            e.ref_index = p->ref_index.data();
            return e;
        };
        er.cur = pic(cur.get());
        er.last = pic(last.get());
        er.next = pic(next.get());  // an I- or P-VOP's is itself, as FFmpeg's next_pic
        er.mb_type = er_type.data();
        er.mbskip = mbskip.data();  // FFmpeg's decoder-wide table, kept across VOPs
        er.b_picture = type == 2;
        er.i_picture = type == 0;
        er.pp_time = int(pp_time);
        er.pb_time = int(pb_time);
        auto t0 = std::chrono::steady_clock::now();
        long n = er.frame_end();
        if (!n) return;
        stats[kConcealUs] += std::chrono::duration_cast<std::chrono::microseconds>(
                                 std::chrono::steady_clock::now() - t0).count();
        stats[kConcealedMbs] += n;
        stats[kDamagedVops]++;
        for (int y = 0; y < mbh; y++)
            for (int x = 0; x < mbw; x++) {
                if (!(er.status[size_t(x + y * ms)] & er::kMbError)) continue;
                cur->kind[size_t(y) * mbw + x] =
                    er_type[size_t(x + y * ms)] & er::kTypeIntra ? kMbIntra : kMb16x16;
            }
    }

    // concealment's macroblock: predicted from the references along
    // `mv_dir`, no residual (mpeg_er_decode_mb)
    void er_decode_mb(int mv_dir, const int (*mv)[2], int x, int y) {
        int rnd = type == 2 ? 1 : !rounding;
        if (mv_dir & er::kMvDirForward) predict(*last, x, y, false, &mv[0], {rnd, false});
        if (mv_dir & er::kMvDirBackward)
            predict(*next, x, y, false, &mv[1], {rnd, (mv_dir & er::kMvDirForward) != 0});
        clear_intra(x, y);
        mbskip[size_t(x + y * (mbw + 1))] = type == 2;
    }

    // ---- VOP

    enum { kDecoded, kSkipped };

    // the VOP header; kSkipped for a VOP that FFmpeg passes over
    int vop_header(BitReader& br) {
        if (!have_vol) fail("MPEG-4 video: a VOP before any VOL header");
        type = int(br.get(2));
        if (type == 3) fail("MPEG-4 S-VOPs (sprites / GMC) are not supported");
        if (type == 2 && low_delay && !vol.control) low_delay = false;
        int incr = 0;
        while (br.get1()) incr++;  // modulo_time_base
        br.get1();  // marker_bit: FFmpeg only logs its absence
        // no marker after vop_time_increment: FFmpeg takes the width from
        // the bits that follow instead, and keeps it
        if (!vol.time_bits || !(br.peek(vol.time_bits + 1) & 1)) {
            stats[kTimeBitsGuessed]++;
            for (vol.time_bits = 1; vol.time_bits < 16; vol.time_bits++) {
                if (type == 1 ? (br.peek(vol.time_bits + 6) & 0x37) == 0x30
                              : (br.peek(vol.time_bits + 5) & 0x1F) == 0x18)
                    break;
            }
        }
        long ticks = long(br.get(vol.time_bits));
        br.get1();  // marker_bit
        long res = vol.resolution;
        if (type != 2) {
            last_time_base = time_base;
            time_base += incr;
            time = time_base * res + ticks;
            if ((bugs & kBugUmp4) && time < last_non_b_time) {
                time_base++;
                time += res;
            }
            pp_time = time - last_non_b_time;
            last_non_b_time = time;
        } else {
            time = (last_time_base + incr) * res + ticks;
            pb_time = pp_time - (last_non_b_time - time);
            if (pp_time <= pb_time || pp_time <= pp_time - pb_time || pp_time <= 0)
                return kSkipped;  // FFmpeg: "messed up order"
            // the field times of field direct, from the first B-VOP's distance
            if (!t_frame) t_frame = pb_time;
            if (!t_frame) t_frame = 1;
            auto rdiv = [](long a, long b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; };
            long base = rdiv(last_non_b_time - pp_time, t_frame);
            pp_field_time = (rdiv(last_non_b_time, t_frame) - base) * 2;
            pb_field_time = (rdiv(time, t_frame) - base) * 2;
            if (pp_field_time <= pb_field_time || pb_field_time <= 1) {
                pb_field_time = 2;
                pp_field_time = 4;
                if (vol.interlaced) return kSkipped;
            }
        }
        if (!br.get1()) {  // vop_coded 0: an N-VOP
            stats[kNVops]++;
            return kSkipped;
        }
        rounding = type == 1 ? br.get1() : 0;
        dc_thr = kDcThreshold[br.get(3)];
        alt_scan = false;
        if (vol.interlaced) {
            tff = br.get1();
            alt_scan = br.get1();
        }
        q = int(br.get(5));
        if (!q) fail("corrupt MPEG-4 video: vop_quant of 0");
        fcode = bcode = 1;
        if (type) {
            fcode = int(br.get(3));
            if (!fcode) fail("corrupt MPEG-4 video: vop_fcode_forward of 0");
        }
        if (type == 2) {
            bcode = int(br.get(3));
            if (!bcode) fail("corrupt MPEG-4 video: vop_fcode_backward of 0");
        }
        if (vol.vo_type == 0 && !vol.control && divx_version == -1 && picture_number == 0)
            low_delay = true;  // FFmpeg: "(divx4/(old)xvid/opendivx) -> forcing low_delay"
        picture_number++;
        return kDecoded;
    }

    PicturePtr new_picture() {
        auto p = std::make_shared<Picture>();
        for (int c = 0; c < 3; c++) p->p[c].assign(cur_size(c), 0);
        p->mv.assign(size_t(b8s) * (2 * mbh + 1) * 2, 0);
        p->kind.assign(size_t(mbw) * mbh, kMbIntra);
        p->skip.assign(size_t(mbw) * mbh, 0);
        p->field_sel.assign(size_t(mbw) * mbh * 2, 0);
        p->field_mv.assign(size_t(mbw) * mbh * 4, 0);
        if (ref_free.empty()) {
            p->ref_index.assign(size_t(mbw + 1) * mbh * 4, 0);
        } else {
            p->ref_index = std::move(ref_free.back());
            ref_free.pop_back();
        }
        p->vop_type = type;
        return p;
    }
    size_t cur_size(int c) const { return c ? size_t(cs) * mbh * 8 : size_t(ys) * mbh * 16; }

    // one VOP from `buf` (its headers first), FFmpeg's ff_h263_decode_frame
    // after the header: the picture it lets out goes to `out`
    bool refused = false;  // the last sample's VOP header was damaged: FFmpeg refuses it
    bool decode_vop(BitReader& br) {
        int r;
        try {
            r = vop_header(br);
        } catch (const Error& e) {
            // FFmpeg's "header damaged": the sample gives no picture
            if (std::strncmp(e.what(), "corrupt MPEG-4 video: vop_", 26)) throw;
            stats[kDamagedHeaders]++;
            refused = true;
            return false;
        }
        skipped_last = r == kSkipped;
        if (r == kSkipped) return false;
        workaround_bugs();
        if ((bugs & kBugStdQpel) && vol.quarter)
            fail("MPEG-4 quarter-sample video of Lavc builds before 4653 (FFmpeg's old qpel "
                 "filter) is not supported");
        if (type == 2 && !last) return false;  // FFmpeg skips B-VOPs without references
        if (type == 1 && !next) fail("MPEG-4 video: a P-VOP without a reference picture");
        // ff_mpv_frame_start: the previous picture let go, the new one's
        // tables taken, then (not a B-VOP) the last reference replaced
        auto let_go = [&](Picture* p) {
            if (p && p != cur.get() && p != last.get() && p != next.get() && !p->ref_index.empty())
                ref_free.push_back(std::move(p->ref_index));
        };
        PicturePtr prev = std::move(cur);
        let_go(prev.get());
        cur = new_picture();
        if (type != 2) {
            PicturePtr old_last = std::move(last);
            last = next;
            next = cur;
            let_go(old_last.get());
        }
        stats[type == 0 ? kIVops : type == 1 ? kPVops : kBVops]++;
        if (type == 1) stats[rounding ? kRound1 : kRound0]++;
        stats[kMaxFcode] = std::max(stats[kMaxFcode], long(fcode));
        if (type == 2) stats[kMaxBcode] = std::max(stats[kMaxBcode], long(bcode));
        if (vol.quarter) stats[kQpelVops]++;
        if (vol.mpeg_quant) stats[kMpegQuantVops]++;
        if (use_xvid_idct) stats[kXvidIdctVops]++;
        if (vol.interlaced) stats[kInterlacedVops]++;
        if (alt_scan) stats[kAltScanVops]++;
        vop_data(br);
        if (type == 2 || low_delay)
            out.push_back(cur);
        else if (last)
            out.push_back(last);
        return true;
    }

    // one sample: header units, then its first VOP (a packed B-VOP after it
    // kept for the next sample, as FFmpeg keeps DivX's)
    void decode(const uint8_t* data, size_t n) {
        refused = false;
        if (n >= 3 && data[0] == 0 && data[1] == 0 && (data[2] & 0xfc) == 0x80)
            fail("MPEG-4 short video header (H.263 baseline) streams are not supported");
        std::vector<uint8_t> buf;
        bool from_stash = false;
        if (!stash.empty() && divx_packed) {
            for (size_t i = 0; i + 3 < n; i++)
                if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1) {
                    if (data[i + 3] == 0xb0) stash.clear();  // "Discarding excessive bitstream"
                    break;
                }
        }
        if (!stash.empty() && (divx_packed || n <= 19)) {
            buf.swap(stash);
            from_stash = true;
            stats[kPackedBVops]++;
        } else {
            buf.assign(data, data + n);
        }
        stash.clear();
        size_t bn = buf.size();
        buf.resize(bn + 8, 0);
        size_t i = 0;
        while (true) {
            // find the next start code 00 00 01 xx
            while (i + 3 < bn && !(buf[i] == 0 && buf[i + 1] == 0 && buf[i + 2] == 1)) i++;
            if (i + 3 >= bn) {  // headers only: no picture
                skipped_last = false;
                return;
            }
            int code = buf[i + 3];
            size_t start = i + 4, end = start;
            while (end + 2 < bn && !(buf[end] == 0 && buf[end + 1] == 0 && buf[end + 2] == 1))
                end++;
            if (end + 2 >= bn) end = bn;
            if (code == 0xb6) {
                // the VOP runs to the end of the sample, as FFmpeg reads it
                BitReader br(&buf[start], bn - start);
                br.unchecked = true;
                if (decode_vop(br) && divx_packed)
                    keep_packed(data, n, from_stash ? 0 : start + (br.pos >> 3));
                return;
            }
            std::vector<uint8_t> unit(buf.begin() + long(start), buf.begin() + long(end));
            unit.resize(unit.size() + 8, 0);
            BitReader br(unit.data(), end - start);
            if (code >= 0x20 && code <= 0x2f)
                parse_vol(br);
            else if (code == 0xb2)
                parse_user_data(unit.data(), end - start);
            i = end;
        }
    }

    // ff_mpeg4_frame_end: a DivX sample's second VOP, an I- or B-VOP after
    // the decoded one, is kept for the next sample
    void keep_packed(const uint8_t* data, size_t n, size_t pos) {
        if (n <= pos + 7) return;
        for (size_t i = pos; i + 4 < n; i++)
            if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1 && data[i + 3] == 0xb6) {
                if (!(data[i + 4] & 0x40)) stash.assign(data + pos, data + n);
                return;
            }
    }

    // the end of the stream: FFmpeg's last reference, or the last picture
    // again after a closing N-VOP
    void flush() {
        if (!low_delay && next) {
            out.push_back(next);
            next.reset();
        } else if (skipped_last && cur) {
            out.push_back(cur);
            cur.reset();
        }
    }
};

// ---------------------------------------------------------------- encoder

struct BitWriter {
    std::vector<uint8_t> out;
    uint64_t acc = 0;
    int nacc = 0;
    void put(uint32_t v, int n) {  // n <= 32
        if (!n) return;
        acc = (acc << n) | (uint64_t(v) & ((uint64_t(1) << n) - 1));
        nacc += n;
        while (nacc >= 8) {
            nacc -= 8;
            out.push_back(uint8_t(acc >> nacc));
        }
    }
    void put(const Code& c) { put(c.code, c.len); }
    void stuffing() {  // next_start_code: a 0, then 1s to the byte boundary
        put(0, 1);
        while (nacc) put(1, 1);
    }
    void start_code(uint8_t code) {
        put(1, 24);
        put(code, 8);
    }
};

struct Encoder : Codec {
    int q = 4, gop = 12, fcode = 2, resolution = 30, increment = 1, time_bits = 5;
    long frame_no = 0, last_seconds = 0;
    int rounding = 0;
    BitWriter bw;
    std::string error;
    std::vector<uint8_t> src[3];
    std::vector<uint8_t> padded;  // the reference luma padded by kPad for the search
    static constexpr int kPad = 64;
    int ps = 0;

    void setup(int width, int height, int quant, int gop_, int fcode_, int res, int inc) {
        if (quant < 1 || quant > 31) fail("vop_quant must be in 1..31");
        if (fcode_ < 1 || fcode_ > 7) fail("f_code must be in 1..7");
        if (gop_ < 1) fail("the I-VOP interval must be at least 1");
        if (res < 1 || res > 65535 || inc < 1 || inc >= res * 64)
            fail("the time resolution must be in 1..65535 and the increment positive");
        init(width, height);
        q = quant;
        gop = gop_;
        fcode = fcode_;
        resolution = res;
        increment = inc;
        int bits = 0;
        while ((1 << bits) < resolution) bits++;
        time_bits = std::max(bits, 1);
        for (int c = 0; c < 3; c++) src[c].assign(cur[c].size(), 0);
        ps = ys + 2 * kPad;
        padded.assign(size_t(ps) * (mbh * 16 + 2 * kPad), 0);
    }

    // VOS, VO and VOL headers: the DecoderSpecificInfo of the container
    std::vector<uint8_t> header() {
        BitWriter b;
        b.start_code(0xb0);
        b.put(0x01, 8);  // Simple Profile (FFmpeg writes level 1 too)
        b.start_code(0xb5);
        b.put(0, 1);  // is_visual_object_identifier
        b.put(1, 4);  // visual_object_type: video
        b.put(0, 1);  // video_signal_type
        b.stuffing();
        b.start_code(0x00);  // video_object_start_code
        b.start_code(0x20);  // video_object_layer_start_code
        b.put(0, 1);         // random_accessible_vol
        b.put(1, 8);         // video_object_type_indication: simple
        b.put(0, 1);         // is_object_layer_identifier
        b.put(1, 4);         // aspect_ratio_info: square pixels
        b.put(1, 1);         // vol_control_parameters
        b.put(1, 2);         // chroma_format 4:2:0
        b.put(1, 1);         // low_delay
        b.put(0, 1);         // vbv_parameters
        b.put(0, 2);         // rectangular
        b.put(1, 1);
        b.put(uint32_t(resolution), 16);
        b.put(1, 1);
        b.put(0, 1);  // fixed_vop_rate
        b.put(1, 1);
        b.put(uint32_t(w), 13);
        b.put(1, 1);
        b.put(uint32_t(h), 13);
        b.put(1, 1);
        b.put(0, 1);  // interlaced
        b.put(1, 1);  // obmc_disable
        b.put(0, 1);  // sprite_enable
        b.put(0, 1);  // not_8_bit
        b.put(0, 1);  // quant_type: H.263
        b.put(1, 1);  // complexity_estimation_disable
        b.put(1, 1);  // resync_marker_disable
        b.put(0, 1);  // data_partitioned
        b.put(0, 1);  // scalability
        b.stuffing();
        return b.out;
    }

    // ---- source and search

    void load_source(const uint8_t* yuv) {
        int cw = w / 2, ch = h / 2;
        const uint8_t* planes[3] = {yuv, yuv + size_t(w) * h,
                                    yuv + size_t(w) * h + size_t(cw) * ch};
        for (int c = 0; c < 3; c++) {
            int pw = c ? cw : w, ph = c ? ch : h, stride = c ? cs : ys;
            int rows = c ? mbh * 8 : mbh * 16;
            for (int y = 0; y < rows; y++) {
                uint8_t* d = &src[c][size_t(y) * stride];
                std::memcpy(d, planes[c] + size_t(std::min(y, ph - 1)) * pw, pw);
                std::memset(d + pw, d[pw - 1], stride - pw);
            }
        }
    }

    void pad_reference() {
        int rows = mbh * 16 + 2 * kPad;
        for (int y = 0; y < rows; y++) {
            int sy = std::min(std::max(y - kPad, 0), edge_h - 1);
            const uint8_t* s = &ref[0][size_t(sy) * ys];
            uint8_t* d = &padded[size_t(y) * ps];
            std::memset(d, s[0], kPad);
            std::memcpy(d + kPad, s, edge_w);
            std::memset(d + kPad + edge_w, s[edge_w - 1], ps - kPad - edge_w);
        }
    }

    int sad_full(const uint8_t* s, int x, int y) const {  // integer-pel, padded reference
        const uint8_t* r = &padded[size_t(y + kPad) * ps + x + kPad];
        int sum = 0;
        for (int j = 0; j < 16; j++)
            for (int i = 0; i < 16; i++) sum += std::abs(int(s[j * ys + i]) - int(r[j * ps + i]));
        return sum;
    }
    int sad_half(const uint8_t* s, int x0, int y0, int mx, int my) const {
        uint8_t p[256];
        mc_block(&padded[size_t(kPad) * ps + kPad], ps, ps, mbh * 16 + kPad, x0 + (mx >> 1),
                 y0 + (my >> 1), ((my & 1) << 1) | (mx & 1), 16, 16, rounding, p, 16);
        int sum = 0;
        for (int j = 0; j < 16; j++)
            for (int i = 0; i < 16; i++) sum += std::abs(int(s[j * ys + i]) - int(p[j * 16 + i]));
        return sum;
    }

    // the best half-pel vector of macroblock (mbx, mby) and its SAD
    int search(int mbx, int mby, int& best_x, int& best_y) {
        int x0 = mbx * 16, y0 = mby * 16;
        const uint8_t* s = &src[0][size_t(y0) * ys + x0];
        int lo = -(16 << (fcode - 1)), hi = (16 << (fcode - 1)) - 1;  // integer pels
        // keep the window inside the padded reference
        int lox = std::max(lo, -x0 - kPad + 1), hix = std::min(hi, ys + kPad - 18 - x0);
        int loy = std::max(lo, -y0 - kPad + 1), hiy = std::min(hi, mbh * 16 + kPad - 18 - y0);
        auto cost = [&](int x, int y) {
            int c = sad_full(s, x0 + x, y0 + y);
            return (x || y) ? c : c - 129;  // favour the zero vector
        };
        int px, py;
        mv_predict(mbx, mby, px, py);
        int cands[4][2] = {{0, 0}, {px >> 1, py >> 1}, {0, 0}, {0, 0}};
        int nc = 2;
        if (mbx) {
            size_t i = (size_t(mby) * mbw + mbx - 1) * 2;
            cands[nc][0] = mvs[i] >> 1;
            cands[nc++][1] = mvs[i + 1] >> 1;
        }
        if (mby) {
            size_t i = (size_t(mby - 1) * mbw + mbx) * 2;
            cands[nc][0] = mvs[i] >> 1;
            cands[nc++][1] = mvs[i + 1] >> 1;
        }
        int bx = 0, by = 0, best = 1 << 30;
        for (int k = 0; k < nc; k++) {
            int x = std::min(std::max(cands[k][0], lox), hix);
            int y = std::min(std::max(cands[k][1], loy), hiy);
            int c = cost(x, y);
            if (c < best) best = c, bx = x, by = y;
        }
        static const int kLarge[8][2] = {{0, -2}, {1, -1}, {2, 0},  {1, 1},
                                         {0, 2},  {-1, 1}, {-2, 0}, {-1, -1}};
        static const int kSmall[4][2] = {{0, -1}, {1, 0}, {0, 1}, {-1, 0}};
        for (int iter = 0; iter < 64; iter++) {
            int nx = bx, ny = by;
            for (auto& d : kLarge) {
                int x = bx + d[0], y = by + d[1];
                if (x < lox || x > hix || y < loy || y > hiy) continue;
                int c = cost(x, y);
                if (c < best) best = c, nx = x, ny = y;
            }
            if (nx == bx && ny == by) break;
            bx = nx;
            by = ny;
        }
        for (auto& d : kSmall) {
            int x = bx + d[0], y = by + d[1];
            if (x < lox || x > hix || y < loy || y > hiy) continue;
            int c = cost(x, y);
            if (c < best) best = c, bx = x, by = y;
        }
        int hx = 2 * bx, hy = 2 * by, hbest = best;
        for (int dy = -1; dy <= 1; dy++)
            for (int dx = -1; dx <= 1; dx++) {
                if (!dx && !dy) continue;
                int mx = 2 * bx + dx, my = 2 * by + dy;
                if (mx < 2 * lox || mx > 2 * hix || my < 2 * loy || my > 2 * hiy) continue;
                int c = sad_half(s, x0, y0, mx, my);
                if (c < hbest) hbest = c, hx = mx, hy = my;
            }
        best_x = hx;
        best_y = hy;
        return hbest;
    }

    const uint8_t* source_block(int mbx, int mby, int n) const {
        if (n < 4)
            return &src[0][size_t(mby * 16 + (n >> 1) * 8) * ys + mbx * 16 + (n & 1) * 8];
        return &src[n - 3][size_t(mby) * 8 * cs + mbx * 8];
    }

    // ---- transform and entropy coding

    // the orthonormal 8x8 DCT of (source - prediction), in the IDCT's scale
    static void fdct(const uint8_t* s, int stride, const uint8_t* pred, int pstride, float* out) {
        struct Basis {
            float m[8][8];
            Basis() {
                for (int u = 0; u < 8; u++)
                    for (int x = 0; x < 8; x++)
                        m[u][x] = float((u ? 0.5 : std::sqrt(0.125)) *
                                        std::cos((2 * x + 1) * u * M_PI / 16));
            }
        };
        static const Basis basis;
        const auto& m = basis.m;
        float blk[8][8], tmp[8][8];
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++)
                blk[y][x] = float(s[y * stride + x]) - (pred ? float(pred[y * pstride + x]) : 0.f);
        for (int y = 0; y < 8; y++)
            for (int u = 0; u < 8; u++) {
                float a = 0;
                for (int x = 0; x < 8; x++) a += m[u][x] * blk[y][x];
                tmp[y][u] = a;
            }
        for (int v = 0; v < 8; v++)
            for (int u = 0; u < 8; u++) {
                float a = 0;
                for (int y = 0; y < 8; y++) a += m[v][y] * tmp[y][u];
                out[v * 8 + u] = a;
            }
    }

    // levels in scan order from position `first` -> TCOEF events
    void put_coeffs(bool intra, const int16_t* blk, const uint8_t* scan, int first) {
        const Tables& t = tables();
        const RunLevel& rl = intra ? kIntraTcoef : kInterTcoef;
        const Escapes& esc = intra ? t.intra_esc : t.inter_esc;
        auto& index = intra ? t.intra_index : t.inter_index;
        int lastpos = -1;
        for (int i = 63; i >= first; i--)
            if (blk[scan[i]]) {
                lastpos = i;
                break;
            }
        int run = 0;
        for (int i = first; i <= lastpos; i++) {
            int level = blk[scan[i]];
            if (!level) {
                run++;
                continue;
            }
            int last = i == lastpos, a = std::abs(level), sign = level < 0;
            int idx = a <= 27 ? index[last][run][a] : -1;
            if (idx >= 0) {
                bw.put(rl.codes[idx]);
                bw.put(sign, 1);
            } else {
                int a1 = a - esc.max_level[last][run];
                int r2 = run - esc.max_run[last][std::min(a, 64)] - 1;
                int idx1 = a1 > 0 && a1 <= 27 ? index[last][run][a1] : -1;
                int idx2 = a <= 27 && r2 >= 0 ? index[last][r2][a] : -1;
                bw.put(rl.codes[kEscape]);
                if (idx1 >= 0) {
                    bw.put(0, 1);
                    bw.put(rl.codes[idx1]);
                    bw.put(sign, 1);
                } else if (idx2 >= 0) {
                    bw.put(2, 2);
                    bw.put(rl.codes[idx2]);
                    bw.put(sign, 1);
                } else {
                    bw.put(3, 2);
                    bw.put(last, 1);
                    bw.put(run, 6);
                    bw.put(1, 1);
                    bw.put(uint32_t(level) & 0xfff, 12);
                    bw.put(1, 1);
                }
            }
            run = 0;
        }
    }

    void put_dc(int diff, bool luma) {
        int a = std::abs(diff), size = 0;
        while ((1 << size) <= a) size++;
        bw.put((luma ? kDcLuma : kDcChroma)[size]);
        if (size) {
            bw.put(uint32_t(diff > 0 ? diff : diff + (1 << size) - 1), size);
            if (size > 8) bw.put(1, 1);
        }
    }

    void put_motion(int val) {
        int shift = fcode - 1, bits = 5 + fcode;
        val = int(uint32_t(val) << (32 - bits)) >> (32 - bits);
        if (!val) {
            bw.put(kMvd[0]);
            return;
        }
        int sign = val < 0, a = std::abs(val) - 1;
        int code = (a >> shift) + 1;
        bw.put(kMvd[code]);
        bw.put(sign, 1);
        if (shift) bw.put(uint32_t(a & ((1 << shift) - 1)), shift);
    }

    // the largest |level| whose dequantised value stays within 12 bits
    int max_level() const { return (2047 - ((q - 1) | 1)) / (2 * q); }

    // an intra macroblock: levels, DC/AC prediction as the decoder does,
    // the bits, and the reconstruction
    void encode_intra_mb(int mbx, int mby, bool pvop) {
        int16_t target[6][64], coded[6][64];
        int dirs[6], dc_diff[6];
        int lmax = max_level();
        int score = 0;
        for (int n = 0; n < 6; n++) {
            int c = comp(n), bx, by, stride = c ? cs : ys;
            block_xy(mbx, mby, n, bx, by);
            const uint8_t* s = source_block(mbx, mby, n);
            float f[64];
            fdct(s, stride, nullptr, 0, f);
            int scale = n < 4 ? luma_dc_scale(q) : chroma_dc_scale(q);
            target[n][0] = int16_t(std::min(std::max(int(std::lround(f[0] / scale)), 1), 254));
            for (int i = 1; i < 64; i++) {
                int l = int(std::fabs(f[i])) / (2 * q);
                l = std::min(l, lmax);
                target[n][i] = int16_t(f[i] < 0 ? -l : l);
            }
            int pred = dc_predict(c, bx, by, scale, dirs[n]);
            dc_diff[n] = target[n][0] - pred;
            dc_store(c, bx, by, target[n][0], scale);
            // the prediction of the first column or row (ac_predict on zeros,
            // which also stores them: the block's own values replace them),
            // and its gain on this block (FFmpeg's decide_ac_pred)
            std::memcpy(coded[n], target[n], sizeof coded[n]);
            int16_t predicted[64] = {};
            ac_predict(c, bx, by, mbx, mby, q, dirs[n], true, predicted);
            int16_t* mine = &ac[c][(size_t(by) * bgw(c) + bx) * 16];
            for (int i = 1; i < 8; i++) {
                int k = dirs[n] == 0 ? i * 8 : i;
                score += std::abs(target[n][k]) - std::abs(target[n][k] - predicted[k]);
                coded[n][k] = int16_t(target[n][k] - predicted[k]);
                mine[i] = target[n][i * 8];
                mine[8 + i] = target[n][i];
            }
        }
        bool ac_pred = score > 0;
        int cbp = 0;
        for (int n = 0; n < 6; n++) {
            const int16_t* blk = ac_pred ? coded[n] : target[n];
            for (int i = 1; i < 64; i++)
                if (blk[i]) {
                    cbp |= 32 >> n;
                    break;
                }
        }
        if (pvop) {
            bw.put(0, 1);  // coded
            bw.put(kInterMcbpc[4 | (cbp & 3)]);
        } else {
            bw.put(kIntraMcbpc[cbp & 3]);
        }
        bw.put(ac_pred, 1);
        bw.put(kCbpy[cbp >> 2]);
        for (int n = 0; n < 6; n++) {
            put_dc(dc_diff[n], n < 4);
            if (cbp & (32 >> n)) {
                const uint8_t* scan =
                    !ac_pred ? kZigzag : dirs[n] == 0 ? kAltVertical : kAltHorizontal;
                put_coeffs(true, ac_pred ? coded[n] : target[n], scan, 1);
            }
        }
        mbq[size_t(mby) * mbw + mbx] = int8_t(q);
        for (int n = 0; n < 6; n++) recon_intra(mbx, mby, n, q, target[n]);
        mvs[(size_t(mby) * mbw + mbx) * 2] = mvs[(size_t(mby) * mbw + mbx) * 2 + 1] = 0;
    }

    // a P-VOP macroblock: inter, not_coded or intra
    void encode_p_mb(int mbx, int mby) {
        size_t mi = size_t(mby) * mbw + mbx;
        int mx, my;
        int sad = search(mbx, mby, mx, my);
        const uint8_t* s = &src[0][size_t(mby * 16) * ys + mbx * 16];
        int sum = 0;
        for (int j = 0; j < 16; j++)
            for (int i = 0; i < 16; i++) sum += s[j * ys + i];
        int mean = (sum + 128) >> 8, dev = 0;
        for (int j = 0; j < 16; j++)
            for (int i = 0; i < 16; i++) dev += std::abs(s[j * ys + i] - mean);
        if (dev < sad - 512) {
            encode_intra_mb(mbx, mby, true);
            return;
        }
        mbq[mi] = int8_t(q);
        predict_mb(mbx, mby, mx, my, rounding);
        int16_t lv[6][64];
        int cbp = 0, lmax = max_level();
        for (int n = 0; n < 6; n++) {
            int stride;
            uint8_t* p = block_ptr(mbx, mby, n, stride);
            const uint8_t* sp = source_block(mbx, mby, n);
            float f[64];
            fdct(sp, stride, p, stride, f);
            for (int i = 0; i < 64; i++) {
                int l = (int(std::fabs(f[i])) - q / 2) / (2 * q);
                l = std::min(std::max(l, 0), lmax);
                lv[n][i] = int16_t(f[i] < 0 ? -l : l);
                if (l) cbp |= 32 >> n;
            }
        }
        clear_intra(mbx, mby);
        if (!mx && !my && !cbp) {
            bw.put(1, 1);  // not_coded
            mvs[mi * 2] = mvs[mi * 2 + 1] = 0;
            return;
        }
        int px, py;
        mv_predict(mbx, mby, px, py);
        mvs[mi * 2] = int16_t(mx);
        mvs[mi * 2 + 1] = int16_t(my);
        bw.put(0, 1);
        bw.put(kInterMcbpc[cbp & 3]);
        bw.put(kCbpy[(cbp >> 2) ^ 15]);
        put_motion(mx - px);
        put_motion(my - py);
        int qmul = 2 * q, qadd = (q - 1) | 1;
        for (int n = 0; n < 6; n++) {
            if (!(cbp & (32 >> n))) continue;
            put_coeffs(false, lv[n], kZigzag, 0);
            int16_t blk[64];
            for (int i = 0; i < 64; i++) {
                int l = lv[n][i];
                blk[i] = int16_t(!l ? 0 : l > 0 ? l * qmul + qadd : l * qmul - qadd);
            }
            recon_inter(mbx, mby, n, blk);
        }
    }

    // one frame (packed I420 of w x h) -> one VOP in bw.out
    void encode(const uint8_t* yuv, bool& key) {
        load_source(yuv);
        bw.out.clear();
        key = frame_no % gop == 0;
        int type = key ? 0 : 1;
        if (type == 1) {
            rounding ^= 1;  // flipped every P-VOP, as FFmpeg does
            pad_reference();
        } else {
            rounding = 0;
        }
        long ticks = frame_no * increment;
        long seconds = ticks / resolution;
        bw.start_code(0xb6);
        bw.put(uint32_t(type), 2);
        for (long s = last_seconds; s < seconds; s++) bw.put(1, 1);  // modulo_time_base
        bw.put(0, 1);
        last_seconds = seconds;
        bw.put(1, 1);
        bw.put(uint32_t(ticks % resolution), time_bits);
        bw.put(1, 1);
        bw.put(1, 1);  // vop_coded
        if (type == 1) bw.put(uint32_t(rounding), 1);
        bw.put(0, 3);  // intra_dc_vlc_thr: the DC VLC throughout
        bw.put(uint32_t(q), 5);
        if (type == 1) bw.put(uint32_t(fcode), 3);
        for (int mby = 0; mby < mbh; mby++)
            for (int mbx = 0; mbx < mbw; mbx++) {
                if (type == 0)
                    encode_intra_mb(mbx, mby, false);
                else
                    encode_p_mb(mbx, mby);
            }
        bw.stuffing();
        swap_frames();
        frame_no++;
    }
};

template <class F>
int guarded(std::string* error, F&& f) {
    try {
        return f();
    } catch (const std::exception& e) {
        if (error) *error = e.what();
        return -1;
    }
}

}  // namespace


extern "C" {

// ---- decoder

void* mpeg4_decoder_new() { return new (std::nothrow) Decoder(); }
void mpeg4_decoder_free(void* d) { delete static_cast<Decoder*>(d); }
const char* mpeg4_decoder_error(void* d) { return static_cast<Decoder*>(d)->error.c_str(); }

// the container's codec tag (an AVI's fourcc, little-endian), which FFmpeg
// reads for its workarounds; 0 for none
void mpeg4_decoder_tag(void* d, unsigned tag) { static_cast<Decoder*>(d)->codec_tag = tag; }

// parses the DecoderSpecificInfo (VOS/VO/VOL/user data); -1 on error
int mpeg4_decoder_config(void* dp, const uint8_t* data, long n, int* width, int* height) {
    Decoder* d = static_cast<Decoder*>(dp);
    return guarded(&d->error, [&] {
        if (n < 0) fail("negative length");
        d->decode(data, size_t(n));
        if (!d->have_vol) fail("MPEG-4 video configuration without a VOL header");
        d->out.clear();
        *width = d->w;
        *height = d->h;
        return 0;
    });
}

// one sample -> the number of pictures waiting to be taken
// (mpeg4_decoder_output), -1 on error.  A sample may change the VOL size:
// the caller reads *width / *height before the planes.
int mpeg4_decode(void* dp, const uint8_t* data, long n, int* width, int* height) {
    Decoder* d = static_cast<Decoder*>(dp);
    return guarded(&d->error, [&] {
        if (n < 0) fail("negative length");
        int w0 = d->w, h0 = d->h;
        d->decode(data, size_t(n));
        *width = d->w;
        *height = d->h;
        if (d->w != w0 || d->h != h0) fail("the MPEG-4 VOL changed the picture size mid-stream");
        return int(d->out.size());
    });
}

// 1 when FFmpeg refuses the last sample as a packet ("header damaged")
int mpeg4_decoder_refused(void* dp) { return static_cast<Decoder*>(dp)->refused; }

// the end of the stream -> the number of pictures waiting
int mpeg4_decoder_flush(void* dp) {
    Decoder* d = static_cast<Decoder*>(dp);
    d->flush();
    return int(d->out.size());
}

// the oldest waiting picture, cropped I420 into `out` (w*h + 2*cw*ch bytes),
// its VOP type (0 I, 1 P, 2 B) in *type; 1 when none waits, -1 on error
int mpeg4_decoder_output(void* dp, uint8_t* out, long out_size, int* type) {
    Decoder* d = static_cast<Decoder*>(dp);
    return guarded(&d->error, [&] {
        if (d->out.empty()) return 1;
        long need = long(d->w) * d->h + 2L * ((d->w + 1) / 2) * ((d->h + 1) / 2);
        if (out_size < need) fail("output buffer too small");
        PicturePtr p = d->out.front();
        d->out.erase(d->out.begin());
        d->crop(p->p, out);
        *type = p->vop_type;
        return 0;
    });
}

int mpeg4_decoder_stats(void* dp, long* out, int n) {
    Decoder* d = static_cast<Decoder*>(dp);
    for (int i = 0; i < n && i < kNumStats; i++) out[i] = d->stats[i];
    return kNumStats;
}

// ---- encoder

void* mpeg4_encoder_new() { return new (std::nothrow) Encoder(); }
void mpeg4_encoder_free(void* e) { delete static_cast<Encoder*>(e); }
const char* mpeg4_encoder_error(void* e) { return static_cast<Encoder*>(e)->error.c_str(); }

// w x h (even), vop_quant, I-VOP interval, f_code, and the time base:
// `increment` ticks of 1 / `resolution` s per frame; -1 on error
int mpeg4_encoder_open(void* ep, int width, int height, int quant, int gop, int fcode,
                       int resolution, int increment) {
    Encoder* e = static_cast<Encoder*>(ep);
    return guarded(&e->error, [&] {
        if (width % 2 || height % 2) fail("the MPEG-4 encoder takes even frame sides");
        e->setup(width, height, quant, gop, fcode, resolution, increment);
        return 0;
    });
}

// the VOS/VO/VOL headers into `out` (64 bytes); returns their length
int mpeg4_encoder_header(void* ep, uint8_t* out) {
    std::vector<uint8_t> h = static_cast<Encoder*>(ep)->header();
    std::memcpy(out, h.data(), h.size());
    return int(h.size());
}

// one packed I420 frame -> the VOP's length (its bytes through
// mpeg4_encoder_output), the reconstruction into `recon` (same layout) when
// not null, *key = 1 for an I-VOP; -1 on error
long mpeg4_encode(void* ep, const uint8_t* yuv, uint8_t* recon, int* key) {
    Encoder* e = static_cast<Encoder*>(ep);
    long r = -1;
    guarded(&e->error, [&] {
        bool k;
        e->encode(yuv, k);
        if (recon) e->crop(e->ref, recon);
        *key = k;
        r = long(e->bw.out.size());
        return 0;
    });
    return r;
}

void mpeg4_encoder_output(void* ep, uint8_t* out) {
    Encoder* e = static_cast<Encoder*>(ep);
    std::memcpy(out, e->bw.out.data(), e->bw.out.size());
}

}  // extern "C"

