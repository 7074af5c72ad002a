// MPEG-4 Part 2 Simple Profile video (ISO/IEC 14496-2, the `mp4v` that
// cv2.VideoWriter writes through FFmpeg): a decoder of I- and P-VOPs and an
// encoder that writes what the decoder reads, for render/mpeg4.py.
//
// Decoder: VOS/VO/VOL/GOV/user-data headers; rectangular progressive VOLs
// with H.263 quantisation; I-VOPs (intra DC VLCs with DC prediction, AC
// prediction, the intra TCOEF VLC and its three escapes) and P-VOPs (1MV
// half-pel motion with median prediction, f_code 1-7, unrestricted vectors
// clamped at the picture edge, not_coded and intra macroblocks, the inter
// TCOEF VLC), reconstructed with FFmpeg's "simple" integer IDCT, the one
// libavcodec picks for Lavc streams, so that the planes equal FFmpeg's.
// Every other tool (B-VOPs, 4MV, MPEG quantisation, interlace, data
// partitioning, sprites, quarter-pel, the short video header, resync
// markers, ...) fails with an error that names it; corrupt or truncated
// data fails too, and no read leaves the input.  Errors are C++ exceptions
// caught at the C entry points, which return -1 and keep the message.
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
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
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
// 16 (inter4v); 20 is stuffing
const Code kInterMcbpc[21] = {
    {1, 1}, {3, 4}, {2, 4}, {5, 6},   // inter
    {3, 5}, {4, 8}, {3, 8}, {3, 7},   // intra
    {3, 3}, {7, 7}, {6, 7}, {5, 9},   // inter+q
    {4, 6}, {4, 9}, {3, 9}, {2, 9},   // intra+q
    {2, 3}, {5, 7}, {4, 7}, {5, 8},   // inter4v
    {1, 9}};                          // stuffing
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

    BitReader(const uint8_t* data, size_t nbytes) : p(data), nbits(nbytes * 8) {}
    uint32_t peek(int n) const {  // n <= 32; bits past the end read as 0
        const uint8_t* b = p + (pos >> 3);
        uint64_t v = 0;
        for (int i = 0; i < 8; i++) v = v << 8 | b[i];
        return uint32_t((v << (pos & 7)) >> (64 - n));
    }
    void skip(int n) {
        if (pos + n > nbits) fail("truncated MPEG-4 video data");
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
    size_t left() const { return nbits - pos; }
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
    Vlc intra_mcbpc{kIntraMcbpc, 9}, inter_mcbpc{kInterMcbpc, 21}, cbpy{kCbpy, 16},
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

// decoder counters, read by the tests to show which tools a stream used
enum Stat {
    kIVops, kPVops, kRound0, kRound1, kIntraMbI, kIntraMbP, kInterMb, kNotCoded, kAcPredOn,
    kAcPredOff, kEsc1, kEsc2, kEsc3, kMaxFcode, kMvOutside, kDquantMb, kNumStats
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
        uint8_t win[17 * 17];
        const uint8_t* s;
        int ss;
        if (x >= 0 && y >= 0 && x + bw + 1 <= ew && y + bh + 1 <= eh) {
            s = src + size_t(y) * stride + x;
            ss = stride;
        } else {
            for (int j = 0; j <= bh; j++) {
                int yy = std::min(std::max(y + j, 0), eh - 1);
                for (int i = 0; i <= bw; i++) {
                    int xx = std::min(std::max(x + i, 0), ew - 1);
                    win[j * 17 + i] = src[size_t(yy) * stride + xx];
                }
            }
            s = win;
            ss = 17;
        }
        switch (dxy) {
            case 0:
                for (int j = 0; j < bh; j++) std::memcpy(dst + j * dstride, s + j * ss, bw);
                break;
            case 1:
                for (int j = 0; j < bh; j++)
                    for (int i = 0; i < bw; i++)
                        dst[j * dstride + i] =
                            uint8_t((s[j * ss + i] + s[j * ss + i + 1] + 1 - rounding) >> 1);
                break;
            case 2:
                for (int j = 0; j < bh; j++)
                    for (int i = 0; i < bw; i++)
                        dst[j * dstride + i] =
                            uint8_t((s[j * ss + i] + s[(j + 1) * ss + i] + 1 - rounding) >> 1);
                break;
            default:
                for (int j = 0; j < bh; j++)
                    for (int i = 0; i < bw; i++)
                        dst[j * dstride + i] =
                            uint8_t((s[j * ss + i] + s[j * ss + i + 1] + s[(j + 1) * ss + i] +
                                     s[(j + 1) * ss + i + 1] + 2 - rounding) >> 2);
        }
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

struct Vol {
    int width = 0, height = 0, time_bits = 1, resolution = 0;
    bool resync_disable = true;
};

struct Decoder : Codec {
    bool have_vol = false;
    Vol vol;
    std::string error;

    // ---- headers

    void parse_vol(BitReader& br) {
        Vol v;
        br.skip(1);  // random_accessible_vol
        int type = int(br.get(8));
        if (type == 0x12) fail("MPEG-4 fine granularity scalable video is not supported");
        int verid = 1;
        if (br.get1()) {  // is_object_layer_identifier
            verid = int(br.get(4));
            br.skip(3);
        }
        if (br.get(4) == 15) br.skip(16);  // aspect_ratio_info, extended PAR
        if (br.get1()) {                   // vol_control_parameters
            if (br.get(2) != 1)
                fail("MPEG-4 video chroma formats other than 4:2:0 are not supported");
            br.skip(1);  // low_delay
            if (br.get1()) {  // vbv_parameters
                br.skip(15);
                br.marker("VOL");
                br.skip(15);
                br.marker("VOL");
                br.skip(15);
                br.marker("VOL");
                br.skip(3 + 11);
                br.marker("VOL");
                br.skip(15);
                br.marker("VOL");
            }
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
        if (br.get1()) fail("interlaced MPEG-4 video is not supported");
        if (!br.get1()) fail("MPEG-4 overlapped block motion compensation (OBMC) is not supported");
        int sprite = int(br.get(verid == 1 ? 1 : 2));
        if (sprite) fail("MPEG-4 sprites and global motion compensation (GMC) are not supported");
        if (br.get1())
            fail("MPEG-4 video with other than 8-bit samples (not_8_bit) is not supported");
        if (br.get1())
            fail("MPEG-4 MPEG quantisation (quant_type 1, quantiser matrices) is not supported");
        if (verid != 1 && br.get1())
            fail("MPEG-4 quarter-pel motion (quarter_sample) is not supported");
        if (!br.get1()) fail("MPEG-4 complexity estimation headers are not supported");
        v.resync_disable = br.get1();
        if (br.get1()) fail("MPEG-4 data partitioning is not supported");
        if (verid != 1) {
            if (br.get1()) fail("MPEG-4 NEWPRED is not supported");
            if (br.get1()) fail("MPEG-4 reduced resolution VOPs are not supported");
        }
        if (br.get1()) fail("MPEG-4 scalability (enhancement layers) is not supported");
        if (!have_vol || v.width != vol.width || v.height != vol.height) init(v.width, v.height);
        vol = v;
        have_vol = true;
    }

    // ---- macroblocks

    int decode_dc_diff(BitReader& br, bool luma) {
        const Tables& t = tables();
        int size = (luma ? t.dc_luma : t.dc_chroma).decode(br, "DC size");
        if (!size) return 0;
        int diff = int(br.get(size));
        if (!(diff >> (size - 1))) diff = diff - (1 << size) + 1;
        if (size > 8) br.marker("DC differential");
        return diff;
    }

    // TCOEF events into blk (natural order) from scan position `i` + 1 on;
    // intra: quantised levels, inter: dequantised by qmul / qadd
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
                if (level == 0) fail("corrupt MPEG-4 video: a zero level in the third escape");
                clamp = true;
                stats[kEsc3]++;
            }
            i += run + 1;
            if (i > 63) fail("corrupt MPEG-4 video: more than 64 coefficients in a block");
            if (qmul > 1 || qadd) {
                level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
                if (clamp && (level < -2048 || level > 2047)) level = level < 0 ? -2048 : 2047;
            }
            blk[scan[i]] = int16_t(level);
            if (last) return;
        }
    }

    void decode_intra_mb(BitReader& br, int mbx, int mby, int cbp, int q, bool ac_pred,
                         bool dc_vlc) {
        for (int n = 0; n < 6; n++) {
            int16_t blk[64] = {};
            int c = comp(n), bx, by, dir;
            block_xy(mbx, mby, n, bx, by);
            int scale = n < 4 ? luma_dc_scale(q) : chroma_dc_scale(q);
            int pred = dc_predict(c, bx, by, scale, dir);
            int i = -1;
            if (dc_vlc) {
                blk[0] = int16_t(pred + decode_dc_diff(br, n < 4));
                i = 0;
            }
            const uint8_t* scan = !ac_pred ? kZigzag : dir == 0 ? kAltVertical : kAltHorizontal;
            if (cbp & (32 >> n)) decode_coeffs(br, true, scan, i, 1, 0, blk);
            if (!dc_vlc) blk[0] = int16_t(blk[0] + pred);
            dc_store(c, bx, by, blk[0], scale);
            ac_predict(c, bx, by, mbx, mby, q, dir, ac_pred, blk);
            recon_intra(mbx, mby, n, q, blk);
        }
        mvs[(size_t(mby) * mbw + mbx) * 2] = mvs[(size_t(mby) * mbw + mbx) * 2 + 1] = 0;
    }

    int decode_motion(BitReader& br, int pred, int fcode) {
        int code = tables().mvd.decode(br, "motion vector");
        if (!code) return pred;
        bool sign = br.get1();
        int shift = fcode - 1, val = code;
        if (shift) val = (((val - 1) << shift) | int(br.get(shift))) + 1;
        if (sign) val = -val;
        val += pred;
        int bits = 5 + fcode;  // the range wraps
        val = int(uint32_t(val) << (32 - bits)) >> (32 - bits);
        return val;
    }

    bool at_resync_marker(const BitReader& br, int fcode) const {
        // next_start_code stuffing (a 0 then 1s to the byte) then 16 + fcode - 1 zeros
        int n = 8 - int(br.pos & 7);
        if (br.left() < size_t(n + 17)) return false;
        uint32_t stuffing = br.peek(n);
        if (stuffing != (1u << (n - 1)) - 1) return false;
        BitReader look = br;
        look.pos += n;
        int zeros = 16 + std::max(fcode, 1) - 1;
        return look.peek(zeros) == 0 && look.peek(zeros + 1) == 1;
    }

    // ---- VOP

    // returns 0 (a coded VOP, now the reference) or 1 (vop_coded = 0)
    int decode_vop(BitReader& br, int& type_out) {
        if (!have_vol) fail("MPEG-4 video: a VOP before any VOL header");
        int type = int(br.get(2));
        if (type == 2) fail("MPEG-4 B-VOPs are not supported");
        if (type == 3) fail("MPEG-4 S-VOPs (sprites / GMC) are not supported");
        while (br.get1()) {
        }  // modulo_time_base
        br.marker("VOP");
        br.skip(vol.time_bits);
        br.marker("VOP");
        if (!br.get1()) return 1;  // vop_coded
        int rounding = type == 1 ? br.get1() : 0;
        int thr = kDcThreshold[br.get(3)];
        int q = int(br.get(5));
        if (!q) fail("corrupt MPEG-4 video: vop_quant of 0");
        int fcode = 0;
        if (type == 1) {
            fcode = int(br.get(3));
            if (!fcode) fail("corrupt MPEG-4 video: vop_fcode_forward of 0");
            if (!have_ref) fail("MPEG-4 video: a P-VOP without a reference picture");
        }
        type_out = type;
        const Tables& t = tables();
        stats[type ? kPVops : kIVops]++;
        if (type == 1) {
            stats[rounding ? kRound1 : kRound0]++;
            stats[kMaxFcode] = std::max(stats[kMaxFcode], long(fcode));
        }
        for (int mby = 0; mby < mbh; mby++) {
            for (int mbx = 0; mbx < mbw; mbx++) {
                if (!vol.resync_disable && (mbx || mby) && at_resync_marker(br, fcode))
                    fail("MPEG-4 resync markers (video packets) are not supported");
                size_t mi = size_t(mby) * mbw + mbx;
                int cbpc;
                bool intra;
                if (type == 1) {
                    if (br.get1()) {  // not_coded
                        mvs[mi * 2] = mvs[mi * 2 + 1] = 0;
                        mbq[mi] = int8_t(q);
                        if (predict_mb(mbx, mby, 0, 0, rounding)) stats[kMvOutside]++;
                        clear_intra(mbx, mby);
                        stats[kNotCoded]++;
                        continue;
                    }
                    do cbpc = t.inter_mcbpc.decode(br, "mcbpc");
                    while (cbpc == kInterMcbpcStuffing);
                    if (cbpc & 16)
                        fail("MPEG-4 four motion vectors per macroblock (inter4v) are not "
                             "supported");
                    intra = cbpc & 4;
                } else {
                    do cbpc = t.intra_mcbpc.decode(br, "mcbpc");
                    while (cbpc == kIntraMcbpcStuffing);
                    cbpc = (cbpc & 3) | 4 | ((cbpc & 4) << 1);
                    intra = true;
                }
                bool dquant = cbpc & 8;
                if (intra) {
                    bool ac_pred = br.get1();
                    int cbp = (t.cbpy.decode(br, "cbpy") << 2) | (cbpc & 3);
                    bool dc_vlc = q < thr;
                    if (dquant) {
                        q = std::min(std::max(q + kDquant[br.get(2)], 1), 31);
                        stats[kDquantMb]++;
                    }
                    mbq[mi] = int8_t(q);
                    decode_intra_mb(br, mbx, mby, cbp, q, ac_pred, dc_vlc);
                    stats[type ? kIntraMbP : kIntraMbI]++;
                    stats[ac_pred ? kAcPredOn : kAcPredOff]++;
                    continue;
                }
                int cbp = ((t.cbpy.decode(br, "cbpy") ^ 15) << 2) | (cbpc & 3);
                if (dquant) {
                    q = std::min(std::max(q + kDquant[br.get(2)], 1), 31);
                    stats[kDquantMb]++;
                }
                mbq[mi] = int8_t(q);
                int px, py;
                mv_predict(mbx, mby, px, py);
                int mx = decode_motion(br, px, fcode);
                int my = decode_motion(br, py, fcode);
                mvs[mi * 2] = int16_t(mx);
                mvs[mi * 2 + 1] = int16_t(my);
                if (predict_mb(mbx, mby, mx, my, rounding)) stats[kMvOutside]++;
                clear_intra(mbx, mby);
                int qmul = 2 * q, qadd = (q - 1) | 1;
                for (int n = 0; n < 6; n++) {
                    if (!(cbp & (32 >> n))) continue;
                    int16_t blk[64] = {};
                    decode_coeffs(br, false, kZigzag, -1, qmul, qadd, blk);
                    recon_inter(mbx, mby, n, blk);
                }
                stats[kInterMb]++;
            }
        }
        swap_frames();
        return 0;
    }

    // one sample: header units, then one VOP; returns 0 (a frame) or 1 (a
    // VOP that is not coded, or headers only)
    int decode(const uint8_t* data, size_t n, int& type) {
        if (n >= 3 && data[0] == 0 && data[1] == 0 && (data[2] & 0xfc) == 0x80)
            fail("MPEG-4 short video header (H.263 baseline) streams are not supported");
        size_t i = 0;
        int result = 1;
        while (true) {
            // find the next start code 00 00 01 xx
            while (i + 3 < n && !(data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1)) i++;
            if (i + 3 >= n) break;
            int code = data[i + 3];
            size_t start = i + 4, end = start;
            while (end + 2 < n && !(data[end] == 0 && data[end + 1] == 0 && data[end + 2] == 1))
                end++;
            if (end + 2 >= n) end = n;
            std::vector<uint8_t> unit(data + start, data + end);
            unit.resize(unit.size() + 8, 0);
            BitReader br(unit.data(), end - start);
            if (code >= 0x20 && code <= 0x2f) {
                parse_vol(br);
            } else if (code == 0xb6) {
                result = decode_vop(br, type);
                return result;
            }  // VOS, VO, user data, GOV, ...: nothing to keep
            i = end;
        }
        return result;
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

// parses the DecoderSpecificInfo (VOS/VO/VOL); -1 on error
int mpeg4_decoder_config(void* dp, const uint8_t* data, long n, int* width, int* height) {
    Decoder* d = static_cast<Decoder*>(dp);
    return guarded(&d->error, [&] {
        if (n < 0) fail("negative length");
        int type = 0;
        d->decode(data, size_t(n), type);
        if (!d->have_vol) fail("MPEG-4 video configuration without a VOL header");
        *width = d->w;
        *height = d->h;
        return 0;
    });
}

// one sample -> 0 with the cropped I420 planes in `out` (w*h + 2*cw*ch
// bytes), 1 for a VOP that is not coded (no picture), -1 on error; the
// VOP's type (0 I, 1 P) in *type.  A sample may change the VOL size: the
// caller reads *width / *height before the planes.
int mpeg4_decode(void* dp, const uint8_t* data, long n, uint8_t* out, long out_size, int* width,
                 int* height, int* type) {
    Decoder* d = static_cast<Decoder*>(dp);
    return guarded(&d->error, [&] {
        if (n < 0) fail("negative length");
        int w0 = d->w, h0 = d->h;
        int t = -1;
        int r = d->decode(data, size_t(n), t);
        *width = d->w;
        *height = d->h;
        if (d->w != w0 || d->h != h0) fail("the MPEG-4 VOL changed the picture size mid-stream");
        if (r == 1) return 1;
        long need = long(d->w) * d->h + 2L * ((d->w + 1) / 2) * ((d->h + 1) / 2);
        if (out_size < need) fail("output buffer too small");
        d->crop(d->ref, out);
        *type = t;
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
