// H.265 / HEVC decoder of 8-bit 4:2:0 Main-profile I, P and B pictures,
// for the demo's video input (render/hevc.py).  Built with g++ into
// adas_tpu_torch/_build/libhevc.so at first use (native/gxx.py).
//
// What it decodes: NAL units from Annex B byte streams or from
// length-prefixed samples (1, 2 or 4 bytes), with emulation prevention;
// VPS, SPS and PPS (profile_tier_level with sub-layers, the VUI with HRD
// parameters, the conformance window, scaling lists with their prediction,
// st_ref_pic_set with inter-RPS prediction); I, P and B slice segment
// headers with both reference lists, their modification and the explicit
// weighted prediction table;
// POC with the MSB wrap from the previous TemporalId-0 picture; the RPS,
// the DPB and FFmpeg's output (bumping by sps_max_num_reorder_pics and
// sps_max_dec_pic_buffering, pic_output_flag, RASL pictures skipped after
// an IRAP picture that starts the stream, missing references made gray);
// CABAC with the three initialisation types (cabac_init_flag), WPP
// (entropy_coding_sync_enabled_flag) and several slices a picture; the
// coding quadtree for CTB sizes 16-64, every part mode including AMP, the
// transform tree and residual coding (scan orders by intra mode, sign data
// hiding, transform skip, cu_qp_delta over quantisation groups, chroma QP
// offsets, scaling lists); the 35 intra modes with reference substitution,
// constrained intra prediction, reference filtering and strong intra
// smoothing; the 4x4 DST and the 4-32 DCT; merge (spatial, temporal and
// combined bi-predictive and zero candidates, log2_parallel_merge_level),
// AMVP over both lists with spatial scaling and TMVP with MV scaling
// (FFmpeg's choice of the co-located list); the 8-tap luma and 4-tap
// chroma filters over several reference pictures to 14-bit intermediates,
// averaged for bi-prediction or weighted explicitly (FFmpeg's
// put_hevc_*_uni_w / *_bi_w); PCM with pcm_loop_filter_disabled_flag; the
// deblocking filter and SAO, as FFmpeg's hevc decoder runs them (which cv2
// runs): boundary strengths written per transform unit and coding unit as
// FFmpeg writes them, and SAO's slice edges by the current CTB's flag.
//
// What it refuses, with an error that names the tool: long-term reference
// pictures, tiles, dependent slice segments,
// cu_transquant_bypass, bit depths above 8 and chroma formats other than
// 4:2:0 (the range extensions), layers above 0, and pictures of more than
// kMaxPixels.  Damaged data decodes or raises a ValueError (FFmpeg's hevc
// decoder has no error concealment).
//
// The syntax layer (parameter sets, slice headers, coding tree units) is
// written once over a read or a write engine, so that a stream writer
// (tests/data/video/hevc_writer.cpp) can include this file and emit the
// same syntax.

#include <algorithm>
#include <chrono>
#include <climits>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace hevc {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] static void fail(const char* fmt, ...) {
  char buf[512];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Error(buf);
}

static const long kMaxPixels = 1L << 25;

static inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
static inline uint8_t clip1(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
static inline int ceil_log2(int v) {
  int n = 0;
  while ((1 << n) < v) n++;
  return n;
}

// ------------------------------------------------------------------ tables

// CABAC context initialisation values (Tables 9-5 to 9-37) by initType
// 0 (I), 1 and 2, one run per syntax element in the order of Ctx.
enum Ctx {
  C_SAO_MERGE = 0,
  C_SAO_TYPE = 1,
  C_SPLIT_CU = 2,                  // 3
  C_TRANSQUANT_BYPASS = 5,
  C_SKIP = 6,                      // 3
  C_PRED_MODE = 9,
  C_PART_MODE = 10,                // 4
  C_PREV_INTRA = 14,
  C_CHROMA_MODE = 15,
  C_RQT_ROOT_CBF = 16,
  C_MERGE_FLAG = 17,
  C_MERGE_IDX = 18,
  C_INTER_PRED = 19,               // 5
  C_REF_IDX = 24,                  // 2
  C_MVP_FLAG = 26,
  C_SPLIT_TRANSFORM = 27,          // 3
  C_CBF_LUMA = 30,                 // 2
  C_CBF_CHROMA = 32,               // 4
  C_MVD_GT0 = 36,
  C_MVD_GT1 = 37,
  C_QP_DELTA = 38,                 // 2
  C_TRANSFORM_SKIP = 40,           // 2: luma, chroma
  C_LAST_X = 42,                   // 18
  C_LAST_Y = 60,                   // 18
  C_CSBF = 78,                     // 4
  C_SIG = 82,                      // 42
  C_GT1 = 124,                     // 24
  C_GT2 = 148,                     // 6
  C_COUNT = 154
};

static const uint8_t kCtxInit[3][C_COUNT] = {
    {
        153,                                                  // sao_merge
        200,                                                  // sao_type_idx
        139, 141, 157,                                        // split_cu_flag
        154,                                                  // cu_transquant_bypass_flag
        154, 154, 154,                                        // cu_skip_flag (unused in I)
        154,                                                  // pred_mode_flag (unused)
        184, 154, 154, 154,                                   // part_mode
        184,                                                  // prev_intra_luma_pred_flag
        63,                                                   // intra_chroma_pred_mode
        154,                                                  // rqt_root_cbf (unused)
        154,                                                  // merge_flag (unused)
        154,                                                  // merge_idx (unused)
        154, 154, 154, 154, 154,                              // inter_pred_idc (unused)
        154, 154,                                             // ref_idx (unused)
        154,                                                  // mvp_flag (unused)
        153, 138, 138,                                        // split_transform_flag
        111, 141,                                             // cbf_luma
        94, 138, 182, 154,                                    // cbf_cb, cbf_cr
        154,                                                  // abs_mvd_greater0 (unused)
        154,                                                  // abs_mvd_greater1 (unused)
        154, 154,                                             // cu_qp_delta_abs
        139, 139,                                             // transform_skip_flag
        110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79, 108, 123, 63,
        110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79, 108, 123, 63,
        91, 171, 134, 141,                                    // coded_sub_block_flag
        111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153, 125, 107, 125, 141,
        179, 153, 125, 107, 125, 141, 179, 153, 125, 140, 139, 182, 182, 152, 136, 152, 136, 153,
        136, 139, 111, 136, 139, 111,                         // sig_coeff_flag
        140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107, 122, 152, 140, 179,
        166, 182, 140, 227, 122, 197,                         // coeff_abs_level_greater1_flag
        138, 153, 136, 167, 152, 152,                         // coeff_abs_level_greater2_flag
    },
    {
        153,
        185,
        107, 139, 126,
        154,
        197, 185, 201,
        149,
        154, 139, 154, 154,
        154,
        152,
        79,
        110,
        122,
        95, 79, 63, 31, 31,
        153, 153,
        168,
        124, 138, 94,
        153, 111,
        149, 107, 167, 154,
        140,
        198,
        154, 154,
        139, 139,
        125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94, 108, 123, 108,
        125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94, 108, 123, 108,
        121, 140, 61, 154,
        155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136, 153, 154, 166, 183, 140,
        136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 123, 123, 107, 121, 107, 121, 167,
        151, 183, 140, 151, 183, 140,
        154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 137, 169, 194,
        166, 167, 154, 167, 137, 182,
        107, 167, 91, 122, 107, 167,
    },
    {
        153,
        160,
        107, 139, 126,
        154,
        197, 185, 201,
        134,
        154, 139, 154, 154,
        183,
        152,
        79,
        154,
        137,
        95, 79, 63, 31, 31,
        153, 153,
        168,
        224, 167, 122,
        153, 111,
        149, 92, 167, 154,
        169,
        198,
        154, 154,
        139, 139,
        125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79, 108, 123, 93,
        125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79, 108, 123, 93,
        121, 140, 61, 154,
        170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136, 153, 154, 166, 183, 140,
        136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 138, 138, 122, 121, 122, 121, 167,
        151, 183, 140, 151, 183, 140,
        154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 122, 169, 208,
        166, 167, 154, 152, 167, 182,
        107, 167, 91, 107, 107, 167,
    },
};

// rangeTabLPS[pStateIdx][qRangeIdx] (Table 9-46) and transIdxLps
static const uint8_t kRangeLps[64][4] = {
    {128, 176, 208, 240}, {128, 167, 197, 227}, {128, 158, 187, 216}, {123, 150, 178, 205},
    {116, 142, 169, 195}, {111, 135, 160, 185}, {105, 128, 152, 175}, {100, 122, 144, 166},
    {95, 116, 137, 158},  {90, 110, 130, 150},  {85, 104, 123, 142},  {81, 99, 117, 135},
    {77, 94, 111, 128},   {73, 89, 105, 122},   {69, 85, 100, 116},   {66, 80, 95, 110},
    {62, 76, 90, 104},    {59, 72, 86, 99},     {56, 69, 81, 94},     {53, 65, 77, 89},
    {51, 62, 73, 85},     {48, 59, 69, 80},     {46, 56, 66, 76},     {43, 53, 63, 72},
    {41, 50, 59, 69},     {39, 48, 56, 65},     {37, 45, 54, 62},     {35, 43, 51, 59},
    {33, 41, 48, 56},     {32, 39, 46, 53},     {30, 37, 43, 50},     {29, 35, 41, 48},
    {27, 33, 39, 45},     {26, 31, 37, 43},     {24, 30, 35, 41},     {23, 28, 33, 39},
    {22, 27, 32, 37},     {21, 26, 30, 35},     {20, 24, 29, 33},     {19, 23, 27, 31},
    {18, 22, 26, 30},     {17, 21, 25, 28},     {16, 20, 23, 27},     {15, 19, 22, 25},
    {14, 18, 21, 24},     {14, 17, 20, 23},     {13, 16, 19, 22},     {12, 15, 18, 21},
    {12, 14, 17, 20},     {11, 14, 16, 19},     {11, 13, 15, 18},     {10, 12, 15, 17},
    {10, 12, 14, 16},     {9, 11, 13, 15},      {9, 11, 12, 14},      {8, 10, 12, 14},
    {8, 9, 11, 13},       {7, 9, 11, 12},       {7, 9, 10, 12},       {7, 8, 10, 11},
    {6, 8, 9, 11},        {6, 7, 9, 10},        {6, 7, 8, 9},         {2, 2, 2, 2}};
static const uint8_t kTransLps[64] = {
    0,  0,  1,  2,  2,  4,  4,  5,  6,  7,  8,  9,  9,  11, 11, 12, 13, 13, 15, 15, 16, 16,
    18, 18, 19, 19, 21, 21, 22, 22, 23, 24, 24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30,
    31, 32, 32, 33, 33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63};

// intraPredAngle for modes 2-34 (Table 8-4) and invAngle for 11-25 (8-5)
static const int8_t kIntraAngle[35] = {0,   0,   32,  26,  21,  17,  13,  9,  5,  2,  0,  -2,
                                       -5,  -9,  -13, -17, -21, -26, -32, -26, -21, -17, -13, -9,
                                       -5,  -2,  0,   2,   5,   9,   13,  17,  21,  26,  32};
static const int16_t kInvAngle[15] = {-4096, -1638, -910, -630, -482, -390, -315, -256,
                                      -315,  -390,  -482, -630, -910, -1638, -4096};

// Default scaling lists of the 8x8 and larger blocks (Table 7-6), in
// up-right diagonal order: intra, then inter
static const uint8_t kDefaultScaling[2][64] = {
    {16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 17, 16, 17, 16, 17, 18, 17, 18, 18, 17, 18, 21,
     19, 20, 21, 20, 19, 21, 24, 22, 22, 24, 24, 22, 22, 24, 25, 25, 27, 30, 27, 25, 25, 29,
     31, 35, 35, 31, 29, 36, 41, 44, 41, 36, 47, 54, 54, 47, 65, 70, 65, 88, 88, 115},
    {16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 17, 17, 17, 17, 17, 18, 18, 18, 18, 18, 18, 20,
     20, 20, 20, 20, 20, 20, 24, 24, 24, 24, 24, 24, 24, 24, 25, 25, 25, 25, 25, 25, 25, 28,
     28, 28, 28, 28, 28, 33, 33, 33, 33, 33, 41, 41, 41, 41, 54, 54, 54, 71, 71, 91}};

static const uint8_t kLevelScale[6] = {40, 45, 51, 57, 64, 72};
static const uint8_t kQpC[14] = {29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37};
static const uint8_t kBeta[52] = {0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,
                                  0,  0,  0,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15,
                                  16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38,
                                  40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64};
static const uint8_t kTc[54] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4,
                                4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24};

static const int8_t kLumaFilter[4][8] = {{0, 0, 0, 64, 0, 0, 0, 0},
                                         {-1, 4, -10, 58, 17, -5, 1, 0},
                                         {-1, 4, -11, 40, 40, -11, 4, -1},
                                         {0, 1, -5, 17, 58, -10, 4, -1}};
static const int8_t kChromaFilter[8][4] = {{0, 64, 0, 0},    {-2, 58, 10, -2}, {-4, 54, 16, -2},
                                           {-6, 46, 28, -4}, {-4, 36, 36, -4}, {-4, 28, 46, -6},
                                           {-2, 16, 54, -4}, {-2, 10, 58, -2}};

static const int8_t kDst4[4][4] = {{29, 55, 74, 84}, {74, 74, 0, -74}, {84, -29, -74, 55},
                                   {55, -84, 74, -29}};

// The 32-point DCT matrix (8.6.4.2): row k, column n is 64 * sqrt(2) *
// cos((2n + 1) k pi / 64) as the standard rounds it.
struct DctMatrix {
  int8_t m[32][32];
  DctMatrix() {
    static const uint8_t c[33] = {64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67, 64,
                                  61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9,  4,  0};
    for (int k = 0; k < 32; k++)
      for (int n = 0; n < 32; n++) {
        int a = ((2 * n + 1) * k) % 128;  // the angle in units of pi/64
        int v = a <= 32 ? c[a] : a <= 64 ? -c[64 - a] : a <= 96 ? -c[a - 64] : c[128 - a];
        m[k][n] = (int8_t)(k == 0 ? 64 : v);
      }
  }
};
static const DctMatrix kDct;

// ScanOrder[log2 size][scanIdx][pos] = (x, y) for sizes 1x1-8x8 (6.5.3-5)
struct Scans {
  uint8_t pos[4][3][64][2];
  Scans() {
    for (int l = 0; l < 4; l++) {
      int n = 1 << l, i = 0, x = 0, y = 0;
      while (i < n * n) {  // up-right diagonal
        while (y >= 0) {
          if (x < n && y < n) {
            pos[l][0][i][0] = (uint8_t)x;
            pos[l][0][i][1] = (uint8_t)y;
            i++;
          }
          y--;
          x++;
        }
        y = x;
        x = 0;
      }
      for (i = 0; i < n * n; i++) {
        pos[l][1][i][0] = (uint8_t)(i % n);  // horizontal
        pos[l][1][i][1] = (uint8_t)(i / n);
        pos[l][2][i][0] = (uint8_t)(i / n);  // vertical
        pos[l][2][i][1] = (uint8_t)(i % n);
      }
    }
  }
};
static const Scans kScan;

// ------------------------------------------------------------------ bits

struct BitReader {
  const uint8_t* d = nullptr;
  size_t nbits = 0, pos = 0;  // the data is padded with kPad zero bytes
  static constexpr size_t kPad = 16;
  void init(const std::vector<uint8_t>& v, size_t nbytes) {
    d = v.data();
    nbits = nbytes * 8;
    pos = 0;
  }
  inline int u1() {
    if (pos >= nbits + kPad * 8) fail("truncated H.265 data: read past the end of a NAL unit");
    int b = (d[pos >> 3] >> (7 - (pos & 7))) & 1;
    pos++;
    return b;
  }
  inline uint32_t u(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v = v << 1 | (uint32_t)u1();
    return v;
  }
  uint32_t ue() {
    int zeros = 0;
    while (!u1())
      if (++zeros > 31) fail("corrupt H.265 data: Exp-Golomb code longer than 32 bits");
    return (uint32_t)(((uint64_t)1 << zeros) - 1 + u(zeros));
  }
  int se() {
    uint32_t k = ue();
    return (k & 1) ? (int)((k + 1) / 2) : -(int)(k / 2);
  }
  // header syntax past the end of its NAL unit
  void check(const char* what) const {
    if (pos > nbits) fail("corrupt H.265 data: the %s runs past the end of its NAL unit", what);
  }
  void align() { pos = (pos + 7) & ~(size_t)7; }
};

struct BitWriter {
  std::vector<uint8_t> buf;
  uint64_t acc = 0;
  int nacc = 0;
  void put(int n, uint32_t v) {
    for (int i = n - 1; i >= 0; i--) {
      acc = (acc << 1) | ((v >> i) & 1);
      if (++nacc == 8) {
        buf.push_back((uint8_t)acc);
        acc = 0;
        nacc = 0;
      }
    }
  }
  void ue(uint32_t v) {
    uint64_t x = (uint64_t)v + 1;
    int len = 0;
    while ((x >> len) > 1) len++;
    put(len, 0);
    for (int i = len; i >= 0; i--) put(1, (uint32_t)(x >> i) & 1);
  }
  void se(int v) { ue(v > 0 ? 2 * (uint32_t)v - 1 : (uint32_t)(-2 * (int64_t)v)); }
  bool aligned() const { return nacc == 0; }
  size_t bits() const { return buf.size() * 8 + nacc; }
  void align_zero() {
    while (nacc) put(1, 0);
  }
  void trailing() {  // rbsp_trailing_bits
    put(1, 1);
    align_zero();
  }
};

// RBSP of a NAL unit's payload: emulation prevention bytes removed.
static void unescape(const uint8_t* p, size_t n, std::vector<uint8_t>& out, size_t& len) {
  out.resize(n + BitReader::kPad);
  size_t o = 0;
  int zeros = 0;
  for (size_t i = 0; i < n; i++) {
    if (zeros >= 2 && p[i] == 3) {
      zeros = 0;
      continue;
    }
    out[o++] = p[i];
    zeros = p[i] == 0 ? zeros + 1 : 0;
  }
  len = o;
  std::fill(out.begin() + (long)o, out.end(), 0);
}

// Emulation prevention of a payload (the writer's).
static std::vector<uint8_t> escape(const std::vector<uint8_t>& in) {
  std::vector<uint8_t> out;
  int zeros = 0;
  for (uint8_t b : in) {
    if (zeros >= 2 && b <= 3) {
      out.push_back(3);
      zeros = 0;
    }
    out.push_back(b);
    zeros = b == 0 ? zeros + 1 : 0;
  }
  return out;
}

// ------------------------------------------------------------------ CABAC

struct CabacDec {
  BitReader* br = nullptr;
  uint32_t range = 510, offset = 0;
  uint8_t st[C_COUNT];
  void start() {  // 9.3.2.5, at a byte boundary
    range = 510;
    offset = br->u(9);
    if (offset >= 510) fail("corrupt H.265 data: CABAC offset out of range");
  }
  inline void renorm() {
    while (range < 256) {
      range <<= 1;
      offset = (offset << 1) | (uint32_t)br->u1();
    }
  }
  inline int decision(int ctx) {
    uint8_t& s = st[ctx];
    int p = s >> 1, mps = s & 1;
    uint32_t lps = kRangeLps[p][(range >> 6) & 3];
    range -= lps;
    int bin;
    if (offset >= range) {
      bin = !mps;
      offset -= range;
      range = lps;
      if (p == 0) mps = 1 - mps;
      s = (uint8_t)(kTransLps[p] << 1 | mps);
    } else {
      bin = mps;
      s = (uint8_t)((p < 62 ? p + 1 : p) << 1 | mps);
    }
    renorm();
    return bin;
  }
  inline int bypass() {
    offset = (offset << 1) | (uint32_t)br->u1();
    if (offset >= range) {
      offset -= range;
      return 1;
    }
    return 0;
  }
  inline int terminate() {
    range -= 2;
    if (offset >= range) return 1;
    renorm();
    return 0;
  }
};

struct CabacEnc {
  BitWriter* bw = nullptr;
  uint32_t low = 0, range = 510;
  int outstanding = 0;
  bool first = true;
  uint8_t st[C_COUNT];
  void start() {
    low = 0;
    range = 510;
    outstanding = 0;
    first = true;
  }
  void put_bit(int b) {
    if (first)
      first = false;
    else
      bw->put(1, (uint32_t)b);
    while (outstanding > 0) {
      bw->put(1, (uint32_t)(1 - b));
      outstanding--;
    }
  }
  void renorm() {
    while (range < 256) {
      if (low < 256) {
        put_bit(0);
      } else if (low >= 512) {
        low -= 512;
        put_bit(1);
      } else {
        low -= 256;
        outstanding++;
      }
      range <<= 1;
      low <<= 1;
    }
  }
  void decision(int ctx, int bin) {
    uint8_t& s = st[ctx];
    int p = s >> 1, mps = s & 1;
    uint32_t lps = kRangeLps[p][(range >> 6) & 3];
    range -= lps;
    if (bin != mps) {
      low += range;
      range = lps;
      if (p == 0) mps = 1 - mps;
      s = (uint8_t)(kTransLps[p] << 1 | mps);
    } else {
      s = (uint8_t)((p < 62 ? p + 1 : p) << 1 | mps);
    }
    renorm();
  }
  void bypass(int bin) {
    low <<= 1;
    if (bin) low += range;
    if (low >= 1024) {
      put_bit(1);
      low -= 1024;
    } else if (low < 512) {
      put_bit(0);
    } else {
      low -= 512;
      outstanding++;
    }
  }
  void terminate(int bin) {
    range -= 2;
    if (bin) {
      low += range;
      flush();
    } else {
      renorm();
    }
  }
  void flush() {  // EncodeFlush: the last bit written is a stop or alignment bit
    range = 2;
    renorm();
    put_bit((low >> 9) & 1);
    bw->put(2, ((low >> 7) & 3) | 1);
  }
};

// Context initialisation (9.3.2.2) for a slice QP and an initType.
static void init_contexts(uint8_t* st, int qp, int init_type) {
  for (int i = 0; i < C_COUNT; i++) {
    int v = kCtxInit[init_type][i];
    int m = (v >> 4) * 5 - 45, n = ((v & 15) << 3) - 16;
    int pre = clip3(1, 126, ((m * clip3(0, 51, qp)) >> 4) + n);
    int mps = pre <= 63 ? 0 : 1;
    st[i] = (uint8_t)((mps ? pre - 64 : 63 - pre) << 1 | mps);
  }
}

// The read and write engines: the syntax layer is written once over
// these (u, ue and se for header fields, bin, byp and term for CABAC).
struct ReadEngine {
  static constexpr bool W = false;
  BitReader* br = nullptr;
  CabacDec cab;
  int u(int n, int) { return (int)br->u(n); }
  int ue(int) { return (int)br->ue(); }
  int se(int) { return br->se(); }
  int bin(int ctx, int) { return cab.decision(ctx); }
  int byp(int) { return cab.bypass(); }
  int term(int) { return cab.terminate(); }
  uint8_t* ctx() { return cab.st; }
  void cabac_start() {
    cab.br = br;
    cab.start();
  }
  // after a terminating bin of 1: the rest of the byte, then a new start
  void cabac_restart() {
    br->align();
    cab.start();
  }
  void pcm_start() { br->align(); }
  int pcm(int n, int) { return (int)br->u(n); }
};

struct WriteEngine {
  static constexpr bool W = true;
  BitWriter* bw = nullptr;
  CabacEnc cab;
  int u(int n, int v) {
    bw->put(n, (uint32_t)v);
    return v;
  }
  int ue(int v) {
    bw->ue((uint32_t)v);
    return v;
  }
  int se(int v) {
    bw->se(v);
    return v;
  }
  int bin(int ctx, int v) {
    cab.decision(ctx, v);
    return v;
  }
  int byp(int v) {
    cab.bypass(v);
    return v;
  }
  int term(int v) {
    cab.terminate(v);
    return v;
  }
  uint8_t* ctx() { return cab.st; }
  void cabac_start() {
    cab.bw = bw;
    cab.start();
  }
  void cabac_restart() {
    bw->align_zero();
    cab.start();
  }
  void pcm_start() { bw->align_zero(); }
  int pcm(int n, int v) {
    bw->put(n, (uint32_t)v);
    return v;
  }
};

// ------------------------------------------------------------------ parameter sets

struct ShortTermRps {
  int num_negative = 0, num_delta = 0;
  int delta_poc[32];
  uint8_t used[32];
  // the syntax as coded (the writer sets it; inter prediction or not)
  int inter = 0, delta_idx_minus1 = 0, delta_rps_sign = 0, abs_delta_rps_minus1 = 0;
  uint8_t used_by_curr[33], use_delta[33];
};

struct ScalingList {
  // the coded lists in diagonal order ([size 4x4..32x32][matrixId]), DC
  // of 16x16 and 32x32
  uint8_t list[4][6][64];
  uint8_t dc[4][6];
  // the syntax as coded (the writer sets it)
  uint8_t pred_mode[4][6], pred_delta[4][6];
};

struct Vps {
  int id = 0, max_sub_layers = 1;
};

struct SubLayerOrdering {
  int max_dec_pic_buffering = 1, num_reorder = 0, max_latency_increase_plus1 = 0;
};

struct Sps {
  int vps_id = 0, max_sub_layers = 1, id = 0;
  int chroma_format_idc = 1, width = 0, height = 0;
  int conf_win = 0, conf_left = 0, conf_right = 0, conf_top = 0, conf_bottom = 0;
  int bit_depth = 8, bit_depth_chroma = 8, log2_max_poc_lsb = 4;
  int sub_layer_ordering_info = 1;
  SubLayerOrdering ordering[8];
  int log2_min_cb = 3, log2_diff_max_min_cb = 0, log2_min_tb = 2, log2_diff_max_min_tb = 0;
  int max_th_depth_inter = 0, max_th_depth_intra = 0;
  int scaling_list_enabled = 0, scaling_list_data_present = 0;
  ScalingList sl;
  int amp = 0, sao = 0, pcm = 0;
  int pcm_bit_depth = 8, pcm_bit_depth_chroma = 8, log2_min_pcm = 3, log2_diff_max_min_pcm = 0;
  int pcm_loop_filter_disabled = 0;
  int num_st_rps = 0;
  ShortTermRps st_rps[65];
  int long_term_present = 0, num_lt_sps = 0;
  int lt_poc_lsb_sps[33];
  uint8_t lt_used_sps[33];
  int temporal_mvp = 0, strong_intra_smoothing = 0;
  int vui = 0;
  // the VUI's timing (0 without), the rest of the VUI skipped
  uint32_t num_units_in_tick = 0, time_scale = 0;
  int extension = 0;
  // derived
  int log2_ctb = 3, ctb_w = 0, ctb_h = 0, min_cb_w = 0, min_cb_h = 0;
};

struct Pps {
  int id = 0, sps_id = 0;
  int dependent_slices = 0, output_flag_present = 0, num_extra_bits = 0, sign_hiding = 0;
  int cabac_init_present = 0, num_ref_idx_default[2] = {1, 1}, init_qp = 26;
  int constrained_intra = 0, transform_skip = 0, cu_qp_delta = 0, diff_cu_qp_delta_depth = 0;
  int cb_qp_offset = 0, cr_qp_offset = 0, slice_chroma_qp_offsets = 0;
  int weighted_pred = 0, weighted_bipred = 0, transquant_bypass = 0, tiles = 0, wpp = 0;
  int loop_filter_across_slices = 0, deblocking_control = 0, deblocking_override = 0;
  int deblocking_disabled = 0, beta_offset_div2 = 0, tc_offset_div2 = 0;
  int scaling_list_data_present = 0;
  ScalingList sl;
  int lists_modification = 0, log2_parallel_merge = 2, slice_header_extension = 0;
  int extension = 0;
};

// profile_tier_level (7.3.3): read and skipped, written as Main profile
template <class E>
static void profile_tier_level(E& e, int max_sub_layers_minus1) {
  e.u(2, 0);                       // general_profile_space
  e.u(1, 0);                       // general_tier_flag
  e.u(5, 1);                       // general_profile_idc: Main
  for (int j = 0; j < 32; j++) e.u(1, j == 1 || j == 2);  // compatible with Main and Main 10
  e.u(1, 1);                       // progressive_source
  e.u(1, 0);                       // interlaced_source
  e.u(1, 0);                       // non_packed_constraint
  e.u(1, 1);                       // frame_only_constraint
  e.u(22, 0);                      // 43 reserved / constraint bits
  e.u(21, 0);
  e.u(1, 0);                       // general_inbld / reserved
  e.u(8, 93);                      // general_level_idc: 3.1
  int prof[8] = {0}, lev[8] = {0};
  for (int i = 0; i < max_sub_layers_minus1; i++) {
    prof[i] = e.u(1, 0);
    lev[i] = e.u(1, 0);
  }
  if (max_sub_layers_minus1 > 0)
    for (int i = max_sub_layers_minus1; i < 8; i++) e.u(2, 0);
  for (int i = 0; i < max_sub_layers_minus1; i++) {
    if (prof[i]) {
      e.u(8, 0);  // profile_space, tier, profile_idc
      e.u(32, 0);
      e.u(4, 0);
      e.u(22, 0);
      e.u(22, 0);
    }
    if (lev[i]) e.u(8, 0);
  }
}

// sub_layer_hrd_parameters and hrd_parameters (E.2.2-3), read and skipped
template <class E>
static void sub_layer_hrd(E& e, int cpb_cnt, int sub_pic) {
  for (int i = 0; i < cpb_cnt; i++) {
    e.ue(0);
    e.ue(0);
    if (sub_pic) {
      e.ue(0);
      e.ue(0);
    }
    e.u(1, 0);
  }
}

template <class E>
static void hrd_parameters(E& e, int common, int max_sub_layers_minus1) {
  int nal = 0, vcl = 0, sub_pic = 0;
  if (common) {
    nal = e.u(1, 0);
    vcl = e.u(1, 0);
    if (nal || vcl) {
      sub_pic = e.u(1, 0);
      if (sub_pic) {
        e.u(8, 0);
        e.u(5, 0);
        e.u(1, 0);
        e.u(5, 0);
      }
      e.u(4, 0);
      e.u(4, 0);
      if (sub_pic) e.u(4, 0);
      e.u(5, 0);
      e.u(5, 0);
      e.u(5, 0);
    }
  }
  for (int i = 0; i <= max_sub_layers_minus1; i++) {
    int fixed_general = e.u(1, 0), fixed_within = 1, low_delay = 0, cpb_cnt = 1;
    if (!fixed_general) fixed_within = e.u(1, 0);
    if (fixed_within)
      e.ue(0);
    else
      low_delay = e.u(1, 0);
    if (!low_delay) cpb_cnt = e.ue(0) + 1;
    if (cpb_cnt > 32) fail("corrupt H.265 data: cpb_cnt_minus1 %d", cpb_cnt - 1);
    if (nal) sub_layer_hrd(e, cpb_cnt, sub_pic);
    if (vcl) sub_layer_hrd(e, cpb_cnt, sub_pic);
  }
}

template <class E>
static void vps_syntax(E& e, Vps& v) {
  v.id = e.u(4, v.id);
  e.u(1, 1);  // vps_base_layer_internal_flag
  e.u(1, 1);  // vps_base_layer_available_flag
  e.u(6, 0);  // vps_max_layers_minus1
  v.max_sub_layers = e.u(3, v.max_sub_layers - 1) + 1;
  e.u(1, 1);  // vps_temporal_id_nesting_flag
  e.u(16, 0xffff);
  profile_tier_level(e, v.max_sub_layers - 1);
  int info = e.u(1, 1);
  for (int i = info ? 0 : v.max_sub_layers - 1; i < v.max_sub_layers; i++) {
    e.ue(4);  // vps_max_dec_pic_buffering_minus1
    e.ue(0);  // vps_max_num_reorder_pics
    e.ue(0);  // vps_max_latency_increase_plus1
  }
  int max_layer_id = e.u(6, 0);
  int sets = e.ue(0);
  if (sets > 1023) fail("corrupt H.265 data: vps_num_layer_sets_minus1 %d", sets);
  for (int i = 1; i <= sets; i++)
    for (int j = 0; j <= max_layer_id; j++) e.u(1, 0);
  if (e.u(1, 0)) {  // vps_timing_info_present_flag
    e.u(32, 0);
    e.u(32, 0);
    if (e.u(1, 0)) e.ue(0);
    int n = e.ue(0);
    if (n > sets + 1) fail("corrupt H.265 data: vps_num_hrd_parameters %d", n);
    for (int i = 0; i < n; i++) {
      e.ue(0);
      int common = i > 0 ? e.u(1, 0) : 1;
      hrd_parameters(e, common, v.max_sub_layers - 1);
    }
  }
  e.u(1, 0);  // vps_extension_flag (the extension is skipped)
}

// st_ref_pic_set (7.3.7) and its derivation (7.4.8); `rps` holds the sets
// before index `idx`.  FFmpeg keeps each set's pictures sorted (negative
// ones nearest first, then positive ones nearest first).
template <class E>
static void st_ref_pic_set(E& e, ShortTermRps* rps, int idx, bool in_slice) {
  ShortTermRps& r = rps[idx];
  int inter = idx ? e.u(1, r.inter) : 0;
  r.inter = inter;
  if (inter) {
    int delta_idx = in_slice ? e.ue(r.delta_idx_minus1) + 1 : 1;
    r.delta_idx_minus1 = delta_idx - 1;
    if (delta_idx > idx) fail("corrupt H.265 data: delta_idx_minus1 %d past the sets", delta_idx - 1);
    const ShortTermRps& ref = rps[idx - delta_idx];
    r.delta_rps_sign = e.u(1, r.delta_rps_sign);
    r.abs_delta_rps_minus1 = e.ue(r.abs_delta_rps_minus1);
    if (r.abs_delta_rps_minus1 > 32767) fail("corrupt H.265 data: abs_delta_rps_minus1 %d", r.abs_delta_rps_minus1);
    int delta_rps = (1 - 2 * r.delta_rps_sign) * (r.abs_delta_rps_minus1 + 1);
    int k = 0, k0 = 0;
    int dp[33];
    uint8_t us[33];
    for (int j = 0; j <= ref.num_delta; j++) {
      int used = e.u(1, r.used_by_curr[j]);
      r.used_by_curr[j] = (uint8_t)used;
      int use_delta = 1;
      if (!used) use_delta = e.u(1, r.use_delta[j]);
      r.use_delta[j] = (uint8_t)use_delta;
      if (use_delta) {
        int d = j < ref.num_delta ? delta_rps + ref.delta_poc[j] : delta_rps;
        if (k >= 32) fail("corrupt H.265 data: a short-term RPS of more than 32 pictures");
        dp[k] = d;
        us[k] = (uint8_t)used;
        if (d < 0) k0++;
        k++;
      }
    }
    // FFmpeg's order: ascending, then the negative ones reversed
    for (int i = 1; i < k; i++)
      for (int m = i; m > 0 && dp[m] < dp[m - 1]; m--) {
        std::swap(dp[m], dp[m - 1]);
        std::swap(us[m], us[m - 1]);
      }
    std::reverse(dp, dp + k0);
    std::reverse(us, us + k0);
    r.num_delta = k;
    r.num_negative = k0;
    std::copy(dp, dp + k, r.delta_poc);
    std::copy(us, us + k, r.used);
  } else {
    int neg = e.ue(r.num_negative);
    int pos = e.ue(r.num_delta - r.num_negative);
    if (neg > 16 || pos > 16 || neg + pos > 16)
      fail("corrupt H.265 data: a short-term RPS of %d and %d pictures", neg, pos);
    int prev = 0;
    for (int i = 0; i < neg; i++) {
      int d = e.ue(prev - r.delta_poc[i] - 1) + 1;
      prev -= d;
      r.delta_poc[i] = prev;
      r.used[i] = (uint8_t)e.u(1, r.used[i]);
    }
    prev = 0;
    for (int i = neg; i < neg + pos; i++) {
      int d = e.ue(r.delta_poc[i] - prev - 1) + 1;
      prev += d;
      r.delta_poc[i] = prev;
      r.used[i] = (uint8_t)e.u(1, r.used[i]);
    }
    r.num_negative = neg;
    r.num_delta = neg + pos;
  }
}

// The default lists (7.3.4 with scaling_list_pred_matrix_id_delta 0)
static void default_scaling(ScalingList& sl) {
  for (int s = 0; s < 4; s++)
    for (int m = 0; m < 6; m++) {
      for (int i = 0; i < 64; i++) sl.list[s][m][i] = s == 0 ? 16 : kDefaultScaling[m >= 3][i];
      sl.dc[s][m] = 16;
      sl.pred_mode[s][m] = 0;
      sl.pred_delta[s][m] = 0;
    }
}

template <class E>
static void scaling_list_data(E& e, ScalingList& sl) {
  for (int s = 0; s < 4; s++)
    for (int m = 0; m < 6; m += s == 3 ? 3 : 1) {
      int coded = e.u(1, sl.pred_mode[s][m]);
      sl.pred_mode[s][m] = (uint8_t)coded;
      int n = std::min(64, 1 << (4 + (s << 1)));
      if (!coded) {
        int delta = e.ue(sl.pred_delta[s][m]);
        sl.pred_delta[s][m] = (uint8_t)delta;
        int step = s == 3 ? 3 : 1;
        if (delta * step > m) fail("corrupt H.265 data: scaling_list_pred_matrix_id_delta %d", delta);
        if (!delta) {
          for (int i = 0; i < 64; i++) sl.list[s][m][i] = s == 0 ? 16 : kDefaultScaling[m >= 3][i];
          sl.dc[s][m] = 16;
        } else {
          int r = m - delta * step;
          std::memcpy(sl.list[s][m], sl.list[s][r], 64);
          sl.dc[s][m] = sl.dc[s][r];
        }
      } else {
        int next = 8;
        if (s > 1) {
          int dc = e.se(sl.dc[s][m] - 8);
          if (dc < -7 || dc > 247) fail("corrupt H.265 data: scaling_list_dc_coef_minus8 %d", dc);
          next = dc + 8;
          sl.dc[s][m] = (uint8_t)next;
        }
        for (int i = 0; i < n; i++) {
          int want = sl.list[s][m][i];
          int d = want - next;
          if (d > 127) d -= 256;
          if (d < -128) d += 256;
          d = e.se(d);
          if (d < -128 || d > 127) fail("corrupt H.265 data: scaling_list_delta_coef %d", d);
          next = (next + d + 256) % 256;
          if (!next) fail("corrupt H.265 data: a scaling list entry of 0");
          sl.list[s][m][i] = (uint8_t)next;
        }
        if (s <= 1) sl.dc[s][m] = sl.list[s][m][0];
      }
    }
  // the 32x32 chroma lists (4:4:4 only) follow the 16x16 ones
  for (int m = 1; m < 6; m++)
    if (m != 3) {
      std::memcpy(sl.list[3][m], sl.list[2][m], 64);
      sl.dc[3][m] = sl.dc[2][m];
    }
}

template <class E>
static void vui_parameters(E& e, Sps& s) {
  if (e.u(1, 0)) {  // aspect_ratio_info_present_flag
    if (e.u(8, 0) == 255) {
      e.u(16, 0);
      e.u(16, 0);
    }
  }
  if (e.u(1, 0)) e.u(1, 0);  // overscan
  if (e.u(1, 0)) {           // video_signal_type_present_flag
    e.u(3, 5);
    if (e.u(1, 0)) fail("H.265 full-range video (video_full_range_flag) is not supported");
    if (e.u(1, 0)) {
      e.u(8, 0);
      e.u(8, 0);
      e.u(8, 0);
    }
  }
  if (e.u(1, 0)) {  // chroma_loc_info_present_flag
    e.ue(0);
    e.ue(0);
  }
  e.u(1, 0);  // neutral_chroma_indication_flag
  if (e.u(1, 0)) fail("H.265 field-coded video (field_seq_flag) is not supported");
  e.u(1, 0);  // frame_field_info_present_flag
  if (e.u(1, 0)) {  // default_display_window_flag
    e.ue(0);
    e.ue(0);
    e.ue(0);
    e.ue(0);
  }
  int timing = e.u(1, s.time_scale != 0);
  if (timing) {
    s.num_units_in_tick = (uint32_t)e.u(32, (int)s.num_units_in_tick);
    s.time_scale = (uint32_t)e.u(32, (int)s.time_scale);
    if (e.u(1, 0)) e.ue(0);
    if (e.u(1, 0)) hrd_parameters(e, 1, s.max_sub_layers - 1);
  } else if (!E::W) {
    s.num_units_in_tick = s.time_scale = 0;
  }
  if (e.u(1, 0)) {  // bitstream_restriction_flag
    e.u(1, 0);
    e.u(1, 0);
    e.u(1, 0);
    e.ue(0);
    e.ue(0);
    e.ue(0);
    e.ue(0);
    e.ue(0);
  }
}

template <class E>
static void sps_syntax(E& e, Sps& s, const Vps* const* vps_table) {
  s.vps_id = e.u(4, s.vps_id);
  if (!E::W && !vps_table[s.vps_id]) fail("corrupt H.265 data: the SPS refers to VPS %d, which was not sent", s.vps_id);
  s.max_sub_layers = e.u(3, s.max_sub_layers - 1) + 1;
  if (s.max_sub_layers > 7) fail("corrupt H.265 data: sps_max_sub_layers_minus1 %d", s.max_sub_layers - 1);
  e.u(1, 1);  // sps_temporal_id_nesting_flag
  profile_tier_level(e, s.max_sub_layers - 1);
  s.id = e.ue(s.id);
  if (s.id > 15) fail("corrupt H.265 data: sps_seq_parameter_set_id %d", s.id);
  s.chroma_format_idc = e.ue(s.chroma_format_idc);
  if (!E::W && s.chroma_format_idc != 1)
    fail("H.265 chroma_format_idc %d is not supported (the range extensions; the decoder takes 4:2:0 only)",
         s.chroma_format_idc);
  s.width = e.ue(s.width);
  s.height = e.ue(s.height);
  s.conf_win = e.u(1, s.conf_win);
  if (s.conf_win) {
    s.conf_left = e.ue(s.conf_left);
    s.conf_right = e.ue(s.conf_right);
    s.conf_top = e.ue(s.conf_top);
    s.conf_bottom = e.ue(s.conf_bottom);
  } else {
    s.conf_left = s.conf_right = s.conf_top = s.conf_bottom = 0;
  }
  s.bit_depth = e.ue(s.bit_depth - 8) + 8;
  s.bit_depth_chroma = e.ue(s.bit_depth_chroma - 8) + 8;
  if (!E::W && (s.bit_depth != 8 || s.bit_depth_chroma != 8))
    fail("H.265 bit depth %d/%d is not supported (Main 10 and the range extensions; the decoder "
         "takes 8-bit video only)", s.bit_depth, s.bit_depth_chroma);
  s.log2_max_poc_lsb = e.ue(s.log2_max_poc_lsb - 4) + 4;
  if (s.log2_max_poc_lsb > 16) fail("corrupt H.265 data: log2_max_pic_order_cnt_lsb_minus4 %d", s.log2_max_poc_lsb - 4);
  s.sub_layer_ordering_info = e.u(1, s.sub_layer_ordering_info);
  for (int i = s.sub_layer_ordering_info ? 0 : s.max_sub_layers - 1; i < s.max_sub_layers; i++) {
    SubLayerOrdering& o = s.ordering[i];
    o.max_dec_pic_buffering = e.ue(o.max_dec_pic_buffering - 1) + 1;
    o.num_reorder = e.ue(o.num_reorder);
    o.max_latency_increase_plus1 = e.ue(o.max_latency_increase_plus1);
    if (o.max_dec_pic_buffering > 16 || o.num_reorder > o.max_dec_pic_buffering - 1)
      fail("corrupt H.265 data: sps_max_dec_pic_buffering %d, num_reorder %d", o.max_dec_pic_buffering,
           o.num_reorder);
  }
  if (!s.sub_layer_ordering_info)
    for (int i = 0; i < s.max_sub_layers - 1; i++) s.ordering[i] = s.ordering[s.max_sub_layers - 1];
  s.log2_min_cb = e.ue(s.log2_min_cb - 3) + 3;
  s.log2_diff_max_min_cb = e.ue(s.log2_diff_max_min_cb);
  s.log2_min_tb = e.ue(s.log2_min_tb - 2) + 2;
  s.log2_diff_max_min_tb = e.ue(s.log2_diff_max_min_tb);
  s.log2_ctb = s.log2_min_cb + s.log2_diff_max_min_cb;
  if (s.log2_min_cb > 6 || s.log2_ctb > 6 || s.log2_ctb < 4)
    fail("corrupt H.265 data: CTB size %d, minimum CB size %d", 1 << std::min(s.log2_ctb, 12),
         1 << std::min(s.log2_min_cb, 12));
  if (s.log2_min_tb >= s.log2_min_cb || s.log2_min_tb + s.log2_diff_max_min_tb > std::min(5, s.log2_ctb))
    fail("corrupt H.265 data: transform sizes %d to %d", s.log2_min_tb, s.log2_min_tb + s.log2_diff_max_min_tb);
  s.max_th_depth_inter = e.ue(s.max_th_depth_inter);
  s.max_th_depth_intra = e.ue(s.max_th_depth_intra);
  if (s.max_th_depth_inter > s.log2_ctb - s.log2_min_tb || s.max_th_depth_intra > s.log2_ctb - s.log2_min_tb)
    fail("corrupt H.265 data: max_transform_hierarchy_depth %d/%d", s.max_th_depth_inter, s.max_th_depth_intra);
  s.scaling_list_enabled = e.u(1, s.scaling_list_enabled);
  if (!E::W) default_scaling(s.sl);
  if (s.scaling_list_enabled) {
    s.scaling_list_data_present = e.u(1, s.scaling_list_data_present);
    if (s.scaling_list_data_present) scaling_list_data(e, s.sl);
  }
  s.amp = e.u(1, s.amp);
  s.sao = e.u(1, s.sao);
  s.pcm = e.u(1, s.pcm);
  if (s.pcm) {
    s.pcm_bit_depth = e.u(4, s.pcm_bit_depth - 1) + 1;
    s.pcm_bit_depth_chroma = e.u(4, s.pcm_bit_depth_chroma - 1) + 1;
    s.log2_min_pcm = e.ue(s.log2_min_pcm - 3) + 3;
    s.log2_diff_max_min_pcm = e.ue(s.log2_diff_max_min_pcm);
    s.pcm_loop_filter_disabled = e.u(1, s.pcm_loop_filter_disabled);
    if (s.pcm_bit_depth > 8 || s.pcm_bit_depth_chroma > 8 || s.log2_min_pcm < s.log2_min_cb ||
        s.log2_min_pcm + s.log2_diff_max_min_pcm > std::min(5, s.log2_ctb))
      fail("corrupt H.265 data: PCM bit depth %d/%d, sizes %d to %d", s.pcm_bit_depth, s.pcm_bit_depth_chroma,
           s.log2_min_pcm, s.log2_min_pcm + s.log2_diff_max_min_pcm);
  }
  s.num_st_rps = e.ue(s.num_st_rps);
  if (s.num_st_rps > 64) fail("corrupt H.265 data: num_short_term_ref_pic_sets %d", s.num_st_rps);
  for (int i = 0; i < s.num_st_rps; i++) st_ref_pic_set(e, s.st_rps, i, false);
  s.long_term_present = e.u(1, s.long_term_present);
  if (s.long_term_present) {
    s.num_lt_sps = e.ue(s.num_lt_sps);
    if (s.num_lt_sps > 32) fail("corrupt H.265 data: num_long_term_ref_pics_sps %d", s.num_lt_sps);
    for (int i = 0; i < s.num_lt_sps; i++) {
      s.lt_poc_lsb_sps[i] = e.u(s.log2_max_poc_lsb, s.lt_poc_lsb_sps[i]);
      s.lt_used_sps[i] = (uint8_t)e.u(1, s.lt_used_sps[i]);
    }
  }
  s.temporal_mvp = e.u(1, s.temporal_mvp);
  s.strong_intra_smoothing = e.u(1, s.strong_intra_smoothing);
  s.vui = e.u(1, s.vui);
  if (s.vui) vui_parameters(e, s);
  s.extension = e.u(1, 0);
  if (s.extension) {
    int range = e.u(1, 0), multilayer = e.u(1, 0), ext3d = e.u(1, 0), scc = e.u(1, 0);
    e.u(4, 0);
    if (range) {
      // every range extension flag 0 is Main; any other is refused
      for (int i = 0; i < 9; i++)
        if (e.u(1, 0)) fail("H.265 range extension tools (sps_range_extension flag %d) are not supported", i);
    }
    if (multilayer || ext3d || scc) fail("H.265 multilayer, 3D and screen content extensions are not supported");
  }
  if (s.width <= 0 || s.height <= 0 || s.width % (1 << s.log2_min_cb) || s.height % (1 << s.log2_min_cb))
    fail("corrupt H.265 data: a picture of %dx%d samples with %d-sample coding blocks", s.width, s.height,
         1 << s.log2_min_cb);
  if ((long)s.width * s.height > kMaxPixels)
    fail("H.265 picture of %dx%d is larger than %ld pixels", s.width, s.height, kMaxPixels);
  if (2 * (s.conf_left + s.conf_right) >= s.width || 2 * (s.conf_top + s.conf_bottom) >= s.height)
    fail("corrupt H.265 data: a conformance window larger than the picture");
  s.ctb_w = (s.width + (1 << s.log2_ctb) - 1) >> s.log2_ctb;
  s.ctb_h = (s.height + (1 << s.log2_ctb) - 1) >> s.log2_ctb;
  s.min_cb_w = s.width >> s.log2_min_cb;
  s.min_cb_h = s.height >> s.log2_min_cb;
}

template <class E>
static void pps_syntax(E& e, Pps& p, const Sps* const* sps_table) {
  p.id = e.ue(p.id);
  if (p.id > 63) fail("corrupt H.265 data: pps_pic_parameter_set_id %d", p.id);
  p.sps_id = e.ue(p.sps_id);
  if (p.sps_id > 15 || (!E::W && !sps_table[p.sps_id]))
    fail("corrupt H.265 data: PPS %d refers to SPS %d, which was not sent", p.id, p.sps_id);
  p.dependent_slices = e.u(1, p.dependent_slices);
  p.output_flag_present = e.u(1, p.output_flag_present);
  p.num_extra_bits = e.u(3, p.num_extra_bits);
  p.sign_hiding = e.u(1, p.sign_hiding);
  p.cabac_init_present = e.u(1, p.cabac_init_present);
  p.num_ref_idx_default[0] = e.ue(p.num_ref_idx_default[0] - 1) + 1;
  p.num_ref_idx_default[1] = e.ue(p.num_ref_idx_default[1] - 1) + 1;
  if (p.num_ref_idx_default[0] > 15 || p.num_ref_idx_default[1] > 15)
    fail("corrupt H.265 data: num_ref_idx_default_active %d", p.num_ref_idx_default[0]);
  p.init_qp = e.se(p.init_qp - 26) + 26;
  if (p.init_qp < 0 || p.init_qp > 51) fail("corrupt H.265 data: init_qp_minus26 %d", p.init_qp - 26);
  p.constrained_intra = e.u(1, p.constrained_intra);
  p.transform_skip = e.u(1, p.transform_skip);
  p.cu_qp_delta = e.u(1, p.cu_qp_delta);
  p.diff_cu_qp_delta_depth = p.cu_qp_delta ? e.ue(p.diff_cu_qp_delta_depth) : 0;
  p.cb_qp_offset = e.se(p.cb_qp_offset);
  p.cr_qp_offset = e.se(p.cr_qp_offset);
  if (p.cb_qp_offset < -12 || p.cb_qp_offset > 12 || p.cr_qp_offset < -12 || p.cr_qp_offset > 12)
    fail("corrupt H.265 data: pps_cb/cr_qp_offset %d/%d", p.cb_qp_offset, p.cr_qp_offset);
  p.slice_chroma_qp_offsets = e.u(1, p.slice_chroma_qp_offsets);
  p.weighted_pred = e.u(1, p.weighted_pred);
  p.weighted_bipred = e.u(1, p.weighted_bipred);
  p.transquant_bypass = e.u(1, p.transquant_bypass);
  if (!E::W && p.transquant_bypass) fail("H.265 cu_transquant_bypass (transquant_bypass_enabled_flag) is not supported");
  p.tiles = e.u(1, p.tiles);
  p.wpp = e.u(1, p.wpp);
  if (!E::W && p.tiles) fail("H.265 tiles (tiles_enabled_flag) are not supported");
  p.loop_filter_across_slices = e.u(1, p.loop_filter_across_slices);
  p.deblocking_control = e.u(1, p.deblocking_control);
  if (p.deblocking_control) {
    p.deblocking_override = e.u(1, p.deblocking_override);
    p.deblocking_disabled = e.u(1, p.deblocking_disabled);
    if (!p.deblocking_disabled) {
      p.beta_offset_div2 = e.se(p.beta_offset_div2);
      p.tc_offset_div2 = e.se(p.tc_offset_div2);
      if (p.beta_offset_div2 < -6 || p.beta_offset_div2 > 6 || p.tc_offset_div2 < -6 || p.tc_offset_div2 > 6)
        fail("corrupt H.265 data: pps beta/tc offsets %d/%d", p.beta_offset_div2, p.tc_offset_div2);
    }
  } else {
    p.deblocking_override = p.deblocking_disabled = p.beta_offset_div2 = p.tc_offset_div2 = 0;
  }
  p.scaling_list_data_present = e.u(1, p.scaling_list_data_present);
  if (!E::W) default_scaling(p.sl);
  if (p.scaling_list_data_present) scaling_list_data(e, p.sl);
  p.lists_modification = e.u(1, p.lists_modification);
  p.log2_parallel_merge = e.ue(p.log2_parallel_merge - 2) + 2;
  p.slice_header_extension = e.u(1, p.slice_header_extension);
  p.extension = e.u(1, 0);
  if (p.extension) {
    int range = e.u(1, 0), multilayer = e.u(1, 0), ext3d = e.u(1, 0), scc = e.u(1, 0);
    e.u(4, 0);
    if (range) {
      if (p.transform_skip && e.ue(0)) fail("H.265 log2_max_transform_skip_block_size above 2 is not supported");
      if (e.u(1, 0)) fail("H.265 cross-component prediction is not supported");
      if (e.u(1, 0)) fail("H.265 chroma_qp_offset_list (the range extensions) is not supported");
      e.ue(0);
      e.ue(0);
    }
    if (multilayer || ext3d || scc) fail("H.265 multilayer, 3D and screen content extensions are not supported");
  }
  if (!E::W) {
    const Sps& s = *sps_table[p.sps_id];
    if (p.diff_cu_qp_delta_depth > s.log2_diff_max_min_cb)
      fail("corrupt H.265 data: diff_cu_qp_delta_depth %d", p.diff_cu_qp_delta_depth);
    if (p.log2_parallel_merge > s.log2_ctb)
      fail("corrupt H.265 data: log2_parallel_merge_level %d", p.log2_parallel_merge);
  }
}

// ------------------------------------------------------------------ slice header

enum { SLICE_B = 0, SLICE_P = 1, SLICE_I = 2 };
enum NalType {
  NAL_TRAIL_N = 0, NAL_TRAIL_R = 1, NAL_TSA_N = 2, NAL_TSA_R = 3, NAL_STSA_N = 4, NAL_STSA_R = 5,
  NAL_RADL_N = 6, NAL_RADL_R = 7, NAL_RASL_N = 8, NAL_RASL_R = 9, NAL_BLA_W_LP = 16,
  NAL_BLA_W_RADL = 17, NAL_BLA_N_LP = 18, NAL_IDR_W_RADL = 19, NAL_IDR_N_LP = 20, NAL_CRA = 21,
  NAL_VPS = 32, NAL_SPS = 33, NAL_PPS = 34, NAL_AUD = 35, NAL_EOS = 36, NAL_EOB = 37
};
static inline bool is_irap(int t) { return t >= 16 && t <= 23; }
static inline bool is_idr(int t) { return t == NAL_IDR_W_RADL || t == NAL_IDR_N_LP; }
static inline bool is_bla(int t) { return t >= NAL_BLA_W_LP && t <= NAL_BLA_N_LP; }
static inline bool is_rasl(int t) { return t == NAL_RASL_N || t == NAL_RASL_R; }

struct SliceHeader {
  int nal_type = 0, temporal_id = 0;
  int first_slice = 1, no_output_of_prior_pics = 0, pps_id = 0;
  int dependent = 0, address = 0;  // slice_segment_address in CTBs (raster)
  int type = SLICE_I, pic_output = 1, poc_lsb = 0;
  int st_rps_sps = 0, st_rps_idx = 0;
  ShortTermRps st_rps;  // the slice's own set (short_term_ref_pic_set_sps_flag 0)
  int temporal_mvp = 0, sao_luma = 0, sao_chroma = 0;
  int num_long_term_pics = 0;  // written only, to make a stream a reader refuses
  int num_ref_idx_override = 0, num_ref_idx[2] = {0, 0};
  int list_mod[2] = {0, 0}, list_entry[2][16] = {};
  int mvd_l1_zero = 0, collocated_from_l0 = 1;
  int cabac_init = 0, collocated_ref_idx = 0, max_merge_cand = 5;
  // pred_weight_table: the syntax as coded (the writer sets it) ...
  int luma_denom = 0, chroma_denom_delta = 0;
  uint8_t luma_w_flag[2][16] = {}, chroma_w_flag[2][16] = {};
  int delta_luma_w[2][16] = {}, luma_off[2][16] = {};
  int delta_chroma_w[2][16][2] = {}, delta_chroma_off[2][16][2] = {};
  // ... and the weights it gives (FFmpeg's luma_weight_lX, luma_offset_lX,
  // chroma_weight_lX, chroma_offset_lX)
  int chroma_denom = 0;
  int lw[2][16] = {}, lo[2][16] = {}, cw[2][16][2] = {}, co[2][16][2] = {};
  int qp_delta = 0, cb_qp_offset = 0, cr_qp_offset = 0;
  int deblocking_override = 0, deblocking_disabled = 0, beta_offset_div2 = 0, tc_offset_div2 = 0;
  int loop_filter_across_slices = 0;
  int num_entry_points = 0, offset_len = 1;
  std::vector<uint32_t> entry_points;
  // derived
  const ShortTermRps* rps = nullptr;
  int num_pic_total_curr = 0, slice_qp = 26;
};

// pred_weight_table (7.3.6.3) as FFmpeg's pred_weight_table reads and
// checks it, with the chroma offset's derivation and clip
template <class E>
static void pred_weight_table(E& e, SliceHeader& h) {
  h.luma_denom = e.ue(h.luma_denom);
  if (h.luma_denom < 0 || h.luma_denom > 7) fail("corrupt H.265 data: luma_log2_weight_denom %d", h.luma_denom);
  h.chroma_denom_delta = e.se(h.chroma_denom_delta);
  long cd = (long)h.luma_denom + h.chroma_denom_delta;
  if (cd < 0 || cd > 7) fail("corrupt H.265 data: chroma_log2_weight_denom %ld", cd);
  h.chroma_denom = (int)cd;
  for (int l = 0; l < (h.type == SLICE_B ? 2 : 1); l++) {
    const int n = h.num_ref_idx[l];
    for (int i = 0; i < n; i++) h.luma_w_flag[l][i] = (uint8_t)e.u(1, h.luma_w_flag[l][i]);
    for (int i = 0; i < n; i++) h.chroma_w_flag[l][i] = (uint8_t)e.u(1, h.chroma_w_flag[l][i]);
    for (int i = 0; i < n; i++) {
      h.lw[l][i] = 1 << h.luma_denom;
      h.lo[l][i] = 0;
      if (h.luma_w_flag[l][i]) {
        h.delta_luma_w[l][i] = e.se(h.delta_luma_w[l][i]);
        h.luma_off[l][i] = e.se(h.luma_off[l][i]);
        // FFmpeg checks the weight's delta, not the offset's range
        if (h.delta_luma_w[l][i] < -128 || h.delta_luma_w[l][i] > 127)
          fail("corrupt H.265 data: delta_luma_weight %d", h.delta_luma_w[l][i]);
        h.lw[l][i] += h.delta_luma_w[l][i];
        h.lo[l][i] = (int16_t)h.luma_off[l][i];  // FFmpeg keeps it in 16 bits
      }
      for (int j = 0; j < 2; j++) {
        h.cw[l][i][j] = 1 << h.chroma_denom;
        h.co[l][i][j] = 0;
        if (!h.chroma_w_flag[l][i]) continue;
        int dw = h.delta_chroma_w[l][i][j] = e.se(h.delta_chroma_w[l][i][j]);
        int doff = h.delta_chroma_off[l][i][j] = e.se(h.delta_chroma_off[l][i][j]);
        if (dw < -128 || dw > 127 || doff < -(1 << 17) || doff > (1 << 17))
          fail("corrupt H.265 data: delta_chroma_weight %d, delta_chroma_offset %d", dw, doff);
        h.cw[l][i][j] += dw;
        h.co[l][i][j] = clip3(-128, 127, doff - ((128 * h.cw[l][i][j]) >> h.chroma_denom) + 128);
      }
    }
  }
}

template <class E>
static void slice_header_syntax(E& e, SliceHeader& h, const Pps* const* pps_table, const Sps* const* sps_table,
                                const Pps*& pp, const Sps*& sp) {
  h.first_slice = e.u(1, h.first_slice);
  if (h.nal_type >= NAL_BLA_W_LP && h.nal_type <= 23) h.no_output_of_prior_pics = e.u(1, h.no_output_of_prior_pics);
  h.pps_id = e.ue(h.pps_id);
  if (h.pps_id > 63 || !pps_table[h.pps_id])
    fail("corrupt H.265 data: a slice refers to PPS %d, which was not sent", h.pps_id);
  pp = pps_table[h.pps_id];
  sp = sps_table[pp->sps_id];
  if (!sp) fail("corrupt H.265 data: PPS %d refers to a missing SPS", h.pps_id);
  const Pps& p = *pp;
  const Sps& s = *sp;
  if (!E::W) h.dependent = 0;
  if (!h.first_slice) {
    if (p.dependent_slices) h.dependent = e.u(1, h.dependent);
    if (!E::W && h.dependent) fail("H.265 dependent slice segments are not supported");
    h.address = e.u(ceil_log2(s.ctb_w * s.ctb_h), h.address);
    if (h.address >= s.ctb_w * s.ctb_h) fail("corrupt H.265 data: slice_segment_address %d", h.address);
  } else {
    h.address = 0;
  }
  for (int i = 0; i < p.num_extra_bits; i++) e.u(1, 0);
  h.type = e.ue(h.type);
  if (h.type > 2) fail("corrupt H.265 data: slice_type %d", h.type);
  if (is_irap(h.nal_type) && h.type != SLICE_I) fail("corrupt H.265 data: an IRAP picture with a P or B slice");
  h.pic_output = p.output_flag_present ? e.u(1, h.pic_output) : 1;
  h.num_pic_total_curr = 0;
  h.rps = nullptr;
  if (!E::W) h.temporal_mvp = 0;
  if (!is_idr(h.nal_type)) {
    h.poc_lsb = e.u(s.log2_max_poc_lsb, h.poc_lsb);
    h.st_rps_sps = e.u(1, h.st_rps_sps);
    if (!h.st_rps_sps) {
      // the slice's set may predict from the SPS's sets: build it beside them
      ShortTermRps tmp[65];
      for (int i = 0; i < s.num_st_rps; i++) tmp[i] = s.st_rps[i];
      tmp[s.num_st_rps] = h.st_rps;
      st_ref_pic_set(e, tmp, s.num_st_rps, true);
      h.st_rps = tmp[s.num_st_rps];
      h.rps = &h.st_rps;
    } else {
      if (!s.num_st_rps) fail("corrupt H.265 data: short_term_ref_pic_set_sps_flag without SPS sets");
      h.st_rps_idx = s.num_st_rps > 1 ? e.u(ceil_log2(s.num_st_rps), h.st_rps_idx) : 0;
      if (h.st_rps_idx >= s.num_st_rps) fail("corrupt H.265 data: short_term_ref_pic_set_idx %d", h.st_rps_idx);
      h.rps = &s.st_rps[h.st_rps_idx];
    }
    if (s.long_term_present) {
      int n_sps = s.num_lt_sps > 0 ? e.ue(0) : 0;
      int n_pics = e.ue(h.num_long_term_pics);
      if (!E::W && (n_sps || n_pics)) fail("H.265 long-term reference pictures are not supported");
    }
    if (s.temporal_mvp) h.temporal_mvp = e.u(1, h.temporal_mvp);
    for (int i = 0; i < h.rps->num_delta; i++) h.num_pic_total_curr += h.rps->used[i];
  }
  if (!s.temporal_mvp || is_idr(h.nal_type)) h.temporal_mvp = 0;
  if (!E::W) h.sao_luma = h.sao_chroma = 0;
  if (!s.sao) h.sao_luma = h.sao_chroma = 0;
  if (s.sao) {
    h.sao_luma = e.u(1, h.sao_luma);
    h.sao_chroma = e.u(1, h.sao_chroma);
  }
  if (!E::W || h.type == SLICE_I) {
    h.num_ref_idx[0] = h.num_ref_idx[1] = 0;
    h.list_mod[0] = h.list_mod[1] = 0;
    h.mvd_l1_zero = 0;
    h.cabac_init = 0;
    h.collocated_from_l0 = 1;
    h.collocated_ref_idx = 0;
    h.max_merge_cand = 5;
  }
  if (h.type != SLICE_I) {
    const bool b = h.type == SLICE_B;
    h.num_ref_idx_override = e.u(1, h.num_ref_idx_override);
    h.num_ref_idx[0] = h.num_ref_idx_override ? e.ue(h.num_ref_idx[0] - 1) + 1 : p.num_ref_idx_default[0];
    h.num_ref_idx[1] = !b ? 0 : h.num_ref_idx_override ? e.ue(h.num_ref_idx[1] - 1) + 1 : p.num_ref_idx_default[1];
    for (int l = 0; l < 2; l++)
      if (h.num_ref_idx[l] < (l == 0 || b) || h.num_ref_idx[l] > 15)
        fail("corrupt H.265 data: num_ref_idx_l%d_active %d", l, h.num_ref_idx[l]);
    // the entries are checked against the lists they index (FFmpeg's
    // ff_hevc_slice_rpl)
    const bool mod = p.lists_modification && h.num_pic_total_curr > 1;
    for (int l = 0; l < 2; l++) {
      if (!mod || (l == 1 && !b)) {
        h.list_mod[l] = 0;
        continue;
      }
      h.list_mod[l] = e.u(1, h.list_mod[l]);
      if (h.list_mod[l])
        for (int i = 0; i < h.num_ref_idx[l]; i++)
          h.list_entry[l][i] = e.u(ceil_log2(h.num_pic_total_curr), h.list_entry[l][i]);
    }
    h.mvd_l1_zero = b ? e.u(1, h.mvd_l1_zero) : 0;
    if (!p.cabac_init_present) h.cabac_init = 0;
    if (p.cabac_init_present) h.cabac_init = e.u(1, h.cabac_init);
    if (!b || !h.temporal_mvp) h.collocated_from_l0 = 1;
    if (b && h.temporal_mvp) h.collocated_from_l0 = e.u(1, h.collocated_from_l0);
    const int col_list = !h.collocated_from_l0;
    if (!(h.temporal_mvp && h.num_ref_idx[col_list] > 1)) h.collocated_ref_idx = 0;
    if (h.temporal_mvp && h.num_ref_idx[col_list] > 1) {
      h.collocated_ref_idx = e.ue(h.collocated_ref_idx);
      if (h.collocated_ref_idx < 0 || h.collocated_ref_idx >= h.num_ref_idx[col_list])
        fail("corrupt H.265 data: collocated_ref_idx %d", h.collocated_ref_idx);
    }
    if ((p.weighted_pred && !b) || (p.weighted_bipred && b)) pred_weight_table(e, h);
    h.max_merge_cand = 5 - e.ue(5 - h.max_merge_cand);
    if (h.max_merge_cand < 1 || h.max_merge_cand > 5) fail("corrupt H.265 data: MaxNumMergeCand %d", h.max_merge_cand);
  }
  h.qp_delta = e.se(h.qp_delta);
  h.slice_qp = p.init_qp + h.qp_delta;
  if (h.slice_qp < 0 || h.slice_qp > 51) fail("corrupt H.265 data: SliceQpY %d", h.slice_qp);
  if (!E::W || !p.slice_chroma_qp_offsets) h.cb_qp_offset = h.cr_qp_offset = 0;
  if (p.slice_chroma_qp_offsets) {
    h.cb_qp_offset = e.se(h.cb_qp_offset);
    h.cr_qp_offset = e.se(h.cr_qp_offset);
    if (h.cb_qp_offset < -12 || h.cb_qp_offset > 12 || h.cr_qp_offset < -12 || h.cr_qp_offset > 12 ||
        p.cb_qp_offset + h.cb_qp_offset < -12 || p.cb_qp_offset + h.cb_qp_offset > 12 ||
        p.cr_qp_offset + h.cr_qp_offset < -12 || p.cr_qp_offset + h.cr_qp_offset > 12)
      fail("corrupt H.265 data: slice_cb/cr_qp_offset %d/%d", h.cb_qp_offset, h.cr_qp_offset);
  }
  h.deblocking_override = p.deblocking_override ? e.u(1, h.deblocking_override) : 0;
  if (h.deblocking_override) {
    // (disabled: FFmpeg keeps the offsets of the slice header before,
    // which the caller leaves in h)
    h.deblocking_disabled = e.u(1, h.deblocking_disabled);
    if (!h.deblocking_disabled) {
      h.beta_offset_div2 = e.se(h.beta_offset_div2);
      h.tc_offset_div2 = e.se(h.tc_offset_div2);
      if (h.beta_offset_div2 < -6 || h.beta_offset_div2 > 6 || h.tc_offset_div2 < -6 || h.tc_offset_div2 > 6)
        fail("corrupt H.265 data: slice beta/tc offsets %d/%d", h.beta_offset_div2, h.tc_offset_div2);
    }
  } else {
    h.deblocking_disabled = p.deblocking_disabled;
    h.beta_offset_div2 = p.beta_offset_div2;
    h.tc_offset_div2 = p.tc_offset_div2;
  }
  h.loop_filter_across_slices = p.loop_filter_across_slices;
  if (p.loop_filter_across_slices && (h.sao_luma || h.sao_chroma || !h.deblocking_disabled))
    h.loop_filter_across_slices = e.u(1, h.loop_filter_across_slices);
  if (!E::W || !(p.tiles || p.wpp)) h.num_entry_points = 0;
  if (p.tiles || p.wpp) {
    h.num_entry_points = e.ue(h.num_entry_points);
    if (h.num_entry_points > s.ctb_h) fail("corrupt H.265 data: num_entry_point_offsets %d", h.num_entry_points);
    if (h.num_entry_points > 0) {
      h.offset_len = e.ue(h.offset_len - 1) + 1;
      if (h.offset_len > 32) fail("corrupt H.265 data: offset_len_minus1 %d", h.offset_len - 1);
      h.entry_points.resize((size_t)h.num_entry_points);
      for (int i = 0; i < h.num_entry_points; i++) {
        uint32_t v = E::W ? h.entry_points[(size_t)i] - 1 : 0;
        if (h.offset_len == 32) {
          uint32_t hi = (uint32_t)e.u(16, (int)(v >> 16)), lo = (uint32_t)e.u(16, (int)(v & 0xffff));
          v = hi << 16 | lo;
        } else {
          v = (uint32_t)e.u(h.offset_len, (int)v);
        }
        h.entry_points[(size_t)i] = v + 1;
      }
    }
  }
  if (p.slice_header_extension) {
    int n = e.ue(0);
    if (n > 256) fail("corrupt H.265 data: slice_segment_header_extension_length %d", n);
    for (int i = 0; i < n; i++) e.u(8, 0);
  }
}

// ------------------------------------------------------------------ pictures

struct Mv {
  int16_t x = 0, y = 0;
  bool operator==(const Mv& o) const { return x == o.x && y == o.y; }
  bool operator!=(const Mv& o) const { return !(*this == o); }
};

// A prediction block's motion, FFmpeg's MvField: pred 0 intra or none, 1
// list 0, 2 list 1, 3 both (PF_INTRA, PF_L0, PF_L1, PF_BI); the vector and
// index of a list the block does not use are not read
enum { PF_INTRA = 0, PF_L0 = 1, PF_L1 = 2, PF_BI = 3 };
struct MvField {
  Mv mv[2];
  int8_t ref[2] = {-1, -1};
  uint8_t pred = PF_INTRA;
};

// FFmpeg's compare_mv_ref_idx: the same motion in the lists both use
static inline bool same_motion(const MvField& a, const MvField& b) {
  if (a.pred != b.pred || a.pred == PF_INTRA) return false;
  for (int l = 0; l < 2; l++)
    if ((a.pred >> l & 1) && (a.mv[l] != b.mv[l] || a.ref[l] != b.ref[l])) return false;
  return true;
}

// the POCs of a slice's two reference lists
struct RefPocs {
  std::vector<int> l[2];
};

enum { F_OUTPUT = 1, F_SHORT_REF = 2 };

struct Picture {
  int id = -1;
  int w = 0, h = 0;  // luma size in samples
  std::vector<uint8_t> y, u, v;
  int poc = 0, flags = 0;
  bool missing = false;
  int crop[4] = {0, 0, 0, 0};  // left, right, top, bottom in luma samples
  // motion for TMVP: per 4x4 block, the slice of each CTB and each slice's
  // lists (POCs), as FFmpeg's rpl_tab keeps them per CTB
  std::vector<MvField> mvf;
  std::vector<int16_t> ctb_slice;
  std::vector<RefPocs> slice_refs;
  void alloc(int wl, int hl) {
    w = wl;
    h = hl;
    y.assign((size_t)w * h, 0);
    u.assign((size_t)w * h / 4, 0);
    v.assign((size_t)w * h / 4, 0);
    mvf.assign((size_t)(w / 4) * (h / 4), MvField());
  }
};

// ------------------------------------------------------------------ writer hooks

// What a stream writer chooses, asked by the syntax layer when it writes
// (decoding never calls these).
struct SaoParams {
  int8_t type[3] = {0, 0, 0};  // 0 none, 1 band, 2 edge
  int8_t offset[3][4] = {{0}};  // sao_offset_abs with its sign
  uint8_t band[3] = {0, 0, 0}, eo[3] = {0, 0, 0};
};

struct CuChoice {
  int skip = 0, intra = 0, part = 0, pcm = 0;
  int luma_mode[4] = {1, 1, 1, 1};  // IntraPredModeY of each PU
  int chroma = 4;                   // intra_chroma_pred_mode
  int rqt_root_cbf = 1;
};

struct PuChoice {
  int merge = 0, merge_idx = 0;
  int inter_pred = 0;  // 0 list 0, 1 list 1, 2 both (inter_pred_idc)
  int ref_idx[2] = {0, 0}, mvp[2] = {0, 0};
  int use_target[2] = {0, 0};  // mvd = target - the chosen predictor
  Mv mvd[2], target[2];
};

struct Policy {
  virtual ~Policy() {}
  virtual int end_of_slice(int ctb_rs) = 0;
  virtual void sao(int rx, int ry, int can_left, int can_up, int& merge_left, int& merge_up, SaoParams& p) = 0;
  virtual int split_cu(int x, int y, int log2, int depth) = 0;
  virtual void cu(int x, int y, int log2, const MvField* merge, int nmerge, CuChoice& c) = 0;
  virtual void pu(int x, int y, int w, int h, int part_idx, const MvField* merge, int nmerge, PuChoice& c) = 0;
  virtual int split_tu(int x, int y, int log2, int depth, int intra) = 0;
  virtual int cbf(int c, int x, int y, int log2, int depth) = 0;
  virtual int qp_delta(int x, int y) = 0;
  virtual int transform_skip(int c, int x, int y) = 0;
  // the TransCoeffLevel values of a block, raster order, at least one non-zero
  virtual void residual(int c, int x, int y, int log2, int16_t* coeff) = 0;
  virtual void pcm(int x, int y, int log2, int c, uint8_t* samples) = 0;
};

// The decoder's counters (STATS in render/hevc.py)
enum Stat {
  ST_PICS, ST_IDR, ST_CRA, ST_IRAP_OTHER, ST_I_SLICES, ST_P_SLICES, ST_SLICES_2PLUS, ST_CTB16, ST_CTB32,
  ST_CTB64, ST_SPLIT_CU, ST_SKIP, ST_MERGE, ST_AMVP, ST_AMP, ST_INTER_NXN, ST_PART_2NXN, ST_PART_NX2N,
  ST_INTRA_NXN, ST_INTRA_ANGULAR, ST_INTRA_PLANAR, ST_INTRA_DC, ST_CHROMA_DM, ST_PCM, ST_TU_SPLIT,
  ST_TU4, ST_TU32, ST_DST, ST_TRANSFORM_SKIP, ST_SIGN_HIDDEN, ST_QP_DELTA, ST_SCALING_LISTS,
  ST_CHROMA_QP_OFFSET, ST_CIP, ST_STRONG_SMOOTHING, ST_TMVP, ST_SCALED_MV, ST_MULTI_REF, ST_MERGE_LEVEL,
  ST_DEBLOCK_OFF, ST_DEBLOCKED_EDGES, ST_SAO_BAND, ST_SAO_EDGE, ST_SAO_MERGE, ST_WPP_ROWS, ST_CABAC_INIT,
  ST_CROPPED, ST_INTER_RPS, ST_RASL_SKIPPED, ST_MISSING_REFS, ST_NOT_OUTPUT, ST_REORDER, ST_LIST_MOD,
  ST_PCM_NO_FILTER, ST_SLICE_ACROSS_OFF, ST_DROPPED_PICTURES, ST_CIP_BLOCKS, ST_B_SLICES, ST_BI_PUS,
  ST_L1_PUS, ST_COMBINED_BI, ST_TMVP_L1, ST_COL_FROM_L1, ST_MVD_L1_ZERO, ST_LIST_MOD_L1, ST_BI_TO_L0,
  ST_WEIGHTED_PUS, ST_WEIGHTED_SLICES, ST_ZERO_MERGE_B, ST_COUNT
};

enum { PART_2Nx2N, PART_2NxN, PART_Nx2N, PART_NxN, PART_2NxnU, PART_2NxnD, PART_nLx2N, PART_nRx2N };

// ------------------------------------------------------------------ decoder

struct Decoder {
  std::unique_ptr<Vps> vps[16];
  std::unique_ptr<Sps> sps[16];
  std::unique_ptr<Pps> pps[64];
  Policy* pol = nullptr;  // the writer's choices; null when decoding
  long stats[ST_COUNT] = {0};
  std::string error;

  // the active parameter sets (copies: a later set of the same id does
  // not change a picture being decoded)
  Sps as;
  Pps ap;
  bool have_sps = false;
  SliceHeader sh;
  int slice_addr = 0;   // SliceAddrRs of the current slice
  int slice_index = 0;  // the current slice's index in its picture
  int init_type = 0;

  // geometry of the active SPS
  int W = 0, H = 0, log2ctb = 4, ctb = 16, w4 = 0, h4 = 0;
  std::vector<int> zs4;  // z-scan order of each 4x4 block (6.5.2 at 4x4)

  // the picture being decoded, its per-4x4 state
  Picture* cur = nullptr;
  std::vector<uint8_t> intra4, skip4, depth4, ipm4, pcm4, cbf4, qp4;
  std::vector<int> ctb_slice_addr;  // SliceAddrRs of each decoded CTB, -1 before
  std::vector<uint8_t> vbs, hbs;    // boundary strengths of the left / top edge of each 4x4
  struct CtbFilter {
    int beta = 0, tc = 0, across = 1;
  };
  std::vector<CtbFilter> ctb_filter;
  std::vector<SaoParams> ctb_sao;
  std::vector<uint8_t> ctb_sao_used;

  // CTU-level parsing state (FFmpeg's local context)
  int ctb_rs = 0, ctb_x = 0, ctb_y = 0;
  int ctb_left = 0, ctb_up = 0;
  int qp_y = 26, qpy_pred = 26, first_qp_group = 1, qp_delta_coded = 0, cu_qp_delta = 0;
  uint8_t wpp_saved[C_COUNT];
  // the current CU
  int cu_intra = 0, cu_part = 0, cu_pcm = 0, cu_skip = 0, cu_merge2nx2n = 0, intra_split = 0, max_trafo_depth = 0;
  int pu_luma_mode[4] = {1, 1, 1, 1}, pu_chroma_mode = 1, tu_luma_mode = 1;

  // the reference pictures of the current slice's lists, their POCs, and
  // the co-located picture
  std::vector<Picture*> ref_list[2];
  RefPocs ref_poc;
  Picture* col_pic = nullptr;
  int cu_depth = 0;  // CtDepth of the current coding unit
  bool weighted = false;  // explicit weights for the slice's type (the PPS's flag)

  // ---------------------------------------------------------------- helpers

  inline size_t at4(int x, int y) const { return (size_t)(y >> 2) * w4 + (x >> 2); }
  inline int ctb_of(int x, int y) const { return (y >> log2ctb) * as.ctb_w + (x >> log2ctb); }

  void set_geometry() {
    W = as.width;
    H = as.height;
    log2ctb = as.log2_ctb;
    ctb = 1 << log2ctb;
    w4 = W >> 2;
    h4 = H >> 2;
    zs4.assign((size_t)w4 * h4, 0);
    int per = 1 << (2 * (log2ctb - 2));
    for (int y = 0; y < h4; y++)
      for (int x = 0; x < w4; x++) {
        int cx = (x << 2) >> log2ctb, cy = (y << 2) >> log2ctb;
        int lx = x & ((ctb >> 2) - 1), ly = y & ((ctb >> 2) - 1), m = 0;
        for (int b = 0; b < 4; b++) m |= ((lx >> b) & 1) << (2 * b) | ((ly >> b) & 1) << (2 * b + 1);
        zs4[(size_t)y * w4 + x] = (cy * as.ctb_w + cx) * per + m;
      }
  }

  // 6.4.1: is (xn, yn) available to the block at (xc, yc)
  bool avail(int xc, int yc, int xn, int yn) const {
    if (xn < 0 || yn < 0 || xn >= W || yn >= H) return false;
    if (zs4[at4(xn, yn)] > zs4[at4(xc, yc)]) return false;
    return ctb_slice_addr[(size_t)ctb_of(xn, yn)] == slice_addr;
  }

  // 6.4.2: for a prediction block, then not intra
  bool avail_pb(int xCb, int yCb, int nCbS, int xPb, int yPb, int nPbW, int nPbH, int part_idx, int xn,
                int yn) const {
    bool same = xCb <= xn && yCb <= yn && xCb + nCbS > xn && yCb + nCbS > yn;
    bool a;
    if (!same)
      a = avail(xPb, yPb, xn, yn);
    else
      a = !((nPbW << 1) == nCbS && (nPbH << 1) == nCbS && part_idx == 1 && yCb + nPbH <= yn && xCb + nPbW > xn);
    return a && !intra4[at4(xn, yn)];
  }

  template <class T>
  void fill4(std::vector<T>& v, int x0, int y0, int w, int h, T val) {
    for (int y = y0; y < y0 + h; y += 4)
      for (int x = x0; x < x0 + w; x += 4) v[at4(x, y)] = val;
  }

  // ---------------------------------------------------------------- slice data

  // the bins of a value: bypass fixed length
  template <class E>
  static int fl_bypass(E& e, int n, int want) {
    int v = 0;
    for (int i = n - 1; i >= 0; i--) v = v << 1 | e.byp((want >> i) & 1);
    return v;
  }

  std::vector<size_t> substreams;  // the writer's substream starts (bytes of slice data)

  template <class E>
  void slice_data(E& e) {
    init_contexts(e.ctx(), sh.slice_qp, init_type);
    e.cabac_start();
    qp_y = sh.slice_qp;
    qpy_pred = sh.slice_qp;
    first_qp_group = 1;
    const int total = as.ctb_w * as.ctb_h;
    int addr = sh.address;
    for (;;) {
      ctb_rs = addr;
      ctb_x = addr % as.ctb_w;
      ctb_y = addr / as.ctb_w;
      if (addr != sh.address && ap.wpp && ctb_x == 0) {
        // a new row of CTBs: the contexts as they were after the second CTB
        // of the row above (a picture one CTB wide starts afresh)
        if (as.ctb_w == 1)
          init_contexts(e.ctx(), sh.slice_qp, init_type);
        else
          std::memcpy(e.ctx(), wpp_saved, C_COUNT);
        stats[ST_WPP_ROWS]++;
      }
      if (ap.wpp && ctb_x == 0) first_qp_group = 1;
      ctb_slice_addr[(size_t)addr] = slice_addr;
      cur->ctb_slice[(size_t)addr] = (int16_t)slice_index;
      ctb_filter[(size_t)addr] = {sh.beta_offset_div2 * 2, sh.tc_offset_div2 * 2, sh.loop_filter_across_slices};
      ctb_left = ctb_x > 0 && addr - 1 >= slice_addr;
      ctb_up = ctb_y > 0 && addr - as.ctb_w >= slice_addr;
      int x0 = ctb_x << log2ctb, y0 = ctb_y << log2ctb;
      if (sh.sao_luma || sh.sao_chroma) sao_syntax(e, ctb_x, ctb_y);
      coding_quadtree(e, x0, y0, log2ctb, 0);
      if (ap.wpp && ctb_x == 1) std::memcpy(wpp_saved, e.ctx(), C_COUNT);
      int want_end = 0;
      if (E::W) want_end = addr + 1 == total ? 1 : pol->end_of_slice(addr);
      int end = e.term(want_end);
      addr++;
      if (end) break;
      if (addr >= total) fail("corrupt H.265 data: slice data past the end of the picture");
      if (ap.wpp && addr % as.ctb_w == 0) {
        if (!e.term(1)) fail("corrupt H.265 data: end_of_subset_one_bit is 0");
        e.cabac_restart();
        if (E::W) substreams.push_back(((WriteEngine&)e).bw->buf.size());
      }
    }
  }
  int last_beta_div2 = 0, last_tc_div2 = 0;  // of the last slice header (FFmpeg keeps them)

  template <class E>
  void sao_syntax(E& e, int rx, int ry) {
    SaoParams want;
    int ml = 0, mu = 0;
    if (E::W) pol->sao(rx, ry, ctb_left, ctb_up, ml, mu, want);
    int merge_left = 0, merge_up = 0;
    if (rx > 0 && ctb_left) merge_left = e.bin(C_SAO_MERGE, ml);
    if (ry > 0 && !merge_left && ctb_up) merge_up = e.bin(C_SAO_MERGE, mu);
    SaoParams& sp = ctb_sao[(size_t)ctb_rs];
    const SaoParams* src = merge_left ? &ctb_sao[(size_t)ctb_rs - 1]
                                      : merge_up ? &ctb_sao[(size_t)(ctb_rs - as.ctb_w)] : nullptr;
    if (src) stats[ST_SAO_MERGE]++;
    for (int c = 0; c < 3; c++) {
      if ((c == 0 && !sh.sao_luma) || (c > 0 && !sh.sao_chroma)) {
        sp.type[c] = 0;
        continue;
      }
      if (src) {
        sp.type[c] = src->type[c];
        sp.band[c] = src->band[c];
        sp.eo[c] = src->eo[c];
        for (int i = 0; i < 4; i++) sp.offset[c][i] = src->offset[c][i];
        continue;
      }
      if (c == 2) {
        sp.type[2] = sp.type[1];
        sp.eo[2] = sp.eo[1];
      } else {
        int t = 0;
        if (e.bin(C_SAO_TYPE, want.type[c] != 0)) t = e.byp(want.type[c] == 2) ? 2 : 1;
        sp.type[c] = (int8_t)t;
      }
      if (!sp.type[c]) continue;
      int abs_[4];
      for (int i = 0; i < 4; i++) {
        int w = std::abs(want.offset[c][i]), v = 0;
        while (v < 7 && e.byp(v < w)) v++;
        abs_[i] = v;
      }
      if (sp.type[c] == 1) {
        for (int i = 0; i < 4; i++) {
          int neg = abs_[i] ? e.byp(want.offset[c][i] < 0) : 0;
          sp.offset[c][i] = (int8_t)(neg ? -abs_[i] : abs_[i]);
        }
        sp.band[c] = (uint8_t)fl_bypass(e, 5, want.band[c]);
        stats[ST_SAO_BAND]++;
      } else {
        for (int i = 0; i < 4; i++) sp.offset[c][i] = (int8_t)(i < 2 ? abs_[i] : -abs_[i]);
        if (c != 2) sp.eo[c] = (uint8_t)fl_bypass(e, 2, want.eo[c]);
        stats[ST_SAO_EDGE]++;
      }
    }
    ctb_sao_used[(size_t)ctb_rs] = 1;
  }

  template <class E>
  void coding_quadtree(E& e, int x0, int y0, int log2, int depth) {
    int size = 1 << log2, split;
    if (x0 + size <= W && y0 + size <= H && log2 > as.log2_min_cb) {
      int inc = (avail(x0, y0, x0 - 1, y0) && depth4[at4(x0 - 1, y0)] > depth) +
                (avail(x0, y0, x0, y0 - 1) && depth4[at4(x0, y0 - 1)] > depth);
      split = e.bin(C_SPLIT_CU + inc, E::W ? pol->split_cu(x0, y0, log2, depth) : 0);
    } else {
      split = log2 > as.log2_min_cb;
    }
    if (ap.cu_qp_delta && log2 >= log2ctb - ap.diff_cu_qp_delta_depth) {
      qp_delta_coded = 0;
      cu_qp_delta = 0;
    }
    if (split) {
      stats[ST_SPLIT_CU]++;
      int h = size >> 1;
      coding_quadtree(e, x0, y0, log2 - 1, depth + 1);
      if (x0 + h < W) coding_quadtree(e, x0 + h, y0, log2 - 1, depth + 1);
      if (y0 + h < H) coding_quadtree(e, x0, y0 + h, log2 - 1, depth + 1);
      if (x0 + h < W && y0 + h < H) coding_quadtree(e, x0 + h, y0 + h, log2 - 1, depth + 1);
      // FFmpeg's predictor update after a split node too (a CTB the
      // picture's edge cuts ends no coding unit on the group's corner)
      int qmask = (1 << (log2ctb - ap.diff_cu_qp_delta_depth)) - 1;
      if (((x0 + size) & qmask) == 0 && ((y0 + size) & qmask) == 0) qpy_pred = qp_y;
    } else {
      coding_unit(e, x0, y0, log2, depth);
    }
  }

  template <class E>
  int part_mode(E& e, int log2, int want) {
    if (e.bin(C_PART_MODE, want == PART_2Nx2N)) return PART_2Nx2N;
    if (log2 == as.log2_min_cb) {
      if (cu_intra) return PART_NxN;
      if (e.bin(C_PART_MODE + 1, want == PART_2NxN)) return PART_2NxN;
      if (log2 == 3) return PART_Nx2N;
      if (e.bin(C_PART_MODE + 2, want == PART_Nx2N)) return PART_Nx2N;
      return PART_NxN;
    }
    if (!as.amp) return e.bin(C_PART_MODE + 1, want == PART_2NxN) ? PART_2NxN : PART_Nx2N;
    bool hor = want == PART_2NxN || want == PART_2NxnU || want == PART_2NxnD;
    if (e.bin(C_PART_MODE + 1, hor)) {
      if (e.bin(C_PART_MODE + 3, want == PART_2NxN)) return PART_2NxN;
      return e.byp(want == PART_2NxnD) ? PART_2NxnD : PART_2NxnU;
    }
    if (e.bin(C_PART_MODE + 3, want == PART_Nx2N)) return PART_Nx2N;
    return e.byp(want == PART_nRx2N) ? PART_nRx2N : PART_nLx2N;
  }

  // candModeList (8.4.2)
  void mpm(int xp, int yp, int* cand) const {
    int a = avail(xp, yp, xp - 1, yp) ? ipm4[at4(xp - 1, yp)] : 1;
    int b = avail(xp, yp, xp, yp - 1) && yp - 1 >= ((yp >> log2ctb) << log2ctb) ? ipm4[at4(xp, yp - 1)] : 1;
    if (a == b) {
      if (a < 2) {
        cand[0] = 0;
        cand[1] = 1;
        cand[2] = 26;
      } else {
        cand[0] = a;
        cand[1] = 2 + ((a + 29) % 32);
        cand[2] = 2 + ((a - 2 + 1) % 32);
      }
    } else {
      cand[0] = a;
      cand[1] = b;
      cand[2] = a != 0 && b != 0 ? 0 : a != 1 && b != 1 ? 1 : 26;
    }
  }

  template <class E>
  void intra_modes(E& e, int x0, int y0, int log2, const CuChoice& ch) {
    int n = 1 << log2, pb = intra_split ? n / 2 : n, np = intra_split ? 4 : 1;
    int wprev[4] = {0, 0, 0, 0}, widx[4] = {0, 0, 0, 0}, wrem[4] = {0, 0, 0, 0};
    if (E::W) {
      // the MPM lists in order, with the chosen modes of the PUs before
      std::vector<uint8_t> keep = ipm4;
      for (int i = 0; i < np; i++) {
        int xp = x0 + (i & 1) * pb, yp = y0 + (i >> 1) * pb, cand[3], m = ch.luma_mode[i];
        mpm(xp, yp, cand);
        for (int k = 0; k < 3; k++)
          if (cand[k] == m) {
            wprev[i] = 1;
            widx[i] = k;
          }
        if (!wprev[i]) {
          std::sort(cand, cand + 3);
          int r = m;
          for (int k = 2; k >= 0; k--)
            if (r > cand[k]) r--;
          wrem[i] = r;
        }
        fill4(ipm4, xp, yp, pb, pb, (uint8_t)m);
      }
      ipm4.swap(keep);
    }
    int prev[4];
    for (int i = 0; i < np; i++) prev[i] = e.bin(C_PREV_INTRA, wprev[i]);
    for (int i = 0; i < np; i++) {
      int xp = x0 + (i & 1) * pb, yp = y0 + (i >> 1) * pb, cand[3], mode;
      mpm(xp, yp, cand);
      if (prev[i]) {
        int idx = e.byp(widx[i] > 0);
        if (idx) idx += e.byp(widx[i] > 1);
        mode = cand[idx];
      } else {
        mode = fl_bypass(e, 5, wrem[i]);
        std::sort(cand, cand + 3);
        for (int k = 0; k < 3; k++)
          if (mode >= cand[k]) mode++;
      }
      pu_luma_mode[i] = mode;
      fill4(ipm4, xp, yp, pb, pb, (uint8_t)mode);
      stats[mode == 0 ? ST_INTRA_PLANAR : mode == 1 ? ST_INTRA_DC : ST_INTRA_ANGULAR]++;
    }
    int c = 4;
    if (e.bin(C_CHROMA_MODE, ch.chroma != 4)) c = fl_bypass(e, 2, ch.chroma);
    static const int kChroma[4] = {0, 26, 10, 1};
    int m0 = pu_luma_mode[0];
    if (c == 4) {
      pu_chroma_mode = m0;
      stats[ST_CHROMA_DM]++;
    } else {
      pu_chroma_mode = kChroma[c] == m0 ? 34 : kChroma[c];
    }
  }

  template <class E>
  void coding_unit(E& e, int x0, int y0, int log2, int depth) {
    int n = 1 << log2;
    cu_depth = depth;
    CuChoice ch;
    if (E::W) {
      MvField mc[5];
      int nmc = sh.type != SLICE_I ? merge_candidates(x0, y0, n, x0, y0, n, n, 0, PART_2Nx2N, mc) : 0;
      pol->cu(x0, y0, log2, mc, nmc, ch);
    }
    cu_skip = 0;
    cu_intra = sh.type == SLICE_I;
    cu_part = PART_2Nx2N;
    cu_pcm = 0;
    intra_split = 0;
    cu_merge2nx2n = 0;
    if (sh.type != SLICE_I) {
      int inc = (avail(x0, y0, x0 - 1, y0) && skip4[at4(x0 - 1, y0)]) +
                (avail(x0, y0, x0, y0 - 1) && skip4[at4(x0, y0 - 1)]);
      cu_skip = e.bin(C_SKIP + inc, ch.skip);
    }
    fill4(skip4, x0, y0, n, n, (uint8_t)cu_skip);
    fill4(pcm4, x0, y0, n, n, (uint8_t)0);
    if (cu_skip) {
      stats[ST_SKIP]++;
      fill4(intra4, x0, y0, n, n, (uint8_t)0);
      fill4(ipm4, x0, y0, n, n, (uint8_t)1);
      prediction_unit(e, x0, y0, n, x0, y0, n, n, 0);
      if (!sh.deblocking_disabled) deblock_bs(x0, y0, log2);
    } else {
      if (sh.type != SLICE_I) cu_intra = e.bin(C_PRED_MODE, ch.intra);
      if (!cu_intra || log2 == as.log2_min_cb) cu_part = part_mode(e, log2, ch.part);
      fill4(intra4, x0, y0, n, n, (uint8_t)cu_intra);
      if (cu_intra) {
        intra_split = cu_part == PART_NxN;
        if (intra_split) stats[ST_INTRA_NXN]++;
        for (int y = y0; y < y0 + n; y += 4)
          for (int x = x0; x < x0 + n; x += 4) cur->mvf[at4(x, y)] = MvField();
        if (cu_part == PART_2Nx2N && as.pcm && log2 >= as.log2_min_pcm &&
            log2 <= as.log2_min_pcm + as.log2_diff_max_min_pcm)
          cu_pcm = e.term(ch.pcm);
        if (cu_pcm) {
          fill4(ipm4, x0, y0, n, n, (uint8_t)1);
          if (!sh.deblocking_disabled) deblock_bs(x0, y0, log2);
          pcm_sample(e, x0, y0, log2);
          if (as.pcm_loop_filter_disabled) {
            fill4(pcm4, x0, y0, n, n, (uint8_t)1);
            stats[ST_PCM_NO_FILTER]++;
          }
          stats[ST_PCM]++;
        } else {
          intra_modes(e, x0, y0, log2, ch);
        }
      } else {
        fill4(ipm4, x0, y0, n, n, (uint8_t)1);
        int q = n / 4, h2 = n / 2;
        switch (cu_part) {
          case PART_2Nx2N:
            prediction_unit(e, x0, y0, n, x0, y0, n, n, 0);
            break;
          case PART_2NxN:
            prediction_unit(e, x0, y0, n, x0, y0, n, h2, 0);
            prediction_unit(e, x0, y0, n, x0, y0 + h2, n, h2, 1);
            break;
          case PART_Nx2N:
            prediction_unit(e, x0, y0, n, x0, y0, h2, n, 0);
            prediction_unit(e, x0, y0, n, x0 + h2, y0, h2, n, 1);
            break;
          case PART_2NxnU:
            prediction_unit(e, x0, y0, n, x0, y0, n, q, 0);
            prediction_unit(e, x0, y0, n, x0, y0 + q, n, n - q, 1);
            break;
          case PART_2NxnD:
            prediction_unit(e, x0, y0, n, x0, y0, n, n - q, 0);
            prediction_unit(e, x0, y0, n, x0, y0 + n - q, n, q, 1);
            break;
          case PART_nLx2N:
            prediction_unit(e, x0, y0, n, x0, y0, q, n, 0);
            prediction_unit(e, x0, y0, n, x0 + q, y0, n - q, n, 1);
            break;
          case PART_nRx2N:
            prediction_unit(e, x0, y0, n, x0, y0, n - q, n, 0);
            prediction_unit(e, x0, y0, n, x0 + n - q, y0, q, n, 1);
            break;
          default:  // PART_NxN
            prediction_unit(e, x0, y0, n, x0, y0, h2, h2, 0);
            prediction_unit(e, x0, y0, n, x0 + h2, y0, h2, h2, 1);
            prediction_unit(e, x0, y0, n, x0, y0 + h2, h2, h2, 2);
            prediction_unit(e, x0, y0, n, x0 + h2, y0 + h2, h2, h2, 3);
            break;
        }
        if (cu_part >= PART_2NxnU)
          stats[ST_AMP]++;
        else if (cu_part == PART_NxN)
          stats[ST_INTER_NXN]++;
        else if (cu_part == PART_2NxN)
          stats[ST_PART_2NXN]++;
        else if (cu_part == PART_Nx2N)
          stats[ST_PART_NX2N]++;
      }
      if (!cu_pcm) {
        int root = 1;
        if (!cu_intra && !(cu_part == PART_2Nx2N && cu_merge2nx2n)) root = e.bin(C_RQT_ROOT_CBF, ch.rqt_root_cbf);
        if (root) {
          max_trafo_depth = cu_intra ? as.max_th_depth_intra + intra_split : as.max_th_depth_inter;
          int base[2] = {0, 0};
          transform_tree(e, x0, y0, x0, y0, x0, y0, log2, 0, 0, base);
        } else if (!sh.deblocking_disabled) {
          deblock_bs(x0, y0, log2);
        }
      }
    }
    if (ap.cu_qp_delta && !qp_delta_coded) set_qpy(x0, y0);
    fill4(qp4, x0, y0, n, n, (uint8_t)qp_y);
    int qmask = (1 << (log2ctb - ap.diff_cu_qp_delta_depth)) - 1;
    if (((x0 + n) & qmask) == 0 && ((y0 + n) & qmask) == 0) qpy_pred = qp_y;
    fill4(depth4, x0, y0, n, n, (uint8_t)depth);
  }

  // FFmpeg's get_qPy_pred and set_qPy
  void set_qpy(int xb, int yb) {
    int mask = (1 << log2ctb) - 1, qmask = (1 << (log2ctb - ap.diff_cu_qp_delta_depth)) - 1;
    int xq = xb - (xb & qmask), yq = yb - (yb & qmask);
    int avail_a = (xb & mask) && (xq & mask), avail_b = (yb & mask) && (yq & mask);
    int pred;
    if (first_qp_group || (!xq && !yq)) {
      first_qp_group = !qp_delta_coded;
      pred = sh.slice_qp;
    } else {
      pred = qpy_pred;
    }
    int qa = avail_a ? qp4[at4(xq - 1, yq)] : pred;
    int qb = avail_b ? qp4[at4(xq, yq - 1)] : pred;
    int q = (qa + qb + 1) >> 1;
    qp_y = cu_qp_delta ? ((q + cu_qp_delta + 52) % 52 + 52) % 52 : q;
  }

  template <class E>
  void pcm_sample(E& e, int x0, int y0, int log2) {
    int n = 1 << log2;
    e.pcm_start();
    std::vector<uint8_t> want;
    for (int c = 0; c < 3; c++) {
      int nc = c ? n / 2 : n, bits = c ? as.pcm_bit_depth_chroma : as.pcm_bit_depth;
      if (E::W) {
        want.assign((size_t)nc * nc, 0);
        pol->pcm(x0, y0, log2, c, want.data());
      }
      uint8_t* plane = c == 0 ? cur->y.data() : c == 1 ? cur->u.data() : cur->v.data();
      int stride = c ? W / 2 : W, xc = c ? x0 / 2 : x0, yc = c ? y0 / 2 : y0;
      for (int y = 0; y < nc; y++)
        for (int x = 0; x < nc; x++) {
          int v = e.pcm(bits, E::W ? want[(size_t)y * nc + x] >> (8 - bits) : 0);
          plane[(size_t)(yc + y) * stride + xc + x] = (uint8_t)(v << (8 - bits));
        }
    }
    e.cabac_restart();
  }

  // ---------------------------------------------------------------- motion

  static Mv scale_mv(Mv m, int td, int tb) {
    td = clip3(-128, 127, td);
    tb = clip3(-128, 127, tb);
    int tx = (0x4000 + std::abs(td / 2)) / td;
    int f = clip3(-4096, 4095, (tb * tx + 32) >> 6);
    auto s = [&](int v) {
      int p = f * v;
      return (int16_t)clip3(-32768, 32767, (p + 127 + (p < 0)) >> 8);
    };
    return {s(m.x), s(m.y)};
  }

  // the collocated motion of the target list X (8.5.3.2.8, FFmpeg's
  // temporal_luma_motion_vector and derive_temporal_colocated_mvs): the
  // co-located block's own slice's lists give its references; of a
  // bi-predicted block, list X when no reference of the current slice
  // follows the current picture (NoBackwardPredFlag), else the list
  // collocated_from_l0_flag names
  bool tmvp(int x0, int y0, int w, int h, int ref_idx, int X, Mv& out) {
    if (!col_pic || col_pic->missing) return false;
    auto col = [&](int x, int y) -> bool {
      x &= ~15;
      y &= ~15;
      const MvField& f = col_pic->mvf[at4(x, y)];
      if (f.pred == PF_INTRA) return false;
      int l;
      if (!(f.pred & PF_L0)) {
        l = 1;
      } else if (f.pred == PF_L0) {
        l = 0;
      } else {
        bool backward = false;
        for (int j = 0; j < 2; j++)
          for (int poc : ref_poc.l[j]) backward |= poc > cur->poc;
        l = !backward ? X : sh.collocated_from_l0 ? 1 : 0;
      }
      int si = col_pic->ctb_slice[(size_t)ctb_of(x, y)];
      if (si < 0 || si >= (int)col_pic->slice_refs.size()) return false;
      const std::vector<int>& refs = col_pic->slice_refs[(size_t)si].l[l];
      if (f.ref[l] < 0 || f.ref[l] >= (int)refs.size()) return false;
      int col_diff = col_pic->poc - refs[(size_t)f.ref[l]];
      int cur_diff = cur->poc - ref_poc.l[X][(size_t)ref_idx];
      if (col_diff == cur_diff || !col_diff)
        out = f.mv[l];
      else {
        out = scale_mv(f.mv[l], col_diff, cur_diff);
        stats[ST_SCALED_MV]++;
      }
      return true;
    };
    int xb = x0 + w, yb = y0 + h;
    if ((y0 >> log2ctb) == (yb >> log2ctb) && yb < H && xb < W && col(xb, yb)) return true;
    return col(x0 + (w >> 1), y0 + (h >> 1));
  }

  // what each merge candidate of the last list is (the counters')
  enum { MC_SPATIAL, MC_TEMPORAL, MC_COMBINED, MC_ZERO };
  int merge_kind[5] = {0, 0, 0, 0, 0};

  // the merge candidates of a prediction block (8.5.3.2.2-5, FFmpeg's
  // derive_spatial_merge_candidates)
  int merge_candidates(int xCb, int yCb, int nCbS, int xPb, int yPb, int nPbW, int nPbH, int part_idx, int part,
                       MvField* out) {
    if (ap.log2_parallel_merge > 2 && nCbS == 8) {
      xPb = xCb;
      yPb = yCb;
      nPbW = nPbH = nCbS;
      part_idx = 0;
    }
    const int pl = ap.log2_parallel_merge;
    auto ok = [&](int xn, int yn) {
      if ((xPb >> pl) == (xn >> pl) && (yPb >> pl) == (yn >> pl)) return false;
      return avail_pb(xCb, yCb, nCbS, xPb, yPb, nPbW, nPbH, part_idx, xn, yn);
    };
    auto mf = [&](int x, int y) -> const MvField& { return cur->mvf[at4(x, y)]; };
    auto same = [&](int xa, int ya, int xb, int yb) { return same_motion(mf(xa, ya), mf(xb, yb)); };
    int n = 0;
    auto add = [&](const MvField& f, int kind) {
      merge_kind[n] = kind;
      out[n++] = f;
    };
    const int xA1 = xPb - 1, yA1 = yPb + nPbH - 1, xB1 = xPb + nPbW - 1, yB1 = yPb - 1;
    const int xB0 = xPb + nPbW, yB0 = yPb - 1, xA0 = xPb - 1, yA0 = yPb + nPbH, xB2 = xPb - 1, yB2 = yPb - 1;
    bool a1 = ok(xA1, yA1) &&
              !(part_idx == 1 && (part == PART_Nx2N || part == PART_nLx2N || part == PART_nRx2N));
    if (a1) add(mf(xA1, yA1), MC_SPATIAL);
    bool b1 = ok(xB1, yB1) &&
              !(part_idx == 1 && (part == PART_2NxN || part == PART_2NxnU || part == PART_2NxnD));
    if (b1 && !(a1 && same(xA1, yA1, xB1, yB1))) add(mf(xB1, yB1), MC_SPATIAL);
    bool b0 = ok(xB0, yB0);
    if (b0 && !(b1 && same(xB1, yB1, xB0, yB0))) add(mf(xB0, yB0), MC_SPATIAL);
    bool a0 = ok(xA0, yA0);
    if (a0 && !(a1 && same(xA1, yA1, xA0, yA0))) add(mf(xA0, yA0), MC_SPATIAL);
    bool b2 = ok(xB2, yB2);
    if (b2 && !(a1 && same(xA1, yA1, xB2, yB2)) && !(b1 && same(xB1, yB1, xB2, yB2)) && n != 4)
      add(mf(xB2, yB2), MC_SPATIAL);
    const bool b = sh.type == SLICE_B;
    if (sh.temporal_mvp && n < sh.max_merge_cand) {
      MvField t;
      bool l0 = tmvp(xPb, yPb, nPbW, nPbH, 0, 0, t.mv[0]);
      bool l1 = b && tmvp(xPb, yPb, nPbW, nPbH, 0, 1, t.mv[1]);
      if (l0 || l1) {
        t.pred = (uint8_t)(l0 + 2 * l1);
        t.ref[0] = t.ref[1] = 0;
        add(t, MC_TEMPORAL);
      }
    }
    // the combined bi-predictive candidates (8.5.3.2.4)
    static const int kComb[12][2] = {{0, 1}, {1, 0}, {0, 2}, {2, 0}, {1, 2}, {2, 1},
                                     {0, 3}, {3, 0}, {1, 3}, {3, 1}, {2, 3}, {3, 2}};
    const int orig = n;
    if (b && orig > 1 && orig < sh.max_merge_cand)
      for (int c = 0; n < sh.max_merge_cand && c < orig * (orig - 1); c++) {
        const MvField &p0 = out[kComb[c][0]], &p1 = out[kComb[c][1]];
        if ((p0.pred & PF_L0) && (p1.pred & PF_L1) &&
            (ref_poc.l[0][(size_t)p0.ref[0]] != ref_poc.l[1][(size_t)p1.ref[1]] || p0.mv[0] != p1.mv[1])) {
          MvField f;
          f.pred = PF_BI;
          f.ref[0] = p0.ref[0];
          f.ref[1] = p1.ref[1];
          f.mv[0] = p0.mv[0];
          f.mv[1] = p1.mv[1];
          add(f, MC_COMBINED);
        }
      }
    const int nb_refs = b ? std::min(sh.num_ref_idx[0], sh.num_ref_idx[1]) : sh.num_ref_idx[0];
    for (int z = 0; n < sh.max_merge_cand; z++) {
      MvField f;
      f.pred = b ? PF_BI : PF_L0;
      f.ref[0] = f.ref[1] = (int8_t)(z < nb_refs ? z : 0);
      add(f, MC_ZERO);
    }
    return std::min(n, sh.max_merge_cand);
  }

  // the two motion vector predictors of list X (8.5.3.2.6-7, FFmpeg's
  // ff_hevc_luma_mv_mvp_mode): each neighbour looked up in list X, then
  // in the other list, by POC, then scaled
  void amvp(int xCb, int yCb, int nCbS, int xPb, int yPb, int nPbW, int nPbH, int part_idx, int X, int ref,
            Mv* cand) {
    auto okb = [&](int xn, int yn) { return avail_pb(xCb, yCb, nCbS, xPb, yPb, nPbW, nPbH, part_idx, xn, yn); };
    auto mf = [&](int x, int y) -> const MvField& { return cur->mvf[at4(x, y)]; };
    const int want_poc = ref_poc.l[X][(size_t)ref];
    const int lists[2] = {X, 1 - X};
    auto mx = [&](int x, int y, Mv& m) {
      const MvField& f = mf(x, y);
      for (int l : lists)
        if ((f.pred >> l & 1) && ref_poc.l[l][(size_t)f.ref[l]] == want_poc) {
          m = f.mv[l];
          return true;
        }
      return false;
    };
    auto mx_scaled = [&](int x, int y, Mv& m) {
      const MvField& f = mf(x, y);
      for (int l : lists) {
        if (!(f.pred >> l & 1)) continue;
        m = f.mv[l];
        int rp = ref_poc.l[l][(size_t)f.ref[l]];
        if (rp != want_poc) {
          int d = cur->poc - rp;
          m = scale_mv(m, d ? d : 1, cur->poc - want_poc);
          stats[ST_SCALED_MV]++;
        }
        return true;
      }
      return false;
    };
    const int xA0 = xPb - 1, yA0 = yPb + nPbH, xA1 = xPb - 1, yA1 = yPb + nPbH - 1;
    bool a0 = okb(xA0, yA0), a1 = okb(xA1, yA1);
    bool scaled = a0 || a1;
    Mv mA, mB;
    bool fa = false, fb = false;
    if (a0) fa = mx(xA0, yA0, mA);
    if (a1 && !fa) fa = mx(xA1, yA1, mA);
    if (a0 && !fa) fa = mx_scaled(xA0, yA0, mA);
    if (a1 && !fa) fa = mx_scaled(xA1, yA1, mA);
    const int xB0 = xPb + nPbW, yB0 = yPb - 1, xB1 = xPb + nPbW - 1, yB1 = yPb - 1, xB2 = xPb - 1, yB2 = yPb - 1;
    bool b0 = okb(xB0, yB0), b1 = okb(xB1, yB1), b2 = okb(xB2, yB2);
    if (b0) fb = mx(xB0, yB0, mB);
    if (b1 && !fb) fb = mx(xB1, yB1, mB);
    if (b2 && !fb) fb = mx(xB2, yB2, mB);
    if (!scaled) {
      if (fb) {
        fa = true;
        mA = mB;
      }
      fb = false;
      if (b0) fb = mx_scaled(xB0, yB0, mB);
      if (b1 && !fb) fb = mx_scaled(xB1, yB1, mB);
      if (b2 && !fb) fb = mx_scaled(xB2, yB2, mB);
    }
    int n = 0;
    cand[0] = cand[1] = Mv();
    if (fa) cand[n++] = mA;
    if (fb && (!fa || mA != mB)) cand[n++] = mB;
    if (n < 2 && sh.temporal_mvp) {
      Mv m;
      if (tmvp(xPb, yPb, nPbW, nPbH, ref, X, m)) {
        cand[n++] = m;
        stats[ST_TMVP]++;
        if (X) stats[ST_TMVP_L1]++;
      }
    }
  }

  template <class E>
  int mvd_component(E& e, int gt0, int gt1, int want) {
    if (!gt0) return 0;
    int a = 1;
    if (gt1) {
      int v = std::abs(want) - 2, k = 1, r = 2;
      while (e.byp(E::W ? v >= (1 << k) : 0)) {
        if (E::W) v -= 1 << k;
        r += 1 << k;
        if (++k > 30) fail("corrupt H.265 data: abs_mvd_minus2 too long");
      }
      r += fl_bypass(e, k, v);
      a = r;
    }
    return e.byp(want < 0) ? -a : a;
  }

  template <class E>
  void prediction_unit(E& e, int xCb, int yCb, int nCbS, int xPb, int yPb, int w, int h, int part_idx) {
    PuChoice pc;
    MvField mc[5];
    if (E::W) {
      int nmc = merge_candidates(xCb, yCb, nCbS, xPb, yPb, w, h, part_idx, cu_part, mc);
      pol->pu(xPb, yPb, w, h, part_idx, mc, nmc, pc);
    }
    MvField f;
    int merge = cu_skip ? 1 : e.bin(C_MERGE_FLAG, pc.merge);
    if (merge) {
      int idx = 0;
      if (sh.max_merge_cand > 1 && e.bin(C_MERGE_IDX, pc.merge_idx > 0)) {
        idx = 1;
        while (idx < sh.max_merge_cand - 1 && e.byp(pc.merge_idx > idx)) idx++;
      }
      int n = merge_candidates(xCb, yCb, nCbS, xPb, yPb, w, h, part_idx, cu_part, mc);
      if (idx >= n) fail("corrupt H.265 data: merge_idx %d", idx);
      f = mc[idx];
      if (merge_kind[idx] == MC_TEMPORAL) {
        stats[ST_TMVP]++;
        if (f.pred & PF_L1) stats[ST_TMVP_L1]++;
      } else if (merge_kind[idx] == MC_COMBINED) {
        stats[ST_COMBINED_BI]++;
      } else if (merge_kind[idx] == MC_ZERO && sh.type == SLICE_B) {
        stats[ST_ZERO_MERGE_B]++;
      }
      // an 8x4 or 4x8 block is not bi-predicted
      if (f.pred == PF_BI && w + h == 12) {
        f.pred = PF_L0;
        stats[ST_BI_TO_L0]++;
      }
      if (part_idx == 0) cu_merge2nx2n = 1;
      stats[ST_MERGE]++;
      if (ap.log2_parallel_merge > 2) stats[ST_MERGE_LEVEL]++;
    } else {
      int pred = PF_L0;
      if (sh.type == SLICE_B) {  // inter_pred_idc
        int idc;
        if (w + h == 12)
          idc = e.bin(C_INTER_PRED + 4, pc.inter_pred == 1);
        else if (e.bin(C_INTER_PRED + cu_depth, pc.inter_pred == 2))
          idc = 2;
        else
          idc = e.bin(C_INTER_PRED + 4, pc.inter_pred == 1);
        pred = idc + 1;
      }
      f.pred = (uint8_t)pred;
      for (int X = 0; X < 2; X++) {
        if (!(pred >> X & 1)) continue;
        int ref = 0, cmax = sh.num_ref_idx[X] - 1;
        while (ref < cmax) {
          int b = ref < 2 ? e.bin(C_REF_IDX + ref, pc.ref_idx[X] > ref) : e.byp(pc.ref_idx[X] > ref);
          if (!b) break;
          ref++;
        }
        Mv cand[2];
        amvp(xCb, yCb, nCbS, xPb, yPb, w, h, part_idx, X, ref, cand);
        int dx = 0, dy = 0;
        if (X == 1 && sh.mvd_l1_zero && pred == PF_BI) {
          stats[ST_MVD_L1_ZERO]++;
        } else {
          Mv want = pc.mvd[X];
          if (E::W && pc.use_target[X])
            want = {(int16_t)(pc.target[X].x - cand[pc.mvp[X]].x), (int16_t)(pc.target[X].y - cand[pc.mvp[X]].y)};
          int gx = e.bin(C_MVD_GT0, want.x != 0), gy = e.bin(C_MVD_GT0, want.y != 0);
          int g1x = gx ? e.bin(C_MVD_GT1, std::abs(want.x) > 1) : 0;
          int g1y = gy ? e.bin(C_MVD_GT1, std::abs(want.y) > 1) : 0;
          dx = mvd_component(e, gx, g1x, want.x);
          dy = mvd_component(e, gy, g1y, want.y);
        }
        int mvp = e.bin(C_MVP_FLAG, pc.mvp[X]);
        f.mv[X].x = (int16_t)(uint16_t)(cand[mvp].x + dx);
        f.mv[X].y = (int16_t)(uint16_t)(cand[mvp].y + dy);
        f.ref[X] = (int8_t)ref;
      }
      stats[ST_AMVP]++;
    }
    if (f.pred == PF_BI)
      stats[ST_BI_PUS]++;
    else if (f.pred == PF_L1)
      stats[ST_L1_PUS]++;
    bool explicit_weights = false;
    for (int X = 0; X < 2; X++) {
      if (!(f.pred >> X & 1)) continue;
      if (f.ref[X] > 0) stats[ST_MULTI_REF]++;
      if (f.ref[X] < 0 || f.ref[X] >= (int)ref_list[X].size() || !ref_list[X][(size_t)f.ref[X]])
        fail("corrupt H.265 data: a reference index past the reference list");
      explicit_weights |= weighted && (sh.luma_w_flag[X][f.ref[X]] || sh.chroma_w_flag[X][f.ref[X]]);
    }
    if (explicit_weights) stats[ST_WEIGHTED_PUS]++;
    for (int y = yPb; y < yPb + h; y += 4)
      for (int x = xPb; x < xPb + w; x += 4) cur->mvf[at4(x, y)] = f;
    predict_inter(xPb, yPb, w, h, f);
  }

  // ---------------------------------------------------------------- inter prediction

  // 8.5.3.3.3, FFmpeg's put_hevc_qpel / put_hevc_epel: the 14-bit
  // intermediate of a w x h block of component c (luma 8-tap at quarter
  // samples, chroma 4-tap at eighth samples), references clamped at the
  // picture's edges
  void mc_block(const Picture* ref, int c, Mv mv, int x0, int y0, int w, int h, int16_t* out) const {
    const int taps = c ? 4 : 8, before = c ? 1 : 3, fbits = c ? 3 : 2;
    const int pw = c ? W / 2 : W, ph = c ? H / 2 : H;
    const int fx = mv.x & ((1 << fbits) - 1), fy = mv.y & ((1 << fbits) - 1);
    const int bx = x0 + (mv.x >> fbits), by = y0 + (mv.y >> fbits);
    const uint8_t* src = c == 0 ? ref->y.data() : c == 1 ? ref->u.data() : ref->v.data();
    const int8_t* cx = c ? kChromaFilter[fx] : kLumaFilter[fx];
    const int8_t* cy = c ? kChromaFilter[fy] : kLumaFilter[fy];
    auto at = [&](int x, int y) { return (int)src[(size_t)clip3(0, ph - 1, y) * pw + clip3(0, pw - 1, x)]; };
    int tmp[(64 + 7) * 64];
    for (int y = -before; y < h + taps - before - 1; y++)
      for (int x = 0; x < w; x++) {
        int s = 0;
        if (fx) {
          for (int i = 0; i < taps; i++) s += cx[i] * at(bx + x + i - before, by + y);
        } else {
          s = at(bx + x, by + y) << 6;
        }
        tmp[(size_t)(y + before) * w + x] = s;
      }
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++) {
        int v;
        if (fy) {
          int s = 0;
          if (fx) {
            for (int i = 0; i < taps; i++) s += cy[i] * tmp[(size_t)(y + i) * w + x];
            v = s >> 6;
          } else {
            for (int i = 0; i < taps; i++) s += cy[i] * at(bx + x, by + y + i - before);
            v = s;
          }
        } else {
          v = tmp[(size_t)(y + before) * w + x];
        }
        out[(size_t)y * w + x] = (int16_t)v;
      }
  }

  // the prediction of a block from its one or two lists: the default
  // weighting (FFmpeg's *_uni, *_bi), or under weighted_pred_flag /
  // weighted_bipred_flag the explicit one (*_uni_w, *_bi_w)
  void predict_inter(int xPb, int yPb, int w, int h, const MvField& f) {
    int16_t a[64 * 64], b[64 * 64];
    const bool bi = f.pred == PF_BI;
    const int la = f.pred == PF_L1 ? 1 : 0;
    const int ra = f.ref[la], rb = bi ? f.ref[1] : 0;
    for (int c = 0; c < 3; c++) {
      const int sx = c ? 1 : 0, pw = W >> sx, x0 = xPb >> sx, y0 = yPb >> sx, bw = w >> sx, bh = h >> sx;
      mc_block(ref_list[la][(size_t)ra], c, f.mv[la], x0, y0, bw, bh, a);
      if (bi) mc_block(ref_list[1][(size_t)rb], c, f.mv[1], x0, y0, bw, bh, b);
      uint8_t* dst = (c == 0 ? cur->y.data() : c == 1 ? cur->u.data() : cur->v.data()) + (size_t)y0 * pw + x0;
      const int denom = c ? sh.chroma_denom : sh.luma_denom;
      const int w0 = c ? sh.cw[la][ra][c - 1] : sh.lw[la][ra], o0 = c ? sh.co[la][ra][c - 1] : sh.lo[la][ra];
      const int w1 = c ? sh.cw[1][rb][c - 1] : sh.lw[1][rb], o1 = c ? sh.co[1][rb][c - 1] : sh.lo[1][rb];
      for (int y = 0; y < bh; y++)
        for (int x = 0; x < bw; x++) {
          const int k = y * bw + x, p = a[k];
          int v;
          if (!bi)
            v = weighted ? ((p * w0 + (1 << (denom + 5))) >> (denom + 6)) + o0 : (p + 32) >> 6;
          else if (!weighted)
            v = (p + b[k] + 64) >> 7;
          else
            v = (b[k] * w1 + p * w0 + (o0 + o1 + 1) * (1 << (denom + 6))) >> (denom + 7);
          dst[(size_t)y * pw + x] = clip1(v);
        }
    }
  }

  // ---------------------------------------------------------------- intra prediction

  // 8.4.4.2: the prediction of a transform block of component c at (x0, y0)
  // in the component's samples, size n, mode
  void predict_intra(int c, int x0, int y0, int n, int mode) {
    const int stride = c ? W / 2 : W;
    uint8_t* plane = c == 0 ? cur->y.data() : c == 1 ? cur->u.data() : cur->v.data();
    // FFmpeg's intra_pred: availability by segment (left, bottom-left,
    // corner, top, top-right), and under constrained intra prediction its
    // own flags by every second prediction unit and its substitution over
    // 4-sample units
    const int hs = c ? 1 : 0, nl = n << hs, xl = x0 << hs, yl = y0 << hs;
    int cand_left = avail(xl, yl, xl - 1, yl), cand_up = avail(xl, yl, xl, yl - 1);
    int cand_up_left = avail(xl, yl, xl - 1, yl - 1), cand_up_right = avail(xl, yl, xl + nl, yl - 1);
    int cand_bottom_left = avail(xl, yl, xl - 1, yl + nl);
    const int bl_size = (clip3(0, H, yl + 2 * nl) - (yl + nl)) >> hs;
    const int tr_size = (clip3(0, W, xl + 2 * nl) - (xl + nl)) >> hs;
    const int pu_log2 = as.log2_min_cb - 1, min_pu_w = W >> pu_log2, min_pu_h = H >> pu_log2;
    auto intra_pu = [&](int px, int py) {
      px = clip3(0, min_pu_w - 1, px);
      py = clip3(0, min_pu_h - 1, py);
      return (int)intra4[at4(px << pu_log2, py << pu_log2)];
    };
    auto IS_INTRA = [&](int x, int y) { return intra_pu((xl + x * (1 << hs)) >> pu_log2, (yl + y * (1 << hs)) >> pu_log2); };
    int left_arr[2 * 64 + 8], top_arr[2 * 64 + 8];
    int* left = left_arr + 1;
    int* top = top_arr + 1;
    auto POS = [&](int x, int y) { return (int)plane[(size_t)(y0 + y) * stride + x0 + x]; };
    auto EXTEND = [&](int* ptr, int val, int len) {
      for (int k = 0; k < len; k += 4)
        for (int q = 0; q < 4; q++) ptr[k + q] = val;
    };
    if (ap.constrained_intra) {
      int pu_v = nl >> pu_log2, pu_h = nl >> pu_log2;
      int edge_x = !(xl & ((1 << pu_log2) - 1)), edge_y = !(yl & ((1 << pu_log2) - 1));
      if (!pu_h) pu_h++;
      if (cand_bottom_left && edge_x) {
        int xp = (xl - 1) >> pu_log2, yp = (yl + nl) >> pu_log2, mx = std::min(pu_v, min_pu_h - yp);
        cand_bottom_left = 0;
        for (int k = 0; k < mx; k += 2) cand_bottom_left |= intra_pu(xp, yp + k);
      }
      if (cand_left && edge_x) {
        int xp = (xl - 1) >> pu_log2, yp = yl >> pu_log2, mx = std::min(pu_v, min_pu_h - yp);
        cand_left = 0;
        for (int k = 0; k < mx; k += 2) cand_left |= intra_pu(xp, yp + k);
      }
      if (cand_up_left) cand_up_left = intra_pu((xl - 1) >> pu_log2, (yl - 1) >> pu_log2);
      if (cand_up && edge_y) {
        int xp = xl >> pu_log2, yp = (yl - 1) >> pu_log2, mx = std::min(pu_h, min_pu_w - xp);
        cand_up = 0;
        for (int k = 0; k < mx; k += 2) cand_up |= intra_pu(xp + k, yp);
      }
      if (cand_up_right && edge_y) {
        int yp = (yl - 1) >> pu_log2, xp = (xl + nl) >> pu_log2, mx = std::min(pu_h, min_pu_w - xp);
        cand_up_right = 0;
        for (int k = 0; k < mx; k += 2) cand_up_right |= intra_pu(xp + k, yp);
      }
      for (int k = 0; k < 2 * 64; k++) left[k] = top[k] = 128;
      top[-1] = 128;
      stats[ST_CIP_BLOCKS]++;
    }
    if (cand_bottom_left) {
      int k = n;
      for (; k < n + bl_size; k++) left[k] = POS(-1, k);
      for (; k < 2 * n; k++) left[k] = POS(-1, n + bl_size - 1);
    }
    if (cand_left)
      for (int k = n - 1; k >= 0; k--) left[k] = POS(-1, k);
    if (cand_up_left) {
      left[-1] = POS(-1, -1);
      top[-1] = left[-1];
    }
    if (cand_up)
      for (int k = 0; k < n; k++) top[k] = POS(k, -1);
    if (cand_up_right) {
      for (int k = n; k < n + tr_size; k++) top[k] = POS(k, -1);
      EXTEND(top + n + tr_size, POS(n + tr_size - 1, -1), n - tr_size);
    }
    if (ap.constrained_intra && (cand_bottom_left || cand_left || cand_up_left || cand_up || cand_up_right)) {
      int a = 0;
      int size_max_x = xl + ((2 * n) << hs) < W ? 2 * n : (W - xl) >> hs;
      int size_max_y = yl + ((2 * n) << hs) < H ? 2 * n : (H - yl) >> hs;
      int j = n + (cand_bottom_left ? bl_size : 0) - 1;
      if (!cand_up_right) size_max_x = xl + (n << hs) < W ? n : (W - xl) >> hs;
      if (!cand_bottom_left) size_max_y = yl + (n << hs) < H ? n : (H - yl) >> hs;
      auto extend_left_cip = [&](int* ptr, int start, int length) {
        for (int k = start; k > start - length; k--)
          if (!IS_INTRA(k - 1, -1)) ptr[k - 1] = ptr[k];
      };
      auto extend_right_cip = [&](int* ptr, int start, int length) {
        for (int k = start; k < start + length; k += 4)
          if (!IS_INTRA(k, -1))
            for (int q = 0; q < 4; q++) ptr[k + q] = a;
          else
            a = ptr[k + 3];
      };
      auto extend_up_cip = [&](int* ptr, int start, int length) {
        for (int k = start; k > start - length; k -= 4)
          if (!IS_INTRA(-1, k - 3))
            for (int q = 0; q < 4; q++) ptr[k - 3 + q] = a;
          else
            a = ptr[k - 3];
      };
      auto extend_down_cip = [&](int* ptr, int start, int length) {
        for (int k = start; k < start + length; k += 4)
          if (!IS_INTRA(-1, k))
            for (int q = 0; q < 4; q++) ptr[k + q] = a;
          else
            a = ptr[k + 3];
      };
      if (cand_bottom_left || cand_left || cand_up_left) {
        while (j > -1 && !IS_INTRA(-1, j)) j--;
        if (!IS_INTRA(-1, j)) {
          j = 0;
          while (j < size_max_x && !IS_INTRA(j, -1)) j++;
          extend_left_cip(top, j, j + 1);
          left[-1] = top[-1];
        }
      } else {
        j = 0;
        while (j < size_max_x && !IS_INTRA(j, -1)) j++;
        if (j > 0) {
          if (xl > 0) {
            extend_left_cip(top, j, j + 1);
          } else {
            extend_left_cip(top, j, j);
            top[-1] = top[0];
          }
        }
        left[-1] = top[-1];
      }
      left[-1] = top[-1];
      if (cand_bottom_left || cand_left) {
        a = left[-1];
        extend_down_cip(left, 0, size_max_y);
      }
      if (!cand_left) EXTEND(left, left[-1], n);
      if (!cand_bottom_left) EXTEND(left + n, left[n - 1], n);
      if (xl != 0 && yl != 0) {
        a = left[size_max_y - 1];
        extend_up_cip(left, size_max_y - 1, size_max_y);
        if (!IS_INTRA(-1, -1)) left[-1] = left[0];
      } else if (xl == 0) {
        EXTEND(left, 0, size_max_y);
      } else {
        a = left[size_max_y - 1];
        extend_up_cip(left, size_max_y - 1, size_max_y);
      }
      top[-1] = left[-1];
      if (yl != 0) {
        a = left[-1];
        extend_right_cip(top, 0, size_max_x);
      }
    }
    // the unavailable samples (FFmpeg's order)
    if (!cand_bottom_left) {
      if (cand_left) {
        EXTEND(left + n, left[n - 1], n);
      } else if (cand_up_left) {
        EXTEND(left, left[-1], 2 * n);
        cand_left = 1;
      } else if (cand_up) {
        left[-1] = top[0];
        EXTEND(left, left[-1], 2 * n);
        cand_up_left = 1;
        cand_left = 1;
      } else if (cand_up_right) {
        EXTEND(top, top[n], n);
        left[-1] = top[n];
        EXTEND(left, left[-1], 2 * n);
        cand_up = 1;
        cand_up_left = 1;
        cand_left = 1;
      } else {
        left[-1] = 128;
        EXTEND(top, left[-1], 2 * n);
        EXTEND(left, left[-1], 2 * n);
      }
    }
    if (!cand_left) EXTEND(left, left[n], n);
    if (!cand_up_left) left[-1] = left[0];
    if (!cand_up) EXTEND(top, left[-1], n);
    if (!cand_up_right) EXTEND(top + n, top[n - 1], n);
    top[-1] = left[-1];
    // into the layout below: 0 is p[-1][2n-1] ... 2n-1 is p[-1][0], 2n is
    // p[-1][-1], 2n+1+k is p[k][-1]
    int ref[4 * 64 + 1];
    const int total = 4 * n + 1;
    for (int k = 0; k < 2 * n; k++) {
      ref[2 * n - 1 - k] = left[k];
      ref[2 * n + 1 + k] = top[k];
    }
    ref[2 * n] = left[-1];
    auto L = [&](int y) -> int& { return ref[2 * n - 1 - y]; };  // p[-1][y], y = -1..2n-1
    auto T = [&](int x) -> int& { return ref[2 * n + 1 + x]; };  // p[x][-1], x = -1..2n-1
    // filtering (8.4.4.2.3), luma only
    if (c == 0 && mode != 1 && n != 4) {
      int dist = std::min(std::abs(mode - 26), std::abs(mode - 10));
      int thres = n == 8 ? 7 : n == 16 ? 1 : 0;
      if (dist > thres) {
        int f[4 * 64 + 1];
        int corner = L(-1);
        bool strong = as.strong_intra_smoothing && n == 32 &&
                      std::abs(corner + T(2 * n - 1) - 2 * T(n - 1)) < 8 &&
                      std::abs(corner + L(2 * n - 1) - 2 * L(n - 1)) < 8;
        if (strong) {
          stats[ST_STRONG_SMOOTHING]++;
          int bl = L(63), tr = T(63);
          for (int y = 0; y < 63; y++) f[2 * n - 1 - y] = ((63 - y) * corner + (y + 1) * bl + 32) >> 6;
          f[0] = bl;
          f[2 * n] = corner;
          for (int x = 0; x < 63; x++) f[2 * n + 1 + x] = ((63 - x) * corner + (x + 1) * tr + 32) >> 6;
          f[2 * n + 1 + 63] = tr;
        } else {
          f[0] = ref[0];
          f[total - 1] = ref[total - 1];
          for (int k = 1; k < total - 1; k++) f[k] = (ref[k - 1] + 2 * ref[k] + ref[k + 1] + 2) >> 2;
        }
        std::memcpy(ref, f, sizeof(int) * (size_t)total);
      }
    }
    uint8_t* out = plane + (size_t)y0 * stride + x0;
    int log2n = 0;
    while ((1 << log2n) < n) log2n++;
    if (mode == 0) {  // planar
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++)
          out[(size_t)y * stride + x] = (uint8_t)(((n - 1 - x) * L(y) + (x + 1) * T(n) + (n - 1 - y) * T(x) +
                                                   (y + 1) * L(n) + n) >> (log2n + 1));
    } else if (mode == 1) {  // DC
      int sum = n;
      for (int k = 0; k < n; k++) sum += T(k) + L(k);
      int dc = sum >> (log2n + 1);
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) out[(size_t)y * stride + x] = (uint8_t)dc;
      if (c == 0 && n < 32) {
        out[0] = (uint8_t)((L(0) + 2 * dc + T(0) + 2) >> 2);
        for (int x = 1; x < n; x++) out[x] = (uint8_t)((T(x) + 3 * dc + 2) >> 2);
        for (int y = 1; y < n; y++) out[(size_t)y * stride] = (uint8_t)((L(y) + 3 * dc + 2) >> 2);
      }
    } else {  // angular
      int angle = kIntraAngle[mode];
      int a[3 * 64 + 1];
      int* r = a + 64;  // r[-n..2n]
      bool vert = mode >= 18;
      auto main_ = [&](int k) { return vert ? T(k) : L(k); };   // k = -1..2n-1
      auto side = [&](int k) { return vert ? L(k) : T(k); };
      for (int x = 0; x <= n; x++) r[x] = main_(x - 1);
      if (angle < 0) {
        if ((n * angle) >> 5 < -1) {
          int inv = kInvAngle[mode - 11];
          for (int x = (n * angle) >> 5; x <= -1; x++) r[x] = side(-1 + ((x * inv + 128) >> 8));
        }
      } else {
        for (int x = n + 1; x <= 2 * n; x++) r[x] = main_(x - 1);
      }
      for (int y = 0; y < n; y++) {
        int idx = ((y + 1) * angle) >> 5, fact = ((y + 1) * angle) & 31;
        for (int x = 0; x < n; x++) {
          int v = fact ? ((32 - fact) * r[x + idx + 1] + fact * r[x + idx + 2] + 16) >> 5 : r[x + idx + 1];
          if (vert)
            out[(size_t)y * stride + x] = (uint8_t)v;
          else
            out[(size_t)x * stride + y] = (uint8_t)v;
        }
      }
      if (c == 0 && n < 32) {
        if (mode == 26)
          for (int y = 0; y < n; y++) out[(size_t)y * stride] = clip1(T(0) + ((L(y) - L(-1)) >> 1));
        if (mode == 10)
          for (int x = 0; x < n; x++) out[x] = clip1(L(0) + ((T(x) - T(-1)) >> 1));
      }
    }
  }

  // ---------------------------------------------------------------- transform tree

  template <class E>
  void transform_tree(E& e, int x0, int y0, int xBase, int yBase, int xCb, int yCb, int log2, int depth,
                      int blk, const int* base_cbf) {
    int cbf[2] = {base_cbf[0], base_cbf[1]};
    if (intra_split) {
      if (depth == 1) tu_luma_mode = pu_luma_mode[blk];
    } else {
      tu_luma_mode = pu_luma_mode[0];
    }
    int split;
    if (log2 <= as.log2_min_tb + as.log2_diff_max_min_tb && log2 > as.log2_min_tb && depth < max_trafo_depth &&
        !(intra_split && depth == 0)) {
      split = e.bin(C_SPLIT_TRANSFORM + 5 - log2, E::W ? pol->split_tu(x0, y0, log2, depth, cu_intra) : 0);
    } else {
      int inter_split = as.max_th_depth_inter == 0 && !cu_intra && cu_part != PART_2Nx2N && depth == 0;
      split = log2 > as.log2_min_tb + as.log2_diff_max_min_tb || (intra_split && depth == 0) || inter_split;
    }
    if (log2 > 2) {
      for (int c = 0; c < 2; c++)
        if (depth == 0 || cbf[c]) cbf[c] = e.bin(C_CBF_CHROMA + depth, E::W ? pol->cbf(c + 1, x0, y0, log2, depth) : 0);
    }
    if (split) {
      stats[ST_TU_SPLIT]++;
      int h = 1 << (log2 - 1);
      transform_tree(e, x0, y0, x0, y0, xCb, yCb, log2 - 1, depth + 1, 0, cbf);
      transform_tree(e, x0 + h, y0, x0, y0, xCb, yCb, log2 - 1, depth + 1, 1, cbf);
      transform_tree(e, x0, y0 + h, x0, y0, xCb, yCb, log2 - 1, depth + 1, 2, cbf);
      transform_tree(e, x0 + h, y0 + h, x0, y0, xCb, yCb, log2 - 1, depth + 1, 3, cbf);
    } else {
      int cbf_luma = 1;
      if (cu_intra || depth != 0 || cbf[0] || cbf[1])
        cbf_luma = e.bin(C_CBF_LUMA + (depth == 0 ? 1 : 0), E::W ? pol->cbf(0, x0, y0, log2, depth) : 0);
      transform_unit(e, x0, y0, xBase, yBase, xCb, yCb, log2, blk, cbf_luma, cbf);
      if (cbf_luma) fill4(cbf4, x0, y0, 1 << log2, 1 << log2, (uint8_t)1);
      if (!sh.deblocking_disabled) deblock_bs(x0, y0, log2);
      if (log2 == 2) stats[ST_TU4]++;
      if (log2 == 5) stats[ST_TU32]++;
    }
  }

  template <class E>
  void transform_unit(E& e, int x0, int y0, int xBase, int yBase, int xCb, int yCb, int log2, int blk,
                      int cbf_luma, const int* cbf) {
    const int n = 1 << log2;
    int chroma_mode = pu_chroma_mode;
    if (cu_intra) predict_intra(0, x0, y0, n, tu_luma_mode);
    int16_t coeff[32 * 32];
    if (cbf_luma || cbf[0] || cbf[1]) {
      if (ap.cu_qp_delta && !qp_delta_coded) {
        int want = E::W ? pol->qp_delta(xCb, yCb) : 0, a = std::abs(want);
        int v = 0;
        while (v < 5 && e.bin(C_QP_DELTA + (v ? 1 : 0), v < a)) v++;
        if (v == 5) {  // EG0 suffix
          int rest = a - 5, k = 0, r = 0;
          while (e.byp(E::W ? rest >= (1 << k) : 0)) {
            if (E::W) rest -= 1 << k;
            r += 1 << k;
            if (++k > 30) fail("corrupt H.265 data: cu_qp_delta_abs too long");
          }
          r += fl_bypass(e, k, rest);
          v += r;
        }
        cu_qp_delta = v && e.byp(want < 0) ? -v : v;
        qp_delta_coded = 1;
        if (cu_qp_delta < -26 || cu_qp_delta > 25) fail("corrupt H.265 data: cu_qp_delta %d", cu_qp_delta);
        if (cu_qp_delta) stats[ST_QP_DELTA]++;
        set_qpy(xCb, yCb);
      }
      int scan = 0, scan_c = 0;
      if (cu_intra && log2 < 4) {
        int m = tu_luma_mode;
        scan = m >= 6 && m <= 14 ? 2 : m >= 22 && m <= 30 ? 1 : 0;
        scan_c = chroma_mode >= 6 && chroma_mode <= 14 ? 2 : chroma_mode >= 22 && chroma_mode <= 30 ? 1 : 0;
      }
      if (cbf_luma) {
        residual_coding(e, x0, y0, log2, 0, scan, coeff);
      }
      if (log2 > 2) {
        for (int c = 1; c <= 2; c++) {
          if (cu_intra) predict_intra(c, x0 / 2, y0 / 2, n / 2, chroma_mode);
          if (cbf[c - 1]) residual_coding(e, x0, y0, log2 - 1, c, scan_c, coeff);
        }
      } else if (blk == 3) {
        for (int c = 1; c <= 2; c++) {
          if (cu_intra) predict_intra(c, xBase / 2, yBase / 2, 4, chroma_mode);
          if (cbf[c - 1]) residual_coding(e, xBase, yBase, 2, c, scan_c, coeff);
        }
      }
    } else if (cu_intra) {
      if (log2 > 2) {
        predict_intra(1, x0 / 2, y0 / 2, n / 2, chroma_mode);
        predict_intra(2, x0 / 2, y0 / 2, n / 2, chroma_mode);
      } else if (blk == 3) {
        predict_intra(1, xBase / 2, yBase / 2, 4, chroma_mode);
        predict_intra(2, xBase / 2, yBase / 2, 4, chroma_mode);
      }
    }
  }

  // residual_coding (7.3.8.11) and the block's reconstruction: (x0, y0) in
  // luma samples, log2 the block's size in the component's samples
  template <class E>
  void residual_coding(E& e, int x0, int y0, int log2, int c, int scan, int16_t* coeff) {
    const int n = 1 << log2;
    int16_t want[32 * 32];
    int ts_want = 0;
    if (E::W) {
      pol->residual(c, x0, y0, log2, want);
      bool any = false;
      for (int i = 0; i < n * n; i++) any |= want[i] != 0;
      if (!any) want[0] = 1;
      if (ap.transform_skip && log2 == 2) ts_want = pol->transform_skip(c, x0, y0);
    }
    int ts = 0;
    if (ap.transform_skip && log2 == 2) ts = e.bin(C_TRANSFORM_SKIP + (c ? 1 : 0), ts_want);
    if (ts) stats[ST_TRANSFORM_SKIP]++;
    // the last significant position
    int lastx = 0, lasty = 0;
    const int nsb = 1 << (log2 - 2);
    const int log2sb = log2 - 2;
    if (E::W) {
      // the last non-zero coefficient in scan order
      for (int i = nsb * nsb - 1; i >= 0 && !(lastx | lasty); i--) {
        int xs = kScan.pos[log2sb][scan][i][0], ys = kScan.pos[log2sb][scan][i][1];
        for (int k = 15; k >= 0; k--) {
          int xc = (xs << 2) + kScan.pos[2][scan][k][0], yc = (ys << 2) + kScan.pos[2][scan][k][1];
          if (want[yc * n + xc]) {
            lastx = xc;
            lasty = yc;
            i = -1;
            break;
          }
        }
      }
      if (scan == 2) std::swap(lastx, lasty);
    }
    int off, shift;
    if (!c) {
      off = 3 * (log2 - 2) + ((log2 - 1) >> 2);
      shift = (log2 + 1) >> 2;
    } else {
      off = 15;
      shift = log2 - 2;
    }
    const int cmax = (log2 << 1) - 1;
    auto prefix_of = [](int v) {
      if (v < 4) return v;
      int p = 4;
      while (true) {
        int base = (1 << ((p >> 1) - 1)) * (2 + (p & 1));
        int next = (1 << (((p + 1) >> 1) - 1)) * (2 + ((p + 1) & 1));
        if (v < next || p == 9) return v >= base ? p : p - 1;
        p++;
      }
    };
    int px = prefix_of(lastx), py = prefix_of(lasty);
    int vx = 0, vy = 0;
    while (vx < cmax && e.bin(C_LAST_X + off + (vx >> shift), vx < px)) vx++;
    while (vy < cmax && e.bin(C_LAST_Y + off + (vy >> shift), vy < py)) vy++;
    auto suffix = [&](int p, int want_v) {
      if (p <= 3) return p;
      int bits = (p >> 1) - 1, base = (1 << bits) * (2 + (p & 1));
      return base + fl_bypass(e, bits, want_v - base);
    };
    lastx = suffix(vx, lastx);
    lasty = suffix(vy, lasty);
    if (scan == 2) std::swap(lastx, lasty);
    if (lastx >= n || lasty >= n) fail("corrupt H.265 data: last significant coefficient outside the block");
    // the subblock and position of the last coefficient
    int last_sb = nsb * nsb - 1, last_pos = 16;
    for (;;) {
      if (last_pos == 0) {
        last_pos = 16;
        last_sb--;
        if (last_sb < 0) fail("corrupt H.265 data: no last coefficient");
      }
      last_pos--;
      int xs = kScan.pos[log2sb][scan][last_sb][0], ys = kScan.pos[log2sb][scan][last_sb][1];
      int xc = (xs << 2) + kScan.pos[2][scan][last_pos][0], yc = (ys << 2) + kScan.pos[2][scan][last_pos][1];
      if (xc == lastx && yc == lasty) break;
    }
    std::memset(coeff, 0, sizeof(int16_t) * (size_t)n * n);
    uint8_t csbf[8][8];
    std::memset(csbf, 0, sizeof csbf);
    int greater1_ctx = 1;  // carried from subblock to subblock
    bool first_sb = true;
    // dequantisation
    int qp;
    if (!c) {
      qp = qp_y;
    } else {
      int o = c == 1 ? ap.cb_qp_offset + sh.cb_qp_offset : ap.cr_qp_offset + sh.cr_qp_offset;
      int qpi = clip3(0, 57, qp_y + o);
      qp = qpi < 30 ? qpi : qpi > 43 ? qpi - 6 : kQpC[qpi - 30];
    }
    const int dq_shift = 8 + log2 - 5;
    const int64_t dq_add = (int64_t)1 << (dq_shift - 1);
    const int64_t dq_scale = (int64_t)kLevelScale[qp % 6] << (qp / 6);
    const uint8_t* matrix = nullptr;
    int dc_scale = 16;
    bool use_matrix = as.scaling_list_enabled && !(ts && log2 > 2);
    if (use_matrix) {
      const ScalingList& sl = ap.scaling_list_data_present ? ap.sl : as.sl;
      int mid = (cu_intra ? 0 : 3) + c;
      matrix = sl.list[log2 - 2][mid];
      dc_scale = log2 >= 4 ? sl.dc[log2 - 2][mid] : 16;
    }
    for (int i = last_sb; i >= 0; i--) {
      const int xs = kScan.pos[log2sb][scan][i][0], ys = kScan.pos[log2sb][scan][i][1];
      bool infer_dc = false;
      int coded;
      int sb_want = 0;
      if (E::W)
        for (int k = 0; k < 16; k++)
          sb_want |= want[((ys << 2) + kScan.pos[2][scan][k][1]) * n + (xs << 2) + kScan.pos[2][scan][k][0]] != 0;
      if (i < last_sb && i > 0) {
        int r = xs + 1 < nsb ? csbf[xs + 1][ys] : 0, b = ys + 1 < nsb ? csbf[xs][ys + 1] : 0;
        coded = e.bin(C_CSBF + std::min(r + b, 1) + (c ? 2 : 0), sb_want);
        infer_dc = true;
      } else {
        coded = 1;
      }
      csbf[xs][ys] = (uint8_t)coded;
      int nsig = 0;
      int pos[16];  // significant positions, in scan order from high to low
      for (int k = (i == last_sb ? last_pos - 1 : 15); k >= 0; k--) {
        int xc = (xs << 2) + kScan.pos[2][scan][k][0], yc = (ys << 2) + kScan.pos[2][scan][k][1];
        int s = 0;
        if (coded && (k > 0 || !infer_dc)) {
          int sig_ctx;
          if (log2 == 2) {
            static const uint8_t kMap[16] = {0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8};
            sig_ctx = kMap[(yc << 2) + xc];
          } else if (xc + yc == 0) {
            sig_ctx = 0;
          } else {
            int r = xs + 1 < nsb ? csbf[xs + 1][ys] : 0, b = ys + 1 < nsb ? csbf[xs][ys + 1] : 0;
            int prev = r + 2 * b, xp = xc & 3, yp = yc & 3;
            sig_ctx = prev == 0 ? (xp + yp == 0 ? 2 : xp + yp < 3 ? 1 : 0)
                      : prev == 1 ? (yp == 0 ? 2 : yp == 1 ? 1 : 0)
                      : prev == 2 ? (xp == 0 ? 2 : xp == 1 ? 1 : 0) : 2;
            if (!c) {
              if (xs + ys > 0) sig_ctx += 3;
              sig_ctx += log2 == 3 ? (scan == 0 ? 9 : 15) : 21;
            } else {
              sig_ctx += log2 == 3 ? 9 : 12;
            }
          }
          s = e.bin(C_SIG + (c ? 27 : 0) + sig_ctx, E::W ? want[yc * n + xc] != 0 : 0);
          if (s) infer_dc = false;
        } else if (coded && k == 0 && infer_dc) {
          s = 1;
        }
        if (s) pos[nsig++] = k;
      }
      if (i == last_sb) {  // the last coefficient itself, first in the list
        for (int k = nsig; k > 0; k--) pos[k] = pos[k - 1];
        pos[0] = last_pos;
        nsig++;
      }
      if (!nsig) continue;
      // the absolute levels
      int absw[16], negw[16];
      for (int m = 0; m < nsig; m++) {
        int k = pos[m];
        int xc = (xs << 2) + kScan.pos[2][scan][k][0], yc = (ys << 2) + kScan.pos[2][scan][k][1];
        int w = E::W ? want[yc * n + xc] : 0;
        absw[m] = std::abs(w);
        negw[m] = w < 0;
      }
      int ctx_set = (i > 0 && c == 0) ? 2 : 0;
      if (!first_sb && greater1_ctx == 0) ctx_set++;
      first_sb = false;
      greater1_ctx = 1;
      int g1[16] = {0}, first_g1 = -1;
      for (int m = 0; m < std::min(nsig, 8); m++) {
        g1[m] = e.bin(C_GT1 + (c ? 16 : 0) + (ctx_set << 2) + greater1_ctx, absw[m] > 1);
        if (g1[m]) {
          greater1_ctx = 0;
          if (first_g1 < 0) first_g1 = m;
        } else if (greater1_ctx > 0 && greater1_ctx < 3) {
          greater1_ctx++;
        }
      }
      int g2 = 0;
      if (first_g1 >= 0) g2 = e.bin(C_GT2 + (c ? 4 : 0) + ctx_set, absw[first_g1] > 2);
      bool hidden = ap.sign_hiding && pos[0] - pos[nsig - 1] > 3;
      if (hidden) stats[ST_SIGN_HIDDEN]++;
      if (E::W && hidden) {
        // the hidden sign is the parity of the sum: make the first one's sign follow it
        int sum = 0;
        for (int m = 0; m < nsig; m++) sum += absw[m];
        negw[nsig - 1] = sum & 1;
      }
      int neg[16];
      for (int m = 0; m < nsig; m++) neg[m] = (hidden && m == nsig - 1) ? 0 : e.byp(negw[m]);
      int rice = 0, sum_abs = 0;
      for (int m = 0; m < nsig; m++) {
        int base = 1 + (m < 8 ? g1[m] : 0) + (m == first_g1 ? g2 : 0);
        int level = base;
        if (base == ((m < 8) ? (m == first_g1 ? 3 : 2) : 1)) {
          int rem = absw[m] - base;
          // coeff_abs_level_remaining: FFmpeg's prefix / suffix
          int prefix = 0;
          if (E::W) {
            if ((rem >> rice) < 3) {
              prefix = rem >> rice;
            } else {
              int p = 0;
              while (rem >= (((1 << (p + 1)) + 2) << rice)) p++;
              prefix = p + 3;
            }
          }
          int pr = 0;
          while (pr < 32 && e.byp(pr < prefix)) pr++;
          if (pr == 32) fail("corrupt H.265 data: coeff_abs_level_remaining prefix too long");
          int value;
          if (pr < 3) {
            value = (pr << rice) + fl_bypass(e, rice, E::W ? rem - (pr << rice) : 0);
          } else {
            int p3 = pr - 3;
            if (p3 + rice > 22) fail("corrupt H.265 data: coeff_abs_level_remaining too large");
            int basev = ((1 << p3) + 2) << rice;
            value = basev + fl_bypass(e, p3 + rice, E::W ? rem - basev : 0);
          }
          level = base + value;
          if (level > 3 * (1 << rice)) rice = std::min(rice + 1, 4);
        }
        sum_abs += level;
        int k = pos[m];
        int xc = (xs << 2) + kScan.pos[2][scan][k][0], yc = (ys << 2) + kScan.pos[2][scan][k][1];
        int v = neg[m] ? -level : level;
        if (hidden && m == nsig - 1 && (sum_abs & 1)) v = -v;
        // scaling (8.6.2-3)
        int scale_m = 16;
        if (matrix) {
          if (xc || yc || log2 < 4) {
            int p = log2 == 2 ? (yc << 2) + xc : log2 == 3 ? (yc << 3) + xc : log2 == 4 ? ((yc >> 1) << 3) + (xc >> 1)
                                                                              : ((yc >> 2) << 3) + (xc >> 2);
            scale_m = raster_scaling(matrix, log2 == 2 ? 2 : 3, p);
          } else {
            scale_m = dc_scale;
          }
        }
        int64_t d = ((int64_t)v * dq_scale * scale_m + dq_add) >> dq_shift;
        coeff[yc * n + xc] = (int16_t)clip3(-32768, 32767, (int)std::max<int64_t>(-32768, std::min<int64_t>(32767, d)));
      }
    }
    if (matrix) stats[ST_SCALING_LISTS]++;
    // the residual
    int32_t res[32 * 32];
    if (ts) {
      for (int i = 0; i < n * n; i++) res[i] = (coeff[i] + 16) >> 5;
    } else {
      bool dst = cu_intra && c == 0 && log2 == 2;
      if (dst) stats[ST_DST]++;
      inverse_transform(coeff, res, log2, dst);
    }
    uint8_t* plane = c == 0 ? cur->y.data() : c == 1 ? cur->u.data() : cur->v.data();
    int stride = c ? W / 2 : W, xp = c ? x0 / 2 : x0, yp = c ? y0 / 2 : y0;
    for (int y = 0; y < n; y++)
      for (int x = 0; x < n; x++) {
        uint8_t& s = plane[(size_t)(yp + y) * stride + xp + x];
        s = clip1(s + res[y * n + x]);
      }
  }

  // a scaling list entry at raster position p of the 4x4 (l2 2) or 8x8
  // (l2 3) list coded in diagonal order
  static int raster_scaling(const uint8_t* list, int l2, int p) {
    int sz = 1 << l2, x = p % sz, y = p / sz;
    for (int i = 0; i < sz * sz; i++)
      if (kScan.pos[l2][0][i][0] == x && kScan.pos[l2][0][i][1] == y) return list[i];
    return 16;
  }

  // 8.6.4.2: columns then rows, the first stage clipped to 16 bits
  static void inverse_transform(const int16_t* in, int32_t* out, int log2, bool dst) {
    const int n = 1 << log2, step = 32 >> log2;
    int32_t tmp[32 * 32];
    auto m = [&](int k, int i) { return dst ? kDst4[k][i] : kDct.m[k * step][i]; };
    for (int x = 0; x < n; x++)
      for (int y = 0; y < n; y++) {
        int s = 0;
        for (int k = 0; k < n; k++) s += m(k, y) * in[k * n + x];
        tmp[y * n + x] = clip3(-32768, 32767, (s + 64) >> 7);
      }
    for (int y = 0; y < n; y++)
      for (int x = 0; x < n; x++) {
        int s = 0;
        for (int k = 0; k < n; k++) s += m(k, x) * tmp[y * n + k];
        out[y * n + x] = (s + 2048) >> 12;
      }
  }

  // ---------------------------------------------------------------- deblocking

  // FFmpeg's boundary_strength of two inter blocks: the current block `c`
  // with the current slice's lists, its neighbour `n` with those of the
  // neighbour's slice; the same reference pictures by POC, both pairings of
  // two vectors, 4 quarter samples apart
  int bs_motion(const MvField& c, const MvField& n, const RefPocs& nr) const {
    const RefPocs& cr = ref_poc;
    auto far = [](Mv a, Mv b) { return std::abs(a.x - b.x) >= 4 || std::abs(a.y - b.y) >= 4; };
    auto poc = [](const RefPocs& r, int l, int i) {
      return i >= 0 && i < (int)r.l[l].size() ? r.l[l][(size_t)i] : INT_MIN + l;
    };
    if (c.pred == PF_BI && n.pred == PF_BI) {
      int c0 = poc(cr, 0, c.ref[0]), c1 = poc(cr, 1, c.ref[1]), n0 = poc(nr, 0, n.ref[0]), n1 = poc(nr, 1, n.ref[1]);
      if (c0 == n0 && c0 == c1 && n0 == n1)
        return (far(n.mv[0], c.mv[0]) || far(n.mv[1], c.mv[1])) && (far(n.mv[1], c.mv[0]) || far(n.mv[0], c.mv[1]));
      if (n0 == c0 && n1 == c1) return far(n.mv[0], c.mv[0]) || far(n.mv[1], c.mv[1]);
      if (n1 == c0 && n0 == c1) return far(n.mv[1], c.mv[0]) || far(n.mv[0], c.mv[1]);
      return 1;
    }
    if (c.pred != PF_BI && n.pred != PF_BI) {
      int lc = c.pred & PF_L0 ? 0 : 1, ln = n.pred & PF_L0 ? 0 : 1;
      if (poc(cr, lc, c.ref[lc]) != poc(nr, ln, n.ref[ln])) return 1;
      return far(c.mv[lc], n.mv[ln]);
    }
    return 1;
  }

  // FFmpeg's ff_hevc_deblocking_boundary_strengths for a transform unit
  // (or a whole coding unit without one): its top and left edges on the
  // 8x8 grid, and the prediction-block edges inside it
  void deblock_bs(int x0, int y0, int log2) {
    const int n = 1 << log2;
    const bool intra = intra4[at4(x0, y0)];
    const RefPocs& own = ref_poc;
    bool up = y0 > 0 && !(y0 & 7);
    bool upper_slice = up && !(y0 & (ctb - 1)) && ctb_slice_addr[(size_t)ctb_of(x0, y0 - 1)] != slice_addr;
    if (up && !sh.loop_filter_across_slices && upper_slice) up = false;
    if (up) {
      const RefPocs& refs = upper_slice ? cur->slice_refs[(size_t)cur->ctb_slice[(size_t)ctb_of(x0, y0 - 1)]] : own;
      for (int i = 0; i < n; i += 4) {
        const MvField &t = cur->mvf[at4(x0 + i, y0 - 1)], &c = cur->mvf[at4(x0 + i, y0)];
        int b;
        if (intra4[at4(x0 + i, y0)] || intra4[at4(x0 + i, y0 - 1)])
          b = 2;
        else if (cbf4[at4(x0 + i, y0)] || cbf4[at4(x0 + i, y0 - 1)])
          b = 1;
        else
          b = bs_motion(c, t, refs);
        hbs[at4(x0 + i, y0)] = (uint8_t)b;
      }
    }
    bool left = x0 > 0 && !(x0 & 7);
    bool left_slice = left && !(x0 & (ctb - 1)) && ctb_slice_addr[(size_t)ctb_of(x0 - 1, y0)] != slice_addr;
    if (left && !sh.loop_filter_across_slices && left_slice) left = false;
    if (left) {
      const RefPocs& refs = left_slice ? cur->slice_refs[(size_t)cur->ctb_slice[(size_t)ctb_of(x0 - 1, y0)]] : own;
      for (int i = 0; i < n; i += 4) {
        const MvField &l = cur->mvf[at4(x0 - 1, y0 + i)], &c = cur->mvf[at4(x0, y0 + i)];
        int b;
        if (intra4[at4(x0, y0 + i)] || intra4[at4(x0 - 1, y0 + i)])
          b = 2;
        else if (cbf4[at4(x0, y0 + i)] || cbf4[at4(x0 - 1, y0 + i)])
          b = 1;
        else
          b = bs_motion(c, l, refs);
        vbs[at4(x0, y0 + i)] = (uint8_t)b;
      }
    }
    if (log2 > as.log2_min_cb - 1 && !intra) {
      for (int j = 8; j < n; j += 8)
        for (int i = 0; i < n; i += 4)
          hbs[at4(x0 + i, y0 + j)] = (uint8_t)bs_motion(cur->mvf[at4(x0 + i, y0 + j)], cur->mvf[at4(x0 + i, y0 + j - 1)], own);
      for (int j = 0; j < n; j += 4)
        for (int i = 8; i < n; i += 8)
          vbs[at4(x0 + i, y0 + j)] = (uint8_t)bs_motion(cur->mvf[at4(x0 + i, y0 + j)], cur->mvf[at4(x0 + i - 1, y0 + j)], own);
    }
  }

  // FFmpeg's deblocking_filter_CTB, with its offsets as they carry over
  // from edge to edge
  void deblock_ctb(int cx, int cy) {
    const bool pcmf = as.pcm && as.pcm_loop_filter_disabled;
    uint8_t* Y = cur->y.data();
    auto qp_at = [&](int x, int y) { return (int)qp4[at4(x, y)]; };
    auto pcm_at = [&](int x, int y) { return (uint8_t)(pcmf && pcm4[at4(x, y)]); };
    auto chroma_tc = [&](int qpy, int c, int tc_offset) {
      int qpi = clip3(0, 57, qpy + (c == 1 ? ap.cb_qp_offset : ap.cr_qp_offset));
      int q = qpi < 30 ? qpi : qpi > 43 ? qpi - 6 : kQpC[qpi - 30];
      return (int)kTc[clip3(0, 53, q + 2 + tc_offset)];
    };
    {
        const int x0 = cx << log2ctb, y0 = cy << log2ctb, ctbi = cy * as.ctb_w + cx;
        const int cur_tc = ctb_filter[(size_t)ctbi].tc, cur_beta = ctb_filter[(size_t)ctbi].beta;
        const int left_tc = x0 ? ctb_filter[(size_t)ctbi - 1].tc : 0, left_beta = x0 ? ctb_filter[(size_t)ctbi - 1].beta : 0;
        const int x_end = std::min(x0 + ctb, W), y_end = std::min(y0 + ctb, H);
        int tc_offset = cur_tc, beta_offset = cur_beta;
        int x_end2 = x_end == W ? x_end : x_end - 8;
        for (int y = y0; y < y_end; y += 8) {
          for (int x = x0 ? x0 : 8; x < x_end; x += 8) {
            int bs0 = vbs[at4(x, y)], bs1 = vbs[at4(x, y + 4)];
            if (!(bs0 || bs1)) continue;
            int qp = (qp_at(x - 1, y) + qp_at(x, y) + 1) >> 1;
            int beta = kBeta[clip3(0, 51, qp + beta_offset)];
            int tc[2] = {bs0 ? kTc[clip3(0, 53, qp + 2 * (bs0 - 1) + tc_offset)] : 0,
                         bs1 ? kTc[clip3(0, 53, qp + 2 * (bs1 - 1) + tc_offset)] : 0};
            uint8_t no_p[2] = {pcm_at(x - 1, y), pcm_at(x - 1, y + 4)}, no_q[2] = {pcm_at(x, y), pcm_at(x, y + 4)};
            filter_luma(Y + (size_t)y * W + x, 1, W, beta, tc, no_p, no_q);
            stats[ST_DEBLOCKED_EDGES]++;
          }
          if (!y) continue;
          for (int x = x0 ? x0 - 8 : 0; x < x_end2; x += 8) {
            int bs0 = hbs[at4(x, y)], bs1 = hbs[at4(x + 4, y)];
            if (!(bs0 || bs1)) continue;
            int qp = (qp_at(x, y - 1) + qp_at(x, y) + 1) >> 1;
            tc_offset = x >= x0 ? cur_tc : left_tc;
            beta_offset = x >= x0 ? cur_beta : left_beta;
            int beta = kBeta[clip3(0, 51, qp + beta_offset)];
            int tc[2] = {bs0 ? kTc[clip3(0, 53, qp + 2 * (bs0 - 1) + tc_offset)] : 0,
                         bs1 ? kTc[clip3(0, 53, qp + 2 * (bs1 - 1) + tc_offset)] : 0};
            uint8_t no_p[2] = {pcm_at(x, y - 1), pcm_at(x + 4, y - 1)}, no_q[2] = {pcm_at(x, y), pcm_at(x + 4, y)};
            filter_luma(Y + (size_t)y * W + x, W, 1, beta, tc, no_p, no_q);
            stats[ST_DEBLOCKED_EDGES]++;
          }
        }
        for (int c = 1; c <= 2; c++) {
          uint8_t* P = c == 1 ? cur->u.data() : cur->v.data();
          const int cs = W / 2;
          for (int y = y0; y < y_end; y += 16) {
            for (int x = x0 ? x0 : 16; x < x_end; x += 16) {
              int bs0 = vbs[at4(x, y)], bs1 = y + 8 < H ? vbs[at4(x, y + 8)] : 0;
              if (bs0 != 2 && bs1 != 2) continue;
              int qp0 = (qp_at(x - 1, y) + qp_at(x, y) + 1) >> 1;
              int qp1 = y + 8 < H ? (qp_at(x - 1, y + 8) + qp_at(x, y + 8) + 1) >> 1 : 0;
              int tc[2] = {bs0 == 2 ? chroma_tc(qp0, c, tc_offset) : 0, bs1 == 2 ? chroma_tc(qp1, c, tc_offset) : 0};
              uint8_t no_p[2] = {pcm_at(x - 1, y), (uint8_t)(y + 8 < H ? pcm_at(x - 1, y + 8) : 0)};
              uint8_t no_q[2] = {pcm_at(x, y), (uint8_t)(y + 8 < H ? pcm_at(x, y + 8) : 0)};
              filter_chroma(P + (size_t)(y >> 1) * cs + (x >> 1), 1, cs, tc, no_p, no_q, y + 8 < H ? 2 : 1);
            }
            if (!y) continue;
            tc_offset = x0 ? left_tc : cur_tc;
            int xe2 = x_end == W ? x_end : x_end - 16;
            for (int x = x0 ? x0 - 16 : 0; x < xe2; x += 16) {
              int bs0 = hbs[at4(x, y)], bs1 = x + 8 < W ? hbs[at4(x + 8, y)] : 0;
              if (bs0 != 2 && bs1 != 2) continue;
              int qp0 = bs0 == 2 ? (qp_at(x, y - 1) + qp_at(x, y) + 1) >> 1 : 0;
              int qp1 = bs1 == 2 ? (qp_at(x + 8, y - 1) + qp_at(x + 8, y) + 1) >> 1 : 0;
              int tc[2] = {bs0 == 2 ? chroma_tc(qp0, c, tc_offset) : 0, bs1 == 2 ? chroma_tc(qp1, c, cur_tc) : 0};
              uint8_t no_p[2] = {pcm_at(x, y - 1), (uint8_t)(x + 8 < W ? pcm_at(x + 8, y - 1) : 0)};
              uint8_t no_q[2] = {pcm_at(x, y), (uint8_t)(x + 8 < W ? pcm_at(x + 8, y) : 0)};
              filter_chroma(P + (size_t)(y >> 1) * cs + (x >> 1), cs, 1, tc, no_p, no_q, x + 8 < W ? 2 : 1);
            }
          }
        }
      }
  }

  // hevc_loop_filter_luma: two segments of four lines across an edge;
  // xs steps across the edge, ys along it
  static void filter_luma(uint8_t* pix, int xs, int ys, int beta, const int* tcs, const uint8_t* no_ps,
                          const uint8_t* no_qs) {
    for (int j = 0; j < 2; j++, pix += 4 * ys) {
      auto P = [&](int line, int i) -> uint8_t& { return pix[line * ys - (i + 1) * xs]; };
      auto Q = [&](int line, int i) -> uint8_t& { return pix[line * ys + i * xs]; };
      const int dp0 = std::abs(P(0, 2) - 2 * P(0, 1) + P(0, 0)), dq0 = std::abs(Q(0, 2) - 2 * Q(0, 1) + Q(0, 0));
      const int dp3 = std::abs(P(3, 2) - 2 * P(3, 1) + P(3, 0)), dq3 = std::abs(Q(3, 2) - 2 * Q(3, 1) + Q(3, 0));
      const int d0 = dp0 + dq0, d3 = dp3 + dq3, tc = tcs[j], no_p = no_ps[j], no_q = no_qs[j];
      if (d0 + d3 >= beta) continue;
      const int b3 = beta >> 3, b2 = beta >> 2, tc25 = (tc * 5 + 1) >> 1;
      if (std::abs(P(0, 3) - P(0, 0)) + std::abs(Q(0, 3) - Q(0, 0)) < b3 && std::abs(P(0, 0) - Q(0, 0)) < tc25 &&
          std::abs(P(3, 3) - P(3, 0)) + std::abs(Q(3, 3) - Q(3, 0)) < b3 && std::abs(P(3, 0) - Q(3, 0)) < tc25 &&
          (d0 << 1) < b2 && (d3 << 1) < b2) {
        const int tc2 = tc << 1;
        for (int d = 0; d < 4; d++) {
          const int p3 = P(d, 3), p2 = P(d, 2), p1 = P(d, 1), p0 = P(d, 0);
          const int q0 = Q(d, 0), q1 = Q(d, 1), q2 = Q(d, 2), q3 = Q(d, 3);
          if (!no_p) {
            P(d, 0) = (uint8_t)(p0 + clip3(-tc2, tc2, ((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3) - p0));
            P(d, 1) = (uint8_t)(p1 + clip3(-tc2, tc2, ((p2 + p1 + p0 + q0 + 2) >> 2) - p1));
            P(d, 2) = (uint8_t)(p2 + clip3(-tc2, tc2, ((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3) - p2));
          }
          if (!no_q) {
            Q(d, 0) = (uint8_t)(q0 + clip3(-tc2, tc2, ((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3) - q0));
            Q(d, 1) = (uint8_t)(q1 + clip3(-tc2, tc2, ((p0 + q0 + q1 + q2 + 2) >> 2) - q1));
            Q(d, 2) = (uint8_t)(q2 + clip3(-tc2, tc2, ((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3) - q2));
          }
        }
      } else {
        const int thr = (beta + (beta >> 1)) >> 3, tc_2 = tc >> 1;
        const int nd_p = dp0 + dp3 < thr ? 2 : 1, nd_q = dq0 + dq3 < thr ? 2 : 1;
        for (int d = 0; d < 4; d++) {
          const int p2 = P(d, 2), p1 = P(d, 1), p0 = P(d, 0), q0 = Q(d, 0), q1 = Q(d, 1), q2 = Q(d, 2);
          int delta0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
          if (std::abs(delta0) >= 10 * tc) continue;
          delta0 = clip3(-tc, tc, delta0);
          if (!no_p) P(d, 0) = clip1(p0 + delta0);
          if (!no_q) Q(d, 0) = clip1(q0 - delta0);
          if (!no_p && nd_p > 1) P(d, 1) = clip1(p1 + clip3(-tc_2, tc_2, (((p2 + p0 + 1) >> 1) - p1 + delta0) >> 1));
          if (!no_q && nd_q > 1) Q(d, 1) = clip1(q1 + clip3(-tc_2, tc_2, (((q2 + q0 + 1) >> 1) - q1 - delta0) >> 1));
        }
      }
    }
  }

  static void filter_chroma(uint8_t* pix, int xs, int ys, const int* tcs, const uint8_t* no_ps, const uint8_t* no_qs,
                            int segments) {
    for (int j = 0; j < segments; j++, pix += 4 * ys) {
      const int tc = tcs[j];
      if (tc <= 0) continue;
      for (int d = 0; d < 4; d++) {
        uint8_t* s = pix + d * ys;
        const int p1 = s[-2 * xs], p0 = s[-xs], q0 = s[0], q1 = s[xs];
        const int delta = clip3(-tc, tc, ((((q0 - p0) * 4) + p1 - q1 + 4) >> 3));
        if (!no_ps[j]) s[-xs] = clip1(p0 + delta);
        if (!no_qs[j]) s[0] = clip1(q0 - delta);
      }
    }
  }

  // SAO (8.7.3) as FFmpeg's sao_filter_CTB runs it, CTB by CTB in the
  // order of its loop filter schedule: a neighbouring sample comes from the
  // saved borders of a CTB already filtered (its values before its SAO),
  // else from the picture as it stands; a neighbour outside the picture,
  // or in another slice when the CTB's slice does not filter across
  // slices (FFmpeg: the current CTB's flag, in every direction), leaves the
  // sample as it is
  struct SaoBorders {
    std::vector<uint8_t> top, bottom, left, right;
    bool applied = false;
  };
  std::vector<SaoBorders> sao_saved[3];

  void sao_ctb(int cx, int cy) {
    const int ci = cy * as.ctb_w + cx;
    if (!ctb_sao_used[(size_t)ci]) return;
    const SaoParams& sp = ctb_sao[(size_t)ci];
    const bool pcmf = as.pcm && as.pcm_loop_filter_disabled;
    const bool across = ctb_filter[(size_t)ci].across;
    const int my_slice = ctb_slice_addr[(size_t)ci];
    for (int c = 0; c < 3; c++) {
      const int type = sp.type[c];
      if (!type) continue;
      std::vector<uint8_t>& plane = c == 0 ? cur->y : c == 1 ? cur->u : cur->v;
      const int pw = c ? W / 2 : W, ph = c ? H / 2 : H, cl = c ? log2ctb - 1 : log2ctb, sh = c ? 1 : 0;
      const int x0 = cx << cl, y0 = cy << cl, w = std::min(1 << cl, pw - x0), h = std::min(1 << cl, ph - y0);
      SaoBorders& mine = sao_saved[c][(size_t)ci];
      // the window: the CTB and a ring of neighbours
      const int ww = w + 2;
      std::vector<int> win((size_t)ww * (h + 2), -1);
      auto put = [&](int x, int y, int v) { win[(size_t)(y + 1) * ww + x + 1] = v; };
      auto get = [&](int x, int y) { return win[(size_t)(y + 1) * ww + x + 1]; };
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) put(x, y, plane[(size_t)(y0 + y) * pw + x0 + x]);
      auto neighbour = [&](int x, int y) {  // a sample outside the CTB, picture coordinates
        int nx = (x << sh) >> log2ctb, ny = (y << sh) >> log2ctb;
        const SaoBorders& b = sao_saved[c][(size_t)(ny * as.ctb_w + nx)];
        if (b.applied) {
          int bx0 = nx << cl, by0 = ny << cl;
          if (y < y0) return (int)b.bottom[(size_t)(x - bx0)];
          if (y >= y0 + h) return (int)b.top[(size_t)(x - bx0)];
          if (x < x0) return (int)b.right[(size_t)(y - by0)];
          return (int)b.left[(size_t)(y - by0)];
        }
        return (int)plane[(size_t)y * pw + x];
      };
      for (int y = -1; y <= h; y++)
        for (int x = -1; x <= w; x++) {
          if (x >= 0 && x < w && y >= 0 && y < h) continue;
          int px = x0 + x, py = y0 + y;
          if (px < 0 || py < 0 || px >= pw || py >= ph) continue;
          put(x, y, neighbour(px, py));
        }
      // the CTB's own borders before its SAO
      mine.top.assign(&plane[(size_t)y0 * pw + x0], &plane[(size_t)y0 * pw + x0] + w);
      mine.bottom.assign(&plane[(size_t)(y0 + h - 1) * pw + x0], &plane[(size_t)(y0 + h - 1) * pw + x0] + w);
      mine.left.resize((size_t)h);
      mine.right.resize((size_t)h);
      for (int y = 0; y < h; y++) {
        mine.left[(size_t)y] = plane[(size_t)(y0 + y) * pw + x0];
        mine.right[(size_t)y] = plane[(size_t)(y0 + y) * pw + x0 + w - 1];
      }
      int table[32] = {0};
      if (type == 1)
        for (int k = 0; k < 4; k++) table[(k + sp.band[c]) & 31] = sp.offset[c][k];
      static const int8_t kPos[4][2][2] = {{{-1, 0}, {1, 0}}, {{0, -1}, {0, 1}}, {{-1, -1}, {1, 1}}, {{1, -1}, {-1, 1}}};
      static const uint8_t kEdge[5] = {1, 2, 0, 3, 4};
      const int pu_log2 = as.log2_min_cb - 1;
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
          // FFmpeg's restore_tqb_pixels keeps PCM samples as they were,
          // for chroma only over the CTB's first half in each direction
          // (it measures the chroma block in luma units)
          if (pcmf && pcm4[at4((x0 + x) << sh, (y0 + y) << sh)] &&
              ((x0 + x) << sh) >> pu_log2 < ((x0 << sh) + w) >> pu_log2 &&
              ((y0 + y) << sh) >> pu_log2 < ((y0 << sh) + h) >> pu_log2)
            continue;
          int v = get(x, y), o;
          if (type == 1) {
            o = table[v >> 3];
          } else {
            bool ok = true;
            int sg[2];
            for (int k = 0; k < 2 && ok; k++) {
              int xn = x + kPos[sp.eo[c]][k][0], yn = y + kPos[sp.eo[c]][k][1];
              int px = x0 + xn, py = y0 + yn;
              if (px < 0 || py < 0 || px >= pw || py >= ph) {
                ok = false;
                break;
              }
              if (!across && (xn < 0 || yn < 0 || xn >= w || yn >= h) &&
                  ctb_slice_addr[(size_t)(((py << sh) >> log2ctb) * as.ctb_w + ((px << sh) >> log2ctb))] != my_slice) {
                ok = false;
                break;
              }
              int nv = get(xn, yn);
              sg[k] = v < nv ? -1 : v > nv ? 1 : 0;
            }
            if (!ok) continue;
            int idx = kEdge[2 + sg[0] + sg[1]];
            o = idx ? sp.offset[c][idx - 1] : 0;
          }
          plane[(size_t)(y0 + y) * pw + x0 + x] = clip1(v + o);
        }
      mine.applied = true;
    }
  }

  // FFmpeg's ff_hevc_hls_filter and ff_hevc_hls_filters: the deblocking of
  // a CTB and the SAO of the CTBs it completes, behind the decoding
  void hls_filter(int x, int y) {
    deblock_ctb(x >> log2ctb, y >> log2ctb);
    if (!as.sao) return;
    bool x_end = x >= W - ctb, y_end = y >= H - ctb;
    if (y && x) sao_ctb((x - ctb) >> log2ctb, (y - ctb) >> log2ctb);
    if (x && y_end) sao_ctb((x - ctb) >> log2ctb, y >> log2ctb);
    if (y && x_end) sao_ctb(x >> log2ctb, (y - ctb) >> log2ctb);
    if (x_end && y_end) sao_ctb(x >> log2ctb, y >> log2ctb);
  }

  void hls_filters(int x, int y) {
    bool x_end = x >= W - ctb, y_end = y >= H - ctb;
    if (y && x) hls_filter(x - ctb, y - ctb);
    if (y && x_end) hls_filter(x, y - ctb);
    if (x && y_end) hls_filter(x - ctb, y);
  }

  void loop_filter_picture() {
    for (int c = 0; c < 3; c++) sao_saved[c].assign((size_t)as.ctb_w * as.ctb_h, SaoBorders());
    for (int cy = 0; cy < as.ctb_h; cy++)
      for (int cx = 0; cx < as.ctb_w; cx++) hls_filters(cx << log2ctb, cy << log2ctb);
    hls_filter((as.ctb_w - 1) << log2ctb, (as.ctb_h - 1) << log2ctb);
  }

  // ---------------------------------------------------------------- pictures and output

  std::vector<std::unique_ptr<Picture>> dpb;
  int next_id = 0;
  int poc_tid0 = 0, max_ra = INT_MAX, eos = 0, last_eos = 0, no_rasl_output = 0;
  bool skipping = false;  // the current picture is a RASL picture FFmpeg skips
  int last_poc = 0;       // the POC of the last picture started
  struct Frame {
    int w, h;
    std::vector<uint8_t> data;  // I420, cropped
  };
  std::vector<Frame> ready;
  Picture* out_cur = nullptr;  // the current picture, output once decoded

  // FFmpeg's av_frame_apply_cropping keeps its planes aligned: a left crop
  // is taken down to a multiple of 64 luma samples
  void output(Picture* p) {
    int cl = p->crop[0] & ~63, cr = p->crop[1], ct = p->crop[2], cb = p->crop[3];
    int w = p->w - cl - cr, h = p->h - ct - cb;
    Frame f{w, h, std::vector<uint8_t>((size_t)w * h * 3 / 2)};
    for (int y = 0; y < h; y++) std::memcpy(&f.data[(size_t)y * w], &p->y[(size_t)(y + ct) * p->w + cl], (size_t)w);
    int cw = p->w / 2;
    uint8_t* u = &f.data[(size_t)w * h];
    uint8_t* v = u + (size_t)w * h / 4;
    for (int y = 0; y < h / 2; y++) {
      std::memcpy(u + (size_t)y * w / 2, &p->u[(size_t)(y + ct / 2) * cw + cl / 2], (size_t)w / 2);
      std::memcpy(v + (size_t)y * w / 2, &p->v[(size_t)(y + ct / 2) * cw + cl / 2], (size_t)w / 2);
    }
    ready.push_back(std::move(f));
  }

  void release_unused() {
    dpb.erase(std::remove_if(dpb.begin(), dpb.end(),
                             [&](const std::unique_ptr<Picture>& p) { return !p->flags && p.get() != cur; }),
              dpb.end());
  }

  // FFmpeg's ff_hevc_output_frames: while more pictures wait than the
  // reorder depth allows, or the DPB is over its size, the lowest POC goes
  void output_frames(int max_output, int max_dpb, bool discard) {
    for (;;) {
      int nb_output = 0, nb_dpb = 0;
      Picture* best = nullptr;
      for (auto& p : dpb) {
        if (p->flags & F_OUTPUT) {
          nb_output++;
          if (!best || p->poc < best->poc) best = p.get();
        }
        nb_dpb += p->flags != 0;
      }
      if (!(nb_output > max_output || (nb_output && nb_dpb > max_dpb))) return;
      best->flags &= ~F_OUTPUT;
      if (discard)
        stats[ST_NOT_OUTPUT]++;
      else if (best == cur)
        out_cur = cur;
      else
        output(best);
      if (nb_output > 1) stats[ST_REORDER]++;
    }
  }

  Picture* new_picture(bool release = true) {
    if (release) release_unused();
    auto p = std::make_unique<Picture>();
    p->alloc(W, H);
    p->id = next_id++;
    p->ctb_slice.assign((size_t)as.ctb_w * as.ctb_h, -1);
    dpb.push_back(std::move(p));
    return dpb.back().get();
  }

  // the RPS (8.3.2, FFmpeg's ff_hevc_frame_rps): references marked.  A
  // missing one is made gray for an IRAP picture; any other picture that
  // refers to a missing reference is not decoded at all (FFmpeg: "Error
  // constructing the frame RPS"), the references before it in the set
  // marked and the rest released.  False for such a picture.
  std::vector<Picture*> st_before, st_after;
  bool frame_rps() {
    st_before.clear();
    st_after.clear();
    if (is_idr(sh.nal_type)) {
      for (auto& p : dpb)
        if (p.get() != cur) p->flags &= ~F_SHORT_REF;
      return true;
    }
    for (auto& p : dpb)  // FFmpeg's unref_missing_refs
      if (p->missing) p->flags = 0;
    release_unused();
    for (auto& p : dpb)
      if (p.get() != cur) p->flags &= ~F_SHORT_REF;
    const ShortTermRps& r = *sh.rps;
    for (int i = 0; i < r.num_delta; i++) {
      int poc = cur->poc + r.delta_poc[i];
      // every picture still held (FFmpeg releases the unmarked ones after this)
      Picture* ref = nullptr;
      for (auto& p : dpb)
        if (p.get() != cur && p->poc == poc && !ref) ref = p.get();
      if (!ref && !is_irap(sh.nal_type)) {
        stats[ST_DROPPED_PICTURES]++;
        return false;
      }
      if (!ref) {
        ref = new_picture(false);
        std::fill(ref->y.begin(), ref->y.end(), 128);
        std::fill(ref->u.begin(), ref->u.end(), 128);
        std::fill(ref->v.begin(), ref->v.end(), 128);
        ref->poc = poc;
        ref->missing = true;
        stats[ST_MISSING_REFS]++;
      }
      ref->flags |= F_SHORT_REF;
      if (r.used[i]) (i < r.num_negative ? st_before : st_after).push_back(ref);
    }
    return true;
  }

  void start_picture() {
    const Sps& s = as;
    // POC (8.3.1, FFmpeg's ff_hevc_compute_poc)
    int poc = 0;
    if (!is_idr(sh.nal_type)) {
      int max_lsb = 1 << s.log2_max_poc_lsb;
      int prev_lsb = poc_tid0 % max_lsb, prev_msb = poc_tid0 - prev_lsb, msb;
      if (sh.poc_lsb < prev_lsb && prev_lsb - sh.poc_lsb >= max_lsb / 2)
        msb = prev_msb + max_lsb;
      else if (sh.poc_lsb > prev_lsb && sh.poc_lsb - prev_lsb > max_lsb / 2)
        msb = prev_msb - max_lsb;
      else
        msb = prev_msb;
      if (is_bla(sh.nal_type)) msb = 0;
      poc = msb + sh.poc_lsb;
    }
    int t = sh.nal_type;
    if (sh.temporal_id == 0 && t != NAL_TRAIL_N && t != NAL_TSA_N && t != NAL_STSA_N && t != NAL_RADL_N &&
        t != NAL_RADL_R && t != NAL_RASL_N && t != NAL_RASL_R)
      poc_tid0 = poc;
    // RASL pictures of an IRAP picture that starts the stream are skipped
    if (max_ra == INT_MAX) {
      if (t == NAL_CRA || is_bla(t))
        max_ra = poc;
      else if (is_idr(t))
        max_ra = INT_MIN;
    }
    if (is_rasl(t) && poc <= max_ra) {
      skipping = true;
      stats[ST_RASL_SKIPPED]++;
      return;
    }
    if (t == NAL_RASL_R && poc > max_ra) max_ra = INT_MIN;
    skipping = false;
    if (is_irap(t)) no_rasl_output = is_idr(t) || is_bla(t) || (t == NAL_CRA && last_eos);
    int no_output_prior = sh.no_output_of_prior_pics || (t == NAL_CRA && last_eos);
    if (is_irap(t) && no_rasl_output) output_frames(0, 0, no_output_prior);
    cur = nullptr;
    cur = new_picture();
    cur->poc = poc;
    last_poc = poc;
    cur->flags = (sh.pic_output ? F_OUTPUT : 0) | F_SHORT_REF;
    if (!sh.pic_output) stats[ST_NOT_OUTPUT]++;
    cur->crop[0] = 2 * s.conf_left;
    cur->crop[1] = 2 * s.conf_right;
    cur->crop[2] = 2 * s.conf_top;
    cur->crop[3] = 2 * s.conf_bottom;
    if (s.conf_win && (s.conf_left || s.conf_right || s.conf_top || s.conf_bottom)) stats[ST_CROPPED]++;
    if (!frame_rps()) {
      cur->flags = 0;
      cur = nullptr;
      release_unused();
      skipping = true;
      return;
    }
    release_unused();
    const SubLayerOrdering& o = s.ordering[s.max_sub_layers - 1];
    output_frames(o.num_reorder, o.max_dec_pic_buffering, false);
    // the picture's state
    const size_t n4 = (size_t)w4 * h4, nctb = (size_t)s.ctb_w * s.ctb_h;
    intra4.assign(n4, 0);
    skip4.assign(n4, 0);
    depth4.assign(n4, 0);
    ipm4.assign(n4, 1);
    pcm4.assign(n4, 0);
    cbf4.assign(n4, 0);
    qp4.assign(n4, (uint8_t)sh.slice_qp);
    vbs.assign(n4, 0);
    hbs.assign(n4, 0);
    ctb_slice_addr.assign(nctb, -1);
    ctb_filter.assign(nctb, CtbFilter());
    ctb_sao.assign(nctb, SaoParams());
    ctb_sao_used.assign(nctb, 0);
    slice_index = -1;
    stats[ST_PICS]++;
    if (is_idr(t))
      stats[ST_IDR]++;
    else if (t == NAL_CRA)
      stats[ST_CRA]++;
    else if (is_irap(t))
      stats[ST_IRAP_OTHER]++;
    stats[log2ctb == 6 ? ST_CTB64 : log2ctb == 5 ? ST_CTB32 : ST_CTB16]++;
    if (ap.constrained_intra) stats[ST_CIP]++;
    if (sh.rps && sh.rps->inter) stats[ST_INTER_RPS]++;
  }

  void finish_picture() {
    if (!cur) return;
    loop_filter_picture();
    if (out_cur == cur) {
      output(cur);
      out_cur = nullptr;
    }
    cur = nullptr;
  }

  // ---------------------------------------------------------------- NAL units

  std::vector<uint8_t> rbsp;

  bool writing = false;  // a stream writer's decoder takes what a reader refuses

  void activate(const Pps* pp, const Sps* sp) {
    // FFmpeg keeps its planes aligned and crops such a left edge less, and
    // cv2 then rescales the frame to the SPS's width
    if (!writing && (2 * sp->conf_left) % 64)
      fail("H.265 conformance window with a left offset of %d samples is not supported (cv2 "
           "rescales such frames)", 2 * sp->conf_left);
    bool new_sps = !have_sps || std::memcmp(&as, sp, sizeof(Sps)) != 0;
    if (new_sps) {
      if (have_sps && (sp->width != as.width || sp->height != as.height)) {
        // pictures of the old size come out first
        output_frames(0, 0, false);
        for (auto& p : dpb) p->flags = 0;
        release_unused();
      }
      as = *sp;
      have_sps = true;
      set_geometry();
    }
    ap = *pp;
  }

  void slice(BitReader& br, int nal_type, int temporal_id) {
    SliceHeader h;
    h.nal_type = nal_type;
    h.temporal_id = temporal_id;
    h.beta_offset_div2 = last_beta_div2;
    h.tc_offset_div2 = last_tc_div2;
    ReadEngine e;
    e.br = &br;
    const Pps* pp = nullptr;
    const Sps* sp = nullptr;
    const Pps* ptab[64];
    const Sps* stab[16];
    for (int i = 0; i < 64; i++) ptab[i] = pps[i].get();
    for (int i = 0; i < 16; i++) stab[i] = sps[i].get();
    slice_header_syntax(e, h, ptab, stab, pp, sp);
    // byte_alignment()
    if (!br.u1()) fail("corrupt H.265 data: the slice header's alignment bit is 0");
    br.align();
    br.check("slice header");
    begin_slice(h, pp, sp);
    if (skipping) return;
    slice_data(e);
  }

  // a slice's header is read: the picture and the slice's state set up
  void begin_slice(const SliceHeader& h, const Pps* pp, const Sps* sp) {
    if (h.first_slice) {
      finish_picture();
      activate(pp, sp);
      sh = h;
      if (sh.rps == &h.st_rps) sh.rps = &sh.st_rps;
      start_picture();
      if (skipping) return;
    } else {
      if (!cur && !skipping) fail("corrupt H.265 data: a slice segment without the first of its picture");
      if (skipping) return;
      if (pp->sps_id != ap.sps_id || std::memcmp(pp, &ap, sizeof(Pps)) != 0) ap = *pp;
      sh = h;
      if (sh.rps == &h.st_rps) sh.rps = &sh.st_rps;
    }
    if (h.address < 0 || h.address >= as.ctb_w * as.ctb_h || ctb_slice_addr[(size_t)h.address] != -1)
      fail("corrupt H.265 data: slice_segment_address %d already decoded", h.address);
    slice_addr = h.address;
    slice_index++;
    last_beta_div2 = sh.beta_offset_div2;
    last_tc_div2 = sh.tc_offset_div2;
    stats[sh.type == SLICE_I ? ST_I_SLICES : sh.type == SLICE_P ? ST_P_SLICES : ST_B_SLICES]++;
    if (slice_index > 0) stats[ST_SLICES_2PLUS]++;
    if (sh.deblocking_disabled) stats[ST_DEBLOCK_OFF]++;
    if (!sh.loop_filter_across_slices) stats[ST_SLICE_ACROSS_OFF]++;
    if (ap.cb_qp_offset || ap.cr_qp_offset || sh.cb_qp_offset || sh.cr_qp_offset) stats[ST_CHROMA_QP_OFFSET]++;
    // FFmpeg's init_type: 2 - slice_type, swapped between 1 and 2 by cabac_init_flag
    init_type = sh.type == SLICE_I ? 0 : (2 - sh.type) ^ (sh.cabac_init ? 3 : 0);
    if (sh.cabac_init) stats[ST_CABAC_INIT]++;
    // the lists (8.3.4, FFmpeg's ff_hevc_slice_rpl): list 0 StCurrBefore
    // then StCurrAfter, list 1 the other way round, repeated up to the
    // slice's count, then the entries of a modification
    ref_list[0].clear();
    ref_list[1].clear();
    ref_poc = RefPocs();
    col_pic = nullptr;
    if (sh.type != SLICE_I) {
      if (st_before.empty() && st_after.empty())
        fail("corrupt H.265 data: a P or B slice without references (zero refs in the RPS)");
      for (int l = 0; l < (sh.type == SLICE_B ? 2 : 1); l++) {
        const std::vector<Picture*>& first = l ? st_after : st_before;
        const std::vector<Picture*>& second = l ? st_before : st_after;
        std::vector<Picture*> tmp;
        while ((int)tmp.size() < sh.num_ref_idx[l]) {
          for (Picture* p : first)
            if (tmp.size() < 16) tmp.push_back(p);
          for (Picture* p : second)
            if (tmp.size() < 16) tmp.push_back(p);
        }
        if (sh.list_mod[l]) {
          stats[l ? ST_LIST_MOD_L1 : ST_LIST_MOD]++;
          for (int i = 0; i < sh.num_ref_idx[l]; i++) {
            if (sh.list_entry[l][i] >= (int)tmp.size())
              fail("corrupt H.265 data: list_entry_l%d %d", l, sh.list_entry[l][i]);
            ref_list[l].push_back(tmp[(size_t)sh.list_entry[l][i]]);
          }
        } else {
          ref_list[l].assign(tmp.begin(), tmp.begin() + std::min<size_t>(tmp.size(), (size_t)sh.num_ref_idx[l]));
        }
        for (Picture* p : ref_list[l]) ref_poc.l[l].push_back(p->poc);
      }
      const std::vector<Picture*>& cl = ref_list[!sh.collocated_from_l0];
      if (sh.temporal_mvp && sh.collocated_ref_idx < (int)cl.size()) col_pic = cl[(size_t)sh.collocated_ref_idx];
      if (col_pic && (col_pic->w != W || col_pic->h != H)) col_pic = nullptr;
      if (sh.temporal_mvp && !sh.collocated_from_l0) stats[ST_COL_FROM_L1]++;
    }
    weighted = (sh.type == SLICE_P && ap.weighted_pred) || (sh.type == SLICE_B && ap.weighted_bipred);
    if (weighted) stats[ST_WEIGHTED_SLICES]++;
    cur->slice_refs.push_back(ref_poc);
  }

  void nal(const uint8_t* p, size_t n) {
    if (n < 2) return;
    if (p[0] & 0x80) fail("corrupt H.265 data: forbidden_zero_bit is 1");
    int type = (p[0] >> 1) & 63, layer = ((p[0] & 1) << 5) | (p[1] >> 3), tid = (p[1] & 7) - 1;
    if (tid < 0) fail("corrupt H.265 data: nuh_temporal_id_plus1 is 0");
    if (layer > 0) {
      if (type <= 31 || type == NAL_SPS || type == NAL_PPS || type == NAL_VPS)
        fail("H.265 layers above 0 (nuh_layer_id %d: multi-layer and 3D video) are not supported", layer);
      return;
    }
    if (type == NAL_EOS || type == NAL_EOB) {
      eos = 1;
      finish_picture();
      output_frames(0, 0, false);
      max_ra = INT_MAX;
      return;
    }
    bool vcl = type <= NAL_CRA;
    if (!vcl && type != NAL_VPS && type != NAL_SPS && type != NAL_PPS) return;  // SEI, AUD and the rest
    if (vcl && ((type >= 10 && type <= 15) || type >= 22)) return;  // reserved
    size_t len;
    unescape(p + 2, n - 2, rbsp, len);
    BitReader br;
    br.init(rbsp, len);
    if (type == NAL_VPS) {
      ReadEngine e;
      e.br = &br;
      auto v = std::make_unique<Vps>();
      vps_syntax(e, *v);
      vps[v->id] = std::move(v);
    } else if (type == NAL_SPS) {
      ReadEngine e;
      e.br = &br;
      auto s = std::make_unique<Sps>();
      const Vps* vt[16];
      for (int i = 0; i < 16; i++) vt[i] = vps[i].get();
      sps_syntax(e, *s, vt);
      br.check("SPS");
      sps[s->id] = std::move(s);
    } else if (type == NAL_PPS) {
      ReadEngine e;
      e.br = &br;
      auto pp = std::make_unique<Pps>();
      const Sps* st[16];
      for (int i = 0; i < 16; i++) st[i] = sps[i].get();
      pps_syntax(e, *pp, st);
      br.check("PPS");
      pps[pp->id] = std::move(pp);
    } else {
      slice(br, type, tid);
    }
  }

  // the start of a packet (an access unit) and its end
  void begin_packet() {
    last_eos = eos;
    eos = 0;
  }
  void end_packet() { finish_picture(); }

  void flush() {
    finish_picture();
    output_frames(0, 0, false);
  }
};

}  // namespace hevc

// ------------------------------------------------------------------ C interface

using hevc::Decoder;

struct HevcHandle {
  Decoder d;
  size_t next_out = 0;
};

template <class F>
static int guard(HevcHandle* h, F fn) {
  try {
    fn();
    return 0;
  } catch (const std::exception& e) {
    h->d.error = e.what();
    return -1;
  }
}

// Splits an Annex B byte stream into NAL units (start, size without
// trailing zero bytes).
static void annexb_nals(const uint8_t* p, size_t n, std::vector<std::pair<size_t, size_t>>& out) {
  size_t i = 0;
  auto start_code = [&](size_t k) { return k + 2 < n && p[k] == 0 && p[k + 1] == 0 && p[k + 2] == 1; };
  while (i < n && !start_code(i)) i++;
  while (i < n) {
    size_t s = i + 3, e = s;
    while (e < n && !start_code(e)) e++;
    size_t end = e;
    while (end > s && p[end - 1] == 0) end--;
    if (end > s) out.push_back({s, end - s});
    i = e;
  }
}

extern "C" {

HevcHandle* hevc_decoder_new() {
  try {
    return new HevcHandle();
  } catch (...) {
    return nullptr;
  }
}

void hevc_decoder_free(HevcHandle* h) { delete h; }

const char* hevc_decoder_error(HevcHandle* h) { return h->d.error.c_str(); }

// Feeds a packet: `length_size` 0 for an Annex B byte stream, else 1, 2 or
// 4 for length-prefixed NAL units.  Returns the number of frames ready, or -1.
int hevc_decode(HevcHandle* h, const uint8_t* data, long n, int length_size) {
  int r = guard(h, [&] {
    h->d.begin_packet();
    if (length_size == 0) {
      std::vector<std::pair<size_t, size_t>> nals;
      annexb_nals(data, (size_t)n, nals);
      for (auto& x : nals) h->d.nal(data + x.first, x.second);
    } else {
      if (length_size != 1 && length_size != 2 && length_size != 4)
        hevc::fail("NAL length size %d (1, 2 or 4)", length_size);
      size_t pos = 0, total = (size_t)n;
      while (pos < total) {
        if (pos + (size_t)length_size > total) hevc::fail("truncated H.265 sample: a NAL length runs past the sample");
        size_t len = 0;
        for (int k = 0; k < length_size; k++) len = len << 8 | data[pos + (size_t)k];
        pos += (size_t)length_size;
        if (len > total - pos) hevc::fail("truncated H.265 sample: a NAL unit of %zu bytes runs past it", len);
        h->d.nal(data + pos, len);
        pos += len;
      }
    }
    h->d.end_packet();
  });
  if (r) return -1;
  return (int)(h->d.ready.size() - h->next_out);
}

int hevc_flush(HevcHandle* h) {
  if (guard(h, [&] { h->d.flush(); })) return -1;
  return (int)(h->d.ready.size() - h->next_out);
}

// The size of the active SPS's cropped frames (0 before one is active).
void hevc_size(HevcHandle* h, int* w, int* ht) {
  const hevc::Sps& s = h->d.as;
  if (!h->d.have_sps) {
    *w = *ht = 0;
    return;
  }
  *w = s.width - ((2 * s.conf_left) & ~63) - 2 * s.conf_right;
  *ht = s.height - 2 * (s.conf_top + s.conf_bottom);
}

// Frame rate from the active SPS's VUI timing (0 if none).
double hevc_fps(HevcHandle* h) {
  const hevc::Sps& s = h->d.as;
  if (!h->d.have_sps || !s.num_units_in_tick || !s.time_scale) return 0.0;
  return (double)s.time_scale / s.num_units_in_tick;
}

long hevc_next_frame_bytes(HevcHandle* h) {
  if (h->next_out >= h->d.ready.size()) return 0;
  return (long)h->d.ready[h->next_out].data.size();
}

int hevc_next_frame(HevcHandle* h, uint8_t* out, long size, int* w, int* ht) {
  if (h->next_out >= h->d.ready.size()) return 1;
  auto& f = h->d.ready[h->next_out];
  if ((long)f.data.size() > size) return -1;
  std::memcpy(out, f.data.data(), f.data.size());
  *w = f.w;
  *ht = f.h;
  f.data.clear();
  f.data.shrink_to_fit();
  if (++h->next_out == h->d.ready.size()) {
    h->d.ready.clear();
    h->next_out = 0;
  }
  return 0;
}

int hevc_last_poc(HevcHandle* h) { return h->d.last_poc; }

int hevc_stats(HevcHandle* h, long* out, int n) {
  int k = std::min(n, (int)hevc::ST_COUNT);
  for (int i = 0; i < k; i++) out[i] = h->d.stats[i];
  return k;
}

}  // extern "C"
