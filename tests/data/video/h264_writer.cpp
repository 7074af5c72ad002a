// A writer of legal H.264 I/P/B streams from a seed, for the tests of the
// port's decoder (adas_tpu_torch/native/h264.cpp).  It includes the
// decoder's source for its syntax layer (parameter sets, slice headers,
// macroblocks and residuals are written by the same functions that read
// them) and feeds every NAL unit it writes to a decoder of its own, whose
// reference lists and marking it consults; cv2's FFmpeg is the independent
// judge of what the two share.  Built by tests/data/video/h264_writer.py.
//
// Two modes:
// - exerciser: random legal syntax, not pictures (mb types, sub-types,
//   intra modes, cbp, coefficient levels, mvd, ref_idx, QP deltas,
//   transform sizes, slices, cabac_init_idc, MMCOs and long-term
//   references, weighted prediction, scaling lists, deblocking controls,
//   POC types), CAVLC or CABAC, with options that turn tools on and off;
//   with B pictures (O_BFRAMES), groups of B pictures before each P
//   picture, a pyramid of reference B pictures, spatial or temporal
//   direct, implicit or explicit bi-prediction weights, B mb types and
//   sub-types, list 1 modifications and the VUI's reorder depth;
// - content: I_PCM pictures of given frames, then P pictures of
//   P_L0_16x16 / P_Skip with a quarter-pel pan and no residual; or with B
//   pictures, the pan coded as IBBBP... with B_Bi_16x16, B_Direct_16x16
//   and B_Skip.
#include "../../../adas_tpu_torch/native/h264.cpp"

namespace h264w {
using namespace h264;

// The spec's dequantisation and transforms of levels, which the writer
// uses to keep every block's transform inside 16 bits (the decoder runs
// FFmpeg's own over its coefficient buffer).
// The scaled 4x4 coefficients d (raster) of levels in scan order; from
// index 1 when the DC comes from a DC transform.
static void dequant4(const int16_t* lev, int qp, const int* ls, int* d, int first) {
  int q6 = qp / 6;
  for (int k = first; k < 16; k++) {
    int r = kZigzag4[k];
    int c = lev[k];
    if (!c) {
      d[r] = 0;
      continue;
    }
    d[r] = q6 >= 4 ? c * ls[r] * (1 << (q6 - 4)) : (c * ls[r] + (1 << (3 - q6))) >> (4 - q6);
  }
}

static void dequant8(const int16_t* lev, int qp, const int* ls, int* d) {
  int q6 = qp / 6;
  for (int k = 0; k < 64; k++) {
    int r = kZigzag8[k];
    int c = lev[k];
    if (!c) {
      d[r] = 0;
      continue;
    }
    d[r] = q6 >= 6 ? c * ls[r] * (1 << (q6 - 6)) : (c * ls[r] + (1 << (5 - q6))) >> (6 - q6);
  }
}

static void idct8_1d(const int* in, int step, int* out, int ostep) {
  int d0 = in[0], d1 = in[step], d2 = in[2 * step], d3 = in[3 * step], d4 = in[4 * step],
      d5 = in[5 * step], d6 = in[6 * step], d7 = in[7 * step];
  int a0 = d0 + d4, a4 = d0 - d4, a2 = (d2 >> 1) - d6, a6 = d2 + (d6 >> 1);
  int b0 = a0 + a6, b2 = a4 + a2, b4 = a4 - a2, b6 = a0 - a6;
  int a1 = -d3 + d5 - d7 - (d7 >> 1), a3 = d1 + d7 - d3 - (d3 >> 1);
  int a5 = -d1 + d7 + d5 + (d5 >> 1), a7 = d3 + d5 + d1 + (d1 >> 1);
  int b1 = a1 + (a7 >> 2), b7 = a7 - (a1 >> 2), b3 = a3 + (a5 >> 2), b5 = (a3 >> 2) - a5;
  out[0] = b0 + b7;
  out[ostep] = b2 + b5;
  out[2 * ostep] = b4 + b3;
  out[3 * ostep] = b6 + b1;
  out[4 * ostep] = b6 - b1;
  out[5 * ostep] = b4 - b3;
  out[6 * ostep] = b2 - b5;
  out[7 * ostep] = b0 - b7;
}

// Intra16x16 DC: inverse Hadamard and scaling (8.5.10); out in raster order
// of the 4x4 blocks
static void luma_dc(const int16_t* lev, int qp, int ls0, int* out) {
  int c[16], f[16], t[16];
  for (int k = 0; k < 16; k++) c[kZigzag4[k]] = lev[k];
  for (int i = 0; i < 4; i++) {  // rows
    const int* r = c + 4 * i;
    int s0 = r[0] + r[1], s1 = r[0] - r[1], s2 = r[2] + r[3], s3 = r[2] - r[3];
    t[4 * i + 0] = s0 + s2;
    t[4 * i + 1] = s0 - s2;
    t[4 * i + 2] = s1 - s3;
    t[4 * i + 3] = s1 + s3;
  }
  for (int j = 0; j < 4; j++) {
    int s0 = t[j] + t[4 + j], s1 = t[j] - t[4 + j], s2 = t[8 + j] + t[12 + j],
        s3 = t[8 + j] - t[12 + j];
    f[j] = s0 + s2;
    f[4 + j] = s0 - s2;
    f[8 + j] = s1 - s3;
    f[12 + j] = s1 + s3;
  }
  int q6 = qp / 6;
  for (int k = 0; k < 16; k++)
    out[k] = q6 >= 6 ? f[k] * ls0 * (1 << (q6 - 6)) : (f[k] * ls0 + (1 << (5 - q6))) >> (6 - q6);
}

static void chroma_dc(const int16_t* lev, int qp, int ls0, int* out) {
  int f0 = lev[0] + lev[1] + lev[2] + lev[3], f1 = lev[0] - lev[1] + lev[2] - lev[3];
  int f2 = lev[0] + lev[1] - lev[2] - lev[3], f3 = lev[0] - lev[1] - lev[2] + lev[3];
  int f[4] = {f0, f1, f2, f3};
  for (int k = 0; k < 4; k++) out[k] = (f[k] * ls0 * (1 << (qp / 6))) >> 5;
}

struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed * 0x9E3779B97F4A7C15ull + 0x1234567ull) {}
  uint32_t next() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return (uint32_t)(s >> 11);
  }
  int range(int lo, int hi) { return lo + (int)(next() % (uint32_t)(hi - lo + 1)); }
  bool chance(int percent) { return (int)(next() % 100) < percent; }
};

// Exerciser options, in the order h264_writer.py passes them.
enum Opt {
  O_WIDTH, O_HEIGHT, O_FRAMES, O_SEED, O_CABAC, O_PROFILE, O_T8X8, O_SCALING, O_WEIGHTED,
  O_SLICES, O_REFS, O_REF_MODS, O_MMCO, O_LONG_TERM, O_POC_TYPE, O_DEBLOCK, O_CIP, O_NONREF,
  O_PCM, O_INTRA_IN_P, O_QP_MIN, O_QP_MAX, O_IDR_EVERY, O_VUI, O_BIG_LEVELS, O_SKIP,
  O_MB_TYPES, O_LOG2_POC_LSB, O_BFRAMES, O_PYRAMID, O_DIRECT, O_BIPRED, O_B_TYPES,
  O_DIRECT_4x4, O_COUNT
};

struct Writer {
  std::string error;
  std::vector<uint8_t> out;
  int o[O_COUNT];
  Rng rng{1};
  Sps sps;
  Pps pps;
  Decoder dec;  // follows the stream: reference lists, marking, POC
  std::vector<MbState> mbs;
  int mb_w = 0, mb_h = 0;
  int frame_index = 0;
  Dequant dq;
  // content mode
  std::vector<uint8_t> planes;  // I_PCM source frames, MB-aligned I420
  int pan_x = 0, pan_y = 0;

  void emit(int ref_idc, int type, BitWriter& bw) {
    std::vector<uint8_t> nal;
    nal.push_back((uint8_t)(ref_idc << 5 | type));
    escape(bw.buf, nal);
    static const uint8_t sc[4] = {0, 0, 0, 1};
    out.insert(out.end(), sc, sc + 4);
    out.insert(out.end(), nal.begin(), nal.end());
    dec.nal(nal.data(), nal.size());
  }

  void write_sps() {
    BitWriter bw;
    WriteEngine e;
    e.bw = &bw;
    sps_syntax(e, sps);
    bw.trailing();
    emit(3, 7, bw);
    resolve_sps_lists(sps);
  }

  void write_pps() {
    BitWriter bw;
    WriteEngine e;
    e.bw = &bw;
    const Sps* table[32] = {nullptr};
    table[sps.id] = &sps;
    pps_syntax(e, pps, table);
    bw.trailing();
    emit(3, 8, bw);
    uint8_t w4[6][16], w8[2][64];
    resolve_lists(sps, pps, w4, w8);
    dq.init(w4, w8);
  }

  void random_list(uint8_t* list, int n) {
    for (int i = 0; i < n; i++) list[i] = (uint8_t)rng.range(6, 40);
  }

  void setup_exerciser(int width, int height) {
    mb_w = (width + 15) / 16;
    mb_h = (height + 15) / 16;
    sps = Sps();
    sps.profile_idc = o[O_PROFILE];
    sps.constraints = o[O_PROFILE] == 66 ? 0xC0 : o[O_PROFILE] == 77 ? 0x40 : 0;
    sps.level_idc = 30;
    sps.id = rng.range(0, 3);
    if (o[O_SCALING] && o[O_PROFILE] == 100) {
      sps.scaling_present = o[O_SCALING] == 2 || rng.chance(70);  // scaling 2: SPS and PPS lists
      for (int i = 0; i < 8; i++) {
        sps.list_present[i] = rng.chance(60);
        sps.use_default[i] = rng.chance(20);
        random_list(sps.lists[i], i < 6 ? 16 : 64);
      }
    }
    sps.log2_max_frame_num = rng.range(4, 6);
    sps.poc_type = o[O_POC_TYPE];
    sps.log2_max_poc_lsb = o[O_LOG2_POC_LSB] ? o[O_LOG2_POC_LSB] : rng.range(4, 6);
    if (sps.poc_type == 1) {
      sps.delta_pic_order_always_zero = rng.chance(50);
      sps.offset_for_non_ref_pic = 1;
      sps.offset_for_top_to_bottom = 0;
      sps.num_ref_frames_in_poc_cycle = rng.range(1, 3);
      for (int i = 0; i < sps.num_ref_frames_in_poc_cycle; i++) sps.offset_for_ref_frame[i] = 2 * rng.range(1, 2);
    }
    sps.max_num_ref_frames = std::max(1, o[O_REFS]);
    sps.width_mbs = mb_w;
    sps.height_mbs = mb_h;
    sps.direct_8x8 = 1;
    int cr = mb_w * 16 - width, cb = mb_h * 16 - height;
    sps.cropping = cr || cb;
    sps.crop_right = cr / 2;
    sps.crop_bottom = cb / 2;
    sps.vui_present = o[O_VUI];
    if (sps.vui_present) {
      sps.timing_present = 1;
      sps.num_units_in_tick = 1;
      sps.time_scale = 50;
      sps.restriction = 1;
      sps.max_num_reorder_frames = 0;
      sps.max_dec_frame_buffering = sps.max_num_ref_frames;
    }
    pps = Pps();
    pps.id = rng.range(0, 5);
    pps.sps_id = sps.id;
    pps.cabac = o[O_CABAC];
    pps.num_ref_idx_default[0] = rng.range(1, std::max(1, o[O_REFS]));
    pps.num_ref_idx_default[1] = 1;
    pps.weighted_pred = o[O_WEIGHTED];
    pps.pic_init_qp = rng.range(o[O_QP_MIN], o[O_QP_MAX]);
    pps.chroma_qp_offset = o[O_PROFILE] == 66 ? 0 : rng.range(-4, 4);
    pps.deblocking_control = o[O_DEBLOCK] != 0;
    pps.constrained_intra_pred = o[O_CIP];
    if (o[O_PROFILE] == 100) {
      pps.has_ext = 1;
      pps.transform_8x8_mode = o[O_T8X8];
      pps.scaling_present = o[O_SCALING] == 2 || (o[O_SCALING] && rng.chance(60));
      for (int i = 0; i < 8; i++) {
        pps.list_present[i] = rng.chance(50);
        pps.use_default[i] = rng.chance(20);
        random_list(pps.lists[i], i < 6 ? 16 : 64);
      }
      pps.second_chroma_qp_offset = rng.range(-4, 4);
    }
    if (o[O_BFRAMES]) {  // B pictures: the plan, and what it needs of the SPS and PPS
      plan_b(o[O_FRAMES], o[O_BFRAMES], o[O_PYRAMID], o[O_IDR_EVERY], true);
      if (sps.profile_idc == 66) {  // Baseline has no B slices: Main
        sps.profile_idc = 77;
        sps.constraints = 0x40;
      }
      sps.poc_type = 0;
      if (!o[O_LOG2_POC_LSB]) sps.log2_max_poc_lsb = 8;
      sps.max_num_ref_frames = std::max(o[O_REFS], 2 + (o[O_PYRAMID] ? 1 : 0));
      sps.direct_8x8 = !o[O_DIRECT_4x4];
      if (o[O_DIRECT_4x4]) sps.level_idc = 21;  // levels 3 and up require direct_8x8_inference_flag
      if (sps.vui_present) {
        sps.max_num_reorder_frames = reorder;
        sps.max_dec_frame_buffering = std::max(sps.max_num_ref_frames, reorder);
      }
      pps.weighted_bipred_idc = o[O_BIPRED];
      pps.num_ref_idx_default[1] = rng.range(1, sps.max_num_ref_frames);
    }
    write_sps();
    write_pps();
  }

  // ---------------------------------------------------------------- macroblock policy

  // Whether a block's scaled coefficients and transform intermediates stay
  // in 16 bits (the conformance range FFmpeg's int16 blocks hold).
  static bool fits(const int* v, int n, int margin = 0) {
    for (int i = 0; i < n; i++)
      if (v[i] < -32768 + margin || v[i] > 32767 - margin) return false;
    return true;
  }
  // (FFmpeg's SIMD transforms add the rounding 32 to the DC first and keep
  // every stage in 16 bits.)
  static bool ok4(const int* din) {
    if (!fits(din, 16)) return false;
    int d[16], t[16];
    std::memcpy(d, din, sizeof d);
    d[0] += 32;
    if (!fits(d, 1)) return false;
    for (int i = 0; i < 4; i++) {
      const int* r = d + 4 * i;
      int e0 = r[0] + r[2], e1 = r[0] - r[2], e2 = (r[1] >> 1) - r[3], e3 = r[1] + (r[3] >> 1);
      t[4 * i] = e0 + e3, t[4 * i + 1] = e1 + e2, t[4 * i + 2] = e1 - e2, t[4 * i + 3] = e0 - e3;
    }
    if (!fits(t, 16)) return false;
    for (int j = 0; j < 4; j++) {
      int g0 = t[j] + t[8 + j], g1 = t[j] - t[8 + j];
      int g2 = (t[4 + j] >> 1) - t[12 + j], g3 = t[4 + j] + (t[12 + j] >> 1);
      int h[4] = {g0 + g3, g1 + g2, g1 - g2, g0 - g3};
      if (!fits(h, 4)) return false;
    }
    return true;
  }
  static bool ok8(const int* din) {
    if (!fits(din, 64)) return false;
    int d[64], t[64], u[64];
    std::memcpy(d, din, sizeof d);
    d[0] += 32;
    if (!fits(d, 1)) return false;
    for (int i = 0; i < 8; i++) idct8_1d(d + 8 * i, 1, t + 8 * i, 1);
    if (!fits(t, 64)) return false;
    for (int j = 0; j < 8; j++) idct8_1d(t + j, 8, u + j, 8);
    return fits(u, 64);
  }

  int level() {
    int a = rng.chance(70) ? 1 : rng.chance(70) ? rng.range(2, 3) : rng.range(4, o[O_BIG_LEVELS] ? 40 : 8);
    if (o[O_BIG_LEVELS] && rng.chance(3)) a = rng.range(100, 2000);
    return rng.chance(50) ? -a : a;
  }
  void fill(int16_t* c, int n, int density) {
    for (int i = 0; i < n; i++) c[i] = rng.chance(density) ? (int16_t)level() : 0;
  }

  void coefficients(SliceState& s, MbSyn& m, int qp) {
    m.clear_coeffs();
    bool intra = is_intra(m.type);
    int density = rng.range(5, 60);
    if (m.type == MB_I16x16) {
      int dcv[16];
      for (int tries = 0;; tries++) {  // after 20 tries, no DC
        fill(m.dc, 16, tries < 20 ? density : 0);
        luma_dc(m.dc, qp, dq.ls4[0][qp % 6][0], dcv);
        if (fits(dcv, 16, 64)) break;
      }
      for (int b = 0; b < 16; b++) {
        int r = kBlkY[b] * 4 + kBlkX[b];
        for (int tries = 0;; tries++) {  // after 20 tries, no AC
          if (m.i16_luma && tries < 20) fill(m.ac[b] + 1, 15, density);
          else std::memset(m.ac[b], 0, sizeof m.ac[b]);
          int d[16];
          dequant4(m.ac[b], qp, dq.ls4[0][qp % 6], d, 1);
          d[0] = dcv[r];
          if (ok4(d) || tries >= 20) break;
        }
      }
    } else {
      for (int b8 = 0; b8 < 4; b8++) {
        if (!((m.cbp >> b8) & 1)) continue;
        if (m.t8x8) {
          const int* ls = dq.ls8[intra ? 0 : 1][qp % 6];
          for (int tries = 0;; tries++) {  // after 20 tries, one level of 1
            fill(m.l8[b8], 64, tries < 20 ? density / 2 + 1 : 0);
            if (s.cabac || tries >= 20) {
              bool any = false;
              for (int k = 0; k < 64; k++) any |= m.l8[b8][k] != 0;
              if (!any) m.l8[b8][rng.range(0, 63)] = rng.chance(50) ? 1 : -1;
            }
            int d[64];
            dequant8(m.l8[b8], qp, ls, d);
            if (ok8(d)) break;
            if (tries > 30) fail("H.264 writer: no 8x8 block in range");
          }
        } else {
          const int* ls = dq.ls4[intra ? 0 : 3][qp % 6];
          for (int k = 0; k < 4; k++) {
            int b = b8 * 4 + k;
            for (int tries = 0;; tries++) {  // after 20 tries, no levels
              fill(m.ac[b], 16, tries < 20 ? density : 0);
              int d[16];
              dequant4(m.ac[b], qp, ls, d, 0);
              if (ok4(d) || tries >= 20) break;
            }
          }
        }
      }
    }
    int cbp_c = m.cbp >> 4;
    if (cbp_c) {
      for (int c = 0; c < 2; c++) {
        int off = c ? pps.second_chroma_qp_offset : pps.chroma_qp_offset;
        int q = kChromaQp[clip3(0, 51, qp + off)];
        int list = (intra ? 1 : 4) + c;
        int dcv[4];
        for (int tries = 0;; tries++) {  // after 20 tries, no DC
          fill(m.cdc[c], 4, tries < 20 ? density : 0);
          chroma_dc(m.cdc[c], q, dq.ls4[list][q % 6][0], dcv);
          if (fits(dcv, 4, 64)) break;
        }
        for (int b = 0; b < 4; b++) {
          for (int tries = 0;; tries++) {  // after 20 tries, no AC
            if (cbp_c == 2 && tries < 20) fill(m.cac[c][b] + 1, 15, density);
            else std::memset(m.cac[c][b], 0, sizeof m.cac[c][b]);
            int d[16];
            dequant4(m.cac[c][b], q, dq.ls4[list][q % 6], d, 1);
            d[0] = dcv[b];
            if (ok4(d) || tries >= 20) break;
          }
        }
      }
    }
  }

  int legal_mode(bool top, bool left, bool corner, int n_modes) {
    int modes[9], k = 0;
    for (int mode = 0; mode < n_modes; mode++) {
      bool ok;
      if (n_modes == 9) {
        bool nt = mode == 0 || mode == 3 || mode == 4 || mode == 5 || mode == 6 || mode == 7;
        bool nl = mode == 1 || mode == 4 || mode == 5 || mode == 6 || mode == 8;
        bool nc = mode == 4 || mode == 5 || mode == 6;
        ok = (!nt || top) && (!nl || left) && (!nc || corner);
      } else if (n_modes == 4) {  // Intra16x16: V, H, DC, plane
        ok = mode == 2 || (mode == 0 && top) || (mode == 1 && left) || (mode == 3 && top && left && corner);
      } else {
        ok = true;
      }
      if (ok) modes[k++] = mode;
    }
    return modes[rng.range(0, k - 1)];
  }

  int chroma_mode(SliceState& s) {
    Recon r;
    r.s = &s;
    bool top = r.intra_avail(s.nB), left = r.intra_avail(s.nA), corner = r.intra_avail(s.nD);
    int modes[4] = {0}, k = 1;
    if (left) modes[k++] = 1;
    if (top) modes[k++] = 2;
    if (top && left && corner) modes[k++] = 3;
    return modes[rng.range(0, k - 1)];
  }

  void intra_mb(SliceState& s, MbSyn& m) {
    Recon r;
    r.s = &s;
    bool p = s.type == SLICE_P;
    int kind = rng.range(0, 99);
    int pcm_rate = o[O_PCM];
    // mb_types 2, 3, 4: Intra16x16, Intra4x4 or Intra8x8 only
    if (o[O_MB_TYPES] == 2) kind = 99, pcm_rate = 0;
    if (o[O_MB_TYPES] >= 3) kind = 99, pcm_rate = 0;
    bool t8 = pps.transform_8x8_mode;
    if (kind < pcm_rate) {
      m.type = MB_IPCM;
      m.mb_type = 25;
      for (int i = 0; i < 384; i++) m.pcm[i] = (uint8_t)rng.range(0, 255);
    } else if (o[O_MB_TYPES] == 2 || (o[O_MB_TYPES] < 2 && kind < pcm_rate + (100 - pcm_rate) / 3)) {
      m.type = MB_I16x16;
      bool top = r.intra_avail(s.nB), left = r.intra_avail(s.nA), corner = r.intra_avail(s.nD);
      m.i16_pred = legal_mode(top, left, corner, 4);
      m.i16_chroma = rng.range(0, 2);
      m.i16_luma = rng.chance(50) ? 15 : 0;
      m.mb_type = 1 + m.i16_pred + 4 * m.i16_chroma + (m.i16_luma ? 12 : 0);
    } else {
      m.type = t8 && (o[O_MB_TYPES] == 4 || (o[O_MB_TYPES] != 3 && rng.chance(50))) ? MB_I8x8 : MB_I4x4;
      m.t8x8 = m.type == MB_I8x8;
      m.mb_type = 0;
      int n = m.t8x8 ? 4 : 16;
      for (int k = 0; k < n; k++) {
        int bx = m.t8x8 ? (k & 1) * 8 : kBlkX[k] * 4, by = m.t8x8 ? (k >> 1) * 8 : kBlkY[k] * 4;
        int blk = blk_of(bx >> 2, by >> 2);
        bool top = r.sample_avail(bx, by - 1, blk), left = r.sample_avail(bx - 1, by, blk);
        bool corner = r.sample_avail(bx - 1, by - 1, blk);
        m.modes[k] = legal_mode(top, left, corner, 9);
      }
    }
    if (p) m.mb_type += 5;
    if (s.type == SLICE_B) m.mb_type += 23;
    if (m.type != MB_IPCM) {
      m.chroma_mode = chroma_mode(s);
      if (m.type != MB_I16x16) m.cbp = rng.range(0, 47) < 40 ? kCbpIntra[rng.range(0, 47)] : 0;
    }
  }

  // a random motion vector target: mostly small, sometimes across the picture
  void random_mv(int* t) {
    if (rng.chance(5)) {
      t[0] = rng.range(-4 * (mb_w * 16 + 40), 4 * (mb_w * 16 + 40));
      t[1] = rng.range(-std::min(2000, 4 * (mb_h * 16 + 40)), std::min(2000, 4 * (mb_h * 16 + 40)));
    } else {
      t[0] = rng.range(-40, 40);
      t[1] = rng.range(-40, 40);
    }
  }

  static void set_ref(MbState& cur, int list, Part pt, int ref) {
    for (int y = pt.y; y < pt.y + pt.h; y += 2)
      for (int x = pt.x; x < pt.x + pt.w; x += 2) cur.ref[list][(y >> 1) * 2 + (x >> 1)] = (int8_t)ref;
  }

  void inter_mb(SliceState& s, MbSyn& m, int valid_refs, int (*target)[4][4][2]) {
    bool cabac = s.cabac;
    int choice = rng.range(0, 4);
    if (choice == 4 && (cabac || s.num_ref[0] < 2)) choice = 3;
    static const int kTypes[5] = {MB_P16x16, MB_P16x8, MB_P8x16, MB_P8x8, MB_P8x8REF0};
    m.type = kTypes[choice];
    if (o[O_MB_TYPES] == 1) m.type = MB_P16x16;
    m.mb_type = m.type - MB_P16x16;
    auto ref = [&]() { return rng.chance(60) ? 0 : rng.range(0, valid_refs - 1); };
    MbState& cur = s.m();
    cur.type = (int8_t)m.type;
    if (is_8x8(m.type)) {
      for (int b8 = 0; b8 < 4; b8++) {
        m.sub[b8] = m.sshape[b8] = rng.chance(40) ? 0 : rng.range(1, 3);
        m.ref[0][b8] = m.type == MB_P8x8REF0 ? 0 : ref();
        cur.ref[0][b8] = (int8_t)m.ref[0][b8];
        for (int k = 0; k < 4; k++) random_mv(target[0][b8][k]);
      }
    } else {
      for (int p = 0; p < num_mb_parts(m.type); p++) {
        m.ref[0][p] = ref();
        set_ref(cur, 0, mb_part(m.type, p), m.ref[0][p]);
        random_mv(target[0][p][0]);
      }
    }
    m.cbp = rng.range(0, 47) < 36 ? kCbpInter[rng.range(0, 47)] : 0;
    bool small = false;
    if (is_8x8(m.type))
      for (int b = 0; b < 4; b++) small |= m.sshape[b] != 0;
    m.t8x8 = pps.transform_8x8_mode && (m.cbp & 15) && !small && rng.chance(50);
  }

  // An inter macroblock of a B slice: B_Direct_16x16, 16x16 / 16x8 / 8x16
  // with L0, L1 or Bi partitions, or B_8x8 with any sub-types (direct
  // among them); O_B_TYPES narrows the choice.
  void b_mb(SliceState& s, MbSyn& m, const int* valid, int (*target)[4][4][2]) {
    MbState& cur = s.m();
    int kind = rng.range(0, 9);  // 0 direct, 1-3 16x16, 4-6 16x8 / 8x16, 7-9 B_8x8
    if (o[O_B_TYPES] == 1) kind = 7;
    if (o[O_B_TYPES] == 2) kind = 0;
    if (o[O_B_TYPES] == 3) kind = rng.range(1, 6);
    auto ref = [&](int l) { return rng.chance(60) ? 0 : rng.range(0, valid[l] - 1); };
    if (kind == 0) {
      m.type = MB_BDIRECT16;
      m.mb_type = 0;
      cur.direct = 15;
    } else if (kind <= 6) {
      int pr[2] = {rng.range(1, 3), rng.range(1, 3)};
      if (kind <= 3) {
        m.mb_type = pr[1] = pr[0];
      } else {
        int odd = rng.chance(50);  // 8x16
        for (int v = 4; v <= 21; v++)
          if (kBPred[v][0] == pr[0] && kBPred[v][1] == pr[1] && (v & 1) == odd) m.mb_type = v;
      }
      m.type = b_type(m.mb_type, m.pred);
      for (int p = 0; p < num_mb_parts(m.type); p++)
        for (int l = 0; l < 2; l++) {
          if (!(m.pred[p] & (1 << l))) continue;
          m.ref[l][p] = ref(l);
          set_ref(cur, l, mb_part(m.type, p), m.ref[l][p]);
          random_mv(target[l][p][0]);
        }
    } else {
      m.type = MB_B8x8;
      m.mb_type = 22;
      for (int b8 = 0; b8 < 4; b8++) {
        int sv = rng.chance(25) ? 0 : rng.range(1, 12);
        m.sub[b8] = sv;
        m.sshape[b8] = kBSubShape[sv];
        m.spred[b8] = kBSubPred[sv];
        if (!sv) cur.direct |= (uint8_t)(1 << b8);
        for (int l = 0; l < 2; l++) {
          if (!(m.spred[b8] & (1 << l))) continue;
          m.ref[l][b8] = ref(l);
          cur.ref[l][b8] = (int8_t)m.ref[l][b8];
          for (int k = 0; k < 4; k++) random_mv(target[l][b8][k]);
        }
      }
    }
    cur.type = (int8_t)m.type;
    m.cbp = rng.range(0, 47) < 36 ? kCbpInter[rng.range(0, 47)] : 0;
    bool small = m.type == MB_BDIRECT16 && !sps.direct_8x8;
    if (is_8x8(m.type))
      for (int b = 0; b < 4; b++) small |= m.spred[b] ? m.sshape[b] != 0 : !sps.direct_8x8;
    m.t8x8 = pps.transform_8x8_mode && (m.cbp & 15) && !small && rng.chance(50);
  }

  // ---------------------------------------------------------------- pictures

  struct Plan {
    std::vector<uint8_t> skip;      // per macroblock of the slice
    std::vector<uint8_t> direct16;  // content B slices: B_Direct_16x16 in place of B_Skip
    int first, last;                // macroblock range
  };

  // What a slice's macroblocks are; the policy fills each coded one.
  struct SliceCb {
    Writer* w;
    Plan* plan;
    const int* valid;
    bool content;
    MbSyn m;
    int skip_run(int addr) {
      int n = 0;
      while (addr + n <= plan->last && plan->skip[addr + n - plan->first]) n++;
      return n;
    }
    int skipped(int addr) { return plan->skip[addr - plan->first]; }
    bool ended(int addr) { return addr > plan->last; }
    void skip(SliceState& s) { skip_mv(s); }
    void coded(WriteEngine& e, SliceState& s) {
      m = MbSyn();
      m.clear_motion();
      std::memset(m.modes, 0, sizeof m.modes);
      m.clear_coeffs();
      int target[2][4][4][2] = {};
      if (content) {
        w->content_mb(s, m, target, plan->direct16[s.cur - plan->first]);
      } else if (s.type == SLICE_I || w->rng.chance(w->o[O_INTRA_IN_P])) {
        w->intra_mb(s, m);
      } else if (s.type == SLICE_B) {
        w->b_mb(s, m, valid, target);
      } else {
        w->inter_mb(s, m, valid[0], target);
      }
      if (!is_intra(m.type)) derive_mvs(s, m, target);
      // the QP delta: keep QP inside [QP_MIN, QP_MAX]
      if (m.type != MB_IPCM && (m.cbp || m.type == MB_I16x16)) {
        int lo = content ? 0 : w->o[O_QP_MIN], hi = content ? 0 : w->o[O_QP_MAX];
        int d = 0;
        if (!content && w->rng.chance(40)) d = w->rng.range(lo - s.qp, hi - s.qp);
        d = clip3(-26, 25, d);
        m.dqp = d;
        w->coefficients(s, m, (s.qp + d + 52) % 52);
      }
      mb_syntax(e, s, m);
    }
  };

  // the pan's vector from the current picture to list l's reference `ref`
  void pan_target(const SliceState& s, int l, int ref, int* t) const {
    int d = (s.cur_poc - s.list[l][ref]->poc) / 2;
    t[0] = pan_x * d;
    t[1] = pan_y * d;
  }

  void content_mb(SliceState& s, MbSyn& m, int (*target)[4][4][2], bool direct16) {
    if (s.type == SLICE_I) {
      m.type = MB_IPCM;
      m.mb_type = 25;
      int W = mb_w * 16;
      const uint8_t* Y = planes.data() + (size_t)frame_index * W * mb_h * 16 * 3 / 2;
      const uint8_t* U = Y + (size_t)W * mb_h * 16;
      const uint8_t* V = U + (size_t)W * mb_h * 4;
      for (int y = 0; y < 16; y++)
        std::memcpy(m.pcm + 16 * y, Y + (size_t)(s.mby * 16 + y) * W + s.mbx * 16, 16);
      for (int y = 0; y < 8; y++) {
        std::memcpy(m.pcm + 256 + 8 * y, U + (size_t)(s.mby * 8 + y) * (W / 2) + s.mbx * 8, 8);
        std::memcpy(m.pcm + 320 + 8 * y, V + (size_t)(s.mby * 8 + y) * (W / 2) + s.mbx * 8, 8);
      }
      return;
    }
    m.cbp = 0;
    if (s.type == SLICE_B && direct16) {
      m.type = MB_BDIRECT16;
      m.mb_type = 0;
      s.m().type = MB_BDIRECT16;
      s.m().direct = 15;
      return;
    }
    bool b = s.type == SLICE_B;
    m.type = b ? MB_B16x16 : MB_P16x16;
    m.mb_type = b ? 3 : 0;  // B_Bi_16x16, P_L0_16x16
    m.pred[0] = b ? PRED_BI : PRED_L0;
    s.m().type = (int8_t)m.type;
    for (int l = 0; l < 1 + b; l++) {
      m.ref[l][0] = 0;
      std::memset(s.m().ref[l], 0, 4);
      pan_target(s, l, 0, target[l][0][0]);
    }
  }

  // whether the skip prediction (P_Skip's vector, or B_Skip's direct
  // motion) of this macroblock is the pan's
  bool skip_matches(SliceState& s) {
    MbState saved = s.m();
    skip_mv(s);
    const MbState& c = s.m();
    bool same = true;
    for (int l = 0; l < 2; l++)
      for (int i = 0; i < 16; i++) {
        int r = c.ref[l][b8_of(i)];
        if (r < 0) continue;
        int t[2];
        pan_target(s, l, r, t);
        same &= c.mv[l][i][0] == t[0] && c.mv[l][i][1] == t[1];
        if (s.type == SLICE_P) same &= r == 0;
      }
    s.m() = saved;
    return same;
  }

  void picture(bool content, int n_pcm) {
    if (!plan.empty()) {
      picture_b(content);
      return;
    }
    int max_fn = 1 << sps.log2_max_frame_num;
    bool first = frame_index == 0;
    bool idr = first || (o[O_IDR_EVERY] && frame_index % o[O_IDR_EVERY] == 0);
    bool intra_pic = idr || (content && frame_index < n_pcm);
    int ref_idc = 3;
    bool prev_nonref = dec.started && !dec.first.nal_ref_idc;
    if (!idr && !content && o[O_NONREF] && rng.chance(40) && !prev_nonref)
      ref_idc = 0;
    else if (!content)
      ref_idc = rng.range(1, 3);
    SliceHeader h;
    h.nal_ref_idc = ref_idc;
    h.nal_type = idr ? 5 : 1;
    h.idr = idr;
    h.pps_id = pps.id;
    h.frame_num = idr ? 0 : (dec.prev_ref_frame_num + 1) % max_fn;
    h.idr_pic_id = frame_index & 1;
    // POC: increasing in decoding order
    if (sps.poc_type == 0) {
      int max_lsb = 1 << sps.log2_max_poc_lsb;
      int step = content ? 2 : 2 * rng.range(1, 2);
      int prev = idr ? -step : last_poc;
      int poc = idr ? 0 : prev + step;
      if (idr) poc = 0;
      // the writer's POC of a picture after mmco5 restarts with the next picture
      h.poc_lsb = ((poc % max_lsb) + max_lsb) % max_lsb;
      last_poc = poc;
    }
    cur_poc = last_poc;
    // marking
    if (ref_idc && idr)
      h.long_term_reference = o[O_LONG_TERM] && rng.chance(50);
    else if (ref_idc)
      choose_marking(h, content);
    bool mmco5 = false;
    for (auto& mm : h.mmcos) mmco5 |= mm.op == 5;
    // slices
    int total = mb_w * mb_h;
    std::vector<int> starts = slice_starts(content, total);
    mbs.assign(total, MbState());
    for (auto& m : mbs) m.reset(-1);
    // slice types: all alike (then slice_type may say so, 5-9), or mixed I and P
    bool mixed = !intra_pic && !content && rng.chance(20);
    int same = !mixed && !content && rng.chance(50) ? 5 : 0;
    for (size_t si = 0; si < starts.size(); si++) {
      int first_mb = starts[si], last_mb = si + 1 < starts.size() ? starts[si + 1] - 1 : total - 1;
      SliceHeader sh = h;
      sh.first_mb = first_mb;
      int type = intra_pic ? SLICE_I : mixed && rng.chance(30) ? SLICE_I : SLICE_P;
      sh.slice_type = type;
      sh.raw_slice_type = type + same;
      slice(sh, (int)si, first_mb, last_mb, content);
    }
    if (sps.poc_type == 0 && mmco5) last_poc = 0;  // tempPicOrderCnt: the picture's POC becomes 0
    frame_index++;
  }
  int last_poc = 0;
  int cur_poc = 0;  // the POC of the picture being written

  // ---------------------------------------------------------------- B pictures

  // A picture of the plan, in decoding order: its POC, first slice type,
  // and whether it is a reference or an IDR picture; `disp` its display
  // position in the stream.
  struct Coded {
    int poc, type;
    bool ref, idr;
    int disp;
  };
  std::vector<Coded> plan;  // B pictures: the whole stream, in decoding order
  int reorder = 0;          // the plan's reorder depth (VUI max_num_reorder_frames)

  // B pictures [lo, hi] of a group: a pyramid codes the middle one first as
  // a reference, then each half; else all as non-reference pictures in order.
  void plan_bs(const std::vector<int>& poc, int base, int lo, int hi, bool pyramid) {
    if (lo > hi) return;
    if (pyramid && hi > lo) {
      int mid = (lo + hi) / 2;
      plan.push_back({poc[mid], SLICE_B, true, false, base + mid});
      plan_bs(poc, base, lo, mid - 1, pyramid);
      plan_bs(poc, base, mid + 1, hi, pyramid);
      return;
    }
    for (int k = lo; k <= hi; k++) plan.push_back({poc[k], SLICE_B, false, false, base + k});
  }

  // The decoding order of `frames` pictures: an IDR picture every
  // `idr_every` (0: the first only), then groups of `nb` B pictures before
  // each P picture (the last group shorter), POC steps of 2 or 4.
  void plan_b(int frames, int nb, bool pyramid, int idr_every, bool random_steps) {
    plan.clear();
    for (int disp = 0; disp < frames;) {
      int len = idr_every ? std::min(idr_every, frames - disp) : frames - disp;
      std::vector<int> poc(len);
      for (int k = 0, p = 0; k < len; k++, p += random_steps ? 2 * rng.range(1, 2) : 2) poc[k] = p;
      plan.push_back({0, SLICE_I, true, true, disp});
      for (int i = 1; i < len;) {
        int anchor = i + std::min(nb, len - 1 - i);
        plan.push_back({poc[anchor], SLICE_P, true, false, disp + anchor});
        plan_bs(poc, disp, i, anchor - 1, pyramid);
        i = anchor + 1;
      }
      disp += len;
    }
    reorder = 0;
    for (size_t j = 0; j < plan.size(); j++) {
      int later = 0;
      for (size_t k = 0; k < j; k++) later += plan[k].disp > plan[j].disp;
      reorder = std::max(reorder, later);
    }
  }

  // The short- and long-term reference pictures other than the current
  // one, by FrameNumWrap (relative to frame_num) and LongTermFrameIdx: the
  // random choices never depend on the order of the decoder's buffers.
  void references(int frame_num, std::vector<Picture*>& st, std::vector<Picture*>& lt) {
    int max_fn = 1 << sps.log2_max_frame_num;
    auto wrap = [&](const Picture* p) { return p->frame_num > frame_num ? p->frame_num - max_fn : p->frame_num; };
    for (auto& pic : dec.dpb) {
      if (pic.get() == dec.cur) continue;
      if (pic->short_ref) st.push_back(pic.get());
      if (pic->long_ref) lt.push_back(pic.get());
    }
    std::sort(st.begin(), st.end(), [&](const Picture* a, const Picture* b) { return wrap(a) < wrap(b); });
    std::sort(lt.begin(), lt.end(), [](const Picture* a, const Picture* b) { return a->lt_idx < b->lt_idx; });
  }

  // The reference-list fields of a P or B slice header, drawn at random:
  // num_ref_idx overrides, ref_pic_list_modification, the weights, and
  // for B the direct mode.  `avail` references are in the DPB.
  void draw_lists(SliceHeader& h, bool content, int avail) {
    bool b = h.slice_type == SLICE_B;
    if (b) h.direct_spatial = content ? frame_index % 2 : o[O_DIRECT] == 2 ? rng.chance(50) : !o[O_DIRECT];
    for (int l = 0; l < 2; l++) h.num_ref_active[l] = l <= b ? pps.num_ref_idx_default[l] : 0;
    h.num_ref_override = 0;
    if (!content && rng.chance(50)) {
      h.num_ref_override = 1;
      for (int l = 0; l <= b; l++) h.num_ref_active[l] = rng.range(1, std::min(16, avail + 1));
    } else if (content && !plan.empty()) {  // B content: room for temporal direct's references
      h.num_ref_override = 1;
      for (int l = 0; l <= b; l++) h.num_ref_active[l] = std::min(3, avail);
    }
    for (int l = 0; l < 2; l++) {
      h.ref_mod_flag[l] = 0;
      h.ref_mods[l].clear();
      if (l > b || content || !o[O_REF_MODS] || !rng.chance(50)) continue;
      h.ref_mod_flag[l] = 1;
      int n = rng.range(1, h.num_ref_active[l]);
      int max_fn = 1 << sps.log2_max_frame_num;
      int pred = h.frame_num;
      std::vector<Picture*> st, lt;
      references(h.frame_num, st, lt);
      for (int i = 0; i < n; i++) {
        if (!lt.empty() && (st.empty() || rng.chance(30))) {
          h.ref_mods[l].push_back({2, lt[rng.range(0, (int)lt.size() - 1)]->lt_idx});
          continue;
        }
        Picture* pic = st[rng.range(0, (int)st.size() - 1)];
        int num = pic->frame_num > h.frame_num ? pic->frame_num - max_fn : pic->frame_num;
        // picNumNoWrap relative to the prediction
        int no_wrap = num < 0 ? num + max_fn : num;
        int d = no_wrap - pred;
        int idc;
        if (d < 0) {
          idc = 0;
          d = -d;
        } else if (d > 0) {
          idc = 1;
        } else {
          idc = rng.chance(50) ? 0 : 1;
          d = max_fn;
        }
        if (d > max_fn) fail("H.264 writer: modification distance");
        h.ref_mods[l].push_back({idc, d - 1});
        pred = no_wrap;
      }
    }
    if (pps.weighted_pred && !b) {
      h.luma_log2_denom = rng.range(0, 7);
      h.chroma_log2_denom = rng.range(0, 7);
      for (int i = 0; i < h.num_ref_active[0]; i++) {
        h.luma_flag[0][i] = rng.chance(60);
        h.luma_w[0][i] = rng.range(-(1 << h.luma_log2_denom), 3 << h.luma_log2_denom);
        h.luma_w[0][i] = clip3(-128, 127, h.luma_w[0][i]);
        h.luma_o[0][i] = rng.range(-30, 30);
        h.chroma_flag[0][i] = rng.chance(60);
        for (int j = 0; j < 2; j++) {
          h.chroma_w[0][i][j] = clip3(-128, 127, rng.range(-(1 << h.chroma_log2_denom), 3 << h.chroma_log2_denom));
          h.chroma_o[0][i][j] = rng.range(-30, 30);
        }
      }
    }
    if (pps.weighted_bipred_idc == 1 && b) {
      // weights in [-64, 63]: any pair's sum stays in the range a
      // bi-predicted block allows; denominators up to 6, so that a
      // pair of default weights does too
      h.luma_log2_denom = rng.range(0, 6);
      h.chroma_log2_denom = rng.range(0, 6);
      for (int l = 0; l < 2; l++)
        for (int i = 0; i < h.num_ref_active[l]; i++) {
          h.luma_flag[l][i] = rng.chance(60);
          h.luma_w[l][i] = h.luma_flag[l][i] ? rng.range(-64, 63) : 1 << h.luma_log2_denom;
          h.luma_o[l][i] = h.luma_flag[l][i] ? rng.range(-30, 30) : 0;
          h.chroma_flag[l][i] = rng.chance(60);
          for (int j = 0; j < 2; j++) {
            h.chroma_w[l][i][j] = h.chroma_flag[l][i] ? rng.range(-64, 63) : 1 << h.chroma_log2_denom;
            h.chroma_o[l][i][j] = h.chroma_flag[l][i] ? rng.range(-30, 30) : 0;
          }
        }
    }
  }

  // Whether temporal direct prediction is legal and read alike by the
  // decoder and FFmpeg: every picture the co-located picture's blocks
  // reference is in RefPicList0 (FFmpeg, which finds it by frame_num, must
  // find the same entry first), and every scaled vector is in range.
  bool temporal_ok(Picture* const* l0, int n0, const Picture* col, int cur_poc) {
    if (!col) return false;
    for (const MbState& m : col->mbs) {
      if (is_intra(m.type)) continue;
      for (int b8 = 0; b8 < 4; b8++) {
        int lc = m.ref[0][b8] >= 0 ? 0 : 1;
        int id = m.refpic[lc][b8], idx = -1;
        for (int i = 0; i < n0 && idx < 0; i++)
          if (l0[i] && l0[i]->id == id) idx = i;
        if (idx < 0) return false;
        for (int i = 0; i < idx; i++)
          if (l0[i] && l0[i]->frame_num == l0[idx]->frame_num) return false;
        const Picture* p0 = l0[idx];
        if (p0->long_ref || col->poc == p0->poc) continue;
        int dsf = dist_scale(cur_poc, p0->poc, col->poc);
        for (int k = 0; k < 16; k++) {
          if (b8_of(k) != b8) continue;
          for (int c = 0; c < 2; c++) {
            int v = (dsf * m.mv[lc][k][c] + 128) >> 8, v1 = v - m.mv[lc][k][c];
            int lim = c ? 2047 : 8191;
            if (v < -lim - 1 || v > lim || v1 < -lim - 1 || v1 > lim) return false;
          }
        }
      }
    }
    return true;
  }

  // A picture of the plan (B pictures on): the reference-list fields are
  // drawn once for every slice of the picture, since FFmpeg maps a
  // co-located picture's references through its last slice's lists.
  void picture_b(bool content) {
    const Coded& c = plan[frame_index];
    int max_fn = 1 << sps.log2_max_frame_num;
    SliceHeader h;
    h.nal_ref_idc = !c.ref ? 0 : content ? 3 : rng.range(1, 3);
    h.nal_type = c.idr ? 5 : 1;
    h.idr = c.idr;
    h.pps_id = pps.id;
    h.frame_num = c.idr ? 0 : (dec.prev_ref_frame_num + 1) % max_fn;
    h.idr_pic_id = frame_index & 1;
    h.poc_lsb = c.poc % (1 << sps.log2_max_poc_lsb);
    cur_poc = c.poc;
    if (h.nal_ref_idc && c.idr)
      h.long_term_reference = o[O_LONG_TERM] && rng.chance(50);
    else if (h.nal_ref_idc)
      choose_marking(h, content);
    if (c.type != SLICE_I) {
      h.slice_type = c.type;
      int avail = 0;
      for (auto& pic : dec.dpb) avail += pic->is_ref();
      draw_lists(h, content, avail);
      if (c.type == SLICE_B && !h.direct_spatial) {
        Picture* l[2][33];
        int n[2];
        for (int k = 0; k < 2; k++) dec.build_list(h, k, c.poc, l[k], n[k]);
        if (!temporal_ok(l[0], n[0], l[1][0], c.poc)) h.direct_spatial = 1;
      }
    }
    int total = mb_w * mb_h;
    std::vector<int> starts = slice_starts(content, total);
    mbs.assign(total, MbState());
    for (auto& m : mbs) m.reset(-1);
    // P pictures may mix I and P slices after a first P slice (FFmpeg
    // keeps a picture's lists, for temporal direct, from its first slice
    // when it decodes in threads); B pictures are B slices only
    bool mixed = c.type == SLICE_P && !content && rng.chance(20);
    int same = !mixed && !content && rng.chance(50) ? 5 : 0;
    for (size_t si = 0; si < starts.size(); si++) {
      int first_mb = starts[si], last_mb = si + 1 < starts.size() ? starts[si + 1] - 1 : total - 1;
      SliceHeader sh = h;
      sh.first_mb = first_mb;
      int type = mixed && rng.chance(30) && si ? SLICE_I : c.type;
      sh.slice_type = type;
      sh.raw_slice_type = type + same;
      slice(sh, (int)si, first_mb, last_mb, content);
    }
    frame_index++;
  }

  // Whether the decoder would accept this marking after the current
  // picture (frame_num of h): marking runs on the follower's DPB, restored.
  bool marking_ok(const SliceHeader& h) {
    struct Snap {
      bool s, l;
      int idx, wrap;
    };
    std::vector<Snap> snap;
    for (auto& p : dec.dpb) snap.push_back({p->short_ref, p->long_ref, p->lt_idx, p->frame_num_wrap});
    int max_lt = dec.max_lt_idx;
    dec.dpb.push_back(std::make_unique<Picture>());  // the current picture, as decoding has it
    Picture& tmp = *dec.dpb.back();
    tmp.frame_num = h.frame_num;
    dec.cur = &tmp;
    bool ok = true;
    try {
      dec.mark(h);
      ok = tmp.is_ref();  // not, say, made long-term and then dropped by MMCO 4
    } catch (const Error&) {
      ok = false;
    }
    dec.cur = nullptr;
    dec.dpb.pop_back();
    for (size_t i = 0; i < snap.size(); i++) {
      Picture& p = *dec.dpb[i];
      p.short_ref = snap[i].s;
      p.long_ref = snap[i].l;
      p.lt_idx = snap[i].idx;
      p.frame_num_wrap = snap[i].wrap;
    }
    dec.max_lt_idx = max_lt;
    return ok;
  }

  void random_mmcos(SliceHeader& h) {
    int max_fn = 1 << sps.log2_max_frame_num;
    std::vector<Picture*> st, lt;
    references(h.frame_num, st, lt);
    auto wrap = [&](Picture* p) { return p->frame_num > h.frame_num ? p->frame_num - max_fn : p->frame_num; };
    int max_lt = dec.max_lt_idx;
    bool lt_ok = o[O_LONG_TERM];
    int n = rng.range(1, 3);
    bool once[7] = {false};  // MMCO 4 and 6 at most once a picture; 5 alone
    for (int i = 0; i < n; i++) {
      static const int kOps[8] = {1, 1, 2, 3, 4, 6, 1, 5};
      int op = kOps[rng.range(0, 7)];
      if (o[O_MMCO] == 2 && i == 0 && rng.chance(50)) op = 5;  // mmco 2: MMCO 5 often
      if (lt_ok && max_lt < 0 && i == 0 && rng.chance(50)) op = 4;  // then room for long-term ones
      if (op == 5 && (i || !plan.empty())) continue;  // (B pictures: no MMCO 5)
      if ((op == 4 || op == 6) && once[op]) continue;
      once[op] = true;
      Mmco m{op, 0, 0};
      if ((op == 1 || op == 3) && !st.empty()) {
        m.a = h.frame_num - wrap(st[rng.range(0, (int)st.size() - 1)]) - 1;
        if (op == 3) {
          if (!lt_ok || max_lt < 0) continue;
          m.b = rng.range(0, max_lt);
        }
      } else if (op == 2 && !lt.empty()) {
        m.a = lt[rng.range(0, (int)lt.size() - 1)]->lt_idx;
      } else if (op == 4 && lt_ok) {
        m.a = rng.range(max_lt < 0 ? 1 : 0, 3);
        max_lt = m.a - 1;
      } else if (op == 6 && lt_ok && max_lt >= 0) {
        m.b = rng.range(0, max_lt);
      } else if (op == 5) {
        h.mmcos.push_back(m);
        return;
      } else {
        continue;
      }
      h.mmcos.push_back(m);
    }
  }

  // dec_ref_pic_marking of a non-IDR reference picture: a random MMCO
  // list or the sliding window, whichever the decoder accepts; else MMCO 5
  // (with B pictures: every reference dropped by MMCO 1 and 2).
  void choose_marking(SliceHeader& h, bool content) {
    for (int attempt = 0; attempt < 40; attempt++) {
      h.mmcos.clear();
      h.adaptive = !content && ((o[O_MMCO] && rng.chance(50)) || attempt >= 10);
      if (h.adaptive) random_mmcos(h);
      if (h.adaptive && h.mmcos.empty()) continue;
      if (marking_ok(h)) return;
    }
    h.adaptive = 1;
    h.mmcos = {{5, 0, 0}};
    if (plan.empty()) return;
    h.mmcos.clear();
    int max_fn = 1 << sps.log2_max_frame_num;
    for (auto& p : dec.dpb) {
      if (p->short_ref) {
        int wrap = p->frame_num > h.frame_num ? p->frame_num - max_fn : p->frame_num;
        h.mmcos.push_back({1, h.frame_num - wrap - 1, 0});
      } else if (p->long_ref) {
        h.mmcos.push_back({2, p->lt_idx, 0});
      }
    }
    if (!marking_ok(h)) fail("H.264 writer: no legal marking");
  }

  // the first macroblocks of a picture's slices: random, or in content
  // pictures one slice every O_SLICES macroblock rows (one when 0)
  std::vector<int> slice_starts(bool content, int total) {
    std::vector<int> starts = {0};
    if (content) {
      for (int r = o[O_SLICES]; o[O_SLICES] > 0 && r < mb_h; r += o[O_SLICES]) starts.push_back(r * mb_w);
      return starts;
    }
    int n_slices = rng.range(1, std::max(1, std::min(o[O_SLICES], total)));
    for (int i = 1; i < n_slices; i++) starts.push_back(rng.range(1, total - 1));
    std::sort(starts.begin(), starts.end());
    starts.erase(std::unique(starts.begin(), starts.end()), starts.end());
    return starts;
  }

  void slice(SliceHeader& h, int slice_num, int first_mb, int last_mb, bool content) {
    bool p = h.slice_type == SLICE_P, b = h.slice_type == SLICE_B;
    // reference list choices
    int valid[2] = {0, 0};
    Picture* list[2][33] = {};
    int n[2] = {0, 0};
    if (p || b) {
      int nshort = 0, nlong = 0;
      for (auto& pic : dec.dpb) {
        if (pic.get() == dec.cur) continue;
        nshort += pic->short_ref;
        nlong += pic->long_ref;
      }
      int avail = nshort + nlong;
      if (!avail) fail("H.264 writer: a P or B slice with no reference");
      if (plan.empty()) draw_lists(h, content, avail);
      for (int l = 0; l <= b; l++) {
        dec.build_list(h, l, cur_poc, list[l], n[l]);
        while (valid[l] < n[l] && list[l][valid[l]]) valid[l]++;
        if (!valid[l]) fail("H.264 writer: no valid reference");
      }
      h.cabac_init_idc = content ? 0 : rng.range(0, 2);
    }
    int qp = content ? 26 : rng.range(o[O_QP_MIN], o[O_QP_MAX]);
    h.slice_qp_delta = qp - pps.pic_init_qp;
    if (pps.deblocking_control) {
      h.disable_deblocking = o[O_DEBLOCK] == 2 ? rng.range(0, 2) : o[O_DEBLOCK] == 3 ? 1 : 0;
      h.alpha_offset = rng.range(-6, 6);
      h.beta_offset = rng.range(-6, 6);
    }
    BitWriter bw;
    WriteEngine e;
    e.bw = &bw;
    const Pps* pp = &pps;
    const Sps* sp = &sps;
    auto lookup = [&](int, const Pps*& a, const Sps*& b) {
      a = pp;
      b = sp;
    };
    slice_header_syntax(e, h, lookup, pp, sp);
    SliceState s;
    s.sps = &sps;
    s.pps = &pps;
    s.h = &h;
    s.slice_num = slice_num;
    s.type = h.slice_type;
    s.cabac = pps.cabac;
    s.mb_w = mb_w;
    s.mb_h = mb_h;
    s.mbs = mbs.data();
    s.qp = qp;
    s.cur_poc = cur_poc;
    s.direct_spatial = h.direct_spatial;
    for (int l = 0; l < 2; l++) {
      s.num_ref[l] = n[l];
      s.list[l] = list[l];
    }
    Plan plan;
    plan.first = first_mb;
    plan.last = last_mb;
    plan.skip.assign(last_mb - first_mb + 1, 0);
    plan.direct16.assign(last_mb - first_mb + 1, 0);
    if ((p || b) && !content) {
      int rate = o[O_SKIP];
      for (auto& k : plan.skip) k = rng.chance(rate);
    }
    SliceCb cb{this, &plan, valid, content, MbSyn()};
    if ((p || b) && content) {
      // skipped where the skip prediction is the pan: decided in order, as
      // it depends on the macroblocks before
      content_slice(e, s, cb, plan);
    } else {
      slice_data(e, s, cb);
    }
    if (s.cabac) {
      while (!bw.aligned()) bw.put(1, 0);
    } else {
      bw.trailing();
    }
    emit(h.nal_ref_idc, h.nal_type, bw);
  }

  // slice_data of a content P or B slice: every macroblock is P_Skip /
  // B_Skip when the skip prediction is the pan (one B macroblock in four
  // B_Direct_16x16 instead), else P_L0_16x16 / B_Bi_16x16 with the pan's
  // vectors
  void content_slice(WriteEngine& e, SliceState& s, SliceCb& cb, Plan& plan) {
    // decide the plan with a dry run of the vectors
    std::vector<MbState> saved = mbs;
    for (int addr = plan.first; addr <= plan.last; addr++) {
      s.begin_mb(addr);
      if (skip_matches(s)) {
        if (s.type == SLICE_B && addr % 4 == 0)
          plan.direct16[addr - plan.first] = 1;
        else
          plan.skip[addr - plan.first] = 1;
        skip_mv(s);
      } else {
        MbSyn m;
        m.clear_motion();
        int target[2][4][4][2] = {};
        content_mb(s, m, target, false);
        derive_mvs(s, m, target);
      }
    }
    mbs = saved;
    s.mbs = mbs.data();
    slice_data(e, s, cb);
  }
};

}  // namespace h264w

using h264w::Writer;

extern "C" {

Writer* h264w_new() {
  try {
    return new Writer();
  } catch (...) {
    return nullptr;
  }
}

void h264w_free(Writer* w) { delete w; }

const char* h264w_error(Writer* w) { return w->error.c_str(); }

// The exerciser: `opts` in the order of h264w::Opt.  Returns 0, or -1.
int h264w_exercise(Writer* w, const int* opts, int n) {
  try {
    if (n != h264w::O_COUNT) h264::fail("h264w_exercise: %d options, expected %d", n, (int)h264w::O_COUNT);
    std::memcpy(w->o, opts, sizeof w->o);
    w->rng = h264w::Rng((uint64_t)opts[h264w::O_SEED]);
    w->setup_exerciser(opts[h264w::O_WIDTH], opts[h264w::O_HEIGHT]);
    for (int i = 0; i < opts[h264w::O_FRAMES]; i++) w->picture(false, 0);
    w->dec.flush();
    return 0;
  } catch (const std::exception& e) {
    w->error = e.what();
    return -1;
  }
}

// Content: `n_pcm` I_PCM pictures of the packed I420 `frames` (width x
// height, even), then `n_p` P pictures panning (pan_x, pan_y) quarter
// samples a picture; with `bframes` > 0 (one I_PCM picture), `n_p`
// pictures in groups of `bframes` B pictures (a pyramid) before each P
// picture.  Returns 0, or -1.
int h264w_content(Writer* w, const uint8_t* frames, int n_pcm, int width, int height, int n_p,
                  int pan_x, int pan_y, int cabac, int bframes, int slice_rows) {
  try {
    using namespace h264w;
    std::memset(w->o, 0, sizeof w->o);
    w->o[O_SLICES] = slice_rows;
    w->o[O_PROFILE] = cabac ? 77 : 66;
    w->o[O_CABAC] = cabac;
    w->o[O_REFS] = 1;
    w->o[O_QP_MIN] = w->o[O_QP_MAX] = 26;
    w->o[O_POC_TYPE] = 0;
    w->o[O_LOG2_POC_LSB] = 8;
    w->mb_w = (width + 15) / 16;
    w->mb_h = (height + 15) / 16;
    int W = w->mb_w * 16, H = w->mb_h * 16;
    // MB-aligned copies, edges repeated
    w->planes.assign((size_t)n_pcm * W * H * 3 / 2, 0);
    for (int f = 0; f < n_pcm; f++) {
      const uint8_t* src = frames + (size_t)f * width * height * 3 / 2;
      uint8_t* dst = w->planes.data() + (size_t)f * W * H * 3 / 2;
      for (int y = 0; y < H; y++)
        for (int x = 0; x < W; x++)
          dst[(size_t)y * W + x] = src[(size_t)std::min(y, height - 1) * width + std::min(x, width - 1)];
      for (int c = 0; c < 2; c++) {
        const uint8_t* s = src + (size_t)width * height + (size_t)c * (width / 2) * (height / 2);
        uint8_t* d = dst + (size_t)W * H + (size_t)c * (W / 2) * (H / 2);
        for (int y = 0; y < H / 2; y++)
          for (int x = 0; x < W / 2; x++)
            d[(size_t)y * (W / 2) + x] =
                s[(size_t)std::min(y, height / 2 - 1) * (width / 2) + std::min(x, width / 2 - 1)];
      }
    }
    w->pan_x = pan_x;
    w->pan_y = pan_y;
    if (bframes) {
      if (n_pcm != 1) h264::fail("H.264 writer: B content starts with one I_PCM picture");
      w->o[O_BFRAMES] = bframes;
      w->plan_b(1 + n_p, bframes, true, 0, false);
    }
    h264::Sps& sps = w->sps;
    sps = h264::Sps();
    sps.profile_idc = cabac || bframes ? 77 : 66;  // Main for B slices
    sps.constraints = cabac || bframes ? 0x40 : 0xC0;
    sps.level_idc = W * H > 414720 ? 40 : 31;
    sps.log2_max_frame_num = 8;
    sps.poc_type = 0;
    sps.log2_max_poc_lsb = 8;
    sps.max_num_ref_frames = bframes ? 3 : 1;
    sps.width_mbs = w->mb_w;
    sps.height_mbs = w->mb_h;
    sps.cropping = W != width || H != height;
    sps.crop_right = (W - width) / 2;
    sps.crop_bottom = (H - height) / 2;
    h264::Pps& pps = w->pps;
    pps = h264::Pps();
    pps.cabac = cabac;
    pps.pic_init_qp = 26;
    w->write_sps();
    w->write_pps();
    for (int i = 0; i < n_pcm + n_p; i++) w->picture(true, n_pcm);
    w->dec.flush();
    return 0;
  } catch (const std::exception& e) {
    w->error = e.what();
    return -1;
  }
}

long h264w_size(Writer* w) { return (long)w->out.size(); }

void h264w_copy(Writer* w, uint8_t* out) { std::memcpy(out, w->out.data(), w->out.size()); }

}  // extern "C"
