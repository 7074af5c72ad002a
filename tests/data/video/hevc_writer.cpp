// A writer of legal H.265 I/P streams from a seed, for the tests of the
// port's decoder (adas_tpu_torch/native/hevc.cpp).  It includes the
// decoder's source for its syntax layer: parameter sets, slice headers and
// coding tree units are written by the same functions that read them,
// with the decoder's own state (a Decoder that follows the stream: POC,
// RPS, DPB, merge and AMVP candidates, intra MPMs) and this file's Policy
// choosing every value.  cv2's FFmpeg is the independent judge of what the
// two share.  Built by tests/data/video/hevc_writer.py.
//
// Two modes:
// - exerciser: random legal syntax over the decoder's tools, not pictures,
//   with options that turn each tool on and off (O_*);
// - content: PCM pictures of given frames, then P pictures of a
//   quarter-sample pan, each coding unit a merge (skip) or an AMVP
//   prediction with no residual.
#include "../../../adas_tpu_torch/native/hevc.cpp"

#include <map>

namespace hevcw {
using namespace hevc;

struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed * 0x9E3779B97F4A7C15ull + 0x7654321ull) {}
  uint32_t next() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return (uint32_t)(s >> 11);
  }
  int range(int lo, int hi) {
    if (hi < lo) fail("H.265 writer: an empty range %d..%d", lo, hi);
    return lo + (int)(next() % (uint32_t)(hi - lo + 1));
  }
  bool chance(int percent) { return (int)(next() % 100) < percent; }
};

// Exerciser options, in the order hevc_writer.py passes them.
enum Opt {
  O_WIDTH, O_HEIGHT, O_FRAMES, O_SEED, O_CTB, O_MIN_CB, O_AMP, O_TU_DEPTH, O_MAX_TB, O_INTRA_IN_P,
  O_SKIP, O_PCM, O_PCM_BITS, O_PCM_LF, O_TSKIP, O_SIGN_HIDING, O_QP_DELTA, O_CHROMA_QP, O_SCALING,
  O_CIP, O_STRONG, O_TMVP, O_REFS, O_MERGE_LEVEL, O_MAX_MERGE, O_DEBLOCK, O_SAO, O_WPP, O_SLICES,
  O_ACROSS, O_CABAC_INIT, O_QP_MIN, O_QP_MAX, O_IDR_EVERY, O_CRA, O_REORDER, O_OUTPUT_FLAG,
  O_CONF_WIN, O_SPS_RPS, O_LIST_MOD, O_VUI, O_LOG2_POC_LSB, O_BIG_LEVELS, O_TRAIL_START, O_COUNT
};

struct Pic {
  int poc = 0, type = NAL_TRAIL_R, output = 1;
  std::vector<int> rps;        // POC deltas kept (sorted as FFmpeg keeps them)
  std::vector<uint8_t> used;   // which are references of the picture
};

struct Writer : Policy {
  std::string error;
  std::vector<uint8_t> out;
  int o[O_COUNT];
  Rng rng{1};
  Decoder dec;  // follows the stream, and codes its syntax
  Vps vps;
  Sps sps;
  Pps pps;
  bool content = false;
  // content mode
  std::vector<uint8_t> planes;  // the PCM pictures, CTB-aligned copies
  int pcm_index = 0, pan_x = 0, pan_y = 0, content_w = 0, content_h = 0;
  std::vector<int> slice_starts;  // the CTB of each slice of the current picture
  int pic_qp = 26;

  Writer() {
    dec.pol = this;
    dec.writing = true;
  }

  // ---------------------------------------------------------------- policy

  int end_of_slice(int ctb_rs) override {
    for (int s : slice_starts)
      if (s == ctb_rs + 1) return 1;
    return 0;
  }

  void sao(int, int, int can_left, int can_up, int& ml, int& mu, SaoParams& p) override {
    if (content) return;
    ml = can_left && rng.chance(25);
    mu = can_up && rng.chance(25);
    for (int c = 0; c < 3; c++) {
      p.type[c] = (int8_t)rng.range(0, 2);
      for (int i = 0; i < 4; i++) p.offset[c][i] = (int8_t)rng.range(-7, 7);
      p.band[c] = (uint8_t)rng.range(0, 31);
      p.eo[c] = (uint8_t)rng.range(0, 3);
    }
  }

  int split_cu(int x, int y, int log2, int) override {
    if (content) return log2 > 5 || (x + (1 << log2) > dec.W || y + (1 << log2) > dec.H);
    return rng.chance(55);
  }

  bool is_intra_slice() const { return dec.sh.type == SLICE_I; }

  void cu(int x, int y, int log2, const MvField* merge, int nmerge, CuChoice& c) override {
    const Sps& s = dec.as;
    if (content) {
      if (is_intra_slice()) {
        c.pcm = 1;
        c.part = PART_2Nx2N;
        return;
      }
      Mv want = pan_mv();
      c.skip = 0;
      for (int i = 0; i < nmerge; i++)
        if (merge[i].ref == 0 && merge[i].mv == want) c.skip = 1;
      c.part = PART_2Nx2N;
      c.rqt_root_cbf = 0;
      return;
    }
    (void)x;
    (void)y;
    bool intra_slice = is_intra_slice();
    c.skip = !intra_slice && rng.chance(o[O_SKIP]);
    c.intra = intra_slice || rng.chance(o[O_INTRA_IN_P]);
    bool min = log2 == s.log2_min_cb;
    std::vector<int> parts = {PART_2Nx2N};
    if (c.intra) {
      if (min) parts.push_back(PART_NxN);
    } else {
      parts.push_back(PART_2NxN);
      parts.push_back(PART_Nx2N);
      if (min && log2 > 3) parts.push_back(PART_NxN);
      if (!min && s.amp)
        for (int p : {PART_2NxnU, PART_2NxnD, PART_nLx2N, PART_nRx2N}) parts.push_back(p);
    }
    c.part = parts[(size_t)rng.range(0, (int)parts.size() - 1)];
    c.pcm = c.intra && rng.chance(o[O_PCM]);
    for (int i = 0; i < 4; i++) c.luma_mode[i] = rng.chance(30) ? rng.range(0, 2) * 13 % 35 : rng.range(0, 34);
    c.chroma = rng.range(0, 4);
    c.rqt_root_cbf = rng.chance(60);
  }

  Mv pan_mv() const { return {(int16_t)pan_x, (int16_t)pan_y}; }

  void pu(int, int, int, int, int, const MvField* merge, int nmerge, PuChoice& c) override {
    if (content) {
      Mv want = pan_mv();
      for (int i = 0; i < nmerge; i++)
        if (merge[i].ref == 0 && merge[i].mv == want) {
          c.merge = 1;
          c.merge_idx = i;
          return;
        }
      c.merge = 0;
      c.ref_idx = 0;
      c.use_target = 1;
      c.target = want;
      c.mvp = 0;
      return;
    }
    c.merge = rng.chance(45);
    c.merge_idx = rng.range(0, std::max(0, nmerge - 1));
    c.ref_idx = rng.range(0, dec.sh.num_ref_idx[0] - 1);
    c.mvp = rng.range(0, 1);
    if (rng.chance(70)) {
      c.use_target = 1;
      int r = rng.chance(20) ? 256 : 48;
      c.target = {(int16_t)rng.range(-r, r), (int16_t)rng.range(-r, r)};
    } else {
      int r = rng.chance(10) ? 300 : 9;
      c.mvd = {(int16_t)rng.range(-r, r), (int16_t)rng.range(-r, r)};
    }
  }

  int split_tu(int, int, int, int, int) override { return rng.chance(45); }
  int cbf(int c, int, int, int, int) override { return rng.chance(c ? 45 : 60); }
  int qp_delta(int, int) override {
    if (rng.chance(30)) return 0;
    int lo = std::max(-26, o[O_QP_MIN] - pic_qp), hi = std::min(25, o[O_QP_MAX] - pic_qp);
    return rng.range(std::min(lo, hi), std::max(lo, hi));
  }
  int transform_skip(int, int, int) override { return rng.chance(40); }

  void residual(int, int, int, int log2, int16_t* coeff) override {
    int n = 1 << log2;
    std::memset(coeff, 0, sizeof(int16_t) * (size_t)n * n);
    int count = rng.chance(30) ? rng.range(1, 3) : rng.range(1, std::min(n * n, 40));
    int region = rng.chance(50) ? std::min(n, 8) : n;
    for (int k = 0; k < count; k++) {
      int x = rng.range(0, region - 1), y = rng.range(0, region - 1);
      int v = rng.chance(70) ? rng.range(1, 2) : rng.chance(80) ? rng.range(1, 20) : rng.range(1, o[O_BIG_LEVELS] ? 3000 : 200);
      coeff[y * n + x] = (int16_t)(rng.chance(50) ? -v : v);
    }
  }

  void pcm(int x, int y, int log2, int c, uint8_t* samples) override {
    int n = c ? (1 << log2) / 2 : 1 << log2;
    if (content) {
      int W = dec.W, H = dec.H;
      const uint8_t* f = planes.data() + (size_t)pcm_index * W * H * 3 / 2;
      const uint8_t* p = c == 0 ? f : f + (size_t)W * H + (size_t)(c - 1) * (W / 2) * (H / 2);
      int stride = c ? W / 2 : W, xc = c ? x / 2 : x, yc = c ? y / 2 : y;
      for (int j = 0; j < n; j++)
        for (int i = 0; i < n; i++) samples[j * n + i] = p[(size_t)(yc + j) * stride + xc + i];
      return;
    }
    for (int i = 0; i < n * n; i++) samples[i] = (uint8_t)rng.range(0, 255);
  }

  // ---------------------------------------------------------------- NAL units

  void put_nal(int type, const std::vector<uint8_t>& payload) {
    static const uint8_t start[4] = {0, 0, 0, 1};
    out.insert(out.end(), start, start + 4);
    out.push_back((uint8_t)(type << 1));
    out.push_back(1);
    std::vector<uint8_t> esc = escape(payload);
    out.insert(out.end(), esc.begin(), esc.end());
    // the decoder follows the parameter sets
    if (type == NAL_VPS || type == NAL_SPS || type == NAL_PPS) {
      std::vector<uint8_t> nal = {(uint8_t)(type << 1), 1};
      nal.insert(nal.end(), esc.begin(), esc.end());
      dec.nal(nal.data(), nal.size());
    }
  }

  void write_parameter_sets() {
    {
      BitWriter bw;
      WriteEngine e;
      e.bw = &bw;
      vps_syntax(e, vps);
      bw.trailing();
      put_nal(NAL_VPS, bw.buf);
    }
    {
      BitWriter bw;
      WriteEngine e;
      e.bw = &bw;
      Sps s = sps;
      sps_syntax(e, s, nullptr);
      bw.trailing();
      put_nal(NAL_SPS, bw.buf);
    }
    {
      BitWriter bw;
      WriteEngine e;
      e.bw = &bw;
      Pps p = pps;
      pps_syntax(e, p, nullptr);
      bw.trailing();
      put_nal(NAL_PPS, bw.buf);
    }
  }

  // one slice: its data through the decoder's walker, then its header
  // with the entry points of its substreams
  void write_slice(SliceHeader& h) {
    const Pps* pp = dec.pps[h.pps_id].get();
    const Sps* sp = dec.sps[pp->sps_id].get();
    const Pps* ptab[64];
    const Sps* stab[16];
    for (int i = 0; i < 64; i++) ptab[i] = dec.pps[i].get();
    for (int i = 0; i < 16; i++) stab[i] = dec.sps[i].get();
    {  // the header's derived fields (its RPS, the slice QP)
      BitWriter tmp;
      WriteEngine te;
      te.bw = &tmp;
      const Pps* p2;
      const Sps* s2;
      h.num_entry_points = 0;
      slice_header_syntax(te, h, ptab, stab, p2, s2);
    }
    dec.begin_slice(h, pp, sp);
    BitWriter data;
    WriteEngine de;
    de.bw = &data;
    dec.substreams.clear();
    dec.slice_data(de);
    data.align_zero();  // after the stop bit the flush wrote
    std::vector<size_t> starts = dec.substreams;
    h.num_entry_points = (int)starts.size();
    h.offset_len = 32;
    h.entry_points.assign(starts.size(), 1);
    std::vector<uint8_t> payload;
    for (int iter = 0; iter < 4; iter++) {
      BitWriter hb;
      WriteEngine he;
      he.bw = &hb;
      SliceHeader hh = h;
      const Pps* p2;
      const Sps* s2;
      slice_header_syntax(he, hh, ptab, stab, p2, s2);
      hb.put(1, 1);  // byte_alignment()
      hb.align_zero();
      payload = hb.buf;
      size_t head = payload.size();
      payload.insert(payload.end(), data.buf.begin(), data.buf.end());
      // substream sizes with the emulation prevention bytes inside them
      std::vector<size_t> esc_pos(payload.size() + 1);
      int zeros = 0;
      size_t q = 0;
      for (size_t i = 0; i < payload.size(); i++) {
        if (zeros >= 2 && payload[i] <= 3) {
          q++;
          zeros = 0;
        }
        esc_pos[i] = q++;
        zeros = payload[i] == 0 ? zeros + 1 : 0;
      }
      esc_pos[payload.size()] = q;
      bool same = true;
      std::vector<size_t> bounds = {0};
      for (size_t s : starts) bounds.push_back(s);
      for (size_t k = 0; k < starts.size(); k++) {
        uint32_t size = (uint32_t)(esc_pos[head + bounds[k + 1]] - esc_pos[head + bounds[k]]);
        if (h.entry_points[k] != size) same = false;
        h.entry_points[k] = size;
      }
      if (same) break;
    }
    out.insert(out.end(), {0, 0, 0, 1});
    out.push_back((uint8_t)(h.nal_type << 1));
    out.push_back(1);
    std::vector<uint8_t> esc = escape(payload);
    out.insert(out.end(), esc.begin(), esc.end());
  }

  // ---------------------------------------------------------------- pictures

  void plan_slices() {
    slice_starts.clear();
    int total = dec.as.ctb_w * dec.as.ctb_h, n = std::max(1, o[O_SLICES]);
    std::vector<int> cand;
    for (int a = 1; a < total; a++)
      if (!dec.ap.wpp || a % dec.as.ctb_w == 0) cand.push_back(a);
    slice_starts.push_back(0);
    for (int k = 1; k < n && !cand.empty(); k++) {
      size_t i = (size_t)rng.range(0, (int)cand.size() - 1);
      slice_starts.push_back(cand[i]);
      cand.erase(cand.begin() + (long)i);
    }
    std::sort(slice_starts.begin(), slice_starts.end());
  }

  // the RPS of a picture as the syntax codes it, from its deltas
  static ShortTermRps explicit_rps(const Pic& p) {
    ShortTermRps r;
    std::vector<std::pair<int, int>> neg, pos;
    for (size_t i = 0; i < p.rps.size(); i++) (p.rps[i] < 0 ? neg : pos).push_back({p.rps[i], p.used[i]});
    std::sort(neg.begin(), neg.end(), [](auto a, auto b) { return a.first > b.first; });
    std::sort(pos.begin(), pos.end());
    r.num_negative = (int)neg.size();
    r.num_delta = (int)(neg.size() + pos.size());
    int k = 0;
    for (auto& v : neg) {
      r.delta_poc[k] = v.first;
      r.used[k++] = (uint8_t)v.second;
    }
    for (auto& v : pos) {
      r.delta_poc[k] = v.first;
      r.used[k++] = (uint8_t)v.second;
    }
    return r;
  }

  // an inter-predicted coding of `t` from `ref` when one exists
  static bool inter_rps(const ShortTermRps& ref, const ShortTermRps& t, int delta_rps, ShortTermRps& out) {
    out = t;
    out.inter = 1;
    out.delta_idx_minus1 = 0;
    out.delta_rps_sign = delta_rps < 0;
    out.abs_delta_rps_minus1 = std::abs(delta_rps) - 1;
    int covered = 0;
    for (int j = 0; j <= ref.num_delta; j++) {
      int d = j < ref.num_delta ? ref.delta_poc[j] + delta_rps : delta_rps;
      int found = -1;
      for (int i = 0; i < t.num_delta; i++)
        if (t.delta_poc[i] == d) found = i;
      if (found >= 0 && d != 0) {
        out.used_by_curr[j] = t.used[found];
        out.use_delta[j] = 1;
        covered++;
      } else {
        out.used_by_curr[j] = 0;
        out.use_delta[j] = 0;
      }
    }
    return covered == t.num_delta && delta_rps != 0;
  }

  std::vector<Pic> plan;

  // the pictures in decoding order: POCs, types, RPSs
  void plan_gop(int frames) {
    int refs = std::max(1, o[O_REFS]);
    int every = o[O_IDR_EVERY];
    // display order indices in decoding order
    std::vector<int> order;
    for (int i = 0; i < frames; i++) order.push_back(i);
    if (o[O_REORDER])
      for (int i = 1; i + 1 < frames; i += 2) {
        bool irap_b = every && (i + 1) % every == 0;
        bool irap_a = every && i % every == 0;
        // before a CRA picture the swap makes a leading (RASL) picture
        if (!irap_a && (!irap_b || o[O_CRA])) std::swap(order[(size_t)i], order[(size_t)i + 1]);
      }
    int poc_base = 0, cra_poc = INT_MIN;
    std::vector<int> decoded;  // POCs held as references, decoding order
    std::vector<int> before_cra;  // those kept by the last CRA picture
    for (int k = 0; k < frames; k++) {
      int d = order[(size_t)k];
      Pic p;
      if (d - poc_base < cra_poc) {  // a leading picture of the CRA picture: RASL
        p.type = NAL_RASL_N;
        p.poc = d - poc_base;
        for (int q : before_cra) {
          p.rps.push_back(q - p.poc);
          p.used.push_back(1);
        }
        p.rps.push_back(cra_poc - p.poc);
        p.used.push_back((uint8_t)rng.chance(50));
        p.output = 1;
        plan.push_back(p);
        continue;
      }
      bool irap = (d == 0 && !o[O_TRAIL_START]) || (every && d % every == 0 && d > 0);
      if (d == 0 && o[O_TRAIL_START]) {  // a stream that starts without an IRAP picture: an I picture, no references
        p.type = NAL_TRAIL_R;
        poc_base = 0;
      } else if (irap && (d == 0 || !o[O_CRA])) {
        p.type = NAL_IDR_W_RADL;
        poc_base = d;
        decoded.clear();
      } else if (irap) {
        p.type = NAL_CRA;
      }
      p.poc = d - poc_base;
      if (p.type != NAL_IDR_W_RADL) {
        std::vector<int> keep;
        for (size_t i = decoded.size() > (size_t)refs ? decoded.size() - (size_t)refs : 0; i < decoded.size(); i++)
          keep.push_back(decoded[i]);
        for (int q : keep) {
          p.rps.push_back(q - p.poc);
          p.used.push_back(p.type == NAL_CRA ? 0 : (uint8_t)(rng.chance(85) || keep.size() == 1));
        }
        if (p.type != NAL_CRA) {
          bool any = false;
          for (uint8_t u : p.used) any |= u;
          if (!any && !p.used.empty()) p.used.back() = 1;
        }
      }
      p.output = !o[O_OUTPUT_FLAG] || rng.chance(80);
      decoded.push_back(p.poc);
      if (p.type == NAL_CRA) {
        before_cra.clear();
        for (int dlt : p.rps) before_cra.push_back(p.poc + dlt);
        decoded.clear();
        decoded.push_back(p.poc);
        cra_poc = p.poc;
      } else if (p.type == NAL_IDR_W_RADL) {
        cra_poc = INT_MIN;
      }
      plan.push_back(p);
    }
  }

  void setup(int width, int height) {
    const int ctb_log2 = o[O_CTB] == 64 ? 6 : o[O_CTB] == 16 ? 4 : 5;
    const int min_cb_log2 = std::min(ctb_log2, o[O_MIN_CB] == 16 ? 4 : o[O_MIN_CB] == 32 ? 5 : 3);
    int cw = 1 << min_cb_log2;
    int W = (width + cw - 1) / cw * cw, H = (height + cw - 1) / cw * cw;
    sps = Sps();
    sps.max_sub_layers = 1;
    sps.width = W;
    sps.height = H;
    if (o[O_CONF_WIN]) {  // two samples off the top edge too (2: and the left edge)
      W = (width + 2 * (o[O_CONF_WIN] > 1) + cw - 1) / cw * cw;
      H = (height + 2 + cw - 1) / cw * cw;
      sps.width = W;
      sps.height = H;
      sps.conf_top = 1;
      sps.conf_left = o[O_CONF_WIN] > 1;
    }
    if (W != width || H != height) {
      sps.conf_win = 1;
      sps.conf_right = (W - width) / 2 - sps.conf_left;
      sps.conf_bottom = (H - height) / 2 - sps.conf_top;
    }
    sps.log2_max_poc_lsb = o[O_LOG2_POC_LSB] ? o[O_LOG2_POC_LSB] : 8;
    int reorder = o[O_REORDER] ? 1 : 0, refs = std::max(1, o[O_REFS]);
    sps.ordering[0].num_reorder = reorder;
    sps.ordering[0].max_dec_pic_buffering = std::min(16, refs + reorder + 2);
    sps.ordering[0].max_latency_increase_plus1 = 0;
    sps.log2_min_cb = min_cb_log2;
    sps.log2_diff_max_min_cb = ctb_log2 - min_cb_log2;
    sps.log2_min_tb = 2;
    int max_tb = std::min(o[O_MAX_TB] ? o[O_MAX_TB] : 5, std::min(5, ctb_log2));
    sps.log2_diff_max_min_tb = max_tb - 2;
    sps.max_th_depth_inter = std::min(o[O_TU_DEPTH], ctb_log2 - 2);
    sps.max_th_depth_intra = std::min(o[O_TU_DEPTH], ctb_log2 - 2);
    sps.scaling_list_enabled = o[O_SCALING] > 0;
    default_scaling(sps.sl);
    sps.scaling_list_data_present = o[O_SCALING] >= 2;
    if (sps.scaling_list_data_present) {
      for (int s = 0; s < 4; s++)
        for (int m = 0; m < 6; m += s == 3 ? 3 : 1) {
          if (m > 0 && rng.chance(30)) {
            sps.sl.pred_mode[s][m] = 0;
            sps.sl.pred_delta[s][m] = (uint8_t)rng.range(0, m / (s == 3 ? 3 : 1));
          } else if (rng.chance(15)) {
            sps.sl.pred_mode[s][m] = 0;
            sps.sl.pred_delta[s][m] = 0;
          } else {
            sps.sl.pred_mode[s][m] = 1;
            for (int i = 0; i < 64; i++) sps.sl.list[s][m][i] = (uint8_t)rng.range(4, 80);
            sps.sl.dc[s][m] = (uint8_t)rng.range(4, 80);
          }
        }
    }
    sps.amp = o[O_AMP];
    sps.sao = o[O_SAO];
    sps.pcm = o[O_PCM] > 0;
    sps.pcm_bit_depth = sps.pcm_bit_depth_chroma = o[O_PCM_BITS] ? o[O_PCM_BITS] : 8;
    sps.log2_min_pcm = std::max(3, min_cb_log2);
    sps.log2_diff_max_min_pcm = std::min(5, ctb_log2) - sps.log2_min_pcm;
    if (sps.log2_diff_max_min_pcm < 0) {
      sps.pcm = 0;
      sps.log2_diff_max_min_pcm = 0;
    }
    sps.pcm_loop_filter_disabled = o[O_PCM_LF];
    sps.long_term_present = 0;
    sps.temporal_mvp = o[O_TMVP];
    sps.strong_intra_smoothing = o[O_STRONG];
    sps.vui = o[O_VUI];
    sps.num_units_in_tick = 1;
    sps.time_scale = 30;
    pps = Pps();
    pps.sign_hiding = o[O_SIGN_HIDING];
    pps.cabac_init_present = o[O_CABAC_INIT];
    pps.num_ref_idx_default[0] = 1;
    pps.init_qp = std::max(o[O_QP_MIN], std::min(o[O_QP_MAX], 30));
    pps.constrained_intra = o[O_CIP];
    pps.transform_skip = o[O_TSKIP];
    pps.cu_qp_delta = o[O_QP_DELTA] > 0;
    pps.diff_cu_qp_delta_depth = std::max(0, std::min(o[O_QP_DELTA] - 1, ctb_log2 - min_cb_log2));
    pps.cb_qp_offset = o[O_CHROMA_QP] ? rng.range(-6, 6) : 0;
    pps.cr_qp_offset = o[O_CHROMA_QP] ? rng.range(-6, 6) : 0;
    pps.slice_chroma_qp_offsets = o[O_CHROMA_QP];
    pps.wpp = o[O_WPP];
    pps.loop_filter_across_slices = o[O_ACROSS] != 0;
    pps.deblocking_control = o[O_DEBLOCK] > 0;
    pps.deblocking_override = o[O_DEBLOCK] >= 2;
    pps.deblocking_disabled = o[O_DEBLOCK] == 1;
    pps.beta_offset_div2 = o[O_DEBLOCK] >= 2 ? rng.range(-6, 6) : 0;
    pps.tc_offset_div2 = o[O_DEBLOCK] >= 2 ? rng.range(-6, 6) : 0;
    pps.scaling_list_data_present = o[O_SCALING] >= 3;
    if (pps.scaling_list_data_present) {
      default_scaling(pps.sl);
      for (int s = 0; s < 4; s++)
        for (int m = 0; m < 6; m += s == 3 ? 3 : 1) {
          pps.sl.pred_mode[s][m] = 1;
          for (int i = 0; i < 64; i++) pps.sl.list[s][m][i] = (uint8_t)rng.range(8, 40);
          pps.sl.dc[s][m] = (uint8_t)rng.range(8, 40);
        }
    }
    pps.lists_modification = o[O_LIST_MOD];
    pps.log2_parallel_merge = std::min(ctb_log2, 2 + o[O_MERGE_LEVEL]);
    pps.output_flag_present = o[O_OUTPUT_FLAG];
  }

  void sps_rps_sets() {
    if (!o[O_SPS_RPS]) return;
    // the distinct sets, the later ones predicted from the one before where they can be
    std::vector<ShortTermRps> sets;
    std::vector<int> pocs;
    for (const Pic& p : plan) {
      if (p.type == NAL_IDR_W_RADL) continue;
      ShortTermRps r = explicit_rps(p);
      bool found = false;
      for (auto& s : sets)
        if (s.num_delta == r.num_delta && s.num_negative == r.num_negative &&
            std::equal(s.delta_poc, s.delta_poc + s.num_delta, r.delta_poc) &&
            std::equal(s.used, s.used + s.num_delta, r.used))
          found = true;
      if (!found && sets.size() < 64) sets.push_back(r);
    }
    for (size_t i = 1; i < sets.size(); i++) {
      ShortTermRps coded;
      for (int d : {-1, 1, -2, 2, -3, 3}) {
        if (inter_rps(sets[i - 1], sets[i], d, coded)) {
          // the derivation must give the set back
          ShortTermRps tmp[65];
          for (size_t k = 0; k < i; k++) tmp[k] = sets[k];
          tmp[i] = coded;
          BitWriter bw;
          WriteEngine e;
          e.bw = &bw;
          st_ref_pic_set(e, tmp, (int)i, false);
          if (tmp[i].num_delta == sets[i].num_delta &&
              std::equal(tmp[i].delta_poc, tmp[i].delta_poc + tmp[i].num_delta, sets[i].delta_poc) &&
              std::equal(tmp[i].used, tmp[i].used + tmp[i].num_delta, sets[i].used)) {
            sets[i] = tmp[i];
            break;
          }
        }
      }
    }
    sps.num_st_rps = (int)sets.size();
    for (size_t i = 0; i < sets.size(); i++) sps.st_rps[i] = sets[i];
  }

  void picture(const Pic& p) {
    dec.begin_packet();
    SliceHeader h;
    h.nal_type = p.type;
    h.first_slice = 1;
    h.pps_id = 0;
    h.type = is_irap(p.type) || p.rps.empty() ? SLICE_I : (rng.chance(o[O_INTRA_IN_P] > 90 ? 30 : 3) ? SLICE_I : SLICE_P);
    if (content) h.type = is_irap(p.type) ? SLICE_I : SLICE_P;
    h.pic_output = p.output;
    h.poc_lsb = p.poc & ((1 << sps.log2_max_poc_lsb) - 1);
    h.temporal_mvp = o[O_TMVP];
    h.sao_luma = o[O_SAO] && rng.chance(80);
    h.sao_chroma = o[O_SAO] && rng.chance(80);
    int nref = 0;
    for (uint8_t u : p.used) nref += u;
    if (p.type != NAL_IDR_W_RADL) {
      ShortTermRps r = explicit_rps(p);
      int idx = -1;
      for (int i = 0; i < sps.num_st_rps; i++)
        if (sps.st_rps[i].num_delta == r.num_delta &&
            std::equal(r.delta_poc, r.delta_poc + r.num_delta, sps.st_rps[i].delta_poc) &&
            std::equal(r.used, r.used + r.num_delta, sps.st_rps[i].used))
          idx = i;
      if (idx >= 0) {
        h.st_rps_sps = 1;
        h.st_rps_idx = idx;
      } else {
        h.st_rps_sps = 0;
        h.st_rps = r;
        if (sps.num_st_rps > 0) {
          ShortTermRps coded;
          const ShortTermRps& last = sps.st_rps[sps.num_st_rps - 1];
          for (int d : {-1, 1, -2, 2}) {
            if (!inter_rps(last, r, d, coded)) continue;
            ShortTermRps tmp[65];
            for (int k = 0; k < sps.num_st_rps; k++) tmp[k] = sps.st_rps[k];
            tmp[sps.num_st_rps] = coded;
            BitWriter bw;
            WriteEngine e;
            e.bw = &bw;
            st_ref_pic_set(e, tmp, sps.num_st_rps, true);
            if (tmp[sps.num_st_rps].num_delta == r.num_delta &&
                std::equal(r.delta_poc, r.delta_poc + r.num_delta, tmp[sps.num_st_rps].delta_poc)) {
              h.st_rps = tmp[sps.num_st_rps];
              break;
            }
          }
        }
      }
    }
    if (nref == 0 && h.type == SLICE_P) h.type = SLICE_I;
    pic_qp = content ? 26 : rng.range(o[O_QP_MIN], o[O_QP_MAX]);
    h.qp_delta = pic_qp - pps.init_qp;
    int cr = o[O_CHROMA_QP] ? rng.range(-6, 6) : 0, cb = o[O_CHROMA_QP] ? rng.range(-6, 6) : 0;
    h.cb_qp_offset = cb;
    h.cr_qp_offset = cr;
    h.deblocking_override = o[O_DEBLOCK] >= 2 && rng.chance(60);
    h.deblocking_disabled = h.deblocking_override ? rng.chance(30) : pps.deblocking_disabled;
    h.beta_offset_div2 = h.deblocking_override ? rng.range(-6, 6) : pps.beta_offset_div2;
    h.tc_offset_div2 = h.deblocking_override ? rng.range(-6, 6) : pps.tc_offset_div2;
    h.loop_filter_across_slices = o[O_ACROSS] == 2 ? rng.chance(50) : o[O_ACROSS];
    int total_refs = nref;
    h.num_ref_idx[0] = std::min(15, rng.range(1, std::max(1, total_refs) + (rng.chance(20) ? 2 : 0)));
    if (content) h.num_ref_idx[0] = 1;
    h.num_ref_idx_override = h.num_ref_idx[0] != pps.num_ref_idx_default[0];
    h.list_mod = o[O_LIST_MOD] && nref > 1 && rng.chance(60);
    for (int i = 0; i < h.num_ref_idx[0]; i++) h.list_entry[i] = rng.range(0, std::max(0, nref - 1));
    h.cabac_init = o[O_CABAC_INIT] && rng.chance(50);
    h.collocated_ref_idx = rng.range(0, h.num_ref_idx[0] - 1);
    h.max_merge_cand = o[O_MAX_MERGE] ? o[O_MAX_MERGE] : 5;
    h.slice_qp = pic_qp;
    // the decoder needs the PPS's SPS to plan slices
    const Pps* pp = dec.pps[0].get();
    const Sps* sp = dec.sps[pp->sps_id].get();
    dec.activate(pp, sp);
    plan_slices();
    for (size_t k = 0; k < slice_starts.size(); k++) {
      SliceHeader hk = h;
      hk.first_slice = k == 0;
      hk.address = slice_starts[k];
      if (k > 0 && !content) {
        hk.sao_luma = o[O_SAO] && rng.chance(80);
        hk.sao_chroma = o[O_SAO] && rng.chance(80);
        if (o[O_ACROSS] == 2) hk.loop_filter_across_slices = rng.chance(50);
        if (h.deblocking_override || o[O_DEBLOCK] >= 2) {
          hk.deblocking_override = o[O_DEBLOCK] >= 2 && rng.chance(60);
          hk.deblocking_disabled = hk.deblocking_override ? rng.chance(30) : pps.deblocking_disabled;
          hk.beta_offset_div2 = hk.deblocking_override ? rng.range(-6, 6) : pps.beta_offset_div2;
          hk.tc_offset_div2 = hk.deblocking_override ? rng.range(-6, 6) : pps.tc_offset_div2;
        }
        if (o[O_CHROMA_QP]) {
          hk.cb_qp_offset = rng.range(-6, 6);
          hk.cr_qp_offset = rng.range(-6, 6);
        }
        int sq = rng.range(o[O_QP_MIN], o[O_QP_MAX]);
        hk.qp_delta = sq - pps.init_qp;
        hk.slice_qp = sq;
      }
      if (hk.type == SLICE_P && !content && k > 0 && h.type == SLICE_P && rng.chance(15)) hk.type = SLICE_I;
      if (hk.deblocking_override && hk.deblocking_disabled) {  // offsets not coded: the last ones stay
        hk.beta_offset_div2 = dec.last_beta_div2;
        hk.tc_offset_div2 = dec.last_tc_div2;
      }
      pic_qp = hk.slice_qp;
      write_slice(hk);
    }
    dec.end_packet();
    dec.ready.clear();
  }
};

}  // namespace hevcw

// ------------------------------------------------------------------ C interface

using hevcw::Writer;

extern "C" {

Writer* hevcw_new() {
  try {
    return new Writer();
  } catch (...) {
    return nullptr;
  }
}

void hevcw_free(Writer* w) { delete w; }

const char* hevcw_error(Writer* w) { return w->error.c_str(); }

// The exerciser: `opts` in the order of hevcw::Opt.  Returns 0, or -1.
int hevcw_exercise(Writer* w, const int* opts, int n) {
  try {
    using namespace hevcw;
    if (n != O_COUNT) hevc::fail("hevcw_exercise: %d options, expected %d", n, (int)O_COUNT);
    std::memcpy(w->o, opts, sizeof w->o);
    w->rng = Rng((uint64_t)opts[O_SEED]);
    w->setup(opts[O_WIDTH], opts[O_HEIGHT]);
    w->plan_gop(opts[O_FRAMES]);
    w->sps_rps_sets();
    w->write_parameter_sets();
    for (const Pic& p : w->plan) w->picture(p);
    return 0;
  } catch (const std::exception& e) {
    w->error = e.what();
    return -1;
  }
}

// Content: `n_pcm` PCM pictures of the packed I420 `frames` (width x
// height, even), then `n_p` P pictures panning (pan_x, pan_y) quarter
// samples a picture, with WPP on when `wpp`.  Returns 0, or -1.
int hevcw_content(Writer* w, const uint8_t* frames, int n_pcm, int width, int height, int n_p, int pan_x,
                  int pan_y, int wpp) {
  try {
    using namespace hevcw;
    std::memset(w->o, 0, sizeof w->o);
    w->content = true;
    w->o[O_CTB] = 64;
    w->o[O_MIN_CB] = 8;
    w->o[O_PCM] = 1;
    w->o[O_PCM_BITS] = 8;
    w->o[O_TMVP] = 1;
    w->o[O_REFS] = 1;
    w->o[O_WPP] = wpp;
    w->o[O_QP_MIN] = w->o[O_QP_MAX] = 26;
    w->o[O_MAX_TB] = 5;
    w->o[O_SLICES] = 1;
    w->o[O_ACROSS] = 1;
    w->o[O_VUI] = 1;
    w->setup(width, height);
    int W = w->sps.width, H = w->sps.height;
    w->planes.assign((size_t)n_pcm * W * H * 3 / 2, 0);
    for (int f = 0; f < n_pcm; f++) {
      const uint8_t* src = frames + (size_t)f * width * height * 3 / 2;
      uint8_t* dst = w->planes.data() + (size_t)f * W * H * 3 / 2;
      for (int y = 0; y < H; y++)
        for (int x = 0; x < W; x++) dst[(size_t)y * W + x] = src[(size_t)std::min(y, height - 1) * width + std::min(x, width - 1)];
      for (int c = 0; c < 2; c++) {
        const uint8_t* s = src + (size_t)width * height + (size_t)c * (width / 2) * (height / 2);
        uint8_t* d = dst + (size_t)W * H + (size_t)c * (W / 2) * (H / 2);
        for (int y = 0; y < H / 2; y++)
          for (int x = 0; x < W / 2; x++)
            d[(size_t)y * (W / 2) + x] = s[(size_t)std::min(y, height / 2 - 1) * (width / 2) + std::min(x, width / 2 - 1)];
      }
    }
    w->pan_x = pan_x;
    w->pan_y = pan_y;
    w->plan_gop(n_pcm + n_p);
    for (int i = 0; i < n_pcm; i++) w->plan[(size_t)i].type = i == 0 ? hevc::NAL_IDR_W_RADL : hevc::NAL_CRA;
    // PCM pictures after the first are CRA pictures keeping nothing; the P pictures refer to the one before
    int poc = 0;
    for (size_t i = 0; i < w->plan.size(); i++) {
      Pic& p = w->plan[i];
      p.poc = poc++;
      p.output = 1;
      p.rps.clear();
      p.used.clear();
      if (i > 0 && (int)i >= n_pcm) {
        p.rps = {-1};
        p.used = {1};
      }
    }
    w->write_parameter_sets();
    for (size_t i = 0; i < w->plan.size(); i++) {
      w->pcm_index = (int)std::min<size_t>(i, (size_t)n_pcm - 1);
      w->picture(w->plan[i]);
    }
    return 0;
  } catch (const std::exception& e) {
    w->error = e.what();
    return -1;
  }
}

// A stream the decoder refuses by name: its parameter sets and one slice
// header carry the tool `kind` (1 B slices, 2 long-term references, 3
// weighted prediction, 4 tiles, 5 dependent slice segments, 6
// cu_transquant_bypass, 7 Main 10, 8 4:2:2, 9 a layer above 0).
// Returns 0, or -1.
int hevcw_refused(Writer* w, int kind) {
  try {
    using namespace hevcw;
    std::memset(w->o, 0, sizeof w->o);
    w->o[O_CTB] = 16;
    w->o[O_REFS] = 1;
    w->o[O_QP_MIN] = w->o[O_QP_MAX] = 30;
    w->o[O_SLICES] = 1;
    w->o[O_ACROSS] = 1;
    w->setup(64, 48);
    Sps& s = w->sps;
    Pps& p = w->pps;
    SliceHeader h;
    h.nal_type = NAL_TRAIL_R;
    h.type = SLICE_P;
    h.poc_lsb = 1;
    h.st_rps.num_negative = h.st_rps.num_delta = 1;
    h.st_rps.delta_poc[0] = -1;
    h.st_rps.used[0] = 1;
    h.num_ref_idx[0] = 1;
    h.slice_qp = 30;
    h.qp_delta = 30 - p.init_qp;
    switch (kind) {
      case 1: h.type = SLICE_B; break;
      case 2: s.long_term_present = 1; h.num_long_term_pics = 1; break;
      case 3: p.weighted_pred = 1; break;
      case 4: p.tiles = 1; break;
      case 5: p.dependent_slices = 1; h.first_slice = 0; h.dependent = 1; h.address = 1; break;
      case 6: p.transquant_bypass = 1; break;
      case 7: s.bit_depth = s.bit_depth_chroma = 10; break;
      case 8: s.chroma_format_idc = 2; break;
      case 9: break;
      default: hevc::fail("hevcw_refused: kind %d", kind);
    }
    auto nal = [&](int type, const BitWriter& bw, int layer) {
      w->out.insert(w->out.end(), {0, 0, 0, 1});
      w->out.push_back((uint8_t)(type << 1 | (layer >> 5)));
      w->out.push_back((uint8_t)((layer & 31) << 3 | 1));
      std::vector<uint8_t> esc = escape(bw.buf);
      w->out.insert(w->out.end(), esc.begin(), esc.end());
    };
    BitWriter vb, sb, pb, hb;
    WriteEngine e;
    e.bw = &vb;
    vps_syntax(e, w->vps);
    vb.trailing();
    nal(NAL_VPS, vb, 0);
    e.bw = &sb;
    Sps sw = s;
    sps_syntax(e, sw, nullptr);
    sb.trailing();
    nal(NAL_SPS, sb, 0);
    e.bw = &pb;
    Pps pw = p;
    pps_syntax(e, pw, nullptr);
    pb.trailing();
    nal(NAL_PPS, pb, 0);
    const Pps* ptab[64] = {&pw};
    const Sps* stab[16] = {&sw};
    const Pps* p2;
    const Sps* s2;
    e.bw = &hb;
    slice_header_syntax(e, h, ptab, stab, p2, s2);
    hb.put(1, 1);
    hb.align_zero();
    hb.put(8, 0x80);
    nal(h.nal_type, hb, kind == 9 ? 1 : 0);
    return 0;
  } catch (const std::exception& e) {
    w->error = e.what();
    return -1;
  }
}

long hevcw_size(Writer* w) { return (long)w->out.size(); }

void hevcw_copy(Writer* w, uint8_t* dst) { std::memcpy(dst, w->out.data(), w->out.size()); }

}  // extern "C"
