// MPEG-4 Part 2 Advanced Simple streams from a seed, for the tests of the
// port's decoder (adas_tpu_torch/native/mpeg4.cpp, which this file includes
// to share its tables, bit writer, prediction state and motion
// compensation).  Two modes:
//
// * exercise: random legal syntax.  I-, P- and B-VOPs (IBBP groups of
//   `bframes` B-VOPs), intra / inter / 4MV / not_coded macroblocks, dquant
//   and dbquant, the four B mb_types and direct (modb) skips, half- or
//   quarter-sample vectors (pointing past the picture at times), H.263 or
//   MPEG quantisation with the default or loaded matrices, video packets
//   with or without HEC, N-VOPs, the intra DC VLC threshold, AC
//   prediction, interlace (field DCT, field vectors and selects in P- and
//   B-VOPs, the alternate vertical scan, top field first), and user data naming Lavc, an XviD build or a DivX build
//   (with one B-VOP at a time, packed: a P-VOP and the B-VOP before it in
//   one sample, then an N-VOP placeholder, as DivX writes them).
// * content: an intra VOP of given I420 planes, then a pan coded as
//   I(BB..)P with 4MV and quarter-sample vectors and MPEG quantisation, the
//   residual of each macroblock's best prediction coded; the pictures are
//   the decoder's own reconstruction, fed back as references.
//
// The stream stays inside what libavcodec decodes without an error: each
// coefficient dequantises within 12 bits, each block's dequantised
// magnitudes sum under a bound that keeps its IDCT output within 9 bits
// (libavcodec's SSE2 XviD IDCT saturates past that), intra DC values within
// 0..2047.  The samples come out in decoding order with their display
// positions, the VOS / VO / VOL / user data apart (the MP4 DSI) and in band
// before each I-VOP (as FFmpeg writes an AVI).
#include "../../../adas_tpu_torch/native/mpeg4.cpp"

namespace {

struct Rng {
    uint64_t s;
    explicit Rng(uint64_t seed) : s(seed * 0x9E3779B97F4A7C15ull + 0x1234567ull) {}
    uint32_t next() {
        s ^= s << 13;
        s ^= s >> 7;
        s ^= s << 17;
        return uint32_t(s >> 11);
    }
    int range(int lo, int hi) { return lo + int(next() % uint32_t(hi - lo + 1)); }  // [lo, hi]
    bool pct(int p) { return range(0, 99) < p; }
};

// the exerciser's options, in the order of mpeg4_writer.py's OPTIONS
struct Opt {
    int width = 64, height = 48, frames = 8, seed = 0, bframes = 0, four_mv = 0, qpel = 0,
        mpeg_quant = 0, packets = 0, hec = 0, user = 0, build = 64, divx_version = 503,
        nvop = 0, intra = 10, skip = 20, dquant = 15, q_min = 2, q_max = 12, fcode = 0,
        resolution = 30, increment = 1, control = 1, outside = 10, ac_pred = 50, dc_thr = -1,
        big_levels = 5, interlaced = 0, field_mv = 30, field_dct = 50, lavc_major = 61,
        xvid_ilace = 0;
};
constexpr int kNumOpts = 32;

enum User { kLavc, kXvid, kDivx, kNoUserData };

// a block's dequantised magnitude budget: within it the XviD IDCT's
// 16-bit intermediates do not saturate
constexpr int kInterBudget = 1400, kIntraAcBudget = 700;

struct Writer {
    Opt o;
    Rng rng{0};
    std::string error;
    Decoder st;   // the syntax state a decoder of the stream keeps
    Encoder enc;  // the bit writer and the VLC writers
    std::vector<uint8_t> header;
    std::vector<std::vector<uint8_t>> samples;
    std::vector<int> keys, display, types;
    int time_bits = 1;
    long last_sec_nonb = 0, prev_sec_nonb = 0;
    int matrix_intra[64], matrix_inter[64];
    bool packed = false;
    // content mode
    Decoder* dec = nullptr;           // the decoder of what was written
    const uint8_t* frames = nullptr;  // packed I420 frames
    int n_src = 0;

    BitWriter& bw() { return enc.bw; }

    // ---- headers

    bool asp() const {
        return o.bframes || o.four_mv || o.qpel || o.mpeg_quant || o.packets || o.interlaced;
    }

    std::vector<uint8_t> make_header() {
        BitWriter b;
        b.start_code(0xb0);
        b.put(asp() ? 0xF5 : 0x01, 8);  // Advanced Simple L5 / Simple L1
        b.start_code(0xb5);
        b.put(0, 1);
        b.put(1, 4);
        b.put(0, 1);
        b.stuffing();
        b.start_code(0x00);
        b.start_code(0x20);
        b.put(0, 1);
        b.put(asp() ? 17 : 1, 8);  // video_object_type_indication
        int verid = o.qpel ? 2 : 1;
        if (verid != 1) {
            b.put(1, 1);
            b.put(uint32_t(verid), 4);
            b.put(1, 3);
        } else {
            b.put(0, 1);
        }
        b.put(1, 4);  // square pixels
        b.put(uint32_t(o.control), 1);
        if (o.control) {
            b.put(1, 2);
            b.put(o.bframes ? 0 : 1, 1);  // low_delay
            b.put(0, 1);
        }
        b.put(0, 2);
        b.put(1, 1);
        b.put(uint32_t(o.resolution), 16);
        b.put(1, 1);
        b.put(0, 1);  // fixed_vop_rate
        b.put(1, 1);
        b.put(uint32_t(o.width), 13);
        b.put(1, 1);
        b.put(uint32_t(o.height), 13);
        b.put(1, 1);
        b.put(uint32_t(o.interlaced), 1);
        b.put(1, 1);  // obmc_disable
        b.put(0, verid == 1 ? 1 : 2);
        b.put(0, 1);  // not_8_bit
        b.put(o.mpeg_quant ? 1 : 0, 1);
        for (int i = 0; i < 64; i++) {
            matrix_intra[i] = kDefaultIntraMatrix[i];
            matrix_inter[i] = kDefaultInterMatrix[i];
        }
        if (o.mpeg_quant) {
            for (int* m : {matrix_intra, matrix_inter}) {
                bool load = o.mpeg_quant == 2;
                b.put(load, 1);
                if (!load) continue;
                // values in zigzag order; a 0 ends them early, the last repeated
                int stop = rng.pct(50) ? rng.range(1, 63) : 64, last = 16;
                for (int i = 0; i < 64; i++) {
                    if (i < stop) last = rng.range(8, 40);
                    m[kZigzag[i]] = last;
                }
                for (int i = 0; i < stop; i++) b.put(uint32_t(m[kZigzag[i]]), 8);
                if (stop < 64) b.put(0, 8);
            }
        }
        if (verid != 1) b.put(uint32_t(o.qpel), 1);
        b.put(1, 1);              // complexity_estimation_disable
        b.put(o.packets ? 0 : 1, 1);  // resync_marker_disable
        b.put(0, 1);              // data_partitioned
        if (verid != 1) {
            b.put(0, 1);
            b.put(0, 1);
        }
        b.put(0, 1);  // scalability
        b.stuffing();
        std::string user;
        char buf[64];
        if (o.user == kLavc) {
            std::snprintf(buf, sizeof buf, "Lavc%d.%d.100", o.lavc_major, o.lavc_major == 61 ? 3 : 60);
            user = buf;
        } else if (o.user == kXvid) {
            std::snprintf(buf, sizeof buf, "XviD%04d", o.build);
            user = buf;
        } else if (o.user == kDivx) {
            std::snprintf(buf, sizeof buf, "DivX%db%d%s", o.divx_version, o.build,
                          packed ? "p" : "");
            user = buf;
        }
        if (!user.empty()) {
            b.start_code(0xb2);
            for (char c : user) b.put(uint8_t(c), 8);
        }
        while (b.nacc) b.put(0, 1);
        return b.out;
    }

    // ---- values a decoder accepts

    int scale_of(int n, int q) const { return n < 4 ? luma_dc_scale(q) : chroma_dc_scale(q); }
    // the dequantised magnitude of level l at natural position i
    int dequant(int l, int i, int q, bool intra) const {
        int a = std::abs(l);
        if (!a) return 0;
        if (o.mpeg_quant) return intra ? a * 2 * q * matrix_intra[i] >> 4
                                       : ((2 * a + 1) * 2 * q * matrix_inter[i]) >> 5;
        return a * 2 * q + ((q - 1) | 1);
    }
    // random levels into blk (natural order) at scan positions >= first,
    // within the budget; true when one is non-zero
    bool random_block(int16_t* blk, int first, int q, bool intra, int budget) {
        int k = rng.pct(30) ? rng.range(1, 2) : rng.range(1, 12);
        int spent = 0;
        bool any = false;
        for (int e = 0; e < k; e++) {
            int pos = rng.pct(70) ? rng.range(first, std::min(first + 15, 63)) : rng.range(first, 63);
            int i = kZigzag[pos];
            int a = rng.pct(70) ? 1 : rng.pct(70) ? rng.range(2, 4) : rng.range(5, 16);
            if (rng.pct(o.big_levels)) a = rng.range(17, 120);
            while (a && (dequant(a, i, q, intra) > 2047 || spent + dequant(a, i, q, intra) > budget))
                a /= 2;
            if (!a) continue;
            blk[i] = int16_t(rng.pct(50) ? -a : a);
            spent += dequant(a, i, q, intra);
            any = true;
        }
        return any;
    }

    int random_mv(int range_bits, int base) {
        int lim = 1 << range_bits;  // vectors lie in [-lim, lim - 1]
        int v = rng.pct(o.outside) ? rng.range(-lim, lim - 1) : base + rng.range(-6, 6);
        return std::min(std::max(v, -lim), lim - 1);
    }

    // ---- macroblocks

    // an intra macroblock (I- or P-VOP): levels, DC / AC prediction as the
    // decoder keeps them, the bits
    void intra_mb(int mbx, int mby, bool pvop, const int16_t (*given)[64] = nullptr) {
        int q = st.q;
        bool dquant = !given && rng.pct(o.dquant);
        int dq = 0;
        if (dquant) {
            dq = rng.range(0, 3);
            q = std::min(std::max(q + kDquant[dq], 1), 31);
        }
        bool dc_vlc = st.q < st.dc_thr;  // before dquant, as the decoder reads it
        int16_t actual[6][64] = {}, coded[6][64];
        int dirs[6];
        bool ac_pred = given ? false : rng.pct(o.ac_pred);
        st.set_q(q);
        for (int n = 0; n < 6; n++) {
            int c = Codec::comp(n), bx, by, scale = scale_of(n, q);
            st.block_xy(mbx, mby, n, bx, by);
            if (given) {
                std::memcpy(actual[n], given[n], sizeof actual[n]);
            } else {
                random_block(actual[n], 1, q, true, kIntraAcBudget);
                actual[n][0] = int16_t(rng.range(std::max(1, 600 / scale), 1800 / scale));
            }
            int pred = st.dc_pred(mbx, mby, n, scale, dirs[n]);
            std::memcpy(coded[n], actual[n], sizeof coded[n]);
            coded[n][0] = int16_t(actual[n][0] - pred);
            st.dc_keep(mbx, mby, n, actual[n][0], scale);
            int16_t predicted[64] = {};
            st.ac_predict(c, bx, by, mbx, mby, q, dirs[n], true, predicted);
            int16_t* mine = &st.ac[c][(size_t(by) * st.bgw(c) + bx) * 16];
            for (int i = 1; i < 8; i++) {
                int k = dirs[n] == 0 ? i * 8 : i;
                if (ac_pred) coded[n][k] = int16_t(actual[n][k] - predicted[k]);
                mine[i] = actual[n][i * 8];
                mine[8 + i] = actual[n][i];
            }
        }
        int cbp = 0;
        for (int n = 0; n < 6; n++)
            for (int i = dc_vlc ? 1 : 0; i < 64; i++)
                if (coded[n][i]) {
                    cbp |= 32 >> n;
                    break;
                }
        if (pvop) {
            bw().put(0, 1);
            bw().put(kInterMcbpc[4 | (cbp & 3) | (dquant ? 8 : 0)]);
        } else {
            bw().put(kIntraMcbpc[(cbp & 3) | (dquant ? 4 : 0)]);
        }
        bw().put(ac_pred, 1);
        bw().put(kCbpy[cbp >> 2]);
        if (dquant) bw().put(uint32_t(dq), 2);
        if (o.interlaced) bw().put(rng.pct(o.field_dct), 1);
        for (int n = 0; n < 6; n++) {
            if (dc_vlc) enc.put_dc(coded[n][0], n < 4);
            if (cbp & (32 >> n)) {
                const uint8_t* scan = st.alt_scan || (ac_pred && dirs[n] == 0) ? kAltVertical
                                      : ac_pred ? kAltHorizontal : kZigzag;
                enc.put_coeffs(true, coded[n], scan, dc_vlc ? 1 : 0);
            }
        }
        size_t mi = size_t(mby) * st.mbw + mbx;
        st.mbq[mi] = int8_t(q);
        st.cur->kind[mi] = kMbIntra;
        for (int n = 0; n < 4; n++) {
            int16_t* mv = st.block_mv(mbx, mby, n);
            mv[0] = mv[1] = 0;
        }
    }

    // the coded blocks of an inter macroblock; `given` levels or random
    void inter_blocks(int cbp, const int16_t (*blocks)[64]) {
        for (int n = 0; n < 6; n++)
            if (cbp & (32 >> n))
                enc.put_coeffs(false, blocks[n], st.alt_scan ? kAltVertical : kZigzag, 0);
    }
    int random_inter_blocks(int16_t (*blocks)[64], int q) {
        int cbp = 0;
        for (int n = 0; n < 6; n++) {
            std::memset(blocks[n], 0, sizeof blocks[n]);
            if (rng.pct(40) && random_block(blocks[n], 0, q, false, kInterBudget)) cbp |= 32 >> n;
        }
        return cbp;
    }

    void put_mvd(int v, int pred, int f) {
        enc.fcode = f;
        enc.put_motion(v - pred);
    }

    // a P-VOP macroblock: `mode` 0 not_coded, 1 inter 1MV, 2 inter 4MV,
    // 3 intra; vectors and levels given (content) or random
    void p_mb(int mbx, int mby, int mode, const int (*mv)[2], int cbp,
              const int16_t (*blocks)[64], int base_x, int base_y) {
        size_t mi = size_t(mby) * st.mbw + mbx;
        int rbits = 4 + st.fcode;
        if (mode == 0) {
            bw().put(1, 1);
            for (int n = 0; n < 4; n++) {
                int16_t* m = st.block_mv(mbx, mby, n);
                m[0] = m[1] = 0;
            }
            st.mbq[mi] = int8_t(st.q);
            st.cur->kind[mi] = kMb16x16;
            st.cur->skip[mi] = 1;
            st.clear_intra(mbx, mby);
            return;
        }
        if (mode == 3) {
            intra_mb(mbx, mby, true);
            return;
        }
        int16_t rb[6][64];
        int vecs[4][2];
        bool dquant = !blocks && mode == 1 && rng.pct(o.dquant);
        int dq = dquant ? rng.range(0, 3) : 0;
        int q = dquant ? std::min(std::max(st.q + kDquant[dq], 1), 31) : st.q;
        if (!blocks) {
            cbp = random_inter_blocks(rb, q);
            blocks = rb;
        }
        bool four = mode == 2;
        if (mv) {
            std::memcpy(vecs, mv, sizeof(int) * 2 * (four ? 4 : 1));
        } else {
            for (int n = 0; n < (four ? 4 : 1); n++) {
                vecs[n][0] = random_mv(rbits, base_x);
                vecs[n][1] = random_mv(rbits, base_y);
            }
        }
        bw().put(0, 1);
        bw().put(kInterMcbpc[(cbp & 3) | (dquant ? 8 : 0) | (four ? 16 : 0)]);
        bw().put(kCbpy[(cbp >> 2) ^ 15]);
        if (dquant) bw().put(uint32_t(dq), 2);
        st.set_q(q);
        st.mbq[mi] = int8_t(q);
        // (an XVIX stream's old XviD writes the field DCT flag without a cbp)
        if (o.interlaced && (cbp || o.xvid_ilace)) bw().put(rng.pct(o.field_dct), 1);
        bool field = !four && o.interlaced && !mv && rng.pct(o.field_mv);
        if (!four && o.interlaced && !mv) bw().put(field, 1);
        if (field) {
            int sel[2] = {rng.range(0, 1), rng.range(0, 1)}, fmv[2][2];
            bw().put(uint32_t(sel[0]), 1);
            bw().put(uint32_t(sel[1]), 1);
            int px, py;
            st.pred_motion(mbx, mby, 0, px, py);
            for (int i = 0; i < 2; i++) {
                fmv[i][0] = random_mv(rbits, base_x);
                fmv[i][1] = random_mv(rbits, base_y / 2);
                put_mvd(fmv[i][0], px, st.fcode);
                put_mvd(fmv[i][1], py / 2, st.fcode);
                st.cur->field_sel[mi * 2 + i] = uint8_t(sel[i]);
                st.cur->field_mv[mi * 4 + i * 2] = int16_t(fmv[i][0]);
                st.cur->field_mv[mi * 4 + i * 2 + 1] = int16_t(fmv[i][1]);
            }
            int ax = fmv[0][0] + fmv[1][0], ay = fmv[0][1] + fmv[1][1];
            ax = (ax >> 1) | (ax & 1);
            for (int n = 0; n < 4; n++) {
                int16_t* m = st.block_mv(mbx, mby, n);
                m[0] = int16_t(ax);
                m[1] = int16_t(ay);
            }
            st.cur->kind[mi] = kMbField;
            st.clear_intra(mbx, mby);
            inter_blocks(cbp, blocks);
            return;
        }
        for (int n = 0; n < (four ? 4 : 1); n++) {
            int px, py;
            st.pred_motion(mbx, mby, n, px, py);
            put_mvd(vecs[n][0], px, st.fcode);
            put_mvd(vecs[n][1], py, st.fcode);
            if (four) {
                int16_t* m = st.block_mv(mbx, mby, n);
                m[0] = int16_t(vecs[n][0]);
                m[1] = int16_t(vecs[n][1]);
            }
        }
        if (!four)
            for (int n = 0; n < 4; n++) {
                int16_t* m = st.block_mv(mbx, mby, n);
                m[0] = int16_t(vecs[0][0]);
                m[1] = int16_t(vecs[0][1]);
            }
        st.cur->kind[mi] = four ? kMb8x8 : kMb16x16;
        st.clear_intra(mbx, mby);
        inter_blocks(cbp, blocks);
    }

    // a B-VOP macroblock that is not skipped: `kind` -1 (direct, modb '1'),
    // or kBDirect / kBInterpolate / kBBackward / kBForward
    void b_mb(int mbx, int mby, int kind, const int* fwd, const int* bwd, const int* dmv, int cbp,
              const int16_t (*blocks)[64]) {
        int16_t rb[6][64];
        const bool blocks_given = blocks != nullptr;
        if (kind == -1) {
            bw().put(1, 1);
            st.clear_intra(mbx, mby);
            return;
        }
        bool dbq = false;
        int dbq_v = 0, q = st.q;
        if (!blocks) {
            cbp = rng.pct(30) ? 0 : -1;
            if (kind != kBDirect && cbp && rng.pct(o.dquant)) {
                dbq = true;
                dbq_v = rng.range(0, 1);
                q = std::min(std::max(q + dbq_v * 4 - 2, 1), 31);
            }
            cbp = cbp ? random_inter_blocks(rb, q) : 0;
            blocks = rb;
            if (!cbp) dbq = false, q = st.q;
        }
        bw().put(0, 1);  // modb: mb_type follows
        bw().put(cbp ? 0 : 1, 1);
        bw().put(kBMbType[kind]);
        if (cbp) bw().put(uint32_t(cbp), 6);
        if (kind != kBDirect && cbp) {
            bw().put(dbq, 1);
            if (dbq) bw().put(uint32_t(dbq_v), 1);
        }
        bool field = false;
        if (o.interlaced) {
            if (cbp) bw().put(rng.pct(o.field_dct), 1);
            if (kind != kBDirect) {
                field = !blocks_given && rng.pct(o.field_mv);
                bw().put(field, 1);
                for (int d = 0; field && d < 2; d++)
                    if (kind != (d ? kBForward : kBBackward)) bw().put(uint32_t(rng.range(0, 3)), 2);
            }
        }
        st.set_q(q);
        if (kind == kBDirect) {
            put_mvd(dmv[0], 0, 1);
            put_mvd(dmv[1], 0, 1);
        } else {
            for (int d = 0; d < 2; d++) {
                if (kind == (d ? kBForward : kBBackward)) continue;
                const int* mv = d ? bwd : fwd;
                int code = d ? st.bcode : st.fcode;
                if (!field) {
                    for (int k = 0; k < 2; k++) {
                        put_mvd(mv[k], st.last_mv[d][0][k], code);
                        st.last_mv[d][0][k] = st.last_mv[d][1][k] = mv[k];
                    }
                    continue;
                }
                for (int i = 0; i < 2; i++) {  // two field vectors
                    int fx = random_mv(4 + code, mv[0]), fy = random_mv(4 + code, mv[1] / 2);
                    put_mvd(fx, st.last_mv[d][i][0], code);
                    put_mvd(fy, st.last_mv[d][i][1] / 2, code);
                    st.last_mv[d][i][0] = fx;
                    st.last_mv[d][i][1] = fy * 2;
                }
            }
        }
        st.clear_intra(mbx, mby);
        inter_blocks(cbp, blocks);
    }

    // ---- VOPs

    // the VOP header (of an N-VOP: up to vop_coded 0); a placeholder that
    // no decoder parses leaves the time base alone
    void vop_header(int type, int t, bool coded, bool placeholder = false) {
        long ticks = long(t) * o.increment, sec = ticks / o.resolution;
        long base = type == 2 ? prev_sec_nonb : last_sec_nonb;
        if (type != 2 && !placeholder) {
            prev_sec_nonb = last_sec_nonb;
            last_sec_nonb = sec;
        }
        bw().start_code(0xb6);
        bw().put(uint32_t(type), 2);
        for (long s = base; s < sec; s++) bw().put(1, 1);
        bw().put(0, 1);
        bw().put(1, 1);
        bw().put(uint32_t(ticks % o.resolution), time_bits);
        bw().put(1, 1);
        bw().put(coded, 1);
        if (!coded) return;
        if (type == 1) bw().put(uint32_t(st.rounding), 1);
        int thr = 0;
        for (int k = 0; k < 8; k++)
            if (kDcThreshold[k] == st.dc_thr) thr = k;
        bw().put(uint32_t(thr), 3);
        if (o.interlaced) {
            bw().put(uint32_t(st.tff), 1);
            bw().put(uint32_t(st.alt_scan), 1);
        }
        bw().put(uint32_t(st.q), 5);
        if (type) bw().put(uint32_t(st.fcode), 3);
        if (type == 2) bw().put(uint32_t(st.bcode), 3);
    }

    void packet_header(int mb, int type, int t) {
        bw().stuffing();
        bw().put(0, st.packet_prefix());
        bw().put(1, 1);
        int n = st.mbw * st.mbh, bits = 0;
        while ((1 << bits) < n) bits++;
        bw().put(uint32_t(mb), std::max(bits, 1));
        int q = rng.range(o.q_min, o.q_max);
        bw().put(uint32_t(q), 5);
        bool hec = rng.pct(o.hec);
        bw().put(hec, 1);
        if (hec) {  // the VOP header's fields again, which FFmpeg reads past
            long ticks = long(t) * o.increment;
            bw().put(0, 1);
            bw().put(1, 1);
            bw().put(uint32_t(ticks % o.resolution), time_bits);
            bw().put(1, 1);
            bw().put(uint32_t(type), 2);
            int thr = 0;
            for (int k = 0; k < 8; k++)
                if (kDcThreshold[k] == st.dc_thr) thr = k;
            bw().put(uint32_t(thr), 3);
            if (type) bw().put(uint32_t(st.fcode), 3);
            if (type == 2) bw().put(uint32_t(st.bcode), 3);
        }
        st.set_q(q);
        st.resync_x = mb % st.mbw;
        st.resync_y = mb / st.mbw;
        st.first_line = true;
        st.clean_buffers(st.resync_x, st.resync_y);
    }

    // the syntax state of a new VOP, as Decoder::decode_vop sets it
    void begin_vop(int type) {
        st.type = type;
        st.cur = st.new_picture();
        if (type != 2) {
            st.last = st.next;
            st.next = st.cur;
        }
        st.resync_x = st.resync_y = 0;
        st.first_line = true;
        std::memset(st.last_mv, 0, sizeof st.last_mv);
    }

    // one random VOP of `type` at display time t
    void random_vop(int type, int t) {
        st.alt_scan = o.interlaced && rng.pct(50);
        st.tff = o.interlaced && rng.pct(50);
        st.q = rng.range(o.q_min, o.q_max);
        st.rounding = type == 1 ? rng.range(0, 1) : 0;
        st.dc_thr = o.dc_thr >= 0 ? kDcThreshold[o.dc_thr] : kDcThreshold[rng.range(0, 7)];
        st.fcode = type ? (o.fcode ? o.fcode : rng.range(1, 4)) : 1;
        st.bcode = type == 2 ? (o.fcode ? o.fcode : rng.range(1, 4)) : 1;
        vop_header(type, t, true);
        begin_vop(type);
        int base_x = rng.range(-8, 8), base_y = rng.range(-6, 6);
        int n = st.mbw * st.mbh;
        for (int mb = 0; mb < n; mb++) {
            int mbx = mb % st.mbw, mby = mb / st.mbw;
            bool b_skip = type == 2 && st.next->skip[size_t(mb)];
            if (o.packets && mb && !b_skip && rng.pct(o.packets)) packet_header(mb, type, t);
            if (st.resync_x == mbx && st.resync_y + 1 == mby) st.first_line = false;
            if (type == 2 && mbx == 0) std::memset(st.last_mv, 0, sizeof st.last_mv);
            if (type == 0) {
                intra_mb(mbx, mby, false);
            } else if (type == 1) {
                int mode = rng.pct(o.skip) ? 0 : rng.pct(o.intra) ? 3 : rng.pct(o.four_mv) ? 2 : 1;
                p_mb(mbx, mby, mode, nullptr, 0, nullptr, base_x, base_y);
            } else if (b_skip) {
                st.clear_intra(mbx, mby);
            } else {
                int r = rng.range(0, 9);
                int kind = r < 2 ? -1 : r < 4 ? kBDirect : r < 6 ? kBInterpolate
                                               : r < 8 ? kBBackward : kBForward;
                int f[2], b[2], d[2];
                f[0] = random_mv(4 + st.fcode, base_x);
                f[1] = random_mv(4 + st.fcode, base_y);
                b[0] = random_mv(4 + st.bcode, -base_x);
                b[1] = random_mv(4 + st.bcode, -base_y);
                d[0] = rng.pct(50) ? 0 : rng.range(-4, 4);
                d[1] = rng.pct(50) ? 0 : rng.range(-4, 4);
                b_mb(mbx, mby, kind, f, b, d, 0, nullptr);
            }
        }
        bw().stuffing();
    }

    // an N-VOP (vop_coded 0) of `type`
    void n_vop(int type, int t, bool placeholder = false) {
        vop_header(type, t, false, placeholder);
        bw().stuffing();
    }

    void finish_sample(int key, int disp, int type, bool with_header) {
        std::vector<uint8_t> s;
        if (with_header) s = header;
        s.insert(s.end(), bw().out.begin(), bw().out.end());
        bw().out.clear();
        samples.push_back(s);
        keys.push_back(key);
        display.push_back(disp);
        types.push_back(type);
    }

    // the display times in decoding order: I, then groups of P and the B-VOPs before it
    std::vector<std::pair<int, int>> schedule() const {
        std::vector<std::pair<int, int>> order;  // (type, display time)
        order.push_back({0, 0});
        int t = 1;
        while (t < o.frames) {
            int nb = std::min(o.bframes, o.frames - 1 - t);
            int p = t + nb;
            order.push_back({1, p});
            for (int k = 0; k < nb; k++) order.push_back({2, t + k});
            t = p + 1;
        }
        return order;
    }

    void setup() {
        if (o.width < 16 || o.height < 16 || o.width > 4096 || o.height > 4096 || o.width % 2 ||
            o.height % 2)
            fail("the writer takes even sides of 16..4096");
        if (o.frames < 1) fail("at least one frame");
        if (o.bframes < 0 || o.bframes > 3) fail("bframes must be in 0..3");
        if (o.q_min < 1 || o.q_max > 31 || o.q_min > o.q_max) fail("q range out of 1..31");
        if (o.resolution < 1 || o.resolution > 65535 || o.increment < 1) fail("bad time base");
        rng = Rng(uint64_t(o.seed));
        // DivX packs a B-VOP into its P-VOP's sample only one at a time
        packed = o.user == kDivx && o.bframes == 1;
        while ((1 << time_bits) < o.resolution) time_bits++;
        time_bits = std::max(time_bits, 1);
        header = make_header();
        st.decode(header.data(), header.size());  // the VOL and user data
        if (!st.have_vol) fail("the writer's VOL does not parse");
    }

    void exercise() {
        setup();
        auto order = schedule();
        for (size_t k = 0; k < order.size(); k++) {
            int type = order[k].first, t = order[k].second;
            if (type == 1 && !o.bframes && rng.pct(o.nvop)) {
                n_vop(1, t);
                finish_sample(0, t, 3, false);
                continue;
            }
            random_vop(type, t);
            if (packed && type == 1 && k + 1 < order.size() && order[k + 1].first == 2) {
                // DivX: the B-VOP in the P-VOP's sample, an N-VOP placeholder after
                int tb = order[k + 1].second;
                random_vop(2, tb);
                finish_sample(0, t, 1, false);
                n_vop(1, tb, true);
                finish_sample(0, tb, 2, false);
                k++;
                continue;
            }
            finish_sample(type == 0, t, type, type == 0);
        }
    }

    // ---- content

    const uint8_t* src_plane(int f, int c) const {
        size_t y = size_t(o.width) * o.height, cw = size_t(o.width / 2) * (o.height / 2);
        const uint8_t* base = frames + size_t(f) * (y + 2 * cw);
        return c == 0 ? base : base + y + (c - 1) * cw;
    }
    // the source block n of macroblock (mbx, mby) of frame f, edge-extended
    void src_block(int f, int mbx, int mby, int n, uint8_t* out) const {
        int c = Codec::comp(n), pw = c ? o.width / 2 : o.width, ph = c ? o.height / 2 : o.height;
        int x0 = c ? mbx * 8 : mbx * 16 + (n & 1) * 8, y0 = c ? mby * 8 : mby * 16 + (n >> 1) * 8;
        const uint8_t* p = src_plane(f, c);
        for (int j = 0; j < 8; j++)
            for (int i = 0; i < 8; i++)
                out[j * 8 + i] = p[size_t(std::min(y0 + j, ph - 1)) * pw + std::min(x0 + i, pw - 1)];
    }
    // the prediction pixels of a macroblock from the decoder's references
    // (a P-VOP's: the last one decoded; a B-VOP's: the two around it)
    void predicted(int mbx, int mby, int dir_mask, bool four, const int (*f)[2], const int (*b)[2],
                   uint8_t (*out)[64]) {
        Decoder& d = *dec;
        d.cur = probe;
        if (dir_mask & 1) d.predict(st.type == 1 ? *d.next : *d.last, mbx, mby, four, f, {1, false});
        if (dir_mask & 2) d.predict(*d.next, mbx, mby, four, b, {1, dir_mask == 3});
        for (int n = 0; n < 6; n++) {
            int stride;
            uint8_t* p = d.block_dst(mbx, mby, n, stride);
            for (int j = 0; j < 8; j++) std::memcpy(out[n] + j * 8, p + j * stride, 8);
        }
    }
    PicturePtr probe;  // the picture candidate predictions are made into

    int sad(int f, int mbx, int mby, uint8_t (*pred)[64]) const {
        int s = 0;
        uint8_t src[64];
        for (int n = 0; n < 4; n++) {
            src_block(f, mbx, mby, n, src);
            for (int i = 0; i < 64; i++) s += std::abs(int(src[i]) - int(pred[n][i]));
        }
        return s;
    }
    // MPEG-quantised inter levels of (source - prediction); the cbp
    int residual(int f, int mbx, int mby, uint8_t (*pred)[64], int16_t (*lv)[64]) {
        int cbp = 0, q = st.q;
        for (int n = 0; n < 6; n++) {
            uint8_t src[64];
            src_block(f, mbx, mby, n, src);
            float F[64];
            Encoder::fdct(src, 8, pred[n], 8, F);
            int spent = 0;
            for (int i = 0; i < 64; i++) {
                int l = int(std::fabs(F[i]) * 8.f / float(q * matrix_inter[i]) - 0.5f);
                l = std::max(l, 0);
                while (l && (dequant(l, i, q, false) > 2047 ||
                             spent + dequant(l, i, q, false) > kInterBudget))
                    l--;
                spent += dequant(l, i, q, false);
                lv[n][i] = int16_t(F[i] < 0 ? -l : l);
                if (l) cbp |= 32 >> n;
            }
        }
        return cbp;
    }

    void content_vop(int type, int t, int pan_x, int pan_y, int f_prev, int f_next) {
        st.alt_scan = st.tff = false;
        st.q = 4;
        st.rounding = 0;
        st.dc_thr = kDcThreshold[0];
        st.fcode = type ? 3 : 1;
        st.bcode = type == 2 ? 3 : 1;
        vop_header(type, t, true);
        begin_vop(type);
        int f = std::min(t, n_src - 1);
        for (int mby = 0; mby < st.mbh; mby++)
            for (int mbx = 0; mbx < st.mbw; mbx++) {
                // a video packet every o.packets macroblock rows
                int mb = mby * st.mbw + mbx;
                if (o.packets && mb && !mbx && mby % o.packets == 0 &&
                    !(type == 2 && st.next->skip[size_t(mb)]))
                    packet_header(mb, type, t);
                if (st.resync_x == mbx && st.resync_y + 1 == mby) st.first_line = false;
                if (type == 0) {
                    int16_t lv[6][64];
                    for (int n = 0; n < 6; n++) {
                        uint8_t src[64];
                        src_block(f, mbx, mby, n, src);
                        float F[64];
                        Encoder::fdct(src, 8, nullptr, 0, F);
                        int scale = scale_of(n, st.q), spent = 0;
                        lv[n][0] = int16_t(std::min(std::max(int(std::lround(F[0] / scale)), 1),
                                                    2040 / scale));
                        for (int i = 1; i < 64; i++) {
                            int l = int(std::lround(std::fabs(F[i]) * 8.f /
                                                    float(st.q * matrix_intra[i])));
                            while (l && (dequant(l, i, st.q, true) > 2047 ||
                                         spent + dequant(l, i, st.q, true) > 2 * kIntraAcBudget))
                                l--;
                            spent += dequant(l, i, st.q, true);
                            lv[n][i] = int16_t(F[i] < 0 ? -l : l);
                        }
                    }
                    intra_mb(mbx, mby, false, lv);
                    continue;
                }
                uint8_t pred[6][64];
                int16_t lv[6][64];
                if (type == 1) {
                    // the pan, and a 4MV variant a quarter sample apart per block
                    int one[1][2] = {{pan_x * (t - f_prev), pan_y * (t - f_prev)}};
                    int four[4][2];
                    for (int n = 0; n < 4; n++) {
                        four[n][0] = one[0][0] + ((n & 1) ? 1 : 0);
                        four[n][1] = one[0][1] + ((n >> 1) ? 1 : 0);
                    }
                    predicted(mbx, mby, 1, false, one, nullptr, pred);
                    int s1 = sad(f, mbx, mby, pred);
                    uint8_t pred4[6][64];
                    predicted(mbx, mby, 1, true, four, nullptr, pred4);
                    int s4 = sad(f, mbx, mby, pred4);
                    bool use4 = s4 < s1 || ((mbx + mby) % 3 == 0);
                    if (use4) std::memcpy(pred, pred4, sizeof pred);
                    int cbp = residual(f, mbx, mby, pred, lv);
                    p_mb(mbx, mby, use4 ? 2 : 1, use4 ? four : one, cbp, lv, 0, 0);
                    continue;
                }
                // B: the best of direct, forward, backward and interpolate
                size_t mi = size_t(mby) * st.mbw + mbx;
                if (mbx == 0) std::memset(st.last_mv, 0, sizeof st.last_mv);
                if (st.next->skip[mi]) {
                    st.clear_intra(mbx, mby);
                    continue;
                }
                int fw[1][2] = {{pan_x * (t - f_prev), pan_y * (t - f_prev)}};
                int bk[1][2] = {{-pan_x * (f_next - t), -pan_y * (f_next - t)}};
                int df[4][2], db[4][2];
                dec->pb_time = st.pb_time;
                dec->pp_time = st.pp_time;
                int dsel[2][2];
                bool dfour = dec->direct_mv(mbx, mby, 0, 0, df, db, dsel) == kMb8x8;
                int best = -1, best_sad = 1 << 30;
                uint8_t cand[6][64];
                for (int k = 0; k < 4; k++) {
                    if (k == 0) predicted(mbx, mby, 3, dfour, df, db, cand);
                    if (k == 1) predicted(mbx, mby, 1, false, fw, nullptr, cand);
                    if (k == 2) predicted(mbx, mby, 2, false, nullptr, bk, cand);
                    if (k == 3) predicted(mbx, mby, 3, false, fw, bk, cand);
                    int s = sad(f, mbx, mby, cand);
                    if (s < best_sad) best_sad = s, best = k, std::memcpy(pred, cand, sizeof pred);
                }
                int cbp = residual(f, mbx, mby, pred, lv);
                static const int kKinds[4] = {kBDirect, kBForward, kBBackward, kBInterpolate};
                int zero[2] = {0, 0};
                int kind = kKinds[best];
                if (kind == kBDirect && !cbp) kind = -1;
                b_mb(mbx, mby, kind, fw[0], bk[0], zero, cbp, lv);
            }
        bw().stuffing();
    }

    void content(int pan_x, int pan_y) {
        setup();
        Decoder d;
        dec = &d;
        d.decode(header.data(), header.size());
        auto order = schedule();
        int prev_ref = 0, next_ref = 0;
        for (size_t k = 0; k < order.size(); k++) {
            int type = order[k].first, t = order[k].second;
            if (type != 2) {
                prev_ref = next_ref;
                next_ref = t;
            }
            // the decoder's times for direct mode, as the VOP header sets them
            st.pp_time = long(next_ref - prev_ref) * o.increment;
            st.pb_time = long(t - prev_ref) * o.increment;
            probe = d.new_picture();
            content_vop(type, t, pan_x, pan_y, type == 2 ? prev_ref : prev_ref, next_ref);
            finish_sample(type == 0, t, type, type == 0);
            const std::vector<uint8_t>& s = samples.back();
            d.decode(s.data(), s.size());
            d.out.clear();
        }
        dec = nullptr;
    }
};

}  // namespace

extern "C" {

Writer* mpeg4w_new() { return new (std::nothrow) Writer(); }
void mpeg4w_free(Writer* w) { delete w; }
const char* mpeg4w_error(Writer* w) { return w->error.c_str(); }

static int load_opts(Writer* w, const int* opts, int n) {
    if (n != kNumOpts) {
        w->error = "expected " + std::to_string(kNumOpts) + " options";
        return -1;
    }
    static_assert(sizeof(Opt) == sizeof(int) * kNumOpts, "Opt holds the options alone");
    std::memcpy(static_cast<void*>(&w->o), opts, sizeof(int) * kNumOpts);
    return 0;
}

// random legal syntax; -1 on error
int mpeg4w_exercise(Writer* w, const int* opts, int n) {
    if (load_opts(w, opts, n)) return -1;
    return guarded(&w->error, [&] {
        w->exercise();
        return 0;
    });
}

// `n_src` packed I420 frames (the first intra-coded, the others the
// sources of the pan), `opts` as for the exerciser (frames, bframes), a
// pan of (pan_x, pan_y) quarter samples a frame; -1 on error
int mpeg4w_content(Writer* w, const int* opts, int n, const uint8_t* frames, int n_src, int pan_x,
                   int pan_y) {
    if (load_opts(w, opts, n)) return -1;
    w->frames = frames;
    w->n_src = n_src;
    return guarded(&w->error, [&] {
        if (!w->o.qpel || !w->o.mpeg_quant) fail("the content clip is quarter-sample and MPEG-quantised");
        w->content(pan_x, pan_y);
        return 0;
    });
}

int mpeg4w_count(Writer* w) { return int(w->samples.size()); }
long mpeg4w_header(Writer* w, uint8_t* out) {
    if (out) std::memcpy(out, w->header.data(), w->header.size());
    return long(w->header.size());
}
// sample i's bytes (into out when not null); its key flag, display time
// and VOP type (3: an N-VOP) in info[0..2]
long mpeg4w_sample(Writer* w, int i, uint8_t* out, int* info) {
    const auto& s = w->samples[size_t(i)];
    if (out) std::memcpy(out, s.data(), s.size());
    info[0] = w->keys[size_t(i)];
    info[1] = w->display[size_t(i)];
    info[2] = w->types[size_t(i)];
    return long(s.size());
}

}  // extern "C"
