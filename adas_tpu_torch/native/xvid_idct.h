// FFmpeg's port of XviD's integer IDCT (libavcodec/xvididct.c) as x86
// builds of libavcodec run it (ff_xvid_idct_sse2, cv2's among them): the
// row pass with its per-row tables and rounding constants (the column
// pass's rounding folded into row 0), each result packed to 16 bits with
// saturation (packssdw), then the column pass in 16-bit lanes, its tangent
// multiplies keeping the high half of the product (pmulhw) and every sum
// saturating (paddsw, psubsw).  Equal to that version for any block, the
// extreme ones of damaged streams included.  libavcodec picks it for
// MPEG-4 Part 2 streams that an XviD build wrote
// (ff_mpeg4_workaround_bugs).  xvid_idct<false> puts the clipped block onto
// 8x8 pixels, xvid_idct<true> adds it to them.  Included by mpeg4.cpp
// inside its anonymous namespace, after simple_idct.h (whose clip_pixel it
// uses).
#pragma once

namespace xvid {

constexpr int kRowShift = 11, kColShift = 6;
constexpr int kRnd[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};
constexpr int kTab04[7] = {22725, 21407, 19266, 16384, 12873, 8867, 4520};
constexpr int kTab17[7] = {31521, 29692, 26722, 22725, 17855, 12299, 6270};
constexpr int kTab26[7] = {29692, 27969, 25172, 21407, 16819, 11585, 5906};
constexpr int kTab35[7] = {26722, 25172, 22654, 19266, 15137, 10426, 5315};
constexpr int kTan1 = 0x32EC, kTan2 = 0x6A0A, kTan3 = 0xAB0E, kSqrt2 = 0x5A82;

// SSE2's 16-bit lanes: a saturated pack or sum, and pmulhw (the high half
// of a signed product; kTan3 is tan(3pi/16) - 1 as a signed 16-bit value)
inline int16_t sat(int v) { return int16_t(v < -32768 ? -32768 : v > 32767 ? 32767 : v); }
inline int16_t add(int a, int b) { return sat(a + b); }
inline int16_t sub(int a, int b) { return sat(a - b); }
inline int16_t mulhi(int c, int x) { return int16_t((int16_t(c) * x) >> 16); }

// one row.  xvididct.c's C row leaves a DC-only row whose result rounds to
// 0 as it was (a DC of -4 in row 0 stays -4); the SSE2 version that x86
// builds of libavcodec run (cv2's among them) writes the zeros, and so does
// this one
inline void row(int16_t* in, const int* tab, int rnd) {
    const int c1 = tab[0], c2 = tab[1], c3 = tab[2], c4 = tab[3], c5 = tab[4], c6 = tab[5],
              c7 = tab[6];
    const int right = in[5] | in[6] | in[7], left = in[1] | in[2] | in[3];
    if (!(right | in[4])) {
        const int k = c4 * in[0] + rnd;
        if (left) {
            const int a0 = k + c2 * in[2], a1 = k + c6 * in[2];
            const int a2 = k - c6 * in[2], a3 = k - c2 * in[2];
            const int b0 = c1 * in[1] + c3 * in[3], b1 = c3 * in[1] - c7 * in[3];
            const int b2 = c5 * in[1] - c1 * in[3], b3 = c7 * in[1] - c5 * in[3];
            in[0] = sat((a0 + b0) >> kRowShift);
            in[1] = sat((a1 + b1) >> kRowShift);
            in[2] = sat((a2 + b2) >> kRowShift);
            in[3] = sat((a3 + b3) >> kRowShift);
            in[4] = sat((a3 - b3) >> kRowShift);
            in[5] = sat((a2 - b2) >> kRowShift);
            in[6] = sat((a1 - b1) >> kRowShift);
            in[7] = sat((a0 - b0) >> kRowShift);
        } else {
            const int a0 = k >> kRowShift;
            for (int i = 0; i < 8; i++) in[i] = sat(a0);
        }
    } else if (!(left | right)) {
        const int a0 = (rnd + c4 * (in[0] + in[4])) >> kRowShift;
        const int a1 = (rnd + c4 * (in[0] - in[4])) >> kRowShift;
        in[0] = in[3] = in[4] = in[7] = sat(a0);
        in[1] = in[2] = in[5] = in[6] = sat(a1);
    } else {
        const int k = c4 * in[0] + rnd;
        const int a0 = k + c2 * in[2] + c4 * in[4] + c6 * in[6];
        const int a1 = k + c6 * in[2] - c4 * in[4] - c2 * in[6];
        const int a2 = k - c6 * in[2] - c4 * in[4] + c2 * in[6];
        const int a3 = k - c2 * in[2] + c4 * in[4] - c6 * in[6];
        const int b0 = c1 * in[1] + c3 * in[3] + c5 * in[5] + c7 * in[7];
        const int b1 = c3 * in[1] - c7 * in[3] - c1 * in[5] - c5 * in[7];
        const int b2 = c5 * in[1] - c1 * in[3] + c7 * in[5] + c3 * in[7];
        const int b3 = c7 * in[1] - c5 * in[3] + c3 * in[5] - c1 * in[7];
        in[0] = sat((a0 + b0) >> kRowShift);
        in[1] = sat((a1 + b1) >> kRowShift);
        in[2] = sat((a2 + b2) >> kRowShift);
        in[3] = sat((a3 + b3) >> kRowShift);
        in[4] = sat((a3 - b3) >> kRowShift);
        in[5] = sat((a2 - b2) >> kRowShift);
        in[6] = sat((a1 - b1) >> kRowShift);
        in[7] = sat((a0 - b0) >> kRowShift);
    }
}

// one column, in the order of the SSE2 version's operations
inline void col(int16_t* in) {
    const int x0 = in[0], x1 = in[8], x2 = in[16], x3 = in[24], x4 = in[32], x5 = in[40],
              x6 = in[48], x7 = in[56];
    const int16_t tp17 = add(mulhi(kTan1, x7), x1), tm17 = sub(mulhi(kTan1, x1), x7);
    const int16_t tp35 = add(add(mulhi(kTan3, x5), x5), x3);
    const int16_t tm35 = sub(add(mulhi(kTan3, x3), x3), x5);
    const int16_t b0 = add(tp17, tp35), b3 = sub(tm17, tm35);
    const int16_t t1 = sub(tp17, tp35), t2 = add(tm17, tm35);
    const int16_t s = mulhi(kSqrt2, add(t1, t2)), d = mulhi(kSqrt2, sub(t1, t2));
    const int16_t b1 = add(s, s), b2 = add(d, d);
    const int16_t tp04 = add(x0, x4), tm04 = sub(x0, x4);
    const int16_t tp26 = add(mulhi(kTan2, x6), x2), tm26 = sub(mulhi(kTan2, x2), x6);
    const int16_t a0 = add(tp04, tp26), a3 = sub(tp04, tp26);
    const int16_t a1 = add(tm04, tm26), a2 = sub(tm04, tm26);
    in[0] = int16_t(add(a0, b0) >> kColShift);
    in[8] = int16_t(add(a1, b1) >> kColShift);
    in[16] = int16_t(add(a2, b2) >> kColShift);
    in[24] = int16_t(add(a3, b3) >> kColShift);
    in[32] = int16_t(sub(a3, b3) >> kColShift);
    in[40] = int16_t(sub(a2, b2) >> kColShift);
    in[48] = int16_t(sub(a1, b1) >> kColShift);
    in[56] = int16_t(sub(a0, b0) >> kColShift);
}

inline void transform(int16_t* in) {
    static const int* const tabs[8] = {kTab04, kTab17, kTab26, kTab35,
                                       kTab04, kTab35, kTab26, kTab17};
    for (int i = 0; i < 8; i++) row(in + 8 * i, tabs[i], kRnd[i]);
    for (int i = 0; i < 8; i++) col(in + i);
}

}  // namespace xvid

template <bool kAdd>
void xvid_idct(int16_t* block, uint8_t* dst, int stride) {
    xvid::transform(block);
    for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) {
            uint8_t* d = dst + y * stride + x;
            *d = clip_pixel(kAdd ? *d + block[y * 8 + x] : block[y * 8 + x]);
        }
}
