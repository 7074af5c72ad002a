// FFmpeg's port of XviD's integer IDCT (libavcodec/xvididct.c): the row
// pass with its per-row tables and rounding constants (the column pass's
// rounding folded into row 0), then the column pass in 16-bit tangent
// multiplies, equal to libavcodec's SSE2 version wherever no 16-bit
// intermediate of that version saturates (|output| < 512: every block of a
// stream whose pixels an encoder meant).  libavcodec picks it for MPEG-4 Part 2 streams that an XviD
// build wrote (ff_mpeg4_workaround_bugs).  xvid_idct<false> puts the
// clipped block onto 8x8 pixels, xvid_idct<true> adds it to them.  Included
// by mpeg4.cpp inside its anonymous namespace, after simple_idct.h (whose
// clip_pixel it uses).
#pragma once

namespace xvid {

constexpr int kRowShift = 11, kColShift = 6;
constexpr int kRnd[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};
constexpr int kTab04[7] = {22725, 21407, 19266, 16384, 12873, 8867, 4520};
constexpr int kTab17[7] = {31521, 29692, 26722, 22725, 17855, 12299, 6270};
constexpr int kTab26[7] = {29692, 27969, 25172, 21407, 16819, 11585, 5906};
constexpr int kTab35[7] = {26722, 25172, 22654, 19266, 15137, 10426, 5315};
constexpr int kTan1 = 0x32EC, kTan2 = 0x6A0A, kTan3 = 0xAB0E, kSqrt2 = 0x5A82;

inline int mult(int c, int x) { return (c * x) >> 16; }

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
            in[0] = int16_t((a0 + b0) >> kRowShift);
            in[1] = int16_t((a1 + b1) >> kRowShift);
            in[2] = int16_t((a2 + b2) >> kRowShift);
            in[3] = int16_t((a3 + b3) >> kRowShift);
            in[4] = int16_t((a3 - b3) >> kRowShift);
            in[5] = int16_t((a2 - b2) >> kRowShift);
            in[6] = int16_t((a1 - b1) >> kRowShift);
            in[7] = int16_t((a0 - b0) >> kRowShift);
        } else {
            const int a0 = k >> kRowShift;
            for (int i = 0; i < 8; i++) in[i] = int16_t(a0);
        }
    } else if (!(left | right)) {
        const int a0 = (rnd + c4 * (in[0] + in[4])) >> kRowShift;
        const int a1 = (rnd + c4 * (in[0] - in[4])) >> kRowShift;
        in[0] = in[3] = in[4] = in[7] = int16_t(a0);
        in[1] = in[2] = in[5] = in[6] = int16_t(a1);
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
        in[0] = int16_t((a0 + b0) >> kRowShift);
        in[1] = int16_t((a1 + b1) >> kRowShift);
        in[2] = int16_t((a2 + b2) >> kRowShift);
        in[3] = int16_t((a3 + b3) >> kRowShift);
        in[4] = int16_t((a3 - b3) >> kRowShift);
        in[5] = int16_t((a2 - b2) >> kRowShift);
        in[6] = int16_t((a1 - b1) >> kRowShift);
        in[7] = int16_t((a0 - b0) >> kRowShift);
    }
}

inline void col(int16_t* in) {
    int m0, m1, m2, m3, m4, m5, m6, m7, t;
    m4 = in[7 * 8];
    m5 = in[5 * 8];
    m6 = in[3 * 8];
    m7 = in[1 * 8];
    m0 = mult(kTan1, m4) + m7;
    m1 = mult(kTan1, m7) - m4;
    m2 = mult(kTan3, m5) + m6;
    m3 = mult(kTan3, m6) - m5;
    m7 = m0 + m2;
    m4 = m1 - m3;
    m0 = m0 - m2;
    m1 = m1 + m3;
    m6 = m0 + m1;
    m5 = m0 - m1;
    m5 = 2 * mult(kSqrt2, m5);
    m6 = 2 * mult(kSqrt2, m6);
    m0 = in[0] + in[4 * 8];
    m1 = in[0] - in[4 * 8];
    m3 = mult(kTan2, in[6 * 8]) + in[2 * 8];
    m2 = mult(kTan2, in[2 * 8]) - in[6 * 8];
    t = m0 + m3; m3 = m0 - m3; m0 = t;
    t = m0 + m7; m7 = m0 - m7; m0 = t;
    in[0 * 8] = int16_t(m0 >> kColShift);
    in[7 * 8] = int16_t(m7 >> kColShift);
    t = m3 + m4; m4 = m3 - m4; m3 = t;
    in[3 * 8] = int16_t(m3 >> kColShift);
    in[4 * 8] = int16_t(m4 >> kColShift);
    t = m1 + m2; m2 = m1 - m2; m1 = t;
    t = m1 + m6; m6 = m1 - m6; m1 = t;
    in[1 * 8] = int16_t(m1 >> kColShift);
    in[6 * 8] = int16_t(m6 >> kColShift);
    t = m2 + m5; m5 = m2 - m5; m2 = t;
    in[2 * 8] = int16_t(m2 >> kColShift);
    in[5 * 8] = int16_t(m5 >> kColShift);
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
