// FFmpeg's "simple" integer IDCT (libavcodec/simple_idct: W4 = 16383, the
// row pass with its DC shortcut, the column pass with its rounding folded
// into the DC term) as x86 builds of libavcodec run it for 8-bit MPEG-4
// Part 2 and Motion JPEG (ff_simple_idct8_sse2, cv2's among them): the C
// version's arithmetic, but each row result packed to 16 bits with
// saturation and the column's rounding added to its DC in a 16-bit lane,
// so equal to that version for any block, the extreme ones of damaged
// streams included.  idct<false> puts the clipped block onto 8x8 pixels,
// idct<true> adds it to them.  Shared by mpeg4.cpp and mjpeg.cpp, each of
// which includes it inside its own anonymous namespace.
#pragma once
constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867,
              W7 = 4520;
constexpr int kRowShift = 11, kColShift = 20, kDcShift = 3;

inline int16_t saturate16(int v) { return int16_t(v < -32768 ? -32768 : v > 32767 ? 32767 : v); }

inline void idct_row(int16_t* row) {
    bool ac = row[1] | row[2] | row[3] | row[4] | row[5] | row[6] | row[7];
    if (!ac) {
        int16_t v = int16_t(uint16_t(row[0] * (1 << kDcShift)));
        for (int i = 0; i < 8; i++) row[i] = v;
        return;
    }
    unsigned a0 = unsigned(W4) * row[0] + (1u << (kRowShift - 1));
    unsigned a1 = a0, a2 = a0, a3 = a0;
    a0 += unsigned(W2) * row[2];
    a1 += unsigned(W6) * row[2];
    a2 -= unsigned(W6) * row[2];
    a3 -= unsigned(W2) * row[2];
    unsigned b0 = unsigned(W1) * row[1] + unsigned(W3) * row[3];
    unsigned b1 = unsigned(W3) * row[1] - unsigned(W7) * row[3];
    unsigned b2 = unsigned(W5) * row[1] - unsigned(W1) * row[3];
    unsigned b3 = unsigned(W7) * row[1] - unsigned(W5) * row[3];
    if (row[4] | row[5] | row[6] | row[7]) {
        a0 += unsigned(W4) * row[4] + unsigned(W6) * row[6];
        a1 += -unsigned(W4) * row[4] - unsigned(W2) * row[6];
        a2 += -unsigned(W4) * row[4] + unsigned(W2) * row[6];
        a3 += unsigned(W4) * row[4] - unsigned(W6) * row[6];
        b0 += unsigned(W5) * row[5] + unsigned(W7) * row[7];
        b1 += -unsigned(W1) * row[5] - unsigned(W5) * row[7];
        b2 += unsigned(W7) * row[5] + unsigned(W3) * row[7];
        b3 += unsigned(W3) * row[5] - unsigned(W1) * row[7];
    }
    row[0] = saturate16(int(a0 + b0) >> kRowShift);
    row[7] = saturate16(int(a0 - b0) >> kRowShift);
    row[1] = saturate16(int(a1 + b1) >> kRowShift);
    row[6] = saturate16(int(a1 - b1) >> kRowShift);
    row[2] = saturate16(int(a2 + b2) >> kRowShift);
    row[5] = saturate16(int(a2 - b2) >> kRowShift);
    row[3] = saturate16(int(a3 + b3) >> kRowShift);
    row[4] = saturate16(int(a3 - b3) >> kRowShift);
}

inline uint8_t clip_pixel(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// one column of the block into 8 pixels of `dst` (add: onto them)
template <bool kAdd>
inline void idct_col(uint8_t* dst, int stride, const int16_t* col) {
    // the rounding added to the DC in 16 bits (paddw), where it may wrap
    unsigned a0 = unsigned(W4) * unsigned(int16_t(col[0] + ((1 << (kColShift - 1)) / W4)));
    unsigned a1 = a0, a2 = a0, a3 = a0;
    a0 += unsigned(W2) * col[16];
    a1 += unsigned(W6) * col[16];
    a2 += -unsigned(W6) * col[16];
    a3 += -unsigned(W2) * col[16];
    unsigned b0 = unsigned(W1) * col[8], b1 = unsigned(W3) * col[8];
    unsigned b2 = unsigned(W5) * col[8], b3 = unsigned(W7) * col[8];
    b0 += unsigned(W3) * col[24];
    b1 += -unsigned(W7) * col[24];
    b2 += -unsigned(W1) * col[24];
    b3 += -unsigned(W5) * col[24];
    if (col[32]) {
        a0 += unsigned(W4) * col[32];
        a1 += -unsigned(W4) * col[32];
        a2 += -unsigned(W4) * col[32];
        a3 += unsigned(W4) * col[32];
    }
    if (col[40]) {
        b0 += unsigned(W5) * col[40];
        b1 += -unsigned(W1) * col[40];
        b2 += unsigned(W7) * col[40];
        b3 += unsigned(W3) * col[40];
    }
    if (col[48]) {
        a0 += unsigned(W6) * col[48];
        a1 += -unsigned(W2) * col[48];
        a2 += unsigned(W2) * col[48];
        a3 += -unsigned(W6) * col[48];
    }
    if (col[56]) {
        b0 += unsigned(W7) * col[56];
        b1 += -unsigned(W5) * col[56];
        b2 += unsigned(W3) * col[56];
        b3 += -unsigned(W1) * col[56];
    }
    int out[8] = {int(a0 + b0) >> kColShift, int(a1 + b1) >> kColShift,
                  int(a2 + b2) >> kColShift, int(a3 + b3) >> kColShift,
                  int(a3 - b3) >> kColShift, int(a2 - b2) >> kColShift,
                  int(a1 - b1) >> kColShift, int(a0 - b0) >> kColShift};
    for (int i = 0; i < 8; i++) {
        uint8_t* d = dst + i * stride;
        *d = clip_pixel(kAdd ? *d + out[i] : out[i]);
    }
}

template <bool kAdd>
void idct(int16_t* block, uint8_t* dst, int stride) {
    for (int i = 0; i < 8; i++) idct_row(block + 8 * i);
    for (int i = 0; i < 8; i++) idct_col<kAdd>(dst + i, stride, block + i);
}
