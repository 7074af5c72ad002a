// Pixel loops of the port's still-image codec (render/image.py): the PNG
// reconstruction (the five row filters, Adam7, 1-16 bit samples of every
// colour type) and a baseline Huffman JPEG decoder, each writing the 8-bit
// BGR image cv2.imread(path, IMREAD_COLOR) gives.
//
// PNG: render/image.py parses the chunks and inflates the IDAT stream
// (zlib); png_decode unfilters it and converts as OpenCV's reader asks
// libpng to: 16-bit samples keep their high byte (png_set_strip_16), gray
// of 1/2/4 bits scales to 8 (x255, x85, x17), palettes expand to RGB,
// alpha is dropped (png_set_strip_alpha), gray is replicated to three
// channels, RGB is swapped to BGR.
//
// JPEG: the decode libjpeg-turbo makes for OpenCV (JDCT_ISLOW, fancy
// upsampling on, output BGR): Huffman entropy decode with restart
// intervals; jidctint.c's integer "islow" IDCT and its range-limit table;
// jdsample.c's fancy (triangle) upsampling for h2v1, h1v2 and h2v2 chroma,
// the edges replicated as jdmainct.c's context rows and the upsampler's
// first and last columns do (and its box filter where the chroma is at
// most 2 samples wide); jdcolor.c's fixed-point YCbCr -> BGR tables.
// Baseline and extended sequential 8-bit Huffman frames of 1 or 3
// components; anything else returns an error code that names it.  Every
// marker segment is read inside its stated length and the file, a Huffman
// table whose codes do not fit their lengths is refused (jdhuff.c), and so
// are a second frame header and sampling factors outside 1..4, as
// libjpeg refuses them: corrupt input returns kBadData or kTruncated.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------- PNG

inline int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

// Unfilter `rows` rows of `rowbytes` bytes (each preceded by its filter
// byte) in place into `out` (rows * rowbytes); bpp = bytes per complete
// pixel (at least 1).  Returns 0, or -1 on an unknown filter type.
int unfilter(const uint8_t* in, int rows, int rowbytes, int bpp, uint8_t* out) {
    for (int y = 0; y < rows; ++y) {
        const uint8_t* src = in + (size_t)y * (rowbytes + 1);
        uint8_t* cur = out + (size_t)y * rowbytes;
        const uint8_t* prev = y ? cur - rowbytes : nullptr;
        int f = src[0];
        ++src;
        switch (f) {
        case 0:
            std::memcpy(cur, src, rowbytes);
            break;
        case 1:
            for (int i = 0; i < rowbytes; ++i)
                cur[i] = (uint8_t)(src[i] + (i >= bpp ? cur[i - bpp] : 0));
            break;
        case 2:
            for (int i = 0; i < rowbytes; ++i)
                cur[i] = (uint8_t)(src[i] + (prev ? prev[i] : 0));
            break;
        case 3:
            for (int i = 0; i < rowbytes; ++i) {
                int a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
                cur[i] = (uint8_t)(src[i] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (int i = 0; i < rowbytes; ++i) {
                int a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
                int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                cur[i] = (uint8_t)(src[i] + paeth(a, b, c));
            }
            break;
        default:
            return -1;
        }
    }
    return 0;
}

inline int channels_of(int color_type) {
    switch (color_type) {
    case 0: return 1;  // gray
    case 2: return 3;  // RGB
    case 3: return 1;  // palette index
    case 4: return 2;  // gray + alpha
    case 6: return 4;  // RGBA
    }
    return 0;
}

// Sample `s` (channel-major within the pixel) of pixel x in an unfiltered
// row, as an 8-bit value before the palette (16-bit: the high byte; gray
// 1/2/4 bits scaled to 8; a palette index unscaled).
inline int sample8(const uint8_t* row, int x, int s, int nch, int depth, int color_type) {
    if (depth == 8) return row[(size_t)x * nch + s];
    if (depth == 16) return row[((size_t)x * nch + s) * 2];
    int bit = x * depth;  // sub-byte depths have one channel
    int v = (row[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
    if (color_type == 3) return v;
    return depth == 1 ? v * 255 : depth == 2 ? v * 85 : v * 17;
}

void put_pixel(const uint8_t* row, int x, int nch, int depth, int color_type,
               const uint8_t* palette, int n_palette, uint8_t* dst) {
    if (color_type == 3) {
        int i = sample8(row, x, 0, nch, depth, color_type);
        const uint8_t* p = i < n_palette ? palette + 3 * i : nullptr;
        dst[0] = p ? p[2] : 0;
        dst[1] = p ? p[1] : 0;
        dst[2] = p ? p[0] : 0;
    } else if (color_type == 0 || color_type == 4) {
        uint8_t g = (uint8_t)sample8(row, x, 0, nch, depth, color_type);
        dst[0] = dst[1] = dst[2] = g;
    } else {
        dst[0] = (uint8_t)sample8(row, x, 2, nch, depth, color_type);
        dst[1] = (uint8_t)sample8(row, x, 1, nch, depth, color_type);
        dst[2] = (uint8_t)sample8(row, x, 0, nch, depth, color_type);
    }
}

// ---------------------------------------------------------------- JPEG

const int kZigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// error codes (render/image.py names them)
enum {
    kOk = 0, kBadData = 1, kProgressive = 2, kArithmetic = 3, kLossless = 4,
    kHierarchical = 5, kPrecision = 6, kComponents = 7, kSampling = 8, kNoFrame = 9,
    kTruncated = 10,
};

struct Huffman {
    // code lengths 1-16 -> canonical codes; a 9-bit lookahead table
    uint8_t lookup_len[512];
    uint8_t lookup_val[512];
    int maxcode[18];
    int valptr[17];
    int mincode[17];
    uint8_t vals[256];
    bool defined = false;

    // false for an over-subscribed table: as jdhuff.c, the codes of each
    // length must fit in that many bits and none may be all ones
    bool build(const uint8_t* counts, const uint8_t* symbols, int n) {
        std::memcpy(vals, symbols, n);
        int code = 0, k = 0;
        std::memset(lookup_len, 0, sizeof(lookup_len));
        for (int len = 1; len <= 16; ++len) {
            if (code + counts[len - 1] >= (1 << len)) return false;
            valptr[len] = k;
            mincode[len] = code;
            for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
                if (len <= 9) {
                    int shift = 9 - len;
                    for (int j = 0; j < (1 << shift); ++j) {
                        lookup_len[(code << shift) | j] = (uint8_t)len;
                        lookup_val[(code << shift) | j] = symbols[k];
                    }
                }
            }
            maxcode[len] = counts[len - 1] ? code - 1 : -1;
            code <<= 1;
        }
        maxcode[17] = 0x7fffffff;
        defined = true;
        return true;
    }
};

struct BitReader {
    const uint8_t* p;
    const uint8_t* end;
    uint64_t acc = 0;
    int bits = 0;
    bool marker = false;  // a marker was reached: feed zeros

    void fill() {
        while (bits <= 56) {
            int byte = 0;
            if (!marker && p < end) {
                byte = *p;
                if (byte == 0xFF) {
                    int next = p + 1 < end ? p[1] : 0;
                    if (next == 0x00) {
                        p += 2;
                    } else {
                        marker = true;
                        byte = 0;
                    }
                } else {
                    ++p;
                }
            }
            acc |= (uint64_t)byte << (56 - bits);
            bits += 8;
        }
    }
    inline int peek(int n) {
        if (bits < n) fill();
        return (int)(acc >> (64 - n));
    }
    inline void skip(int n) {
        acc <<= n;
        bits -= n;
    }
    inline int get(int n) {
        if (n == 0) return 0;
        int v = peek(n);
        skip(n);
        return v;
    }
    // at a restart: drop the partial byte and read RSTn
    bool restart() {
        acc = 0;
        bits = 0;
        marker = false;
        while (p + 1 < end && !(p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7)) ++p;
        if (p + 1 >= end) return false;
        p += 2;
        return true;
    }
};

inline int decode_huff(BitReader& br, const Huffman& h) {
    int look = br.peek(9);
    int len = h.lookup_len[look];
    if (len) {
        br.skip(len);
        return h.lookup_val[look];
    }
    int code = br.get(9);
    len = 9;
    while (code > h.maxcode[len]) {
        code = (code << 1) | br.get(1);
        if (++len > 16) return -1;
    }
    return h.vals[h.valptr[len] + code - h.mincode[len]];
}

inline int extend(int v, int t) {
    return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
}

// jidctint.c (libjpeg-turbo), the accurate integer IDCT
const int CONST_BITS = 13, PASS1_BITS = 2;
const long FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
           FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
           FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
           FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline long descale(long x, int n) { return (x + (1L << (n - 1))) >> n; }

struct RangeLimit {
    uint8_t idct[1024];   // post-IDCT table, indexed by value & 1023
    uint8_t simple[768];  // simple[x + 256] = clamp(x) for x in [-256, 511]
    RangeLimit() {
        for (int i = 0; i < 768; ++i) simple[i] = (uint8_t)(i < 256 ? 0 : i < 512 ? i - 256 : 255);
        for (int i = 0; i < 1024; ++i)
            idct[i] = (uint8_t)(i < 128 ? 128 + i : i < 512 ? 255 : i < 896 ? 0 : i - 896);
    }
};
const RangeLimit kLimit;

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
    int ws[64];
    for (int c = 0; c < 8; ++c) {
        const int16_t* in = coef + c;
        const uint16_t* qp = q + c;
        int* w = ws + c;
        if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
            int dc = in[0] * qp[0] * (1 << PASS1_BITS);
            for (int r = 0; r < 8; ++r) w[8 * r] = dc;
            continue;
        }
        long z2 = in[16] * qp[16], z3 = in[48] * qp[48];
        long z1 = (z2 + z3) * FIX_0_541196100;
        long tmp2 = z1 + z3 * (-FIX_1_847759065);
        long tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = in[0] * qp[0];
        z3 = in[32] * qp[32];
        long tmp0 = (z2 + z3) * (1L << CONST_BITS);
        long tmp1 = (z2 - z3) * (1L << CONST_BITS);
        long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = in[56] * qp[56];
        tmp1 = in[40] * qp[40];
        tmp2 = in[24] * qp[24];
        tmp3 = in[8] * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        long z4 = tmp1 + tmp3;
        long z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int n = CONST_BITS - PASS1_BITS;
        w[0] = (int)descale(tmp10 + tmp3, n);
        w[56] = (int)descale(tmp10 - tmp3, n);
        w[8] = (int)descale(tmp11 + tmp2, n);
        w[48] = (int)descale(tmp11 - tmp2, n);
        w[16] = (int)descale(tmp12 + tmp1, n);
        w[40] = (int)descale(tmp12 - tmp1, n);
        w[24] = (int)descale(tmp13 + tmp0, n);
        w[32] = (int)descale(tmp13 - tmp0, n);
    }
    const uint8_t* lim = kLimit.idct;
    const int n = CONST_BITS + PASS1_BITS + 3;
    for (int r = 0; r < 8; ++r) {
        const int* w = ws + 8 * r;
        uint8_t* o = out + (size_t)r * stride;
        if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
            uint8_t v = lim[(int)descale(w[0], PASS1_BITS + 3) & 1023];
            for (int i = 0; i < 8; ++i) o[i] = v;
            continue;
        }
        long z2 = w[2], z3 = w[6];
        long z1 = (z2 + z3) * FIX_0_541196100;
        long tmp2 = z1 + z3 * (-FIX_1_847759065);
        long tmp3 = z1 + z2 * FIX_0_765366865;
        long tmp0 = ((long)w[0] + w[4]) * (1L << CONST_BITS);
        long tmp1 = ((long)w[0] - w[4]) * (1L << CONST_BITS);
        long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        long z4 = tmp1 + tmp3;
        long z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        o[0] = lim[(int)descale(tmp10 + tmp3, n) & 1023];
        o[7] = lim[(int)descale(tmp10 - tmp3, n) & 1023];
        o[1] = lim[(int)descale(tmp11 + tmp2, n) & 1023];
        o[6] = lim[(int)descale(tmp11 - tmp2, n) & 1023];
        o[2] = lim[(int)descale(tmp12 + tmp1, n) & 1023];
        o[5] = lim[(int)descale(tmp12 - tmp1, n) & 1023];
        o[3] = lim[(int)descale(tmp13 + tmp0, n) & 1023];
        o[4] = lim[(int)descale(tmp13 - tmp0, n) & 1023];
    }
}

struct Component {
    int id, h, v, tq;
    int td = 0, ta = 0;
    int pred = 0;
    int bw = 0, bh = 0;  // blocks across and down the padded plane
    int dw = 0, dh = 0;  // the component's own (downsampled) size
    std::vector<uint8_t> plane;
};

int decode_block(BitReader& br, Component& c, const Huffman* dc, const Huffman* ac,
                 const uint16_t* q, int bx, int by) {
    int16_t coef[64] = {0};
    int t = decode_huff(br, dc[c.td]);
    if (t < 0 || t > 11) return kBadData;
    int diff = t ? extend(br.get(t), t) : 0;
    // jdhuff.c sums in unsigned: a run of corrupt differences wraps
    c.pred = (int)((unsigned)c.pred + (unsigned)diff);
    coef[0] = (int16_t)c.pred;
    for (int k = 1; k < 64;) {
        int rs = decode_huff(br, ac[c.ta]);
        if (rs < 0) return kBadData;
        int r = rs >> 4, s = rs & 15;
        if (s == 0) {
            if (r != 15) break;
            k += 16;
            continue;
        }
        k += r;
        if (k > 63) return kBadData;
        coef[kZigzag[k]] = (int16_t)extend(br.get(s), s);
        ++k;
    }
    idct_islow(coef, q, c.plane.data() + (size_t)by * 8 * c.bw * 8 + (size_t)bx * 8, c.bw * 8);
    return kOk;
}

// jdsample.c fancy upsampling of one component plane to the max factors,
// into `out` (height rows of `width` samples, the image's size)
void upsample(const Component& c, int hmax, int vmax, int width, int height,
              std::vector<uint8_t>& out) {
    out.assign((size_t)width * height, 0);
    const int stride = c.bw * 8;
    const uint8_t* src = c.plane.data();
    int fh = hmax / c.h, fv = vmax / c.v;
    auto in = [&](int y, int x) -> int { return src[(size_t)y * stride + x]; };
    int dw = c.dw, dh = c.dh;
    for (int oy = 0; oy < height; ++oy) {
        uint8_t* o = out.data() + (size_t)oy * width;
        if (fh == 1 && fv == 1) {
            std::memcpy(o, src + (size_t)oy * stride, width);
        } else if (fh == 2 && dw <= 2) {
            // jdsample.c takes the fancy h2v1/h2v2 filters only for a
            // downsampled width above 2; else the box (replicating) one
            const uint8_t* r = src + (size_t)(oy / fv) * stride;
            for (int x = 0; x < width; ++x) o[x] = r[x >> 1];
        } else if (fh == 2 && fv == 1) {  // h2v1
            int y = oy;
            std::vector<uint8_t> r((size_t)dw * 2);
            r[0] = (uint8_t)in(y, 0);
            if (dw == 1) {
                r[1] = r[0];
            } else {
                r[1] = (uint8_t)((in(y, 0) * 3 + in(y, 1) + 2) >> 2);
                for (int x = 1; x < dw - 1; ++x) {
                    int iv = in(y, x) * 3;
                    r[2 * x] = (uint8_t)((iv + in(y, x - 1) + 1) >> 2);
                    r[2 * x + 1] = (uint8_t)((iv + in(y, x + 1) + 2) >> 2);
                }
                r[2 * dw - 2] = (uint8_t)((in(y, dw - 1) * 3 + in(y, dw - 2) + 1) >> 2);
                r[2 * dw - 1] = (uint8_t)in(y, dw - 1);
            }
            std::memcpy(o, r.data(), width);
        } else if (fh == 1 && fv == 2) {  // h1v2
            int y = oy >> 1, v = oy & 1;
            int y1 = v == 0 ? (y > 0 ? y - 1 : 0) : (y + 1 < dh ? y + 1 : dh - 1);
            int bias = v == 0 ? 1 : 2;
            for (int x = 0; x < width; ++x)
                o[x] = (uint8_t)((in(y, x) * 3 + in(y1, x) + bias) >> 2);
        } else {  // h2v2
            int y = oy >> 1, v = oy & 1;
            int y1 = v == 0 ? (y > 0 ? y - 1 : 0) : (y + 1 < dh ? y + 1 : dh - 1);
            std::vector<uint8_t> r((size_t)dw * 2);
            auto colsum = [&](int x) { return in(y, x) * 3 + in(y1, x); };
            if (dw == 1) {
                int s = colsum(0);
                r[0] = (uint8_t)((s * 4 + 8) >> 4);
                r[1] = (uint8_t)((s * 4 + 7) >> 4);
            } else {
                int thiscol = colsum(0), nextcol = colsum(1), lastcol;
                r[0] = (uint8_t)((thiscol * 4 + 8) >> 4);
                r[1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
                lastcol = thiscol;
                thiscol = nextcol;
                for (int x = 1; x < dw - 1; ++x) {
                    nextcol = colsum(x + 1);
                    r[2 * x] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
                    r[2 * x + 1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
                    lastcol = thiscol;
                    thiscol = nextcol;
                }
                r[2 * dw - 2] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
                r[2 * dw - 1] = (uint8_t)((thiscol * 4 + 7) >> 4);
            }
            std::memcpy(o, r.data(), width);
        }
    }
}

inline int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

}  // namespace

extern "C" {

// PNG: `raw` is the inflated IDAT stream; returns 0, or -1 (bad filter
// type) / -2 (the stream is shorter than the image needs).
int png_decode(const uint8_t* raw, long raw_len, int w, int h, int color_type, int depth,
               int interlace, const uint8_t* palette, int n_palette, uint8_t* out) {
    int nch = channels_of(color_type);
    int bits_pp = nch * depth;
    int bpp = bits_pp >= 8 ? bits_pp / 8 : 1;
    static const int X0[7] = {0, 4, 0, 2, 0, 1, 0}, Y0[7] = {0, 0, 4, 0, 2, 0, 1};
    static const int DX[7] = {8, 8, 4, 4, 2, 2, 1}, DY[7] = {8, 8, 8, 4, 4, 2, 2};
    int passes = interlace ? 7 : 1;
    long pos = 0;
    std::vector<uint8_t> rows;
    for (int p = 0; p < passes; ++p) {
        int x0 = interlace ? X0[p] : 0, y0 = interlace ? Y0[p] : 0;
        int dx = interlace ? DX[p] : 1, dy = interlace ? DY[p] : 1;
        int pw = w > x0 ? (w - x0 + dx - 1) / dx : 0;
        int ph = h > y0 ? (h - y0 + dy - 1) / dy : 0;
        if (pw == 0 || ph == 0) continue;
        int rowbytes = (int)(((long)pw * bits_pp + 7) / 8);
        long need = (long)ph * (rowbytes + 1);
        if (pos + need > raw_len) return -2;
        rows.resize((size_t)ph * rowbytes);
        if (unfilter(raw + pos, ph, rowbytes, bpp, rows.data())) return -1;
        pos += need;
        for (int j = 0; j < ph; ++j) {
            const uint8_t* row = rows.data() + (size_t)j * rowbytes;
            uint8_t* dst = out + ((size_t)(y0 + j * dy) * w) * 3;
            for (int i = 0; i < pw; ++i)
                put_pixel(row, i, nch, depth, color_type, palette, n_palette,
                          dst + (size_t)(x0 + i * dx) * 3);
        }
    }
    return 0;
}

// JPEG header: the frame's size and components -> 0, or an error code.
int jpeg_info(const uint8_t* data, long len, int* w, int* h, int* ncomp) {
    const uint8_t* p = data + 2;
    const uint8_t* end = data + len;
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return kBadData;
    while (p + 4 <= end) {
        if (p[0] != 0xFF) return kBadData;
        int m = p[1];
        if (m == 0xFF) { ++p; continue; }
        int seglen = be16(p + 2);
        if (seglen < 2) return kBadData;
        if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) return kProgressive;
        if (m >= 0xC9 && m <= 0xCF && m != 0xCC) return kArithmetic;
        if (m == 0xCC) return kArithmetic;
        if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) return kLossless;
        if (m == 0xC5) return kHierarchical;
        if (m == 0xC0 || m == 0xC1) {
            if (seglen < 8 || p + 10 > end) return kTruncated;
            if (p[4] != 8) return kPrecision;
            *h = be16(p + 5);
            *w = be16(p + 7);
            *ncomp = p[9];
            return *w && *h ? kOk : kBadData;
        }
        p += 2 + seglen;
    }
    return kNoFrame;
}

// JPEG decode into `out` (out_h x out_w x 3 BGR, jpeg_info's size) -> 0,
// or an error code; a frame of another size is refused.
int jpeg_decode(const uint8_t* data, long len, int out_w, int out_h, uint8_t* out) {
    const uint8_t* p = data + 2;
    const uint8_t* end = data + len;
    if (len < 4) return kTruncated;
    uint16_t qt[4][64] = {{0}};
    bool qdef[4] = {false, false, false, false};
    Huffman dc[4], ac[4];
    std::vector<Component> comps;
    int width = 0, height = 0, restart = 0, hmax = 1, vmax = 1;
    bool frame = false;
    int scans = 0;
    while (p + 2 <= end) {
        if (p[0] != 0xFF) return kBadData;
        int m = p[1];
        if (m == 0xFF) { ++p; continue; }
        if (m == 0xD9) break;
        if (p + 4 > end) return kTruncated;
        int seglen = be16(p + 2);
        if (seglen < 2) return kBadData;
        const uint8_t* s = p + 4;
        const uint8_t* seg_end = p + 2 + seglen;
        if (seg_end > end) return kTruncated;
        // the segment holds at least `n` more bytes from s
        auto has = [&](long n) { return seg_end - s >= n; };
        if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) return kProgressive;
        if (m == 0xCC || (m >= 0xC9 && m <= 0xCF)) return kArithmetic;
        if (m == 0xC3 || m == 0xC7) return kLossless;
        if (m == 0xC5) return kHierarchical;
        if (m == 0xDB) {  // DQT
            while (s < seg_end) {
                int pq = s[0] >> 4, tq = s[0] & 15;
                if (tq > 3 || pq > 1) return kBadData;
                ++s;
                if (!has(pq ? 128 : 64)) return kTruncated;
                qdef[tq] = true;
                for (int k = 0; k < 64; ++k) {
                    qt[tq][kZigzag[k]] = (uint16_t)(pq ? be16(s + 2 * k) : s[k]);
                }
                s += pq ? 128 : 64;
            }
        } else if (m == 0xC4) {  // DHT
            while (s < seg_end) {
                if (!has(17)) return kTruncated;
                int tc = s[0] >> 4, th = s[0] & 15;
                if (th > 3 || tc > 1) return kBadData;
                int n = 0;
                for (int i = 0; i < 16; ++i) n += s[1 + i];
                if (n > 256) return kBadData;
                if (!has(17 + n)) return kTruncated;
                if (!(tc ? ac : dc)[th].build(s + 1, s + 17, n)) return kBadData;
                s += 17 + n;
            }
        } else if (m == 0xDD) {  // DRI
            if (!has(2)) return kTruncated;
            restart = be16(s);
        } else if (m == 0xC0 || m == 0xC1) {  // SOF0/1
            if (frame) return kBadData;  // a second frame header (jdmarker.c)
            if (!has(6)) return kTruncated;
            if (s[0] != 8) return kPrecision;
            height = be16(s + 1);
            width = be16(s + 3);
            if (width != out_w || height != out_h || !width || !height) return kBadData;
            int n = s[5];
            if (n != 1 && n != 3) return kComponents;
            if (!has(6 + 3 * n)) return kTruncated;
            comps.resize(n);
            for (int i = 0; i < n; ++i) {
                comps[i].id = s[6 + 3 * i];
                comps[i].h = s[7 + 3 * i] >> 4;
                comps[i].v = s[7 + 3 * i] & 15;
                comps[i].tq = s[8 + 3 * i];
                if (comps[i].h < 1 || comps[i].h > 4 || comps[i].v < 1 || comps[i].v > 4 ||
                    comps[i].tq > 3)
                    return kBadData;
                hmax = comps[i].h > hmax ? comps[i].h : hmax;
                vmax = comps[i].v > vmax ? comps[i].v : vmax;
            }
            if (hmax > 2 || vmax > 2) return kSampling;
            int mcux = (width + 8 * hmax - 1) / (8 * hmax), mcuy = (height + 8 * vmax - 1) / (8 * vmax);
            for (auto& c : comps) {
                if (hmax % c.h || vmax % c.v || (n == 3 && &c != &comps[0] && (c.h != 1 || c.v != 1)))
                    return kSampling;
                c.bw = mcux * c.h;
                c.bh = mcuy * c.v;
                c.dw = (width * c.h + hmax - 1) / hmax;
                c.dh = (height * c.v + vmax - 1) / vmax;
                c.plane.assign((size_t)c.bw * 8 * c.bh * 8, 0);
            }
            frame = true;
        } else if (m == 0xDA) {  // SOS
            if (!frame) return kNoFrame;
            if (!has(1)) return kTruncated;
            int ns = s[0];
            if (ns < 1 || ns > (int)comps.size()) return kBadData;
            if (!has(1 + 2 * ns + 3)) return kTruncated;
            std::vector<Component*> sc;
            for (int i = 0; i < ns; ++i) {
                int cid = s[1 + 2 * i];
                Component* c = nullptr;
                for (auto& cc : comps) if (cc.id == cid) c = &cc;
                if (!c) return kBadData;
                c->td = s[2 + 2 * i] >> 4;
                c->ta = s[2 + 2 * i] & 15;
                if (c->td > 3 || c->ta > 3 || !dc[c->td].defined || !ac[c->ta].defined ||
                    !qdef[c->tq])
                    return kBadData;
                c->pred = 0;
                sc.push_back(c);
            }
            BitReader br{seg_end, end};
            int mcux, mcuy;
            if (ns == 1) {  // non-interleaved: the component's own blocks
                mcux = (sc[0]->dw + 7) / 8;
                mcuy = (sc[0]->dh + 7) / 8;
            } else {
                mcux = (width + 8 * hmax - 1) / (8 * hmax);
                mcuy = (height + 8 * vmax - 1) / (8 * vmax);
            }
            long n = 0;
            for (int my = 0; my < mcuy; ++my) {
                for (int mx = 0; mx < mcux; ++mx, ++n) {
                    if (restart && n && n % restart == 0) {
                        if (!br.restart()) return kTruncated;
                        for (auto* c : sc) c->pred = 0;
                    }
                    for (auto* c : sc) {
                        int bh = ns == 1 ? 1 : c->v, bwid = ns == 1 ? 1 : c->h;
                        for (int by = 0; by < bh; ++by)
                            for (int bx = 0; bx < bwid; ++bx) {
                                int err = decode_block(br, *c, dc, ac, qt[c->tq],
                                                       mx * bwid + bx, my * bh + by);
                                if (err) return err;
                            }
                    }
                }
            }
            ++scans;
            // past the entropy-coded data: find the next marker
            const uint8_t* q = br.p;
            while (q + 1 < end && !(q[0] == 0xFF && q[1] != 0x00 && !(q[1] >= 0xD0 && q[1] <= 0xD7)))
                ++q;
            p = q;
            continue;
        }
        p = seg_end;
    }
    if (!frame) return kNoFrame;
    if (!scans) return kTruncated;  // no image data (jdapimin.c JERR_NO_IMAGE)
    if (comps.size() == 1) {  // gray, replicated (jdcolor.c gray_rgb_convert)
        const Component& c = comps[0];
        for (int y = 0; y < height; ++y) {
            const uint8_t* row = c.plane.data() + (size_t)y * c.bw * 8;
            uint8_t* o = out + (size_t)y * width * 3;
            for (int x = 0; x < width; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = row[x];
        }
        return kOk;
    }
    std::vector<uint8_t> planes[3];
    for (int i = 0; i < 3; ++i) upsample(comps[i], hmax, vmax, width, height, planes[i]);
    // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
    static int cr_r[256], cb_b[256];
    static long cr_g[256], cb_g[256];
    static bool built = false;
    if (!built) {
        const long one_half = 1L << 15;
        for (int i = 0; i < 256; ++i) {
            long x = i - 128;
            cr_r[i] = (int)((91881L * x + one_half) >> 16);    // FIX(1.40200)
            cb_b[i] = (int)((116130L * x + one_half) >> 16);   // FIX(1.77200)
            cr_g[i] = -46802L * x;                             // -FIX(0.71414)
            cb_g[i] = -22554L * x + one_half;                  // -FIX(0.34414)
        }
        built = true;
    }
    const uint8_t* lim = kLimit.simple + 256;
    for (size_t i = 0; i < (size_t)width * height; ++i) {
        int y = planes[0][i], cb = planes[1][i], cr = planes[2][i];
        out[3 * i + 2] = lim[y + cr_r[cr]];
        out[3 * i + 1] = lim[y + (int)((cb_g[cb] + cr_g[cr]) >> 16)];
        out[3 * i + 0] = lim[y + cb_b[cb]];
    }
    return kOk;
}

}  // extern "C"
