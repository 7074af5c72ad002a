// Pixel loops of the port's still-image codec (render/image.py): the PNG
// reconstruction (the five row filters, Adam7, 1-16 bit samples of every
// colour type), a Huffman JPEG decoder (sequential and progressive), the
// BMP kinds render/image.py does not slice with numpy, and a baseline JPEG
// encoder, each writing what cv2.imread(path, IMREAD_COLOR) /
// cv2.imencode('.jpg', img) give.
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
// intervals; progressive scans as jdphuff.c decodes them (DC first and
// refine, AC first with EOB runs, AC refine with its correction bits) into
// a whole-image coefficient buffer that goes through the IDCT after the
// last scan; jidctint.c's integer "islow" IDCT and its range-limit table;
// jdsample.c's fancy (triangle) upsampling for h2v1, h1v2 and h2v2 chroma,
// the edges replicated as jdmainct.c's context rows and the upsampler's
// first and last columns do (and its box filter where the chroma is at
// most 2 samples wide); jdcolor.c's fixed-point YCbCr -> BGR tables.
// Baseline, extended sequential and progressive 8-bit Huffman frames of 1
// or 3 components; anything else returns an error code that names it, and
// so does a progressive file whose scans leave some of the first ten
// coefficients unsent or unrefined (libjpeg-turbo smooths its blocks,
// jdcoefct.c).  Every marker segment is read inside its stated length and
// the file, a Huffman table whose codes do not fit their lengths is
// refused (jdhuff.c), and so are a second frame header, sampling factors
// outside 1..4 and a progressive scan's bad Ss/Se/Ah/Al, as libjpeg
// refuses them: corrupt input returns an error code.
#include <cstdint>
#include <climits>
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

// the natural (row-major) position of zigzag index k, with 16 entries of
// 63 past the end for the runs of corrupt data (jutils.c's
// jpeg_natural_order has the same extra entries)
const int kZigzag[80] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// error codes (render/image.py names them)
enum {
    kOk = 0, kBadData = 1, kArithmetic = 3, kLossless = 4, kHierarchical = 5,
    kPrecision = 6, kComponents = 7, kSampling = 8, kNoFrame = 9, kTruncated = 10,
    kIncomplete = 11, kBadProgression = 12,
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
    // length must fit in that many bits and none may be all ones; a DC
    // table's symbols must be at most 15
    bool build(const uint8_t* counts, const uint8_t* symbols, int n, bool is_dc) {
        for (int i = 0; i < n && is_dc; ++i)
            if (symbols[i] > 15) return false;
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
    // progressive: the whole image's coefficients (bw x bh blocks of 64,
    // natural order), the quantization table latched at the component's
    // first scan (jdinput.c latch_quant_tables), and jdphuff.c's
    // coef_bits: the Al of the last scan that coded each coefficient, -1
    // before any did
    std::vector<int16_t> coef;
    uint16_t q[64];
    bool latched = false;
    int bits[64];
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

// ---- progressive (jdphuff.c): the four kinds of scan, one block each

int dc_first(BitReader& br, Component& c, const Huffman& dc, int16_t* blk, int al) {
    int s = decode_huff(br, dc);
    if (s < 0) return kBadData;
    int diff = s ? extend(br.get(s), s) : 0;
    if ((c.pred >= 0 && diff > INT32_MAX - c.pred) || (c.pred < 0 && diff < INT32_MIN - c.pred))
        return kBadData;  // JERR_BAD_DCT_COEF
    c.pred += diff;
    blk[0] = (int16_t)(uint16_t)((unsigned)c.pred << al);
    return kOk;
}

void dc_refine(BitReader& br, int16_t* blk, int al) {
    if (br.get(1)) blk[0] = (int16_t)(blk[0] | (1 << al));
}

int ac_first(BitReader& br, const Huffman& ac, int16_t* blk, int ss, int se, int al,
             int& eobrun) {
    if (eobrun > 0) {  // a block of the band of zeros
        --eobrun;
        return kOk;
    }
    for (int k = ss; k <= se; ++k) {
        int rs = decode_huff(br, ac);
        if (rs < 0) return kBadData;
        int r = rs >> 4, s = rs & 15;
        if (s) {
            k += r;
            int v = extend(br.get(s), s);
            blk[kZigzag[k]] = (int16_t)(uint16_t)((unsigned)v << al);
        } else if (r == 15) {
            k += 15;  // ZRL
        } else {  // EOBr: a run of 2^r + r more bits blocks, this one included
            eobrun = 1 << r;
            if (r) eobrun += br.get(r);
            --eobrun;
            break;
        }
    }
    return kOk;
}

// a correction bit for a coefficient already nonzero: 1 raises its
// magnitude by the bit being coded
inline void correct(BitReader& br, int16_t* coef, int p1, int m1) {
    if (br.get(1) && (*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
}

int ac_refine(BitReader& br, const Huffman& ac, int16_t* blk, int ss, int se, int al,
              int& eobrun) {
    const int p1 = 1 << al, m1 = -(1 << al);
    int k = ss;
    if (eobrun == 0) {
        for (; k <= se; ++k) {
            int rs = decode_huff(br, ac);
            if (rs < 0) return kBadData;
            int r = rs >> 4, s = rs & 15;
            if (s) {  // a newly nonzero coefficient (its size should be 1)
                s = br.get(1) ? p1 : m1;
            } else if (r != 15) {
                eobrun = 1 << r;
                if (r) eobrun += br.get(r);
                break;  // the rest of the block is the EOB run's
            }
            // skip r zero coefficients, correcting the nonzero ones passed
            do {
                int16_t* coef = blk + kZigzag[k];
                if (*coef != 0) {
                    correct(br, coef, p1, m1);
                } else if (--r < 0) {
                    break;
                }
                ++k;
            } while (k <= se);
            if (s) blk[kZigzag[k]] = (int16_t)s;
        }
    }
    if (eobrun > 0) {
        for (; k <= se; ++k) {
            int16_t* coef = blk + kZigzag[k];
            if (*coef != 0) correct(br, coef, p1, m1);
        }
        --eobrun;
    }
    return kOk;
}

// jdcoefct.c smoothing_ok: libjpeg-turbo smooths the blocks of a
// progressive image (block smoothing is on by default) when every
// component has a quantization table without zeros in its first ten
// zigzag positions and some DC, and some component's first nine AC
// coefficients are not all fully coded
bool would_smooth(const std::vector<Component>& comps) {
    bool useful = false;
    for (const auto& c : comps) {
        if (!c.latched) return false;
        for (int k = 0; k < 10; ++k)
            if (c.q[kZigzag[k]] == 0) return false;
        if (c.bits[0] < 0) return false;
        for (int k = 1; k < 10; ++k) useful |= c.bits[k] != 0;
    }
    return useful;
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

// ---------------------------------------------------------------- JPEG encoder
//
// The baseline JPEG libjpeg-turbo writes for cv2.imencode('.jpg', img) at
// its defaults (quality 95, 4:2:0, the standard Huffman tables, no
// optimisation, no restarts): jccolor.c rgb_ycc_convert, jcsample.c
// h2v2_downsample with expand_right_edge, jcprepct.c's bottom-edge
// replication, jfdctint.c jpeg_fdct_islow, jcdctmgr.c's reciprocal
// quantisation, jccoefct.c's dummy blocks, jchuff.c's bit packing, and
// jcmarker.c's markers.  libjpeg-turbo's SIMD versions of these compute
// the same integers.

// jcparam.c (Annex K), natural order
const uint8_t kStdLumaQ[64] = {
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jstdhuff.c: code counts of lengths 1-16, then the symbols
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffEnc {
    uint16_t code[256];
    uint8_t size[256];
    // jchuff.c jpeg_make_c_derived_tbl: canonical codes by length
    HuffEnc(const uint8_t* bits, const uint8_t* vals) {
        std::memset(size, 0, sizeof(size));
        int c = 0, k = 0;
        for (int len = 1; len <= 16; ++len, c <<= 1)
            for (int i = 0; i < bits[len - 1]; ++i, ++k, ++c) {
                code[vals[k]] = (uint16_t)c;
                size[vals[k]] = (uint8_t)len;
            }
    }
};

// jcdctmgr.c compute_reciprocal (16-bit DCTELEM): the divisor's
// reciprocal, rounding correction and shift
struct Divisor {
    uint32_t recip, corr;
    int shift;
};

Divisor reciprocal(uint32_t d) {
    if (d == 1) return {1, 0, 0};
    int b = 31 - __builtin_clz(d);
    int r = 16 + b;
    uint64_t fq = (1ULL << r) / d, fr = (1ULL << r) % d;
    uint32_t c = d / 2;
    if (fr == 0) {
        fq >>= 1;
        --r;
    } else if (fr <= d / 2) {
        ++c;
    } else {
        ++fq;
    }
    return {(uint32_t)fq, c, r};
}

// jfdctint.c, in place on 64 samples less 128; the output is scaled by 8
void fdct_islow(int* d) {
    for (int pass = 0; pass < 2; ++pass) {
        const int step = pass ? 8 : 1, next = pass ? 1 : 8;
        for (int i = 0; i < 8; ++i) {
            int* p = d + i * next;
            long tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
            long tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
            long tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
            long tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
            long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
            long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
            const int n = pass ? CONST_BITS + PASS1_BITS : CONST_BITS - PASS1_BITS;
            if (pass) {
                p[0] = (int)descale(tmp10 + tmp11, PASS1_BITS);
                p[4 * step] = (int)descale(tmp10 - tmp11, PASS1_BITS);
            } else {
                p[0] = (int)((tmp10 + tmp11) * (1 << PASS1_BITS));
                p[4 * step] = (int)((tmp10 - tmp11) * (1 << PASS1_BITS));
            }
            long z1 = (tmp12 + tmp13) * FIX_0_541196100;
            p[2 * step] = (int)descale(z1 + tmp13 * FIX_0_765366865, n);
            p[6 * step] = (int)descale(z1 + tmp12 * (-FIX_1_847759065), n);
            z1 = tmp4 + tmp7;
            long z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
            long z5 = (z3 + z4) * FIX_1_175875602;
            tmp4 *= FIX_0_298631336;
            tmp5 *= FIX_2_053119869;
            tmp6 *= FIX_3_072711026;
            tmp7 *= FIX_1_501321110;
            z1 *= -FIX_0_899976223;
            z2 *= -FIX_2_562915447;
            z3 *= -FIX_1_961570560;
            z4 *= -FIX_0_390180644;
            z3 += z5;
            z4 += z5;
            p[7 * step] = (int)descale(tmp4 + z1 + z3, n);
            p[5 * step] = (int)descale(tmp5 + z2 + z4, n);
            p[3 * step] = (int)descale(tmp6 + z2 + z3, n);
            p[step] = (int)descale(tmp7 + z1 + z4, n);
        }
    }
}

struct BitWriter {
    uint8_t* out;
    long cap, n = 0;
    uint64_t acc = 0;
    int bits = 0;
    bool overflow = false;
    void byte(int b) {
        if (n < cap) out[n] = (uint8_t)b;
        else overflow = true;
        ++n;
    }
    void put(uint32_t v, int size) {  // the low `size` bits of v
        acc = (acc << size) | (v & ((1u << size) - 1));
        bits += size;
        while (bits >= 8) {
            int b = (int)(acc >> (bits - 8)) & 0xFF;
            byte(b);
            if (b == 0xFF) byte(0);
            bits -= 8;
        }
    }
    void flush() {  // pad the last byte with 1-bits
        if (bits) put(0x7F, 8 - bits);
    }
    void marker(int m) {
        byte(0xFF);
        byte(m);
    }
    void u16(int v) {
        byte(v >> 8);
        byte(v & 0xFF);
    }
};

// one block's coefficients (natural order) in jchuff.c encode_one_block
void encode_block(BitWriter& bw, const int* coef, int& last_dc, const HuffEnc& dc,
                  const HuffEnc& ac) {
    int temp = coef[0] - last_dc, temp2 = temp;
    last_dc = coef[0];
    if (temp < 0) {
        temp = -temp;
        --temp2;
    }
    int nbits = 0;
    while (temp) {
        ++nbits;
        temp >>= 1;
    }
    bw.put(dc.code[nbits], dc.size[nbits]);
    if (nbits) bw.put((uint32_t)temp2, nbits);
    int r = 0;
    for (int k = 1; k < 64; ++k) {
        temp = coef[kZigzag[k]];
        if (temp == 0) {
            ++r;
            continue;
        }
        for (; r > 15; r -= 16) bw.put(ac.code[0xF0], ac.size[0xF0]);
        temp2 = temp;
        if (temp < 0) {
            temp = -temp;
            --temp2;
        }
        nbits = 1;
        while (temp >>= 1) ++nbits;
        int i = (r << 4) + nbits;
        bw.put(ac.code[i], ac.size[i]);
        bw.put((uint32_t)temp2, nbits);
        r = 0;
    }
    if (r > 0) bw.put(ac.code[0], ac.size[0]);
}

// a plane of rows x cols samples -> 8x8 blocks of quantized coefficients
// (natural order), blocks_w x blocks_h of them
void forward_blocks(const uint8_t* plane, int cols, int blocks_w, int blocks_h,
                    const Divisor* div, std::vector<int>& out) {
    out.assign((size_t)blocks_w * blocks_h * 64, 0);
    int ws[64];
    for (int by = 0; by < blocks_h; ++by)
        for (int bx = 0; bx < blocks_w; ++bx) {
            for (int r = 0; r < 8; ++r)
                for (int c = 0; c < 8; ++c)
                    ws[8 * r + c] = plane[(size_t)(8 * by + r) * cols + 8 * bx + c] - 128;
            fdct_islow(ws);
            int* o = out.data() + ((size_t)by * blocks_w + bx) * 64;
            for (int i = 0; i < 64; ++i) {
                int t = ws[i];
                uint64_t a = (uint64_t)(t < 0 ? -t : t);
                int v = (int)(((a + div[i].corr) * div[i].recip) >> div[i].shift);
                o[i] = t < 0 ? -v : v;
            }
        }
}

// jcparam.c jpeg_add_quant_table at jpeg_quality_scaling(quality), baseline
void quant_table(const uint8_t* basic, int quality, uint16_t* q) {
    quality = quality < 1 ? 1 : quality > 100 ? 100 : quality;
    long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    for (int i = 0; i < 64; ++i) {
        long t = (basic[i] * scale + 50) / 100;
        q[i] = (uint16_t)(t <= 0 ? 1 : t > 255 ? 255 : t);
    }
}

void put_dqt(BitWriter& bw, int index, const uint16_t* q) {
    bw.marker(0xDB);
    bw.u16(67);
    bw.byte(index);
    for (int k = 0; k < 64; ++k) bw.byte(q[kZigzag[k]]);
}

void put_dht(BitWriter& bw, int index, const uint8_t* bits, const uint8_t* vals) {
    int n = 0;
    for (int i = 0; i < 16; ++i) n += bits[i];
    bw.marker(0xC4);
    bw.u16(2 + 1 + 16 + n);
    bw.byte(index);
    for (int i = 0; i < 16; ++i) bw.byte(bits[i]);
    for (int i = 0; i < n; ++i) bw.byte(vals[i]);
}

inline int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// the error a frame marker names, or kOk for a frame the decoder takes
// (SOF0/1 sequential, SOF2 progressive, all Huffman)
int frame_kind(int m) {
    switch (m) {
    case 0xC0: case 0xC1: case 0xC2: return kOk;
    case 0xC3: return kLossless;
    case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF: return kHierarchical;
    case 0xC9: case 0xCA: case 0xCB: return kArithmetic;
    }
    return -1;  // not a frame marker
}

}  // namespace

extern "C" {

// cv2.imencode('.jpg', img) at its defaults: `img` is h x w x nch uint8
// (nch 1 gray, 3 BGR, 4 BGRA whose alpha is dropped), rows `stride` bytes
// apart; the file goes into out[0:cap].  Returns its length, or minus
// the length it needs when cap is too small.
long jpeg_encode(const uint8_t* img, int w, int h, int nch, long stride, int quality,
                 uint8_t* out, long cap) {
    const bool gray = nch == 1;
    const int nc = gray ? 1 : 3;
    // 4:2:0 for colour (jcparam.c jpeg_set_defaults): luma 2x2, chroma 1x1
    const int mh = gray ? 8 : 16, mw = gray ? 8 : 16;
    const int mcux = (w + mw - 1) / mw, mcuy = (h + mh - 1) / mh;
    const int ybw = (w + 7) / 8, ybh = (h + 7) / 8;  // luma width/height_in_blocks
    const int ycols = ybw * 8, yrows = mcuy * mh;
    // jccolor.c: Y, Cb, Cr of every pixel (gray: a copy), the planes padded
    // by replicating the last column (expand_right_edge) and the last row
    // (jcprepct.c expand_bottom_edge)
    std::vector<uint8_t> yp((size_t)ycols * yrows);
    const int ccols = mcux * 16;  // chroma input columns: 2 x its width_in_blocks x 8
    std::vector<uint8_t> cbf, crf;
    if (!gray) {
        cbf.resize((size_t)ccols * yrows);
        crf.resize((size_t)ccols * yrows);
    }
    static int32_t tab[8][256];
    static bool tab_built = false;
    if (!tab_built) {
        const long one_half = 1L << 15, cbcr_offset = 128L << 16;
        for (int i = 0; i < 256; ++i) {
            tab[0][i] = 19595 * i;                                 // FIX(0.29900)
            tab[1][i] = 38470 * i;                                 // FIX(0.58700)
            tab[2][i] = (int32_t)(7471 * i + one_half);            // FIX(0.11400)
            tab[3][i] = -11059 * i;                                // -FIX(0.16874)
            tab[4][i] = -21709 * i;                                // -FIX(0.33126)
            tab[5][i] = (int32_t)(32768 * i + cbcr_offset + one_half - 1);  // FIX(0.5)
            tab[6][i] = -27439 * i;                                // -FIX(0.41869)
            tab[7][i] = -5329 * i;                                 // -FIX(0.08131)
        }
        tab_built = true;
    }
    for (int y = 0; y < yrows; ++y) {
        const uint8_t* src = img + (size_t)(y < h ? y : h - 1) * stride;
        uint8_t* yo = yp.data() + (size_t)y * ycols;
        uint8_t* cbo = gray ? nullptr : cbf.data() + (size_t)y * ccols;
        uint8_t* cro = gray ? nullptr : crf.data() + (size_t)y * ccols;
        for (int x = 0; x < w; ++x) {
            const uint8_t* px = src + (size_t)x * nch;
            if (gray) {
                yo[x] = px[0];
                continue;
            }
            int b = px[0], g = px[1], r = px[2];
            yo[x] = (uint8_t)((tab[0][r] + tab[1][g] + tab[2][b]) >> 16);
            cbo[x] = (uint8_t)((tab[3][r] + tab[4][g] + tab[5][b]) >> 16);
            cro[x] = (uint8_t)((tab[5][r] + tab[6][g] + tab[7][b]) >> 16);
        }
        for (int x = w; x < ycols; ++x) yo[x] = yo[w - 1];
        if (!gray)
            for (int x = w; x < ccols; ++x) {
                cbo[x] = cbo[w - 1];
                cro[x] = cro[w - 1];
            }
    }
    uint16_t q[2][64];
    quant_table(kStdLumaQ, quality, q[0]);
    quant_table(kStdChromaQ, quality, q[1]);
    Divisor div[2][64];
    for (int t = 0; t < 2; ++t)
        for (int i = 0; i < 64; ++i) div[t][i] = reciprocal((uint32_t)q[t][i] << 3);
    std::vector<int> ycoef, cbcoef, crcoef;
    forward_blocks(yp.data(), ycols, ybw, ybh, div[0], ycoef);
    if (!gray) {
        // jcsample.c h2v2_downsample: 2x2 means, the bias 1, 2, 1, 2, ...
        // along each row; rows past the image's half replicate its last
        // (jcprepct.c pads the downsampled rows to the iMCU height)
        const int crows = mcuy * 8, cw = mcux * 8;
        const int real = (h + 1) / 2;
        std::vector<uint8_t> cb((size_t)cw * crows), cr((size_t)cw * crows);
        for (int y = 0; y < crows; ++y) {
            int sy = y < real ? y : real - 1;
            const uint8_t* b0 = cbf.data() + (size_t)(2 * sy) * ccols;
            const uint8_t* r0 = crf.data() + (size_t)(2 * sy) * ccols;
            for (int x = 0, bias = 1; x < cw; ++x, bias ^= 3) {
                cb[(size_t)y * cw + x] = (uint8_t)((b0[2 * x] + b0[2 * x + 1] + b0[ccols + 2 * x] +
                                                    b0[ccols + 2 * x + 1] + bias) >> 2);
                cr[(size_t)y * cw + x] = (uint8_t)((r0[2 * x] + r0[2 * x + 1] + r0[ccols + 2 * x] +
                                                    r0[ccols + 2 * x + 1] + bias) >> 2);
            }
        }
        forward_blocks(cb.data(), cw, mcux, mcuy, div[1], cbcoef);
        forward_blocks(cr.data(), cw, mcux, mcuy, div[1], crcoef);
    }
    BitWriter bw{out, cap};
    bw.marker(0xD8);
    // JFIF APP0: version 1.01, density unit 0, 1:1, no thumbnail
    static const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
    bw.marker(0xE0);
    bw.u16(16);
    for (uint8_t b : jfif) bw.byte(b);
    put_dqt(bw, 0, q[0]);
    if (!gray) put_dqt(bw, 1, q[1]);
    bw.marker(0xC0);
    bw.u16(8 + 3 * nc);
    bw.byte(8);
    bw.u16(h);
    bw.u16(w);
    bw.byte(nc);
    for (int c = 0; c < nc; ++c) {
        bw.byte(c + 1);
        bw.byte(gray ? 0x11 : c == 0 ? 0x22 : 0x11);
        bw.byte(c == 0 ? 0 : 1);
    }
    put_dht(bw, 0x00, kDcLumaBits, kDcVals);
    put_dht(bw, 0x10, kAcLumaBits, kAcLumaVals);
    if (!gray) {
        put_dht(bw, 0x01, kDcChromaBits, kDcVals);
        put_dht(bw, 0x11, kAcChromaBits, kAcChromaVals);
    }
    bw.marker(0xDA);
    bw.u16(6 + 2 * nc);
    bw.byte(nc);
    for (int c = 0; c < nc; ++c) {
        bw.byte(c + 1);
        bw.byte(c == 0 ? 0x00 : 0x11);
    }
    bw.byte(0);
    bw.byte(63);
    bw.byte(0);
    static const HuffEnc dc0(kDcLumaBits, kDcVals), ac0(kAcLumaBits, kAcLumaVals);
    static const HuffEnc dc1(kDcChromaBits, kDcVals), ac1(kAcChromaBits, kAcChromaVals);
    int last[3] = {0, 0, 0};
    if (gray) {
        for (int i = 0; i < ybw * ybh; ++i) encode_block(bw, ycoef.data() + (size_t)i * 64, last[0],
                                                         dc0, ac0);
    } else {
        // jccoefct.c: a luma block past the right or bottom edge of the
        // blocks is a dummy: AC zero, DC that of the block before it in
        // the MCU (for the bottom row, the MCU's last block above)
        int blk[4][64];
        for (int my = 0; my < mcuy; ++my)
            for (int mx = 0; mx < mcux; ++mx) {
                for (int i = 0; i < 4; ++i) {
                    int bx = 2 * mx + (i & 1), by = 2 * my + (i >> 1);
                    if (by >= ybh) {
                        std::memset(blk[i], 0, sizeof(blk[i]));
                        blk[i][0] = blk[1][0];
                    } else if (bx >= ybw) {
                        std::memset(blk[i], 0, sizeof(blk[i]));
                        blk[i][0] = blk[i - 1][0];
                    } else {
                        std::memcpy(blk[i], ycoef.data() + ((size_t)by * ybw + bx) * 64,
                                    sizeof(blk[i]));
                    }
                }
                for (int i = 0; i < 4; ++i) encode_block(bw, blk[i], last[0], dc0, ac0);
                size_t c = ((size_t)my * mcux + mx) * 64;
                encode_block(bw, cbcoef.data() + c, last[1], dc1, ac1);
                encode_block(bw, crcoef.data() + c, last[2], dc1, ac1);
            }
    }
    bw.flush();
    bw.marker(0xD9);
    return bw.overflow ? -bw.n : bw.n;
}

// BMP pixels as OpenCV's BmpDecoder (grfmt_bmp.cpp) writes them for
// IMREAD_COLOR: rows of 1-, 4- and 8-bit palette indices, RLE8 (rle 1) and
// RLE4 (rle 2), 16-bit 5-5-5 (bits 15) and 5-6-5 (bits 16); `palette`
// holds 256 BGRA entries (zero past the file's).  Returns 0, 1 (the data
// ends early) or 2 (an RLE run passes the end of its line).
int bmp_decode(const uint8_t* data, long len, int w, int h, int bits, int rle,
               const uint8_t* palette, int top_down, uint8_t* out) {
    const long width3 = (long)w * 3;
    // line y of the file (bottom-up unless top_down) -> its output row
    auto row = [&](int y) { return out + (size_t)(top_down ? y : h - 1 - y) * width3; };
    auto pix = [&](uint8_t* d, int i) {
        d[0] = palette[4 * i];
        d[1] = palette[4 * i + 1];
        d[2] = palette[4 * i + 2];
    };
    if (rle == 0) {
        long pitch = (((long)w * (bits == 15 ? 16 : bits) + 7) / 8 + 3) & ~3L;
        if (pitch * h > len) return 1;
        for (int y = 0; y < h; ++y) {
            const uint8_t* s = data + pitch * y;
            uint8_t* d = row(y);
            for (int x = 0; x < w; ++x, d += 3) {
                if (bits == 1) {
                    pix(d, (s[x >> 3] >> (7 - (x & 7))) & 1);
                } else if (bits == 4) {
                    pix(d, (s[x >> 1] >> (x & 1 ? 0 : 4)) & 15);
                } else if (bits == 8) {
                    pix(d, s[x]);
                } else {
                    int t = s[2 * x] | (s[2 * x + 1] << 8);
                    d[0] = (uint8_t)((t << 3) & 0xF8);
                    d[1] = (uint8_t)(bits == 15 ? (t >> 2) & 0xF8 : (t >> 3) & 0xFC);
                    d[2] = (uint8_t)(bits == 15 ? (t >> 7) & 0xF8 : (t >> 8) & 0xF8);
                }
            }
        }
        return 0;
    }
    // RLE: the decoder's position is line y, byte x3 of the line; a fill
    // of palette entry 0 (what OpenCV writes for skipped pixels) runs on
    // across lines (FillUniColor)
    long pos = 0;
    int y = 0;
    long x3 = 0;
    auto fill = [&](long count3, int index) {
        do {
            long n = count3 < width3 - x3 ? count3 : width3 - x3;
            count3 -= n;
            for (uint8_t* d = row(y) + x3; n > 0; n -= 3, d += 3, x3 += 3) pix(d, index);
            if (x3 >= width3) {
                x3 = 0;
                if (++y >= h) break;
            }
        } while (count3 > 0);
    };
    bool flag = false;  // RLE8: the last run ended its line (line_end_flag)
    for (;;) {
        if (pos + 2 > len) return 1;
        int count = data[pos], code = data[pos + 1];
        pos += 2;
        if (count) {  // encoded mode
            if (x3 + (long)count * 3 > width3) return 2;
            if (rle == 1) {
                int prev = y;
                fill((long)count * 3, code);
                flag = y != prev;
                if (y >= h) break;
            } else {
                uint8_t* d = row(y) + x3;
                for (int i = 0; i < count; ++i, d += 3) pix(d, i & 1 ? code & 15 : code >> 4);
                x3 += (long)count * 3;
            }
        } else if (code > 2) {  // absolute mode
            if (x3 + (long)code * 3 > width3) return 2;
            long sz = rle == 1 ? (code + 1) & ~1 : (((code + 1) >> 1) + 1) & ~1;
            if (pos + sz > len) return 1;
            const uint8_t* s = data + pos;
            uint8_t* d = row(y) + x3;
            for (int i = 0; i < code; ++i, d += 3)
                pix(d, rle == 1 ? s[i] : (s[i >> 1] >> (i & 1 ? 0 : 4)) & 15);
            x3 += (long)code * 3;
            pos += sz;
            flag = false;
        } else {  // 0 end of line, 1 end of bitmap, 2 delta (dx, dy)
            long shift3 = width3 - x3, yshift = h - y;
            if (code == 2) {
                if (pos + 2 > len) return 1;
                shift3 = data[pos] * 3L;
                yshift = data[pos + 1];
                pos += 2;
            }
            if (rle == 1) {
                // RLE8: the end of the bitmap fills every line left and a
                // delta dy lines more; an end of line right after a run
                // that ended its line is no more than that run's line break
                if (code) shift3 += yshift * width3;
                if (code || !flag || x3 > 0) {
                    if (y >= h) break;
                    fill(shift3, 0);
                    if (y >= h) break;
                }
                flag = false;
                if (y >= h) break;
            } else {
                // RLE4: an end of the bitmap ends only its line, and a
                // delta skips dx pixels (its dy is read and passed over)
                fill(shift3, 0);
                if (y >= h) break;
            }
        }
    }
    return 0;
}

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
        int kind = frame_kind(m);
        if (kind > 0) return kind;
        if (kind == kOk) {
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
    bool frame = false, progressive = false;
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
        int kind = frame_kind(m);
        if (kind > 0) return kind;
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
                if (!(tc ? ac : dc)[th].build(s + 1, s + 17, n, tc == 0)) return kBadData;
                s += 17 + n;
            }
        } else if (m == 0xDD) {  // DRI
            if (!has(2)) return kTruncated;
            restart = be16(s);
        } else if (kind == kOk) {  // SOF0/1/2
            if (frame) return kBadData;  // a second frame header (jdmarker.c)
            if (!has(6)) return kTruncated;
            if (s[0] != 8) return kPrecision;
            progressive = m == 0xC2;
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
                if (progressive) {
                    c.coef.assign((size_t)c.bw * c.bh * 64, 0);
                    for (int k = 0; k < 64; ++k) c.bits[k] = -1;
                }
            }
            frame = true;
        } else if (m == 0xDA) {  // SOS
            if (!frame) return kNoFrame;
            if (!has(1)) return kTruncated;
            int ns = s[0];
            if (ns < 1 || ns > (int)comps.size()) return kBadData;
            if (!has(1 + 2 * ns + 3)) return kTruncated;
            const uint8_t* sp = s + 1 + 2 * ns;
            int ss = sp[0], se = sp[1], ah = sp[2] >> 4, al = sp[2] & 15;
            if (progressive) {  // jdphuff.c start_pass_phuff_decoder
                bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
                if ((ah != 0 && al != ah - 1) || al > 13 || bad) return kBadProgression;
            }
            std::vector<Component*> sc;
            for (int i = 0; i < ns; ++i) {
                int cid = s[1 + 2 * i];
                Component* c = nullptr;
                for (auto& cc : comps) if (cc.id == cid) c = &cc;
                if (!c) return kBadData;
                c->td = s[2 + 2 * i] >> 4;
                c->ta = s[2 + 2 * i] & 15;
                if (c->td > 3 || c->ta > 3) return kBadData;
                // the tables this scan decodes with must be defined
                bool need_dc = !progressive || (ss == 0 && ah == 0);
                bool need_ac = !progressive || ss != 0;
                if ((need_dc && !dc[c->td].defined) || (need_ac && !ac[c->ta].defined))
                    return kBadData;
                if (progressive && !c->latched) {
                    if (!qdef[c->tq]) return kBadData;
                    std::memcpy(c->q, qt[c->tq], sizeof(c->q));
                    c->latched = true;
                }
                if (!progressive && !qdef[c->tq]) return kBadData;
                c->pred = 0;
                sc.push_back(c);
            }
            if (progressive)
                for (auto* c : sc)
                    for (int k = ss; k <= se; ++k) c->bits[k] = al;
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
            int eobrun = 0;
            for (int my = 0; my < mcuy; ++my) {
                for (int mx = 0; mx < mcux; ++mx, ++n) {
                    if (restart && n && n % restart == 0) {
                        if (!br.restart()) return kTruncated;
                        for (auto* c : sc) c->pred = 0;
                        eobrun = 0;
                    }
                    for (auto* c : sc) {
                        int bh = ns == 1 ? 1 : c->v, bwid = ns == 1 ? 1 : c->h;
                        for (int by = 0; by < bh; ++by)
                            for (int bx = 0; bx < bwid; ++bx) {
                                int x = mx * bwid + bx, y = my * bh + by, err = kOk;
                                if (!progressive) {
                                    err = decode_block(br, *c, dc, ac, qt[c->tq], x, y);
                                } else {
                                    int16_t* blk = c->coef.data() + ((size_t)y * c->bw + x) * 64;
                                    if (ss == 0 && ah == 0)
                                        err = dc_first(br, *c, dc[c->td], blk, al);
                                    else if (ss == 0)
                                        dc_refine(br, blk, al);
                                    else if (ah == 0)
                                        err = ac_first(br, ac[c->ta], blk, ss, se, al, eobrun);
                                    else
                                        err = ac_refine(br, ac[c->ta], blk, ss, se, al, eobrun);
                                }
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
    if (progressive) {
        if (would_smooth(comps)) return kIncomplete;
        // the coefficients through the IDCT; a component no scan named
        // stays at zero coefficients: mid-gray
        for (auto& c : comps) {
            if (!c.latched) {
                std::memset(c.plane.data(), 128, c.plane.size());
                continue;
            }
            for (int by = 0; by < c.bh; ++by)
                for (int bx = 0; bx < c.bw; ++bx)
                    idct_islow(c.coef.data() + ((size_t)by * c.bw + bx) * 64, c.q,
                               c.plane.data() + (size_t)by * 8 * c.bw * 8 + (size_t)bx * 8,
                               c.bw * 8);
        }
    }
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
