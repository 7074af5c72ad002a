// Motion JPEG (a JPEG picture per video frame) decoded as FFmpeg's `mjpeg`
// decoder decodes it for cv2.VideoCapture, for render/mjpeg.py.  This is
// not image.cpp's still-image decoder: cv2.imread goes through libjpeg,
// video through libavcodec, and the two round differently.
//
// What follows FFmpeg (libavcodec/mjpegdec.c, baseline sequential path):
// - markers are found as find_marker finds them (0xFF then a code in
//   SOF0..COM, garbage skipped); SOI clears the restart interval; a packet
//   ends at EOI, or at its end once a scan was decoded ("EOI missing");
// - the DC predictor lives in the dequantised domain and starts (at each
//   scan and restart) at 4 << 8 = 1024, which is where the +128 level
//   shift comes in; the DC is clipped to int16 in the block, the AC
//   products wrap to int16;
// - the entropy-coded data is unescaped as FFmpeg unescapes it (0xFF00 ->
//   0xFF, RSTn kept, up to the next other marker) and read past its end as
//   zeros; an MCU that starts past the end is an overread;
// - at the end of a restart interval the marker is looked for as
//   mjpeg_decode_scan looks for it (padding ones or zeros, then 0xFF..,
//   then RSTn): found, the predictors reset; not found, decoding goes on;
// - the Huffman tables start as the standard ones of Annex K (frames of
//   cameras and AVI1 files often carry no DHT) and, with the quantisation
//   tables, persist from frame to frame as they do in FFmpeg's context;
// - the IDCT is FFmpeg's simple IDCT (simple_idct.h), put without a level
//   shift, as idctdsp's idct_put;
// - the planes are those of yuvj444p / yuvj422p / yuvj440p / yuvj420p /
//   yuvj411p / gray: the components as decoded, not upsampled, full range.
//
// Refused with an error that names them: progressive, lossless,
// hierarchical, arithmetic-coded and JPEG-LS frames, precisions other than
// 8 bits, RGB (component ids R, G, B or an Adobe transform of 0) and CMYK
// frames, sampling factors other than the formats above, interlaced
// two-field frames (a frame under 3/4 of the container's height, FFmpeg's
// test), a quantisation table that was never defined, a scan that leaves a
// component out, and pictures of more than kMaxPixels.  Corrupt or
// truncated data fails too ("corrupt" / "truncated" in the message), and no
// read leaves the input.  Errors are C++ exceptions caught at the C entry
// points, which return -1 and keep the message.
//
// mjpeg_bgr converts the last frame to BGR as cv2 does it, through x86
// libswscale's YUVJ -> BGR24 conversion with SWS_BICUBIC (the sws
// namespace below): its chroma filters, fixed points and rounding.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// the largest picture, in pixels
constexpr long kMaxPixels = 1L << 25;

struct Error : std::runtime_error {
    using std::runtime_error::runtime_error;
};
[[noreturn]] void fail(const std::string& msg) { throw Error(msg); }

#include "simple_idct.h"

// natural index of each zigzag position
const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ITU T.81 Annex K.3: the standard Huffman tables (counts per length,
// then the symbols), FFmpeg's defaults for DC and AC tables 0 and 1
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

// the entropy-coded bits of a scan, unescaped, read past their end as zeros
struct Bits {
    std::vector<uint8_t> buf;  // the data, then 8 zero bytes
    size_t n = 0;              // data bytes
    size_t pos = 0;            // bits consumed

    uint32_t peek32() const {
        size_t b = pos >> 3;
        uint64_t v = 0;
        if (b + 8 <= buf.size()) {
            std::memcpy(&v, buf.data() + b, 8);
            v = __builtin_bswap64(v);
        } else {
            for (int i = 0; i < 8; i++) v = v << 8 | (b + i < n ? buf[b + i] : 0);
        }
        return uint32_t(v >> (32 - (pos & 7)));
    }
    uint32_t get(int k) {  // k in 1..16
        uint32_t v = peek32() >> (32 - k);
        pos += k;
        return v;
    }
    long left() const { return long(n) * 8 - long(pos); }
};

// get_xbits: k bits, the value's sign in its top bit as T.81's EXTEND
inline int xbits(Bits& br, int k) {
    int v = int(br.get(k));
    return v < (1 << (k - 1)) ? v - (1 << k) + 1 : v;
}

struct Huffman {
    // a 9-bit lookahead (len << 8 | symbol, 0 when longer), then the
    // canonical code ranges
    uint16_t fast[512];
    int maxcode[18], valptr[17], mincode[17];
    uint8_t vals[256];
    bool defined = false;
    bool standard = false;  // Annex K's, not a DHT's

    // false for an over-subscribed table (FFmpeg's "Overdetermined VLC
    // tree": the codes of each length must fit, the all-ones code left out),
    // which is left undefined, as FFmpeg frees it
    bool build(const uint8_t* counts, const uint8_t* symbols, int n) {
        defined = false;
        std::memcpy(vals, symbols, size_t(n));
        std::memset(fast, 0, sizeof fast);
        int code = 0, k = 0;
        for (int len = 1; len <= 16; ++len) {
            if (code + counts[len - 1] >= (1 << len)) return false;
            valptr[len] = k;
            mincode[len] = code;
            for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
                if (len <= 9) {
                    int shift = 9 - len;
                    for (int j = 0; j < (1 << shift); ++j)
                        fast[(code << shift) | j] = uint16_t(len << 8 | symbols[k]);
                }
            }
            maxcode[len] = counts[len - 1] ? code - 1 : -1;
            code <<= 1;
        }
        maxcode[17] = 0x7fffffff;
        defined = true;
        return true;
    }
    // the symbol, or -1 for a code that is not in the table
    int decode(Bits& br) const {
        uint32_t look = br.peek32();
        int f = fast[look >> 23];
        if (f) {
            br.pos += f >> 8;
            return f & 0xff;
        }
        int code = int(look >> 23), len = 9;
        while (code > maxcode[len]) {
            if (++len > 16) return -1;
            code = int(look >> (32 - len));
        }
        br.pos += len;
        return vals[valptr[len] + code - mincode[len]];
    }
};

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int bw = 0, bh = 0;  // blocks across and down the padded plane
    int dw = 0, dh = 0;  // the plane's own size (FFmpeg's chroma size)
    bool scanned = false;
    std::vector<uint8_t> plane;
};

enum Stat { kFrames, kScans, kRestarts, kStandardTableScans, kOverreads, kNumStats };

enum Format { kGray, k420, k422, k440, k444, k411 };

inline int be16(const uint8_t* p) { return p[0] << 8 | p[1]; }

struct Decoder {
    std::string error;
    long stats[kNumStats] = {};
    std::vector<std::vector<uint8_t>> recycled;  // the last frame's planes
    int last_format = -1, last_width = 0, last_height = 0;
    int container_height = 0;
    // what persists from frame to frame (FFmpeg's context)
    Huffman dc[4], ac[4];
    uint16_t qt[4][64] = {};
    bool qdef[4] = {};
    // the frame
    int width = 0, height = 0, format = kGray, hmax = 1, vmax = 1, restart = 0;
    bool adobe_rgb = false;
    bool has_frame = false;  // the last decode gave a whole frame
    std::vector<Component> comps;
    Bits br;

    Decoder() {
        dc[0].build(kDcLumaBits, kDcVals, 12);
        dc[1].build(kDcChromaBits, kDcVals, 12);
        ac[0].build(kAcLumaBits, kAcLumaVals, 162);
        ac[1].build(kAcChromaBits, kAcChromaVals, 162);
        for (int i = 0; i < 2; i++) dc[i].standard = ac[i].standard = true;
    }

    // find_marker: the next 0xFF followed by a code in SOF0..COM
    static int find_marker(const uint8_t* d, size_t n, size_t& pos) {
        while (pos + 1 < n) {
            if (d[pos] == 0xff && d[pos + 1] >= 0xc0 && d[pos + 1] <= 0xfe) {
                pos += 2;
                return d[pos - 1];
            }
            pos++;
        }
        pos = n;
        return -1;
    }

    // a segment's payload after its 16-bit length; the length must fit
    static const uint8_t* segment(const uint8_t* d, size_t n, size_t pos, int& len) {
        if (pos + 2 > n) fail("truncated Motion JPEG: a marker segment past the frame's end");
        len = be16(d + pos) - 2;
        if (len < 0) fail("corrupt Motion JPEG: a marker segment length below 2");
        if (pos + 2 + size_t(len) > n)
            fail("truncated Motion JPEG: a marker segment past the frame's end");
        return d + pos + 2;
    }

    void dqt(const uint8_t* s, int len) {
        while (len >= 65) {
            int pq = s[0] >> 4, tq = s[0] & 15;
            if (pq > 1) fail("corrupt Motion JPEG: DQT precision above 16 bits");
            if (tq >= 4) fail("corrupt Motion JPEG: DQT table index above 3");
            int size = 64 * (pq + 1);
            if (len < 1 + size) fail("truncated Motion JPEG: a DQT table past its segment");
            for (int k = 0; k < 64; k++) qt[tq][k] = uint16_t(pq ? be16(s + 1 + 2 * k) : s[1 + k]);
            qdef[tq] = true;
            s += 1 + size;
            len -= 1 + size;
        }
    }

    void dht(const uint8_t* s, int len) {
        while (len > 0) {
            if (len < 17) fail("truncated Motion JPEG: a DHT table past its segment");
            int tc = s[0] >> 4, th = s[0] & 15;
            if (tc >= 2) fail("corrupt Motion JPEG: DHT class above 1");
            if (th >= 4) fail("corrupt Motion JPEG: DHT table index above 3");
            int n = 0;
            for (int i = 1; i <= 16; i++) n += s[i];
            len -= 17;
            if (len < n || n > 256) fail("corrupt Motion JPEG: a DHT table past its segment");
            Huffman& h = (tc ? ac : dc)[th];
            if (!h.build(s + 1, s + 17, n)) fail("corrupt Motion JPEG: an over-subscribed DHT table");
            h.standard = false;
            s += 17 + n;
            len -= n;
        }
    }

    void sof(const uint8_t* s, int len) {
        if (!comps.empty()) fail("corrupt Motion JPEG: a second frame header in one frame");
        if (len < 6) fail("truncated Motion JPEG: frame header");
        if (s[0] != 8)
            fail("Motion JPEG of " + std::to_string(s[0]) + "-bit samples is not supported "
                 "(8-bit only)");
        height = be16(s + 1);
        width = be16(s + 3);
        int n = s[5];
        if (!width || !height) fail("corrupt Motion JPEG: a frame of width or height 0");
        if (long(width) * height > kMaxPixels)
            fail("a Motion JPEG frame of " + std::to_string(width) + "x" +
                 std::to_string(height) + " is larger than the decoder's limit");
        if (n == 0 || n > 4) fail("corrupt Motion JPEG: " + std::to_string(n) + " components");
        if (len != 6 + 3 * n) fail("corrupt Motion JPEG: frame header length mismatch");
        if (n == 2 || n == 4)
            fail("Motion JPEG of " + std::to_string(n) + " components (CMYK or other) is not "
                 "supported");
        if (container_height && height < container_height * 3 / 4)
            fail("interlaced (two-field) Motion JPEG is not supported: frames of " +
                 std::to_string(height) + " rows in a stream of " +
                 std::to_string(container_height));
        comps.assign(size_t(n), Component());
        hmax = vmax = 1;
        for (int i = 0; i < n; i++) {
            Component& c = comps[size_t(i)];
            c.id = s[6 + 3 * i];
            c.h = s[7 + 3 * i] >> 4;
            c.v = s[7 + 3 * i] & 15;
            c.tq = s[8 + 3 * i];
            if (!c.h || !c.v) fail("corrupt Motion JPEG: a sampling factor of 0");
            if (c.tq >= 4) fail("corrupt Motion JPEG: a quantisation table index above 3");
            hmax = std::max(hmax, c.h);
            vmax = std::max(vmax, c.v);
        }
        int sw = 0, sh = 0;
        if (n == 1) {
            format = kGray;
        } else {
            const Component &y = comps[0], &cb = comps[1], &cr = comps[2];
            bool chroma11 = cb.h == 1 && cb.v == 1 && cr.h == 1 && cr.v == 1;
            int hv = y.h * 10 + y.v;
            // FFmpeg reads 4:4:4 as RGB by these two signs
            if (hv == 11 && chroma11 && y.id == 'R' && cb.id == 'G' && cr.id == 'B')
                fail("RGB Motion JPEG (components R, G, B) is not supported");
            if (hv == 11 && chroma11 && adobe_rgb)
                fail("RGB Motion JPEG (Adobe transform 0) is not supported");
            if (!chroma11 || (hv != 11 && hv != 21 && hv != 12 && hv != 22 && hv != 41))
                fail("Motion JPEG sampling factors Y " + std::to_string(y.h) + "x" +
                     std::to_string(y.v) + ", Cb " + std::to_string(cb.h) + "x" +
                     std::to_string(cb.v) + ", Cr " + std::to_string(cr.h) + "x" +
                     std::to_string(cr.v) + " are not supported (4:4:4, 4:2:2, 4:4:0, "
                     "4:2:0, 4:1:1 and gray are)");
            format = hv == 11 ? k444 : hv == 21 ? k422 : hv == 12 ? k440 : hv == 22 ? k420 : k411;
            sw = hv == 21 || hv == 22 ? 1 : hv == 41 ? 2 : 0;
            sh = hv == 12 || hv == 22 ? 1 : 0;
        }
        int mcux = (width + 8 * hmax - 1) / (8 * hmax);
        int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        bool same = format == last_format && width == last_width && height == last_height;
        last_format = format;
        last_width = width;
        last_height = height;
        for (size_t i = 0; i < comps.size(); i++) {
            Component& c = comps[i];
            c.bw = mcux * c.h;
            c.bh = mcuy * c.v;
            // gray takes one component whatever its factors
            if (n == 1) {
                c.bw = (width + 7) / 8;
                c.bh = (height + 7) / 8;
            }
            c.dw = i ? -((-width) >> sw) : width;
            c.dh = i ? -((-height) >> sh) : height;
            // the previous frame's plane when its format and size are the
            // same: the MCUs an overread leaves undecoded show it, as cv2 shows
            // them (FFmpeg's frame pool hands the decoder back the buffer of
            // the frame before; a new format starts a new pool, of zeros)
            size_t need = size_t(c.bw) * 8 * size_t(c.bh) * 8;
            if (same && i < recycled.size() && recycled[i].size() == need)
                c.plane.swap(recycled[i]);
            else
                c.plane.assign(need, 0);
        }
    }

    // the entropy-coded data after a SOS header at `pos`, unescaped as
    // FFmpeg's ff_mjpeg_find_marker does; returns where the raw data ends
    size_t unescape(const uint8_t* d, size_t n, size_t pos) {
        br.buf.clear();
        size_t i = pos;
        while (i < n) {
            uint8_t x = d[i++];
            if (x != 0xff) {
                br.buf.push_back(x);
                continue;
            }
            // 0xFF, then any further 0xFFs (fill bytes) and a code
            while (i < n && d[i] == 0xff) i++;
            if (i >= n) {
                br.buf.push_back(0xff);
                break;
            }
            uint8_t code = d[i];
            if (code == 0x00) {  // a stuffed 0xFF
                br.buf.push_back(0xff);
                i++;
            } else if (code >= 0xd0 && code <= 0xd7) {  // RSTn, kept
                br.buf.push_back(0xff);
                br.buf.push_back(code);
                i++;
            } else {  // another marker ends the scan
                i--;
                break;
            }
        }
        br.n = br.buf.size();
        br.buf.resize(br.n + 8, 0);
        br.pos = 0;
        return i;
    }

    void decode_block(Component& c, int ci, int td, int ta, int* last_dc, int bx, int by) {
        int16_t blk[64] = {};
        const uint16_t* q = qt[c.tq];
        int t = dc[td].decode(br);
        if (t < 0 || t > 16) fail("corrupt Motion JPEG: a bad DC code");
        int diff = t ? xbits(br, t) : 0;
        int val = int(unsigned(diff) * unsigned(q[0]) + unsigned(last_dc[ci]));
        last_dc[ci] = val;
        blk[0] = int16_t(val < -32768 ? -32768 : val > 32767 ? 32767 : val);
        const Huffman& h = ac[ta];
        int i = 0;
        do {
            int rs = h.decode(br);
            if (rs < 0) fail("corrupt Motion JPEG: a bad AC code");
            // FFmpeg's AC symbols: run + 1 positions on, EOB far past 63
            int size = rs & 15;
            i += rs == 0 ? 256 : (rs >> 4) + 1;
            if (size) {
                int level = xbits(br, size);
                if (i > 63) fail("corrupt Motion JPEG: AC coefficients past the block's 64");
                blk[kZigzag[i]] = int16_t(unsigned(level) * q[i]);
            }
        } while (i < 63);
        const int stride = c.bw * 8;
        idct<false>(blk, c.plane.data() + size_t(by) * 8 * stride + size_t(bx) * 8, stride);
    }

    // the restart marker where mjpeg_decode_scan looks for it
    bool take_restart() {
        int k = 8 + int((-long(br.pos)) & 7);
        uint32_t look = br.peek32() >> (32 - k);
        if (look != (1u << k) - 1 && look != 0xff) return false;
        size_t saved = br.pos;
        br.pos = (br.pos + 7) & ~size_t(7);
        while (br.left() >= 8 && (br.peek32() >> 24) == 0xff) br.pos += 8;
        if (br.left() >= 8 && ((br.peek32() >> 24) & 0xf8) == 0xd0) {
            br.pos += 8;
            return true;
        }
        br.pos = saved;
        return false;
    }

    size_t sos(const uint8_t* d, size_t n, size_t pos, const uint8_t* s, int len) {
        if (comps.empty()) fail("corrupt Motion JPEG: a scan before the frame header");
        if (len < 1) fail("truncated Motion JPEG: scan header");
        int ns = s[0];
        if (ns == 0 || ns > int(comps.size()))
            fail("corrupt Motion JPEG: a scan of " + std::to_string(ns) + " components");
        if (len != 4 + 2 * ns) fail("corrupt Motion JPEG: scan header length mismatch");
        Component* sc[4];
        int td[4], ta[4], last_dc[4];
        for (int i = 0; i < ns; i++) {
            int id = s[1 + 2 * i];
            sc[i] = nullptr;
            for (auto& c : comps)
                if (c.id == id) sc[i] = &c;
            if (!sc[i]) fail("corrupt Motion JPEG: a scan of a component the frame lacks");
            td[i] = s[2 + 2 * i] >> 4;
            ta[i] = s[2 + 2 * i] & 15;
            if (td[i] >= 4 || ta[i] >= 4 || !dc[td[i]].defined || !ac[ta[i]].defined)
                fail("corrupt Motion JPEG: a scan names a Huffman table that is not defined");
            if (!qdef[sc[i]->tq])
                fail("Motion JPEG without a quantisation table (DQT) for a component");
            if (dc[td[i]].standard || ac[ta[i]].standard) stats[kStandardTableScans]++;
            sc[i]->scanned = true;
            last_dc[i] = 4 << 8;
        }
        size_t end = unescape(d, n, pos + 2 + size_t(len) + 2);
        int mcux, mcuy;
        if (ns > 1) {
            mcux = (width + 8 * hmax - 1) / (8 * hmax);
            mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        } else {
            int fh = hmax / sc[0]->h, fv = vmax / sc[0]->v;
            if (comps.size() == 1) fh = fv = 1;
            mcux = (width + 8 * fh - 1) / (8 * fh);
            mcuy = (height + 8 * fv - 1) / (8 * fv);
        }
        int count = 0;
        for (int my = 0; my < mcuy; my++) {
            for (int mx = 0; mx < mcux; mx++) {
                if (restart && !count) count = restart;
                if (br.left() < 0) {
                    // FFmpeg: "overread", the scan stops and the frame is let out
                    // with the MCUs decoded so far ("EOI missing, emulating")
                    stats[kOverreads]++;
                    return end;
                }
                for (int i = 0; i < ns; i++) {
                    int bh = ns == 1 ? 1 : sc[i]->v, bwd = ns == 1 ? 1 : sc[i]->h;
                    for (int by = 0; by < bh; by++)
                        for (int bx = 0; bx < bwd; bx++)
                            decode_block(*sc[i], i, td[i], ta[i], last_dc, mx * bwd + bx,
                                         my * bh + by);
                }
                if (restart && --count == 0 && take_restart()) {
                    stats[kRestarts]++;
                    for (int i = 0; i < ns; i++) last_dc[i] = 4 << 8;
                }
            }
        }
        stats[kScans]++;
        return end;
    }

    // one frame into the components' planes (errors throw)
    void decode(const uint8_t* d, size_t n) {
        has_frame = false;
        recycled.resize(comps.size());
        for (size_t i = 0; i < comps.size(); i++) recycled[i].swap(comps[i].plane);
        comps.clear();
        restart = 0;
        adobe_rgb = false;
        int scans = 0;
        size_t pos = 0;
        while (true) {
            int m = find_marker(d, n, pos);
            if (m < 0) break;
            if (m == 0xd8) {  // SOI
                restart = 0;
                continue;
            }
            if (m == 0xd9) {  // EOI
                if (scans) break;
                continue;  // FFmpeg: an EOI before any picture is ignored
            }
            if (m >= 0xd0 && m <= 0xd7) continue;  // a stray RSTn
            if (m == 0xc2 || m == 0xc6 || m == 0xca || m == 0xce)
                fail("progressive Motion JPEG is not supported");
            if (m == 0xc3 || m == 0xc7 || m == 0xcb || m == 0xcf)
                fail("lossless Motion JPEG is not supported");
            if (m == 0xc5) fail("hierarchical Motion JPEG is not supported");
            if (m == 0xc9 || m == 0xcc) fail("arithmetic-coded Motion JPEG is not supported");
            if (m == 0xf7 || m == 0xf8) fail("JPEG-LS Motion JPEG is not supported");
            if (m == 0xc8) fail("Motion JPEG with the reserved JPG marker is not supported");
            bool known = m == 0xc0 || m == 0xc1 || m == 0xc4 || m == 0xdb || m == 0xdd ||
                         m == 0xda || (m >= 0xe0 && m <= 0xef) || m == 0xfe;
            if (!known) continue;  // FFmpeg skips it and looks for the next marker
            int len;
            const uint8_t* s = segment(d, n, pos, len);
            if (m == 0xc0 || m == 0xc1) {
                sof(s, len);
            } else if (m == 0xc4) {
                dht(s, len);
            } else if (m == 0xdb) {
                dqt(s, len);
            } else if (m == 0xdd) {
                if (len != 2) fail("corrupt Motion JPEG: DRI length other than 4");
                restart = be16(s);
            } else if (m == 0xda) {
                pos = sos(d, n, pos - 2, s, len);
                scans++;
                continue;
            } else if (m == 0xee && len >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
                adobe_rgb = s[11] == 0;
            }
            pos += 2 + size_t(len);
        }
        if (comps.empty()) fail("Motion JPEG frame without a frame header (SOF)");
        if (!scans) fail("truncated Motion JPEG: a frame without image data");
        for (auto& c : comps)
            if (!c.scanned)
                fail("Motion JPEG frame whose scans leave a component out is not supported");
        stats[kFrames]++;
        has_frame = true;
    }

    long plane_bytes() const {
        long b = 0;
        for (auto& c : comps) b += long(c.dw) * c.dh;
        return b;
    }

    void planes(uint8_t* out) const {
        for (auto& c : comps) {
            const int stride = c.bw * 8;
            for (int y = 0; y < c.dh; y++, out += c.dw)
                std::memcpy(out, c.plane.data() + size_t(y) * stride, size_t(c.dw));
        }
    }
};

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }
inline uint8_t clamp_u8(int v) { return clamp255(v); }

// ------------------------------------------------ swscale's YUVJ -> BGR24
//
// cv2 converts each decoded frame with sws_scale(SWS_BICUBIC) to BGR24;
// x86 libswscale takes one of three paths, each emulated here:
// - 4:2:0 / 4:2:2 of even height: the unscaled yuv2rgb converter, nearest
//   chroma (a pair of pixels per sample), its 16-bit fixed point (pmulhw
//   of 8x the samples by the full-range coefficients);
// - otherwise the scaler: the chroma resampled by bicubic filters
//   (initFilter: B = 0, C = 0.6, samples sited at their centres) to half
//   the width (packed output) or, for an odd width or unsubsampled chroma,
//   to the full width (SWS_FULL_CHR_H_INT, which swscale then forces);
//   packed rows in the MMX fixed point, its last two rows through the C
//   tables; full-chroma rows through yuv2rgb_write_full.
namespace sws {

// the full-range BT.601 coefficients of ff_yuv2rgb_c_init_tables: for the
// SIMD and full paths (13 fraction bits) and for the C tables (16)
constexpr int kVr = 11485, kUb = 14516, kUg = -2819, kVg = -5850, kY = 8192;
constexpr int kCrv = 91881, kCbu = 116129, kCgu = -22552, kCgv = -46800;

inline int mulhi(int a, int b) { return int16_t((a * b) >> 16); }
inline int64_t cdiv(int64_t a, int64_t b) { return a / b; }  // C's truncation

// pmulhw / paddw / packuswb of 8x the samples (yuv_2_rgb.asm, YSCALEYUV2RGB*)
inline void simd_bgr(int y8, int u8, int v8, uint8_t* o) {
    int y = mulhi(y8, kY), u = u8 - 1024, v = v8 - 1024;
    o[0] = clamp_u8(y + mulhi(u, kUb));
    o[1] = clamp_u8(y + mulhi(u, kUg) + mulhi(v, kVg));
    o[2] = clamp_u8(y + mulhi(v, kVr));
}
// the C tables (yuv2rgb_write of 8-bit samples)
inline void table_bgr(int y, int u, int v, uint8_t* o) {
    u = std::min(std::max(u, 0), 255);
    v = std::min(std::max(v, 0), 255);
    auto f = [](int a, int c) { return int((int64_t(a) * c) >> 16) - (c >> 9); };
    o[0] = clamp_u8(y + f(u, kCbu));
    o[1] = clamp_u8(y + f(u, kCgu) + f(v, kCgv));
    o[2] = clamp_u8(y + f(v, kCrv));
}
// yuv2rgb_write_full of samples at 2^9 (chroma centred)
inline void full_bgr(int y, int u, int v, uint8_t* o) {
    int64_t yy = int64_t(y) * kY + (1 << 21);
    int64_t c[3] = {yy + int64_t(u) * kUb, yy + int64_t(v) * kVg + int64_t(u) * kUg,
                    yy + int64_t(v) * kVr};
    for (int k = 0; k < 3; k++) {
        int32_t x = int32_t(uint32_t(c[k]));
        if (x & 0xC0000000) x = x < 0 ? 0 : (1 << 30) - 1;
        o[k] = uint8_t(x >> 22);
    }
}

// initFilter's bicubic filter from srcW samples to dstW, normalised to `one`
struct Filter {
    int size = 1;
    std::vector<int> pos;
    std::vector<int> coef;  // dstW x size
};
inline int av_log2(unsigned v) { return v ? 31 - __builtin_clz(v) : 0; }
Filter init_filter(int64_t xinc, int src_w, int dst_w, int align, int one) {
    const int64_t fone = int64_t(1) << (54 - std::min(av_log2(unsigned(src_w / dst_w)), 8));
    int size;
    std::vector<int64_t> f;
    std::vector<int> pos(static_cast<size_t>(dst_w));
    if (std::abs(xinc - 0x10000) < 10) {  // unscaled (the sitings are equal)
        size = 1;
        f.assign(size_t(dst_w), fone);
        for (int i = 0; i < dst_w; i++) pos[size_t(i)] = i;
    } else {
        const int factor = 4;  // bicubic
        size = xinc <= 1 << 16 ? 1 + factor : 1 + int((factor * int64_t(src_w) + dst_w - 1) / dst_w);
        size = std::max(std::min(size, src_w - 2), 1);
        f.assign(size_t(dst_w) * size, 0);
        const int64_t B = 0, C = int64_t(0.6 * (1 << 24));
        int64_t x_in_src = ((128 * xinc) >> 7) - ((128 * 0x10000LL) >> 7);
        for (int i = 0; i < dst_w; i++) {
            int64_t xx = cdiv(x_in_src - int64_t(size - 2) * (1 << 16), 1 << 17);
            pos[size_t(i)] = int(xx);
            for (int j = 0; j < size; j++, xx++) {
                int64_t d = std::abs(xx * (1 << 17) - x_in_src) << 13, coeff = 0;
                if (xinc > 1 << 16) d = d * dst_w / src_w;
                if (d < int64_t(1) << 31) {
                    int64_t dd = (d * d) >> 30, ddd = (dd * d) >> 30;
                    if (d < int64_t(1) << 30)
                        coeff = (12 * (1LL << 24) - 9 * B - 6 * C) * ddd +
                                (-18 * (1LL << 24) + 12 * B + 6 * C) * dd +
                                (6 * (1LL << 24) - 2 * B) * (1LL << 30);
                    else
                        coeff = (-B - 6 * C) * ddd + (6 * B + 30 * C) * dd +
                                (-12 * B - 48 * C) * d + (8 * B + 24 * C) * (1LL << 30);
                }
                f[size_t(i) * size + j] = cdiv(coeff, (int64_t(1) << 54) / fone);
            }
            x_in_src += 2 * xinc;
        }
    }
    // drop near-zero taps on the left and count them on the right
    const double cut = 0.002;
    int min_size = 0;
    for (int i = dst_w - 1; i >= 0; i--) {
        int64_t* row = &f[size_t(i) * size];
        int mn = size;
        int64_t acc = 0;
        for (int j = 0; j < size; j++) {
            acc += std::abs(row[0]);
            if (acc > cut * fone) break;
            if (i < dst_w - 1 && pos[size_t(i)] >= pos[size_t(i) + 1]) break;
            for (int k = 1; k < size; k++) row[k - 1] = row[k];
            row[size - 1] = 0;
            pos[size_t(i)]++;
        }
        acc = 0;
        for (int j = size - 1; j > 0; j--) {
            acc += std::abs(row[j]);
            if (acc > cut * fone) break;
            mn--;
        }
        min_size = std::max(min_size, mn);
    }
    if (min_size == 1 && align == 2) align = 1;
    int out_size = (min_size + align - 1) & ~(align - 1);
    std::vector<int64_t> g(size_t(dst_w) * out_size, 0);
    for (int i = 0; i < dst_w; i++)
        for (int j = 0; j < std::min(size, out_size); j++)
            g[size_t(i) * out_size + j] = f[size_t(i) * size + j];
    // fold the taps past the borders onto the edge samples
    for (int i = 0; i < dst_w; i++) {
        int64_t* row = &g[size_t(i) * out_size];
        int& p = pos[size_t(i)];
        if (p < 0) {
            for (int j = 1; j < out_size; j++) {
                int left = std::max(j + p, 0);
                row[left] += row[j];
                row[j] = 0;
            }
            p = 0;
        }
        if (p + out_size > src_w) {
            int shift = p + std::min(out_size - src_w, 0);
            int64_t acc = 0;
            for (int j = out_size - 1; j >= 0; j--)
                if (p + j >= src_w) {
                    acc += row[j];
                    row[j] = 0;
                }
            for (int j = out_size - 1; j >= 0; j--) row[j] = j < shift ? 0 : row[j - shift];
            p -= shift;
            row[src_w - 1 - p] += acc;
        }
    }
    Filter out;
    out.size = out_size;
    out.pos = pos;
    out.coef.assign(size_t(dst_w) * out_size, 0);
    for (int i = 0; i < dst_w; i++) {
        int64_t sum = 0, error = 0;
        for (int j = 0; j < out_size; j++) sum += g[size_t(i) * out_size + j];
        sum = (sum + one / 2) / one;
        if (!sum) sum = 1;
        for (int j = 0; j < out_size; j++) {
            int64_t v = g[size_t(i) * out_size + j] + error;
            int64_t iv = v >= 0 ? (v + sum / 2) / sum : -((-v + sum / 2) / sum);  // ROUNDED_DIV
            out.coef[size_t(i) * out_size + j] = int(iv);
            error = v - iv * sum;
        }
    }
    return out;
}

}  // namespace sws


template <class F>
int guarded(std::string* error, F&& f) {
    try {
        return f();
    } catch (const std::exception& e) {
        *error = e.what();
        return -1;
    }
}

}  // namespace

extern "C" {

void* mjpeg_decoder_new(int container_height) {
    Decoder* d = new (std::nothrow) Decoder();
    if (d) d->container_height = container_height;
    return d;
}
void mjpeg_decoder_free(void* d) { delete static_cast<Decoder*>(d); }
const char* mjpeg_decoder_error(void* d) { return static_cast<Decoder*>(d)->error.c_str(); }

// one frame -> 0, its size, format (Format) and packed planes' bytes in
// the out-parameters; -1 on error
int mjpeg_decode(void* dp, const uint8_t* data, long n, int* width, int* height, int* format,
                 long* plane_bytes) {
    Decoder* d = static_cast<Decoder*>(dp);
    return guarded(&d->error, [&] {
        if (n < 0) fail("negative length");
        d->decode(data, size_t(n));
        *width = d->width;
        *height = d->height;
        *format = d->format;
        *plane_bytes = d->plane_bytes();
        return 0;
    });
}

// the last frame's planes, packed: Y (h x w), then Cb and Cr of FFmpeg's
// chroma size; -1 when the last decode failed
int mjpeg_planes(void* dp, uint8_t* out) {
    const Decoder* d = static_cast<Decoder*>(dp);
    if (!d->has_frame) return -1;
    d->planes(out);
    return 0;
}

// the last frame as (h, w, 3) BGR; -1 when the last decode failed
int mjpeg_bgr(void* dp, uint8_t* out) {
    const Decoder* d = static_cast<Decoder*>(dp);
    if (!d->has_frame) return -1;
    const Component& y = d->comps[0];
    const int ys = y.bw * 8;
    if (d->format == kGray) {
        for (int r = 0; r < d->height; r++) {
            const uint8_t* row = y.plane.data() + size_t(r) * ys;
            uint8_t* o = out + size_t(r) * d->width * 3;
            for (int x = 0; x < d->width; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = row[x];
        }
        return 0;
    }
    const Component &cb = d->comps[1], &cr = d->comps[2];
    const int cs = cb.bw * 8, w = d->width, h = d->height;
    int sw = d->format == k420 || d->format == k422 ? 1 : d->format == k411 ? 2 : 0;
    int sh = d->format == k420 || d->format == k440 ? 1 : 0;
    if (sw == 1 && !(h & 1)) {  // the unscaled converter
        for (int r = 0; r < h; r++) {
            const uint8_t* py = y.plane.data() + size_t(r) * ys;
            const uint8_t* pb = cb.plane.data() + size_t(r >> sh) * cs;
            const uint8_t* pr = cr.plane.data() + size_t(r >> sh) * cs;
            uint8_t* o = out + size_t(r) * w * 3;
            for (int x = 0; x < w; x++)
                sws::simd_bgr(py[x] << 3, pb[x >> 1] << 3, pr[x >> 1] << 3, o + 3 * x);
        }
        return 0;
    }
    // the scaler: chroma lines of src_w x src_h to dst_w x h
    const bool full = (w & 1) || (!sw && !sh);
    const int src_w = -((-w) >> sw), src_h = -((-h) >> sh), dst_w = full ? w : (w + 1) / 2;
    const int64_t xinc = ((int64_t(src_w) << 16) + (dst_w >> 1)) / dst_w;
    const int64_t yinc = ((int64_t(src_h) << 16) + (h >> 1)) / h;
    const sws::Filter hf = sws::init_filter(xinc, src_w, dst_w, 4, 1 << 14);
    const sws::Filter vf = sws::init_filter(yinc, src_h, h, 2, 1 << 12);
    std::vector<int> lines[2];  // hScale8To15 of each chroma line
    for (int c = 0; c < 2; c++) {
        const Component& comp = d->comps[1 + c];
        lines[c].assign(size_t(src_h) * dst_w, 0);
        for (int r = 0; r < src_h; r++) {
            const uint8_t* p = comp.plane.data() + size_t(r) * cs;
            for (int i = 0; i < dst_w; i++) {
                int v = 0;
                for (int j = 0; j < hf.size; j++) {
                    int k = hf.pos[size_t(i)] + j;
                    if (k < src_w) v += p[k] * hf.coef[size_t(i) * hf.size + j];
                }
                lines[c][size_t(r) * dst_w + i] = std::min(v >> 7, (1 << 15) - 1);
            }
        }
    }
    std::vector<int> u(static_cast<size_t>(dst_w)), v(static_cast<size_t>(dst_w));
    for (int r = 0; r < h; r++) {
        const uint8_t* py = y.plane.data() + size_t(r) * ys;
        uint8_t* o = out + size_t(r) * w * 3;
        const int p0 = vf.pos[size_t(r)];
        const int* taps = &vf.coef[size_t(r) * vf.size];
        const bool simd = !full && r < h - 2;  // swscale's last two rows are C
        for (int c = 0; c < 2; c++) {
            std::vector<int>& acc = c ? v : u;
            for (int i = 0; i < dst_w; i++) {
                if (vf.size == 1) {
                    int s = lines[c][size_t(p0) * dst_w + i];
                    acc[size_t(i)] = full ? (s - (128 << 7)) * 4 : simd ? s >> 4 : (s + 64) >> 7;
                    continue;
                }
                int64_t a = full ? (1 << 9) - (128 << 19) : simd ? 4 : 1 << 18;
                for (int j = 0; j < vf.size; j++) {
                    int s = lines[c][size_t(std::min(p0 + j, src_h - 1)) * dst_w + i];
                    a += simd ? sws::mulhi(s, taps[j]) : int64_t(s) * taps[j];
                }
                acc[size_t(i)] = int(full ? a >> 10 : simd ? int16_t(a) : a >> 19);
            }
        }
        for (int x = 0; x < w; x++) {
            int i = full ? x : x >> 1;
            if (full)
                sws::full_bgr(py[x] << 9, u[size_t(i)], v[size_t(i)], o + 3 * x);
            else if (simd)
                sws::simd_bgr(vf.size == 1 ? py[x] << 3 : 4 + (py[x] << 3), u[size_t(i)],
                              v[size_t(i)], o + 3 * x);
            else
                sws::table_bgr(py[x], u[size_t(i)], v[size_t(i)], o + 3 * x);
        }
    }
    return 0;
}

int mjpeg_stats(void* dp, long* out, int n) {
    Decoder* d = static_cast<Decoder*>(dp);
    for (int i = 0; i < n && i < kNumStats; i++) out[i] = d->stats[i];
    return kNumStats;
}

}  // extern "C"
