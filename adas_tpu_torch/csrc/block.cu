// Fused W8A8 two-conv residual body, NHWC s8 in and out:
//
//   mid = clip(round(act1(conv3x3_s8(x, w1) * s1 + b1) / s_mid))   (s8)
//   y   = act2(conv3x3_s8(mid, w2) * s2 + b2)
//   y   = act_post(y + x * s_x)                 (when residual)
//   out = clip(round(y / s_out))                (s8)
//
// Replaces the TPU kernels adas_tpu/ops/pallas_block.py::_block_kernel
// (entry fused_block, padded planar I/O) and ::_block_kernel_nhwc (entry
// fused_block_nhwc, NHWC I/O).  Both compute this one function; the planar
// domain was a TPU lane-layout device, so one NHWC kernel serves both, and
// consecutive blocks chain NHWC s8 tensors directly.
//
// What bounds it on an H100: the five sites of the serving path are
// 8x160x160x64 (YOLOv8l stage1, SiLU/SiLU, residual) and 8x80x400x64
// (ResNet-18 layer1, ReLU/-/ReLU, residual): 2 x 0.94 and 2 x 1.2 GMAC per
// call, bound by the tensor cores' int8 rate (0.015 and 0.019 ms), while
// fusion keeps the mid activation out of device memory (the s8 input is
// read once, the s8 output written once).  What the card spends beyond
// that goes to the epilogues (an exp and two divisions per value at the
// SiLU sites, 2 x 64 values per output pixel) and to the ring of mid
// pixels that a tile recomputes.
//
// What the design does about it:
//  * Products on wgmma m64nNk32 s8 x s8 -> s32 straight from shared memory,
//    with no im2col tile.  The input tile is staged channel-chunk-planar,
//    [C/16][rows][66 cols][16 bytes], so for one tap (dy, dx) the 64
//    consecutive pixels of a row are 8 no-swizzle K-major core matrices (8
//    pixels x 16 channel bytes) 128 bytes apart: the A descriptor of a tap
//    is the row's base shifted by (dy * 66 + dx) * 16 bytes, its leading
//    byte offset (the next 16 channels) one chunk plane, its stride byte
//    offset (the next 8 pixels) 128 bytes.  The mid tile has the same
//    layout and feeds conv2 the same way.  The weights, (C, 3, 3, C) s8 and
//    K-major as they stand, are staged once per block into core matrices
//    ([9C/16][C][16 bytes]) and both sets stay resident.  The s32 sums are
//    exact in any order, so the kernel equals the plain version to the bit.
//  * Tiles of TH = 6 output rows x 62 output columns: one 64-row M tile
//    covers a whole mid row (62 outputs + the 1-pixel ring), so the ring
//    costs 64/62 in width and (TH + 2)/TH in height (1.33x for conv1, where
//    the 8 x 16 tile of the first design cost 1.5x).
//  * The input halo, (TH + 4) x 66 pixels, arrives by TMA: a 4-D tiled map
//    over the NHWC input (channels, W, H, N), one 16-channel box per chunk
//    plane, which lands in the chunk-planar layout as it is.  The map
//    starts at the input's base and carries its channel pitch, so C2f's
//    channel slice is read in place, and the TMA's out-of-bounds zero fill
//    is the image border.  A persistent grid (one block per SM) runs one
//    producer warp and four consumer warpgroups over an mbarrier ring of
//    two input stages: the next tile's halo lands while this tile computes.
//  * The consumer warpgroups take rows in turn: while one runs a row's
//    epilogue on the CUDA cores, another's wgmma run on the tensor cores.
//    One accumulator set per warpgroup: two sets in flight in one
//    warpgroup made ptxas serialize every wgmma (notice C7514).
//  * The epilogues, not the products, bound the kernel: at the SiLU sites
//    an exp and two divisions per value, (TH + 2) x 64 + TH x 64 values per
//    channel per tile against the tensor cores' 18 k32 steps per row.  So:
//    more warps for them (four consumer warpgroups beat two and three, and
//    6 rows beat 4 and 8: the sweep in PERF.md); eight values a
//    thread as independent chains, silu a template argument so that no
//    branch splits them; the branch-free exact division of
//    csrc/int8_epilogue.cuh (shared with the int8 conv), with its range
//    checks cut to one per block on the scales (the argument at silu_fast
//    below; the range check per value sent whole warps to the exact path
//    wherever silu's argument fell below -44); int <-> float conversions
//    and the rounding by the float adder's 1.5 * 2^23 trick, off the
//    quarter-rate conversion pipe.  A lane whose values leave the fast
//    path's range redoes them through __fdiv_rn, out of line.
//    __fmul_rn / __fadd_rn: no FMA contraction.  s_mid, s_x and s_out are
//    read from device memory, never from the host.  conv1's epilogue
//    writes the s8 mid (zero outside the image: conv2's padding) into
//    shared memory; conv2's adds the residual from the input tile still
//    staged, requantizes, and stages each warp's 16 output pixels in
//    shared memory for 16-byte coalesced stores.
//  * C (= Cin = Cmid = Cout) in {16, 32, 48, 64}.  64 and 32 run as they
//    are (wgmma n64 and n32); 48 and 16 run the 64- and 32-wide instance
//    with zero channels past C (zero weights, zeroed input planes), so one
//    design serves every width.
//
// Layouts: x (N, H, W, *) s8 with channel pitch x_pitch (a multiple of 16,
// base 16-byte aligned); w1, w2 (C, 3, 3, C) s8 contiguous; s1, b1, s2, b2
// f32 (C); out (N, H, W, C) s8 contiguous.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "int8_epilogue.cuh"

namespace {

constexpr int kTH = 6;          // output rows per tile (PERF.md has the sweep)
constexpr int kTW = 62;         // output columns per tile
constexpr int kMW = 64;         // mid columns per tile: one wgmma M tile
constexpr int kPW = 66;         // pixels per row of a staged plane
static_assert(kTW + 2 == kMW && kMW + 2 == kPW, "a 3x3 ring on each side");
constexpr int kWGs = 4;         // consumer warpgroups
constexpr int kConsumers = 128 * kWGs;
constexpr int kThreads = kConsumers + 32;  // + one producer warp

constexpr int round128(int b) { return (b + 127) / 128 * 128; }

template <int CP>
struct Cfg {
  static constexpr int KC = CP / 16;                         // 16-channel chunks
  static constexpr int KS = 9 * CP / 32;                     // k32 steps per conv
  static constexpr int IN_PLANE = round128((kTH + 4) * kPW * 16);
  static constexpr int IN_BYTES = KC * IN_PLANE;             // one input stage
  static constexpr int MID_PLANE = round128((kTH + 2) * kPW * 16);
  static constexpr int MID_BYTES = KC * MID_PLANE;
  static constexpr int W_BYTES = 9 * CP * CP;
  static constexpr int OUT_BYTES = (kConsumers / 32) * 16 * CP;  // 16 pixels a warp
  static constexpr int VEC_BYTES = 4 * CP * 4;
  static constexpr int W1 = 0, W2 = W_BYTES, IN = 2 * W_BYTES;
  static constexpr int MID = IN + 2 * IN_BYTES;
  static constexpr int OUT = MID + MID_BYTES;
  static constexpr int VEC = OUT + OUT_BYTES;
  static constexpr int BAR = VEC + VEC_BYTES;
  static constexpr int SMEM = BAR + 4 * 8 + 128;             // + alignment slack
};

static_assert(Cfg<64>::SMEM <= 232448, "the tile does not fit one SM's shared memory");

struct Params {
  const int8_t* w1;
  const int8_t* w2;
  const float *s1, *b1, *s2, *b2;  // b1, b2 may be null
  const float *mid_scale, *x_scale, *out_scale;
  int8_t* out;
  int n, h, w, c;
  int act1, act2, act_post, residual;
  int tiles_x, tiles_y, tiles;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase with parity ``parity`` has completed; a
// phase that never completes is a bug: trap after ~4e9 cycles.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// One 16-channel box of the input halo: channels c..c+15 of the
// (kTH + 4) x kPW pixels from (x, y) of image n; zeros outside the image.
__device__ __forceinline__ void tma_load_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                             int c, int x, int y, int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(x), "r"(y), "r"(n)
      : "memory");
}

// the consumer warpgroups' own barrier (the producer warp never joins it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Order this thread's generic-proxy shared-memory writes before later
// async-proxy reads (wgmma's operand fetches).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor, no swizzle (interleaved core matrices),
// K-major: 8 rows of 16 bytes per core matrix, ``lbo`` bytes to the next
// 16 bytes of K, ``sbo`` bytes to the next 8 rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<32>(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// One row's implicit 3x3 GEMM: 64 pixels of the staged row ``row`` (its
// taps reach rows row..row+2 and columns 0..65 of the planes at ``tile``,
// ``plane`` bytes apart) x CP output channels of the staged weights ``w``;
// KS k32 steps in (dy, dx, 32 channels) order, one commit group.
template <int CP>
__device__ __forceinline__ void issue_row(int* acc, uint32_t tile, uint32_t plane, int row,
                                          uint32_t w) {
  using F = Cfg<CP>;
  fence_regs<CP / 2>(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < F::KS; ++kk) {
    const int tap = kk / (F::KC / 2), pair = kk % (F::KC / 2);
    const int dy = tap / 3, dx = tap % 3;
    const uint32_t a = tile + 2 * pair * plane + ((row + dy) * kPW + dx) * 16;
    wgmma_s8<CP>(acc, smem_desc(a, plane, 128), smem_desc(w + kk * 32 * CP, CP * 16, 128),
                 kk != 0);
  }
  wgmma_commit();
}

// This warpgroup's rows first, first + kWGs, ... below ``end``: a row's
// products (``issue(acc, row)``), then its epilogue (``finish(acc, row)``);
// the other warpgroups' products run on the tensor cores meanwhile.
template <int CP, typename Issue, typename Finish>
__device__ __forceinline__ void run_rows(int first, int end, Issue issue, Finish finish) {
#pragma unroll 1
  for (int row = first; row < end; row += kWGs) {
    int acc[CP / 2];
    issue(acc, row);
    wgmma_wait<0>();
    fence_regs<CP / 2>(acc);
    finish(acc, row);
  }
}

// Conversions without the conversion unit, which issues at a quarter of
// the float adder's rate on sm_90 and, with exp2 and the reciprocals on the
// same quarter-rate pipes, bounds the SiLU epilogue.
//
// a as a float, exactly, for |a| < 2^22: the float 1.5 * 2^23 + a less
// 1.5 * 2^23; ``slow`` is set for a larger |a| (the exact path converts).
__device__ __forceinline__ float to_f32(int a, bool& slow) {
  slow |= static_cast<unsigned>(a + (1 << 22)) >= (1u << 23);
  return __fsub_rn(__int_as_float(0x4B400000 + a), 12582912.f);
}

// clip(round(t), -127, 127) as s8, round half to even: 1.5 * 2^23 + t
// rounded by the adder holds round(t) in its low mantissa bits.
__device__ __forceinline__ int8_t to_s8(float t) {
  t = fminf(fmaxf(t, -127.f), 127.f);
  return static_cast<int8_t>(__float_as_int(__fadd_rn(t, 12582912.f)));
}

// The fast path's range argument.  With every scale (s_mid, s_x, s_out) in
// [2^-30, 2^30], checked once per block (``odd_scales`` sends every group
// to the exact path otherwise), the fast division gives every output the
// exact path gives, with no check per value:
//  * silu(v) = v / (1 + exp(-v)): for v in [-44, 17] dividend, divisor
//    (below 2^64) and quotient sit where the fast path is exact; above 17
//    the divisor is 1 and the quotient v.  Below -44 the exact value is
//    under 2^-57 in magnitude and 0 stands in for it, as a value under
//    2^-60 does for itself: requantized, either gives 0; added to a nonzero
//    residual (at least s_x), either is under half the sum's ulp.
//  * the requantize by s: the dividend clamped to +-128 s first (the
//    output saturates there), so the quotient is exact from 1/4 up and
//    rounds to 0 below.
__device__ __forceinline__ float silu_fast(float v) {
  bool unchecked = false;
  return v < -44.f ? 0.f : div_rn(v, 1.f + expf(-v), unchecked);
}

__device__ __forceinline__ int8_t requant_fast(float y, float s) {
  const float lim = 128.f * s;
  bool unchecked = false;
  return to_s8(div_rn(fminf(fmaxf(y, -lim), lim), s, unchecked));
}

__device__ __forceinline__ bool odd_scale(float s) { return !(s >= 0x1p-30f && s <= 0x1p30f); }

// The activation of a value: silu when SILU (a template argument, so that
// the eight chains of a group interleave with no branch between them), else
// relu or none by a select.
template <bool EXACT, bool SILU>
__device__ __forceinline__ float act_as(float v, int act, bool& slow) {
  if constexpr (SILU) return EXACT ? activate<true>(v, kActSilu, slow) : silu_fast(v);
  return act == kActRelu ? fmaxf(v, 0.f) : v;
}

// Eight accumulator values of one thread -> act(acc * s + b), as the plain
// version rounds them.  Value i = jj * 4 + h * 2 + e sits at pixel row h
// and channel 8 jj + e of the thread's 16-channel group (``s``, ``b`` point
// at its first channel).
template <bool EXACT, bool SILU>
__device__ __forceinline__ void scale_act(const int* a, const float* s, const float* b, int act,
                                          float (&y)[8], bool& slow) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ch = 8 * (i / 4) + i % 2;
    const float af = EXACT ? static_cast<float>(a[i]) : to_f32(a[i], slow);
    y[i] = act_as<EXACT, SILU>(__fadd_rn(__fmul_rn(af, s[ch]), b[ch]), act, slow);
  }
}

struct Int8x8 {
  int v[8];
};

// conv1's values of one 16-channel group -> s8 mid (q[i] as in scale_act)
template <bool EXACT, bool SILU>
__device__ __forceinline__ bool mid_values(const int* a, const float* s, const float* b, int act,
                                           float s_mid, int8_t (&q)[8], bool slow = false) {
  float y[8];
  scale_act<EXACT, SILU>(a, s, b, act, y, slow);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    q[i] = EXACT ? requant<true>(y[i], s_mid, slow) : requant_fast(y[i], s_mid);
  return slow;
}

// the rare redo of a lane's group with __fdiv_rn, out of line
template <bool SILU>
__device__ __noinline__ Int8x8 mid_values_exact(Int8x8 a, const float* s, const float* b, int act,
                                                float s_mid) {
  int8_t q[8];
  mid_values<true, SILU>(a.v, s, b, act, s_mid, q);
  Int8x8 r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = q[i];
  return r;
}

// conv2's values of one 16-channel group -> s8 output; ``xr`` the
// residual's s8 inputs (added only with a residual: y + 0 would differ from
// y only by the sign of a zero, which requantizes to the same 0)
template <bool EXACT, bool SILU2, bool SILUP>
__device__ __forceinline__ bool out_values(const int* a, const float* s, const float* b,
                                           const int8_t (&xr)[8], int act2, int act_post,
                                           bool residual, float s_x, float s_out,
                                           int8_t (&q)[8], bool slow = false) {
  float y[8];
  scale_act<EXACT, SILU2>(a, s, b, act2, y, slow);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float xf = __fsub_rn(__int_as_float(0x4B400000 + xr[i]), 12582912.f);  // exact
    const float xv = residual ? __fmul_rn(xf, s_x) : 0.f;
    const float v = act_as<EXACT, SILUP>(__fadd_rn(y[i], xv), act_post, slow);
    q[i] = EXACT ? requant<true>(v, s_out, slow) : requant_fast(v, s_out);
  }
  return slow;
}

template <bool SILU2, bool SILUP>
__device__ __noinline__ Int8x8 out_values_exact(Int8x8 a, const float* s, const float* b,
                                                Int8x8 x, int act2, int act_post,
                                                bool residual, float s_x, float s_out) {
  int8_t xr[8], q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) xr[i] = static_cast<int8_t>(x.v[i]);
  out_values<true, SILU2, SILUP>(a.v, s, b, xr, act2, act_post, residual, s_x, s_out, q);
  Int8x8 r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = q[i];
  return r;
}

__device__ __forceinline__ char2 pair(int8_t a, int8_t b) {
  char2 v;
  v.x = a;
  v.y = b;
  return v;
}

// What a consumer thread's epilogues read: the tile, its thread's place in
// it, and the block's parameters.
struct Ctx {
  int8_t* sm;          // the aligned shared-memory base
  const float* vec;    // s1, b1, s2, b2 in shared memory
  const int8_t* in_s;  // this tile's input stage
  int8_t* stage;       // this warp's output staging
  int8_t* out;
  float s_mid, s_x, s_out;
  bool odd_scales;     // a scale outside [2^-30, 2^30]: every value by the exact path
  int warp, lane, ch0, kc;
  int h, w, c, n, oy0, ox0;
  int act1, act2, act_post;
  bool residual;
};

// conv1's epilogue of mid row ``mr``: s8 into the mid tile, zero outside
// the image (conv2's padding) and past C
template <int CP, bool SILU>
__device__ __forceinline__ void finish_mid(const int* acc, int mr, const Ctx& x) {
  using F = Cfg<CP>;
  const bool row_ok = static_cast<unsigned>(x.oy0 - 1 + mr) < static_cast<unsigned>(x.h);
#pragma unroll
  for (int g = 0; g < F::KC; ++g) {
    const float* sc = x.vec + 16 * g + x.ch0;
    const float* bi = x.vec + CP + 16 * g + x.ch0;
    int8_t q[8];
    if (mid_values<false, SILU>(acc + 8 * g, sc, bi, x.act1, x.s_mid, q, x.odd_scales)) {
      Int8x8 a;
#pragma unroll
      for (int k = 0; k < 8; ++k) a.v[k] = acc[8 * g + k];
      const Int8x8 r = mid_values_exact<SILU>(a, sc, bi, x.act1, x.s_mid);
#pragma unroll
      for (int k = 0; k < 8; ++k) q[k] = static_cast<int8_t>(r.v[k]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = x.warp * 16 + x.lane / 4 + 8 * h;
      const bool ok = row_ok && static_cast<unsigned>(x.ox0 - 1 + m) < static_cast<unsigned>(x.w);
      int8_t* dst = x.sm + F::MID + g * F::MID_PLANE + (mr * kPW + m) * 16 + x.ch0;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        *reinterpret_cast<char2*>(dst + 8 * jj) =
            ok ? pair(q[jj * 4 + h * 2], q[jj * 4 + h * 2 + 1]) : pair(0, 0);
    }
  }
}

// Byte offset of 16-channel chunk ``g`` of staged output pixel ``px`` (CP
// bytes a pixel): the chunks of each 128-byte line rotate with the line, so
// that the 8 pixels of a fragment store, and the 8 lanes of a 16-byte read,
// hit distinct banks.
__device__ __forceinline__ int staged(int px, int g, int cp) {
  return px * cp + ((g ^ (px * cp / 128)) & (cp / 16 - 1)) * 16;
}

// conv2's epilogue of output row ``r``: residual, act_post, s8 staged per
// warp, then the warp's kept pixels to device memory 16 bytes a store
template <int CP, bool SILU2, bool SILUP>
__device__ __forceinline__ void finish_out(const int* acc, int r, const Ctx& x) {
  using F = Cfg<CP>;
#pragma unroll
  for (int g = 0; g < F::KC; ++g) {
    const float* sc = x.vec + 2 * CP + 16 * g + x.ch0;
    const float* bi = x.vec + 3 * CP + 16 * g + x.ch0;
    int8_t xr[8], q[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = x.warp * 16 + x.lane / 4 + 8 * h;
      const int8_t* src = x.in_s + g * F::IN_PLANE + ((r + 2) * kPW + m + 2) * 16 + x.ch0;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const char2 v = *reinterpret_cast<const char2*>(src + 8 * jj);
        xr[jj * 4 + h * 2] = v.x;
        xr[jj * 4 + h * 2 + 1] = v.y;
      }
    }
    if (out_values<false, SILU2, SILUP>(acc + 8 * g, sc, bi, xr, x.act2, x.act_post, x.residual,
                                        x.s_x, x.s_out, q, x.odd_scales)) {
      Int8x8 a, xv;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        a.v[k] = acc[8 * g + k];
        xv.v[k] = xr[k];
      }
      const Int8x8 rr = out_values_exact<SILU2, SILUP>(a, sc, bi, xv, x.act2, x.act_post,
                                                       x.residual, x.s_x, x.s_out);
#pragma unroll
      for (int k = 0; k < 8; ++k) q[k] = static_cast<int8_t>(rr.v[k]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        *reinterpret_cast<char2*>(x.stage + staged(x.lane / 4 + 8 * h, g, CP) + 8 * jj + x.ch0) =
            pair(q[jj * 4 + h * 2], q[jj * 4 + h * 2 + 1]);
  }
  __syncwarp();
  const int oy = x.oy0 + r;
  if (oy < x.h) {
    const int m0 = x.warp * 16;
    int8_t* row = x.out + ((static_cast<long long>(x.n) * x.h + oy) * x.w + x.ox0 + m0) * x.c;
    for (int k = x.lane; k < 16 * x.kc; k += 32) {
      const int px = k / x.kc, part = k % x.kc;
      if (m0 + px < kTW && x.ox0 + m0 + px < x.w)
        *reinterpret_cast<uint4*>(row + px * x.c + part * 16) =
            *reinterpret_cast<const uint4*>(x.stage + staged(px, part, CP));
    }
  }
  __syncwarp();
}

template <int CP>
__global__ void __launch_bounds__(kThreads, 1)
    block_kernel(const __grid_constant__ CUtensorMap xmap, const Params p) {
  using F = Cfg<CP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127) & ~127u;
  int8_t* sm = reinterpret_cast<int8_t*>(smem_raw) + (base - raw);
  float* vec = reinterpret_cast<float*>(sm + F::VEC);  // s1, b1, s2, b2; zero past C
  const uint32_t full = base + F::BAR, empty = full + 16;
  const int tid = threadIdx.x;
  const int kc = p.c / 16;  // chunk planes the input fills; the rest stay zero

  // both weight sets into core matrices [tap * KC + chunk][co][16 bytes],
  // zero past C; the epilogue vectors; zero the input planes past C
  for (int i = tid; i < 9 * F::KC * CP; i += kThreads) {
    const int co = i / (9 * F::KC), q = i % (9 * F::KC);
    const int tap = q / F::KC, cc = q % F::KC;
    uint4 v1 = {0, 0, 0, 0}, v2 = {0, 0, 0, 0};
    if (co < p.c && cc < kc) {
      const long long off = static_cast<long long>(co) * 9 * p.c + tap * p.c + cc * 16;
      v1 = *reinterpret_cast<const uint4*>(p.w1 + off);
      v2 = *reinterpret_cast<const uint4*>(p.w2 + off);
    }
    *reinterpret_cast<uint4*>(sm + F::W1 + (q * CP + co) * 16) = v1;
    *reinterpret_cast<uint4*>(sm + F::W2 + (q * CP + co) * 16) = v2;
  }
  for (int i = tid; i < 4 * CP; i += kThreads) {
    const int k = i / CP, co = i % CP;
    const float* src = k == 0 ? p.s1 : k == 1 ? p.b1 : k == 2 ? p.s2 : p.b2;
    vec[i] = co < p.c && src != nullptr ? src[co] : 0.f;
  }
  for (int i = tid; i < 2 * (F::KC - kc) * F::IN_PLANE / 16; i += kThreads) {
    const int per = (F::KC - kc) * F::IN_PLANE / 16;
    *reinterpret_cast<uint4*>(sm + F::IN + (i / per) * F::IN_BYTES + kc * F::IN_PLANE +
                              (i % per) * 16) = uint4{0, 0, 0, 0};
  }
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's expect_tx
      mbar_init(empty + 8 * s, 1);  // one consumer thread, after the tile
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: one thread issues the TMA
    if (tid != kConsumers) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
      const int s = it & 1;
      const int tx = tile % p.tiles_x, ty = (tile / p.tiles_x) % p.tiles_y;
      const int n = tile / (p.tiles_x * p.tiles_y);
      mbar_wait(empty + 8 * s, ((it >> 1) & 1) ^ 1);
      const uint32_t dst = base + F::IN + s * F::IN_BYTES;
      mbar_arrive_expect_tx(full + 8 * s, kc * (kTH + 4) * kPW * 16);
      for (int k = 0; k < kc; ++k)
        tma_load_box(dst + k * F::IN_PLANE, &xmap, full + 8 * s, 16 * k, tx * kTW - 2,
                     ty * kTH - 2, n);
    }
    return;
  }

  const int wg = tid / 128;
  Ctx x;
  x.sm = sm;
  x.vec = vec;
  x.stage = sm + F::OUT + (tid / 32) * 16 * CP;
  x.out = p.out;
  x.s_mid = *p.mid_scale;
  x.s_x = *p.x_scale;
  x.s_out = *p.out_scale;
  x.odd_scales = odd_scale(x.s_mid) || odd_scale(x.s_x) || odd_scale(x.s_out);
  x.warp = (tid % 128) / 32;
  x.lane = tid % 32;
  x.ch0 = 2 * (tid % 4);  // the thread's first channel in each 8
  x.kc = kc;
  x.h = p.h;
  x.w = p.w;
  x.c = p.c;
  x.act1 = p.act1;
  x.act2 = p.act2;
  x.act_post = p.act_post;
  x.residual = p.residual != 0;
  const bool silu1 = p.act1 == kActSilu, silu2 = p.act2 == kActSilu;
  const bool silup = p.act_post == kActSilu;
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
    const int s = it & 1;
    const int tx = tile % p.tiles_x, ty = (tile / p.tiles_x) % p.tiles_y;
    x.n = tile / (p.tiles_x * p.tiles_y);
    x.oy0 = ty * kTH;
    x.ox0 = tx * kTW;
    const uint32_t in_u = base + F::IN + s * F::IN_BYTES;
    x.in_s = sm + F::IN + s * F::IN_BYTES;
    mbar_wait(full + 8 * s, (it >> 1) & 1);

    // conv1 over the (kTH + 2) x 64 mid tile, rows wg, wg + kWGs, ...
    run_rows<CP>(
        wg, kTH + 2,
        [&](int* acc, int mr) { issue_row<CP>(acc, in_u, F::IN_PLANE, mr, base + F::W1); },
        [&](int* acc, int mr) {
          if (silu1)
            finish_mid<CP, true>(acc, mr, x);
          else
            finish_mid<CP, false>(acc, mr, x);
        });
    fence_proxy_async();  // the mid writes, before conv2's wgmma read them
    consumers_sync();

    // conv2 + residual + act_post over the kTH x 64 output rows (62 kept)
    run_rows<CP>(
        wg, kTH,
        [&](int* acc, int r) { issue_row<CP>(acc, base + F::MID, F::MID_PLANE, r, base + F::W2); },
        [&](int* acc, int r) {
          if (silu2 && silup)
            finish_out<CP, true, true>(acc, r, x);
          else if (silu2)
            finish_out<CP, true, false>(acc, r, x);
          else if (silup)
            finish_out<CP, false, true>(acc, r, x);
          else
            finish_out<CP, false, false>(acc, r, x);
        });
    consumers_sync();  // conv2 is done with the mid tile and this input stage
    if (tid == 0) mbar_arrive(empty + 8 * s);
  }
}

template <int CP>
cudaError_t launch(const CUtensorMap& xmap, const Params& p, int max_blocks, cudaStream_t stream) {
  auto kern = block_kernel<CP>;
  // per device, so set on every launch (a host-side call, no stream work)
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<CP>::SMEM);
  if (err != cudaSuccess) return err;
  const int grid = p.tiles < max_blocks ? p.tiles : max_blocks;
  kern<<<grid, kThreads, Cfg<CP>::SMEM, stream>>>(xmap, p);
  return cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

}  // namespace

// The input halo's TMA map: NHWC s8 at ``x`` (n, h, w, c) with ``pitch``
// bytes between pixels (a multiple of 16; x 16-byte aligned), read as boxes
// of 16 channels x 66 pixels x (tile rows + 4) rows, no swizzle, zeros
// outside.  Writes the 128-byte CUtensorMap to ``map_out``.  Returns 0, a
// cudaError_t (lookup, arguments), or 1000 + the CUresult of the encode.
extern "C" int adas_block_encode_input(const void* x, int n, int h, int w, int c, int pitch,
                                       void* map_out) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c % 16 || pitch < c || pitch % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap map;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(pitch),
                                 static_cast<cuuint64_t>(pitch) * w,
                                 static_cast<cuuint64_t>(pitch) * w * h};
  const cuuint32_t box[4] = {16, static_cast<cuuint32_t>(kPW), static_cast<cuuint32_t>(kTH + 4),
                             1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), dims,
                              strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return 1000 + static_cast<int>(res);
  memcpy(map_out, &map, sizeof(map));
  return 0;
}

// Plain C entry for ctypes.  ``xmap``: the input's map from
// adas_block_encode_input.  c in {16, 32, 48, 64} (= Cin = Cmid = Cout);
// acts: 0 none, 1 relu, 2 silu; b1/b2 may be null; mid_scale, x_scale and
// out_scale point to f32 scalars in device memory.  max_blocks bounds the
// persistent grid (the caller passes the SM count).  Launches on ``stream`` and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported
// configuration); never synchronises.
extern "C" int adas_block_forward(const void* xmap, const void* w1, const float* s1,
                                  const float* b1, const float* mid_scale, const void* w2,
                                  const float* s2, const float* b2, const float* x_scale,
                                  const float* out_scale, void* out, int n, int h, int wd, int c,
                                  int act1, int act2, int act_post, int residual,
                                  int max_blocks, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || max_blocks <= 0 || act1 < 0 || act1 > 2 || act2 < 0 ||
      act2 > 2 || act_post < 0 || act_post > 2)
    return cudaErrorInvalidValue;
  const int tiles_x = (wd + kTW - 1) / kTW, tiles_y = (h + kTH - 1) / kTH;
  if (static_cast<long long>(n) * tiles_x * tiles_y >= (1ll << 31)) return cudaErrorInvalidValue;
  Params p;
  p.w1 = static_cast<const int8_t*>(w1);
  p.w2 = static_cast<const int8_t*>(w2);
  p.s1 = s1;
  p.b1 = b1;
  p.s2 = s2;
  p.b2 = b2;
  p.mid_scale = mid_scale;
  p.x_scale = x_scale;
  p.out_scale = out_scale;
  p.out = static_cast<int8_t*>(out);
  p.n = n;
  p.h = h;
  p.w = wd;
  p.c = c;
  p.act1 = act1;
  p.act2 = act2;
  p.act_post = act_post;
  p.residual = residual;
  p.tiles_x = tiles_x;
  p.tiles_y = tiles_y;
  p.tiles = n * tiles_x * tiles_y;
  CUtensorMap xm;
  memcpy(&xm, xmap, sizeof(xm));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 64 || c == 48) return launch<64>(xm, p, max_blocks, s);
  if (c == 32 || c == 16) return launch<32>(xm, p, max_blocks, s);
  return cudaErrorInvalidValue;
}
