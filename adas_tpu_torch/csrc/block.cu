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
// call at a channel width of 64, where a conv alone is bound by moving its
// activations.  Fusing keeps the mid activation out of device memory: per
// call the kernel reads the s8 input once and writes the s8 output once.
//
// What the design does about it:
//  * A persistent grid (2 blocks of 256 threads per SM) walks 8 x 16 output
//    tiles.  Each block loads both weight sets once (2 x C x 9C bytes, rows
//    padded so fragment loads are conflict-free) and keeps them in shared
//    memory for all its tiles.
//  * Per tile: the input with a 2-pixel halo (12 x 20 pixels, zero outside
//    the image) goes to shared memory; conv1 runs over the tile plus a
//    1-pixel ring (10 x 18 mid pixels) as an implicit GEMM on the tensor
//    cores (mma.sync m16n8k32 s8 -> s32), and its epilogue requantizes the
//    mid to s8 in shared memory, zero outside the image (conv2's padding,
//    as pallas_block.py masks it).  conv2 then runs over the 8 x 16 tile,
//    and its epilogue adds the residual from the input tile still in
//    shared memory, applies act_post and requantizes to the NHWC output.
//  * The epilogues round as the reference does: __fmul_rn / __fadd_rn (no
//    FMA contraction), __fdiv_rn by the scale, round half to even.  s_mid,
//    s_x and s_out are read from device memory, never from the host.
//  * C (= Cin = Cmid = Cout) is a template parameter (16, 32, 48 or 64); the
//    input takes a channel pitch (the first bottleneck of a C2f reads a
//    channel slice of cv1's output in place).
//
// Layouts: x (N, H, W, *) s8 with channel pitch x_pitch; w1, w2 (C, 3, 3,
// C) s8 contiguous; s1, b1, s2, b2 f32 (C); out (N, H, W, C) s8 contiguous.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 8, kTW = 16;                  // output tile
constexpr int kMH = kTH + 2, kMW = kTW + 2;       // mid tile (1-pixel ring)
constexpr int kIH = kTH + 4, kIW = kTW + 4;       // input tile (2-pixel halo)
constexpr int kMidPix = kMH * kMW;                // 180
constexpr int kM1Tiles = (kMidPix + 15) / 16;     // 12 m16 tiles for conv1
constexpr int kM2Tiles = kTH * kTW / 16;          // 8 m16 tiles for conv2
constexpr int kThreads = 256;                     // 8 warps: 4 (M) x 2 (N)

enum Act { kActNone = 0, kActRelu = 1, kActSilu = 2 };

template <int C>
struct Cfg {
  static constexpr int PS = (C > 32 ? C : 32) + 16;        // pixel stride (bytes)
  static constexpr int K = 9 * C;
  static constexpr int KP = (K + 31) / 32 * 32;            // K padded to 32
  static constexpr int WS = KP + 16;                       // weight row stride
  static constexpr int NTW = C / 16;                       // n8 tiles per warp
  static constexpr int IN_BYTES = kIH * kIW * PS;
  static constexpr int MID_BYTES = kMidPix * PS;
  static constexpr int W_BYTES = C * WS;
  static constexpr int SMEM = IN_BYTES + MID_BYTES + 2 * W_BYTES;
  static constexpr int VEC = C % 16 == 0 ? 16 : 8;
};

struct Params {
  const int8_t* x;
  const int8_t* w1;
  const int8_t* w2;
  const float *s1, *b1, *s2, *b2;  // b1, b2 may be null
  const float *mid_scale, *x_scale, *out_scale;
  int8_t* out;
  int n, h, w, x_pitch;
  int act1, act2, act_post, residual;
  int tiles_x, tiles_y, tiles;
};

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kActRelu) return fmaxf(v, 0.f);
  if (act == kActSilu) return __fdiv_rn(v, 1.f + expf(-v));
  return v;
}

__device__ __forceinline__ int8_t requant(float v, float s) {
  float q = rintf(__fdiv_rn(v, s));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(q));
}

// One 32-byte K step of an implicit 3x3 GEMM over a pixel-major shared
// tile whose rows are ``tw`` pixels wide: 4 bytes of row r at K offset k
// (tap = k / C, channel = k % C); zero past the 9 taps (the K padding).
template <int C>
__device__ __forceinline__ unsigned a_word(const int8_t* tile, int pix, int k, int tw) {
  const int tap = k / C;
  if (tap >= 9) return 0u;
  const int c = k - tap * C;
  const int dy = tap / 3, dx = tap - dy * 3;
  return *reinterpret_cast<const unsigned*>(tile + (pix + dy * tw + dx) * Cfg<C>::PS + c);
}

template <int C, int MT>
__device__ __forceinline__ void gemm(int (&acc)[MT][Cfg<C>::NTW][4], const int8_t* tile,
                                     int tw, const int (&pix)[MT][2], const int8_t* w_s,
                                     int wn, int g, int t) {
  using F = Cfg<C>;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < F::NTW; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
#pragma unroll 2
  for (int k0 = 0; k0 < F::KP; k0 += 32) {
    unsigned bf[F::NTW][2];
#pragma unroll
    for (int j = 0; j < F::NTW; ++j) {
      const int8_t* base = w_s + (wn + j * 8 + g) * F::WS + k0 + t * 4;
      bf[j][0] = *reinterpret_cast<const unsigned*>(base);
      bf[j][1] = *reinterpret_cast<const unsigned*>(base + 16);
    }
    const int ka = k0 + t * 4, kb = ka + 16;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      unsigned af[4];
      af[0] = a_word<C>(tile, pix[i][0], ka, tw);
      af[1] = a_word<C>(tile, pix[i][1], ka, tw);
      af[2] = a_word<C>(tile, pix[i][0], kb, tw);
      af[3] = a_word<C>(tile, pix[i][1], kb, tw);
#pragma unroll
      for (int j = 0; j < F::NTW; ++j) mma_s8(acc[i][j], af, bf[j]);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 2) block_kernel(const Params p) {
  using F = Cfg<C>;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* in_s = smem;
  int8_t* mid_s = in_s + F::IN_BYTES;
  int8_t* w1_s = mid_s + F::MID_BYTES;
  int8_t* w2_s = w1_s + F::W_BYTES;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % 4, wn = (warp / 4) * (C / 2);

  // both weight sets, once per block; K padding zeroed
  for (int i = tid; i < C * F::WS / 4; i += kThreads) {
    const int row = (i * 4) / F::WS, col = (i * 4) % F::WS;
    unsigned v1 = 0, v2 = 0;
    if (col < F::K) {
      v1 = *reinterpret_cast<const unsigned*>(p.w1 + row * F::K + col);
      v2 = *reinterpret_cast<const unsigned*>(p.w2 + row * F::K + col);
    }
    *reinterpret_cast<unsigned*>(w1_s + row * F::WS + col) = v1;
    *reinterpret_cast<unsigned*>(w2_s + row * F::WS + col) = v2;
  }
  const float s_mid = *p.mid_scale, s_x = *p.x_scale, s_out = *p.out_scale;

  // fragment rows: conv1 over the 10 x 18 mid tile (rows past 180 clamp to
  // a valid pixel and are discarded), conv2 over the 8 x 16 output tile
  constexpr int M1 = kM1Tiles / 4, M2 = kM2Tiles / 4;
  int pix1[M1][2], pix2[M2][2];
#pragma unroll
  for (int i = 0; i < M1; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = min((wm * M1 + i) * 16 + g + 8 * h, kMidPix - 1);
      pix1[i][h] = (m / kMW) * kIW + m % kMW;
    }
#pragma unroll
  for (int i = 0; i < M2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (wm * M2 + i) * 16 + g + 8 * h;
      pix2[i][h] = (m / kTW) * kMW + m % kTW;
    }

  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int tx = tile % p.tiles_x;
    const int ty = (tile / p.tiles_x) % p.tiles_y;
    const int n = tile / (p.tiles_x * p.tiles_y);
    const int oy0 = ty * kTH, ox0 = tx * kTW;

    __syncthreads();  // the previous tile is done with in_s / mid_s
    // input tile with its 2-pixel halo, zero outside the image
    constexpr int kChunks = C / F::VEC;
    for (int i = tid; i < kIH * kIW * kChunks; i += kThreads) {
      const int pix = i / kChunks, ch = (i % kChunks) * F::VEC;
      const int iy = oy0 - 2 + pix / kIW, ix = ox0 - 2 + pix % kIW;
      int8_t* dst = in_s + pix * F::PS + ch;
      const bool ok = iy >= 0 && iy < p.h && ix >= 0 && ix < p.w;
      const int8_t* src =
          p.x + ((static_cast<long long>(n) * p.h + iy) * p.w + ix) * p.x_pitch + ch;
      if (F::VEC == 16) {
        *reinterpret_cast<uint4*>(dst) = ok ? *reinterpret_cast<const uint4*>(src) : uint4{};
      } else {
        *reinterpret_cast<uint2*>(dst) = ok ? *reinterpret_cast<const uint2*>(src) : uint2{};
      }
    }
    __syncthreads();

    {  // conv1 -> s8 mid in shared memory
      int acc[M1][F::NTW][4];
      gemm<C, M1>(acc, in_s, kIW, pix1, w1_s, wn, g, t);
#pragma unroll
      for (int j = 0; j < F::NTW; ++j) {
        const int co = wn + j * 8 + t * 2;
        const float sc0 = p.s1[co], sc1 = p.s1[co + 1];
        const float bb0 = p.b1 ? p.b1[co] : 0.f, bb1 = p.b1 ? p.b1[co + 1] : 0.f;
#pragma unroll
        for (int i = 0; i < M1; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = (wm * M1 + i) * 16 + g + 8 * h;
            if (m >= kMidPix) continue;
            const int my = oy0 - 1 + m / kMW, mx = ox0 - 1 + m % kMW;
            char2 v = {0, 0};
            if (my >= 0 && my < p.h && mx >= 0 && mx < p.w) {
              float y0 = __fmul_rn(static_cast<float>(acc[i][j][2 * h]), sc0);
              float y1 = __fmul_rn(static_cast<float>(acc[i][j][2 * h + 1]), sc1);
              if (p.b1) {
                y0 = __fadd_rn(y0, bb0);
                y1 = __fadd_rn(y1, bb1);
              }
              v.x = requant(activate(y0, p.act1), s_mid);
              v.y = requant(activate(y1, p.act1), s_mid);
            }
            *reinterpret_cast<char2*>(mid_s + m * F::PS + co) = v;
          }
      }
    }
    __syncthreads();

    {  // conv2 + residual + act_post -> s8 output
      int acc[M2][F::NTW][4];
      gemm<C, M2>(acc, mid_s, kMW, pix2, w2_s, wn, g, t);
#pragma unroll
      for (int j = 0; j < F::NTW; ++j) {
        const int co = wn + j * 8 + t * 2;
        const float sc0 = p.s2[co], sc1 = p.s2[co + 1];
        const float bb0 = p.b2 ? p.b2[co] : 0.f, bb1 = p.b2 ? p.b2[co + 1] : 0.f;
#pragma unroll
        for (int i = 0; i < M2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = (wm * M2 + i) * 16 + g + 8 * h;
            const int ly = m / kTW, lx = m % kTW;
            const int oy = oy0 + ly, ox = ox0 + lx;
            if (oy >= p.h || ox >= p.w) continue;
            float y0 = __fmul_rn(static_cast<float>(acc[i][j][2 * h]), sc0);
            float y1 = __fmul_rn(static_cast<float>(acc[i][j][2 * h + 1]), sc1);
            if (p.b2) {
              y0 = __fadd_rn(y0, bb0);
              y1 = __fadd_rn(y1, bb1);
            }
            y0 = activate(y0, p.act2);
            y1 = activate(y1, p.act2);
            if (p.residual) {
              const int8_t* xr = in_s + ((ly + 2) * kIW + lx + 2) * F::PS + co;
              y0 = __fadd_rn(y0, __fmul_rn(static_cast<float>(xr[0]), s_x));
              y1 = __fadd_rn(y1, __fmul_rn(static_cast<float>(xr[1]), s_x));
            }
            char2 v;
            v.x = requant(activate(y0, p.act_post), s_out);
            v.y = requant(activate(y1, p.act_post), s_out);
            *reinterpret_cast<char2*>(
                p.out + ((static_cast<long long>(n) * p.h + oy) * p.w + ox) * C + co) = v;
          }
      }
    }
  }
}

template <int C>
cudaError_t launch(Params p, int max_blocks, cudaStream_t stream) {
  constexpr int smem = Cfg<C>::SMEM;
  auto kern = block_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = p.tiles < max_blocks ? p.tiles : max_blocks;
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes.  c in {16, 32, 48, 64} (= Cin = Cmid = Cout); acts:
// 0 none, 1 relu, 2 silu; b1/b2 may be null; mid_scale, x_scale and
// out_scale point to f32 scalars in device memory.  max_blocks bounds the
// persistent grid (the caller passes 2 x the SM count).  Launches on
// ``stream`` and returns cudaGetLastError() (cudaErrorInvalidValue for an
// unsupported configuration); never synchronises.
extern "C" int adas_block_forward(const void* x, const void* w1, const float* s1,
                                  const float* b1, const float* mid_scale, const void* w2,
                                  const float* s2, const float* b2, const float* x_scale,
                                  const float* out_scale, void* out, int n, int h, int wd,
                                  int c, int x_pitch, int act1, int act2, int act_post,
                                  int residual, int max_blocks, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || x_pitch < c || max_blocks <= 0 || act1 < 0 ||
      act1 > 2 || act2 < 0 || act2 > 2 || act_post < 0 || act_post > 2)
    return cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const int8_t*>(x);
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
  p.x_pitch = x_pitch;
  p.act1 = act1;
  p.act2 = act2;
  p.act_post = act_post;
  p.residual = residual;
  p.tiles_x = (wd + kTW - 1) / kTW;
  p.tiles_y = (h + kTH - 1) / kTH;
  p.tiles = n * p.tiles_x * p.tiles_y;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 64 && x_pitch % 16 == 0) return launch<64>(p, max_blocks, s);
  if (c == 48 && x_pitch % 16 == 0) return launch<48>(p, max_blocks, s);
  if (c == 32 && x_pitch % 16 == 0) return launch<32>(p, max_blocks, s);
  if (c == 16 && x_pitch % 16 == 0) return launch<16>(p, max_blocks, s);
  return cudaErrorInvalidValue;
}
