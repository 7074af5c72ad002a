// Fused stride-2 stem: act(conv2d(x, w, stride 2, pad k/2) * gain + bias),
// optionally followed by a 3x3/2 pad-1 max pool, in one kernel.
//
// Replaces the TPU kernel adas_tpu/ops/pallas_stem.py::_stem_kernel (entry
// fused_stem).  It computes what that kernel computes, not its blocking:
// the Pallas kernel walks bands of rows of a polyphase (space-to-depth)
// planar input on one core; here every block of threads owns one output
// tile of one image, and the blocks run in parallel over the SMs.
//
// What bounds it on an H100: the stems have C_in = 3, so the conv is
// 27 (k=3) or 147 (k=7) MACs per output feature.  The YOLO 3x3 stem
// (8x3x640x640 -> 8x64x320x320) is bound by writing its 52M-element output;
// the ResNet 7x7 stem (8x3x320x1600 -> conv 8x64x160x800 -> pool
// 8x64x80x400) by its 9.6 GMAC of arithmetic, which this first version
// runs in f32 on the CUDA cores (tensor cores are later work).
//
// What the design does about it:
//  * The input tile of a block is read once from device memory into shared
//    memory (zero padding by bounds checks, no padded copy) and split by
//    column parity, so the stride-2 reads of neighbouring lanes fall on
//    neighbouring addresses.  The 64 x 3 x k x k taps sit in shared memory
//    as f32, [tap][feature], so a warp reads 16 features of one tap as four
//    broadcast 16-byte loads.
//  * Each thread holds 16 features x R pixels of accumulators: per tap it
//    does 16 R FMAs for 4 + R shared loads.
//  * BN (folded to gain/bias), the activation and the cast happen in
//    registers.  With the pool, the block's conv tile stays in shared
//    memory (with real -inf outside the conv output), so the full-
//    resolution stem activation never reaches device memory, and odd sizes
//    and non-ReLU pools are exact with no routing.
//
// Layouts: x NCHW (N, 3, H, W); w OIHW (64, 3, k, k) in the input's type;
// gain, bias f32 (64); out NCHW (N, 64, Ho, Wo) in the input's type.
// Accumulation and the epilogue run in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kC = 3;                       // input channels
constexpr int kF = 64;                      // output features
constexpr int kThreads = 256;
constexpr int kFG = 16;                     // features per thread
constexpr int kFeatGroups = kF / kFG;       // 4
constexpr int kPixGroups = kThreads / 32 / kFeatGroups;  // 2

enum Act { kActNone = 0, kActRelu = 1, kActSilu = 2 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kActRelu) return fmaxf(v, 0.f);
  if (act == kActSilu) return v / (1.f + __expf(-v));
  return v;
}

// Tile geometry.  Without the pool a block computes an 8 x 32 conv tile;
// with it, a 4 x 16 pool tile, i.e. the 9 x 33 conv tile its windows cover.
template <int K, bool POOL>
struct Geom {
  static constexpr int OH = POOL ? 4 : 8;    // output rows per block
  static constexpr int OW = POOL ? 16 : 32;  // output cols per block
  static constexpr int CR = POOL ? 2 * OH + 1 : OH;  // conv rows computed
  static constexpr int CC = POOL ? 2 * OW + 1 : OW;  // conv cols computed
  static constexpr int NPIX = CR * CC;
  static constexpr int CHUNKS = (NPIX + 31) / 32;
  static constexpr int R = (CHUNKS + kPixGroups - 1) / kPixGroups;  // px/thread
  static constexpr int IN_H = 2 * (CR - 1) + K;
  static constexpr int IN_W = 2 * (CC - 1) + K;
  static constexpr int IN_WH = (IN_W + 1) / 2;  // width of one column phase
  static constexpr int W_FLOATS = kC * K * K * kF;
  static constexpr int IN_FLOATS = kC * IN_H * 2 * IN_WH;
};

template <int K, bool POOL, typename T>
constexpr size_t smem_bytes() {
  using G = Geom<K, POOL>;
  return sizeof(float) * (G::W_FLOATS + G::IN_FLOATS) +
         (POOL ? sizeof(T) * kF * G::NPIX : 0);
}

template <int K, bool POOL, typename T>
__global__ void __launch_bounds__(kThreads, 2)
stem_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const float* __restrict__ gain, const float* __restrict__ bias,
            T* __restrict__ out, int H, int W, int Hc, int Wc, int Ho, int Wo,
            int act) {
  using G = Geom<K, POOL>;
  constexpr int pad = K / 2;
  extern __shared__ float4 smem_raw[];
  float* w_s = reinterpret_cast<float*>(smem_raw);  // [tap][kF]
  float* in_s = w_s + G::W_FLOATS;                   // [c][row][phase][IN_WH]
  T* ct_s = reinterpret_cast<T*>(in_s + G::IN_FLOATS);  // [f][CR][CC] (pool)

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int by = blockIdx.y, bx = blockIdx.x;
  // first conv row/col of this block's conv tile (-1 halo with the pool)
  const int crow0 = POOL ? 2 * by * G::OH - 1 : by * G::OH;
  const int ccol0 = POOL ? 2 * bx * G::OW - 1 : bx * G::OW;
  const int iy0 = 2 * crow0 - pad;
  const int ix0 = 2 * ccol0 - pad;

  for (int i = tid; i < G::W_FLOATS; i += kThreads) {
    const int f = i % kF, tap = i / kF;
    w_s[i] = to_f32(w[f * (kC * K * K) + tap]);
  }
  const T* xn = x + static_cast<size_t>(n) * kC * H * W;
  for (int i = tid; i < kC * G::IN_H * G::IN_W; i += kThreads) {
    const int col = i % G::IN_W;
    const int r = (i / G::IN_W) % G::IN_H;
    const int c = i / (G::IN_W * G::IN_H);
    const int gy = iy0 + r, gx = ix0 + col;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = to_f32(xn[(static_cast<size_t>(c) * H + gy) * W + gx]);
    in_s[((c * G::IN_H + r) * 2 + (col & 1)) * G::IN_WH + (col >> 1)] = v;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int fg = warp % kFeatGroups;
  const int pg = warp / kFeatGroups;
  int pix_off[G::R], pix_row[G::R], pix_col[G::R];
  bool pix_ok[G::R];
#pragma unroll
  for (int j = 0; j < G::R; ++j) {
    const int p = (pg + kPixGroups * j) * 32 + lane;
    pix_ok[j] = p < G::NPIX;
    const int pp = pix_ok[j] ? p : 0;
    pix_row[j] = pp / G::CC;
    pix_col[j] = pp % G::CC;
    // input row 2*row + ky, column 2*col + kx -> phase kx&1, index col + kx/2
    pix_off[j] = 2 * pix_row[j] * 2 * G::IN_WH + pix_col[j];
  }

  float acc[G::R][kFG];
#pragma unroll
  for (int j = 0; j < G::R; ++j)
#pragma unroll
    for (int f = 0; f < kFG; ++f) acc[j][f] = 0.f;

  for (int c = 0; c < kC; ++c) {
    for (int ky = 0; ky < K; ++ky) {
      const float* in_row = in_s + (c * G::IN_H + ky) * 2 * G::IN_WH;
      const float* w_row = w_s + ((c * K + ky) * K) * kF + fg * kFG;
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        const float4* wp = reinterpret_cast<const float4*>(w_row + kx * kF);
        float wv[kFG];
#pragma unroll
        for (int q = 0; q < kFG / 4; ++q) {
          const float4 t = wp[q];
          wv[4 * q] = t.x; wv[4 * q + 1] = t.y; wv[4 * q + 2] = t.z; wv[4 * q + 3] = t.w;
        }
        const float* base = in_row + (kx & 1) * G::IN_WH + (kx >> 1);
#pragma unroll
        for (int j = 0; j < G::R; ++j) {
          const float v = base[pix_off[j]];
#pragma unroll
          for (int f = 0; f < kFG; ++f) acc[j][f] = fmaf(v, wv[f], acc[j][f]);
        }
      }
    }
  }

  float g[kFG], b[kFG];
#pragma unroll
  for (int f = 0; f < kFG; ++f) {
    g[f] = gain[fg * kFG + f];
    b[f] = bias[fg * kFG + f];
  }

  if constexpr (!POOL) {
    T* on = out + static_cast<size_t>(n) * kF * Ho * Wo;
#pragma unroll
    for (int j = 0; j < G::R; ++j) {
      const int oy = crow0 + pix_row[j], ox = ccol0 + pix_col[j];
      if (!pix_ok[j] || oy >= Ho || ox >= Wo) continue;
#pragma unroll
      for (int f = 0; f < kFG; ++f) {
        const float v = activate(fmaf(acc[j][f], g[f], b[f]), act);
        on[(static_cast<size_t>(fg * kFG + f) * Ho + oy) * Wo + ox] = from_f32<T>(v);
      }
    }
  } else {
    // pooled: the conv tile goes to shared memory, -inf outside the conv
    // output (the pool's padding), then each 3x3/2 window is reduced there
#pragma unroll
    for (int j = 0; j < G::R; ++j) {
      if (!pix_ok[j]) continue;
      const int cy = crow0 + pix_row[j], cx = ccol0 + pix_col[j];
      const bool valid = cy >= 0 && cy < Hc && cx >= 0 && cx < Wc;
#pragma unroll
      for (int f = 0; f < kFG; ++f) {
        const float v = valid ? activate(fmaf(acc[j][f], g[f], b[f]), act) : -CUDART_INF_F;
        ct_s[(fg * kFG + f) * G::NPIX + pix_row[j] * G::CC + pix_col[j]] = from_f32<T>(v);
      }
    }
    __syncthreads();
    const int py0 = by * G::OH, px0 = bx * G::OW;
    T* on = out + static_cast<size_t>(n) * kF * Ho * Wo;
    for (int i = tid; i < kF * G::OH * G::OW; i += kThreads) {
      const int pc = i % G::OW;
      const int pr = (i / G::OW) % G::OH;
      const int f = i / (G::OW * G::OH);
      const int py = py0 + pr, px = px0 + pc;
      if (py >= Ho || px >= Wo) continue;
      const T* win = ct_s + f * G::NPIX + 2 * pr * G::CC + 2 * pc;
      float m = -CUDART_INF_F;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, to_f32(win[dy * G::CC + dx]));
      on[(static_cast<size_t>(f) * Ho + py) * Wo + px] = from_f32<T>(m);
    }
  }
}

template <int K, bool POOL, typename T>
cudaError_t launch(const void* x, const void* w, const float* gain,
                   const float* bias, void* out, int n, int h, int wd,
                   int act, cudaStream_t stream) {
  using G = Geom<K, POOL>;
  const int hc = (h - 1) / 2 + 1, wc = (wd - 1) / 2 + 1;
  const int ho = POOL ? (hc - 1) / 2 + 1 : hc;
  const int wo = POOL ? (wc - 1) / 2 + 1 : wc;
  constexpr size_t smem = smem_bytes<K, POOL, T>();
  auto kern = stem_kernel<K, POOL, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((wo + G::OW - 1) / G::OW, (ho + G::OH - 1) / G::OH, n);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), gain, bias,
      static_cast<T*>(out), h, wd, hc, wc, ho, wo, act);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const float* gain,
                     const float* bias, void* out, int n, int h, int wd,
                     int k, int pool, int act, cudaStream_t s) {
  if (k == 3 && !pool) return launch<3, false, T>(x, w, gain, bias, out, n, h, wd, act, s);
  if (k == 3 && pool) return launch<3, true, T>(x, w, gain, bias, out, n, h, wd, act, s);
  if (k == 7 && !pool) return launch<7, false, T>(x, w, gain, bias, out, n, h, wd, act, s);
  if (k == 7 && pool) return launch<7, true, T>(x, w, gain, bias, out, n, h, wd, act, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry for ctypes.  dtype: 0 = f32, 1 = bf16.  act: 0 none,
// 1 relu, 2 silu.  Launches on ``stream`` and returns cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported configuration); never
// synchronises.
extern "C" int adas_stem_forward(const void* x, const void* w,
                                 const float* gain, const float* bias,
                                 void* out, int n, int h, int wd, int k,
                                 int pool, int act, int dtype, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || act < 0 || act > 2) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, w, gain, bias, out, n, h, wd, k, pool, act, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, gain, bias, out, n, h, wd, k, pool, act, s);
  return cudaErrorInvalidValue;
}
