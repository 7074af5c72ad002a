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
// (8x3x640x640 -> 8xFx320x320, F = 16..80 features by scale) is bound by
// writing its output (~0.037 ms of bytes at F = 64); the ResNet 7x7 stem
// (8x3x320x1600 -> conv 8x64x160x800 -> pool 8x64x80x400) by its 9.6 GMAC
// (~0.02 ms on the bf16 tensor cores, ~0.29 ms on the f32 CUDA cores).
//
// The feature count F is a template parameter of both paths; only the
// served combinations are instantiated (3x3 without the pool at F = 16,
// 32, 48, 64, 80: the YOLOv8/v10 n/s/m/l/x stems; 7x7 with the pool at
// F = 64: the ResNet stem), and the C entry returns cudaErrorInvalidValue
// for any other.
//
// What the design does about it, bf16 (the serving path; stem_mma_kernel):
//  * A persistent grid (two blocks per SM) walks the output tiles; each
//    block stages the F x K weights once, K padded from 27 to 32 (3x3) or
//    147 to 160 (7x7) with zero weights.  A tile's input is read once from
//    device memory into shared memory (zero padding by bounds checks, no
//    padded copy); for the 3x3 stem the next tile's input is loaded into
//    registers while this tile computes.
//  * The conv is a GEMM of the block's conv pixels x F features x K on the
//    tensor cores, mma.sync m16n8k16 bf16 with f32 accumulation.  The A
//    fragments are gathered straight from the staged input (a pixel's
//    offset plus a per-k tap offset from a table), so the im2col tile is
//    never built; the B fragments are conflict-free 32-bit loads of the
//    weight rows.  Products of bf16 values are exact in f32: only the
//    order of the sum differs from the plain version.
//  * Folded BN, the activation (silu with the fast exp and division: IEEE
//    division's branch to its slow routine keeps nvcc from overlapping the
//    values) and the cast happen on the accumulators.
//    The conv tile then goes to shared memory: without the pool it leaves
//    as 16-byte row stores; with the pool it holds real -inf outside the
//    conv output, the 3x3/2 windows are reduced there, and the
//    full-resolution stem activation never reaches device memory (odd
//    sizes and non-ReLU pools are exact with no routing).
//  * 8 warps, each 2 (no pool: 4x64 pixel tile) or 4 (pool: 15x33 conv
//    pixels for a 7x16 pool tile) 16-pixel fragments by F features, two
//    fragments at a time (one at F = 80): at most 64 f32 accumulators per
//    thread.  At F = 16 the tile is bound by its stores; it is not tuned.
//
// f32 (stem_f32_kernel) stays on the CUDA cores: TF32 tensor cores cannot meet
// the f32 yardstick (atol 2e-4, rtol 1e-4, tests/test_pallas_stem.py:80),
// and the batched serving paths stem in bf16 (int8 and bf16 nets); the
// f32 nets (the demo's default YOLOv8n) run it.  It stages the input tile
// split by column parity and the weights as f32 [tap][feature]; the 8
// warps split the features into 1, 2 or 4 groups (F / 16 up to 4) and the
// pixels among the rest, so each thread holds F accumulators (one block
// per SM at F = 80, to keep them in registers).
//
// Layouts: x NCHW (N, 3, H, W); w OIHW (F, 3, k, k) in the input's type;
// gain, bias f32 (F); out NCHW (N, F, Ho, Wo) in the input's type.
// Accumulation and the epilogue run in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kC = 3;                       // input channels
constexpr int kThreads = 256;

enum Act { kActNone = 0, kActRelu = 1, kActSilu = 2 };


// silu with the fast exp and division (a few ulp of f32, well inside both
// yardsticks): the IEEE division's branch to its slow routine would keep
// the compiler from overlapping one value's division with the next
__device__ __forceinline__ float activate(float v, int act) {
  if (act == kActRelu) return fmaxf(v, 0.f);
  if (act == kActSilu) return __fdividef(v, 1.f + __expf(-v));
  return v;
}

// Tile geometry of stem_f32_kernel.  Without the pool a block computes an
// 8 x 32 conv tile; with it, a 4 x 16 pool tile, i.e. the 9 x 33 conv tile
// its windows cover.  The warps split the F features into kFeatGroups of
// kFG (a multiple of 4: float4 weight loads) and the pixels among the
// kPixGroups warps of each feature group.
template <int K, bool POOL, int F>
struct Geom {
  static constexpr int kFeatGroups = F >= 48 ? 4 : F / 16;   // 1, 2, 4, 4, 4
  static constexpr int kFG = F / kFeatGroups;                // 16, 16, 12, 16, 20
  static constexpr int kPixGroups = kThreads / 32 / kFeatGroups;
  static_assert(F % kFeatGroups == 0 && kFG % 4 == 0 &&
                kPixGroups * kFeatGroups == kThreads / 32, "feature split");
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
  static constexpr int W_FLOATS = kC * K * K * F;
  static constexpr int IN_FLOATS = kC * IN_H * 2 * IN_WH;
};

template <int K, bool POOL, int F>
constexpr size_t smem_bytes() {
  using G = Geom<K, POOL, F>;
  return sizeof(float) * (G::W_FLOATS + G::IN_FLOATS) +
         (POOL ? sizeof(float) * F * G::NPIX : 0);
}

// F accumulators per thread: one block per SM above 64 features, so that
// they stay in registers
template <int K, bool POOL, int F>
__global__ void __launch_bounds__(kThreads, F > 64 ? 1 : 2)
stem_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ gain, const float* __restrict__ bias,
            float* __restrict__ out, int H, int W, int Hc, int Wc, int Ho, int Wo,
            int act) {
  using G = Geom<K, POOL, F>;
  constexpr int kFG = G::kFG, kFeatGroups = G::kFeatGroups, kPixGroups = G::kPixGroups;
  constexpr int pad = K / 2;
  extern __shared__ float4 smem_raw[];
  float* w_s = reinterpret_cast<float*>(smem_raw);  // [tap][F]
  float* in_s = w_s + G::W_FLOATS;                   // [c][row][phase][IN_WH]
  float* ct_s = reinterpret_cast<float*>(in_s + G::IN_FLOATS);  // [f][CR][CC] (pool)

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int by = blockIdx.y, bx = blockIdx.x;
  // first conv row/col of this block's conv tile (-1 halo with the pool)
  const int crow0 = POOL ? 2 * by * G::OH - 1 : by * G::OH;
  const int ccol0 = POOL ? 2 * bx * G::OW - 1 : bx * G::OW;
  const int iy0 = 2 * crow0 - pad;
  const int ix0 = 2 * ccol0 - pad;

  for (int i = tid; i < G::W_FLOATS; i += kThreads) {
    const int f = i % F, tap = i / F;
    w_s[i] = w[f * (kC * K * K) + tap];
  }
  const float* xn = x + static_cast<size_t>(n) * kC * H * W;
  for (int i = tid; i < kC * G::IN_H * G::IN_W; i += kThreads) {
    const int col = i % G::IN_W;
    const int r = (i / G::IN_W) % G::IN_H;
    const int c = i / (G::IN_W * G::IN_H);
    const int gy = iy0 + r, gx = ix0 + col;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = xn[(static_cast<size_t>(c) * H + gy) * W + gx];
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
      const float* w_row = w_s + ((c * K + ky) * K) * F + fg * kFG;
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        const float4* wp = reinterpret_cast<const float4*>(w_row + kx * F);
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
    float* on = out + static_cast<size_t>(n) * F * Ho * Wo;
#pragma unroll
    for (int j = 0; j < G::R; ++j) {
      const int oy = crow0 + pix_row[j], ox = ccol0 + pix_col[j];
      if (!pix_ok[j] || oy >= Ho || ox >= Wo) continue;
#pragma unroll
      for (int f = 0; f < kFG; ++f) {
        const float v = activate(fmaf(acc[j][f], g[f], b[f]), act);
        on[(static_cast<size_t>(fg * kFG + f) * Ho + oy) * Wo + ox] = v;
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
        ct_s[(fg * kFG + f) * G::NPIX + pix_row[j] * G::CC + pix_col[j]] = v;
      }
    }
    __syncthreads();
    const int py0 = by * G::OH, px0 = bx * G::OW;
    float* on = out + static_cast<size_t>(n) * F * Ho * Wo;
    for (int i = tid; i < F * G::OH * G::OW; i += kThreads) {
      const int pc = i % G::OW;
      const int pr = (i / G::OW) % G::OH;
      const int f = i / (G::OW * G::OH);
      const int py = py0 + pr, px = px0 + pc;
      if (py >= Ho || px >= Wo) continue;
      const float* win = ct_s + f * G::NPIX + 2 * pr * G::CC + 2 * pc;
      float m = -CUDART_INF_F;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, win[dy * G::CC + dx]);
      on[(static_cast<size_t>(f) * Ho + py) * Wo + px] = m;
    }
  }
}

template <int K, bool POOL, int F>
cudaError_t launch_f32(const void* x, const void* w, const float* gain,
                   const float* bias, void* out, int n, int h, int wd,
                   int act, cudaStream_t stream) {
  using G = Geom<K, POOL, F>;
  const int hc = (h - 1) / 2 + 1, wc = (wd - 1) / 2 + 1;
  const int ho = POOL ? (hc - 1) / 2 + 1 : hc;
  const int wo = POOL ? (wc - 1) / 2 + 1 : wc;
  constexpr size_t smem = smem_bytes<K, POOL, F>();
  auto kern = stem_f32_kernel<K, POOL, F>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((wo + G::OW - 1) / G::OW, (ho + G::OH - 1) / G::OH, n);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), gain, bias,
      static_cast<float*>(out), h, wd, hc, wc, ho, wo, act);
  return cudaGetLastError();
}

// ---- bf16 on the tensor cores ------------------------------------------

// Tile geometry of stem_mma_kernel.  Without the pool a block computes a
// 4 x 64 conv tile; with it, a 7 x 16 pool tile, i.e. the 15 x 33 conv tile
// its windows cover.  Rows of the GEMM are the conv pixels in row-major
// order, 16 to an m16n8k16 fragment; the F features are NT n-tiles of 8.
// A warp computes Q fragments at a time: 2 (8 * NT accumulators per
// thread, at most 64), 1 at F = 80.
template <int K, bool POOL, int F>
struct MGeom {
  static constexpr int NT = F / 8;
  static constexpr int Q = F > 64 ? 1 : 2;
  static constexpr int OH = POOL ? 7 : 4;     // output rows per block
  static constexpr int OW = POOL ? 16 : 64;   // output cols per block
  static constexpr int CR = POOL ? 2 * OH + 1 : OH;  // conv rows computed
  static constexpr int CC = POOL ? 2 * OW + 1 : OW;  // conv cols computed
  static constexpr int NPIX = CR * CC;
  static constexpr int FRAGS = (NPIX + 15) / 16;
  static constexpr int FPW = (FRAGS + 7) / 8;        // fragments per warp
  static constexpr int KK = kC * K * K;              // 27 or 147
  static constexpr int KP = (KK + 15) / 16 * 16;     // 32 or 160
  static constexpr int WS = KP + 8;   // weight row stride: conflict-free fragment loads
  static constexpr int CTS = POOL ? 504 : 264;  // conv-tile row stride, = 8 or 24 mod 32 words
  static constexpr int IN_H = 2 * (CR - 1) + K;
  static constexpr int IN_W = 2 * (CC - 1) + K;
  static constexpr size_t W_BYTES = 2 * F * WS;
  static constexpr size_t CT_BYTES = 2 * F * CTS;
  static constexpr size_t TAP_BYTES = 4 * KP;
  static constexpr size_t IN_BYTES = 2 * kC * IN_H * IN_W;
  static constexpr size_t SMEM = W_BYTES + CT_BYTES + TAP_BYTES + IN_BYTES;
  static_assert(F % 8 == 0 && FPW % Q == 0, "fragments go Q at a time");
  static_assert(CTS >= NPIX && W_BYTES % 16 == 0 && CT_BYTES % 16 == 0, "layout");
};

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Element i ([c][row][col]) of the input tile whose first input row and
// column are iy0 and ix0, from image xn; zero outside the image.
template <int K, bool POOL, int F>
__device__ __forceinline__ __nv_bfloat16 input_at(const __nv_bfloat16* __restrict__ xn, int iy0,
                                                  int ix0, int i, int H, int W) {
  using G = MGeom<K, POOL, F>;
  const int col = i % G::IN_W;
  const int r = (i / G::IN_W) % G::IN_H;
  const int c = i / (G::IN_W * G::IN_H);
  const int gy = iy0 + r, gx = ix0 + col;
  return (gy >= 0 && gy < H && gx >= 0 && gx < W) ? xn[(static_cast<size_t>(c) * H + gy) * W + gx]
                                                  : __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int K, bool POOL, int F>
__global__ void __launch_bounds__(kThreads, 2)
stem_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ gain, const float* __restrict__ bias,
                __nv_bfloat16* __restrict__ out, int N, int H, int W, int Hc, int Wc, int Ho,
                int Wo, int act) {
  using G = MGeom<K, POOL, F>;
  constexpr int NT = G::NT, Q = G::Q;
  constexpr int pad = K / 2;
  extern __shared__ float4 smem_raw[];
  auto* w_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);                 // [f][WS]
  auto* ct_s = reinterpret_cast<__nv_bfloat16*>(
      reinterpret_cast<char*>(smem_raw) + G::W_BYTES);                     // [f][CTS]
  auto* tap_s = reinterpret_cast<int*>(
      reinterpret_cast<char*>(smem_raw) + G::W_BYTES + G::CT_BYTES);      // [KP]
  auto* in_s = reinterpret_cast<__nv_bfloat16*>(
      reinterpret_cast<char*>(tap_s) + G::TAP_BYTES);                     // [c][IN_H][IN_W]

  const int tid = threadIdx.x;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  // weights and tap offsets once per block: the grid is persistent
  for (int i = tid; i < F * G::KP; i += kThreads) {
    const int f = i / G::KP, k = i % G::KP;
    w_s[f * G::WS + k] = k < G::KK ? w[f * G::KK + k] : zero;
  }
  for (int k = tid; k < G::KP; k += kThreads) {
    const int c = k / (K * K), r = k % (K * K);
    // padded k: any in-tile offset (its weights are zero)
    tap_s[k] = k < G::KK ? (c * G::IN_H + r / K) * G::IN_W + r % K : 0;
  }
  const int tiles_x = (Wo + G::OW - 1) / G::OW, tiles_y = (Ho + G::OH - 1) / G::OH;
  const int tiles = tiles_x * tiles_y * N;
  // tile t's image and first conv row/col (-1 halo with the pool)
  auto origin = [&](int t, int& n, int& crow0, int& ccol0) {
    const int bx = t % tiles_x, by = (t / tiles_x) % tiles_y;
    n = t / (tiles_x * tiles_y);
    crow0 = POOL ? 2 * by * G::OH - 1 : by * G::OH;
    ccol0 = POOL ? 2 * bx * G::OW - 1 : bx * G::OW;
  };
  // The 3x3 stem's next input tile is loaded into registers while this
  // tile computes (staging it was half of that stem's time); the larger
  // tiles (the pool's, the 7x7's) would not fit the register budget.
  constexpr int kIn = kC * G::IN_H * G::IN_W;
  constexpr bool kPrefetch = !POOL && kIn <= 16 * kThreads;
  constexpr int kPre = kPrefetch ? (kIn + kThreads - 1) / kThreads : 1;
  __nv_bfloat16 pre[kPre];
  auto prefetch = [&](int t) {
    int n, crow0, ccol0;
    origin(t, n, crow0, ccol0);
    const __nv_bfloat16* xn = x + static_cast<size_t>(n) * kC * H * W;
#pragma unroll
    for (int j = 0; j < kPre; ++j) {
      const int i = tid + j * kThreads;
      pre[j] = i < kIn ? input_at<K, POOL, F>(xn, 2 * crow0 - pad, 2 * ccol0 - pad, i, H, W) : zero;
    }
  };
  if constexpr (kPrefetch) {
    if (blockIdx.x < tiles) prefetch(blockIdx.x);
  }
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int bx = tile % tiles_x, by = (tile / tiles_x) % tiles_y;
    int n, crow0, ccol0;
    origin(tile, n, crow0, ccol0);
    __syncthreads();  // the previous tile is out of in_s and ct_s
    if constexpr (!kPrefetch) {
      const __nv_bfloat16* xn = x + static_cast<size_t>(n) * kC * H * W;
      for (int i = tid; i < kIn; i += kThreads)
        in_s[i] = input_at<K, POOL, F>(xn, 2 * crow0 - pad, 2 * ccol0 - pad, i, H, W);
    } else {
#pragma unroll
      for (int j = 0; j < kPre; ++j)
        if (tid + j * kThreads < kIn) in_s[tid + j * kThreads] = pre[j];
    }
    __syncthreads();
    if constexpr (kPrefetch) {
      if (tile + gridDim.x < tiles) prefetch(tile + gridDim.x);
    }

    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
    for (int pair = 0; pair < G::FPW / Q; ++pair) {
      // this thread's GEMM rows: fragment q, rows g and g + 8
      int poff[Q][2];
      bool pok[Q][2];
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = ((warp * G::FPW + Q * pair + q) * 16) + g + 8 * h;
          pok[q][h] = p < G::NPIX;
          const int pp = pok[q][h] ? p : 0;
          poff[q][h] = 2 * (pp / G::CC) * G::IN_W + 2 * (pp % G::CC);
        }
      float acc[Q][NT][4];
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][j][e] = 0.f;

#pragma unroll
      for (int ks = 0; ks < G::KP / 16; ++ks) {
        const int k0 = ks * 16 + 2 * t;
        const int o0 = tap_s[k0], o1 = tap_s[k0 + 1], o2 = tap_s[k0 + 8], o3 = tap_s[k0 + 9];
        uint32_t a[Q][4];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const __nv_bfloat16* r0 = in_s + poff[q][0];
          const __nv_bfloat16* r1 = in_s + poff[q][1];
          a[q][0] = pack_bf16(r0[o0], r0[o1]);
          a[q][1] = pack_bf16(r1[o0], r1[o1]);
          a[q][2] = pack_bf16(r0[o2], r0[o3]);
          a[q][3] = pack_bf16(r1[o2], r1[o3]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const __nv_bfloat16* wr = w_s + (j * 8 + g) * G::WS + k0;
          uint32_t b[2];
          b[0] = *reinterpret_cast<const uint32_t*>(wr);
          b[1] = *reinterpret_cast<const uint32_t*>(wr + 8);
#pragma unroll
          for (int q = 0; q < Q; ++q) mma_bf16(acc[q][j], a[q], b);
        }
      }

      // accumulator e of (q, j): row g + 8*(e/2), feature j*8 + 2t + e%2
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int f = j * 8 + 2 * t + e2;
          const float gf = gain[f], bf = bias[f];
#pragma unroll
          for (int q = 0; q < Q; ++q)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (!pok[q][h]) continue;
              const int p = ((warp * G::FPW + Q * pair + q) * 16) + g + 8 * h;
              float v = activate(fmaf(acc[q][j][2 * h + e2], gf, bf), act);
              if constexpr (POOL) {
                const int cy = crow0 + p / G::CC, cx = ccol0 + p % G::CC;
                if (cy < 0 || cy >= Hc || cx < 0 || cx >= Wc) v = -CUDART_INF_F;
              }
              ct_s[f * G::CTS + p] = __float2bfloat16_rn(v);
            }
        }
      }
    }
    __syncthreads();

    __nv_bfloat16* on = out + static_cast<size_t>(n) * F * Ho * Wo;
    if constexpr (!POOL) {
      // rows of 64 pixels leave as 8 16-byte pieces per feature
      for (int i = tid; i < F * G::OH * (G::OW / 8); i += kThreads) {
        const int piece = i % (G::OW / 8);
        const int r = (i / (G::OW / 8)) % G::OH;
        const int f = i / ((G::OW / 8) * G::OH);
        const int oy = crow0 + r, ox = ccol0 + piece * 8;
        if (oy >= Ho || ox >= Wo) continue;
        const __nv_bfloat16* src = ct_s + f * G::CTS + r * G::OW + piece * 8;
        __nv_bfloat16* dst = on + (static_cast<size_t>(f) * Ho + oy) * Wo + ox;
        if (Wo % 8 == 0) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8 && ox + e < Wo; ++e) dst[e] = src[e];
        }
      }
    } else {
      const int py0 = by * G::OH, px0 = bx * G::OW;
      for (int i = tid; i < F * G::OH * G::OW; i += kThreads) {
        const int pc = i % G::OW;
        const int pr = (i / G::OW) % G::OH;
        const int f = i / (G::OW * G::OH);
        const int py = py0 + pr, px = px0 + pc;
        if (py >= Ho || px >= Wo) continue;
        const __nv_bfloat16* win = ct_s + f * G::CTS + 2 * pr * G::CC + 2 * pc;
        float m = -CUDART_INF_F;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, __bfloat162float(win[dy * G::CC + dx]));
        on[(static_cast<size_t>(f) * Ho + py) * Wo + px] = __float2bfloat16_rn(m);
      }
    }
  }
}

// The shared-memory attribute is per device, so it is set on every launch;
// sms is the launching device's SM count.
template <int K, bool POOL, int F>
cudaError_t launch_mma(const void* x, const void* w, const float* gain, const float* bias,
                       void* out, int n, int h, int wd, int act, int sms, cudaStream_t stream) {
  using G = MGeom<K, POOL, F>;
  const int hc = (h - 1) / 2 + 1, wc = (wd - 1) / 2 + 1;
  const int ho = POOL ? (hc - 1) / 2 + 1 : hc;
  const int wo = POOL ? (wc - 1) / 2 + 1 : wc;
  auto kern = stem_mma_kernel<K, POOL, F>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(G::SMEM));
  if (err != cudaSuccess) return err;
  const int max_blocks = 2 * sms;  // the persistent grid: two blocks per SM
  const int tiles = ((wo + G::OW - 1) / G::OW) * ((ho + G::OH - 1) / G::OH) * n;
  kern<<<tiles < max_blocks ? tiles : max_blocks, kThreads, G::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), gain, bias,
      static_cast<__nv_bfloat16*>(out), n, h, wd, hc, wc, ho, wo, act);
  return cudaGetLastError();
}

// The served combinations, (k, pool, features): 3x3 without the pool at
// each YOLO width, 7x7 with the pool at 64 (the ResNet stem).  The one
// list both the dispatch and ``adas_stem_configs`` read.
#define ADAS_STEM_CONFIGS(X) \
  X(3, false, 16)            \
  X(3, false, 32)            \
  X(3, false, 48)            \
  X(3, false, 64)            \
  X(3, false, 80)            \
  X(7, true, 64)

// BF16 picks the path.
template <bool BF16>
cudaError_t dispatch(const void* x, const void* w, const float* gain, const float* bias,
                     void* out, int n, int h, int wd, int k, int pool, int f, int act, int sms,
                     cudaStream_t s) {
#define ADAS_STEM_CASE(K_, POOL_, F_)                                                      \
  if (k == K_ && pool == POOL_ && f == F_)                                                 \
    return BF16 ? launch_mma<K_, POOL_, F_>(x, w, gain, bias, out, n, h, wd, act, sms, s)   \
                : launch_f32<K_, POOL_, F_>(x, w, gain, bias, out, n, h, wd, act, s);
  ADAS_STEM_CONFIGS(ADAS_STEM_CASE)
#undef ADAS_STEM_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry for ctypes.  f: output features.  dtype: 0 = f32,
// 1 = bf16.  act: 0 none, 1 relu, 2 silu.  sms: the launching device's SM
// count (sizes the bf16 persistent grid).  Launches on ``stream`` and
// returns cudaGetLastError() (cudaErrorInvalidValue for a configuration
// that is not instantiated); never synchronises.
extern "C" int adas_stem_forward(const void* x, const void* w,
                                 const float* gain, const float* bias,
                                 void* out, int n, int h, int wd, int k,
                                 int pool, int f, int act, int dtype, int sms, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || act < 0 || act > 2 || sms <= 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<false>(x, w, gain, bias, out, n, h, wd, k, pool, f, act, sms, s);
  if (dtype == 1) return dispatch<true>(x, w, gain, bias, out, n, h, wd, k, pool, f, act, sms, s);
  return cudaErrorInvalidValue;
}

// The instantiated (k, pool, features) combinations, as consecutive int
// triples in ``out`` (room for ``cap`` triples); returns their number.
extern "C" int adas_stem_configs(int* out, int cap) {
  int i = 0;
#define ADAS_STEM_CONFIG(K_, POOL_, F_) \
  if (i < cap) {                        \
    out[3 * i] = K_;                    \
    out[3 * i + 1] = POOL_;             \
    out[3 * i + 2] = F_;                \
  }                                     \
  ++i;
  ADAS_STEM_CONFIGS(ADAS_STEM_CONFIG)
#undef ADAS_STEM_CONFIG
  return i;
}
