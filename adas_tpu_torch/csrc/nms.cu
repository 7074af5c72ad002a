// Greedy selection scan of fixed-shape NMS / soft-NMS, one stream per block:
// iou (B, N, N) f32, scores (B, N) f32 -> picked indices (B, max_out) int64
// in selection order, padded with -1.
//
// Replaces the lax.scan of adas_tpu/ops/nms.py::_select_loop (the step at
// nms.py:111), which the JAX package leaves to XLA: min(max_out, N)
// sequential steps, each an argmax over the live scores, a threshold test,
// and a rescoring of the boxes still in play with one row of the IoU
// matrix (hard: weight 0 above the IoU threshold; linear: 1 - iou above
// it; gaussian: exp(-iou^2 / sigma) everywhere).  The plain PyTorch version
// is a Python loop of ~10 launches per step, ~1,000 per tick at max_out =
// 100; this kernel is one launch per tick.
//
// What bounds it on an H100: the chain of dependent steps, each a
// block-wide reduction with two barriers (a few microseconds per step at
// N = 512), not bytes or flops.  The IoU rows it reads (2 KB per step at
// N = 512) come from L2, where the IoU kernel has just written the matrix.
//
// What the design does about it:
//  * One block per stream (N <= 1024 threads, one candidate per thread):
//    each thread keeps its candidate's live score and active flag in
//    registers, and the argmax goes through warp shuffles and one shared-
//    memory exchange, ties to the lowest index as jnp.argmax.
//  * Once the best live score is at or below score_threshold, every later
//    step of the reference yields -1 (its active mask is all false), so the
//    block writes the -1 padding and stops.
//  * The rescoring is rounded as the reference rounds it (__fmul_rn,
//    __fsub_rn, __fdiv_rn, and expf without fast math), so the kernel picks
//    what the plain version picks.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxN = 1024;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF for inactive boxes

enum Method { kHard = 0, kLinear = 1, kGaussian = 2 };

// (v, i) pair order of jnp.argmax: the larger value, then the lower index
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kMaxN)
nms_scan_kernel(const float* __restrict__ iou, const float* __restrict__ scores,
                long long* __restrict__ out, int n, int steps, int max_out, int method,
                float iou_threshold, float sigma, float score_threshold) {
  __shared__ float warp_v[32];
  __shared__ int warp_i[32];
  __shared__ int s_pick;
  __shared__ int s_ok;

  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const int n_warps = blockDim.x >> 5;
  const bool in = j < n;
  const float* row0 = iou + static_cast<size_t>(b) * n * n;
  long long* o = out + static_cast<size_t>(b) * max_out;

  float live = in ? scores[static_cast<size_t>(b) * n + j] : 0.f;
  bool active = in && live > score_threshold;

  int step = 0;
  for (; step < steps; ++step) {
    // masked = where(active, live, NEG_INF); threads past N never win
    float v = in ? (active ? live : kNegInf) : -CUDART_INF_F;
    int i = j;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      take_better(v, i, __shfl_down_sync(0xffffffffu, v, off),
                  __shfl_down_sync(0xffffffffu, i, off));
    }
    if (lane == 0) {
      warp_v[warp] = v;
      warp_i[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < n_warps ? warp_v[lane] : -CUDART_INF_F;
      i = lane < n_warps ? warp_i[lane] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        take_better(v, i, __shfl_down_sync(0xffffffffu, v, off),
                    __shfl_down_sync(0xffffffffu, i, off));
      }
      if (lane == 0) {
        const bool ok = v > score_threshold;
        s_pick = i;
        s_ok = ok;
        o[step] = ok ? i : -1;
      }
    }
    __syncthreads();
    const int pick = s_pick;
    if (!s_ok) break;  // uniform across the block
    if (in) {
      const float u = row0[static_cast<size_t>(pick) * n + j];
      float w;
      if (method == kLinear) {
        w = u > iou_threshold ? __fsub_rn(1.f, u) : 1.f;
      } else if (method == kGaussian) {
        w = expf(__fdiv_rn(-__fmul_rn(u, u), sigma));
      } else {
        w = u > iou_threshold ? 0.f : 1.f;
      }
      if (active) live = __fmul_rn(live, w);
      if (j == pick) active = false;
    }
  }
  // a step that found nothing wrote its own -1; the rest is padding
  for (int s = (step < steps ? step + 1 : steps) + j; s < max_out; s += blockDim.x) o[s] = -1;
}

}  // namespace

// iou: (B, N, N) f32; scores: (B, N) f32; out: (B, max_out) int64; all
// contiguous.  Returns the launch's cudaError_t (0 on success).
extern "C" int adas_nms_scan(const void* iou, const void* scores, void* out, int batch, int n,
                             int max_out, int method, float iou_threshold, float sigma,
                             float score_threshold, void* stream) {
  if (batch <= 0 || n <= 0 || n > kMaxN || max_out <= 0 || method < 0 || method > 2)
    return cudaErrorInvalidValue;
  const int threads = (n + 31) / 32 * 32;
  const int steps = max_out < n ? max_out : n;
  nms_scan_kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(iou), static_cast<const float*>(scores),
      static_cast<long long*>(out), n, steps, max_out, method, iou_threshold, sigma,
      score_threshold);
  return static_cast<int>(cudaGetLastError());
}
