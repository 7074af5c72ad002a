// Greedy selection of fixed-shape NMS / soft-NMS, one stream per block, in
// two kernels:
//  * the walk (hard suppression with score_threshold >= 0, the serving
//    path): mask (B, N, ceil(N/32)) int32 from the IoU kernel's mask mode,
//    scores (B, N) f32 -> picked indices (B, max_out) int64;
//  * the rescoring scan (linear, gaussian, and hard with a negative score
//    threshold): iou (B, N, N) f32, scores (B, N) f32 -> the same.
// Both give indices in selection order, padded with -1.
//
// Replaces the lax.scan of adas_tpu/ops/nms.py::_select_loop (the step at
// nms.py:111), which the JAX package leaves to XLA: min(max_out, N)
// sequential steps, each an argmax over the live scores, a threshold test,
// and a rescoring of the boxes still in play with one row of the IoU
// matrix (hard: weight 0 above the IoU threshold; linear: 1 - iou above
// it; gaussian: exp(-iou^2 / sigma) everywhere).
//
// What bounds it on an H100: the chain of dependent steps, not bytes or
// flops (the scan's IoU rows and the walk's mask come from L2, where the
// IoU kernel has just written them: a few KB per pick, 32 KB per stream
// at N = 512).  The scan pays a block-wide argmax, a barrier and an L2
// read per step; the walk one warp's chain per pick, a bit scan, a
// shuffle and a few logic operations.
//
// Why the walk is exact.  Under hard suppression, live * weight leaves an
// unsuppressed box's score unchanged (x 1.0 exactly) and turns a
// suppressed box's finite score into +0.  A suppressed box stays "active"
// in the reference, but with score_threshold >= 0 a +0 never passes
// best > score_threshold, and every unsuppressed active box (score above
// the threshold, so above 0) outranks it.  So each step's argmax is the
// first unsuppressed, unpicked active box in the reference's order (score
// descending, then index ascending, as jnp.argmax breaks ties), and once
// none is left every later step yields -1.  Boxes whose score is not above
// the threshold (NaN included) are never active.  One more case: a
// suppressed +inf score becomes inf * 0 = NaN, the next step's argmax is
// that NaN, and from then on the reference yields only -1; the walk stops
// after the pick that suppressed it.  With score_threshold < 0 a
// suppressed 0 could outrank a negative score, so that case keeps the scan.
//
// What the walk's design does about its chain:
//  * The block stages the stream's mask rows in shared memory with
//    cp.async (32 KB at N = 512, 128 KB at N = 1024) while it ranks the
//    candidates; when the active candidates already stand in rank order
//    (a prefix of non-increasing scores, as the top-k sort hands them
//    over) the ranking is skipped.
//  * One warp walks, with no block barrier.  When the candidates stand in
//    rank order (the serving path), it goes word by word through the live
//    bits: picks + N/32 iterations rather than N.  Within a word the chain
//    from one pick to the next is __clz (on bit-reversed words), one
//    shuffle (lane k holds the word's part of box 32 w + k's row) and two
//    logic operations; a word's removed bits are gathered once,
//    from its part of the earlier picks' rows (a load per lane per 32
//    picks and a warp OR), instead of ORing every picked row into every
//    word.  Otherwise the walk visits the candidates in rank order, 32
//    indices fetched at once, with the removed set (N/32 <= 32 words, one
//    per lane) in registers: a shuffle tests a candidate's bit, and a pick
//    ORs every lane's word of its row into the set.
//
// What the scan's design does: one block per stream (N <= 1024 threads,
// one candidate per thread), each thread keeping its candidate's live
// score and active flag in registers; per step a warp-shuffle argmax
// (ties to the lowest index), the warps' results in double-buffered
// slots, and one barrier after which every warp reduces the slots itself.
// Once the best live score is at or below score_threshold every later step
// yields -1, so the block stops.  The rescoring is rounded as the
// reference rounds it (__fmul_rn, __fsub_rn, __fdiv_rn, and expf without
// fast math), so the kernel picks what the plain version picks.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxN = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF for inactive boxes

enum Method { kHard = 0, kLinear = 1, kGaussian = 2 };

// (v, i) pair order of jnp.argmax: the larger value, then the lower index
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    take_better(v, i, __shfl_down_sync(kFull, v, off), __shfl_down_sync(kFull, i, off));
}

__global__ void __launch_bounds__(kMaxN)
nms_scan_kernel(const float* __restrict__ iou, const float* __restrict__ scores,
                long long* __restrict__ out, int n, int steps, int max_out, int method,
                float iou_threshold, float sigma, float score_threshold) {
  __shared__ float warp_v[2][32];
  __shared__ int warp_i[2][32];

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
    const int buf = step & 1;
    // masked = where(active, live, NEG_INF); threads past N never win
    float v = in ? (active ? live : kNegInf) : -CUDART_INF_F;
    int i = j;
    warp_argmax(v, i);
    if (lane == 0) {
      warp_v[buf][warp] = v;
      warp_i[buf][warp] = i;
    }
    // one barrier per step: a warp writes the other buffer next step only
    // after every warp has passed this barrier, done reading it
    __syncthreads();
    v = lane < n_warps ? warp_v[buf][lane] : -CUDART_INF_F;
    i = lane < n_warps ? warp_i[buf][lane] : 0x7fffffff;
    warp_argmax(v, i);
    const int pick = __shfl_sync(kFull, i, 0);
    const bool ok = __shfl_sync(kFull, v, 0) > score_threshold;
    if (j == 0) o[step] = ok ? pick : -1;
    if (!ok) break;  // uniform across the block
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

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// Shared memory of the walk: keys and rank order (N rounded up to 4 each,
// so that the mask rows after them are 16-byte aligned), then the rows.
__host__ __device__ __forceinline__ int walk_pad(int n) { return (n + 3) & ~3; }

size_t walk_smem_bytes(int n, int words) {
  return (2 * static_cast<size_t>(walk_pad(n)) + static_cast<size_t>(n) * words) * 4;
}

__global__ void __launch_bounds__(kMaxN)
nms_walk_kernel(const unsigned* __restrict__ mask, const float* __restrict__ scores,
                long long* __restrict__ out, int n, int words, int max_out,
                float score_threshold) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pad = walk_pad(n);
  float* s_key = reinterpret_cast<float*>(smem);
  int* s_order = reinterpret_cast<int*>(s_key + pad);
  unsigned* s_rows = reinterpret_cast<unsigned*>(s_order + pad);
  __shared__ unsigned s_act[32], s_inf[32];
  __shared__ int s_picks;

  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const float s = j < n ? scores[static_cast<size_t>(b) * n + j] : 0.f;

  // 1. stage the rows; the copies land while the block ranks
  const unsigned* src = mask + static_cast<size_t>(b) * n * words;
  const int total = n * words;
  if ((total & 3) == 0) {  // every stream's rows start 16-byte aligned
    for (int e = 4 * j; e < total; e += 4 * blockDim.x) cp_async16(s_rows + e, src + e);
  } else {
    for (int e = j; e < total; e += blockDim.x) cp_async4(s_rows + e, src + e);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // 2. the active set (score above the threshold; NaN never is), as keys
  // and as per-word bit sets
  const bool active = j < n && s > score_threshold;
  if (j < pad) s_key[j] = active ? s : -CUDART_INF_F;
  const unsigned act = __ballot_sync(kFull, active);
  const unsigned inf = __ballot_sync(kFull, active && s == CUDART_INF_F);
  if (lane == 0) {
    s_act[warp] = act;
    s_inf[warp] = inf;
  }
  __syncthreads();

  // 3. rank order: score descending, then index ascending.  The active
  // candidates already stand in it when they form a prefix of
  // non-increasing scores (an inactive key is -inf); with no +inf score
  // among them the walk takes its word-by-word path and needs no ranks.
  const bool in_order = !active || (s != CUDART_INF_F && (j == 0 || s_key[j - 1] >= s));
  const bool by_word = __syncthreads_and(in_order);
  if (!by_word && active) {
    int rank = 0;
    const float4* k4 = reinterpret_cast<const float4*>(s_key);
    for (int q = 0; q < pad / 4; ++q) {
      const float4 k = k4[q];
      const int i = 4 * q;
      rank += (k.x > s || (k.x == s && i < j)) + (k.y > s || (k.y == s && i + 1 < j)) +
              (k.z > s || (k.z == s && i + 2 < j)) + (k.w > s || (k.w == s && i + 3 < j));
    }
    s_order[rank] = j;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 4. one warp walks
  long long* o = out + static_cast<size_t>(b) * max_out;
  if (warp == 0) {
    const unsigned act_l = lane < words ? s_act[lane] : 0u;  // lane l: word l's active bits
    int picks = 0;
    if (by_word) {
      // word by word, the picks so far listed in s_order (no ranks here).
      // A word's removed bits are its part of the earlier picks' rows, one
      // load per lane per 32 picks and a warp OR.  Within a word the bits
      // are reversed, so that the lowest live box is __clz of the live
      // bits, and lane k holds the word's part of box 32 w + k's row, so
      // that a pick's effect on the word is one shuffle.
      int* s_pk = s_order;
      unsigned act_r = __brev(__shfl_sync(kFull, act_l, 0));
      unsigned sup_r = __brev(lane < n ? s_rows[lane * words] : 0u);
      for (int cw = 0; cw < words && act_r != 0u; ++cw) {
        // the next word's active bits and row parts, loaded ahead of need
        const int nw = cw + 1 < words ? cw + 1 : cw;
        const int next = (nw << 5) + lane;
        const unsigned next_act_r = __brev(__shfl_sync(kFull, act_l, nw));
        const unsigned next_sup_r = __brev(next < n ? s_rows[next * words + nw] : 0u);
        unsigned part = 0u;
        for (int i = lane; i < picks; i += 32) part |= s_rows[s_pk[i] * words + cw];
        unsigned cur_r = __brev(__reduce_or_sync(kFull, part));
        unsigned picked_r = 0u;
        int room = max_out - picks;
        for (unsigned live = act_r & ~cur_r; live != 0u && room > 0; live = act_r & ~cur_r) {
          const int k = __clz(live);
          const unsigned bit = 0x80000000u >> k;
          cur_r |= __shfl_sync(kFull, sup_r, k) | bit;
          picked_r |= bit;
          --room;
        }
        const unsigned picked = __brev(picked_r);
        if ((picked >> lane) & 1u) {
          const int at = picks + __popc(picked & ((1u << lane) - 1u));
          s_pk[at] = (cw << 5) + lane;
          o[at] = (cw << 5) + lane;
        }
        picks += __popc(picked);
        __syncwarp();
        if (room == 0) break;
        act_r = next_act_r;
        sup_r = next_sup_r;
      }
    } else {
      // in rank order, 32 indices fetched at once, a shuffle testing each
      // one's bit; lane l holds word l of the removed set (picked or
      // suppressed boxes), and the picks in batches of 32 (lane k the
      // k-th).  A pick that suppresses an active +inf score ends the walk
      // (see the note above).
      const unsigned inf_l = lane < words ? s_inf[lane] : 0u;
      const bool any_inf = __any_sync(kFull, inf_l != 0u);
      const int n_active = __reduce_add_sync(kFull, __popc(act_l));
      unsigned removed = 0u;
      int held = -1;
      bool stop = false;
      for (int r0 = 0; r0 < n_active && !stop; r0 += 32) {
        const int next = r0 + lane < n_active ? s_order[r0 + lane] : 0;
        const int cnt = min(32, n_active - r0);
        for (int k = 0; k < cnt && !stop; ++k) {
          const int p = __shfl_sync(kFull, next, k);
          const unsigned bit = lane == (p >> 5) ? 1u << (p & 31) : 0u;
          if ((__shfl_sync(kFull, removed, p >> 5) >> (p & 31)) & 1u) continue;
          const unsigned row = lane < words ? s_rows[p * words + lane] : 0u;
          if (any_inf) stop = __any_sync(kFull, (row & ~(removed | bit) & inf_l) != 0u);
          removed |= bit | row;
          held = lane == (picks & 31) ? p : held;
          if ((++picks & 31) == 0) o[picks - 32 + lane] = held;
          stop = stop || picks == max_out;
        }
      }
      if (lane < (picks & 31)) o[(picks & ~31) + lane] = held;
    }
    if (lane == 0) s_picks = picks;
  }
  __syncthreads();
  for (int q = s_picks + j; q < max_out; q += blockDim.x) o[q] = -1;
}

int threads_for(int n) { return (n + 31) / 32 * 32; }

}  // namespace

// iou: (B, N, N) f32; scores: (B, N) f32; out: (B, max_out) int64; all
// contiguous.  Returns the launch's cudaError_t (0 on success).
extern "C" int adas_nms_scan(const void* iou, const void* scores, void* out, int batch, int n,
                             int max_out, int method, float iou_threshold, float sigma,
                             float score_threshold, void* stream) {
  if (batch <= 0 || n <= 0 || n > kMaxN || max_out <= 0 || method < 0 || method > 2)
    return cudaErrorInvalidValue;
  const int steps = max_out < n ? max_out : n;
  nms_scan_kernel<<<batch, threads_for(n), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(iou), static_cast<const float*>(scores),
      static_cast<long long*>(out), n, steps, max_out, method, iou_threshold, sigma,
      score_threshold);
  return static_cast<int>(cudaGetLastError());
}

// mask: (B, N, ceil(N/32)) int32 (csrc/iou.cu's mask mode); scores: (B, N)
// f32; out: (B, max_out) int64; all contiguous; score_threshold >= 0.
// Sets the kernel's dynamic shared-memory size on every launch (the
// attribute is per device).  Returns the cudaError_t (0 on success).
extern "C" int adas_nms_walk(const void* mask, const void* scores, void* out, int batch, int n,
                             int max_out, float score_threshold, void* stream) {
  if (batch <= 0 || n <= 0 || n > kMaxN || max_out <= 0 || !(score_threshold >= 0.f))
    return cudaErrorInvalidValue;
  const int words = (n + 31) / 32;
  const size_t smem = walk_smem_bytes(n, words);
  cudaError_t err = cudaFuncSetAttribute(
      nms_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  nms_walk_kernel<<<batch, threads_for(n), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(mask), static_cast<const float*>(scores),
      static_cast<long long*>(out), n, words, max_out, score_threshold);
  return static_cast<int>(cudaGetLastError());
}
