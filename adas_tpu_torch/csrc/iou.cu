// Pairwise IoU of a box set, in two output modes, from boxes (B, N, 4) f32
// xyxy, with iou(i, j) = union > 0 ? inter / union : 0 and the VOC "+1"
// width and height when plus_one is set:
//  * matrix mode: iou (B, N, N) f32, for the soft methods and nms_scan;
//  * mask mode: mask (B, N, ceil(N/32)) int32, bit k of mask[b, i, w] set
//    when iou(i, 32 w + k) > threshold (bits past N zero), for the hard
//    walk of csrc/nms.cu, which reads nothing else of the matrix.
//
// Replaces the TPU kernel adas_tpu/ops/pallas_iou.py::_iou_kernel (entry
// iou_matrix).  That kernel fills 128 x 128 output tiles in order on one
// core, from coordinates carried transposed in (8, 128) blocks so that the
// box index fills the VPU's lanes.  Here every block of threads owns one
// 64-row x 128-column tile of one batch entry, and the blocks run in
// parallel.
//
// What bounds it on an H100: in matrix mode the write of B*N*N f32 (8 MB at
// B = 8, N = 512: 2.5 us at 3.35 TB/s); in mask mode, 32x less output
// (256 KB), the ~16 f32 operations per pair (a division among them).  At
// serving sizes the launch itself is a large part of either.
//
// What the design does about it:
//  * 512 threads, each computing a 4-row x 4-column patch: the 64 row
//    boxes and their areas are staged once per block in shared memory, and
//    each thread keeps its 4 column boxes and areas in registers.
//  * Matrix mode: a thread's 4 columns are adjacent, so a warp writes a
//    row's 128 columns as 16-byte float4 streaming stores (__stcs: the
//    matrix is read at most once, by the scan); a row that is not 16-byte
//    aligned (N % 4 != 0) or runs past N takes scalar stores.
//  * Mask mode: a thread's 4 columns are 32 apart, so lane k of a warp
//    holds column 32 w + k of each of the tile's 4 words and __ballot_sync
//    packs a word in one instruction; lanes 0-3 store a row's 4 words.
//  * Every product, sum and the division are rounded on their own
//    (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), in the reference's
//    operand order, so nvcc contracts nothing into an FMA and the result is
//    the plain PyTorch version's to the bit.  The matrix is then symmetric
//    to the bit, and row i equals the reference's iou_row(boxes, boxes[i]).
//    A zero intersection skips the division (0 / union is +0, and
//    __fdiv_rn takes its slow routine for a zero dividend).
// No tensor cores are involved.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;     // tile rows
constexpr int kCols = 128;    // tile columns: 4 per lane, 4 mask words
constexpr int kThreads = 512;
constexpr int kRowStep = kThreads / 32;        // 16: a warp per row
constexpr int kPatch = kRows / kRowStep;       // 4 rows (and 4 columns) a thread

__device__ __forceinline__ float area(float4 b, float off) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), off), __fadd_rn(__fsub_rn(b.w, b.y), off));
}

__device__ __forceinline__ float iou(float4 rb, float ra, float4 cb, float ca, float off) {
  const float w = fmaxf(__fadd_rn(__fsub_rn(fminf(rb.z, cb.z), fmaxf(rb.x, cb.x)), off), 0.f);
  const float h = fmaxf(__fadd_rn(__fsub_rn(fminf(rb.w, cb.w), fmaxf(rb.y, cb.y)), off), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(ra, ca), inter);
  return uni > 0.f && inter != 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

// MASK = false: out is (B, N, N) f32; MASK = true: out is (B, N, words)
// int32 and thr the f32 threshold.
template <bool MASK>
__global__ void __launch_bounds__(kThreads)
iou_kernel(const float4* __restrict__ boxes, void* __restrict__ out, int n, int words,
           float off, float thr) {
  __shared__ float4 rows[kRows];
  __shared__ float row_area[kRows];

  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kRows;
  const int c0 = blockIdx.x * kCols;
  const float4* bx = boxes + static_cast<size_t>(b) * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x < kRows) {
    const int r = r0 + threadIdx.x;
    const float4 v = r < n ? bx[r] : make_float4(0.f, 0.f, 0.f, 0.f);
    rows[threadIdx.x] = v;
    row_area[threadIdx.x] = area(v, off);
  }
  // this thread's columns: adjacent (matrix) or a warp's width apart (mask)
  float4 cb[kPatch];
  float ca[kPatch];
#pragma unroll
  for (int k = 0; k < kPatch; ++k) {
    const int c = MASK ? c0 + 32 * k + lane : c0 + kPatch * lane + k;
    cb[k] = c < n ? bx[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    ca[k] = area(cb[k], off);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kPatch; ++i) {
    const int tr = warp + i * kRowStep;  // the same row for the whole warp
    const int r = r0 + tr;
    if (r >= n) break;
    const float4 rb = rows[tr];
    const float ra = row_area[tr];
    float u[kPatch];
#pragma unroll
    for (int k = 0; k < kPatch; ++k) u[k] = iou(rb, ra, cb[k], ca[k], off);
    if (MASK) {
      unsigned word[kPatch];
#pragma unroll
      for (int k = 0; k < kPatch; ++k)
        word[k] = __ballot_sync(0xffffffffu, c0 + 32 * k + lane < n && u[k] > thr);
      const int w = (c0 >> 5) + lane;
      if (lane < kPatch && w < words) {
        const unsigned v = lane == 0 ? word[0] : lane == 1 ? word[1] : lane == 2 ? word[2]
                                                                                   : word[3];
        static_cast<unsigned*>(out)[(static_cast<size_t>(b) * n + r) * words + w] = v;
      }
    } else {
      const int c = c0 + kPatch * lane;
      float* o = static_cast<float*>(out) + (static_cast<size_t>(b) * n + r) * n + c;
      if ((n & 3) == 0 && c + kPatch <= n) {
        __stcs(reinterpret_cast<float4*>(o), make_float4(u[0], u[1], u[2], u[3]));
      } else {
#pragma unroll
        for (int k = 0; k < kPatch; ++k)
          if (c + k < n) __stcs(o + k, u[k]);
      }
    }
  }
}

template <bool MASK>
int launch(const void* boxes, void* out, int batch, int n, int plus_one, float thr,
           void* stream) {
  if (batch <= 0 || n <= 0 || batch > 65535) return cudaErrorInvalidValue;
  const int row_tiles = (n + kRows - 1) / kRows;
  if (row_tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid((n + kCols - 1) / kCols, row_tiles, batch);
  iou_kernel<MASK><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), out, n, (n + 31) / 32, plus_one ? 1.f : 0.f, thr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// boxes: (B, N, 4) f32 contiguous; out: (B, N, N) f32 contiguous.
// Returns the launch's cudaError_t (0 on success).
extern "C" int adas_iou_matrix(const void* boxes, void* out, int batch, int n, int plus_one,
                               void* stream) {
  return launch<false>(boxes, out, batch, n, plus_one, 0.f, stream);
}

// boxes: (B, N, 4) f32 contiguous; mask: (B, N, ceil(N/32)) int32
// contiguous; threshold: the IoU threshold as an f32.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int adas_iou_mask(const void* boxes, void* mask, int batch, int n, int plus_one,
                             float threshold, void* stream) {
  return launch<true>(boxes, mask, batch, n, plus_one, threshold, stream);
}
