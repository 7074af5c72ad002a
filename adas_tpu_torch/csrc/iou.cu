// Pairwise IoU matrix: boxes (B, N, 4) f32 xyxy -> iou (B, N, N) f32,
// iou[b, i, j] = union > 0 ? inter / union : 0, with the VOC "+1" width and
// height when plus_one is set.
//
// Replaces the TPU kernel adas_tpu/ops/pallas_iou.py::_iou_kernel (entry
// iou_matrix).  That kernel fills 128 x 128 output tiles in order on one
// core, from coordinates carried transposed in (8, 128) blocks so that the
// box index fills the VPU's lanes.  Here every block of threads owns one
// 64 x 64 output tile of one batch entry, and the blocks run in parallel.
//
// What bounds it on an H100: the write of B*N*N f32 (8 MB at B = 8,
// N = 512: about 3 us of device memory bandwidth).  The arithmetic is ~15
// flops per output and the reads are 32 bytes per tile row and column, so
// at serving sizes the launch itself is most of the cost.
//
// What the design does about it:
//  * Each block stages its 64 row boxes and 64 column boxes in shared
//    memory, with each box's area computed once there.
//  * 256 threads: a thread owns one column and 16 rows of the tile, so a
//    warp's stores are 32 consecutive floats (128-byte coalesced lines).
//  * The ragged edge (N not a multiple of 64) is masked in the kernel.
//  * Every product, sum and the division are rounded on their own
//    (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), in the reference's
//    operand order, so nvcc contracts nothing into an FMA and the result is
//    the plain PyTorch version's to the bit.  The matrix is then symmetric
//    to the bit, and row i equals the reference's iou_row(boxes, boxes[i]).
// No tensor cores are involved.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kTile * kTile / kThreads;  // 16
constexpr int kRowStride = kThreads / kTile;              // 4

__device__ __forceinline__ float area(float4 b, float off) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), off), __fadd_rn(__fsub_rn(b.w, b.y), off));
}

__global__ void __launch_bounds__(kThreads)
iou_kernel(const float4* __restrict__ boxes, float* __restrict__ out, int n, float off) {
  __shared__ float4 rows[kTile];
  __shared__ float4 cols[kTile];
  __shared__ float row_area[kTile];
  __shared__ float col_area[kTile];

  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  const float4* bx = boxes + static_cast<size_t>(b) * n;
  const int t = threadIdx.x;
  if (t < kTile) {
    const int r = r0 + t;
    const float4 v = r < n ? bx[r] : make_float4(0.f, 0.f, 0.f, 0.f);
    rows[t] = v;
    row_area[t] = area(v, off);
  } else if (t < 2 * kTile) {
    const int c = c0 + t - kTile;
    const float4 v = c < n ? bx[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    cols[t - kTile] = v;
    col_area[t - kTile] = area(v, off);
  }
  __syncthreads();

  const int tc = t % kTile;
  const int c = c0 + tc;
  if (c >= n) return;
  const float4 cb = cols[tc];
  const float ca = col_area[tc];
  float* orow = out + (static_cast<size_t>(b) * n + r0) * n + c;
#pragma unroll 4
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int tr = t / kTile + k * kRowStride;
    if (r0 + tr >= n) break;
    const float4 rb = rows[tr];
    const float w = fmaxf(__fadd_rn(__fsub_rn(fminf(rb.z, cb.z), fmaxf(rb.x, cb.x)), off), 0.f);
    const float h = fmaxf(__fadd_rn(__fsub_rn(fminf(rb.w, cb.w), fmaxf(rb.y, cb.y)), off), 0.f);
    const float inter = __fmul_rn(w, h);
    const float uni = __fsub_rn(__fadd_rn(row_area[tr], ca), inter);
    orow[static_cast<size_t>(tr) * n] = uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
  }
}

}  // namespace

// boxes: (B, N, 4) f32 contiguous; out: (B, N, N) f32 contiguous.
// Returns the launch's cudaError_t (0 on success).
extern "C" int adas_iou_matrix(const void* boxes, void* out, int batch, int n, int plus_one,
                               void* stream) {
  if (batch <= 0 || n <= 0 || batch > 65535) return cudaErrorInvalidValue;
  const int tiles = (n + kTile - 1) / kTile;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(tiles, tiles, batch);
  iou_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<float*>(out), n, plus_one ? 1.f : 0.f);
  return static_cast<int>(cudaGetLastError());
}
