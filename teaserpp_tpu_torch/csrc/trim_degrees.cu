// Batched TRIM-graph degrees with the pair predicate never stored.
//
// Replaces teaserpp_tpu/ops/pallas_kernels.py::trim_degrees_pallas (body
// _trim_deg_kernel), with a batch axis:
//
//   deg[b, j] = #{ i != j : pred_b(i, j) },
//
// pred the sqrt-free TRIM predicate of trim_pred.cuh, the same instructions
// as trim_bits.cu, so deg equals the popcount row sums of that kernel's words
// on the same inputs with every point valid.
//
// What bounds it: about 22 FP32 add/sub/mul per pair and 4 bytes written per
// vertex, so the FP32 instruction rate, not memory (at N=100,000: 1e10 ordered pairs against
// 2.8 MB moved).
//
// Design, for that bound:
//  * grid (column blocks, B); 256 threads per block;
//  * each thread owns one vertex j, keeps its 6 floats in registers and its
//    count in a register; the block walks all row points in tiles of 256,
//    staged in shared memory (6 floats each) and read as broadcasts;
//  * one int32 store per thread, coalesced; no atomics, so the sum has one
//    order and the result is exact whatever the schedule.
//
// The TPU kernel accumulates tiles across a sequential grid axis; here that
// axis is the loop inside the block.

#include <cuda_runtime.h>
#include <stdint.h>

#include "trim_pred.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
trim_degrees_kernel(const float* __restrict__ src,
                    const float* __restrict__ dst, int32_t* __restrict__ out,
                    int n, float b2) {
  __shared__ float rows[6][kThreads];

  const long long b = blockIdx.y;
  const float* s = src + b * 3 * n;
  const float* d = dst + b * 3 * n;

  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int jj = j < n ? j : 0;  // threads past N still stage rows
  const float sx = s[jj], sy = s[n + jj], sz = s[2 * n + jj];
  const float tx = d[jj], ty = d[n + jj], tz = d[2 * n + jj];

  int count = 0;
  for (int r0 = 0; r0 < n; r0 += kThreads) {
    const int i = r0 + threadIdx.x;
    const int ii = i < n ? i : 0;
    __syncthreads();  // the previous tile has been read by every thread
    rows[0][threadIdx.x] = s[ii];
    rows[1][threadIdx.x] = s[n + ii];
    rows[2][threadIdx.x] = s[2 * n + ii];
    rows[3][threadIdx.x] = d[ii];
    rows[4][threadIdx.x] = d[n + ii];
    rows[5][threadIdx.x] = d[2 * n + ii];
    __syncthreads();
    const int rows_here = min(kThreads, n - r0);
#pragma unroll 8
    for (int r = 0; r < rows_here; ++r) {
      const float ds =
          trim::sq_dist(rows[0][r], rows[1][r], rows[2][r], sx, sy, sz);
      const float dd =
          trim::sq_dist(rows[3][r], rows[4][r], rows[5][r], tx, ty, tz);
      count += static_cast<int>(trim::pred_sq(ds, dd, b2) && (r0 + r != j));
    }
  }
  if (j < n) out[b * n + j] = count;
}

}  // namespace

extern "C" {

// src, dst: (batch, 3, n) float32; out: (batch, n) int32. Launches on
// `stream` and returns the launch's cudaError_t (0 on success); does not
// synchronise.
int trim_degrees_launch(const float* src, const float* dst, int32_t* out,
                        int batch, int n, float b2, cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  trim_degrees_kernel<<<grid, kThreads, 0, stream>>>(src, dst, out, n, b2);
  return static_cast<int>(cudaGetLastError());
}

const char* trim_degrees_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
