// Batched TRIM-graph degrees with the pair predicate never stored.
//
// Replaces teaserpp_tpu/ops/pallas_kernels.py::trim_degrees_pallas (body
// _trim_deg_kernel), with a batch axis:
//
//   deg[b, j] = #{ i != j : pred_b(i, j) },
//
// pred the sqrt-free TRIM predicate of trim_pred.cuh, run through the tile
// loop of trim_tile.cuh: the same instructions as trim_bits.cu, so deg equals
// the popcount row sums of that kernel's words on the same inputs with every
// point valid.
//
// What bounds it on an H100: instruction issue, per UNORDERED pair. pred is
// symmetric bit for bit, so one predicate (21 FP32 instructions and two
// compares) counts toward deg[i] and deg[j]; 4 bytes are written per vertex
// (at N = 100,000: 5e9 predicates against 2.8 MB moved).
//
// Design (the tile loop, its schedule and its budget are trim_tile.cuh's):
//  * grid (ceil(tasks / 8), B), 256 threads; a warp runs one task: the 32
//    rows of block I against 4 column blocks J >= I, each unordered 32x32
//    block once, points past N masked as trim_bits.cu masks invalid ones;
//  * the popcount of a lane's own word is its column's share of the block,
//    the popcount of the warp's bit transpose is its row's share; a diagonal
//    block holds every pair in both orientations and counts columns only;
//  * the shares are added to deg with integer atomicAdd: five a lane a task,
//    zero shares skipped. The wrapper hands over zeros. Integer adds commute
//    exactly, so the result is exact and the same from run to run whatever
//    the order the warps finish in.
//
// The TPU kernel accumulates tiles across a sequential grid axis; blocks run
// in no order here, and the triangle makes the rows' work unequal, so the
// sum goes through the atomics instead of a loop over all rows.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "trim_tile.cuh"

namespace {

__global__ void __launch_bounds__(trim::kThreads, trim::kMinBlocks)
trim_degrees_kernel(const float* __restrict__ src,
                    const float* __restrict__ dst, int32_t* __restrict__ deg,
                    int n, int words, long long tasks, float b2) {
  __shared__ float4 rows[trim::kWarps][64];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long t = static_cast<long long>(blockIdx.x) * trim::kWarps + warp;
  if (t >= tasks) return;  // a whole warp; nothing below waits for it

  const long long b = blockIdx.y;
  const trim::Tile tile =
      trim::compute_tile(src + b * 3 * n, dst + b * 3 * n, nullptr, n, words,
                         t, trim::SqDistPred{b2}, rows[warp], lane);

  int32_t* g = deg + b * n;
  int row_share = 0;
#pragma unroll
  for (int c = 0; c < trim::kColBlocks; ++c) {
    if (c < tile.active) {
      const int col_block = tile.col_block0 + c;
      const int j = 32 * col_block + lane;
      const int col_share = __popc(tile.word[c]);  // 0 for a column past N
      if (col_share != 0) atomicAdd(g + j, col_share);
      if (col_block != tile.row_block) row_share += __popc(tile.mirror[c]);
    }
  }
  // a nonzero row share comes from a block off the diagonal, where row
  // block I is whole
  if (row_share != 0) atomicAdd(g + 32 * tile.row_block + lane, row_share);
}

}  // namespace

extern "C" {

// src, dst: (batch, 3, n) float32; deg: (batch, n) int32, zero on entry.
// Launches on `stream` and returns the launch's cudaError_t (0 on success);
// does not synchronise.
int trim_degrees_launch(const float* src, const float* dst, int32_t* deg,
                        int batch, int n, float b2, cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int words = (n + 31) / 32;
  const long long tasks = trim::tasks_upto(words);
  const long long blocks = (tasks + trim::kWarps - 1) / trim::kWarps;
  if (blocks > INT_MAX || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(static_cast<unsigned>(blocks), batch);
  trim_degrees_kernel<<<grid, trim::kThreads, 0, stream>>>(src, dst, deg, n,
                                                           words, tasks, b2);
  return static_cast<int>(cudaGetLastError());
}

const char* trim_degrees_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
