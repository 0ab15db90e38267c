// Batched TRIM adjacency emitted directly as row-packed 32-bit words.
//
// Replaces teaserpp_tpu/ops/pallas_kernels.py::trim_adjacency_bits_pallas
// (body _trim_bits_kernel), with a batch axis and a per-problem validity
// mask added so the batched known-scale solve runs it on every call:
//
//   out[b, w, j] bit r  =  adj_b[32 w + r, j]
//   adj_b[i, j] = valid[b, i] & valid[b, j] & (i != j) &
//                 (s <= b2 | d*d <= b2*(2s - b2)),
//   s = ds + dd, d = ds - dd, ds/dd the squared distances of points i and j
//   in src/dst (the sqrt-free TRIM predicate of ops/tims.py::trim_pred_sq).
//
// What bounds it on an H100: instruction issue, per UNORDERED pair of valid
// points. adj is symmetric bit for bit, so one predicate (21 FP32
// instructions and two compares) serves the entries (i, j) and (j, i); the
// output is 4 bytes per 32 entries (1.25 GB at N = 100,000, 0.4 ms at the
// card's memory rate against 5e9 predicates).
//
// Design (the tile loop, its schedule and its budget are trim_tile.cuh's):
//  * grid (ceil(tasks / 8), B), 256 threads; a warp runs one task: word row
//    I against 4 column blocks J >= I, each unordered 32x32 block once;
//  * the lane's own words are out[I, 32 J + lane]; the warp's bit transpose
//    of them is out[J, 32 I + lane]; both are stored as 32 neighbouring
//    words (coalesced). A diagonal block holds both orientations in one word
//    and is stored once;
//  * every word of (B, ceil(N/32), N) is stored by exactly one warp, also
//    those of padded points and of the ragged last block: the wrapper hands
//    over uninitialised memory.
//
// The words must equal, bit for bit, those of the plain PyTorch version
// (ops/cuda_kernels.py::trim_adjacency_bits_plain) and of the JAX package.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "trim_tile.cuh"

namespace {

__global__ void __launch_bounds__(trim::kThreads, trim::kMinBlocks)
trim_bits_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                 const uint8_t* __restrict__ valid, int32_t* __restrict__ out,
                 int n, int words, long long tasks, float b2) {
  __shared__ float4 rows[trim::kWarps][64];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long t = static_cast<long long>(blockIdx.x) * trim::kWarps + warp;
  if (t >= tasks) return;  // a whole warp; nothing below waits for it

  const long long b = blockIdx.y;
  const trim::Tile tile =
      trim::compute_tile(src + b * 3 * n, dst + b * 3 * n, valid + b * n, n,
                         words, t, trim::SqDistPred{b2}, rows[warp], lane);

  int32_t* o = out + b * words * n;
  const int i = 32 * tile.row_block + lane;
#pragma unroll
  for (int c = 0; c < trim::kColBlocks; ++c) {
    if (c < tile.active) {
      const int col_block = tile.col_block0 + c;
      const int j = 32 * col_block + lane;
      if (j < n) {
        o[static_cast<long long>(tile.row_block) * n + j] =
            static_cast<int32_t>(tile.word[c]);
      }
      // off the diagonal I < J <= words - 1, so row block I is whole: i < n
      if (col_block != tile.row_block) {
        o[static_cast<long long>(col_block) * n + i] =
            static_cast<int32_t>(tile.mirror[c]);
      }
    }
  }
}

}  // namespace

extern "C" {

// src, dst: (batch, 3, n) float32; valid: (batch, n) bytes (0 or 1);
// out: (batch, ceil(n/32), n) int32. Launches on `stream` and returns the
// launch's cudaError_t (0 on success); does not synchronise.
int trim_bits_launch(const float* src, const float* dst, const uint8_t* valid,
                     int32_t* out, int batch, int n, float b2,
                     cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int words = (n + 31) / 32;
  const long long tasks = trim::tasks_upto(words);
  const long long blocks = (tasks + trim::kWarps - 1) / trim::kWarps;
  if (blocks > INT_MAX || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(static_cast<unsigned>(blocks), batch);
  trim_bits_kernel<<<grid, trim::kThreads, 0, stream>>>(src, dst, valid, out, n,
                                                        words, tasks, b2);
  return static_cast<int>(cudaGetLastError());
}

const char* trim_bits_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The task numbering that this library's kernel (and trim_degrees.cu's) runs,
// decoded on the host by the kernel's own trim::decode_task: tasks of a
// problem of `words` word rows, and tasks t0 .. t0 + count - 1 as
// out[3 k .. 3 k + 2] = (row block, first column block, column blocks).
long long trim_bits_task_count(int words) { return trim::tasks_upto(words); }

void trim_bits_decode_tasks(long long t0, int count, int words, int32_t* out) {
  for (int k = 0; k < count; ++k) {
    trim::Tile tile;
    trim::decode_task(t0 + k, words, tile);
    out[3 * k] = tile.row_block;
    out[3 * k + 1] = tile.col_block0;
    out[3 * k + 2] = tile.active;
  }
}

}  // extern "C"
