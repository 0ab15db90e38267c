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
//
// The row slab (trim_bits_slab_launch) computes only the word rows
// [w0, w1) of the same words, out[b, w - w0, j], for the row-sharded solve
// on a mesh: rank r of P holds rows [r ceil(W/P), (r+1) ceil(W/P)) with all
// N columns, JAX's P(pairs, None) on the (W, N) words. A slab holds both
// orientations of a block only inside its diagonal square [w0, w1)^2, so
// there the tasks are the full kernel's schedule on that square (each
// unordered block once, both orientations stored); outside it each task is
// one word row I in [w0, w1) against up to 4 column blocks J < w0 or
// J >= w1, and only its row orientation out[I, 32 J + lane] is stored. At
// P = 2 a slab is 3/8 of the W^2 blocks against the full kernel's 1/2: two
// slabs do 1.5x the whole kernel's work, the price of sharding rows. The
// predicate is symmetric bit for bit, so a word computed as a row equals
// the mirror that the full kernel stores. A slab of every row (0, W) is the
// full launch and goes to trim_bits_launch.

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

// The row slab [w0, w1) of the words: the first square_tasks tasks are the
// square [w0, w1)^2 under decode_task's numbering (both orientations); each
// of the rest is one row block I of the slab against `groups` groups of up
// to kColBlocks column blocks outside the square, groups_left of them in
// [0, w0) and the others in [w1, words) (row orientation only). `out` is the
// (batch, w1 - w0, n) slab.
__global__ void __launch_bounds__(trim::kThreads, trim::kMinBlocks)
trim_bits_slab_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                      const uint8_t* __restrict__ valid, int32_t* __restrict__ out,
                      int n, int words, int w0, int w1, long long square_tasks,
                      int groups_left, int groups, long long tasks, float b2) {
  __shared__ float4 rows[trim::kWarps][64];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long t = static_cast<long long>(blockIdx.x) * trim::kWarps + warp;
  if (t >= tasks) return;  // a whole warp; nothing below waits for it

  const int slab = w1 - w0;
  const bool square = t < square_tasks;
  trim::Tile tile;
  if (square) {
    trim::decode_task(t, slab, tile);  // blocks of the square, from 0
    tile.row_block += w0;
    tile.col_block0 += w0;
  } else {
    const long long u = t - square_tasks;
    tile.row_block = w0 + static_cast<int>(u / groups);
    const int g = static_cast<int>(u % groups);
    const int end = g < groups_left ? w0 : words;
    tile.col_block0 = g < groups_left ? trim::kColBlocks * g
                                      : w1 + trim::kColBlocks * (g - groups_left);
    const int left = end - tile.col_block0;
    tile.active = left < trim::kColBlocks ? left : trim::kColBlocks;
  }
  const long long b = blockIdx.y;
  trim::compute_tile_at(src + b * 3 * n, dst + b * 3 * n, valid + b * n, n,
                        trim::SqDistPred{b2}, rows[warp], lane, tile);

  int32_t* o = out + b * slab * n;
  const int i = 32 * tile.row_block + lane;
#pragma unroll
  for (int c = 0; c < trim::kColBlocks; ++c) {
    if (c < tile.active) {
      const int col_block = tile.col_block0 + c;
      const int j = 32 * col_block + lane;
      if (j < n) {
        o[static_cast<long long>(tile.row_block - w0) * n + j] =
            static_cast<int32_t>(tile.word[c]);
      }
      // inside the square, off its diagonal: I < J <= w1 - 1 <= words - 1,
      // so row block I is whole (i < n) and J is a row of the slab
      if (square && col_block != tile.row_block) {
        o[static_cast<long long>(col_block - w0) * n + i] =
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

// The row slab [w0, w1) of the same words into out: (batch, w1 - w0, n)
// int32, 0 <= w0 <= w1 <= ceil(n/32). Launches on `stream` and returns the
// launch's cudaError_t (0 on success; an empty slab launches nothing); does
// not synchronise.
int trim_bits_slab_launch(const float* src, const float* dst, const uint8_t* valid,
                          int32_t* out, int batch, int n, int w0, int w1, float b2,
                          cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int words = (n + 31) / 32;
  if (w0 < 0 || w1 > words || w0 > w1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (w0 == w1) return 0;
  const int slab = w1 - w0;
  const long long square_tasks = trim::tasks_upto(slab);
  const int groups_left = (w0 + trim::kColBlocks - 1) / trim::kColBlocks;
  const int groups =
      groups_left + (words - w1 + trim::kColBlocks - 1) / trim::kColBlocks;
  const long long tasks = square_tasks + static_cast<long long>(slab) * groups;
  const long long blocks = (tasks + trim::kWarps - 1) / trim::kWarps;
  if (blocks > INT_MAX || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(static_cast<unsigned>(blocks), batch);
  trim_bits_slab_kernel<<<grid, trim::kThreads, 0, stream>>>(
      src, dst, valid, out, n, words, w0, w1, square_tasks, groups_left,
      groups > 0 ? groups : 1, tasks, b2);
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
