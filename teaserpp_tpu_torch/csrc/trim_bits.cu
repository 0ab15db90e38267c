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
// What bounds it: about 22 FP32 add/sub/mul per pair plus two compares, and
// only 4 bytes written per 32 pairs, so the kernel is bound by FP32 ALU
// issue, not by memory (at B=512, N=1889: 1.8e9 pairs against 232 MB of
// output words).
//
// Design, for that bound:
//  * grid (column blocks, ceil(N/32) words, B); 256 threads per block;
//  * the 32 row points of the block's word (6 floats each) and their valid
//    flags sit in shared memory and are read as broadcasts;
//  * each thread owns one column j, keeps its 6 floats in registers, and
//    loops over the 32 rows, setting bit r of its word; the word is written
//    once, and neighbouring threads write neighbouring words (coalesced);
//  * no tensor cores and no TMA: the work is compare and shift, not a product.
//
// The predicate is trim_pred.cuh's (FMA-free, JAX's op order): the words must
// equal, bit for bit, those of the plain PyTorch version
// (ops/cuda_kernels.py::trim_adjacency_bits_plain) and of the JAX package.

#include <cuda_runtime.h>
#include <stdint.h>

#include "trim_pred.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
trim_bits_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                 const uint8_t* __restrict__ valid, int32_t* __restrict__ out,
                 int n, int words, float b2) {
  __shared__ float rows[6][32];
  __shared__ int row_ok[32];

  const int w = blockIdx.y;
  const long long b = blockIdx.z;
  const float* s = src + b * 3 * n;
  const float* d = dst + b * 3 * n;
  const uint8_t* v = valid + b * n;

  if (threadIdx.x < 32) {
    const int i = w * 32 + threadIdx.x;
    const bool in = i < n;
    const int ii = in ? i : 0;
    rows[0][threadIdx.x] = s[ii];
    rows[1][threadIdx.x] = s[n + ii];
    rows[2][threadIdx.x] = s[2 * n + ii];
    rows[3][threadIdx.x] = d[ii];
    rows[4][threadIdx.x] = d[n + ii];
    rows[5][threadIdx.x] = d[2 * n + ii];
    row_ok[threadIdx.x] = in && v[ii] != 0;
  }
  __syncthreads();

  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;

  uint32_t word = 0;
  if (v[j] != 0) {
    const float sx = s[j], sy = s[n + j], sz = s[2 * n + j];
    const float tx = d[j], ty = d[n + j], tz = d[2 * n + j];
#pragma unroll 8
    for (int r = 0; r < 32; ++r) {
      const float ds =
          trim::sq_dist(rows[0][r], rows[1][r], rows[2][r], sx, sy, sz);
      const float dd =
          trim::sq_dist(rows[3][r], rows[4][r], rows[5][r], tx, ty, tz);
      const bool pred = trim::pred_sq(ds, dd, b2);
      const bool keep = pred && row_ok[r] && (w * 32 + r != j);
      word |= static_cast<uint32_t>(keep) << r;
    }
  }
  out[(b * words + w) * static_cast<long long>(n) + j] =
      static_cast<int32_t>(word);
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
  const dim3 grid((n + kThreads - 1) / kThreads, words, batch);
  trim_bits_kernel<<<grid, kThreads, 0, stream>>>(src, dst, valid, out, n,
                                                  words, b2);
  return static_cast<int>(cudaGetLastError());
}

const char* trim_bits_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
