// Batched dense TRIM adjacency (int8) from Gram-form distances.
//
// Replaces teaserpp_tpu/ops/pallas_kernels.py::trim_adjacency_pallas (body
// _trim_kernel), with a batch axis:
//
//   adj[b, i, j] = (i != j) & (|dist_src(i, j) - dist_dst(i, j)| <= beta),
//   dist(i, j)   = sqrt(max(a2_i + a2_j - 2 (x_i x_j + y_i y_j + z_i z_j), 0)),
//   a2_i         = x_i x_i + y_i y_i + z_i z_i,
//
// every sum left to right. The Gram product has depth 3 and is taken inside
// the kernel with plain FP32 instructions: the TPU kernel pads the depth to 8
// to feed its matrix unit, which is not carried over, and tensor cores would
// round the inputs to TF32 and change the result. The TPU kernel parks its
// tile padding at +-1e15 because its grid needs whole tiles; a bounds check
// does that here.
//
// What bounds it: one output byte per ordered pair against about 20 FP32
// instructions and two square roots per pair; the FP32 pipe, the special
// function unit and the N^2 output bytes are within a small factor of each
// other, and this simple version is held by its instruction count.
//
// Design:
//  * grid (column blocks, ceil(N/32) row bands, B); 256 threads per block;
//  * the band's 32 row points (x, y, z, a2 of both clouds, 8 floats each)
//    sit in shared memory and are read as broadcasts;
//  * each thread owns one column j, keeps its 8 floats in registers and
//    loops over the 32 rows; a warp writes 32 neighbouring bytes per row,
//    one full 32-byte sector.
//
// Every add, sub and mul goes through __f*_rn so nvcc cannot contract them
// into FMAs, and the square root is __fsqrt_rn (IEEE, round to nearest): the
// output must equal, byte for byte, the plain PyTorch version
// (ops/cuda_kernels.py::trim_adjacency_i8_plain), which rounds after every
// operation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;

__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// sqrt(max(a2 + b2 - 2 (ax bx + ay by + az bz), 0))
__device__ __forceinline__ float gram_dist(float ax, float ay, float az,
                                           float a2, float bx, float by,
                                           float bz, float b2) {
  const float gram = __fadd_rn(
      __fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
  const float d2 = __fsub_rn(__fadd_rn(a2, b2), __fmul_rn(2.0f, gram));
  return __fsqrt_rn(fmaxf(d2, 0.0f));
}

__global__ void __launch_bounds__(kThreads)
trim_adjacency_kernel(const float* __restrict__ src,
                      const float* __restrict__ dst, int8_t* __restrict__ out,
                      int n, float beta) {
  __shared__ float rows[8][kRows];

  const int i0 = blockIdx.y * kRows;
  const long long b = blockIdx.z;
  const float* s = src + b * 3 * n;
  const float* d = dst + b * 3 * n;

  if (threadIdx.x < kRows) {
    const int i = i0 + threadIdx.x;
    const int ii = i < n ? i : 0;
    const float sx = s[ii], sy = s[n + ii], sz = s[2 * n + ii];
    const float tx = d[ii], ty = d[n + ii], tz = d[2 * n + ii];
    rows[0][threadIdx.x] = sx;
    rows[1][threadIdx.x] = sy;
    rows[2][threadIdx.x] = sz;
    rows[3][threadIdx.x] = norm2(sx, sy, sz);
    rows[4][threadIdx.x] = tx;
    rows[5][threadIdx.x] = ty;
    rows[6][threadIdx.x] = tz;
    rows[7][threadIdx.x] = norm2(tx, ty, tz);
  }
  __syncthreads();

  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;

  const float sx = s[j], sy = s[n + j], sz = s[2 * n + j];
  const float tx = d[j], ty = d[n + j], tz = d[2 * n + j];
  const float s2 = norm2(sx, sy, sz);
  const float t2 = norm2(tx, ty, tz);

  int8_t* o = out + (b * n + i0) * static_cast<long long>(n) + j;
  const int rows_here = min(kRows, n - i0);
#pragma unroll 4
  for (int r = 0; r < rows_here; ++r) {
    const float ds = gram_dist(rows[0][r], rows[1][r], rows[2][r], rows[3][r],
                               sx, sy, sz, s2);
    const float dd = gram_dist(rows[4][r], rows[5][r], rows[6][r], rows[7][r],
                               tx, ty, tz, t2);
    const bool keep = (fabsf(__fsub_rn(ds, dd)) <= beta) && (i0 + r != j);
    o[static_cast<long long>(r) * n] = static_cast<int8_t>(keep);
  }
}

}  // namespace

extern "C" {

// src, dst: (batch, 3, n) float32; out: (batch, n, n) int8. Launches on
// `stream` and returns the launch's cudaError_t (0 on success); does not
// synchronise.
int trim_adjacency_launch(const float* src, const float* dst, int8_t* out,
                          int batch, int n, float beta, cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads, (n + kRows - 1) / kRows,
                  batch);
  trim_adjacency_kernel<<<grid, kThreads, 0, stream>>>(src, dst, out, n, beta);
  return static_cast<int>(cudaGetLastError());
}

const char* trim_adjacency_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
