// The TRIM pair predicate shared by the kernels that evaluate it
// (trim_bits.cu, trim_degrees.cu, through the tile loop of trim_tile.cuh), so
// both run the same instructions; and the Gram-form distance of the dense
// int8 adjacency (trim_adjacency.cu).
//
// Every add, sub and mul goes through __f*_rn so nvcc cannot contract them
// into FMAs: the predicate must equal, bit for bit, that of the plain PyTorch
// versions (ops/tims.py::trim_pred_sq over _pdist2) and of the JAX package,
// which round after every operation, including at pairs that sit exactly on
// the threshold. The one fused operation, 2 s - b2, is exact to fuse:
// doubling a float is exact, so the FMA rounds the same real number once
// that the two operations round.
//
// The predicate is symmetric in its two points, bit for bit: (a - b) and
// (b - a) differ in sign only, their squares are equal, and no sum below
// mixes the two points' terms in an order that depends on which came first.
// trim_tile.cuh stands on that. The Gram-form distance is symmetric too: its
// products and its sum a2 + b2 commute exactly.

#pragma once

#include <cuda_runtime.h>

namespace trim {

// dx*dx + dy*dy + dz*dz of (a - b), summed left to right.
__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Sqrt-free |sqrt(ds) - sqrt(dd)| <= beta on squared distances, b2 = beta^2:
// s <= b2  or  d*d <= b2*(2 s - b2), with s = ds + dd and d = ds - dd.
__device__ __forceinline__ bool pred_sq(float ds, float dd, float b2) {
  const float sum = __fadd_rn(ds, dd);
  const float diff = __fsub_rn(ds, dd);
  const float lhs = __fmul_rn(diff, diff);
  const float rhs = __fmul_rn(b2, __fmaf_rn(2.0f, sum, -b2));  // 2 sum exact
  return (sum <= b2) | (lhs <= rhs);
}

// x*x + y*y + z*z, summed left to right.
__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// a2 + b2 - 2 (ax bx + ay by + az bz), a2 and b2 the squared norms, in the
// order of the plain version (ops/cuda_kernels.py::_gram_dist): the product
// summed left to right, unfused; `- 2 gram` as one exact FMA (doubling is
// exact, so it rounds the real number that the separate multiply and
// subtract round).
__device__ __forceinline__ float gram_d2(float ax, float ay, float az, float a2,
                                         float bx, float by, float bz,
                                         float b2) {
  const float gram = __fadd_rn(
      __fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
  return __fmaf_rn(-2.0f, gram, __fadd_rn(a2, b2));
}

// The Gram-form distance, sqrt(max(d2, 0)): IEEE square root, round to
// nearest, as the plain version takes it.
__device__ __forceinline__ float gram_dist(float ax, float ay, float az,
                                           float a2, float bx, float by,
                                           float bz, float b2) {
  return __fsqrt_rn(fmaxf(gram_d2(ax, ay, az, a2, bx, by, bz, b2), 0.0f));
}

// One special-function instruction (MUFU.SQRT): NaN below zero, subnormal
// inputs flushed to zero. Within 2^-21 sqrt(x) + 2^-63 of __fsqrt_rn(x) for
// every finite x >= 0, as trim_adjacency_sqrt_check (trim_adjacency.cu)
// verifies on the card over all of them; trim_tile.cuh's GramDistPred
// stands on that bound.
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

}  // namespace trim
