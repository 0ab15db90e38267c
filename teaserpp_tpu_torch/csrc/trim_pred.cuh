// The TRIM pair predicate shared by the kernels that evaluate it
// (trim_bits.cu, trim_degrees.cu, through the tile loop of trim_tile.cuh), so
// both run the same instructions.
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
// trim_tile.cuh stands on that.

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

}  // namespace trim
