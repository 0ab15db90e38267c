// The symmetric tile loop shared by the kernels that evaluate a symmetric
// pair function over all pairs of a problem: the TRIM predicate on squared
// distances (trim_bits.cu, trim_degrees.cu) and the Gram-form distance
// compare of the dense int8 adjacency (trim_adjacency.cu). Each kernel names
// its pair function as a policy (SqDistPred, GramDistPred below); the loop,
// the schedule and the masks are the same for all three.
//
// What bounds these kernels on an H100: instruction issue (four warp
// instructions a clock an SM) and, before this design, the SM's single
// shared-memory pipe (one warp-wide load a clock). Memory is far away for the
// bit kernels: the whole input of N = 100,000 is 2.4 MB and stays in L2, and
// the largest output (1.25 GB of words) is 0.4 ms at the card's memory rate.
// The needed work is one pair function per UNORDERED pair: for the TRIM
// predicate 21 FP32 instructions (22 operations, two of them fused exactly,
// trim_pred.cuh) and two compares.
//
// What the design does about it:
//
//  * Each unordered 32x32 block of pairs is evaluated once. The pair
//    functions are symmetric bit for bit (negating a difference is exact,
//    every sum and product keeps its order or commutes), so the work of a
//    problem is the upper triangle of blocks (I, J), I <= J, of its
//    ceil(N/32)^2 blocks.
//  * A task is one word row I and kColBlocks consecutive column blocks
//    starting at J0 = I + kColBlocks * k; one warp runs one task. Lane l owns
//    the columns 32 (J0 + c) + l and keeps their coordinates in registers
//    (24 registers at kColBlocks = 4; 32 with the squared norms that the Gram
//    form adds). The 32 row points are staged by the warp in its own 1 KB of
//    shared memory as two 16-byte vectors each ({x, y, z, w} of src and of
//    dst, w the squared norm where the pair function reads it, else 0) and
//    read as two LDS.128 broadcasts a row, used against the 4 columns: 0.5
//    shared loads a pair.
//  * The inner loop is the predicate and one bit insert: lane l builds, for
//    each column block, the word whose bit r is pred(row r, column l). That
//    is the word [I, 32 J + l] of the row-packed adjacency. A 32x32 bit
//    transpose across the warp (5 shuffle steps, about one instruction a
//    pair) turns the 32 lanes' words into the mirrored words: lane r then
//    holds the word whose bit l is the same entry, word [J, 32 I + r]. (A
//    ballot a row gives the same words but adds a vote, a lane compare and a
//    select to every pair; it was tried and was slower on the card.)
//  * Masks stay out of the inner loop: row validity is one AND with a ballot
//    of the row flags, column validity one AND of the transposed word with a
//    ballot of the column flags, and the diagonal bit is cleared after the
//    loop, in diagonal blocks only. A task none of whose rows or none of
//    whose columns is valid skips the arithmetic and returns zero words.
//  * Tasks are numbered linearly per problem, rows in order of increasing
//    length, so every warp of the grid has work and no block is launched to
//    return at once. The number is turned into (I, k) by a square-root
//    estimate corrected in integers, exact for any N. A warp never waits for
//    another: there is no __syncthreads, and a warp past the last task exits
//    whole. (trim_adjacency.cu runs the same tile, compute_tile_at, under a
//    schedule of its own: block tasks of 4 warps that stage their output.)
//  * No tensor cores: the result must equal the plain PyTorch version bit
//    for bit, and a product in TF32 would not. No TMA and no cp.async ring: a
//    task reads 160 points (3.8-5 KB, from L2) for 80,000 FP32 instructions
//    or more.
//
// Budget: trim_bits.cu and trim_degrees.cu run __launch_bounds__(256, 3), 80
// registers a thread, so three blocks (24 warps) are resident on an SM and
// hide the L2 latency of each task's loads behind the other warps'
// arithmetic; trim_adjacency.cu states its own.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "trim_pred.cuh"

namespace trim {

constexpr int kColBlocks = 4;  // 32-column blocks a warp holds in registers
constexpr int kRowChunk = 8;   // rows unrolled at a time in the tile loop
constexpr int kWarps = 8;      // warps (tasks) a thread block
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 3;  // resident blocks an SM the registers allow
constexpr unsigned kFullMask = 0xffffffffu;

// Tasks of all word rows of length 1..m: sum of ceil(L / kColBlocks).
__host__ __device__ inline long long tasks_upto(long long m) {
  const long long q = m / kColBlocks;
  const long long rem = m % kColBlocks;
  return kColBlocks * q * (q + 1) / 2 + rem * (q + 1);
}

// What one warp hands to its kernel's epilogue.
struct Tile {
  int row_block;   // I
  int col_block0;  // J0: the task's column blocks are J0 .. J0 + active - 1
  int active;      // 1..kColBlocks column blocks inside the problem
  // lane l, bit r: adj[32 I + r, 32 (J0 + c) + l], masked
  uint32_t word[kColBlocks];
  // lane r, bit l: the same entry, read as adj[32 (J0 + c) + l, 32 I + r]
  uint32_t mirror[kColBlocks];
};

// The column points a lane keeps in registers; s2, t2 (squared norms) only
// where the pair function reads them (else they are never set and take no
// register).
struct Columns {
  float sx[kColBlocks], sy[kColBlocks], sz[kColBlocks], s2[kColBlocks];
  float tx[kColBlocks], ty[kColBlocks], tz[kColBlocks], t2[kColBlocks];
};

// Pair function of trim_bits.cu and trim_degrees.cu: the sqrt-free TRIM
// predicate on squared distances, b2 = beta^2 rounded once to float32.
struct SqDistPred {
  static constexpr bool kNorms = false;
  static constexpr bool kFiltered = false;
  float b2;
  __device__ __forceinline__ bool operator()(const float4& a, const float4& b,
                                             const Columns& col, int c) const {
    const float ds = sq_dist(a.x, a.y, a.z, col.sx[c], col.sy[c], col.sz[c]);
    const float dd = sq_dist(b.x, b.y, b.z, col.tx[c], col.ty[c], col.tz[c]);
    return pred_sq(ds, dd, b2);
  }
};

// Pair function of trim_adjacency.cu: |dist_src - dist_dst| <= beta with
// both distances in Gram form (trim_pred.cuh's gram_dist), beta float32.
//
// It is filtered: approx() takes the square roots with one MUFU.SQRT each in
// place of the IEEE sequence (an RSQ, five FP32 instructions and a range
// check with a call), and decides every pair whose approximate |ds - dd|
// lies farther from beta than the square roots' error can carry it; the
// rest set `near`, and the tile loop decides them again, exactly, with
// operator(). The margin: sqrt_approx(x) is within 2^-21 sqrt(x) + 2^-63 of
// the IEEE root (checked on the card over every float), so the approximate
// and exact |ds - dd| differ by at most (2^-21 + 2^-23) S (1 + 2^-20) + 2^-61
// after their roundings, S = ds + dd. S is bounded for a whole task by the
// norms: a Gram-form distance is at most (|a| + |b|) (1 + 2^-21), so
// `margin` = 2^-18 T + 2^-59, T >= the sum of the largest row and column
// norms of both clouds (trim_adjacency.cu computes it), is six times the
// error or more. NaN (a negative d2, which the exact path clamps to 0) and
// infinities count as near.
//
// approx() returns |ds - dd| - beta_up, beta_up the float after beta: its
// sign bit is the entry (|ds - dd| <= beta exactly when the difference is
// below beta_up, and a rounded difference keeps its sign, never -0 here),
// which the tile loop shifts into its word with one funnel shift.
struct GramDistPred {
  static constexpr bool kNorms = true;
  static constexpr bool kFiltered = true;
  float beta, beta_up, margin;
  __device__ __forceinline__ bool operator()(const float4& a, const float4& b,
                                             const Columns& col, int c) const {
    const float ds = gram_dist(a.x, a.y, a.z, a.w, col.sx[c], col.sy[c],
                               col.sz[c], col.s2[c]);
    const float dd = gram_dist(b.x, b.y, b.z, b.w, col.tx[c], col.ty[c],
                               col.tz[c], col.t2[c]);
    return fabsf(__fsub_rn(ds, dd)) <= beta;
  }
  __device__ __forceinline__ float approx(const float4& a, const float4& b,
                                          const Columns& col, int c,
                                          bool& near) const {
    const float ds = sqrt_approx(gram_d2(a.x, a.y, a.z, a.w, col.sx[c],
                                         col.sy[c], col.sz[c], col.s2[c]));
    const float dd = sqrt_approx(gram_d2(b.x, b.y, b.z, b.w, col.tx[c],
                                         col.ty[c], col.tz[c], col.t2[c]));
    const float x = __fsub_rn(fabsf(__fsub_rn(ds, dd)), beta_up);
    near |= !(fabsf(x) > margin);
    return x;
  }
};

// Task number t of a problem of `words` word rows -> (I, J0, active). Rows
// come in order of increasing length m = words - I; within a row k counts
// the column groups from the diagonal. Compiled for the host as well, so a
// library can show the numbering its kernel runs (trim_bits_decode_tasks).
__host__ __device__ __forceinline__ void decode_task(long long t, int words,
                                                     Tile& tile) {
  // tasks_upto(m) is about m^2 / (2 kColBlocks): estimate, then correct
  long long m = static_cast<long long>(
      sqrt(2.0 * kColBlocks * static_cast<double>(t)));
  if (m > words) m = words;
  if (m < 1) m = 1;
  while (m > 1 && tasks_upto(m - 1) > t) --m;
  while (tasks_upto(m) <= t) ++m;
  const int k = static_cast<int>(t - tasks_upto(m - 1));
  tile.row_block = words - static_cast<int>(m);
  tile.col_block0 = tile.row_block + kColBlocks * k;
  const int left = words - tile.col_block0;
  tile.active = left < kColBlocks ? left : kColBlocks;
}

// The 32 rows of the staged block against CA column blocks of this lane:
// word[c] bit r = pred(row r, this lane's column of block c), unmasked.
template <int CA, class Pred>
__device__ __forceinline__ void tile_loop(const float4* rows, const Columns& col,
                                          const Pred& pred,
                                          uint32_t (&word)[kColBlocks]) {
#pragma unroll 1
  for (int r0 = 0; r0 < 32; r0 += kRowChunk) {
    uint32_t part[CA];
#pragma unroll
    for (int c = 0; c < CA; ++c) part[c] = 0;
    if constexpr (Pred::kFiltered) {
      bool near = false;
      // rows from the last: each funnel shift moves the word up one bit and
      // brings in the sign bit of approx(), so row u ends at bit u
#pragma unroll
      for (int u = kRowChunk - 1; u >= 0; --u) {
        const float4 a = rows[2 * (r0 + u)];
        const float4 b = rows[2 * (r0 + u) + 1];
#pragma unroll
        for (int c = 0; c < CA; ++c) {
          part[c] = __funnelshift_l(
              __float_as_uint(pred.approx(a, b, col, c, near)), part[c], 1);
        }
      }
      // a lane holds a pair that the filter cannot decide: the warp takes
      // the chunk again, exactly (rare; every lane stays converged)
      if (__any_sync(kFullMask, near)) {
#pragma unroll
        for (int c = 0; c < CA; ++c) part[c] = 0;
#pragma unroll 1
        for (int u = 0; u < kRowChunk; ++u) {
          const float4 a = rows[2 * (r0 + u)];
          const float4 b = rows[2 * (r0 + u) + 1];
#pragma unroll
          for (int c = 0; c < CA; ++c) {
            part[c] |= static_cast<uint32_t>(pred(a, b, col, c)) << u;
          }
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < kRowChunk; ++u) {
        const float4 a = rows[2 * (r0 + u)];
        const float4 b = rows[2 * (r0 + u) + 1];
#pragma unroll
        for (int c = 0; c < CA; ++c) {
          part[c] |= static_cast<uint32_t>(pred(a, b, col, c)) << u;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CA; ++c) word[c] |= part[c] << r0;
  }
}

// 32x32 bit transpose across a warp: afterwards lane r's bit l is what lane
// l's bit r was. Five steps; step s swaps the off-diagonal s x s blocks of
// every 2s x 2s block between lanes s apart.
__device__ __forceinline__ uint32_t warp_transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    // bit positions p with (p & s) == 0
    const uint32_t low = s == 16 ? 0x0000ffffu
                       : s == 8  ? 0x00ff00ffu
                       : s == 4  ? 0x0f0f0f0fu
                       : s == 2  ? 0x33333333u
                                 : 0x55555555u;
    const uint32_t y = __shfl_xor_sync(kFullMask, x, s);
    x = (lane & s) ? (((y >> s) & low) | (x & ~low))
                   : ((x & low) | ((y << s) & ~low));
  }
  return x;
}

// One task: the masked words of word row tile.row_block against its
// tile.active column blocks from tile.col_block0 (set by the caller), in both
// orientations, of the pair function `pred`, into tile.word and tile.mirror.
// `s`, `d` are the problem's (3, n) points; `v` its n validity bytes, or null
// when every point counts. `rows` is this warp's 64 float4 of shared memory.
// Every lane of the warp must call this.
template <class Pred>
__device__ __forceinline__ void compute_tile_at(const float* __restrict__ s,
                                                const float* __restrict__ d,
                                                const uint8_t* __restrict__ v,
                                                int n, const Pred& pred,
                                                float4* rows, int lane,
                                                Tile& tile) {
  // stage the 32 row points; a lane past N stages a copy of the last point
  // and its flag says so
  const int i = 32 * tile.row_block + lane;
  const int ii = min(i, n - 1);
  {
    const float sx = s[ii], sy = s[n + ii], sz = s[2 * n + ii];
    const float tx = d[ii], ty = d[n + ii], tz = d[2 * n + ii];
    rows[2 * lane] =
        make_float4(sx, sy, sz, Pred::kNorms ? norm2(sx, sy, sz) : 0.0f);
    rows[2 * lane + 1] =
        make_float4(tx, ty, tz, Pred::kNorms ? norm2(tx, ty, tz) : 0.0f);
  }
  const bool row_ok = i < n && (v == nullptr || v[ii] != 0);
  const uint32_t row_mask = __ballot_sync(kFullMask, row_ok);

  Columns col;
  bool col_ok[kColBlocks];
  uint32_t col_mask[kColBlocks];
  uint32_t any_col = 0;
#pragma unroll
  for (int c = 0; c < kColBlocks; ++c) {
    const int j = 32 * (tile.col_block0 + c) + lane;
    const int jj = min(j, n - 1);
    col.sx[c] = s[jj];
    col.sy[c] = s[n + jj];
    col.sz[c] = s[2 * n + jj];
    col.tx[c] = d[jj];
    col.ty[c] = d[n + jj];
    col.tz[c] = d[2 * n + jj];
    if (Pred::kNorms) {
      col.s2[c] = norm2(col.sx[c], col.sy[c], col.sz[c]);
      col.t2[c] = norm2(col.tx[c], col.ty[c], col.tz[c]);
    }
    col_ok[c] = j < n && (v == nullptr || v[jj] != 0);
    col_mask[c] = __ballot_sync(kFullMask, col_ok[c]);
    any_col |= col_mask[c];
    tile.word[c] = 0;
    tile.mirror[c] = 0;
  }
  __syncwarp();  // the staged rows are visible to every lane

  if (row_mask == 0 || any_col == 0) return;  // warp-uniform

  if constexpr (Pred::kFiltered) {
    // one loop for every task keeps the filtered kernel's code small (its
    // loop holds the exact pass too); the columns of the blocks past
    // tile.active are clamped points, masked below
    tile_loop<kColBlocks>(rows, col, pred, tile.word);
  } else {
    switch (tile.active) {
      case 1: tile_loop<1>(rows, col, pred, tile.word); break;
      case 2: tile_loop<2>(rows, col, pred, tile.word); break;
      case 3: tile_loop<3>(rows, col, pred, tile.word); break;
      default: tile_loop<4>(rows, col, pred, tile.word); break;
    }
  }
  static_assert(kColBlocks == 4, "the switch above lists 1..kColBlocks");

  const bool diagonal = tile.col_block0 == tile.row_block;  // block c = 0
#pragma unroll
  for (int c = 0; c < kColBlocks; ++c) {
    uint32_t w = tile.word[c];
    if (c == 0 && diagonal) w &= ~(1u << lane);
    // every lane takes part in the transpose, whatever its flags
    const uint32_t m = warp_transpose32(w, lane);
    tile.word[c] = col_ok[c] ? (w & row_mask) : 0u;
    tile.mirror[c] = row_ok ? (m & col_mask[c]) : 0u;
  }
}

// compute_tile_at on task number t of a problem of `words` word rows
// (decode_task's numbering).
template <class Pred>
__device__ __forceinline__ Tile compute_tile(const float* __restrict__ s,
                                             const float* __restrict__ d,
                                             const uint8_t* __restrict__ v,
                                             int n, int words, long long t,
                                             const Pred& pred, float4* rows,
                                             int lane) {
  Tile tile;
  decode_task(t, words, tile);
  compute_tile_at(s, d, v, n, pred, rows, lane, tile);
  return tile;
}

}  // namespace trim
