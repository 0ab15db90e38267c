// Batched dense TRIM adjacency (int8) from Gram-form distances.
//
// Replaces teaserpp_tpu/ops/pallas_kernels.py::trim_adjacency_pallas (body
// _trim_kernel), with a batch axis:
//
//   adj[b, i, j] = (i != j) & (|dist_src(i, j) - dist_dst(i, j)| <= beta),
//   dist(i, j)   = sqrt(max(a2_i + a2_j - 2 (x_i x_j + y_i y_j + z_i z_j), 0)),
//   a2_i         = x_i x_i + y_i y_i + z_i z_i,
//
// every sum left to right (trim_pred.cuh's gram_dist). The Gram product has
// depth 3 and is taken with plain FP32 instructions: the TPU kernel pads the
// depth to 8 to feed its matrix unit, which is not carried over, and tensor
// cores would round the inputs to TF32 and change the result. The TPU kernel
// parks its tile padding at +-1e15 because its grid needs whole tiles;
// bounds checks do that here.
//
// What bounds it on an H100, per UNORDERED pair (the entry is symmetric bit
// for bit): 18 FP32 instructions (each distance 3 mul, 2 add for the
// product, 1 add and 1 exact FMA for d2, 1 max; then a sub and a compare),
// two square roots on the special-function units, and two output bytes. At
// N = 16,384 the three are within 25% of each other (0.072, 0.064 and
// 0.080 ms): instruction issue and the N^2 output bytes are the limits.
//
// Design:
//  * The tile loop and its masks are trim_tile.cuh's, with the Gram-form pair
//    function (GramDistPred): a warp evaluates row block I against up to 4
//    column blocks J >= I, each unordered 32x32 block of pairs once, the row
//    points staged as {x, y, z, a2}, its columns' x, y, z and squared norm
//    of both clouds in 32 registers.
//  * The square roots are filtered (GramDistPred::approx): one MUFU.SQRT
//    each decides every pair whose |ds - dd| lies farther from beta than the
//    approximate roots' proven error; the rare rest are decided again with
//    the IEEE roots. An IEEE root costs about 12 instructions with its range
//    check and call; the filter 2 a pair (a subtraction and a compare with a
//    margin bounded once a task from the points' norms), and the entry goes
//    into its word as the sign bit of |ds - dd| - beta_up by one funnel
//    shift. The error bound that the margin stands on is checked over every
//    float on the card (trim_adjacency_sqrt_check below).
//  * The stores decide the design as much as the arithmetic. At an odd N a
//    32-byte row segment per block starts at any byte and shares its end
//    sectors with segments that other warps store, and the card takes a
//    store that writes part of a 32-byte sector at a fraction of the rate
//    of whole-sector ones, whatever its width
//    (scripts/torch_store_pattern_probe.py). So a thread block of 4 warps
//    takes a block task, a group of 4 row blocks (S) against a group of 4
//    column blocks (g >= S), and stages both orientations in shared memory,
//    expanded to bytes (four bits at a time with one multiply and one mask):
//    the 128 rows of its row group over the column group's 128 columns, and,
//    transposed, the 128 rows of its column group over the row group's 128
//    columns. Each output row then gets one run of up to 128 bytes from the
//    block instead of four segments: its whole 16-byte aligned slots go out
//    as 16-byte stores, eight lanes a run, each read as four words shifted
//    by the run's misalignment, and the fewer than 16 bytes on either side
//    of them as one byte store a side. At N % 16 == 0 there are no such
//    bytes. A diagonal block is stored once, from the upper staging; the
//    lower runs cover the row blocks left of the diagonal.
//  * Every byte of the uninitialised (B, N, N) output is stored exactly once.
//    Offsets are 64-bit: B N^2 passes 2^31 at N = 46,341.
//
// Budget: 40 KB of shared memory a block of 4 warps (the row points and the
// two 18 KB stagings, staged rows 144 bytes apart so that 16-byte stores on 8
// rows hit every bank once), so five blocks (20 warps) an SM.
//
// The bytes must equal those of the plain PyTorch version
// (ops/cuda_kernels.py::trim_adjacency_i8_plain) at every N.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "trim_tile.cuh"

namespace {

constexpr int kGroup = trim::kColBlocks;  // row and column blocks a block task spans
constexpr int kThreads = 32 * kGroup;     // a warp a row block
constexpr int kMinBlocks = 5;             // resident blocks an SM (shared memory)
constexpr int kRun = 32 * kGroup;         // bytes of a staged row: 128
constexpr int kPitch = kRun + 16;         // staged rows 144 bytes apart: 8 lanes
                                          // storing 16 bytes on 8 rows hit 32 banks

// Block task number t of a problem of `groups` groups of row (column) blocks
// -> (S, g), g >= S: rows of block tasks in order of increasing length
// G - S, as trim::decode_task orders its tasks.
__device__ __forceinline__ void decode_block_task(long long t, int groups,
                                                  int& S, int& g) {
  long long m = static_cast<long long>(sqrt(2.0 * static_cast<double>(t)));
  if (m > groups) m = groups;
  if (m < 1) m = 1;
  while (m > 1 && m * (m - 1) / 2 > t) --m;
  while (m * (m + 1) / 2 <= t) ++m;
  S = groups - static_cast<int>(m);
  g = S + static_cast<int>(t - m * (m - 1) / 2);
}

// Bits 0..3 of x -> bytes 0..3 (0 or 1) of the result: bit k of x lands at
// bits k, k + 7, k + 14, k + 21 of the product (no two overlap, so there is
// no carry), and bit k + 7 k = 8 k is the one kept.
__device__ __forceinline__ uint32_t expand4(uint32_t x) {
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

// The 32 bits of x as 32 bytes (0 or 1) at p, 16-byte aligned shared memory.
__device__ __forceinline__ void stage32(uint8_t* p, uint32_t x) {
  reinterpret_cast<uint4*>(p)[0] = make_uint4(expand4(x), expand4(x >> 4),
                                              expand4(x >> 8), expand4(x >> 12));
  reinterpret_cast<uint4*>(p)[1] = make_uint4(expand4(x >> 16), expand4(x >> 20),
                                              expand4(x >> 24), expand4(x >> 28));
}

// sqrt(x^2 + y^2 + z^2) of point i of a (3, n) cloud, within 2^-20 of it
// (one approximate root, trim_pred.cuh).
__device__ __forceinline__ float point_norm(const float* p, int n, int i) {
  return trim::sqrt_approx(trim::norm2(p[i], p[n + i], p[2 * n + i]));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(trim::kFullMask, v, s));
  }
  return v;
}

// The 32 runs of one side of a warp's share: run r is `len` bytes at
// at0 + r * n, staged at src0 + r * kPitch, for r < rows (the rows inside
// the problem).
struct Runs {
  uintptr_t at0;
  const uint8_t* src0;
  int len, rows;
};

// Lane k (0..7) of run r's eight stores the run's k-th whole 16-byte aligned
// slot, if it has one: 16 staged bytes read as four words shifted by the
// run's misalignment.
template <bool kAligned>
__device__ __forceinline__ void store_slot(const Runs& runs, int n, int r,
                                           int k) {
  if (r >= runs.rows || runs.len <= 0) return;
  const uintptr_t at = runs.at0 + static_cast<uintptr_t>(r) * n;
  const uintptr_t slot = ((at + 15) & ~static_cast<uintptr_t>(15)) + 16 * k;
  if (slot + 16 > at + runs.len) return;
  const uint8_t* s = runs.src0 + r * kPitch + (slot - at);
  if (kAligned) {
    *reinterpret_cast<uint4*>(slot) = *reinterpret_cast<const uint4*>(s);
    return;
  }
  const unsigned d = static_cast<unsigned>(reinterpret_cast<uintptr_t>(s) & 3);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(s - d);
  const unsigned sel = 0x3210u + 0x1111u * d;
  *reinterpret_cast<uint4*>(slot) =
      make_uint4(__byte_perm(w[0], w[1], sel), __byte_perm(w[1], w[2], sel),
                 __byte_perm(w[2], w[3], sel), __byte_perm(w[3], w[4], sel));
}

// Lane m (0..15) of run r's sixteen stores the bytes outside its whole
// slots (fewer than 16 before the first, fewer than 16 after the last), a
// byte a lane: one store instruction a side of a run. They share their
// 16-byte slots, and their sectors, with the neighbouring runs, which other
// blocks store.
__device__ __forceinline__ void store_edge_bytes(const Runs& runs, int n, int r,
                                                 int m) {
  if (r >= runs.rows || runs.len <= 0) return;
  const uintptr_t at = runs.at0 + static_cast<uintptr_t>(r) * n;
  const uintptr_t a1 = at + runs.len;
  const uintptr_t f0 = (at + 15) & ~static_cast<uintptr_t>(15);
  const uintptr_t f1 = a1 & ~static_cast<uintptr_t>(15);
  const uintptr_t head_end = f0 < a1 ? f0 : a1;
  const uintptr_t tail = f1 > head_end ? f1 : head_end;
  const int h = static_cast<int>(head_end - at);
  const int edge = h + static_cast<int>(a1 - tail);
  const uint8_t* s = runs.src0 + r * kPitch;
  for (int e = m; e < edge; e += 16) {
    const uintptr_t b = e < h ? at + e : tail + (e - h);
    *reinterpret_cast<uint8_t*>(b) = s[b - at];
  }
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
trim_adjacency_kernel(const float* __restrict__ src,
                      const float* __restrict__ dst, int8_t* __restrict__ out,
                      int n, int words, int groups, float beta) {
  __shared__ float4 rows[kGroup][64];
  // upper: row 32 I + r of warp I - kGroup S over the group's columns;
  // lower: row 32 J + l of the group over the row group's columns; the last
  // row's word reads may run 16 bytes past it
  __shared__ __align__(16) uint8_t upper[kGroup * 32 * kPitch + 16];
  __shared__ __align__(16) uint8_t lower[kGroup * 32 * kPitch + 16];

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  int S, g;
  decode_block_task(blockIdx.x, groups, S, g);
  const long long b = blockIdx.y;
  const float* ps = src + b * 3 * n;
  const float* pd = dst + b * 3 * n;
  const uintptr_t o = reinterpret_cast<uintptr_t>(out + b * n * static_cast<long long>(n));

  // this warp's task: row block I against the group's column blocks on or
  // right of the diagonal
  trim::Tile tile;
  tile.row_block = kGroup * S + w;
  tile.col_block0 = max(kGroup * g, tile.row_block);
  tile.active = min(kGroup * g + kGroup, words) - tile.col_block0;
  const bool live = tile.row_block < words && tile.active > 0;  // warp-uniform
  if (live) {
    // the filter's margin for this task (see trim::GramDistPred): the
    // largest row and column norms of both clouds
    const int ii = min(32 * tile.row_block + lane, n - 1);
    float cmax = 0.0f;
#pragma unroll
    for (int c = 0; c < trim::kColBlocks; ++c) {
      const int jj = min(32 * (tile.col_block0 + c) + lane, n - 1);
      cmax = fmaxf(cmax, point_norm(ps, n, jj) + point_norm(pd, n, jj));
    }
    const float t = (warp_max(point_norm(ps, n, ii) + point_norm(pd, n, ii)) +
                     warp_max(cmax)) * (1.0f + 0x1p-17f);
    const trim::GramDistPred pred{beta, nextafterf(beta, INFINITY),
                                  __fmaf_ru(0x1p-18f, t, 0x1p-59f)};
    trim::compute_tile_at(ps, pd, nullptr, n, pred, rows[w], lane, tile);
#pragma unroll
    for (int c = 0; c < trim::kColBlocks; ++c) {
      if (c < tile.active) {
        const int J = tile.col_block0 + c;
        // lane r: row 32 I + r over block J (its transposed word)
        stage32(upper + (32 * w + lane) * kPitch + 32 * (J - kGroup * g),
                tile.mirror[c]);
        // lane l: row 32 J + l over block I (its own word); a diagonal
        // block is stored once, from `upper`
        if (J != tile.row_block) {
          stage32(lower + (32 * (J - kGroup * g) + lane) * kPitch + 32 * w,
                  tile.word[c]);
        }
      }
    }
  }
  __syncthreads();

  // warp w stores the 32 upper rows of its row block (from column
  // 32 col_block0 to the group's end) and the 32 lower rows of column block
  // J = kGroup g + w (from column kRun S to the diagonal): 64 runs of up to
  // 128 bytes
  const int I = tile.row_block;
  const int J = kGroup * g + w;
  Runs up, lo;
  up.at0 = o + static_cast<uintptr_t>(32 * I) * n + 32 * tile.col_block0;
  up.src0 = upper + 32 * w * kPitch + 32 * (tile.col_block0 - kGroup * g);
  up.len = live ? min(32 * (kGroup * g + kGroup), n) - 32 * tile.col_block0 : 0;
  up.rows = live ? min(32, n - 32 * I) : 0;
  lo.at0 = o + static_cast<uintptr_t>(32 * J) * n + kRun * S;
  lo.src0 = lower + 32 * w * kPitch;
  lo.len = 32 * min(kGroup * S + kGroup, J) - kRun * S;
  lo.rows = J < words ? min(32, n - 32 * J) : 0;
  // whole 16-byte slots: 4 runs a store, 8 lanes a run
#pragma unroll 1
  for (int q = 0; q < 8; ++q) {
    store_slot<kAligned>(up, n, 4 * q + (lane >> 3), lane & 7);
  }
#pragma unroll 1
  for (int q = 0; q < 8; ++q) {
    store_slot<kAligned>(lo, n, 4 * q + (lane >> 3), lane & 7);
  }
  // the bytes at the runs' ends: 2 runs a store, 16 lanes a run
  if (!kAligned) {
#pragma unroll 1
    for (int q = 0; q < 16; ++q) store_edge_bytes(up, n, 2 * q + (lane >> 4), lane & 15);
#pragma unroll 1
    for (int q = 0; q < 16; ++q) store_edge_bytes(lo, n, 2 * q + (lane >> 4), lane & 15);
  }
}

// Every finite x >= 0 (bit patterns 0 .. 0x7f7fffff), strided: counts in
// out[0] the x whose sqrt_approx lies farther than 2^-21 sqrt(x) + 2^-63
// from __fsqrt_rn(x), and keeps in out[1] the largest distance of the two
// in units in the last place.
__global__ void sqrt_check_kernel(unsigned long long* out) {
  const unsigned kEnd = 0x7f800000u;
  unsigned long long bad = 0, worst = 0;
  for (unsigned u = blockIdx.x * blockDim.x + threadIdx.x; u < kEnd;
       u += gridDim.x * blockDim.x) {
    const float x = __uint_as_float(u);
    const float e = __fsqrt_rn(x);
    const float a = trim::sqrt_approx(x);
    const double err = fabs(static_cast<double>(a) - static_cast<double>(e));
    if (!(err <= ldexp(static_cast<double>(e), -21) + ldexp(1.0, -63))) ++bad;
    const long long ulps = llabs(static_cast<long long>(__float_as_uint(a)) -
                                 static_cast<long long>(__float_as_uint(e)));
    // (below the normal range sqrt_approx flushes to 0: no ulps to count)
    if (u >= 0x00800000u && static_cast<unsigned long long>(ulps) > worst) {
      worst = ulps;
    }
  }
  if (bad) atomicAdd(out, bad);
  atomicMax(out + 1, worst);
}

}  // namespace

extern "C" {

// src, dst: (batch, 3, n) float32; out: (batch, n, n) int8. Launches on
// `stream` and returns the launch's cudaError_t (0 on success); does not
// synchronise. A batch beyond 65,535 or a grid beyond INT_MAX blocks is
// refused (cudaErrorInvalidConfiguration) and nothing runs.
int trim_adjacency_launch(const float* src, const float* dst, int8_t* out,
                          int batch, int n, float beta, cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int words = (n + 31) / 32;
  const int groups = (words + kGroup - 1) / kGroup;
  const long long blocks = static_cast<long long>(groups) * (groups + 1) / 2;
  if (blocks > INT_MAX || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(static_cast<unsigned>(blocks), batch);
  // every run starts and ends on a 16-byte boundary: whole slots only
  if (n % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    trim_adjacency_kernel<true><<<grid, kThreads, 0, stream>>>(
        src, dst, out, n, words, groups, beta);
  } else {
    trim_adjacency_kernel<false><<<grid, kThreads, 0, stream>>>(
        src, dst, out, n, words, groups, beta);
  }
  return static_cast<int>(cudaGetLastError());
}

// The check that the filter's margin stands on (trim_tile.cuh's
// GramDistPred): sqrt_approx against __fsqrt_rn over every finite float
// x >= 0. `out` is two zeroed unsigned 64-bit integers on the card; once the
// work is done they hold the count of x outside the bound and the largest
// distance in units in the last place over normal x. Launches on `stream`.
int trim_adjacency_sqrt_check(unsigned long long* out, cudaStream_t stream) {
  sqrt_check_kernel<<<1024, 256, 0, stream>>>(out);
  return static_cast<int>(cudaGetLastError());
}

const char* trim_adjacency_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
