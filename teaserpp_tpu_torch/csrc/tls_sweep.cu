// Kernel S: the sweep of the scale TLS (ops/tls.py::scalar_tls) over every
// problem of a batch, from the stable sort's permutation of the 2N events.
//
// Replaces no Pallas kernel: the JAX package (teaserpp_tpu/ops/tls.py) writes
// the sweep as jnp sorts and cumulative sums. The plain version
// (ops/cuda_kernels.py::tls_sweep_plain) gathers six signed per-measurement
// quantities into float64 event streams, scans each with ops/tls.py's
// fixed-order prefix_sum, and reads the cost of every candidate from them;
// at 2K = 3.57M events a problem those streams moved ~224 B an event each
// through device memory.
//
// What it computes, in the plain version's order, so that its bits are the
// plain version's on the CPU:
//   * event e of a row is measurement i = perm[e] opening (perm[e] < N) or
//     i = perm[e] - N closing; its six deltas are +-vm, +-w, +-w x, +-r vm,
//     +-x vm, +-(x x) vm in T (w = vm / (vm > 0 ? r r : 1)), widened to
//     float64;
//   * prefix_sum's order: the row cut into blocks of 64 events (zero
//     padded), each block scanned by Hillis-Steele passes (pass p adds the
//     element 2^p places back), the block totals (element 63) scanned the
//     same way (the carry, by the wrapper), and block r's elements added to
//     carry[r - 1]; each sum rounded once to T. Padding only follows a
//     row's last element, so it changes no element of the row;
//   * the ranges' total: the same scan over the N values r vm, its last
//     element;
//   * each event's cost in T and the row's first minimum in torch.argmin's
//     order (a NaN first, ties to the lower index).
//
// Launches: tls_pack_kernel packs each measurement's x, r, vm and w into one
// 4-wide entry; tls_totals_kernel writes the block totals of the six streams
// and of the ranges' row, and the ranges' row's last in-block prefix;
// tls_carry_kernel scans the totals, one launch a level of 64^l (three at
// N = 1,889: 55,724 blocks a row); tls_sweep_kernel recomputes the in-block
// scans, adds the carries, and writes each tile's first minimum (cost,
// estimate); the wrapper reduces the tiles with torch.argmin.
//
// What bounds it on an H100: each of the two passes over the events reads
// every event's int64 permutation entry once, 16 B an event for both, at
// 3.35 TB/s (1.28 ms for the 267M events of one chunk, 75 problems at
// N = 1,889). Beside that it moves the measurements (x, r, vm read and the
// packed row written once, 14 B an event) and the block totals and the
// levels of their carry (about 5 B an event). An event gathers its measurement's packed
// (x, r, vm, w), one 32 B sector, from 28.5 MB a problem at K = 1.78M in
// float32, which L2 (50 MB) serves. Design: the grid is (tiles, problems)
// with the tile fastest, so the resident blocks sweep about one problem at a
// time and its packed row stays in L2; a warp takes four blocks of 64
// events, two events a lane, issues all their permutation loads before the
// first gather, and reduces (first pass) or scans (second) the float64
// streams with shuffles in registers; nothing but the block totals and one
// candidate a tile reaches device memory.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                          // warps a block
constexpr int kScanBlock = 64;                     // ops/tls.py::_SCAN_BLOCK
constexpr int kTileBlocks = 32;                    // scan blocks a tile
constexpr int kWarpBlocks = kTileBlocks / kWarps;  // a warp's: blocks warp + 8 q
constexpr int kStreams = 6;                        // card, w, w x, r vm, x vm, x x vm
constexpr int kRows = kStreams + 1;                // and the ranges' row
constexpr int kRng = 3;                            // the stream of r vm
constexpr unsigned kFull = 0xffffffffu;

// T's arithmetic rounded to nearest, never contracted into an FMA.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float narrow(double v, float) { return __double2float_rn(v); }
__device__ __forceinline__ double narrow(double v, double) { return v; }

struct Packed32 { float x, r, vm, w; };
struct Packed64 { double x, r, vm, w; };

__device__ __forceinline__ Packed32 load_packed(const float* rows, long long i) {
  const float4 v = reinterpret_cast<const float4*>(rows)[i];
  return {v.x, v.y, v.z, v.w};
}

__device__ __forceinline__ Packed64 load_packed(const double* rows, long long i) {
  const double2* p = reinterpret_cast<const double2*>(rows) + 2 * i;
  const double2 a = p[0], b = p[1];
  return {a.x, a.y, b.x, b.y};
}

__device__ __forceinline__ void store_packed(float* rows, long long i, Packed32 m) {
  reinterpret_cast<float4*>(rows)[i] = make_float4(m.x, m.r, m.vm, m.w);
}

__device__ __forceinline__ void store_packed(double* rows, long long i, Packed64 m) {
  double2* p = reinterpret_cast<double2*>(rows) + 2 * i;
  p[0] = make_double2(m.x, m.r);
  p[1] = make_double2(m.vm, m.w);
}

// The six float64 deltas of the event whose permutation entry is p, or
// zeros for p < 0, an event past the row's end (prefix_sum's padding).
template <typename T>
__device__ __forceinline__ void deltas(const T* packed, long long p, long long n,
                                       double d[kStreams]) {
  if (p < 0) {
#pragma unroll
    for (int s = 0; s < kStreams; ++s) d[s] = 0.0;
    return;
  }
  const bool close = p >= n;
  const auto m = load_packed(packed, close ? p - n : p);
  const T q[kStreams] = {m.vm, m.w, mul_rn(m.w, m.x), mul_rn(m.r, m.vm), mul_rn(m.x, m.vm),
                         mul_rn(mul_rn(m.x, m.x), m.vm)};
#pragma unroll
  for (int s = 0; s < kStreams; ++s) d[s] = static_cast<double>(close ? -q[s] : q[s]);
}

// r vm of measurement i of a row of n (0 past its end), widened.
template <typename T>
__device__ __forceinline__ double range_term(const T* packed, long long i, long long n) {
  if (i >= n) return 0.0;
  const auto m = load_packed(packed, i);
  return static_cast<double>(mul_rn(m.r, m.vm));
}

// Hillis-Steele inclusive scan of a warp's 64 elements: `a` holds element
// `lane`, `c` element `lane + 32`. Pass k adds element i - k to element i >= k
// and leaves i < k as it is, as ops/tls.py::_shifted_add_scan.
__device__ __forceinline__ void block_scan(double& a, double& c, int lane) {
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const int from = (lane - k) & 31;  // element i - k: lane - k of a half, or of the low half
    const double ua = __shfl_sync(kFull, a, from);
    const double uc = __shfl_sync(kFull, c, from);
    c = __dadd_rn(c, lane >= k ? uc : ua);
    if (lane >= k) a = __dadd_rn(a, ua);
  }
  c = __dadd_rn(c, a);  // k = 32
}

// torch.argmin's order of candidates: a NaN before anything else, then the
// smaller cost, and between equals the lower index.
template <typename T>
__device__ __forceinline__ bool precedes(T ca, long long ia, T cb, long long ib) {
  const bool nan_a = ca != ca, nan_b = cb != cb;
  if (nan_a) return !nan_b || ia < ib;
  if (nan_b) return false;
  return ca < cb || (ca == cb && ia < ib);
}

template <typename T>
struct Best {
  T cost, x_hat;
  long long idx;

  __device__ __forceinline__ void take(T c, T x, long long i) {
    if (precedes(c, i, cost, idx)) {
      cost = c;
      x_hat = x;
      idx = i;
    }
  }
};

// Each measurement's x, r, vm and weight w = vm / (vm > 0 ? r r : 1),
// packed into one 4-wide row entry, so that an event gathers one sector.
template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
tls_pack_kernel(const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ vm,
                T* __restrict__ packed, long long count) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    using P = decltype(load_packed(packed, 0));
    const T v = vm[i], ri = r[i];
    store_packed(packed, i, P{x[i], ri, v, div_rn(v, v > T(0) ? mul_rn(ri, ri) : T(1))});
  }
}

// Element 63 of a block's scan, the block total: every sum it takes covers a
// whole window of 2^(p+1) elements (63 >= 2^(p+1) - 1 for p <= 5), so it is
// the balanced pairwise tree of the block: elements 2l and 2l + 1 in lane l,
// then lanes l and l + 2^p. The total lands in lane 0.
__device__ __forceinline__ double block_total(double lo, double hi) {
  double t = __dadd_rn(lo, hi);
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) t = __dadd_rn(t, __shfl_down_sync(kFull, t, k));
  return t;
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
tls_totals_kernel(const int64_t* __restrict__ perm, const T* __restrict__ packed,
                  double* __restrict__ totals, double* __restrict__ last, long long n,
                  long long blocks, long long rng_blocks, long long tiles) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = blockIdx.x / tiles;
  const long long tile = blockIdx.x % tiles;
  const long long len = 2 * n;
  const int64_t* row = perm + b * len;
  const T* meas = packed + b * n * 4;
  double* tot = totals + b * kRows * blocks;

  // Events 2l and 2l + 1 of each of the warp's blocks, one 16 B load of the
  // permutation each, all issued before the first block's gathers (a row has
  // an even number of events: both or neither lie in it).
  longlong2 pp[kWarpBlocks];
#pragma unroll
  for (int q = 0; q < kWarpBlocks; ++q) {
    const long long e = (tile * kTileBlocks + warp + q * kWarps) * kScanBlock + 2 * lane;
    pp[q] = e < len ? reinterpret_cast<const longlong2*>(row + e)[0] : make_longlong2(-1, -1);
  }
#pragma unroll
  for (int q = 0; q < kWarpBlocks; ++q) {
    const long long r = tile * kTileBlocks + warp + q * kWarps;
    if (r >= blocks) break;
    double lo[kStreams], hi[kStreams];
    deltas(meas, pp[q].x, n, lo);
    deltas(meas, pp[q].y, n, hi);
    double t[kStreams];
#pragma unroll
    for (int s = 0; s < kStreams; ++s) t[s] = block_total(lo[s], hi[s]);
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < kStreams; ++s) tot[s * blocks + r] = t[s];
    }

    // the ranges' row: N values r vm, in blocks of its own (0 past its end)
    double rng = 0.0;
    if (r < rng_blocks) {
      const long long i = r * kScanBlock;
      rng = block_total(range_term(meas, i + 2 * lane, n), range_term(meas, i + 2 * lane + 1, n));
      if (r == rng_blocks - 1) {  // the row's last element: the whole scan of its block
        double ra = range_term(meas, i + lane, n), rc = range_term(meas, i + 32 + lane, n);
        block_scan(ra, rc, lane);
        const int end = static_cast<int>((n - 1) % kScanBlock);
        if (lane == (end & 31)) last[b] = end < 32 ? ra : rc;
      }
    }
    if (lane == 0) tot[kStreams * blocks + r] = rng;
  }
}

// One level of the carry: the Hillis-Steele passes k = s, 2s, ..., 32s of a
// scan of rows of `len` float64 values (ops/tls.py::_shifted_add_scan),
// stride s = 64^level. Those passes act on each residue class mod s alone,
// as passes 1, 2, ..., 32 of the class's own scan (element c + s m gains
// element c + s (m - k') when m >= k'), and element m of a class after them
// sums elements m - 63..m of the class. So a warp writes 64 outputs m of
// one class from a window of the 128 elements up to them, four a lane (m0 +
// 32 j + lane): the window's first elements, which lack elements before it,
// are never added to an output. Passes 64s and up are the next levels'.
__global__ void __launch_bounds__(32 * kWarps)
tls_carry_kernel(const double* __restrict__ in, double* __restrict__ out, long long len,
                 long long stride, long long tiles, long long warps) {
  const long long w = blockIdx.x * static_cast<long long>(kWarps) + (threadIdx.x >> 5);
  if (w >= warps) return;  // a whole warp
  const int lane = threadIdx.x & 31;
  const long long c = w % stride;  // the class, fastest: a block's warps share sectors
  const long long t = w / stride % tiles;
  const long long row = w / stride / tiles;
  const long long count = (len - c + stride - 1) / stride;  // the class's elements
  const double* x = in + row * len + c;
  const long long m0 = kScanBlock * (t - 1);
  double v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long m = m0 + 32 * j + lane;
    v[j] = m >= 0 && m < count ? x[m * stride] : 0.0;
  }
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    double u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) u[j] = __shfl_sync(kFull, v[j], (lane - k) & 31);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (m0 + 32 * j + lane < k) continue;
      if (lane >= k) v[j] = __dadd_rn(v[j], u[j]);
      else if (j > 0) v[j] = __dadd_rn(v[j], u[j - 1]);  // j = 0: before the window
    }
  }
#pragma unroll
  for (int j = 3; j > 0; --j)  // k = 32, from the top, so v[j - 1] is still the old value
    if (m0 + 32 * j + lane >= 32) v[j] = __dadd_rn(v[j], v[j - 1]);
  double* y = out + row * len + c;
#pragma unroll
  for (int j = 2; j < 4; ++j) {
    const long long m = m0 + 32 * j + lane;
    if (m < count) y[m * stride] = v[j];
  }
}

template <typename T>
__device__ __forceinline__ void candidate(const double v[kStreams], T total, long long e,
                                          long long len, Best<T>& best) {
  if (e >= len) return;
  const T card = narrow(v[0], T());
  const T cum_w = narrow(v[1], T());
  const T cum_xw = narrow(v[2], T());
  const T cum_rng = -narrow(v[kRng], T());
  const T cum_sx = narrow(v[4], T());
  const T cum_sx2 = narrow(v[5], T());
  const T outlier_pen = add_rn(total, cum_rng);
  const bool consensus = card > T(0.5);
  const T x_hat = div_rn(cum_xw, consensus ? cum_w : T(1));
  const T residual = sub_rn(add_rn(mul_rn(mul_rn(card, x_hat), x_hat), cum_sx2),
                         mul_rn(mul_rn(T(2), cum_sx), x_hat));
  const T cost = consensus ? add_rn(residual, outlier_pen) : T(INFINITY);
  best.take(cost, x_hat, e);
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
tls_sweep_kernel(const int64_t* __restrict__ perm, const T* __restrict__ packed,
                 const double* __restrict__ carry, const double* __restrict__ last,
                 T* __restrict__ tile_cost, T* __restrict__ tile_x_hat, long long n,
                 long long blocks, long long rng_blocks, long long tiles) {
  __shared__ T warp_cost[kWarps];
  __shared__ T warp_x_hat[kWarps];
  __shared__ long long warp_idx[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = blockIdx.x / tiles;
  const long long tile = blockIdx.x % tiles;
  const long long len = 2 * n;
  const int64_t* row = perm + b * len;
  const T* meas = packed + b * n * 4;
  const double* car = carry + b * kRows * blocks;

  double rng_total = last[b];
  if (rng_blocks > 1) rng_total = __dadd_rn(rng_total, car[kStreams * blocks + rng_blocks - 2]);
  const T total = narrow(rng_total, T());

  Best<T> best{T(INFINITY), T(0), LLONG_MAX};
  long long pa[kWarpBlocks], pc[kWarpBlocks];  // as the first pass: all loaded first
#pragma unroll
  for (int q = 0; q < kWarpBlocks; ++q) {
    const long long e = (tile * kTileBlocks + warp + q * kWarps) * kScanBlock + lane;
    pa[q] = e < len ? row[e] : -1;
    pc[q] = e + 32 < len ? row[e + 32] : -1;
  }
#pragma unroll
  for (int q = 0; q < kWarpBlocks; ++q) {
    const long long r = tile * kTileBlocks + warp + q * kWarps;
    if (r >= blocks) break;
    const long long e = r * kScanBlock + lane;
    double a[kStreams], c[kStreams];
    deltas(meas, pa[q], n, a);
    deltas(meas, pc[q], n, c);
#pragma unroll
    for (int s = 0; s < kStreams; ++s) block_scan(a[s], c[s], lane);
    if (r > 0) {
#pragma unroll
      for (int s = 0; s < kStreams; ++s) {
        const double k = car[s * blocks + r - 1];
        a[s] = __dadd_rn(a[s], k);
        c[s] = __dadd_rn(c[s], k);
      }
    }
    candidate(a, total, e, len, best);
    candidate(c, total, e + 32, len, best);
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T cost = __shfl_xor_sync(kFull, best.cost, off);
    const T x_hat = __shfl_xor_sync(kFull, best.x_hat, off);
    const long long idx = __shfl_xor_sync(kFull, best.idx, off);
    best.take(cost, x_hat, idx);
  }
  if (lane == 0) {
    warp_cost[warp] = best.cost;
    warp_x_hat[warp] = best.x_hat;
    warp_idx[warp] = best.idx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) best.take(warp_cost[w], warp_x_hat[w], warp_idx[w]);
    tile_cost[b * tiles + tile] = best.cost;
    tile_x_hat[b * tiles + tile] = best.x_hat;
  }
}

// Blocks of a row of `n` measurements: of 2n events, of the ranges' n values,
// and tiles; 0 when the launch is refused.
int shape(int batch, int n, long long tiles, long long* blocks, long long* rng_blocks) {
  *blocks = (2LL * n + kScanBlock - 1) / kScanBlock;
  *rng_blocks = (static_cast<long long>(n) + kScanBlock - 1) / kScanBlock;
  if (tiles != (*blocks + kTileBlocks - 1) / kTileBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(batch) * tiles > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  return 0;
}

}  // namespace

extern "C" {

// x, r, vm: (count,) float32 (f64 0) or float64 (f64 1); packed out:
// (count, 4) of the same type, every element written. Launches on `stream`
// and returns the launch's cudaError_t; does not synchronise.
int tls_pack_launch(const void* x, const void* r, const void* vm, void* packed, long long count,
                    int f64, cudaStream_t stream) {
  if (count <= 0) return 0;
  const long long want = (count + 32 * kWarps - 1) / (32 * kWarps);
  const unsigned grid = static_cast<unsigned>(want < 65536 ? want : 65536);
  if (f64)
    tls_pack_kernel<double><<<grid, 32 * kWarps, 0, stream>>>(
        static_cast<const double*>(x), static_cast<const double*>(r),
        static_cast<const double*>(vm), static_cast<double*>(packed), count);
  else
    tls_pack_kernel<float><<<grid, 32 * kWarps, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(r),
        static_cast<const float*>(vm), static_cast<float*>(packed), count);
  return static_cast<int>(cudaGetLastError());
}

// perm: (batch, 2n) int64, each row a permutation of [0, 2n) (the stable
// sort of the events); packed: (batch, n, 4) of x, r, vm, w, float32 (f64 0)
// or float64 (f64 1); totals out: (batch, 7, blocks) float64, blocks =
// ceil(2n / 64); last out: (batch,) float64; tiles = ceil(blocks / 32).
// Every element of both outputs is written. Launches on `stream` and
// returns the launch's cudaError_t (0 on success); does not synchronise.
int tls_totals_launch(const int64_t* perm, const void* packed, double* totals, double* last,
                      int batch, int n, long long tiles, int f64, cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  long long blocks, rng_blocks;
  const int rc = shape(batch, n, tiles, &blocks, &rng_blocks);
  if (rc != 0) return rc;
  const unsigned grid = static_cast<unsigned>(batch * tiles);
  if (f64)
    tls_totals_kernel<double><<<grid, 32 * kWarps, 0, stream>>>(
        perm, static_cast<const double*>(packed), totals, last, n, blocks, rng_blocks, tiles);
  else
    tls_totals_kernel<float><<<grid, 32 * kWarps, 0, stream>>>(
        perm, static_cast<const float*>(packed), totals, last, n, blocks, rng_blocks, tiles);
  return static_cast<int>(cudaGetLastError());
}

// in, out: (rows, len) float64, distinct; stride: a power of 64 below len,
// or 1. Writes out, every element: the passes k = stride, ..., 32 stride of
// in's scan along its rows (one level of the carry). Launches on `stream`
// and returns the launch's cudaError_t; does not synchronise.
int tls_carry_launch(const double* in, double* out, long long rows, long long len,
                     long long stride, cudaStream_t stream) {
  if (rows <= 0 || len <= 0) return 0;
  if (stride < 1 || (stride > 1 && stride >= len)) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = ((len + stride - 1) / stride + kScanBlock - 1) / kScanBlock;
  if (rows > LLONG_MAX / tiles / stride) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long warps = rows * tiles * stride;
  const long long grid = (warps + kWarps - 1) / kWarps;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  tls_carry_kernel<<<static_cast<unsigned>(grid), 32 * kWarps, 0, stream>>>(
      in, out, len, stride, tiles, warps);
  return static_cast<int>(cudaGetLastError());
}

// carry: the totals scanned along their last dimension (tls_carry_launch's
// levels); tile_cost, tile_x_hat out: (batch, tiles) of the
// packed type, each tile's first minimum in torch.argmin's order. Other
// arguments as tls_totals_launch's.
int tls_sweep_launch(const int64_t* perm, const void* packed, const double* carry,
                     const double* last, void* tile_cost, void* tile_x_hat, int batch, int n,
                     long long tiles, int f64, cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  long long blocks, rng_blocks;
  const int rc = shape(batch, n, tiles, &blocks, &rng_blocks);
  if (rc != 0) return rc;
  const unsigned grid = static_cast<unsigned>(batch * tiles);
  if (f64)
    tls_sweep_kernel<double><<<grid, 32 * kWarps, 0, stream>>>(
        perm, static_cast<const double*>(packed), carry, last, static_cast<double*>(tile_cost),
        static_cast<double*>(tile_x_hat), n, blocks, rng_blocks, tiles);
  else
    tls_sweep_kernel<float><<<grid, 32 * kWarps, 0, stream>>>(
        perm, static_cast<const float*>(packed), carry, last, static_cast<float*>(tile_cost),
        static_cast<float*>(tile_x_hat), n, blocks, rng_blocks, tiles);
  return static_cast<int>(cudaGetLastError());
}

const char* tls_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
