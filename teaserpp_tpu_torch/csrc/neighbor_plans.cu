// The front end's neighbour plans (features/spatial.py::NeighborPlan) built on
// the card: each point's grid cell key, each query block's occupied cells
// within a radius's reach, and each block's padded candidate list.
//
// Replaces no Pallas kernel: the JAX package builds the plans in host numpy
// (teaserpp_tpu/features/spatial.py::build_neighbor_plans), and so does the
// port's copy of it, which stays the CPU route. On a 100,000-point cloud that
// copy took ~0.4 s of host time while the card waited (152 np.searchsorted
// passes over the (block, cell) incidences, a (blocks, cells) bool mark, its
// product with the cell lengths and a Python loop over the blocks). The
// plain version is features/spatial.py::build_neighbor_plans_plain.
//
// What it computes, the host copy's integers element for element (the
// wrapper, features/spatial.py::build_neighbor_plans_tensor, sorts and finds
// the cells with tensor operations between the launches):
//   * keys: ijk = floor((p - lo) / cell) in float64, each operation rounded
//     to nearest and never contracted, as numpy computes it; the grid's
//     sizes d = floor((hi - lo) / cell) + 1 (the largest index plus one, as
//     the map from a coordinate to its index is monotone); the packed key
//     (i d1 + j) d2 + k in int64;
//   * mark: for each (block, cell) incidence of the sorted cloud (the first
//     point of a cell within a block) and each of the reach's (2r+1)^2 rows
//     of offsets (di, dj), the occupied cells whose keys lie in
//     [key + (di d1 + dj) d2 - r, key + (di d1 + dj) d2 + r]: the host's
//     (2r+1)^3 packed offsets, a row of dk at a time, so an offset that wraps
//     across a grid row or slab hits an occupied cell as it does on the host.
//     One binary search a row finds the first key of the range in the unique
//     keys, and a walk takes the rest. A hit sets the block's bit of the cell
//     (atomicOr) and, when it is new, adds the cell's length to its word's
//     sum (atomicAdd of integers, exact in any order);
//   * candidates: a block's marked cells in ascending cell order, each the
//     sorted-order range [start, start + len), concatenated and padded with
//     n to the plan's width: the words' sums scanned across the block give
//     each thread's offset.
//
// What bounds it on an H100: bytes. The keys read the float64 cloud (2.4 MB at
// N = 100,000) and write 0.8 MB; the marks read the sorted keys and, by
// binary search, the unique keys (0.5 MB, which L2 holds); the candidate
// lists are 2.8 MB for the FPFH radius; with the bitmaps and word sums (1.3
// MB each a radius) about 10 MB a cloud, ~3 us at 3.35 TB/s. In practice the
// launches and the wrapper's one host read of the widths bound it. Design:
// every table is over occupied cells (the unique keys) or sorted points,
// never over the grid's bounding box, whose cells may number 1e9 on a
// scan; the mark is a bitmap of blocks x points bits (points bound the
// occupied cells, so no host read of their count is needed).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // threads a block of the keys and marks
constexpr int kCandThreads = 1024;  // threads a block of the candidate lists
constexpr int kMaxReach = 7;        // features/spatial.py refuses more
constexpr unsigned kFull = 0xffffffffu;

// floor((p - lo) / cell), each operation rounded to nearest as numpy's.
__device__ __forceinline__ long long cell_index(double p, double lo, double cell) {
  return static_cast<long long>(floor(__ddiv_rn(__dsub_rn(p, lo), cell)));
}

// a * b + c in int64 with numpy's wrap-around on overflow.
__device__ __forceinline__ long long wrap_mad(long long a, long long b, long long c) {
  return static_cast<long long>(static_cast<unsigned long long>(a) *
                                    static_cast<unsigned long long>(b) +
                                static_cast<unsigned long long>(c));
}

// lohi: (2, 3) float64, the cloud's minimum then maximum.
struct Grid {
  long long d1, d2;
  __device__ Grid(const double* lohi, double cell)
      : d1(cell_index(lohi[4], lohi[1], cell) + 1), d2(cell_index(lohi[5], lohi[2], cell) + 1) {}
};

__global__ void __launch_bounds__(kThreads)
plan_keys_kernel(const double* __restrict__ pts, const double* __restrict__ lohi, double cell,
                 long long n, long long* __restrict__ keys) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const Grid g(lohi, cell);
  const long long a = cell_index(pts[3 * i], lohi[0], cell);
  const long long b = cell_index(pts[3 * i + 1], lohi[1], cell);
  const long long c = cell_index(pts[3 * i + 2], lohi[2], cell);
  keys[i] = wrap_mad(wrap_mad(a, g.d1, b), g.d2, c);
}

// A thread a sorted point and row of offsets (blockIdx.y); points that are
// no incidence return at once.
__global__ void __launch_bounds__(kThreads)
plan_mark_kernel(const long long* __restrict__ skey, const long long* __restrict__ uniq,
                 const long long* __restrict__ lens, const double* __restrict__ lohi,
                 double cell, long long n, int block, int reach, long long words,
                 unsigned* __restrict__ mark, int* __restrict__ wsum) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long key = skey[i];
  if (i % block != 0 && skey[i - 1] == key) return;
  const int side = 2 * reach + 1;
  const long long di = static_cast<int>(blockIdx.y) / side - reach;
  const long long dj = static_cast<int>(blockIdx.y) % side - reach;
  const Grid g(lohi, cell);
  const long long centre = wrap_mad(wrap_mad(di, g.d1, dj), g.d2, key);
  const long long first = centre - reach, last = centre + reach;
  long long lo = 0, hi = n;  // the first unique key >= first (padding is INT64_MAX)
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (uniq[mid] < first) lo = mid + 1;
    else hi = mid;
  }
  const long long row = (i / block) * words;
  for (long long c = lo; c < n && uniq[c] <= last; ++c) {
    const unsigned bit = 1u << (c & 31);
    if (!(atomicOr(mark + row + (c >> 5), bit) & bit))
      atomicAdd(wsum + row + (c >> 5), static_cast<int>(lens[c]));
  }
}

// A block a query block: each thread a run of words of the block's bitmap.
__global__ void __launch_bounds__(kCandThreads)
plan_cands_kernel(const unsigned* __restrict__ mark, const int* __restrict__ wsum,
                  const long long* __restrict__ starts, const long long* __restrict__ lens,
                  long long words, int mpad, int fill, int* __restrict__ out) {
  __shared__ int warp_total[kCandThreads / 32];
  const long long b = blockIdx.x;
  const unsigned* m = mark + b * words;
  const int* s = wsum + b * words;
  int* o = out + b * mpad;
  const long long per = (words + kCandThreads - 1) / kCandThreads;
  const long long w0 = min(words, threadIdx.x * per), w1 = min(words, w0 + per);
  int own = 0;
  for (long long w = w0; w < w1; ++w) own += s[w];
  // the block's exclusive scan of the threads' sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = own;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = warp_total[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, t, d);
      if (lane >= d) t += v;
    }
    warp_total[lane] = t;
  }
  __syncthreads();
  int off = incl - own + (warp > 0 ? warp_total[warp - 1] : 0);
  const int total = warp_total[kCandThreads / 32 - 1];
  for (long long w = w0; w < w1; ++w) {
    for (unsigned bits = m[w]; bits; bits &= bits - 1) {
      const long long c = w * 32 + __ffs(bits) - 1;
      const long long start = starts[c];
      const int len = static_cast<int>(lens[c]);
      for (int k = 0; k < len && off + k < mpad; ++k) o[off + k] = static_cast<int>(start + k);
      off += len;
    }
  }
  for (int j = total + threadIdx.x; j < mpad; j += kCandThreads) o[j] = fill;
}

}  // namespace

extern "C" {

// pts: (n, 3) float64; lohi: (2, 3) float64, its minimum then maximum;
// keys out: (n,) int64, every element written. Launches on `stream` and
// returns the launch's cudaError_t; does not synchronise.
int plan_keys_launch(const double* pts, const double* lohi, double cell, long long n,
                     long long* keys, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!(cell > 0)) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (n + kThreads - 1) / kThreads;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  plan_keys_kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(pts, lohi, cell, n,
                                                                        keys);
  return static_cast<int>(cudaGetLastError());
}

// skey: (n,) the sorted keys; uniq: (n,) the unique keys ascending, then
// INT64_MAX; lens: (n,) each unique cell's point count, then 0; mark:
// (ceil(n / block), words) uint32 and wsum: (ceil(n / block), words) int32,
// both zeroed, words >= ceil(n / 32). Sets the bits of the marked cells and
// adds their lengths to their words' sums. Launches on `stream` and returns
// the launch's cudaError_t; does not synchronise.
int plan_mark_launch(const long long* skey, const long long* uniq, const long long* lens,
                     const double* lohi, double cell, long long n, int block, int reach,
                     long long words, unsigned* mark, int* wsum, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!(cell > 0) || block < 1 || reach < 0 || reach > kMaxReach || words < (n + 31) / 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (n + kThreads - 1) / kThreads;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 blocks(static_cast<unsigned>(grid), (2 * reach + 1) * (2 * reach + 1));
  plan_mark_kernel<<<blocks, kThreads, 0, stream>>>(skey, uniq, lens, lohi, cell, n, block,
                                                    reach, words, mark, wsum);
  return static_cast<int>(cudaGetLastError());
}

// mark, wsum: plan_mark_launch's, (nblocks, words); starts, lens: (>= 32
// words,) each unique cell's first sorted index and point count; out:
// (nblocks, mpad) int32, every element written: each block's candidate
// list padded with `fill`. mpad must hold every block's count. Launches on
// `stream` and returns the launch's cudaError_t; does not synchronise.
int plan_cands_launch(const unsigned* mark, const int* wsum, const long long* starts,
                      const long long* lens, long long nblocks, long long words, int mpad,
                      int fill, int* out, cudaStream_t stream) {
  if (nblocks <= 0) return 0;
  if (words < 1 || mpad < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (nblocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  plan_cands_kernel<<<static_cast<unsigned>(nblocks), kCandThreads, 0, stream>>>(
      mark, wsum, starts, lens, words, mpad, fill, out);
  return static_cast<int>(cudaGetLastError());
}

const char* neighbor_plans_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
