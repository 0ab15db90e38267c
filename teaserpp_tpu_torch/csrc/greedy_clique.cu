// The batched greedy clique: every greedy step of every (problem, seed)
// lane in one launch, on the adjacency's packed words.
//
// Replaces no Pallas kernel. In the JAX package the greedy
// (teaserpp_tpu/clique/heuristic.py::_greedy_from_seed) is a vmapped
// lax.while_loop of masked argmaxes; a host loop of PyTorch operations in
// its place synchronised with the host once a step and streamed a
// (B, S, N) score plane through the card to pick one vertex a lane.
//
// The step rule is the JAX package's: a lane takes the candidate with the
// highest core number, ties to the lowest index, then ANDs the pick's
// adjacency row into its candidates, until none is left. `order` is each
// problem's core order (core numbers descending, then index ascending: a
// stable descending sort), so the pick is the first candidate in `order`.
// A lane's candidates only shrink, so a vertex that is no candidate when
// the lane's scan passes it never becomes one again: each lane keeps a
// cursor into `order` that only moves forward, and a step advances it to
// the first entry whose bit is set. A lane scans at most n order entries
// plus, per step, one row of W = ceil(n/32) words.
//
//   rows[b, v, w]   bit j: vertex 32 w + j is adjacent to v (zero diagonal)
//   order[b, p]     the p-th vertex of problem b's core order
//   allowed[b, w]   bit j: vertex 32 w + j may be a candidate; a lane whose
//                   seed is not allowed has no candidates (padding, skip)
//   members[b, s, w], sizes[b, s]: the clique of lane s, seeded with
//                   order[b, s], and its number of vertices
//
// What bounds it on an H100: the row words its steps read, sum over lanes
// of (size - 1) W 4 bytes, at the memory's 3.35 TB/s if no step found its
// row in L2 (a problem's rows are read by all its lanes, so most come from
// L2), and the latency of each lane's chain of dependent steps: a step
// needs the previous step's AND before its scan. Design: one warp a lane,
// its candidates and members in shared memory (2 W words); the scan reads
// 32 order entries a round (the problem's lanes share them through L1) and
// picks with __ballot_sync / __ffs; the row is read as W consecutive words,
// all of a warp's loads of a step in flight together. Blocks hold the
// lanes of one problem; the warps a block holds are set by W (and capped by
// the seeds), so a block's shared memory stays within the default 48 KB
// where it can.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kDefaultShared = 48 * 1024;
constexpr int kMaxShared = 227 * 1024;  // a block's limit on Hopper
constexpr int kLoads = 4;                // row words a thread loads at once
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool has_bit(const uint32_t* set, int v) {
  return (set[v >> 5] >> (v & 31)) & 1u;
}

__global__ void __launch_bounds__(32 * kMaxWarps)
greedy_clique_kernel(const uint32_t* __restrict__ rows, const int32_t* __restrict__ order,
                     const uint32_t* __restrict__ allowed, uint32_t* __restrict__ members,
                     int32_t* __restrict__ sizes, int n, int words, int seeds,
                     int groups) {
  extern __shared__ uint32_t shared[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = blockIdx.x / groups;
  const int s = (blockIdx.x % groups) * (blockDim.x >> 5) + warp;
  if (s >= seeds) return;  // a whole warp; no block-wide barrier below

  uint32_t* cand = shared + 2 * warp * words;
  uint32_t* member = cand + words;
  const int32_t* ord = order + b * n;
  const uint32_t* rows_b = rows + b * n * words;
  const uint32_t* allow = allowed + b * words;

  const int seed = ord[s];
  const bool in_range = seed >= 0 && seed < n;
  const bool open = in_range && has_bit(allow, seed);
  const uint32_t* row = rows_b + static_cast<long long>(open ? seed : 0) * words;
  bool any = false;
  for (int w = lane; w < words; w += 32) {
    const uint32_t c = open ? (row[w] & allow[w]) : 0u;
    cand[w] = c;
    member[w] = in_range && w == (seed >> 5) ? 1u << (seed & 31) : 0u;
    any |= c != 0u;
  }
  int size = in_range ? 1 : 0;
  int pos = 0;  // the cursor: no candidate lies before it in `ord`
  __syncwarp();
  bool running = __any_sync(kFull, any);

  while (running) {
    int pick = -1;
    for (; pos < n; pos += 32) {
      const int p = pos + lane;
      const int v = p < n ? ord[p] : -1;
      const bool hit = v >= 0 && v < n && has_bit(cand, v);
      const unsigned found = __ballot_sync(kFull, hit);
      if (found) {
        const int k = __ffs(found) - 1;
        pick = __shfl_sync(kFull, v, k);
        pos += k + 1;
        break;
      }
    }
    if (pick < 0) break;  // candidates left only behind the cursor
    if (lane == 0) member[pick >> 5] |= 1u << (pick & 31);
    ++size;

    row = rows_b + static_cast<long long>(pick) * words;
    any = false;
    for (int w0 = 0; w0 < words; w0 += 32 * kLoads) {
      uint32_t x[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int w = w0 + 32 * k + lane;
        x[k] = w < words ? row[w] : 0u;
      }
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int w = w0 + 32 * k + lane;
        if (w < words) {
          const uint32_t c = cand[w] & x[k];
          cand[w] = c;
          any |= c != 0u;
        }
      }
    }
    __syncwarp();
    running = __any_sync(kFull, any);
  }

  __syncwarp();
  uint32_t* out = members + (b * seeds + s) * words;
  for (int w = lane; w < words; w += 32) out[w] = member[w];
  if (lane == 0) sizes[b * seeds + s] = size;
}

// Warps a block for rows of `words` words: as many as fit the default
// shared memory, at most kMaxWarps, at least one.
int warps_for(int words) {
  const int per_warp = 2 * words * static_cast<int>(sizeof(uint32_t));
  const int fit = kDefaultShared / per_warp;
  return fit < 1 ? 1 : (fit > kMaxWarps ? kMaxWarps : fit);
}

}  // namespace

extern "C" {

// rows: (batch, n, ceil(n/32)) int32; order: (batch, n) int32, each row a
// permutation of [0, n); allowed: (batch, ceil(n/32)) int32; members out:
// (batch, seeds, ceil(n/32)) int32; sizes out: (batch, seeds) int32;
// 1 <= seeds <= n. Every word of both outputs is written. Launches on
// `stream` and returns the launch's cudaError_t (0 on success); does not
// synchronise. An entry of `order` outside [0, n) is never picked.
int greedy_clique_launch(const int32_t* rows, const int32_t* order, const int32_t* allowed,
                         int32_t* members, int32_t* sizes, int batch, int n, int seeds,
                         cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (seeds < 1 || seeds > n) return static_cast<int>(cudaErrorInvalidValue);
  const int words = (n + 31) / 32;
  const long long per_warp = 2LL * words * sizeof(uint32_t);
  if (per_warp > kMaxShared) return static_cast<int>(cudaErrorInvalidConfiguration);
  int warps = warps_for(words);
  if (warps > seeds) warps = seeds;
  const int groups = (seeds + warps - 1) / warps;
  const long long blocks = static_cast<long long>(batch) * groups;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int shared = static_cast<int>(warps * per_warp);
  if (shared > kDefaultShared) {
    const cudaError_t err = cudaFuncSetAttribute(
        greedy_clique_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  greedy_clique_kernel<<<static_cast<unsigned>(blocks), 32 * warps, shared, stream>>>(
      reinterpret_cast<const uint32_t*>(rows), order,
      reinterpret_cast<const uint32_t*>(allowed), reinterpret_cast<uint32_t*>(members),
      sizes, n, words, seeds, groups);
  return static_cast<int>(cudaGetLastError());
}

const char* greedy_clique_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
