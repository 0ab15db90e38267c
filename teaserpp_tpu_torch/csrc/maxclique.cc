// Exact maximum-clique search on a dense bitset graph.
//
// The port's own copy of teaserpp_tpu/clique/native/maxclique.cc (host C++,
// no CUDA): the native equivalent of the external PMC library the
// reference fetches (teaser/CMakeLists.txt:6-13) and drives from
// graph.cc:12-125: a branch-and-bound with greedy-coloring upper bounds
// (Tomita-style), degeneracy-ordered root expansion, k-core pruning, an
// initial greedy lower bound, and a wall-clock time limit that degrades the
// answer to best-found-so-far (reference graph.h:256 semantics).
//
// Written from scratch for this framework; the graph arrives as row-major
// bitset words so Python hands over a packed numpy array with zero copies.
//
// Build: teaserpp_tpu_torch/ops/_build.py compiles it with g++ at first use
// (-O3 -march=native -std=c++17 -shared -fPIC -pthread).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

// Word operations of coloring (a coloring of P costs |P| x words) after
// which the search turns to the near-clique search: about a second of one
// core, more than the search takes on the graphs that it finishes quickly.
constexpr long long kColoringWork = 1LL << 28;

struct BitRow {
  const uint64_t* p;
  int words;
  bool test(int v) const { return (p[v >> 6] >> (v & 63)) & 1ULL; }
};

inline int popcount_words(const uint64_t* a, int words) {
  int c = 0;
  for (int i = 0; i < words; ++i) c += __builtin_popcountll(a[i]);
  return c;
}

inline int first_bit(const std::vector<uint64_t>& a) {
  for (size_t i = 0; i < a.size(); ++i)
    if (a[i]) return int(i * 64 + __builtin_ctzll(a[i]));
  return -1;
}

inline bool any_bit(const std::vector<uint64_t>& a) {
  for (uint64_t w : a)
    if (w) return true;
  return false;
}

// Shared incumbent for (optionally multi-threaded) branch-and-bound: the
// size is an atomic read for lock-free pruning; the vector updates under a
// mutex (PMC shares its bound across OpenMP threads the same way).
struct Incumbent {
  std::atomic<int> size{0};
  std::vector<int> verts;
  std::mutex mu;

  void offer(const std::vector<int>& c) {
    int s = int(c.size());
    if (s <= size.load(std::memory_order_relaxed)) return;
    std::lock_guard<std::mutex> lock(mu);
    if (s > int(verts.size())) {
      verts = c;
      size.store(s, std::memory_order_relaxed);
    }
  }
};

struct Searcher {
  int n = 0, words = 0;
  const uint64_t* adj = nullptr;  // n rows x words
  Incumbent* inc = nullptr;
  std::vector<int> cur;
  Clock::time_point deadline;
  bool timed_out = false;
  long long nodes = 0;
  // the work the coloring has done, shared by the threads, and where it
  // stops (0: nowhere): a coloring of P costs |P| x words word operations
  std::atomic<long long>* work = nullptr;
  long long work_limit = 0;
  bool stopped = false;

  const uint64_t* row(int v) const { return adj + size_t(v) * words; }

  int best_size() const { return inc->size.load(std::memory_order_relaxed); }

  bool check_time() {
    if ((++nodes & 0xFFF) == 0 && Clock::now() > deadline) timed_out = true;
    return timed_out;
  }

  // Greedy coloring of candidate set P; emits vertices in nondecreasing color
  // order. Color of a vertex upper-bounds the clique extension through it.
  void color_sort(const std::vector<uint64_t>& P, std::vector<int>& order,
                  std::vector<int>& colors) {
    std::vector<uint64_t> uncolored = P;
    std::vector<uint64_t> Q(words);
    int color = 0;
    order.clear();
    colors.clear();
    while (any_bit(uncolored)) {
      ++color;
      Q = uncolored;
      while (true) {
        int v = first_bit(Q);
        if (v < 0) break;
        Q[v >> 6] &= ~(1ULL << (v & 63));
        uncolored[v >> 6] &= ~(1ULL << (v & 63));
        const uint64_t* rv = row(v);
        for (int i = 0; i < words; ++i) Q[i] &= ~rv[i];
        order.push_back(v);
        colors.push_back(color);
      }
    }
  }

  void expand(std::vector<uint64_t>& P) {
    if (check_time() || stopped) return;
    std::vector<int> order, colors;
    color_sort(P, order, colors);
    if (work_limit && work->fetch_add(static_cast<long long>(order.size()) * words) > work_limit) {
      stopped = true;
      return;
    }
    for (int k = int(order.size()) - 1; k >= 0; --k) {
      if (int(cur.size()) + colors[k] <= best_size()) return;
      int v = order[k];
      cur.push_back(v);
      std::vector<uint64_t> P2(words);
      const uint64_t* rv = row(v);
      for (int i = 0; i < words; ++i) P2[i] = P[i] & rv[i];
      if (any_bit(P2)) {
        expand(P2);
      } else if (int(cur.size()) > best_size()) {
        inc->offer(cur);
      }
      cur.pop_back();
      if (timed_out || stopped) return;
      P[v >> 6] &= ~(1ULL << (v & 63));
    }
  }
};

// Core numbers by repeated min-degree peeling: the vertex of least degree,
// ties to the lowest id. Each degree keeps a bitset of its live vertices, so
// a pick reads one bucket's words and a removal moves each live neighbour
// one bucket down: O(n words + E).
void compute_cores(const uint64_t* adj, int n, int words, std::vector<int>& core,
                   std::vector<int>& degeneracy_order) {
  std::vector<int> deg(n);
  int max_deg = 0;
  for (int v = 0; v < n; ++v) {
    deg[v] = popcount_words(adj + size_t(v) * words, words);
    max_deg = std::max(max_deg, deg[v]);
  }
  std::vector<uint64_t> bucket(size_t(max_deg + 1) * words, 0), live(words, 0);
  std::vector<int> in_bucket(max_deg + 1, 0);
  auto move = [&](int v, int from, int to) {
    if (from >= 0) {
      bucket[size_t(from) * words + (v >> 6)] &= ~(1ULL << (v & 63));
      --in_bucket[from];
    }
    bucket[size_t(to) * words + (v >> 6)] |= 1ULL << (v & 63);
    ++in_bucket[to];
  };
  for (int v = 0; v < n; ++v) {
    move(v, -1, deg[v]);
    live[v >> 6] |= 1ULL << (v & 63);
  }
  core.assign(n, 0);
  degeneracy_order.clear();
  degeneracy_order.reserve(n);
  int k = 0, d = 0;
  for (int it = 0; it < n; ++it) {
    while (in_bucket[d] == 0) ++d;
    const uint64_t* b = bucket.data() + size_t(d) * words;
    int w = 0;
    while (!b[w]) ++w;
    int v = w * 64 + __builtin_ctzll(b[w]);
    k = std::max(k, d);
    core[v] = k;
    bucket[size_t(d) * words + (v >> 6)] &= ~(1ULL << (v & 63));
    --in_bucket[d];
    live[v >> 6] &= ~(1ULL << (v & 63));
    degeneracy_order.push_back(v);
    // each live neighbour's degree drops by one, and the least degree with it
    const uint64_t* rv = adj + size_t(v) * words;
    for (int x = 0; x < words; ++x)
      for (uint64_t y = rv[x] & live[x]; y; y &= y - 1) {
        int u = x * 64 + __builtin_ctzll(y);
        move(u, deg[u], deg[u] - 1);
        --deg[u];
      }
    d = std::max(0, d - 1);
  }
}

// Greedy clique from each of the top-core vertices for an initial lower bound.
std::vector<int> greedy_clique(const uint64_t* adj, int n, int words,
                               const std::vector<int>& core) {
  std::vector<int> verts(n);
  for (int i = 0; i < n; ++i) verts[i] = i;
  std::sort(verts.begin(), verts.end(),
            [&](int a, int b) { return core[a] > core[b]; });
  std::vector<int> best;
  int tries = std::min(n, 32);
  for (int t = 0; t < tries; ++t) {
    int seed = verts[t];
    std::vector<uint64_t> cand(adj + size_t(seed) * words,
                               adj + size_t(seed + 1) * words);
    std::vector<int> clique = {seed};
    while (true) {
      // highest-core candidate
      int pick = -1, bestc = -1;
      for (int i = 0; i < words; ++i) {
        uint64_t w = cand[i];
        while (w) {
          int v = i * 64 + __builtin_ctzll(w);
          w &= w - 1;
          if (core[v] > bestc) {
            bestc = core[v];
            pick = v;
          }
        }
      }
      if (pick < 0) break;
      clique.push_back(pick);
      const uint64_t* rp = adj + size_t(pick) * words;
      for (int i = 0; i < words; ++i) cand[i] &= rp[i];
    }
    if (clique.size() > best.size()) best = clique;
  }
  return best;
}

// ---------------------------------------------------------------------------
// Sparse CSR mode — the analog of PMC's `search` path the reference switches
// to at V >= adj_limit = 20000 (graph.cc:114-121), where the dense N^2/8
// bitset no longer fits. Degeneracy order comes from an O(E + N)
// Batagelj-Zaversnik bucket peel; each root then expands over the *local*
// dense bitset graph induced on its later-ordered neighbors, whose size is
// bounded by the graph degeneracy — so the exponential search always runs on
// a small dense problem regardless of N.

// O(E + N) bucket k-core peel; returns core numbers + degeneracy order.
void compute_cores_csr(const int64_t* rowptr, const int32_t* col, int n,
                       std::vector<int>& core, std::vector<int>& order) {
  std::vector<int> deg(n), pos(n), vert(n);
  int maxd = 0;
  for (int v = 0; v < n; ++v) {
    deg[v] = int(rowptr[v + 1] - rowptr[v]);
    maxd = std::max(maxd, deg[v]);
  }
  std::vector<int> bin(maxd + 2, 0);
  for (int v = 0; v < n; ++v) ++bin[deg[v]];
  int start = 0;
  for (int d = 0; d <= maxd; ++d) {
    int c = bin[d];
    bin[d] = start;
    start += c;
  }
  for (int v = 0; v < n; ++v) {
    pos[v] = bin[deg[v]]++;
    vert[pos[v]] = v;
  }
  for (int d = maxd; d > 0; --d) bin[d] = bin[d - 1];
  bin[0] = 0;
  core.assign(n, 0);
  order.assign(n, 0);
  for (int i = 0; i < n; ++i) {
    int v = vert[i];
    order[i] = v;
    core[v] = deg[v];
    for (int64_t e = rowptr[v]; e < rowptr[v + 1]; ++e) {
      int u = col[e];
      if (deg[u] > deg[v]) {
        int du = deg[u], pu = pos[u];
        int pw = bin[du], w = vert[pw];
        if (u != w) {
          pos[u] = pw;
          vert[pu] = w;
          pos[w] = pu;
          vert[pw] = u;
        }
        ++bin[du];
        --deg[u];
      }
    }
  }
}

// A clique peeled from the top k-core: drop the vertex that misses the most
// edges to the rest (ties to the lowest id) until none misses one. On a graph
// whose top core is a clique of inliers with a few near-inliers, it is the
// maximum clique or close to it, a far better bound than greedy_clique's.
std::vector<int> peel_top_core(const uint64_t* adj, int n, int words,
                               const std::vector<int>& core, int max_core) {
  std::vector<int> top;
  for (int v = 0; v < n; ++v)
    if (core[v] == max_core) top.push_back(v);
  std::vector<uint64_t> alive(words, 0);
  for (int v : top) alive[v >> 6] |= 1ULL << (v & 63);
  std::vector<int> miss(top.size());
  int m = int(top.size());
  for (int i = 0; i < m; ++i) {
    int v = top[i];
    const uint64_t* rv = adj + size_t(v) * words;
    int deg = -int((rv[v >> 6] >> (v & 63)) & 1ULL);  // a loop is no edge
    for (int w = 0; w < words; ++w) deg += __builtin_popcountll(alive[w] & rv[w]);
    miss[i] = m - 1 - deg;
  }
  std::vector<char> gone(m, 0);
  while (true) {
    int j = -1;
    for (int i = 0; i < m; ++i)
      if (!gone[i] && miss[i] > 0 && (j < 0 || miss[i] > miss[j])) j = i;
    if (j < 0) break;
    gone[j] = 1;
    int v = top[j];
    alive[v >> 6] &= ~(1ULL << (v & 63));
    const uint64_t* rv = adj + size_t(v) * words;
    for (int i = 0; i < m; ++i)
      if (!gone[i] && top[i] != v && !((rv[top[i] >> 6] >> (top[i] & 63)) & 1ULL)) --miss[i];
  }
  std::vector<int> clique;
  for (int i = 0; i < m; ++i)
    if (!gone[i]) clique.push_back(top[i]);
  return clique;
}

// Exact maximum independent set of a sparse graph on bitsets: vertices of
// degree 0 or 1 are taken (some maximum set holds them), components are
// solved apart, and the rest branches on a vertex of the largest degree
// (taken, then left out where the bound of a greedy matching allows a
// larger set). Ties go to the lowest id. ``over`` is set past max_nodes
// or the deadline.
struct IndependentSet {
  int cw = 0;
  std::vector<std::vector<uint64_t>> nb;
  long long nodes = 0, max_nodes = 0;
  Clock::time_point deadline;
  bool over = false;

  static int count(const std::vector<uint64_t>& a) {
    int c = 0;
    for (uint64_t w : a) c += __builtin_popcountll(w);
    return c;
  }
  int degree(int v, const std::vector<uint64_t>& vs) const {
    int c = 0;
    for (int w = 0; w < cw; ++w) c += __builtin_popcountll(nb[v][w] & vs[w]);
    return c;
  }
  static void clear(std::vector<uint64_t>& a, int v) { a[v >> 6] &= ~(1ULL << (v & 63)); }

  std::vector<uint64_t> component(const std::vector<uint64_t>& vs) const {
    std::vector<uint64_t> comp(cw, 0);
    int s = first_bit(vs);
    comp[s >> 6] |= 1ULL << (s & 63);
    std::vector<uint64_t> front = comp;
    while (any_bit(front)) {
      std::vector<uint64_t> next(cw, 0);
      for (int w = 0; w < cw; ++w) {
        uint64_t f = front[w];
        while (f) {
          int v = w * 64 + __builtin_ctzll(f);
          f &= f - 1;
          for (int x = 0; x < cw; ++x) next[x] |= nb[v][x];
        }
      }
      for (int w = 0; w < cw; ++w) {
        next[w] &= vs[w] & ~comp[w];
        comp[w] |= next[w];
      }
      front = next;
    }
    return comp;
  }

  int bound(std::vector<uint64_t> vs) const {  // |vs| minus a greedy matching
    int size = count(vs), matched = 0;
    for (int v = first_bit(vs); v >= 0; v = first_bit(vs)) {
      clear(vs, v);
      for (int w = 0; w < cw; ++w) {
        uint64_t x = nb[v][w] & vs[w];
        if (x) {
          clear(vs, w * 64 + __builtin_ctzll(x));
          ++matched;
          break;
        }
      }
    }
    return size - matched;
  }

  std::vector<int> solve(std::vector<uint64_t> vs) {
    std::vector<int> taken;
    if (++nodes > max_nodes || ((nodes & 0xFF) == 0 && Clock::now() > deadline)) over = true;
    if (over) return taken;
    for (bool changed = true; changed;) {
      changed = false;
      for (int w = 0; w < cw; ++w) {
        uint64_t f = vs[w];
        while (f) {
          int v = w * 64 + __builtin_ctzll(f);
          f &= f - 1;
          if (!((vs[w] >> (v & 63)) & 1ULL) || degree(v, vs) > 1) continue;
          taken.push_back(v);
          for (int x = 0; x < cw; ++x) vs[x] &= ~nb[v][x];
          clear(vs, v);
          f &= vs[w];
          changed = true;
        }
      }
    }
    if (!any_bit(vs)) return taken;
    std::vector<uint64_t> comp = component(vs);
    if (comp != vs) {
      for (int w = 0; w < cw; ++w) vs[w] &= ~comp[w];
      std::vector<int> a = solve(comp), b = solve(vs);
      taken.insert(taken.end(), a.begin(), a.end());
      taken.insert(taken.end(), b.begin(), b.end());
      return taken;
    }
    int top = -1, dtop = -1;
    for (int w0 = 0; w0 < cw; ++w0) {
      for (uint64_t f = vs[w0]; f; f &= f - 1) {
        int u = w0 * 64 + __builtin_ctzll(f);
        int d = degree(u, vs);
        if (d > dtop) {
          dtop = d;
          top = u;
        }
      }
    }
    std::vector<uint64_t> with = vs;
    for (int x = 0; x < cw; ++x) with[x] &= ~nb[top][x];
    clear(with, top);
    std::vector<int> best = solve(with);
    best.push_back(top);
    std::vector<uint64_t> without = vs;
    clear(without, top);
    if (bound(without) > int(best.size())) {
      std::vector<int> other = solve(without);
      if (other.size() > best.size()) best = other;
    }
    taken.insert(taken.end(), best.begin(), best.end());
    return taken;
  }
};

// The exact search where the graph is a near-clique. Every clique larger
// than the incumbent's L vertices lies in the L-core C; the largest clique
// of C is C less a least cover of the edges it misses, i.e. the vertices of
// C that miss none and a maximum independent set of the conflict graph of
// the misses. Returns false, leaving the incumbent, where that graph is not
// sparse (more than 8 misses a conflicted vertex on average: the coloring
// search is the better tool there) or the set search passes its budget.
bool near_clique_search(const uint64_t* adj, int n, int words, const std::vector<int>& core,
                        Clock::time_point deadline, Incumbent& inc) {
  const int L = inc.size.load();
  std::vector<uint64_t> in_c(words, 0);
  std::vector<int> members;
  for (int v = 0; v < n; ++v)
    if (core[v] >= L) {
      in_c[v >> 6] |= 1ULL << (v & 63);
      members.push_back(v);
    }
  std::vector<int> conflicted, local(n, -1);
  long long misses = 0;
  for (int v : members) {
    const uint64_t* rv = adj + size_t(v) * words;
    int deg = -int((rv[v >> 6] >> (v & 63)) & 1ULL);  // a loop is no edge
    for (int w = 0; w < words; ++w) deg += __builtin_popcountll(in_c[w] & rv[w]);
    int miss = int(members.size()) - 1 - deg;
    if (miss > 0) {
      local[v] = int(conflicted.size());
      conflicted.push_back(v);
      misses += miss;
    }
  }
  const int c = int(conflicted.size());
  if (misses / 2 > 8LL * c) return false;
  IndependentSet mis;
  mis.cw = (c + 63) / 64;
  mis.max_nodes = 1000000;
  mis.deadline = deadline;
  mis.nb.assign(c, std::vector<uint64_t>(mis.cw, 0));
  for (int i = 0; i < c; ++i) {
    const uint64_t* rv = adj + size_t(conflicted[i]) * words;
    for (int j = 0; j < c; ++j) {
      int u = conflicted[j];
      if (j != i && !((rv[u >> 6] >> (u & 63)) & 1ULL))
        mis.nb[i][j >> 6] |= 1ULL << (j & 63);
    }
  }
  std::vector<uint64_t> all(mis.cw, 0);
  for (int i = 0; i < c; ++i) all[i >> 6] |= 1ULL << (i & 63);
  std::vector<int> keep = c ? mis.solve(all) : std::vector<int>();
  if (mis.over) return false;
  std::vector<char> in_set(c, 0);
  for (int i : keep) in_set[i] = 1;
  std::vector<int> clique;
  for (int v : members)
    if (local[v] < 0 || in_set[local[v]]) clique.push_back(v);
  inc.offer(clique);
  return true;
}

}  // namespace

extern "C" {

// Exact maximum clique over a symmetric CSR graph (both edge directions
// present). Same contract as tpureg_max_clique_mt; memory is O(E + d^2/8)
// with d the degeneracy, never O(N^2).
int tpureg_max_clique_sparse(const int64_t* rowptr, const int32_t* col,
                             int32_t n, double time_limit_sec,
                             int32_t num_threads, int32_t* out,
                             int32_t* timed_out_flag) {
  if (n <= 0) return 0;
  std::vector<int> core, order;
  compute_cores_csr(rowptr, col, n, core, order);
  std::vector<int> pos(n);
  for (int i = 0; i < n; ++i) pos[order[i]] = i;

  auto deadline =
      Clock::now() + std::chrono::duration_cast<Clock::duration>(
                         std::chrono::duration<double>(time_limit_sec));
  Incumbent inc;
  std::atomic<int> timed_out{0};
  std::atomic<int> next_root{n - 1};
  int nt = std::max(1, int(num_threads));
  nt = std::min<int>(nt, std::max(1u, std::thread::hardware_concurrency()));

  auto worker = [&]() {
    std::vector<int> local_id(n, -1);
    std::vector<int> members;     // local -> global
    std::vector<uint64_t> local_adj;
    Searcher s;
    s.inc = &inc;  // unused for pruning here (local incumbent below); set for safety
    bool my_timeout = false;
    while (true) {
      int i = next_root.fetch_sub(1, std::memory_order_relaxed);
      if (i < 0 || my_timeout) break;
      if (Clock::now() > deadline) {
        my_timeout = true;
        break;
      }
      int v = order[i];
      int best_now = inc.size.load(std::memory_order_relaxed);
      if (core[v] + 1 <= best_now) continue;
      // P(v): neighbors ordered after v (unique root per clique)
      members.clear();
      for (int64_t e = rowptr[v]; e < rowptr[v + 1]; ++e) {
        int u = col[e];
        if (pos[u] > i) {
          local_id[u] = int(members.size());
          members.push_back(u);
        }
      }
      int m = int(members.size());
      if (m + 1 <= best_now || m == 0) {
        for (int u : members) local_id[u] = -1;
        continue;
      }
      // dense bitset of the induced local graph
      int lwords = (m + 63) / 64;
      local_adj.assign(size_t(m) * lwords, 0);
      for (int a = 0; a < m; ++a) {
        int u = members[a];
        for (int64_t e = rowptr[u]; e < rowptr[u + 1]; ++e) {
          int b = local_id[col[e]];
          if (b >= 0)
            local_adj[size_t(a) * lwords + (b >> 6)] |= 1ULL << (b & 63);
        }
      }
      // local search target: global incumbent minus the root vertex
      Incumbent local_inc;
      local_inc.size.store(std::max(0, best_now - 1),
                           std::memory_order_relaxed);
      s.n = m;
      s.words = lwords;
      s.adj = local_adj.data();
      s.inc = &local_inc;
      s.deadline = deadline;
      s.timed_out = false;
      s.nodes = 0;
      s.cur.clear();
      std::vector<uint64_t> P(lwords, 0);
      for (int a = 0; a < m; ++a) P[a >> 6] |= 1ULL << (a & 63);
      s.expand(P);
      if (s.timed_out) my_timeout = true;
      if (!local_inc.verts.empty() &&
          int(local_inc.verts.size()) + 1 >
              inc.size.load(std::memory_order_relaxed)) {
        std::vector<int> clique = {v};
        for (int a : local_inc.verts) clique.push_back(members[a]);
        inc.offer(clique);
      }
      for (int u : members) local_id[u] = -1;
    }
    if (my_timeout) timed_out.store(1, std::memory_order_relaxed);
  };

  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }

  std::lock_guard<std::mutex> lock(inc.mu);
  for (size_t i = 0; i < inc.verts.size(); ++i) out[i] = int32_t(inc.verts[i]);
  if (timed_out_flag) *timed_out_flag = timed_out.load() ? 1 : 0;
  return int(inc.verts.size());
}

// CSR k-core export (O(E + N) bucket peel; parity/tooling).
void tpureg_core_numbers_csr(const int64_t* rowptr, const int32_t* col,
                             int32_t n, int32_t* out_core) {
  std::vector<int> core, order;
  compute_cores_csr(rowptr, col, n, core, order);
  for (int v = 0; v < n; ++v) out_core[v] = core[v];
}

// Returns the clique size (>=0) and fills out[0..size) with vertex ids.
// timed_out_flag (optional) is set to 1 if the search hit the time limit
// (result is then the best clique found so far, like PMC under time_limit).
int tpureg_max_clique_mt(const uint64_t* adj_bits, int32_t n, int32_t words,
                         double time_limit_sec, int32_t num_threads,
                         int32_t* out, int32_t* timed_out_flag) {
  if (n <= 0) return 0;
  std::vector<int> core, order;
  compute_cores(adj_bits, n, words, core, order);
  int max_core = 0;
  for (int v = 0; v < n; ++v) max_core = std::max(max_core, core[v]);

  auto deadline =
      Clock::now() + std::chrono::duration_cast<Clock::duration>(
                         std::chrono::duration<double>(time_limit_sec));
  Incumbent inc;
  inc.offer(greedy_clique(adj_bits, n, words, core));

  std::atomic<int> timed_out{0};
  // Root expansion in reverse degeneracy order: P(v) = later-ordered
  // neighbors of v (each clique gets a unique root); roots whose core
  // bound cannot beat the incumbent are pruned. Threads pull roots from
  // a shared atomic counter and share the incumbent bound (the same
  // scheme PMC uses across its OpenMP threads, graph.cc:38). Returns
  // whether the search ran to its end (not stopped by ``work_limit``).
  std::vector<int> pos(n);
  for (int i = 0; i < n; ++i) pos[order[i]] = i;
  auto search = [&](long long work_limit) {
    int nt = std::max(1, int(num_threads));
    nt = std::min<int>(nt, std::max(1u, std::thread::hardware_concurrency()));
    std::atomic<int> next_root{n - 1};
    std::atomic<long long> work{0};
    std::atomic<int> stopped{0};

    auto worker = [&]() {
      Searcher s;
      s.n = n;
      s.words = words;
      s.adj = adj_bits;
      s.inc = &inc;
      s.deadline = deadline;
      s.work = &work;
      s.work_limit = work_limit;
      while (true) {
        int i = next_root.fetch_sub(1, std::memory_order_relaxed);
        if (i < 0 || s.timed_out || s.stopped || stopped.load()) break;
        int v = order[i];
        if (core[v] + 1 <= s.best_size()) continue;
        std::vector<uint64_t> P(words, 0);
        const uint64_t* rv = s.row(v);
        for (int w = 0; w < words; ++w) P[w] = rv[w];
        // keep only vertices ordered after v
        for (int u = 0; u < n; ++u)
          if (pos[u] < i) P[u >> 6] &= ~(1ULL << (u & 63));
        if (!any_bit(P)) continue;
        s.cur = {v};
        s.expand(P);
        s.cur.clear();
      }
      if (s.timed_out) timed_out.store(1, std::memory_order_relaxed);
      if (s.stopped) stopped.store(1);
    };

    if (nt <= 1) {
      worker();
    } else {
      std::vector<std::thread> threads;
      for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
      for (auto& th : threads) th.join();
    }
    return stopped.load() == 0;
  };

  // The coloring search, as PMC runs it, up to kColoringWork; past it (a
  // near-clique of thousands of vertices, where it could run for minutes)
  // a clique peeled from the top core and the near-clique search finish
  // the job exactly, or else the coloring search runs again to its end.
  if (inc.size.load() < max_core + 1 && !search(kColoringWork)) {
    inc.offer(peel_top_core(adj_bits, n, words, core, max_core));
    if (inc.size.load() < max_core + 1 && !near_clique_search(adj_bits, n, words, core, deadline, inc))
      search(0);
  }

  std::lock_guard<std::mutex> lock(inc.mu);
  for (size_t i = 0; i < inc.verts.size(); ++i) out[i] = int32_t(inc.verts[i]);
  if (timed_out_flag) *timed_out_flag = timed_out.load() ? 1 : 0;
  return int(inc.verts.size());
}

// Single-threaded entry kept for ABI compatibility.
int tpureg_max_clique(const uint64_t* adj_bits, int32_t n, int32_t words,
                      double time_limit_sec, int32_t* out,
                      int32_t* timed_out_flag) {
  return tpureg_max_clique_mt(adj_bits, n, words, time_limit_sec, 1, out,
                              timed_out_flag);
}

// K-core decomposition export (used for parity tests of the device kernel).
void tpureg_core_numbers(const uint64_t* adj_bits, int32_t n, int32_t words,
                         int32_t* out_core) {
  std::vector<int> core, order;
  compute_cores(adj_bits, n, words, core, order);
  for (int v = 0; v < n; ++v) out_core[v] = core[v];
}

}  // extern "C"
