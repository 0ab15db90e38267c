// Kernel R: the whole GNC-TLS rotation loop (solvers/rotation.py::_solve_gnc_tls)
// of every problem of a batch, one block a problem, every round on the card.
//
// Replaces no Pallas kernel: the JAX package (teaserpp_tpu/solvers/rotation.py)
// writes the loop as a lax.while_loop that it vmaps over the problems. The plain
// version (ops/cuda_kernels.py::gnc_tls_plain) runs each round as PyTorch
// operations on the whole batch: its Procrustes (ops/procrustes.py::svd_rot ->
// jacobi_eigh_small, 10 sweeps of 6 Givens rotations of a 4x4) alone is ~3,400
// launches of a few elements each, and each round ends in a host sync for the
// batch's stopping test.
//
// What a block computes for its problem, in the plain version's order of
// operations, each product, sum, quotient and root rounded once and never
// contracted into an FMA; only the sums over the N columns are taken in another
// order (below):
//   while i < max_iterations and not done:
//   1. the correlation H = X diag(w) Y^T: (x_a w) y_b summed over the columns;
//   2. d = 3: rotation_from_correlation's q-method: K from H, normalised (the
//      identity where its norm is below 1e-30), jacobi_eigh_small's 10 sweeps
//      (column rotation, row rotation of the updated matrix, then V), the
//      eigenvector of the first largest eigenvalue as a quaternion, and
//      _quat_to_rot; d = 2: svd_rot_2d's closed form;
//   3. the residuals ||y - R x||^2 v; on round 0 their max gives mu0, and
//      mu0 <= 0 stops the problem with its weights and cost as they were;
//   4. the TLS weight update (_gnc_tls_weight_update), the cost with the
//      previous weights;
//   5. done when |cost - prev_cost| < cost_threshold; mu *= gnc_factor.
// Then R, the weights, the last cost and the rounds are written.
//
// What bounds it on an H100: a round reads each column's x, y, weight and
// validity twice (three times on round 0), 29 B a column in float32: ~28 MB a
// pass at (512, 1,889), which L2 (50 MB) keeps between passes and rounds, so
// at 3.35 TB/s a round could take ~20 us. Beside that each problem runs a chain
// of dependent scalar operations a round: the Jacobi's 60 rotations, each a
// division and two square roots deep, in one thread. Design: a block of 256
// threads strides over its problem's columns (thread t takes t, t + 256, ...),
// so each thread reads and writes its own weights and no pass waits for
// another's stores; every sum goes through a shuffle tree in each warp and then
// the warps in order, one fixed order, so the bits repeat run to run and a
// problem's bits do not depend on the batch it is solved in; thread 0 solves
// the Procrustes in registers while the others wait at the barrier. Nothing is
// staged by N: any N runs, one block a problem.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSweeps = 10;  // jacobi_eigh_small's
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
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_of(double a) { return fabs(a); }

template <typename T>
__device__ __forceinline__ bool is_nan(T a) { return a != a; }

// torch.sign: -1, 0 or 1 (0 for a NaN).
template <typename T>
__device__ __forceinline__ T sign_of(T a) { return T(int(a > T(0)) - int(a < T(0))); }

// torch.amax's pairwise step: the larger, a NaN over anything.
template <typename T>
__device__ __forceinline__ T max_of(T a, T b) { return is_nan(a) || a > b ? a : (is_nan(b) || b > a ? b : a); }

// One Givens rotation of jacobi_eigh_small on the pair (P, Q).
template <typename T, int P, int Q>
__device__ __forceinline__ void givens(T (&a)[4][4], T (&v)[4][4]) {
  const T apq = a[P][Q], app = a[P][P], aqq = a[Q][Q];
  const bool small = abs_of(apq) <= T(1e-35);  // max(tiny * 16, 1e-35) of both dtypes
  const T tau = div_rn(sub_rn(aqq, app), small ? T(1) : mul_rn(T(2), apq));
  const bool big = abs_of(tau) > T(1e10);
  const T ts = big ? T(1) : tau;
  T t = div_rn(sign_of(ts), add_rn(abs_of(ts), sqrt_rn(add_rn(T(1), mul_rn(ts, ts)))));
  if (big) t = mul_rn(div_rn(T(1), tau), T(0.5));  // torch's 0.5 / tau: a reciprocal, halved
  if (small) t = T(0);
  const T c = div_rn(T(1), sqrt_rn(add_rn(T(1), mul_rn(t, t))));
  const T s = mul_rn(t, c);
#pragma unroll
  for (int r = 0; r < 4; ++r) {  // A <- A G
    const T ap = a[r][P], aq = a[r][Q];
    a[r][P] = sub_rn(mul_rn(c, ap), mul_rn(s, aq));
    a[r][Q] = add_rn(mul_rn(s, ap), mul_rn(c, aq));
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // A <- G^T A, on the updated A
    const T ap = a[P][k], aq = a[Q][k];
    a[P][k] = sub_rn(mul_rn(c, ap), mul_rn(s, aq));
    a[Q][k] = add_rn(mul_rn(s, ap), mul_rn(c, aq));
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {  // V <- V G
    const T vp = v[r][P], vq = v[r][Q];
    v[r][P] = sub_rn(mul_rn(c, vp), mul_rn(s, vq));
    v[r][Q] = add_rn(mul_rn(s, vp), mul_rn(c, vq));
  }
}

// svd_rot's rotation from the 3x3 correlation h (row-major) into r.
template <typename T>
__device__ void procrustes(const T (&h)[9], T (&r)[9]) {
  const T sigma = add_rn(add_rn(h[0], h[4]), h[8]);
  const T z[3] = {sub_rn(h[5], h[7]), sub_rn(h[6], h[2]), sub_rn(h[1], h[3])};
  T k[4][4], v[4][4];
  k[0][0] = sigma;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    k[0][i + 1] = z[i];
    k[i + 1][0] = z[i];
#pragma unroll
    for (int j = 0; j < 3; ++j)  // h + h^T - sigma I
      k[i + 1][j + 1] = sub_rn(add_rn(h[3 * i + j], h[3 * j + i]), mul_rn(sigma, T(i == j)));
  }
  T sq = T(0);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sq = add_rn(sq, mul_rn(k[i][j], k[i][j]));
  const T norm = sqrt_rn(sq);
  const bool degenerate = norm < T(1e-30);  // max(tiny * 1e4, 1e-30) of both dtypes
  const T scale = norm > T(0) ? norm : T(1);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      k[i][j] = div_rn(k[i][j], scale);
      v[i][j] = T(i == j);
    }
#pragma unroll 1
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    givens<T, 0, 1>(k, v);
    givens<T, 0, 2>(k, v);
    givens<T, 0, 3>(k, v);
    givens<T, 1, 2>(k, v);
    givens<T, 1, 3>(k, v);
    givens<T, 2, 3>(k, v);
  }
  // torch.argmax of the eigenvalues: the first largest, a NaN before anything
  T top = k[0][0];
  int best = 0;
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    if (!is_nan(top) && (is_nan(k[j][j]) || k[j][j] > top)) {
      top = k[j][j];
      best = j;
    }
  }
  T q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = best == 0 ? v[i][0] : best == 1 ? v[i][1] : best == 2 ? v[i][2] : v[i][3];
  const T w = q[0], x = q[1], y = q[2], zq = q[3];
  r[0] = sub_rn(T(1), mul_rn(T(2), add_rn(mul_rn(y, y), mul_rn(zq, zq))));
  r[1] = mul_rn(T(2), sub_rn(mul_rn(x, y), mul_rn(w, zq)));
  r[2] = mul_rn(T(2), add_rn(mul_rn(x, zq), mul_rn(w, y)));
  r[3] = mul_rn(T(2), add_rn(mul_rn(x, y), mul_rn(w, zq)));
  r[4] = sub_rn(T(1), mul_rn(T(2), add_rn(mul_rn(x, x), mul_rn(zq, zq))));
  r[5] = mul_rn(T(2), sub_rn(mul_rn(y, zq), mul_rn(w, x)));
  r[6] = mul_rn(T(2), sub_rn(mul_rn(x, zq), mul_rn(w, y)));
  r[7] = mul_rn(T(2), add_rn(mul_rn(y, zq), mul_rn(w, x)));
  r[8] = sub_rn(T(1), mul_rn(T(2), add_rn(mul_rn(x, x), mul_rn(y, y))));
  if (degenerate) {
#pragma unroll
    for (int i = 0; i < 9; ++i) r[i] = T(i % 4 == 0);
  }
}

// svd_rot_2d's closed form from the 2x2 correlation h (row-major) into r.
template <typename T>
__device__ void procrustes(const T (&h)[4], T (&r)[4]) {
  const T a = add_rn(h[0], h[3]);
  const T b = sub_rn(h[1], h[2]);
  const T norm = sqrt_rn(add_rn(mul_rn(a, a), mul_rn(b, b)));
  const bool degenerate = norm < T(1e-30);
  const T safe = degenerate ? T(1) : norm;
  const T c = degenerate ? T(1) : div_rn(a, safe);
  const T s = degenerate ? T(0) : div_rn(b, safe);
  r[0] = c;
  r[1] = -s;
  r[2] = s;
  r[3] = c;
}

// The block's sums of v, into thread 0's v: a shuffle tree in each warp, then
// the warps in order through `scratch` (kWarps * K). The caller synchronises
// the block again before `scratch` is written anew.
template <typename T, int K>
__device__ __forceinline__ void block_sum(T (&v)[K], T* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = add_rn(v[k], __shfl_down_sync(kFull, v[k], off));
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) scratch[warp * K + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w)
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = add_rn(v[k], scratch[w * K + k]);
  }
}

// The block's max of m, into thread 0's m, as block_sum.
template <typename T>
__device__ __forceinline__ void block_max(T& m, T* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max_of(m, __shfl_down_sync(kFull, m, off));
  if (lane == 0) scratch[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kWarps; ++w) m = max_of(m, scratch[w]);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
gnc_tls_kernel(const T* __restrict__ src, const T* __restrict__ dst,
               const uint8_t* __restrict__ valid, const T* __restrict__ noise_bound,
               T noise_bound_all, T* __restrict__ rotation, T* __restrict__ weights,
               T* __restrict__ cost, int* __restrict__ iterations, long long n, T gnc_factor,
               int max_iterations, T cost_threshold) {
  __shared__ T scratch[kWarps * D * D];
  __shared__ T r_shared[D * D];
  __shared__ T mu_shared;  // round 0's mu0
  __shared__ int degenerate_shared;  // round 0's break
  __shared__ int flag_shared;  // whether the round runs
  const long long b = blockIdx.x;
  const T* x = src + b * D * n;
  const T* y = dst + b * D * n;
  const uint8_t* vm = valid == nullptr ? nullptr : valid + b * n;
  T* w = weights + b * n;

  auto valid_f = [&](long long c) { return vm == nullptr || vm[c] ? T(1) : T(0); };
  for (long long c = threadIdx.x; c < n; c += kThreads) w[c] = valid_f(c);

  // noise bound squared, with the reference's fallback (registration.cc:794-796)
  const T nb = noise_bound == nullptr ? noise_bound_all : noise_bound[b];
  T nb_sq = mul_rn(nb, nb);
  if (nb_sq < T(1e-16)) nb_sq = T(1e-2);

  T r[D * D];  // every thread's copy of the round's rotation
#pragma unroll
  for (int k = 0; k < D * D; ++k) r[k] = T(k % (D + 1) == 0);
  T mu = T(1);  // the same in every thread
  T prev_cost = T(INFINITY);  // thread 0's
  bool done = false;  // thread 0's
  int i = 0;

  // ||y_c - R x_c||^2 v_c, rotate's and _colnorm_sq's sums in their order
  auto residual = [&](long long c) {
    T xs[D];
#pragma unroll
    for (int a = 0; a < D; ++a) xs[a] = x[a * n + c];
    T res = T(0);
#pragma unroll
    for (int a = 0; a < D; ++a) {
      T rot = mul_rn(r[a * D], xs[0]);
#pragma unroll
      for (int k = 1; k < D; ++k) rot = add_rn(rot, mul_rn(r[a * D + k], xs[k]));
      const T diff = sub_rn(y[a * n + c], rot);
      res = a == 0 ? mul_rn(diff, diff) : add_rn(res, mul_rn(diff, diff));
    }
    return mul_rn(res, valid_f(c));
  };

  for (;;) {
    if (threadIdx.x == 0) flag_shared = i < max_iterations && !done;
    __syncthreads();
    if (!flag_shared) break;

    // 1-2. H with the current weights; thread 0 solves the Procrustes
    T h[D * D];
#pragma unroll
    for (int k = 0; k < D * D; ++k) h[k] = T(0);
    for (long long c = threadIdx.x; c < n; c += kThreads) {
      const T wc = w[c];
      T ys[D];
#pragma unroll
      for (int a = 0; a < D; ++a) ys[a] = y[a * n + c];
#pragma unroll
      for (int a = 0; a < D; ++a) {
        const T xw = mul_rn(x[a * n + c], wc);
#pragma unroll
        for (int k = 0; k < D; ++k) h[a * D + k] = add_rn(h[a * D + k], mul_rn(xw, ys[k]));
      }
    }
    block_sum(h, scratch);
    if (threadIdx.x == 0) {
      T rn[D * D];
      procrustes(h, rn);
#pragma unroll
      for (int k = 0; k < D * D; ++k) r_shared[k] = rn[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < D * D; ++k) r[k] = r_shared[k];

    // 3. on round 0, mu0 from the largest residual, and the degenerate break
    bool degenerate = false;
    if (i == 0) {
      T m = T(-INFINITY);
      for (long long c = threadIdx.x; c < n; c += kThreads) m = max_of(m, residual(c));
      block_max(m, scratch);
      if (threadIdx.x == 0) {
        mu_shared = div_rn(T(1), sub_rn(div_rn(mul_rn(T(2), m), nb_sq), T(1)));
        degenerate_shared = mu_shared <= T(0);
      }
      __syncthreads();
      mu = mu_shared;
      degenerate = degenerate_shared;
    }

    if (degenerate) {  // the weights and the cost stay as they were
      if (threadIdx.x == 0) done = true;
    } else {
      // 4. the weights from the residuals, the cost with the previous weights
      const T mu1 = add_rn(mu, T(1));
      const T th1 = mul_rn(div_rn(mu1, mu), nb_sq);
      const T th2 = mul_rn(div_rn(mu, mu1), nb_sq);
      const T num = mul_rn(mul_rn(nb_sq, mu), mu1);
      T part[1] = {T(0)};
      for (long long c = threadIdx.x; c < n; c += kThreads) {
        const T rc = residual(c);
        part[0] = add_rn(part[0], mul_rn(w[c], rc));
        const T safe = is_nan(rc) || rc >= T(1e-30) ? rc : T(1e-30);
        const T interp = sub_rn(sqrt_rn(div_rn(num, safe)), mu);
        const T nw = rc >= th1 ? T(0) : rc <= th2 ? T(1) : interp;
        w[c] = mul_rn(nw, valid_f(c));
      }
      block_sum(part, scratch);
      // 5. the stopping test, then the next mu
      if (threadIdx.x == 0) {
        done = abs_of(sub_rn(part[0], prev_cost)) < cost_threshold;
        prev_cost = part[0];
      }
      mu = mul_rn(mu, gnc_factor);
    }
    ++i;
  }

  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < D * D; ++k) rotation[b * D * D + k] = r[k];
    cost[b] = prev_cost;
    iterations[b] = i;
  }
}

template <typename T, int D>
int launch(const void* src, const void* dst, const uint8_t* valid, const void* noise_bound,
           double noise_bound_all, void* rotation, void* weights, void* cost, int* iterations,
           int batch, long long n, double gnc_factor, int max_iterations, double cost_threshold,
           cudaStream_t stream) {
  gnc_tls_kernel<T, D><<<static_cast<unsigned>(batch), kThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(dst), valid,
      static_cast<const T*>(noise_bound), static_cast<T>(noise_bound_all),
      static_cast<T*>(rotation), static_cast<T*>(weights), static_cast<T*>(cost), iterations, n,
      static_cast<T>(gnc_factor), max_iterations, static_cast<T>(cost_threshold));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// src, dst: (batch, d, n) float32 (f64 0) or float64 (f64 1), d 2 or 3; valid:
// (batch, n) bool, or null for every column valid; noise_bound: (batch,) of the
// same type, or null for noise_bound_all in every problem (gnc_factor,
// cost_threshold and noise_bound_all are rounded to that type, as PyTorch rounds
// a Python float against a tensor). Out, every element written: rotation
// (batch, d, d), weights (batch, n) and cost (batch,) of that type, iterations
// (batch,) int32. n = 0 is refused where a round would run (the plain version's
// max over no column raises). Launches on `stream` and returns the launch's
// cudaError_t (0 on success); does not synchronise.
int gnc_tls_launch(const void* src, const void* dst, const uint8_t* valid,
                   const void* noise_bound, double noise_bound_all, void* rotation,
                   void* weights, void* cost, int* iterations, int batch, int d, long long n,
                   double gnc_factor, int max_iterations, double cost_threshold, int f64,
                   cudaStream_t stream) {
  if (batch < 0 || n < 0 || (d != 2 && d != 3) || (n == 0 && max_iterations > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  if (f64)
    return d == 3 ? launch<double, 3>(src, dst, valid, noise_bound, noise_bound_all, rotation,
                                      weights, cost, iterations, batch, n, gnc_factor,
                                      max_iterations, cost_threshold, stream)
                  : launch<double, 2>(src, dst, valid, noise_bound, noise_bound_all, rotation,
                                      weights, cost, iterations, batch, n, gnc_factor,
                                      max_iterations, cost_threshold, stream);
  return d == 3 ? launch<float, 3>(src, dst, valid, noise_bound, noise_bound_all, rotation,
                                   weights, cost, iterations, batch, n, gnc_factor,
                                   max_iterations, cost_threshold, stream)
                : launch<float, 2>(src, dst, valid, noise_bound, noise_bound_all, rotation,
                                   weights, cost, iterations, batch, n, gnc_factor,
                                   max_iterations, cost_threshold, stream);
}

const char* gnc_tls_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
