#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``teaserpp_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit, as ``nvidia-smi`` gives them;
2. build every CUDA kernel and the host library from
   ``teaserpp_tpu_torch/csrc`` (one compiler process each, all started
   together) and print the build time;
3. kernels: each kernel against its plain PyTorch version on the card, exactly
   equal, timed with CUDA events: ``trim_bits`` at (512, 1889) (each problem
   with its own cloud, a quarter padded), (1, 65536) and (1, 100000);
   ``trim_degrees`` at (512, 1889) and (1, 100000), the second also against
   the popcount sums of ``trim_bits``; ``trim_adjacency_i8`` at (64, 1889) and
   (1, 16384), with its agreement share with ``trim_adjacency_dense``. All
   three kernels also run small hard shapes: (7, 333) (for ``trim_bits`` with
   a scattered validity mask, an empty problem, an empty row block and
   duplicated points), (3, 1), (2, 33) and (1, 10007), the size of a gathered
   subset of the exact path; ``trim_adjacency_i8`` also a near-threshold
   input (2, 1889) (colinear points whose neighbours' true distance
   difference is exactly beta, so rounding decides them) and (1, 46341),
   whose 2.15 GB output passes 2^31 bytes. Before each ``trim_bits`` and
   ``trim_adjacency_i8`` launch the allocator's block of the output's size is
   filled with a pattern and the output is checked to lie there, so an
   element that no warp stores shows as a difference. First, the tile
   kernels' compiled task numbering is read back through the built library
   and must cover every unordered block once, a batch beyond the
   launch's grid must raise, and the approximate square root that
   ``trim_adjacency_i8`` filters with must keep its error bound over every
   finite float (checked exhaustively on the card). The K1 row slab (a
   mesh rank's word rows) against its plain version and against the whole
   launch's rows, on the filled allocator block: the two halves of
   (1, 100000) (timed, with their bound), and on (7, 333)'s scattered
   validity the ragged last rows, one row, an empty slab and a first slab,
   and the second word row of (2, 33). The greedy clique kernel
   (``greedy_clique``) against its plain version, member words and sizes
   exactly, on the filled allocator block, timed: K1's words of phase 4's
   512 bunny problems with 64 seeds, the B = 1 dense sub-adjacency of
   ``solve_large_sharded`` (the top 2,048 vertices of the N=100,000
   problem), and (7, 333)'s scattered validity with two problems skipped;
   beside each, the bound of the row words its lanes read and of the words
   read once. Its wrapper refuses a wrong dtype, shape or device, and its
   launch rows too long for shared memory, counting nothing. Kernel S
   (``tls_sweep``, the scale TLS's sweep) against its plain version on the
   card, equal hashes of the estimates and costs and six launches a call,
   timed beside its bound (16 B an event) with peak memory and one profiled
   call: one chunk of the unknown-scale batch (75 bunny problems at
   N = 1,889, s = 2.5, a cloud each: 267,482,400 events) in float32, and 4
   of them in float64;
4. batched path: ``solve_batch`` on 512 bunny-shaped problems (N=1889, 1700
   outlier draws with replacement, so ~59% outliers; bench.py's parameters)
   with every launch count set to 0 just before and read just after; every
   problem must pass <0.1 deg rotation and <0.01 m translation error; prints
   registrations/s and stage times;
5. parity: the same port on the CPU for 4 of those problems must give the
   same clique masks, and rotation and translation within 1e-4;
5a. clique-mode batch: ``solve_batch`` on the same 512 problems with the
   library's default selector (PMC_EXACT, which the batched path runs as
   the greedy clique over 64 seeds), best of 3 windows of 3 solves, stage
   times and peak memory; the same gate, K1 and the greedy clique kernel
   launched once a solve each, the masks of 8 problems cliques of K1's
   graph (its plain version's words, on the host); PMC_HEU and KCORE_HEU
   0.5 give the same masks; KCORE_HEU at a threshold under every problem's
   max-core share gives the top k-core of phase 4, and at the median share
   the top k-core where the shortcut fires and the greedy clique elsewhere
   (the count printed);
   one more solve under ``torch.profiler`` gives the device's busy time,
   idle share and the kernels that take the most time; then the CPU run of
   4 problems gives equal masks (R and t within 1e-4);
6. large path: ``solve_large_sharded`` on one seeded problem of N=100,000
   correspondences with 90% outliers (scripts/bench_large_single.py's
   recipe), launch counts set to 0 before and read after; gated on <0.5 deg
   and <0.02 translation error; prints seconds per solve and stage times;
7. exact path: ``solve_large_exact`` on the same problem, same gate, and a
   clique at least as large as the heuristic's;
8. public kernel operations: ``trim_degrees`` on the N=100,000 problem and
   ``trim_adjacency_i8`` on its first 16,384 correspondences, through their
   wrappers with the counts set to 0 before, gated on what the planted
   inliers imply (as in the JAX package, these two kernels sit on no solver
   path);
9. large-path parity: the port on the CPU at N=2,000 against the card's run,
   both branches: equal ``max_core``, candidate order and clique mask,
   rotation and translation within 1e-4;
10. facade, the headline demo: ``RobustRegistrationSolver.solve`` on one
    bunny-shaped problem of phase 4's recipe (known scale, PMC_EXACT,
    GNC-TLS, cost threshold 0.005; examples/bunny_registration.py), gated on
    <0.1 deg and <0.01 m and a clique no smaller than the JAX facade's on
    the same problem (``scripts/jax_scale_reference.py``: 767); prints
    seconds per solve and ``getStageTimings()``;
11. facade, the library's defaults: the same problem with ``dst = 1.4 R src
    + t``, unknown scale and PMC_EXACT; the same gate and |s - 1.4| < 1e-3;
12. batched unknown scale: ``solve_batch`` with ``estimate_scaling=True``
    and KCORE_HEU at threshold 0 on scripts/bench_scale_est.py's problems
    at its defaults (B=64, N=500, 70% outliers, s in [0.5, 2], noise bound
    0.01); every problem within |ds| < 1e-3, 0.01 rad and 0.02 translation
    error (tests/test_registration_e2e.py's gate); prints registrations/s,
    stage times and peak memory;
13. their CPU/GPU parity: the facade on a problem of N=300 with unknown
    scale (equal clique, R and t within 1e-4, s within 1e-5) and 4 problems
    of phase 12 (equal clique and scale-pair masks, s within 1e-5, R and t
    within 1e-4);
14. determinism: the facade defaults (phase 11) 20 times in this process
    and once in each of 2 fresh processes (this script with
    ``--facade-defaults-hash``), the unknown-scale batch 5 times and the
    clique-mode batch 3 times must each give one hash of every output's
    bits; also prints whether the facade's s equals the CPU run's bits;
15. ICP: ``icp_point_to_point`` on the bunny-shaped cloud against its
    transformed copy (noise +-nb/2), started from the facade demo's result
    turned by 2 degrees and shifted by 5 mm; gated on <0.1 deg, and the CPU
    run within 1e-5;
16. the FPFH front end at full width (``fpfh_frontend``): scripts/
    bench_frontend_e2e.py's synth100k pair (100,000 points uniform in
    [-1, 1]^3 and a rigid copy with noise 0.003; radii 0.05 and 0.10):
    ``build_neighbor_plans`` on the host, ``estimate_normals_pruned`` and
    ``compute_fpfh_pruned`` of both clouds (descriptors left on the card),
    ``Matcher`` with cross-check, then ``solve_large_sharded`` (KCORE_HEU
    at threshold 0, noise bound 0.01); gated on <0.1 deg and <0.01 m
    against the planted transform. At synth100k's ~13K matches the solve
    takes its dense branch (N <= 16,384, as in JAX), which launches no
    TRIM kernel, so the phase requires none (K1 above 16,384), only the
    greedy clique kernel on the subgraph; prints the
    correspondence and clique counts beside the JAX package's, seconds per
    stage (best of 3 after a first run), peak memory, and one more run of
    the stages up to the matches under ``torch.profiler`` (busy time, idle
    share, top kernels, each stage's host and kernel time);
17. front-end parity: the matcher's NN of the first 8,192 source
    descriptors among all 100,000 target descriptors equals a plain exact NN
    by direct differences on the card; at N=8,192 (the synth100k density)
    the grid route's normals on the card and on the CPU lie within the tests'
    float32 bound of the float64 run, their SPFH counts (shared normals)
    differ on at most 5% of the rows and the FPFH of rows away from those
    within 2e-3; the matcher's correspondences on the card equal the CPU's;
18. the FPFH facade, TEASER and ICP (examples/fpfh_icp_registration.py's
    flow) on the wavy patch of tests/test_features.py at 64 x 64 points,
    z + 3, turned 0.25 rad and shifted: ``FPFHEstimation()`` (radii 0.1,
    0.16; dense at this size), ``Matcher``, ``RobustRegistrationSolver``
    (PMC_EXACT, noise bound 0.05), ``icp_point_to_point``; gated on >80% of
    the correspondences the identity, TEASER within 0.05 rad and 0.05, ICP
    <0.01 deg;
19. the CLI: ``python -m teaserpp_tpu_torch.cli`` in a subprocess on PLY
    files of phase 18's clouds with ``--fpfh`` (phase 18's TEASER gate) and
    of phase 10's problem without it (phase 10's clique size, <0.1 deg,
    <0.01 m), then the ``--fpfh`` call through ``cli.main`` in this
    process for its launch counts;
20. certify_e2e: scripts/bench_frontend_e2e.py::certify_saved's flow on the
    two in-repo rotation-stage problems (``.e2e_cert_synth100k.npz``,
    ``.e2e_cert_scene60k.npz``), float64 on the card: GNC-TLS over the
    chain, a 150-TIM subset keeping every outlier, GNC again, then
    ``certify_checkpointed`` (ITERATIVE, rank 128, 25-iteration segments,
    20 rounds of 200; the checkpoint in a temporary directory). Gate: both
    certified, synth100k with gap 0, scene60k with gap < 1e-3; prints
    iterations (beside the JAX package's 75 and 2,331), seconds, ms per
    iteration, saturation and peak memory. Then one 25-iteration segment of
    scene60k under ``torch.profiler``: launches and host syncs per
    iteration, idle share, top kernels, device time by operation;
21. certify_batch: scripts/bench_certify.py's defaults (B=32, N=100, DENSE,
    100 iterations): certs/s (best of 3 after a first run), the certified
    count; gate: each lane equal to ``DRSCertifier.certify`` of its problem
    alone (verdict, iteration count, trajectory within 1e-6 relative + 1e-8);
22. certify_scale: the reference's large random instances
    (certification-test.cc:530-644): ITERATIVE at N=1000 (npm 4004, rank
    128), at N=499 (npm 2000) ITERATIVE (rank 96, <= 5 iterations) then
    DENSE; gate: certified, gap <= 1e-5, not saturated;
23. certify_parity: both modes at N=40 on the card and on the CPU (equal
    verdict and iteration count, trajectories within the same tolerance),
    and ``certify_checkpointed`` stopped after 2 segments and resumed on the
    card: bit-identical to the uninterrupted run.

24. mesh: one world of two ranks sharing the card (gloo named, a loopback
    store, collectives that time out after 300 s; this script with
    ``--mesh-rank``), each running (a) ``solve_large_sharded`` and
    ``solve_large_exact`` on phase 6's N=100,000 problem on a (1, 2) mesh
    over ``pairs`` (K1 as row slabs), (b) phase 16's synth100k pair through
    ``FPFHEstimation(neighbor_mode="grid")`` with its query blocks over both
    ranks, the matcher and ``solve_large_sharded`` on the (1, 2) mesh (the
    dense branch: no TRIM kernel), (c) ``solve_batch_sharded`` on phase
    4's 512 problems on a (2, 1) mesh over ``batch``. Every rank's results equal
    this process's ``mesh=None`` runs on the card bit for bit (on (c) each
    rank's half equals ``solve_batch`` of that half; the whole batch equals
    phase 4's within 1e-4 with equal masks), (a) and (b) pass phases 6 and
    16's gates, the slab launches on (a) and nothing on (b); prints seconds
    beside ``mesh=None``'s, peak memory a rank, the backend and the bytes
    staged through the host. Two ranks share one card: no scaling numbers;
25. a world of one over NCCL, joined here (``init_process_group("nccl")``,
    world size 1): (a) on the (1, 1) mesh, equal to ``mesh=None`` bit for
    bit, the collectives through NCCL (no host staging); then two ranks
    (this script with ``--nccl-refusal``) that ask ``initialize_distributed``
    for its default backend, NCCL, on the one card must both be refused
    with a ``RuntimeError`` that names the shared card and gloo.

Phases 10-12, 15 and 18-23 run no TRIM kernel (as in the JAX package,
their route reaches no Pallas kernel): each sets the launch counts to 0
before and requires them to read 0 after; phases 10 and 11 (PMC_EXACT's
host search) also no greedy clique kernel. Phases 11 and 12 (unknown scale)
must launch kernel S, phases 4 and 10 (known scale) must not. Then one
``{"kernels": [...]}`` line and, last, the device line. Without CUDA, or without the package beside it, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np

BATCH = 512
N_POINTS = 1889  # the bunny's correspondences (examples/bunny_registration.py)
N_OUTLIER_DRAWS = 1700
NOISE_BOUND = 0.001
HUGE_N = 65536  # the JAX package sends single problems this large to its Pallas kernel
LARGE_N = 100_000  # scripts/bench_large_single.py's single huge problem
LARGE_OUTLIER_RATIO = 0.9
LARGE_NOISE_BOUND = 0.01
DENSE_N = 16384  # the largest N at which the JAX package builds a dense adjacency
DENSE_BATCH = 64
WIDE_N = 46341  # the least N whose (N, N) int8 output passes 2^31 bytes
EXACT_N = LARGE_N  # the exact phase's size; cut it if the host search outgrows the budget
EXACT_TIME_LIMIT_S = 120.0
LARGE_PARITY_N = 2000
GREEDY_SEEDS = 64  # the library's max_clique_heuristic_seeds
SUBGRAPH_M = 2048  # solve_large_sharded's subgraph_size
GREEDY_SKIPPED = (1, 4)  # problems of (7, 333) whose greedy is skipped
PARITY_PROBLEMS = 4
PARITY_TOL = 1e-4  # Frobenius (rotation) / Euclidean (translation), as the tests state
FACADE_SCALE = 1.4  # the defaults phase's scale (tests/test_registration_e2e.py's)
# The JAX facade's clique on the facade phases' problem, float32 and float64
# alike (scripts/jax_scale_reference.py on the CPU): the clique gate's floor
JAX_FACADE_CLIQUE = 767
FACADE_PARITY_N = 300
TLS_SWEEP_BATCH = 75  # one chunk of the unknown-scale batch at N = 1,889: 267,482,400 events
TLS_SWEEP_SCALE = 2.5  # the unknown-scale cell's
SCALE_BATCH = 64  # scripts/bench_scale_est.py's defaults
SCALE_N = 500
SCALE_NOISE_BOUND = 0.01
SCALE_PARITY_TOL = 1e-5
DETERMINISM_FACADE_RUNS = 20
DETERMINISM_PROCESSES = 2
CHILD_FLAG = "--facade-defaults-hash"  # what a determinism phase's fresh process runs
ICP_SEED = 31
ICP_START_DEG = 2.0  # the ICP phase's start: the demo's result turned and shifted
ICP_START_M = 0.005
ICP_MAX_DISTANCE = 0.02
ICP_PARITY_TOL = 1e-5
# The front end: scripts/bench_frontend_e2e.py's synth100k pair (:254-258)
FRONTEND_N = 100_000
FRONTEND_SEED = 11
FRONTEND_NOISE = 0.003
FRONTEND_RADII = (0.05, 0.10)
FRONTEND_NOISE_BOUND = 0.01
# what the JAX package found on that pair (PERFORMANCE.md:455-459): counts only
JAX_FRONTEND_CORRESPONDENCES = 12_935
JAX_FRONTEND_CLIQUE = 1_732
FRONTEND_PARITY_QUERIES = 8192
FRONTEND_PARITY_N = 8192
# The facade phase's wavy patch (tests/test_features.py:371-374) at 64 x 64
PATCH_M = 64
PATCH_SEED = 12345
PATCH_RADII = (0.1, 0.16)
PATCH_NOISE_BOUND = 0.05

# H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s HBM3; 67 TFLOP/s float32
# outside the tensor cores, counting an FMA as two operations, so 33.5e12
# single add/sub/mul instructions a second
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
# The TRIM predicate: 2 x (3 sub, 3 mul, 2 add), then add, sub, 2 mul and
# `2 s - b2`, which is one FMA (doubling is exact, so fusing it rounds as the
# separate multiply and subtract do): 20 add/sub/mul + 1 exact FMA
TRIM_OPS_PER_PAIR = 21
# Gram-form dense adjacency: per cloud 3 mul + 2 add (product), add, and
# `- 2 gram` as one FMA (doubling is exact, so fusing it rounds as the
# separate multiply and subtract do), max = 8; then one sub and one compare
# (the abs is an operand modifier)
GRAM_OPS_PER_PAIR = 2 * 8 + 2
GRAM_SQRTS_PER_PAIR = 2
# An SM has 128 FP32 lanes and 16 special-function units (Hopper white
# paper), so a square root's MUFU instruction runs at 1/8 of the FP32 rate
SFU_OPS_PER_S = FP32_OPS_PER_S / 8

# The example's fixed SE(3) transform (examples/bunny_registration.py),
# projected to its orthogonal polar factor.
T = np.array(
    [
        [9.96926560e-01, 6.68735757e-02, -4.06664421e-02, -1.15576939e-01],
        [-6.61289946e-02, 9.97617877e-01, 1.94008687e-02, -3.87705398e-02],
        [4.18675510e-02, -1.66517807e-02, 9.98977765e-01, 1.14874890e-01],
        [0, 0, 0, 1],
    ]
)
_u, _s, _vt = np.linalg.svd(T[:3, :3])
T[:3, :3] = _u @ _vt


def make_problems(batch: int, n: int, seed: int = 0, shared_cloud: bool = True,
                  scale: float = 1.0):
    """Bunny-shaped problems: one fixed cloud in a 0.15 m box (or, with
    ``shared_cloud`` False, one per problem), transformed by ``scale`` and
    ``T``, uniform noise +-nb/2, and 1700 outlier draws shifting all three
    axes of the drawn points by one integer in [5, 10] (the example's
    recipe). The draws are with replacement, so at N=1889 about 1121 points
    (59%) are outliers."""
    cloud = np.random.default_rng(seed).uniform(0.0, 0.15, (3, n))
    srcs, dsts = [], []
    for p in range(batch):
        rng = np.random.default_rng(seed + 1 + p)
        if not shared_cloud:
            cloud = rng.uniform(0.0, 0.15, (3, n))
        tgt = scale * (T[:3, :3] @ cloud) + T[:3, 3:4]
        tgt = tgt + rng.uniform(-NOISE_BOUND / 2, NOISE_BOUND / 2, size=tgt.shape)
        mask = np.zeros(n, bool)
        mask[rng.integers(0, n, size=min(N_OUTLIER_DRAWS, n))] = True
        tgt[:, mask] += rng.integers(5, 11, size=mask.sum())
        srcs.append(cloud)
        dsts.append(tgt)
    return np.stack(srcs).astype(np.float32), np.stack(dsts).astype(np.float32)


def make_scale_problems(batch: int, n: int, seed: int = 0):
    """scripts/bench_scale_est.py's problems: cloud uniform in [-1, 1]^3, a
    uniform random rotation, s uniform in [0.5, 2], t normal with sd 0.5,
    uniform noise +-nb/2, 70% of ``dst`` replaced by uniform [-4, 4]^3.
    Returns (src, dst (B, 3, n) float32, s (B,), R (B, 3, 3), t (B, 3))."""
    rng = np.random.default_rng(seed)
    srcs, dsts, rs, ss, ts = [], [], [], [], []
    for _ in range(batch):
        src = rng.uniform(-1, 1, size=(3, n))
        q, r_ = np.linalg.qr(rng.normal(size=(3, 3)))
        q *= np.sign(np.diag(r_))
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        s = rng.uniform(0.5, 2.0)
        t = rng.normal(size=3) * 0.5
        dst = s * q @ src + t[:, None]
        dst += rng.uniform(-SCALE_NOISE_BOUND / 2, SCALE_NOISE_BOUND / 2, size=dst.shape)
        out = rng.choice(n, size=int(0.7 * n), replace=False)
        dst[:, out] = rng.uniform(-4, 4, size=(3, out.size))
        srcs.append(src)
        dsts.append(dst)
        rs.append(q)
        ss.append(s)
        ts.append(t)
    return (np.stack(srcs).astype(np.float32), np.stack(dsts).astype(np.float32),
            np.array(ss), np.stack(rs), np.stack(ts))


def make_large_problem(n: int, seed: int = 0):
    """One huge problem by scripts/bench_large_single.py's recipe: cloud
    uniform in [-1, 1]^3, rotation 0.5 rad about z, t = (0.3, -0.2, 0.4),
    uniform noise +-nb/2, and 90% of ``dst`` replaced by uniform [-3, 3]^3.
    Returns (src, dst (3, n) float32, R, t, inlier mask)."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1, 1, size=(3, n))
    theta = 0.5
    r_true = np.array([[np.cos(theta), -np.sin(theta), 0],
                       [np.sin(theta), np.cos(theta), 0],
                       [0, 0, 1.0]])
    t_true = np.array([0.3, -0.2, 0.4])
    dst = r_true @ src + t_true[:, None]
    dst += rng.uniform(-LARGE_NOISE_BOUND / 2, LARGE_NOISE_BOUND / 2, size=dst.shape)
    n_out = int(LARGE_OUTLIER_RATIO * n)
    out = rng.choice(n, size=n_out, replace=False)
    dst[:, out] = rng.uniform(-3, 3, size=(3, n_out))
    inlier = np.ones(n, bool)
    inlier[out] = False
    return src.astype(np.float32), dst.astype(np.float32), r_true, t_true, inlier


def large_params():
    from teaserpp_tpu_torch.params import (
        InlierSelectionMode,
        RobustRegistrationSolverParams,
    )

    return RobustRegistrationSolverParams(
        noise_bound=LARGE_NOISE_BOUND,
        estimate_scaling=False,
        inlier_selection_mode=InlierSelectionMode.KCORE_HEU,
        kcore_heuristic_threshold=0.0,
    )


def bench_params():
    from teaserpp_tpu_torch.params import (
        InlierSelectionMode,
        RobustRegistrationSolverParams,
    )

    return RobustRegistrationSolverParams(
        noise_bound=NOISE_BOUND,
        cbar2=1.0,
        estimate_scaling=False,
        rotation_cost_threshold=0.005,
        inlier_selection_mode=InlierSelectionMode.KCORE_HEU,
        kcore_heuristic_threshold=0.0,
    )


def facade_param_fields(estimate_scaling: bool) -> dict:
    """The facade phases' parameters as field values (either package's
    ``RobustRegistrationSolverParams`` takes them): examples/
    bunny_registration.py's, PMC_EXACT, and the scale estimated or not."""
    return dict(noise_bound=NOISE_BOUND, cbar2=1.0, estimate_scaling=estimate_scaling,
                rotation_cost_threshold=0.005)


def scale_params():
    from teaserpp_tpu_torch.params import (
        InlierSelectionMode,
        RobustRegistrationSolverParams,
    )

    return RobustRegistrationSolverParams(
        noise_bound=SCALE_NOISE_BOUND,
        estimate_scaling=True,
        inlier_selection_mode=InlierSelectionMode.KCORE_HEU,
        kcore_heuristic_threshold=0.0,
    )


def time_ms(fn, reps: int, device) -> float:
    """Median time of ``fn()`` in ms: CUDA events on the card, else host clock."""
    import torch

    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _bound(times_ms: dict) -> tuple[float, str]:
    """The largest of the candidate least times, and whether bytes or
    operations set it."""
    name = max(times_ms, key=times_ms.get)
    return times_ms[name], "bytes" if name == "bytes" else "operations"


def trim_bits_bound_ms(valid: np.ndarray) -> tuple[float, str, int]:
    """Least time for the TRIM bits of inputs masked by ``valid`` (B, N):
    FP32 instruction time vs bytes moved, and the pairs counted.

    The predicate is symmetric in (i, j), bit for bit, and a diagonal or
    padded pair needs none, so the work is one predicate per unordered pair
    of valid points of a problem.
    """
    bsz, n = valid.shape
    m = valid.sum(axis=-1).astype(np.int64)
    pairs = int(np.sum(m * (m - 1) // 2))
    words = (n + 31) // 32
    nbytes = bsz * (2 * 3 * n * 4 + n) + bsz * words * n * 4
    return (*_bound({
        "fp32": TRIM_OPS_PER_PAIR * pairs / FP32_OPS_PER_S * 1e3,
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
    }), pairs)


def trim_bits_slab_bound_ms(valid: np.ndarray, rows) -> tuple[float, str, int]:
    """Least time for the word rows ``rows = (w0, w1)`` of the TRIM bits:
    the predicate once for each unordered pair of valid points inside the
    slab's rows, and once for each ordered pair of a valid point of those
    rows and one outside them (the slab holds no mirror of those), against
    the points read and the slab's words written."""
    bsz, n = valid.shape
    w0, w1 = rows
    inside = valid[:, 32 * w0:32 * w1].sum(axis=-1).astype(np.int64)
    outside = valid.sum(axis=-1).astype(np.int64) - inside
    pairs = int(np.sum(inside * (inside - 1) // 2 + inside * outside))
    nbytes = bsz * (2 * 3 * n * 4 + n) + bsz * (w1 - w0) * n * 4
    return (*_bound({
        "fp32": TRIM_OPS_PER_PAIR * pairs / FP32_OPS_PER_S * 1e3,
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
    }), pairs)


def slab_cases(inputs: dict) -> list:
    """(input name, word rows) of the K1 slab checks: the two halves of the
    (1, 100000) problem (a (1, 2) mesh's slabs, timed), then the edge cases
    on the scattered validity mask (7, 333) (11 word rows, the last holding
    13 points): the ragged last rows, one row, an empty slab, a first slab;
    and the second word row of (2, 33)."""
    words = (LARGE_N + 31) // 32
    half = -(-words // 2)
    return [("large", (0, half)), ("large", (half, words)),
            ("scattered", (6, 11)), ("scattered", (4, 5)), ("scattered", (3, 3)),
            ("scattered", (0, 7)), ("two_blocks", (1, 2))]


def trim_degrees_bound_ms(bsz: int, n: int) -> tuple[float, str, int]:
    """Least time for the TRIM degrees of (B, 3, N) points: the same
    predicate per unordered pair as the bits, against the points read and
    one int32 per vertex written."""
    pairs = bsz * n * (n - 1) // 2
    nbytes = bsz * (2 * 3 * n * 4 + n * 4)
    return (*_bound({
        "fp32": TRIM_OPS_PER_PAIR * pairs / FP32_OPS_PER_S * 1e3,
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
    }), pairs)


def trim_adjacency_bound_ms(bsz: int, n: int) -> tuple[float, str, int, dict]:
    """Least time for the Gram-form int8 adjacency of (B, 3, N) points.

    The entry is symmetric in (i, j), bit for bit (every sum and product
    commutes), so the work is two Gram-form distances per unordered pair:
    FP32 instruction time, two square roots at the special-function rate, and the N^2
    output bytes; the largest of the three bounds it.
    """
    pairs = bsz * n * (n - 1) // 2
    nbytes = bsz * (2 * 3 * n * 4 + n * n)
    terms = {
        "fp32": GRAM_OPS_PER_PAIR * pairs / FP32_OPS_PER_S * 1e3,
        "sqrt": GRAM_SQRTS_PER_PAIR * pairs / SFU_OPS_PER_S * 1e3,
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
    }
    return (*_bound(terms), pairs, terms)


def _to(device, *arrays):
    import torch

    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def _max_abs_diff(got, want) -> int:
    import torch

    if torch.equal(got, want):
        return 0
    return int((got.long() - want.long()).abs().max())


def _poison_allocator(device, shape, dtype):
    """Fill a block of an output's size with a pattern and free it, so a
    kernel that leaves a word of the next ``torch.empty`` of that size
    unwritten cannot pass on leftover bytes of an earlier, equal result.
    Returns the block's address (None on the CPU): the caller checks that
    the output landed there."""
    import torch

    if device.type != "cuda":
        return None
    pattern = 0x5A if dtype == torch.int8 else 0x5A5A5A5A
    block = torch.full(shape, pattern, dtype=dtype, device=device)
    torch.cuda.synchronize()
    return block.data_ptr()


def _compare_and_time(kernel, plain, device, reps: int, plain_reps: int,
                      poison=None) -> dict:
    """Run ``kernel()`` and ``plain()`` once, compare them exactly, then time
    both. ``poison`` is the (shape, dtype) of an output the kernel receives
    uninitialised."""
    poisoned_at = _poison_allocator(device, *poison) if poison is not None else None
    got = kernel()
    if poisoned_at is not None and got.numel() and got.data_ptr() != poisoned_at:
        raise AssertionError("the output did not land on the block filled with the pattern")
    want = plain()
    _sync(device)
    err = _max_abs_diff(got, want)
    res = dict(equal=err == 0, elements_differing=int((got != want).sum()),
               max_abs_err=err)
    del got, want
    res["ms"] = time_ms(kernel, reps, device)
    res["plain_ms"] = time_ms(plain, plain_reps, device)
    return res


def near_threshold_problems(n: int):
    """Colinear problems on which rounding decides the neighbours: point i at
    (i h, 0, 0) in ``src`` and (i (h + beta), 0, 0) in ``dst``, so the true
    distance difference of i and i + 1 is exactly beta; h and beta are exact
    in binary, but h has 12 significant bits, so the squared norms round and
    the Gram form's cancellation puts those pairs on both sides of beta.
    One problem for each of two spacings -> (src, dst (2, 3, n), beta)."""
    beta = 2.0 ** -8
    i = np.arange(n, dtype=np.float64)
    src = np.zeros((2, 3, n), np.float32)
    dst = np.zeros((2, 3, n), np.float32)
    for p, h in enumerate(((2 ** 11 + 1) * 2.0 ** -17, (2 ** 9 + 3) * 2.0 ** -15)):
        src[p, 0], dst[p, 0] = i * h, i * (h + beta)
        if not (np.array_equal(src[p, 0], i * h) and np.array_equal(dst[p, 0], i * (h + beta))):
            raise AssertionError("near-threshold coordinates are not exact in float32")
    return src, dst, beta


def kernel_inputs(seed: int = 0) -> dict:
    """The tile kernels' inputs, {name: (src, dst, valid, beta)} as numpy: the
    three timed shapes "main" (a quarter padded), "huge" and "large", then
    the small hard ones."""
    from teaserpp_tpu_torch.ops.tims import trim_beta

    beta, large_beta = trim_beta(NOISE_BOUND), trim_beta(LARGE_NOISE_BOUND)
    rng = np.random.default_rng(seed)
    src_main, dst_main = make_problems(BATCH, N_POINTS, seed=seed + 3, shared_cloud=False)
    bsz, _, n = src_main.shape
    valid = np.ones((bsz, n), bool)
    for p in range(bsz - bsz // 4, bsz):  # a quarter padded
        valid[p, rng.integers(n // 2, n):] = False
    huge_src, huge_dst = make_problems(1, HUGE_N, seed=seed + 7)
    large_src, large_dst, *_ = make_large_problem(LARGE_N, seed=seed)

    few_src, few_dst = make_problems(7, 333, seed=seed + 5, shared_cloud=False)
    few_src[:, :, 10], few_dst[:, :, 10] = few_src[:, :, 3], few_dst[:, :, 3]  # duplicates
    few_valid = rng.random((7, 333)) < 0.7  # scattered, not a suffix
    few_valid[1] = False  # an empty problem
    few_valid[2, 64:96] = False  # an empty row block and column block
    one_src, one_dst = make_problems(3, 1, seed=seed + 9, shared_cloud=False)
    two_src, two_dst = make_problems(2, 33, seed=seed + 13, shared_cloud=False)
    sub_src, sub_dst, *_ = make_large_problem(10007, seed=seed + 11)
    return {
        "main": (src_main, dst_main, valid, beta),
        "huge": (huge_src, huge_dst, np.ones((1, HUGE_N), bool), beta),
        "large": (large_src[None], large_dst[None], np.ones((1, LARGE_N), bool), large_beta),
        "scattered": (few_src, few_dst, few_valid, beta),
        "one_point": (one_src, one_dst, np.ones((3, 1), bool), beta),
        "two_blocks": (two_src, two_dst, np.ones((2, 33), bool), beta),
        "gathered_subset": (sub_src[None], sub_dst[None], np.ones((1, 10007), bool), large_beta),
    }


def kernel_phase(device, seed: int = 0) -> dict:
    """Every kernel against its plain version, exactly, at the shapes listed
    in the module docstring. Returns {kernel name: [one dict per shape]}."""
    import torch
    from teaserpp_tpu_torch.clique.kcore import active_degrees
    from teaserpp_tpu_torch.ops import cuda_kernels as ck
    from teaserpp_tpu_torch.ops.tims import trim_adjacency_dense, trim_beta

    inputs = kernel_inputs(seed)
    src_main, dst_main = inputs["main"][:2]
    large_src, large_dst = inputs["large"][:2]
    results = {"trim_bits": [], "trim_bits_slab": [], "trim_degrees": [],
               "trim_adjacency_i8": []}

    def shape_of(s):
        return dict(batch=int(s.shape[0]), n=int(s.shape[-1]))

    # trim_bits
    for s_np, d_np, v_np, bt in inputs.values():
        s, d, v = _to(device, s_np, d_np, v_np)
        out_shape = (s.shape[0], (s.shape[-1] + 31) // 32, s.shape[-1])
        res = _compare_and_time(
            lambda: ck.trim_bits(s, d, v, bt),
            lambda: ck.trim_adjacency_bits_plain(s, d, v, bt), device, 20, 3,
            poison=(out_shape, torch.int32))
        bound_ms, bound_by, pairs = trim_bits_bound_ms(v_np)
        results["trim_bits"].append(dict(
            **shape_of(s), **res, bound_ms=bound_ms, bound_by=bound_by, bound_pairs=pairs))
        del s, d, v

    # the K1 row slab: against its plain version and the whole launch's rows
    for name, rows in slab_cases(inputs):
        s_np, d_np, v_np, bt = inputs[name]
        s, d, v = _to(device, s_np, d_np, v_np)
        out_shape = (s.shape[0], rows[1] - rows[0], s.shape[-1])
        res = _compare_and_time(
            lambda: ck.trim_bits(s, d, v, bt, rows=rows),
            lambda: ck.trim_adjacency_bits_plain(s, d, v, bt, rows=rows), device, 20, 3,
            poison=(out_shape, torch.int32))
        whole = ck.trim_bits(s, d, v, bt)[:, rows[0]:rows[1]]
        res["equals_whole_rows"] = bool(torch.equal(ck.trim_bits(s, d, v, bt, rows=rows), whole))
        res["equal"] = res["equal"] and res["equals_whole_rows"]
        del whole
        bound_ms, bound_by, pairs = trim_bits_slab_bound_ms(v_np, rows)
        results["trim_bits_slab"].append(dict(
            case=name, rows=list(rows), **shape_of(s), **res, bound_ms=bound_ms,
            bound_by=bound_by, bound_pairs=pairs))
        del s, d, v

    # trim_degrees: no validity mask, so every point of the main shape counts
    for name, (s_np, d_np, _, bt) in inputs.items():
        if name == "huge":  # the large shape covers what it would show
            continue
        against_bits = name == "large"
        s, d = _to(device, s_np, d_np)
        res = _compare_and_time(
            lambda: ck.trim_degrees(s, d, bt),
            lambda: ck.trim_degrees_plain(s, d, bt), device, 20, 3)
        if against_bits:
            all_valid = torch.ones(s.shape[0], s.shape[-1], dtype=torch.bool, device=device)
            bits = ck.trim_bits(s, d, all_valid, bt)
            res["equals_popcount_of_trim_bits"] = bool(torch.equal(
                ck.trim_degrees(s, d, bt), active_degrees(bits, all_valid)))
            res["equal"] = res["equal"] and res["equals_popcount_of_trim_bits"]
            del bits
        bound_ms, bound_by, pairs = trim_degrees_bound_ms(s.shape[0], s.shape[-1])
        results["trim_degrees"].append(dict(
            **shape_of(s), **res, bound_ms=bound_ms, bound_by=bound_by, bound_pairs=pairs))
        del s, d

    # trim_adjacency_i8: the two timed shapes (also against the direct
    # distances of trim_adjacency_dense), then the hard ones
    dn = min(DENSE_N, large_src.shape[-1])
    near_src, near_dst, near_beta = near_threshold_problems(N_POINTS)
    wide_src, wide_dst, *_ = make_large_problem(WIDE_N, seed=seed + 17)
    # (case, src, dst, beta, noise bound of the dense agreement or None)
    adjacency_cases = [
        ("main", src_main[:DENSE_BATCH], dst_main[:DENSE_BATCH], trim_beta(NOISE_BOUND),
         NOISE_BOUND),
        ("large", large_src[..., :dn], large_dst[..., :dn], trim_beta(LARGE_NOISE_BOUND),
         LARGE_NOISE_BOUND),
        *[(name, inputs[name][0], inputs[name][1], inputs[name][3], None) for name in
          ("one_point", "two_blocks", "scattered", "gathered_subset")],
        ("near_threshold", near_src, near_dst, near_beta, None),
        ("wide", wide_src[None], wide_dst[None], trim_beta(LARGE_NOISE_BOUND), None),
    ]
    for name, s_np, d_np, bt, nb in adjacency_cases:
        s, d = _to(device, s_np, d_np)
        res = _compare_and_time(
            lambda: ck.trim_adjacency_i8(s, d, bt),
            lambda: ck.trim_adjacency_i8_plain(s, d, bt), device, 20, 3,
            poison=((s.shape[0], s.shape[-1], s.shape[-1]), torch.int8))
        got = ck.trim_adjacency_i8(s, d, bt)
        res["diagonal_zero"] = not bool(got.diagonal(dim1=-2, dim2=-1).any())
        res["equal"] = res["equal"] and res["diagonal_zero"]
        if nb is not None:
            dense = trim_adjacency_dense(s, d, nb)
            res["agreement_with_trim_adjacency_dense"] = float(
                (got.bool() == dense).sum(dtype=torch.float64) / dense.numel())
            res["equal"] = res["equal"] and res["agreement_with_trim_adjacency_dense"] >= 0.9999
            del dense
        del got
        bound_ms, bound_by, pairs, terms = trim_adjacency_bound_ms(s.shape[0], s.shape[-1])
        results["trim_adjacency_i8"].append(dict(
            case=name, **shape_of(s), **res, bound_ms=bound_ms, bound_by=bound_by,
            bound_pairs=pairs, bound_terms_ms=terms))
        del s, d

    results["greedy_clique"] = greedy_phase(device, inputs)
    results["tls_sweep"] = tls_sweep_phase(device)
    return results


def greedy_cases(device, inputs: dict) -> list:
    """The greedy clique kernel's inputs on ``device``, [(case, rows, order,
    allowed)], each with its path's seeds: K1's words of phase 4's bunny
    problems, ``solve_large_sharded``'s dense sub-adjacency of the
    N=100,000 problem (the top ``SUBGRAPH_M`` by score), and (7, 333)'s
    scattered validity with the problems ``GREEDY_SKIPPED`` skipped."""
    import torch
    from teaserpp_tpu_torch.clique.heuristic import greedy_order_and_allowed
    from teaserpp_tpu_torch.clique.kcore import (
        core_numbers,
        core_numbers_from_bits,
        pack_bits_u32,
    )
    from teaserpp_tpu_torch.ops import cuda_kernels as ck
    from teaserpp_tpu_torch.ops.tims import trim_adjacency_dense, trim_beta
    from teaserpp_tpu_torch.parallel.sharded import candidate_scores, top_candidates

    def from_words(name, words, n, valid, skip=None):
        core = core_numbers_from_bits(words, n, valid)
        order, allowed = greedy_order_and_allowed(core, valid, skip)
        return name, words.transpose(-1, -2).contiguous(), order, allowed

    src, dst = _to(device, *make_problems(BATCH, N_POINTS))
    valid = torch.ones(src.shape[0], src.shape[-1], dtype=torch.bool, device=device)
    cases = [from_words("bunny_batch", ck.trim_bits(src, dst, valid, trim_beta(NOISE_BOUND)),
                        src.shape[-1], valid)]
    del src, dst, valid

    src, dst = _to(device, *inputs["large"][:2])
    score, _ = candidate_scores(src, dst, large_params())
    top = top_candidates(score, min(SUBGRAPH_M, src.shape[-1]))
    sub = trim_adjacency_dense(src[..., top], dst[..., top], LARGE_NOISE_BOUND)
    order, allowed = greedy_order_and_allowed(core_numbers(sub))
    cases.append(("sharded_subgraph", pack_bits_u32(sub), order, allowed))
    del src, dst, sub

    s_np, d_np, v_np, beta = inputs["scattered"]
    src, dst, valid = _to(device, s_np, d_np, v_np)
    skip = torch.zeros(src.shape[0], dtype=torch.bool, device=device)
    skip[list(GREEDY_SKIPPED)] = True
    cases.append(from_words("padded_odd", ck.trim_bits(src, dst, valid, beta),
                            src.shape[-1], valid, skip))
    return cases


def greedy_phase(device, inputs: dict) -> list:
    """The greedy clique kernel against its plain version at
    :func:`greedy_cases`' shapes: member words and sizes exactly equal (the
    members on the allocator block filled with a pattern), both timed, and
    two least times at the memory's rate: the row words its lanes' steps
    read, sum over lanes of (size - 1) W 4 bytes (the bound), and the words
    read once."""
    import torch
    from teaserpp_tpu_torch.ops import cuda_kernels as ck

    results = []
    for name, rows, order, allowed in greedy_cases(device, inputs):
        bsz, n, words = rows.shape
        seeds = min(GREEDY_SEEDS, n)
        poisoned_at = _poison_allocator(device, (bsz, seeds, words), torch.int32)
        members, sizes = ck.greedy_clique(rows, order, allowed, seeds)
        if poisoned_at is not None and members.data_ptr() != poisoned_at:
            raise AssertionError("the members did not land on the block filled with the pattern")
        want_members, want_sizes = ck.greedy_clique_plain(rows, order, allowed, seeds)
        _sync(device)
        differing = int((members != want_members).sum() + (sizes != want_sizes).sum())
        row_bytes = int((sizes.long() - 1).clamp(min=0).sum()) * words * 4
        results.append(dict(
            case=name, batch=bsz, n=n, seeds=seeds, equal=differing == 0,
            elements_differing=differing,
            max_abs_err=max(_max_abs_diff(members, want_members),
                            _max_abs_diff(sizes, want_sizes)),
            size_min=int(sizes.min()), size_max=int(sizes.max()),
            ms=time_ms(lambda: ck.greedy_clique(rows, order, allowed, seeds), 20, device),
            plain_ms=time_ms(lambda: ck.greedy_clique_plain(rows, order, allowed, seeds), 3,
                             device),
            bound_ms=row_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            bound_row_bytes=row_bytes,
            words_once_ms=rows.numel() * 4 / HBM_BYTES_PER_S * 1e3))
        del members, sizes, want_members, want_sizes
    return results


def tls_sweep_cases(device) -> list:
    """Kernel S's inputs on ``device``, [(case, perm, x, ranges, vmask)], as
    ``solve_scale_tls`` hands them to ``scalar_tls``: the raw scales and
    half-intervals of the TIM pairs of ``TLS_SWEEP_BATCH`` bunny problems
    at N = 1,889 with s = 2.5, a cloud each (one chunk of the unknown-scale
    batch), in float32; and of 4 of them in float64."""
    import torch
    from teaserpp_tpu_torch.ops.tims import compute_tim_norms

    src, dst = _to(device, *make_problems(TLS_SWEEP_BATCH, N_POINTS, shared_cloud=False,
                                          scale=TLS_SWEEP_SCALE))
    src_norms, dst_norms = compute_tim_norms(src), compute_tim_norms(dst)
    del src, dst
    cases = []
    for name, dtype, bsz in (("chunk", torch.float32, TLS_SWEEP_BATCH),
                             ("float64", torch.float64, 4)):
        sn, dn = src_norms[:bsz].to(dtype), dst_norms[:bsz].to(dtype)
        safe = torch.where(sn > 0, sn, torch.ones_like(sn))
        x, ranges, vmask = dn / safe, 2.0 * NOISE_BOUND / safe, (sn > 0).to(dtype)
        perm = torch.sort(torch.cat([x - ranges, x + ranges], dim=-1), dim=-1,
                          stable=True).indices
        cases.append((name, perm, x, ranges, vmask))
        del sn, dn, safe
    return cases


def tls_sweep_phase(device) -> list:
    """Kernel S against its plain version at :func:`tls_sweep_cases`'
    shapes: equal hashes of the estimates and costs, both timed, the
    kernel's launches counted (pack, totals, a carry level each, sweep),
    peak memory above the inputs, one call profiled, and the bound: each
    pass reads an event's int64 permutation entry, 16 B an event at the
    memory's rate."""
    import torch
    from teaserpp_tpu_torch.ops import cuda_kernels as ck

    def peak_bytes(fn):
        if device.type != "cuda":
            return None
        _sync(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        fn()
        _sync(device)
        return torch.cuda.max_memory_allocated(device) - base

    results = []
    for name, perm, x, ranges, vmask in tls_sweep_cases(device):
        ck.reset_launches()
        got = ck.tls_sweep(perm, x, ranges, vmask)
        _sync(device)
        launches = ck.LAUNCHES["tls_sweep"]
        want = ck.tls_sweep_plain(perm, x, ranges, vmask)
        got_hash = _hash(*(t.cpu().numpy() for t in got))
        want_hash = _hash(*(t.cpu().numpy() for t in want))
        events = perm.numel()
        res = dict(
            case=name, batch=int(x.shape[0]), n=int(x.shape[-1]), events=events,
            dtype=str(x.dtype), hash=got_hash, plain_hash=want_hash,
            equal=got_hash == want_hash and launches == (
                3 + len(ck._carry_strides(-(-2 * int(x.shape[-1]) // 64)))
                if device.type == "cuda" else 0),
            launches=launches, scale_min=float(got[0].min()), scale_max=float(got[0].max()),
            ms=time_ms(lambda: ck.tls_sweep(perm, x, ranges, vmask), 20, device),
            plain_ms=time_ms(lambda: ck.tls_sweep_plain(perm, x, ranges, vmask), 3, device),
            bound_ms=16 * events / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            peak_bytes=peak_bytes(lambda: ck.tls_sweep(perm, x, ranges, vmask)),
            plain_peak_bytes=peak_bytes(lambda: ck.tls_sweep_plain(perm, x, ranges, vmask)),
            profile=device_busy_phase(device, lambda: ck.tls_sweep(perm, x, ranges, vmask)))
        results.append(res)
        del got, want, perm, x, ranges, vmask
    return results


def schedule_phase() -> dict:
    """The tile kernels' task numbering, decoded by the compiled
    ``trim::decode_task`` (``csrc/trim_tile.cuh``) through the host entry of
    the built ``trim_bits`` library: every unordered 32x32 block of a problem
    is in exactly one task, for ragged N, and the first and last task of a
    word row decode right at the largest sizes the launch takes."""
    import ctypes
    from teaserpp_tpu_torch.ops import _build

    lib = _build.load_library("trim_bits")
    lib.trim_bits_task_count.argtypes = [ctypes.c_int]
    lib.trim_bits_task_count.restype = ctypes.c_longlong
    lib.trim_bits_decode_tasks.argtypes = [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.trim_bits_decode_tasks.restype = None

    def decode(t0: int, count: int, words: int) -> np.ndarray:
        out = np.empty((count, 3), np.int32)
        lib.trim_bits_decode_tasks(t0, count, words, out.ctypes.data)
        return out

    covered = []
    for n in (1, 31, 33, 257, N_POINTS, 10007, LARGE_N):
        words = (n + 31) // 32
        tasks = int(lib.trim_bits_task_count(words))
        seen = np.zeros((words, words), np.int32)
        for row_block, col_block0, active in decode(0, tasks, words):
            if not (0 <= row_block <= col_block0 and active >= 1
                    and col_block0 + active <= words):
                raise AssertionError(f"task outside the triangle at N={n}")
            seen[row_block, col_block0:col_block0 + active] += 1
        if not np.array_equal(seen, np.triu(np.ones_like(seen))):
            raise AssertionError(f"tasks do not cover each unordered block once at N={n}")
        covered.append(dict(n=n, words=words, tasks=tasks))

    edges = 0
    for words in (3125, 65535, 370_000):
        for m in (1, 2, words // 2, words - 1, words):  # the word row of length m
            first = int(lib.trim_bits_task_count(m - 1))
            last = int(lib.trim_bits_task_count(m)) - 1
            (r0, c0, _), (r1, c1, a1) = decode(first, 1, words)[0], decode(last, 1, words)[0]
            if (r0, c0) != (words - m, words - m) or r1 != words - m or c1 + a1 != words:
                raise AssertionError(f"task decode wrong at words={words}, row length {m}")
            edges += 2
    return dict(covered=covered, row_edges_decoded=edges)


def refusal_phase(device) -> dict:
    """What the tile kernels' launch does not take raises, and counts no
    launch: a batch beyond the grid's second axis, for all three; and the
    greedy clique's wrong dtype, shape and device, and rows too long for
    its launch."""
    import torch
    from teaserpp_tpu_torch.ops import cuda_kernels as ck

    bsz = 65536
    s = torch.zeros(bsz, 3, 1, device=device)
    v = torch.ones(bsz, 1, dtype=torch.bool, device=device)
    ck.reset_launches()
    refused = {}
    for name, call in (("trim_bits", lambda: ck.trim_bits(s, s, v, 0.01)),
                       ("trim_degrees", lambda: ck.trim_degrees(s, s, 0.01)),
                       ("trim_adjacency_i8", lambda: ck.trim_adjacency_i8(s, s, 0.01))):
        try:
            call()
        except RuntimeError as exc:
            refused[name] = str(exc)
        else:
            raise AssertionError(f"{name} took a batch of {bsz}")

    # the greedy clique: its wrapper's checks, and a launch whose rows pass
    # a block's shared memory (n = 1,000,000: 31,250 words a row; the launch
    # refuses it before it reads a pointer)
    rows = torch.zeros(2, 40, 2, dtype=torch.int32, device=device)
    order = torch.arange(40, dtype=torch.int32, device=device).repeat(2, 1)
    allowed = torch.full((2, 2), -1, dtype=torch.int32, device=device)
    for name, call in (
            ("greedy_clique dtype", lambda: ck.greedy_clique(rows.long(), order, allowed, 4)),
            ("greedy_clique shape", lambda: ck.greedy_clique(rows, order[:, 1:].contiguous(),
                                                             allowed, 4)),
            ("greedy_clique device", lambda: ck.greedy_clique(rows, order.cpu(), allowed, 4)),
            ("greedy_clique launch", lambda: ck._launch(
                "greedy_clique", "greedy_clique", device, 0, 0, 0, 0, 0, 1, 1_000_000, 64))):
        try:
            call()
        except (TypeError, ValueError, RuntimeError) as exc:
            refused[name] = str(exc)
        else:
            raise AssertionError(f"{name} was taken")
    if any(ck.LAUNCHES.values()):
        raise AssertionError(f"a refused launch was counted: {ck.LAUNCHES}")
    return refused


def sqrt_filter_phase(device) -> dict:
    """The bound that ``trim_adjacency_i8``'s filter stands on
    (``csrc/trim_tile.cuh``'s GramDistPred): the kernel's approximate square
    root lies within 2^-21 sqrt(x) + 2^-63 of the IEEE one for every finite
    float x >= 0, checked over all of them by the library's own check
    kernel."""
    import ctypes
    import torch
    from teaserpp_tpu_torch.ops import _build

    fn = _build.load_library("trim_adjacency").trim_adjacency_sqrt_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(2, dtype=torch.int64, device=device)
    t0 = time.perf_counter()
    if fn(out.data_ptr(), torch.cuda.current_stream(device).cuda_stream) != 0:
        raise RuntimeError("the square-root check did not launch")
    torch.cuda.synchronize()
    outside, worst = (int(v) for v in out.cpu())
    res = dict(inputs=0x7F800000, outside_bound=outside, max_ulps_normal_inputs=worst,
               seconds=time.perf_counter() - t0)
    if outside:
        raise AssertionError(f"the approximate square root leaves its bound: {res}")
    return res


def _require_launched(device, launches: dict, path: str, kernels: list) -> None:
    """Fail if a kernel that ``path`` runs on the card was launched no time."""
    missing = [k for k in kernels if launches[k] == 0]
    if device.type == "cuda" and missing:
        raise AssertionError(f"{path} did not launch {missing}: {launches}")


def path_phase(device, src, dst, repeats: int = 5):
    """The main path: solve_batch through the kernels, gated on accuracy."""
    import torch
    from teaserpp_tpu_torch import solve_batch
    from teaserpp_tpu_torch.convert import solution_to_numpy
    from teaserpp_tpu_torch.ops import cuda_kernels as ck
    from teaserpp_tpu_torch.utils.metrics import rotation_error_deg, translation_error

    params = bench_params()
    src_d = torch.from_numpy(src).to(device)
    dst_d = torch.from_numpy(dst).to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    ck.reset_launches()
    t0 = time.perf_counter()
    sol = solve_batch(src_d, dst_d, params, device=device)
    sync()
    first_s = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)

    sol_np = solution_to_numpy(sol)
    bsz = src.shape[0]
    for name in ("rotation", "translation"):  # the cost is inf on a degenerate GNC stop
        if not np.isfinite(getattr(sol_np, name)).all():
            raise AssertionError(f"non-finite {name}")
    if sol_np.rotation.shape != (bsz, 3, 3) or sol_np.translation.shape != (bsz, 3):
        raise AssertionError("solution has the wrong shape")
    rot_err = np.array([rotation_error_deg(sol_np.rotation[p], T[:3, :3]) for p in range(bsz)])
    t_err = np.array([translation_error(sol_np.translation[p], T[:3, 3]) for p in range(bsz)])
    accuracy_ok = bool((rot_err < 0.1).all() and (t_err < 0.01).all() and sol_np.valid.all())
    if not accuracy_ok:
        raise AssertionError(
            f"accuracy gate failed: max rot {rot_err.max()} deg, max t {t_err.max()} m, "
            f"{int((~sol_np.valid).sum())} invalid"
        )
    _require_launched(device, launches, "solve_batch", ["trim_bits"])
    if launches["tls_sweep"]:  # the known-scale branch sweeps no scale TLS
        raise AssertionError(f"the known-scale batch launched kernel S: {launches}")

    windows = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        for _ in range(repeats):
            solve_batch(src_d, dst_d, params, device=device)
        sync()
        windows.append(time.perf_counter() - t0)
    seconds_per_batch = min(windows) / repeats

    stage_ms = {}
    solve_batch(src_d, dst_d, params, device=device, stage_ms=stage_ms)
    return sol_np, dict(
        batch=bsz, n=int(src.shape[-1]),
        registrations_per_s=bsz / seconds_per_batch,
        seconds_per_batch=seconds_per_batch,
        first_call_s=first_s,
        stage_ms=stage_ms,
        launches=launches,
        accuracy_ok=accuracy_ok,
        rot_err_deg_max=float(rot_err.max()),
        trans_err_m_max=float(t_err.max()),
        clique_size_min=int(sol_np.clique_mask.sum(-1).min()),
        clique_size_max=int(sol_np.clique_mask.sum(-1).max()),
        gnc_iterations_max=int(sol_np.rotation_iterations.max()),
        gnc_iterations_mean=float(sol_np.rotation_iterations.mean()),
    )


def parity_phase(src, dst, sol_dev):
    """The port on the CPU for the first problems must match the card's run."""
    from teaserpp_tpu_torch import solve_batch
    from teaserpp_tpu_torch.convert import solution_to_numpy

    k = PARITY_PROBLEMS
    cpu = solution_to_numpy(solve_batch(src[:k], dst[:k], bench_params(), device="cpu"))
    masks_equal = bool(np.array_equal(cpu.clique_mask, sol_dev.clique_mask[:k]))
    rot_diff = float(max(np.linalg.norm(cpu.rotation[p] - sol_dev.rotation[p]) for p in range(k)))
    t_diff = float(max(np.linalg.norm(cpu.translation[p] - sol_dev.translation[p]) for p in range(k)))
    if not masks_equal or rot_diff > PARITY_TOL or t_diff > PARITY_TOL:
        raise AssertionError(
            f"CPU/GPU parity failed: masks_equal={masks_equal}, "
            f"rotation {rot_diff}, translation {t_diff} (tolerance {PARITY_TOL})"
        )
    return dict(problems=k, clique_masks_equal=masks_equal,
                rotation_frobenius_max=rot_diff, translation_max=t_diff,
                iterations_equal=bool(np.array_equal(
                    cpu.rotation_iterations, sol_dev.rotation_iterations[:k])))


def _large_gate(name: str, res, r_true, t_true, inlier) -> dict:
    """The JAX tests' limits for the huge-N path: valid, <0.5 deg, <0.02."""
    from teaserpp_tpu_torch.utils.metrics import rotation_error_deg, translation_error

    sol = res.solution
    if sol.rotation.shape != (3, 3) or sol.translation.shape != (3,):
        raise AssertionError(f"{name}: solution has the wrong shape")
    if not (np.isfinite(sol.rotation).all() and np.isfinite(sol.translation).all()):
        raise AssertionError(f"{name}: non-finite solution")
    rot_err = rotation_error_deg(sol.rotation, r_true)
    t_err = translation_error(sol.translation, t_true)
    members = int(sol.clique_mask.sum())
    true_members = int((sol.clique_mask & inlier).sum())
    out = dict(valid=bool(sol.valid), rot_err_deg=rot_err, trans_err=t_err,
               max_core=int(res.max_core), clique_size=int(res.clique_size),
               clique_true_inlier_share=true_members / max(members, 1),
               true_inliers=int(inlier.sum()))
    if not (out["valid"] and rot_err < 0.5 and t_err < 0.02 and members == out["clique_size"]):
        raise AssertionError(f"{name}: accuracy gate failed: {out}")
    return out


def large_phase(device, n: int, repeats: int = 3):
    """The huge-N path: solve_large_sharded on one problem, gated on accuracy."""
    from teaserpp_tpu_torch import solve_large_sharded
    from teaserpp_tpu_torch.convert import large_result_to_numpy
    from teaserpp_tpu_torch.ops import cuda_kernels as ck

    src, dst, r_true, t_true, inlier = make_large_problem(n)
    params = large_params()
    src_d, dst_d = _to(device, src, dst)

    ck.reset_launches()
    t0 = time.perf_counter()
    res = solve_large_sharded(src_d, dst_d, params, device=device)
    _sync(device)
    first_s = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    _require_launched(device, launches, "solve_large_sharded", ["trim_bits"])
    res_np = large_result_to_numpy(res)
    gate = _large_gate("solve_large_sharded", res_np, r_true, t_true, inlier)

    times = []
    for _ in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        solve_large_sharded(src_d, dst_d, params, device=device)
        _sync(device)
        times.append(time.perf_counter() - t0)
    stage_ms = {}
    solve_large_sharded(src_d, dst_d, params, device=device, stage_ms=stage_ms)
    return dict(
        n=n, seconds_per_solve=statistics.median(times), seconds_all=times,
        first_call_s=first_s, stage_ms=stage_ms, launches=launches,
        gnc_iterations=int(res_np.solution.rotation_iterations), **gate)


def exact_phase(device, n: int, heuristic_clique_size=None):
    """The exact huge-N path: solve_large_exact, same gate, and a clique no
    smaller than the heuristic's on the same problem."""
    from teaserpp_tpu_torch import solve_large_exact, solve_large_sharded
    from teaserpp_tpu_torch.convert import large_result_to_numpy
    from teaserpp_tpu_torch.ops import cuda_kernels as ck

    src, dst, r_true, t_true, inlier = make_large_problem(n)
    params = large_params()
    src_d, dst_d = _to(device, src, dst)
    if heuristic_clique_size is None:
        heuristic_clique_size = int(
            solve_large_sharded(src_d, dst_d, params, device=device).clique_size)

    ck.reset_launches()
    t0 = time.perf_counter()
    res = solve_large_exact(src_d, dst_d, params, time_limit=EXACT_TIME_LIMIT_S,
                            device=device)
    _sync(device)
    seconds = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    _require_launched(device, launches, "solve_large_exact", ["trim_bits"])
    gate = _large_gate("solve_large_exact", large_result_to_numpy(res), r_true, t_true, inlier)
    if gate["clique_size"] < heuristic_clique_size:
        raise AssertionError(
            f"exact clique {gate['clique_size']} smaller than the heuristic's "
            f"{heuristic_clique_size}")
    return dict(n=n, seconds=seconds, time_limit_s=EXACT_TIME_LIMIT_S, launches=launches,
                heuristic_clique_size=heuristic_clique_size, **gate)


def ops_phase(device, n: int, dense_n: int):
    """The two kernels that sit on no solver path, driven as a user would:
    TRIM degrees of the huge problem and the dense int8 adjacency of its
    first ``dense_n`` correspondences, gated on what the planted inliers
    imply. Any two inliers are consistent (their distances differ by at most
    2 sqrt(3) nb/2 < 2 nb), so an inlier's degree is at least the inlier
    count less one, and the inlier block of the adjacency is all ones off the
    diagonal."""
    import torch
    from teaserpp_tpu_torch.ops import cuda_kernels as ck
    from teaserpp_tpu_torch.ops.tims import trim_beta

    src, dst, _, _, inlier = make_large_problem(n)
    beta = trim_beta(LARGE_NOISE_BOUND)
    src_d, dst_d = _to(device, src[None], dst[None])
    dense_n = min(dense_n, n)
    src_s, dst_s = src_d[..., :dense_n].contiguous(), dst_d[..., :dense_n].contiguous()
    inl = torch.from_numpy(inlier).to(device)

    ck.reset_launches()
    deg = ck.trim_degrees(src_d, dst_d, beta)[0]
    adj = ck.trim_adjacency_i8(src_s, dst_s, beta)[0]
    _sync(device)
    launches = dict(ck.LAUNCHES)
    _require_launched(device, launches, "the public kernel operations",
                      ["trim_degrees", "trim_adjacency_i8"])

    n_in = int(inlier.sum())
    inl_s = inl[:dense_n]
    block = adj[inl_s][:, inl_s]
    out = dict(
        n=n, dense_n=dense_n, launches=launches,
        degrees_shape_ok=tuple(deg.shape) == (n,) and deg.dtype == torch.int32,
        inlier_degree_min=int(deg[inl].min()), inliers=n_in,
        outlier_degree_mean=float(deg[~inl].double().mean()),
        adjacency_shape_ok=tuple(adj.shape) == (dense_n, dense_n) and adj.dtype == torch.int8,
        adjacency_symmetric=bool(torch.equal(adj, adj.T)),
        adjacency_diagonal_zero=not bool(adj.diagonal().any()),
        inlier_block_complete=int(block.sum()) == int(inl_s.sum()) * (int(inl_s.sum()) - 1),
        # the first dense_n vertices' degrees inside that subgraph never exceed the whole graph's
        subgraph_degrees_within=bool((adj.sum(dim=0, dtype=torch.int32) <= deg[:dense_n]).all()),
    )
    ok = (out["degrees_shape_ok"] and out["inlier_degree_min"] >= n_in - 1
          and out["adjacency_shape_ok"] and out["adjacency_symmetric"]
          and out["adjacency_diagonal_zero"] and out["inlier_block_complete"]
          and out["subgraph_degrees_within"])
    if not ok:
        raise AssertionError(f"public kernel operations failed their gate: {out}")
    return out


def large_parity_phase(device, n: int):
    """The port's huge-N path on the CPU against ``device`` at a small N: the
    heuristic solve in both branches (dense peel, and bit words with the
    binary-search core) and the exact solve."""
    import torch
    from teaserpp_tpu_torch import solve_large_exact, solve_large_sharded
    from teaserpp_tpu_torch.convert import large_result_to_numpy
    from teaserpp_tpu_torch.parallel.sharded import candidate_scores, top_candidates

    src, dst, *_ = make_large_problem(n)
    params = large_params()
    m = min(256, n)

    def run(branch, threshold, dev):
        """-> (candidate order or None, the branch's result as numpy)."""
        if branch == "exact":
            # one search thread: with several, which of two equal cliques
            # wins is a matter of timing
            return None, large_result_to_numpy(solve_large_exact(
                src, dst, params, time_limit=EXACT_TIME_LIMIT_S, num_threads=1, device=dev))
        s, d = _to(dev, src[None], dst[None])
        score, _ = candidate_scores(s, d, params, threshold)
        return top_candidates(score, m).cpu().numpy(), large_result_to_numpy(
            solve_large_sharded(src, dst, params, subgraph_size=m,
                                blocked_threshold=threshold, device=dev))

    out = []
    for branch, threshold in (("dense", 16384), ("bits", 64), ("exact", None)):
        top_c, res_c = run(branch, threshold, torch.device("cpu"))
        top_d, res_d = run(branch, threshold, device)
        row = dict(
            branch=branch, n=n,
            max_core_equal=int(res_c.max_core) == int(res_d.max_core),
            top_idx_equal=branch == "exact" or bool(np.array_equal(top_c, top_d)),
            clique_masks_equal=bool(np.array_equal(
                res_c.solution.clique_mask, res_d.solution.clique_mask)),
            rotation_frobenius=float(np.linalg.norm(
                res_c.solution.rotation - res_d.solution.rotation)),
            translation=float(np.linalg.norm(
                res_c.solution.translation - res_d.solution.translation)),
        )
        if not (row["max_core_equal"] and row["top_idx_equal"] and row["clique_masks_equal"]
                and row["rotation_frobenius"] <= PARITY_TOL and row["translation"] <= PARITY_TOL):
            raise AssertionError(f"CPU/GPU parity of the large path failed: {row}")
        out.append(row)
    return out


TRIM_KERNELS = ("trim_bits", "trim_bits_slab", "trim_degrees", "trim_adjacency_i8")


def _require_no_launch(launches: dict, path: str) -> None:
    """A route that reaches no TRIM kernel, as in the JAX package (the
    facade, the unknown-scale batch, the front end at <= 16,384 matches): a
    launch there means the route changed. (The front end's dense branch
    runs the greedy clique kernel on its subgraph.)"""
    if any(launches[k] for k in TRIM_KERNELS):
        raise AssertionError(f"{path} launched a TRIM kernel: {launches}")


def facade_phase(device, scale: float, repeats: int = 3) -> dict:
    """``RobustRegistrationSolver.solve`` on one bunny-shaped problem at
    N=1889, PMC_EXACT; the scale estimated when ``scale`` is not 1."""
    from teaserpp_tpu_torch import RobustRegistrationSolver, RobustRegistrationSolverParams
    from teaserpp_tpu_torch.ops import cuda_kernels as ck
    from teaserpp_tpu_torch.utils.metrics import rotation_error_deg, translation_error

    src, dst = make_problems(1, N_POINTS, scale=scale)
    params = RobustRegistrationSolverParams(**facade_param_fields(scale != 1.0))
    solver = RobustRegistrationSolver(params, device=device)
    ck.reset_launches()
    t0 = time.perf_counter()
    sol = solver.solve(src[0], dst[0])
    first_s = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    _require_no_launch(launches, "RobustRegistrationSolver.solve")
    if launches["greedy_clique"]:  # PMC_EXACT's host search, not the greedy
        raise AssertionError(f"the facade launched the greedy clique kernel: {launches}")
    if params.estimate_scaling:
        _require_launched(device, launches, "RobustRegistrationSolver.solve", ["tls_sweep"])
    elif launches["tls_sweep"]:
        raise AssertionError(f"the known-scale facade launched kernel S: {launches}")

    out = dict(
        n=N_POINTS, estimate_scaling=params.estimate_scaling, true_scale=scale,
        valid=bool(sol.valid), scale=float(sol.scale),
        scale_err=abs(float(sol.scale) - scale),
        rot_err_deg=rotation_error_deg(sol.rotation, T[:3, :3]),
        trans_err_m=translation_error(sol.translation, T[:3, 3]),
        clique_size=len(solver.getInlierMaxClique()),
        jax_facade_clique_size=JAX_FACADE_CLIQUE,
        scale_inlier_pairs=int(solver.getScaleInliersMask().sum()),
        rotation_cost=solver.getGNCRotationCostAtTermination(),
        first_call_s=first_s, launches=launches,
        rotation=sol.rotation.tolist(), translation=sol.translation.tolist(),
    )
    finite = np.isfinite(sol.rotation).all() and np.isfinite(sol.translation).all()
    if not (finite and sol.rotation.shape == (3, 3) and sol.translation.shape == (3,)
            and out["valid"] and out["rot_err_deg"] < 0.1 and out["trans_err_m"] < 0.01
            and out["scale_err"] < 1e-3 and out["clique_size"] >= JAX_FACADE_CLIQUE):
        raise AssertionError(f"facade gate failed: {out}")

    times, stages = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        solver.solve(src[0], dst[0])
        times.append(time.perf_counter() - t0)
        stages.append({k: v * 1e3 for k, v in solver.getStageTimings().items()})
    return dict(out, seconds_per_solve=statistics.median(times), seconds_all=times,
                stage_ms_all=stages)


def scale_batch_phase(device, problems, repeats: int = 3):
    """``solve_batch`` with unknown scale on bench_scale_est.py's problems,
    every problem inside tests/test_registration_e2e.py's gate."""
    import torch
    from teaserpp_tpu_torch import solve_batch
    from teaserpp_tpu_torch.convert import solution_to_numpy
    from teaserpp_tpu_torch.ops import cuda_kernels as ck
    from teaserpp_tpu_torch.utils.metrics import angular_error, translation_error

    src, dst, s_true, r_true, t_true = problems
    params = scale_params()
    src_d, dst_d = _to(device, src, dst)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
        base_bytes = torch.cuda.memory_allocated(device)
    ck.reset_launches()
    t0 = time.perf_counter()
    sol = solve_batch(src_d, dst_d, params, device=device)
    _sync(device)
    first_s = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    _require_no_launch(launches, "solve_batch with estimate_scaling")
    _require_launched(device, launches, "solve_batch with estimate_scaling", ["tls_sweep"])
    peak_gb = ((torch.cuda.max_memory_allocated(device) - base_bytes) / 1e9
               if on_card else None)

    sol_np = solution_to_numpy(sol)
    bsz = src.shape[0]
    if not (np.isfinite(sol_np.rotation).all() and np.isfinite(sol_np.translation).all()
            and np.isfinite(sol_np.scale).all()):
        raise AssertionError("non-finite solution")
    s_err = np.abs(sol_np.scale - s_true)
    r_err = np.array([angular_error(sol_np.rotation[p], r_true[p]) for p in range(bsz)])
    t_err = np.array([translation_error(sol_np.translation[p], t_true[p]) for p in range(bsz)])
    gate = dict(scale_err_max=float(s_err.max()), rot_err_rad_max=float(r_err.max()),
                trans_err_max=float(t_err.max()), invalid=int((~sol_np.valid).sum()))
    if not ((s_err < 1e-3).all() and (r_err < 0.01).all() and (t_err < 0.02).all()
            and sol_np.valid.all()):
        raise AssertionError(f"unknown-scale batch gate failed: {gate}")

    windows = []
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(repeats):
            solve_batch(src_d, dst_d, params, device=device)
        _sync(device)
        windows.append(time.perf_counter() - t0)
    seconds_per_batch = min(windows) / repeats
    stage_ms = {}
    solve_batch(src_d, dst_d, params, device=device, stage_ms=stage_ms)
    return sol_np, dict(
        batch=bsz, n=int(src.shape[-1]), pairs_per_problem=int(src.shape[-1]) * (int(src.shape[-1]) - 1) // 2,
        registrations_per_s=bsz / seconds_per_batch, seconds_per_batch=seconds_per_batch,
        seconds_windows=[w / repeats for w in windows], first_call_s=first_s,
        stage_ms=stage_ms, launches=launches, peak_gb_above_inputs=peak_gb, **gate,
        clique_size_min=int(sol_np.clique_mask.sum(-1).min()),
        clique_size_max=int(sol_np.clique_mask.sum(-1).max()),
        gnc_iterations_max=int(sol_np.rotation_iterations.max()),
    )


def scale_parity_phase(device, problems, sol_dev) -> dict:
    """The facade at N=300 with unknown scale, and 4 problems of the
    unknown-scale batch, on the CPU against the card."""
    from teaserpp_tpu_torch import RobustRegistrationSolver, RobustRegistrationSolverParams
    from teaserpp_tpu_torch import solve_batch
    from teaserpp_tpu_torch.convert import solution_to_numpy

    src, dst = make_problems(1, FACADE_PARITY_N, scale=FACADE_SCALE)
    params = RobustRegistrationSolverParams(**facade_param_fields(True))
    res = []
    for dev in ("cpu", device):
        solver = RobustRegistrationSolver(params, device=dev)
        sol = solver.solve(src[0], dst[0])
        res.append((sol, solver.getInlierMaxClique()))
    (c_sol, c_clique), (d_sol, d_clique) = res
    facade = dict(
        n=FACADE_PARITY_N, cliques_equal=c_clique == d_clique, clique_size=len(d_clique),
        scale_diff=abs(c_sol.scale - d_sol.scale),
        rotation_frobenius=float(np.linalg.norm(c_sol.rotation - d_sol.rotation)),
        translation=float(np.linalg.norm(c_sol.translation - d_sol.translation)),
    )
    if not (facade["cliques_equal"] and c_sol.valid and d_sol.valid
            and facade["scale_diff"] <= SCALE_PARITY_TOL
            and facade["rotation_frobenius"] <= PARITY_TOL
            and facade["translation"] <= PARITY_TOL):
        raise AssertionError(f"CPU/GPU parity of the facade failed: {facade}")

    k = PARITY_PROBLEMS
    b_src, b_dst = problems[0][:k], problems[1][:k]
    cpu = solution_to_numpy(solve_batch(b_src, b_dst, scale_params(), device="cpu"))
    batch = dict(
        problems=k,
        clique_masks_equal=bool(np.array_equal(cpu.clique_mask, sol_dev.clique_mask[:k])),
        scale_pair_masks_equal=bool(np.array_equal(cpu.scale_pair_mask,
                                                   sol_dev.scale_pair_mask[:k])),
        scale_diff_max=float(np.abs(cpu.scale - sol_dev.scale[:k]).max()),
        rotation_frobenius_max=float(max(np.linalg.norm(cpu.rotation[p] - sol_dev.rotation[p])
                                         for p in range(k))),
        translation_max=float(max(np.linalg.norm(cpu.translation[p] - sol_dev.translation[p])
                                  for p in range(k))),
    )
    if not (batch["clique_masks_equal"] and batch["scale_pair_masks_equal"]
            and batch["scale_diff_max"] <= SCALE_PARITY_TOL
            and batch["rotation_frobenius_max"] <= PARITY_TOL
            and batch["translation_max"] <= PARITY_TOL):
        raise AssertionError(f"CPU/GPU parity of the unknown-scale batch failed: {batch}")
    return dict(facade=facade, batch=batch)


def clique_params(**change):
    """bench.py's problem parameters with the library's default inlier
    selection (PMC_EXACT, which the batched path runs as the greedy clique;
    kcore_heuristic_threshold 0.5; 64 seeds)."""
    from teaserpp_tpu_torch.params import RobustRegistrationSolverParams

    return RobustRegistrationSolverParams(
        noise_bound=NOISE_BOUND, cbar2=1.0, estimate_scaling=False,
        rotation_cost_threshold=0.005).replace(**change)


def _hash(*arrays) -> str:
    """sha256 of the arrays' bytes (dtype and shape included), 16 hex digits."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _solution_hash(sol) -> str:
    from teaserpp_tpu_torch.convert import solution_to_numpy

    return _hash(*solution_to_numpy(sol))


def _host_clique_check(src, dst, masks, problems: int) -> list:
    """Each of the first ``problems`` masks is a clique of the TRIM graph,
    read from the plain version of K1's words on the host. Returns the
    clique sizes."""
    import torch
    from teaserpp_tpu_torch.ops import cuda_kernels as ck
    from teaserpp_tpu_torch.ops.tims import trim_beta
    from teaserpp_tpu_torch.parallel.sharded import _unpack_bits_rows

    s, d = _to(torch.device("cpu"), src[:problems], dst[:problems])
    valid = torch.ones(problems, src.shape[-1], dtype=torch.bool)
    words = ck.trim_adjacency_bits_plain(s, d, valid, trim_beta(NOISE_BOUND)).numpy()
    sizes = []
    for p in range(problems):
        adj = _unpack_bits_rows(words[p], src.shape[-1])
        idx = np.flatnonzero(masks[p])
        if adj[np.ix_(idx, idx)].sum() != idx.size * (idx.size - 1):
            raise AssertionError(f"problem {p}: the clique mask is not a clique of K1's graph")
        sizes.append(int(idx.size))
    return sizes


def clique_batch_phase(device, src, dst, top_core_masks, repeats: int = 3):
    """The clique-mode batch: ``solve_batch`` on the batched-bunny problems
    under the library's default selector (PMC_EXACT -> the batched greedy
    clique), gated on accuracy, K1 and the greedy clique kernel launched
    once a solve each, the masks of 8 problems cliques of K1's graph on the
    host; PMC_HEU and KCORE_HEU 0.5 give the same masks; KCORE_HEU where the
    shortcut fires on every problem gives the top k-core, and where it fires
    on some, the top k-core there and the greedy clique elsewhere."""
    import torch
    from teaserpp_tpu_torch import solve_batch
    from teaserpp_tpu_torch.clique.kcore import core_numbers_from_bits
    from teaserpp_tpu_torch.convert import solution_to_numpy
    from teaserpp_tpu_torch.ops import cuda_kernels as ck
    from teaserpp_tpu_torch.ops.tims import trim_beta
    from teaserpp_tpu_torch.params import InlierSelectionMode
    from teaserpp_tpu_torch.utils.metrics import rotation_error_deg, translation_error

    params = clique_params()
    src_d, dst_d = _to(device, src, dst)
    bsz, _, n = src.shape
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
        base_bytes = torch.cuda.memory_allocated(device)
    ck.reset_launches()
    t0 = time.perf_counter()
    sol = solve_batch(src_d, dst_d, params, device=device)
    _sync(device)
    first_s = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    peak_gb = ((torch.cuda.max_memory_allocated(device) - base_bytes) / 1e9
               if on_card else None)
    _require_launched(device, launches, "solve_batch (clique modes)", ["trim_bits"])
    for kernel in ("trim_bits", "greedy_clique"):
        if on_card and launches[kernel] != 1:
            raise AssertionError(f"{kernel} launched {launches[kernel]} times in one solve")

    sol_np = solution_to_numpy(sol)
    if not (np.isfinite(sol_np.rotation).all() and np.isfinite(sol_np.translation).all()):
        raise AssertionError("non-finite clique-mode solution")
    rot_err = np.array([rotation_error_deg(sol_np.rotation[p], T[:3, :3]) for p in range(bsz)])
    t_err = np.array([translation_error(sol_np.translation[p], T[:3, 3]) for p in range(bsz)])
    if not ((rot_err < 0.1).all() and (t_err < 0.01).all() and sol_np.valid.all()):
        raise AssertionError(
            f"clique-mode gate failed: max rot {rot_err.max()} deg, max t {t_err.max()} m, "
            f"{int((~sol_np.valid).sum())} invalid")
    host_sizes = _host_clique_check(src, dst, sol_np.clique_mask, 8)

    ck.reset_launches()
    windows = []
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(repeats):
            solve_batch(src_d, dst_d, params, device=device)
        _sync(device)
        windows.append(time.perf_counter() - t0)
    for kernel in ("trim_bits", "greedy_clique"):
        if on_card and ck.LAUNCHES[kernel] != 3 * repeats:
            raise AssertionError(f"{kernel} launched {ck.LAUNCHES[kernel]} times in "
                                 f"{3 * repeats} solves")
    seconds_per_batch = min(windows) / repeats
    stage_ms = {}
    solve_batch(src_d, dst_d, params, device=device, stage_ms=stage_ms)

    # the other modes that run the greedy give the same cliques
    modes = {}
    for name, change in (("PMC_HEU", dict(inlier_selection_mode=InlierSelectionMode.PMC_HEU)),
                         ("KCORE_HEU_0.5", dict(inlier_selection_mode=InlierSelectionMode.KCORE_HEU,
                                                kcore_heuristic_threshold=0.5))):
        other = solve_batch(src_d, dst_d, clique_params(**change), device=device)
        modes[name] = bool(np.array_equal(other.clique_mask.cpu().numpy(), sol_np.clique_mask))
        if not modes[name]:
            raise AssertionError(f"{name} masks differ from the default selector's")

    # KCORE_HEU's shortcut: max_core > threshold * n on the problems it fires on
    valid = torch.ones(bsz, n, dtype=torch.bool, device=device)
    core = core_numbers_from_bits(
        ck.trim_adjacency_bits_plain(src_d, dst_d, valid, trim_beta(NOISE_BOUND)), n, valid)
    max_core = core.amax(dim=-1).cpu().numpy()
    ratio = max_core / n
    shortcut = {}
    for label, threshold in (("all", round(0.9 * float(ratio.min()), 3)),
                             ("some", round(float(np.median(ratio)), 3))):
        fired = max_core.astype(np.float32) > np.float32(threshold) * np.float32(n)
        got = solve_batch(src_d, dst_d, clique_params(
            inlier_selection_mode=InlierSelectionMode.KCORE_HEU,
            kcore_heuristic_threshold=threshold), device=device).clique_mask.cpu().numpy()
        want = np.where(fired[:, None], top_core_masks, sol_np.clique_mask)
        shortcut[label] = dict(threshold=threshold, problems_fired=int(fired.sum()),
                               masks_equal=bool(np.array_equal(got, want)))
        if not shortcut[label]["masks_equal"]:
            raise AssertionError(f"KCORE_HEU shortcut masks wrong: {shortcut[label]}")
    if shortcut["all"]["problems_fired"] != bsz:
        raise AssertionError(f"the shortcut did not fire everywhere: {shortcut}")

    sizes = sol_np.clique_mask.sum(-1)
    return sol_np, dict(
        batch=bsz, n=n, selector="PMC_EXACT (batched greedy), 64 seeds",
        registrations_per_s=bsz / seconds_per_batch, seconds_per_batch=seconds_per_batch,
        seconds_windows=[w / repeats for w in windows], first_call_s=first_s,
        stage_ms=stage_ms, launches=launches, peak_gb_above_inputs=peak_gb,
        rot_err_deg_max=float(rot_err.max()), trans_err_m_max=float(t_err.max()),
        clique_size_min=int(sizes.min()), clique_size_max=int(sizes.max()),
        top_core_size_min=int(top_core_masks.sum(-1).min()),
        top_core_size_max=int(top_core_masks.sum(-1).max()),
        max_core_min=int(max_core.min()), max_core_max=int(max_core.max()),
        host_checked_clique_sizes=host_sizes, same_masks_as=modes, kcore_shortcut=shortcut,
        gnc_iterations_max=int(sol_np.rotation_iterations.max()),
    )


def device_busy_phase(device, fn, top: int = 8, ranges: str = "") -> dict:
    """One call of ``fn`` under ``torch.profiler`` (CPU and CUDA activity):
    wall time, the summed device time of its kernels (one stream, so they do
    not overlap), the idle share that leaves, the kernel count and the
    kernels that took the most device time; with ``ranges``, the host and
    device time of each ``record_function`` range whose name starts so. A
    profiler that records no device time is reported as such ("not
    measured"), not as an idle card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    # a record_function range also shows on the device's timeline, as a span
    # and not a kernel: those entries are not counted as busy time
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA
               and not (ranges and e.key.startswith(ranges))]

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(e, "device_time_total", 0)

    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    if busy_ms <= 0:
        return dict(wall_ms=wall_ms, device_busy_ms="not measured", idle_share="not measured")
    kernels.sort(key=dev_us, reverse=True)
    out = dict(
        wall_ms=wall_ms, device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / wall_ms,
        kernel_launches=int(sum(e.count for e in kernels)),
        top_kernels=[dict(name=e.key[:90], launches=int(e.count), ms=dev_us(e) / 1e3)
                     for e in kernels[:top]],
    )
    if ranges:
        # a range's host entry holds its wall time on the host and the device
        # time of the kernels launched inside it; its device entry, the span
        # from its first kernel's start to its last kernel's end
        out["ranges"] = {}
        for e in averages:
            if e.key.startswith(ranges):
                r = out["ranges"].setdefault(e.key, {})
                if e.device_type == DeviceType.CUDA:
                    r["device_span_ms"] = dev_us(e) / 1e3
                else:
                    r.update(host_ms=e.cpu_time_total / 1e3,
                             kernel_ms=getattr(e, "device_time_total", 0) / 1e3)
    return out


def clique_parity_phase(src, dst, sol_dev) -> dict:
    """The clique-mode batch on the CPU for the first problems: equal masks."""
    from teaserpp_tpu_torch import solve_batch
    from teaserpp_tpu_torch.convert import solution_to_numpy

    k = PARITY_PROBLEMS
    cpu = solution_to_numpy(solve_batch(src[:k], dst[:k], clique_params(), device="cpu"))
    out = dict(
        problems=k,
        clique_masks_equal=bool(np.array_equal(cpu.clique_mask, sol_dev.clique_mask[:k])),
        rotation_frobenius_max=float(max(np.linalg.norm(cpu.rotation[p] - sol_dev.rotation[p])
                                         for p in range(k))),
        translation_max=float(max(np.linalg.norm(cpu.translation[p] - sol_dev.translation[p])
                                  for p in range(k))),
    )
    if not (out["clique_masks_equal"] and out["rotation_frobenius_max"] <= PARITY_TOL
            and out["translation_max"] <= PARITY_TOL):
        raise AssertionError(f"CPU/GPU parity of the clique-mode batch failed: {out}")
    return out


def facade_defaults_hash(device) -> tuple:
    """One facade solve with the library's defaults (phase 11's problem) ->
    (hash of R, t, s and the clique, s)."""
    from teaserpp_tpu_torch import RobustRegistrationSolver, RobustRegistrationSolverParams

    src, dst = make_problems(1, N_POINTS, scale=FACADE_SCALE)
    solver = RobustRegistrationSolver(
        RobustRegistrationSolverParams(**facade_param_fields(True)), device=device)
    sol = solver.solve(src[0], dst[0])
    clique = np.asarray(solver.getInlierMaxClique(), np.int64)
    return _hash(sol.rotation, sol.translation, np.float64(sol.scale), clique), sol.scale


def determinism_phase(device, scale_problems, bunny) -> dict:
    """Equal inputs, equal bits: the facade defaults 20 times here and once
    in each of 2 fresh processes, the unknown-scale batch 5 times, the
    clique-mode batch 3 times. Also reports whether the facade's s equals
    the port's CPU run bit for bit (no gate)."""
    import torch
    from teaserpp_tpu_torch import solve_batch

    facade = [facade_defaults_hash(device) for _ in range(DETERMINISM_FACADE_RUNS)]
    children = [subprocess.Popen([sys.executable, __file__, CHILD_FLAG], stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
                for _ in range(DETERMINISM_PROCESSES)]
    child_hashes = []
    for proc in children:
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            proc.kill()
        if proc.returncode != 0:
            raise AssertionError(f"determinism child failed: {err[-2000:]}")
        child_hashes.append(json.loads(out.strip().splitlines()[-1])["hash"])

    src, dst, *_ = scale_problems
    s_d, d_d = _to(device, src, dst)
    scale_hashes = [_solution_hash(solve_batch(s_d, d_d, scale_params(), device=device))
                    for _ in range(5)]
    b_src, b_dst = _to(device, *bunny)
    clique_hashes = [_solution_hash(solve_batch(b_src, b_dst, clique_params(), device=device))
                     for _ in range(3)]
    cpu_hash, cpu_s = facade_defaults_hash(torch.device("cpu"))
    facade_hashes = [h for h, _ in facade]
    out = dict(
        facade_defaults=dict(runs=len(facade), processes=len(children),
                             hashes=sorted(set(facade_hashes + child_hashes)),
                             scale=facade[0][1]),
        unknown_scale_batch=dict(runs=5, hashes=sorted(set(scale_hashes))),
        clique_mode_batch=dict(runs=3, hashes=sorted(set(clique_hashes))),
        facade_scale_equals_cpu_bits=bool(np.float64(cpu_s) == np.float64(facade[0][1])),
        facade_cpu_scale=cpu_s, facade_equals_cpu_bits=cpu_hash == facade_hashes[0],
    )
    for name in ("facade_defaults", "unknown_scale_batch", "clique_mode_batch"):
        if len(out[name]["hashes"]) != 1:
            raise AssertionError(f"{name} is not bit-stable: {out[name]}")
    return out


def icp_phase(device, demo: dict) -> dict:
    """``icp_point_to_point`` on the bunny-shaped cloud (N=1889) against its
    transformed copy (noise +-nb/2, no outliers), from the facade demo's
    result turned by 2 degrees and shifted by 5 mm; gated on <0.1 deg, and
    the CPU run within 1e-5."""
    from teaserpp_tpu_torch.ops import cuda_kernels as ck
    from teaserpp_tpu_torch.solvers.icp import icp_point_to_point
    from teaserpp_tpu_torch.utils.metrics import rotation_error_deg, translation_error

    rng = np.random.default_rng(ICP_SEED)
    cloud = np.random.default_rng(0).uniform(0.0, 0.15, (3, N_POINTS))  # make_problems' cloud
    target = T[:3, :3] @ cloud + T[:3, 3:4]
    target = target + rng.uniform(-NOISE_BOUND / 2, NOISE_BOUND / 2, target.shape)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    ang = np.radians(ICP_START_DEG)
    turn = np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * (k @ k)
    shift = rng.normal(size=3)
    shift *= ICP_START_M / np.linalg.norm(shift)
    r0 = turn @ np.asarray(demo["rotation"])
    t0 = np.asarray(demo["translation"]) + shift
    src32, dst32 = cloud.astype(np.float32), target.astype(np.float32)

    def run(dev):
        return icp_point_to_point(src32, dst32, ICP_MAX_DISTANCE, r_init=r0, t_init=t0,
                                  max_iterations=50, device=dev)

    ck.reset_launches()
    t_start = time.perf_counter()
    res = run(device)
    _sync(device)
    first_s = time.perf_counter() - t_start
    launches = dict(ck.LAUNCHES)
    _require_no_launch(launches, "icp_point_to_point")
    times = []
    for _ in range(3):
        t_start = time.perf_counter()
        run(device)
        _sync(device)
        times.append(time.perf_counter() - t_start)
    cpu = run("cpu")
    r, t = res.rotation.cpu().double().numpy(), res.translation.cpu().double().numpy()
    out = dict(
        n=N_POINTS, start_rot_err_deg=rotation_error_deg(r0, T[:3, :3]),
        start_trans_err_m=translation_error(t0, T[:3, 3]),
        rot_err_deg=rotation_error_deg(r, T[:3, :3]), trans_err_m=translation_error(t, T[:3, 3]),
        iterations=int(res.iterations), rmse=float(res.rmse), fitness=float(res.fitness),
        cpu_rotation_max_abs=float(np.abs(cpu.rotation.double().numpy() - r).max()),
        cpu_translation_max_abs=float(np.abs(cpu.translation.double().numpy() - t).max()),
        cpu_iterations=int(cpu.iterations), first_call_s=first_s,
        seconds_per_icp=statistics.median(times), launches=launches,
    )
    if not (np.isfinite(r).all() and out["rot_err_deg"] < 0.1
            and out["cpu_rotation_max_abs"] <= ICP_PARITY_TOL
            and out["cpu_translation_max_abs"] <= ICP_PARITY_TOL):
        raise AssertionError(f"ICP gate failed: {out}")
    return out


def rigid_copy(pts, rng, noise):
    """scripts/bench_frontend_e2e.py's rigid_copy: a uniform random proper
    rotation, t uniform in [-1, 1]^3, Gaussian noise of sd noise / 3.
    Returns (copy (N, 3), R, t)."""
    q, r_ = np.linalg.qr(rng.standard_normal((3, 3)))
    q *= np.sign(np.diag(r_))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    t = rng.uniform(-1, 1, 3)
    dst = pts @ q.T + t + rng.normal(scale=noise / 3, size=pts.shape)
    return dst, q, t


def make_frontend_pair(n: int, seed: int = FRONTEND_SEED, half_width: float = 1.0):
    """The synth100k pair (scripts/bench_frontend_e2e.py:254-258): n points
    uniform in [-w, w]^3 and their rigid copy with noise 0.003."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-half_width, half_width, (n, 3))
    dst, r, t = rigid_copy(pts, rng, FRONTEND_NOISE)
    return pts, dst, r, t


def frontend_params():
    from teaserpp_tpu_torch.params import InlierSelectionMode, RobustRegistrationSolverParams

    return RobustRegistrationSolverParams(
        noise_bound=FRONTEND_NOISE_BOUND, estimate_scaling=False,
        inlier_selection_mode=InlierSelectionMode.KCORE_HEU, kcore_heuristic_threshold=0.0)


def frontend_match(device, src, dst, stages: dict):
    """scripts/bench_frontend_e2e.py:77-110 on the port: plans (host), normals
    and FPFH of both clouds (left on the card), then the matcher with
    cross-check. Each stage is a ``frontend.*`` profiler range and adds its
    seconds to ``stages``. Returns (correspondences, descriptors, plans)."""
    from torch.profiler import record_function
    from teaserpp_tpu_torch.features import (
        Matcher, build_neighbor_plans, compute_fpfh_pruned, estimate_normals_pruned)

    t0 = time.perf_counter()
    with record_function("frontend.plans"):
        plans = [build_neighbor_plans(c, FRONTEND_RADII) for c in (src, dst)]
    t1 = time.perf_counter()
    stages["plans"] = t1 - t0
    xs = [c.astype(np.float32) for c in (src, dst)]
    with record_function("frontend.normals"):
        nres = [estimate_normals_pruned(x, FRONTEND_RADII[0], p[0], device=device)
                for x, p in zip(xs, plans)]
        _sync(device)
    t2 = time.perf_counter()
    stages["normals"] = t2 - t1
    with record_function("frontend.fpfh"):
        desc = [compute_fpfh_pruned(x, r.normals, FRONTEND_RADII[1], p[1], device=device)
                for x, r, p in zip(xs, nres, plans)]
        _sync(device)
    t3 = time.perf_counter()
    stages["fpfh"] = t3 - t2
    with record_function("frontend.matcher"):
        corr = Matcher(device=device).calculateCorrespondences(
            src, dst, desc[0], desc[1], False, True, False, 0.95)
    stages["matcher"] = time.perf_counter() - t3
    return corr, desc, plans


def frontend_run(device, src, dst):
    """scripts/bench_frontend_e2e.py:77-128 on the port: ``frontend_match``,
    then ``solve_large_sharded`` on the matched points. Returns (stage
    seconds, correspondences, descriptors, correspondence points, result,
    plans)."""
    from teaserpp_tpu_torch import solve_large_sharded

    stages = {}
    t0 = time.perf_counter()
    corr, desc, plans = frontend_match(device, src, dst, stages)
    t1 = time.perf_counter()
    ci, cj = np.asarray(corr, np.int64).T
    src_c = np.ascontiguousarray(src[ci].T).astype(np.float32)
    dst_c = np.ascontiguousarray(dst[cj].T).astype(np.float32)
    res = solve_large_sharded(src_c, dst_c, frontend_params(), device=device)
    _sync(device)
    stages["solve"] = time.perf_counter() - t1
    stages["total"] = time.perf_counter() - t0
    return stages, corr, desc, (src_c, dst_c), res, plans


def _frontend_gate(name, res, r_true, t_true) -> dict:
    from teaserpp_tpu_torch.convert import large_result_to_numpy
    from teaserpp_tpu_torch.utils.metrics import rotation_error_deg, translation_error

    r = large_result_to_numpy(res)
    sol = r.solution
    out = dict(rot_err_deg=rotation_error_deg(np.asarray(sol.rotation, np.float64), r_true),
               trans_err_m=translation_error(np.asarray(sol.translation, np.float64), t_true),
               clique_size=int(r.clique_size), max_core=int(r.max_core),
               gnc_iterations=int(sol.rotation_iterations))
    if not (np.isfinite(sol.rotation).all() and np.isfinite(sol.translation).all()
            and out["rot_err_deg"] < 0.1 and out["trans_err_m"] < 0.01):
        raise AssertionError(f"front-end gate failed ({name}): {out}")
    return out


def frontend_phase(device, n: int = FRONTEND_N, repeats: int = 3):
    """Phase 16: the front end at full width, gated on <0.1 deg and <0.01 m
    against the planted transform."""
    import torch
    from teaserpp_tpu_torch import solve_large_sharded
    from teaserpp_tpu_torch.ops import cuda_kernels as ck

    src, dst, r_true, t_true = make_frontend_pair(n)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    first, corr, desc, (src_c, dst_c), res, plans = frontend_run(device, src, dst)
    launches = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9 if device.type == "cuda" else None
    # solve_large_sharded takes its bit-word branch (K1) only above
    # blocked_threshold = 16,384 matches, in JAX as here (sharded.py:67); at
    # synth100k's ~13K the dense branch runs and no TRIM kernel is launched
    k = len(corr)
    if k > 16384:
        _require_launched(device, launches, "fpfh_frontend", ["trim_bits"])
    else:
        _require_no_launch(launches, "fpfh_frontend")
    gate = _frontend_gate("synth100k", res, r_true, t_true)

    runs = [frontend_run(device, src, dst)[0] for _ in range(repeats)]
    best = min(runs, key=lambda s: s["total"])
    # one synchronised solve for its stage times
    stage_ms = {}
    solve_large_sharded(src_c, dst_c, frontend_params(), device=device, stage_ms=stage_ms)
    desc_src, desc_dst = desc
    out = dict(
        n=n, radii=list(FRONTEND_RADII), noise_bound=FRONTEND_NOISE_BOUND,
        normal_plan_mpad=plans[0][0].mpad, fpfh_plan_mpad=plans[0][1].mpad,
        correspondences=k, jax_correspondences=JAX_FRONTEND_CORRESPONDENCES,
        jax_clique_size=JAX_FRONTEND_CLIQUE, **gate,
        solve_stage_ms=stage_ms,
        identity_share=float(np.mean([i == j for i, j in corr])),
        first_run_s=first, best_run_s=best,
        best_stage_s={s: min(r[s] for r in runs) for s in best},
        total_s_all=[r["total"] for r in runs],
        peak_memory_gb=peak, launches=launches,
    )
    return out, desc_src, desc_dst


def plain_nn(queries, database, chunk: int = 256):
    """Exact nearest neighbour by direct differences, ties to the lowest
    index, in query chunks: per query the squared differences summed left to
    right over the descriptor axis (matcher.squared_distance's order), after
    the matcher's mean-centring."""
    import torch

    center = torch.mean(database, dim=0)
    q = queries - center
    db = database - center
    out = []
    for s in range(0, q.shape[0], chunk):
        d = q[s:s + chunk, None, 0] - db[None, :, 0]
        acc = d * d
        for k in range(1, q.shape[1]):
            d = q[s:s + chunk, None, k] - db[None, :, k]
            acc = acc + d * d
        out.append(torch.argmin(acc, dim=1))
    return torch.cat(out)


def _normal_bounds(pts, radius, plan):
    """Per-row float32 bound of tests/test_torch_features.py: 64 eps32
    lambda_max / (lambda_1 - lambda_0) from the float64 covariances."""
    import torch
    from teaserpp_tpu_torch.features import normals as tn

    cpu = torch.device("cpu")
    sp = tn.sorted_on_device(pts, plan, 1e12, cpu, torch.float64)
    rows = tn.query_rows(plan, cpu)
    ci = torch.as_tensor(plan.cand_idx).long()
    r2 = tn._r2_grid(radius, torch.float64, cpu)
    cov = torch.cat([tn._moments(sp[rows[s.start:s.stop]], sp[ci[s.start:s.stop]], r2)[0]
                     for s in tn.block_steps(plan)])[: plan.n][torch.as_tensor(plan.inv)]
    lam = np.linalg.eigvalsh(cov.numpy())
    return 64 * np.finfo(np.float32).eps * lam[:, 2] / np.maximum(lam[:, 1] - lam[:, 0], 1e-300)


def _spfh_counts(device, pts32, normals, plan):
    """(SPFH (n, 33), neighbour counts) of the grid route on ``device``."""
    import torch
    from teaserpp_tpu_torch.features import fpfh as tf
    from teaserpp_tpu_torch.features import normals as tn

    sp = tn.sorted_on_device(pts32, plan, 1e12, device, torch.float32)
    sn = tn.sorted_on_device(normals, plan, 0.0, device, torch.float32)
    rows = tn.query_rows(plan, device)
    ci = torch.as_tensor(plan.cand_idx, device=device).long()
    r2 = tn._r2_grid(plan.radius, torch.float32, device)
    spfh = tf._spfh_sorted(sp, sn, rows, ci, r2, tn.block_steps(plan))[: plan.n]
    return spfh[torch.as_tensor(plan.inv, device=device)].cpu().numpy()


def frontend_parity_phase(device, desc_src, desc_dst, n: int = FRONTEND_PARITY_N,
                          queries: int = FRONTEND_PARITY_QUERIES) -> dict:
    """Phase 17: (a) the matcher's NN of the first source descriptors among
    all target descriptors equals the plain exact NN on the card; (b) at
    N=8,192 with the grid route, the card's normals and (with shared
    normals) SPFH and FPFH hold to the port's CPU run within the tests'
    float32 tolerances; (c) the matcher's correspondences on the card equal
    the CPU's for the same descriptors."""
    import torch
    from teaserpp_tpu_torch.features import (
        Matcher, build_neighbor_plans, compute_fpfh_pruned, estimate_normals_pruned)
    from teaserpp_tpu_torch.features.matcher import _nn_indices

    cpu = torch.device("cpu")
    q = desc_src[:queries].to(torch.float32)
    db = desc_dst.to(torch.float32)
    t0 = time.perf_counter()
    got = _nn_indices(q, db)
    _sync(device)
    nn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = plain_nn(q, db)
    _sync(device)
    plain_s = time.perf_counter() - t0
    out = dict(nn_queries=int(q.shape[0]), nn_database=int(db.shape[0]),
               nn_equal_plain=bool(torch.equal(got, want)),
               nn_differing=int((got != want).sum()), nn_s=nn_s, plain_nn_s=plain_s)

    # (b) a cloud of the synth100k density, grid route forced
    pts, moved, _, _ = make_frontend_pair(n, seed=FRONTEND_SEED + 1, half_width=0.4)
    x = pts.astype(np.float32)
    plans = build_neighbor_plans(pts, FRONTEND_RADII)
    card = estimate_normals_pruned(x, FRONTEND_RADII[0], plans[0], device=device)
    host = estimate_normals_pruned(x, FRONTEND_RADII[0], plans[0], device=cpu)
    ref64 = estimate_normals_pruned(pts, FRONTEND_RADII[0], plans[0], device=cpu)
    bound = _normal_bounds(pts, FRONTEND_RADII[0], plans[0])
    ok = ref64.valid.numpy()
    worst = 0.0
    for res in (card, host):
        err = np.linalg.norm(res.normals.cpu().double().numpy() - ref64.normals.numpy(), axis=1)
        worst = max(worst, float((err[ok] / bound[ok]).max()))
    valid_equal = bool(np.array_equal(card.valid.cpu().numpy(), host.valid.numpy()))

    shared = host.normals
    s_card = _spfh_counts(device, x, shared.to(device), plans[1])
    s_host = _spfh_counts(cpu, x, shared, plans[1])
    nbr = np.zeros((n, n), bool)
    for s in range(0, n, 512):
        d = pts[s:s + 512, None, :] - pts[None, :, :]
        nbr[s:s + 512] = (d * d).sum(-1) <= FRONTEND_RADII[1] ** 2
    cnt = np.maximum(nbr.sum(1) - 1, 1)[:, None] / 100.0
    differ = (np.round(s_card * cnt) != np.round(s_host * cnt)).any(1)
    f_card = compute_fpfh_pruned(x, shared.to(device), FRONTEND_RADII[1], plans[1],
                                 device=device).cpu().numpy()
    f_host = compute_fpfh_pruned(x, shared, FRONTEND_RADII[1], plans[1], device=cpu).numpy()
    clean = ~(nbr & differ[None, :]).any(1)
    fpfh_err = float(np.abs(f_card - f_host)[clean].max())
    out.update(grid_n=n, valid_equal=valid_equal, normals_err_over_bound_max=worst,
               spfh_rows_differing_share=float(differ.mean()), fpfh_clean_rows=float(clean.mean()),
               fpfh_clean_max_abs_err=fpfh_err)

    # (c) the matcher on both devices, the same (CPU) descriptors
    plans_m = build_neighbor_plans(moved, FRONTEND_RADII)
    nm = estimate_normals_pruned(moved.astype(np.float32), FRONTEND_RADII[0], plans_m[0],
                                 device=cpu)
    f_moved = compute_fpfh_pruned(moved.astype(np.float32), nm.normals, FRONTEND_RADII[1],
                                  plans_m[1], device=cpu).numpy()
    c_card = Matcher(device=device).calculateCorrespondences(pts, moved, f_host, f_moved)
    c_host = Matcher(device=cpu).calculateCorrespondences(pts, moved, f_host, f_moved)
    out.update(correspondences=len(c_card), correspondences_equal=c_card == c_host)
    if not (out["nn_equal_plain"] and valid_equal and worst <= 1.0
            and out["spfh_rows_differing_share"] <= 0.05 and out["fpfh_clean_rows"] > 0.8
            and fpfh_err <= 2e-3 and out["correspondences_equal"]):
        raise AssertionError(f"front-end parity failed: {out}")
    return out


def make_patch(m: int = PATCH_M, seed: int = PATCH_SEED):
    """tests/test_features.py:371-374's wavy patch at m x m points, z + 3,
    turned 0.25 rad about a seeded axis and shifted by (0.4, -0.3, 0.25).
    Returns (src (N, 3), dst (N, 3), R, t)."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.linspace(-1, 1, m), np.linspace(-1, 1, m))
    zs = 0.3 * np.sin(2.5 * xs) * np.cos(1.5 * ys) + 0.1 * np.sin(5 * xs * ys)
    src = np.stack([xs.ravel(), ys.ravel(), zs.ravel() + 3.0], axis=1)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    r = np.eye(3) + np.sin(0.25) * kx + (1 - np.cos(0.25)) * (kx @ kx)
    t = np.array([0.4, -0.3, 0.25])
    return src, src @ r.T + t, r, t


def patch_params():
    from teaserpp_tpu_torch.params import InlierSelectionMode, RobustRegistrationSolverParams

    return RobustRegistrationSolverParams(noise_bound=PATCH_NOISE_BOUND, estimate_scaling=False,
                                          inlier_selection_mode=InlierSelectionMode.PMC_EXACT)


def _teaser_gate(name, rotation, translation, r_true, t_true) -> dict:
    rot = np.asarray(rotation, np.float64)
    ang = float(np.arccos(np.clip((np.trace(rot.T @ r_true) - 1) / 2, -1, 1)))
    out = dict(rot_err_rad=ang, trans_err=float(np.linalg.norm(np.asarray(translation) - t_true)))
    if not (np.isfinite(rot).all() and ang < 0.05 and out["trans_err"] < 0.05):
        raise AssertionError(f"{name}: TEASER gate failed: {out}")
    return out


def facade_icp_phase(device, repeats: int = 2) -> dict:
    """Phase 18: FPFHEstimation (auto: dense at 4,096 points), the matcher,
    RobustRegistrationSolver (PMC_EXACT) and ICP from its result
    (examples/fpfh_icp_registration.py's flow on the wavy patch); no TRIM
    kernel on this route."""
    from teaserpp_tpu_torch import RobustRegistrationSolver
    from teaserpp_tpu_torch.features import FPFHEstimation, Matcher
    from teaserpp_tpu_torch.ops import cuda_kernels as ck
    from teaserpp_tpu_torch.solvers.icp import icp_point_to_point
    from teaserpp_tpu_torch.utils.geometry import PointCloud
    from teaserpp_tpu_torch.utils.metrics import rotation_error_deg

    src, dst, r_true, t_true = make_patch()

    def run():
        stages = {}
        t0 = time.perf_counter()
        fp = FPFHEstimation(device=device)
        sf = fp.computeFPFHFeatures(src, *PATCH_RADII)
        df = fp.computeFPFHFeatures(dst, *PATCH_RADII)
        t1 = time.perf_counter()
        corr = Matcher(device=device).calculateCorrespondences(src, dst, sf, df, False, True,
                                                               False, 0.95)
        t2 = time.perf_counter()
        solver = RobustRegistrationSolver(patch_params(), device=device)
        sol = solver.solve(PointCloud(src), PointCloud(dst), corr)
        t3 = time.perf_counter()
        icp = icp_point_to_point(src.T.astype(np.float32), dst.T.astype(np.float32),
                                 PATCH_NOISE_BOUND, r_init=sol.rotation, t_init=sol.translation,
                                 max_iterations=100, device=device)
        _sync(device)
        t4 = time.perf_counter()
        stages.update(fpfh=t1 - t0, matcher=t2 - t1, teaser=t3 - t2, icp=t4 - t3, total=t4 - t0)
        return stages, corr, sol, solver, icp

    ck.reset_launches()
    first, corr, sol, solver, icp = run()
    launches = dict(ck.LAUNCHES)
    _require_no_launch(launches, "the FPFH facade, TEASER and ICP")
    r_icp = icp.rotation.cpu().double().numpy()
    out = dict(
        n=len(src), radii=list(PATCH_RADII), correspondences=len(corr),
        identity_share=float(np.mean([i == j for i, j in corr])),
        clique_size=len(solver.getInlierMaxClique()), valid=bool(sol.valid),
        teaser=_teaser_gate("facade", sol.rotation, sol.translation, r_true, t_true),
        icp_rot_err_deg=rotation_error_deg(r_icp, r_true),
        icp_trans_err=float(np.linalg.norm(icp.translation.cpu().double().numpy() - t_true)),
        icp_iterations=int(icp.iterations), first_run_s=first,
        runs_s=[run()[0] for _ in range(repeats)], launches=launches,
    )
    if not (out["valid"] and out["identity_share"] > 0.8 and out["icp_rot_err_deg"] < 0.01):
        raise AssertionError(f"FPFH facade + ICP gate failed: {out}")
    return out


def cli_phase(device, demo: dict) -> dict:
    """Phase 19: ``python -m teaserpp_tpu_torch.cli`` as a subprocess on the
    card, with --fpfh on phase 18's clouds (phase 18's TEASER gate) and
    without on phase 10's problem (phase 10's clique); then the same --fpfh
    call in this process, with the launch counts set to 0 before it."""
    import contextlib
    import io
    import pathlib
    import tempfile

    from teaserpp_tpu_torch import cli
    from teaserpp_tpu_torch.io import write_ply
    from teaserpp_tpu_torch.ops import cuda_kernels as ck
    from teaserpp_tpu_torch.utils.geometry import PointCloud
    from teaserpp_tpu_torch.utils.metrics import rotation_error_deg, translation_error

    root = pathlib.Path(__file__).resolve().parent
    src, dst, r_true, t_true = make_patch()
    b_src, b_dst = make_problems(1, N_POINTS)

    def run(argv):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "teaserpp_tpu_torch.cli", *argv],
                              cwd=root, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"cli failed ({proc.returncode}): {proc.stderr[-3000:]}")
        return json.loads(proc.stdout.strip().splitlines()[-1]), time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, cloud in (("src", src), ("dst", dst), ("bsrc", b_src[0].T), ("bdst", b_dst[0].T)):
            paths[name] = str(pathlib.Path(tmp) / f"{name}.ply")
            write_ply(paths[name], PointCloud(cloud))
        fpfh_argv = ["--src", paths["src"], "--dst", paths["dst"], "--fpfh",
                     "--normal-search-radius", str(PATCH_RADII[0]),
                     "--fpfh-search-radius", str(PATCH_RADII[1]),
                     "--noise-bound", str(PATCH_NOISE_BOUND)]
        fpfh, fpfh_s = run(fpfh_argv)
        plain, plain_s = run(["--src", paths["bsrc"], "--dst", paths["bdst"],
                              "--noise-bound", str(NOISE_BOUND),
                              "--rotation-cost-threshold", "0.005"])
        ck.reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(fpfh_argv + ["--device", device.type])
        launches = dict(ck.LAUNCHES)
    _require_no_launch(launches, "the CLI")
    in_process = json.loads(buf.getvalue().strip().splitlines()[-1])
    out = dict(
        fpfh=dict(_teaser_gate("cli --fpfh", fpfh["rotation"], fpfh["translation"], r_true,
                               t_true), max_clique_size=fpfh["max_clique_size"],
                  time_taken=fpfh["time_taken"], process_s=fpfh_s),
        in_process=dict(rc=rc, **_teaser_gate("cli.main --fpfh", in_process["rotation"],
                                              in_process["translation"], r_true, t_true),
                        time_taken=in_process["time_taken"]),
        plain=dict(max_clique_size=plain["max_clique_size"],
                   facade_demo_clique_size=demo["clique_size"],
                   rot_err_deg=rotation_error_deg(np.asarray(plain["rotation"]), T[:3, :3]),
                   trans_err_m=translation_error(np.asarray(plain["translation"]), T[:3, 3]),
                   time_taken=plain["time_taken"], process_s=plain_s),
        launches=launches,
    )
    if not (fpfh["valid"] and plain["valid"] and rc == 0
            and plain["max_clique_size"] == demo["clique_size"]
            and out["plain"]["rot_err_deg"] < 0.1 and out["plain"]["trans_err_m"] < 0.01):
        raise AssertionError(f"CLI gate failed: {out}")
    return out


# The certifier phases (20-23): scripts/bench_frontend_e2e.py::certify_saved's
# flow on the front end's two rotation-stage problems, scripts/bench_certify.py's
# batch, the reference's large random instances, CPU parity and resume
CERT_FIXTURES = (("synth100k", 0), ("scene60k", 10))  # and their subset outliers
CERT_TIMS = 150
CERT_JAX_ITERATIONS = {"synth100k": 75, "scene60k": 2331}  # the JAX package's, on the CPU
CERT_SEGMENT = 25
CERT_PROFILE_ITERATIONS = 25
CERT_BATCH = 32
CERT_BATCH_N = 100
CERT_BATCH_NOISE_BOUND = 0.01
CERT_BATCH_ITERATIONS = 100
CERT_TRAJ_RTOL = 1e-6  # tests/test_torch_certification.py's DENSE tolerance
CERT_TRAJ_ATOL = 1e-8
CERT_SCALE_N = 1000  # npm 4004
CERT_SCALE_SMALL_N = 499  # npm 2000
CERT_PARITY_N = 40
CERT_PARITY_NOISE_BOUND = 0.03


def _cert_gnc(device, v1, v2, nb):
    """The port's float64 GNC-TLS on one problem -> (R, inliers, iterations) on the host."""
    import torch
    from teaserpp_tpu_torch.solvers.rotation import solve_rotation_gnc_tls

    a, b = (torch.as_tensor(x, dtype=torch.float64, device=device)[None] for x in (v1, v2))
    res = solve_rotation_gnc_tls(a, b, nb)
    return (res.rotation[0].cpu().numpy(), res.inliers[0].cpu().numpy(),
            int(res.iterations.reshape(-1)[0]))


def cert_subset(device, name: str) -> dict:
    """certify_saved's problem: GNC over the saved chain, every TLS outlier
    and evenly spaced inliers up to 150 TIMs, GNC again on the subset."""
    import pathlib

    path = pathlib.Path(__file__).resolve().parent / f".e2e_cert_{name}.npz"
    with np.load(path) as z:
        v1f, v2f, nb = z["v1"], z["v2"], float(z["nb_rot"])
    _, th_full, chain_iters = _cert_gnc(device, v1f, v2f, nb)
    out_idx, in_idx = np.nonzero(~th_full)[0], np.nonzero(th_full)[0]
    keep_out = out_idx[: CERT_TIMS // 2]
    n_in = min(CERT_TIMS - len(keep_out), len(in_idx))
    keep_in = in_idx[np.linspace(0, len(in_idx) - 1, n_in).astype(int)]
    sel = np.sort(np.concatenate([keep_in, keep_out]))
    r, inl, sub_iters = _cert_gnc(device, v1f[:, sel], v2f[:, sel], nb)
    return dict(v1=v1f[:, sel], v2=v2f[:, sel], rotation=r, theta=np.where(inl, 1.0, -1.0),
                noise_bound=nb, chain_tims=v1f.shape[1], chain_outliers=len(out_idx),
                gnc_iterations_chain=chain_iters, gnc_iterations_subset=sub_iters)


def cert_e2e_params(nb: float):
    from teaserpp_tpu_torch.params import DRSCertifierParams, EigSolverType

    return DRSCertifierParams(noise_bound=nb, eig_decomposition_solver=EigSolverType.ITERATIVE,
                              iterations_per_dispatch=CERT_SEGMENT, psd_projection_rank=128,
                              max_iterations=200)


def certify_e2e_phase(device) -> tuple:
    """Phase 20: certify_saved's flow on both in-repo rotation-stage problems,
    float64 on the card, the checkpoint in a temporary directory. Gate: both
    certified, synth100k with gap 0, scene60k with gap < 1e-3."""
    import pathlib
    import tempfile

    import torch
    from teaserpp_tpu_torch.certification.drs import certify_checkpointed
    from teaserpp_tpu_torch.ops import cuda_kernels as ck

    ck.reset_launches()
    out, subsets = {}, {}
    for name, subset_outliers in CERT_FIXTURES:
        sub = subsets[name] = cert_subset(device, name)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            res = certify_checkpointed(
                sub["rotation"], sub["v1"], sub["v2"], sub["theta"],
                cert_e2e_params(sub["noise_bound"]),
                checkpoint_path=str(pathlib.Path(tmp) / "ck.npz"), checkpoint_every=2,
                rounds=20, device=device)
            _sync(device)
            seconds = time.perf_counter() - t0
        iters = len(res.suboptimality_traj)
        out[name] = dict(
            chain_tims=sub["chain_tims"], chain_outliers=sub["chain_outliers"],
            subset_tims=CERT_TIMS, subset_outliers=int((sub["theta"] < 0).sum()),
            gnc_iterations_chain=sub["gnc_iterations_chain"],
            gnc_iterations_subset=sub["gnc_iterations_subset"],
            is_optimal=res.is_optimal, gap=res.best_suboptimality, iterations=iters,
            jax_iterations=CERT_JAX_ITERATIONS[name], seconds=seconds,
            ms_per_iteration=seconds * 1e3 / max(iters, 1), rank_saturated=res.rank_saturated,
            peak_memory_gb=(torch.cuda.max_memory_allocated() / 1e9
                            if device.type == "cuda" else None))
        gap_ok = res.best_suboptimality == 0.0 if name == "synth100k" else \
            res.best_suboptimality < 1e-3
        if not (res.is_optimal and gap_ok and out[name]["subset_outliers"] == subset_outliers):
            raise AssertionError(f"certify_e2e gate failed on {name}: {out[name]}")
    out["launches"] = dict(ck.LAUNCHES)
    _require_no_launch(out["launches"], "certify_e2e")
    return out, subsets


def certify_profile_phase(device, sub: dict) -> dict:
    """Phase 20's profile: one 25-iteration ITERATIVE segment of scene60k
    (iterations 25-50, after a warm first segment) under ``torch.profiler``:
    wall and device time, idle share, launches and host syncs per iteration,
    the top kernels, and the device time by operation."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from teaserpp_tpu_torch.certification import drs

    params = cert_e2e_params(sub["noise_bound"])
    args = [torch.as_tensor(sub[k], dtype=torch.float64, device=device)[None]
            for k in ("rotation", "v1", "v2", "theta")]
    state, consts = drs._iterative_init_batch(*args, params)
    state = drs._iterative_segment_batch(state, consts, params, CERT_SEGMENT)
    it0 = int(state[0][0])
    end = it0 + CERT_PROFILE_ITERATIONS
    drs._iterative_segment_batch(state, consts, params, end)  # warm
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        after = drs._iterative_segment_batch(state, consts, params, end)
        _sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    iters = int(after[0][0]) - it0
    averages = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(e, "device_time_total", 0)

    kernels = [e for e in averages if e.device_type == DeviceType.CUDA
               and not e.key.startswith("drs.")]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    host = {e.key: e for e in averages if e.device_type == DeviceType.CPU}

    def count(*names):
        return sum(host[n].count for n in names if n in host)

    # device time of the kernels each operation launched (its children's included)
    ops = {"cholesky": ["aten::linalg_cholesky_ex"], "cholesky_solve": ["aten::cholesky_solve"],
           "qr": ["aten::linalg_qr"], "eigh": ["aten::_linalg_eigh"],
           "dual_projection": ["drs.dual_projection"],
           "matmul": ["aten::mm", "aten::bmm"]}
    by_op = {k: sum(getattr(host[n], "device_time_total", 0) for n in names if n in host) / 1e3
             for k, names in ops.items()}
    kernels.sort(key=dev_us, reverse=True)
    out = dict(iterations=iters, start_iteration=it0, wall_ms=wall_ms,
               ms_per_iteration=wall_ms / max(iters, 1), device_busy_ms=busy_ms,
               idle_share=(1.0 - busy_ms / wall_ms) if busy_ms > 0 else "not measured",
               launches_per_iteration=sum(e.count for e in kernels) / max(iters, 1),
               host_syncs_per_iteration=count("cudaStreamSynchronize",
                                              "cudaDeviceSynchronize") / max(iters, 1),
               memcpy_per_iteration=count("cudaMemcpyAsync") / max(iters, 1),
               device_ms_by_op=by_op,
               top_kernels=[dict(name=e.key[:90], launches=int(e.count), ms=dev_us(e) / 1e3)
                            for e in kernels[:10]])
    return out


def cert_batch_problems(b: int, n: int, seed: int = 0):
    """scripts/bench_certify.py's problems: known rotations, uniform noise
    within the bound, 20% outliers with their theta -1."""
    nb = CERT_BATCH_NOISE_BOUND
    rng = np.random.default_rng(seed)
    rots, srcs, dsts, thetas = [], [], [], []
    for _ in range(b):
        q, r_ = np.linalg.qr(rng.normal(size=(3, 3)))
        q *= np.sign(np.diag(r_))
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        src = rng.uniform(-1, 1, size=(3, n))
        dst = q @ src + rng.uniform(-nb / 2, nb / 2, size=(3, n))
        theta = np.ones(n)
        out = rng.choice(n, size=n // 5, replace=False)
        dst[:, out] = rng.uniform(-2, 2, size=(3, n // 5))
        theta[out] = -1
        rots.append(q)
        srcs.append(src)
        dsts.append(dst)
        thetas.append(theta)
    return tuple(np.stack(x) for x in (rots, srcs, dsts, thetas))


def _cert_same_run(got, want) -> bool:
    return (got.is_optimal == want.is_optimal
            and len(got.suboptimality_traj) == len(want.suboptimality_traj)
            and np.allclose(got.suboptimality_traj, want.suboptimality_traj,
                            rtol=CERT_TRAJ_RTOL, atol=CERT_TRAJ_ATOL))


def certify_batch_phase(device, repeats: int = 3) -> dict:
    """Phase 21: scripts/bench_certify.py's defaults (B=32, N=100, DENSE, 100
    iterations): certs/s, best of ``repeats`` after a first run. Gate: lane
    by lane equal to ``DRSCertifier.certify`` of the problem alone (verdict,
    iteration count, trajectory within the tests' tolerance)."""
    from teaserpp_tpu_torch.certification.drs import DRSCertifier, certify_batch
    from teaserpp_tpu_torch.ops import cuda_kernels as ck
    from teaserpp_tpu_torch.params import DRSCertifierParams

    probs = cert_batch_problems(CERT_BATCH, CERT_BATCH_N)
    params = DRSCertifierParams(noise_bound=CERT_BATCH_NOISE_BOUND,
                                max_iterations=CERT_BATCH_ITERATIONS)
    ck.reset_launches()
    t0 = time.perf_counter()
    res = certify_batch(*probs, params, device=device)
    first_s = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    _require_no_launch(launches, "certify_batch")
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        certify_batch(*probs, params, device=device)
        runs.append(time.perf_counter() - t0)
    single = DRSCertifier(params, device=device)
    t0 = time.perf_counter()
    differ = [b for b in range(CERT_BATCH)
              if not _cert_same_run(res[b], single.certify(*(p[b] for p in probs)))]
    singles_s = time.perf_counter() - t0
    out = dict(batch=CERT_BATCH, n=CERT_BATCH_N, npm=4 * CERT_BATCH_N + 4,
               max_iterations=CERT_BATCH_ITERATIONS, first_s=first_s, runs_s=runs,
               certs_per_s=CERT_BATCH / min(runs),
               certified=sum(r.is_optimal for r in res),
               iterations=sorted({len(r.suboptimality_traj) for r in res}),
               median_gap=float(np.median([r.best_suboptimality for r in res])),
               singles_s=singles_s, lanes_differing=differ, launches=launches)
    if differ:
        raise AssertionError(f"certify_batch lanes differ from their single runs: {out}")
    return out


def cert_reference_instance(rng, n: int, outlier_ratio: float = 0.1):
    """tests/test_certification_scale.py::reference_style_instance
    (certification-test.cc:544-562): noise-free inliers, trailing outliers."""
    v1 = rng.uniform(-1, 1, (3, n))
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    v2 = q @ v1
    k = int(n * (1 - outlier_ratio))
    theta = np.ones(n)
    theta[k:] = -1
    v2[:, k:] = rng.uniform(-1, 1, (3, n - k)) * 5 + 5
    return q, v1, v2, theta


def certify_scale_phase(device) -> dict:
    """Phase 22: the reference's large random instances: ITERATIVE at N=1000
    (rank 128), and at N=499 ITERATIVE (rank 96, at most 5 iterations) then
    DENSE. Gate, the reference's: certified with gap <= 1e-5, not saturated."""
    from teaserpp_tpu_torch.certification.drs import DRSCertifier
    from teaserpp_tpu_torch.ops import cuda_kernels as ck
    from teaserpp_tpu_torch.params import DRSCertifierParams, EigSolverType

    ck.reset_launches()
    out = {}
    runs = ((f"iterative_npm{4 * CERT_SCALE_N + 4}", CERT_SCALE_N, EigSolverType.ITERATIVE, 128),
            (f"iterative_npm{4 * CERT_SCALE_SMALL_N + 4}", CERT_SCALE_SMALL_N,
             EigSolverType.ITERATIVE, 96),
            (f"dense_npm{4 * CERT_SCALE_SMALL_N + 4}", CERT_SCALE_SMALL_N, EigSolverType.DENSE, 0))
    for name, n, solver, rank in runs:
        prob = cert_reference_instance(np.random.default_rng(12345), n)
        params = DRSCertifierParams(noise_bound=0.01, eig_decomposition_solver=solver,
                                    psd_projection_rank=rank)
        t0 = time.perf_counter()
        res = DRSCertifier(params, device=device).certify(*prob)
        _sync(device)
        out[name] = dict(seconds=time.perf_counter() - t0, is_optimal=res.is_optimal,
                         gap=res.best_suboptimality, iterations=len(res.suboptimality_traj),
                         rank_saturated=res.rank_saturated)
        if not (res.is_optimal and res.best_suboptimality <= 1e-5 and not res.rank_saturated
                and (n != CERT_SCALE_SMALL_N or len(res.suboptimality_traj) <= 5)):
            raise AssertionError(f"certify_scale gate failed: {name} {out[name]}")
    out["launches"] = dict(ck.LAUNCHES)
    _require_no_launch(out["launches"], "certify_scale")
    return out


def cert_parity_problem(n: int = CERT_PARITY_N, seed: int = 40):
    """A noisy problem (sd nb/4, a quarter outliers) solved by the port's
    float64 GNC-TLS on the CPU -> (R, v1, v2, theta)."""
    import torch

    nb = CERT_PARITY_NOISE_BOUND
    rng = np.random.default_rng(seed)
    v1 = rng.standard_normal((3, n))
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    v2 = q @ v1 + rng.standard_normal((3, n)) * (nb / 4)
    idx = rng.choice(n, n // 4, replace=False)
    v2[:, idx] = rng.standard_normal((3, n // 4)) * 2
    r, inl, _ = _cert_gnc(torch.device("cpu"), v1, v2, nb)
    return r, v1, v2, np.where(inl, 1.0, -1.0)


def certify_parity_phase(device) -> dict:
    """Phase 23: the card against the CPU at N=40 and, on the card,
    ``certify_checkpointed`` stopped after 2 segments and resumed:
    bit-identical to the uninterrupted run (a hash of the trajectory and the
    best gap).

    DENSE: equal verdict and iteration count, trajectories within the tests'
    tolerance. ITERATIVE: the seed blocks are equal, but the initial Lanczos
    estimate (no reorthogonalization, as in JAX) moves by a few percent
    under a 1e-15 change of its input, and the shift it sets carries that
    through the run; so the whole runs are held to an equal verdict and
    iteration count, and the loop itself to the tests' tolerance from one
    state: the CPU's init carried to the card, the same segment on both."""
    import pathlib
    import tempfile

    import torch
    from teaserpp_tpu_torch.certification import drs
    from teaserpp_tpu_torch.certification.drs import DRSCertifier, certify_checkpointed
    from teaserpp_tpu_torch.convert import drs_state_from_numpy, drs_state_to_numpy
    from teaserpp_tpu_torch.ops import cuda_kernels as ck
    from teaserpp_tpu_torch.params import DRSCertifierParams, EigSolverType

    prob = cert_parity_problem()
    ck.reset_launches()
    out = {}
    for solver in (EigSolverType.DENSE, EigSolverType.ITERATIVE):
        params = DRSCertifierParams(noise_bound=CERT_PARITY_NOISE_BOUND,
                                    eig_decomposition_solver=solver)
        card = DRSCertifier(params, device=device).certify(*prob)
        cpu = DRSCertifier(params, device="cpu").certify(*prob)
        same_length = len(card.suboptimality_traj) == len(cpu.suboptimality_traj)
        out[solver.name.lower()] = dict(
            is_optimal=[card.is_optimal, cpu.is_optimal],
            iterations=[len(card.suboptimality_traj), len(cpu.suboptimality_traj)],
            gap=[card.best_suboptimality, cpu.best_suboptimality],
            max_traj_diff=float(np.abs(np.subtract(card.suboptimality_traj,
                                                   cpu.suboptimality_traj)).max())
            if same_length else None)
        ok = (_cert_same_run(card, cpu) if solver == EigSolverType.DENSE
              else card.is_optimal == cpu.is_optimal and same_length)
        if not ok:
            raise AssertionError(f"certify_parity: card and CPU differ: {out}")
    # ITERATIVE from one state: the CPU's init, carried to the card
    cpu_args = [torch.as_tensor(a, dtype=torch.float64)[None] for a in prob]
    state, consts = drs._iterative_init_batch(*cpu_args, params)
    # how far the initial Lanczos estimate moves under a 1e-15 change of v1
    nudged = list(cpu_args)
    nudged[1] = nudged[1] * (1 + 1e-15)
    lam0 = float(state[6][0])
    out["lanczos_rel_change_at_1e-15"] = abs(
        float(drs._iterative_init_batch(*nudged, params)[0][6][0]) - lam0) / abs(lam0)
    s_card, c_card = drs_state_from_numpy(
        *drs_state_to_numpy(drs._lane(state), drs._lane(consts)), device, torch.float64)
    card_end = drs._iterative_segment_batch(drs._batched(s_card), drs._batched(c_card), params,
                                            params.max_iterations)
    cpu_end = drs._iterative_segment_batch(state, consts, params, params.max_iterations)
    it_card, it_cpu = int(card_end[0][0]), int(cpu_end[0][0])
    traj_card, traj_cpu = card_end[3][0, :it_card].cpu().numpy(), cpu_end[3][0, :it_cpu].numpy()
    out["iterative_shared_state"] = dict(
        iterations=[it_card, it_cpu],
        max_traj_diff=float(np.abs(traj_card - traj_cpu).max()) if it_card == it_cpu else None)
    if not (it_card == it_cpu and np.allclose(traj_card, traj_cpu, rtol=CERT_TRAJ_RTOL,
                                              atol=CERT_TRAJ_ATOL)):
        raise AssertionError(f"certify_parity: card and CPU differ from one state: {out}")
    params = DRSCertifierParams(noise_bound=CERT_PARITY_NOISE_BOUND,
                                eig_decomposition_solver=EigSolverType.ITERATIVE,
                                iterations_per_dispatch=7)

    def digest(res):
        return _hash(np.asarray(res.suboptimality_traj, np.float64),
                     np.asarray(res.best_suboptimality, np.float64))

    whole = certify_checkpointed(*prob, params, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(pathlib.Path(tmp) / "ck.npz")
        stopped = certify_checkpointed(*prob, params, checkpoint_path=ckpt, checkpoint_every=1,
                                       _stop_after_segments=2, device=device)
        resumed = certify_checkpointed(*prob, params, checkpoint_path=ckpt, checkpoint_every=1,
                                       device=device)
    out["resume"] = dict(stopped=stopped is None, whole=digest(whole), resumed=digest(resumed),
                         iterations=len(whole.suboptimality_traj))
    if not (stopped is None and digest(whole) == digest(resumed)
            and len(whole.suboptimality_traj) > 2 * 7):
        raise AssertionError(f"certify_parity: resume is not bit-identical: {out}")
    out["launches"] = dict(ck.LAUNCHES)
    _require_no_launch(out["launches"], "certify_parity")
    return out


MESH_FLAG = "--mesh-rank"  # what a rank of the mesh phase's world runs
MESH_WORLD = 2
MESH_TIMEOUT_S = 300.0  # the ranks' collectives give up after this
MESH_WAIT_S = 600.0  # the parent kills a world that runs longer
MESH_REPEATS = 2


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _fields(prefix: str, result) -> dict:
    """A result (LargeSolveResult, PipelineSolution, tensors, arrays) as
    {name: numpy array}, for an exact comparison across processes."""
    import torch

    if isinstance(result, tuple) and hasattr(result, "_fields"):
        out = {}
        for k in result._fields:
            out.update(_fields(f"{prefix}.{k}", getattr(result, k)))
        return out
    if isinstance(result, torch.Tensor):
        result = result.detach().cpu().numpy()
    return {prefix: np.asarray(result)}


def mesh_frontend(device, src, dst, blocks=None, pairs=None):
    """Mesh case (b): ``FPFHEstimation(neighbor_mode="grid")`` on both clouds
    with its query blocks over ``blocks``, the matcher with cross-check, and
    ``solve_large_sharded`` over ``pairs`` (``None``: one device). Returns
    (correspondences (K, 2), source and target descriptors, result)."""
    from teaserpp_tpu_torch import solve_large_sharded
    from teaserpp_tpu_torch.features import FPFHEstimation, Matcher

    est = FPFHEstimation(neighbor_mode="grid", mesh=blocks, device=device)
    ds = est.computeFPFHFeatures(src, *FRONTEND_RADII)
    dd = est.computeFPFHFeatures(dst, *FRONTEND_RADII)
    corr = np.asarray(Matcher(device=device).calculateCorrespondences(
        src, dst, ds, dd, False, True, False, 0.95), np.int64).reshape(-1, 2)
    src_c = np.ascontiguousarray(src[corr[:, 0]].T).astype(np.float32)
    dst_c = np.ascontiguousarray(dst[corr[:, 1]].T).astype(np.float32)
    return corr, ds, dd, solve_large_sharded(src_c, dst_c, frontend_params(), mesh=pairs,
                                             device=device)


def mesh_child(rank: int, address: str, out_dir: str, device_name: str) -> int:
    """One rank of the mesh phase's world: cases (a)-(c) on ``device_name``
    (``cuda:0``, shared with the other rank), over gloo. Writes its results
    to ``<out_dir>/rank<r>.npz`` and its numbers to ``rank<r>.json``."""
    import pathlib

    import torch
    import torch.distributed as dist
    from teaserpp_tpu_torch import solve_large_exact, solve_large_sharded
    from teaserpp_tpu_torch.ops import cuda_kernels as ck
    from teaserpp_tpu_torch.parallel import multihost as mh
    from teaserpp_tpu_torch.parallel import solve_batch_sharded

    device = torch.device(device_name)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mh.initialize_distributed(address, MESH_WORLD, rank, backend="gloo",
                              timeout_s=MESH_TIMEOUT_S)
    pairs = mh.make_mesh(pairs_per_host=MESH_WORLD)  # (1, 2): the pair rows over both
    batch = mh.make_mesh(pairs_per_host=1)  # (2, 1): the batch over both
    blocks = mh.Mesh(np.arange(MESH_WORLD), ("blocks",))  # the front end's query blocks
    fields, stats = {}, dict(rank=rank, backend=dist.get_backend(), device=str(device),
                             pairs_mesh=pairs.shape, batch_mesh=batch.shape)

    def run(name, fn, repeats=0):
        dist.barrier()
        ck.reset_launches()
        mh.reset_staged_bytes()
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        stats[name] = dict(first_s=time.perf_counter() - t0, launches=dict(ck.LAUNCHES),
                           staged_bytes=dict(mh.STAGED_BYTES))
        times = []
        for _ in range(repeats):
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            _sync(device)
            times.append(time.perf_counter() - t0)
        if times:
            stats[name]["seconds_all"] = times
        return out

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    src, dst, *_ = make_large_problem(LARGE_N)
    src_d, dst_d = _to(device, src, dst)
    fields.update(_fields("large", run("large", lambda: solve_large_sharded(
        src_d, dst_d, large_params(), mesh=pairs, device=device), MESH_REPEATS)))
    fields.update(_fields("exact", run("exact", lambda: solve_large_exact(
        src_d, dst_d, large_params(), mesh=pairs, time_limit=EXACT_TIME_LIMIT_S,
        device=device))))
    del src_d, dst_d
    fe_src, fe_dst, *_ = make_frontend_pair(FRONTEND_N)
    corr, ds, dd, fe = run("frontend", lambda: mesh_frontend(device, fe_src, fe_dst, blocks,
                                                             pairs), 1)
    fields.update(_fields("frontend", fe))
    fields.update({"frontend.corr": corr, "frontend.desc_src": ds, "frontend.desc_dst": dd})
    b_src, b_dst = make_problems(BATCH, N_POINTS)
    fields.update(_fields("batch", run("batch", lambda: solve_batch_sharded(
        b_src, b_dst, bench_params(), batch, device=device), MESH_REPEATS)))
    stats["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None
    out = pathlib.Path(out_dir)
    np.savez(out / f"rank{rank}.npz", **fields)
    (out / f"rank{rank}.json").write_text(json.dumps(stats))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _differing(got: dict, want: dict, keys) -> list:
    """The keys whose arrays differ in dtype, shape or any bit."""
    return [k for k in keys if got[k].dtype != want[k].dtype or got[k].shape != want[k].shape
            or got[k].tobytes() != want[k].tobytes()]


def mesh_references(device, batch_sol) -> dict:
    """The mesh phase's ``mesh=None`` runs on this card, timed: (a) and (b)
    as the ranks run them, and ``solve_batch`` of each half of the batch.
    ``batch_sol`` is phase 4's solve of the whole batch (numpy)."""
    import torch
    from teaserpp_tpu_torch import solve_batch, solve_large_exact, solve_large_sharded

    def timed(fn, repeats):
        times, out = [], None
        for _ in range(1 + repeats):
            _sync(device)
            t0 = time.perf_counter()
            out = fn()
            _sync(device)
            times.append(time.perf_counter() - t0)
        return out, times

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    src, dst, r_true, t_true, inlier = make_large_problem(LARGE_N)
    src_d, dst_d = _to(device, src, dst)
    large, large_s = timed(lambda: solve_large_sharded(src_d, dst_d, large_params(),
                                                       device=device), MESH_REPEATS)
    exact, exact_s = timed(lambda: solve_large_exact(
        src_d, dst_d, large_params(), time_limit=EXACT_TIME_LIMIT_S, device=device), 0)
    fe_src, fe_dst, fe_r, fe_t = make_frontend_pair(FRONTEND_N)
    (corr, ds, dd, fe), fe_s = timed(lambda: mesh_frontend(device, fe_src, fe_dst), 1)
    b_src, b_dst = make_problems(BATCH, N_POINTS)
    half = BATCH // MESH_WORLD
    halves = [_fields("batch", solve_batch(b_src[i * half:(i + 1) * half],
                                           b_dst[i * half:(i + 1) * half], bench_params(),
                                           device=device)) for i in range(MESH_WORLD)]
    fields = {**_fields("large", large), **_fields("exact", exact), **_fields("frontend", fe),
              "frontend.corr": corr, "frontend.desc_src": ds, "frontend.desc_dst": dd}
    return dict(fields=fields, halves=halves, batch_sol=batch_sol, large_s=large_s,
                exact_s=exact_s, frontend_s=fe_s, truth=(r_true, t_true, inlier, fe_r, fe_t),
                peak_memory_gb=torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None)


def mesh_phase(device, refs: dict) -> dict:
    """Two ranks sharing this card, gloo named, each running cases (a)-(c)
    (``mesh_child``); every rank's results equal the ``mesh=None`` runs of
    ``refs`` bit for bit ((c): each rank's half equals ``solve_batch`` of
    that half, the whole batch phase 4's within the parity tolerance) and
    pass the gates of phases 6 and 16. The K1 slab must launch on (a) and no
    kernel on (b)."""
    import tempfile

    import torch

    if device.type == "cuda":
        torch.cuda.empty_cache()  # the ranks share this card
    with tempfile.TemporaryDirectory() as tmp:
        address = f"127.0.0.1:{_free_port()}"
        card = "cuda:0" if device.type == "cuda" else "cpu"
        procs = [subprocess.Popen([sys.executable, __file__, MESH_FLAG, str(r), address, tmp,
                                   card],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(MESH_WORLD)]
        logs = []
        try:
            for proc in procs:
                logs.append(proc.communicate(timeout=MESH_WAIT_S))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        for r, (proc, (_, err)) in enumerate(zip(procs, logs)):
            if proc.returncode != 0:
                raise AssertionError(f"mesh rank {r} failed (rc {proc.returncode}): {err[-3000:]}")
        ranks = []
        for r in range(MESH_WORLD):
            with np.load(f"{tmp}/rank{r}.npz") as z:
                ranks.append(({k: z[k] for k in z.files},
                              json.loads(open(f"{tmp}/rank{r}.json").read())))

    want = refs["fields"]
    r_true, t_true, inlier, fe_r, fe_t = refs["truth"]
    half = BATCH // MESH_WORLD
    out = dict(world=MESH_WORLD, note="two ranks share one card: no scaling numbers",
               ranks=[])
    for r, (got, stats) in enumerate(ranks):
        keys = [k for k in want if not k.startswith("batch")]
        differ = _differing(got, want, keys)
        batch_keys = [k for k in got if k.startswith("batch")]
        own = refs["halves"][r]
        differ += [f"{k}[half {r}]" for k in batch_keys
                   if got[k][r * half:(r + 1) * half].tobytes() != own[k].tobytes()]
        differ += [f"{k}[half {1 - r}]" for k in batch_keys
                   if got[k][(1 - r) * half:(2 - r) * half].tobytes()
                   != refs["halves"][1 - r][k].tobytes()]
        whole = refs["batch_sol"]
        rot = float(np.linalg.norm(got["batch.rotation"] - whole.rotation, axis=(1, 2)).max())
        trans = float(np.linalg.norm(got["batch.translation"] - whole.translation, axis=1).max())
        masks = bool(np.array_equal(got["batch.clique_mask"], whole.clique_mask))
        if differ or not masks or rot > PARITY_TOL or trans > PARITY_TOL:
            raise AssertionError(
                f"mesh rank {r} differs from mesh=None: {differ[:12]}, whole-batch masks "
                f"{masks}, rotation {rot}, translation {trans}")
        launches = {k: stats[k]["launches"] for k in ("large", "exact", "frontend", "batch")}
        for path, kernels in (("large", ["trim_bits_slab"]), ("exact", ["trim_bits_slab"]),
                              ("batch", ["trim_bits"])):
            _require_launched(device, launches[path], f"mesh {path} (rank {r})", kernels)
        _require_no_launch(launches["frontend"], f"mesh frontend (rank {r})")
        out["ranks"].append(dict(
            rank=r, backend=stats["backend"], device=stats["device"],
            pairs_mesh=stats["pairs_mesh"], batch_mesh=stats["batch_mesh"],
            equal_to_mesh_none=True, batch_whole_rotation_max=rot,
            batch_whole_translation_max=trans, peak_memory_gb=stats["peak_memory_gb"],
            **{f"{k}_first_s": stats[k]["first_s"] for k in ("large", "exact", "frontend", "batch")},
            large_s=stats["large"]["seconds_all"], frontend_s=stats["frontend"]["seconds_all"],
            batch_s=stats["batch"]["seconds_all"], launches=launches,
            staged_bytes={k: stats[k]["staged_bytes"] for k in launches}))

    got = ranks[0][0]
    large = _large_result_view(got, "large")
    out["large_gate"] = _large_gate("mesh solve_large_sharded", large, r_true, t_true, inlier)
    out["exact_gate"] = _large_gate("mesh solve_large_exact", _large_result_view(got, "exact"),
                                    r_true, t_true, inlier)
    out["frontend_gate"] = _frontend_gate("mesh synth100k", _large_result_view(got, "frontend"),
                                          fe_r, fe_t)
    out["correspondences"] = int(got["frontend.corr"].shape[0])
    out["mesh_none"] = dict(large_s=refs["large_s"], exact_s=refs["exact_s"],
                            frontend_s=refs["frontend_s"], peak_memory_gb=refs["peak_memory_gb"])
    return out


def _large_result_view(fields: dict, prefix: str):
    """A LargeSolveResult of numpy arrays from ``_fields`` output."""
    from teaserpp_tpu_torch.parallel.sharded import LargeSolveResult
    from teaserpp_tpu_torch.solvers.pipeline import PipelineSolution

    sol = PipelineSolution(*(fields[f"{prefix}.solution.{k}"] for k in PipelineSolution._fields))
    return LargeSolveResult(solution=sol, max_core=fields[f"{prefix}.max_core"],
                            clique_size=fields[f"{prefix}.clique_size"])


NCCL_REFUSAL_FLAG = "--nccl-refusal"  # a rank of the refused NCCL world


def nccl_refusal_child(rank: int, address: str) -> int:
    """A rank of a world of two that asks for the default backend (NCCL) on
    a host with one card: ``initialize_distributed`` must raise and name
    the cause, on both ranks, before NCCL sees the shared card."""
    from teaserpp_tpu_torch.parallel import multihost as mh

    try:
        mh.initialize_distributed(address, 2, rank, timeout_s=60.0)
    except RuntimeError as exc:
        refused = "Duplicate GPU" in str(exc) and "gloo" in str(exc)
        print(json.dumps({"rank": rank, "refused": refused, "message": str(exc)}), flush=True)
        return 0 if refused else 1
    print(json.dumps({"rank": rank, "refused": False}), flush=True)
    return 1


def nccl_refusal_phase() -> list:
    """Two ranks asking for NCCL on the one card are refused, by name."""
    address = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, __file__, NCCL_REFUSAL_FLAG, str(r), address],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=120))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, (out, err) in zip(procs, outs):
        if proc.returncode != 0:
            raise AssertionError(f"NCCL on a shared card was not refused: {out} {err[-2000:]}")
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


def nccl_phase(device, refs: dict) -> dict:
    """A world of one over NCCL on this card: the phase joins it itself
    (``init_process_group("nccl")``, world size 1) and runs case (a) on the
    (1, 1) mesh of ``make_mesh``, whose collectives then go through NCCL;
    equal to the ``mesh=None`` runs of ``refs`` bit for bit."""
    import datetime

    import torch.distributed as dist
    from teaserpp_tpu_torch import solve_large_exact, solve_large_sharded
    from teaserpp_tpu_torch.ops import cuda_kernels as ck
    from teaserpp_tpu_torch.parallel import multihost as mh

    src, dst, r_true, t_true, inlier = make_large_problem(LARGE_N)
    src_d, dst_d = _to(device, src, dst)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        mesh = mh.make_mesh()
        ck.reset_launches()
        mh.reset_staged_bytes()
        t0 = time.perf_counter()
        large = solve_large_sharded(src_d, dst_d, large_params(), mesh=mesh, device=device)
        _sync(device)
        large_s = time.perf_counter() - t0
        exact = solve_large_exact(src_d, dst_d, large_params(), mesh=mesh,
                                  time_limit=EXACT_TIME_LIMIT_S, device=device)
        _sync(device)
        launches = dict(ck.LAUNCHES)
        out = dict(backend=dist.get_backend(), world=dist.get_world_size(), mesh=mesh.shape,
                   large_s=large_s, launches=launches, staged_bytes=dict(mh.STAGED_BYTES))
    finally:
        dist.destroy_process_group()
    got = {**_fields("large", large), **_fields("exact", exact)}
    differ = _differing(got, refs["fields"], got)
    if differ or out["backend"] != "nccl" or any(out["staged_bytes"].values()):
        raise AssertionError(f"NCCL world of one: {differ}, {out}")
    _require_launched(device, launches, "NCCL world of one", ["trim_bits"])
    out["gate"] = _large_gate("NCCL solve_large_sharded", _large_result_view(got, "large"),
                              r_true, t_true, inlier)
    out["equal_to_mesh_none"] = True
    return out


def determinism_child() -> int:
    """One facade-defaults solve on the card; prints its hash (for the
    determinism phase's fresh processes)."""
    import torch

    digest, scale = facade_defaults_hash(torch.device("cuda"))
    print(json.dumps({"hash": digest, "scale": scale}), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    try:
        from teaserpp_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: teaserpp_tpu_torch not importable: {exc}", file=sys.stderr)
        return 1
    if sys.argv[1:] == [CHILD_FLAG]:
        return determinism_child()
    if sys.argv[1:2] == [MESH_FLAG]:
        return mesh_child(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
    if sys.argv[1:2] == [NCCL_REFUSAL_FLAG]:
        return nccl_refusal_child(int(sys.argv[2]), sys.argv[3])

    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "libraries": {k: v.name for k, v in libs.items()}}), flush=True)
    for name, so in libs.items():
        log = so.with_name(so.name + ".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {name}:", line.strip())

    device = torch.device("cuda")
    print(json.dumps({"tile_schedule": schedule_phase()}), flush=True)
    print(json.dumps({"refused_launches": refusal_phase(device)}), flush=True)
    print(json.dumps({"sqrt_filter_check": sqrt_filter_phase(device)}), flush=True)
    shapes = kernel_phase(device)
    for name, rows in shapes.items():
        for r in rows:
            print(json.dumps({f"{name}_shape": r}), flush=True)
            if not r["equal"]:
                raise AssertionError(f"{name} differs from its plain version: {r}")

    src, dst = make_problems(BATCH, N_POINTS)
    sol, path = path_phase(device, src, dst)
    print(json.dumps({"path": path, "card": card}), flush=True)

    parity = parity_phase(src, dst, sol)
    print(json.dumps({"parity": parity}), flush=True)

    clique_sol, clique = clique_batch_phase(device, src, dst, sol.clique_mask)
    print(json.dumps({"clique_mode_batch": clique, "card": card}), flush=True)
    from teaserpp_tpu_torch import solve_batch

    src_d, dst_d = _to(device, src, dst)
    print(json.dumps({"clique_mode_profile": device_busy_phase(
        device, lambda: solve_batch(src_d, dst_d, clique_params(), device=device)),
        "card": card}), flush=True)
    del src_d, dst_d
    print(json.dumps({"clique_mode_parity": clique_parity_phase(src, dst, clique_sol)}),
          flush=True)

    large = large_phase(device, LARGE_N)
    print(json.dumps({"large_path": large, "card": card}), flush=True)

    exact = exact_phase(
        device, EXACT_N, large["clique_size"] if EXACT_N == LARGE_N else None)
    print(json.dumps({"exact_path": exact, "card": card}), flush=True)

    ops = ops_phase(device, LARGE_N, DENSE_N)
    print(json.dumps({"public_kernel_ops": ops}), flush=True)

    large_parity = large_parity_phase(device, LARGE_PARITY_N)
    print(json.dumps({"large_parity": large_parity}), flush=True)

    demo = facade_phase(device, 1.0)
    print(json.dumps({"facade_demo": demo, "card": card}), flush=True)
    defaults = facade_phase(device, FACADE_SCALE)
    print(json.dumps({"facade_defaults": defaults, "card": card}), flush=True)
    scale_problems = make_scale_problems(SCALE_BATCH, SCALE_N)
    scale_sol, scale_batch = scale_batch_phase(device, scale_problems)
    print(json.dumps({"unknown_scale_batch": scale_batch, "card": card}), flush=True)
    scale_parity = scale_parity_phase(device, scale_problems, scale_sol)
    print(json.dumps({"unknown_scale_parity": scale_parity}), flush=True)

    determinism = determinism_phase(device, scale_problems, (src, dst))
    print(json.dumps({"determinism": determinism}), flush=True)
    icp = icp_phase(device, demo)
    print(json.dumps({"icp": icp, "card": card}), flush=True)

    frontend, desc_src, desc_dst = frontend_phase(device)
    print(json.dumps({"fpfh_frontend": frontend, "card": card}), flush=True)
    fe_src, fe_dst, _, _ = make_frontend_pair(FRONTEND_N)
    # the profiled window ends at the matches: the solve after it is
    # solve_large_sharded's, timed by its stage_ms above, and its ~110K small
    # launches would cost the profiler a minute of processing
    print(json.dumps({"fpfh_frontend_profile": device_busy_phase(
        device, lambda: frontend_match(device, fe_src, fe_dst, {}), top=12,
        ranges="frontend."), "card": card}), flush=True)
    frontend_parity = frontend_parity_phase(device, desc_src, desc_dst)
    print(json.dumps({"fpfh_frontend_parity": frontend_parity}), flush=True)
    del desc_src, desc_dst
    facade_icp = facade_icp_phase(device)
    print(json.dumps({"fpfh_facade_icp": facade_icp, "card": card}), flush=True)
    cli_run = cli_phase(device, demo)
    print(json.dumps({"cli": cli_run, "card": card}), flush=True)

    cert_e2e, cert_subsets = certify_e2e_phase(device)
    print(json.dumps({"certify_e2e": cert_e2e, "card": card}), flush=True)
    print(json.dumps({"certify_e2e_profile": certify_profile_phase(device, cert_subsets["scene60k"]),
                      "card": card}), flush=True)
    cert_batch = certify_batch_phase(device)
    print(json.dumps({"certify_batch": cert_batch, "card": card}), flush=True)
    cert_scale = certify_scale_phase(device)
    print(json.dumps({"certify_scale": cert_scale, "card": card}), flush=True)
    cert_parity = certify_parity_phase(device)
    print(json.dumps({"certify_parity": cert_parity, "card": card}), flush=True)

    refs = mesh_references(device, sol)
    mesh = mesh_phase(device, refs)
    print(json.dumps({"mesh": mesh, "card": card}), flush=True)
    nccl = nccl_phase(device, refs)
    nccl["shared_card_refused"] = nccl_refusal_phase()
    print(json.dumps({"nccl_world_of_one": nccl, "card": card}), flush=True)
    del refs

    # which shape's numbers stand at the top of each kernel's entry: the one
    # its path gives it
    paths = {"solve_batch": path["launches"], "solve_large_sharded": large["launches"],
             "solve_large_exact": exact["launches"], "public_kernel_ops": ops["launches"],
             "facade_demo": demo["launches"], "facade_defaults": defaults["launches"],
             "unknown_scale_batch": scale_batch["launches"],
             "clique_mode_batch": clique["launches"], "icp": icp["launches"],
             "fpfh_frontend": frontend["launches"], "fpfh_facade_icp": facade_icp["launches"],
             "cli": cli_run["launches"], "certify_e2e": cert_e2e["launches"],
             "certify_batch": cert_batch["launches"], "certify_scale": cert_scale["launches"],
             "certify_parity": cert_parity["launches"],
             "nccl_world_of_one": nccl["launches"]}
    for path in ("large", "exact", "frontend", "batch"):  # summed over the ranks
        paths[f"mesh_{path}"] = {k: sum(r["launches"][path][k] for r in mesh["ranks"])
                                 for k in mesh["ranks"][0]["launches"][path]}
    entries = [
        ("trim_bits", "teaserpp_tpu_torch/csrc/trim_bits.cu",
         "teaserpp_tpu/ops/pallas_kernels.py:165", 0),
        ("trim_bits_slab", "teaserpp_tpu_torch/csrc/trim_bits.cu",
         "teaserpp_tpu/ops/pallas_kernels.py:165", 0),
        ("trim_degrees", "teaserpp_tpu_torch/csrc/trim_degrees.cu",
         "teaserpp_tpu/ops/pallas_kernels.py:244", 1),
        ("trim_adjacency_i8", "teaserpp_tpu_torch/csrc/trim_adjacency.cu",
         "teaserpp_tpu/ops/pallas_kernels.py:59", 1),
        ("greedy_clique", "teaserpp_tpu_torch/csrc/greedy_clique.cu",
         "none: teaserpp_tpu/clique/heuristic.py's vmapped lax.while_loop", 0),
    ]
    kernels = []
    for name, source, replaces, main_index in entries:
        rows = shapes[name]
        main_shape = rows[main_index]
        by_path = {p: counts[name] for p, counts in paths.items()}
        kernels.append(dict(
            name=name,
            route="cuda",
            source=source,
            replaces=replaces,
            launches=sum(by_path.values()),
            launches_by_path=by_path,
            max_abs_err=max(r["max_abs_err"] for r in rows),
            equal=all(r["equal"] for r in rows),
            ms=main_shape["ms"],
            plain_ms=main_shape["plain_ms"],
            bound_ms=main_shape["bound_ms"],
            bound_by=main_shape["bound_by"],
            library_ms=None,  # no single PyTorch call computes any of these functions
            shapes=rows,
        ))
        if kernels[-1]["launches"] == 0:
            raise AssertionError(f"{name} was launched on no path: {paths}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
