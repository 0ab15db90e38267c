"""What the tests marked ``chip`` share: the fixture that decides whether
there is a CUDA card, the poisoned-allocator check, and the problems on
which their gates were measured.

The files that hold ``chip`` tests (``tests/test_torch_chip_*.py`` and
``tests/test_torch_tls_sweep.py``) import no JAX, so on a machine with an
H100 and without JAX they run without ``tests/conftest.py``::

    python -m pytest tests/test_torch_chip_*.py tests/test_torch_tls_sweep.py \\
        -m chip --noconftest -p no:cacheprovider

Importing this module builds and launches nothing: the recipes make their
inputs when a fixture or a test calls them. Keep the recipes as they are:
the gates' constants (the JAX package's clique and correspondence counts
among them) were measured on exactly these inputs.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

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
EXACT_TIME_LIMIT_S = 120.0
GREEDY_SEEDS = 64  # the library's max_clique_heuristic_seeds
SUBGRAPH_M = 2048  # solve_large_sharded's subgraph_size
GREEDY_SKIPPED = (1, 4)  # problems of (7, 333) whose greedy is skipped
PARITY_PROBLEMS = 4
PARITY_TOL = 1e-4  # Frobenius (rotation) / Euclidean (translation), as the tests state
FACADE_SCALE = 1.4  # the library defaults' problem's scale (tests/test_registration_e2e.py's)
# The JAX facade's clique on the facade's problem, float32 and float64 alike
# (scripts/jax_scale_reference.py on the CPU): the clique gate's floor
JAX_FACADE_CLIQUE = 767
TLS_SWEEP_BATCH = 75  # one chunk of the unknown-scale batch at N = 1,889: 267,482,400 events
TLS_SWEEP_SCALE = 2.5  # the unknown-scale cell's
# Kernel R's many-round batch: rotated clouds, noise within the bound, 70% outliers
GNC_BATCH = 64
GNC_N = 1000
GNC_OUTLIERS = 0.7
GNC_NOISE_BOUND = 0.01
SCALE_BATCH = 64  # scripts/bench_scale_est.py's defaults
SCALE_N = 500
SCALE_NOISE_BOUND = 0.01
# The front end: scripts/bench_frontend_e2e.py's synth100k pair (:254-258)
FRONTEND_N = 100_000
FRONTEND_SEED = 11
FRONTEND_NOISE = 0.003
FRONTEND_RADII = (0.05, 0.10)
FRONTEND_NOISE_BOUND = 0.01
# what the JAX package found on that pair (PERFORMANCE.md:455-459): floors
JAX_FRONTEND_CORRESPONDENCES = 12_935
JAX_FRONTEND_CLIQUE = 1_732
# The FPFH facade's wavy patch (tests/test_features.py:371-374) at 64 x 64
PATCH_M = 64
PATCH_SEED = 12345
PATCH_RADII = (0.1, 0.16)
PATCH_NOISE_BOUND = 0.05

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


@pytest.fixture(scope="session")
def cuda_card():
    """The CUDA device, decided when a test asks; a skip without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda", 0)


def poison_allocator(device, shape, dtype):
    """Fill a block of an output's size with a pattern and free it, so a
    kernel that leaves a word of the next ``torch.empty`` of that size
    unwritten cannot pass on leftover bytes of an earlier, equal result.
    Returns the block's address: the caller checks that the output landed
    there."""
    import torch

    torch.cuda.empty_cache()  # no other free block of that size to land on
    pattern = 0x5A if dtype == torch.int8 else 0x5A5A5A5A
    block = torch.full(shape, pattern, dtype=dtype, device=device)
    torch.cuda.synchronize()
    return block.data_ptr()


def to_device(device, *arrays):
    import torch

    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def hash_arrays(*arrays) -> str:
    """sha256 of the arrays' bytes (dtype and shape included), 16 hex digits."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def launched(**counts) -> dict:
    """``LAUNCHES`` as a path leaves them: ``counts``, every other kernel 0."""
    from teaserpp_tpu_torch.ops import cuda_kernels as ck

    return {k: counts.get(k, 0) for k in ck.LAUNCHES}


def run_counted(fn):
    """(``fn()``, the kernel launches it made), synchronised."""
    import torch
    from teaserpp_tpu_torch.ops import cuda_kernels as ck

    ck.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(ck.LAUNCHES)


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


def _rotation(rng):
    q, r_ = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.diag(r_))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def make_scale_problems(batch: int, n: int, seed: int = 0):
    """scripts/bench_scale_est.py's problems: cloud uniform in [-1, 1]^3, a
    uniform random rotation, s uniform in [0.5, 2], t normal with sd 0.5,
    uniform noise +-nb/2, 70% of ``dst`` replaced by uniform [-4, 4]^3.
    Returns (src, dst (B, 3, n) float32, s (B,), R (B, 3, 3), t (B, 3))."""
    rng = np.random.default_rng(seed)
    srcs, dsts, rs, ss, ts = [], [], [], [], []
    for _ in range(batch):
        src = rng.uniform(-1, 1, size=(3, n))
        q = _rotation(rng)
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


def make_frontend_pair(n: int, seed: int = FRONTEND_SEED, half_width: float = 1.0):
    """The synth100k pair (scripts/bench_frontend_e2e.py:254-258): n points
    uniform in [-w, w]^3 and their rigid copy (bench_frontend_e2e.py's
    rigid_copy: a uniform random proper rotation, t uniform in [-1, 1]^3,
    Gaussian noise of sd 0.003 / 3). Returns (src, dst (n, 3), R, t)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-half_width, half_width, (n, 3))
    q, r_ = np.linalg.qr(rng.standard_normal((3, 3)))
    q *= np.sign(np.diag(r_))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    t = rng.uniform(-1, 1, 3)
    dst = pts @ q.T + t + rng.normal(scale=FRONTEND_NOISE / 3, size=pts.shape)
    return pts, dst, q, t


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


def _params(**fields):
    from teaserpp_tpu_torch.params import RobustRegistrationSolverParams

    return RobustRegistrationSolverParams(**fields)


def _kcore_heu(noise_bound: float, **fields):
    """KCORE_HEU at threshold 0 (the top k-core), the scale not estimated."""
    from teaserpp_tpu_torch.params import InlierSelectionMode

    return _params(**{"noise_bound": noise_bound, "estimate_scaling": False,
                      "inlier_selection_mode": InlierSelectionMode.KCORE_HEU,
                      "kcore_heuristic_threshold": 0.0, **fields})


def bench_params():
    """bench.py's batch: KCORE_HEU at threshold 0, known scale."""
    return _kcore_heu(NOISE_BOUND, cbar2=1.0, rotation_cost_threshold=0.005)


def large_params():
    return _kcore_heu(LARGE_NOISE_BOUND)


def scale_params():
    return _kcore_heu(SCALE_NOISE_BOUND, estimate_scaling=True)


def frontend_params():
    return _kcore_heu(FRONTEND_NOISE_BOUND)


def facade_param_fields(estimate_scaling: bool) -> dict:
    """The facade's parameters as field values (either package's
    ``RobustRegistrationSolverParams`` takes them): examples/
    bunny_registration.py's, PMC_EXACT, and the scale estimated or not."""
    return dict(noise_bound=NOISE_BOUND, cbar2=1.0, estimate_scaling=estimate_scaling,
                rotation_cost_threshold=0.005)


def clique_params(**change):
    """bench.py's problem parameters with the library's default inlier
    selection (PMC_EXACT, which the batched path runs as the greedy clique;
    kcore_heuristic_threshold 0.5; 64 seeds)."""
    return _params(**facade_param_fields(False)).replace(**change)


def facade_solve(device, scale: float, n: int = N_POINTS):
    """``RobustRegistrationSolver.solve`` on one bunny-shaped problem
    (examples/bunny_registration.py's parameters, PMC_EXACT), the scale
    estimated when ``scale`` is not 1: (solution, solver, launches)."""
    from teaserpp_tpu_torch import RobustRegistrationSolver

    src, dst = make_problems(1, n, scale=scale)
    solver = RobustRegistrationSolver(_params(**facade_param_fields(scale != 1.0)),
                                      device=device)
    sol, launches = run_counted(lambda: solver.solve(src[0], dst[0]))
    return sol, solver, launches


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
        assert np.array_equal(src[p, 0], i * h) and np.array_equal(dst[p, 0], i * (h + beta))
    return src, dst, beta


def kernel_inputs(seed: int = 0) -> dict:
    """The tile kernels' inputs, {name: (src, dst, valid, beta)} as numpy: the
    three shapes of PERF.md's table of kernels, "main" (a quarter padded),
    "huge" and "large", then the small hard ones: (7, 333) with a scattered
    validity mask, an empty problem, an empty row block and duplicated
    points; (3, 1); (2, 33); and (1, 10007), a gathered subset of the exact
    path."""
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


def slab_cases() -> list:
    """(input name, word rows) of the K1 slab: the two halves of the
    (1, 100000) problem (a (1, 2) mesh's slabs), then on the scattered
    validity mask (7, 333) (11 word rows, the last holding 13 points) the
    ragged last rows, one row, an empty slab and a first slab; and the
    second word row of (2, 33)."""
    words = (LARGE_N + 31) // 32
    half = -(-words // 2)
    return [("large", (0, half)), ("large", (half, words)),
            ("scattered", (6, 11)), ("scattered", (4, 5)), ("scattered", (3, 3)),
            ("scattered", (0, 7)), ("two_blocks", (1, 2))]


def adjacency_case(name: str, inputs: dict, seed: int = 0):
    """K3's inputs -> (src, dst (B, 3, N), beta, noise bound of the agreement
    with ``trim_adjacency_dense`` or None): "main" the first 64 problems of
    the main shape, "large" the first 16,384 points of the huge problem, the
    small hard shapes, "near_threshold" at N = 1,889 and "wide" at
    N = 46,341."""
    from teaserpp_tpu_torch.ops.tims import trim_beta

    if name == "main":
        src, dst = (a[:DENSE_BATCH] for a in inputs["main"][:2])
        return src, dst, trim_beta(NOISE_BOUND), NOISE_BOUND
    if name == "large":
        src, dst = (a[..., :DENSE_N] for a in inputs["large"][:2])
        return src, dst, trim_beta(LARGE_NOISE_BOUND), LARGE_NOISE_BOUND
    if name == "near_threshold":
        return (*near_threshold_problems(N_POINTS), None)
    if name == "wide":
        src, dst, *_ = make_large_problem(WIDE_N, seed=seed + 17)
        return src[None], dst[None], trim_beta(LARGE_NOISE_BOUND), None
    src, dst, _, beta = inputs[name]
    return src, dst, beta, None


ADJACENCY_CASES = ["main", "large", "one_point", "two_blocks", "scattered", "gathered_subset",
                   "near_threshold", "wide"]
GREEDY_CASES = ["bunny_batch", "sharded_subgraph", "padded_odd"]


def greedy_case(name: str, device, inputs: dict):
    """Kernel G's inputs on ``device`` -> (rows, order, allowed), with its
    path's seeds: "bunny_batch" K1's words of the 512 bunny problems,
    "sharded_subgraph" ``solve_large_sharded``'s dense sub-adjacency of the
    N=100,000 problem (the top ``SUBGRAPH_M`` by score), "padded_odd"
    (7, 333)'s scattered validity with the problems ``GREEDY_SKIPPED``
    skipped."""
    import torch
    from teaserpp_tpu_torch.clique.heuristic import greedy_order_and_allowed
    from teaserpp_tpu_torch.clique.kcore import core_numbers, core_numbers_from_bits, pack_bits_u32
    from teaserpp_tpu_torch.ops import cuda_kernels as ck
    from teaserpp_tpu_torch.ops.tims import trim_adjacency_dense, trim_beta
    from teaserpp_tpu_torch.parallel.sharded import candidate_scores, top_candidates

    def from_words(words, valid, skip=None):
        core = core_numbers_from_bits(words, words.shape[-1], valid)
        order, allowed = greedy_order_and_allowed(core, valid, skip)
        return words.transpose(-1, -2).contiguous(), order, allowed

    if name == "bunny_batch":
        src, dst = to_device(device, *make_problems(BATCH, N_POINTS))
        valid = torch.ones(src.shape[0], src.shape[-1], dtype=torch.bool, device=device)
        return from_words(ck.trim_bits(src, dst, valid, trim_beta(NOISE_BOUND)), valid)
    if name == "sharded_subgraph":
        src, dst = to_device(device, *inputs["large"][:2])
        score, _ = candidate_scores(src, dst, large_params())
        top = top_candidates(score, min(SUBGRAPH_M, src.shape[-1]))
        sub = trim_adjacency_dense(src[..., top], dst[..., top], LARGE_NOISE_BOUND)
        order, allowed = greedy_order_and_allowed(core_numbers(sub))
        return pack_bits_u32(sub), order, allowed
    s_np, d_np, v_np, beta = inputs["scattered"]
    src, dst, valid = to_device(device, s_np, d_np, v_np)
    skip = torch.zeros(src.shape[0], dtype=torch.bool, device=device)
    skip[list(GREEDY_SKIPPED)] = True
    return from_words(ck.trim_bits(src, dst, valid, beta), valid, skip)


def tls_sweep_case(name: str, device):
    """Kernel S's inputs on ``device`` -> (perm, x, ranges, vmask), as
    ``solve_scale_tls`` hands them to ``scalar_tls``: the raw scales and
    half-intervals of the TIM pairs of bunny problems at N = 1,889 with
    s = 2.5, a cloud each: "chunk", ``TLS_SWEEP_BATCH`` of them (one chunk
    of the unknown-scale batch) in float32; "float64", the first 4."""
    import torch
    from teaserpp_tpu_torch.ops.tims import compute_tim_norms

    dtype, bsz = {"chunk": (torch.float32, TLS_SWEEP_BATCH), "float64": (torch.float64, 4)}[name]
    src, dst = to_device(device, *make_problems(bsz, N_POINTS, shared_cloud=False,
                                                scale=TLS_SWEEP_SCALE))
    sn, dn = compute_tim_norms(src).to(dtype), compute_tim_norms(dst).to(dtype)
    safe = torch.where(sn > 0, sn, torch.ones_like(sn))
    x, ranges, vmask = dn / safe, 2.0 * NOISE_BOUND / safe, (sn > 0).to(dtype)
    perm = torch.sort(torch.cat([x - ranges, x + ranges], dim=-1), dim=-1, stable=True).indices
    return perm, x, ranges, vmask


def large_gate(name: str, res, r_true, t_true, inlier) -> dict:
    """The JAX tests' limits for the huge-N path on a numpy
    ``LargeSolveResult``: valid, finite, <0.5 deg, <0.02, and a clique mask
    of ``clique_size`` members. Returns the numbers it held."""
    from teaserpp_tpu_torch.utils.metrics import rotation_error_deg, translation_error

    sol = res.solution
    assert sol.rotation.shape == (3, 3) and sol.translation.shape == (3,), name
    assert np.isfinite(sol.rotation).all() and np.isfinite(sol.translation).all(), name
    out = dict(valid=bool(sol.valid), rot_err_deg=rotation_error_deg(sol.rotation, r_true),
               trans_err=translation_error(sol.translation, t_true),
               clique_size=int(res.clique_size), members=int(sol.clique_mask.sum()),
               true_members=int((sol.clique_mask & inlier).sum()))
    assert (out["valid"] and out["rot_err_deg"] < 0.5 and out["trans_err"] < 0.02
            and out["members"] == out["clique_size"]), f"{name}: {out}"
    return out


def frontend_gate(name: str, res, r_true, t_true) -> dict:
    """The front end's gate on a numpy ``LargeSolveResult``: finite, <0.1 deg
    and <0.01 m against the planted transform."""
    from teaserpp_tpu_torch.utils.metrics import rotation_error_deg, translation_error

    sol = res.solution
    out = dict(rot_err_deg=rotation_error_deg(np.asarray(sol.rotation, np.float64), r_true),
               trans_err_m=translation_error(np.asarray(sol.translation, np.float64), t_true),
               clique_size=int(res.clique_size))
    assert (np.isfinite(sol.rotation).all() and np.isfinite(sol.translation).all()
            and out["rot_err_deg"] < 0.1 and out["trans_err_m"] < 0.01), f"{name}: {out}"
    return out


GNC_CASES = ["bunny_batch", "facade", "outliers_100", "outliers_1", "degenerate",
             "noise_bounds", "float64", "quatro", "complete_graph", "large"]


def _top_core_mask(src, dst, valid, beta):
    """Each problem's top k-core of K1's graph (the known-scale batch's
    KCORE_HEU clique)."""
    from teaserpp_tpu_torch.clique.kcore import core_numbers_from_bits
    from teaserpp_tpu_torch.ops import cuda_kernels as ck

    core = core_numbers_from_bits(ck.trim_bits(src, dst, valid, beta), src.shape[-1], valid)
    return (core >= core.amax(dim=-1, keepdim=True)) & valid


def gnc_outlier_problems(batch: int, n: int, seed: int = 0):
    """Rotation-only problems that take GNC-TLS through many rounds: points
    uniform in [-1, 1]^3, a uniform random rotation each, uniform noise
    +-nb/2, ``GNC_OUTLIERS`` of ``dst`` uniform in [-1, 1]^3, and the last
    problem's second half padding -> (src, dst (B, 3, n) float32, valid)."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1, 1, (batch, 3, n))
    rot = np.stack([_rotation(rng) for _ in range(batch)])
    dst = rot @ src + rng.uniform(-GNC_NOISE_BOUND / 2, GNC_NOISE_BOUND / 2, (batch, 3, n))
    k = int(GNC_OUTLIERS * n)
    dst[:, :, :k] = rng.uniform(-1, 1, (batch, 3, k))
    valid = np.ones((batch, n), bool)
    valid[-1, n // 2:] = False
    return src.astype(np.float32), dst.astype(np.float32), valid


def gnc_tls_case(name: str, device, inputs: dict) -> dict:
    """Kernel R's inputs on ``device`` -> the keyword arguments of
    ``cuda_kernels.gnc_tls`` (``src``, ``dst``, ``noise_bound``,
    ``gnc_factor``, ``max_iterations``, ``cost_threshold``, ``valid``,
    ``procrustes``):

    * "bunny_batch": the chain TIMs of the top k-cores of the 512 bunny
      problems of ``kernel_inputs``'s "main" (a quarter padded), with the
      rotation stage's noise bound per problem and the bunny's cost
      threshold 0.005; "facade": the first of them alone;
    * "outliers_100", "outliers_1": :func:`gnc_outlier_problems` with 100
      rounds at most and with 1;
    * "degenerate": noise-free data (mu0 <= 0 stops it in round 0), a
      problem with no valid column, and one of the outlier problems;
    * "noise_bounds": the outlier problems, each with its own noise bound
      from 1 to 2 times the one their noise keeps to, the first 0 (the 1e-2
      fallback of its square);
    * "float64": the outlier problems in float64;
    * "quatro": their XY rows (strided views) with the 2-D Procrustes;
    * "complete_graph": the facade's COMPLETE formulation, every pair TIM of
      the first bunny problem's top core (~293,000 columns);
    * "large": the chain TIMs of the planted inliers of the N=100,000
      problem (``solve_large_sharded``'s width).
    """
    import torch
    from teaserpp_tpu_torch.ops.procrustes import svd_rot, svd_rot_2d
    from teaserpp_tpu_torch.ops.tims import chain_tims

    args = dict(gnc_factor=1.4, max_iterations=100, cost_threshold=1e-6, procrustes=svd_rot)
    if name in ("bunny_batch", "facade", "complete_graph"):
        s_np, d_np, v_np, beta = inputs["main"]
        if name != "bunny_batch":
            s_np, d_np, v_np = s_np[:1], d_np[:1], v_np[:1]
        src, dst, valid = to_device(device, s_np, d_np, v_np)
        mask = _top_core_mask(src, dst, valid, beta)
        nb = torch.full((src.shape[0],), 2.0 * NOISE_BOUND, dtype=src.dtype, device=device)
        args.update(cost_threshold=0.005, noise_bound=nb)
        if name == "complete_graph":
            idx = torch.nonzero(mask[0])[:, 0]
            i, j = torch.triu_indices(idx.numel(), idx.numel(), 1, device=device)
            src_t = (src[0][:, idx[j]] - src[0][:, idx[i]])[None]
            dst_t = (dst[0][:, idx[j]] - dst[0][:, idx[i]])[None]
            return dict(args, src=src_t.contiguous(), dst=dst_t.contiguous(), valid=None)
        src_t, tim_valid = chain_tims(src, mask)
        dst_t, _ = chain_tims(dst, mask)
        return dict(args, src=src_t, dst=dst_t, valid=tim_valid)
    if name == "large":
        src, dst, _, _, inlier = make_large_problem(LARGE_N)
        src, dst, mask = to_device(device, src[None], dst[None], inlier[None])
        src_t, tim_valid = chain_tims(src, mask)
        dst_t, _ = chain_tims(dst, mask)
        return dict(args, src=src_t, dst=dst_t, valid=tim_valid,
                    noise_bound=2.0 * LARGE_NOISE_BOUND)
    s_np, d_np, v_np = gnc_outlier_problems(GNC_BATCH, GNC_N)
    if name == "degenerate":
        s_np, d_np, v_np = s_np[:3].copy(), d_np[:3].copy(), v_np[:3].copy()
        d_np[0] = s_np[0]  # noise-free: every residual 0
        v_np[1] = False
    src, dst, valid = to_device(device, s_np, d_np, v_np)
    args.update(src=src, dst=dst, valid=valid, noise_bound=GNC_NOISE_BOUND)
    if name == "outliers_1":
        args.update(max_iterations=1)
    elif name == "noise_bounds":
        nb = np.linspace(1.0, 2.0, GNC_BATCH) * GNC_NOISE_BOUND
        nb[0] = 0.0
        args.update(noise_bound=torch.as_tensor(nb, dtype=src.dtype, device=device))
    elif name == "float64":
        args.update(src=src.double(), dst=dst.double())
    elif name == "quatro":
        args.update(src=src[:, :2], dst=dst[:, :2], procrustes=svd_rot_2d)
    return args
