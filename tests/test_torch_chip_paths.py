"""The port's solve paths on the card, each held to its gate, to its run on
the CPU and to the launches its route makes: ``solve_batch`` on 512
bunny-shaped problems with the known scale (KCORE_HEU at threshold 0) and
with the library's default selector (PMC_EXACT, which the batched path runs
as K1's words into the greedy clique kernel), ``solve_large_sharded`` and
``solve_large_exact`` at N = 100,000, the two public kernel operations, the
facade (``RobustRegistrationSolver``) on the bunny-shaped demo with the
known and with the estimated scale, the unknown-scale batch, ICP, and every
output's bits repeating in this process and in fresh ones.

Each path's launches are counted from 0 and compared whole with the
kernels its route runs (``ops/cuda_kernels.py::LAUNCHES``): a route that
reaches no TRIM kernel in the JAX package reaches none here, only the
unknown-scale routes sweep with kernel S, and each GNC-TLS rotation solve is
one launch of kernel R (``gnc_tls``), every round of every problem in it. Marked ``chip``: skips without a
CUDA card. No JAX; on a machine with an H100::

    python -m pytest tests/test_torch_chip_paths.py -m chip --noconftest -p no:cacheprovider
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_support import (
    BATCH,
    DENSE_N,
    EXACT_TIME_LIMIT_S,
    FACADE_SCALE,
    JAX_FACADE_CLIQUE,
    LARGE_N,
    LARGE_NOISE_BOUND,
    N_POINTS,
    NOISE_BOUND,
    PARITY_PROBLEMS,
    PARITY_TOL,
    SCALE_BATCH,
    SCALE_N,
    T,
    bench_params,
    clique_params,
    cuda_card,  # noqa: F401 (a fixture)
    facade_solve,
    hash_arrays,
    large_gate,
    large_params,
    launched,
    make_large_problem,
    make_problems,
    make_scale_problems,
    run_counted,
    scale_params,
    to_device,
)
from teaserpp_tpu_torch import solve_batch, solve_large_exact, solve_large_sharded
from teaserpp_tpu_torch.convert import large_result_to_numpy, solution_to_numpy
from teaserpp_tpu_torch.ops import cuda_kernels as ck
from teaserpp_tpu_torch.params import InlierSelectionMode
from teaserpp_tpu_torch.utils.metrics import angular_error, rotation_error_deg, translation_error

pytestmark = pytest.mark.chip

LARGE_PARITY_N = 2000
FACADE_PARITY_N = 300
SCALE_PARITY_TOL = 1e-5
DETERMINISM_FACADE_RUNS = 20
DETERMINISM_PROCESSES = 2
ICP_SEED = 31
ICP_START_DEG = 2.0  # ICP's start: the demo's result turned and shifted
ICP_START_M = 0.005
ICP_MAX_DISTANCE = 0.02
ICP_PARITY_TOL = 1e-5


def _max_norm(a, b, axes) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b), axis=axes).max())


def _bunny_gate(sol):
    """Every problem valid and within 0.1 deg and 0.01 m of ``T``."""
    bsz = sol.rotation.shape[0]
    assert sol.rotation.shape == (bsz, 3, 3) and sol.translation.shape == (bsz, 3)
    assert np.isfinite(sol.rotation).all() and np.isfinite(sol.translation).all()
    rot = np.array([rotation_error_deg(r, T[:3, :3]) for r in sol.rotation])
    trans = np.array([translation_error(t, T[:3, 3]) for t in sol.translation])
    assert (rot < 0.1).all() and (trans < 0.01).all() and sol.valid.all(), (
        rot.max(), trans.max(), int((~sol.valid).sum()))


def _cpu_parity(src, dst, params, sol, fields=("clique_mask",)):
    """The first problems solved on the CPU against the card's ``sol``:
    ``fields`` equal, R and t within ``PARITY_TOL``. Returns the CPU's."""
    k = PARITY_PROBLEMS
    cpu = solution_to_numpy(solve_batch(src[:k], dst[:k], params, device="cpu"))
    for name in fields:
        assert np.array_equal(getattr(cpu, name), getattr(sol, name)[:k]), name
    assert _max_norm(cpu.rotation, sol.rotation[:k], (1, 2)) <= PARITY_TOL
    assert _max_norm(cpu.translation, sol.translation[:k], 1) <= PARITY_TOL
    return cpu


@pytest.fixture(scope="module")
def bunny(cuda_card):
    return make_problems(BATCH, N_POINTS)


@pytest.fixture(scope="module")
def batch(cuda_card, bunny):
    """``solve_batch`` of the 512 problems, known scale: (numpy, launches)."""
    src, dst = to_device(cuda_card, *bunny)
    sol, launches = run_counted(lambda: solve_batch(src, dst, bench_params(), device=cuda_card))
    return solution_to_numpy(sol), launches


@pytest.fixture(scope="module")
def clique_batch(cuda_card, bunny):
    """The same under the default selector (the batched greedy clique)."""
    src, dst = to_device(cuda_card, *bunny)
    sol, launches = run_counted(lambda: solve_batch(src, dst, clique_params(), device=cuda_card))
    return solution_to_numpy(sol), launches


def test_batch(batch):
    sol, launches = batch
    _bunny_gate(sol)
    assert launches == launched(trim_bits=1, gnc_tls=1)


def test_batch_on_the_cpu(batch, bunny):
    _cpu_parity(*bunny, bench_params(), batch[0])


def test_clique_mode_batch(clique_batch, bunny, cuda_card):
    """The gate; K1, the greedy kernel and kernel R once a solve; the masks of 8
    problems cliques of K1's graph, read from its plain version's words on
    the host."""
    from teaserpp_tpu_torch.ops.tims import trim_beta
    from teaserpp_tpu_torch.parallel.sharded import _unpack_bits_rows

    sol, launches = clique_batch
    _bunny_gate(sol)
    assert launches == launched(trim_bits=1, greedy_clique=1, gnc_tls=1)
    src, dst = to_device(cuda_card, *bunny)
    _, again = run_counted(lambda: [solve_batch(src, dst, clique_params(), device=cuda_card)
                                    for _ in range(3)])
    assert again == launched(trim_bits=3, greedy_clique=3, gnc_tls=3)

    s, d = (torch.from_numpy(a[:8]) for a in bunny)
    valid = torch.ones(8, N_POINTS, dtype=torch.bool)
    words = ck.trim_adjacency_bits_plain(s, d, valid, trim_beta(NOISE_BOUND)).numpy()
    for p in range(8):
        idx = np.flatnonzero(sol.clique_mask[p])
        adj = _unpack_bits_rows(words[p], N_POINTS)
        assert adj[np.ix_(idx, idx)].sum() == idx.size * (idx.size - 1), p


@pytest.mark.parametrize("mode", ["PMC_HEU", "KCORE_HEU_0.5"])
def test_other_greedy_modes_give_the_default_s_masks(mode, clique_batch, bunny, cuda_card):
    change = {"PMC_HEU": dict(inlier_selection_mode=InlierSelectionMode.PMC_HEU),
              "KCORE_HEU_0.5": dict(inlier_selection_mode=InlierSelectionMode.KCORE_HEU,
                                    kcore_heuristic_threshold=0.5)}[mode]
    src, dst = to_device(cuda_card, *bunny)
    other = solve_batch(src, dst, clique_params(**change), device=cuda_card)
    assert np.array_equal(other.clique_mask.cpu().numpy(), clique_batch[0].clique_mask)


@pytest.mark.parametrize("where", ["all", "some"])
def test_kcore_shortcut(where, batch, clique_batch, bunny, cuda_card):
    """KCORE_HEU's shortcut (max_core > threshold * n): at 0.9 of the least
    max-core share it fires on every problem and gives the top k-core of the
    known-scale batch; at the median share the top k-core where it fires and
    the greedy clique elsewhere."""
    from teaserpp_tpu_torch.clique.kcore import core_numbers_from_bits
    from teaserpp_tpu_torch.ops.tims import trim_beta

    src, dst = to_device(cuda_card, *bunny)
    n = src.shape[-1]
    valid = torch.ones(src.shape[0], n, dtype=torch.bool, device=cuda_card)
    max_core = core_numbers_from_bits(ck.trim_adjacency_bits_plain(
        src, dst, valid, trim_beta(NOISE_BOUND)), n, valid).amax(dim=-1).cpu().numpy()
    ratio = max_core / n
    threshold = round(0.9 * float(ratio.min()) if where == "all" else float(np.median(ratio)), 3)
    fired = max_core.astype(np.float32) > np.float32(threshold) * np.float32(n)
    got = solve_batch(src, dst, clique_params(inlier_selection_mode=InlierSelectionMode.KCORE_HEU,
                                              kcore_heuristic_threshold=threshold),
                      device=cuda_card).clique_mask.cpu().numpy()
    want = np.where(fired[:, None], batch[0].clique_mask, clique_batch[0].clique_mask)
    assert np.array_equal(got, want), (threshold, int(fired.sum()))
    assert where == "some" or fired.all()


def test_clique_mode_batch_on_the_cpu(clique_batch, bunny):
    _cpu_parity(*bunny, clique_params(), clique_batch[0])


@pytest.fixture(scope="module")
def large(cuda_card):
    """``solve_large_sharded`` of the N=100,000 problem: (numpy, launches,
    (R, t, inlier mask))."""
    src, dst, r, t, inlier = make_large_problem(LARGE_N)
    s, d = to_device(cuda_card, src, dst)
    res, launches = run_counted(lambda: solve_large_sharded(s, d, large_params(),
                                                            device=cuda_card))
    return large_result_to_numpy(res), launches, (r, t, inlier)


def test_large(large):
    res, launches, truth = large
    large_gate("solve_large_sharded", res, *truth)
    assert launches == launched(trim_bits=1, greedy_clique=1, gnc_tls=1)


def test_large_exact(large, cuda_card):
    """The same gate, and a clique no smaller than the heuristic's; kernel R
    in the heuristic bound's solve and in the exact clique's."""
    src, dst, r, t, inlier = make_large_problem(LARGE_N)
    s, d = to_device(cuda_card, src, dst)
    res, launches = run_counted(lambda: solve_large_exact(
        s, d, large_params(), time_limit=EXACT_TIME_LIMIT_S, device=cuda_card))
    gate = large_gate("solve_large_exact", large_result_to_numpy(res), r, t, inlier)
    assert gate["clique_size"] >= int(large[0].clique_size)
    assert launches == launched(trim_bits=3, greedy_clique=1, gnc_tls=2)


def test_public_kernel_operations(cuda_card):
    """TRIM degrees of the huge problem and the dense int8 adjacency of its
    first 16,384 correspondences, against what the planted inliers imply:
    any two inliers are consistent (their distances differ by at most
    2 sqrt(3) nb/2 < 2 nb), so an inlier's degree is at least the inlier
    count less one, and the inlier block of the adjacency is all ones off
    the diagonal. These two kernels sit on no solver path, as in JAX."""
    from teaserpp_tpu_torch.ops.tims import trim_beta

    src, dst, _, _, inlier = make_large_problem(LARGE_N)
    beta = trim_beta(LARGE_NOISE_BOUND)
    s, d = to_device(cuda_card, src[None], dst[None])
    (deg, adj), launches = run_counted(lambda: (
        ck.trim_degrees(s, d, beta)[0],
        ck.trim_adjacency_i8(s[..., :DENSE_N].contiguous(), d[..., :DENSE_N].contiguous(),
                             beta)[0]))
    assert launches == launched(trim_degrees=1, trim_adjacency_i8=1)
    inl = torch.from_numpy(inlier).to(cuda_card)
    inl_s = inl[:DENSE_N]
    assert tuple(deg.shape) == (LARGE_N,) and deg.dtype == torch.int32
    assert int(deg[inl].min()) >= int(inlier.sum()) - 1
    assert tuple(adj.shape) == (DENSE_N, DENSE_N) and adj.dtype == torch.int8
    assert torch.equal(adj, adj.T) and not bool(adj.diagonal().any())
    m = int(inl_s.sum())
    assert int(adj[inl_s][:, inl_s].sum()) == m * (m - 1)
    # the subgraph's degrees never exceed the whole graph's
    assert bool((adj.sum(dim=0, dtype=torch.int32) <= deg[:DENSE_N]).all())


@pytest.mark.parametrize("branch", ["dense", "bits", "exact"])
def test_large_on_the_cpu(branch, cuda_card):
    """At N=2,000 against the CPU: the heuristic solve in both branches
    (dense peel; bit words with the binary-search core) and the exact solve:
    equal max core, candidate order and clique mask, R and t within 1e-4."""
    from teaserpp_tpu_torch.parallel.sharded import candidate_scores, top_candidates

    src, dst, *_ = make_large_problem(LARGE_PARITY_N)
    params = large_params()
    m = 256
    threshold = {"dense": DENSE_N, "bits": 64, "exact": None}[branch]

    def run(dev):
        if branch == "exact":
            # one search thread: with several, which of two equal cliques
            # wins is a matter of timing
            return None, large_result_to_numpy(solve_large_exact(
                src, dst, params, time_limit=EXACT_TIME_LIMIT_S, num_threads=1, device=dev))
        s, d = to_device(dev, src[None], dst[None])
        score, _ = candidate_scores(s, d, params, threshold)
        return top_candidates(score, m).cpu().numpy(), large_result_to_numpy(
            solve_large_sharded(src, dst, params, subgraph_size=m,
                                blocked_threshold=threshold, device=dev))

    (top_c, res_c), (top_d, res_d) = run(torch.device("cpu")), run(cuda_card)
    assert int(res_c.max_core) == int(res_d.max_core)
    assert branch == "exact" or np.array_equal(top_c, top_d)
    assert np.array_equal(res_c.solution.clique_mask, res_d.solution.clique_mask)
    assert np.linalg.norm(res_c.solution.rotation - res_d.solution.rotation) <= PARITY_TOL
    assert np.linalg.norm(res_c.solution.translation - res_d.solution.translation) <= PARITY_TOL


@pytest.mark.parametrize("scale", [1.0, FACADE_SCALE], ids=["demo", "defaults"])
def test_facade(scale, cuda_card):
    """The demo (known scale) and the library's defaults (s = 1.4
    estimated): <0.1 deg, <0.01 m, |ds| < 1e-3, and a clique no smaller
    than the JAX facade's. PMC_EXACT searches on the host: no TRIM kernel
    and no greedy; kernel S sweeps the scale in 6 launches, kernel R solves
    the rotation in one."""
    sol, solver, launches = facade_solve(cuda_card, scale)
    assert sol.rotation.shape == (3, 3) and sol.translation.shape == (3,)
    assert np.isfinite(sol.rotation).all() and np.isfinite(sol.translation).all()
    assert sol.valid and abs(float(sol.scale) - scale) < 1e-3
    assert rotation_error_deg(sol.rotation, T[:3, :3]) < 0.1
    assert translation_error(sol.translation, T[:3, 3]) < 0.01
    assert len(solver.getInlierMaxClique()) >= JAX_FACADE_CLIQUE
    assert launches == (launched(gnc_tls=1) if scale == 1.0
                        else launched(tls_sweep=6, gnc_tls=1))


@pytest.fixture(scope="module")
def scale_batch(cuda_card):
    """``solve_batch`` with unknown scale on scripts/bench_scale_est.py's 64
    problems of N=500: (problems, numpy, launches)."""
    problems = make_scale_problems(SCALE_BATCH, SCALE_N)
    src, dst = to_device(cuda_card, *problems[:2])
    sol, launches = run_counted(lambda: solve_batch(src, dst, scale_params(), device=cuda_card))
    return problems, solution_to_numpy(sol), launches


def test_unknown_scale_batch(scale_batch):
    """tests/test_registration_e2e.py's gate on every problem: |ds| < 1e-3,
    <0.01 rad, <0.02; kernel S in one chunk (5 launches at N = 500), kernel
    R once."""
    (_, _, s_true, r_true, t_true), sol, launches = scale_batch
    assert all(np.isfinite(a).all() for a in (sol.rotation, sol.translation, sol.scale))
    assert (np.abs(sol.scale - s_true) < 1e-3).all()
    assert all(angular_error(r, rt) < 0.01 for r, rt in zip(sol.rotation, r_true))
    assert all(translation_error(t, tt) < 0.02 for t, tt in zip(sol.translation, t_true))
    assert sol.valid.all()
    assert launches == launched(tls_sweep=5, gnc_tls=1)


def test_unknown_scale_batch_on_the_cpu(scale_batch):
    """4 problems: equal clique and scale-pair masks, s within 1e-5."""
    problems, sol, _ = scale_batch
    cpu = _cpu_parity(*problems[:2], scale_params(), sol,
                      fields=("clique_mask", "scale_pair_mask"))
    assert np.abs(cpu.scale - sol.scale[:PARITY_PROBLEMS]).max() <= SCALE_PARITY_TOL


def test_unknown_scale_facade_on_the_cpu(cuda_card):
    """The facade at N=300 with unknown scale: equal clique, s within 1e-5,
    R and t within 1e-4."""
    (c_sol, c_solver, _), (d_sol, d_solver, _) = (
        facade_solve(dev, FACADE_SCALE, FACADE_PARITY_N) for dev in ("cpu", cuda_card))
    assert c_solver.getInlierMaxClique() == d_solver.getInlierMaxClique()
    assert c_sol.valid and d_sol.valid
    assert abs(c_sol.scale - d_sol.scale) <= SCALE_PARITY_TOL
    assert np.linalg.norm(c_sol.rotation - d_sol.rotation) <= PARITY_TOL
    assert np.linalg.norm(c_sol.translation - d_sol.translation) <= PARITY_TOL


def facade_defaults_hash(device) -> str:
    """The hash of R, t, s and the clique of one facade solve with the
    library's defaults (``test_facade[defaults]``'s problem)."""
    sol, solver, _ = facade_solve(device, FACADE_SCALE)
    return hash_arrays(sol.rotation, sol.translation, np.float64(sol.scale),
                       np.asarray(solver.getInlierMaxClique(), np.int64))


FRESH_PROCESS = """
import sys
sys.path[:0] = sys.argv[1:3]
from test_torch_chip_paths import facade_defaults_hash
print(facade_defaults_hash("cuda"))
"""


def test_facade_defaults_repeat_here_and_in_fresh_processes(cuda_card):
    here = os.path.dirname(os.path.abspath(__file__))
    children = [subprocess.Popen([sys.executable, "-c", FRESH_PROCESS, here,
                                  os.path.dirname(here)], stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
                for _ in range(DETERMINISM_PROCESSES)]
    hashes = {facade_defaults_hash(cuda_card) for _ in range(DETERMINISM_FACADE_RUNS)}
    for proc in children:
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            proc.kill()
        assert proc.returncode == 0, err[-2000:]
        hashes.add(out.strip().splitlines()[-1])
    assert len(hashes) == 1, hashes


@pytest.mark.parametrize("which,runs", [("unknown_scale", 5), ("clique_mode", 3)])
def test_batch_repeats_bit_for_bit(which, runs, bunny, cuda_card):
    if which == "unknown_scale":
        problems, params = make_scale_problems(SCALE_BATCH, SCALE_N)[:2], scale_params()
    else:
        problems, params = bunny, clique_params()
    src, dst = to_device(cuda_card, *problems)
    hashes = {hash_arrays(*solution_to_numpy(solve_batch(src, dst, params, device=cuda_card)))
              for _ in range(runs)}
    assert len(hashes) == 1, hashes


def test_icp(cuda_card):
    """``icp_point_to_point`` on the bunny-shaped cloud against its
    transformed copy (noise +-nb/2, no outliers), from the demo's result
    turned by 2 degrees and shifted by 5 mm: <0.1 deg, the CPU run within
    1e-5, no kernel."""
    from teaserpp_tpu_torch.solvers.icp import icp_point_to_point

    demo, _, _ = facade_solve(cuda_card, 1.0)
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
    r0, t0 = turn @ np.asarray(demo.rotation), np.asarray(demo.translation) + shift
    src32, dst32 = cloud.astype(np.float32), target.astype(np.float32)

    def run(dev):
        return icp_point_to_point(src32, dst32, ICP_MAX_DISTANCE, r_init=r0, t_init=t0,
                                  max_iterations=50, device=dev)

    res, launches = run_counted(lambda: run(cuda_card))
    assert launches == launched()
    cpu = run("cpu")
    r, t = res.rotation.cpu().double().numpy(), res.translation.cpu().double().numpy()
    assert np.isfinite(r).all() and rotation_error_deg(r, T[:3, :3]) < 0.1
    assert np.abs(cpu.rotation.double().numpy() - r).max() <= ICP_PARITY_TOL
    assert np.abs(cpu.translation.double().numpy() - t).max() <= ICP_PARITY_TOL
