"""The FPFH front end, its facades and the command-line tool on the card:
scripts/bench_frontend_e2e.py's synth100k pair (100,000 points uniform in
[-1, 1]^3 and a rigid copy with noise 0.003; radii 0.05 and 0.10) through
plans, normals, FPFH, the matcher with cross-check and
``solve_large_sharded``, against the planted transform and the JAX
package's counts; the matcher against a plain exact nearest neighbour, the
grid passes and the matcher against the CPU; examples/fpfh_icp_registration.py's
flow (``FPFHEstimation``, ``Matcher``, ``RobustRegistrationSolver``, ICP) on
a wavy patch; and ``python -m teaserpp_tpu_torch.cli``.

Marked ``chip``: skips without a CUDA card. No JAX; on a machine with an
H100::

    python -m pytest tests/test_torch_chip_frontend.py -m chip --noconftest -p no:cacheprovider
"""

import contextlib
import io
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_support import (
    DENSE_N,
    FRONTEND_N,
    FRONTEND_RADII,
    FRONTEND_SEED,
    JAX_FRONTEND_CLIQUE,
    JAX_FRONTEND_CORRESPONDENCES,
    N_POINTS,
    NOISE_BOUND,
    PATCH_NOISE_BOUND,
    PATCH_RADII,
    T,
    cuda_card,  # noqa: F401 (a fixture)
    facade_solve,
    frontend_gate,
    frontend_params,
    launched,
    make_frontend_pair,
    make_patch,
    make_problems,
    run_counted,
)
from teaserpp_tpu_torch import RobustRegistrationSolver, solve_large_sharded
from teaserpp_tpu_torch.convert import large_result_to_numpy
from teaserpp_tpu_torch.features import (
    FPFHEstimation,
    Matcher,
    build_neighbor_plans,
    compute_fpfh_pruned,
    estimate_normals_pruned,
)
from teaserpp_tpu_torch.params import InlierSelectionMode, RobustRegistrationSolverParams
from teaserpp_tpu_torch.utils.metrics import rotation_error_deg, translation_error

pytestmark = pytest.mark.chip

PARITY_QUERIES = 8192
PARITY_N = 8192  # the synth100k density at half-width 0.4


@pytest.fixture(scope="module")
def synth100k(cuda_card):
    """The pair through the front end and the solve:
    (correspondences, descriptors, numpy result, launches, (R, t))."""
    src, dst, r_true, t_true = make_frontend_pair(FRONTEND_N)

    def run():
        plans = [build_neighbor_plans(c, FRONTEND_RADII) for c in (src, dst)]
        xs = [c.astype(np.float32) for c in (src, dst)]
        normals = [estimate_normals_pruned(x, FRONTEND_RADII[0], p[0], device=cuda_card)
                   for x, p in zip(xs, plans)]
        desc = [compute_fpfh_pruned(x, nr.normals, FRONTEND_RADII[1], p[1], device=cuda_card)
                for x, nr, p in zip(xs, normals, plans)]
        corr = Matcher(device=cuda_card).calculateCorrespondences(
            src, dst, desc[0], desc[1], False, True, False, 0.95)
        ci, cj = np.asarray(corr, np.int64).T
        res = solve_large_sharded(np.ascontiguousarray(src[ci].T).astype(np.float32),
                                  np.ascontiguousarray(dst[cj].T).astype(np.float32),
                                  frontend_params(), device=cuda_card)
        return corr, desc, res

    (corr, desc, res), launches = run_counted(run)
    return corr, desc, large_result_to_numpy(res), launches, (r_true, t_true)


def test_synth100k_registration(synth100k):
    """<0.1 deg and <0.01 m against the planted transform; at least as many
    correspondences and as large a clique as the JAX package found. Up to
    16,384 matches the solve takes its dense branch, as in JAX: no TRIM
    kernel, the greedy clique kernel on the subgraph; kernel R for the
    rotation."""
    corr, _, res, launches, truth = synth100k
    gate = frontend_gate("synth100k", res, *truth)
    assert len(corr) >= JAX_FRONTEND_CORRESPONDENCES
    assert gate["clique_size"] >= JAX_FRONTEND_CLIQUE
    dense = len(corr) <= DENSE_N  # solve_large_sharded's blocked_threshold
    assert launches == launched(trim_bits=0 if dense else 1, greedy_clique=1, gnc_tls=1), \
        len(corr)


def plain_nn(queries, database, chunk: int = 256):
    """Exact nearest neighbour by direct differences, ties to the lowest
    index, in query chunks: per query the squared differences summed left to
    right over the descriptor axis (matcher.squared_distance's order), after
    the matcher's mean-centring."""
    center = torch.mean(database, dim=0)
    q, db = queries - center, database - center
    out = []
    for s in range(0, q.shape[0], chunk):
        d = q[s:s + chunk, None, 0] - db[None, :, 0]
        acc = d * d
        for k in range(1, q.shape[1]):
            d = q[s:s + chunk, None, k] - db[None, :, k]
            acc = acc + d * d
        out.append(torch.argmin(acc, dim=1))
    return torch.cat(out)


def test_matcher_nn_equals_a_plain_exact_nn(synth100k):
    """The first 8,192 source descriptors among all 100,000 target ones."""
    from teaserpp_tpu_torch.features.matcher import _nn_indices

    desc_src, desc_dst = synth100k[1]
    q, db = desc_src[:PARITY_QUERIES].to(torch.float32), desc_dst.to(torch.float32)
    assert torch.equal(_nn_indices(q, db), plain_nn(q, db))


@pytest.fixture(scope="module")
def grid_cloud(cuda_card):
    """A cloud of the synth100k density (8,192 points in [-0.4, 0.4]^3), its
    moved copy, its plans and its float32 normals on the CPU."""
    pts, moved, _, _ = make_frontend_pair(PARITY_N, seed=FRONTEND_SEED + 1, half_width=0.4)
    plans = build_neighbor_plans(pts, FRONTEND_RADII)
    host = estimate_normals_pruned(pts.astype(np.float32), FRONTEND_RADII[0], plans[0],
                                   device="cpu")
    return pts, moved, plans, host


def _normal_bounds(pts, radius, plan):
    """Per-row float32 bound of tests/test_torch_features.py: 64 eps32
    lambda_max / (lambda_1 - lambda_0) from the float64 covariances."""
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


def _spfh(device, pts32, normals, plan):
    """SPFH (n, 33) of the grid route on ``device``."""
    from teaserpp_tpu_torch.features import fpfh as tf
    from teaserpp_tpu_torch.features import normals as tn

    sp = tn.sorted_on_device(pts32, plan, 1e12, device, torch.float32)
    sn = tn.sorted_on_device(normals, plan, 0.0, device, torch.float32)
    rows = tn.query_rows(plan, device)
    ci = torch.as_tensor(plan.cand_idx, device=device).long()
    r2 = tn._r2_grid(plan.radius, torch.float32, device)
    spfh = tf._spfh_sorted(sp, sn, rows, ci, r2, tn.block_steps(plan))[: plan.n]
    return spfh[torch.as_tensor(plan.inv, device=device)].cpu().numpy()


def test_grid_passes_hold_to_the_cpu(grid_cloud, cuda_card):
    """The card's and the CPU's float32 normals within the tests' bound of
    the float64 run, equal validity; with shared normals, SPFH counts
    differing on at most 5% of the rows, and FPFH within 2e-3 on the rows
    (over 80%) with no such row in their radius."""
    pts, _, plans, host = grid_cloud
    x = pts.astype(np.float32)
    card = estimate_normals_pruned(x, FRONTEND_RADII[0], plans[0], device=cuda_card)
    ref64 = estimate_normals_pruned(pts, FRONTEND_RADII[0], plans[0], device="cpu")
    bound = _normal_bounds(pts, FRONTEND_RADII[0], plans[0])
    ok = ref64.valid.numpy()
    for res in (card, host):
        err = np.linalg.norm(res.normals.cpu().double().numpy() - ref64.normals.numpy(), axis=1)
        assert (err[ok] / bound[ok]).max() <= 1.0
    assert np.array_equal(card.valid.cpu().numpy(), host.valid.numpy())

    shared = host.normals
    s_card, s_host = _spfh(cuda_card, x, shared.to(cuda_card), plans[1]), _spfh(
        torch.device("cpu"), x, shared, plans[1])
    nbr = np.zeros((PARITY_N, PARITY_N), bool)
    for s in range(0, PARITY_N, 512):
        d = pts[s:s + 512, None, :] - pts[None, :, :]
        nbr[s:s + 512] = (d * d).sum(-1) <= FRONTEND_RADII[1] ** 2
    cnt = np.maximum(nbr.sum(1) - 1, 1)[:, None] / 100.0
    differ = (np.round(s_card * cnt) != np.round(s_host * cnt)).any(1)
    assert differ.mean() <= 0.05
    f_card = compute_fpfh_pruned(x, shared.to(cuda_card), FRONTEND_RADII[1], plans[1],
                                 device=cuda_card).cpu().numpy()
    f_host = compute_fpfh_pruned(x, shared, FRONTEND_RADII[1], plans[1], device="cpu").numpy()
    clean = ~(nbr & differ[None, :]).any(1)
    assert clean.mean() > 0.8 and np.abs(f_card - f_host)[clean].max() <= 2e-3


def test_matcher_correspondences_equal_the_cpu(grid_cloud, cuda_card):
    """The same CPU descriptors of both clouds through the matcher on each
    device."""
    pts, moved, plans, host = grid_cloud
    f_pts = compute_fpfh_pruned(pts.astype(np.float32), host.normals, FRONTEND_RADII[1],
                                plans[1], device="cpu").numpy()
    plans_m = build_neighbor_plans(moved, FRONTEND_RADII)
    m32 = moved.astype(np.float32)
    nm = estimate_normals_pruned(m32, FRONTEND_RADII[0], plans_m[0], device="cpu")
    f_moved = compute_fpfh_pruned(m32, nm.normals, FRONTEND_RADII[1], plans_m[1],
                                  device="cpu").numpy()
    c_card = Matcher(device=cuda_card).calculateCorrespondences(pts, moved, f_pts, f_moved)
    assert c_card == Matcher(device="cpu").calculateCorrespondences(pts, moved, f_pts, f_moved)


def patch_params():
    return RobustRegistrationSolverParams(noise_bound=PATCH_NOISE_BOUND, estimate_scaling=False,
                                          inlier_selection_mode=InlierSelectionMode.PMC_EXACT)


def teaser_gate(rotation, translation, r_true, t_true):
    """Within 0.05 rad and 0.05 of the patch's transform."""
    rot = np.asarray(rotation, np.float64)
    ang = float(np.arccos(np.clip((np.trace(rot.T @ r_true) - 1) / 2, -1, 1)))
    trans = float(np.linalg.norm(np.asarray(translation) - t_true))
    assert np.isfinite(rot).all() and ang < 0.05 and trans < 0.05, (ang, trans)


def test_fpfh_facade_teaser_and_icp(cuda_card):
    """``FPFHEstimation()`` (radii 0.1, 0.16; dense at 4,096 points),
    ``Matcher``, ``RobustRegistrationSolver`` (PMC_EXACT, noise bound 0.05)
    and ICP from its result: over 80% of the correspondences the identity,
    TEASER's gate, ICP <0.01 deg; no TRIM kernel and no greedy on this
    route, kernel R once for the facade's rotation."""
    from teaserpp_tpu_torch.solvers.icp import icp_point_to_point
    from teaserpp_tpu_torch.utils.geometry import PointCloud

    src, dst, r_true, t_true = make_patch()

    def run():
        fp = FPFHEstimation(device=cuda_card)
        sf, df = (fp.computeFPFHFeatures(c, *PATCH_RADII) for c in (src, dst))
        corr = Matcher(device=cuda_card).calculateCorrespondences(src, dst, sf, df, False, True,
                                                                  False, 0.95)
        sol = RobustRegistrationSolver(patch_params(), device=cuda_card).solve(
            PointCloud(src), PointCloud(dst), corr)
        icp = icp_point_to_point(src.T.astype(np.float32), dst.T.astype(np.float32),
                                 PATCH_NOISE_BOUND, r_init=sol.rotation, t_init=sol.translation,
                                 max_iterations=100, device=cuda_card)
        return corr, sol, icp

    (corr, sol, icp), launches = run_counted(run)
    assert launches == launched(gnc_tls=1)
    assert np.mean([i == j for i, j in corr]) > 0.8
    assert sol.valid
    teaser_gate(sol.rotation, sol.translation, r_true, t_true)
    assert rotation_error_deg(icp.rotation.cpu().double().numpy(), r_true) < 0.01


@pytest.fixture(scope="module")
def ply_files(cuda_card, tmp_path_factory):
    """PLY files of the patch and its moved copy, and of the bunny-shaped
    demo's clouds."""
    from teaserpp_tpu_torch.io import write_ply
    from teaserpp_tpu_torch.utils.geometry import PointCloud

    tmp = tmp_path_factory.mktemp("cli")
    src, dst, _, _ = make_patch()
    b_src, b_dst = make_problems(1, N_POINTS)
    paths = {}
    for name, cloud in (("src", src), ("dst", dst), ("bsrc", b_src[0].T), ("bdst", b_dst[0].T)):
        paths[name] = str(tmp / f"{name}.ply")
        write_ply(paths[name], PointCloud(cloud))
    return paths


def _fpfh_argv(paths):
    return ["--src", paths["src"], "--dst", paths["dst"], "--fpfh",
            "--normal-search-radius", str(PATCH_RADII[0]),
            "--fpfh-search-radius", str(PATCH_RADII[1]), "--noise-bound", str(PATCH_NOISE_BOUND)]


def _cli(argv) -> dict:
    root = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-m", "teaserpp_tpu_torch.cli", *argv], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_cli_fpfh(ply_files):
    """``--fpfh`` on the patch's PLY files, on the card: TEASER's gate."""
    out = _cli(_fpfh_argv(ply_files))
    _, _, r_true, t_true = make_patch()
    assert out["valid"]
    teaser_gate(out["rotation"], out["translation"], r_true, t_true)


def test_cli_bunny_demo(ply_files, cuda_card):
    """Without ``--fpfh`` on the demo's clouds: the facade's clique, <0.1 deg,
    <0.01 m."""
    out = _cli(["--src", ply_files["bsrc"], "--dst", ply_files["bdst"],
                "--noise-bound", str(NOISE_BOUND), "--rotation-cost-threshold", "0.005"])
    _, solver, _ = facade_solve(cuda_card, 1.0)
    assert out["valid"] and out["max_clique_size"] == len(solver.getInlierMaxClique())
    assert rotation_error_deg(np.asarray(out["rotation"]), T[:3, :3]) < 0.1
    assert translation_error(np.asarray(out["translation"]), T[:3, 3]) < 0.01


def test_cli_in_this_process_launches_no_kernel(ply_files):
    """``cli.main`` with ``--fpfh`` on the card: TEASER's gate, kernel R once
    (the facade's rotation) and no other launch."""
    from teaserpp_tpu_torch import cli

    _, _, r_true, t_true = make_patch()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, launches = run_counted(lambda: cli.main(_fpfh_argv(ply_files) + ["--device", "cuda"]))
    assert rc == 0 and launches == launched(gnc_tls=1)
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    teaser_gate(out["rotation"], out["translation"], r_true, t_true)
