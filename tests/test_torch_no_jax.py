"""The port stands alone: no import of JAX or of the JAX package, CPU solves
(batched known and unknown scale, the batched greedy clique, huge-N, exact,
the facade, ICP), PLY I/O and the FPFH front end, matcher and command-line
tool and the DRS certifier with JAX blocked, the mesh paths on a (1, 1)
mesh with JAX blocked, its own native clique library, and no silent fallback
to the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from teaserpp_tpu_torch import (
    RobustRegistrationSolver,
    RobustRegistrationSolverParams,
    solve_batch,
    solve_large_exact,
    solve_large_sharded,
)
from teaserpp_tpu_torch.clique.graph import MaxCliqueSolver
from teaserpp_tpu_torch.device import resolve_device
from teaserpp_tpu_torch.features import (
    FPFHEstimation,
    Matcher,
    build_neighbor_plans,
    compute_fpfh_pruned,
    estimate_normals_pruned,
)
from teaserpp_tpu_torch.solvers.icp import icp_point_to_point

ROOT = pathlib.Path(__file__).resolve().parent.parent
# The port, and the files that run it on the card, which run where JAX is not
PORT_FILES = (sorted((ROOT / "teaserpp_tpu_torch").rglob("*.py"))
              + [ROOT / "tests" / "chip_support.py", ROOT / "tests" / "test_torch_tls_sweep.py",
                 ROOT / "scripts" / "torch_kernel_times.py"]
              + sorted((ROOT / "tests").glob("test_torch_chip_*.py")))


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "teaserpp_tpu"), f"{path}: imports {mod}"


SOLVE_WITH_JAX_BLOCKED = r"""
import sys
sys.modules["jax"] = None
sys.modules["teaserpp_tpu"] = None
import numpy as np, torch
torch.set_num_threads(1)
from teaserpp_tpu_torch import (InlierSelectionMode, RobustRegistrationSolver,
                                RobustRegistrationSolverParams, solve_batch,
                                solve_large_exact, solve_large_sharded)
rng = np.random.default_rng(0)
src = rng.uniform(0, 0.15, (2, 3, 64))
dst = src + np.array([0.1, -0.2, 0.05])[:, None] + rng.uniform(-5e-4, 5e-4, src.shape)
dst[:, :, :20] = rng.uniform(-1, 1, (2, 3, 20))
params = RobustRegistrationSolverParams(
    noise_bound=0.001, estimate_scaling=False, rotation_cost_threshold=0.005,
    inlier_selection_mode=InlierSelectionMode.KCORE_HEU, kcore_heuristic_threshold=0.0)
sol = solve_batch(src, dst, params, device="cpu")
assert np.abs(sol.rotation.numpy() - np.eye(3)).max() < 1e-2
large = solve_large_sharded(src[0], dst[0], params, subgraph_size=32,
                            blocked_threshold=16, device="cpu")
exact = solve_large_exact(src[0], dst[0], params, num_threads=1, device="cpu")
for res in (large, exact):
    assert np.abs(res.solution.rotation.numpy() - np.eye(3)).max() < 1e-2
assert int(exact.clique_size) >= int(large.clique_size)
scaled = solve_batch(src, 1.5 * dst, params.replace(estimate_scaling=True), device="cpu")
assert np.abs(scaled.scale.numpy() - 1.5).max() < 1e-2
greedy = solve_batch(src, dst, params.replace(
    inlier_selection_mode=InlierSelectionMode.PMC_HEU), device="cpu")
assert np.abs(greedy.rotation.numpy() - np.eye(3)).max() < 1e-2
assert greedy.clique_mask.sum(-1).min() >= 40

import tempfile
from teaserpp_tpu_torch.io import read_ply, write_ply
from teaserpp_tpu_torch.solvers.icp import icp_point_to_point
from teaserpp_tpu_torch.utils.geometry import PointCloud
with tempfile.TemporaryDirectory() as tmp:
    write_ply(tmp + "/c.ply", PointCloud(src[0].T))
    cloud = read_ply(tmp + "/c.ply")
assert np.allclose(cloud.as_matrix(), src[0], atol=1e-6)
icp = icp_point_to_point(cloud.as_matrix(), src[0] + 0.01, 0.05, device="cpu")
assert np.abs(icp.translation.numpy() - 0.01).max() < 1e-4
facade = RobustRegistrationSolver(noise_bound=0.001, rotation_cost_threshold=0.005,
                                  device="cpu")
sol = facade.solve(src[0], 1.5 * dst[0])
assert sol.valid and abs(sol.scale - 1.5) < 1e-2 and len(facade.getInlierMaxClique()) >= 40

# the FPFH front end (grid plans and the facade), the matcher and the CLI
import contextlib, io, json
from teaserpp_tpu_torch import cli
from teaserpp_tpu_torch.features import (FPFHEstimation, Matcher, build_neighbor_plans,
                                         compute_fpfh_pruned, estimate_normals_pruned)
xs, ys = np.meshgrid(np.linspace(-1, 1, 16), np.linspace(-1, 1, 16))
patch = np.stack([xs.ravel(), ys.ravel(), 0.3 * np.sin(2.5 * xs.ravel()) + 3.0], axis=1)
moved = patch + np.array([0.2, -0.1, 0.05])
plans = build_neighbor_plans(patch, (0.3, 0.45), block=64, pad_multiple=64)
nres = estimate_normals_pruned(patch, 0.3, plans[0], device="cpu")
desc = compute_fpfh_pruned(patch, nres.normals, 0.45, plans[1], device="cpu")
assert desc.shape == (256, 33) and bool(torch.isfinite(desc).all())
fp = FPFHEstimation(device="cpu")
corr = Matcher(device="cpu").calculateCorrespondences(
    patch, moved, fp.computeFPFHFeatures(patch, 0.3, 0.45),
    fp.computeFPFHFeatures(moved, 0.3, 0.45), False, True, False, 0.0)
assert np.mean([i == j for i, j in corr]) > 0.8
with tempfile.TemporaryDirectory() as tmp:
    write_ply(tmp + "/a.ply", PointCloud(patch))
    write_ply(tmp + "/b.ply", PointCloud(moved))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["--src", tmp + "/a.ply", "--dst", tmp + "/b.ply", "--fpfh",
                       "--normal-search-radius", "0.3", "--fpfh-search-radius", "0.45",
                       "--noise-bound", "0.05", "--device", "cpu"])
assert rc == 0
res = json.loads(out.getvalue().strip().splitlines()[-1])
assert res["valid"] and np.abs(np.asarray(res["translation"]) - [0.2, -0.1, 0.05]).max() < 1e-2

# the DRS certifier, DENSE and ITERATIVE, and a checkpointed run
from teaserpp_tpu_torch import DRSCertifier, DRSCertifierParams, EigSolverType
from teaserpp_tpu_torch.certification.drs import certify_batch, certify_checkpointed
q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
q *= np.sign(np.linalg.det(q))
v1 = rng.uniform(-1, 1, (3, 10))
v2 = q @ v1
v2[:, 9] = 5.0
theta = np.r_[np.ones(9), -1.0]
for solver in (EigSolverType.DENSE, EigSolverType.ITERATIVE):
    cert = DRSCertifier(noise_bound=0.01, eig_decomposition_solver=solver, device="cpu")
    assert cert.certify(q, v1, v2, theta).is_optimal
assert certify_batch(q[None], v1[None], v2[None], theta[None], device="cpu")[0].is_optimal
with tempfile.TemporaryDirectory() as tmp:
    assert certify_checkpointed(q, v1, v2, theta, checkpoint_path=tmp + "/c.npz",
                                device="cpu").is_optimal
assert "jaxlib" not in sys.modules

# the exact search ran in the port's own library: nothing of the JAX package's
# native directory is mapped into this process
import pathlib
from teaserpp_tpu_torch.ops import _build
mapped = [line.split()[-1] for line in open("/proc/self/maps") if "maxclique" in line]
assert mapped, "the native clique library is not loaded"
assert all(pathlib.Path(m).parent == _build.BUILD_DIR for m in mapped), mapped
print("solved")
"""


def _jax_native_dir_state():
    native = ROOT / "teaserpp_tpu" / "clique" / "native"
    return {p.name: (p.stat().st_mtime_ns, p.stat().st_size) for p in native.iterdir()}


def test_cpu_solve_with_jax_blocked():
    """Batched, huge-N and exact solves, the front end and the CLI run with
    JAX and the JAX package unimportable, and the exact search neither loads
    nor rebuilds the JAX package's ``clique/native/libmaxclique.so``."""
    before = _jax_native_dir_state()
    proc = subprocess.run(
        [sys.executable, "-c", SOLVE_WITH_JAX_BLOCKED],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("solved")
    assert _jax_native_dir_state() == before


MESH_SOLVE_WITH_JAX_BLOCKED = r"""
import sys
sys.modules["jax"] = None
sys.modules["teaserpp_tpu"] = None
import numpy as np, torch
torch.set_num_threads(1)
from teaserpp_tpu_torch import (InlierSelectionMode, RobustRegistrationSolverParams,
                                solve_large_sharded)
from teaserpp_tpu_torch.parallel import solve_batch_sharded
from teaserpp_tpu_torch.parallel.multihost import make_mesh
rng = np.random.default_rng(1)
src = rng.uniform(-1, 1, (3, 200))
dst = src + np.array([0.1, -0.2, 0.05])[:, None] + rng.uniform(-5e-3, 5e-3, src.shape)
dst[:, :120] = rng.uniform(-3, 3, (3, 120))
params = RobustRegistrationSolverParams(
    noise_bound=0.01, estimate_scaling=False,
    inlier_selection_mode=InlierSelectionMode.KCORE_HEU, kcore_heuristic_threshold=0.0)
mesh = make_mesh()
assert mesh.shape == {"batch": 1, "pairs": 1}
for threshold in (64, 16384):
    got = solve_large_sharded(src, dst, params, mesh=mesh, blocked_threshold=threshold,
                              device="cpu")
    want = solve_large_sharded(src, dst, params, blocked_threshold=threshold, device="cpu")
    assert torch.equal(got.solution.rotation, want.solution.rotation)
    assert torch.equal(got.solution.clique_mask, want.solution.clique_mask)
    assert np.abs(got.solution.rotation.numpy() - np.eye(3)).max() < 1e-2
from teaserpp_tpu_torch import solve_batch
sol = solve_batch_sharded(src[None], dst[None], params, mesh, device="cpu")
ref = solve_batch(src[None], dst[None], params, device="cpu")
assert all(torch.equal(a, b) for a, b in zip(sol, ref))
assert "jaxlib" not in sys.modules
print("solved")
"""


def test_mesh_solve_with_jax_blocked():
    """solve_large_sharded (both branches) and solve_batch_sharded on a (1, 1)
    mesh, with JAX and the JAX package unimportable: the mesh=None result."""
    proc = subprocess.run(
        [sys.executable, "-c", MESH_SOLVE_WITH_JAX_BLOCKED],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("solved")


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    params = RobustRegistrationSolverParams(estimate_scaling=False)
    params = params.replace(inlier_selection_mode=params.inlier_selection_mode.KCORE_HEU,
                            kcore_heuristic_threshold=0.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_batch(np.zeros((1, 3, 8)), np.zeros((1, 3, 8)), params, device=None)
    for solve in (solve_large_sharded, solve_large_exact):
        with pytest.raises(RuntimeError, match="CUDA"):
            solve(np.zeros((3, 8)), np.zeros((3, 8)), params, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        icp_point_to_point(np.zeros((3, 8)), np.zeros((3, 8)), 0.1)
    for build in (lambda: RobustRegistrationSolver(params), MaxCliqueSolver, Matcher,
                  FPFHEstimation):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    from teaserpp_tpu_torch import DRSCertifier
    from teaserpp_tpu_torch.certification.drs import certify_batch, certify_checkpointed

    with pytest.raises(RuntimeError, match="CUDA"):
        DRSCertifier().certify(np.eye(3), np.ones((3, 4)), np.ones((3, 4)), np.ones(4))
    with pytest.raises(RuntimeError, match="CUDA"):
        certify_batch(np.eye(3)[None], np.ones((1, 3, 4)), np.ones((1, 3, 4)), np.ones((1, 4)))
    with pytest.raises(RuntimeError, match="CUDA"):
        certify_checkpointed(np.eye(3), np.ones((3, 4)), np.ones((3, 4)), np.ones(4))
    pts = np.random.default_rng(0).uniform(size=(64, 3))
    plans = build_neighbor_plans(pts, (0.3, 0.4), block=32, pad_multiple=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        estimate_normals_pruned(pts, 0.3, plans[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_fpfh_pruned(pts, np.zeros((64, 3)), 0.4, plans[1])
    assert resolve_device("cpu") == torch.device("cpu")
