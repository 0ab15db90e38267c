"""The port's multi-process and mesh paths on the CPU, in one world of two
gloo ranks, against the port's own ``mesh=None`` results and the JAX
package's mesh runs.

The module fixture starts the world once: this file, run as a script, is
each rank (``python tests/test_torch_mesh.py <rank> <port> <dir>``). Every
rank runs each entry point with a mesh and with ``mesh=None`` on the same
inputs and writes both to ``<dir>/rank<r>.pkl``; the tests read them.

What is held, and how closely:
* port against port: every mesh entry point equals its ``mesh=None`` result
  bit for bit on every rank (``solve_batch_sharded`` on meshes (2, 1) and
  (1, 2), each rank's half against ``solve_batch`` of that half;
  ``solve_large_sharded`` dense and on bit words, also on a (2, 1) mesh that
  replicates; ``solve_large_exact``; ``estimate_normals_pruned``,
  ``compute_fpfh_pruned`` and ``FPFHEstimation`` with a mesh, with several
  steps a rank and with all steps on one rank; the composed front end,
  matcher and sharded solve), and the two ranks agree;
* port against JAX, each package on its mesh (JAX's 8 virtual CPU devices,
  ``tests/conftest.py``): ``max_core``, clique masks and the iteration counts
  equal; rotation and translation within 1e-4 (``tests/test_torch_large.py``'s
  tolerance) on the huge-N paths and 1e-5 on the batch
  (``tests/test_torch_pipeline.py``'s); normals within 1e-9 and descriptors
  inside JAX's own facade gate (``tests/test_torch_features.py``: the two
  packages' FPFH part at pair-feature ties, so they are not held bit for
  bit against each other);
* the K1 row slab's plain version against the rows of the whole words, with
  ragged, one-row and empty slabs and invalid points.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

WORLD = 2
N_LARGE = 512
BATCH, N_BATCH = 8, 64
PATCH_M = 32
RADII = (0.2, 0.3)
FE_M = 48  # tests/test_parallel.py's composed front end
FE_RADII = (0.25, 0.4)
TOL_LARGE = 1e-4  # Frobenius (rotation) / Euclidean (translation)
TOL_BATCH = 1e-5


def _rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def large_problem(seed=12345, n=N_LARGE):
    """tests/conftest.py's make_registration_problem(n, outlier_ratio=0.8,
    noise=0.005) recipe, float32."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1.0, 1.0, size=(3, n))
    r = _rotation(rng)
    t = rng.uniform(-1.0, 1.0, size=3)
    dst = r @ src + t[:, None] + rng.normal(scale=0.005, size=(3, n))
    out = rng.choice(n, size=int(0.8 * n), replace=False)
    dst[:, out] = rng.uniform(-5.0, 5.0, size=(3, out.size))
    return src.astype(np.float32), dst.astype(np.float32), r, t


def batch_problems(seed=7):
    """Bunny-shaped problems (tests/test_torch_pipeline.py's recipe), 85%
    outliers, float32."""
    rng = np.random.default_rng(seed)
    srcs, dsts = [], []
    for _ in range(BATCH):
        src = rng.uniform(0.0, 0.15, (3, N_BATCH))
        dst = _rotation(rng) @ src + rng.uniform(-0.2, 0.2, (3, 1))
        dst += rng.uniform(-5e-4, 5e-4, dst.shape)
        idx = rng.choice(N_BATCH, size=int(0.85 * N_BATCH), replace=False)
        dst[:, idx] = rng.uniform(-1.0, 1.0, (3, idx.size))
        srcs.append(src)
        dsts.append(dst)
    return np.stack(srcs).astype(np.float32), np.stack(dsts).astype(np.float32)


def wavy(m=PATCH_M, seed=0):
    """tests/test_torch_features.py's surface."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.linspace(-1, 1, m), np.linspace(-1, 1, m))
    xs = np.sign(xs) * xs**2
    zs = 0.3 * np.sin(2.5 * xs) * np.cos(1.5 * ys) + 0.1 * np.sin(5 * xs * ys)
    pts = np.stack([xs.ravel(), ys.ravel(), zs.ravel() + 2.0], axis=1)
    return pts + rng.normal(scale=0.003, size=pts.shape)


def frontend_pair(seed=3):
    """tests/test_parallel.py's composed front end: a 48 x 48 wavy surface
    and its copy turned 0.2 rad and shifted."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.linspace(-1, 1, FE_M), np.linspace(-1, 1, FE_M))
    zs = 0.3 * np.sin(2.5 * xs) * np.cos(1.5 * ys) + 0.1 * np.sin(5 * xs * ys)
    src = np.stack([xs.ravel(), ys.ravel(), zs.ravel() + 3.0], axis=1)
    src = src + rng.normal(scale=0.002, size=src.shape)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    r = np.eye(3) + np.sin(0.2) * kx + (1 - np.cos(0.2)) * (kx @ kx)
    t = np.array([0.3, -0.2, 0.15])
    return src, src @ r.T + t, r, t


def large_params(mod):
    return mod.RobustRegistrationSolverParams(
        noise_bound=0.01, estimate_scaling=False,
        inlier_selection_mode=mod.InlierSelectionMode.KCORE_HEU, kcore_heuristic_threshold=0.0)


def batch_params(mod):
    return mod.RobustRegistrationSolverParams(
        noise_bound=0.001, cbar2=1.0, estimate_scaling=False, rotation_cost_threshold=0.005,
        inlier_selection_mode=mod.InlierSelectionMode.KCORE_HEU, kcore_heuristic_threshold=0.0)


def _numpy(x):
    """A result as {field path: numpy array}."""
    if isinstance(x, tuple):
        keys = getattr(x, "_fields", None) or [str(i) for i in range(len(x))]
        return {f"{k}.{sub}".rstrip("."): v for k, item in zip(keys, x)
                for sub, v in _numpy(item).items()}
    if isinstance(x, torch.Tensor):
        return {"": x.detach().cpu().numpy()}
    return {"": np.asarray(x)}


def _corr_points(src, dst, corr):
    ci, cj = np.asarray(corr, np.int64).reshape(-1, 2).T
    return (np.ascontiguousarray(src[ci].T).astype(np.float32),
            np.ascontiguousarray(dst[cj].T).astype(np.float32))


def rank_main(rank: int, port: int, out_dir: str) -> None:
    """One rank of the world: every mesh case beside its mesh=None run."""
    import teaserpp_tpu_torch as tp
    from teaserpp_tpu_torch.features import (
        FPFHEstimation, Matcher, build_neighbor_plans, compute_fpfh_pruned,
        estimate_normals_pruned)
    from teaserpp_tpu_torch.features import normals as t_normals
    from teaserpp_tpu_torch.parallel import solve_batch_sharded
    from teaserpp_tpu_torch.parallel.multihost import Mesh, initialize_distributed, make_mesh

    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", WORLD, rank, backend="gloo", timeout_s=120)
    pairs = make_mesh(pairs_per_host=2)  # (1, 2): pairs over both ranks
    batch = make_mesh(pairs_per_host=1)  # (2, 1): batch over both ranks
    blocks = Mesh(np.arange(WORLD), ("blocks",))
    cpu = dict(device="cpu")
    res = {"meshes": {"pairs": pairs.shape, "batch": batch.shape, "coords": pairs.coords}}

    def both(name, fn, mesh):
        res[name] = {"mesh": _numpy(fn(mesh)), "none": _numpy(fn(None))}

    src, dst, _, _ = large_problem()
    lp = large_params(tp)
    for name, threshold in (("large_dense", 16384), ("large_blocked", 64)):
        both(name, lambda m: tp.solve_large_sharded(
            src, dst, lp, mesh=m, subgraph_size=256, blocked_threshold=threshold, **cpu), pairs)
    both("large_blocked_2x1", lambda m: tp.solve_large_sharded(
        src, dst, lp, mesh=m, subgraph_size=256, blocked_threshold=64, **cpu), batch)
    both("exact", lambda m: tp.solve_large_exact(src, dst, lp, mesh=m, num_threads=1, **cpu),
         pairs)

    bsrc, bdst = batch_problems()
    bp = batch_params(tp)
    for name, mesh in (("batch_2x1", batch), ("batch_1x2", pairs)):
        res[name] = {"mesh": _numpy(solve_batch_sharded(bsrc, bdst, bp, mesh, **cpu)),
                     "none": _numpy(tp.solve_batch(bsrc, bdst, bp, **cpu))}
        half = slice(BATCH // 2 * batch.coords["batch"], BATCH // 2 * (batch.coords["batch"] + 1))
        if name == "batch_2x1":
            res[name]["own_half"] = _numpy(tp.solve_batch(bsrc[half], bdst[half], bp, **cpu))

    try:  # an uneven batch is refused on every rank, before any collective
        solve_batch_sharded(bsrc[:BATCH - 1], bdst[:BATCH - 1], bp, batch, **cpu)
    except ValueError as exc:
        res["uneven_batch"] = str(exc)

    pts = wavy()
    plans = build_neighbor_plans(pts, RADII, block=64, pad_multiple=64)
    # small steps: several a rank, the last one ragged, so the ranks' shares
    # are cut at step boundaries that are not the halves of the blocks
    default_step = t_normals.PAIRS_PER_STEP
    t_normals.PAIRS_PER_STEP = 3 * plans[0].block * plans[1].mpad
    both("normals", lambda m: estimate_normals_pruned(pts, RADII[0], plans[0], mesh=m, **cpu),
         blocks)
    normals = estimate_normals_pruned(pts, RADII[0], plans[0], **cpu).normals
    both("fpfh", lambda m: compute_fpfh_pruned(pts, normals, RADII[1], plans[1], mesh=m, **cpu),
         blocks)
    res["steps"] = [len(t_normals.mesh_steps(p, blocks)[0]) for p in plans]
    t_normals.PAIRS_PER_STEP = default_step
    res["default_steps"] = [len(t_normals.mesh_steps(p, blocks)[0]) for p in plans]

    def facade(m):
        est = FPFHEstimation(neighbor_mode="grid", mesh=m, dtype=torch.float64, **cpu)
        return est.computeFPFHFeatures(pts, *RADII), torch.as_tensor(est.getNormals())
    both("facade", facade, blocks)

    fsrc, fdst, _, _ = frontend_pair()

    def frontend(m):
        est = FPFHEstimation(neighbor_mode="grid", mesh=m and blocks, **cpu)
        ds, dd = (est.computeFPFHFeatures(c, *FE_RADII) for c in (fsrc, fdst))
        corr = Matcher(**cpu).calculateCorrespondences(fsrc, fdst, ds, dd, False, True,
                                                       False, 0.0)
        sol = tp.solve_large_sharded(*_corr_points(fsrc, fdst, corr), lp, mesh=m,
                                     subgraph_size=256, **cpu)
        return np.asarray(corr, np.int64), ds, dd, sol
    both("frontend", frontend, pairs)

    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    sys.exit(0)


# --- the tests (pytest process) --------------------------------------------

from teaserpp_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from teaserpp_tpu_torch.parallel.multihost import Mesh, make_mesh, require_mesh  # noqa: E402

RANKS = pytest.mark.parametrize("rank", range(WORLD))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world_procs(tmp_path_factory):
    """Start one world of two gloo processes; yields (processes, output dir).
    The JAX references are computed while it runs (``jax_refs``)."""
    out = tmp_path_factory.mktemp("mesh_world")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(port),
                               str(out)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    try:
        yield procs, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def world(world_procs, jax_refs):
    """Both ranks' results. A world that hangs is killed by the timeout."""
    procs, out = world_procs
    logs = [p.communicate(timeout=150) for p in procs]
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, f"rank failed (rc={p.returncode}):\n{err[-4000:]}"
    results = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _bits_equal(got: dict, want: dict) -> list:
    """Fields of two flattened results that differ in dtype, shape or bits."""
    assert set(got) == set(want)
    return [k for k in got if got[k].dtype != want[k].dtype or got[k].shape != want[k].shape
            or got[k].tobytes() != want[k].tobytes()]


MESH_CASES = ["large_dense", "large_blocked", "large_blocked_2x1", "exact", "batch_1x2",
              "normals", "fpfh", "facade", "frontend"]


@RANKS
@pytest.mark.parametrize("case", MESH_CASES)
def test_mesh_equals_mesh_none_bit_for_bit(world, case, rank):
    got = world[rank][case]
    assert _bits_equal(got["mesh"], got["none"]) == []
    # every rank returns the same result
    assert _bits_equal(got["mesh"], world[0][case]["mesh"]) == []


@RANKS
def test_solve_batch_sharded_halves(world, rank):
    """On (2, 1) each rank solves its half; the gathered batch holds both
    halves as each rank's solve_batch of its half gives them, bit for bit,
    and equals solve_batch of the whole batch."""
    case = world[rank]["batch_2x1"]
    half = slice(BATCH // 2 * rank, BATCH // 2 * (rank + 1))
    own = case["own_half"]
    sliced = {k: v[half] for k, v in case["mesh"].items()}
    assert _bits_equal(sliced, own) == []
    other = world[1 - rank]["batch_2x1"]["own_half"]
    half_o = slice(BATCH // 2 * (1 - rank), BATCH // 2 * (2 - rank))
    assert _bits_equal({k: v[half_o] for k, v in case["mesh"].items()}, other) == []
    assert _bits_equal(case["mesh"], case["none"]) == []


@RANKS
def test_solve_batch_sharded_refuses_an_uneven_batch(world, rank):
    assert "pad_problems" in world[rank]["uneven_batch"]


def test_solve_batch_sharded_needs_a_mesh():
    import teaserpp_tpu_torch as tp
    from teaserpp_tpu_torch.parallel import solve_batch_sharded

    src, dst = batch_problems()
    with pytest.raises(TypeError, match="Mesh"):
        solve_batch_sharded(src, dst, batch_params(tp), None, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        solve_batch_sharded(src, dst, batch_params(tp), object(), device="cpu")


def test_world_layout(world):
    assert world[0]["meshes"]["pairs"] == {"batch": 1, "pairs": 2}
    assert world[0]["meshes"]["batch"] == {"batch": 2, "pairs": 1}
    assert [w["meshes"]["coords"]["pairs"] for w in world] == [0, 1]
    # the small-step run split the blocks' steps over both ranks; at the
    # default step one rank holds every step and the other none
    for p in range(2):
        assert world[0]["steps"][p] > 1 and world[1]["steps"][p] > 1
        assert sorted(w["default_steps"][p] for w in world)[0] == 0


def test_frontend_registers(world):
    """tests/test_parallel.py's gate on the composed mesh run."""
    _, _, r, t = frontend_pair()
    got = world[0]["frontend"]["mesh"]
    assert got["0"].shape[0] > 500  # correspondences
    rot = got["3.solution.rotation"].astype(np.float64)
    ang = np.arccos(np.clip((np.trace(r.T @ rot) - 1) / 2, -1, 1))
    assert ang < 0.02
    assert np.linalg.norm(got["3.solution.translation"] - t) < 0.02
    assert bool(got["3.solution.valid"])


# --- against the JAX package's mesh runs -----------------------------------

def _jax_mesh(shape, names):
    import jax
    from jax.sharding import Mesh as JMesh

    return JMesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)


@pytest.fixture(scope="module")
def jax_refs(world_procs):
    """The JAX package's mesh runs of the same inputs, as numpy, computed
    while the world runs."""
    from teaserpp_tpu import params as jp
    from teaserpp_tpu.features import FPFHEstimation as JFPFHEstimation
    from teaserpp_tpu.parallel import solve_batch_sharded, solve_large_exact, solve_large_sharded
    from teaserpp_tpu_torch.convert import large_result_to_numpy, solution_to_numpy

    src, dst, _, _ = large_problem()
    pairs = _jax_mesh((1, 8), ("batch", "pairs"))
    refs = {name: large_result_to_numpy(solve_large_sharded(
        src, dst, large_params(jp), pairs, subgraph_size=256, blocked_threshold=threshold))
        for name, threshold in (("large_dense", 16384), ("large_blocked", 64))}
    refs["exact"] = large_result_to_numpy(solve_large_exact(
        src, dst, large_params(jp), _jax_mesh((8,), ("pairs",)), num_threads=1))
    bsrc, bdst = batch_problems()
    refs["batch"] = solution_to_numpy(solve_batch_sharded(
        bsrc, bdst, batch_params(jp), _jax_mesh((4, 2), ("batch", "pairs"))))
    est = JFPFHEstimation(neighbor_mode="grid", mesh=_jax_mesh((8,), ("blocks",)))
    refs["facade"] = (est.computeFPFHFeatures(wavy(), *RADII), np.asarray(est.getNormals()))
    return refs


@pytest.mark.parametrize("case", ["large_dense", "large_blocked", "exact"])
def test_large_paths_match_jax_mesh(world, jax_refs, case):
    ref = jax_refs[case]
    got = world[0][case]["mesh"]
    assert int(got["max_core"]) == int(ref.max_core)
    assert int(got["clique_size"]) == int(ref.clique_size)
    np.testing.assert_array_equal(got["solution.clique_mask"], ref.solution.clique_mask)
    np.testing.assert_array_equal(got["solution.valid"], ref.solution.valid)
    assert np.linalg.norm(got["solution.rotation"] - ref.solution.rotation) < TOL_LARGE
    assert np.linalg.norm(got["solution.translation"] - ref.solution.translation) < TOL_LARGE


def test_solve_batch_sharded_matches_jax_mesh(world, jax_refs):
    ref = jax_refs["batch"]
    got = world[0]["batch_2x1"]["mesh"]
    for field in ("clique_mask", "valid", "rotation_iterations", "rotation_inlier_mask",
                  "translation_inlier_mask"):
        np.testing.assert_array_equal(got[field], getattr(ref, field), field)
    for p in range(BATCH):
        assert np.linalg.norm(got["rotation"][p] - ref.rotation[p]) < TOL_BATCH
        assert np.linalg.norm(got["translation"][p] - ref.translation[p]) < TOL_BATCH


def test_features_match_jax_mesh(world, jax_refs):
    """Normals within 1e-9 of JAX's mesh run (float64); the descriptors inside
    JAX's facade gate (the module docstring)."""
    want, want_normals = jax_refs["facade"]
    got, normals = world[0]["facade"]["mesh"]["0"], world[0]["facade"]["mesh"]["1"]
    pts = wavy()
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    assert (d2 <= RADII[0] ** 2).sum(1).min() >= 3  # every normal is defined
    assert np.abs(normals - want_normals).max() <= 1e-9
    err = np.abs(got - want)
    assert (err > 1e-6).mean() < 0.05
    assert err.mean() < 0.02


# --- without a world ---------------------------------------------------------

@pytest.mark.parametrize("rows", [(0, 17), (3, 9), (16, 17), (5, 6), (7, 7), (0, 0), (17, 17)],
                         ids=["all", "middle", "ragged-last", "one-row", "empty", "empty-0",
                              "empty-end"])
def test_trim_bits_slab_plain_equals_whole_rows(rows):
    """N = 530: 17 word rows, the last holding 18 points; scattered invalid
    points and a duplicated one."""
    rng = np.random.default_rng(4)
    src = torch.tensor(rng.uniform(-1, 1, (2, 3, 530)), dtype=torch.float32)
    dst = src + torch.tensor(rng.uniform(-0.01, 0.01, (2, 3, 530)), dtype=torch.float32)
    dst[:, :, ::3] = torch.tensor(rng.uniform(-1, 1, (2, 3, 177)), dtype=torch.float32)
    src[:, :, 40], dst[:, :, 40] = src[:, :, 7], dst[:, :, 7]
    valid = torch.tensor(rng.random((2, 530)) < 0.8)
    whole = ck.trim_bits(src, dst, valid, 0.02)
    w0, w1 = rows
    slab = ck.trim_bits(src, dst, valid, 0.02, rows=rows)
    assert slab.shape == (2, w1 - w0, 530) and slab.dtype == torch.int32
    assert torch.equal(slab, whole[:, w0:w1])
    assert torch.equal(ck.trim_adjacency_bits_plain(src, dst, valid, 0.02, rows=rows), slab)


def test_trim_bits_slab_refuses_rows_outside():
    src = torch.zeros((1, 3, 70))
    valid = torch.ones((1, 70), dtype=torch.bool)
    for rows in ((0, 4), (2, 1), (-1, 2)):
        with pytest.raises(ValueError, match="word rows"):
            ck.trim_bits(src, src, valid, 0.1, rows=rows)


def test_slab_degrees_sum_to_whole():
    """Partial degrees of the slabs of P ranks sum to the whole words'."""
    from teaserpp_tpu_torch.clique.kcore import active_degrees
    from teaserpp_tpu_torch.parallel.multihost import shard_range

    src, dst, _, _ = large_problem(n=300)
    s, d = torch.tensor(src[None]), torch.tensor(dst[None])
    valid = torch.ones((1, 300), dtype=torch.bool)
    whole = ck.trim_bits(s, d, valid, 0.02)
    active = torch.tensor(np.random.default_rng(0).random((1, 300)) < 0.6)
    want = active_degrees(whole, active)
    for parts in (2, 3, 4):
        total = torch.zeros_like(want)
        for r in range(parts):
            w0, w1 = shard_range(10, parts, r)
            total += active_degrees(ck.trim_bits(s, d, valid, 0.02, rows=(w0, w1)), active, w0)
        assert torch.equal(total, want)


def test_mesh_without_a_world_is_the_identity():
    """No process group: make_mesh gives (1, 1) and every collective is an
    identity, so a mesh run is the mesh=None run."""
    import teaserpp_tpu_torch as tp

    mesh = make_mesh()
    assert mesh.shape == {"batch": 1, "pairs": 1} and mesh.coords == {"batch": 0, "pairs": 0}
    assert mesh.devices.shape == (1, 1)
    x = torch.arange(6).reshape(2, 3)
    for out in (mesh.all_reduce(x, "pairs"), mesh.all_reduce(x, "pairs", op="max"),
                mesh.all_gather(x, "batch", dim=1), mesh.broadcast(x, "pairs")):
        assert torch.equal(out, x)
    src, dst, _, _ = large_problem(n=200)
    params = large_params(tp)
    got = tp.solve_large_sharded(src, dst, params, mesh=mesh, blocked_threshold=64,
                                 device="cpu")
    want = tp.solve_large_sharded(src, dst, params, blocked_threshold=64, device="cpu")
    assert _bits_equal(_numpy(got), _numpy(want)) == []
    assert require_mesh(None) is None and require_mesh(mesh) is mesh
    with pytest.raises(TypeError, match="Mesh"):
        require_mesh(object())
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.zeros((1, 1), np.int64), ("batch",))


def test_initialize_distributed_single_process_is_a_no_op():
    from teaserpp_tpu_torch.parallel.multihost import initialize_distributed

    for n in (None, 0, 1):
        initialize_distributed("localhost:1", n, 0)
    assert not torch.distributed.is_initialized()


SHARED_CARD_RANK = r"""
import sys, types
import torch
from teaserpp_tpu_torch.parallel import multihost as mh
# a host with one card, as the ranks see it
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
torch.cuda.get_device_properties = lambda i: types.SimpleNamespace(uuid="GPU-one")
try:
    mh.initialize_distributed(sys.argv[1], 2, int(sys.argv[2]), timeout_s=30)
except RuntimeError as exc:
    print("refused:", exc)
    sys.exit(0)
sys.exit(1)
"""


def test_nccl_on_a_shared_card_is_refused_on_every_rank():
    """Two ranks on a host with one card and the default backend (NCCL):
    both raise, naming the cause and gloo, before NCCL sees the card; the
    store's rank waits until the other has read, so neither hangs."""
    address = f"localhost:{_free_port()}"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", SHARED_CARD_RANK, address, str(r)], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert "Duplicate GPU" in out and "gloo" in out


def test_initialize_distributed_takes_no_backend_it_cannot_run(monkeypatch):
    """NCCL, the default, needs a card for every rank: without CUDA it
    raises and names gloo, and never falls back to it by itself."""
    from teaserpp_tpu_torch.parallel.multihost import initialize_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in (None, "nccl"):
        with pytest.raises(RuntimeError, match="gloo"):
            initialize_distributed(f"localhost:{_free_port()}", 2, 0, backend=backend)
    with pytest.raises(ValueError, match="coordinator_address"):
        initialize_distributed(None, 2, 0, backend="gloo")
    assert not torch.distributed.is_initialized()
