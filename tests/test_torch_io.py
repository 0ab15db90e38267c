"""Port parity for the host-side surface: PLY (binary and ASCII) and PCD
files written by one package and read by the other, batch results files
across the two packages, the point containers and helpers, the facade's
cloud + correspondence overload on the port's ``PointCloud``, ``trace_to``
and the package exports. Files are generated here from a seed (the bunny PLY
is not in the repo)."""

import json
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import teaserpp_tpu
import teaserpp_tpu_torch
from teaserpp_tpu.io import ply as jply
from teaserpp_tpu.io.pcd import read_pcd as j_read_pcd
from teaserpp_tpu.parallel import results_io as jresults
from teaserpp_tpu.solvers.pipeline import PipelineSolution as JPipelineSolution
from teaserpp_tpu.utils import geometry as jgeom
from teaserpp_tpu.utils import helpers as jhelpers
from teaserpp_tpu_torch import RobustRegistrationSolver, RobustRegistrationSolverParams
from teaserpp_tpu_torch.io import PLYReader, PLYWriter, read_ply, write_ply
from teaserpp_tpu_torch.io.pcd import read_pcd
from teaserpp_tpu_torch.parallel import results_io
from teaserpp_tpu_torch.parallel.batch import solve_batch
from teaserpp_tpu_torch.solvers.pipeline import PipelineSolution
from teaserpp_tpu_torch.utils import geometry as tgeom
from teaserpp_tpu_torch.utils import helpers as thelpers
from teaserpp_tpu_torch.utils.timing import trace_to

torch.set_num_threads(1)

PACKAGES = {"port": (write_ply, read_ply, tgeom.PointCloud),
            "jax": (jply.write_ply, jply.read_ply, jgeom.PointCloud)}


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_ply_across_packages(tmp_path, rng, binary, writer, reader):
    pts = rng.normal(size=(123, 3))
    path = str(tmp_path / "c.ply")
    write, _, cloud_cls = PACKAGES[writer]
    assert write(path, cloud_cls(pts), binary=binary) == 0
    loaded = PACKAGES[reader][1](path)
    assert isinstance(loaded, PACKAGES[reader][2])
    # float32 storage; the two packages read the same bits
    np.testing.assert_allclose(loaded.points, pts, atol=1e-5)
    np.testing.assert_array_equal(loaded.points, jply.read_ply(path).points)
    assert pathlib.Path(path).read_bytes().startswith(b"ply\nformat " + (
        b"binary_little_endian" if binary else b"ascii"))


def test_ply_reader_writer_facades(tmp_path, rng):
    pts = rng.normal(size=(10, 3))
    path = str(tmp_path / "c.ply")
    assert PLYWriter().write(path, tgeom.PointCloud(pts)) == 0
    out = tgeom.PointCloud()
    assert PLYReader().read(path, out) == 0
    np.testing.assert_array_equal(out.points, jply.read_ply(path).points)
    assert PLYReader().read(str(tmp_path / "missing.ply"), out) == -1


def _write_pcd(path, pts, binary):
    """A PCD file with x y z and an extra rgb field, as PCL writes them."""
    n = pts.shape[0]
    header = ("# .PCD v0.7\nVERSION 0.7\nFIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F U\n"
              f"COUNT 1 1 1 1\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
              f"DATA {'binary' if binary else 'ascii'}\n")
    rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("rgb", "<u4")])
    rec["x"], rec["y"], rec["z"] = pts.T.astype(np.float32)
    rec["rgb"] = np.arange(n)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(rec.tobytes())
        else:
            for r in rec:
                f.write(f"{r['x']:.9g} {r['y']:.9g} {r['z']:.9g} {r['rgb']}\n".encode())


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_pcd_read_matches_jax(tmp_path, rng, binary):
    pts = rng.uniform(-1, 1, (57, 3))
    path = str(tmp_path / "c.pcd")
    _write_pcd(path, pts, binary)
    got = read_pcd(path)
    assert isinstance(got, tgeom.PointCloud) and len(got) == 57
    np.testing.assert_array_equal(got.points, j_read_pcd(path).points)
    np.testing.assert_allclose(got.points, pts, atol=1e-6)


def _port_solution():
    rng = np.random.default_rng(3)
    src = rng.uniform(0, 0.15, (2, 3, 64)).astype(np.float32)
    dst = (src + np.array([0.1, -0.2, 0.05], np.float32)[:, None]).astype(np.float32)
    dst[:, :, :16] = rng.uniform(-1, 1, (2, 3, 16))
    params = RobustRegistrationSolverParams(noise_bound=0.001, estimate_scaling=True)
    return solve_batch(src, dst, params, device="cpu")


def test_results_files_across_packages(tmp_path):
    sol = _port_solution()
    host = [v.numpy() for v in sol]
    # the port's file, read by both packages
    path = str(tmp_path / "port.npz")
    results_io.save_batch_results(path, sol)
    for loaded, cls in ((results_io.load_batch_results(path), PipelineSolution),
                        (jresults.load_batch_results(path), JPipelineSolution)):
        assert type(loaded) is cls and loaded._fields == PipelineSolution._fields
        for name, want, got in zip(PipelineSolution._fields, host, loaded):
            assert isinstance(got, np.ndarray), name
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, name)
    # the JAX package's file, read by the port
    jpath = str(tmp_path / "jax.npz")
    jresults.save_batch_results(jpath, JPipelineSolution(*[jnp.asarray(v) for v in host]))
    back = results_io.load_batch_results(jpath)
    for name, want, got in zip(PipelineSolution._fields, host, back):
        np.testing.assert_array_equal(got, want, name)


def test_trace_to_writes_a_trace(tmp_path):
    with trace_to(str(tmp_path)):
        torch.ones(64).cumprod(0).sum()
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("cumprod" in e.get("name", "") for e in events)
    for off in (None, ""):  # no trace, nothing written
        with trace_to(off):
            torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == traces


def test_point_cloud_container_matches_jax():
    clouds = [tgeom.PointCloud(), jgeom.PointCloud()]
    for c, xyz in zip(clouds, (tgeom.PointXYZ, jgeom.PointXYZ)):
        assert c.empty() and len(c) == 0
        c.push_back(xyz(1, 2, 3))
        c.push_back((4, 5, 6))
    port, jax_c = clouds
    assert port.size() == jax_c.size() == 2
    assert tuple(port.at(0)) == tuple(jax_c.at(0)) == (1.0, 2.0, 3.0)
    np.testing.assert_array_equal(port.as_matrix(), jax_c.as_matrix())
    assert [tuple(p) for p in port] == [tuple(p) for p in jax_c]
    m = np.arange(12.0).reshape(3, 4)  # 3xN in, (N, 3) held, as in JAX
    np.testing.assert_array_equal(tgeom.PointCloud.from_matrix(m).points,
                                  jgeom.PointCloud.from_matrix(m).points)
    port.clear()
    assert port.empty()


def test_helpers_match_jax():
    m = np.arange(12).reshape(3, 4).astype(float)
    for fn in ("remove_row", "remove_column"):
        for i in (0, 1, 9):
            np.testing.assert_array_equal(getattr(thelpers, fn)(m, i), getattr(jhelpers, fn)(m, i))
    assert thelpers.remove_row(m, 7) is m
    mask = [0, 1, 0, 1, 1]
    assert thelpers.find_nonzero(mask) == jhelpers.find_nonzero(mask) == [1, 3, 4]
    assert (thelpers.mask_vector([True, False, True], ["a", "b", "c"])
            == jhelpers.mask_vector([True, False, True], ["a", "b", "c"]) == ["a", "c"])
    population = list(range(100))
    assert (thelpers.random_sample(population, 10, np.random.default_rng(4))
            == jhelpers.random_sample(population, 10, np.random.default_rng(4)))


def test_facade_solves_on_point_clouds(rng):
    """``solve(src_cloud, dst_cloud, correspondences)`` reads the port's
    ``PointCloud`` (and any cloud with ``points``) as JAX's facade does."""
    pts = rng.uniform(0, 0.15, (40, 3))
    t = np.array([0.05, -0.1, 0.2])
    src_cloud = tgeom.PointCloud(pts)
    dst_cloud = tgeom.PointCloud(pts[::-1] + t)  # point i matches point 39 - i
    corr = [(i, 39 - i) for i in range(40)]
    params = RobustRegistrationSolverParams(noise_bound=0.001, estimate_scaling=False)
    sol = RobustRegistrationSolver(params, device="cpu").solve(src_cloud, dst_cloud, corr)
    again = RobustRegistrationSolver(params, device="cpu").solve(
        jgeom.PointCloud(pts), jgeom.PointCloud(pts[::-1] + t), corr)
    assert sol.valid and np.abs(sol.translation - t).max() < 1e-4
    np.testing.assert_array_equal(sol.rotation, again.rotation)


def test_exports_match_jax():
    """Every name the JAX package exports, bar the certifier's (not ported
    yet), and the module-scope enum aliases."""
    certifier = {"DRSCertifier", "DRSCertifierParams", "CertificationResult", "EigSolverType"}
    missing = set(teaserpp_tpu.__all__) - certifier - set(teaserpp_tpu_torch.__all__)
    assert not missing
    assert teaserpp_tpu_torch.INLIER_SELECTION_MODE is teaserpp_tpu_torch.InlierSelectionMode
    assert (teaserpp_tpu_torch.ROTATION_ESTIMATION_ALGORITHM
            is teaserpp_tpu_torch.RotationEstimationAlgorithm)
    assert (teaserpp_tpu_torch.INLIER_GRAPH_FORMULATION
            is teaserpp_tpu_torch.InlierGraphFormulation)
    for name in ("MaxCliqueSolverParams", "GNCRotationSolverParams"):
        ours, theirs = getattr(teaserpp_tpu_torch, name)(), getattr(teaserpp_tpu, name)()
        assert ours == type(ours)(**{f: getattr(theirs, f) for f in vars(ours)})
    for name in teaserpp_tpu_torch.__all__:
        assert hasattr(teaserpp_tpu_torch, name), name
