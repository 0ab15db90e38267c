"""The port's front end end to end on the CPU: FPFH descriptors, the matcher,
the robust solve and ICP (examples/fpfh_icp_registration.py's flow) against
the JAX package's, and the command-line tool ``teaserpp_tpu_torch.cli``
against ``teaserpp_tpu.cli`` on PLY files (tests/test_matlab_wrapper.py's
pattern)."""

import json

import numpy as np
import pytest
import torch

from teaserpp_tpu import cli as j_cli
from teaserpp_tpu.features import FPFHEstimation as JFPFHEstimation
from teaserpp_tpu.features import Matcher as JMatcher
from teaserpp_tpu_torch import (
    InlierSelectionMode,
    RobustRegistrationSolver,
    RobustRegistrationSolverParams,
    cli,
)
from teaserpp_tpu_torch.features import FPFHEstimation, Matcher
from teaserpp_tpu_torch.io import write_ply
from teaserpp_tpu_torch.solvers.icp import icp_point_to_point
from teaserpp_tpu_torch.utils.geometry import PointCloud

from conftest import random_rotation

torch.set_num_threads(1)

# R (max abs entry) and t (max abs) between the port's float32 facade and the
# JAX facade under x64 on the same clique: float32 rounding of the points and
# of the GNC rounds, the bound the CPU/GPU parity phases state
RT_TOL = 1e-4


def _patch(seed=12345, m=24):
    """tests/test_features.py::test_fpfh_registration_end_to_end's scene: the
    wavy patch, z + 3, turned 0.25 rad about a seeded axis and shifted."""
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


def _angle(r_a, r_b):
    return float(np.arccos(np.clip((np.trace(r_a.T @ r_b) - 1) / 2, -1, 1)))


def test_fpfh_teaser_icp_flow_matches_jax():
    src, dst, r, t = _patch()
    est = FPFHEstimation(device="cpu", dtype=torch.float64)
    sf, df = est.computeFPFHFeatures(src, 0.25, 0.4), est.computeFPFHFeatures(dst, 0.25, 0.4)
    corr = Matcher(device="cpu").calculateCorrespondences(src, dst, sf, df, False, True,
                                                          False, 0.0)
    jest = JFPFHEstimation()
    jsf, jdf = jest.computeFPFHFeatures(src, 0.25, 0.4), jest.computeFPFHFeatures(dst, 0.25, 0.4)
    want = JMatcher().calculateCorrespondences(src, dst, jsf, jdf, False, True, False, 0.0)
    assert len(set(corr) & set(want)) >= 0.95 * len(want)
    assert len(corr) > 100 and np.mean([i == j for i, j in corr]) > 0.8

    params = RobustRegistrationSolverParams(
        noise_bound=0.05, estimate_scaling=False,
        inlier_selection_mode=InlierSelectionMode.PMC_EXACT)
    sol = RobustRegistrationSolver(params, device="cpu").solve(
        PointCloud(src), PointCloud(dst), corr)
    assert sol.valid
    assert _angle(sol.rotation, r) < 0.05
    assert np.linalg.norm(sol.translation - t) < 0.05

    icp = icp_point_to_point(src.T.astype(np.float32), dst.T.astype(np.float32), 0.05,
                             r_init=sol.rotation, t_init=sol.translation,
                             max_iterations=100, device="cpu")
    assert np.degrees(_angle(icp.rotation.double().numpy(), r)) < 0.01


def _run(main, argv, capsys):
    rc = main(argv)
    out = [line for line in capsys.readouterr().out.splitlines() if line.strip()]
    return rc, (json.loads(out[-1]) if rc == 0 else None)


def _known_problem(n=120, outliers=36, seed=3):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1, 1, (n, 3))
    r, t = random_rotation(rng), rng.uniform(-1, 1, 3)
    dst = src @ r.T + t + rng.uniform(-0.005, 0.005, (n, 3))
    dst[:outliers] = rng.uniform(-2, 2, (outliers, 3))
    return src, dst, r, t


def test_cli_matches_jax_cli(tmp_path, capsys):
    src, dst, r, t = _known_problem()
    write_ply(str(tmp_path / "src.ply"), PointCloud(src))
    write_ply(str(tmp_path / "dst.ply"), PointCloud(dst))
    argv = ["--src", str(tmp_path / "src.ply"), "--dst", str(tmp_path / "dst.ply"),
            "--noise-bound", "0.01"]
    rc, want = _run(j_cli.main, argv, capsys)
    assert rc == 0
    rc, got = _run(cli.main, argv + ["--device", "cpu"], capsys)
    assert rc == 0
    assert set(got) == set(want) == {"valid", "scale", "rotation", "translation",
                                     "time_taken", "max_clique_size"}
    assert got["valid"] and got["max_clique_size"] == want["max_clique_size"] >= 84
    assert got["scale"] == want["scale"] == 1.0
    assert np.abs(np.asarray(got["rotation"]) - np.asarray(want["rotation"])).max() < RT_TOL
    assert np.abs(np.asarray(got["translation"]) - np.asarray(want["translation"])).max() < RT_TOL
    assert np.degrees(_angle(np.asarray(got["rotation"]), r)) < 1.0


def test_cli_fpfh_registers_the_patch(tmp_path, capsys):
    src, dst, r, t = _patch()
    write_ply(str(tmp_path / "src.ply"), PointCloud(src))
    write_ply(str(tmp_path / "dst.ply"), PointCloud(dst))
    rc, got = _run(cli.main, [
        "--src", str(tmp_path / "src.ply"), "--dst", str(tmp_path / "dst.ply"), "--fpfh",
        "--normal-search-radius", "0.25", "--fpfh-search-radius", "0.4",
        "--noise-bound", "0.05", "--device", "cpu"], capsys)
    assert rc == 0 and got["valid"]
    assert _angle(np.asarray(got["rotation"]), r) < 0.05
    assert np.linalg.norm(np.asarray(got["translation"]) - t) < 0.05


def test_cli_refuses_unequal_clouds_without_fpfh(tmp_path, capsys):
    src, dst, _, _ = _known_problem()
    write_ply(str(tmp_path / "src.ply"), PointCloud(src))
    write_ply(str(tmp_path / "dst.ply"), PointCloud(dst[:-1]))
    argv = ["--src", str(tmp_path / "src.ply"), "--dst", str(tmp_path / "dst.ply")]
    assert cli.main(argv + ["--device", "cpu"]) == 2
    assert "differ in size" in capsys.readouterr().err
    assert j_cli.main(argv) == 2


def test_cli_device_flag_defaults_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, dst, _, _ = _known_problem()
    write_ply(str(tmp_path / "src.ply"), PointCloud(src))
    write_ply(str(tmp_path / "dst.ply"), PointCloud(dst))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--src", str(tmp_path / "src.ply"), "--dst", str(tmp_path / "dst.ply")])
