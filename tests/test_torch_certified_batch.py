"""Certified registration through the batched entry:
``solve_batch(..., certify=DRSCertifierParams(...))`` certifies every answer
on its rotation stage's chain TIMs, inlier vector and noise bound, grouped by
TIM count, as upstream's ``solve`` then ``DRSCertifier::certify`` does one
problem at a time. Small problems on the CPU, float64 certificates.

Each lane is held to the facade's flow: ``RobustRegistrationSolver.solve``,
then ``DRSCertifier.certify`` on ``getMaxCliqueSrcTIMs()``,
``getMaxCliqueDstTIMs()`` and ``getRotationInliersMask()`` at the rotation
stage's noise bound, of the float64 Procrustes of those TIMs and that mask
(the rotation a certified batch returns, within float32 rounding of the
facade's): the same verdict, the same iteration count and trajectories
within the DENSE tolerance of ``test_torch_certification.py``.
"""

import numpy as np
import pytest
import torch

from teaserpp_tpu_torch import (
    CertifiedSolution,
    PipelineSolution,
    RobustRegistrationSolver,
    solve_batch,
)
from teaserpp_tpu_torch.certification import drs
from teaserpp_tpu_torch.certification.drs import DRSCertifier, certify_batch
from teaserpp_tpu_torch.ops.procrustes import svd_rot
from teaserpp_tpu_torch.params import (
    DRSCertifierParams,
    InlierSelectionMode,
    RobustRegistrationSolverParams,
)

CPU = torch.device("cpu")
NB = 0.001
N = 40
# outliers a problem: cliques of 34, 31, 34 and 28 points, so three groups,
# one of two lanes; the fifth problem has no consistent pair at all
OUTLIERS = (6, 9, 6, 12)
TRAJ_RTOL = 1e-6  # tests/test_torch_certification.py's DENSE tolerance
TRAJ_ATOL = 1e-8
F32_ANGLE = 1e-6  # rad: float32 rounding of a rotation, with room
PARAMS = RobustRegistrationSolverParams(
    noise_bound=NB, cbar2=1.0, estimate_scaling=False, rotation_gnc_factor=1.4,
    rotation_max_iterations=100, rotation_cost_threshold=0.005,
    inlier_selection_mode=InlierSelectionMode.PMC_EXACT)
CERTIFY = DRSCertifierParams()


def _angle(a, b) -> float:
    """The angle (rad) between two rotations, accurate near 0."""
    d = np.asarray(a, np.float64).T @ np.asarray(b, np.float64)
    return float(np.linalg.norm(d - d.T) / (2 * np.sqrt(2)))


def _rotation(rng) -> np.ndarray:
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    return q * np.sign(np.linalg.det(q))


@pytest.fixture(scope="module")
def problems():
    """(B, 3, N) float32 src and dst: bunny-box problems (a 0.15 m cloud,
    noise +-NB/2, each outlier shifted by its own 5-14 m), then one whose
    destination is unrelated to its source."""
    rng = np.random.default_rng(2025)
    src = rng.uniform(0.0, 0.15, (len(OUTLIERS) + 1, 3, N))
    dst = np.empty_like(src)
    for b, k in enumerate(OUTLIERS):
        dst[b] = _rotation(rng) @ src[b] + rng.uniform(-1, 1, (3, 1))
        dst[b] += rng.uniform(-NB / 2, NB / 2, (3, N))
        dst[b][:, rng.choice(N, k, replace=False)] += 5.0 + np.arange(k) / 1.0
    dst[-1] = rng.uniform(-50, 50, (3, N))
    return src.astype(np.float32), dst.astype(np.float32)


@pytest.fixture(scope="module")
def certified(problems):
    """The certified batch, its stage times and the certifier's counts."""
    drs.reset_certify()
    stages = {}
    sol = solve_batch(*problems, PARAMS, device=CPU, stage_ms=stages, certify=CERTIFY)
    return sol, stages, dict(drs.CERTIFY)


def test_every_lane_equals_the_facade_then_the_certifier(problems, certified):
    sol, _, _ = certified
    assert type(sol) is CertifiedSolution
    sizes = sol.clique_mask.sum(-1).tolist()
    assert sizes[:-1] == [N - k for k in OUTLIERS] and sizes[-1] <= 1
    facade = RobustRegistrationSolver(PARAMS, device=CPU)
    certifier = DRSCertifier(CERTIFY.replace(noise_bound=2.0 * NB), device=CPU)
    for b in range(len(OUTLIERS)):
        facade.solve(problems[0][b], problems[1][b])
        assert sorted(facade.getInlierMaxClique()) == np.nonzero(
            sol.clique_mask[b].numpy())[0].tolist()
        tims = [torch.as_tensor(t, dtype=torch.float64) for t in (
            facade.getMaxCliqueSrcTIMs(), facade.getMaxCliqueDstTIMs())]
        mask = facade.getRotationInliersMask()
        r64 = svd_rot(*tims, torch.as_tensor(mask, dtype=torch.float64))
        assert sol.rotation.dtype == torch.float64
        np.testing.assert_allclose(sol.rotation[b].numpy(), r64.numpy(), rtol=0, atol=1e-14)
        assert 0 < _angle(facade.getSolution().rotation, r64) < F32_ANGLE
        want = certifier.certify(r64, *tims, mask)
        assert want.is_optimal  # noisy inliers only: certified, as upstream's tests
        got = certify_batch(r64[None], tims[0][None], tims[1][None], mask[None],
                            CERTIFY.replace(noise_bound=2.0 * NB), device=CPU)[0]
        assert got.suboptimality_traj == want.suboptimality_traj  # the same inputs
        assert bool(sol.optimal[b]) == want.is_optimal
        assert abs(float(sol.suboptimality[b]) - want.best_suboptimality) <= (
            TRAJ_ATOL + TRAJ_RTOL * want.best_suboptimality)


def test_lanes_equal_their_single_runs_in_trajectory(problems, certified, monkeypatch):
    """The grouped loops' whole trajectories against each problem certified alone."""
    sol, _, _ = certified
    runs = {}
    real = drs.certify_batch

    def record(r, v1, v2, theta, params, **kw):
        res = real(r, v1, v2, theta, params, **kw)
        for i in range(len(res)):
            single = DRSCertifier(params, device=CPU).certify(r[i], v1[i], v2[i], theta[i])
            runs[(v1.shape[-1], i)] = (res[i], single, len(res))
        return res

    monkeypatch.setattr(drs, "certify_batch", record)
    again = solve_batch(*problems, PARAMS, device=CPU, certify=CERTIFY)
    assert torch.equal(again.suboptimality, sol.suboptimality)
    assert sorted(g for (_, i), (_, _, g) in runs.items() if i == 0) == [1, 1, 2]
    for got, want, _ in runs.values():
        assert got.is_optimal == want.is_optimal
        assert len(got.suboptimality_traj) == len(want.suboptimality_traj)
        np.testing.assert_allclose(got.suboptimality_traj, want.suboptimality_traj,
                                   rtol=TRAJ_RTOL, atol=TRAJ_ATOL)


def test_a_degenerate_clique_is_not_certified(certified):
    sol, _, counts = certified
    assert not bool(sol.valid[-1])
    assert not bool(sol.optimal[-1]) and float(sol.suboptimality[-1]) == float("inf")
    assert sol.optimal.dtype == torch.bool and sol.suboptimality.dtype == torch.float64
    assert counts["lanes"] == len(OUTLIERS)  # the certifier never saw it


def test_without_certify_nothing_changes(problems, certified):
    sol, _, _ = certified
    drs.reset_certify()
    stages = {}
    plain = solve_batch(*problems, PARAMS, device=CPU, stage_ms=stages)
    assert type(plain) is PipelineSolution
    for name, a, b in zip(PipelineSolution._fields, plain, sol):
        if name != "rotation":
            assert torch.equal(a, b), name
    # the certified rotations: float64 within float32 rounding of the plain
    # ones, and the degenerate problem's kept
    for b in range(len(OUTLIERS)):
        assert _angle(plain.rotation[b], sol.rotation[b]) < F32_ANGLE
    assert torch.equal(plain.rotation[-1].double(), sol.rotation[-1])
    assert not {"certify", "psd", "gap"} & set(stages)
    assert all(v == 0 for v in drs.CERTIFY.values())


def test_counters_and_stage_times(certified):
    _, stages, counts = certified
    iters = counts["lane_iterations"]
    assert counts["groups"] == 3 and counts["lanes"] == len(OUTLIERS)
    assert counts["loop_iterations"] < iters <= counts["loop_iterations"] * 2
    # a done test a loop turn and one that ends each loop, the TIM counts,
    # and the four result arrays of each loop
    assert counts["host_reads"] == counts["loop_iterations"] + 3 + 1 + 4 * 3
    assert 0 < stages["psd"] + stages["gap"] < stages["certify"]
    for name in ("bits", "peel", "chain_tims", "rotation", "translation"):
        assert stages[name] > 0


def test_certify_batch_takes_tensors_as_they_lie(problems, certified):
    """Tensors and host arrays of the same numbers give the same runs."""
    sol, _, _ = certified
    from teaserpp_tpu_torch.ops.tims import chain_tims

    v1, ok = chain_tims(torch.from_numpy(problems[0][:1]).double(), sol.clique_mask[:1])
    v2, _ = chain_tims(torch.from_numpy(problems[1][:1]).double(), sol.clique_mask[:1])
    args = (sol.rotation[:1], v1[:, :, ok[0]], v2[:, :, ok[0]],
            sol.rotation_inlier_mask[:1][:, ok[0]])
    params = CERTIFY.replace(noise_bound=2.0 * NB)
    drs.reset_certify()
    on_device = certify_batch(*args, params, device=CPU)[0]
    reads = drs.CERTIFY["host_reads"]
    via_host = certify_batch(*(a.numpy() for a in args), params, device=CPU)[0]
    assert on_device.suboptimality_traj == via_host.suboptimality_traj
    assert on_device.best_suboptimality == pytest.approx(float(sol.suboptimality[0]),
                                                         rel=TRAJ_RTOL, abs=TRAJ_ATOL)
    assert drs.CERTIFY["host_reads"] == 2 * reads
