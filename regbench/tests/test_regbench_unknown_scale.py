"""The unknown-scale cell at sizes a CPU test holds: its reference's TLS
sweep against a brute-force loop over every candidate, the reference
against the ground truth, a run of the cell, and the runs that must fail:
a scale moved by 1e-4 of itself, the known-scale reference in the
configuration's place, and the bfloat16 control."""

import math
import time

import numpy as np
import pytest
import torch

import teaserpp_tpu_torch
from regbench import run
from regbench.control import control_readings
from regbench.reference import unknown_scale as ref

torch.set_num_threads(2)

CELL = "bunny1889_unknown_scale.batch"
# the cell at a size the CPU holds: the same generator, solver, reference
# and entry, fewer points, problems and requests
SMALL = {"config": {"problem": {"n": 240, "outlier_draws": 216}},
         "traffic": {"batch": 4, "pool": 8, "traced_requests": 1}}


def _brute_force_tls(x, r):
    """Every candidate of the sweep from its definition, in float64: after
    each event (the measurements' interval ends in sorted order) the open
    set, its weighted mean and the cost of that mean; the first of least
    cost."""
    ends = sorted([(x[i] - r[i], i) for i in range(len(x))]
                  + [(x[i] + r[i], len(x) + i) for i in range(len(x))])
    best, best_cost = None, math.inf
    for t in range(len(ends)):
        seen = {e for _, e in ends[:t + 1]}
        open_ = [i for i in range(len(x)) if i in seen and len(x) + i not in seen]
        if not open_:
            continue
        w = 1.0 / r[open_] ** 2
        m = float(np.sum(w * x[open_]) / np.sum(w))
        closed = np.setdiff1d(np.arange(len(x)), open_)
        cost = float(np.sum((x[open_] - m) ** 2) + np.sum(r[closed]))
        if cost < best_cost:
            best, best_cost = m, cost
    return best


@pytest.mark.parametrize("seed", range(6))
def test_tls_sweep_matches_a_brute_force_loop(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 40))
    inl = int(rng.integers(2, n + 1))
    x = np.concatenate([rng.normal(2.5, 0.01, inl), rng.uniform(0.0, 10.0, n - inl)])
    r = rng.uniform(0.01, 0.3, n)
    valid = rng.uniform(size=n) > 0.15
    est, mask = ref.tls_sweep(torch.from_numpy(x)[None], torch.from_numpy(r)[None],
                              torch.from_numpy(valid)[None])
    want = _brute_force_tls(x[valid], r[valid])
    assert est.dtype == torch.float64
    assert est.item() == pytest.approx(want, rel=1e-12)
    np.testing.assert_array_equal(mask[0].numpy(), (np.abs(x - want) <= r) & valid)


def test_solve_recovers_the_ground_truth():
    _, config, _ = run.load_cell(CELL, SMALL)
    problem = config["problem"]
    gen = run.load_module("generators", config["generator"])
    src, dst = gen.make(problem, 7, range(3))
    sol = ref.solve(torch.from_numpy(src), torch.from_numpy(dst), config["solver"])
    s, t = problem["scale"], gen.transform(problem)
    assert bool(sol.decided.all()) and sol.scale.dtype == torch.float64
    np.testing.assert_allclose(sol.scale.numpy(), s, rtol=1e-3)
    resid = dst - (s * t[:3, :3] @ src + t[:3, 3:4])
    truth = np.abs(resid).max(axis=1) <= problem["noise_bound"] / 2 + 1e-5
    np.testing.assert_array_equal(sol.inliers.numpy(), truth)
    for p in range(3):
        cos = (np.trace(sol.rotation[p].numpy().T @ t[:3, :3]) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.2
        assert np.linalg.norm(sol.translation[p].numpy() - t[:3, 3]) < 2e-3


def _run(override=SMALL, seconds=0.3, trace=False):
    return run.run_cell(CELL, 2 ** 31 + 77, seconds, trace, torch.device("cpu"), override,
                        t0=time.perf_counter())


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_correct_on_the_cpu(trace):
    assert run.load_cell(CELL)[1]["reference"] == "unknown_scale"
    res, verdict = _run(seconds=3.0 if trace else 0.3, trace=bool(trace))
    assert res["correct"] is True and res["failed"] == 0, verdict.lines()
    assert verdict.worst["set_diff"] == 0 and verdict.worst["undecided"] == 0
    assert 0 < verdict.worst["scale_gap"] <= verdict.limits["scale_gap"]
    want = {"scale_ms.unknown_scale", "scale_graph_ms.unknown_scale"} if trace else {
        "regs_per_s", "setup_s"}
    assert set(res["metrics"]) == want


def test_a_scale_moved_by_a_ten_thousandth_is_not_correct(monkeypatch):
    solve = teaserpp_tpu_torch.solve_batch

    def moved(*a, **kw):
        sol = solve(*a, **kw)
        return sol._replace(scale=sol.scale * (1 + 1e-4))

    monkeypatch.setattr(teaserpp_tpu_torch, "solve_batch", moved)
    res, verdict = _run()
    assert res["correct"] is False and res["failed"] == verdict.compared, verdict.lines()
    assert verdict.worst["scale_gap"] > verdict.limits["scale_gap"]
    assert verdict.worst["set_diff"] == 0


def test_the_known_scale_reference_is_not_correct():
    override = dict(SMALL, config=dict(SMALL["config"], reference="registration"))
    res, verdict = _run(override)
    assert res["correct"] is False and res["failed"] >= 1, verdict.lines()
    assert verdict.worst["scale_gap"] > verdict.limits["scale_gap"]


def test_the_control_is_not_correct():
    for seed in (11, 12, 13):
        got = control_readings(CELL, seed, torch.device("cpu"), SMALL)
        assert got["correct"] is False, got
        gap = got["checks"]["scale_gap"]
        assert gap["value"] >= 10 * gap["limit"], got
