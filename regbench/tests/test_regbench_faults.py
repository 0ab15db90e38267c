"""A run of each cell, with the harness's look for a card skipped and the
program broken underneath, comes out not correct; and the control, the
reference in bfloat16, fails the cell's limits. At sizes the CPU holds.

The faults a cell can have: a step that returns its state unchanged (the
GNC rotation loop hands back its starting identity); half of the batch
left out (the batch's second half answered with the first half's
solutions; a single problem solved on half of its correspondences); an
answer altered where it is produced (one inlier flipped, a translation
moved by a millimetre, or a scale by a thousandth). One card, so no
exchange between cards to leave out. And a reference that does not model
the configuration's scale fails the comparison.
"""

import time

import numpy as np
import pytest
import torch

import teaserpp_tpu_torch
from regbench import run
from regbench.control import control_readings
from regbench.tests.small import CELLS, SMALL
from teaserpp_tpu_torch.solvers import registration, rotation

torch.set_num_threads(2)


def _run(cell):
    res, verdict = run.run_cell(cell, 4242, 0.3, False, torch.device("cpu"), SMALL[cell],
                                t0=time.perf_counter())
    return res, verdict


def _state_unchanged(monkeypatch, cell):
    def gnc(src, dst, noise_bound, gnc_factor, max_iterations, cost_threshold, valid, procrustes):
        bsz, d, n = src.shape
        eye = torch.eye(d, dtype=src.dtype).expand(bsz, d, d).clone()
        return (eye, torch.ones(bsz, n, dtype=src.dtype), torch.zeros(bsz, dtype=src.dtype),
                torch.zeros(bsz, dtype=torch.int32))

    monkeypatch.setattr(rotation, "_solve_gnc_tls", gnc)


def _half_left_out(monkeypatch, cell):
    if cell == "bunny1889.batch":
        solve = teaserpp_tpu_torch.solve_batch

        def half(src, dst, params, **kw):
            h = src.shape[0] // 2
            sol = solve(src[:h], dst[:h], params, **kw)
            return type(sol)(*(torch.cat([f, f[: src.shape[0] - h]]) for f in sol))

        monkeypatch.setattr(teaserpp_tpu_torch, "solve_batch", half)
    else:
        solve = registration.RobustRegistrationSolver.solve

        def half(self, src, dst, correspondences=None):
            h = src.shape[-1] // 2
            return solve(self, src[:, :h], dst[:, :h])

        monkeypatch.setattr(registration.RobustRegistrationSolver, "solve", half)


def _altered(what):
    def plant(monkeypatch, cell):
        if cell == "bunny1889.facade":
            solve = registration.RobustRegistrationSolver.solve

            def alter(self, src, dst, correspondences=None):
                sol = solve(self, src, dst)
                if what == "inlier":
                    self._max_clique = self._max_clique[1:]
                elif what == "scale":
                    sol.scale = sol.scale * 1.001
                else:
                    sol.translation = sol.translation + 1e-3
                return sol

            monkeypatch.setattr(registration.RobustRegistrationSolver, "solve", alter)
            return
        solve = teaserpp_tpu_torch.solve_batch

        def alter(*a, **kw):
            sol = solve(*a, **kw)
            if what == "inlier":
                mask = sol.clique_mask.clone()
                mask.view(-1)[int(torch.nonzero(mask.view(-1))[0])] = False
                return sol._replace(clique_mask=mask)
            if what == "scale":
                return sol._replace(scale=sol.scale * 1.001)
            return sol._replace(translation=sol.translation + 1e-3)

        monkeypatch.setattr(teaserpp_tpu_torch, "solve_batch", alter)
    return plant


FAULTS = {"state_unchanged": _state_unchanged, "half_left_out": _half_left_out,
          "inlier_altered": _altered("inlier"), "translation_altered": _altered("translation"),
          "scale_altered": _altered("scale")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_program_is_not_correct(cell, fault, monkeypatch):
    sound, _ = _run(cell)
    assert sound["correct"] is True
    FAULTS[fault](monkeypatch, cell)
    res, verdict = _run(cell)
    assert res["correct"] is False and res["failed"] >= 1, verdict.lines()
    if fault == "scale_altered":  # only the scale moved, and its own number sees it
        assert verdict.worst["scale_gap"] > verdict.limits["scale_gap"], verdict.lines()
        assert res["failed"] == verdict.compared, verdict.lines()


@pytest.mark.parametrize("cell", CELLS)
def test_a_reference_that_ignores_the_scale_is_not_correct(cell):
    # the program estimates s = 1.4; the known-scale reference answers 1
    small = SMALL[cell]
    override = {"config": dict(small["config"],
                               problem=dict(small["config"]["problem"], scale=1.4),
                               solver={"estimate_scaling": True}),
                "traffic": small["traffic"]}
    assert run.load_cell(cell, override)[1]["reference"] == "registration"
    res, verdict = run.run_cell(cell, 4242, 0.3, False, torch.device("cpu"), override,
                                t0=time.perf_counter())
    assert res["correct"] is False and res["failed"] >= 1, verdict.lines()
    assert verdict.worst["scale_gap"] > verdict.limits["scale_gap"], verdict.lines()


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    for seed in (11, 12, 13):
        got = control_readings(cell, seed, torch.device("cpu"), SMALL[cell])
        assert got["correct"] is False, got
        assert got["checks"]["rot_gap_deg"]["value"] > got["checks"]["rot_gap_deg"]["limit"]
