"""The unknown-scale branch of ``register_pair`` in chunks of problems.

Its TIM norms, TLS scale and pair-mask graph run a chunk of problems at a
time (``pipeline.SCALE_CHUNK_EVENTS``); the chunked solve equals the solve
in one chunk bit for bit on every field, and the batched solve agrees with
the benchmark's plain unknown-scale reference (``regbench/reference/
unknown_scale.py``) under its cell's limits.
"""

import numpy as np
import pytest
import torch

from regbench import checks
from regbench.entries._params import solver_params
from regbench.run import load_json, load_module
from teaserpp_tpu_torch import InlierSelectionMode, RobustRegistrationSolverParams, solve_batch
from teaserpp_tpu_torch.parallel.batch import pad_problems
from teaserpp_tpu_torch.solvers import pipeline

torch.set_num_threads(2)


def _padded_batch():
    """Five scaled problems of 64, 64, 50, 64 and 40 points, padded to 64."""
    rng = np.random.default_rng(17)
    srcs, dsts = [], []
    for n, s in ((64, 1.4), (64, 0.8), (50, 2.5), (64, 1.1), (40, 1.9)):
        src = rng.uniform(-1, 1, (3, n))
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        r = q * np.sign(np.linalg.det(q))
        dst = s * r @ src + rng.normal(size=(3, 1)) + rng.uniform(-0.005, 0.005, (3, n))
        out = rng.choice(n, size=n // 3, replace=False)
        dst[:, out] = rng.uniform(-3, 3, (3, out.size))
        srcs.append(src)
        dsts.append(dst)
    src, dst, valid = pad_problems(srcs, dsts, multiple=64)
    return src.astype(np.float32), dst.astype(np.float32), valid


def _solve(src, dst, valid, params, chunk_events, monkeypatch):
    monkeypatch.setattr(pipeline, "SCALE_CHUNK_EVENTS", chunk_events)
    pipeline.reset_scale_sweep()
    stage_ms = {}
    sol = solve_batch(src, dst, params, valid, device="cpu", stage_ms=stage_ms)
    return sol, dict(pipeline.SCALE_SWEEP), stage_ms


@pytest.mark.parametrize("mode", ["PMC_EXACT", "NONE"])
def test_chunks_equal_one_chunk_bit_for_bit(mode, monkeypatch):
    src, dst, valid = _padded_batch()
    params = RobustRegistrationSolverParams(noise_bound=0.01, estimate_scaling=True,
                                            inlier_selection_mode=InlierSelectionMode[mode])
    events = 64 * 63  # 2K events a problem
    whole, swept_whole, _ = _solve(src, dst, valid, params, 5 * events, monkeypatch)
    # two problems a chunk: chunks of 2, 2 and 1
    parts, swept_parts, stage_ms = _solve(src, dst, valid, params, 2 * events + 7,
                                          monkeypatch)
    assert swept_whole == {"chunks": 1, "events": 5 * events}
    assert swept_parts == {"chunks": 3, "events": 5 * events}
    for name, a, b in zip(pipeline.PipelineSolution._fields, whole, parts):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    graph = ["scale_graph"] if mode != "NONE" else []
    assert set(stage_ms) >= {"scale", *graph, "clique", "rotation"}
    assert ("scale_graph" in stage_ms) == bool(graph)
    assert not whole.clique_mask[2, 50:].any() and not whole.clique_mask[4, 40:].any()
    assert whole.valid.all() and (whole.scale - torch.tensor([1.4, 0.8, 2.5, 1.1, 1.9])
                                  ).abs().max() < 0.02


def test_solve_batch_agrees_with_the_plain_reference():
    cell = load_json("workloads", "bunny1889_unknown_scale.batch")
    config = load_json("configs", cell["config"])
    problem = dict(config["problem"], n=240, outlier_draws=216)
    assert problem["scale"] == 2.5 and config["solver"]["estimate_scaling"] is True
    src, dst = load_module("generators", config["generator"]).make(problem, 2 ** 33 + 5,
                                                                   range(4))
    got = solve_batch(src, dst, solver_params(config["solver"]), device="cpu")
    ref = load_module("reference", config["reference"]).solve(
        torch.from_numpy(src), torch.from_numpy(dst), config["solver"])
    verdict = checks.compare(
        got.rotation.numpy(), got.translation.numpy(), got.scale.numpy(),
        got.clique_mask.numpy(), ref.rotation.numpy(), ref.translation.numpy(),
        ref.scale.numpy(), ref.inliers.numpy(), ref.decided.numpy(), cell["limits"])
    assert verdict.correct, verdict.lines()
    assert verdict.compared == 4 and verdict.worst["set_diff"] == 0
