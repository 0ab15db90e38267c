"""Determinism of the port, mirroring tests/test_determinism.py: equal
inputs give bitwise-equal outputs on repeated runs (the batched solve with
PMC_HEU, which runs the batched greedy clique; the facade with PMC_EXACT),
the facade records its stage timings, and the TLS prefix sums are the
fixed-order scan ``ops/tls.py::prefix_sum``: bit-equal to a Python model of
its order of additions, and within its error bound of an exact sum.
The batched solve is also held against the JAX package's on the same input."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from teaserpp_tpu.params import InlierSelectionMode as JMode
from teaserpp_tpu.params import RobustRegistrationSolverParams as JParams
from teaserpp_tpu.solvers.pipeline import register_pair_jit
from teaserpp_tpu_torch import RobustRegistrationSolver
from teaserpp_tpu_torch.convert import params_from_jax, solution_to_numpy
from teaserpp_tpu_torch.ops.tls import _SCAN_BLOCK, prefix_sum, scalar_tls
from teaserpp_tpu_torch.solvers.pipeline import register_pair

from conftest import make_registration_problem

torch.set_num_threads(1)

PARAMS = JParams(
    noise_bound=0.01,
    estimate_scaling=False,
    inlier_selection_mode=JMode.PMC_HEU,
    max_clique_heuristic_seeds=16,
)


def test_pipeline_bitwise_deterministic(rng):
    src, dst, *_ = make_registration_problem(rng, n=128, outlier_ratio=0.7)
    src, dst = src.astype(np.float32), dst.astype(np.float32)
    params = params_from_jax(PARAMS)
    a = solution_to_numpy(register_pair(src[None], dst[None], params, device="cpu"))
    b = solution_to_numpy(register_pair(src[None], dst[None], params, device="cpu"))
    for name, fa, fb in zip(a._fields, a, b):
        assert np.array_equal(fa, fb), f"nondeterministic {name}"
    # and it is the JAX package's solve: the greedy clique equal, R and t to
    # test_torch_pipeline.py's 1e-5
    want = register_pair_jit(jnp.asarray(src), jnp.asarray(dst), PARAMS)
    np.testing.assert_array_equal(a.clique_mask[0], np.asarray(want.clique_mask))
    assert a.clique_mask.sum() >= 30  # the 38 planted inliers, up to noise
    assert np.linalg.norm(a.rotation[0] - np.asarray(want.rotation)) < 1e-5
    assert np.linalg.norm(a.translation[0] - np.asarray(want.translation)) < 1e-5


@pytest.mark.parametrize("estimate_scaling", [False, True])
def test_host_solver_repeatable(rng, estimate_scaling):
    src, dst, *_ = make_registration_problem(rng, n=80, outlier_ratio=0.5)
    params = params_from_jax(PARAMS.replace(inlier_selection_mode=JMode.PMC_EXACT,
                                            estimate_scaling=estimate_scaling))
    s1 = RobustRegistrationSolver(params, device="cpu").solve(src, dst)
    s2 = RobustRegistrationSolver(params, device="cpu").solve(src, dst)
    assert np.array_equal(s1.rotation, s2.rotation)
    assert np.array_equal(s1.translation, s2.translation)
    assert s1.scale == s2.scale


def test_stage_timings_collected(rng):
    src, dst, *_ = make_registration_problem(rng, n=60, outlier_ratio=0.4)
    solver = RobustRegistrationSolver(
        params_from_jax(PARAMS.replace(inlier_selection_mode=JMode.PMC_EXACT)), device="cpu")
    solver.solve(src, dst)
    timings = solver.getStageTimings()
    assert set(timings) == {"scale", "clique", "rotation_translation"}
    assert all(v >= 0 for v in timings.values())


def _shifted_adds(v):
    """Pass p adds each element 2^p places back, one float64 add at a time."""
    k = 1
    while k < len(v):
        v = v[:k] + [v[i] + v[i - k] for i in range(k, len(v))]
        k *= 2
    return v


def _scan_model(x: np.ndarray, block: int) -> np.ndarray:
    """prefix_sum's order of additions in Python floats (float64): blocks of
    ``block`` zero-padded and scanned by shifted adds, the block sums scanned
    the same way, each block's predecessors' sum added; then one rounding to
    float32."""
    v = [float(e) for e in x]
    if len(v) <= block:
        return np.array(_shifted_adds(v), np.float64).astype(np.float32)
    v += [0.0] * (-len(v) % block)
    rows = [_shifted_adds(v[i:i + block]) for i in range(0, len(v), block)]
    carry = _shifted_adds([r[-1] for r in rows])
    out = rows[0] + [e + carry[r - 1] for r in range(1, len(rows)) for e in rows[r]]
    return np.array(out[:len(x)], np.float64).astype(np.float32)


@pytest.mark.parametrize("length", [1, 2, 5, 64, 65, 1000, 4096, 5000])
def test_prefix_sum_is_the_fixed_order_scan(length):
    rng = np.random.default_rng(length)
    x = (rng.normal(size=(3, length)) * rng.choice([1e-3, 1.0, 1e3], (3, length))
         ).astype(np.float32)
    got = prefix_sum(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    for row in range(3):
        np.testing.assert_array_equal(got[row].numpy(), _scan_model(x[row], _SCAN_BLOCK))
    # element i is a float64 sum at most ceil(log2 L) + 2 additions deep,
    # within depth * u64 / (1 - depth * u64) of the magnitudes summed, then
    # rounded once to float32 (half an ulp, u32 |exact|)
    depth = max(1, math.ceil(math.log2(length))) + 2
    u64, u32 = 2.0 ** -53, 2.0 ** -24
    gamma = depth * u64 / (1 - depth * u64)
    exact = np.cumsum(x.astype(np.float64), axis=-1)
    bound = u32 * np.abs(exact) + gamma * np.cumsum(np.abs(x.astype(np.float64)), axis=-1)
    assert (np.abs(got.numpy().astype(np.float64) - exact) <= bound).all()
    assert torch.equal(prefix_sum(torch.from_numpy(x)), got)  # and again, the same bits


def test_prefix_sum_keeps_cancelling_prefixes():
    """Opens and closes that cancel, as in a TLS sweep: a float32 tree scan
    would carry the window sums' error (1e4 x 2^-24 per pass) into prefixes
    of size 1; the float64 scan gives them to float32 rounding."""
    rng = np.random.default_rng(0)
    big = rng.uniform(1e3, 1e4, 4096).astype(np.float32)
    x = np.empty(8192, np.float32)
    x[0::2], x[1::2] = big, -big  # prefix: big_0, 0, big_1, 0, ...
    x[1::2][::7] += 1.0  # and a few closes that leave 1 open
    got = prefix_sum(torch.from_numpy(x)).numpy()
    exact = np.cumsum(x.astype(np.float64))
    assert np.abs(got - exact).max() <= 2.0 ** -24 * np.abs(exact).max()


def test_scalar_tls_repeatable_and_no_cumsum(rng, monkeypatch):
    """The TLS runs on the scan alone: ``torch.cumsum`` is never called."""
    def refuse(*args, **kwargs):
        raise AssertionError("torch.cumsum called")

    monkeypatch.setattr(torch, "cumsum", refuse)
    monkeypatch.setattr(torch.Tensor, "cumsum", refuse)
    x = torch.from_numpy(rng.normal(size=(4, 3000)).astype(np.float32))
    r = torch.from_numpy(rng.uniform(0.01, 0.1, (4, 3000)).astype(np.float32))
    a, b = scalar_tls(x, r), scalar_tls(x, r)
    for fa, fb in zip(a, b):
        assert torch.equal(fa, fb)
