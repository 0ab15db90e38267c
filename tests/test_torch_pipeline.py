"""Port parity for the whole batched solve: ``solve_batch`` of the port
against the JAX package's ``solve_batch`` on the known-scale KCORE_HEU
threshold-0 path (bench.py's parameters), and ``register_batch`` against
JAX's on the unknown-scale path (scripts/bench_scale_est.py's recipe) in
NONE and KCORE_HEU threshold-0 modes, at a small size with one padded
problem. The other inlier-selection modes are held against JAX in
test_torch_clique_modes.py and test_torch_clique_modes_scale.py."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from teaserpp_tpu.params import InlierSelectionMode as JMode
from teaserpp_tpu.params import RobustRegistrationSolverParams as JParams
from teaserpp_tpu.parallel.batch import solve_batch as j_solve_batch
from teaserpp_tpu.solvers import pipeline as jpipe
from teaserpp_tpu_torch import params as tparams
from teaserpp_tpu_torch.convert import params_from_jax, solution_to_numpy
from teaserpp_tpu_torch.parallel.batch import pad_problems, solve_batch
from teaserpp_tpu_torch.solvers.pipeline import register_batch, register_pair

from conftest import random_rotation

torch.set_num_threads(1)

BENCH_PARAMS = JParams(
    noise_bound=0.001,
    cbar2=1.0,
    estimate_scaling=False,
    rotation_cost_threshold=0.005,
    inlier_selection_mode=JMode.KCORE_HEU,
    kcore_heuristic_threshold=0.0,
)


def _problem(rng, n, outlier_frac, noise=0.0005):
    """Bunny-shaped problem: points in a 0.15 m box, uniform noise, outliers."""
    src = rng.uniform(0.0, 0.15, (3, n))
    r = random_rotation(rng)
    t = rng.uniform(-0.2, 0.2, 3)
    dst = r @ src + t[:, None] + rng.uniform(-noise, noise, (3, n))
    idx = rng.choice(n, size=int(outlier_frac * n), replace=False)
    dst[:, idx] = rng.uniform(-1.0, 1.0, (3, idx.size))
    return src, dst, r, t


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    # noise past nb/2 in the first problem breaks some inlier pairs and
    # makes GNC iterate; the others stop on the degenerate first round
    probs = [_problem(rng, n, 0.85, noise)
             for n, noise in ((160, 0.0009), (160, 0.0005), (120, 0.0005))]
    src, dst, valid = pad_problems([p[0] for p in probs], [p[1] for p in probs],
                                   multiple=32)
    return (src.astype(np.float32), dst.astype(np.float32), valid,
            [p[2] for p in probs], [p[3] for p in probs])


def test_params_from_jax_carries_every_field():
    p = params_from_jax(BENCH_PARAMS.replace(final_polish=True))
    assert isinstance(p, tparams.RobustRegistrationSolverParams)
    for f in dataclasses.fields(BENCH_PARAMS):
        mine = getattr(p, f.name)
        theirs = getattr(BENCH_PARAMS.replace(final_polish=True), f.name)
        assert mine == theirs, f.name
    assert p.inlier_selection_mode is tparams.InlierSelectionMode.KCORE_HEU
    with pytest.raises(TypeError):
        params_from_jax(object())


@pytest.mark.parametrize("polish", [False, True])
def test_solve_batch_matches_jax(batch, polish):
    src, dst, valid, r_true, t_true = batch
    jparams = BENCH_PARAMS.replace(final_polish=polish)
    ref = j_solve_batch(jnp.asarray(src), jnp.asarray(dst), jparams,
                        jnp.asarray(valid))
    stage_ms = {}
    got = solution_to_numpy(solve_batch(src, dst, params_from_jax(jparams),
                                        valid, device="cpu", stage_ms=stage_ms))
    assert set(stage_ms) == {"bits", "peel", "chain_tims", "rotation", "translation"}
    np.testing.assert_array_equal(got.clique_mask, np.asarray(ref.clique_mask))
    np.testing.assert_array_equal(got.rotation_iterations,
                                  np.asarray(ref.rotation_iterations))
    np.testing.assert_array_equal(got.valid, np.asarray(ref.valid))
    np.testing.assert_array_equal(got.rotation_inlier_mask,
                                  np.asarray(ref.rotation_inlier_mask))
    np.testing.assert_array_equal(got.translation_inlier_mask,
                                  np.asarray(ref.translation_inlier_mask))
    # float32 GNC rounds and TLS prefix sums summed in another order than
    # XLA's; the iterations and inlier sets agree exactly, so the estimates
    # differ only by rounding: 1e-5 Frobenius / Euclidean, tighter than the
    # 1e-4 the port is held to end to end
    for p in range(src.shape[0]):
        assert np.linalg.norm(got.rotation[p] - np.asarray(ref.rotation[p])) < 1e-5
        assert np.linalg.norm(got.translation[p] - np.asarray(ref.translation[p])) < 1e-5
        assert np.linalg.norm(got.rotation[p] - r_true[p]) < 1e-2
        assert np.linalg.norm(got.translation[p] - t_true[p]) < 1e-2
    assert got.rotation_iterations[0] > 1
    assert got.clique_mask[2, 120:].sum() == 0
    assert got.scale_pair_mask.shape == (3, 0)


def test_register_pair_single_problem_equals_batch_row(batch):
    src, dst, valid, _, _ = batch
    params = params_from_jax(BENCH_PARAMS)
    one = register_pair(src[2:3], dst[2:3], params, valid=valid[2:3], device="cpu")
    full = solve_batch(src, dst, params, valid, device="cpu")
    assert one.rotation.shape == (1, 3, 3) and one.clique_mask.shape == (1, 160)
    assert torch.equal(one.clique_mask[0], full.clique_mask[2])
    assert torch.allclose(one.rotation[0], full.rotation[2], atol=1e-6)


def test_mismatched_shapes_raise(batch):
    src, dst, valid, _, _ = batch
    params = params_from_jax(BENCH_PARAMS)
    with pytest.raises(ValueError, match="3, N"):
        solve_batch(src, dst[:, :, :100], params, device="cpu")
    with pytest.raises(ValueError, match="3, N"):
        solve_batch(src[:, :2], dst[:, :2], params, device="cpu")


def _scaled_problem(rng, n, s, outlier_frac=0.6, nb=0.01):
    """scripts/bench_scale_est.py's recipe: cloud in [-1, 1]^3, dst = s R src
    + t, uniform noise +-nb/2, outliers uniform in [-4, 4]^3."""
    src = rng.uniform(-1, 1, (3, n))
    r = random_rotation(rng)
    t = rng.normal(size=3) * 0.5
    dst = s * r @ src + t[:, None] + rng.uniform(-nb / 2, nb / 2, (3, n))
    out = rng.choice(n, size=int(outlier_frac * n), replace=False)
    dst[:, out] = rng.uniform(-4, 4, (3, out.size))
    return src, dst, r, t


@pytest.fixture(scope="module")
def scaled_batch():
    """Three scaled problems, the last padded from 90 to 120 points."""
    rng = np.random.default_rng(11)
    probs = [_scaled_problem(rng, n, s) for n, s in ((120, 1.4), (120, 0.7), (90, 1.9))]
    src, dst, valid = pad_problems([p[0] for p in probs], [p[1] for p in probs],
                                   multiple=40)
    return (src.astype(np.float32), dst.astype(np.float32), valid,
            np.array([1.4, 0.7, 1.9]), [p[2] for p in probs], [p[3] for p in probs])


@pytest.mark.parametrize("mode", ["NONE", "KCORE_HEU"])
def test_register_batch_unknown_scale_matches_jax(scaled_batch, mode):
    src, dst, valid, s_true, r_true, t_true = scaled_batch
    jp = JParams(noise_bound=0.01, estimate_scaling=True,
                 inlier_selection_mode=JMode[mode], kcore_heuristic_threshold=0.0)
    # compiled once: eager dispatch compiles every op
    want = jax.jit(lambda s, d, v: jpipe.register_batch(s, d, jp, v))(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid))
    stage_ms = {}
    got = solution_to_numpy(register_batch(src, dst, params_from_jax(jp), valid,
                                           device="cpu", stage_ms=stage_ms))
    assert set(stage_ms) == {"scale", "clique", "chain_tims", "rotation", "translation"}
    for f in ("valid", "scale_pair_mask", "clique_mask", "rotation_inlier_mask",
              "translation_inlier_mask", "rotation_iterations"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), f)
    # float32 TLS scale (K = 7,140 events) and GNC rounds summed in another
    # order: the same events and inlier sets win, the values differ by rounding
    np.testing.assert_allclose(got.scale, np.asarray(want.scale), rtol=1e-5)
    np.testing.assert_allclose(got.rotation, np.asarray(want.rotation), atol=1e-5)
    np.testing.assert_allclose(got.translation, np.asarray(want.translation), atol=1e-5)
    assert got.scale_pair_mask.shape == (3, 120 * 119 // 2)
    assert not got.clique_mask[2, 90:].any()
    for p in range(3):
        assert abs(got.scale[p] - s_true[p]) < 1e-2
        assert np.linalg.norm(got.rotation[p] - r_true[p]) < 2e-2
        assert np.linalg.norm(got.translation[p] - t_true[p]) < 5e-2
    # solve_batch is the same call
    again = solution_to_numpy(solve_batch(src, dst, params_from_jax(jp), valid, device="cpu"))
    np.testing.assert_array_equal(again.rotation, got.rotation)
