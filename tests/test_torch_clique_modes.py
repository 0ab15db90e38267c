"""Port parity for every batched inlier-selection mode on the known-scale
branch: the port's ``solve_batch`` against the JAX package's ``solve_batch``
under KCORE_HEU at thresholds 0.1 / 0.35 / 0.5 / 0.99, PMC_HEU and PMC_EXACT (both
packages run the batched greedy clique for the last two), and with
``use_matmul_norms`` (which this branch ignores in both).

The problems are built so that the modes disagree: in the first two a second
rigid group with noise past the bound is a dense subgraph that is not a
clique and holds the top k-core (max cores 34 and 36 of 100 vertices), so
the greedy clique differs from it; the third is 60 inliers of 90 (max core
59). So KCORE_HEU's shortcut fires on every problem at 0.1, on the last two
at 0.35, on the last at 0.5 and on none at 0.99: batches whose greedy lanes
are skipped per problem. The port's known-scale branch reads K1's bit words,
whose predicate is the JAX dense adjacency's bit for bit, so the clique
masks are equal exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from teaserpp_tpu.params import InlierSelectionMode as JMode
from teaserpp_tpu.params import RobustRegistrationSolverParams as JParams
from teaserpp_tpu.parallel.batch import solve_batch as j_solve_batch
from teaserpp_tpu_torch.convert import params_from_jax, solution_to_numpy
from teaserpp_tpu_torch.parallel.batch import pad_problems, solve_batch

from conftest import random_rotation

torch.set_num_threads(1)

NOISE_BOUND = 0.001

# (mode, threshold, problems whose greedy clique differs from the top core);
# the top k-core itself (KCORE_HEU at 0) is held against JAX in
# test_torch_pipeline.py
MODES = [("KCORE_HEU", 0.1, []), ("KCORE_HEU", 0.35, [0]), ("KCORE_HEU", 0.5, [0, 1]),
         ("KCORE_HEU", 0.99, [0, 1]), ("PMC_HEU", 0.0, [0, 1]), ("PMC_EXACT", 0.0, [0, 1])]
MODE_IDS = [f"{m}-{t}" for m, t, _ in MODES]


def _problem(rng, n, n_in, n_group, group_noise):
    """``n_in`` inliers of one rigid motion (noise +-nb/2), ``n_group``
    points of a second motion with noise +-``group_noise``, the rest uniform
    in [-1, 1]^3; the order shuffled."""
    src = rng.uniform(0.0, 0.15, (3, n))
    dst = rng.uniform(-1.0, 1.0, (3, n))
    r, t = random_rotation(rng), rng.uniform(-0.2, 0.2, 3)
    dst[:, :n_in] = (r @ src[:, :n_in] + t[:, None]
                     + rng.uniform(-NOISE_BOUND / 2, NOISE_BOUND / 2, (3, n_in)))
    group = slice(n_in, n_in + n_group)
    dst[:, group] = (random_rotation(rng) @ src[:, group]
                     + rng.uniform(-group_noise, group_noise, (3, n_group)))
    perm = rng.permutation(n)
    return src[:, perm], dst[:, perm]


def clique_mode_batch(seed=5):
    """Three problems, the last padded from 90 to 128 points -> (src, dst)
    float32 (3, 3, 128) and valid (3, 128)."""
    rng = np.random.default_rng(seed)
    probs = [_problem(rng, 100, 18, 40, 0.0012), _problem(rng, 100, 22, 40, 0.0010),
             _problem(rng, 90, 60, 0, 0.0)]
    src, dst, valid = pad_problems([p[0] for p in probs], [p[1] for p in probs],
                                   multiple=32)
    return src.astype(np.float32), dst.astype(np.float32), valid


def jax_params(mode, threshold, estimate_scaling):
    return JParams(noise_bound=NOISE_BOUND, cbar2=1.0, estimate_scaling=estimate_scaling,
                   rotation_cost_threshold=0.005, inlier_selection_mode=JMode[mode],
                   kcore_heuristic_threshold=threshold)


def assert_solutions_match(got, want, top_core, differing):
    """Masks, iterations and validity equal; R and t within the 1e-5 that
    test_torch_pipeline.py holds the threshold-0 path to; the clique differs
    from the top core on the problems listed in ``differing`` alone."""
    for f in ("valid", "clique_mask", "rotation_inlier_mask", "translation_inlier_mask",
              "rotation_iterations", "scale_pair_mask"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), f)
    for p in range(got.rotation.shape[0]):
        assert np.linalg.norm(got.rotation[p] - np.asarray(want.rotation[p])) < 1e-5
        assert np.linalg.norm(got.translation[p] - np.asarray(want.translation[p])) < 1e-5
    differs = (got.clique_mask != top_core).any(axis=-1)
    assert np.flatnonzero(differs).tolist() == differing
    assert got.clique_mask[2].sum() == 60 and not got.clique_mask[2, 90:].any()


def run_case(mode, threshold, differing, estimate_scaling, use_matmul_norms=False):
    src, dst, valid = clique_mode_batch()
    jp = jax_params(mode, threshold, estimate_scaling)
    want = j_solve_batch(jnp.asarray(src), jnp.asarray(dst), jp, jnp.asarray(valid),
                         use_matmul_norms=use_matmul_norms)
    stage_ms = {}
    got = solution_to_numpy(solve_batch(src, dst, params_from_jax(jp), valid, device="cpu",
                                        stage_ms=stage_ms, use_matmul_norms=use_matmul_norms))
    top = solution_to_numpy(solve_batch(
        src, dst, params_from_jax(jp.replace(inlier_selection_mode=JMode.KCORE_HEU,
                                             kcore_heuristic_threshold=0.0)),
        valid, device="cpu"))
    assert_solutions_match(got, want, top.clique_mask, differing)
    return got, stage_ms


@pytest.mark.parametrize("mode,threshold,differing", MODES, ids=MODE_IDS)
def test_known_scale_modes_match_jax(mode, threshold, differing):
    got, stage_ms = run_case(mode, threshold, differing, estimate_scaling=False)
    # the greedy runs, and is timed, unless the shortcut holds everywhere
    greedy = ["greedy"] if differing else []
    assert list(stage_ms) == ["bits", "peel", *greedy, "chain_tims", "rotation",
                              "translation"]
    assert got.scale_pair_mask.shape == (3, 0)


def test_known_scale_ignores_use_matmul_norms():
    """Both packages take ``use_matmul_norms`` and ignore it on the bits
    branch."""
    got, _ = run_case("PMC_HEU", 0.0, [0, 1], estimate_scaling=False, use_matmul_norms=True)
    src, dst, valid = clique_mode_batch()
    plain = solution_to_numpy(solve_batch(
        src, dst, params_from_jax(jax_params("PMC_HEU", 0.0, False)), valid, device="cpu"))
    np.testing.assert_array_equal(got.rotation, plain.rotation)
