"""Port parity for every batched inlier-selection mode on the unknown-scale
branch (TLS scale -> pair-mask adjacency -> selection): the port's
``solve_batch`` against the JAX package's under KCORE_HEU at 0.1 / 0.5 /
0.99, PMC_HEU and PMC_EXACT, and with ``use_matmul_norms`` (Gram-form TIM
norms) in both packages. The problems are test_torch_clique_modes.py's:
the top k-core of the first two is no clique, so the greedy clique differs
from it where it runs. The scale pair masks are equal, so the adjacency and
the clique masks are equal exactly; the float32 TLS scale and the GNC rounds
agree to the tolerances of test_torch_pipeline.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from teaserpp_tpu.parallel.batch import solve_batch as j_solve_batch
from teaserpp_tpu_torch.convert import params_from_jax, solution_to_numpy
from teaserpp_tpu_torch.parallel.batch import solve_batch

from test_torch_clique_modes import clique_mode_batch, jax_params

torch.set_num_threads(1)

# (mode, threshold, problems whose clique differs from the top core)
MODES = [("KCORE_HEU", 0.1, []), ("KCORE_HEU", 0.5, [0, 1]), ("KCORE_HEU", 0.99, [0, 1]),
         ("PMC_HEU", 0.0, [0, 1]), ("PMC_EXACT", 0.0, [0, 1])]


def _run(mode, threshold, use_matmul_norms=False):
    src, dst, valid = clique_mode_batch()
    jp = jax_params(mode, threshold, estimate_scaling=True)
    want = j_solve_batch(jnp.asarray(src), jnp.asarray(dst), jp, jnp.asarray(valid),
                         use_matmul_norms=use_matmul_norms)
    stage_ms = {}
    got = solution_to_numpy(solve_batch(src, dst, params_from_jax(jp), valid, device="cpu",
                                        stage_ms=stage_ms, use_matmul_norms=use_matmul_norms))
    top = solution_to_numpy(solve_batch(
        src, dst, params_from_jax(jax_params("KCORE_HEU", 0.0, estimate_scaling=True)),
        valid, device="cpu", use_matmul_norms=use_matmul_norms))
    for f in ("valid", "scale_pair_mask", "clique_mask", "rotation_inlier_mask",
              "translation_inlier_mask", "rotation_iterations"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), f)
    # test_torch_pipeline.py's unknown-scale tolerances
    np.testing.assert_allclose(got.scale, np.asarray(want.scale), rtol=1e-5)
    np.testing.assert_allclose(got.rotation, np.asarray(want.rotation), atol=1e-5)
    np.testing.assert_allclose(got.translation, np.asarray(want.translation), atol=1e-5)
    assert got.scale_pair_mask.shape == (3, 128 * 127 // 2)
    assert not got.clique_mask[2, 90:].any()
    return got, stage_ms, top


@pytest.mark.parametrize("mode,threshold,differing", MODES,
                         ids=[f"{m}-{t}" for m, t, _ in MODES])
def test_unknown_scale_modes_match_jax(mode, threshold, differing):
    got, stage_ms, top = _run(mode, threshold)
    differs = (got.clique_mask != top.clique_mask).any(axis=-1)
    assert np.flatnonzero(differs).tolist() == differing
    greedy = ["greedy"] if differing else []
    assert list(stage_ms) == ["scale", "clique", *greedy, "chain_tims", "rotation",
                              "translation"]


def test_use_matmul_norms_matches_jax():
    """Gram-form TIM norms in both packages (JAX's ``use_matmul_norms``): the
    scale stage's pair masks and the greedy cliques stay equal."""
    got, _, _ = _run("PMC_HEU", 0.0, use_matmul_norms=True)
    assert got.clique_mask[:2].sum() > 0
