"""Port parity for the pluggable stage estimators (reference
setScale/Rotation/TranslationEstimator, registration.h:623-644): the port's
``RobustRegistrationSolver`` in float64 against the JAX package's facade
under x64, on ``tests/test_custom_estimators.py``'s problem, compared
through every getter."""

import numpy as np
import torch

import teaserpp_tpu as J

from test_torch_registration import _assert_getters_match, _check_truth, _solvers
from conftest import make_registration_problem

torch.set_num_threads(1)


def _custom_problem():
    rng = np.random.default_rng(12345)
    return make_registration_problem(rng, n=80, outlier_ratio=0.5, noise=0.005,
                                     translation_scale=0.5)


def test_custom_scale_and_rotation_estimators_match_jax():
    """Scale and rotation replaced; the built-in translation runs."""
    src, dst, s_true, r_true, t_true, _ = _custom_problem()
    seen = []

    def fixed_scale(src_tims, dst_tims):
        seen.append((src_tims.shape, dst_tims.shape, src_tims.dtype))
        return s_true, np.ones(src_tims.shape[1], bool)

    def oracle_rotation(src_tims, dst_tims):
        res_sq = np.sum((dst_tims - r_true @ src_tims) ** 2, axis=0)
        return r_true, res_sq < (0.02 / s_true) ** 2, 0.0

    jparams = J.RobustRegistrationSolverParams(
        noise_bound=0.01, estimate_scaling=True, max_clique_num_threads=1)
    js, ps = _solvers(jparams)
    for solver in (js, ps):
        solver.setScaleEstimator(fixed_scale)
        solver.setRotationEstimator(oracle_rotation)
    js.solve(src, dst)
    sol = ps.solve(src, dst)
    k = 80 * 79 // 2
    assert seen == [((3, k), (3, k), np.float64)] * 2
    _assert_getters_match(ps, js)
    assert sol.scale == s_true
    np.testing.assert_array_equal(sol.rotation, r_true)
    assert np.linalg.norm(sol.translation - t_true) < 0.05
    assert ps.getGNCRotationCostAtTermination() == 0.0


def test_custom_translation_estimator_matches_jax():
    """Translation replaced, on the COMPLETE graph; the built-in scale and
    rotation run, and the estimators survive ``reset``."""
    src, dst, s_true, r_true, t_true, _ = _custom_problem()

    def median_translation(aligned_src, dst_pts):
        raw = dst_pts - aligned_src
        t = np.median(raw, axis=1)
        return t, np.linalg.norm(raw - t[:, None], axis=0) < 0.05

    jparams = J.RobustRegistrationSolverParams(
        noise_bound=0.01, estimate_scaling=True, max_clique_num_threads=1,
        rotation_tim_graph=J.InlierGraphFormulation.COMPLETE)
    js, ps = _solvers(jparams)
    for solver in (js, ps):
        solver.setTranslationEstimator(median_translation)
        solver.reset(solver.getParams())
    js.solve(src, dst)
    sol = ps.solve(src, dst)
    _assert_getters_match(ps, js)
    _check_truth(sol, s_true, r_true, t_true, s_tol=0.05, r_tol=0.01, t_tol=0.05)
    ps.setTranslationEstimator(None)  # back to the built-in stage
    assert ps.solve(src, dst).valid
