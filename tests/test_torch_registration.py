"""Port parity for the public solver: ``RobustRegistrationSolver`` of the
port in float64 against the JAX package's facade under x64 (as
``tests/conftest.py`` runs it), on the cases of
``tests/test_registration_e2e.py`` and ``tests/test_custom_estimators.py``:
every inlier-selection mode, GNC-TLS / FGR / Quatro, CHAIN and COMPLETE,
known and unknown scale, the correspondence overload and the degenerate
all-outlier problem, compared through every getter (the custom estimators:
``test_torch_custom_estimators.py``). Each JAX solve compiles its stages
anew, so each case here combines several of those features."""

import dataclasses

import numpy as np
import pytest
import torch

import teaserpp_tpu as J
from teaserpp_tpu.clique.graph import Graph as JGraph
from teaserpp_tpu.params import CliqueSolverMode as JCliqueMode
from teaserpp_tpu.params import MaxCliqueSolverParams as JCliqueParams
from teaserpp_tpu.utils.geometry import PointCloud
from teaserpp_tpu_torch import (
    InlierGraphFormulation,
    RegistrationSolution,
    RobustRegistrationSolver,
    RobustRegistrationSolverParams,
)
from teaserpp_tpu_torch import params as tparams
from teaserpp_tpu_torch.clique.graph import Graph, MaxCliqueSolver
from teaserpp_tpu_torch.convert import params_from_jax
from teaserpp_tpu_torch.utils.metrics import angular_error, translation_error
from teaserpp_tpu_torch.utils.timing import StageTimer

from conftest import make_registration_problem

torch.set_num_threads(1)

# float64 on both sides, the same stages in the same order: rotations and
# translations agree to a few ulps of their magnitude (observed: 1e-15), so
# 1e-9; costs are sums of residuals that may reach 1e-28, hence the atol
ATOL = 1e-9
COST_RTOL, COST_ATOL = 1e-6, 1e-12


def _solvers(jparams, **port_kw):
    jsolver = J.RobustRegistrationSolver(jparams)
    psolver = RobustRegistrationSolver(params_from_jax(jparams), device="cpu",
                                       dtype=torch.float64, **port_kw)
    return jsolver, psolver


def _assert_getters_match(ps, js):
    """Every getter of the two facades after one solve each."""
    a, b = ps.getSolution(), js.getSolution()
    assert isinstance(a, RegistrationSolution) and ps.solution is a
    assert a.valid == b.valid
    assert a.scale == pytest.approx(b.scale, abs=ATOL)
    np.testing.assert_allclose(a.rotation, b.rotation, atol=ATOL)
    np.testing.assert_allclose(a.translation, b.translation, atol=ATOL)
    assert a.rotation.dtype == a.translation.dtype == np.float64
    assert ps.getParams() == params_from_jax(js.getParams())
    ca, cb = ps.getGNCRotationCostAtTermination(), js.getGNCRotationCostAtTermination()
    if np.isfinite(cb):
        assert ca == pytest.approx(cb, rel=COST_RTOL, abs=COST_ATOL)
    else:
        assert ca == cb or (np.isnan(ca) and np.isnan(cb))
    for getter in ("getScaleInliersMask", "getScaleInliersMap", "getRotationInliersMask",
                   "getRotationInliersMap", "getTranslationInliersMask",
                   "getTranslationInliersMap", "getSrcTIMs", "getDstTIMs",
                   "getMaxCliqueSrcTIMs", "getMaxCliqueDstTIMs", "getSrcTIMsMap",
                   "getDstTIMsMap", "getSrcTIMsMapForRotation", "getDstTIMsMapForRotation"):
        x, y = getattr(ps, getter)(), getattr(js, getter)()
        if y is None:
            assert x is None, getter
            continue
        assert np.asarray(x).dtype == np.asarray(y).dtype, getter
        if getter == "getMaxCliqueDstTIMs":
            # divided by the scale estimate, whose float64 TLS sums run in
            # another order: a few ulps
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=0)
        else:
            # masks, maps and float64 differences of the same inputs: equal
            np.testing.assert_array_equal(x, np.asarray(y), getter)
    for getter in ("getScaleInliers", "getRotationInliers", "getTranslationInliers",
                   "getInputOrderedTranslationInliers", "getInlierMaxClique",
                   "getInlierGraph"):
        assert getattr(ps, getter)() == getattr(js, getter)(), getter
    for prop in ("scale_inliers_mask", "rotation_inliers", "translation_inliers_mask",
                 "inlier_max_clique", "src_tims_map_for_rotation"):
        np.testing.assert_array_equal(np.asarray(getattr(ps, prop)),
                                      np.asarray(getattr(js, prop)), prop)
    assert set(ps.getStageTimings()) == set(js.getStageTimings())


def _check_truth(sol, s, r, t, s_tol=1e-3, r_tol=0.01, t_tol=0.02):
    """tests/test_registration_e2e.py's gate."""
    assert sol.valid
    assert abs(sol.scale - s) < s_tol
    assert angular_error(sol.rotation, r) < r_tol
    assert translation_error(sol.translation, t) < t_tol


def _yaw(a):
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])


# (mode, rotation algorithm, TIM graph, estimate scale, n, outlier ratio)
CASES = [
    ("PMC_EXACT", "GNC_TLS", "CHAIN", False, 100, 0.9),
    ("PMC_HEU", "FGR", "CHAIN", False, 80, 0.6),  # gnc factor 2 (below)
    ("KCORE_HEU", "GNC_TLS", "COMPLETE", True, 60, 0.3),
    ("NONE", "QUATRO", "CHAIN", False, 60, 0.3),
]


@pytest.mark.parametrize("mode,alg,graph,scaled,n,outliers", CASES,
                         ids=[c[0] for c in CASES])
def test_facade_matches_jax(mode, alg, graph, scaled, n, outliers):
    seed = {"PMC_EXACT": 1, "PMC_HEU": 2, "KCORE_HEU": 3, "NONE": 4}[mode]
    rng = np.random.default_rng(seed)
    s_true = 1.4 if scaled else 1.0
    src, dst, s, r, t, inlier = make_registration_problem(
        rng, n=n, outlier_ratio=outliers, noise=0.002, scale=s_true)
    if alg == "QUATRO":  # Quatro estimates a yaw
        r = _yaw(0.7)
        dst[:, inlier] = s * (r @ src[:, inlier]) + t[:, None] + rng.normal(
            scale=0.002, size=(3, int(inlier.sum())))
    jparams = J.RobustRegistrationSolverParams(
        noise_bound=0.01, estimate_scaling=scaled,
        inlier_selection_mode=J.InlierSelectionMode[mode],
        rotation_estimation_algorithm=J.RotationEstimationAlgorithm[alg],
        rotation_tim_graph=J.InlierGraphFormulation[graph],
        max_clique_num_threads=1,  # one search thread: equal cliques tie alike
        # FGR anneals mu down from ~1e13 by this factor a round: 2 takes ~45
        # rounds where 1.4 takes ~90
        rotation_gnc_factor=2.0 if alg == "FGR" else 1.4,
    )
    js, ps = _solvers(jparams)
    js.solve(src, dst)
    sol = ps.solve(src, dst)
    _assert_getters_match(ps, js)
    _check_truth(sol, s, r, t)
    clique = ps.getInlierMaxClique()
    if mode == "PMC_EXACT":
        assert set(clique) == set(np.nonzero(inlier)[0].tolist())
    if mode == "NONE":
        assert clique == list(range(n)) and ps.getInlierGraph() == []
    if mode == "KCORE_HEU":  # the top core is over half the points: the shortcut
        assert len(clique) > jparams.kcore_heuristic_threshold * n
    if graph == "COMPLETE":
        m = len(clique)
        assert ps.getRotationInliersMask().shape == (m * (m - 1) // 2,)
    assert ps.getSrcTIMs().shape == (3, n * (n - 1) // 2)

    if mode == "PMC_EXACT":
        # the cloud + correspondence overload on shuffled clouds
        perm_s, perm_d = rng.permutation(n), rng.permutation(n)
        src_cloud, dst_cloud = np.empty((n, 3)), np.empty((n, 3))
        src_cloud[perm_s], dst_cloud[perm_d] = src.T, dst.T
        corr = list(zip(perm_s.tolist(), perm_d.tolist()))
        over = RobustRegistrationSolver(params_from_jax(jparams), device="cpu",
                                        dtype=torch.float64)
        sol2 = over.solve(PointCloud(src_cloud), dst_cloud, corr)
        np.testing.assert_array_equal(sol2.rotation, sol.rotation)
        np.testing.assert_array_equal(sol2.translation, sol.translation)
        assert over.getInlierMaxClique() == clique


def test_degenerate_all_outliers_matches_jax():
    rng = np.random.default_rng(12345)
    n = 30
    src = rng.uniform(-1, 1, size=(3, n))
    dst = rng.uniform(-100, 100, size=(3, n))
    jparams = J.RobustRegistrationSolverParams(
        noise_bound=1e-6, estimate_scaling=False,
        inlier_selection_mode=J.InlierSelectionMode.PMC_EXACT)
    js, ps = _solvers(jparams)
    assert not js.solve(src, dst).valid
    sol = ps.solve(src, dst)
    assert not sol.valid and len(ps.getInlierMaxClique()) <= 1
    _assert_getters_match(ps, js)
    assert set(ps.getStageTimings()) == {"scale", "clique"}


def test_constructor_forms_aliases_and_stage_timer():
    p = RobustRegistrationSolver(noise_bound=0.05, estimate_scaling=False, device="cpu")
    assert p.getParams() == RobustRegistrationSolverParams(noise_bound=0.05,
                                                           estimate_scaling=False)
    q = RobustRegistrationSolver(RobustRegistrationSolverParams(), device="cpu",
                                 noise_bound=0.05)
    assert q.getParams().noise_bound == 0.05 and q.dtype == torch.float32
    assert RobustRegistrationSolver.INLIER_SELECTION_MODE is tparams.InlierSelectionMode
    assert RobustRegistrationSolver.INLIER_GRAPH_FORMULATION is InlierGraphFormulation
    assert (RobustRegistrationSolver.ROTATION_ESTIMATION_ALGORITHM
            is tparams.RotationEstimationAlgorithm)
    assert not p.getSolution().valid and p.getInlierGraph() == []
    with pytest.raises(ValueError, match="3xN"):
        p.solve(np.zeros((3, 5)), np.zeros((3, 6)))

    timer = StageTimer()
    for name in ("a", "b", "a"):
        with timer.stage(name, sync=torch.device("cpu")):
            pass
    assert timer.order == ["a", "b"] and set(timer.as_dict()) == {"a", "b"}
    assert timer.report().splitlines()[-1].startswith("total:")


def test_graph_and_clique_params_match_jax():
    rng = np.random.default_rng(9)
    adj = rng.random((25, 25)) < 0.3
    adj = adj | adj.T
    mine, theirs = Graph(adj), JGraph(adj)
    mine.addEdge(0, 24), theirs.addEdge(0, 24)
    mine.removeEdge(1, 2), theirs.removeEdge(1, 2)
    mine.addVertex(27), theirs.addVertex(27)
    assert mine.numVertices() == theirs.numVertices() == 28
    assert mine.numEdges() == theirs.numEdges()
    assert [mine.getEdges(v) for v in range(28)] == [theirs.getEdges(v) for v in range(28)]
    np.testing.assert_array_equal(mine.getAdjMatrix(), theirs.getAdjMatrix())
    edges = [(0, 1), (1, 2), (2, 0), (3, 4)]
    np.testing.assert_array_equal(Graph.from_edges(5, edges).getAdjMatrix(),
                                  JGraph.from_edges(5, edges).getAdjMatrix())
    with pytest.raises(ValueError, match="square"):
        Graph(np.zeros((2, 3), bool))

    jp = JCliqueParams(solver_mode=JCliqueMode.KCORE_HEU, kcore_heuristic_threshold=0.2,
                       num_threads=1)
    p = params_from_jax(jp)
    assert isinstance(p, tparams.MaxCliqueSolverParams)
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    assert p.solver_mode is tparams.CliqueSolverMode.KCORE_HEU
    # a triangle plus an isolated edge: every mode finds the triangle
    g = Graph.from_edges(5, edges)
    for mode in tparams.CliqueSolverMode:
        solver = MaxCliqueSolver(p.replace(solver_mode=mode, kcore_heuristic_threshold=0.0),
                                 device="cpu")
        assert solver.findMaxClique(g) == [0, 1, 2], mode
    assert MaxCliqueSolver(p, device="cpu").findMaxClique(Graph()) == []
