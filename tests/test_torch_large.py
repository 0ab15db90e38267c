"""Port parity for the huge-N single-problem slice: ``solve_large_sharded``
and ``solve_large_exact`` of the port against the JAX package on one device
(``pairs_sharding=None``), at N=512, and the port's own native clique library
against the JAX package's bridge."""

import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from teaserpp_tpu.clique import exact as jexact
from teaserpp_tpu.clique import kcore as jkcore
from teaserpp_tpu.ops import tims as jtims
from teaserpp_tpu.parallel import sharded as jsharded
from teaserpp_tpu.params import InlierSelectionMode as JMode
from teaserpp_tpu.params import RobustRegistrationSolverParams as JParams
from teaserpp_tpu_torch import LargeSolveResult, solve_large_exact, solve_large_sharded
from teaserpp_tpu_torch.clique import exact as texact
from teaserpp_tpu_torch.convert import large_result_to_numpy, params_from_jax
from teaserpp_tpu_torch.ops import _build
from teaserpp_tpu_torch.parallel import sharded as tsharded

from conftest import make_registration_problem

N = 512
TOL = 1e-4  # Frobenius (rotation) / Euclidean (translation)


def _params(noise_bound):
    return JParams(
        noise_bound=noise_bound,
        estimate_scaling=False,
        inlier_selection_mode=JMode.KCORE_HEU,
        kcore_heuristic_threshold=0.0,
    )


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(12345)
    src, dst, _, r, t, inlier = make_registration_problem(
        rng, n=N, outlier_ratio=0.8, noise=0.005)
    return src.astype(np.float32), dst.astype(np.float32), r, t, inlier


def _jax_scores(src, dst, params, blocked_threshold):
    """The ranking of sharded.py:75-90, outside its jit, to get at ``top_idx``."""
    src, dst = jnp.asarray(src), jnp.asarray(dst)
    n = src.shape[-1]
    if n > blocked_threshold:
        bits = jtims.trim_adjacency_bits(src, dst, params.noise_bound, params.cbar2)
        top_mask, _ = jkcore.max_core_from_bits(bits, n)
        deg0 = jnp.sum(jax.lax.population_count(bits), axis=-2).astype(jnp.int32)
        return jnp.where(top_mask, deg0 + n, deg0)
    adj = jtims.trim_adjacency_dense(src, dst, params.noise_bound, params.cbar2)
    return jkcore.core_numbers(adj)


# blocked_threshold 64 sends N=512 down the bit-word branch; subgraph size 40
# cuts through the tie block of the ~100 inliers' equal scores and 120 through
# a tie block of outliers, where an unordered top-k would select another set
@pytest.mark.parametrize("blocked_threshold,subgraph_size", [
    (16384, 256), (16384, 40), (64, 256), (64, 120), (64, 40),
], ids=["dense-256", "dense-40", "bits-256", "bits-120", "bits-40"])
def test_solve_large_sharded_matches_jax(problem, blocked_threshold, subgraph_size):
    src, dst, r_true, t_true, _ = problem
    jparams = _params(0.01)
    ref = large_result_to_numpy(jsharded._large_registration_jit(
        jnp.asarray(src), jnp.asarray(dst), jparams, subgraph_size, None,
        blocked_threshold))
    stage_ms = {}
    res = solve_large_sharded(
        src, dst, params_from_jax(jparams), subgraph_size=subgraph_size,
        blocked_threshold=blocked_threshold, device="cpu", stage_ms=stage_ms)
    assert isinstance(res, LargeSolveResult)
    got = large_result_to_numpy(res)
    assert set(stage_ms) == {"bits", "max_core", "score_topk", "greedy",
                             "chain_tims", "rotation", "translation"}

    # the candidate order, as a sequence
    j_score = _jax_scores(src, dst, jparams, blocked_threshold)
    _, j_top = jax.lax.top_k(j_score, subgraph_size)
    s, d = tsharded._points(src, dst, torch.device("cpu"))
    score, max_core = tsharded.candidate_scores(
        s, d, params_from_jax(jparams), blocked_threshold)
    assert np.array_equal(score.numpy(), np.asarray(j_score))
    top_idx = tsharded.top_candidates(score, subgraph_size).numpy()
    assert np.array_equal(top_idx, np.asarray(j_top))
    if subgraph_size < 256:  # a tie does straddle position m
        ranked = np.sort(np.asarray(j_score))[::-1]
        assert ranked[subgraph_size - 1] == ranked[subgraph_size]

    assert int(got.max_core) == int(ref.max_core) == int(max_core)
    assert int(got.clique_size) == int(ref.clique_size)
    np.testing.assert_array_equal(got.solution.clique_mask, ref.solution.clique_mask)
    np.testing.assert_array_equal(got.solution.valid, ref.solution.valid)
    assert np.linalg.norm(got.solution.rotation - ref.solution.rotation) < TOL
    assert np.linalg.norm(got.solution.translation - ref.solution.translation) < TOL
    # one problem in, unbatched fields out, as in the JAX package
    for name in got.solution._fields:
        assert getattr(got.solution, name).shape == getattr(ref.solution, name).shape, name
    cos = (np.trace(r_true.T @ got.solution.rotation.astype(np.float64)) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.5
    assert np.linalg.norm(got.solution.translation - t_true) < 0.02


def test_solve_large_exact_matches_jax():
    rng = np.random.default_rng(12345)
    src, dst, _, r_true, t_true, inlier = make_registration_problem(
        rng, n=N, outlier_ratio=0.85, noise=0.0005)
    src, dst = src.astype(np.float32), dst.astype(np.float32)
    jparams = _params(0.002)
    ref = large_result_to_numpy(
        jsharded.solve_large_exact(src, dst, jparams, None, num_threads=2))
    got = large_result_to_numpy(solve_large_exact(
        src, dst, params_from_jax(jparams), num_threads=2, device="cpu"))
    np.testing.assert_array_equal(got.solution.clique_mask, ref.solution.clique_mask)
    assert int(got.clique_size) == int(ref.clique_size) == got.solution.clique_mask.sum()
    assert int(got.max_core) == int(ref.max_core)
    assert np.linalg.norm(got.solution.rotation - ref.solution.rotation) < TOL
    assert np.linalg.norm(got.solution.translation - ref.solution.translation) < TOL
    # the planted inliers are mutually consistent: the exact clique holds them all
    assert (got.solution.clique_mask & inlier).sum() == inlier.sum()
    heu = solve_large_sharded(src, dst, params_from_jax(jparams), subgraph_size=256,
                              device="cpu")
    assert int(got.clique_size) >= int(heu.clique_size)
    assert np.linalg.norm(got.solution.translation - t_true) < 0.01


def test_unpack_bits_rows_matches_jax(rng):
    adj = rng.random((70, 70)) < 0.3
    j_bits = np.asarray(jkcore.pack_bits_u32_rows(jnp.asarray(adj)))
    t_bits = torch.from_numpy(j_bits.view(np.int32).copy())
    assert np.array_equal(tsharded._unpack_bits_rows(t_bits, 70), adj)
    assert np.array_equal(jsharded._unpack_bits_rows(j_bits, 70), adj)


def _random_graph(rng, n, density, planted):
    a = rng.random((n, n)) < density
    idx = rng.choice(n, size=planted, replace=False)
    a[np.ix_(idx, idx)] = True
    a = np.triu(a, 1)
    return a | a.T


def _near_clique(rng, m, x, o, p_out):
    """A front end's graph in small: m inliers (a clique), x near-inliers
    each missing edges to 1-4 inliers and to 5% of the other near-inliers,
    o outliers with edges of probability p_out; vertices shuffled."""
    n = m + x + o
    a = rng.random((n, n)) < p_out
    a[:m + x, :m + x] = True
    for v in range(m, m + x):
        a[v, rng.choice(m, size=rng.integers(1, 5), replace=False)] = False
        a[v, m + np.nonzero(rng.random(x) < 0.05)[0]] = False
    a = np.triu(a, 1)
    a = a | a.T
    perm = rng.permutation(n)
    return a[np.ix_(perm, perm)]


@pytest.mark.parametrize("seed", [1, 2])
def test_exact_clique_of_a_near_clique_is_exact_and_quick(seed):
    """The coloring search alone took 30 s on such a graph of 1,060
    vertices (and minutes at the front end's 13,000); past its budget of
    work the near-clique search finishes the job: a clique of the size the
    benchmark's plain reference finds by its own exact search."""
    from regbench.run import load_module

    ref = load_module("reference", "fpfh_frontend")
    known = load_module("reference", "registration")
    adj = _near_clique(np.random.default_rng(seed), 400, 60, 600, 0.05)
    t0 = time.perf_counter()
    clique, timed_out = texact.exact_max_clique(adj, time_limit=60.0, num_threads=1)
    elapsed = time.perf_counter() - t0
    a = torch.from_numpy(adj)
    want, decided = ref.max_clique(a, known.degrees(a[None])[0])
    assert decided and not timed_out
    assert len(clique) == int(want.sum()) > 400
    assert adj[np.ix_(clique, clique)].sum() == len(clique) * (len(clique) - 1)
    assert elapsed < 15.0


def _with_cover_gadget(adj, rng):
    """``adj`` with 14 vertices joined to all of its top core and to each
    other but for a bipartite graph of misses (6 vertices on one side, 8 of
    2-6 misses each on the other) on which covering the misses greedily by
    the most misses takes the 8 where the least cover is the 6."""
    n = len(adj)
    top = np.nonzero(texact.native_core_numbers(adj) == texact.native_core_numbers(adj).max())[0]
    miss = np.zeros((14, 14), bool)
    start = {}
    for r, d in enumerate([6, 5, 4, 3, 3, 2, 2, 2], start=6):
        left = [(start.get(d, 0) + k) % 6 for k in range(d)]
        start[d] = start.get(d, 0) + d
        miss[r, left] = miss[left, r] = True
    out = np.zeros((n + 14, n + 14), bool)
    out[:n, :n] = adj
    out[n:, top] = out[top, n:] = True
    out[n:, n:] = ~miss
    np.fill_diagonal(out, False)
    perm = rng.permutation(n + 14)
    return out[np.ix_(perm, perm)]


@pytest.mark.parametrize("graph", ["near_clique", "near_clique_with_cover_gadget"])
def test_near_clique_search_matches_the_jax_bridge(graph):
    """Two graphs on which the coloring search passes its budget of work and
    the near-clique search decides the answer: the clique's size is the JAX
    package's bridge's (PMC's coloring search alone, run to its end)."""
    if graph == "near_clique":
        adj = _near_clique(np.random.default_rng(2), 400, 60, 600, 0.05)
    else:
        adj = _with_cover_gadget(_near_clique(np.random.default_rng(1), 400, 60, 600, 0.05),
                                 np.random.default_rng(11))
    t_clique, t_timed_out = texact.exact_max_clique(adj, time_limit=60.0, num_threads=1)
    j_clique, j_timed_out = jexact.exact_max_clique(adj, time_limit=60.0, num_threads=1)
    assert not t_timed_out and not j_timed_out
    assert len(t_clique) == len(j_clique) > 400
    assert adj[np.ix_(t_clique, t_clique)].sum() == len(t_clique) * (len(t_clique) - 1)


def test_native_library_matches_the_jax_bridge(rng):
    adj = _random_graph(rng, 130, 0.25, 14)
    t_clique, t_timed_out = texact.exact_max_clique(adj, num_threads=1)
    j_clique, _ = jexact.exact_max_clique(adj, num_threads=1)
    assert not t_timed_out and t_clique == j_clique
    assert adj[np.ix_(t_clique, t_clique)].sum() == len(t_clique) * (len(t_clique) - 1)
    assert len(t_clique) >= 14
    assert np.array_equal(texact.native_core_numbers(adj), jexact.native_core_numbers(adj))
    # against the device peel of the port, too
    from teaserpp_tpu_torch.clique.kcore import core_numbers
    assert np.array_equal(texact.native_core_numbers(adj),
                          core_numbers(torch.from_numpy(adj)[None])[0].numpy())
    packed, words = texact.pack_adjacency(adj)
    j_packed, j_words = jexact.pack_adjacency(adj)
    assert words == j_words == 3 and np.array_equal(packed, j_packed)
    indptr, indices = texact.adjacency_to_csr(adj)
    j_indptr, j_indices = jexact.adjacency_to_csr(adj)
    assert np.array_equal(indptr, j_indptr) and np.array_equal(indices, j_indices)
    s_clique, _ = texact.exact_max_clique_sparse(indptr, indices, 130, num_threads=1)
    assert len(s_clique) == len(t_clique)
    assert np.array_equal(texact.native_core_numbers_csr(indptr, indices, 130),
                          jexact.native_core_numbers_csr(indptr, indices, 130))
    assert texact.exact_max_clique(np.zeros((0, 0), bool)) == ([], False)


def test_native_library_is_built_inside_the_port():
    so = _build.build("maxclique")
    assert so.parent == _build.BUILD_DIR and so.name.startswith("libmaxclique_")
    assert _build.BUILD_DIR.name == "_build"
    assert _build.BUILD_DIR.parent.name == "teaserpp_tpu_torch"
    assert "maxclique" in _build.host_sources() and "maxclique" not in _build.sources()
    assert set(_build.sources()) == {"trim_bits", "trim_degrees", "trim_adjacency",
                                     "greedy_clique", "tls_sweep", "gnc_tls", "neighbor_plans"}


def test_large_result_to_numpy_takes_either_package(problem):
    src, dst, *_ = problem
    jparams = _params(0.01)
    ref = jsharded._large_registration_jit(
        jnp.asarray(src), jnp.asarray(dst), jparams, 256, None, 16384)
    ref_np = large_result_to_numpy(ref)
    assert type(ref_np) is type(ref)
    assert isinstance(ref_np.solution.rotation, np.ndarray)
    assert isinstance(ref_np.max_core, np.ndarray)


def test_mesh_and_bad_input_raise(problem, monkeypatch):
    """A mesh that is no port Mesh raises TypeError; a (1, 1) mesh without a
    process group gives the mesh=None result."""
    from teaserpp_tpu_torch.parallel.multihost import make_mesh

    src, dst, *_ = problem
    params = params_from_jax(_params(0.01))
    mesh = make_mesh()
    for solve in (solve_large_sharded, solve_large_exact):
        with pytest.raises(TypeError, match="Mesh"):
            solve(src, dst, params, mesh=object(), device="cpu")
        got = large_result_to_numpy(solve(src, dst, params, mesh=mesh, device="cpu"))
        want = large_result_to_numpy(solve(src, dst, params, device="cpu"))
        assert int(got.max_core) == int(want.max_core)
        for g, w in zip(got.solution, want.solution):
            assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
        with pytest.raises(ValueError, match="3, N"):
            solve(src[None], dst[None], params, device="cpu")
        with pytest.raises(ValueError, match="3, N"):
            solve(src, dst[:, :100], params, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for solve in (solve_large_sharded, solve_large_exact):
        with pytest.raises(RuntimeError, match="CUDA"):
            solve(src, dst, params)
