"""The plain reference on small seeded problems: each piece against a
straightforward loop, and the whole against the ground truth."""

import math

import numpy as np
import pytest
import torch

from regbench.reference import registration as ref
from regbench.run import load_json, load_module

torch.set_num_threads(2)


def _problem(n=240, draws=216, seed=7):
    cfg = load_json("configs", "bunny1889")
    problem = dict(cfg["problem"], n=n, outlier_draws=draws)
    gen = load_module("generators", "bunny_box")
    src, dst = gen.make(problem, seed, range(3))
    return cfg, gen.transform(problem), torch.from_numpy(src), torch.from_numpy(dst)


def _loop_adjacency(src, dst, beta):
    s = src.astype(np.float64)
    d = dst.astype(np.float64)
    n = s.shape[1]
    adj = np.zeros((n, n), bool)
    for i in range(n):
        ds = np.linalg.norm(s[:, i:i + 1] - s, axis=0)
        dd = np.linalg.norm(d[:, i:i + 1] - d, axis=0)
        adj[i] = np.abs(ds - dd) <= beta
        adj[i, i] = False
    return adj


def _loop_core_numbers(adj):
    """Batagelj-Zaversnik peel, one vertex at a time."""
    deg = adj.sum(axis=1).astype(int)
    alive = np.ones(len(adj), bool)
    core = np.zeros(len(adj), int)
    k = 0
    while alive.any():
        v = np.flatnonzero(alive)[np.argmin(deg[alive])]
        k = max(k, deg[v])
        core[v] = k
        alive[v] = False
        deg[adj[v] & alive] -= 1
    return core


def test_graph_agrees_with_a_loop_away_from_ties():
    cfg, _, src, dst = _problem()
    beta = 2 * cfg["solver"]["noise_bound"]
    adj = ref.trim_adjacency(src, dst, beta, torch.float32)
    for p in range(src.shape[0]):
        want = _loop_adjacency(src[p].numpy(), dst[p].numpy(), beta)
        assert (adj[p].numpy() != want).sum() <= 2  # only pairs within rounding of beta
        np.testing.assert_array_equal(adj[p].numpy(), adj[p].numpy().T)


def test_top_core_is_the_peel_s_top_core():
    cfg, _, src, dst = _problem()
    adj = ref.trim_adjacency(src, dst, 2 * cfg["solver"]["noise_bound"], torch.float32)
    core = ref.top_core(adj, ref.degrees(adj))
    for p in range(src.shape[0]):
        cn = _loop_core_numbers(adj[p].numpy())
        np.testing.assert_array_equal(core[p].numpy(), cn == cn.max())


def test_top_core_search_on_a_graph_with_a_deep_core():
    g = torch.Generator().manual_seed(3)
    adj = torch.rand(2, 60, 60, generator=g) < 0.3
    adj = adj | adj.transpose(1, 2)
    adj[:, :12, :12] = True  # a 12-clique, core 11 at least
    adj &= ~torch.eye(60, dtype=torch.bool)
    core = ref.top_core(adj, ref.degrees(adj))
    for p in range(2):
        cn = _loop_core_numbers(adj[p].numpy())
        np.testing.assert_array_equal(core[p].numpy(), cn == cn.max())


def test_chain_tims_match_a_loop():
    v = torch.randn(2, 3, 9, dtype=torch.float64)
    mask = torch.tensor([[0, 1, 1, 0, 0, 1, 0, 1, 0], [1, 0, 0, 0, 0, 0, 0, 0, 1]], dtype=torch.bool)
    got = ref.chain_tims(v, mask)
    for p in range(2):
        sel = np.flatnonzero(mask[p].numpy())
        want = np.zeros((3, 9))
        for a, b in zip(sel, np.roll(sel, -1)):
            want[:, a] = (v[p, :, b] - v[p, :, a]).numpy()
        np.testing.assert_allclose(got[p].numpy(), want)


def _loop_tls(x, beta):
    events = sorted([(xi - beta, 0, i) for i, xi in enumerate(x)]
                    + [(xi + beta, 1, i) for i, xi in enumerate(x)], key=lambda e: e[0])
    open_, best, best_cost = set(), None, math.inf
    for _, kind, i in events:
        (open_.discard if kind else open_.add)(i)
        if open_:
            vals = np.array([x[j] for j in open_])
            m = vals.mean()
            cost = ((vals - m) ** 2).sum() + beta * (len(x) - len(open_))
            if cost < best_cost - 1e-15:
                best, best_cost = m, cost
    return best


def test_tls_translation_matches_a_sweep():
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(-0.01, 0.01, (3, 30)), rng.uniform(-2, 2, (3, 10))], axis=1)
    valid = np.ones(40, bool)
    valid[-3:] = False
    got = ref.tls_translation(torch.from_numpy(x)[None], torch.from_numpy(valid)[None], 0.02)
    for a in range(3):
        assert got[0, a].item() == pytest.approx(_loop_tls(x[a, valid], 0.02), abs=1e-12)


def test_procrustes_recovers_a_rotation():
    g = torch.Generator().manual_seed(1)
    q, _ = torch.linalg.qr(torch.randn(4, 3, 3, generator=g, dtype=torch.float64))
    q = q * torch.sign(torch.linalg.det(q))[:, None, None]
    x = torch.randn(4, 3, 50, generator=g, dtype=torch.float64)
    got = ref.weighted_procrustes(x, q @ x, torch.ones(4, 50, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), q.numpy(), atol=1e-12)


def test_solve_recovers_the_ground_truth():
    cfg, t, src, dst = _problem()
    sol = ref.solve(src, dst, cfg["solver"])
    assert bool(sol.decided.all())
    resid = dst.double() - (torch.from_numpy(t[:3, :3]) @ src.double() + torch.from_numpy(t[:3, 3:4]))
    truth = resid.abs().amax(dim=1) <= cfg["problem"]["noise_bound"] / 2 + 1e-6
    np.testing.assert_array_equal(sol.inliers.numpy(), truth.numpy())
    for p in range(src.shape[0]):
        ang = np.degrees(np.arccos(np.clip((np.trace(sol.rotation[p].numpy().T @ t[:3, :3]) - 1) / 2,
                                           -1, 1)))
        assert ang < 0.2
        assert np.linalg.norm(sol.translation[p].numpy() - t[:3, 3]) < 2e-3
