"""Port parity: the binary-search top core, the fixed-k core and the greedy
heuristic clique against the JAX package. Integer logic only, so every mask,
size and core number must be equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from teaserpp_tpu.clique import heuristic as jheu
from teaserpp_tpu.clique import kcore as jkcore
from teaserpp_tpu_torch.clique import heuristic as theu
from teaserpp_tpu_torch.clique import kcore as tkcore

torch.set_num_threads(1)


def _graph(rng, n, density, planted):
    """Symmetric random graph with a planted clique on random vertices."""
    a = rng.random((n, n)) < density
    idx = rng.choice(n, size=planted, replace=False)
    a[np.ix_(idx, idx)] = True
    a = np.triu(a, 1)
    return a | a.T, idx


CASES = [(45, 0.1, 9), (70, 0.3, 20), (97, 0.05, 30), (64, 0.5, 12)]  # N not all multiples of 32


@pytest.mark.parametrize("with_valid", [False, True], ids=["all_valid", "masked"])
def test_max_core_and_kcore_mask_from_bits_match_jax(rng, with_valid):
    n_pad = max(c[0] for c in CASES)
    adj = np.zeros((len(CASES), n_pad, n_pad), bool)
    valid = np.zeros((len(CASES), n_pad), bool)
    for p, (n, density, planted) in enumerate(CASES):
        adj[p, :n, :n], _ = _graph(rng, n, density, planted)
        valid[p, :n] = rng.random(n) < 0.9 if with_valid else True
    # the batched port works on one padded stack; JAX gets each problem alone
    adj &= valid[:, None, :] & valid[:, :, None]
    t_valid = torch.from_numpy(valid) if with_valid else None
    bits = tkcore.pack_bits_u32_rows(torch.from_numpy(adj))
    if not with_valid:  # vertices past a problem's n are isolated, not masked
        valid[:] = True
    mask, max_core = tkcore.max_core_from_bits(bits, n_pad, t_valid)
    ks = [7, 200]
    kmasks = {k: tkcore.kcore_mask_from_bits(bits, n_pad, k, t_valid) for k in ks}
    per_problem_k = torch.tensor([2, 5, 9, 4], dtype=torch.int32)
    kmask_vec = tkcore.kcore_mask_from_bits(bits, n_pad, per_problem_k, t_valid)
    assert mask.dtype == torch.bool and max_core.dtype == torch.int32
    # and the top core is the level peel's top core
    core = tkcore.core_numbers_from_bits(bits, n_pad, t_valid)
    assert torch.equal(max_core, core.amax(dim=-1))
    assert torch.equal(mask, (core >= max_core[:, None]) & torch.from_numpy(valid))
    for p in range(len(CASES)):
        j_bits = jkcore.pack_bits_u32_rows(jnp.asarray(adj[p]))
        j_valid = jnp.asarray(valid[p]) if with_valid else None
        j_mask, j_max = jkcore.max_core_from_bits(j_bits, n_pad, j_valid)
        assert int(max_core[p]) == int(j_max), p
        assert np.array_equal(mask[p].numpy(), np.asarray(j_mask)), p
        for k in ks:
            ref = jkcore.kcore_mask_from_bits(j_bits, n_pad, k, j_valid)
            assert np.array_equal(kmasks[k][p].numpy(), np.asarray(ref)), (p, k)
        ref = jkcore.kcore_mask_from_bits(j_bits, n_pad, int(per_problem_k[p]), j_valid)
        assert np.array_equal(kmask_vec[p].numpy(), np.asarray(ref)), p
    assert not kmasks[200].any()


def test_active_degrees_chunking_is_exact(rng, monkeypatch):
    adj = np.stack([_graph(rng, 97, 0.2, 10)[0] for _ in range(2)])
    bits = tkcore.pack_bits_u32_rows(torch.from_numpy(adj))
    active = torch.from_numpy(rng.random((2, 97)) < 0.7)
    whole = tkcore.active_degrees(bits, active)
    assert np.array_equal(whole.numpy(), (adj & active.numpy()[:, :, None]).sum(axis=1))
    monkeypatch.setattr(tkcore, "_DEGREE_CHUNK_WORDS", 2 * 97)  # one word row a chunk
    assert torch.equal(tkcore.active_degrees(bits, active), whole)
    mask, max_core = tkcore.max_core_from_bits(bits, 97)
    monkeypatch.undo()
    mask2, max_core2 = tkcore.max_core_from_bits(bits, 97)
    assert torch.equal(mask, mask2) and torch.equal(max_core, max_core2)


def _both(adj, valid=None, num_seeds=16, skip=None, core=None):
    ref = jheu.heuristic_max_clique(
        jnp.asarray(adj), None if valid is None else jnp.asarray(valid),
        num_seeds=num_seeds, skip=None if skip is None else jnp.asarray(skip),
        core=None if core is None else jnp.asarray(core))
    got = theu.heuristic_max_clique(
        torch.from_numpy(adj), None if valid is None else torch.from_numpy(valid),
        num_seeds=num_seeds, skip=skip,
        core=None if core is None else torch.from_numpy(np.array(core)))
    return ref, got


def _assert_same(ref, got):
    assert np.array_equal(got.mask.numpy(), np.asarray(ref.mask))
    assert int(got.size) == int(ref.size)
    assert int(got.max_core) == int(ref.max_core)
    assert np.array_equal(got.core.numpy(), np.asarray(ref.core))


@pytest.mark.parametrize("n,density,planted", CASES)
def test_heuristic_max_clique_matches_jax_on_planted_graph(rng, n, density, planted):
    adj, idx = _graph(rng, n, density, planted)
    ref, got = _both(adj)
    _assert_same(ref, got)
    members = np.nonzero(got.mask.numpy())[0]
    assert adj[np.ix_(members, members)].sum() == len(members) * (len(members) - 1)
    assert int(got.size) >= planted or density >= 0.3
    assert got.mask.dtype == torch.bool and got.core.dtype == torch.int32


def test_heuristic_with_valid_mask_and_given_core(rng):
    adj, _ = _graph(rng, 80, 0.2, 15)
    valid = rng.random(80) < 0.85
    ref, got = _both(adj, valid=valid)
    _assert_same(ref, got)
    assert not (got.mask.numpy() & ~valid).any()
    core = np.asarray(ref.core)
    ref2, got2 = _both(adj, valid=valid, core=core)
    _assert_same(ref2, got2)
    assert np.array_equal(got2.mask.numpy(), got.mask.numpy())


def test_seeds_that_finish_at_different_steps_keep_their_state():
    """Two disjoint cliques of sizes 9 and 3 with vertex 0 isolated: seeds
    in the small clique run out of candidates six steps before those in the
    large one. A finished seed that kept picking would take ``argmax`` of an
    all -1 row, vertex 0, into its clique."""
    n = 16
    adj = np.zeros((n, n), bool)
    adj[1:10, 1:10] = True
    adj[11:14, 11:14] = True
    np.fill_diagonal(adj, False)
    seeds = torch.tensor([11, 12, 1, 2, 0])
    core = torch.from_numpy(np.array(jkcore.core_numbers(jnp.asarray(adj))))
    members = theu._greedy_from_seed(
        seeds[None], torch.from_numpy(adj)[None], core[None],
        torch.zeros((1,), dtype=torch.bool))[0].numpy()
    assert members[:, 0].tolist() == [False, False, False, False, True]
    assert members.sum(axis=1).tolist() == [3, 3, 9, 9, 1]
    ref, got = _both(adj, num_seeds=n)  # every vertex a seed, isolated ones too
    _assert_same(ref, got)
    assert int(got.size) == 9 and not got.mask[0]


@pytest.mark.parametrize("skip", [True, False])
def test_skip_runs_no_greedy_step(rng, skip):
    adj, _ = _graph(rng, 50, 0.3, 10)
    ref, got = _both(adj, skip=skip)
    _assert_same(ref, got)
    assert (int(got.size) == 1) == skip
