"""Port parity of the problem-batched clique pieces: the greedy clique over a
(B, N, N) batch against ``jax.vmap`` of the JAX package's
``heuristic_max_clique`` (per-problem ``skip``, given core numbers, padded
vertices, lanes that finish at different steps), the two dense peels
``core_numbers_matvec`` / ``core_numbers_bitset`` against JAX's, the
device unpack of row-packed words, and the pipeline's clique stage
functions in three modes against ``jax.vmap`` of JAX's
``device_clique_from_adjacency``. Integer logic only: every mask, size and
core number must be equal."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from teaserpp_tpu.clique import heuristic as jheu
from teaserpp_tpu.clique import kcore as jkcore
from teaserpp_tpu.params import InlierSelectionMode as JMode
from teaserpp_tpu.params import RobustRegistrationSolverParams as JParams
from teaserpp_tpu.solvers import pipeline as jpipe
from teaserpp_tpu_torch.clique import heuristic as theu
from teaserpp_tpu_torch.clique import kcore as tkcore
from teaserpp_tpu_torch.convert import params_from_jax
from teaserpp_tpu_torch.parallel.sharded import _unpack_bits_rows
from teaserpp_tpu_torch.solvers import pipeline as tpipe

N_PAD = 72  # not a multiple of 32


def _graph(rng, n, density, planted):
    a = rng.random((n, n)) < density
    idx = rng.choice(n, size=planted, replace=False)
    a[np.ix_(idx, idx)] = True
    a = np.triu(a, 1)
    return a | a.T


def _two_cliques(n):
    """Cliques of 9 and 3 with vertex 0 isolated: lanes seeded in the small
    one finish six steps before those in the large one."""
    adj = np.zeros((n, n), bool)
    adj[1:10, 1:10] = True
    adj[11:14, 11:14] = True
    np.fill_diagonal(adj, False)
    return adj


@pytest.fixture(scope="module")
def batch():
    """Five problems padded to N_PAD: random graphs of several densities with
    planted cliques (two with padding), the two-cliques graph, and an empty
    one."""
    rng = np.random.default_rng(21)
    adj = np.zeros((5, N_PAD, N_PAD), bool)
    valid = np.zeros((5, N_PAD), bool)
    for p, (n, density, planted) in enumerate(((72, 0.2, 12), (60, 0.4, 15), (45, 0.1, 9))):
        adj[p, :n, :n] = _graph(rng, n, density, planted)
        valid[p, :n] = True
    valid[0, rng.choice(72, 6, replace=False)] = False  # scattered padding
    adj[3, :20, :20] = _two_cliques(20)
    valid[3, :20] = True
    valid[4, :5] = True  # five isolated vertices
    return adj, valid


def _jax_batched(adj, valid, num_seeds, skip=None, core=None):
    fn = jax.jit(jax.vmap(
        lambda a, v, s, c: jheu.heuristic_max_clique(a, valid=v, num_seeds=num_seeds,
                                                     skip=s, core=c),
        in_axes=(0, 0, None if skip is None else 0, None if core is None else 0)))
    return fn(jnp.asarray(adj), jnp.asarray(valid),
              None if skip is None else jnp.asarray(skip),
              None if core is None else jnp.asarray(core))


@pytest.mark.parametrize("num_seeds", [8, 64])
@pytest.mark.parametrize("given", ["none", "core_and_skip"])
def test_batched_greedy_matches_jax_vmap(batch, num_seeds, given):
    adj, valid = batch
    skip = core = None
    if given == "core_and_skip":
        skip = np.array([False, True, False, False, False])
        core = np.stack([np.asarray(jkcore.core_numbers(jnp.asarray(adj[p] & valid[p][None]
                                                                    & valid[p][:, None]),
                                                        jnp.asarray(valid[p])))
                         for p in range(adj.shape[0])])
    ref = _jax_batched(adj, valid, num_seeds, skip, core)
    got = theu.heuristic_max_clique(
        torch.from_numpy(adj), valid=torch.from_numpy(valid), num_seeds=num_seeds,
        skip=None if skip is None else torch.from_numpy(skip),
        core=None if core is None else torch.from_numpy(core))
    for f in ("mask", "size", "max_core", "core"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)
    sizes = got.size.tolist()
    assert sizes[3] == 9 and not got.mask[3, 0]  # the finished lanes kept their state
    assert not (got.mask.numpy() & ~valid).any()
    if skip is not None:
        assert sizes[1] == 1  # a skipped problem's clique is its best seed alone
    for p in range(adj.shape[0]):  # every mask is a clique
        members = np.flatnonzero(got.mask[p].numpy())
        assert adj[p][np.ix_(members, members)].sum() == len(members) * (len(members) - 1)


def test_single_problem_is_a_batch_of_one(batch):
    adj, valid = batch
    one = theu.heuristic_max_clique(torch.from_numpy(adj[0]), valid=torch.from_numpy(valid[0]),
                                    num_seeds=16)
    full = theu.heuristic_max_clique(torch.from_numpy(adj), valid=torch.from_numpy(valid),
                                     num_seeds=16)
    assert one.mask.shape == (N_PAD,) and one.size.dim() == 0 and one.max_core.dim() == 0
    assert torch.equal(one.mask, full.mask[0]) and int(one.size) == int(full.size[0])


@pytest.mark.parametrize("with_valid", [False, True])
def test_dense_peels_match_jax(batch, with_valid):
    adj, valid = batch
    t_valid = torch.from_numpy(valid) if with_valid else None
    t_adj = torch.from_numpy(adj)
    matvec = tkcore.core_numbers_matvec(t_adj, t_valid)
    bitset = tkcore.core_numbers_bitset(t_adj, t_valid)
    assert matvec.dtype == bitset.dtype == torch.int32
    assert torch.equal(matvec, bitset)
    assert torch.equal(tkcore.core_numbers(t_adj, t_valid), bitset)
    for p in range(adj.shape[0]):
        j_valid = jnp.asarray(valid[p]) if with_valid else None
        np.testing.assert_array_equal(
            matvec[p].numpy(), np.asarray(jkcore.core_numbers_matvec(jnp.asarray(adj[p]), j_valid)))
        np.testing.assert_array_equal(
            bitset[p].numpy(), np.asarray(jkcore.core_numbers_bitset(jnp.asarray(adj[p]), j_valid)))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 72])
def test_unpack_bits_rows_inverts_the_packing(n):
    rng = np.random.default_rng(n)
    mask = rng.random((2, 3, n, n + 5)) < 0.5
    bits = tkcore.pack_bits_u32_rows(torch.from_numpy(mask))
    got = tkcore.unpack_bits_u32_rows(bits, n)
    assert got.dtype == torch.bool and got.shape == mask.shape
    np.testing.assert_array_equal(got.numpy(), mask)
    np.testing.assert_array_equal(got[1, 2].numpy(), _unpack_bits_rows(bits[1, 2], n))


@pytest.mark.parametrize("mode,threshold", [("KCORE_HEU", 0.0), ("KCORE_HEU", 0.3),
                                            ("PMC_EXACT", 0.0)])
def test_clique_stage_functions_match_jax(batch, mode, threshold):
    """``device_clique_from_adjacency`` against ``jax.vmap`` of JAX's, and
    ``device_clique_from_bits`` / ``device_clique_stage`` agreeing with it on
    the same graphs (packed words; the upper-triangle pair mask)."""
    adj, valid = batch
    jp = JParams(inlier_selection_mode=JMode[mode], kcore_heuristic_threshold=threshold,
                 max_clique_heuristic_seeds=16)
    params = params_from_jax(jp)
    want = jax.jit(jax.vmap(lambda a, v: jpipe.device_clique_from_adjacency(a, jp, v)))(
        jnp.asarray(adj), jnp.asarray(valid))
    t_adj, t_valid = torch.from_numpy(adj), torch.from_numpy(valid)
    got = tpipe.device_clique_from_adjacency(t_adj, params, t_valid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    masked = t_adj & t_valid[:, None, :] & t_valid[:, :, None]
    from_bits = tpipe.device_clique_from_bits(tkcore.pack_bits_u32_rows(masked), N_PAD,
                                              params, t_valid)
    i, j = np.triu_indices(N_PAD, k=1)
    from_pairs = tpipe.device_clique_stage(t_adj[:, i, j], N_PAD, params, t_valid)
    assert torch.equal(from_bits, got) and torch.equal(from_pairs, got)


def _tie_batch():
    """Six problems padded to 67 vertices on which ties in core number are
    the rule: five disjoint 7-cliques, a circulant 6-regular graph, a
    5-cycle of 4-cliques joined in a ring, a cycle, a problem with fewer
    valid vertices (10) than seeds, and a planted clique among equal-degree
    noise; the padding is scattered in two of them."""
    n = 67
    rng = np.random.default_rng(5)
    adj = np.zeros((6, n, n), bool)
    valid = np.ones((6, n), bool)
    for c in range(5):  # disjoint equal cliques; vertices 35.. isolated
        adj[0, 7 * c:7 * c + 7, 7 * c:7 * c + 7] = True
    i = np.arange(n)
    for k in (1, 2, 3):  # circulant: i ~ i +- 1, 2, 3
        adj[1, i, (i + k) % n] = adj[1, (i + k) % n, i] = True
    for c in range(5):  # 4-cliques on a ring, each joined to the next by one edge
        adj[2, 4 * c:4 * c + 4, 4 * c:4 * c + 4] = True
        a, b = 4 * c + 3, (4 * c + 4) % 20
        adj[2, a, b] = adj[2, b, a] = True
    adj[3, i[:61], (i[:61] + 1) % 61] = adj[3, (i[:61] + 1) % 61, i[:61]] = True
    adj[4] = _graph(rng, n, 0.3, 8)
    valid[4] = False
    valid[4, rng.choice(n, 10, replace=False)] = True  # 10 valid, fewer than the seeds
    adj[5] = _graph(rng, n, 0.15, 11)
    valid[5, rng.choice(n, 9, replace=False)] = False
    valid[1, [0, 33, 66]] = False
    idx = np.arange(n)
    adj[:, idx, idx] = False
    return adj, valid


@pytest.mark.parametrize("num_seeds", [16, 64])
@pytest.mark.parametrize("skip", [None, [False, True, False, True, False, False]],
                         ids=["run_all", "skip_mixed"])
def test_greedy_on_ties_padding_and_skip_matches_jax_vmap(num_seeds, skip):
    """Ties in core number decide nearly every pick, N = 67 is no multiple of
    32, one problem has fewer valid vertices than seeds, and skipped lanes
    run beside running ones: every mask, size and core number equals
    ``jax.vmap`` of the JAX greedy's."""
    adj, valid = _tie_batch()
    skip = None if skip is None else np.array(skip)
    ref = _jax_batched(adj, valid, num_seeds, skip)
    got = theu.heuristic_max_clique(
        torch.from_numpy(adj), valid=torch.from_numpy(valid), num_seeds=num_seeds,
        skip=None if skip is None else torch.from_numpy(skip))
    for f in ("mask", "size", "max_core", "core"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)
    sizes = got.size.tolist()
    if skip is None:
        assert sizes[0] == 7 and sizes[2] == 4 and sizes[3] == 2
    else:
        assert sizes[1] == sizes[3] == 1 and sizes[0] == 7
    assert not (got.mask.numpy() & ~valid).any()


def test_greedy_words_route_equals_dense_route():
    """K1's (B, W, N) words and the dense adjacency give the same cliques:
    the words' transpose is the dense rows' packing."""
    adj, valid = _tie_batch()
    t_adj, t_valid = torch.from_numpy(adj), torch.from_numpy(valid)
    dense = theu.heuristic_max_clique(t_adj, valid=t_valid, num_seeds=16)
    words = tkcore.pack_bits_u32_rows(t_adj)
    assert torch.equal(words.transpose(-1, -2), tkcore.pack_bits_u32(t_adj))
    got = theu.heuristic_max_clique_from_bits(words, adj.shape[-1], dense.core,
                                              valid=t_valid, num_seeds=16)
    for f in ("mask", "size", "max_core", "core"):
        assert torch.equal(getattr(got, f), getattr(dense, f)), f


@pytest.mark.parametrize("case", ["dtype", "rows_shape", "order_shape", "allowed_shape",
                                  "seeds_zero", "seeds_past_n", "device"])
def test_greedy_clique_wrapper_refuses_and_counts_nothing(case):
    from teaserpp_tpu_torch.ops import cuda_kernels as ck

    n, bsz = 40, 2
    rows = torch.zeros((bsz, n, 2), dtype=torch.int32)
    order = torch.arange(n, dtype=torch.int32).repeat(bsz, 1)
    allowed = torch.full((bsz, 2), -1, dtype=torch.int32)
    seeds = 4
    if case == "dtype":
        rows = rows.long()
    elif case == "rows_shape":
        rows = torch.zeros((bsz, n, 3), dtype=torch.int32)
    elif case == "order_shape":
        order = order[:, :-1].contiguous()
    elif case == "allowed_shape":
        allowed = allowed[:1]
    elif case == "seeds_zero":
        seeds = 0
    elif case == "seeds_past_n":
        seeds = n + 1
    else:
        rows = rows.to("meta")
    ck.reset_launches()
    with pytest.raises((TypeError, ValueError)):
        ck.greedy_clique(rows, order, allowed, seeds)
    assert ck.LAUNCHES["greedy_clique"] == 0
