"""Port parity for the correspondence matcher: given the same descriptors, the
port's ``Matcher`` returns exactly the JAX package's correspondence list, on
the CPU, in every branch of the reference's matching logic, and its nearest
neighbours equal a float64 brute force in the hierarchical branch (database
of more than 4096 rows), the same-block near tie included."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from teaserpp_tpu.features.matcher import Matcher as JMatcher
from teaserpp_tpu.features.matcher import _nn_indices as j_nn
from teaserpp_tpu_torch.features.matcher import Matcher, _nn_indices

torch.set_num_threads(1)

N = 500


def _descriptors(seed, n=N, extra=0, dim=33, noise=0.5):
    rng = np.random.default_rng(seed)
    base = (rng.random((n, dim)) * 100).astype(np.float32)
    pert = base + rng.standard_normal((n, dim)).astype(np.float32) * noise
    if extra:
        pert = np.concatenate([pert, (rng.random((extra, dim)) * 100).astype(np.float32)])
    return base, pert, rng.random((n, 3)), rng.random((n + extra, 3)) * 2.0


def _both(*args):
    want = JMatcher().calculateCorrespondences(*args)
    got = Matcher(device="cpu").calculateCorrespondences(*args)
    assert got == want
    return got


@pytest.mark.parametrize("crosscheck", [True, False], ids=["crosscheck", "no-crosscheck"])
def test_matcher_equals_jax(crosscheck):
    base, pert, pts, pts2 = _descriptors(0)
    corr = _both(pts, pts2, base, pert, False, crosscheck, False, 0.0)
    assert len(corr) >= 0.9 * N
    assert all(isinstance(i, int) and isinstance(j, int) for i, j in corr)


@pytest.mark.parametrize("seed", [0, 7])
def test_matcher_tuple_test_equals_jax(seed):
    base, pert, pts, _ = _descriptors(1)
    moved = pts * 1.5 + 0.2  # lengths scale by 1.5: the tuple test at 0.6 keeps them
    corr = _both(pts, moved, base, pert, False, True, True, 0.6, seed)
    assert len(corr) > 0.9 * N
    assert _both(pts, moved, base, pert, False, True, True, 0.9, seed) == []


@pytest.mark.parametrize("larger", ["source", "target"])
def test_matcher_unequal_sizes_equal_jax(larger):
    base, pert, pts, pts2 = _descriptors(2, extra=37)
    if larger == "target":
        args = (pts, pts2, base, pert)
    else:
        args = (pts2, pts, pert, base)
    corr = _both(*args, False, True, False, 0.0)
    assert len(corr) >= 0.9 * N
    _both(*args, True, False, True, 0.8)  # absolute scale, no crosscheck, tuple test


def test_matcher_hierarchical_branch_equals_jax_and_brute_force():
    """A database of 4224 rows (33 lane blocks): the block winners and
    runners-up, then the exact rescore."""
    rng = np.random.default_rng(3)
    db = (rng.random((4224, 33)) * 100).astype(np.float32)
    pick = rng.choice(4224, 300, replace=False)
    q = db[pick] + rng.standard_normal((300, 33)).astype(np.float32) * 2.0
    corr = _both(rng.random((4224, 3)), rng.random((300, 3)), db, q, False, True, False, 0.0)
    assert len(corr) > 250
    got = _nn_indices(torch.from_numpy(q), torch.from_numpy(db)).numpy()
    want = ((q[:, None, :].astype(np.float64) - db[None].astype(np.float64)) ** 2).sum(-1)
    assert np.array_equal(got, want.argmin(1))
    assert np.array_equal(got, np.asarray(j_nn(jnp.asarray(q), jnp.asarray(db))))


def test_nn_same_block_near_tie():
    """tests/test_features.py::test_nn_hierarchical_same_block_near_tie at a
    database of 4224 rows: the true NN and a decoy in one 128-lane block,
    their exact distances ~1e-3 apart, far inside the Gram form's float32
    error; the runner-up of each block recovers every true NN."""
    rng = np.random.default_rng(4)
    n_q, n_db, lane = 33, 4224, 128
    q = (rng.random((n_q, 33)) * 100).astype(np.float32)
    db = (rng.random((n_db, 33)) * 100).astype(np.float32)
    true_idx = np.empty(n_q, np.int64)
    for i in range(n_q):
        p_true, p_decoy = i * lane + 7, i * lane + 91
        e = rng.normal(size=33)
        e = e / np.linalg.norm(e) * 5.0
        db[p_true] = q[i] + (e * np.sqrt(1.0 - 4e-5)).astype(np.float32)
        db[p_decoy] = q[i] + e.astype(np.float32)
        true_idx[i] = p_true
    d = ((q[:, None, :].astype(np.float64) - db[None].astype(np.float64)) ** 2).sum(-1)
    assert (d.argmin(1) == true_idx).all()
    got = _nn_indices(torch.from_numpy(q), torch.from_numpy(db)).numpy()
    assert np.array_equal(got, true_idx)
    assert np.array_equal(got, np.asarray(j_nn(jnp.asarray(q), jnp.asarray(db))))


def test_nn_exact_ties_pick_the_lowest_index():
    """Duplicate database rows (as zero descriptors of isolated points are):
    the lowest index wins, in both branches."""
    rng = np.random.default_rng(5)
    for n_db in (1000, 4224):
        db = (rng.random((n_db, 33)) * 100).astype(np.float32)
        db[[5, 900, n_db - 1]] = 0.0
        q = np.zeros((4, 33), np.float32)
        assert _nn_indices(torch.from_numpy(q), torch.from_numpy(db)).tolist() == [5] * 4


def test_matcher_generic_descriptor_dimension():
    """32-D descriptors (e.g. 3DSmoothNet), not only 33-bin FPFH."""
    n = 200
    rng = np.random.default_rng(6)
    src = rng.normal(size=(n, 32)).astype(np.float32)
    dst = src + rng.normal(scale=1e-3, size=(n, 32)).astype(np.float32)
    pts = rng.normal(size=(n, 3))
    corr = _both(pts, pts + 0.1, src, dst, False, True, False, 0.0)
    assert len(corr) >= 0.95 * n
    assert np.mean([i == j for i, j in corr]) > 0.95


def test_matcher_tensor_input_equals_numpy():
    """Descriptors as tensors (the front end's output) give the numpy
    correspondences; float64 input too, since the search runs in float32."""
    base, pert, pts, _ = _descriptors(8)
    m = Matcher(device="cpu")
    c_np = m.calculateCorrespondences(pts, pts, base, pert, False, True, False, 0.0)
    c_t = m.calculateCorrespondences(pts, pts, torch.from_numpy(base), torch.from_numpy(pert),
                                     False, True, False, 0.0)
    c_64 = m.calculateCorrespondences(pts, pts, base.astype(np.float64),
                                      torch.from_numpy(pert.astype(np.float64)),
                                      False, True, False, 0.0)
    assert c_np == c_t == c_64
    assert c_np == JMatcher().calculateCorrespondences(pts, pts, base, pert, False, True,
                                                       False, 0.0)
