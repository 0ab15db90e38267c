"""What the tile kernels ``trim_bits`` and ``trim_degrees`` stand on.

Both CUDA kernels evaluate each unordered pair of a problem once and use the
result for both orientations (``csrc/trim_tile.cuh``). That is right only if
the row-packed TRIM words are a symmetric matrix, bit for bit: held here
against the plain PyTorch version and against the JAX package's Pallas kernel
(interpret mode), also at pairs that sit exactly on the threshold. The
kernels' task numbering is modelled here and must cover every unordered
32x32 block of pairs once. The kernels themselves, and their compiled task
decode, are held on the card by ``tests/test_torch_chip_kernels.py``.
"""

import math
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from teaserpp_tpu_torch.ops import cuda_kernels as ck

BETA = 0.01


def _unpack(words: np.ndarray, n: int) -> np.ndarray:
    """(ceil(n/32), n) uint32 row-packed words -> (n, n) bool adjacency:
    bit r of word [w, j] is entry [32 w + r, j]."""
    bits = (words[:, None, :] >> np.arange(32, dtype=np.uint32)[None, :, None]) & 1
    return bits.reshape(-1, words.shape[-1])[:n].astype(bool)


def _plain_words(src, dst, valid, beta):
    out = ck.trim_adjacency_bits_plain(
        torch.from_numpy(src)[None], torch.from_numpy(dst)[None],
        torch.from_numpy(valid)[None], beta)
    return out[0].numpy().view(np.uint32)


def _clouds(rng, n):
    src = rng.uniform(-1, 1, (3, n)).astype(np.float32)
    dst = (src + rng.normal(scale=0.002, size=(3, n))).astype(np.float32)
    idx = rng.choice(n, size=n // 2, replace=False)
    dst[:, idx] += rng.uniform(1, 4, size=(3, n // 2)).astype(np.float32)
    return src, dst


def _threshold_clouds():
    """Pairs exactly on the threshold, in float32: ``src`` a 4x4x4 integer
    lattice with two duplicated points, ``dst = 1.5 src``, beta 0.5. Every
    coordinate, squared distance and product is exactly representable, and
    lattice neighbours (distance 1 against 1.5) give
    ``d*d == b2*(2s - b2) == 1.5625``. -> (src, dst, beta, on_threshold)."""
    grid = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij")).reshape(3, -1)
    src = np.concatenate([grid, grid[:, [5, 5]]], axis=1).astype(np.float32)
    dst = (1.5 * src).astype(np.float32)
    beta, b2 = 0.5, np.float32(0.25)
    ds = ((src[:, :, None] - src[:, None, :]) ** 2).sum(0, dtype=np.float32)
    dd = ((dst[:, :, None] - dst[:, None, :]) ** 2).sum(0, dtype=np.float32)
    s, d = ds + dd, ds - dd
    on_threshold = d * d == b2 * (np.float32(2) * s - b2)
    return src, dst, beta, on_threshold


def _assert_symmetric(adj: np.ndarray, valid: np.ndarray) -> None:
    assert np.array_equal(adj, adj.T)
    assert not adj.diagonal().any()
    assert not adj[~valid].any() and not adj[:, ~valid].any()


@pytest.mark.parametrize("n", [1, 31, 33, 257])
def test_plain_words_are_a_symmetric_matrix(rng, n):
    src, dst = _clouds(rng, n)
    valid = rng.random(n) < 0.7  # scattered, not a suffix
    adj = _unpack(_plain_words(src, dst, valid, BETA), n)
    _assert_symmetric(adj, valid)
    if n > 1:
        assert adj.any() and valid.any() and not valid.all()


def test_plain_words_are_symmetric_on_the_threshold():
    src, dst, beta, on_threshold = _threshold_clouds()
    n = src.shape[-1]
    assert on_threshold.sum() >= 2 * 100  # the lattice's neighbour pairs
    valid = np.ones(n, bool)
    valid[[7, 40]] = False
    adj = _unpack(_plain_words(src, dst, valid, beta), n)
    _assert_symmetric(adj, valid)
    # `<=` holds at equality, in both orientations, and for duplicated points
    live = valid[:, None] & valid[None, :] & ~np.eye(n, dtype=bool)
    assert adj[on_threshold & live].all()
    assert adj[5, 64] and adj[64, 65] and adj[65, 5]


@pytest.mark.parametrize("case", ["random", "threshold"])
def test_pallas_interpret_words_are_symmetric_and_equal_plain(rng, case):
    from jax.experimental.pallas import tpu as pltpu
    from teaserpp_tpu.ops import pallas_kernels as pk

    if case == "random":
        src, dst = _clouds(rng, 150)
        beta = BETA
    else:
        src, dst, beta, _ = _threshold_clouds()
    n = src.shape[-1]
    with pltpu.force_tpu_interpret_mode():
        words = np.asarray(pk.trim_adjacency_bits_pallas(
            jnp.asarray(src), jnp.asarray(dst), beta, rows=64, cols=128))
    valid = np.ones(n, bool)
    _assert_symmetric(_unpack(words, n), valid)
    assert np.array_equal(words, _plain_words(src, dst, valid, beta))


# The tasks of ``csrc/trim_tile.cuh``, modelled in Python. The tests below
# hold the numbering scheme (that such a schedule covers the triangle once,
# and that an integer-corrected square root decodes it at any size); they do
# not run the CUDA source. The compiled ``decode_task`` itself is held by
# ``tests/test_torch_chip_kernels.py``, which reads it back through the built library's
# ``trim_bits_decode_tasks`` and makes the same two checks on it.
_HEADER = Path(ck.__file__).resolve().parent.parent / "csrc" / "trim_tile.cuh"
COL_BLOCKS = int(re.search(r"constexpr int kColBlocks = (\d+);", _HEADER.read_text()).group(1))


def _tasks_upto(m: int) -> int:
    """Tasks of all word rows of length 1..m (the header's ``tasks_upto``)."""
    q, rem = divmod(m, COL_BLOCKS)
    return COL_BLOCKS * q * (q + 1) // 2 + rem * (q + 1)


def _tile_task(t: int, words: int):
    """The header's ``decode_task``: task number -> (I, J0, active)."""
    m = max(1, min(int(math.sqrt(2.0 * COL_BLOCKS * t)), words))
    while m > 1 and _tasks_upto(m - 1) > t:
        m -= 1
    while _tasks_upto(m) <= t:
        m += 1
    row_block = words - m
    col_block0 = row_block + COL_BLOCKS * (t - _tasks_upto(m - 1))
    return row_block, col_block0, min(COL_BLOCKS, words - col_block0)


@pytest.mark.parametrize("n", [1, 31, 33, 257, 1889, 10007])
def test_tile_tasks_cover_every_unordered_block_once(n):
    words = (n + 31) // 32
    tasks = _tasks_upto(words)
    assert tasks == sum(-(-(words - i) // COL_BLOCKS) for i in range(words))
    seen = np.zeros((words, words), int)
    for t in range(tasks):
        row_block, col_block0, active = _tile_task(t, words)
        assert 0 <= row_block <= col_block0 and 1 <= active <= COL_BLOCKS
        assert col_block0 + active <= words
        seen[row_block, col_block0:col_block0 + active] += 1
    assert np.array_equal(seen, np.triu(np.ones((words, words), int)))


def test_tile_task_decode_is_exact_at_the_largest_sizes():
    """The square-root estimate is corrected in integers: first, last and
    boundary tasks of every row decode right where a float would not. (Of
    the model above; see the note there.)"""
    for words in (3125, 65535, 370_000):
        starts = {}
        for m in (1, 2, words // 2, words - 1, words):
            starts[m] = _tasks_upto(m - 1)
        for m, first in starts.items():
            last = _tasks_upto(m) - 1
            assert _tile_task(first, words)[:2] == (words - m, words - m)
            row_block, col_block0, active = _tile_task(last, words)
            assert row_block == words - m and col_block0 + active == words

