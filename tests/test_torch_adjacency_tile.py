"""What the dense int8 adjacency kernel ``trim_adjacency_i8`` stands on.

The CUDA kernel (``csrc/trim_adjacency.cu``) evaluates each unordered 32x32
block of pairs once, through the tile loop of ``csrc/trim_tile.cuh``, and
stores both orientations from the bit words. That is right only if its plain
version's output is a symmetric matrix, byte for byte: held here on random
clouds and on a near-threshold input, where rounding alone decides the
neighbours' pairs, and against the JAX package's Pallas kernel (interpret
mode). The kernel's write schedule and its stores are modelled here: every
block of the output is stored once, and every byte once, with the right
value, at any alignment of the output. The kernel itself is held against the plain version on the card, byte for byte,
by ``tests/test_torch_chip_kernels.py``.
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
NEAR_BETA = 2.0 ** -8
# spacings of the near-threshold input: exact in binary, 12 significant bits
NEAR_SPACINGS = ((2 ** 11 + 1) * 2.0 ** -17, (2 ** 9 + 3) * 2.0 ** -15)

_CSRC = Path(ck.__file__).resolve().parent.parent / "csrc"
_KERNEL = (_CSRC / "trim_adjacency.cu").read_text()
# row and column blocks a side of the kernel's block task (its kGroup)
GROUP = int(re.search(r"constexpr int kColBlocks = (\d+);",
                      (_CSRC / "trim_tile.cuh").read_text()).group(1))


def _clouds(rng, n):
    src = rng.uniform(-1, 1, (3, n)).astype(np.float32)
    dst = (src + rng.normal(scale=0.003, size=(3, n))).astype(np.float32)
    idx = rng.choice(n, size=n // 2, replace=False)
    dst[:, idx] += rng.uniform(1, 4, size=(3, n // 2)).astype(np.float32)
    return src, dst


def _near_threshold(n, h):
    """Colinear points (i h, 0, 0) and (i (h + beta), 0, 0): the true distance
    difference of i and i + 1 is exactly beta, and the Gram form's rounding
    decides on which side those pairs fall."""
    i = np.arange(n, dtype=np.float64)
    src = np.zeros((3, n), np.float32)
    dst = np.zeros((3, n), np.float32)
    src[0], dst[0] = i * h, i * (h + NEAR_BETA)
    assert np.array_equal(src[0], i * h) and np.array_equal(dst[0], i * (h + NEAR_BETA))
    return src, dst


def _plain(src, dst, beta):
    out = ck.trim_adjacency_i8_plain(torch.from_numpy(src)[None], torch.from_numpy(dst)[None],
                                     beta)
    return out[0].numpy()


@pytest.mark.parametrize("case", ["random", "near_threshold"])
@pytest.mark.parametrize("n", [1, 31, 33, 257])
def test_plain_is_a_symmetric_matrix_byte_for_byte(rng, n, case):
    if case == "random":
        src, dst = _clouds(rng, n)
        beta = BETA
    else:
        src, dst = _near_threshold(n, NEAR_SPACINGS[0])
        beta = NEAR_BETA
    adj = _plain(src, dst, beta)
    assert adj.dtype == np.int8 and set(np.unique(adj)) <= {0, 1}
    assert np.array_equal(adj, adj.T)
    assert not adj.diagonal().any()
    if n > 1:
        assert adj.any()


@pytest.mark.parametrize("h", NEAR_SPACINGS)
def test_near_threshold_input_puts_neighbours_on_both_sides(h):
    """The input is what it claims: at N = 257 rounding keeps some of the
    pairs |i - j| = 1 and drops others, all exactly beta apart in truth."""
    adj = _plain(*_near_threshold(257, h), NEAR_BETA)
    neighbours = np.diagonal(adj, 1)
    assert 0 < neighbours.sum() < neighbours.size
    assert np.array_equal(adj, adj.T)


@pytest.mark.parametrize("h", NEAR_SPACINGS)
def test_plain_agrees_with_pallas_interpret_near_threshold(h):
    from jax.experimental.pallas import tpu as pltpu
    from teaserpp_tpu.ops import pallas_kernels as pk

    src, dst = _near_threshold(257, h)
    with pltpu.force_tpu_interpret_mode():
        adj_p = np.asarray(pk.trim_adjacency_pallas(
            jnp.asarray(src), jnp.asarray(dst), NEAR_BETA, tile=128))
    got = _plain(src, dst, NEAR_BETA)
    # as in test_torch_kernels23.py: XLA may sum the Pallas kernel's product
    # in its own order
    assert (got == adj_p).mean() >= 0.9999


# The kernel's write schedule at block level, modelled in numpy: block task
# (S, g) has warp w take row block I = 4 S + w against the column blocks of
# group g on or right of the diagonal; it stores those blocks (rows of block
# I) and, off the diagonal, their transposes (rows of block J).

def _decode_block_tasks(t, groups):
    """Block task numbers -> (S, g), decode_block_task vectorised."""
    m = np.clip(np.sqrt(2.0 * t).astype(np.int64), 1, groups)
    while True:
        down = (m > 1) & (m * (m - 1) // 2 > t)
        up = m * (m + 1) // 2 <= t
        if not (down.any() or up.any()):
            break
        m = m - down + up
    S = groups - m
    return S, S + t - m * (m - 1) // 2


@pytest.mark.parametrize("n", [1, 31, 33, 257, 1889, 10007, 46341])
def test_adjacency_stores_cover_every_block_once(n):
    words = (n + 31) // 32
    groups = (words + GROUP - 1) // GROUP
    S, g = _decode_block_tasks(np.arange(groups * (groups + 1) // 2, dtype=np.int64), groups)
    assert (g >= S).all() and (g < groups).all()
    assert len(set(zip(S.tolist(), g.tolist()))) == S.size  # no task twice
    stored = np.zeros((words, words), np.int64)
    for w in range(GROUP):
        I = GROUP * S + w
        j0 = np.maximum(GROUP * g, I)
        active = np.minimum(GROUP * g + GROUP, words) - j0
        for c in range(GROUP):
            live = (I < words) & (c < active)
            i, j = I[live], j0[live] + c
            np.add.at(stored, (i, j), 1)  # rows of block I over block J
            off = i != j  # a diagonal block is stored once
            np.add.at(stored, (j[off], i[off]), 1)  # rows of block J over block I
    assert np.array_equal(stored, np.ones((words, words), np.int64))
    # offsets past 2^31 at the largest N: the kernel's are 64-bit
    assert (n * n > 2 ** 31) == (n == 46341)


# The kernel's stores, byte by byte, modelled in numpy: block tasks (a group
# of 4 row blocks S against a group of 4 column blocks g >= S, numbered as
# decode_block_task numbers them), each warp's words as trim_tile.cuh leaves
# them, staged in both orientations, then one run per output row: its whole
# 16-byte aligned slots as 16-byte stores and the bytes on either side of
# them a byte a lane. The text of the formulas is tied to the source.


def test_store_formulas_are_the_kernels():
    for text in ("constexpr int kGroup = trim::kColBlocks;",
                 "((x & 0xFu) * 0x00204081u) & 0x01010101u",
                 "tile.col_block0 = max(kGroup * g, tile.row_block);",
                 "tile.active = min(kGroup * g + kGroup, words) - tile.col_block0;",
                 "up.len = live ? min(32 * (kGroup * g + kGroup), n) - 32 * tile.col_block0 : 0;",
                 "lo.len = 32 * min(kGroup * S + kGroup, J) - kRun * S;",
                 "const uintptr_t slot = ((at + 15) & ~static_cast<uintptr_t>(15)) + 16 * k;",
                 "if (slot + 16 > at + runs.len) return;",
                 "const uintptr_t b = e < h ? at + e : tail + (e - h);",
                 "S = groups - static_cast<int>(m);",
                 "g = S + static_cast<int>(t - m * (m - 1) / 2);"):
        assert text in _KERNEL, text


def _block_tasks(groups):
    """decode_block_task over every block task: rows of increasing length."""
    out = []
    for t in range(groups * (groups + 1) // 2):
        m = max(1, min(int(math.sqrt(2.0 * t)), groups))
        while m > 1 and m * (m - 1) // 2 > t:
            m -= 1
        while m * (m + 1) // 2 <= t:
            m += 1
        S = groups - m
        out.append((S, S + t - m * (m - 1) // 2))
    return out


def _run_pieces(a0, length):
    """(address, width) of a run's stores: its whole 16-byte aligned slots
    (lanes k = 0..7, store_slot) and the bytes outside them (lanes
    m = 0..15, store_edge_bytes)."""
    if length <= 0:
        return []
    a1 = a0 + length
    f0, f1 = (a0 + 15) & ~15, a1 & ~15
    slots = [(f0 + 16 * k, 16) for k in range(12) if f0 + 16 * k + 16 <= a1]
    assert len(slots) <= 8  # the kernel gives a run eight lanes
    head_end = min(f0, a1)
    tail = max(f1, head_end)
    h = head_end - a0
    edge = [(a0 + e if e < h else tail + (e - h), 1) for e in range(h + a1 - tail)]
    return slots + edge


def _simulate_stores(adj, base=0):
    """The kernel's output for the symmetric 0/1 matrix ``adj`` (zero
    diagonal) at address ``base``, and how often each byte was stored."""
    n = adj.shape[0]
    words = (n + 31) // 32
    groups = (words + GROUP - 1) // GROUP
    pad = np.zeros((32 * GROUP * groups, 32 * GROUP * groups), np.int8)
    pad[:n, :n] = adj
    flat = np.full(n * n, 0x5A, np.int8)
    count = np.zeros(n * n, np.int64)
    for S, g in _block_tasks(groups):
        assert g >= S
        upper = np.zeros((GROUP, 32, 32 * GROUP), np.int8)
        lower = np.zeros((32 * GROUP, 32 * GROUP), np.int8)
        tiles = []
        for w in range(GROUP):
            I = GROUP * S + w
            j0 = max(GROUP * g, I)
            active = min(GROUP * g + GROUP, words) - j0
            live = I < words and active > 0
            tiles.append((I, j0, live))
            for J in range(j0, j0 + active) if live else ():
                block = pad[32 * I:32 * I + 32, 32 * J:32 * J + 32]
                x = 32 * (J - GROUP * g)
                upper[w, :, x:x + 32] = block
                if J != I:
                    lower[x:x + 32, 32 * w:32 * w + 32] = block.T
        for w, (I, j0, live) in enumerate(tiles):
            J = GROUP * g + w
            runs = []
            for r in range(32):  # upper runs: rows of row block I
                i = 32 * I + r
                c0, c1 = 32 * j0, min(32 * (GROUP * g + GROUP), n)
                if live and i < n:
                    runs.append((i, c0, c1, upper[w, r, c0 - 32 * GROUP * g:]))
            for l in range(32):  # lower runs: rows of column block J
                j = 32 * J + l
                c0, c1 = 32 * GROUP * S, 32 * min(GROUP * S + GROUP, J)
                if J < words and j < n and c1 > c0:
                    runs.append((j, c0, c1, lower[32 * w + l]))
            for row, c0, c1, staged in runs:
                assert c1 - c0 <= 32 * GROUP
                a0 = base + row * n + c0
                for at, width in _run_pieces(a0, c1 - c0):
                    assert at % width == 0
                    flat[at - base:at - base + width] = staged[at - a0:at - a0 + width]
                    count[at - base:at - base + width] += 1
    return flat.reshape(n, n), count.reshape(n, n)


@pytest.mark.parametrize("n,base", [(1, 0), (2, 0), (31, 0), (33, 0), (33, 5), (35, 0),
                                    (257, 0), (257, 3), (16, 0), (48, 0), (96, 0), (272, 8)])
def test_stores_write_every_byte_once(rng, n, base):
    upper = np.triu(rng.random((n, n)) < 0.3, 1)
    adj = (upper | upper.T).astype(np.int8)
    out, count = _simulate_stores(adj, base)
    assert np.array_equal(count, np.ones((n, n), np.int64))
    assert np.array_equal(out, adj)


@pytest.mark.parametrize("a0", range(16))
def test_run_pieces_cover_a_run_once(a0):
    """Every length a run can have, at every alignment: whole 16-byte slots
    from at most eight lanes, at most 30 bytes around them, no byte twice;
    at a 16-byte aligned start and length, slots only."""
    for length in range(1, 32 * GROUP + 1):
        pieces = _run_pieces(a0, length)
        covered = sorted(b for at, width in pieces for b in range(at, at + width))
        assert covered == list(range(a0, a0 + length))
        assert all(at % width == 0 for at, width in pieces)
        assert sum(width == 1 for _, width in pieces) <= 30
        if a0 % 16 == 0 and length % 16 == 0:
            assert all(width == 16 for _, width in pieces)


def test_bit_to_byte_expansion_over_all_inputs():
    x = np.arange(16, dtype=np.uint64)
    got = ((x * np.uint64(0x00204081)) & np.uint64(0xFFFFFFFF)) & np.uint64(0x01010101)
    want = sum(((x >> np.uint64(k)) & np.uint64(1)) << np.uint64(8 * k) for k in range(4))
    assert np.array_equal(got, want)
    # the 16-byte store: every 16-bit input
    x16 = np.arange(1 << 16, dtype=np.uint64)
    parts = [((x16 >> np.uint64(4 * k)) & np.uint64(0xF)) * np.uint64(0x00204081)
             & np.uint64(0x01010101) for k in range(4)]
    as_bytes = np.stack([(p >> np.uint64(8 * b)) & np.uint64(0xFF)
                         for p in parts for b in range(4)], axis=1)
    want16 = (x16[:, None] >> np.arange(16, dtype=np.uint64)[None]) & np.uint64(1)
    assert np.array_equal(as_bytes, want16)
