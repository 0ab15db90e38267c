"""Each TRIM kernel and kernel G against its plain PyTorch version on the
card, exactly, one test a shape: K1 (``trim_bits``, whole and as a mesh
rank's row slab), K2 (``trim_degrees``), K3 (``trim_adjacency_i8``) and the
greedy clique (``greedy_clique``), at the shapes of PERF.md's table of
kernels and at small hard ones; the tile kernels' compiled task numbering,
the launches the wrappers refuse, and the bound of K3's approximate square
root over every float. Kernel S is held in ``tests/test_torch_tls_sweep.py``.

Each output a kernel receives uninitialised lands on an allocator block
filled with a pattern first, so a word that no thread stores shows as a
difference. Marked ``chip``: skips without a CUDA card. No JAX; on a machine
with an H100::

    python -m pytest tests/test_torch_chip_kernels.py -m chip --noconftest -p no:cacheprovider
"""

import ctypes

import numpy as np
import pytest
import torch

from chip_support import (
    ADJACENCY_CASES,
    GREEDY_CASES,
    GREEDY_SEEDS,
    LARGE_N,
    N_POINTS,
    adjacency_case,
    cuda_card,  # noqa: F401 (a fixture)
    greedy_case,
    kernel_inputs,
    poison_allocator,
    slab_cases,
    to_device,
)
from teaserpp_tpu_torch.clique.kcore import active_degrees
from teaserpp_tpu_torch.ops import _build
from teaserpp_tpu_torch.ops import cuda_kernels as ck
from teaserpp_tpu_torch.ops.tims import trim_adjacency_dense

pytestmark = pytest.mark.chip

K1_CASES = ["main", "huge", "large", "scattered", "one_point", "two_blocks", "gathered_subset"]


@pytest.fixture(scope="module")
def inputs(cuda_card):
    return kernel_inputs()


def _on_poison(kernel, device, shape, dtype):
    """``kernel()``'s output, which must land on a block filled first."""
    poisoned_at = poison_allocator(device, shape, dtype)
    got = kernel()
    assert got.numel() == 0 or got.data_ptr() == poisoned_at, "not on the filled block"
    return got


def _task_library():
    lib = _build.load_library("trim_bits")
    lib.trim_bits_task_count.argtypes = [ctypes.c_int]
    lib.trim_bits_task_count.restype = ctypes.c_longlong
    lib.trim_bits_decode_tasks.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    lib.trim_bits_decode_tasks.restype = None

    def decode(t0: int, count: int, words: int) -> np.ndarray:
        out = np.empty((count, 3), np.int32)
        lib.trim_bits_decode_tasks(t0, count, words, out.ctypes.data)
        return out

    return lib.trim_bits_task_count, decode


@pytest.mark.parametrize("n", [1, 31, 33, 257, N_POINTS, 10007, LARGE_N])
def test_tile_tasks_cover_each_unordered_block_once(n, cuda_card):
    """``csrc/trim_tile.cuh``'s ``trim::decode_task``, read back through the
    built library: every unordered 32x32 block of a problem in one task."""
    task_count, decode = _task_library()
    words = (n + 31) // 32
    seen = np.zeros((words, words), np.int32)
    for row_block, col_block0, active in decode(0, int(task_count(words)), words):
        assert 0 <= row_block <= col_block0 and active >= 1 and col_block0 + active <= words
        seen[row_block, col_block0:col_block0 + active] += 1
    assert np.array_equal(seen, np.triu(np.ones_like(seen)))


@pytest.mark.parametrize("words", [3125, 65535, 370_000])
def test_tile_tasks_decode_at_the_ends_of_each_word_row(words, cuda_card):
    """The first and last task of word rows of length 1, 2, W/2, W-1 and W,
    up to the largest sizes the launch takes."""
    task_count, decode = _task_library()
    for m in (1, 2, words // 2, words - 1, words):
        (r0, c0, _), = decode(int(task_count(m - 1)), 1, words)
        (r1, c1, a1), = decode(int(task_count(m)) - 1, 1, words)
        assert (r0, c0) == (words - m, words - m) and r1 == words - m and c1 + a1 == words, m


REFUSALS = ["trim_bits batch", "trim_degrees batch", "trim_adjacency_i8 batch",
            "greedy_clique dtype", "greedy_clique shape", "greedy_clique device",
            "greedy_clique launch"]


@pytest.mark.parametrize("case", REFUSALS)
def test_what_a_launch_does_not_take_raises_and_counts_nothing(case, cuda_card):
    """A batch beyond the tile grid's second axis; the greedy clique's wrong
    dtype, shape and device, and rows too long for a block's shared memory
    (n = 1,000,000: 31,250 words a row; refused before a pointer is read)."""
    s = torch.zeros(65536, 3, 1, device=cuda_card)
    v = torch.ones(65536, 1, dtype=torch.bool, device=cuda_card)
    rows = torch.zeros(2, 40, 2, dtype=torch.int32, device=cuda_card)
    order = torch.arange(40, dtype=torch.int32, device=cuda_card).repeat(2, 1)
    allowed = torch.full((2, 2), -1, dtype=torch.int32, device=cuda_card)
    tile, greedy = RuntimeError, (TypeError, ValueError, RuntimeError)
    raises, call = {
        "trim_bits batch": (tile, lambda: ck.trim_bits(s, s, v, 0.01)),
        "trim_degrees batch": (tile, lambda: ck.trim_degrees(s, s, 0.01)),
        "trim_adjacency_i8 batch": (tile, lambda: ck.trim_adjacency_i8(s, s, 0.01)),
        "greedy_clique dtype": (greedy, lambda: ck.greedy_clique(rows.long(), order, allowed, 4)),
        "greedy_clique shape": (greedy, lambda: ck.greedy_clique(
            rows, order[:, 1:].contiguous(), allowed, 4)),
        "greedy_clique device": (greedy, lambda: ck.greedy_clique(rows, order.cpu(), allowed, 4)),
        "greedy_clique launch": (greedy, lambda: ck._launch(
            "greedy_clique", "greedy_clique", cuda_card, 0, 0, 0, 0, 0, 1, 1_000_000, 64)),
    }[case]
    ck.reset_launches()
    with pytest.raises(raises):
        call()
    assert not any(ck.LAUNCHES.values()), ck.LAUNCHES


def test_approximate_square_root_keeps_its_bound_over_every_float(cuda_card):
    """The bound K3's filter stands on (``csrc/trim_tile.cuh``'s
    GramDistPred): the kernel's square root lies within 2^-21 sqrt(x) + 2^-63
    of the IEEE one for every finite float x >= 0, checked over all of them
    by the library's own check kernel."""
    fn = _build.load_library("trim_adjacency").trim_adjacency_sqrt_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(2, dtype=torch.int64, device=cuda_card)
    assert fn(out.data_ptr(), torch.cuda.current_stream(cuda_card).cuda_stream) == 0
    torch.cuda.synchronize()
    outside, worst_ulps = (int(v) for v in out.cpu())
    assert outside == 0, worst_ulps


@pytest.mark.parametrize("case", K1_CASES)
def test_trim_bits_equals_plain(case, inputs, cuda_card):
    src, dst, valid = to_device(cuda_card, *inputs[case][:3])
    beta = inputs[case][3]
    bsz, _, n = src.shape
    got = _on_poison(lambda: ck.trim_bits(src, dst, valid, beta), cuda_card,
                     (bsz, (n + 31) // 32, n), torch.int32)
    assert torch.equal(got, ck.trim_adjacency_bits_plain(src, dst, valid, beta))


@pytest.mark.parametrize("case,rows", slab_cases(), ids=lambda v: str(v).replace(" ", ""))
def test_trim_bits_slab_equals_plain_and_the_whole_rows(case, rows, inputs, cuda_card):
    src, dst, valid = to_device(cuda_card, *inputs[case][:3])
    beta = inputs[case][3]
    got = _on_poison(lambda: ck.trim_bits(src, dst, valid, beta, rows=rows), cuda_card,
                     (src.shape[0], rows[1] - rows[0], src.shape[-1]), torch.int32)
    assert torch.equal(got, ck.trim_adjacency_bits_plain(src, dst, valid, beta, rows=rows))
    assert torch.equal(got, ck.trim_bits(src, dst, valid, beta)[:, rows[0]:rows[1]])


@pytest.mark.parametrize("case", [c for c in K1_CASES if c != "huge"])
def test_trim_degrees_equals_plain(case, inputs, cuda_card):
    """No validity mask: every point counts. At the huge problem also the
    popcounts of K1's words."""
    src, dst = to_device(cuda_card, *inputs[case][:2])
    beta = inputs[case][3]
    got = ck.trim_degrees(src, dst, beta)
    assert torch.equal(got, ck.trim_degrees_plain(src, dst, beta))
    if case == "large":
        valid = torch.ones(src.shape[0], src.shape[-1], dtype=torch.bool, device=cuda_card)
        assert torch.equal(got, active_degrees(ck.trim_bits(src, dst, valid, beta), valid))


@pytest.mark.parametrize("case", ADJACENCY_CASES)
def test_trim_adjacency_i8_equals_plain(case, inputs, cuda_card):
    """Also a zero diagonal, and at the two shapes of the table at least
    99.99% agreement with the direct distances of ``trim_adjacency_dense``
    (the Gram form may decide a pair at the threshold otherwise)."""
    s_np, d_np, beta, noise_bound = adjacency_case(case, inputs)
    src, dst = to_device(cuda_card, s_np, d_np)
    bsz, _, n = src.shape
    got = _on_poison(lambda: ck.trim_adjacency_i8(src, dst, beta), cuda_card, (bsz, n, n),
                     torch.int8)
    assert torch.equal(got, ck.trim_adjacency_i8_plain(src, dst, beta))
    assert not bool(got.diagonal(dim1=-2, dim2=-1).any())
    if noise_bound is not None:
        dense = trim_adjacency_dense(src, dst, noise_bound)
        assert float((got.bool() == dense).sum(dtype=torch.float64) / dense.numel()) >= 0.9999


@pytest.mark.parametrize("case", GREEDY_CASES)
def test_greedy_clique_equals_plain(case, inputs, cuda_card):
    """Member words and sizes exactly, the members on the filled block."""
    rows, order, allowed = greedy_case(case, cuda_card, inputs)
    bsz, n, words = rows.shape
    seeds = min(GREEDY_SEEDS, n)
    poisoned_at = poison_allocator(cuda_card, (bsz, seeds, words), torch.int32)
    members, sizes = ck.greedy_clique(rows, order, allowed, seeds)
    assert members.data_ptr() == poisoned_at, "not on the filled block"
    want_members, want_sizes = ck.greedy_clique_plain(rows, order, allowed, seeds)
    assert torch.equal(members, want_members) and torch.equal(sizes, want_sizes)
