"""Each TRIM kernel and kernel G against its plain PyTorch version on the
card, exactly, one test a shape: K1 (``trim_bits``, whole and as a mesh
rank's row slab), K2 (``trim_degrees``), K3 (``trim_adjacency_i8``) and the
greedy clique (``greedy_clique``), at the shapes of PERF.md's table of
kernels and at small hard ones; the tile kernels' compiled task numbering,
the launches the wrappers refuse, and the bound of K3's approximate square
root over every float. Kernel R (``gnc_tls``, the GNC-TLS loop) against its
plain version on the card, one test a case: equal rounds and inlier masks,
R and the cost within rounding, its bits repeating. Kernel S is held in
``tests/test_torch_tls_sweep.py``.

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
    GNC_CASES,
    GREEDY_CASES,
    GREEDY_SEEDS,
    LARGE_N,
    N_POINTS,
    adjacency_case,
    cuda_card,  # noqa: F401 (a fixture)
    gnc_tls_case,
    greedy_case,
    hash_arrays,
    kernel_inputs,
    launched,
    poison_allocator,
    run_counted,
    slab_cases,
    to_device,
)
from teaserpp_tpu_torch.clique.kcore import active_degrees
from teaserpp_tpu_torch.ops import _build
from teaserpp_tpu_torch.ops import cuda_kernels as ck
from teaserpp_tpu_torch.ops.procrustes import svd_rot
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
            "greedy_clique launch", "gnc_tls dtype", "gnc_tls shape", "gnc_tls device",
            "gnc_tls procrustes", "gnc_tls no column", "gnc_tls launch"]


@pytest.mark.parametrize("case", REFUSALS)
def test_what_a_launch_does_not_take_raises_and_counts_nothing(case, cuda_card):
    """A batch beyond the tile grid's second axis; the greedy clique's wrong
    dtype, shape and device, and rows too long for a block's shared memory
    (n = 1,000,000: 31,250 words a row; refused before a pointer is read);
    kernel R's half-precision points, a 4-D problem, ``dst`` on the host, the
    3-D Procrustes asked for a 2-D problem, problems with no column, and a
    4-D problem handed to the launch itself (refused before a pointer is
    read)."""
    s = torch.zeros(65536, 3, 1, device=cuda_card)
    v = torch.ones(65536, 1, dtype=torch.bool, device=cuda_card)
    rows = torch.zeros(2, 40, 2, dtype=torch.int32, device=cuda_card)
    order = torch.arange(40, dtype=torch.int32, device=cuda_card).repeat(2, 1)
    allowed = torch.full((2, 2), -1, dtype=torch.int32, device=cuda_card)
    pts = torch.ones(2, 3, 40, device=cuda_card)
    tile, greedy = RuntimeError, (TypeError, ValueError, RuntimeError)

    def gnc(src=pts, dst=pts, procrustes=svd_rot):
        return ck.gnc_tls(src, dst, 0.01, 1.4, 100, 1e-6, None, procrustes)

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
        "gnc_tls dtype": (TypeError, lambda: gnc(pts.half(), pts.half())),
        "gnc_tls shape": (ValueError, lambda: gnc(pts.repeat(1, 2, 1)[:, :4], pts[:, :, :4])),
        "gnc_tls device": (ValueError, lambda: gnc(dst=pts.cpu())),
        "gnc_tls procrustes": (ValueError, lambda: gnc(pts[:, :2], pts[:, :2])),
        "gnc_tls no column": (ValueError, lambda: gnc(pts[:, :, :0], pts[:, :, :0])),
        "gnc_tls launch": (RuntimeError, lambda: ck._launch(
            "gnc_tls", "gnc_tls", cuda_card, 0, 0, 0, 0, 0.01, 0, 0, 0, 0, 2, 4, 40, 1.4, 100,
            1e-6, 0)),
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


def _gnc_tolerances(dtype):
    """(R, relative cost) tolerances of kernel R against its plain version.
    The two take their sums over the N columns in other orders, so H, the
    max residual and the cost differ by a few ulps of each sum; R moves by
    that over the Procrustes' eigengap (~1e-7 in float32). A weight between
    0 and 1 is ``sqrt(nb^2 mu (mu + 1) / r) - mu``, whose cancellation at
    mu ~ 1.4^rounds (1e7 after 50 rounds) turns those ulps into ~1e-3 of a
    weight in float32, and the cost, a sum of weights times residuals, by up
    to ~1e-4 of itself; 1e-3 leaves room. Float64 has 2^29 times less
    rounding."""
    return (1e-5, 1e-3) if dtype == torch.float32 else (1e-9, 1e-9)


def _gnc_agree(got, want, rows, args) -> None:
    """Kernel R's outputs ``got`` against the plain version's ``want`` on the
    problems ``rows``: equal inlier masks (weights >= 0.5; >= 0.4 for
    Quatro), R and the cost within ``_gnc_tolerances``."""
    threshold = 0.5 if args["procrustes"] is svd_rot else 0.4
    assert torch.equal(got[1][rows] >= threshold, want[1][rows] >= threshold)
    r_tol, cost_tol = _gnc_tolerances(args["src"].dtype)
    torch.testing.assert_close(got[0][rows], want[0][rows], rtol=0.0, atol=r_tol)
    torch.testing.assert_close(got[2][rows], want[2][rows], rtol=cost_tol, atol=0.0)


def _gnc_ties(args, got, want) -> list:
    """The problems whose rounds differ, each checked to stop at a tie: with
    both versions cut at k - 1 and at k rounds (k the fewer), they agree
    there (``_gnc_agree``), and the cost change of round k lies below
    ``cost_threshold`` in one and not in the other, so the two stopping
    tests fell on either side of the threshold by rounding alone."""
    ties = torch.nonzero(got[3] != want[3])[:, 0].tolist()
    for p in ties:
        k = int(min(got[3][p], want[3][p]))
        cut = [[fn(**dict(args, max_iterations=m)) for m in (k - 1, k)]
               for fn in (ck.gnc_tls, ck.gnc_tls_plain)]
        stops = []
        for before, at in cut:
            assert int(at[3][p]) == k
            stops.append(bool(abs(at[2][p] - before[2][p]) < args["cost_threshold"]))
        for m in (0, 1):
            _gnc_agree(cut[0][m], cut[1][m], [p], args)
        assert stops[0] != stops[1], (p, k)
    return ties


# The bunny's problems, on which every problem takes the same rounds
GNC_BUNNY = ("bunny_batch", "facade", "complete_graph")


@pytest.mark.parametrize("case", GNC_CASES)
def test_gnc_tls_equals_plain(case, inputs, cuda_card):
    """One launch, the weights on a block filled first; equal rounds, and
    ``_gnc_agree``, on every problem, except on the synthetic cases a
    problem whose stopping test falls on the threshold within rounding
    (``_gnc_ties``; cost thresholds of 1e-6 against costs of ~1e-2)."""
    args = gnc_tls_case(case, cuda_card, inputs)
    bsz, _, n = args["src"].shape
    poisoned_at = poison_allocator(cuda_card, (bsz, n), args["src"].dtype)
    got, launches = run_counted(lambda: ck.gnc_tls(**args))
    assert launches == launched(gnc_tls=1)
    assert got[1].data_ptr() == poisoned_at, "not on the filled block"
    want = ck.gnc_tls_plain(**args)
    ties = _gnc_ties(args, got, want)
    assert not (ties and case in GNC_BUNNY), ties
    same = [p for p in range(bsz) if p not in ties]
    _gnc_agree(got, want, same, args)
    if case == "degenerate":  # mu0 <= 0, and no valid column: round 0 stops both
        assert got[3][:2].tolist() == [1, 1] and bool(torch.isinf(got[2][:2]).all())
    if case == "outliers_100":
        assert int(got[3].min()) >= 10


def test_gnc_tls_repeats_bit_for_bit_and_alone(inputs, cuda_card):
    """The bunny batch three times, hashing alike; and problems solved alone,
    equal bit for bit to their rows of the batch (a block a problem, every
    sum in one fixed order)."""
    args = gnc_tls_case("bunny_batch", cuda_card, inputs)
    outs = [ck.gnc_tls(**args) for _ in range(3)]
    assert len({hash_arrays(*(t.cpu().numpy() for t in out)) for out in outs}) == 1
    for p in (0, 255, 511):
        one = {k: args[k][p:p + 1] for k in ("src", "dst", "valid", "noise_bound")}
        alone = ck.gnc_tls(**dict(args, **one))
        assert all(torch.equal(a[0], b[p]) for a, b in zip(alone, outs[0])), p
