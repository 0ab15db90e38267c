"""Kernel S (``csrc/tls_sweep.cu``): the scale TLS's sweep of the sorted events.

On the card (tests marked ``chip``; they skip without CUDA) ``scalar_tls``
through the kernel gives bit for bit what the plain version gives on the CPU:
rows of N measurements below, on and across the 64-event scan blocks, with
ties, duplicates, padding, no valid measurement and a NaN, in float32 and
float64; at one chunk of the unknown-scale batch (75 problems at N = 1,889,
267,482,400 events) in float32 and 4 of them in float64, the kernel on the
card hashes as the plain version on the card does, in 6 launches a call; and
the unknown-scale batch solve at N = 1,889 gives equal bits in one chunk of
problems and in several. On the CPU the wrapper is the plain version and
launches nothing. The file imports no JAX, so on a machine with a card and
without JAX:

    python -m pytest tests/test_torch_tls_sweep.py -m chip --noconftest -p no:cacheprovider
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_support import cuda_card, hash_arrays, tls_sweep_case  # noqa: F401 (a fixture)
from teaserpp_tpu_torch.ops import cuda_kernels as ck
from teaserpp_tpu_torch.ops.tls import ScalarTLSResult, scalar_tls

LENGTHS = [1, 2, 31, 32, 33, 1000, 1889]
DTYPES = [torch.float32, torch.float64]


def _rows(n: int, dtype: torch.dtype, seed: int = 0):
    """Seven rows of ``n`` measurements -> ``x``, ``ranges`` (7, n) and ``valid``:
    random; quantised positions with one range, so opens land on closes;
    the first half duplicated; the second half padding; no valid
    measurement; a valid NaN, whose events sort last; one range for all."""
    rng = np.random.default_rng(seed + n)
    x = rng.normal(1.0, 0.3, (7, n))
    r = rng.uniform(0.01, 0.2, (7, n))
    valid = rng.random((7, n)) < 0.9
    x[1] = np.round(x[1] * 8) / 8
    r[1] = 0.0625
    x[2, n // 2:] = x[2, :n - n // 2]
    r[2, n // 2:] = r[2, :n - n // 2]
    valid[3, (n + 1) // 2:] = False
    valid[4] = False
    x[5, n // 3] = np.nan
    valid[5, n // 3] = True
    r[6] = 0.05
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(r).to(dtype),
            torch.from_numpy(valid))


def _launches(n: int) -> int:
    """Kernel S's launches for rows of ``n`` measurements: the pack, the
    totals, a level of the carry for each stride, the sweep."""
    return 3 + len(ck._carry_strides(-(-2 * n // 64)))


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal dtype, shape and bits, signed zeros included; a NaN equals a NaN
    (the card and the CPU write NaNs of different payloads)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.dtype == torch.bool:
        return torch.equal(got, want)
    same = (got == want) & (torch.signbit(got) == torch.signbit(want))
    return bool((same | (got.isnan() & want.isnan())).all())


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    x, r, valid = _rows(100, torch.float32)
    before = dict(ck.LAUNCHES)
    got = scalar_tls(x, r, valid)
    vmask = valid.to(x.dtype)
    perm = torch.sort(torch.cat([x - r, x + r], dim=-1), dim=-1, stable=True).indices
    want = ck.tls_sweep_plain(perm, x, r, vmask)
    for a, b in zip((got.estimate, got.cost), want):
        assert _same_bits(a, b)
    for a, b in zip(ck.tls_sweep(perm, x, r, vmask), want):
        assert _same_bits(a, b)
    assert bool(got.estimate[5].isnan()) and got.cost[4] == float("inf")
    assert ck.LAUNCHES == before


@pytest.mark.parametrize("change", ["ranges_dtype", "vmask_shape", "perm_dtype", "perm_length",
                                    "x_dtype"])
def test_wrapper_refuses_what_the_kernel_does_not_take(change):
    x, r, valid = _rows(40, torch.float32)
    vmask = valid.to(x.dtype)
    perm = torch.sort(torch.cat([x - r, x + r], dim=-1), dim=-1, stable=True).indices
    args = dict(perm=perm, x=x, ranges=r, vmask=vmask)
    args.update({
        "ranges_dtype": dict(ranges=r.double()),
        "vmask_shape": dict(vmask=vmask[:, :-1]),
        "perm_dtype": dict(perm=perm.int()),
        "perm_length": dict(perm=perm[:, :-1]),
        "x_dtype": dict(x=x.half(), ranges=r.half(), vmask=vmask.half()),
    }[change])
    before = dict(ck.LAUNCHES)
    with pytest.raises((ValueError, TypeError)):
        ck.tls_sweep(**args)
    assert ck.LAUNCHES == before


@pytest.mark.chip
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
@pytest.mark.parametrize("n", LENGTHS)
def test_kernel_equals_the_plain_version_on_the_cpu(n, dtype, cuda_card):
    x, r, valid = _rows(n, dtype)
    for v in (valid, None):
        want = scalar_tls(x, r, v)
        ck.reset_launches()
        got = scalar_tls(x.to(cuda_card), r.to(cuda_card),
                         None if v is None else v.to(cuda_card))
        torch.cuda.synchronize()
        assert ck.LAUNCHES["tls_sweep"] == _launches(n)
        for name, g, w in zip(ScalarTLSResult._fields, got, want):
            assert _same_bits(g.cpu(), w), (name, g.cpu(), w)
    assert bool(want.estimate[5].isnan())


@pytest.mark.chip
def test_leading_dimensions_and_a_float32_range(cuda_card):
    """(2, 3, N) measurements, float64 positions with float32 ranges (the
    sweep runs in float64), and an empty batch."""
    x, r, valid = _rows(333, torch.float64)
    x = torch.cat([x, x[:1] * 2]).reshape(2, 4, 333)[:, 1:]  # not contiguous
    r, valid = r[:6].reshape(2, 3, 333).float(), valid[:6].reshape(2, 3, 333)
    want = scalar_tls(x, r, valid)
    got = scalar_tls(x.to(cuda_card), r.to(cuda_card), valid.to(cuda_card))
    for g, w in zip(got, want):
        assert _same_bits(g.cpu(), w)
    empty = scalar_tls(x[:0].to(cuda_card), r[:0].to(cuda_card))
    assert empty.estimate.shape == (0, 3) and empty.inliers.shape == (0, 3, 333)
    with pytest.raises(ValueError):
        scalar_tls(x[..., :0].to(cuda_card), r[..., :0].to(cuda_card))


@pytest.mark.chip
@pytest.mark.parametrize("case", ["chunk", "float64"])
def test_one_chunk_of_the_unknown_scale_batch_hashes_as_the_plain_version(case, cuda_card):
    perm, x, ranges, vmask = tls_sweep_case(case, cuda_card)
    ck.reset_launches()
    got = ck.tls_sweep(perm, x, ranges, vmask)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["tls_sweep"] == _launches(x.shape[-1]) == 6
    want = ck.tls_sweep_plain(perm, x, ranges, vmask)
    assert hash_arrays(*(t.cpu().numpy() for t in got)) == hash_arrays(
        *(t.cpu().numpy() for t in want))


def _unknown_scale_batch(batch: int):
    """``batch`` problems of the unknown-scale cell's configuration (N = 1,889)."""
    from regbench.entries._params import solver_params
    from regbench.run import load_json, load_module

    config = load_json("configs", "bunny1889_unknown_scale")
    src, dst = load_module("generators", config["generator"]).make(
        config["problem"], 2 ** 33 + 18, range(batch))
    return src, dst, solver_params(config["solver"])


@pytest.mark.chip
def test_chunks_of_problems_give_equal_bits_on_the_card(cuda_card, monkeypatch):
    from teaserpp_tpu_torch import solve_batch
    from teaserpp_tpu_torch.solvers import pipeline

    src, dst, params = _unknown_scale_batch(64)
    n = src.shape[-1]
    events = n * (n - 1)  # 2K a problem
    src, dst = torch.from_numpy(src).to(cuda_card), torch.from_numpy(dst).to(cuda_card)
    runs = []
    for per in (64, 9):  # one chunk; chunks of 9 (7 x 9 + 1)
        monkeypatch.setattr(pipeline, "SCALE_CHUNK_EVENTS", per * events)
        pipeline.reset_scale_sweep()
        ck.reset_launches()
        runs.append(solve_batch(src, dst, params, device=cuda_card))
        torch.cuda.synchronize()
        chunks = -(-64 // per)
        assert pipeline.SCALE_SWEEP == {"chunks": chunks, "events": 64 * events}
        assert ck.LAUNCHES["tls_sweep"] == _launches(n * (n - 1) // 2) * chunks
    for name, a, b in zip(pipeline.PipelineSolution._fields, *runs):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert ((runs[0].scale - 2.5).abs() < 1e-3).all()


@pytest.mark.chip
def test_known_scale_launches_no_sweep(cuda_card):
    from teaserpp_tpu_torch import solve_batch

    src, dst, params = _unknown_scale_batch(2)
    ck.reset_launches()
    solve_batch(torch.from_numpy(src).to(cuda_card), torch.from_numpy(dst).to(cuda_card),
                dataclasses.replace(params, estimate_scaling=False), device=cuda_card)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["tls_sweep"] == 0
