"""Port parity: the plain PyTorch versions of the ``trim_degrees`` and
``trim_adjacency_i8`` CUDA kernels against the Pallas kernels they replace
(interpret mode) and against the port's own bit words and dense adjacency.
The CUDA kernels themselves are held against these plain versions on the card
by ``tests/test_torch_chip_kernels.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from teaserpp_tpu.ops import tims as jtims
from teaserpp_tpu_torch.clique import kcore as tkcore
from teaserpp_tpu_torch.ops import cuda_kernels as ck
from teaserpp_tpu_torch.ops.procrustes import svd_rot
from teaserpp_tpu_torch.ops import tims as ttims

NOISE_BOUND = 0.005
BETA = 2 * NOISE_BOUND


def _clouds(rng, n, n_out, batch=None):
    shape = (3, n) if batch is None else (batch, 3, n)
    src = rng.uniform(-1, 1, shape).astype(np.float32)
    dst = (src + rng.normal(scale=0.002, size=shape)).astype(np.float32)
    idx = rng.choice(n, size=n_out, replace=False)
    dst[..., idx] += rng.uniform(1, 4, size=shape[:-1] + (n_out,)).astype(np.float32)
    return src, dst


def _t(x):
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t[None] if t.dim() == 2 else t


@pytest.mark.parametrize("rows,cols", [(64, 128), (64, 96)])
def test_degrees_plain_equals_pallas_interpret(rng, rows, cols):
    from jax.experimental.pallas import tpu as pltpu
    from teaserpp_tpu.ops import pallas_kernels as pk

    n = 150
    src, dst = _clouds(rng, n, 90)
    with pltpu.force_tpu_interpret_mode():
        deg_p = np.asarray(pk.trim_degrees_pallas(
            jnp.asarray(src), jnp.asarray(dst), BETA, rows=rows, cols=cols))
    got = ck.trim_degrees_plain(_t(src), _t(dst), BETA)
    assert got.dtype == torch.int32 and got.shape == (1, n)
    assert np.array_equal(got[0].numpy(), deg_p)


@pytest.mark.parametrize("n", [1, 31, 150, 257])
def test_degrees_plain_equals_popcount_of_port_bits(rng, n):
    src, dst = _clouds(rng, n, n // 2, batch=3)
    s, d = _t(src), _t(dst)
    valid = torch.ones(3, n, dtype=torch.bool)
    bits = ck.trim_adjacency_bits_plain(s, d, valid, BETA)
    # the adjacency is symmetric, so column sums of the row-packed words are
    # the degrees
    want = tkcore.popcount32(bits).sum(dim=-2).to(torch.int32)
    assert torch.equal(ck.trim_degrees_plain(s, d, BETA), want)
    # and equal to the JAX package's words, summed the same way
    for p in range(3):
        ref = np.asarray(jtims.trim_adjacency_bits(
            jnp.asarray(src[p]), jnp.asarray(dst[p]), NOISE_BOUND))
        assert np.array_equal(np.bitwise_count(ref).sum(axis=0), want[p].numpy())


def test_adjacency_plain_agrees_with_pallas_interpret_and_dense(rng):
    from jax.experimental.pallas import tpu as pltpu
    from teaserpp_tpu.ops import pallas_kernels as pk

    n = 300
    src, dst = _clouds(rng, n, 200)
    with pltpu.force_tpu_interpret_mode():
        adj_p = np.asarray(pk.trim_adjacency_pallas(
            jnp.asarray(src), jnp.asarray(dst), BETA, tile=128))
    got = ck.trim_adjacency_i8_plain(_t(src), _t(dst), BETA)
    assert got.dtype == torch.int8 and got.shape == (1, n, n)
    got = got[0].numpy()
    assert set(np.unique(got)) <= {0, 1}
    # the Gram form cancels differently at pairs on the threshold, and XLA
    # sums the Pallas kernel's 8-deep product in its own order
    assert (got == adj_p).mean() >= 0.9999
    dense = ttims.trim_adjacency_dense(_t(src), _t(dst), NOISE_BOUND)[0].numpy()
    assert (got.astype(bool) == dense).mean() >= 0.9999
    j_dense = np.asarray(jtims.trim_adjacency_dense(
        jnp.asarray(src), jnp.asarray(dst), NOISE_BOUND))
    assert (got.astype(bool) == j_dense).mean() >= 0.9999
    assert not got.diagonal().any()
    assert np.array_equal(got, got.T)


@pytest.mark.parametrize("budget", [100, 3 * 100 * 100])
def test_plain_chunking_is_exact(rng, monkeypatch, budget):
    """Row-band chunks (budget below one problem) and batch chunks agree."""
    src, dst = _clouds(rng, 100, 60, batch=4)
    s, d = _t(src), _t(dst)
    deg, adj = ck.trim_degrees_plain(s, d, BETA), ck.trim_adjacency_i8_plain(s, d, BETA)
    monkeypatch.setattr(ck, "_PLAIN_CHUNK_PAIRS", budget)
    assert torch.equal(ck.trim_degrees_plain(s, d, BETA), deg)
    assert torch.equal(ck.trim_adjacency_i8_plain(s, d, BETA), adj)


def test_wrappers_on_cpu_are_plain_and_uncounted(rng):
    src, dst = _clouds(rng, 96, 40, batch=2)
    s, d = _t(src), _t(dst)
    before = dict(ck.LAUNCHES)
    assert set(before) == {"trim_bits", "trim_bits_slab", "trim_degrees", "trim_adjacency_i8",
                           "greedy_clique", "tls_sweep", "gnc_tls"}
    assert torch.equal(ck.trim_degrees(s, d, BETA), ck.trim_degrees_plain(s, d, BETA))
    assert torch.equal(ck.trim_adjacency_i8(s, d, BETA),
                       ck.trim_adjacency_i8_plain(s, d, BETA))
    valid = torch.ones((2, 96), dtype=torch.bool)
    assert torch.equal(ck.trim_bits(s, d, valid, BETA, rows=(1, 3)),
                       ck.trim_adjacency_bits_plain(s, d, valid, BETA, rows=(1, 3)))
    rows = ck.trim_adjacency_bits_plain(s, d, valid, BETA).transpose(-1, -2).contiguous()
    order = torch.arange(96, dtype=torch.int32).repeat(2, 1)
    allowed = torch.full((2, 3), -1, dtype=torch.int32)
    got, want = (f(rows, order, allowed, 8) for f in (ck.greedy_clique, ck.greedy_clique_plain))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    gnc = (s, d, 0.01, 1.4, 100, 1e-6, valid, svd_rot)
    assert all(torch.equal(g, w) for g, w in zip(ck.gnc_tls(*gnc), ck.gnc_tls_plain(*gnc)))
    assert ck.LAUNCHES == before


@pytest.mark.parametrize("wrapper", [ck.trim_degrees, ck.trim_adjacency_i8],
                         ids=["trim_degrees", "trim_adjacency_i8"])
def test_wrappers_raise_on_what_the_kernel_does_not_take(wrapper):
    """No silent fallback and no silent cast: wrong device, dtype, shape or
    layout is refused, on CPU tensors too."""
    s = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        wrapper(s.to("meta"), s.to("meta"), BETA)
    with pytest.raises(TypeError, match="dtype"):
        wrapper(s.double(), s.double(), BETA)
    with pytest.raises(TypeError, match="dtype"):
        wrapper(s, s.double(), BETA)
    with pytest.raises(ValueError, match=r"\(B, 3, N\)"):
        wrapper(s[0], s[0], BETA)
    with pytest.raises(ValueError, match=r"\(B, 3, N\)"):
        wrapper(torch.zeros(2, 4, 8), torch.zeros(2, 4, 8), BETA)
    with pytest.raises(ValueError, match="shape"):
        wrapper(s, s[:, :, :7].contiguous(), BETA)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(torch.zeros(2, 8, 3).transpose(1, 2), s, BETA)
