"""Port parity: TRIM adjacency bits and chain TIMs against the JAX package.

The plain PyTorch version of the ``trim_bits`` CUDA kernel must equal, word
for word on the same float32 inputs, the Pallas kernel (interpret mode), the
XLA stripe path and the dense adjacency packed per problem. The CUDA kernel
itself is held against the plain version on the card by
``tests/test_torch_chip_kernels.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from teaserpp_tpu.clique import kcore as jkcore
from teaserpp_tpu.ops import tims as jtims
from teaserpp_tpu_torch.clique import kcore as tkcore
from teaserpp_tpu_torch.ops import cuda_kernels as ck
from teaserpp_tpu_torch.ops import tims as ttims
from teaserpp_tpu_torch.parallel.batch import pad_problems

NOISE_BOUND = 0.005
BETA = 2 * NOISE_BOUND


def _clouds(rng, n, n_out):
    src = rng.uniform(-1, 1, (3, n)).astype(np.float32)
    dst = (src + rng.normal(scale=0.002, size=(3, n))).astype(np.float32)
    idx = rng.choice(n, size=n_out, replace=False)
    dst[:, idx] += rng.uniform(1, 4, size=(3, n_out)).astype(np.float32)
    return src, dst


def _plain(src, dst, valid=None):
    s = torch.from_numpy(np.ascontiguousarray(src, np.float32))
    d = torch.from_numpy(np.ascontiguousarray(dst, np.float32))
    if s.dim() == 2:
        s, d = s[None], d[None]
    v = (torch.ones(s.shape[0], s.shape[-1], dtype=torch.bool) if valid is None
         else torch.from_numpy(valid))
    return ck.trim_adjacency_bits_plain(s, d, v, BETA).numpy().view(np.uint32)


@pytest.mark.parametrize("rows,cols", [(64, 128), (96, 128), (64, 96)])
def test_plain_matches_pallas_interpret(rng, rows, cols):
    from jax.experimental.pallas import tpu as pltpu
    from teaserpp_tpu.ops import pallas_kernels as pk

    n = 150
    src, dst = _clouds(rng, n, 90)
    with pltpu.force_tpu_interpret_mode():
        bits_p = np.asarray(pk.trim_adjacency_bits_pallas(
            jnp.asarray(src), jnp.asarray(dst), BETA, rows=rows, cols=cols))
    got = _plain(src, dst)[0]
    assert got.shape == bits_p.shape == ((n + 31) // 32, n)
    assert np.array_equal(got, bits_p)


@pytest.mark.parametrize("n", [1, 31, 64, 257])
def test_plain_matches_xla_stripe_path(rng, n):
    src, dst = _clouds(rng, n, n // 2)
    ref = np.asarray(jtims.trim_adjacency_bits(
        jnp.asarray(src), jnp.asarray(dst), NOISE_BOUND))
    assert np.array_equal(_plain(src, dst)[0], ref)


def test_plain_matches_packed_dense_with_padding(rng):
    sizes = [200, 137, 64]
    probs = [_clouds(rng, n, int(0.6 * n)) for n in sizes]
    src, dst, valid = pad_problems([p[0] for p in probs], [p[1] for p in probs])
    src, dst = src.astype(np.float32), dst.astype(np.float32)
    got = _plain(src, dst, valid)
    for b in range(len(sizes)):
        adj = jtims.trim_adjacency_dense(
            jnp.asarray(src[b]), jnp.asarray(dst[b]), NOISE_BOUND,
            valid=jnp.asarray(valid[b]))
        ref = np.asarray(jkcore.pack_bits_u32_rows(adj))
        assert np.array_equal(got[b], ref), b
    # the port's dense adjacency packs to the same words
    t_adj = ttims.trim_adjacency_dense(
        torch.from_numpy(src), torch.from_numpy(dst), NOISE_BOUND,
        valid=torch.from_numpy(valid))
    packed = tkcore.pack_bits_u32_rows(t_adj).numpy().view(np.uint32)
    assert np.array_equal(packed, got)


@pytest.mark.parametrize("budget", [32 * 100, 3 * 32 * 100])
def test_plain_chunking_is_exact(rng, monkeypatch, budget):
    """Row-band chunks (budget below one problem) and batch chunks agree."""
    src = rng.uniform(-0.2, 0.2, (4, 3, 100)).astype(np.float32)
    dst = (src + rng.normal(scale=0.004, size=src.shape)).astype(np.float32)
    valid = rng.random((4, 100)) < 0.9
    whole = _plain(src, dst, valid)
    monkeypatch.setattr(ck, "_PLAIN_CHUNK_PAIRS", budget)
    assert np.array_equal(_plain(src, dst, valid), whole)


def test_wrapper_on_cpu_is_plain_and_uncounted(rng):
    src, dst = _clouds(rng, 96, 40)
    s = torch.from_numpy(src)[None].repeat(2, 1, 1)
    d = torch.from_numpy(dst)[None].repeat(2, 1, 1)
    v = torch.ones(2, 96, dtype=torch.bool)
    v[1, 80:] = False
    before = dict(ck.LAUNCHES)
    got = ttims.trim_adjacency_bits(s, d, NOISE_BOUND, valid=v)
    assert ck.LAUNCHES == before
    assert torch.equal(got, ck.trim_adjacency_bits_plain(s, d, v, BETA))
    assert got.dtype == torch.int32 and got.shape == (2, 3, 96)


def test_wrapper_raises_off_cpu_and_cuda():
    """No silent fallback: a tensor that is neither on the CPU nor on CUDA
    is refused instead of going to the plain version."""
    s = torch.zeros(1, 3, 8, device="meta")
    v = torch.ones(1, 8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ck.trim_bits(s, s, v, BETA)


@pytest.mark.parametrize("frac", [0.0, 0.05, 0.5, 1.0])
def test_chain_tims_exact(rng, frac):
    n = 70
    v = rng.normal(size=(3, 3, n)).astype(np.float32)
    mask = rng.random((3, n)) < frac
    mask[1] = False
    if frac:
        mask[2, :] = False
        mask[2, 5] = True  # a single member chains to itself
    t_tims, t_valid = ttims.chain_tims(torch.from_numpy(v), torch.from_numpy(mask))
    for b in range(3):
        j_tims, j_valid = jtims.chain_tims(jnp.asarray(v[b]), jnp.asarray(mask[b]))
        assert np.array_equal(t_valid[b].numpy(), np.asarray(j_valid))
        assert np.array_equal(t_tims[b].numpy(), np.asarray(j_tims))
