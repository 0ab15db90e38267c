"""Adaptive-voting scalar truncated least squares, batched.

Counterpart of ``teaserpp_tpu/ops/tls.py`` (reference registration.cc:21-204,
``ScalarTLSEstimator``). Measurement ``i`` opens its consensus interval at
``x_i - r_i`` and closes it at ``x_i + r_i``; after sorting the 2N events,
prefix sums of each running quantity of the reference's sweep give every
candidate estimate and its cost.

The JAX package carries the event streams through one unstable
multi-operand sort; here a stable sort of the positions gathers each
stream, one stream at a time. Events at equal positions may come out in
another order, which can change the prefix sums only inside a tie. The
prefix sums are :func:`prefix_sum`, a float64 scan whose order of additions
is fixed by the length alone, so equal inputs give equal bits on every run,
on the CPU and the card alike (``torch.cumsum`` on CUDA floats promises
neither).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

# Elements per block of :func:`prefix_sum`: the full-length passes are the
# in-block ones, log2 of this, plus one to add the block carries.
_SCAN_BLOCK = 64


def _shifted_add_scan(x: torch.Tensor) -> torch.Tensor:
    """Hillis-Steele inclusive scan along the last dimension: ``ceil(log2 L)``
    passes, pass ``p`` adding each element ``2^p`` places back into a fresh
    tensor. Each pass is one elementwise add."""
    n = x.shape[-1]
    k = 1
    while k < n:
        nxt = torch.empty_like(x)
        nxt[..., :k] = x[..., :k]
        torch.add(x[..., k:], x[..., :-k], out=nxt[..., k:])
        x = nxt
        k *= 2
    return x


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last dimension, in a fixed order.

    In float64, rounded once to ``x``'s dtype at the end: the last dimension
    is cut into blocks of ``_SCAN_BLOCK`` (zero-padded), each block scanned
    by shifted adds, the block sums scanned the same way, and each block's
    predecessors' sum added to it. Every step is an elementwise add, so the
    order of additions depends on the length alone, never on scheduling, and
    the CPU and the card give the same bits. A tree scan's partial sums run
    over windows of the input, far larger than a prefix where the events'
    opens and closes cancel (a TLS sweep's running sums), so they are kept
    in float64: each output is its float64 sum, at most
    ``ceil(log2 L) + 2`` additions deep, rounded once.
    """
    out = x.to(torch.float64, copy=True)
    n = out.shape[-1]
    if n <= _SCAN_BLOCK:
        return _shifted_add_scan(out).to(x.dtype)
    rows = -(-n // _SCAN_BLOCK)
    out = torch.nn.functional.pad(out, (0, rows * _SCAN_BLOCK - n))
    out = _shifted_add_scan(out.reshape(*out.shape[:-1], rows, _SCAN_BLOCK))
    carry = _shifted_add_scan(out[..., -1])  # inclusive prefix of the block sums
    out[..., 1:, :] += carry[..., :-1, None]
    return out.reshape(*out.shape[:-2], rows * _SCAN_BLOCK)[..., :n].to(x.dtype)


class ScalarTLSResult(NamedTuple):
    estimate: torch.Tensor  # (...,) TLS estimate
    inliers: torch.Tensor  # (..., N) bool consensus mask at the estimate
    cost: torch.Tensor  # (...,) cost at the selected consensus set


def scalar_tls(
    x: torch.Tensor,
    ranges: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> ScalarTLSResult:
    """TLS estimate of a scalar from (..., N) measurements with per-measurement
    half-intervals ``ranges`` (inlier iff ``|x_i - estimate| <= ranges_i``).

    ``valid`` (..., N) bool drops measurements entirely (padding). Weights
    are ``1 / r_i^2``; the candidate after each event is the weighted mean of
    the open set, its cost the unweighted squared residual of the open set
    plus the ranges of the closed ones, in the JAX package's float order.
    """
    dtype = torch.promote_types(x.dtype, ranges.dtype)
    x = x.to(dtype)
    ranges = ranges.to(dtype)
    vmask = torch.ones_like(x) if valid is None else valid.to(dtype)
    w = vmask / torch.where(vmask > 0, ranges * ranges, torch.ones_like(x))

    perm = torch.sort(torch.cat([x - ranges, x + ranges], dim=-1), dim=-1,
                      stable=True).indices

    def running(q):
        """Prefix sums, over the sorted events, of the signed deltas of a
        per-measurement quantity ``q`` (+q opening, -q closing; reference
        registration.cc:63-68). One stream is built, gathered and scanned at
        a time, so only its scan outlives the call."""
        return prefix_sum(torch.gather(torch.cat([q, -q], dim=-1), -1, perm))

    # invalid measurements add nothing (q is 0 there). The ranges' total is
    # the last of their fixed-order prefix sums, not ``torch.sum``, whose
    # order on the card follows the number of rows: so a problem's bits do
    # not depend on the batch it is solved in.
    total_rng = prefix_sum(ranges * vmask)[..., -1:]
    card = running(vmask)
    cum_w = running(w)
    cum_xw = running(w * x)
    cum_rng = -running(ranges * vmask)  # outlier penalty: closing adds the range back
    cum_sx = running(x * vmask)
    cum_sx2 = running(x * x * vmask)
    outlier_pen = total_rng + cum_rng

    have_consensus = card > 0.5
    safe_w = torch.where(have_consensus, cum_w, torch.ones_like(cum_w))
    x_hat = cum_xw / safe_w
    residual = card * x_hat * x_hat + cum_sx2 - 2.0 * cum_sx * x_hat
    cost = residual + outlier_pen
    cost = torch.where(have_consensus, cost, torch.full_like(cost, float("inf")))

    min_idx = torch.argmin(cost, dim=-1, keepdim=True)
    estimate = torch.gather(x_hat, -1, min_idx)[..., 0]
    best_cost = torch.gather(cost, -1, min_idx)[..., 0]

    inliers = (torch.abs(x - estimate[..., None]) <= ranges) & (vmask > 0)
    return ScalarTLSResult(estimate=estimate, inliers=inliers, cost=best_cost)


def scalar_tls_fixed_range(
    x: torch.Tensor,
    beta: Union[float, torch.Tensor],
    valid: Optional[torch.Tensor] = None,
) -> ScalarTLSResult:
    """TLS estimate of a scalar from (..., N) measurements sharing range ``beta``.

    ``valid`` (..., N) bool masks padding out of every event stream. With one
    range every weight is equal, so three streams suffice.
    """
    dtype = x.dtype
    beta = torch.as_tensor(beta, dtype=dtype, device=x.device)
    vmask = (
        torch.ones_like(x) if valid is None else valid.to(dtype)
    )

    b = beta.expand_as(x)
    perm = torch.sort(torch.cat([x - b, x + b], dim=-1), dim=-1, stable=True).indices

    def running(q):  # as scalar_tls's: +q opening, -q closing, sorted, scanned
        return prefix_sum(torch.gather(torch.cat([q, -q], dim=-1), -1, perm))

    card = running(vmask)
    sx = vmask * x
    cum_sx = running(sx)
    cum_sx2 = running(sx * x)
    nv = torch.sum(vmask, dim=-1, keepdim=True)

    have_consensus = card > 0.5
    safe_card = torch.where(have_consensus, card, torch.ones_like(card))
    x_hat = cum_sx / safe_card
    residual = cum_sx2 - cum_sx * x_hat
    cost = residual + beta * (nv - card)
    cost = torch.where(have_consensus, cost, torch.full_like(cost, float("inf")))

    min_idx = torch.argmin(cost, dim=-1, keepdim=True)
    estimate = torch.gather(x_hat, -1, min_idx)[..., 0]
    best_cost = torch.gather(cost, -1, min_idx)[..., 0]

    inliers = (torch.abs(x - estimate[..., None]) <= b) & (vmask > 0)
    return ScalarTLSResult(estimate=estimate, inliers=inliers, cost=best_cost)
