"""Adaptive-voting scalar truncated least squares, batched.

Counterpart of ``teaserpp_tpu/ops/tls.py`` (reference registration.cc:21-204,
``ScalarTLSEstimator``). Measurement ``i`` opens its consensus interval at
``x_i - r_i`` and closes it at ``x_i + r_i``; after sorting the 2N events,
prefix sums of each running quantity of the reference's sweep give every
candidate estimate and its cost.

The JAX package carries the event streams through one unstable
multi-operand sort; here a stable sort of the positions gathers each
stream. Events at equal positions may come out in another order, which can
change the prefix sums only inside a tie.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch


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
    ones = torch.ones_like(x)
    w = vmask / torch.where(vmask > 0, ranges * ranges, ones)

    def ev(q):  # a per-measurement quantity on its two events
        return torch.cat([q, q], dim=-1)

    vals = torch.cat([x - ranges, x + ranges], dim=-1)  # (..., 2N)
    sign = torch.cat([ones, -ones], dim=-1)
    # per-event signed deltas of the reference's running sums
    # (registration.cc:63-68); invalid measurements add nothing
    streams = (
        sign * ev(vmask),  # card
        sign * ev(w),
        sign * ev(w * x),
        -sign * ev(ranges * vmask),  # outlier penalty
        sign * ev(x * vmask),
        sign * ev(x * x * vmask),
    )
    perm = torch.sort(vals, dim=-1, stable=True).indices
    card, cum_w, cum_xw, cum_rng, cum_sx, cum_sx2 = (
        torch.cumsum(torch.gather(d, -1, perm), dim=-1) for d in streams
    )
    outlier_pen = torch.sum(ranges * vmask, dim=-1, keepdim=True) + cum_rng

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
    vals = torch.cat([x - b, x + b], dim=-1)  # (..., 2N)
    sign = torch.cat([vmask, -vmask], dim=-1)
    xx = torch.cat([x, x], dim=-1)
    sx = sign * xx
    sx2 = sx * xx

    vals, perm = torch.sort(vals, dim=-1, stable=True)
    sign_s = torch.gather(sign, -1, perm)
    sx_s = torch.gather(sx, -1, perm)
    sx2_s = torch.gather(sx2, -1, perm)
    card = torch.cumsum(sign_s, dim=-1)
    cum_sx = torch.cumsum(sx_s, dim=-1)
    cum_sx2 = torch.cumsum(sx2_s, dim=-1)
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
