"""Point-to-point ICP refinement.

Counterpart of ``teaserpp_tpu/solvers/icp.py``: the reference's example
workflow refines the TEASER global solution with an ICP local solve
(examples/teaser_python_fpfh_icp/example.py:67-72, open3d
``registration_icp`` with ``TransformationEstimationPointToPoint``). Each
iteration matches every transformed source point to its nearest target point
(a Gram-form distance argmin), weights the matches within
``max_correspondence_distance`` (open3d semantics), and re-solves (R, t) by
the weighted Procrustes of ``ops/procrustes.py``. The JAX package's
``while_loop`` is a Python loop here with one host sync an iteration, for
the stop rule.

Clouds may have different sizes; padded points are masked.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from teaserpp_tpu_torch.device import DeviceLike, resolve_device
from teaserpp_tpu_torch.ops.procrustes import rotate, svd_rot


class ICPResult(NamedTuple):
    rotation: torch.Tensor  # (3, 3) refined rotation
    translation: torch.Tensor  # (3,) refined translation
    rmse: torch.Tensor  # () inlier RMSE at termination
    fitness: torch.Tensor  # () matched fraction of valid source points
    iterations: torch.Tensor  # () int32


def _nearest_dst(src_t: torch.Tensor, dst: torch.Tensor, dst_valid) -> tuple:
    """Nearest dst index + squared distance per transformed source point.

    (3, M) x (3, N) -> argmin over N of ``|s|^2 + |d|^2 - 2 s.d``, the cross
    term one (M, N) float32 matrix product as in the JAX package (the
    process's TF32 setting is left as it is; by default PyTorch keeps float32
    products in float32). Invalid targets score +inf.
    """
    sq_s = torch.sum(src_t * src_t, dim=0)  # (M,)
    sq_d = torch.sum(dst * dst, dim=0)  # (N,)
    cross = torch.matmul(src_t.T, dst)  # (M, N)
    d2 = sq_s[:, None] + sq_d[None, :] - 2.0 * cross
    if dst_valid is not None:
        d2 = torch.where(dst_valid[None, :], d2, torch.full_like(d2, float("inf")))
    idx = torch.argmin(d2, dim=1)
    best = torch.gather(d2, 1, idx[:, None])[:, 0]
    return idx, torch.clamp(best, min=0.0)


def icp_point_to_point(
    src,
    dst,
    max_correspondence_distance: float,
    r_init=None,
    t_init=None,
    max_iterations: int = 30,
    relative_rmse: float = 1e-6,
    src_valid=None,
    dst_valid=None,
    device: DeviceLike = None,
) -> ICPResult:
    """Refine an SE(3) estimate by point-to-point ICP.

    Args:
      src: (3, M) source cloud (pre-transform), numpy or tensor.
      dst: (3, N) target cloud.
      max_correspondence_distance: matches beyond this are discarded.
      r_init, t_init: initial transform (defaults: identity / zero).
      max_iterations: iteration ceiling.
      relative_rmse: stop after an iteration past the first whose
        |rmse_prev - rmse| / rmse is below this.
      src_valid / dst_valid: padding masks.
      device: CUDA unless named. Floating inputs keep their dtype (float32
        or float64); others become float32.

    Returns:
      ICPResult with the refined (R, t), open3d-style rmse and fitness, as
      tensors on ``device``.
    """
    dev = resolve_device(device)
    src = torch.as_tensor(src, device=dev)
    dtype = src.dtype if src.is_floating_point() else torch.float32
    src = src.to(dtype)
    dst = torch.as_tensor(dst, device=dev).to(dtype)
    m = src.shape[-1]
    r = (torch.eye(3, dtype=dtype, device=dev) if r_init is None
         else torch.as_tensor(r_init, device=dev).to(dtype))
    t = (torch.zeros((3,), dtype=dtype, device=dev) if t_init is None
         else torch.as_tensor(t_init, device=dev).to(dtype))
    sv = (torch.ones((m,), dtype=dtype, device=dev) if src_valid is None
          else torch.as_tensor(src_valid, device=dev).to(dtype))
    dv = None if dst_valid is None else torch.as_tensor(dst_valid, device=dev).to(torch.bool)
    max_d2 = torch.as_tensor(max_correspondence_distance, dtype=dtype, device=dev) ** 2
    tiny = torch.tensor(1e-12, dtype=dtype, device=dev)

    rmse_prev = torch.tensor(float("inf"), dtype=dtype, device=dev)
    rmse = rmse_prev
    fitness = torch.zeros((), dtype=dtype, device=dev)
    i = 0
    while i < max_iterations:
        src_t = rotate(r, src) + t[:, None]
        idx, d2 = _nearest_dst(src_t, dst, dv)
        w = sv * (d2 <= max_d2)
        matched = dst[:, idx]  # (3, M)
        nw = torch.maximum(torch.sum(w), tiny)
        rmse = torch.sqrt(torch.sum(w * d2) / nw)
        fitness = nw / torch.maximum(torch.sum(sv), tiny)

        # weighted point-to-point update: center both sides (svd_rot solves
        # the translation-free Procrustes, reference utils.h:121), then align
        cog_s = torch.sum(src * w, dim=1) / nw
        cog_m = torch.sum(matched * w, dim=1) / nw
        r = svd_rot(src - cog_s[:, None], matched - cog_m[:, None], w)
        t = cog_m - rotate(r, cog_s[:, None])[:, 0]

        rel = torch.abs(rmse_prev - rmse) / torch.maximum(rmse, tiny)
        done = i > 0 and bool(rel < relative_rmse)  # the iteration's one host sync
        i += 1
        rmse_prev = rmse
        if done:
            break
    return ICPResult(rotation=r, translation=t, rmse=rmse, fitness=fitness,
                     iterations=torch.tensor(i, dtype=torch.int32, device=dev))
