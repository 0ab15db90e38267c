"""Batched known-scale registration pipeline.

Counterpart of ``teaserpp_tpu/solvers/pipeline.py``, for the branch the
batched solve takes with known scale and KCORE_HEU at threshold 0
(pipeline.py:358-365 there):

  TRIM adjacency bits (CUDA kernel) -> batch k-core peel -> top-core mask
  -> chain TIMs -> GNC-TLS rotation (q-method Procrustes) -> TLS translation.

Every function takes a batch dimension where the JAX package used ``vmap``.
Other inlier-selection modes, scale estimation and the FGR / Quatro rotation
solvers are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional

import torch

from teaserpp_tpu_torch.clique.kcore import core_numbers_from_bits
from teaserpp_tpu_torch.device import DeviceLike, resolve_device
from teaserpp_tpu_torch.ops.procrustes import rotate, svd_rot
from teaserpp_tpu_torch.ops.tims import chain_tims, trim_adjacency_bits
from teaserpp_tpu_torch.params import (
    InlierSelectionMode,
    RobustRegistrationSolverParams,
    RotationEstimationAlgorithm,
)
from teaserpp_tpu_torch.solvers.rotation import solve_rotation_gnc_tls
from teaserpp_tpu_torch.solvers.translation import solve_translation_tls


class PipelineSolution(NamedTuple):
    """Batched solution + introspection masks (leading dim B on every field)."""

    valid: torch.Tensor  # (B,) bool — False when the clique degenerated (size <= 1)
    scale: torch.Tensor  # (B,)
    rotation: torch.Tensor  # (B, 3, 3)
    translation: torch.Tensor  # (B, 3)
    scale_pair_mask: torch.Tensor  # (B, 0) bool: empty on the known-scale path
    clique_mask: torch.Tensor  # (B, N) bool max-clique membership
    rotation_inlier_mask: torch.Tensor  # (B, N) bool per chain-TIM root index
    translation_inlier_mask: torch.Tensor  # (B, N) bool over original measurements
    rotation_cost: torch.Tensor  # (B,) GNC cost at termination
    rotation_iterations: torch.Tensor  # (B,) int32


class _StageClock:
    """Host wall time per stage, synchronising the device at each mark.

    With ``out`` None it does nothing, so the solve stays free of syncs.
    """

    def __init__(self, out: Optional[Dict[str, float]], device: torch.device):
        self.out, self.device = out, device
        self._t = self._now() if out is not None else 0.0

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def mark(self, stage: str) -> None:
        if self.out is not None:
            t = self._now()
            self.out[stage] = self.out.get(stage, 0.0) + (t - self._t) * 1e3
            self._t = t


def _require_top_kcore(params: RobustRegistrationSolverParams) -> None:
    mode = params.resolved_inlier_selection_mode()
    if mode != InlierSelectionMode.KCORE_HEU or params.kcore_heuristic_threshold > 0:
        raise NotImplementedError(
            f"inlier selection {mode.name} with kcore_heuristic_threshold="
            f"{params.kcore_heuristic_threshold} is not ported yet, only KCORE_HEU "
            "at threshold 0 (ROADMAP queue 1, item 5: a problem-batched "
            "clique/heuristic.py inside register_pair)"
        )


def _require_gnc_tls(params: RobustRegistrationSolverParams) -> None:
    if params.rotation_estimation_algorithm != RotationEstimationAlgorithm.GNC_TLS:
        raise NotImplementedError(
            f"{params.rotation_estimation_algorithm.name} rotation is not ported "
            "yet (ROADMAP queue 1, item 4: FGR and Quatro in solvers/rotation.py)"
        )


def device_clique_from_bits(
    adj_bits: torch.Tensor,
    n: int,
    params: RobustRegistrationSolverParams,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Top k-core of each problem's row-packed adjacency -> (B, N) bool mask.

    The KCORE_HEU threshold-0 selector ("always take the top k-core",
    reference registration.h:480-482).
    """
    _require_top_kcore(params)
    core = core_numbers_from_bits(adj_bits, n, valid)
    mask = core >= core.amax(dim=-1, keepdim=True)
    if valid is not None:
        mask = mask & valid
    return mask


def _polish_rt(src, dst, scale, rotation, translation, inlier_mask):
    """Joint weighted-Procrustes re-fit of (R, t) on the final inlier points.

    ``dst = s R src + t`` with s fixed; keeps the inputs of a problem with
    fewer than 3 inliers. All arguments are batched.
    """
    w = inlier_mask.to(src.dtype)
    nw = torch.sum(w, dim=-1, keepdim=True)
    safe_nw = torch.clamp(nw, min=1.0)
    cs = torch.sum(src * w[:, None, :], dim=-1) / safe_nw
    cd = torch.sum(dst * w[:, None, :], dim=-1) / safe_nw
    r_pol = svd_rot(src - cs[..., None], dst - cd[..., None], w)
    t_pol = cd - scale[:, None] * rotate(r_pol, cs[..., None])[..., 0]
    ok = nw[:, 0] >= 3
    return (
        torch.where(ok[:, None, None], r_pol, rotation),
        torch.where(ok[:, None], t_pol, translation),
    )


def rotation_translation_stage(
    src: torch.Tensor,
    dst: torch.Tensor,
    scale: torch.Tensor,
    clique_mask: torch.Tensor,
    params: RobustRegistrationSolverParams,
    stage_ms: Optional[Dict[str, float]] = None,
) -> PipelineSolution:
    """Chain-TIM GNC rotation + component-wise TLS translation, batched.

    Reference flow: chain TIM rebuild (registration.cc:657-680), de-scaling
    and rotation noise-bound update (registration.cc:697-704), rotation solve
    (registration.cc:708), translation solve on the clique points
    (registration.cc:717-727). ``scale`` is (B,).
    """
    clock = _StageClock(stage_ms, src.device)
    src_ctims, tim_valid = chain_tims(src, clique_mask)
    dst_ctims, _ = chain_tims(dst, clique_mask)
    inv_s = 1.0 / scale
    dst_ctims = dst_ctims * inv_s[:, None, None]
    nb_rot = params.noise_bound * 2.0 * inv_s
    clock.mark("chain_tims")

    _require_gnc_tls(params)
    rot = solve_rotation_gnc_tls(
        src_ctims, dst_ctims, nb_rot,
        gnc_factor=params.rotation_gnc_factor,
        max_iterations=params.rotation_max_iterations,
        cost_threshold=params.rotation_cost_threshold,
        valid=tim_valid,
    )
    clock.mark("rotation")

    aligned_src = scale[:, None, None] * rotate(rot.rotation, src)
    trans = solve_translation_tls(
        aligned_src, dst, params.noise_bound, params.cbar2, valid=clique_mask
    )
    rotation, translation = rot.rotation, trans.translation
    if params.final_polish:
        rotation, translation = _polish_rt(
            src, dst, scale, rotation, translation, trans.inliers & clique_mask
        )
    clock.mark("translation")

    return PipelineSolution(
        valid=clique_mask.sum(dim=-1) > 1,  # reference registration.cc:643-647
        scale=scale,
        rotation=rotation,
        translation=translation,
        scale_pair_mask=torch.zeros((src.shape[0], 0), dtype=torch.bool, device=src.device),
        clique_mask=clique_mask,
        rotation_inlier_mask=rot.inliers,
        translation_inlier_mask=trans.inliers,
        rotation_cost=rot.cost,
        rotation_iterations=rot.iterations,
    )


def _to_device(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(dtype).contiguous()


def register_pair(
    src,
    dst,
    params: RobustRegistrationSolverParams,
    valid=None,
    device: DeviceLike = None,
    stage_ms: Optional[Dict[str, float]] = None,
) -> PipelineSolution:
    """Known-scale solve of a batch of problems (B, 3, N).

    The batch dimension stands where the JAX package ``vmap``s its per-problem
    ``register_pair``; one problem is a batch of one. The inputs (numpy arrays
    or tensors) go to ``device`` — CUDA unless ``device`` names another — as
    float32; ``valid`` (B, N) masks padded correspondences. Pass a dict as
    ``stage_ms`` to have the host wall time of each stage (``bits``, ``peel``,
    ``chain_tims``, ``rotation``, ``translation``) added to it; this
    synchronises the device after every stage.
    """
    if params.estimate_scaling:
        raise NotImplementedError(
            "scale estimation is not ported yet (ROADMAP queue 1, item 4: "
            "solvers/scale.py and the unknown-scale path)"
        )
    _require_top_kcore(params)
    _require_gnc_tls(params)
    dev = resolve_device(device)
    src = _to_device(src, dev, torch.float32)
    dst = _to_device(dst, dev, torch.float32)
    if src.shape != dst.shape or src.dim() != 3 or src.shape[-2] != 3:
        raise ValueError(
            f"src and dst must both be (B, 3, N), got "
            f"{tuple(src.shape)} and {tuple(dst.shape)}"
        )
    bsz, _, n = src.shape
    valid = (
        torch.ones((bsz, n), dtype=torch.bool, device=dev)
        if valid is None else _to_device(valid, dev, torch.bool)
    )

    clock = _StageClock(stage_ms, dev)
    bits = trim_adjacency_bits(src, dst, params.noise_bound, params.cbar2, valid)
    clock.mark("bits")
    clique_mask = device_clique_from_bits(bits, n, params, valid)
    clock.mark("peel")
    scale = torch.ones((bsz,), dtype=src.dtype, device=dev)
    return rotation_translation_stage(src, dst, scale, clique_mask, params, stage_ms)
