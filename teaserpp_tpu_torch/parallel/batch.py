"""Batched registration: many independent problems in one call.

Counterpart of ``teaserpp_tpu/parallel/batch.py``. Variable-size problems
are padded to a common N with validity masks (:func:`pad_problems`, numpy
only, copied from the JAX package). :func:`solve_batch_sharded` splits a
batch over the ranks of a mesh axis (``parallel/multihost.py``).
``solve_batch(..., certify=...)`` certifies each answer with the DRS
certifier (``certification/drs.py``), as upstream's ``solve`` then
``DRSCertifier::certify``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from teaserpp_tpu_torch.certification import drs
from teaserpp_tpu_torch.device import DeviceLike, resolve_device
from teaserpp_tpu_torch.params import DRSCertifierParams, RobustRegistrationSolverParams
from teaserpp_tpu_torch.ops.procrustes import svd_rot
from teaserpp_tpu_torch.ops.tims import chain_tims
from teaserpp_tpu_torch.parallel.multihost import Mesh, require_mesh, shard_range
from teaserpp_tpu_torch.solvers.pipeline import PipelineSolution, register_pair
from teaserpp_tpu_torch.utils.timing import StageClock

# A PipelineSolution with each answer's optimality certificate, which
# ``solve_batch(..., certify=...)`` returns: ``rotation`` (B, 3, 3) float64,
# the rotation certified; ``optimal`` (B,) bool, the certifier's verdict, and
# ``suboptimality`` (B,) float64, its best gap (upstream's
# ``best_suboptimality``).
CertifiedSolution = NamedTuple("CertifiedSolution", [
    *PipelineSolution.__annotations__.items(),
    ("optimal", torch.Tensor), ("suboptimality", torch.Tensor)])


def pad_problems(
    src_list: Sequence[np.ndarray],
    dst_list: Sequence[np.ndarray],
    n_pad: Optional[int] = None,
    multiple: int = 64,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad a list of (3, n_i) problems to a common size.

    Returns (src (B, 3, N), dst (B, 3, N), valid (B, N)).
    """
    assert len(src_list) == len(dst_list)
    sizes = [s.shape[1] for s in src_list]
    if n_pad is None:
        n_pad = max(sizes)
        n_pad = ((n_pad + multiple - 1) // multiple) * multiple
    b = len(src_list)
    src = np.zeros((b, 3, n_pad))
    dst = np.zeros((b, 3, n_pad))
    valid = np.zeros((b, n_pad), bool)
    for i, (s, d) in enumerate(zip(src_list, dst_list)):
        n = s.shape[1]
        assert n <= n_pad
        src[i, :, :n] = s
        dst[i, :, :n] = d
        valid[i, :n] = True
    return src, dst, valid


def solve_batch(
    src,
    dst,
    params: RobustRegistrationSolverParams,
    valid=None,
    device: DeviceLike = None,
    stage_ms: Optional[Dict[str, float]] = None,
    use_matmul_norms: bool = False,
    certify: Optional[DRSCertifierParams] = None,
) -> Union[PipelineSolution, CertifiedSolution]:
    """Solve a (B, 3, N) problem batch on ``device`` (CUDA unless named).

    Known or unknown scale (``params.estimate_scaling``), every
    inlier-selection mode and rotation algorithm, so the library's default
    params run as they are. PMC_EXACT runs the batched greedy clique, as the
    JAX package's batched path does; the exact search is the facade's,
    ``RobustRegistrationSolver``, one problem at a time. See
    :func:`register_pair` for ``stage_ms`` and ``use_matmul_norms``.

    With ``certify`` (the DRS certifier's parameters, upstream's
    ``DRSCertifier::Params``) every answer is certified in float64 on its
    rotation stage's chain TIMs, inlier vector and noise bound
    (:func:`_certify_answers`; ``certify.noise_bound`` is replaced by each
    problem's ``2 noise_bound / s``), and a :class:`CertifiedSolution` is
    returned, its rotation the one certified: the rotation stage's
    Procrustes solved again in float64. ``stage_ms`` then also gets
    ``certify``, ``psd`` and ``gap``. Without it nothing else runs.
    """
    if certify is None:
        return register_pair(src, dst, params, valid=valid, device=device,
                             stage_ms=stage_ms, use_matmul_norms=use_matmul_norms)
    dev = resolve_device(device)
    src, dst = (torch.as_tensor(x, device=dev).to(torch.float32).contiguous()
                for x in (src, dst))
    sol = register_pair(src, dst, params, valid=valid, device=dev, stage_ms=stage_ms,
                        use_matmul_norms=use_matmul_norms)
    rotation, optimal, suboptimality = _certify_answers(src, dst, sol, params.noise_bound,
                                                        certify, stage_ms)
    return CertifiedSolution(*sol._replace(rotation=rotation), optimal, suboptimality)


def _certify_answers(
    src: torch.Tensor,
    dst: torch.Tensor,
    sol: PipelineSolution,
    noise_bound: float,
    params: DRSCertifierParams,
    stage_ms: Optional[Dict[str, float]],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(rotation (B, 3, 3), optimal (B,) bool, suboptimality (B,))`` of
    every answer of a solved (B, 3, N) batch, float64 on its device.

    Problem b is certified in float64, as upstream's certifier computes in
    double, on
      * the rotation its rotation stage solves for, the Procrustes of the
        TIMs below weighted by theta, solved again in float64. The float32
        rotation lies within float32 rounding of it but is no stationary
        point of the certified cost: the rounding, amplified by
        ``(N + 1) / mu``, gave gaps up to 1.4e-4 where the float64 rotation
        reads 0, and took one of 9.47e-4 to 9.998e-4, a hair from
        uncertified (PERF.md);
      * the cyclic chain TIMs of its clique in index order (the TIMs its
        rotation was solved on), the destination's divided by its scale:
        the facade's ``getMaxCliqueSrcTIMs`` and ``getMaxCliqueDstTIMs``;
      * theta: +1 where ``rotation_inlier_mask`` holds, -1 elsewhere;
      * the rotation stage's noise bound ``2 noise_bound / s`` in place of
        ``params.noise_bound``.
    The problems are grouped by TIM count and noise bound, one
    ``certify_batch`` loop a group (a lane's numbers do not depend on the
    others, and padding would change the SDP); each group's TIMs are
    gathered on the device, after one host read of the counts. A problem
    whose clique is degenerate (``valid`` False) is not certified: its
    rotation kept, ``optimal`` False, ``suboptimality`` inf. ``stage_ms`` gets
    ``certify``, the whole of it, and ``certify_batch``'s ``psd`` and
    ``gap``.
    """
    dev = src.device
    clock = StageClock(stage_ms, dev)
    f64 = torch.float64
    v1, tim_valid = chain_tims(src.to(f64), sol.clique_mask)
    v2, _ = chain_tims(dst.to(f64), sol.clique_mask)
    scale = sol.scale.to(f64)
    v2 = v2 / scale[:, None, None]
    # each row's valid TIMs first, in index order
    order = torch.argsort((~tim_valid).to(torch.int8), dim=-1, stable=True)
    drs.CERTIFY["host_reads"] += 1
    counts, scales, valid = torch.stack(
        [tim_valid.sum(-1).to(f64), scale, sol.valid.to(f64)]).cpu().tolist()
    groups: Dict[Tuple[int, float], list] = {}
    for i, (k, s, ok) in enumerate(zip(counts, scales, valid)):
        if ok:
            groups.setdefault((int(k), 2.0 * noise_bound / s), []).append(i)
    rotation = sol.rotation.to(f64)
    optimal = np.zeros(len(counts), bool)
    suboptimality = np.full(len(counts), np.inf)
    for (k, nb), members in sorted(groups.items()):
        idx = torch.as_tensor(members, device=dev)
        pos = order[idx, :k]
        v1k, v2k = (v[idx].gather(-1, pos[:, None, :].expand(-1, 3, -1)) for v in (v1, v2))
        theta = sol.rotation_inlier_mask[idx].gather(-1, pos)
        rotation[idx] = svd_rot(v1k, v2k, theta.to(f64))
        res = drs.certify_batch(rotation[idx], v1k, v2k, theta,
                                params.replace(noise_bound=nb), device=dev, stage_ms=stage_ms)
        for i, r in zip(members, res):
            optimal[i], suboptimality[i] = r.is_optimal, r.best_suboptimality
    out = (rotation, torch.as_tensor(optimal, device=dev),
           torch.as_tensor(suboptimality, device=dev))
    clock.mark("certify")
    return out


def solve_batch_sharded(
    src,
    dst,
    params: RobustRegistrationSolverParams,
    mesh: Mesh,
    valid=None,
    batch_axis: str = "batch",
    use_matmul_norms: bool = False,
    device: DeviceLike = None,
) -> PipelineSolution:
    """Batch solve with the batch axis sharded over the ranks of ``mesh``.

    The data-parallel path: the rank at coordinate ``c`` of ``batch_axis``
    (size ``P``) solves problems ``[c B/P, (c+1) B/P)`` with
    :func:`solve_batch` on ``device``, the ranks along the mesh's other axes
    repeat it (as ``P(batch_axis)`` replicates), and the solutions are
    gathered along the batch: every rank returns the whole batch's
    :class:`PipelineSolution`. The problems are independent, so the only
    traffic is that gather. ``B`` must be a multiple of ``P``, as for JAX's
    ``device_put`` to ``P(batch_axis)``: pad the batch with
    :func:`pad_problems` (its ``valid`` masks mark the padding).
    """
    mesh = require_mesh(mesh)
    if mesh is None:
        raise TypeError("solve_batch_sharded needs a Mesh (make_mesh); "
                        "solve_batch solves on one device")
    parts = mesh.shape[batch_axis]
    bsz = src.shape[0]
    if bsz % parts:
        raise ValueError(
            f"a batch of {bsz} does not split evenly over the {parts} ranks of "
            f"mesh axis {batch_axis!r}: pad it with pad_problems")
    lo, hi = shard_range(bsz, parts, mesh.coords[batch_axis])
    part = solve_batch(src[lo:hi], dst[lo:hi], params,
                       None if valid is None else valid[lo:hi], device=device,
                       use_matmul_norms=use_matmul_norms)
    return PipelineSolution(*(mesh.all_gather(f, batch_axis) for f in part))
