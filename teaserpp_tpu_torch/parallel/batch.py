"""Batched registration: many independent problems in one call.

Counterpart of ``teaserpp_tpu/parallel/batch.py``. Variable-size problems
are padded to a common N with validity masks (:func:`pad_problems`, numpy
only, copied from the JAX package). :func:`solve_batch_sharded` splits a
batch over the ranks of a mesh axis (``parallel/multihost.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from teaserpp_tpu_torch.device import DeviceLike
from teaserpp_tpu_torch.params import RobustRegistrationSolverParams
from teaserpp_tpu_torch.parallel.multihost import Mesh, require_mesh, shard_range
from teaserpp_tpu_torch.solvers.pipeline import PipelineSolution, register_pair


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
) -> PipelineSolution:
    """Solve a (B, 3, N) problem batch on ``device`` (CUDA unless named).

    Known or unknown scale (``params.estimate_scaling``), every
    inlier-selection mode and rotation algorithm, so the library's default
    params run as they are. PMC_EXACT runs the batched greedy clique, as the
    JAX package's batched path does; the exact search is the facade's,
    ``RobustRegistrationSolver``, one problem at a time. See
    :func:`register_pair` for ``stage_ms`` and ``use_matmul_norms``.
    """
    return register_pair(src, dst, params, valid=valid, device=device,
                         stage_ms=stage_ms, use_matmul_norms=use_matmul_norms)


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
