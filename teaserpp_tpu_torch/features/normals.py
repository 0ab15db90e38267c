"""Surface normal estimation from radius neighbourhoods.

Counterpart of ``teaserpp_tpu/features/normals.py``, the reference's
pcl::NormalEstimationOMP usage (fpfh.cc:28-33): per-point covariance of the
radius neighbourhood, smallest eigenvector by the batched Jacobi 3x3
eigensolver of ``ops/procrustes.py``, oriented toward the viewpoint (PCL
flipNormalTowardsViewpoint semantics, default origin).

Two routes over the same per-pair arithmetic:

* dense (:func:`estimate_normals`): query rows in chunks against the whole
  cloud, on the device the points lie on;
* grid-pruned (:func:`estimate_normals_pruned`): the query blocks of a
  :class:`~teaserpp_tpu_torch.features.spatial.NeighborPlan`, each against
  its own candidate list, on ``device``.

Both collect the (N, 3, 3) covariances and call the eigensolver once over the
cloud: it is a Python loop of ~450 small operations, the same arithmetic per
point whatever the batch, so one call gives the bits that one call a block
would, at a hundredth of the launches.

With a ``mesh`` (``parallel/multihost.py``) the grid route's query blocks are
sharded over the ranks of the mesh's first axis, as JAX's ``shard_map``
shards them; the sorted cloud is replicated. A rank runs a contiguous run of
the steps that ``mesh=None`` runs (:func:`mesh_steps`), cut at the same
block indices, so every reduction and product runs at the shape it has
without a mesh and the gathered results equal ``mesh=None``'s bit for bit.

The radius test keeps each JAX route's own rounding of r^2. On the dense
route JAX's radius is static, so ``radius * radius`` is a Python double
rounded once to the points' dtype; on the grid route it is a device scalar
of that dtype, squared in it. In float32 the two differ by an ulp for about
half of all radii (r = 0.05 among them), and a pair on that boundary would
land in different neighbourhoods: see :func:`_r2_dense`, :func:`_r2_grid`.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from teaserpp_tpu_torch.device import DeviceLike, resolve_device
from teaserpp_tpu_torch.features.spatial import SENTINEL, NeighborPlan, sorted_padded
from teaserpp_tpu_torch.ops.procrustes import jacobi_eigh_small
from teaserpp_tpu_torch.parallel.multihost import Mesh, require_mesh

# Pairs (query rows x candidates) one step of a pruned pass holds at once:
# several query blocks go together up to this count. A step keeps a few dozen
# (S, B, M) temporaries of the points' dtype, so at float32 the cap bounds
# them to ~64 MiB each.
PAIRS_PER_STEP = 1 << 24


class NormalsResult(NamedTuple):
    normals: torch.Tensor  # (N, 3)
    curvatures: torch.Tensor  # (N,) lambda_0 / (l0 + l1 + l2), PCL-style
    valid: torch.Tensor  # (N,) bool — at least 3 neighbours


def _r2_dense(radius: float, dtype, device) -> torch.Tensor:
    """r^2 as the dense JAX route rounds it: a double product, rounded once."""
    r = float(radius)
    return torch.tensor(r * r, dtype=dtype, device=device)


def _r2_grid(radius: float, dtype, device) -> torch.Tensor:
    """r^2 as the grid JAX route rounds it: r rounded, then squared in dtype."""
    r = torch.tensor(float(radius), dtype=dtype, device=device)
    return r * r


def _require_tensor(name: str, x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        raise TypeError(
            f"{name} must be a torch.Tensor (the dense routes run where their "
            f"tensors are), got {type(x).__name__}"
        )
    return x


def _planes(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x, y, z planes of a (..., 3) tensor."""
    return a[..., 0], a[..., 1], a[..., 2]


def pair_diffs(q: torch.Tensor, c: torch.Tensor):
    """Candidate-minus-query differences and squared distances.

    ``q`` (S, B, 3) queries, ``c`` (S, M, 3) candidates -> the three (S, B, M)
    difference planes and ``dx^2 + dy^2 + dz^2`` summed in that order (JAX's
    sum over a 3-wide axis).
    """
    qx, qy, qz = _planes(q)
    cx, cy, cz = _planes(c)
    dx = cx[:, None, :] - qx[:, :, None]
    dy = cy[:, None, :] - qy[:, :, None]
    dz = cz[:, None, :] - qz[:, :, None]
    return dx, dy, dz, dx * dx + dy * dy + dz * dz


def _moments(q: torch.Tensor, c: torch.Tensor, r2: torch.Tensor):
    """Neighbour count and centred covariance of each query row.

    ``q`` (S, B, 3) against ``c`` (S, M, 3) -> (cov (S*B, 3, 3), cnt (S*B,)).
    Sums run over query-centred differences: the covariance of a radius-r
    neighbourhood is ~r^2 while raw second moments grow with the squared
    distance from the origin, and float32 loses the one to cancellation in
    the other (JAX normals.py:50-54).
    """
    dx, dy, dz, d2 = pair_diffs(q, c)
    mask = (d2 <= r2).to(q.dtype)
    cnt = mask.sum(-1)
    safe = torch.clamp(cnt, min=1.0)
    md = (mask * dx, mask * dy, mask * dz)
    mean = [s.sum(-1) / safe for s in md]
    d = (dx, dy, dz)
    cov = q.new_empty(q.shape[:2] + (3, 3))
    for i in range(3):
        for j in range(i, 3):
            cov[..., i, j] = (md[i] * d[j]).sum(-1) / safe - mean[i] * mean[j]
            if j != i:
                cov[..., j, i] = cov[..., i, j]
    return cov.reshape(-1, 3, 3), cnt.reshape(-1)


def _normals_from_cov(cov, cnt, query_pts, viewpoint) -> NormalsResult:
    """Smallest eigenvector, PCL curvature and viewpoint flip for every row.

    One eigensolver call over all rows. Eigenvalues are ordered by a stable
    argsort, as ``jnp.argsort`` is stable (JAX normals.py:65).
    """
    eigvals, eigvecs = jacobi_eigh_small(cov)
    order = torch.argsort(eigvals, dim=-1, stable=True)
    small = order[:, 0]
    normal = torch.gather(eigvecs, -1, small[:, None, None].expand(-1, 3, 1))[..., 0]
    lam = torch.gather(eigvals, -1, order)
    lam_sum = lam[:, 0].abs() + lam[:, 1].abs() + lam[:, 2].abs()
    positive = lam_sum > 0
    curvature = torch.where(
        positive,
        lam[:, 0].abs() / torch.where(positive, lam_sum, torch.ones_like(lam_sum)),
        torch.zeros_like(lam_sum),
    )
    to_vp = viewpoint[None, :] - query_pts
    dot = normal[:, 0] * to_vp[:, 0] + normal[:, 1] * to_vp[:, 1] + normal[:, 2] * to_vp[:, 2]
    normal = torch.where((dot < 0)[:, None], -normal, normal)
    return NormalsResult(normals=normal, curvatures=curvature, valid=cnt >= 3)


def radius_neighbor_mask(
    pts: torch.Tensor, radius: float, valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """(N, N) bool: ||p_i - p_j|| <= radius (self included, PCL convention).

    Gram form, as in JAX; the product is one float32 (or float64) matrix
    product, with the process's TF32 setting left as it is.
    """
    pts = _require_tensor("pts", pts)
    sq = torch.sum(pts * pts, dim=-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (pts @ pts.T)
    mask = d2 <= _r2_dense(radius, pts.dtype, pts.device)
    if valid is not None:
        mask = mask & valid[None, :] & valid[:, None]
    return mask


def estimate_normals(
    pts: torch.Tensor,
    radius: float,
    viewpoint: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    valid: Optional[torch.Tensor] = None,
    chunk_size: int = 1024,
) -> NormalsResult:
    """Per-point normals from the radius neighbourhood covariance.

    Args:
      pts: (N, 3) points, a tensor; the pass runs on its device in its dtype.
      radius: neighbourhood radius (PCL setRadiusSearch equivalent).
      viewpoint: orientation reference; normals flipped to face it.
      valid: optional (N,) padding mask (invalid points excluded from
        neighbourhoods and marked invalid in the result).
      chunk_size: query rows per step against the whole cloud.
    """
    pts = _require_tensor("pts", pts)
    dtype, device = pts.dtype, pts.device
    n = pts.shape[0]
    vp = torch.tensor(viewpoint, dtype=dtype, device=device)
    if valid is not None:
        # exclude invalid points from every neighbourhood by parking them far away
        pts_eff = torch.where(valid[:, None], pts, torch.full_like(pts, 1e12))
    else:
        pts_eff = pts
    r2 = _r2_dense(radius, dtype, device)
    b = max(min(chunk_size, n), 1)
    covs, cnts = [], []
    for s in range(0, n, b):
        cov, cnt = _moments(pts_eff[None, s:s + b], pts_eff[None], r2)
        covs.append(cov)
        cnts.append(cnt)
    res = _normals_from_cov(torch.cat(covs), torch.cat(cnts), pts_eff, vp)
    if valid is not None:
        res = res._replace(valid=res.valid & valid)
    return res


def _floating(dtype: torch.dtype) -> torch.dtype:
    return dtype if dtype.is_floating_point else torch.float32


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def sorted_on_device(x, plan: NeighborPlan, fill, device: torch.device,
                     dtype) -> torch.Tensor:
    """``x`` in the plan's sorted order with one trailing ``fill`` row, on
    ``device``: :func:`spatial.sorted_padded` for host arrays, the same gather
    on the device for a tensor already there (no round trip; ``cuda`` names
    the current card)."""
    if isinstance(x, torch.Tensor) and x.device.type == device.type and (
            device.index is None or x.device.index == device.index):
        perm = torch.as_tensor(plan.perm, device=device)
        tail = torch.full((1,) + tuple(x.shape[1:]), fill, dtype=dtype, device=device)
        return torch.cat([x.to(dtype)[perm], tail])
    return torch.as_tensor(sorted_padded(_host(x), plan, fill), device=device).to(dtype)


def query_rows(plan: NeighborPlan, device) -> torch.Tensor:
    """(nblocks, block) sorted-row index of every query slot; the tail block's
    padding slots name the trailing fill row ``n`` (:func:`spatial.query_blocks`)."""
    pad = plan.nblocks * plan.block - plan.n
    idx = np.concatenate([np.arange(plan.n), np.full(pad, plan.n, np.int64)])
    return torch.as_tensor(idx.reshape(plan.nblocks, plan.block), device=device)


def block_steps(plan: NeighborPlan) -> List[range]:
    """Query blocks grouped so one step holds at most :data:`PAIRS_PER_STEP`
    pairs (at least one block a step)."""
    per = max(1, PAIRS_PER_STEP // max(plan.block * plan.mpad, 1))
    return [range(s, min(s + per, plan.nblocks)) for s in range(0, plan.nblocks, per)]


def check_plan_radius(radius: float, plan: NeighborPlan) -> None:
    if float(radius) > plan.radius * (1 + 1e-9):
        raise ValueError(
            f"radius {radius} exceeds plan.radius {plan.radius}: the plan's "
            "candidate lists only provably cover plan.radius — neighbors "
            "beyond it would be silently dropped. Build a plan for this "
            "radius."
        )


def mesh_steps(plan: NeighborPlan, mesh: Optional[Mesh]):
    """The steps of :func:`block_steps` that this rank runs, and each rank's
    count of query slots (None without a mesh, when this process runs every
    step).

    A step starting at block ``s`` goes to coordinate ``s P // nblocks`` of
    the mesh's first axis (size ``P``): each rank gets a contiguous run of
    whole steps, about ``nblocks / P`` blocks (JAX pads the blocks to a
    multiple of ``P`` with ``pad_block_count`` and splits them evenly; a cut
    inside a step would run part of it at another shape, and on the card
    another batch size may take another reduction order).
    """
    steps = block_steps(plan)
    if require_mesh(mesh) is None:
        return steps, None
    axis = mesh.axis_names[0]
    parts = mesh.shape[axis]
    owner = [s.start * parts // plan.nblocks for s in steps]
    mine = [s for s, o in zip(steps, owner) if o == mesh.coords[axis]]
    sizes = [plan.block * sum(len(s) for s, o in zip(steps, owner) if o == r)
             for r in range(parts)]
    return mine, sizes


def gather_slots(mesh: Optional[Mesh], sizes, x: torch.Tensor) -> torch.Tensor:
    """The ranks' per-slot rows ``x`` gathered in block order along the
    mesh's first axis (``x`` itself without a mesh)."""
    if mesh is None:
        return x
    return mesh.all_gather(x, mesh.axis_names[0], sizes=sizes)


def estimate_normals_pruned(
    pts,
    radius: float,
    plan: NeighborPlan,
    viewpoint: Sequence[float] = (0.0, 0.0, 0.0),
    mesh=None,
    device: DeviceLike = None,
) -> NormalsResult:
    """Grid-hash-pruned normals: the dense route's semantics (the candidate
    set provably contains every radius neighbour, the exact Euclidean
    predicate is re-tested) at a few percent of the pair work.

    ``pts`` (N, 3) are host points (numpy, or a tensor), sorted on the host
    by ``plan`` (from :func:`~teaserpp_tpu_torch.features.spatial.
    build_neighbor_plans` for this radius) and computed in their own dtype
    on ``device`` (CUDA unless named). With a ``mesh`` (a port ``Mesh``)
    the query blocks are sharded over its first axis (the module docstring)
    and every rank of it returns the whole result.
    """
    check_plan_radius(radius, plan)
    steps, sizes = mesh_steps(plan, mesh)
    dev = resolve_device(device)
    pts_np = _host(pts)
    dtype = _floating(torch.as_tensor(pts_np[:0]).dtype)
    sp = sorted_on_device(pts_np, plan, SENTINEL, dev, dtype)
    rows = query_rows(plan, dev)
    ci = torch.as_tensor(plan.cand_idx, device=dev).long()
    r2 = _r2_grid(radius, dtype, dev)
    covs, cnts = [sp.new_empty((0, 3, 3))], [sp.new_empty((0,))]
    for step in steps:
        blocks = slice(step.start, step.stop)
        cov, cnt = _moments(sp[rows[blocks]], sp[ci[blocks]], r2)
        covs.append(cov)
        cnts.append(cnt)
    vp = torch.tensor(tuple(viewpoint), dtype=dtype, device=dev)
    mine = slice(steps[0].start, steps[-1].stop) if steps else slice(0, 0)
    res = _normals_from_cov(torch.cat(covs), torch.cat(cnts), sp[rows[mine].reshape(-1)], vp)
    inv = torch.as_tensor(plan.inv, device=dev)
    return NormalsResult(*(gather_slots(mesh, sizes, a)[: plan.n][inv] for a in res))
