"""Grid-hash neighbor-candidate plans for the feature front-end.

Counterpart of ``teaserpp_tpu/features/spatial.py``, whose host numpy
:func:`build_neighbor_plans` is copied here line for line (no JAX): the
plans decide which candidates every pass sees, so both packages must build
equal arrays from equal points.

In place of the reference's kd-tree radius searches (the PCL kd-tree inside
NormalEstimationOMP / FPFHEstimationOMP, reference fpfh.h:59 + fpfh.cc:28-40),
which chase pointers point by point,

  1. points are sorted by spatial grid cell;
  2. queries are processed in blocks of consecutive sorted points;
  3. each block gets a PADDED candidate index list — the union of the
     sorted-order ranges of every grid cell within Chebyshev cell-distance
     ``reach = ceil(radius / cell)`` of a cell occupied by the block.

Exactness: a neighbor within ``radius`` of a query lies in a cell within
``reach`` of the query's cell, so the candidate list provably contains
every true (exact-arithmetic) radius neighbor; the device passes re-test
the Euclidean predicate against the candidates, and padding slots point
at a sentinel row parked far away (inert under every radius test).
Boundary caveat: coverage is proven in exact arithmetic. When the device
predicate runs in f32, a pair whose true separation is a hair PAST the
radius can f32-round to "inside" — the dense path would then include it
while, at exact-integer radius/cell ratios, the candidate grid may not.
That window is ~radius * 1e-7, inside which the dense path's own f32
predicate is itself rounding-determined, so pruned-vs-dense can differ by
such a boundary pair in principle. Because candidacy comes from the
block's own occupied CELLS — never from a bounding box of the block — a
block that straddles distant regions (sort-order seam) just gets the
union of two local neighborhoods, not everything in between.

Every downstream pass keeps the dense path's shape (masked arithmetic over
fixed (B, M) tiles, one query block at a time) but touches a few percent of
the pairs.

:func:`build_neighbor_plans_tensor` builds the same integers from a float64
tensor where it lies: on a CUDA card by the kernels of
``csrc/neighbor_plans.cu`` (counted in ``ops.cuda_kernels.LAUNCHES
["neighbor_plans"]``), with one host read, of the plans' widths; on the CPU
by :func:`build_neighbor_plans_plain`, the same algorithm in plain PyTorch.
Their plans hold tensors on that device, which the passes take as they are.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from teaserpp_tpu_torch.ops import cuda_kernels

# The front end's work, counted where it is done (as ``ops.cuda_kernels.
# LAUNCHES`` counts launches): of each pass, the (query, candidate) pairs it
# tests (the plan's padded candidate lists, or N^2 on the dense route) and
# the ordered pairs within its radius, self included, whatever implements
# it; of the matcher, the correspondences it returns and the query rows of
# feature distances it computes (both directions).
FRONTEND = {"normals_candidates": 0, "normals_neighbors": 0, "fpfh_candidates": 0,
            "fpfh_neighbors": 0, "correspondences": 0, "match_rows": 0}


def reset_frontend() -> None:
    for k in FRONTEND:
        FRONTEND[k] = 0


class NeighborPlan(NamedTuple):
    """Candidate plan for one search radius.

    All downstream device arrays are indexed in SORTED order; ``perm``
    gathers original -> sorted, ``inv`` scatters sorted -> original.
    ``cand_idx[b]`` lists candidate point indices (sorted order) for query
    block ``b``; entries equal to ``n`` are padding and must resolve to a
    sentinel row appended by the caller. The index arrays are numpy from
    :func:`build_neighbor_plans`, tensors on the points' device from
    :func:`build_neighbor_plans_tensor`, with equal integers.
    """

    perm: np.ndarray  # (n,) int64: sorted_x = x[perm]
    inv: np.ndarray  # (n,) int64: x = sorted_x[inv]
    n: int
    block: int  # query block size B
    nblocks: int
    mpad: int  # padded candidate count M
    cand_idx: np.ndarray  # (nblocks, mpad) int32, padding == n
    radius: float

    @property
    def pair_fraction(self) -> float:
        """Padded candidate work as a fraction of the dense N^2 work."""
        return float(self.mpad) / max(self.n, 1)


def _cell_keys(pts: np.ndarray, lo: np.ndarray, cell: float):
    """Integer grid coordinates and packed int64 cell keys."""
    ijk = np.floor((pts - lo) / cell).astype(np.int64)
    dims = ijk.max(axis=0) + 1
    key = (ijk[:, 0] * dims[1] + ijk[:, 1]) * dims[2] + ijk[:, 2]
    return ijk, key, dims


def build_neighbor_plans(
    pts: np.ndarray,
    radii: Sequence[float],
    block: int = 1024,
    pad_multiple: int = 1024,
) -> List[NeighborPlan]:
    """One :class:`NeighborPlan` per radius, sharing a single sort order.

    The grid cell size is the smallest radius (so the shared permutation
    is the finest ordering any pass needs); larger radii use a larger
    Chebyshev ``reach`` on the same grid. ``mpad`` is the per-plan max
    candidate count rounded up to ``pad_multiple`` (bounds recompiles
    across clouds of similar density).
    """
    pts = np.asarray(pts, np.float64)
    n = len(pts)
    radii = [float(r) for r in radii]
    cell = min(radii)
    if cell <= 0:
        raise ValueError(f"radii must be positive, got {radii}")
    lo = pts.min(axis=0)
    ijk, key, dims = _cell_keys(pts, lo, cell)

    perm = np.argsort(key, kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    skey = key[perm]
    uniq, starts = np.unique(skey, return_index=True)
    ends = np.append(starts[1:], n)

    nblocks = (n + block - 1) // block
    ncells = len(uniq)
    lens = ends - starts

    # unique (block, cell) incidence: which grid cells each query block
    # occupies — all vectorized (the per-cell Python dict walk this
    # replaces cost ~3 s at 100K points)
    block_of = np.arange(n) // block
    cell_idx_of = np.searchsorted(uniq, skey)  # exact: every skey is in uniq
    ucode = np.unique(block_of.astype(np.int64) * ncells + cell_idx_of)
    ub = ucode // ncells  # block of each incidence pair
    uc = ucode % ncells  # cell index of each incidence pair

    plans: List[NeighborPlan] = []
    for radius in radii:
        reach = int(np.ceil(radius / cell - 1e-12))
        if (2 * reach + 1) ** 3 > 4096:  # reach > 7
            raise ValueError(
                f"radius {radius} needs Chebyshev reach {reach} on the cell "
                f"grid (cell={cell}, set by the smallest radius): "
                f"{(2 * reach + 1) ** 3} neighbor-cell offsets is past the "
                "practical grid-hash regime (host plan build would blow up "
                "cubically). Use closer radii, separate plans per radius, "
                "or the dense path."
            )
        offs = np.array(
            [
                (i * dims[1] + j) * dims[2] + k
                for i in range(-reach, reach + 1)
                for j in range(-reach, reach + 1)
                for k in range(-reach, reach + 1)
            ],
            np.int64,
        )
        # mark[b, c] = block b's candidate set includes occupied cell c
        mark = np.zeros((nblocks, ncells), bool)
        base = uniq[uc]
        for o in offs:
            pos = np.searchsorted(uniq, base + o)
            pos_c = np.minimum(pos, ncells - 1)
            hit = uniq[pos_c] == base + o
            mark[ub[hit], pos_c[hit]] = True

        counts = mark @ lens
        mmax = max(int(counts.max()), 1)
        mpad = ((mmax + pad_multiple - 1) // pad_multiple) * pad_multiple
        cand_idx = np.full((nblocks, mpad), n, np.int32)
        for b in range(nblocks):
            cells_b = np.nonzero(mark[b])[0]
            if not len(cells_b):
                continue
            s_b, l_b = starts[cells_b], lens[cells_b]
            # multi-arange: concatenate [s, s+l) ranges without a Python loop
            total = int(l_b.sum())
            step = np.ones(total, np.int64)
            step[0] = s_b[0]
            cs = np.cumsum(l_b)[:-1]
            step[cs] = s_b[1:] - (s_b[:-1] + l_b[:-1] - 1)
            cand_idx[b, :total] = np.cumsum(step)
        plans.append(
            NeighborPlan(
                perm=perm,
                inv=inv,
                n=n,
                block=block,
                nblocks=nblocks,
                mpad=mpad,
                cand_idx=cand_idx,
                radius=radius,
            )
        )
    return plans


def _plan_args(pts: torch.Tensor, radii: Sequence[float]):
    """``(radii, cell, reaches)`` of :func:`build_neighbor_plans_tensor`,
    refused as :func:`build_neighbor_plans` refuses them."""
    if not isinstance(pts, torch.Tensor) or pts.dtype != torch.float64:
        raise TypeError(f"pts must be a float64 tensor, got {getattr(pts, 'dtype', type(pts))}")
    if pts.dim() != 2 or pts.shape[1] != 3 or pts.shape[0] == 0:
        raise ValueError(f"pts must be (N, 3) with N >= 1, got {tuple(pts.shape)}")
    radii = [float(r) for r in radii]
    cell = min(radii)
    if cell <= 0:
        raise ValueError(f"radii must be positive, got {radii}")
    reaches = [int(np.ceil(r / cell - 1e-12)) for r in radii]
    for radius, reach in zip(radii, reaches):
        if (2 * reach + 1) ** 3 > 4096:  # reach > 7
            raise ValueError(
                f"radius {radius} needs Chebyshev reach {reach} on the cell "
                f"grid (cell={cell}, set by the smallest radius): "
                f"{(2 * reach + 1) ** 3} neighbor-cell offsets is past the "
                "practical grid-hash regime. Use closer radii, separate plans "
                "per radius, or the dense path."
            )
    return radii, cell, reaches


def _sorted_cells(key: torch.Tensor):
    """The stable sort of the cell keys and the occupied cells, with no host
    read: ``(perm, inv, skey, first, uniq, starts, lens)``. ``first`` marks
    the first sorted point of each cell; ``uniq``, ``starts`` and ``lens``
    hold each cell's key, first sorted index and point count in ascending
    key order, padded to N with the largest int64, N and 0."""
    n = key.shape[0]
    skey, perm = torch.sort(key, stable=True)
    pos = torch.arange(n, device=key.device)
    inv = torch.empty_like(perm).scatter_(0, perm, pos)
    first = torch.ones(n, dtype=torch.bool, device=key.device)
    first[1:] = skey[1:] != skey[:-1]
    cell_of = torch.cumsum(first, 0) - 1
    uniq = torch.full_like(skey, torch.iinfo(torch.int64).max).scatter_(0, cell_of, skey)
    starts = torch.full_like(skey, n).scatter_reduce_(0, cell_of, pos, "amin")
    lens = torch.diff(starts, append=starts.new_full((1,), n))
    return perm, inv, skey, first, uniq, starts, lens


def build_neighbor_plans_plain(
    pts: torch.Tensor, radii: Sequence[float], block: int = 1024, pad_multiple: int = 1024,
) -> List[NeighborPlan]:
    """Plain PyTorch version of ``csrc/neighbor_plans.cu``: the plans of
    :func:`build_neighbor_plans` from (N, 3) float64 ``pts``, a tensor, as
    tensors on its device.

    The kernels' algorithm: keys ``floor((p - lo) / cell)`` packed in int64;
    the stable sort and the occupied cells; for each (block, cell)
    incidence and row ``(di, dj)`` of the reach's offsets, the occupied
    cells whose keys lie within ``r`` of ``key + (di d1 + dj) d2`` (the
    host's packed offsets a row of ``dk`` at a time, wraps included), by a
    binary search into the unique keys; each block's count the sum of its
    marked cells' lengths; its candidates their sorted-order ranges in
    ascending cell order, padded with N.
    """
    radii, cell, reaches = _plan_args(pts, radii)
    n = pts.shape[0]
    lo, hi = pts.amin(0), pts.amax(0)
    ijk = torch.floor((pts - lo) / cell).long()
    d1, d2 = (int(d) + 1 for d in torch.floor((hi - lo) / cell).long()[1:])
    key = (ijk[:, 0] * d1 + ijk[:, 1]) * d2 + ijk[:, 2]
    perm, inv, skey, first, uniq, starts, lens = _sorted_cells(key)
    ncells = int(first.sum())
    uniq, starts, lens = uniq[:ncells], starts[:ncells], lens[:ncells]
    nblocks = (n + block - 1) // block
    inc = torch.nonzero((torch.arange(n, device=pts.device) % block == 0) | first)[:, 0]
    inc_block, base = inc // block, skey[inc]
    plans = []
    for radius, reach in zip(radii, reaches):
        mark = torch.zeros((nblocks, ncells), dtype=torch.bool, device=pts.device)
        for di in range(-reach, reach + 1):
            for dj in range(-reach, reach + 1):
                centre = base + (di * d1 + dj) * d2
                c0 = torch.searchsorted(uniq, centre - reach)
                c1 = torch.searchsorted(uniq, centre + reach, right=True)
                for k in range(2 * reach + 1):
                    hit = c0 + k < c1
                    mark[inc_block[hit], c0[hit] + k] = True
        counts = (mark * lens).sum(1)
        mpad = -(-max(int(counts.max()), 1) // pad_multiple) * pad_multiple
        # each marked (block, cell)'s range at its offset in the block's list
        b, c = torch.nonzero(mark, as_tuple=True)  # ascending block, then cell
        length = lens[c]
        before = torch.cumsum(length, 0) - length
        offset = before - (torch.cumsum(counts, 0) - counts)[b]
        pair = torch.repeat_interleave(torch.arange(len(c), device=pts.device), length)
        within = torch.arange(len(pair), device=pts.device) - before[pair]
        cand_idx = torch.full((nblocks, mpad), n, dtype=torch.int32, device=pts.device)
        cand_idx[b[pair], offset[pair] + within] = (starts[c[pair]] + within).int()
        plans.append(NeighborPlan(perm=perm, inv=inv, n=n, block=block, nblocks=nblocks,
                                  mpad=mpad, cand_idx=cand_idx, radius=radius))
    return plans


def build_neighbor_plans_tensor(
    pts: torch.Tensor, radii: Sequence[float], block: int = 1024, pad_multiple: int = 1024,
) -> List[NeighborPlan]:
    """:func:`build_neighbor_plans` on the device of ``pts``, (N, 3) float64:
    the same integers, as tensors there.

    On the CPU this is :func:`build_neighbor_plans_plain`. On CUDA the
    kernels of ``csrc/neighbor_plans.cu`` run on the current stream, each
    launch counted in ``LAUNCHES["neighbor_plans"]`` (the keys once, then
    the marks and the candidate lists once a radius), the sort and the
    occupied cells between them as tensor operations; the plans' widths
    ``mpad`` are the one host read. Every table is over the points or the
    occupied cells: the mark of each radius is a (blocks, ceil(N / 32))
    bitmap, with the sum of the marked cells' lengths a word beside it.
    """
    if pts.device.type == "cpu":
        return build_neighbor_plans_plain(pts, radii, block, pad_multiple)
    if pts.device.type != "cuda":
        raise ValueError(f"the plans are built on cuda or cpu, not {pts.device}")
    radii, cell, reaches = _plan_args(pts, radii)
    if block < 1:
        raise ValueError(f"block must be positive, got {block}")
    n, dev = pts.shape[0], pts.device
    pts = pts.contiguous()
    lohi = torch.stack([pts.amin(0), pts.amax(0)])

    def launch(entry, *args):
        cuda_kernels._launch("neighbor_plans", "neighbor_plans", dev, *args, entry=entry)

    key = torch.empty(n, dtype=torch.int64, device=dev)
    launch("plan_keys", pts.data_ptr(), lohi.data_ptr(), cell, n, key.data_ptr())
    perm, inv, skey, _, uniq, starts, lens = _sorted_cells(key)
    nblocks, words = (n + block - 1) // block, (n + 31) // 32
    marks = []
    for reach in reaches:
        mark = torch.zeros((nblocks, words), dtype=torch.int32, device=dev)
        wsum = torch.zeros_like(mark)
        launch("plan_mark", skey.data_ptr(), uniq.data_ptr(), lens.data_ptr(), lohi.data_ptr(),
               cell, n, block, reach, words, mark.data_ptr(), wsum.data_ptr())
        marks.append((mark, wsum))
    widths = torch.stack([wsum.sum(1).amax() for _, wsum in marks]).tolist()  # the host read
    plans = []
    for radius, (mark, wsum), width in zip(radii, marks, widths):
        mpad = -(-max(width, 1) // pad_multiple) * pad_multiple
        cand_idx = torch.empty((nblocks, mpad), dtype=torch.int32, device=dev)
        launch("plan_cands", mark.data_ptr(), wsum.data_ptr(), starts.data_ptr(),
               lens.data_ptr(), nblocks, words, mpad, n, cand_idx.data_ptr())
        plans.append(NeighborPlan(perm=perm, inv=inv, n=n, block=block, nblocks=nblocks,
                                  mpad=mpad, cand_idx=cand_idx, radius=radius))
    return plans


# Coordinate far outside any plausible scene: padding rows park here so
# every radius predicate excludes them (1e12^2 = 1e24, comfortably inside
# f32 range). Matches the parking convention of features/normals.py.
SENTINEL = 1e12


def sorted_padded(arr: np.ndarray, plan: NeighborPlan, fill) -> np.ndarray:
    """``arr`` gathered to sorted order with one trailing fill row."""
    arr = np.asarray(arr)
    tail = np.full((1,) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr[plan.perm], tail], axis=0)


def query_blocks(arr_sorted_padded: np.ndarray, plan: NeighborPlan) -> np.ndarray:
    """Sorted array reshaped to (nblocks, block, ...) query blocks.

    The tail block is padded with the sentinel row (index ``n``)."""
    pad = plan.nblocks * plan.block - plan.n
    idx = np.concatenate(
        [np.arange(plan.n), np.full(pad, plan.n, np.int64)]
    ).reshape(plan.nblocks, plan.block)
    return arr_sorted_padded[idx]


def pad_block_count(qb: np.ndarray, plan: NeighborPlan, multiple: int):
    """(query_blocks, cand_idx) padded with inert blocks so the block count
    divides ``multiple`` (mesh sharding needs equal per-device shares).
    Padding query rows sit at the sentinel coordinate; padding candidate
    lists are all-``n`` (the sentinel row), so padded blocks compute
    nothing and their rows are sliced off by the caller."""
    nb = qb.shape[0]
    target = ((nb + multiple - 1) // multiple) * multiple
    if target == nb:
        return qb, plan.cand_idx
    extra = target - nb
    qb_pad = np.concatenate(
        [qb, np.full((extra,) + qb.shape[1:], SENTINEL, qb.dtype)], axis=0
    )
    ci_pad = np.concatenate(
        [
            plan.cand_idx,
            np.full((extra, plan.mpad), plan.n, plan.cand_idx.dtype),
        ],
        axis=0,
    )
    return qb_pad, ci_pad
