"""Grid-hash neighbor-candidate plans for the feature front-end.

Counterpart of ``teaserpp_tpu/features/spatial.py``, copied line for line
(host numpy, no JAX): the plans decide which candidates every pass sees, so
both packages must build equal arrays from equal points.

In place of the reference's kd-tree radius searches (the PCL kd-tree inside
NormalEstimationOMP / FPFHEstimationOMP, reference fpfh.h:59 + fpfh.cc:28-40),
which chase pointers point by point,

  1. points are sorted by spatial grid cell on the host (cheap numpy);
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
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np


class NeighborPlan(NamedTuple):
    """Host-built candidate plan for one search radius.

    All downstream device arrays are indexed in SORTED order; ``perm``
    gathers original -> sorted, ``inv`` scatters sorted -> original.
    ``cand_idx[b]`` lists candidate point indices (sorted order) for query
    block ``b``; entries equal to ``n`` are padding and must resolve to a
    sentinel row appended by the caller.
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
