"""FPFH correspondence matcher (FGR-style), reference matcher.{h,cc} parity.

Counterpart of ``teaserpp_tpu/features/matcher.py``. In place of the
reference's FLANN kd-trees (matcher.cc:134-137, approximate checks=128
search): exact nearest neighbours, a float32 Gram product per query stripe
to rank candidates, then an exact rescore by direct differences.

Semantics mirror matcher.cc:21-301: optional mean-centre + global-scale
normalisation (only consumed by the tuple test geometry), larger cloud as
the indexing side, the reference's asymmetric initial matching
(i_to_j[i] = NN_j(i) for every i hit by some j, plus all (NN_i(j), j)
pairs), optional cross check, optional random 3-tuple length-ratio test,
swap-back, sort + dedup. The host logic is the JAX package's numpy.

Ties: every candidate selection breaks ties toward the lower index (a stable
sort where JAX's ``lax.top_k`` does so; ``torch.argmin``'s first minimum
inside a block), and the rescore sorts its candidates and takes the first
exact minimum, so the lowest database index wins an exact tie.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from teaserpp_tpu_torch.device import DeviceLike, resolve_device
from teaserpp_tpu_torch.features.spatial import FRONTEND
from teaserpp_tpu_torch.utils.timing import StageTimer

_LANE = 128  # database rows per block of the hierarchical candidate search


def squared_distance(diff: torch.Tensor) -> torch.Tensor:
    """``sum(diff * diff)`` over the last axis, added left to right: the same
    float order on every device and at every shape (a reduction kernel's
    order depends on both), so the exact distance of a pair has the same
    bits wherever it is computed."""
    acc = diff[..., 0] * diff[..., 0]
    for k in range(1, diff.shape[-1]):
        acc = acc + diff[..., k] * diff[..., k]
    return acc


def _rescore_pick(queries, database, cand):
    """Exact-distance argmin over per-query candidate index sets.

    Re-scores with the cancellation-free direct difference (the Gram form
    loses ~||f||^2 * eps absolute accuracy in f32, which for 100-scale FPFH
    descriptors is comparable to real nearest distances). Candidates are
    sorted by index and ``torch.argmin`` takes the first minimum, so ties
    break toward the lowest database index.
    """
    diff = queries[:, None, :] - database[cand]  # (Q, k, D)
    exact = squared_distance(diff)
    order = torch.argsort(cand, dim=-1, stable=True)
    exact_sorted = torch.gather(exact, -1, order)
    cand_sorted = torch.gather(cand, -1, order)
    best = torch.argmin(exact_sorted, dim=-1)
    return torch.gather(cand_sorted, -1, best[:, None])[:, 0]


def _block_top2(a3: torch.Tensor):
    """Per-lane-block (min1, arg1, arg2) over the last axis, ties to the lower
    lane. ``a3`` is (Q, nb, lane) and is overwritten (its winners set to
    +inf). Where a block has no finite runner-up (the last block's padding),
    the runner-up is the winner: JAX's reduce leaves -1 there, a stray
    candidate from the block before (harmless under the exact rescore), and
    no caller depends on either."""
    arg1 = torch.argmin(a3, dim=-1)
    min1 = torch.gather(a3, -1, arg1[..., None])
    a3.scatter_(-1, arg1[..., None], float("inf"))
    arg2 = torch.argmin(a3, dim=-1)
    min2 = torch.gather(a3, -1, arg2[..., None])[..., 0]
    arg2 = torch.where(torch.isinf(min2), arg1, arg2)
    return min1[..., 0], arg1, arg2


def _first_k(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` smallest entries of each row, ties lowest index
    first: the order ``lax.top_k(-values, k)`` gives (``torch.topk`` promises
    no tie order)."""
    return torch.sort(values, dim=-1, stable=True).indices[:, :k]


def _nn_block(queries: torch.Tensor, database: torch.Tensor) -> torch.Tensor:
    """Index of the nearest database row for every query row (squared L2).

    The Gram product ranks candidates, then they are re-scored exactly
    (:func:`_rescore_pick`). For a database of more than 4096 rows the
    approximate row is reduced to per-128-lane-block winners and runners-up,
    the best 32 blocks are taken, and the 64 candidates re-scored. The
    runner-up matters: f32 Gram error (~||f||^2*eps) can mis-rank a true NN
    behind a same-block near-tie (JAX matcher.py:80-125).
    """
    db = database.shape[0]
    q2 = torch.sum(queries * queries, dim=-1)
    d2 = torch.sum(database * database, dim=-1)
    # (q2 + d2) - 2 gram, JAX's order; formed in place in the product's
    # buffer (an exact negation and doubling, then a commutative add) to hold
    # two (Q, DB) float32 buffers, not four. The product stays float32 as long
    # as the process allows no TF32, which PyTorch's default does not.
    approx = (queries @ database.T).mul_(-2.0).add_(q2[:, None] + d2[None, :])

    if db <= 4096:  # small database: direct top-k is cheap
        return _rescore_pick(queries, database, _first_k(approx, min(32, db)))

    nb = -(-db // _LANE)
    pad = nb * _LANE - db
    if pad:
        approx = torch.nn.functional.pad(approx, (0, pad), value=float("inf"))
    a3 = approx.view(approx.shape[0], nb, _LANE)
    bmin, barg, barg2 = _block_top2(a3)  # winner + runner-up per block
    del approx, a3
    bidx = _first_k(bmin, min(32, nb))  # (Q, k) best blocks
    c1 = bidx * _LANE + torch.gather(barg, -1, bidx)
    c2 = bidx * _LANE + torch.gather(barg2, -1, bidx)
    # a padded lane is +inf and never a winner; the clip guards it anyway
    cand = torch.clamp(torch.cat([c1, c2], dim=-1), 0, db - 1)
    return _rescore_pick(queries, database, cand)


def _nn_indices(queries: torch.Tensor, database: torch.Tensor, block: int = 4096) -> torch.Tensor:
    """Exact NN over query stripes of ``block`` rows: peak memory O(block * DB)
    not O(Q * DB) (the full 100K x 100K approximate matrix is 40 GB). Runs on
    the tensors' device."""
    # mean-centring is distance-invariant but removes the descriptor common
    # mode, shrinking norms and thus the Gram form's cancellation error
    center = torch.mean(database, dim=0)
    queries = queries - center
    database = database - center
    q = queries.shape[0]
    if q <= block:
        return _nn_block(queries, database)
    return torch.cat([_nn_block(queries[s:s + block], database) for s in range(0, q, block)])


class Matcher:
    """Reference-style matcher facade (matcher.h:18-63). ``device`` is where
    the nearest-neighbour search runs: CUDA unless named (without CUDA the
    constructor raises)."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._timer = StageTimer()

    def getStageTimings(self) -> dict:
        """Wall-clock seconds of the last ``calculateCorrespondences``
        (``match``: the nearest neighbours both ways and the host filters),
        ending in a device sync."""
        return self._timer.as_dict()

    def _features(self, f) -> torch.Tensor:
        # float32 on both sides, as in JAX (matcher.py:192-195, 215-216): a
        # tensor is cast where it lies after the move, numpy once on the host
        if isinstance(f, torch.Tensor):
            return f.to(self.device).to(torch.float32)
        return torch.from_numpy(np.ascontiguousarray(f, np.float32)).to(self.device)

    def calculateCorrespondences(
        self,
        source_points,
        target_points,
        source_features,
        target_features,
        use_absolute_scale: bool = False,
        use_crosscheck: bool = True,
        use_tuple_test: bool = False,
        tuple_scale: float = 0.0,
        seed: Optional[int] = 0,
    ) -> List[Tuple[int, int]]:
        """Compute (source_idx, target_idx) correspondence pairs.

        ``seed`` drives the tuple test's random triples; the reference seeds
        with time(NULL) (matcher.cc:225) — a fixed seed by default for
        reproducibility, None for entropy.
        """
        self._timer = StageTimer()
        with self._timer.stage("match", sync=self.device):
            corres = self._match(source_points, target_points, source_features,
                                 target_features, use_absolute_scale, use_crosscheck,
                                 use_tuple_test, tuple_scale, seed)
        FRONTEND["correspondences"] += len(corres)
        return corres

    def _match(self, source_points, target_points, source_features, target_features,
               use_absolute_scale, use_crosscheck, use_tuple_test, tuple_scale, seed):
        src_pts = np.asarray(
            getattr(source_points, "points", source_points), dtype=np.float64
        )
        tgt_pts = np.asarray(
            getattr(target_points, "points", target_points), dtype=np.float64
        )
        if src_pts.shape[0] == 3 and src_pts.shape[1] != 3:
            src_pts = src_pts.T
        if tgt_pts.shape[0] == 3 and tgt_pts.shape[1] != 3:
            tgt_pts = tgt_pts.T
        feats = [source_features, target_features]
        clouds = [src_pts, tgt_pts]

        # normalizePoints (matcher.cc:55-113): mean-center both clouds; scale
        # both by the max centered norm unless absolute scale is requested.
        means = [c.mean(axis=0) for c in clouds]
        clouds = [c - m for c, m in zip(clouds, means)]
        scale = max(np.linalg.norm(c, axis=1).max() if len(c) else 0.0 for c in clouds)
        global_scale = 1.0 if use_absolute_scale else scale
        if global_scale != 1.0 and global_scale > 0:
            clouds = [c / global_scale for c in clouds]

        # larger cloud indexes as side i (matcher.cc:121-126)
        fi, fj = 0, 1
        swapped = False
        if clouds[1].shape[0] > clouds[0].shape[0]:
            fi, fj = 1, 0
            swapped = True
        n_i = clouds[fi].shape[0]

        feat_i = self._features(feats[fi])
        feat_j = self._features(feats[fj])
        # NN of each j-feature among i-features, and vice versa
        nn_i_of_j = _nn_indices(feat_j, feat_i).cpu().numpy()  # (n_j,)
        nn_j_of_i = _nn_indices(feat_i, feat_j).cpu().numpy()  # (n_i,)
        FRONTEND["match_rows"] += len(nn_i_of_j) + len(nn_j_of_i)

        # initial matching (matcher.cc:151-175), vectorized
        i_to_j = np.full(n_i, -1, np.int64)
        hit = np.unique(nn_i_of_j)
        i_to_j[hit] = nn_j_of_i[hit]
        ii = np.nonzero(i_to_j != -1)[0]
        corres_ij = np.stack([ii, i_to_j[ii]], axis=1)  # (Mij, 2)
        n_j = len(nn_i_of_j)

        if use_crosscheck:
            # (i, j) kept iff j == i_to_j[i] and nn_i_of_j[j] == i
            # (matcher.cc:182-213)
            jj = corres_ij[:, 1]
            keep = (jj >= 0) & (jj < n_j)
            keep[keep] = nn_i_of_j[jj[keep]] == corres_ij[keep, 0]
            corres = corres_ij[keep]
        else:
            corres_ji = np.stack(
                [nn_i_of_j, np.arange(n_j, dtype=np.int64)], axis=1
            )
            corres = np.concatenate([corres_ij, corres_ji], axis=0)

        # tuple constraint (matcher.cc:223-283)
        if use_tuple_test and tuple_scale != 0 and len(corres):
            rng = np.random.default_rng(seed)
            ncorr = len(corres)
            trials = ncorr * 100
            ci = corres[:, 0]
            cj = corres[:, 1]
            picks = rng.integers(0, ncorr, size=(trials, 3))
            pi = clouds[fi][ci[picks]]  # (T, 3, 3)
            pj = clouds[fj][cj[picks]]

            def side_lengths(p):
                return np.stack(
                    [
                        np.linalg.norm(p[:, 0] - p[:, 1], axis=1),
                        np.linalg.norm(p[:, 1] - p[:, 2], axis=1),
                        np.linalg.norm(p[:, 2] - p[:, 0], axis=1),
                    ],
                    axis=1,
                )

            li = side_lengths(pi)
            lj = side_lengths(pj)
            ok = ((li * tuple_scale < lj) & (lj < li / tuple_scale)).all(axis=1)
            kept = picks[ok].reshape(-1)
            corres = np.stack([ci[kept], cj[kept]], axis=1)

        if swapped:
            corres = corres[:, ::-1]
        # sort + dedup (matcher.cc:299-300): lexicographic unique rows match
        # sorted(set(tuples)) exactly
        corres = np.unique(corres.astype(np.int64), axis=0)
        return [tuple(row) for row in corres.tolist()]
