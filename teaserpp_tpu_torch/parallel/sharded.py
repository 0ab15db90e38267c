"""Single huge-N known-scale registration, on one device or row-sharded
over a mesh of ranks.

Counterpart of ``teaserpp_tpu/parallel/sharded.py``: for a problem of 100K
correspondences the N x N pair grid exists only as row-packed bit words
(N^2/8 bytes), built by the ``trim_bits`` kernel at B=1.

Pipeline:
  1. TRIM adjacency bits (CUDA kernel)                       [O(N^2) compute]
  2. binary-search top k-core on the bits                    [popcount rounds]
  3. degree score -> top ``subgraph_size`` vertices -> dense sub-adjacency
  4. greedy clique on the subgraph
  5. chain-TIM GNC rotation + TLS translation over the clique mask

One problem is ``(3, N)``; inside, it runs as a batch of one through the
batched stage functions, and every field of the returned
:class:`LargeSolveResult` (and of its ``solution``) is unbatched, the JAX
package's layout.

With a ``mesh`` (``parallel/multihost.py``) the O(N^2) structure is sharded
over the ranks of ``pairs_axis``, as JAX shards it ``P(pairs, None)``: rank
``r`` of ``P`` holds the word rows ``[r ceil(W/P), (r+1) ceil(W/P))`` of the
bit words (the ``trim_bits`` row slab) or the matching 32-row band of the
dense adjacency, packed to the same words. Each round of the k-core loops
sums the slabs' partial degrees with one all-reduce over the axis, so the
core numbers, masks and ``max_core`` equal the unsharded ones exactly. The
points and everything after the scores (the stable top ``m``, the
subgraph's greedy clique, rotation and translation) are replicated: every
rank runs them on equal inputs and returns the same result. The host exact
search of :func:`solve_large_exact` runs on the axis' first rank and its
clique is broadcast. Other mesh axes replicate. ``mesh=None`` is the
single-device path.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from teaserpp_tpu_torch.clique import exact as _exact
from teaserpp_tpu_torch.clique.heuristic import heuristic_max_clique
from teaserpp_tpu_torch.clique.kcore import (
    active_degrees,
    core_numbers_from_bits,
    kcore_mask_from_bits,
    max_core_from_bits,
    pack_bits_u32_rows,
)
from teaserpp_tpu_torch.device import DeviceLike, resolve_device
from teaserpp_tpu_torch.ops.tims import trim_adjacency_bits, trim_adjacency_dense
from teaserpp_tpu_torch.parallel.multihost import Mesh, require_mesh, shard_range
from teaserpp_tpu_torch.params import RobustRegistrationSolverParams
from teaserpp_tpu_torch.solvers.pipeline import (
    PipelineSolution,
    _StageClock,
    _to_device,
    rotation_translation_stage,
)


class LargeSolveResult(NamedTuple):
    solution: PipelineSolution  # unbatched fields: rotation (3, 3), clique_mask (N,), ...
    max_core: torch.Tensor  # scalar int32
    clique_size: torch.Tensor  # scalar


class PairsShard(NamedTuple):
    """This rank's share of a problem's word rows on ``mesh[axis]``."""

    mesh: Mesh
    axis: str
    w0: int  # word rows [w0, w1) of the ceil(N/32)
    w1: int

    @classmethod
    def of(cls, mesh: Optional[Mesh], axis: str, n: int) -> Optional["PairsShard"]:
        if require_mesh(mesh) is None:
            return None
        if axis not in mesh.shape:
            raise ValueError(f"pairs_axis {axis!r} is not an axis of {mesh}")
        w0, w1 = shard_range((n + 31) // 32, mesh.shape[axis], mesh.coords[axis])
        return cls(mesh, axis, w0, w1)


def _degrees(shard: Optional[PairsShard], words: torch.Tensor):
    """``active -> (1, N)`` degrees into ``active``: of the whole ``words``,
    or, with a ``shard``, of this rank's slab summed over the shard's axis
    (the whole graph's degrees on every rank)."""
    if shard is None:
        return lambda active: active_degrees(words, active)
    return lambda active: shard.mesh.all_reduce(
        active_degrees(words, active, shard.w0), shard.axis)


def _points(src, dst, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """One problem's (3, N) inputs as (1, 3, N) float32 tensors on ``device``."""
    src = _to_device(src, device, torch.float32)
    dst = _to_device(dst, device, torch.float32)
    if src.shape != dst.shape or src.dim() != 2 or src.shape[0] != 3:
        raise ValueError(
            f"src and dst must both be (3, N), got {tuple(src.shape)} and "
            f"{tuple(dst.shape)}"
        )
    return src[None], dst[None]


def _adjacency_bits_fast(src, dst, params, shard: Optional[PairsShard] = None) -> torch.Tensor:
    """Row-packed TRIM words of one problem, ``(1, ceil(N/32), N)`` int32,
    or this rank's slab of them, ``(1, w1 - w0, N)``.

    The port builds them one way: the ``trim_bits`` kernel on CUDA (its row
    slab on a mesh), its plain version for CPU tensors.
    """
    rows = None if shard is None else (shard.w0, shard.w1)
    return trim_adjacency_bits(src, dst, params.noise_bound, params.cbar2, rows=rows)


def candidate_scores(
    src: torch.Tensor,
    dst: torch.Tensor,
    params: RobustRegistrationSolverParams,
    blocked_threshold: int = 16384,
    clock: Optional[_StageClock] = None,
    shard: Optional[PairsShard] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vertex ranking for the subgraph selection and the max core number.

    ``src``/``dst`` are ``(1, 3, N)``. Above ``blocked_threshold`` the
    adjacency exists only as bit words, only the top core is found (binary
    search), and the score is the degree, lifted by N inside the top core;
    at or below it the dense adjacency is peeled level by level and the score
    is the core number. With a ``shard`` this rank builds only its word rows
    (or its row band of the dense adjacency, packed) and every degree is
    summed over the shard's axis. Returns (score (N,) int32, max_core scalar
    int32), equal on every rank.
    """
    clock = clock or _StageClock(None, src.device)
    n = src.shape[-1]
    if n > blocked_threshold:
        adj_bits = _adjacency_bits_fast(src, dst, params, shard)
        degrees = _degrees(shard, adj_bits)
        clock.mark("bits")
        top_mask, max_core = max_core_from_bits(adj_bits, n, degrees=degrees)
        clock.mark("max_core")
        deg0 = degrees(torch.ones_like(top_mask))
        score = torch.where(top_mask, deg0 + n, deg0)[0]
        max_core = max_core[0]
    else:
        # the dense adjacency (this rank's band of rows [32 w0, 32 w1)),
        # packed to the words that kcore.core_numbers peels
        rows = (0, n) if shard is None else (32 * shard.w0, min(32 * shard.w1, n))
        words = pack_bits_u32_rows(trim_adjacency_dense(
            src, dst, params.noise_bound, params.cbar2, rows=rows))
        clock.mark("bits")
        score = core_numbers_from_bits(words, n, degrees=_degrees(shard, words))[0]
        max_core = score.amax()
        clock.mark("max_core")
    return score, max_core


def top_candidates(score: torch.Tensor, m: int) -> torch.Tensor:
    """Indices of the ``m`` highest scores, ties lowest index first.

    The order ``jax.lax.top_k`` gives. The scores tie heavily, both the
    selected set (a tie across position ``m``) and the order (the greedy
    search breaks its own ties by subgraph position) depend on it, and
    ``torch.topk`` promises no tie order: hence a stable descending sort.
    """
    return torch.sort(score, descending=True, stable=True).indices[:m]


def _squeeze_solution(sol: PipelineSolution) -> PipelineSolution:
    return PipelineSolution(*[v[0] for v in sol])


def _rt_stage(src, dst, clique_mask, params, stage_ms=None) -> PipelineSolution:
    scale = torch.ones((1,), dtype=src.dtype, device=src.device)
    sol = rotation_translation_stage(src, dst, scale, clique_mask[None], params, stage_ms)
    return _squeeze_solution(sol)


def _large_registration_impl(
    src: torch.Tensor,
    dst: torch.Tensor,
    params: RobustRegistrationSolverParams,
    subgraph_size: int,
    blocked_threshold: int = 16384,
    stage_ms: Optional[Dict[str, float]] = None,
    shard: Optional[PairsShard] = None,
) -> LargeSolveResult:
    n = src.shape[-1]
    clock = _StageClock(stage_ms, src.device)
    score, max_core = candidate_scores(src, dst, params, blocked_threshold, clock, shard)

    # Reduce to the densest subgraph: the top `subgraph_size` vertices by
    # score contain the maximum clique when subgraph_size > max_core.
    m = min(subgraph_size, n)
    top_idx = top_candidates(score, m)
    # The subgraph's adjacency is re-derived from the gathered points: the
    # same TRIM formula on the same coordinates, and no gather from the words.
    sub_adj = trim_adjacency_dense(
        src[..., top_idx], dst[..., top_idx], params.noise_bound, params.cbar2
    )[0]
    clock.mark("score_topk")
    heu = heuristic_max_clique(sub_adj, num_seeds=params.max_clique_heuristic_seeds)

    clique_mask = torch.zeros((n,), dtype=torch.bool, device=src.device)
    clique_mask.index_put_((top_idx,), heu.mask)  # distinct indices: a plain scatter
    clock.mark("greedy")
    sol = _rt_stage(src, dst, clique_mask, params, stage_ms)
    return LargeSolveResult(
        solution=sol, max_core=max_core, clique_size=clique_mask.sum()
    )


def _kcore_prune(src, dst, params, k: int, shard: Optional[PairsShard] = None) -> torch.Tensor:
    """(N,) bool ``k``-core survivor mask of the TRIM graph, on the bit words
    (this rank's slab of them, with a ``shard``)."""
    n = src.shape[-1]
    adj_bits = _adjacency_bits_fast(src, dst, params, shard)
    return kcore_mask_from_bits(adj_bits, n, k, degrees=_degrees(shard, adj_bits))[0]


def _sub_adjacency_bits(src_sel, dst_sel, params) -> torch.Tensor:
    """(ceil(m/32), m) int32 TRIM words of the gathered ``(1, 3, m)`` points."""
    return trim_adjacency_bits(src_sel, dst_sel, params.noise_bound, params.cbar2)[0]


def _unpack_bits_rows(bits, n: int) -> np.ndarray:
    """Host unpack of the (W, N) int32 row-packed layout -> (N, N) bool."""
    b = np.ascontiguousarray(
        bits.detach().cpu().numpy() if isinstance(bits, torch.Tensor) else bits
    )  # (W, N)
    bytes_ = b.view(np.uint8).reshape(b.shape[0], b.shape[1], 4)
    # little-endian words: byte order within a word is LSB-first
    rows = np.unpackbits(bytes_, axis=-1, bitorder="little")  # (W, N, 32)
    rows = np.moveaxis(rows, -1, 1).reshape(b.shape[0] * 32, b.shape[1])
    return rows[:n].astype(bool)


def _exact_search(src_sel, dst_sel, params, time_limit: float,
                  num_threads: int) -> torch.Tensor:
    """Host exact maximum clique of the TRIM graph of the gathered ``(1, 3,
    m)`` points: dense bitset search below the reference's ``adj_limit``,
    sparse above. Returns the clique's int64 indices into the m points."""
    m = src_sel.shape[-1]
    sub_adj = _unpack_bits_rows(
        _sub_adjacency_bits(src_sel.contiguous(), dst_sel.contiguous(), params), m)
    if m < 20000:  # reference PMC adj_limit (graph.cc:43)
        clique_local, _ = _exact.exact_max_clique(
            sub_adj, time_limit=time_limit, num_threads=num_threads
        )
    else:
        indptr, indices = _exact.adjacency_to_csr(sub_adj)
        clique_local, _ = _exact.exact_max_clique_sparse(
            indptr, indices, m, time_limit=time_limit, num_threads=num_threads
        )
    return torch.as_tensor(np.asarray(clique_local), dtype=torch.int64)


def solve_large_exact(
    src,
    dst,
    params: RobustRegistrationSolverParams,
    mesh=None,
    pairs_axis: str = "pairs",
    time_limit: float = 3600.0,
    num_threads: int = 0,
    device: DeviceLike = None,
) -> LargeSolveResult:
    """Known-scale registration with a provably exact maximum clique at huge N.

      1. heuristic device solve -> genuine clique of size ``lb`` (lower bound);
      2. device (lb-1)-core fixpoint on the bit words: every vertex of a
         maximum clique has core >= clique_size - 1 >= lb - 1, so the
         survivors contain every maximum clique;
      3. host exact branch-and-bound on the (small) survivor subgraph, dense
         bitset or sparse CSR depending on survivor count;
      4. device rotation/translation stages over the exact clique mask.

    ``src``/``dst`` are (3, N); ``device`` is CUDA unless named. On a search
    cut by ``time_limit`` the best clique found so far is used. With a
    ``mesh`` steps 1-2 run row-sharded over ``pairs_axis`` (the module
    docstring), step 3 on the axis' first rank, whose clique every rank of
    the axis receives, and step 4 on every rank. Returns a
    :class:`LargeSolveResult` with unbatched fields.
    """
    dev = resolve_device(device)
    src, dst = _points(src, dst, dev)
    n = src.shape[-1]
    shard = PairsShard.of(mesh, pairs_axis, n)

    # 1. heuristic lower bound (the greedy clique is a genuine clique)
    heu_res = _large_registration_impl(src, dst, params, 2048, shard=shard)
    lb = int(heu_res.clique_size)

    # 2. provably safe pruning to the (lb-1)-core
    survivors = _kcore_prune(src, dst, params, lb - 1, shard)
    idx = torch.nonzero(survivors)[:, 0]
    m = int(idx.shape[0])
    if m == 0:
        return heu_res

    # 3. exact search on the survivor subgraph (adjacency re-derived from the
    # gathered points on the device, fetched as packed bits: m^2/8 bytes)
    in_clique = torch.zeros((m,), dtype=torch.bool, device=dev)
    if shard is None or shard.mesh.coords[shard.axis] == 0:
        in_clique[_exact_search(src[..., idx], dst[..., idx], params, time_limit,
                                num_threads).to(dev)] = True
    if shard is not None:
        # a search cut by its clock may end elsewhere on another rank: one
        # rank searches and the others take its clique
        in_clique = shard.mesh.broadcast(in_clique, shard.axis)
    clique_mask = torch.zeros((n,), dtype=torch.bool, device=dev)
    clique_mask[idx[in_clique]] = True

    # 4. rotation/translation over the exact clique
    sol = _rt_stage(src, dst, clique_mask, params)
    return LargeSolveResult(
        solution=sol,
        max_core=heu_res.max_core,
        clique_size=clique_mask.sum().to(torch.int32),
    )


def solve_large_sharded(
    src,
    dst,
    params: RobustRegistrationSolverParams,
    mesh=None,
    pairs_axis: str = "pairs",
    subgraph_size: int = 2048,
    blocked_threshold: int = 16384,
    device: DeviceLike = None,
    stage_ms: Optional[Dict[str, float]] = None,
) -> LargeSolveResult:
    """Known-scale registration of one huge problem on ``device`` (CUDA unless
    named), with the O(N^2) structure row-sharded over ``mesh``'s
    ``pairs_axis`` when a mesh is given (a port ``Mesh``, see the module
    docstring; every rank of the axis calls this with the same inputs and
    gets the same result).

    ``src``/``dst`` are (3, N) with N typically 10K-100K.

    ``subgraph_size`` caps the clique candidate set: when the true inlier set
    is larger, the clique is truncated to the top ``subgraph_size`` vertices
    (GNC only needs a clean subset); raise it if the full inlier list itself
    is wanted. Pass a dict as ``stage_ms`` to have the host wall time of each
    stage (``bits``, ``max_core``, ``score_topk``, ``greedy``, ``chain_tims``,
    ``rotation``, ``translation``) added to it; this synchronises the device
    after every stage. Returns a :class:`LargeSolveResult` with unbatched
    fields.
    """
    dev = resolve_device(device)
    src, dst = _points(src, dst, dev)
    shard = PairsShard.of(mesh, pairs_axis, src.shape[-1])
    return _large_registration_impl(
        src, dst, params, subgraph_size, blocked_threshold, stage_ms, shard
    )
