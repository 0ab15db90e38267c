"""Batched registration pipeline.

Counterpart of ``teaserpp_tpu/solvers/pipeline.py``. ``register_pair`` takes
one of two branches, as there:

* known scale with a clique mode (pipeline.py:358-365 there): TRIM
  adjacency bits (CUDA kernel) -> batch k-core peel -> inlier selection;
* otherwise (unknown scale, or NONE): TIM norms -> TLS scale or the TRIM
  pair selector -> pair-mask adjacency -> inlier selection (or every point).
  The first three steps run a chunk of problems at a time
  (:data:`SCALE_CHUNK_EVENTS`), so their memory does not grow with the
  batch; the selection runs once over the whole batch's words.

Both then run chain TIMs -> GNC-TLS / FGR / Quatro rotation -> TLS
translation. Every function takes a batch dimension where the JAX package
used ``vmap``. Inlier selection in a batch takes every mode, as JAX's
``device_clique_from_adjacency``: the top k-core (KCORE_HEU at threshold 0,
or above it where the k-core shortcut holds) or the batched greedy clique
(``clique/heuristic.py``), which PMC_HEU and PMC_EXACT both run. So the
batched path is not exact in either package; the facade
(``solvers/registration.py``) runs the exact search one problem at a time.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from teaserpp_tpu_torch.clique.graph import adjacency_from_pair_mask
from teaserpp_tpu_torch.clique.heuristic import heuristic_max_clique_from_bits
from teaserpp_tpu_torch.clique.kcore import core_numbers_from_bits, pack_bits_u32_rows
from teaserpp_tpu_torch.device import DeviceLike, resolve_device
from teaserpp_tpu_torch.ops.procrustes import rotate, svd_rot
from teaserpp_tpu_torch.ops.tims import (
    _pair_index,
    chain_tims,
    compute_tim_norms,
    tim_pair_valid,
    trim_adjacency_bits,
)
from teaserpp_tpu_torch.params import (
    InlierSelectionMode,
    RobustRegistrationSolverParams,
    RotationEstimationAlgorithm,
)
from teaserpp_tpu_torch.solvers.rotation import (
    RotationResult,
    solve_rotation_fgr,
    solve_rotation_gnc_tls,
    solve_rotation_quatro,
)
from teaserpp_tpu_torch.solvers.scale import select_scale_inliers, solve_scale_tls
from teaserpp_tpu_torch.solvers.translation import solve_translation_tls
from teaserpp_tpu_torch.utils.timing import StageClock


# Events (2K a problem, K = N(N-1)/2 TIM pairs) that the unknown-scale
# branch of ``register_pair`` sweeps at once: its TIM norms, TLS scale and
# pair-mask graph run on chunks of ``max(1, SCALE_CHUNK_EVENTS // 2K)``
# problems. ``scalar_tls``'s plain sweep (the CPU's) keeps ~79 B an event
# alive at its peak (17.96 GB for 64 problems of N = 1,889), kernel S on the
# card far less, so a batch's peak stays bounded however large it is (9.4 GB
# on an H100 at B = 512: chunks of 75 problems at N = 1,889). A fixed
# count, not one sized by free memory: the chunking, and with it the
# timing, depends on the shapes alone.
SCALE_CHUNK_EVENTS = 1 << 28

# Chunks and events the unknown-scale branch swept, counted at each chunk
# (as :data:`ops.cuda_kernels.LAUNCHES` counts launches).
SCALE_SWEEP = {"chunks": 0, "events": 0}


def reset_scale_sweep() -> None:
    for k in SCALE_SWEEP:
        SCALE_SWEEP[k] = 0


class ScaleStageResult(NamedTuple):
    scale: torch.Tensor  # (B,) estimated scale
    pair_mask: torch.Tensor  # (B, K) bool scale-stage TIM inlier mask


class PipelineSolution(NamedTuple):
    """Batched solution + introspection masks (leading dim B on every field)."""

    valid: torch.Tensor  # (B,) bool — False when the clique degenerated (size <= 1)
    scale: torch.Tensor  # (B,)
    rotation: torch.Tensor  # (B, 3, 3)
    translation: torch.Tensor  # (B, 3)
    scale_pair_mask: torch.Tensor  # (B, K) bool, or (B, 0) on the known-scale bits branch
    clique_mask: torch.Tensor  # (B, N) bool max-clique membership
    rotation_inlier_mask: torch.Tensor  # (B, N) bool per chain-TIM root index
    translation_inlier_mask: torch.Tensor  # (B, N) bool over original measurements
    rotation_cost: torch.Tensor  # (B,) GNC cost at termination
    rotation_iterations: torch.Tensor  # (B,) int32


def _solve_rotation(
    src_tims: torch.Tensor,
    dst_tims: torch.Tensor,
    noise_bound,
    params: RobustRegistrationSolverParams,
    valid: Optional[torch.Tensor] = None,
) -> RotationResult:
    """The rotation solver that ``params`` names, on (B, 3, M) TIMs."""
    solver = {
        RotationEstimationAlgorithm.GNC_TLS: solve_rotation_gnc_tls,
        RotationEstimationAlgorithm.FGR: solve_rotation_fgr,
        RotationEstimationAlgorithm.QUATRO: solve_rotation_quatro,
    }[params.rotation_estimation_algorithm]
    return solver(
        src_tims, dst_tims, noise_bound,
        gnc_factor=params.rotation_gnc_factor,
        max_iterations=params.rotation_max_iterations,
        cost_threshold=params.rotation_cost_threshold,
        valid=valid,
    )


def scale_stage(
    src: torch.Tensor,
    dst: torch.Tensor,
    params: RobustRegistrationSolverParams,
    valid: Optional[torch.Tensor] = None,
    use_matmul_norms: bool = False,
) -> ScaleStageResult:
    """TIM norms + TLS scale estimate or known-scale TRIM pair selection.

    Reference flow: computeTIMs (registration.cc:599-600) + solveForScale
    (registration.cc:603). Only the (B, K) TIM norms are built, never the
    TIM vectors; ``use_matmul_norms`` takes them in Gram form
    (:func:`compute_tim_norms`).
    """
    src_norms = compute_tim_norms(src, use_matmul=use_matmul_norms)
    dst_norms = compute_tim_norms(dst, use_matmul=use_matmul_norms)
    pv = tim_pair_valid(valid, src.shape[-1])
    solve = solve_scale_tls if params.estimate_scaling else select_scale_inliers
    res = solve(src_norms, dst_norms, params.noise_bound, params.cbar2, valid=pv)
    return ScaleStageResult(scale=res.scale, pair_mask=res.inliers)


def _select_inliers(
    adj_bits: torch.Tensor,
    n: int,
    params: RobustRegistrationSolverParams,
    valid: Optional[torch.Tensor],
    clock: "StageClock",
    peel_stage: str,
) -> torch.Tensor:
    """Inlier selection of JAX ``device_clique_from_adjacency`` on row-packed
    words (B, W, N), batched -> (B, N) bool.

    The peel's core numbers give the top k-core. KCORE_HEU at threshold 0
    takes it ("always take the top k-core", reference registration.h:480-482).
    KCORE_HEU above 0 takes it where ``threshold != 1`` and ``max_core >
    threshold * n_valid`` (reference graph.cc:66-81) and runs the greedy
    clique elsewhere, its lanes empty where the shortcut holds; PMC_HEU and
    PMC_EXACT run the greedy clique, as JAX's ``else`` branch does. The
    greedy reads the words themselves (one ``greedy_clique`` launch for the
    batch, no host sync); it runs only when some problem needs it, and the
    clock marks ``greedy`` after it, ``peel_stage`` after the peel.
    """
    mode = params.resolved_inlier_selection_mode()
    threshold = params.kcore_heuristic_threshold
    core = core_numbers_from_bits(adj_bits, n, valid)
    max_core = core.amax(dim=-1)
    mask = core >= max_core[:, None]
    use_kcore = None
    run_greedy = True
    if mode == InlierSelectionMode.KCORE_HEU:
        if threshold <= 0:
            run_greedy = False
        else:
            if valid is None:
                nv = torch.full_like(max_core, n, dtype=torch.float32)
            else:
                nv = valid.sum(dim=-1).to(torch.float32)
            use_kcore = (max_core.to(torch.float32) > threshold * nv) & (threshold != 1)
            run_greedy = not bool(use_kcore.all())  # one host sync
    clock.mark(peel_stage)
    if run_greedy:
        heu = heuristic_max_clique_from_bits(
            adj_bits, n, core, valid=valid, num_seeds=params.max_clique_heuristic_seeds,
            skip=use_kcore,
        )
        mask = heu.mask if use_kcore is None else torch.where(use_kcore[:, None], mask,
                                                              heu.mask)
        clock.mark("greedy")
    if valid is not None:
        mask = mask & valid
    return mask


def device_clique_from_bits(
    adj_bits: torch.Tensor,
    n: int,
    params: RobustRegistrationSolverParams,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inlier selection on each problem's row-packed (B, W, N) adjacency
    words -> (B, N) bool mask: the top k-core or the greedy clique, as
    :func:`device_clique_from_adjacency` says."""
    return _select_inliers(adj_bits, n, params, valid, StageClock(None, adj_bits.device),
                           "peel")


def device_clique_from_adjacency(
    adj: torch.Tensor,
    params: RobustRegistrationSolverParams,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inlier selection from a dense (B, N, N) bool adjacency -> (B, N) mask.

    Every mode, as the JAX function of this name: KCORE_HEU at threshold 0
    takes the top k-core; above 0 the top k-core where it holds more than
    ``threshold`` of the valid vertices, else the greedy clique; PMC_HEU and
    PMC_EXACT the greedy clique over ``max_clique_heuristic_seeds`` seeds
    (not an exact search, in either package). ``valid`` is ANDed in last.
    """
    return _select_inliers(pack_bits_u32_rows(adj), adj.shape[-1], params, valid,
                           StageClock(None, adj.device), "clique")


def _words_from_pairs(pair_mask: torch.Tensor, n: int,
                      valid: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, K) pair mask -> the (B, W, N) row-packed words of its symmetric
    adjacency, padded vertices (``valid`` False) masked out of rows and
    columns."""
    adj = adjacency_from_pair_mask(pair_mask, n)
    if valid is not None:
        adj = adj & valid[:, None, :] & valid[:, :, None]
    return pack_bits_u32_rows(adj)


def device_clique_stage(
    pair_mask: torch.Tensor,
    n: int,
    params: RobustRegistrationSolverParams,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inlier selection from the scale stage's (B, K) pair mask -> (B, N) mask.

    NONE keeps every valid point; any other mode scatters the pairs into an
    adjacency and selects on it as :func:`device_clique_from_adjacency`
    (reference registration.cc:609-654).
    """
    if params.resolved_inlier_selection_mode() == InlierSelectionMode.NONE:
        mask = torch.ones((pair_mask.shape[0], n), dtype=torch.bool, device=pair_mask.device)
        return mask if valid is None else mask & valid
    return _select_inliers(_words_from_pairs(pair_mask, n, valid), n, params, valid,
                           StageClock(None, pair_mask.device), "clique")


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
    """Chain-TIM rotation + component-wise TLS translation, batched.

    Reference flow: chain TIM rebuild (registration.cc:657-680), de-scaling
    and rotation noise-bound update (registration.cc:697-704), rotation solve
    (registration.cc:708), translation solve on the clique points
    (registration.cc:717-727). ``scale`` is (B,).
    """
    clock = StageClock(stage_ms, src.device)
    src_ctims, tim_valid = chain_tims(src, clique_mask)
    dst_ctims, _ = chain_tims(dst, clique_mask)
    inv_s = 1.0 / scale
    dst_ctims = dst_ctims * inv_s[:, None, None]
    nb_rot = params.noise_bound * 2.0 * inv_s
    clock.mark("chain_tims")

    rot = _solve_rotation(src_ctims, dst_ctims, nb_rot, params, tim_valid)
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


def rotation_translation_complete(
    src_sel: torch.Tensor,
    dst_sel: torch.Tensor,
    point_valid: torch.Tensor,
    scale: torch.Tensor,
    params: RobustRegistrationSolverParams,
) -> PipelineSolution:
    """COMPLETE-graph rotation + translation on gathered clique points.

    Reference registration.cc:681-694: all M(M-1)/2 TIMs of the (B, 3, M)
    clique points, padded to M with ``point_valid`` (B, M). The rotation
    inlier mask is over the pair order, the translation mask over the points.
    """
    m = src_sel.shape[-1]
    i, j = _pair_index(m, src_sel.device)
    src_tims = src_sel[..., :, j] - src_sel[..., :, i]
    dst_tims = dst_sel[..., :, j] - dst_sel[..., :, i]
    pv = tim_pair_valid(point_valid, m)
    inv_s = 1.0 / scale
    dst_tims = dst_tims * inv_s[:, None, None]
    nb_rot = params.noise_bound * 2.0 * inv_s
    rot = _solve_rotation(src_tims, dst_tims, nb_rot, params, pv)

    aligned_src = scale[:, None, None] * rotate(rot.rotation, src_sel)
    trans = solve_translation_tls(
        aligned_src, dst_sel, params.noise_bound, params.cbar2, valid=point_valid
    )
    rotation, translation = rot.rotation, trans.translation
    if params.final_polish:
        rotation, translation = _polish_rt(
            src_sel, dst_sel, scale, rotation, translation, trans.inliers & point_valid
        )
    return PipelineSolution(
        valid=point_valid.sum(dim=-1) > 1,
        scale=scale,
        rotation=rotation,
        translation=translation,
        scale_pair_mask=torch.zeros((src_sel.shape[0], 0), dtype=torch.bool,
                                    device=src_sel.device),
        clique_mask=point_valid,
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
    use_matmul_norms: bool = False,
) -> PipelineSolution:
    """Solve a batch of problems (B, 3, N): scale -> clique -> rotation ->
    translation.

    The batch dimension stands where the JAX package ``vmap``s its per-problem
    ``register_pair``; one problem is a batch of one. The inputs (numpy arrays
    or tensors) go to ``device`` — CUDA unless ``device`` names another — as
    float32; ``valid`` (B, N) masks padded correspondences. Every
    inlier-selection mode runs (see :func:`device_clique_from_adjacency`).
    Known scale with a clique mode builds the TRIM adjacency bits directly
    (the returned ``scale_pair_mask`` is then (B, 0)); unknown scale, or
    NONE, runs the scale stage over the (B, K) TIM norms, in Gram form with
    ``use_matmul_norms`` (which the bits branch ignores, as in JAX), and
    returns its pair mask; its norms, TLS scale and graph run on chunks of
    problems (:func:`_chunked_scale_stage`). Pass a dict as ``stage_ms`` to
    have the host wall time of each stage (``bits``, ``peel``; or ``scale``,
    ``scale_graph`` (the pair-mask scatter and packing, without NONE), each
    summed over the chunks, then ``clique``, the peel; then ``greedy`` where
    the greedy clique ran; then ``chain_tims``, ``rotation``,
    ``translation``) added to it; this synchronises the device after every
    stage.
    """
    mode = params.resolved_inlier_selection_mode()
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

    clock = StageClock(stage_ms, dev)
    if not params.estimate_scaling and mode != InlierSelectionMode.NONE:
        bits = trim_adjacency_bits(src, dst, params.noise_bound, params.cbar2, valid)
        clock.mark("bits")
        clique_mask = _select_inliers(bits, n, params, valid, clock, "peel")
        del bits
        scale = torch.ones((bsz,), dtype=src.dtype, device=dev)
        return rotation_translation_stage(src, dst, scale, clique_mask, params, stage_ms)
    graph = mode != InlierSelectionMode.NONE
    scale, pair_mask, words = _chunked_scale_stage(src, dst, params, valid, graph,
                                                   use_matmul_norms, clock)
    if graph:
        clique_mask = _select_inliers(words, n, params, valid, clock, "clique")
        del words
    else:
        clique_mask = valid.clone()
        clock.mark("clique")
    sol = rotation_translation_stage(src, dst, scale, clique_mask, params, stage_ms)
    return sol._replace(scale_pair_mask=pair_mask)


def _chunked_scale_stage(src, dst, params, valid, graph: bool, use_matmul_norms: bool,
                         clock: StageClock):
    """:func:`scale_stage` and, with ``graph``, the packed pair-mask words,
    over a (B, 3, N) batch in chunks of problems -> ``(scale (B,), pair_mask
    (B, K), words (B, W, N) or None)``.

    A chunk holds ``max(1, SCALE_CHUNK_EVENTS // 2K)`` problems. The problems
    are independent and every step works on each problem's own row in an
    order set by its length alone (a stable sort, fixed-order prefix sums, a
    per-row argmin), so the outputs are bit for bit those of one chunk. The
    clock adds each chunk's norms and TLS to ``scale`` and its scatter and
    packing to ``scale_graph``.
    """
    bsz, _, n = src.shape
    k = n * (n - 1) // 2
    per = max(1, SCALE_CHUNK_EVENTS // max(1, 2 * k))
    dev = src.device
    scale = torch.empty((bsz,), dtype=src.dtype, device=dev)
    pair_mask = torch.empty((bsz, k), dtype=torch.bool, device=dev)
    words = (torch.empty((bsz, (n + 31) // 32, n), dtype=torch.int32, device=dev)
             if graph else None)
    for lo in range(0, bsz, per):
        hi = min(bsz, lo + per)
        sc = scale_stage(src[lo:hi], dst[lo:hi], params, valid=valid[lo:hi],
                         use_matmul_norms=use_matmul_norms)
        scale[lo:hi] = sc.scale
        pair_mask[lo:hi] = sc.pair_mask
        SCALE_SWEEP["chunks"] += 1
        SCALE_SWEEP["events"] += 2 * k * (hi - lo)
        clock.mark("scale")
        if graph:
            words[lo:hi] = _words_from_pairs(sc.pair_mask, n, valid[lo:hi])
            clock.mark("scale_graph")
        del sc
    return scale, pair_mask, words


# The JAX package's name for its ``vmap`` of ``register_pair``; the port's
# ``register_pair`` is batched already.
register_batch = register_pair
