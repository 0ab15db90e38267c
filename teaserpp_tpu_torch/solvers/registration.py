"""Host-facing robust registration solver with the reference's API surface.

Counterpart of ``teaserpp_tpu/solvers/registration.py``.
``RobustRegistrationSolver`` mirrors the reference orchestrator
(registration.h:361-957 / registration.cc:473-762) and its Python binding
(teaserpp_python.cc:82-177): ``solve``, ``getSolution`` and the getter
family (inlier masks and maps, TIMs, max clique, inlier graph). It drives
the batched stage functions of ``solvers/pipeline.py`` with a batch of one
on its device (CUDA unless ``device="cpu"`` is given) and the clique
subsystem of ``clique/graph.py``; inputs and results are numpy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from teaserpp_tpu_torch.clique.graph import Graph, MaxCliqueSolver, adjacency_from_pair_mask
from teaserpp_tpu_torch.device import DeviceLike, resolve_device
from teaserpp_tpu_torch.ops.tims import compute_tims, upper_tri_indices
from teaserpp_tpu_torch.params import (
    CliqueSolverMode,
    InlierGraphFormulation,
    InlierSelectionMode,
    MaxCliqueSolverParams,
    RobustRegistrationSolverParams,
)
from teaserpp_tpu_torch.solvers import pipeline as _pipe
from teaserpp_tpu_torch.solvers.translation import solve_translation_tls
from teaserpp_tpu_torch.utils.diagnostics import debug_error_msg
from teaserpp_tpu_torch.utils.geometry import PointCloud
from teaserpp_tpu_torch.utils.timing import StageTimer


@dataclasses.dataclass
class RegistrationSolution:
    """Solution to a registration problem (reference registration.h:25-38)."""

    valid: bool = True
    scale: float = 1.0
    translation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3)
    )
    rotation: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3))

    def __repr__(self) -> str:
        return (
            f"RegistrationSolution(valid={self.valid}, scale={self.scale}, "
            f"translation={self.translation.tolist()}, "
            f"rotation={self.rotation.tolist()})"
        )


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


_CLIQUE_MODE = {
    InlierSelectionMode.PMC_EXACT: CliqueSolverMode.PMC_EXACT,
    InlierSelectionMode.PMC_HEU: CliqueSolverMode.PMC_HEU,
    InlierSelectionMode.KCORE_HEU: CliqueSolverMode.KCORE_HEU,
}


class RobustRegistrationSolver:
    """Decoupled scale/rotation/translation robust registration solver.

    Accepts either a :class:`RobustRegistrationSolverParams` or keyword
    arguments with the same names. ``device`` is where the stages run: CUDA
    unless named, and without CUDA the constructor raises. ``dtype`` is the
    stages' float type: ``torch.float32`` by default, as the JAX package
    computes on a TPU (the JAX facade takes float64 only when JAX runs with
    x64); pass ``torch.float64`` to compare with that. Getters return numpy
    arrays shaped as the reference's.
    """

    # Reference-style nested aliases (registration.h:382-412).
    from teaserpp_tpu_torch.params import (  # noqa: F401
        RotationEstimationAlgorithm as ROTATION_ESTIMATION_ALGORITHM,
        InlierSelectionMode as INLIER_SELECTION_MODE,
        InlierGraphFormulation as INLIER_GRAPH_FORMULATION,
    )

    def __init__(self, params: Optional[RobustRegistrationSolverParams] = None, *,
                 device: DeviceLike = None, dtype: torch.dtype = torch.float32, **kw):
        if params is None:
            params = RobustRegistrationSolverParams(**kw)
        elif kw:
            params = params.replace(**kw)
        self.device = resolve_device(device)
        self.dtype = dtype
        # Pluggable stage estimators (reference setScale/Rotation/
        # TranslationEstimator, registration.h:623-644); None = the built-in
        # stage. They survive reset(), as the reference's member solvers
        # survive solve().
        self._scale_estimator = None
        self._rotation_estimator = None
        self._translation_estimator = None
        self.reset(params)

    # ------------------------------------------------- pluggable estimators
    def setScaleEstimator(self, estimator) -> None:
        """Replace the scale stage (reference registration.h:623-629).

        ``estimator(src_tims (3, K), dst_tims (3, K)) -> (scale: float,
        pair_inliers: (K,) bool)`` over the upper-triangle TIM pair order of
        :meth:`getScaleInliersMap`. Pass ``None`` to restore the built-in.
        """
        self._scale_estimator = estimator

    def setRotationEstimator(self, estimator) -> None:
        """Replace the rotation stage (reference registration.h:631-638).

        ``estimator(src_tims (3, M), dst_tims (3, M)) -> (rotation (3, 3),
        inliers (M,) bool, cost: float)``; ``dst_tims`` arrive de-scaled by
        the scale estimate, as in the reference (registration.cc:697-704).
        """
        self._rotation_estimator = estimator

    def setTranslationEstimator(self, estimator) -> None:
        """Replace the translation stage (reference registration.h:640-644).

        ``estimator(src (3, M), dst (3, M)) -> (translation (3,),
        inliers (M,) bool)`` on the scale*R-aligned clique points.
        """
        self._translation_estimator = estimator

    # ------------------------------------------------------------------ reset
    def reset(self, params: RobustRegistrationSolverParams) -> None:
        """Reset params and clear all cached solve state (registration.h:830-908)."""
        self.params = params
        self._timer = StageTimer()
        self._solution = RegistrationSolution(valid=False)
        self._n = 0
        self._src = None
        self._dst = None
        self._scale_pair_mask = None  # (K,) bool np
        self._max_clique: List[int] = []
        self._inlier_graph: Optional[Graph] = None
        self._rotation_inliers_mask = np.zeros((0,), bool)
        self._translation_inliers_mask = np.zeros((0,), bool)
        self._rotation_cost = float("nan")
        self._src_tims = None
        self._dst_tims = None
        self._pruned_src_tims = None
        self._pruned_dst_tims = None
        self._tims_map_rotation = np.zeros((2, 0), np.int32)

    def getParams(self) -> RobustRegistrationSolverParams:
        return self.params

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(self.dtype)

    # ------------------------------------------------------------------ solve
    def solve(self, src, dst, correspondences: Optional[Sequence] = None):
        """Solve for scale, rotation, translation.

        Either ``solve(src_3xN, dst_3xN)`` on correspondence matrices
        (reference registration.cc:568) or
        ``solve(src_cloud, dst_cloud, correspondences)`` on point clouds plus
        an index-pair list (reference registration.cc:553).
        """
        if correspondences is not None:
            src = _gather_correspondences(src, correspondences, side=0)
            dst = _gather_correspondences(dst, correspondences, side=1)
        src = np.asarray(src, dtype=np.float64)
        dst = np.asarray(dst, dtype=np.float64)
        if src.ndim != 2 or src.shape[0] != 3 or src.shape != dst.shape:
            raise ValueError(
                f"src and dst must both be 3xN, got {src.shape} and {dst.shape}")

        n = src.shape[1]
        self.reset(self.params)
        self._n = n
        self._src = src
        self._dst = dst
        src_d = self._tensor(src)[None]
        dst_d = self._tensor(dst)[None]
        params = self.params
        mode = params.resolved_inlier_selection_mode()

        # ---- scale stage (TIM norms + TLS scale / TRIM selector)
        with self._timer.stage("scale", sync=self.device):
            if self._scale_estimator is not None:
                scale, pair_mask = self._scale_estimator(
                    self.getSrcTIMs(), self.getDstTIMs()
                )
                scale = float(scale)
                self._scale_pair_mask = np.asarray(pair_mask, bool)
                pair_mask_d = torch.from_numpy(self._scale_pair_mask).to(self.device)[None]
            else:
                sc = _pipe.scale_stage(src_d, dst_d, params)
                scale = float(sc.scale[0])
                pair_mask_d = sc.pair_mask
                self._scale_pair_mask = pair_mask_d[0].cpu().numpy()
        self._solution.scale = scale

        # ---- clique stage
        if mode != InlierSelectionMode.NONE:
            with self._timer.stage("clique", sync=self.device):
                adj = adjacency_from_pair_mask(pair_mask_d, n)[0].cpu().numpy()
                self._inlier_graph = Graph(adj)
                clique_params = MaxCliqueSolverParams(
                    solver_mode=_CLIQUE_MODE[mode],
                    time_limit=params.max_clique_time_limit,
                    kcore_heuristic_threshold=params.kcore_heuristic_threshold,
                    num_threads=params.max_clique_num_threads,
                    heuristic_num_seeds=params.max_clique_heuristic_seeds,
                )
                self._max_clique = sorted(
                    MaxCliqueSolver(clique_params, self.device).findMaxClique(
                        self._inlier_graph)
                )
            if len(self._max_clique) <= 1:
                # degenerate clique: abort (reference registration.cc:643-647)
                debug_error_msg(
                    "Clique size too small. Abort and return an invalid solution."
                )
                self._solution.valid = False
                return self._solution
        else:
            self._max_clique = list(range(n))

        clique = np.asarray(self._max_clique, np.int64)
        with self._timer.stage("rotation_translation", sync=self.device):
            if self._rotation_estimator is not None or self._translation_estimator is not None:
                self._solve_rt_custom(src, dst, scale, clique, params)
            else:
                self._solve_rt(src, dst, src_d, dst_d, scale, clique, params)
        return self._solution

    def _solve_rt(self, src, dst, src_d, dst_d, scale, clique, params) -> None:
        """The built-in rotation + translation stages on the device."""
        n = src.shape[1]
        scale_d = torch.full((1,), scale, dtype=self.dtype, device=self.device)
        if params.rotation_tim_graph == InlierGraphFormulation.CHAIN:
            clique_mask = np.zeros(n, bool)
            clique_mask[clique] = True
            sol = _pipe.rotation_translation_stage(
                src_d, dst_d, scale_d,
                torch.from_numpy(clique_mask).to(self.device)[None], params,
            )
            # compact the per-root masks to clique order, as the getters report
            self._rotation_inliers_mask = sol.rotation_inlier_mask[0].cpu().numpy()[clique]
            self._translation_inliers_mask = (
                sol.translation_inlier_mask[0].cpu().numpy()[clique])
            leaf = np.roll(clique, -1)
            self._tims_map_rotation = np.stack([leaf, clique]).astype(np.int32)
            self._pruned_src_tims = src[:, leaf] - src[:, clique]
            self._pruned_dst_tims = (dst[:, leaf] - dst[:, clique]) / scale
        else:
            # COMPLETE: the clique points padded to a multiple of 32, as the
            # JAX facade pads them, so the pair masks compact the same way
            m = len(clique)
            m_pad = max(_round_up(m, 32), 2)
            sel = np.zeros((3, m_pad))
            sel_dst = np.zeros((3, m_pad))
            sel[:, :m] = src[:, clique]
            sel_dst[:, :m] = dst[:, clique]
            point_valid = np.zeros(m_pad, bool)
            point_valid[:m] = True
            sol = _pipe.rotation_translation_complete(
                self._tensor(sel)[None], self._tensor(sel_dst)[None],
                torch.from_numpy(point_valid).to(self.device)[None], scale_d, params,
            )
            i_idx, j_idx = upper_tri_indices(m_pad)
            pair_valid = point_valid[i_idx] & point_valid[j_idx]
            self._rotation_inliers_mask = sol.rotation_inlier_mask[0].cpu().numpy()[pair_valid]
            self._translation_inliers_mask = sol.translation_inlier_mask[0].cpu().numpy()[:m]
            ci, cj = upper_tri_indices(m)
            self._tims_map_rotation = np.stack([clique[cj], clique[ci]]).astype(np.int32)
            self._pruned_src_tims = sel[:, cj] - sel[:, ci]
            self._pruned_dst_tims = (sel_dst[:, cj] - sel_dst[:, ci]) / scale

        self._rotation_cost = float(sol.rotation_cost[0])
        self._solution.valid = True
        self._solution.rotation = sol.rotation[0].cpu().numpy().astype(np.float64)
        self._solution.translation = sol.translation[0].cpu().numpy().astype(np.float64)

    def _solve_rt_custom(self, src, dst, scale, clique, params) -> None:
        """Rotation + translation with user-plugged estimators.

        Mirrors the built-in path (reference registration.cc:657-731): pruned
        TIMs per the TIM-graph formulation, dst TIMs de-scaled, the custom or
        the built-in solver per stage, masks stored for the getters.
        """
        if params.rotation_tim_graph == InlierGraphFormulation.CHAIN:
            leaf = np.roll(clique, -1)
            src_tims_p = src[:, leaf] - src[:, clique]
            dst_tims_p = (dst[:, leaf] - dst[:, clique]) / scale
            self._tims_map_rotation = np.stack([leaf, clique]).astype(np.int32)
        else:
            ci, cj = upper_tri_indices(len(clique))
            sel, sel_dst = src[:, clique], dst[:, clique]
            src_tims_p = sel[:, cj] - sel[:, ci]
            dst_tims_p = (sel_dst[:, cj] - sel_dst[:, ci]) / scale
            self._tims_map_rotation = np.stack([clique[cj], clique[ci]]).astype(np.int32)
        self._pruned_src_tims = src_tims_p
        self._pruned_dst_tims = dst_tims_p

        if self._rotation_estimator is not None:
            r, rot_inliers, cost = self._rotation_estimator(src_tims_p, dst_tims_p)
        else:
            nb_rot = params.noise_bound * 2.0 / scale
            rr = _pipe._solve_rotation(
                self._tensor(src_tims_p)[None], self._tensor(dst_tims_p)[None],
                nb_rot, params,
            )
            r, rot_inliers, cost = (
                rr.rotation[0].cpu().numpy(), rr.inliers[0].cpu().numpy(), rr.cost[0])
        r = np.asarray(r, np.float64)
        self._rotation_inliers_mask = np.asarray(rot_inliers, bool)
        self._rotation_cost = float(cost)

        aligned = scale * (r @ src[:, clique])
        if self._translation_estimator is not None:
            t, trans_inliers = self._translation_estimator(aligned, dst[:, clique])
        else:
            tr = solve_translation_tls(
                self._tensor(aligned)[None], self._tensor(dst[:, clique])[None],
                params.noise_bound, params.cbar2,
            )
            t, trans_inliers = tr.translation[0].cpu().numpy(), tr.inliers[0].cpu().numpy()
        self._translation_inliers_mask = np.asarray(trans_inliers, bool)
        self._solution.valid = True
        self._solution.rotation = r
        self._solution.translation = np.asarray(t, np.float64)

    def getStageTimings(self) -> dict:
        """Wall-clock seconds per stage of the last solve (``scale``,
        ``clique``, ``rotation_translation``), each ending in a device sync."""
        return self._timer.as_dict()

    # --------------------------------------------------------------- getters
    def getSolution(self) -> RegistrationSolution:
        return self._solution

    @property
    def solution(self) -> RegistrationSolution:
        return self._solution

    def getGNCRotationCostAtTermination(self) -> float:
        return self._rotation_cost

    gnc_rotation_cost_at_termination = property(getGNCRotationCostAtTermination)

    def getScaleInliersMask(self) -> np.ndarray:
        """(K,) bool mask over TIM pairs (reference registration.h:651-653)."""
        return self._scale_pair_mask

    scale_inliers_mask = property(getScaleInliersMask)

    def getScaleInliersMap(self) -> np.ndarray:
        """2xK pair index map (reference registration.h:661)."""
        i_idx, j_idx = upper_tri_indices(self._n)
        return np.stack([i_idx, j_idx]).astype(np.int32)

    scale_inliers_map = property(getScaleInliersMap)

    def getScaleInliers(self) -> List[Tuple[int, int]]:
        i_idx, j_idx = upper_tri_indices(self._n)
        sel = self._scale_pair_mask
        return list(zip(i_idx[sel].tolist(), j_idx[sel].tolist()))

    scale_inliers = property(getScaleInliers)

    def getRotationInliersMask(self) -> np.ndarray:
        return self._rotation_inliers_mask

    rotation_inliers_mask = property(getRotationInliersMask)

    def getRotationInliersMap(self) -> np.ndarray:
        return np.asarray(self._max_clique, np.int32)

    def getRotationInliers(self) -> List[int]:
        return np.nonzero(self._rotation_inliers_mask)[0].tolist()

    rotation_inliers = property(getRotationInliers)

    def getTranslationInliersMask(self) -> np.ndarray:
        return self._translation_inliers_mask

    translation_inliers_mask = property(getTranslationInliersMask)

    def getTranslationInliersMap(self) -> np.ndarray:
        return np.asarray(self._max_clique, np.int32)

    translation_inliers_map = property(getTranslationInliersMap)

    def getTranslationInliers(self) -> List[int]:
        return np.nonzero(self._translation_inliers_mask)[0].tolist()

    translation_inliers = property(getTranslationInliers)

    def getInputOrderedTranslationInliers(self) -> List[int]:
        """Translation inliers as original input indices (registration.h:757-768)."""
        return [self._max_clique[i] for i in self.getTranslationInliers()]

    def getInlierMaxClique(self) -> List[int]:
        return list(self._max_clique)

    inlier_max_clique = property(getInlierMaxClique)

    def getInlierGraph(self) -> List[List[int]]:
        if self._inlier_graph is None:
            return []
        return [self._inlier_graph.getEdges(v) for v in range(self._n)]

    inlier_graph = property(getInlierGraph)

    def _all_tims(self, points) -> np.ndarray:
        """(3, K) float64 TIMs of ``points``, built on the device when asked for."""
        return compute_tims(
            torch.from_numpy(points).to(self.device, torch.float64)).cpu().numpy()

    def getSrcTIMs(self) -> np.ndarray:
        if self._src_tims is None and self._src is not None:
            self._src_tims = self._all_tims(self._src)
        return self._src_tims

    src_tims = property(getSrcTIMs)

    def getDstTIMs(self) -> np.ndarray:
        if self._dst_tims is None and self._dst is not None:
            self._dst_tims = self._all_tims(self._dst)
        return self._dst_tims

    dst_tims = property(getDstTIMs)

    def getMaxCliqueSrcTIMs(self) -> np.ndarray:
        return self._pruned_src_tims

    max_clique_src_tims = property(getMaxCliqueSrcTIMs)

    def getMaxCliqueDstTIMs(self) -> np.ndarray:
        return self._pruned_dst_tims

    max_clique_dst_tims = property(getMaxCliqueDstTIMs)

    def getSrcTIMsMap(self) -> np.ndarray:
        return self.getScaleInliersMap()

    src_tims_map = property(getSrcTIMsMap)

    def getDstTIMsMap(self) -> np.ndarray:
        return self.getScaleInliersMap()

    dst_tims_map = property(getDstTIMsMap)

    def getSrcTIMsMapForRotation(self) -> np.ndarray:
        return self._tims_map_rotation

    src_tims_map_for_rotation = property(getSrcTIMsMapForRotation)

    def getDstTIMsMapForRotation(self) -> np.ndarray:
        return self._tims_map_rotation

    dst_tims_map_for_rotation = property(getDstTIMsMapForRotation)


def _gather_correspondences(cloud: Union[PointCloud, np.ndarray], correspondences,
                            side: int) -> np.ndarray:
    """Gather correspondence endpoints into a 3xK matrix (registration.cc:557-564).

    ``cloud`` is a :class:`PointCloud` (read through its ``points``, (N, 3),
    as any cloud object with that attribute) or an (N, 3) or (3, N) array.
    """
    pts = np.asarray(getattr(cloud, "points", cloud), dtype=np.float64)
    if pts.ndim == 2 and pts.shape[0] != 3 and pts.shape[1] == 3:
        pts = pts.T
    idx = np.asarray([c[side] for c in correspondences], dtype=np.int64)
    return pts[:, idx]
