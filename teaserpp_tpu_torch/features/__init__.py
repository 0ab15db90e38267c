"""Feature front end: normals, FPFH descriptors, correspondence matching.

Counterpart of ``teaserpp_tpu/features/`` (reference fpfh.{h,cc}, PCL-backed,
and matcher.{h,cc}, FLANN-backed): masked neighbourhood arithmetic over
query-row tiles (dense, or pruned by grid-hash candidate plans), the batched
Jacobi eigensolver for normals, and exact nearest neighbours by a float32
Gram ranking and an exact rescore. Entry points run on CUDA unless given
``device="cpu"``; the dense passes run where their tensors are.
"""

from teaserpp_tpu_torch.features.normals import (
    estimate_normals,
    estimate_normals_pruned,
    radius_neighbor_mask,
)
from teaserpp_tpu_torch.features.fpfh import (
    FPFHEstimation,
    compute_fpfh,
    compute_fpfh_features,
    compute_fpfh_pruned,
)
from teaserpp_tpu_torch.features.spatial import NeighborPlan, build_neighbor_plans
from teaserpp_tpu_torch.features.matcher import Matcher

__all__ = [
    "estimate_normals",
    "estimate_normals_pruned",
    "radius_neighbor_mask",
    "FPFHEstimation",
    "compute_fpfh",
    "compute_fpfh_features",
    "compute_fpfh_pruned",
    "NeighborPlan",
    "build_neighbor_plans",
    "Matcher",
]
