"""Command-line registration tool.

The role of the reference's MATLAB mex binding (matlab/teaser_solve.m: named
args in, ``[s, R, t, time_taken]`` out) for environments that shell out
rather than import Python: reads two PLY/PCD clouds (already-corresponding
points, or FPFH matching with ``--fpfh``), solves, prints JSON.
Counterpart of ``teaserpp_tpu/cli.py``, with the same flags and JSON keys;
``--device`` (``cuda`` by default) names where the solve and the front end
run, and without CUDA the default device fails.

    python -m teaserpp_tpu_torch.cli --src src.ply --dst dst.ply --noise-bound 0.01
    python -m teaserpp_tpu_torch.cli --src a.ply --dst b.ply --fpfh --estimate-scaling
    python -m teaserpp_tpu_torch.cli --src a.ply --dst b.ply --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src", required=True, help="source cloud (.ply/.pcd)")
    ap.add_argument("--dst", required=True, help="target cloud (.ply/.pcd)")
    ap.add_argument("--noise-bound", type=float, default=0.01)
    ap.add_argument("--cbar2", type=float, default=1.0)
    ap.add_argument("--estimate-scaling", action="store_true")
    ap.add_argument(
        "--rotation-estimation-algorithm",
        default="GNC_TLS",
        choices=["GNC_TLS", "FGR", "QUATRO"],
    )
    ap.add_argument("--rotation-gnc-factor", type=float, default=1.4)
    ap.add_argument("--rotation-max-iterations", type=int, default=100)
    ap.add_argument("--rotation-cost-threshold", type=float, default=1e-6)
    ap.add_argument(
        "--inlier-selection-mode",
        default="PMC_EXACT",
        choices=["PMC_EXACT", "PMC_HEU", "KCORE_HEU", "NONE"],
    )
    ap.add_argument("--kcore-heuristic-threshold", type=float, default=0.5)
    ap.add_argument(
        "--rotation-tim-graph", default="CHAIN", choices=["CHAIN", "COMPLETE"]
    )
    ap.add_argument("--fpfh", action="store_true",
                    help="run FPFH + matcher to generate correspondences")
    ap.add_argument("--normal-search-radius", type=float, default=0.03)
    ap.add_argument("--fpfh-search-radius", type=float, default=0.05)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu on request)")
    args = ap.parse_args(argv)

    from teaserpp_tpu_torch import (
        InlierGraphFormulation,
        InlierSelectionMode,
        RobustRegistrationSolver,
        RobustRegistrationSolverParams,
        RotationEstimationAlgorithm,
    )
    from teaserpp_tpu_torch.io.pcd import read_pcd
    from teaserpp_tpu_torch.io.ply import read_ply

    def load(path):
        return read_pcd(path) if path.endswith(".pcd") else read_ply(path)

    src_cloud = load(args.src)
    dst_cloud = load(args.dst)

    params = RobustRegistrationSolverParams(
        noise_bound=args.noise_bound,
        cbar2=args.cbar2,
        estimate_scaling=args.estimate_scaling,
        rotation_estimation_algorithm=RotationEstimationAlgorithm[
            args.rotation_estimation_algorithm
        ],
        rotation_gnc_factor=args.rotation_gnc_factor,
        rotation_max_iterations=args.rotation_max_iterations,
        rotation_cost_threshold=args.rotation_cost_threshold,
        rotation_tim_graph=InlierGraphFormulation[args.rotation_tim_graph],
        inlier_selection_mode=InlierSelectionMode[args.inlier_selection_mode],
        kcore_heuristic_threshold=args.kcore_heuristic_threshold,
    )
    solver = RobustRegistrationSolver(params, device=args.device)

    t0 = time.perf_counter()
    if args.fpfh:
        from teaserpp_tpu_torch.features import FPFHEstimation, Matcher

        fp = FPFHEstimation(device=args.device)
        sd = fp.computeFPFHFeatures(
            src_cloud, args.normal_search_radius, args.fpfh_search_radius
        )
        dd = fp.computeFPFHFeatures(
            dst_cloud, args.normal_search_radius, args.fpfh_search_radius
        )
        corr = Matcher(device=args.device).calculateCorrespondences(
            src_cloud, dst_cloud, sd, dd, False, True, False, 0.95
        )
        solution = solver.solve(src_cloud, dst_cloud, corr)
    else:
        if len(src_cloud) != len(dst_cloud):
            print(
                "error: clouds differ in size; use --fpfh to generate "
                "correspondences",
                file=sys.stderr,
            )
            return 2
        solution = solver.solve(src_cloud.as_matrix(), dst_cloud.as_matrix())
    dt = time.perf_counter() - t0

    print(
        json.dumps(
            {
                "valid": bool(solution.valid),
                "scale": float(solution.scale),
                "rotation": solution.rotation.tolist(),
                "translation": solution.translation.tolist(),
                "time_taken": dt,
                "max_clique_size": len(solver.getInlierMaxClique()),
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
