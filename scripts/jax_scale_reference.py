#!/usr/bin/env python3
"""The JAX package's results on the facade and unknown-scale problems of
``tests/chip_support.py``, on the CPU.

    python3 scripts/jax_scale_reference.py [--x64]

1. The facade problems of ``tests/test_torch_chip_paths.py::test_facade``
   (N=1889, PMC_EXACT, known scale and s=1.4), solved by the JAX package's
   ``RobustRegistrationSolver`` (float32, or float64 with ``--x64``): errors
   against the planted transform, clique size, stage seconds. The clique
   size is the floor of the port's clique gate (``JAX_FACADE_CLIQUE``).
2. The 64 unknown-scale problems of ``test_unknown_scale_batch`` (B=64,
   N=500): the scale estimate of the JAX package's batched ``solve_batch``
   in float32 beside the port's ``scale_stage`` in float32 and in float64
   (on the CPU, in chunks of 8 problems): each against the truth and
   against each other.

Prints one JSON line; about a minute.
"""

import argparse
import json
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--x64", action="store_true")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", args.x64)
    import jax.numpy as jnp
    import torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import chip_support as cs
    from teaserpp_tpu import RobustRegistrationSolver, RobustRegistrationSolverParams
    from teaserpp_tpu.params import InlierSelectionMode
    from teaserpp_tpu.parallel import solve_batch
    from teaserpp_tpu.utils.metrics import rotation_error_deg, translation_error
    from teaserpp_tpu_torch.solvers.pipeline import scale_stage

    out = {"x64": args.x64}
    for name, scale in (("demo", 1.0), ("defaults", cs.FACADE_SCALE)):
        src, dst = cs.make_problems(1, cs.N_POINTS, scale=scale)
        params = RobustRegistrationSolverParams(**cs.facade_param_fields(scale != 1.0))
        solver = RobustRegistrationSolver(params)
        t0 = time.perf_counter()
        sol = solver.solve(src[0], dst[0])
        out[name] = dict(
            valid=bool(sol.valid), scale=float(sol.scale),
            scale_err=abs(float(sol.scale) - scale),
            rot_err_deg=rotation_error_deg(sol.rotation, cs.T[:3, :3]),
            trans_err_m=translation_error(sol.translation, cs.T[:3, 3]),
            clique_size=len(solver.getInlierMaxClique()),
            scale_inlier_pairs=int(solver.getScaleInliersMask().sum()),
            seconds_first_solve=time.perf_counter() - t0,
            stage_s=solver.getStageTimings(),
        )

    src, dst, s_true, _, _ = cs.make_scale_problems(cs.SCALE_BATCH, cs.SCALE_N)
    tp = cs.scale_params()
    jp = RobustRegistrationSolverParams(
        noise_bound=tp.noise_bound, estimate_scaling=True,
        inlier_selection_mode=InlierSelectionMode.KCORE_HEU, kcore_heuristic_threshold=0.0)
    est = {"jax_float32": [], "port_float32": [], "port_float64": []}
    for c in range(0, src.shape[0], 8):
        s, d = src[c:c + 8], dst[c:c + 8]
        est["jax_float32"].append(np.asarray(solve_batch(jnp.asarray(s), jnp.asarray(d), jp).scale))
        for dt, key in ((torch.float32, "port_float32"), (torch.float64, "port_float64")):
            st = scale_stage(torch.from_numpy(s).to(dt), torch.from_numpy(d).to(dt), tp)
            est[key].append(st.scale.double().numpy())
    est = {k: np.concatenate(v).astype(np.float64) for k, v in est.items()}
    out["unknown_scale_batch"] = dict(
        problems=int(src.shape[0]),
        **{f"{k}_err_max": float(np.abs(v - s_true).max()) for k, v in est.items()},
        jax_float32_vs_port_float32_max=float(np.abs(est["jax_float32"] - est["port_float32"]).max()),
        jax_float32_vs_port_float64_max=float(np.abs(est["jax_float32"] - est["port_float64"]).max()),
        port_float32_vs_port_float64_max=float(np.abs(est["port_float32"] - est["port_float64"]).max()),
    )
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
