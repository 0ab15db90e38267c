"""The control of the comparison: the reference put in the program's place
and computed one precision below the configuration's float32, in bfloat16
(graph, rotation and translation; 3x3 decompositions, which PyTorch has in
no type below float32, in float32), held against the reference as a run's
answers are, by the same numbers. The reference is the one the cell's
configuration names. It has to come out not correct; its readings are the
upper ends from which the limits in ``workloads/<cell>.json`` were set.

    python3 -m regbench.control --workload <cell> --seeds 1 2 3 [--device cuda]

Each seed draws the cell's pool of problems as a run does and compares
every problem of it once; one JSON line a seed. The benchmark's runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional


def _host(x):
    return None if x is None else x.cpu().numpy()


def control_readings(workload: str, seed: int, device, override: Optional[dict] = None) -> dict:
    """The control's numbers for one seed of ``workload``: ``checks.Verdict``
    as a dict, with the limits of the cell beside them."""
    import torch

    from regbench import checks
    from regbench.run import load_cell, load_module

    cell, config, traffic = load_cell(workload, override)
    ref = load_module("reference", config["reference"])
    src, dst = load_module("generators", config["generator"]).make(
        config["problem"], seed, range(traffic["pool"]))
    src_t = torch.from_numpy(src).to(device)
    dst_t = torch.from_numpy(dst).to(device)
    t0 = time.perf_counter()
    want = ref.solve(src_t, dst_t, config["solver"])
    t1 = time.perf_counter()
    got = ref.solve(src_t, dst_t, config["solver"], dtype=torch.bfloat16,
                    graph_dtype=torch.bfloat16)
    t2 = time.perf_counter()
    cert = {}
    if checks.certifying(cell["limits"]):
        cert = {side + f: _host(getattr(r, f, None)) for side, r in (("", got), ("ref_", want))
                for f in checks.CERTIFICATE}
    v = checks.compare(*(x.cpu().numpy() for x in (
        got.rotation, got.translation, got.scale, got.inliers, want.rotation,
        want.translation, want.scale, want.inliers, want.decided)), cell["limits"], **cert)
    return {"workload": workload, "seed": seed, "problems": int(len(src)),
            "correct": v.correct, "failed": v.failed, "checks": v.as_json(),
            "reference_s": t1 - t0, "control_s": t2 - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    for seed in args.seeds:
        print(json.dumps(control_readings(args.workload, seed, device)), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
