#!/usr/bin/env python3
"""The TLS prefix sums before and after the fixed-order scan, in one process
on one card.

    python3 scripts/torch_scan_cost.py [--rounds 2] [--repeats 20]

The port's scale stage (``solvers/pipeline.py::scale_stage``, which runs
``ops/tls.py::scalar_tls`` over 2K events) on ``chip_smoke.py``'s two
unknown-scale problems: the facade defaults' (one problem, N=1889, 3.57M
events) and the unknown-scale batch's (B=64, N=500, 64 x 249,500 events).
Each is run with ``tls.prefix_sum`` as it is (the float64 shifted-add scan)
and with ``torch.cumsum`` in its place (the prefix sums before the scan), in
turns: cumsum, scan, scan, cumsum, ``--rounds`` times; each turn is the
median of ``--repeats`` synchronised stage times by CUDA events, with the
peak memory above the inputs. Then each variant runs the stage
``--repeats`` times more and counts the distinct bit patterns of its scale
estimates and pair masks (1 means bit-stable). Prints the card's name and
power limit, then one JSON line a problem. Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _digest(res) -> str:
    h = hashlib.sha256()
    for t in (res.scale, res.pair_mask):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_scan_cost: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args()

    import chip_smoke
    from teaserpp_tpu_torch.ops import tls
    from teaserpp_tpu_torch.params import RobustRegistrationSolverParams
    from teaserpp_tpu_torch.solvers.pipeline import scale_stage

    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    scan = tls.prefix_sum
    variants = {"cumsum": lambda x: torch.cumsum(x, dim=-1), "scan": scan}

    facade_src, facade_dst = chip_smoke.make_problems(1, chip_smoke.N_POINTS,
                                                      scale=chip_smoke.FACADE_SCALE)
    batch = chip_smoke.make_scale_problems(chip_smoke.SCALE_BATCH, chip_smoke.SCALE_N)
    problems = {
        "facade_defaults": (facade_src, facade_dst, RobustRegistrationSolverParams(
            **chip_smoke.facade_param_fields(True))),
        "unknown_scale_batch": (batch[0], batch[1], chip_smoke.scale_params()),
    }
    try:
        for name, (src, dst, params) in problems.items():
            s, d = chip_smoke._to(dev, src, dst)
            valid = torch.ones(s.shape[0], s.shape[-1], dtype=torch.bool, device=dev)

            def stage():
                return scale_stage(s, d, params, valid=valid)

            times = {k: [] for k in variants}
            peaks = {}
            for _ in range(args.rounds):
                for key in ("cumsum", "scan", "scan", "cumsum"):
                    tls.prefix_sum = variants[key]
                    stage()  # warm
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats(dev)
                    base = torch.cuda.memory_allocated(dev)
                    times[key].append(chip_smoke.time_ms(stage, args.repeats, dev))
                    peaks[key] = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
            stable = {}
            for key, fn in variants.items():
                tls.prefix_sum = fn
                stable[key] = len({_digest(stage()) for _ in range(args.repeats)})
            tls.prefix_sum = scan
            print(json.dumps({name: dict(
                batch=int(s.shape[0]), n=int(s.shape[-1]), events_per_problem=int(
                    s.shape[-1] * (s.shape[-1] - 1)), stage_ms=times,
                stage_ms_median={k: statistics.median(v) for k, v in times.items()},
                peak_gb_above_inputs=peaks, distinct_results_in_repeats=stable),
                "card": card}), flush=True)
    finally:
        tls.prefix_sum = scan
    return 0


if __name__ == "__main__":
    sys.exit(main())
