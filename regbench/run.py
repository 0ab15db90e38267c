"""Run one cell of the benchmark once and print its result line.

    python3 -m regbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell ``workloads/<cell>.json`` names its
configuration and traffic mix, and the traffic mix its driver
``traffic/<driver>.py``; the seed draws the pool of problems. Set-up
(``setup_s``, from the start of this process) loads the program, builds or
loads its native libraries into its ``_build/`` directory in the checkout,
and has the driver warm the entry up at the window's shapes; then the
driver sends requests for ``--seconds``. After the window every answer is
held against the plain reference that the configuration names
(``reference/<name>.py``, compared by ``checks.py``), which runs on the
same card once the program's memory is read and freed.

With ``--trace 0`` the line carries the cell's end-to-end metrics. With
``--trace 1`` the driver profiles the first requests of the window with
``torch.profiler`` and runs the rest with the program's stage timers on;
the line carries the per-layer metrics, the device's busy time in the
traced part and a breakdown. The numbers compared and their limits are the
last lines of standard error and the last key of the line.

Exit codes: 0 with a result; 3 without a CUDA card or with fewer than the
cell needs; 4 when JAX or the JAX package was loaded; other codes for
errors, with no result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Callable, List, NamedTuple, Optional  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "teaserpp_tpu")


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` by its file (a name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"regbench_{kind}_{name}".replace(".", "_"), path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(folder: str, metric: str):
    """The reader of ``metric``: ``<folder>/<metric>.py``, or else the one
    of the part of its name before the first dot (``idle_pct.py`` reads
    ``idle_pct.batch`` and ``idle_pct.facade``)."""
    if not (HERE / folder / f"{metric}.py").exists():
        metric = metric.split(".")[0]
    return load_module(folder, metric)


def load_cell(workload: str, override: Optional[dict] = None):
    """``(cell, config, traffic)`` of ``workload``; ``override`` changes the
    configuration and traffic (keys ``config`` and ``traffic``), for tests
    at sizes the CPU holds."""
    override = override or {}
    cell = load_json("workloads", workload)
    config = _merge(load_json("configs", cell["config"]), override.get("config"))
    traffic = _merge(load_json("traffic", cell["traffic"]), override.get("traffic"))
    return cell, config, traffic


def banned_modules() -> List[str]:
    """Top-level names, compared whole, of loaded modules that must not be."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


class Layers(SimpleNamespace):
    """What the per-layer readers read: ``trace`` (``trace.Trace`` of the
    profiled requests, or None), ``stage_ms`` (the program's stage times,
    one dict a request), ``device_kind``, ``batch``, ``n``, and whatever
    else the traffic's driver measured (``traced_requests``, ...)."""

    def stage_median_ms(self, stage: str) -> Optional[float]:
        vals = [d[stage] for d in self.stage_ms if stage in d]
        return statistics.median(vals) if vals else None

    def idle_pct(self) -> Optional[float]:
        if self.trace is None or self.trace.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)

    def device_s(self, match) -> Optional[float]:
        """Device seconds of the operations whose names ``match`` accepts."""
        if self.trace is None:
            return None
        s = sum(v for k, v in self.trace.op_s.items() if match(k))
        return s if s > 0 else None


class Ctx(NamedTuple):
    """What a traffic driver drives: the entry, the traffic mix, request
    ``r`` as ``(src, dst, first pool index)``, and the device's sync."""

    entry: object
    traffic: dict
    request: Callable
    sync: Callable
    device: object


def _merge(base: dict, change: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (change or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def _metrics(workload: str, kind: str, source, folder: str) -> dict:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = {}
    for m in bench[kind]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        value = reader(folder, m["name"]).read(source)
        if value is None:
            if kind == "end_to_end":
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _certificates(answers, rows) -> np.ndarray:
    """``(2, A)`` float64: each row's ``optimal`` (0/1) and
    ``suboptimality`` from its answer, NaN where the answer has none."""
    out = np.full((2, len(rows)), np.nan)
    for i, (_, a, k) in enumerate(rows):
        if len(answers[a]) > 5:
            out[:, i] = answers[a][5][k], answers[a][6][k]
    return out


def _power_limit() -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             override: Optional[dict] = None, t0: float = _T0):
    """One run of ``workload``; returns ``(result dict, checks.Verdict)``.

    The traffic's driver (``traffic/<driver>.py``) warms the entry up and
    drives the window; see ``load_cell`` for ``override``.
    """
    import torch

    from regbench import checks
    from regbench import trace as tr

    cell, config, traffic = load_cell(workload, override)
    ref = load_module("reference", config["reference"])
    seed = int(seed) % 2 ** 64
    bsz, pool = traffic["batch"], traffic["pool"]
    if pool % bsz:
        raise ValueError(f"pool {pool} is no multiple of the batch {bsz}")
    is_cuda = device.type == "cuda"

    def sync():
        if is_cuda:
            torch.cuda.synchronize(device)

    marks = [time.perf_counter()]
    src_pool, dst_pool = load_module("generators", config["generator"]).make(
        config["problem"], seed, range(pool))
    marks.append(time.perf_counter())
    entry = load_module("entries", traffic["entry"]).open(config["solver"], traffic["args"],
                                                          device)
    marks.append(time.perf_counter())

    def request(r: int):
        lo = (r * bsz) % pool
        return src_pool[lo:lo + bsz], dst_pool[lo:lo + bsz], lo

    driver = load_module("traffic", traffic["driver"])
    ctx = Ctx(entry, traffic, request, sync, device)
    driver.warm_up(ctx)
    marks.append(time.perf_counter())
    setup_s = marks[-1] - t0
    print(f"regbench: set-up {setup_s:.3f} s: before the cell {marks[0] - t0:.3f}, "
          f"pool {marks[1] - marks[0]:.3f}, program {marks[2] - marks[1]:.3f}, "
          f"warm-up {marks[3] - marks[2]:.3f}", file=sys.stderr, flush=True)

    window = driver.drive(ctx, seconds, trace)
    answers = window.pop("answers")
    events = window.pop("events")

    memory_peak = int(torch.cuda.max_memory_allocated(device)) if is_cuda else 0
    kind = torch.cuda.get_device_name(device) if is_cuda else "cpu"
    del entry, ctx
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    trace_result = None
    if trace:
        trace_result = tr.reduce(events)
        del events
        if is_cuda and (trace_result is None or trace_result.busy_s <= 0):
            raise RuntimeError("the profiler recorded no device time in the traced window")

    # correctness: every answer of the window against the reference of its problem
    rows = [(first + k, a_i, k) for a_i, (first, rot, *_) in enumerate(answers)
            for k in range(len(rot))]
    pids = sorted({p for p, _, _ in rows})
    at = {p: i for i, p in enumerate(pids)}
    sol = ref.solve(torch.from_numpy(src_pool[pids]).to(device),
                    torch.from_numpy(dst_pool[pids]).to(device), config["solver"])
    idx = np.array([at[p] for p, _, _ in rows])
    got = [np.stack([answers[a][f][k] for _, a, k in rows]) for f in range(1, 5)]
    want = [x.cpu().numpy()[idx] for x in (sol.rotation, sol.translation, sol.scale,
                                           sol.inliers, sol.decided)]
    cert = {}
    if checks.certifying(cell["limits"]):
        cert = dict(zip(checks.CERTIFICATE, _certificates(answers, rows)))
        for f in checks.CERTIFICATE:
            x = getattr(sol, f, None)
            cert["ref_" + f] = None if x is None else x.cpu().numpy()[idx]
    verdict = checks.compare(*got, *want, cell["limits"], **cert)

    dev = {"platform": "gpu" if is_cuda else device.type, "kind": kind, "count": cell["chips"],
           "memory_peak_bytes": memory_peak}
    result = {"correct": verdict.correct, "attempted": window["attempted"],
              "failed": verdict.failed}
    if trace:
        layers = Layers(trace=trace_result, device_kind=kind, batch=bsz,
                        n=src_pool.shape[-1], **window)
        result["metrics"] = _metrics(workload, "per_layer", layers, "metrics")
        if trace_result is not None:
            dev.update(busy_s=trace_result.busy_s, window_s=trace_result.window_s)
            result["breakdown"] = {"device_ops": tr.top(trace_result.op_s),
                                   "idle_gaps": tr.top(trace_result.gap_s)}
        if is_cuda:
            dev["power_limit"] = _power_limit()
    else:
        record = SimpleNamespace(setup_s=setup_s, failed=verdict.failed, **window)
        result["metrics"] = _metrics(workload, "end_to_end", record, "end_to_end")
    result["device"] = dev
    result["checks"] = verdict.as_json()
    return result, verdict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of regbench once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    chips = load_json("workloads", args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"regbench: cell {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    # torch's own CPU operations take one host thread: with its default pool
    # of a thread a core, the facade's solves ran 3-10% slower on every seed
    # tried (PERF.md, section 2)
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.zeros((), device=device)  # the CUDA context, counted before the cell
    result, verdict = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device)
    found = banned_modules()
    if found:
        print(f"regbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    sys.stderr.write("".join(f"check {line}\n" for line in verdict.lines()))
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
