"""A closed loop: each request is sent when the last has come back.

Request ``r`` is the ``r``-th slice of ``batch`` problems of the pool,
cycling through it. ``warm_up`` sends the first ``warmup_requests``, at the
window's shapes, as set-up. ``drive`` sends the rest for ``seconds``; with
``trace`` the first ``traced_requests`` of them run under the profiler and
the rest of the window with the program's stage timers on.

Keys of the traffic mix read here: ``batch``, ``pool``,
``warmup_requests``, ``traced_requests``.
"""

from __future__ import annotations

import time

from regbench import trace as tr


def warm_up(ctx) -> None:
    for r in range(ctx.traffic["warmup_requests"]):
        ctx.entry.solve(*ctx.request(r)[:2])
    ctx.sync()


def drive(ctx, seconds: float, trace: bool) -> dict:
    """The window: every answer with its problems' first pool index, each
    request's latency, the stage times, the profiled events and the
    window's length (the profiled part plus the rest; the reading of the
    profiler's events between them is not counted)."""
    import torch

    out = {"answers": [], "latencies_s": [], "stage_ms": [], "events": None,
           "traced_requests": 0}
    r = ctx.traffic["warmup_requests"]

    def one(stages):
        nonlocal r
        src, dst, first = ctx.request(r)
        a = time.perf_counter()
        with torch.profiler.record_function(tr.REQUEST):
            rot, trans, mask = ctx.entry.solve(src, dst, stages)
        out["latencies_s"].append(time.perf_counter() - a)
        out["answers"].append((first, rot, trans, mask))
        if stages is not None:
            out["stage_ms"].append(stages)
        r += 1

    profiled_s = 0.0
    if trace:
        w0 = time.perf_counter()
        with tr.profiled(ctx.device, ctx.sync) as events:
            for _ in range(ctx.traffic["traced_requests"]):
                # stage times that cost the entry no syncs are read here too
                one(None if ctx.entry.stage_timing else {})
            ctx.sync()
            profiled_s = time.perf_counter() - w0
        out["events"] = events
        out["traced_requests"] = ctx.traffic["traced_requests"]
    w1 = time.perf_counter()
    while time.perf_counter() - w1 < seconds - profiled_s:
        one({} if trace else None)
    ctx.sync()
    out["window_s"] = profiled_s + time.perf_counter() - w1
    out["attempted"] = len(out["answers"]) * ctx.traffic["batch"]
    return out
