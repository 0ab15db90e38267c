"""The profiler's trace, reduced to what the per-layer metrics read.

``profiled`` runs a block of requests under ``torch.profiler``, and
``collect`` takes the raw events of the run as plain tuples. ``reduce``
cuts them to the traced window (the span of the harness's
``regbench.window`` range) and gives the device's busy time (the union of
every kernel, copy and set on the card), each device operation's time by
name, and the idle gaps of the card, each named by what the host was doing
at its middle: the innermost host event of the window's thread that covers
it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

WINDOW = "regbench.window"
REQUEST = "regbench.request"


class Event(NamedTuple):
    name: str
    on_device: bool
    start_ns: int
    end_ns: int
    thread: int
    annotation: bool  # a record_function range, not an operation


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    op_s: Dict[str, float]  # device time by operation name, inside the window
    gap_s: Dict[str, float]  # idle time by what the host was doing


@contextlib.contextmanager
def profiled(device, sync):
    """Profile the block inside the ``regbench.window`` range, the device
    synchronised before the range closes; the list it yields holds the
    raw events once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    events: List[Event] = []
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield events
            sync()
    events.extend(collect(prof))


def collect(prof) -> List[Event]:
    """The raw events of a finished ``torch.profiler.profile``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = int(e.start_ns())
        dev = str(e.device_type()).rsplit(".", 1)[-1] != "CPU"
        note = bool(e.is_user_annotation()) if hasattr(e, "is_user_annotation") \
            else name.startswith("regbench.")
        out.append(Event(name, dev, start, start + int(e.duration_ns()),
                         int(e.start_thread_id()), note))
    return out


def _union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _name_gaps(gaps: List[Tuple[int, int]], host: List[Event]) -> Dict[str, float]:
    """Idle seconds by the innermost host event covering each gap's middle.
    Host events of one thread nest, so a stack swept in time order holds
    the chain of events open at each moment."""
    host = sorted(host, key=lambda e: (e.start_ns, -e.end_ns))
    out: Dict[str, float] = {}
    stack: List[Event] = []
    i = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) / 2
        while i < len(host) and host[i].start_ns <= mid:
            while stack and stack[-1].end_ns <= host[i].start_ns:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1].end_ns < mid:
            stack.pop()
        name = stack[-1].name if stack else "(no host event)"
        out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return out


def reduce(events: List[Event]) -> Optional[Trace]:
    """The window's busy time, device operations and named idle gaps; None
    when the trace holds no window."""
    windows = [e for e in events if e.name == WINDOW and not e.on_device]
    if not windows:
        return None
    win = windows[0]
    w0, w1 = win.start_ns, win.end_ns
    ops: Dict[str, float] = {}
    spans = []
    for e in events:
        if not e.on_device or e.annotation:
            continue
        a, b = max(e.start_ns, w0), min(e.end_ns, w1)
        if b <= a:
            continue
        spans.append((a, b))
        ops[e.name] = ops.get(e.name, 0.0) + (b - a) / 1e9
    busy = _union(spans)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    host = [e for e in events if not e.on_device and e.thread == win.thread
            and e.end_ns > w0 and e.start_ns < w1]
    return Trace(window_s=(w1 - w0) / 1e9,
                 busy_s=sum(b - a for a, b in busy) / 1e9,
                 op_s=ops, gap_s=_name_gaps(gaps, host))


def top(d: Dict[str, float], k: int = 10, width: int = 120) -> List[list]:
    """The ``k`` largest entries as ``[name, seconds]``, names cut to ``width``."""
    return [[name[:width], s] for name, s in sorted(d.items(), key=lambda kv: -kv[1])[:k]]
