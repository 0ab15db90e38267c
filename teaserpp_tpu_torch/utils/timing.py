"""Per-stage timing.

Counterpart of ``teaserpp_tpu/utils/timing.py``'s ``StageTimer``: wall times
collected around host-visible stage boundaries, the device synchronised at
each boundary that names it; and ``trace_to``, a ``torch.profiler`` trace
of a block, the counterpart of the JAX package's ``jax.profiler`` hook.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch


class StageTimer:
    """Accumulates wall-clock durations per named stage."""

    def __init__(self) -> None:
        self.durations: Dict[str, float] = {}
        self.order: List[str] = []

    @contextlib.contextmanager
    def stage(self, name: str, sync: Optional[torch.device] = None):
        """Time a stage; a CUDA ``sync`` device is synchronised at exit, so
        the stage's queued kernels count in its time."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None and torch.device(sync).type == "cuda":
                torch.cuda.synchronize(sync)
            dt = time.perf_counter() - t0
            if name not in self.durations:
                self.order.append(name)
                self.durations[name] = 0.0
            self.durations[name] += dt

    def report(self) -> str:
        total = sum(self.durations.values())
        lines = [f"{n}: {self.durations[n]*1e3:.2f} ms" for n in self.order]
        lines.append(f"total: {total*1e3:.2f} ms")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.durations)


@contextlib.contextmanager
def trace_to(log_dir: Optional[str]):
    """Record a ``torch.profiler`` trace of the block into ``log_dir``; a
    no-op when ``log_dir`` is empty or None.

    CPU activity always, CUDA activity where a card is present; the trace
    lands in ``log_dir`` as TensorBoard's ``*.pt.trace.json`` (a Chrome
    trace). It records what runs and adds no spans of its own.
    """
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
