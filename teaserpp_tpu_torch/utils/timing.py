"""Per-stage timing.

Counterpart of ``teaserpp_tpu/utils/timing.py``'s ``StageTimer``: wall times
collected around host-visible stage boundaries, the device synchronised at
each boundary that names it. (``trace_to``, the profiler hook, is not ported
yet: ROADMAP queue 1, item 9.)
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
