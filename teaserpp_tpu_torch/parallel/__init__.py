"""Batched and huge-N entry points."""

from teaserpp_tpu_torch.parallel.batch import pad_problems, solve_batch
from teaserpp_tpu_torch.parallel.sharded import (
    LargeSolveResult,
    solve_large_exact,
    solve_large_sharded,
)

__all__ = [
    "LargeSolveResult",
    "pad_problems",
    "solve_batch",
    "solve_large_exact",
    "solve_large_sharded",
]
