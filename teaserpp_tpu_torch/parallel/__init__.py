"""Batched execution, mesh-sharded batches and huge problems."""

from teaserpp_tpu_torch.parallel.batch import pad_problems, solve_batch, solve_batch_sharded
from teaserpp_tpu_torch.parallel.sharded import (
    LargeSolveResult,
    solve_large_exact,
    solve_large_sharded,
    trim_adjacency_dense,
)

__all__ = [
    "pad_problems",
    "solve_batch",
    "solve_batch_sharded",
    "trim_adjacency_dense",
    "solve_large_exact",
    "solve_large_sharded",
    "LargeSolveResult",
]
