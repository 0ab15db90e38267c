"""Persistence for batched registration sweeps.

Counterpart of ``teaserpp_tpu/parallel/results_io.py``: a batched
``PipelineSolution`` round-trips through one npz file, one array per field
under the field's name. The layout is the JAX package's, so a file written
by either package loads in the other.
"""

from __future__ import annotations

import numpy as np

from teaserpp_tpu_torch.convert import solution_to_numpy
from teaserpp_tpu_torch.solvers.pipeline import PipelineSolution

_FIELDS = PipelineSolution._fields


def save_batch_results(path: str, solution: PipelineSolution) -> None:
    """Write a (possibly batched) PipelineSolution to ``path`` (npz); tensors
    are copied to the host first."""
    host = solution_to_numpy(solution)
    np.savez_compressed(path, **{f: getattr(host, f) for f in _FIELDS})


def load_batch_results(path: str) -> PipelineSolution:
    """Read a PipelineSolution saved with :func:`save_batch_results`, its
    fields as numpy arrays (as the JAX package returns them)."""
    with np.load(path) as data:
        return PipelineSolution(**{f: data[f] for f in _FIELDS})
