"""teaserpp_tpu_torch — the registration engine in PyTorch and CUDA.

A port of ``teaserpp_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100, kept
beside it with the same module names. It imports neither JAX nor the JAX
package. Entry points run on CUDA unless called with ``device="cpu"``.

Ported so far: the public solver ``RobustRegistrationSolver`` (every
inlier-selection mode, GNC-TLS / FGR / Quatro, CHAIN and COMPLETE, known
and unknown scale, custom stage estimators), the batched solve
(``solve_batch`` / ``register_batch``, known or unknown scale, NONE or
KCORE_HEU at threshold 0), and the huge-N single-problem solve on one
device (``solve_large_sharded``, ``solve_large_exact``). The three TPU
kernels of the JAX package are hand-written CUDA kernels
(``csrc/trim_bits.cu``, ``csrc/trim_degrees.cu``,
``csrc/trim_adjacency.cu``; wrappers in ``ops/cuda_kernels.py``).
"""

from teaserpp_tpu_torch.params import (
    InlierGraphFormulation,
    InlierSelectionMode,
    RobustRegistrationSolverParams,
    RotationEstimationAlgorithm,
)
from teaserpp_tpu_torch.parallel.batch import pad_problems, solve_batch
from teaserpp_tpu_torch.parallel.sharded import (
    LargeSolveResult,
    solve_large_exact,
    solve_large_sharded,
)
from teaserpp_tpu_torch.solvers.pipeline import (
    PipelineSolution,
    register_batch,
    register_pair,
)
from teaserpp_tpu_torch.solvers.registration import (
    RegistrationSolution,
    RobustRegistrationSolver,
)

__all__ = [
    "InlierGraphFormulation",
    "InlierSelectionMode",
    "LargeSolveResult",
    "PipelineSolution",
    "RegistrationSolution",
    "RobustRegistrationSolver",
    "RobustRegistrationSolverParams",
    "RotationEstimationAlgorithm",
    "pad_problems",
    "register_batch",
    "register_pair",
    "solve_batch",
    "solve_large_exact",
    "solve_large_sharded",
]
