"""teaserpp_tpu_torch — the registration engine in PyTorch and CUDA.

A port of ``teaserpp_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100, kept
beside it with the same module names. It imports neither JAX nor the JAX
package. Entry points run on CUDA unless called with ``device="cpu"``.

Ported: the public solver ``RobustRegistrationSolver`` (every
inlier-selection mode, GNC-TLS / FGR / Quatro, CHAIN and COMPLETE, known
and unknown scale, custom stage estimators), the batched solve
(``solve_batch`` / ``register_batch``, known or unknown scale, every
inlier-selection mode: the top k-core or the batched greedy clique), the
huge-N single-problem solve (``solve_large_sharded``, ``solve_large_exact``),
the multi-process and mesh paths over ``torch.distributed``
(``parallel/multihost.py``: ``initialize_distributed``, ``make_mesh`` and a
mesh of ranks; ``parallel.solve_batch_sharded``; the ``mesh=`` branches of
the huge-N solve, row-sharded, and of the front end), point-to-point ICP
(``solvers/icp.py``), PLY and PCD
I/O (``io/``), batch results files (``parallel/results_io.py``), the point
containers and helpers (``utils/``), a profiler hook
(``utils/timing.py::trace_to``), the FPFH front end (``features/``: grid-hash
neighbour plans, normals, FPFH descriptors and the exact-NN ``Matcher``;
imported from ``teaserpp_tpu_torch.features``, as in the JAX package) and
the command-line tool (``python -m teaserpp_tpu_torch.cli``) and the DRS
optimality certifier (``certification/``: ``DRSCertifier``, DENSE and
ITERATIVE, ``certify_batch``, ``certify_checkpointed``; float64 by default
through its ``dtype`` argument), which ``solve_batch(..., certify=...)``
runs on every answer of a batch. The three
TPU kernels of the JAX package are hand-written CUDA kernels
(``csrc/trim_bits.cu``, ``csrc/trim_degrees.cu``, ``csrc/trim_adjacency.cu``;
wrappers in ``ops/cuda_kernels.py``).
"""

from teaserpp_tpu_torch.certification import (
    CertificationResult,
    DRSCertifier,
    DRSCertifierParams,
    EigSolverType,
)
from teaserpp_tpu_torch.params import (
    GNCRotationSolverParams,
    InlierGraphFormulation,
    InlierSelectionMode,
    MaxCliqueSolverParams,
    RobustRegistrationSolverParams,
    RotationEstimationAlgorithm,
)
from teaserpp_tpu_torch.parallel.batch import CertifiedSolution, pad_problems, solve_batch
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

# Reference-compatible aliases, as the JAX package's (the reference's
# python/teaserpp_python/__init__.py re-exports the enums at module scope).
ROTATION_ESTIMATION_ALGORITHM = RotationEstimationAlgorithm
INLIER_SELECTION_MODE = InlierSelectionMode
INLIER_GRAPH_FORMULATION = InlierGraphFormulation

__all__ = [
    "CertificationResult",
    "CertifiedSolution",
    "DRSCertifier",
    "DRSCertifierParams",
    "EigSolverType",
    "GNCRotationSolverParams",
    "INLIER_GRAPH_FORMULATION",
    "INLIER_SELECTION_MODE",
    "InlierGraphFormulation",
    "InlierSelectionMode",
    "LargeSolveResult",
    "MaxCliqueSolverParams",
    "PipelineSolution",
    "ROTATION_ESTIMATION_ALGORITHM",
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
