"""fasta_tpu_torch — FASTA in PyTorch with hand-written CUDA kernels for
NVIDIA Hopper, ported from ``fasta_tpu`` (which stays the reference).

Ported so far: the 13 example problems — the dense family (LASSO, NNLS,
sparse logistic regression, the SVM), TV denoising on the dual, phase
retrieval (PhaseMax, complex or planar, and coded diffraction), sparse
LASSO, democratic representations, MMV, 1-bit matrix completion,
max-norm and NMF — with the operator, term and prox library, in plain,
adaptive and FISTA mode, through
``fasta()`` / ``Problem.solve`` (the PyTorch loop with the one-read
gradient-map kernels), ``Problem.microsolve`` (the whole-solve kernels),
``solve_path`` and ``Problem.microsolve_sweep`` (the regularization
path), ``Problem.recovery_error``, and the serving path:
``recommend_path`` / ``ServingPlan`` and ``Problem.solve_serving``, which
route a request (stacked measurements, or an ``InstanceBatch`` whose
instances carry their own prox data and starts) to the whole-solve
kernels, their batched forms
(``microsolve_batch``) or the batch solver (``make_batch_solver``);
bfloat16 storage (``LowPrecDenseOp``, bfloat16 ``PlanarDenseOp``) with
float32 refinement through ``checkpoint.resume``, and ``checkpoint``'s
``save_pytree`` / ``load_pytree``, whose files both packages read; exact
mid-run resume (``make_stateful_solver`` → ``SolverState`` →
``resume_state``); the batch solver over a stacked operator; the
mode-comparison harness (``compare_modes``, ``format_comparison``), the
closure builders of ``smooth``, the figures of ``plotting`` (matplotlib
imported when a figure is drawn) and the suite's runner
``python -m fasta_tpu_torch.problems``.
Row-sharded solves over ``torch.distributed`` (``sharding``: the row
layouts of ``fasta_tpu.sharding`` on a ``DeviceMesh``, one all-reduce a
gradient map; ``distributed``: the process group); the layouts that shard
x itself (the TV halo exchange, the 2-D meshes) are not ported yet.
Entry points place data that carries no device on the card unless the
caller passes ``device="cpu"``.
It exports every name of ``fasta_tpu.__all__``.  Importing this package
imports no JAX and no matplotlib, and compiles nothing.
"""

from . import (checkpoint, distributed, operators, plotting, profiling,
               prox, sharding, smooth, terms)
from .harness import MODE_OPTIONS, compare_modes, format_comparison
from .micro import (MicroBatchResult, MicroResult, microsolve,
                    microsolve_batch, microsolve_supported, microsolve_sweep)
from .operators import (AdjointOp, ComposeOp, DenseOp, DiagonalOp,
                        FunctionOp, IdentityOp, LinearOp, LowPrecDenseOp,
                        MaskedFourierOp, PlanarDenseOp, ScaledOp, SparseOp,
                        StackedOp, TVDiv2D, TVGrad2D, as_linear_op,
                        check_adjoint)
from .options import STOP_RULES, FastaOptions
from .problem import Problem
from .prox import (project_box, project_l1_ball, project_linf_ball,
                   project_nonneg, prox_l1, prox_l21, prox_linear, prox_linf,
                   prox_zero, shrink, shrink_rows, svt)
from .serving import (BATCH_CROSSOVER_UNKNOWNS, InstanceBatch, ServingPlan,
                      recommend_path)
from .solver import (DeviceResult, Diagnostics, FastaResult, SolverState,
                     estimate_stepsize, fasta, make_batch_solver, make_solver,
                     make_stateful_solver, resume_state, solve, solve_path)
from .terms import (BoxIndicator, FunctionProx, FunctionSmooth, L1Norm,
                    L2Norm2, L21Norm, LeastSquares, LinearAnchor,
                    LinfBallIndicator, LinfNorm, Logistic, MaskedLogistic,
                    MaxRowNormBall, NMFLoss, NonnegIndicator, NuclearNorm,
                    PhaseHinge, PlanarLinearAnchor, PlanarPhaseHinge,
                    ProxTerm, SmoothTerm, SquaredHinge, ZeroTerm,
                    as_prox_term, as_smooth_term)

__all__ = [
    "fasta", "solve", "make_solver", "make_stateful_solver", "resume_state",
    "make_batch_solver", "solve_path", "estimate_stepsize",
    "FastaResult", "DeviceResult", "SolverState", "Diagnostics",
    "FastaOptions", "STOP_RULES", "Problem",
    "LinearOp", "AdjointOp", "DenseOp", "SparseOp", "LowPrecDenseOp",
    "PlanarDenseOp", "IdentityOp", "FunctionOp", "MaskedFourierOp",
    "DiagonalOp", "ScaledOp", "ComposeOp", "StackedOp",
    "TVGrad2D", "TVDiv2D", "as_linear_op", "check_adjoint",
    "SmoothTerm", "LeastSquares", "Logistic", "SquaredHinge", "PhaseHinge",
    "PlanarPhaseHinge", "MaskedLogistic", "NMFLoss", "FunctionSmooth",
    "ProxTerm", "L1Norm", "LinfNorm", "L21Norm", "NuclearNorm",
    "NonnegIndicator", "BoxIndicator", "LinfBallIndicator",
    "MaxRowNormBall", "L2Norm2", "LinearAnchor", "PlanarLinearAnchor",
    "ZeroTerm", "FunctionProx", "as_smooth_term", "as_prox_term",
    "shrink", "prox_l1", "project_nonneg", "project_box",
    "project_linf_ball", "project_l1_ball", "prox_linf", "svt",
    "shrink_rows", "prox_l21", "prox_linear", "prox_zero",
    "compare_modes", "format_comparison", "MODE_OPTIONS",
    "MicroResult", "MicroBatchResult", "microsolve", "microsolve_supported",
    "microsolve_sweep", "microsolve_batch", "recommend_path", "ServingPlan",
    "InstanceBatch",
    "BATCH_CROSSOVER_UNKNOWNS", "checkpoint", "distributed", "operators",
    "plotting", "profiling", "prox", "sharding", "smooth", "terms",
]
