"""fasta_tpu_torch — FASTA in PyTorch with hand-written CUDA kernels for
NVIDIA Hopper, ported from ``fasta_tpu`` (which stays the reference).

Ported so far: the dense problem family — LASSO, NNLS, sparse logistic
regression and the SVM — and TV denoising on the dual, in plain,
adaptive and FISTA mode, through ``fasta()`` / ``Problem.solve`` (the
PyTorch loop with the one-read gradient-map kernels), ``Problem.microsolve``
(the whole-solve kernels), ``solve_path`` and ``Problem.microsolve_sweep``
(the regularization path).
Only what is ported is exported.  Importing this package imports no JAX
and compiles nothing.
"""

from .micro import (MicroBatchResult, MicroResult, microsolve,
                    microsolve_supported, microsolve_sweep)
from .operators import (AdjointOp, DenseOp, LinearOp, ScaledOp, TVDiv2D,
                        TVGrad2D, as_linear_op, check_adjoint)
from .options import STOP_RULES, FastaOptions
from .problem import Problem
from .prox import project_box, project_nonneg, shrink
from .solver import (DeviceResult, FastaResult, estimate_stepsize, fasta,
                     make_solver, solve, solve_path)
from .terms import (BoxIndicator, FunctionProx, FunctionSmooth, L1Norm,
                    L2Norm2, LeastSquares, Logistic, NonnegIndicator,
                    ProxTerm, SmoothTerm, SquaredHinge, as_prox_term,
                    as_smooth_term)

__all__ = [
    "fasta", "solve", "make_solver", "solve_path", "estimate_stepsize",
    "FastaResult", "DeviceResult", "FastaOptions", "STOP_RULES", "Problem",
    "LinearOp", "AdjointOp", "DenseOp", "ScaledOp", "TVGrad2D", "TVDiv2D",
    "as_linear_op", "check_adjoint",
    "SmoothTerm", "LeastSquares", "Logistic", "SquaredHinge",
    "FunctionSmooth", "ProxTerm", "L1Norm", "NonnegIndicator",
    "BoxIndicator", "L2Norm2", "FunctionProx", "as_smooth_term",
    "as_prox_term", "shrink", "project_nonneg", "project_box",
    "MicroResult", "MicroBatchResult", "microsolve", "microsolve_supported",
    "microsolve_sweep",
]
