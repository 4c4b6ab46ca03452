"""fasta_tpu_torch — FASTA in PyTorch with hand-written CUDA kernels for
NVIDIA Hopper, ported from ``fasta_tpu`` (which stays the reference).

Slice 1: the LASSO main path in adaptive mode — ``fasta()`` over
``DenseOp`` · ``LeastSquares`` · ``L1Norm`` with the fused gradient-map
kernel, and ``Problem.microsolve()`` through the whole-solve kernel.
Only what is ported is exported.  Importing this package imports no JAX
and compiles nothing.
"""

from .micro import MicroResult, microsolve, microsolve_supported
from .operators import AdjointOp, DenseOp, LinearOp, as_linear_op, check_adjoint
from .options import STOP_RULES, FastaOptions
from .problem import Problem
from .prox import shrink
from .solver import (DeviceResult, FastaResult, estimate_stepsize, fasta,
                     make_solver, solve)
from .terms import (FunctionProx, FunctionSmooth, L1Norm, LeastSquares,
                    ProxTerm, SmoothTerm, as_prox_term, as_smooth_term)

__all__ = [
    "fasta", "solve", "make_solver", "estimate_stepsize", "FastaResult",
    "DeviceResult", "FastaOptions", "STOP_RULES", "Problem",
    "LinearOp", "AdjointOp", "DenseOp", "as_linear_op", "check_adjoint",
    "SmoothTerm", "LeastSquares", "FunctionSmooth", "ProxTerm", "L1Norm",
    "FunctionProx", "as_smooth_term", "as_prox_term", "shrink",
    "MicroResult", "microsolve", "microsolve_supported",
]
