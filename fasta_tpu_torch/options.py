"""Solver options — the reference-compatible configuration surface.

Port of ``fasta_tpu/options.py``: the same fields, defaults and checks, so
one option set means the same solve in both packages.  Every enhancement
(adaptive BB stepsize, FISTA acceleration, backtracking, restart) is
independently toggleable, the stopping rule is selectable, and the
defaults follow the reference conventions (adaptive on, acceleration
off, backtracking on, window 10, stepsize_shrink 0.2 when adaptive else
0.5).

``FastaOptions`` is a frozen dataclass: the solver reads it, never
mutates it, and ``replace`` derives a variant.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

__all__ = ["FastaOptions", "STOP_RULES", "stop_test"]

# Stopping rules, matching reference_oracle.fasta_numpy.STOP_RULES.  The
# index of a rule in this tuple is its code in the CUDA kernel.
STOP_RULES = (
    "residual",
    "normalized_residual",
    "ratio_residual",
    "hybrid_residual",
    "iterations",
)


def stop_test(rule: str, res, nres, max_res, tol: float, eps_r: float):
    """The stopping rule ``rule`` as a bool tensor shaped like ``res`` (0-d
    for one solve, one per lane for a batch; oracle-identical formulas;
    "iterations" never stops early)."""
    if rule == "residual":
        return res < tol
    if rule == "normalized_residual":
        return nres < tol
    if rule == "ratio_residual":
        return res / (max_res + eps_r) < tol
    if rule == "hybrid_residual":
        return (res / (max_res + eps_r) < tol) | (nres < tol)
    return torch.zeros_like(res, dtype=torch.bool)


@dataclasses.dataclass(frozen=True)
class FastaOptions:
    """Solver configuration.

    Field semantics are identical to the keyword arguments of the float64
    oracle ``reference_oracle.fasta_numpy.fasta``.
    """

    max_iters: int = 1000
    tol: float = 1e-3
    adaptive: bool = True
    accelerate: bool = False
    backtrack: bool = True
    restart: bool = True
    window: int = 10
    max_backtracks: int = 20
    stepsize_shrink: Optional[float] = None   # default 0.2 adaptive else 0.5
    eps_r: float = 1e-8
    eps_n: float = 1e-8
    stop_rule: str = "hybrid_residual"
    record_objective: bool = False
    record_iterates: bool = False
    # Lean mode: skip all per-iteration diagnostic recording (the
    # residuals/taus/fvals/backtracks arrays come back None).  Iteration
    # math, stopping decisions and solution are unchanged.
    record_diagnostics: bool = True
    verbose: bool = False
    # Let the smooth term provide a fused one-pass (d, f, grad)
    # evaluation (the K-B3 kernel on an f32 CUDA operator, the plain
    # two-pass form elsewhere).  An execution strategy only.
    fuse: bool = True
    # Halt the loop the moment the objective or residual goes NaN/Inf and
    # flag it in the result.
    guard_nonfinite: bool = False
    # Custom stopping rule: a callable (k, residual, norm_residual,
    # max_residual, f1) -> bool, OR-combined with the selected stop_rule.
    stop_fn: Optional[Callable] = None
    # Decision-scalar precision.  "high" accumulates the cancellation-
    # prone decision scalars (f-values and the nonmonotone window,
    # ⟨Δx,∇f⟩, ⟨Δx,Δg⟩) in float64; "auto" (the default) does so exactly
    # when the iterate dtype is float32; "standard" uses plain
    # working-precision reductions.
    precision: str = "auto"

    # Mode precedence matches the oracle (fasta_numpy.py: ``if adaptive and
    # not accelerate ... elif accelerate``): acceleration wins when both are
    # set, since ``adaptive=True`` is the default.
    @property
    def effective_mode(self) -> str:
        if self.accelerate:
            return "accelerated"
        if self.adaptive:
            return "adaptive"
        return "plain"

    def __post_init__(self):
        if self.stop_rule not in STOP_RULES:
            raise ValueError(
                f"stop_rule must be one of {STOP_RULES}, got {self.stop_rule!r}")
        if self.precision not in ("auto", "standard", "high"):
            raise ValueError(
                "precision must be 'auto', 'standard' or 'high', "
                f"got {self.precision!r}")
        if self.window < 1:
            raise ValueError("window must be >= 1")
        if self.max_iters < 1:
            raise ValueError("max_iters must be >= 1")
        if not self.record_diagnostics and (self.record_objective
                                            or self.record_iterates):
            raise ValueError(
                "record_objective/record_iterates need "
                "record_diagnostics=True")

    @property
    def shrink_factor(self) -> float:
        """Backtracking shrink factor with the reference's mode-dependent
        default: 0.2 when adaptive, 0.5 otherwise."""
        if self.stepsize_shrink is not None:
            return self.stepsize_shrink
        return 0.2 if self.adaptive else 0.5

    def replace(self, **kw) -> "FastaOptions":
        return dataclasses.replace(self, **kw)
