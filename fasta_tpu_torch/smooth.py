"""Reference-style (f, gradf) closure builders (port of
``fasta_tpu/smooth.py``): thin views over the terms in
``fasta_tpu_torch.terms``, which hold the objective math.

The solver takes :class:`~fasta_tpu_torch.terms.SmoothTerm` objects;
these builders serve callers that want bare callables (the upstream API
shape).  Each binds the corresponding term's methods, so the formulas
cannot drift."""

from __future__ import annotations

from . import terms as _terms

__all__ = [
    "least_squares", "logistic", "phase_hinge", "objective_l1",
]


def least_squares(b):
    """f(d) = ½‖d − b‖² (complex-safe) — terms.LeastSquares as a pair."""
    t = _terms.LeastSquares(b)
    return t.value, t.grad


def logistic(b):
    """Stable logistic loss, labels b ∈ {0,1} — terms.Logistic as a
    pair."""
    t = _terms.Logistic(b)
    return t.value, t.grad


def phase_hinge(b):
    """PhaseMax smooth circular hinge — terms.PhaseHinge as a pair."""
    t = _terms.PhaseHinge(b)
    return t.value, t.grad


def objective_l1(mu):
    """g(x) = μ‖x‖₁ — terms.L1Norm's value (for recording)."""
    return _terms.L1Norm(mu).value
