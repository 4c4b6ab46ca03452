"""Objective terms: smooth f(A·) and prox-friendly g(·) (port of
``fasta_tpu/terms.py:45-260, 443-482, 543-625, 693-720, 799-815,
854-889``).

Smooth terms implement ``value(d)`` and ``grad(d)`` (evaluated at
d = A x); prox terms implement ``value(x)`` and ``prox(z, t)``.  Terms
are plain data holders over tensors.  The port has the terms of the dense
problems (LASSO, NNLS, sparse logistic regression, SVM) and of TV
denoising (``LeastSquares`` over a 2-D image, ``BoxIndicator``); the
other terms come with their problems (ROADMAP Queue A item 7).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import prox as _prox

__all__ = [
    "SmoothTerm", "LeastSquares", "Logistic", "SquaredHinge",
    "FunctionSmooth", "ProxTerm", "L1Norm", "NonnegIndicator",
    "BoxIndicator", "L2Norm2", "FunctionProx", "as_smooth_term",
    "as_prox_term", "logistic_ell", "logistic_grad", "hinge_residual",
]


# --------------------------------------------------------------------------
# Smooth terms  f(d), ∇f(d)
# --------------------------------------------------------------------------

class SmoothTerm:
    # ∇f affine in d: the FISTA loop then extrapolates the gradient map
    # instead of evaluating it (fasta_tpu/solver.py:250-251)
    grad_affine = False

    def value(self, d):
        raise NotImplementedError

    def value_f64(self, d):
        """f(d) as a float64 scalar — the solver's high-precision decision
        value.  Default: exact lift of the plain value (no extra
        precision); terms whose value is a large reduction override it
        with a float64 accumulation."""
        return self.value(d).to(torch.float64)

    def grad(self, d):
        raise NotImplementedError

    def fused_gradmap(self, op):
        """Optional fused evaluation  x ↦ (d, f(d), Aᴴ∇f(d))  in one
        operator pass.  Return None when no fusion applies (the solver
        then uses the two-call path)."""
        del op
        return None


class LeastSquares(SmoothTerm):
    """f(d) = ½‖d − b‖²  (complex-safe Hermitian norm)."""

    grad_affine = True

    def __init__(self, b: torch.Tensor):
        self.b = b

    def value(self, d):
        r = d - self.b
        return 0.5 * torch.sum(torch.real(torch.conj(r) * r))

    def value_f64(self, d):
        from .precision import dot64
        r = d - self.b
        return 0.5 * dot64(r, r)

    def grad(self, d):
        return d - self.b

    def fused_gradmap(self, op):
        """One-pass (Ax, ½‖Ax−b‖², Aᴴ(Ax−b)) for a dense real operator.

        A float32 matrix of any shape takes kernel K-B3
        (``fused_lstsq_gradmap``: the CUDA kernel for a CUDA tensor, its
        plain version for a CPU tensor).  Any other dtype takes the plain
        two-pass form, as the JAX package's f32/bf16 dtype rule does
        (``lstsq_fused.py:144-145``).

        The TV dual's ``ScaledOp(μ, TVDiv2D())`` over a 2-D image takes
        kernel K-B5 (``fused_tv_gradmap``) for a float32 image and its
        plain version otherwise (``fasta_tpu/terms.py:146-155``, without
        the JAX package's Pallas and TPU gates)."""
        from .operators import DenseOp, ScaledOp, TVDiv2D
        if (isinstance(op, ScaledOp) and isinstance(op.op, TVDiv2D)
                and self.b.ndim == 2):
            from .kernels.tv_fused import (fused_tv_gradmap,
                                           tv_gradmap_reference)
            b, mu = self.b, float(op.c)
            if b.dtype == torch.float32:
                return lambda p: fused_tv_gradmap(p, b, mu)
            return lambda p: tv_gradmap_reference(p, b, mu)
        if not isinstance(op, DenseOp):
            return None
        A, b = op.A, self.b
        if A.ndim != 2 or A.is_complex() or b.ndim != 1:
            return None
        from .kernels.lstsq_fused import (fused_lstsq_gradmap,
                                          lstsq_gradmap_reference,
                                          supports_fusion)
        m, n = A.shape
        if supports_fusion(m, n, A.dtype):
            return lambda x: fused_lstsq_gradmap(A, x, b)
        return lambda x: lstsq_gradmap_reference(A, x, b)


def logistic_ell(d, b):
    """Elementwise stable logistic loss ℓ = max(d,0) + log1p(exp(−|d|))
    − b·d (the oracle's formula, in the JAX order of operations)."""
    return (torch.clamp_min(d, 0.0) + torch.log1p(torch.exp(-torch.abs(d)))
            - b * d)


def logistic_grad(d, b):
    """ℓ′ = 1/(1+exp(−d)) − b."""
    return 1.0 / (1.0 + torch.exp(-d)) - b


def hinge_residual(d, y):
    """r = max(0, 1 − y⊙d) of the squared hinge; ℓ = ½r², ℓ′ = −y⊙r."""
    return torch.clamp_min(1.0 - y * d, 0.0)


def _pointwise_fused(op, data, loss):
    """One-pass (d, Σℓ, Aᵀℓ′) for a pointwise loss over a float32 dense
    real operator: kernel K-B3p (``fused_pointwise_gradmap``), the CUDA
    kernel for a CUDA tensor and its plain version for a CPU tensor.
    Other operators and dtypes take the two-call path (None), as the JAX
    package's dtype rule does."""
    from .operators import DenseOp
    if not isinstance(op, DenseOp):
        return None
    A = op.A
    if (A.ndim != 2 or A.dtype != torch.float32 or data.ndim != 1):
        return None
    from .kernels.lstsq_fused import fused_pointwise_gradmap
    return lambda x: fused_pointwise_gradmap(A, x, data, loss)


class Logistic(SmoothTerm):
    """Logistic loss  Σ log(1+exp(d)) − bᵀd,  labels b ∈ {0,1}; stable
    evaluation as the oracle's (max(d,0) + log1p(exp(−|d|)))."""

    def __init__(self, b: torch.Tensor):
        self.b = b

    def value(self, d):
        return torch.sum(logistic_ell(d, self.b))

    def value_f64(self, d):
        """A float64 sum of the working-precision elementwise ℓ (the
        counterpart of ``value_dd``)."""
        return torch.sum(logistic_ell(d, self.b).to(torch.float64))

    def grad(self, d):
        return logistic_grad(d, self.b)

    def fused_gradmap(self, op):
        return _pointwise_fused(op, self.b, "logistic")


class SquaredHinge(SmoothTerm):
    """SVM squared hinge  f(d) = ½ Σ max(0, 1 − y⊙d)²,
    ∇f(d) = −y⊙max(0, 1 − y⊙d);  labels y ∈ {−1, +1}."""

    def __init__(self, y: torch.Tensor):
        self.y = y

    def value(self, d):
        r = hinge_residual(d, self.y)
        return 0.5 * torch.sum(r * r)

    def value_f64(self, d):
        from .precision import dot64
        r = hinge_residual(d, self.y)
        return 0.5 * dot64(r, r)

    def grad(self, d):
        return -self.y * hinge_residual(d, self.y)

    def fused_gradmap(self, op):
        return _pointwise_fused(op, self.y, "squared_hinge")


class FunctionSmooth(SmoothTerm):
    """Wrap raw (f, gradf) callables — reference-style closures.
    ``gradf=None`` derives the gradient with ``torch.func.grad`` (the
    conjugate Wirtinger convention for complex measurement spaces)."""

    def __init__(self, f: Callable, gradf: Optional[Callable] = None):
        self.f = f
        if gradf is None:
            raw = torch.func.grad(lambda d: torch.real(f(d)))

            def gradf(d):
                out = raw(d)
                return torch.conj(out) if d.is_complex() else out
        self.gradf = gradf

    def value(self, d):
        return torch.as_tensor(self.f(d))

    def grad(self, d):
        return self.gradf(d)


# --------------------------------------------------------------------------
# Prox terms  g(x), prox_{t·g}(z)
# --------------------------------------------------------------------------

class ProxTerm:
    def value(self, x):
        raise NotImplementedError

    def prox(self, z, t):
        raise NotImplementedError


class L1Norm(ProxTerm):
    """g = μ‖·‖₁; prox = soft threshold (shrink)."""

    def __init__(self, mu: float = 1.0):
        self.mu = mu

    def value(self, x):
        return self.mu * torch.sum(torch.abs(x))

    def prox(self, z, t):
        return _prox.shrink(z, t * self.mu)


class NonnegIndicator(ProxTerm):
    """g = indicator{x ≥ 0}; prox = orthant projection (NNLS)."""

    def value(self, x):
        return torch.zeros((), dtype=torch.real(x).dtype, device=x.device)

    def prox(self, z, t):
        del t
        return _prox.project_nonneg(z)


class BoxIndicator(ProxTerm):
    """g = indicator{lo ≤ x ≤ hi}; prox = clamp (real)."""

    def __init__(self, lo: float = -1.0, hi: float = 1.0):
        self.lo = lo
        self.hi = hi

    def value(self, x):
        return torch.zeros((), dtype=torch.real(x).dtype, device=x.device)

    def prox(self, z, t):
        del t
        return _prox.project_box(z, self.lo, self.hi)


class L2Norm2(ProxTerm):
    """g = (λ/2)‖·‖² (ridge / Tikhonov); prox(z, t) = z/(1+tλ)."""

    def __init__(self, lam=1.0):
        self.lam = lam

    def value(self, x):
        return 0.5 * self.lam * torch.real(torch.vdot(x.reshape(-1),
                                                      x.reshape(-1)))

    def prox(self, z, t):
        return z / (1.0 + t * self.lam)


class FunctionProx(ProxTerm):
    """Wrap raw (g, proxg) callables — reference-style closures.  ``g``
    may be None (value 0)."""

    def __init__(self, g: Optional[Callable], proxg: Callable):
        self.g = g
        self.proxg = proxg

    def value(self, x):
        if self.g is None:
            return torch.zeros((), dtype=torch.real(x).dtype, device=x.device)
        return torch.as_tensor(self.g(x))

    def prox(self, z, t):
        return self.proxg(z, t)


def as_smooth_term(f, gradf=None) -> SmoothTerm:
    if isinstance(f, SmoothTerm):
        return f
    return FunctionSmooth(f, gradf)


def as_prox_term(g, proxg=None) -> ProxTerm:
    """A ``ProxTerm`` as itself, callables wrapped; (None, None) is g ≡ 0
    with the identity prox."""
    if isinstance(g, ProxTerm):
        return g
    if g is None and proxg is None:
        return FunctionProx(None, lambda z, t: z)
    return FunctionProx(g, proxg)
