"""Objective terms: smooth f(A·) and prox-friendly g(·) (port of
``fasta_tpu/terms.py:45-260, 330-439, 443-482, 543-625, 693-720, 777-838,
854-889``).

Smooth terms implement ``value(d)`` and ``grad(d)`` (evaluated at
d = A x); prox terms implement ``value(x)`` and ``prox(z, t)``.  Terms
are plain data holders over tensors.

Over a leading lane axis (the batch dimension of
``solver.make_batch_solver``, ``jax.vmap`` in the JAX package), smooth
terms give ``value_lanes``, ``value_f64_lanes`` and ``grad_lanes`` and
prox terms ``value_lanes`` and ``prox_lanes`` (one stepsize per lane), one
value per lane.  A term's one data tensor (``lane_field``: b, y, μ, λ or
c) is either shared by every lane or carries the lane axis itself.

The port has the terms of the dense problems (LASSO, NNLS, sparse
logistic regression, SVM), of TV denoising (``LeastSquares`` over a 2-D
image, ``BoxIndicator``) and of phase retrieval (``PhaseHinge`` and
``LinearAnchor``, and their planar forms); the other terms come with
their problems (ROADMAP Queue A item 7).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import prox as _prox
from .precision import lane, lane_dot64, lane_sum

__all__ = [
    "SmoothTerm", "LeastSquares", "Logistic", "SquaredHinge", "PhaseHinge",
    "PlanarPhaseHinge", "FunctionSmooth", "ProxTerm", "L1Norm",
    "NonnegIndicator", "BoxIndicator", "L2Norm2", "LinearAnchor",
    "PlanarLinearAnchor", "FunctionProx", "as_smooth_term", "as_prox_term",
    "logistic_ell", "logistic_grad", "hinge_residual", "phase_hinge_parts",
]


# --------------------------------------------------------------------------
# Smooth terms  f(d), ∇f(d)
# --------------------------------------------------------------------------

class SmoothTerm:
    # ∇f affine in d: the FISTA loop then extrapolates the gradient map
    # instead of evaluating it (fasta_tpu/solver.py:250-251)
    grad_affine = False
    # the attribute holding the term's one data tensor (None: no data)
    lane_field: Optional[str] = None

    def value(self, d):
        """f(d): one lane of ``value_lanes``."""
        return self.value_lanes(d[None])[0]

    def value_f64(self, d):
        """f(d) as a float64 scalar — the solver's high-precision decision
        value: one lane of ``value_f64_lanes``."""
        return self.value_f64_lanes(d[None])[0]

    def grad(self, d):
        raise NotImplementedError

    def value_lanes(self, d):
        """f of each lane of d (B, ...), shape (B,)."""
        raise NotImplementedError

    def value_f64_lanes(self, d):
        """f per lane in float64.  Default: exact lift of the plain value
        (no extra precision); terms whose value is a large reduction
        override it with a float64 accumulation."""
        return self.value_lanes(d).to(torch.float64)

    def grad_lanes(self, d):
        """∇f of each lane; the data terms' elementwise gradients take
        the lane axis by broadcasting."""
        return self.grad(d)

    def fused_gradmap(self, op):
        """Optional fused evaluation  x ↦ (d, f(d), Aᴴ∇f(d))  in one
        operator pass.  Return None when no fusion applies (the solver
        then uses the two-call path)."""
        del op
        return None


class LeastSquares(SmoothTerm):
    """f(d) = ½‖d − b‖²  (complex-safe Hermitian norm)."""

    grad_affine = True
    lane_field = "b"

    def __init__(self, b: torch.Tensor):
        self.b = b

    def value_lanes(self, d):
        r = d - self.b
        return 0.5 * lane_sum(torch.real(torch.conj(r) * r))

    def value_f64_lanes(self, d):
        r = d - self.b
        return 0.5 * lane_dot64(r, r)

    def grad(self, d):
        return d - self.b

    def fused_gradmap(self, op):
        """One-pass (Ax, ½‖Ax−b‖², Aᴴ(Ax−b)) for a dense real operator.

        A float32 matrix of any shape takes kernel K-B3
        (``fused_lstsq_gradmap``: the CUDA kernel for a CUDA tensor, its
        plain version for a CPU tensor).  Any other dtype takes the plain
        two-pass form, as the JAX package's f32/bf16 dtype rule does
        (``lstsq_fused.py:144-145``).  A ``LowPrecDenseOp`` takes the
        kernel's bfloat16 form past the reference's 64 MB gate, else the
        two-call path (:func:`_lowprec_fused`).

        The TV dual's ``ScaledOp(μ, TVDiv2D())`` over a 2-D image takes
        kernel K-B5 (``fused_tv_gradmap``) for a float32 image and its
        plain version otherwise (``fasta_tpu/terms.py:146-155``, without
        the JAX package's Pallas and TPU gates).

        A float32 or bfloat16 ``PlanarDenseOp`` with planar measurements
        b (m, 2) takes kernel K-B7's least-squares form
        (``fused_planar_lstsq_gradmap``, ``fasta_tpu/terms.py:156-170``,
        without the JAX package's 64 MB streaming gate: over bfloat16
        channels both of its paths upcast the matrix and keep x in
        float32, so the kernel computes the two-call path's function);
        other dtypes take the two-call path, as in the JAX package."""
        from .operators import DenseOp, PlanarDenseOp, ScaledOp, TVDiv2D
        if isinstance(op, PlanarDenseOp):
            b = self.b
            if (op.Ar.ndim != 2 or op.Ar.dtype not in _PLANAR_FUSED
                    or b.ndim != 2 or b.shape[-1] != 2):
                return None
            from .kernels.planar_fused import fused_planar_lstsq_gradmap
            return lambda x: fused_planar_lstsq_gradmap(op.Ar, op.Ai, x, b)
        if (isinstance(op, ScaledOp) and isinstance(op.op, TVDiv2D)
                and self.b.ndim == 2):
            from .kernels.tv_fused import (fused_tv_gradmap,
                                           tv_gradmap_reference)
            b, mu = self.b, float(op.c)
            if b.dtype == torch.float32:
                return lambda p: fused_tv_gradmap(p, b, mu)
            return lambda p: tv_gradmap_reference(p, b, mu)
        fused = _lowprec_fused(op, self.b, "lstsq")
        if fused is not None or not isinstance(op, DenseOp):
            return fused
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


# The channel types K-B7 takes
_PLANAR_FUSED = (torch.float32, torch.bfloat16)

# The reference's streaming gate (``fasta_tpu/kernels/lstsq_fused.py:125,
# 138``) over the stored bytes of a LowPrecDenseOp.  It is kept because it
# chooses the function, not for speed: the kernel keeps x in float32,
# while the two-call path rounds x to the storage type (the reference's
# LowPrecDenseOp product).  Below the gate the port computes what the
# reference computes there.  No H100 measurement set it.
_STREAMING_BYTES = 64 << 20


def _lowprec_fused(op, data, loss):
    """The one-read gradient map of ``loss`` ("lstsq", "logistic" or
    "squared_hinge") over a ``LowPrecDenseOp``: kernel K-B3 or K-B3p in
    its bfloat16 form when the storage is bfloat16 and the stored bytes
    pass the 64 MB gate, else None (the two-call path through the
    operator, x rounded to the storage type).  A float16 operator always
    takes None: the reference's kernel takes bfloat16 only.  None too for
    any other operator."""
    from .operators import LowPrecDenseOp
    if not isinstance(op, LowPrecDenseOp):
        return None
    A = op.A
    if (A.ndim != 2 or A.dtype != torch.bfloat16 or data.ndim != 1
            or A.numel() * A.element_size() <= _STREAMING_BYTES):
        return None
    from .kernels.lstsq_fused import (fused_lstsq_gradmap,
                                      fused_pointwise_gradmap)
    if loss == "lstsq":
        return lambda x: fused_lstsq_gradmap(A, x, data)
    return lambda x: fused_pointwise_gradmap(A, x, data, loss)


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
    kernel for a CUDA tensor and its plain version for a CPU tensor; over
    a ``LowPrecDenseOp``, as :func:`_lowprec_fused` says
    (``fasta_tpu/terms.py:272-289``).  Other operators and dtypes take the
    two-call path (None), as the JAX package's dtype rule does."""
    from .operators import DenseOp
    if not isinstance(op, DenseOp):
        return _lowprec_fused(op, data, loss)
    A = op.A
    if (A.ndim != 2 or A.dtype != torch.float32 or data.ndim != 1):
        return None
    from .kernels.lstsq_fused import fused_pointwise_gradmap
    return lambda x: fused_pointwise_gradmap(A, x, data, loss)


class Logistic(SmoothTerm):
    """Logistic loss  Σ log(1+exp(d)) − bᵀd,  labels b ∈ {0,1}; stable
    evaluation as the oracle's (max(d,0) + log1p(exp(−|d|)))."""

    lane_field = "b"

    def __init__(self, b: torch.Tensor):
        self.b = b

    def value_lanes(self, d):
        return lane_sum(logistic_ell(d, self.b))

    def value_f64_lanes(self, d):
        """A float64 sum of the working-precision elementwise ℓ (the
        counterpart of ``value_dd``)."""
        return lane_sum(logistic_ell(d, self.b).to(torch.float64))

    def grad(self, d):
        return logistic_grad(d, self.b)

    def fused_gradmap(self, op):
        return _pointwise_fused(op, self.b, "logistic")


class SquaredHinge(SmoothTerm):
    """SVM squared hinge  f(d) = ½ Σ max(0, 1 − y⊙d)²,
    ∇f(d) = −y⊙max(0, 1 − y⊙d);  labels y ∈ {−1, +1}."""

    lane_field = "y"

    def __init__(self, y: torch.Tensor):
        self.y = y

    def value_lanes(self, d):
        r = hinge_residual(d, self.y)
        return 0.5 * lane_sum(r * r)

    def value_f64_lanes(self, d):
        r = hinge_residual(d, self.y)
        return 0.5 * lane_dot64(r, r)

    def grad(self, d):
        return -self.y * hinge_residual(d, self.y)

    def fused_gradmap(self, op):
        return _pointwise_fused(op, self.y, "squared_hinge")


def phase_hinge_parts(mag, b):
    """(r, s) of the PhaseMax hinge at magnitudes ``mag``: r = max(|d| − b,
    0), s = r / max(|d|, 1e-30); f = ½Σr², ∇f = s·d."""
    r = torch.clamp_min(mag - b, 0.0)
    return r, r / torch.clamp_min(mag, 1e-30)


class PhaseHinge(SmoothTerm):
    """Smooth circular hinge for PhaseMax phase retrieval:
    f(d) = ½ Σ max(|d|−b, 0)², Wirtinger gradient max(|d|−b,0)·d/|d|.
    No fused map: the JAX package fuses it only on its sharded operators
    (``fasta_tpu/terms.py:358-366``, ROADMAP Queue A item 13)."""

    lane_field = "b"

    def __init__(self, b: torch.Tensor):
        self.b = b

    def value_lanes(self, d):
        r, _ = phase_hinge_parts(torch.abs(d), self.b)
        return 0.5 * lane_sum(r * r)

    def value_f64_lanes(self, d):
        r, _ = phase_hinge_parts(torch.abs(d), self.b)
        return 0.5 * lane_dot64(r, r)

    def grad(self, d):
        _, s = phase_hinge_parts(torch.abs(d), self.b)
        return s * d


class PlanarPhaseHinge(SmoothTerm):
    """PhaseMax hinge on planar measurements d ∈ ℝ^{m×2}:
    |d| = √(dr² + di²) on the real channels, the gradient the Wirtinger
    gradient in planar layout — :class:`PhaseHinge`'s math, all real."""

    lane_field = "b"

    def __init__(self, b: torch.Tensor):
        self.b = b                      # (m,) magnitudes

    def _parts(self, d):
        return phase_hinge_parts(torch.sqrt(torch.sum(d * d, dim=-1)),
                                  self.b)

    def value_lanes(self, d):
        r, _ = self._parts(d)
        return 0.5 * lane_sum(r * r)

    def value_f64_lanes(self, d):
        r, _ = self._parts(d)
        return 0.5 * lane_dot64(r, r)

    def grad(self, d):
        _, s = self._parts(d)
        return s[..., None] * d

    def fused_gradmap(self, op):
        """K-B7's hinge form (``fused_planar_hinge_gradmap``) on a float32
        or bfloat16 ``PlanarDenseOp``: the CUDA kernel for CUDA tensors,
        its plain version for CPU tensors (``fasta_tpu/terms.py:418-432``,
        without the JAX package's 64 MB streaming gate, for the reason
        ``LeastSquares.fused_gradmap`` gives).  Other operators and dtypes
        take the two-call path (None)."""
        from .operators import PlanarDenseOp
        if (not isinstance(op, PlanarDenseOp) or op.Ar.ndim != 2
                or op.Ar.dtype not in _PLANAR_FUSED or self.b.ndim != 1):
            return None
        from .kernels.planar_fused import fused_planar_hinge_gradmap
        b = self.b
        return lambda x: fused_planar_hinge_gradmap(op.Ar, op.Ai, x, b)


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

    def value_lanes(self, d):
        return torch.stack([self.value(di) for di in d])

    def grad(self, d):
        return self.gradf(d)

    def grad_lanes(self, d):
        return torch.stack([self.gradf(di) for di in d])


# --------------------------------------------------------------------------
# Prox terms  g(x), prox_{t·g}(z)
# --------------------------------------------------------------------------

class ProxTerm:
    # the attribute holding the term's one data tensor (None: no data)
    lane_field: Optional[str] = None

    def value(self, x):
        raise NotImplementedError

    def prox(self, z, t):
        raise NotImplementedError

    def value_lanes(self, x):
        """g of each lane of x (B, ...), shape (B,); default one call per
        lane (terms without lane data)."""
        return torch.stack([self.value(xi) for xi in x])

    def prox_lanes(self, z, t):
        """The prox of each lane of z at the lane's stepsize t (B,);
        default one call per lane (terms without lane data)."""
        return torch.stack([self.prox(zi, ti) for zi, ti in zip(z, t)])


def _weight(w, t):
    """A weight as the lanes see it: a number as it is, a tensor (one per
    lane) in the stepsize's dtype and device."""
    return torch.as_tensor(w, dtype=t.dtype, device=t.device) \
        if torch.is_tensor(w) else w


class L1Norm(ProxTerm):
    """g = μ‖·‖₁; prox = soft threshold (shrink)."""

    lane_field = "mu"

    def __init__(self, mu: float = 1.0):
        self.mu = mu

    def value(self, x):
        return self.mu * torch.sum(torch.abs(x))

    def prox(self, z, t):
        return _prox.shrink(z, t * self.mu)

    def value_lanes(self, x):
        s = lane_sum(torch.abs(x))
        return _weight(self.mu, s) * s

    def prox_lanes(self, z, t):
        return _prox.shrink(z, lane(t * _weight(self.mu, t), z))


class NonnegIndicator(ProxTerm):
    """g = indicator{x ≥ 0}; prox = orthant projection (NNLS)."""

    def value(self, x):
        return torch.zeros((), dtype=torch.real(x).dtype, device=x.device)

    def prox(self, z, t):
        del t
        return _prox.project_nonneg(z)

    def value_lanes(self, x):
        return torch.zeros(x.shape[0], dtype=torch.real(x).dtype,
                           device=x.device)

    def prox_lanes(self, z, t):
        return self.prox(z, t)


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

    def value_lanes(self, x):
        return torch.zeros(x.shape[0], dtype=torch.real(x).dtype,
                           device=x.device)

    def prox_lanes(self, z, t):
        return self.prox(z, t)


class L2Norm2(ProxTerm):
    """g = (λ/2)‖·‖² (ridge / Tikhonov); prox(z, t) = z/(1+tλ)."""

    lane_field = "lam"

    def __init__(self, lam=1.0):
        self.lam = lam

    def value(self, x):
        return 0.5 * self.lam * torch.real(torch.vdot(x.reshape(-1),
                                                      x.reshape(-1)))

    def prox(self, z, t):
        return z / (1.0 + t * self.lam)

    def value_lanes(self, x):
        sq = torch.stack([torch.real(torch.vdot(v, v))
                          for v in x.reshape(x.shape[0], -1)])
        return 0.5 * _weight(self.lam, sq) * sq

    def prox_lanes(self, z, t):
        return z / (1.0 + lane(t * _weight(self.lam, t), z))


class LinearAnchor(ProxTerm):
    """g(x) = −Re⟨c, x⟩ (the PhaseMax anchor); prox(z, t) = z + t·c."""

    lane_field = "c"

    def __init__(self, c: torch.Tensor):
        self.c = c

    def value(self, x):
        return -torch.real(torch.vdot(self.c.reshape(-1), x.reshape(-1)))

    def prox(self, z, t):
        return z + t * self.c

    def value_lanes(self, x):
        return torch.stack([LinearAnchor(ci).value(xi)
                            for ci, xi in zip(self.c.expand_as(x), x)])

    def prox_lanes(self, z, t):
        return z + lane(t, z) * self.c


class PlanarLinearAnchor(ProxTerm):
    """g(x) = −⟨c, x⟩ on planar vectors (−Re⟨c, x⟩ on ℂ);
    prox(z, t) = z + t·c.  c ∈ ℝ^{n×2}."""

    lane_field = "c"

    def __init__(self, c: torch.Tensor):
        self.c = c

    def value(self, x):
        return -torch.sum(self.c * x)

    def prox(self, z, t):
        return z + t * self.c

    def value_lanes(self, x):
        return -lane_sum(self.c * x)

    def prox_lanes(self, z, t):
        return z + lane(t, z) * self.c


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
