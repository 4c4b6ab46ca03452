"""Linear operators (port of ``fasta_tpu/operators.py:47-132, 215-264,
301-343, 391-410, 464-544``).

The dense problems need the explicit matrix: ``LinearOp``, ``AdjointOp``,
``DenseOp``, ``as_linear_op`` and ``check_adjoint``; TV denoising needs
the stencil pair ``TVGrad2D`` / ``TVDiv2D`` and ``ScaledOp``; planar
phase retrieval needs ``PlanarDenseOp``.  The other operators (identity,
closures, FFTs, sparse) come with their problems (ROADMAP Queue A item
2).  Operators are plain data holders; their tensors stay on whatever
device the caller put them.  ``lanes`` and ``rmatvec_lanes`` apply an
operator to every lane of a leading lane axis (the batch dimension of
``solver.make_batch_solver``; ``jax.vmap`` in the JAX package): one call
per lane by default, one batched call where the operator has one.

All adjoints are conjugate transposes, so complex data is handled
exactly.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .precision import real_dtype

__all__ = ["LinearOp", "AdjointOp", "DenseOp", "PlanarDenseOp", "TVGrad2D",
           "TVDiv2D", "ScaledOp", "tv_grad_2d", "tv_div_2d", "as_linear_op",
           "check_adjoint", "default_device"]


class LinearOp:
    """Abstract linear operator: ``y = op(x)``, adjoint ``op.rmatvec(y)``."""

    def __call__(self, x):
        raise NotImplementedError

    def rmatvec(self, y):
        """Apply the conjugate-transpose (adjoint) operator."""
        raise NotImplementedError

    def lanes(self, x):
        """The operator on each lane of ``x`` (B, ...), stacked."""
        return torch.stack([self(xi) for xi in x])

    def rmatvec_lanes(self, y):
        """The adjoint on each lane of ``y`` (B, ...), stacked."""
        return torch.stack([self.rmatvec(yi) for yi in y])

    @property
    def H(self) -> "LinearOp":
        """The adjoint as a first-class operator."""
        return AdjointOp(self)


class AdjointOp(LinearOp):
    def __init__(self, base: LinearOp):
        self.base = base

    def __call__(self, x):
        return self.base.rmatvec(x)

    def rmatvec(self, y):
        return self.base(y)

    def lanes(self, x):
        return self.base.rmatvec_lanes(x)

    def rmatvec_lanes(self, y):
        return self.base.lanes(y)

    @property
    def H(self):
        return self.base


class DenseOp(LinearOp):
    """Explicit dense matrix A ∈ 𝔽^{m×n}.  Matvecs are ``torch.matmul``
    (the JAX package leaves them to XLA outside Pallas too); the fused
    least-squares pass over the same matrix is kernel K-B3
    (``LeastSquares.fused_gradmap``).  A float32 product on the card runs
    in full float32 unless the caller enables TF32."""

    def __init__(self, A: torch.Tensor):
        self.A = A

    def __call__(self, x):
        return torch.matmul(self.A, x)

    def rmatvec(self, y):
        return torch.matmul(self.A.mH, y)

    def lanes(self, x):
        """Vector lanes (B, n) as one product X·Aᵀ (one lane: A x, the
        single solve's product)."""
        if x.shape[0] == 1 or x.ndim != 2:
            return super().lanes(x)
        return torch.matmul(x, self.A.mT)

    def rmatvec_lanes(self, y):
        """Vector lanes (B, m) as one product Y·Ā (one lane: Aᴴ y)."""
        if y.shape[0] == 1 or y.ndim != 2:
            return super().rmatvec_lanes(y)
        return torch.matmul(y, self.A.conj())

    @property
    def shape(self):
        return tuple(self.A.shape)


class PlanarDenseOp(LinearOp):
    """Complex dense operator A = Ar + i·Ai in planar layout: two real
    channel matrices (m, n), vectors with real and imaginary parts on a
    trailing axis of 2, x ∈ ℝ^{n×2} ↦ d ∈ ℝ^{m×2}:

        d = [Ar xr − Ai xi,  Ar xi + Ai xr]
        Aᴴ y = [Arᵀyr + Aiᵀyi,  Arᵀyi − Aiᵀyr]

    Each application is two (m,n)·(n,2) products through ``torch.matmul``
    (the JAX package leaves them to XLA at ``Precision.HIGHEST``; a
    float32 product on the card runs in full float32 unless the caller
    enables TF32).  The real dot of two planar vectors is Re⟨·,·⟩ of the
    complex ones, so the real solver drives complex problems unchanged.
    The fused gradient map over the same matrices is kernel K-B7."""

    def __init__(self, Ar: torch.Tensor, Ai: torch.Tensor):
        self.Ar = Ar
        self.Ai = Ai

    @classmethod
    def from_complex(cls, A, dtype: torch.dtype = torch.float32, *,
                     device) -> "PlanarDenseOp":
        """The channels of a complex NumPy matrix as ``dtype`` tensors on
        ``device``."""
        A = np.asarray(A)
        return cls(torch.tensor(A.real, dtype=dtype, device=device),
                   torch.tensor(A.imag, dtype=dtype, device=device))

    def __call__(self, x):
        p = torch.matmul(self.Ar, x)
        q = torch.matmul(self.Ai, x)
        return torch.stack([p[..., 0] - q[..., 1], p[..., 1] + q[..., 0]],
                           dim=-1)

    def rmatvec(self, y):
        p = torch.matmul(self.Ar.mT, y)
        q = torch.matmul(self.Ai.mT, y)
        return torch.stack([p[..., 0] + q[..., 1], p[..., 1] - q[..., 0]],
                           dim=-1)

    def lanes(self, x):
        """Lanes (B, n, 2) in two batched products (one lane: the single
        solve's products)."""
        return super().lanes(x) if x.shape[0] == 1 else self(x)

    def rmatvec_lanes(self, y):
        return super().rmatvec_lanes(y) if y.shape[0] == 1 else self.rmatvec(y)

    @property
    def shape(self):
        return tuple(self.Ar.shape)


def tv_grad_2d(x: torch.Tensor) -> torch.Tensor:
    """2-D forward differences (..., H, W) → (..., 2, H, W): channel 0
    vertical, channel 1 horizontal, the last row / column of each channel
    zero (``reference_oracle.generators.tv_grad_2d``); leading axes are
    lanes."""
    zrow = torch.zeros_like(x[..., :1, :])
    zcol = torch.zeros_like(x[..., :, :1])
    dv = torch.cat([x[..., 1:, :] - x[..., :-1, :], zrow], dim=-2)
    dh = torch.cat([x[..., :, 1:] - x[..., :, :-1], zcol], dim=-1)
    return torch.stack([dv, dh], dim=-3)


def tv_div_2d(p: torch.Tensor) -> torch.Tensor:
    """The adjoint of :func:`tv_grad_2d`, (..., 2, H, W) → (..., H, W)
    (minus the divergence), in the JAX package's order of operations: the
    vertical difference plus the horizontal one (``generators.tv_div_2d``)."""
    pv, ph = p[..., 0, :, :], p[..., 1, :, :]
    zrow = torch.zeros_like(pv[..., :1, :])
    zcol = torch.zeros_like(ph[..., :, :1])
    out = (torch.cat([zrow, pv[..., :-1, :]], dim=-2)
           - torch.cat([pv[..., :-1, :], zrow], dim=-2))
    return out + (torch.cat([zcol, ph[..., :, :-1]], dim=-1)
                  - torch.cat([ph[..., :, :-1], zcol], dim=-1))


class TVGrad2D(LinearOp):
    """2-D discrete gradient (forward differences, Neumann boundary),
    (H, W) → (2, H, W); adjoint :class:`TVDiv2D`."""

    def __call__(self, x):
        return tv_grad_2d(x)

    def rmatvec(self, p):
        return tv_div_2d(p)

    lanes, rmatvec_lanes = __call__, rmatvec      # leading axes are lanes


class TVDiv2D(LinearOp):
    """Adjoint of :class:`TVGrad2D`, (2, H, W) → (H, W) (equals minus the
    divergence)."""

    def __call__(self, p):
        return tv_div_2d(p)

    def rmatvec(self, y):
        return tv_grad_2d(y)

    lanes, rmatvec_lanes = __call__, rmatvec      # leading axes are lanes


class ScaledOp(LinearOp):
    """c · op with a real scalar c (so the adjoint is c · opᴴ)."""

    def __init__(self, c: float, op: LinearOp):
        self.c = c
        self.op = op

    def __call__(self, x):
        return self.c * self.op(x)

    def rmatvec(self, y):
        return self.c * self.op.rmatvec(y)

    def lanes(self, x):
        return self.c * self.op.lanes(x)

    def rmatvec_lanes(self, y):
        return self.c * self.op.rmatvec_lanes(y)


def default_device(device, what: str) -> torch.device:
    """The device an entry point places data that carries none on:
    ``device``, or the card when None.  With no card present the default
    raises rather than fall back to the CPU; callers pass ``device="cpu"``
    for that."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}: the default device is 'cuda' and no CUDA device is "
            f"available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def as_linear_op(A: Any, At: Any = None, device=None) -> LinearOp:
    """Normalize an operator argument: a tensor becomes a ``DenseOp`` on
    the tensor's own device, a NumPy matrix a ``DenseOp`` on ``device``
    (the card when None: see :func:`default_device`), a ``LinearOp``
    itself.  ``At`` must be None for those forms."""
    if isinstance(A, LinearOp):
        return A
    if isinstance(A, (torch.Tensor, np.ndarray)):
        if At is not None:
            raise ValueError("an explicit matrix takes no separate adjoint")
        if isinstance(A, np.ndarray):
            return DenseOp(torch.as_tensor(
                A, device=default_device(device, "as_linear_op")))
        return DenseOp(A)
    raise NotImplementedError(
        f"operator type {type(A).__name__} is not ported yet: identity, "
        f"closure-pair and structured operators are ROADMAP Queue A "
        f"item 2")


def check_adjoint(op: LinearOp, x_like: torch.Tensor,
                  generator: torch.Generator, rtol: float = 1e-4,
                  n_trials: int = 2) -> float:
    """Verify ⟨Ax, y⟩ = ⟨x, Aᴴy⟩ on random vectors drawn from
    ``generator`` (which must live on ``x_like``'s device).  Returns the
    max relative error; raises if it exceeds ``rtol``."""
    d_like = op(x_like)
    worst = 0.0
    for _ in range(n_trials):
        x = randn_like(x_like, generator)
        y = randn_like(d_like, generator)
        lhs = complex(torch.vdot(y.reshape(-1), op(x).reshape(-1)))
        rhs = complex(torch.vdot(op.rmatvec(y).reshape(-1), x.reshape(-1)))
        scale = max(abs(lhs), abs(rhs), 1e-30)
        worst = max(worst, abs(lhs - rhs) / scale)
    if worst > rtol:
        raise ValueError(
            f"adjoint check failed: rel err {worst:.3e} > {rtol:.1e}")
    return worst


def randn_like(v: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Standard normal draws shaped and typed like ``v`` (real and
    imaginary parts both standard normal for complex ``v``), from
    ``generator`` on ``v``'s device."""
    real = torch.randn(v.shape, generator=generator, device=v.device,
                       dtype=real_dtype(v.dtype))
    if v.is_complex():
        imag = torch.randn(v.shape, generator=generator, device=v.device,
                           dtype=real.dtype)
        return torch.complex(real, imag).to(v.dtype)
    return real.to(v.dtype)
