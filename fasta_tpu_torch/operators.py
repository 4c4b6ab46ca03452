"""Linear operators (port of ``fasta_tpu/operators.py``; the row-sharded
operators are in ``sharding.py``).

``LinearOp``, ``AdjointOp``, ``DenseOp`` (the explicit matrix),
``SparseOp`` (torch sparse CSR), ``LowPrecDenseOp`` (bfloat16 storage),
``PlanarDenseOp`` (float32 or bfloat16 channels), ``IdentityOp``,
``FunctionOp`` (a closure pair), the TV stencil pair ``TVGrad2D`` /
``TVDiv2D``, ``MaskedFourierOp`` (a unitary FFT), ``DiagonalOp``,
``ScaledOp``, ``ComposeOp`` and ``StackedOp``, with ``as_linear_op`` and
``check_adjoint``.  Operators are plain data holders; their tensors stay
on whatever device the caller put them.  ``lanes`` and ``rmatvec_lanes``
apply an operator to every lane of a leading lane axis (the batch
dimension of ``solver.make_batch_solver``; ``jax.vmap`` in the JAX
package): one call per lane by default, one batched call where the
operator has one.

All adjoints are conjugate transposes, so complex data is handled
exactly.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from .precision import real_dtype
from .profiling import span

__all__ = ["LinearOp", "AdjointOp", "DenseOp", "SparseOp",
           "LowPrecDenseOp", "PlanarDenseOp", "IdentityOp", "FunctionOp",
           "TVGrad2D", "TVDiv2D", "MaskedFourierOp", "DiagonalOp",
           "ScaledOp", "ComposeOp", "StackedOp", "tv_grad_2d", "tv_div_2d",
           "as_linear_op", "check_adjoint", "default_device"]


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

    # Measurement-space hooks of ``check_adjoint``.  A row-sharded operator
    # (``sharding.py``) holds this rank's rows of d = A x and overrides
    # both; an operator that holds every row keeps these.

    def measurement_draw(self, d, generator: torch.Generator):
        """Standard normal draws for the measurement vector ``d``."""
        return randn_like(d, generator)

    def measurement_sum(self, s):
        """A sum over ``d``'s entries completed over the measurement space:
        ``s`` itself here."""
        return s

    # Signal-space hooks of the solver, ``estimate_stepsize`` and
    # ``check_adjoint``.  An operator whose rank holds a block of x (the
    # x-sharded layouts of ``sharding.py``) overrides both; an operator
    # whose rank holds all of x keeps these, which stack, cast and launch
    # nothing.

    def signal_draw(self, x, generator: torch.Generator):
        """Standard normal draws for the signal ``x``."""
        return randn_like(x, generator)

    def signal_sum(self, *parts):
        """Sums over x's entries (per-lane partial sums on a rank that
        holds a block of x) completed over the ranks that share x's
        split, as a tuple: ``parts`` themselves here."""
        return parts

    def gather_lanes(self, result):
        """``solver.make_batch_solver``'s result over this operator's lanes
        as the caller sees it: ``result`` itself here.  An operator whose
        rank holds a block of the lanes (``sharding``'s lane layouts)
        gathers every rank's lanes."""
        return result


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


def _promoted(A: torch.Tensor, x: torch.Tensor):
    """A and x in their common type, as ``jnp.matmul`` promotes mixed
    operands (a bfloat16 matrix times a float32 vector is a float32
    product); ``torch.matmul`` itself refuses mixed types."""
    dt = torch.promote_types(A.dtype, x.dtype)
    return A.to(dt), x.to(dt)


def _stacked_matmul(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Lane i of ``x`` (B, n) or (B, n, l) times matrix i of ``A``
    (B, m, n): one batched ``torch.matmul``."""
    A, x = _promoted(A, x)
    if x.ndim == 2:
        return torch.matmul(A, x[..., None])[..., 0]
    return torch.matmul(A, x)


class DenseOp(LinearOp):
    """Explicit dense matrix A ∈ 𝔽^{m×n}.  Matvecs are ``torch.matmul``
    (the JAX package leaves them to XLA outside Pallas too) in the type
    the two operands promote to; the fused least-squares pass over the
    same matrix is kernel K-B3 (``LeastSquares.fused_gradmap``).  A
    float32 product on the card runs in full float32 unless the caller
    enables TF32."""

    # the matrix that make_batch_solver's batched operator stacks, one a
    # lane: A (B, m, n)
    lane_fields = ("A",)

    def __init__(self, A: torch.Tensor):
        self.A = A

    def __call__(self, x):
        return torch.matmul(*_promoted(self.A, x))

    def rmatvec(self, y):
        return torch.matmul(*_promoted(self.A.mH, y))

    def lanes(self, x):
        """Vector lanes (B, n) as one product X·Aᵀ (one lane: A x, the
        single solve's product); with a stack of matrices (B, m, n), lane
        i's product through matrix i."""
        if self.A.ndim == 3:
            return _stacked_matmul(self.A, x)
        if x.shape[0] == 1 or x.ndim != 2:
            return super().lanes(x)
        A, x = _promoted(self.A, x)
        return torch.matmul(x, A.mT)

    def rmatvec_lanes(self, y):
        """Vector lanes (B, m) as one product Y·Ā (one lane: Aᴴ y)."""
        if self.A.ndim == 3:
            return _stacked_matmul(self.A.mH, y)
        if y.shape[0] == 1 or y.ndim != 2:
            return super().rmatvec_lanes(y)
        A, y = _promoted(self.A, y)
        return torch.matmul(y, A.conj())

    @property
    def shape(self):
        return tuple(self.A.shape)


class SparseOp(LinearOp):
    """Sparse matrix M ∈ 𝔽^{m×n} as a torch sparse CSR tensor, with its
    adjoint Mᴴ stored once as a second CSR tensor (port of
    ``fasta_tpu/operators.py:133-170``, whose BCOO transposes on every
    adjoint).  Products are ``torch`` sparse × dense (cuSPARSE on the
    card) in the type the two operands promote to; they sum in another
    order than BCOO's, so they agree with the JAX operator to rounding.
    A lane axis is one product with an (n, B) right side."""

    def __init__(self, M: torch.Tensor, Mh: torch.Tensor):
        self.M = M
        self.Mh = Mh

    @classmethod
    def from_scipy(cls, sp_matrix, dtype: Optional[torch.dtype] = None, *,
                   device=None) -> "SparseOp":
        """The scipy sparse matrix as ``dtype`` CSR tensors (scipy's own
        type when None) on ``device`` (the card when None: see
        :func:`default_device`); the adjoint from ``M.T.tocsr()``,
        conjugated for complex data."""
        device = default_device(device, "SparseOp.from_scipy")
        M = sp_matrix.tocsr()
        Mh = M.T.tocsr()
        if np.iscomplexobj(M.data):
            Mh = Mh.conj()
        return cls(_csr(M, dtype, device), _csr(Mh, dtype, device))

    @staticmethod
    def _apply(M, x):
        dt = torch.promote_types(M.dtype, x.dtype)
        M = M if M.dtype == dt else M.to(dt)
        return torch.matmul(M, x.to(dt))

    def __call__(self, x):
        return self._apply(self.M, x)

    def rmatvec(self, y):
        return self._apply(self.Mh, y)

    def lanes(self, x):
        """Vector lanes (B, n) as one product M·Xᵀ (one lane: M x)."""
        if x.shape[0] == 1 or x.ndim != 2:
            return super().lanes(x)
        return self._apply(self.M, x.mT).mT

    def rmatvec_lanes(self, y):
        if y.shape[0] == 1 or y.ndim != 2:
            return super().rmatvec_lanes(y)
        return self._apply(self.Mh, y.mT).mT

    @property
    def shape(self):
        return tuple(self.M.shape)


def _csr(M, dtype, device) -> torch.Tensor:
    """A scipy CSR matrix as a torch sparse CSR tensor."""
    values = torch.as_tensor(M.data)
    return torch.sparse_csr_tensor(
        torch.as_tensor(M.indptr, dtype=torch.int64),
        torch.as_tensor(M.indices, dtype=torch.int64),
        values if dtype is None else values.to(dtype),
        size=M.shape, device=device, check_invariants=True)


class LowPrecDenseOp(LinearOp):
    """Dense real matrix stored in a low-precision type (bfloat16 by
    default) with float32 accumulation: the mixed-precision path of
    ``fasta_tpu/operators.py:170-212``.

    The product is the JAX one, ``dot_general(A, x.astype(A.dtype),
    preferred_element_type=float32)``: the vector is rounded to the
    storage type, each product of two bfloat16 values is exact in
    float32, and the sums run in float32.  Here both operands are upcast
    to float32 for ``torch.matmul`` (a bfloat16 product would round its
    result to bfloat16, and a mixed one raises); outputs are float32.
    The intended workflow solves at this precision to a loose tolerance
    and then warm-restarts the float32 problem from the result
    (``checkpoint.resume``).  The one-read gradient maps over a bfloat16
    matrix are kernels K-B3 and K-B3p (``terms.py``: past the reference's
    64 MB gate).

    Not a ``DenseOp``, as in JAX: the whole-solve kernels do not take it
    (``micro._dispatch``)."""

    def __init__(self, A: torch.Tensor):
        self.A = A                     # already in the storage type

    @classmethod
    def from_dense(cls, A, storage_dtype: torch.dtype = torch.bfloat16, *,
                   device=None) -> "LowPrecDenseOp":
        """A tensor or NumPy matrix in ``storage_dtype``: a tensor on its
        own device unless ``device`` is given, a NumPy matrix on
        ``device`` (the card when None: see :func:`default_device`)."""
        if not isinstance(A, torch.Tensor):
            device = default_device(device, "LowPrecDenseOp.from_dense")
            A = torch.as_tensor(np.asarray(A))
        return cls(A.to(device=device, dtype=storage_dtype))

    @property
    def stored_bytes(self) -> int:
        """The stored matrix's bytes, which the 64 MB gate of the one-read
        gradient maps judges (``terms._lowprec_fused``); a rank's rows of
        a row-sharded matrix answer for the whole matrix."""
        return self.A.numel() * self.A.element_size()

    def _rounded(self, v):
        """``v`` rounded to the storage type, as float32."""
        return v.to(self.A.dtype).to(torch.float32)

    def __call__(self, x):
        return torch.matmul(self.A.to(torch.float32), self._rounded(x))

    def rmatvec(self, y):
        return torch.matmul(self.A.to(torch.float32).mT, self._rounded(y))

    def lanes(self, x):
        """Vector lanes (B, n) as one product X·Aᵀ (one lane: A x)."""
        if x.shape[0] == 1 or x.ndim != 2:
            return super().lanes(x)
        return torch.matmul(self._rounded(x), self.A.to(torch.float32).mT)

    def rmatvec_lanes(self, y):
        """Vector lanes (B, m) as one product Y·A (one lane: Aᵀ y)."""
        if y.shape[0] == 1 or y.ndim != 2:
            return super().rmatvec_lanes(y)
        return torch.matmul(self._rounded(y), self.A.to(torch.float32))

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
    in the promoted type (the JAX package leaves them to XLA at
    ``Precision.HIGHEST``; a float32 product on the card runs in full
    float32 unless the caller enables TF32): bfloat16 channels are upcast
    and the vector stays float32, as ``jnp.matmul`` promotes them.  The real dot of two planar vectors is Re⟨·,·⟩ of the
    complex ones, so the real solver drives complex problems unchanged.
    The fused gradient map over the same matrices is kernel K-B7."""

    # the channels that make_batch_solver's batched operator stacks, one
    # pair a lane: Ar, Ai (B, m, n)
    lane_fields = ("Ar", "Ai")

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
        p = torch.matmul(*_promoted(self.Ar, x))
        q = torch.matmul(*_promoted(self.Ai, x))
        return torch.stack([p[..., 0] - q[..., 1], p[..., 1] + q[..., 0]],
                           dim=-1)

    def rmatvec(self, y):
        p = torch.matmul(*_promoted(self.Ar.mT, y))
        q = torch.matmul(*_promoted(self.Ai.mT, y))
        return torch.stack([p[..., 0] + q[..., 1], p[..., 1] - q[..., 0]],
                           dim=-1)

    def lanes(self, x):
        """Lanes (B, n, 2) in two batched products (one lane: the single
        solve's products); stacked channels (B, m, n) take lane i through
        pair i.  The call is the span ``fasta.op.planar.forward``."""
        with span("fasta.op.planar.forward"):
            if x.shape[0] == 1 and self.Ar.ndim == 2:
                return super().lanes(x)
            return self(x)

    def rmatvec_lanes(self, y):
        """The adjoint over lanes (B, m, 2), as ``lanes``; the span
        ``fasta.op.planar.adjoint``."""
        with span("fasta.op.planar.adjoint"):
            if y.shape[0] == 1 and self.Ar.ndim == 2:
                return super().rmatvec_lanes(y)
            return self.rmatvec(y)

    @property
    def shape(self):
        return tuple(self.Ar.shape)


class IdentityOp(LinearOp):
    """The identity, the operator of a problem with no explicit A
    (``fasta_tpu/operators.py:268``)."""

    def __call__(self, x):
        return x

    def rmatvec(self, y):
        return y

    lanes, rmatvec_lanes = __call__, rmatvec


class FunctionOp(LinearOp):
    """An arbitrary (forward, adjoint) closure pair, the reference's
    function-operator mode (``fasta_tpu/operators.py:277``).  Lanes take
    one call each."""

    def __init__(self, fwd: Callable, adj: Callable):
        self.fwd = fwd
        self.adj = adj

    def __call__(self, x):
        return self.fwd(x)

    def rmatvec(self, y):
        return self.adj(y)


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


class MaskedFourierOp(LinearOp):
    """Subsampled unitary FFT y = mask ⊙ FFT(x)/√n over the last axis, the
    adjoint IFFT(conj(mask) ⊙ y)·√n (``torch.fft`` with ``norm="ortho"``,
    cuFFT on the card; ``fasta_tpu/operators.py:346``).  Leading axes are
    lanes."""

    def __init__(self, mask: torch.Tensor):
        self.mask = mask

    def __call__(self, x):
        return self.mask * torch.fft.fft(x, norm="ortho")

    def rmatvec(self, y):
        return torch.fft.ifft(torch.conj(self.mask) * y, norm="ortho")

    lanes, rmatvec_lanes = __call__, rmatvec


class DiagonalOp(LinearOp):
    """Elementwise scaling by d, the adjoint by conj(d)
    (``fasta_tpu/operators.py:373``).  Leading axes are lanes."""

    def __init__(self, d: torch.Tensor):
        self.d = d

    def __call__(self, x):
        return self.d * x

    def rmatvec(self, y):
        return torch.conj(self.d) * y

    lanes, rmatvec_lanes = __call__, rmatvec


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


class ComposeOp(LinearOp):
    """outer ∘ inner: x ↦ outer(inner(x)) (``fasta_tpu/operators.py:414``)."""

    def __init__(self, outer: LinearOp, inner: LinearOp):
        self.outer = outer
        self.inner = inner

    def __call__(self, x):
        return self.outer(self.inner(x))

    def rmatvec(self, y):
        return self.inner.rmatvec(self.outer.rmatvec(y))

    def lanes(self, x):
        return self.outer.lanes(self.inner.lanes(x))

    def rmatvec_lanes(self, y):
        return self.inner.rmatvec_lanes(self.outer.rmatvec_lanes(y))


class StackedOp(LinearOp):
    """Vertical stack x ↦ [op₁x; op₂x; …] along a new leading axis; the
    members' outputs share a shape and the adjoint sums the members'
    adjoints in order (``fasta_tpu/operators.py:436``).  Over lanes the
    stack axis follows the lane axis: (B, K, ...)."""

    def __init__(self, ops: Sequence[LinearOp]):
        self.ops = tuple(ops)

    def __call__(self, x):
        return torch.stack([op(x) for op in self.ops])

    def rmatvec(self, y):
        out = self.ops[0].rmatvec(y[0])
        for i, op in enumerate(self.ops[1:], start=1):
            out = out + op.rmatvec(y[i])
        return out

    def lanes(self, x):
        return torch.stack([op.lanes(x) for op in self.ops], dim=1)

    def rmatvec_lanes(self, y):
        out = self.ops[0].rmatvec_lanes(y[:, 0])
        for i, op in enumerate(self.ops[1:], start=1):
            out = out + op.rmatvec_lanes(y[:, i])
        return out


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
    """Normalize the reference's operator forms into a ``LinearOp``
    (``fasta_tpu/operators.py:464-514``):

    * None → :class:`IdentityOp`;
    * a ``LinearOp`` → itself;
    * a tensor → a ``DenseOp`` on the tensor's own device, a NumPy matrix
      → a ``DenseOp`` on ``device`` (the card when None: see
      :func:`default_device`); ``At`` must be None;
    * a scipy sparse matrix → a :class:`SparseOp` on ``device``;
    * an object with ``matvec``, ``rmatvec`` and ``shape`` (a scipy
      ``LinearOperator``) → a :class:`FunctionOp` that applies it on the
      host in NumPy, one round trip to the host a product, as the JAX
      package's ``pure_callback`` does: a compatibility path;
    * a callable with its adjoint callable ``At`` → a :class:`FunctionOp`.
    """
    if A is None:
        return IdentityOp()
    if isinstance(A, LinearOp):
        return A
    if isinstance(A, (torch.Tensor, np.ndarray)):
        if At is not None:
            raise ValueError("an explicit matrix takes no separate adjoint")
        if isinstance(A, np.ndarray):
            return DenseOp(torch.as_tensor(
                A, device=default_device(device, "as_linear_op")))
        return DenseOp(A)
    import scipy.sparse as sp
    if sp.issparse(A):
        return SparseOp.from_scipy(A, device=default_device(device,
                                                            "as_linear_op"))
    if (callable(getattr(A, "matvec", None))
            and callable(getattr(A, "rmatvec", None))
            and hasattr(A, "shape")):
        # checked before the bare callable: scipy's LinearOperator has
        # __call__ too
        return FunctionOp(_on_host(A.matvec), _on_host(A.rmatvec))
    if callable(A):
        if not callable(At):
            raise ValueError("A is a callable; At must be its adjoint "
                             "callable")
        return FunctionOp(A, At)
    raise TypeError(f"unsupported operator type: {type(A)}")


def _on_host(fn: Callable) -> Callable:
    """``fn`` over NumPy arrays as a function of a tensor: the tensor
    copied to the host, ``fn`` applied there, its result cast to the
    tensor's dtype and copied back to the tensor's device."""
    def apply(v):
        out = np.asarray(fn(v.detach().cpu().numpy()))
        return torch.as_tensor(out).to(device=v.device, dtype=v.dtype)
    return apply


def check_adjoint(op: LinearOp, x_like: torch.Tensor,
                  generator: torch.Generator, rtol: float = 1e-4,
                  n_trials: int = 2) -> float:
    """Verify ⟨Ax, y⟩ = ⟨x, Aᴴy⟩ on random vectors drawn from
    ``generator`` (which must live on ``x_like``'s device).  Returns the
    max relative error; raises if it exceeds ``rtol``."""
    d_like = op(x_like)
    worst = 0.0
    for _ in range(n_trials):
        x = op.signal_draw(x_like, generator)
        y = op.measurement_draw(d_like, generator)
        lhs = complex(op.measurement_sum(
            torch.vdot(y.reshape(-1), op(x).reshape(-1))))
        rhs = complex(op.signal_sum(
            torch.vdot(op.rmatvec(y).reshape(-1), x.reshape(-1)))[0])
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
