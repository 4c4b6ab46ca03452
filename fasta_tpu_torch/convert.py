"""Carry problems and results across between ``fasta_tpu`` and the port.

The JAX package's problem data is its ``Problem.instance`` dict of raw
NumPy arrays (or ``np.asarray`` of its leaves); these helpers build a
port :class:`~fasta_tpu_torch.problem.Problem` holding the same numbers,
so both packages solve bit-identical inputs, and turn a port result back
into NumPy.  No JAX import: everything crosses as NumPy.  A JAX bfloat16
array crosses as its bits (:func:`bf16_tensor`), so the port holds the
very values the JAX operator stores.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .operators import (DenseOp, LowPrecDenseOp, PlanarDenseOp, ScaledOp,
                        TVDiv2D, tv_div_2d)
from .precision import real_dtype
from .problem import Problem
from .terms import (BoxIndicator, L1Norm, L2Norm2, LeastSquares,
                    LinearAnchor, Logistic, NonnegIndicator, PhaseHinge,
                    PlanarLinearAnchor, PlanarPhaseHinge, SquaredHinge)

__all__ = ["problem_from_instance", "problem_from_arrays",
           "result_to_numpy", "bf16_tensor", "lowprec_op_from_arrays",
           "planar_op_from_arrays"]


def bf16_tensor(a, *, device) -> torch.Tensor:
    """A bfloat16 tensor on ``device`` holding exactly the values of the
    NumPy bfloat16 array ``a`` (``np.asarray`` of a JAX bfloat16 array,
    whose dtype is named "bfloat16"): its bits, viewed as int16 and
    reinterpreted."""
    a = np.asarray(a)
    if a.dtype.name != "bfloat16":
        raise ValueError(f"bf16_tensor takes a bfloat16 array, got {a.dtype}")
    bits = np.ascontiguousarray(a).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)


def _stored(a, device) -> torch.Tensor:
    """An array a JAX operator stores, as a tensor on ``device``: bfloat16
    bits carried across, other types as they are."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return bf16_tensor(a, device=device)
    return torch.as_tensor(a).to(device)


def lowprec_op_from_arrays(A, *, device) -> LowPrecDenseOp:
    """The port's ``LowPrecDenseOp`` over the stored matrix of a JAX
    ``LowPrecDenseOp`` (``op.A``)."""
    return LowPrecDenseOp(_stored(A, device))


def planar_op_from_arrays(Ar, Ai, *, device) -> PlanarDenseOp:
    """The port's ``PlanarDenseOp`` over the channels of a JAX one
    (``op.Ar``, ``op.Ai``)."""
    return PlanarDenseOp(_stored(Ar, device), _stored(Ai, device))


def problem_from_arrays(A, b, mu: float, x0, tau0: Optional[float] = None,
                        *, device, dtype: torch.dtype,
                        name: Optional[str] = None) -> Problem:
    """A LASSO ``Problem`` (DenseOp · LeastSquares · L1Norm) over
    ``dtype`` copies of ``A``, ``b`` and ``x0`` on ``device``."""
    def t(a):
        return torch.tensor(np.asarray(a), device=device, dtype=dtype)

    A_t = t(A)
    m, n = A_t.shape
    return Problem(
        name=name or f"lasso[{m}x{n}]",
        op=DenseOp(A_t),
        fterm=LeastSquares(t(b)),
        gterm=L1Norm(float(mu)),
        x0=t(x0),
        tau0=tau0,
    )


# instance name -> (smooth term, prox term from the instance)
_DENSE = {
    "lasso": (LeastSquares, lambda inst: L1Norm(float(inst["mu"]))),
    "nnls": (LeastSquares, lambda inst: NonnegIndicator()),
    "logistic": (Logistic, lambda inst: L1Norm(float(inst["mu"]))),
    "svm": (SquaredHinge, lambda inst: L2Norm2(float(inst["lam"]))),
}


def problem_from_instance(inst: dict, *, device, dtype: torch.dtype,
                          planar: bool = False) -> Problem:
    """A port ``Problem`` from a generator instance dict (the JAX
    ``Problem.instance``) of one of the dense problems — LASSO, NNLS,
    sparse logistic regression or the SVM, whose instances hold the
    matrix ``A``, the measurements or labels ``b`` and ``x0`` — of TV
    denoising, whose instance holds the image ``b``, the dual start
    ``x0`` (2, H, W) and the TV weight ``mu``, and no matrix, or of phase
    retrieval (complex ``A``, magnitudes ``b``, anchor ``x0_hat``, weight
    ``delta``), as complex tensors or, with ``planar``, in planar layout
    (``dtype`` then names the channels' real type)."""
    name = inst.get("name")
    ported = sorted(_DENSE) + ["phase_retrieval", "tv"]
    if name not in ported:
        raise NotImplementedError(
            f"instance {name!r} is not ported yet (ROADMAP Queue A items 2 "
            f"and 7); the port carries {ported}")
    if name == "phase_retrieval":
        return _phase_retrieval(inst, device, dtype, planar)

    def t(a):
        return torch.tensor(np.asarray(a), device=device, dtype=dtype)

    if name == "tv":
        mu = float(inst["mu"])
        h, w = np.shape(inst["b"])
        return Problem(name=f"tv[{h}x{w}]", op=ScaledOp(mu, TVDiv2D()),
                       fterm=LeastSquares(t(inst["b"])),
                       gterm=BoxIndicator(-1.0, 1.0), x0=t(inst["x0"]),
                       x_true=inst.get("x_true"), instance=inst,
                       recover=_tv_recover(np.asarray(inst["b"]), mu))
    smooth, prox = _DENSE[name]

    A = t(inst["A"])
    m, n = A.shape
    return Problem(name=f"{name}[{m}x{n}]", op=DenseOp(A),
                   fterm=smooth(t(inst["b"])), gterm=prox(inst),
                   x0=t(inst["x0"]), x_true=inst.get("x_true"),
                   instance=inst)


def _phase_retrieval(inst, device, dtype, planar):
    """The phase retrieval problem of ``problems/phase_retrieval.py``:
    complex ``DenseOp`` · ``PhaseHinge`` · ``LinearAnchor``, or planar
    ``PlanarDenseOp`` · ``PlanarPhaseHinge`` · ``PlanarLinearAnchor`` with
    ``recover`` mapping (n, 2) to the complex signal."""
    rdt = real_dtype(dtype)
    m, n = np.shape(inst["A"])
    c = inst["delta"] * np.asarray(inst["x0_hat"])
    b = torch.tensor(np.asarray(inst["b"]), device=device, dtype=rdt)
    if planar:
        def planar_t(z):
            z = np.asarray(z)
            return torch.tensor(np.stack([z.real, z.imag], axis=-1),
                                device=device, dtype=rdt)
        return Problem(
            name=f"phase_retrieval_planar[{m}x{n}]",
            op=PlanarDenseOp.from_complex(inst["A"], rdt, device=device),
            fterm=PlanarPhaseHinge(b), gterm=PlanarLinearAnchor(planar_t(c)),
            x0=planar_t(inst["x0"]), x_true=inst.get("x_true"),
            instance=inst, recover=_planar_recover)
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64

    def t(a):
        return torch.tensor(np.asarray(a), device=device, dtype=cdt)
    return Problem(name=f"phase_retrieval[{m}x{n}]", op=DenseOp(t(inst["A"])),
                   fterm=PhaseHinge(b), gterm=LinearAnchor(t(c)),
                   x0=t(inst["x0"]), x_true=inst.get("x_true"),
                   instance=inst)


def _planar_recover(xp):
    """The complex signal of a planar (…, 2) vector, on its device."""
    xp = torch.as_tensor(xp)
    return torch.complex(xp[..., 0], xp[..., 1])


def _tv_recover(b: np.ndarray, mu: float):
    """x = b − μ·div(p): the denoised image of a dual field p, in float64
    on p's device (the JAX problem's ``recover``, ``problems/tv.py``)."""
    def recover(p):
        p = torch.as_tensor(p)
        b64 = torch.as_tensor(b, dtype=torch.float64, device=p.device)
        return b64 - mu * tv_div_2d(p.to(torch.float64))
    return recover


def result_to_numpy(result) -> dict:
    """A result (``FastaResult``, ``DeviceResult`` — of one solve or of a
    batch — ``MicroResult``, ``MicroBatchResult`` or a kernel's
    ``MicrosolveOutput``) as a dict of NumPy arrays and Python scalars,
    field by field; a batch's per-instance lists stay lists of arrays."""
    if dataclasses.is_dataclass(result):
        fields = {f.name: getattr(result, f.name)
                  for f in dataclasses.fields(result)}
    else:
        fields = result._asdict()

    def host(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        if isinstance(v, list):
            return [host(e) for e in v]
        return v

    return {k: host(v) for k, v in fields.items()}
