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

from .operators import (ComposeOp, DenseOp, DiagonalOp, IdentityOp,
                        LowPrecDenseOp, MaskedFourierOp, PlanarDenseOp,
                        ScaledOp, SparseOp, StackedOp, TVDiv2D, tv_div_2d)
from .precision import real_dtype
from .problem import Problem
from .solver import Diagnostics, SolverState
from .terms import (BoxIndicator, L1Norm, L2Norm2, L21Norm, LeastSquares,
                    LinearAnchor, LinfNorm, Logistic, MaskedLogistic,
                    MaxRowNormBall, NMFLoss, NonnegIndicator, NuclearNorm,
                    PhaseHinge, PlanarLinearAnchor, PlanarPhaseHinge,
                    SquaredHinge)

__all__ = ["problem_from_instance", "problem_from_arrays",
           "result_to_numpy", "bf16_tensor", "lowprec_op_from_arrays",
           "planar_op_from_arrays", "solver_state_from_arrays",
           "solver_state_to_arrays", "sharded_op_arrays",
           "sharded_op_from_arrays"]


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


def _sparse_entries(data, idx, offsets) -> tuple:
    """(values, rows, cols) of the JAX sharded sparse operators' padded
    blocks: the padding (zero entries at the block's (0, 0)) dropped, each
    block's indices offset by ``offsets`` (its first row and column,
    broadcast against the entries)."""
    rows = idx[..., 0] + offsets[0]
    cols = idx[..., 1] + offsets[1]
    keep = data != 0
    return data[keep], rows[keep], cols[keep]


def sharded_op_arrays(op, rows: Optional[int] = None) -> dict:
    """The global arrays of the operator of a problem that
    ``fasta_tpu.sharding`` placed (its ``RowShardedDenseOp`` — a stacked
    A (B, m, n) splits its lanes — ``RowShardedPlanarDenseOp`` (stacked
    alike), ``ShardedCDPOp``, ``RowShardedSparseOp``,
    ``GridShardedDenseOp``, ``GridShardedSparseOp``,
    ``GridShardedPlanarDenseOp`` or ``RowShardedTVDivOp``, or an operator
    it left to GSPMD: a ``LowPrecDenseOp``, whose bfloat16 matrix crosses
    as its bits, or an ``IdentityOp``, which carries no shape: ``rows``
    gives x's rows) as NumPy, with its ``kind``: what
    :func:`sharded_op_from_arrays` takes on each rank.  The sparse blocks'
    padding (zero entries) is dropped and their indices offset to the
    whole matrix's."""
    kind = type(op).__name__
    if kind == "RowShardedDenseOp":
        A = np.asarray(op.A)
        return {"kind": "lanes_dense" if A.ndim == 3 else "dense", "A": A}
    if kind == "RowShardedPlanarDenseOp":
        Ar = np.asarray(op.Ar)
        return {"kind": "lanes_planar" if Ar.ndim == 3 else "planar",
                "Ar": Ar, "Ai": np.asarray(op.Ai)}
    if kind == "LowPrecDenseOp":
        return {"kind": "lowprec", "A": np.asarray(op.A)}
    if kind == "IdentityOp":
        if rows is None:
            raise ValueError("an IdentityOp carries no shape: pass rows, "
                             "the leading axis of x")
        return {"kind": "identity", "rows": int(rows)}
    if kind == "ShardedCDPOp":
        return {"kind": "cdp", "mods": np.asarray(op.mods),
                "wins": np.asarray(op.wins)}
    if kind == "RowShardedSparseOp":
        data, idx = np.asarray(op.data), np.asarray(op.indices)
        vals, rows, cols = _sparse_entries(
            data, idx, (op.block_rows * np.arange(len(data))[:, None], 0))
        return {"kind": "sparse", "data": vals, "rows": rows, "cols": cols,
                "shape": (len(data) * op.block_rows, op.n)}
    if kind == "GridShardedDenseOp":
        return {"kind": "grid_dense", "A": np.asarray(op.A)}
    if kind == "GridShardedPlanarDenseOp":
        return {"kind": "grid_planar", "Ar": np.asarray(op.Ar),
                "Ai": np.asarray(op.Ai)}
    if kind == "GridShardedSparseOp":
        data, idx = np.asarray(op.data), np.asarray(op.indices)
        R, C = data.shape[:2]
        vals, rows, cols = _sparse_entries(
            data, idx, (op.block_rows * np.arange(R)[:, None, None],
                        op.block_cols * np.arange(C)[None, :, None]))
        return {"kind": "grid_sparse", "data": vals, "rows": rows,
                "cols": cols,
                "shape": (R * op.block_rows, C * op.block_cols)}
    if kind == "RowShardedTVDivOp":
        return {"kind": "tv", "c": float(op.c)}
    raise TypeError(f"no sharded counterpart of {kind}")


def sharded_op_from_arrays(arrays: dict, mesh):
    """This rank's port operator (``sharding``'s sharded classes) over the
    global arrays of :func:`sharded_op_arrays`; the rank, the world and
    the device are the mesh's (a 2-D rows × cols mesh for the grid
    kinds).  Both packages then hold the same numbers."""
    from . import sharding as sh
    kind = arrays["kind"]
    if kind == "grid_dense":
        return sh.GridShardedDenseOp(
            sh._grid_block(arrays["A"], mesh, "rows", "cols"), mesh)
    if kind == "grid_planar":
        return sh.GridShardedPlanarDenseOp(
            sh._grid_block(arrays["Ar"], mesh, "rows", "cols"),
            sh._grid_block(arrays["Ai"], mesh, "rows", "cols"), mesh)
    if kind == "grid_sparse":
        import scipy.sparse as sp
        M = sp.coo_matrix((arrays["data"], (arrays["rows"], arrays["cols"])),
                          shape=arrays["shape"])
        return sh.GridShardedSparseOp.from_scipy(M, mesh)
    if kind == "tv":
        return sh.RowShardedTVDivOp(arrays["c"], mesh)
    if kind == "dense":
        return sh.RowShardedDenseOp(sh.shard_rows(arrays["A"], mesh), mesh)
    if kind == "planar":
        return sh.RowShardedPlanarDenseOp(sh.shard_rows(arrays["Ar"], mesh),
                                          sh.shard_rows(arrays["Ai"], mesh),
                                          mesh)
    if kind == "cdp":
        return sh.ShardedCDPOp(sh.shard_rows(arrays["mods"], mesh),
                               sh.shard_rows(arrays["wins"], mesh), mesh)
    if kind == "sparse":
        import scipy.sparse as sp
        M = sp.coo_matrix((arrays["data"], (arrays["rows"], arrays["cols"])),
                          shape=arrays["shape"])
        return sh.RowShardedSparseOp.from_scipy(M, mesh)
    if kind == "lowprec":
        return sh.RowShardedLowPrecDenseOp(
            sh.shard_rows(_stored(arrays["A"], "cpu"), mesh), mesh)
    if kind == "identity":
        return sh.RowShardedIdentityOp(arrays["rows"], mesh)
    if kind == "lanes_dense":
        return sh.LaneShardedDenseOp(sh.shard_rows(arrays["A"], mesh), mesh)
    if kind == "lanes_planar":
        return sh.LaneShardedPlanarDenseOp(sh.shard_rows(arrays["Ar"], mesh),
                                           sh.shard_rows(arrays["Ai"], mesh),
                                           mesh)
    raise ValueError(f"no sharded operator of kind {kind!r}")


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


# instance name -> (smooth term, prox term from the instance) over the
# instance's dense matrix A
_DENSE = {
    "lasso": (LeastSquares, lambda inst: L1Norm(float(inst["mu"]))),
    "nnls": (LeastSquares, lambda inst: NonnegIndicator()),
    "logistic": (Logistic, lambda inst: L1Norm(float(inst["mu"]))),
    "svm": (SquaredHinge, lambda inst: L2Norm2(float(inst["lam"]))),
    "democratic": (LeastSquares, lambda inst: LinfNorm(float(inst["mu"]))),
    "mmv": (LeastSquares, lambda inst: L21Norm(float(inst["mu"]))),
}

def problem_from_instance(inst: dict, *, device, dtype: torch.dtype,
                          planar: bool = False) -> Problem:
    """A port ``Problem`` from a generator instance dict (the JAX
    ``Problem.instance``) of any of the 13 example problems, with the
    operator, terms, name and ``recover`` of the JAX problem module
    (``problems/<name>.py``), its tensors ``dtype`` on ``device``:

    * the dense family — LASSO, NNLS, sparse logistic regression, the
      SVM — and democratic representations and MMV: ``DenseOp(A)``, the
      smooth term over ``b``;
    * sparse LASSO: ``SparseOp`` over the instance's scipy matrix;
    * TV denoising: the image ``b``, the dual start (2, H, W), the TV
      weight ``mu``, no matrix;
    * matrix completion, max-norm and NMF: ``IdentityOp`` over a matrix
      variable (NMF's ``recover`` the product W Hᵀ);
    * phase retrieval (complex ``A``, magnitudes ``b``, anchor
      ``x0_hat``, weight ``delta``) as complex tensors or, with
      ``planar``, in planar layout (``dtype`` then names the channels'
      real type), and its coded-diffraction form (a stack of modulated
      FFTs, ``dtype`` complex)."""
    name = inst.get("name")
    if name not in _BUILDERS:
        raise ValueError(f"instance {name!r} names no example problem; "
                         f"the port carries {sorted(_BUILDERS)}")
    return _BUILDERS[name](inst, device, dtype, planar)


def _tensors(device, dtype):
    """``t(a)``: a NumPy array as a ``dtype`` tensor on ``device``."""
    def t(a):
        return torch.tensor(np.asarray(a), device=device, dtype=dtype)
    return t


def _common(inst, t) -> dict:
    return dict(x0=t(inst["x0"]), x_true=inst.get("x_true"), instance=inst)


def _dense(inst, device, dtype, planar):
    smooth, prox = _DENSE[inst["name"]]
    t = _tensors(device, dtype)
    A = t(inst["A"])
    m, n = A.shape
    label = (f"mmv[{m}x{n}x{np.shape(inst['b'])[1]}]"
             if inst["name"] == "mmv" else f"{inst['name']}[{m}x{n}]")
    return Problem(name=label, op=DenseOp(A), fterm=smooth(t(inst["b"])),
                   gterm=prox(inst), **_common(inst, t))


def _tv(inst, device, dtype, planar):
    t = _tensors(device, dtype)
    mu = float(inst["mu"])
    h, w = np.shape(inst["b"])
    return Problem(name=f"tv[{h}x{w}]", op=ScaledOp(mu, TVDiv2D()),
                   fterm=LeastSquares(t(inst["b"])),
                   gterm=BoxIndicator(-1.0, 1.0),
                   recover=_tv_recover(np.asarray(inst["b"]), mu),
                   **_common(inst, t))


def _sparse_lasso(inst, device, dtype, planar):
    t = _tensors(device, dtype)
    m, n = inst["A_sparse"].shape
    return Problem(
        name=f"sparse_lasso[{m}x{n}@{inst['density']}]",
        op=SparseOp.from_scipy(inst["A_sparse"], dtype, device=device),
        fterm=LeastSquares(t(inst["b"])),
        gterm=L1Norm(float(inst["mu"])), **_common(inst, t))


def _matrix_completion(inst, device, dtype, planar):
    t = _tensors(device, dtype)
    d1, d2 = np.shape(inst["b"])
    return Problem(name=f"matrix_completion[{d1}x{d2}]", op=IdentityOp(),
                   fterm=MaskedLogistic(t(inst["b"]), t(inst["mask"])),
                   gterm=NuclearNorm(float(inst["mu"])), **_common(inst, t))


def _max_norm(inst, device, dtype, planar):
    t = _tensors(device, dtype)
    d1, d2 = np.shape(inst["b"])
    return Problem(name=f"max_norm[{d1}x{d2}]", op=IdentityOp(),
                   fterm=LeastSquares(t(inst["b"])),
                   gterm=MaxRowNormBall(float(inst["radius"])),
                   **_common(inst, t))


def _nmf(inst, device, dtype, planar):
    """The stacked factor [W; H], the clean product as x_true."""
    t = _tensors(device, dtype)
    d1, d2 = np.shape(inst["b"])
    return Problem(name=f"nmf[{d1}x{d2},r{inst['rank']}]", op=IdentityOp(),
                   fterm=NMFLoss(t(inst["b"])), gterm=NonnegIndicator(),
                   recover=lambda X: X[:d1] @ X[d1:].T, **_common(inst, t))


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


def _phase_retrieval_cdp(inst, device, dtype, planar):
    """Coded-diffraction phase retrieval (``problems/phase_retrieval_cdp.py``):
    ``StackedOp`` of K ``ComposeOp(MaskedFourierOp(ones), DiagonalOp(mask))``
    (a unitary FFT of each modulated signal), ``PhaseHinge`` over the
    magnitudes and ``LinearAnchor`` δ·x̂₀, ``dtype`` complex."""
    K, n = np.shape(inst["masks"])

    def t(a, dt=dtype):
        return torch.tensor(np.asarray(a), device=device, dtype=dt)
    ones = torch.ones(n, device=device, dtype=dtype)
    op = StackedOp([ComposeOp(MaskedFourierOp(ones), DiagonalOp(t(m)))
                    for m in inst["masks"]])
    return Problem(name=f"phase_retrieval_cdp[{K}x{n}]", op=op,
                   fterm=PhaseHinge(t(inst["b"], real_dtype(dtype))),
                   gterm=LinearAnchor(inst["delta"] * t(inst["x0_hat"])),
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


# instance name -> builder(inst, device, dtype, planar)
_BUILDERS = {**{name: _dense for name in _DENSE}, "tv": _tv,
             "sparse_lasso": _sparse_lasso,
             "matrix_completion": _matrix_completion,
             "max_norm": _max_norm, "nmf": _nmf,
             "phase_retrieval": _phase_retrieval,
             "phase_retrieval_cdp": _phase_retrieval_cdp}


def _field_dict(node) -> dict:
    """A state's (or its records') fields by name: a NamedTuple's or a
    mapping's."""
    return dict(node._asdict() if hasattr(node, "_asdict") else node)


def solver_state_from_arrays(fields, *, device) -> SolverState:
    """A port :class:`~fasta_tpu_torch.solver.SolverState` on ``device``
    from the JAX package's ``SolverState`` with NumPy leaves
    (``np.asarray`` of each field, None kept), or a mapping of its field
    names, ``diags`` likewise, ``accel`` a sequence or None.  A state that
    ``fasta_tpu.make_stateful_solver`` returned (or that
    ``fasta_tpu.checkpoint.load_pytree`` read) then resumes in the port's
    ``resume_state`` with no port run to give an example.  Each array
    keeps its type; a double-word window (the JAX package's float32 hp
    ``fwin``, a (hi, lo) pair) becomes the port's float64 window hi + lo."""
    f = _field_dict(fields)

    def t(a):
        return None if a is None else torch.tensor(np.asarray(a),
                                                    device=device)
    fwin = f["fwin"]
    if isinstance(fwin, (tuple, list)):          # (hi, lo)
        hi, lo = (np.asarray(p, np.float64) for p in fwin)
        fwin = hi + lo
    accel = f["accel"]
    diags = _field_dict(f["diags"])
    return SolverState(**{
        **{k: t(v) for k, v in f.items() if k not in ("accel", "diags")},
        "fwin": t(fwin),
        "accel": None if accel is None else tuple(t(a) for a in accel),
        "diags": Diagnostics(**{k: t(v) for k, v in diags.items()})})


def solver_state_to_arrays(state: SolverState) -> dict:
    """The inverse of :func:`solver_state_from_arrays`: the port state's
    fields by name as NumPy arrays (``accel`` a tuple or None, ``diags`` a
    dict), the JAX package's ``SolverState`` fields, so that
    ``fasta_tpu.SolverState(**d, diags=fasta_tpu.Diagnostics(**d["diags"]))``
    rebuilds it.  Its window stays the port's: float64 under hp, where
    the JAX package keeps a double-word pair."""
    def host(v):
        return None if v is None else v.detach().cpu().numpy()
    out = {k: host(v) for k, v in state._asdict().items()
           if k not in ("accel", "diags")}
    out["accel"] = (None if state.accel is None
                    else tuple(host(a) for a in state.accel))
    out["diags"] = {k: host(v) for k, v in state.diags._asdict().items()}
    return out


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
