"""Kernels K-B1 and K-B2: the whole adaptive LASSO solve in one launch.

Port of ``fasta_tpu/kernels/microsolver.py:49-102, 105-711, 721-843``
(and, inlined, ``kernels/ddreduce.py``) for loss "lstsq" × prox "l1" in
adaptive mode.  The CUDA sources are ``fasta_tpu_torch/csrc/
microsolver.cu`` (K-B1) and ``csrc/reduce.cuh`` (K-B2, the fixed-order
FP64 reduction of the hp decision scalars); their header notes give the
design.  ``microsolve_lasso`` launches the kernel for CUDA tensors and
runs the plain version ``microsolve_lasso_reference`` for CPU tensors.

The other loss × prox pairs, FISTA and the objective / normalized
residual / iterate recordings of the TPU kernel are ROADMAP Queue B item
B1's later steps; asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from ..options import STOP_RULES, stop_test
from ..prox import shrink
from . import _build

__all__ = ["microsolve_lasso", "microsolve_lasso_reference",
           "MicrosolveOutput", "STATUS_NAMES", "supports_microsolver",
           "LAUNCHES"]

# Launches of the whole-solve kernel (counted where it launches, nowhere
# else).
LAUNCHES = 0

# The kernel's int32 halt codes, in order.
STATUS_NAMES = ("max_iters", "converged", "nonfinite")

# The kernel keeps the nonmonotone window in a fixed shared-memory ring.
_WINDOW_MAX = 128

# The reference's residency gate (fasta_tpu/kernels/microsolver.py:79,
# sized for the TPU's VMEM), kept so that the port's dispatch decisions
# match the reference's.  Not measured on the H100, where A and its
# transpose stream from L2 and device memory.
_DENSE_VMEM_BYTES = 24 << 20

_EPS32 = 1.1920928955078125e-07
# The kernel's eps_r of the ratio and hybrid stop rules (FastaOptions'
# default).
_EPS_R = 1e-8


def supports_microsolver(m: int, n: int) -> bool:
    """The reference's residency gate for the dense whole-solve kernel."""
    return m * n * 4 <= _DENSE_VMEM_BYTES


class MicrosolveOutput(NamedTuple):
    """What one whole-solve run returns.  ``taus``, ``residuals``,
    ``fvals`` and ``backtracks`` have ``max_iters`` entries; those at and
    after ``iteration_count`` are zero.  ``halt`` is the int32 halt code;
    ``status`` names it."""
    x: torch.Tensor
    taus: torch.Tensor
    residuals: torch.Tensor
    iteration_count: torch.Tensor        # 0-d int32
    halt: torch.Tensor                   # 0-d int32: index into STATUS_NAMES
    fvals: Optional[torch.Tensor]        # when record_fvals
    backtracks: Optional[torch.Tensor]   # int32, when record_bts

    @property
    def status(self) -> str:
        """"max_iters", "converged" or "nonfinite" (reads the device)."""
        return STATUS_NAMES[int(self.halt)]


def _check_options(loss, prox, accelerate, record_objs, record_its,
                   record_nres, stop_rule, window, max_iters):
    if loss != "lstsq" or prox != "l1":
        raise NotImplementedError(
            f"microsolve_lasso: loss {loss!r} x prox {prox!r} is not ported "
            f"yet; only lstsq x l1 is (the other pairs are ROADMAP Queue B "
            f"item B1)")
    if accelerate:
        raise NotImplementedError(
            "microsolve_lasso: FISTA mode is not ported yet (ROADMAP Queue "
            "B item B1)")
    if record_objs or record_its or record_nres:
        raise NotImplementedError(
            "microsolve_lasso: objective, iterate and normalized-residual "
            "recording are not ported yet (ROADMAP Queue B item B1)")
    if stop_rule not in STOP_RULES:
        raise ValueError(f"unknown stop_rule {stop_rule!r} "
                         f"(choose from {STOP_RULES})")
    if not 1 <= window <= _WINDOW_MAX:
        raise ValueError(f"window must be in [1, {_WINDOW_MAX}], got "
                         f"{window}")
    if max_iters < 1:
        raise ValueError("max_iters must be >= 1")


def _check_tensors(A, b, x0):
    if A.ndim != 2 or b.ndim != 1 or x0.ndim != 1:
        raise ValueError("microsolve_lasso needs A (m,n), b (m,), x0 (n,)")
    m, n = A.shape
    if b.shape[0] != m or x0.shape[0] != n:
        raise ValueError(f"microsolve_lasso: b has {b.shape[0]} entries and "
                         f"x0 {x0.shape[0]} for A {m}x{n}")
    for name, t in (("A", A), ("b", b), ("x0", x0)):
        if t.dtype != torch.float32:
            raise ValueError(f"microsolve_lasso: {name} must be float32, "
                             f"got {t.dtype}")
        if t.device != A.device:
            raise ValueError("microsolve_lasso: A, b and x0 must share a "
                             "device")


def microsolve_lasso(A, b, x0, tau0, mu, *, max_iters=1000, window=10,
                     tol=1e-3, shrink_factor=0.2, max_backtracks=20,
                     hp=False, stop_rule="hybrid_residual",
                     record_fvals=False, record_bts=False, loss="lstsq",
                     prox="l1", accelerate=False, record_objs=False,
                     record_its=False, record_nres=False
                     ) -> MicrosolveOutput:
    """Whole adaptive solve of  min ½‖Ax−b‖² + μ‖x‖₁  in one launch.

    Same options and math as the TPU kernel: nonmonotone backtracking
    over a ``window`` of f-values, the Zhou–Gao–Dai BB stepsize, the five
    stop rules, and the halt code (nonfinite wins over converged).
    ``hp=True`` accumulates the decision scalars in float64.

    CUDA tensors launch kernel K-B1 (A, b, x0 float32; a contiguous Aᵀ
    is made once per call); CPU tensors run the plain version."""
    _check_options(loss, prox, accelerate, record_objs, record_its,
                   record_nres, stop_rule, window, max_iters)
    _check_tensors(A, b, x0)
    kw = dict(max_iters=max_iters, window=window, tol=tol,
              shrink_factor=shrink_factor, max_backtracks=max_backtracks,
              hp=hp, stop_rule=stop_rule, record_fvals=record_fvals,
              record_bts=record_bts)
    if A.device.type == "cpu":
        return microsolve_lasso_reference(A, b, x0, tau0, mu, **kw)
    if A.device.type != "cuda":
        raise ValueError(f"microsolve_lasso: no kernel for device "
                         f"{A.device}")
    return _launch(A, b, x0, tau0, mu, **kw)


@functools.lru_cache(maxsize=None)
def _grid(device_index: int) -> int:
    nb = ctypes.c_int()
    with torch.cuda.device(device_index):
        _build.check(_build.library().fasta_microsolve_grid(ctypes.byref(nb)),
                     "fasta_microsolve_grid")
    if nb.value < 1:
        raise RuntimeError("the whole-solve kernel cannot be resident on "
                           "this device")
    return nb.value


def _launch(A, b, x0, tau0, mu, *, max_iters, window, tol, shrink_factor,
            max_backtracks, hp, stop_rule, record_fvals, record_bts):
    for name, t in (("A", A), ("b", b), ("x0", x0)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"microsolve_lasso: {name} must be contiguous "
                             f"and 16-byte aligned")
    m, n = A.shape
    dev = A.device
    nb = _grid(dev.index)
    f32 = dict(device=dev, dtype=torch.float32)
    i32 = dict(device=dev, dtype=torch.int32)
    At = A.t().contiguous()
    x = torch.empty(n, **f32)
    taus = torch.zeros(max_iters, **f32)
    res = torch.zeros(max_iters, **f32)
    fvals = torch.zeros(max_iters, **f32) if record_fvals else None
    bts = torch.zeros(max_iters, **i32) if record_bts else None
    k = torch.empty((), **i32)
    halt = torch.empty((), **i32)
    work_f = torch.empty(4 * n + m, **f32)
    work_d = torch.empty(2 * 7 * nb, device=dev, dtype=torch.float64)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with _build.on_device(dev) as stream:
        _build.check(_build.library().fasta_microsolve_lasso(
            A.data_ptr(), At.data_ptr(), b.data_ptr(), x0.data_ptr(),
            float(tau0), float(mu), m, n, max_iters, window, float(tol),
            float(shrink_factor), max_backtracks, int(bool(hp)),
            STOP_RULES.index(stop_rule), x.data_ptr(), taus.data_ptr(),
            res.data_ptr(), ptr(fvals), ptr(bts), k.data_ptr(),
            halt.data_ptr(), work_f.data_ptr(), work_d.data_ptr(), nb,
            stream), "fasta_microsolve_lasso")
    global LAUNCHES
    LAUNCHES += 1
    return MicrosolveOutput(x, taus, res, k, halt, fvals, bts)


def microsolve_lasso_reference(A, b, x0, tau0, mu, *, max_iters=1000,
                               window=10, tol=1e-3, shrink_factor=0.2,
                               max_backtracks=20, hp=False,
                               stop_rule="hybrid_residual",
                               record_fvals=False, record_bts=False
                               ) -> MicrosolveOutput:
    """The plain version of K-B1: a Python loop doing the kernel's math
    in torch on A's device.  Scalars are float32 tensors, as in the
    kernel; with ``hp`` the f-values, the window, the backtracking dot
    and the BB numerator accumulate in float64.  Only the order of the
    float32 sums differs from the kernel."""
    _check_options("lstsq", "l1", False, False, False, False, stop_rule,
                   window, max_iters)
    dev = A.device
    f32 = dict(device=dev, dtype=torch.float32)
    acc = torch.float64 if hp else torch.float32
    At = A.t()
    tau = torch.tensor(tau0, **f32)
    mu_t = torch.tensor(mu, **f32)
    taus = torch.zeros(max_iters, **f32)
    res_rec = torch.zeros(max_iters, **f32)
    fvals = torch.zeros(max_iters, **f32) if record_fvals else None
    bts = (torch.zeros(max_iters, device=dev, dtype=torch.int32)
           if record_bts else None)

    def fof(d):
        r = (d - b).to(acc)
        return 0.5 * torch.sum(r * r)

    def fb(x, g, tau):
        x1hat = x - tau * g
        x1 = shrink(x1hat, tau * mu_t)
        d1 = torch.matmul(A, x1)
        return x1hat, x1, x1 - x, fof(d1), torch.matmul(At, d1 - b)

    x = x0
    d0 = torch.matmul(A, x0)
    g = torch.matmul(At, d0 - b)
    fwin = torch.full((window,), -math.inf, device=dev, dtype=acc)
    fwin[0] = fof(d0)
    maxres = torch.tensor(-math.inf, **f32)
    k, halt = 0, 0
    while k < max_iters and halt == 0:
        x1hat, x1, dx, f1, g1 = fb(x, g, tau)
        M = torch.max(fwin)
        bt = 0
        while True:
            nd2 = torch.sum(dx * dx)
            if hp:
                slack = 1e-12 + (64.0 * _EPS32) * (torch.abs(M)
                                                   + torch.abs(f1))
                suff = M + (torch.sum(dx.double() * g.double())
                            + (nd2 / (2.0 * tau)).double())
                viol = bool(f1 - suff > slack)
            else:
                suff = M + torch.sum(dx * g) + nd2 / (2.0 * tau)
                viol = bool(f1 - 1e-12 > suff)
            if not (viol and bt < max_backtracks):
                break
            tau = tau * shrink_factor
            x1hat, x1, dx, f1, g1 = fb(x, g, tau)
            bt += 1

        res = torch.sqrt(nd2) / tau
        maxres = torch.maximum(maxres, res)
        sm = x1 - x1hat
        normalizer = torch.maximum(torch.sqrt(torch.sum(g * g)),
                                   torch.sqrt(torch.sum(sm * sm)) / tau) + 1e-8
        nres = res / normalizer
        stop = bool(stop_test(stop_rule, res, nres, maxres, tol, _EPS_R))

        dg = g1 + (x1hat - x) / tau
        if hp:
            dot = torch.sum(dx.double() * dg.double()).float()
        else:
            dot = torch.sum(dx * dg)
        ndg2 = torch.sum(dg * dg)
        tau_s = torch.where(dot != 0.0, nd2 / dot, math.inf)
        tau_m = torch.clamp_min(torch.where(ndg2 > 0.0, dot / ndg2, 0.0), 0.0)
        tau_n = torch.where(2.0 * tau_m > tau_s, tau_m, tau_s - 0.5 * tau_m)
        bad = (tau_n <= 0.0) | torch.isinf(tau_n) | torch.isnan(tau_n)
        tau_n = torch.where(bad, tau * 1.5, tau_n)
        finite = bool(torch.isfinite(res) & torch.isfinite(tau_n)
                      & torch.isfinite(f1))
        halt = 2 if not finite else (1 if stop else 0)

        taus[k] = tau
        res_rec[k] = res
        if record_fvals:
            fvals[k] = f1
        if record_bts:
            bts[k] = bt
        fwin[(k + 1) % window] = f1
        x, g, tau = x1, g1, tau_n
        k += 1
    return MicrosolveOutput(
        x, taus, res_rec, torch.tensor(k, device=dev, dtype=torch.int32),
        torch.tensor(halt, device=dev, dtype=torch.int32), fvals, bts)
