"""Kernels K-B8 and K-B8b: the whole planar PhaseMax solve in one launch.

``microsolve_planar_phasemax`` runs the adaptive or FISTA solve of
min ½ Σ max(|Ax| − b, 0)² − ⟨c, x⟩ on planar x (n, 2), A = Ar + i·Ai
(m, n), b (m,) magnitudes, c (n, 2) the anchor; port of
``fasta_tpu/kernels/microsolver_planar.py:45-64, 606-722`` (pallas_call at
:669).  ``microsolve_planar_phasemax_batch`` (K-B8b) solves B instances
sharing A and c, each with its own b, x₀ and τ₀, in one launch; port of
the kernel under ``jax.vmap`` (``fasta_tpu/micro.py:435``).  The CUDA
source is ``fasta_tpu_torch/csrc/microsolver_planar.cu``
(its header note gives the design).  The wrappers launch the kernel for
CUDA tensors and run the plain versions
(``microsolve_planar_phasemax_reference``: K-B1's plain loop over the
planar pair with the hinge and the anchor, per instance for the batch)
for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..options import STOP_RULES
from . import _build
from .microsolver import (MicrosolveOutput, _check_batch, _check_options,
                          _outputs, _points, _ptr, batch_reference,
                          solve_reference)

__all__ = ["microsolve_planar_phasemax",
           "microsolve_planar_phasemax_reference",
           "microsolve_planar_phasemax_batch",
           "microsolve_planar_phasemax_batch_reference",
           "supports_planar_microsolver", "row_chunk", "WIDE_N", "LAUNCHES",
           "BATCH_LAUNCHES", "WIDE_LAUNCHES", "WIDE_BATCH_LAUNCHES"]

# Launches of the whole-solve kernel for one solve (K-B8) and for a batch
# (K-B8b), on the route for n ≤ WIDE_N and on the wide route past it, each
# counted where it launches, nowhere else.
LAUNCHES = 0
BATCH_LAUNCHES = 0
WIDE_LAUNCHES = 0
WIDE_BATCH_LAUNCHES = 0

# The widest signal (after padding to a multiple of 4) whose n-sized state
# every block keeps in shared memory, a warp's lanes holding a row's
# columns in registers; wider signals take the wide route, whose state
# lives in device memory (csrc/microsolver_planar.cu).
WIDE_N = 512

# The reference's residency gate (microsolver_planar.py:61-64, sized for
# the TPU's VMEM), kept so that the port's dispatch decisions match the
# reference's.  Not measured on the H100.
_PLANAR_VMEM_BYTES = 48 << 20

# The JAX kernel's defaults (microsolver_planar.py:606-614; micro.py:681
# passes hp off).
_DEFAULTS = dict(max_iters=1000, window=10, tol=1e-3, shrink_factor=0.2,
                 max_backtracks=20, hp=False, stop_rule="hybrid_residual",
                 accelerate=False, restart=True, restart_dd=False,
                 record_fvals=False, record_bts=False, record_objs=False,
                 record_nres=False)


def row_chunk(m: int):
    """The reference's measurement-axis chunk (microsolver_planar.py:45-58):
    m itself up to 2048, else the largest of 2048, 1024, …, 128 dividing m,
    or None.  The CUDA kernel takes any m; the gate keeps the port's
    dispatch decisions the reference's."""
    if m <= 2048:
        return m
    for cand in (2048, 1024, 512, 256, 128):
        if m % cand == 0:
            return cand
    return None


def supports_planar_microsolver(m: int, n: int) -> bool:
    """The reference's gate: both channel matrices within 48 MB and m
    admitting a 128-multiple chunk."""
    return 2 * m * n * 4 <= _PLANAR_VMEM_BYTES and row_chunk(m) is not None


def _options(options):
    unknown = set(options) - set(_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown option(s) {sorted(unknown)}")
    o = {**_DEFAULTS, **options}
    _check_options("lstsq", "l1", o["stop_rule"], o["window"],
                   o["max_iters"])
    # the plain loop's loss and prox: the hinge and the anchor
    return {**o, "loss": "phase_hinge", "prox": "anchor"}


def _check(Ar, Ai, b, c, x0, what):
    if (Ar.ndim != 2 or Ar.shape != Ai.shape or b.ndim != 1
            or x0.ndim != 2 or x0.shape[-1] != 2 or c.shape != x0.shape):
        raise ValueError(f"{what} needs Ar, Ai (m,n), b (m,), c and x0 "
                         f"(n,2); got {tuple(Ar.shape)}, {tuple(Ai.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}, "
                         f"{tuple(x0.shape)}")
    m, n = Ar.shape
    if b.shape[0] != m or x0.shape[0] != n:
        raise ValueError(f"{what}: b has {b.shape[0]} entries and x0 "
                         f"{x0.shape[0]} rows for A {m}x{n}")
    for name, t in (("Ar", Ar), ("Ai", Ai), ("b", b), ("c", c), ("x0", x0)):
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32, got "
                             f"{t.dtype}")
        if t.device != Ar.device:
            raise ValueError(f"{what}: Ar, Ai, b, c and x0 must share a "
                             f"device")
    if Ar.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {Ar.device}")


def microsolve_planar_phasemax(Ar, Ai, b, c, x0, tau0, *, record_its=False,
                               **options) -> MicrosolveOutput:
    """Whole solve of planar PhaseMax in one launch.

    Same options and math as the TPU kernel: nonmonotone backtracking over
    a ``window`` of f-values, the Zhou–Gao–Dai BB stepsize or, with
    ``accelerate``, FISTA with O'Donoghue–Candès ``restart``
    (``restart_dd`` takes the restart dot in float64 under hp), the five
    stop rules and the halt code.  ``hp`` (default off, as in JAX)
    accumulates the decision scalars in float64.  ``record_fvals``,
    ``record_bts``, ``record_objs`` (f(x₁) − ⟨c, x₁⟩), ``record_nres``
    and ``record_its`` (iterates (max_iters, n, 2)) add series.

    CUDA tensors launch kernel K-B8 at any shape (n padded by the wrapper
    to a multiple of 4 with zero columns; past ``WIDE_N`` the wide route);
    CPU tensors run the plain version."""
    o = _options(options)
    _check(Ar, Ai, b, c, x0, "microsolve_planar_phasemax")
    if Ar.device.type == "cpu":
        return _solve(Ar, Ai, b, c, x0, tau0, record_its, o)
    out = _launch(Ar, Ai, b, c, x0, tau0, 1, record_its, o)
    global LAUNCHES, WIDE_LAUNCHES
    if _wide(Ar.shape[1]):
        WIDE_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return MicrosolveOutput(*(None if t is None else t[0] for t in out))


def microsolve_planar_phasemax_batch(Ar, Ai, bs, c, x0s, tau0s,
                                     **options) -> MicrosolveOutput:
    """The solve of ``microsolve_planar_phasemax`` for B instances sharing
    Ar, Ai and the anchor c in one launch: magnitudes ``bs`` (B, m), starts
    ``x0s`` (B, n, 2) or one shared (n, 2), τ₀ a number or a (B,) tensor.
    Every output field gains a leading axis of B instances, each
    bit-identical to a separate ``microsolve_planar_phasemax`` call on the
    same device.

    CUDA tensors launch kernel K-B8b; CPU tensors run the plain version."""
    o = _options(options)
    B = _check_batch(Ar, bs, x0s, tau0s, 1,
                     "microsolve_planar_phasemax_batch")
    _check(Ar, Ai, bs[0], c, x0s if x0s.ndim == 2 else x0s[0],
           "microsolve_planar_phasemax_batch")
    if Ar.device.type == "cpu":
        return microsolve_planar_phasemax_batch_reference(
            Ar, Ai, bs, c, x0s, tau0s, **options)
    out = _launch(Ar, Ai, bs, c, x0s, tau0s, B, False, o)
    global BATCH_LAUNCHES, WIDE_BATCH_LAUNCHES
    if _wide(Ar.shape[1]):
        WIDE_BATCH_LAUNCHES += 1
    else:
        BATCH_LAUNCHES += 1
    return MicrosolveOutput(*out)


def microsolve_planar_phasemax_batch_reference(Ar, Ai, bs, c, x0s, tau0s,
                                               **options
                                               ) -> MicrosolveOutput:
    """The plain version of K-B8b: the plain K-B8 solve per instance, its
    outputs stacked on a leading axis."""
    o = _options(options)
    return batch_reference(
        lambda b, x0, tau0: _solve(Ar, Ai, b, c, x0, tau0, False, o),
        bs, x0s, tau0s, 2)


def microsolve_planar_phasemax_reference(Ar, Ai, b, c, x0, tau0, *,
                                         record_its=False, **options
                                         ) -> MicrosolveOutput:
    """The plain version of K-B8 on Ar's device: K-B1's plain loop with
    fwd/adj the planar pair, the hinge as the loss and z + τc as the
    prox.  With ``hp`` the f-values, the window, the backtracking dot, the
    BB numerator and (with ``restart_dd``) the restart dot accumulate in
    float64; only the order of the float32 sums differs from the
    kernel."""
    o = _options(options)
    _check(Ar, Ai, b, c, x0, "microsolve_planar_phasemax_reference")
    return _solve(Ar, Ai, b, c, x0, tau0, record_its, o)


def _solve(Ar, Ai, b, c, x0, tau0, record_its, o):
    from ..operators import PlanarDenseOp
    op = PlanarDenseOp(Ar, Ai)
    return solve_reference(op, op.rmatvec, b, x0, tau0, c, record_its, o)[0]


def _wide(n: int) -> bool:
    """Whether n columns take the wide route."""
    return (n + 3) // 4 * 4 > WIDE_N


@functools.lru_cache(maxsize=None)
def _grid(device_index: int, n4: int) -> int:
    nb = ctypes.c_int()
    with torch.cuda.device(device_index):
        _build.check(_build.library().fasta_microsolve_planar_grid(
            n4, ctypes.byref(nb)), "fasta_microsolve_planar_grid")
    if nb.value < 1:
        raise RuntimeError("the planar whole-solve kernel cannot be resident "
                           "on this device")
    return nb.value


@functools.lru_cache(maxsize=None)
def _work(m: int, n4: int, nblocks: int) -> int:
    nf = ctypes.c_int()
    _build.check(_build.library().fasta_microsolve_planar_work(
        m, n4, nblocks, ctypes.byref(nf)), "fasta_microsolve_planar_work")
    return nf.value


def _launch(Ar, Ai, b, c, x0, tau0, B, record_its, o):
    """One launch over B instances: b (m,) or (B, m), x0 (n, 2) or
    (B, n, 2), τ₀ a number or (B,)."""
    m, n = Ar.shape
    n4 = (n + 3) // 4 * 4
    pad = n4 - n
    # a copy per launch only where the layout needs one: zero columns up to
    # a multiple of 4 (16-byte rows)
    Ar, Ai = (F.pad(Ar, (0, pad)), F.pad(Ai, (0, pad))) if pad else (Ar, Ai)
    c, x0 = (F.pad(c, (0, 0, 0, pad)), F.pad(x0, (0, 0, 0, pad))) if pad \
        else (c, x0)
    Ar, Ai, b, c, x0 = (t.contiguous() for t in (Ar, Ai, b, c, x0))
    dev = Ar.device
    K = o["max_iters"]
    nb = _grid(dev.index, n4)
    f32 = dict(device=dev, dtype=torch.float32)
    b_stride, x0_stride, tau0s, tau0 = _points(B, b, 1, x0, 2, tau0, dev)
    x = torch.empty((B, n, 2), **f32)
    r = _outputs(B, K, o, dev, nb)
    its = torch.zeros((B, K, n, 2), **f32) if record_its else None
    work_f = torch.empty(_work(m, n4, nb), **f32)
    flags = (int(bool(o["hp"])) | int(bool(o["accelerate"])) << 1
             | int(bool(o["restart"])) << 2 | int(bool(o["restart_dd"])) << 3)
    with _build.on_device(dev) as stream:
        _build.check(_build.library().fasta_microsolve_planar(
            Ar.data_ptr(), Ai.data_ptr(), b.data_ptr(), b_stride,
            c.data_ptr(), x0.data_ptr(), x0_stride, _ptr(tau0s), B, tau0,
            m, n, n4, K, o["window"],
            float(o["tol"]), float(o["shrink_factor"]), o["max_backtracks"],
            STOP_RULES.index(o["stop_rule"]), flags, x.data_ptr(),
            r.taus.data_ptr(), r.res.data_ptr(), _ptr(r.fvals), _ptr(r.bts),
            _ptr(r.objs), _ptr(r.nres), _ptr(its), r.k.data_ptr(),
            r.halt.data_ptr(), work_f.data_ptr(), r.work_d.data_ptr(), nb,
            stream), "fasta_microsolve_planar")
    return x, r.taus, r.res, r.k, r.halt, r.fvals, r.bts, r.objs, its, r.nres
