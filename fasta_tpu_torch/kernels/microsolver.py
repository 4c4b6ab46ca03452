"""Kernels K-B1, K-B1p, K-B1b and K-B2: whole dense solves in one launch.

K-B1, ``microsolve_lasso``: the whole adaptive or FISTA solve of
min f(Ax) + g(x) for the losses "lstsq" ½‖·−b‖², "logistic"
Σlog(1+exp(·))−bᵀ· and "squared_hinge" ½Σmax(0,1−b⊙·)² × the proxes
"l1" μ‖·‖₁, "nonneg", "box" ([−1,1]) and "ridge" (μ/2)‖·‖²; port of
``fasta_tpu/kernels/microsolver.py:49-102, 105-711, 721-843``.
K-B1p, ``microsolve_lasso_path``: the same solve over a path of weights μ
in one launch, warm (each point from the previous solution and stepsize)
or cold (each point as a separate ``microsolve_lasso`` call); port of
``microsolver.py:853-966``.  K-B1b, ``microsolve_lasso_batch``: B
instances sharing A, each with its own b, x₀ and τ₀, in one launch; port
of ``microsolve_lasso`` under ``jax.vmap`` (``fasta_tpu/micro.py:435``).
K-B2, the fixed-order FP64 reduction of the hp decision scalars
(``kernels/ddreduce.py``), is inlined.

The CUDA source is ``fasta_tpu_torch/csrc/microsolver.cu`` (with
``csrc/reduce.cuh`` and ``csrc/losses.cuh``); its header note gives the
design.  Each wrapper launches the kernel for CUDA tensors and runs its
plain version (``microsolve_lasso_reference``,
``microsolve_lasso_path_reference``, ``microsolve_lasso_batch_reference``)
for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from ..options import STOP_RULES, stop_test
from ..prox import project_box, project_nonneg, shrink
from ..terms import hinge_residual, logistic_ell, logistic_grad
from . import _build

__all__ = ["microsolve_lasso", "microsolve_lasso_reference",
           "microsolve_lasso_path", "microsolve_lasso_path_reference",
           "microsolve_lasso_batch", "microsolve_lasso_batch_reference",
           "MicrosolveOutput", "STATUS_NAMES", "LOSSES", "PROXES",
           "supports_microsolver", "LAUNCHES", "PATH_LAUNCHES",
           "BATCH_LAUNCHES"]

# Launches of the whole-solve kernel for one solve (K-B1), for a path
# (K-B1p) and for a batch (K-B1b), each counted where it launches, nowhere
# else.
LAUNCHES = 0
PATH_LAUNCHES = 0
BATCH_LAUNCHES = 0

# The kernel's int32 halt codes, in order.
STATUS_NAMES = ("max_iters", "converged", "nonfinite")
# The kernel's loss and prox codes, in order (csrc/losses.cuh,
# csrc/microsolver.cu).
LOSSES = ("lstsq", "logistic", "squared_hinge")
PROXES = ("l1", "nonneg", "box", "ridge")

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
    """What a whole-solve run returns.  ``taus``, ``residuals`` and the
    optional series have ``max_iters`` entries (``iterates``: rows);
    those at and after ``iteration_count`` are zero.  ``halt`` is the
    int32 halt code; ``status`` names it.  A path run stacks every field
    on a leading axis of path points."""
    x: torch.Tensor
    taus: torch.Tensor
    residuals: torch.Tensor
    iteration_count: torch.Tensor        # int32
    halt: torch.Tensor                   # int32: index into STATUS_NAMES
    fvals: Optional[torch.Tensor]        # when record_fvals
    backtracks: Optional[torch.Tensor]   # int32, when record_bts
    objectives: Optional[torch.Tensor]   # when record_objs
    iterates: Optional[torch.Tensor]     # (max_iters, n), when record_its
    norm_residuals: Optional[torch.Tensor]   # when record_nres

    @property
    def status(self) -> str:
        """"max_iters", "converged" or "nonfinite" (reads the device)."""
        return STATUS_NAMES[int(self.halt)]


def _check_options(loss, prox, stop_rule, window, max_iters):
    if loss not in LOSSES:
        raise ValueError(f"unknown loss {loss!r} (choose from {LOSSES})")
    if prox not in PROXES:
        raise ValueError(f"unknown prox {prox!r} (choose from {PROXES})")
    if stop_rule not in STOP_RULES:
        raise ValueError(f"unknown stop_rule {stop_rule!r} "
                         f"(choose from {STOP_RULES})")
    if not 1 <= window <= _WINDOW_MAX:
        raise ValueError(f"window must be in [1, {_WINDOW_MAX}], got "
                         f"{window}")
    if max_iters < 1:
        raise ValueError("max_iters must be >= 1")


def _check_tensors(A, b, x0, what):
    if A.ndim != 2 or b.ndim != 1 or x0.ndim != 1:
        raise ValueError(f"{what} needs A (m,n), b (m,), x0 (n,)")
    m, n = A.shape
    if b.shape[0] != m or x0.shape[0] != n:
        raise ValueError(f"{what}: b has {b.shape[0]} entries and x0 "
                         f"{x0.shape[0]} for A {m}x{n}")
    for name, t in (("A", A), ("b", b), ("x0", x0)):
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32, got "
                             f"{t.dtype}")
        if t.device != A.device:
            raise ValueError(f"{what}: A, b and x0 must share a device")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {A.device}")


_DEFAULTS = dict(max_iters=1000, window=10, tol=1e-3, shrink_factor=0.2,
                 max_backtracks=20, hp=False, stop_rule="hybrid_residual",
                 loss="lstsq", prox="l1", accelerate=False, restart=True,
                 restart_dd=False, record_fvals=False, record_bts=False,
                 record_objs=False, record_nres=False)


def microsolve_lasso(A, b, x0, tau0, mu, *, record_its=False,
                     **options) -> MicrosolveOutput:
    """Whole solve of  min f(Ax) + g(x)  in one launch.

    ``loss`` selects f: "lstsq" (½‖·−b‖²), "logistic" (labels b ∈ {0,1})
    or "squared_hinge" (labels b ∈ {±1}); ``prox`` selects g: "l1"
    (μ‖·‖₁), "nonneg", "box" ([−1,1]) or "ridge" ((μ/2)‖·‖², μ carries
    λ).  Same options and math as the TPU kernel: nonmonotone
    backtracking over a ``window`` of f-values, the Zhou–Gao–Dai BB
    stepsize or, with ``accelerate``, FISTA with O'Donoghue–Candès
    ``restart`` (``restart_dd`` takes the restart dot in float64 under
    hp), the five stop rules, and the halt code (nonfinite wins over
    converged).  ``hp=True`` accumulates the decision scalars in float64.
    ``record_fvals``, ``record_bts``, ``record_objs`` (prox-point
    objective), ``record_its`` (iterate rows) and ``record_nres``
    (normalized residuals) add series to the output.

    CUDA tensors launch kernel K-B1 (A, b, x0 float32; a contiguous Aᵀ
    is made once per call); CPU tensors run the plain version."""
    opts = _options(options)
    _check_tensors(A, b, x0, "microsolve_lasso")
    if A.device.type == "cpu":
        return microsolve_lasso_reference(A, b, x0, tau0, mu,
                                          record_its=record_its, **opts)
    out = _launch(A, b, x0, tau0, torch.tensor([float(mu)]), 1, False,
                  record_its, opts)
    global LAUNCHES
    LAUNCHES += 1
    return MicrosolveOutput(*(None if t is None else t[0] for t in out))


def microsolve_lasso_path(A, b, x0, tau0, mus, *, warm=True,
                          **options) -> MicrosolveOutput:
    """The solve of ``microsolve_lasso`` for each weight of ``mus`` (B,)
    in one launch; every output field gains a leading axis of B points.

    ``warm=True`` is the continuation recipe of ``solve_path``: point i
    starts from point i−1's solution and, in adaptive mode, its last
    genuinely accepted stepsize (fewer than ``max_backtracks`` trials,
    τ > 0), else τ₀; FISTA warm-starts x only and keeps τ₀.  A nonfinite
    abort at point i sends point i+1 back to the cold x₀, with point i's
    own start τ — the JAX kernel's code (microsolver.py:704-709), whose
    docstring says the caller's τ₀.  Order ``mus`` strongest first and
    prefer ``stop_rule="residual"``.
    ``warm=False`` solves every point cold: each is bit-identical to a
    separate ``microsolve_lasso`` call on the same device.

    CUDA tensors launch kernel K-B1p; CPU tensors run the plain version."""
    opts = _options(options)
    _check_tensors(A, b, x0, "microsolve_lasso_path")
    mus = torch.as_tensor(mus, dtype=torch.float32)
    if mus.ndim != 1 or mus.shape[0] < 1:
        raise ValueError("microsolve_lasso_path: mus must be a non-empty "
                         "1-D vector of weights")
    if A.device.type == "cpu":
        return microsolve_lasso_path_reference(A, b, x0, tau0, mus,
                                               warm=warm, **opts)
    out = _launch(A, b, x0, tau0, mus.cpu(), mus.shape[0], warm, False, opts)
    global PATH_LAUNCHES
    PATH_LAUNCHES += 1
    return MicrosolveOutput(*out)


def microsolve_lasso_batch(A, bs, x0s, tau0s, mu,
                           **options) -> MicrosolveOutput:
    """The solve of ``microsolve_lasso`` for B instances sharing A and the
    weight ``mu`` in one launch: measurements or labels ``bs`` (B, m),
    starts ``x0s`` (B, n) or one shared x₀ (n,), and τ₀ a number or a (B,)
    tensor (one per instance).  Every output field gains a leading axis of
    B instances, each bit-identical to a separate ``microsolve_lasso``
    call on the same device (the JAX contract of ``microsolve_batch``).

    CUDA tensors launch kernel K-B1b; CPU tensors run the plain version."""
    opts = _options(options)
    B = _check_batch(A, bs, x0s, tau0s, 1, "microsolve_lasso_batch")
    _check_tensors(A, bs[0], x0s if x0s.ndim == 1 else x0s[0],
                   "microsolve_lasso_batch")
    if A.device.type == "cpu":
        return microsolve_lasso_batch_reference(A, bs, x0s, tau0s, mu,
                                                **opts)
    out = _launch(A, bs, x0s, tau0s, torch.tensor([float(mu)]), B, False,
                  False, opts)
    global BATCH_LAUNCHES
    BATCH_LAUNCHES += 1
    return MicrosolveOutput(*out)


def _check_batch(lead, bs, x0s, tau0s, data_ndim, what) -> int:
    """B, after checking that ``bs`` stacks instance data of ``data_ndim``
    dimensions on a leading axis, that ``x0s`` is one start or B and that
    τ₀ is a number or B on ``lead``'s device."""
    if bs.ndim != data_ndim + 1 or bs.shape[0] < 1:
        raise ValueError(f"{what}: bs must stack {data_ndim}-d instance data "
                         f"on a leading batch axis, got {tuple(bs.shape)}")
    B = bs.shape[0]
    for name, t in (("bs", bs), ("x0s", x0s)):
        if t.device != lead.device:
            raise ValueError(f"{what}: {name} lies on {t.device}, the "
                             f"operator on {lead.device}")
    if torch.is_tensor(tau0s) and tau0s.ndim:
        if tuple(tau0s.shape) != (B,):
            raise ValueError(f"{what}: per-instance tau0 shape "
                             f"{tuple(tau0s.shape)} != ({B},)")
    return B


def _points(B, b, b_dims, x0, x0_dims, tau0, dev):
    """The per-point data of a launch over B points (csrc/fbs_control.cuh,
    Points): the strides of b and x₀ (their size when they stack B on a
    leading axis, else 0: shared) and τ₀ as (a (B,) float32 tensor on
    ``dev`` or None, the shared number)."""
    b_stride = b[0].numel() if b.ndim == b_dims + 1 else 0
    x0_stride = x0[0].numel() if x0.ndim == x0_dims + 1 else 0
    if torch.is_tensor(tau0) and tau0.ndim:
        return (b_stride, x0_stride,
                tau0.to(device=dev, dtype=torch.float32).contiguous(), 0.0)
    return b_stride, x0_stride, None, float(tau0)


def _options(options):
    unknown = set(options) - set(_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown option(s) {sorted(unknown)}")
    opts = {**_DEFAULTS, **options}
    _check_options(opts["loss"], opts["prox"], opts["stop_rule"],
                   opts["window"], opts["max_iters"])
    return opts


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


@functools.lru_cache(maxsize=None)
def _work_doubles(nblocks: int) -> int:
    """The FP64 scratch of a K-B1 or K-B6 launch over ``nblocks``
    (csrc/fbs_control.cuh)."""
    nd = ctypes.c_int()
    _build.check(_build.library().fasta_fbs_work_doubles(
        nblocks, ctypes.byref(nd)), "fasta_fbs_work_doubles")
    return nd.value


class _Outputs(NamedTuple):
    """What every whole-solve launch writes besides the solution: the
    (B, K) records, the (B,) counts and halt codes, and the FP64
    scratch."""
    taus: torch.Tensor
    res: torch.Tensor
    fvals: Optional[torch.Tensor]
    bts: Optional[torch.Tensor]
    objs: Optional[torch.Tensor]
    nres: Optional[torch.Tensor]
    k: torch.Tensor
    halt: torch.Tensor
    work_d: torch.Tensor


def _outputs(B, K, o, dev, nblocks) -> _Outputs:
    def series(flag, dtype=torch.float32):
        return torch.zeros(B, K, device=dev, dtype=dtype) if flag else None

    return _Outputs(
        series(True), series(True), series(o["record_fvals"]),
        series(o["record_bts"], torch.int32), series(o["record_objs"]),
        series(o["record_nres"]),
        torch.empty(B, device=dev, dtype=torch.int32),
        torch.empty(B, device=dev, dtype=torch.int32),
        torch.empty(_work_doubles(nblocks), device=dev, dtype=torch.float64))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _pad4(v: int) -> int:
    return (v + 3) // 4 * 4


def _launch(A, b, x0, tau0, mus, B, warm, record_its, o):
    """One launch over B points: b (m,) or (B, m), x0 (n,) or (B, n), τ₀
    a number or (B,), mus (1,) shared or (B,)."""
    for name, t in (("A", A), ("b", b), ("x0", x0)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"microsolve_lasso: {name} must be contiguous "
                             f"and 16-byte aligned")
    m, n = A.shape
    K = o["max_iters"]
    dev = A.device
    nb = _grid(dev.index)
    f32 = dict(device=dev, dtype=torch.float32)
    At = A.t().contiguous()
    mus_d = mus.to(**f32)
    b_stride, x0_stride, tau0s, tau0 = _points(B, b, 1, x0, 1, tau0, dev)
    x = torch.empty(B, n, **f32)
    r = _outputs(B, K, o, dev, nb)
    its = torch.zeros(B, K, n, **f32) if record_its else None
    # the kernel carves five n-vectors and three m-vectors, each padded
    # to 4 floats so that every one stays 16-byte aligned
    work_f = torch.empty(5 * _pad4(n) + 3 * _pad4(m), **f32)
    flags = (int(bool(o["hp"])) | int(bool(o["accelerate"])) << 1
             | int(bool(o["restart"])) << 2 | int(bool(o["restart_dd"])) << 3
             | int(bool(warm)) << 4)
    with _build.on_device(dev) as stream:
        _build.check(_build.library().fasta_microsolve(
            A.data_ptr(), At.data_ptr(), b.data_ptr(), b_stride,
            x0.data_ptr(), x0_stride, mus_d.data_ptr(),
            int(mus_d.numel() > 1), _ptr(tau0s), B, tau0, m, n, K,
            o["window"],
            float(o["tol"]), float(o["shrink_factor"]), o["max_backtracks"],
            STOP_RULES.index(o["stop_rule"]), LOSSES.index(o["loss"]),
            PROXES.index(o["prox"]), flags, x.data_ptr(), r.taus.data_ptr(),
            r.res.data_ptr(), _ptr(r.fvals), _ptr(r.bts), _ptr(r.objs),
            _ptr(r.nres), _ptr(its), r.k.data_ptr(), r.halt.data_ptr(),
            work_f.data_ptr(), r.work_d.data_ptr(), nb, stream),
            "fasta_microsolve")
    return x, r.taus, r.res, r.k, r.halt, r.fvals, r.bts, r.objs, its, r.nres


# --------------------------------------------------------------------------
# The plain versions
# --------------------------------------------------------------------------

def _loss_fns(loss, b, acc):
    """(f, ℓ′) of the kernel's loss: f sums in ``acc`` (float64 under
    hp), ℓ′ stays float32.  "phase_hinge" is K-B8's PhaseMax hinge over
    planar rows d (m, 2) against magnitudes b (m,)."""
    if loss == "phase_hinge":
        from ..terms import phase_hinge_parts

        def parts(d):
            return phase_hinge_parts(torch.sqrt(torch.sum(d * d, dim=-1)), b)

        def fof(d):
            r = parts(d)[0].to(acc)
            return 0.5 * torch.sum(r * r)
        return fof, lambda d: parts(d)[1][:, None] * d
    if loss == "logistic":
        return (lambda d: torch.sum(logistic_ell(d, b).to(acc)),
                lambda d: logistic_grad(d, b))
    if loss == "squared_hinge":
        def fof(d):
            r = hinge_residual(d, b).to(acc)
            return 0.5 * torch.sum(r * r)
        return fof, lambda d: -b * hinge_residual(d, b)

    def fof(d):
        r = (d - b).to(acc)
        return 0.5 * torch.sum(r * r)
    return fof, lambda d: d - b


def _prox_fns(prox, mu):
    """(prox(z, τ), g(x)) of the kernel's prox with weight ``mu`` (for
    K-B8's "anchor", g(x) = −⟨c, x⟩, ``mu`` is the anchor c)."""
    if prox == "anchor":
        return (lambda z, tau: z + tau * mu,
                lambda x: -torch.sum(mu * x))
    if prox == "nonneg":
        return (lambda z, tau: project_nonneg(z),
                lambda x: torch.zeros((), dtype=x.dtype, device=x.device))
    if prox == "box":
        return (lambda z, tau: project_box(z, -1.0, 1.0),
                lambda x: torch.zeros((), dtype=x.dtype, device=x.device))
    if prox == "ridge":
        return (lambda z, tau: z / (1.0 + tau * mu),
                lambda x: 0.5 * mu * torch.sum(x * x))
    return (lambda z, tau: shrink(z, tau * mu),
            lambda x: mu * torch.sum(torch.abs(x)))


def microsolve_lasso_reference(A, b, x0, tau0, mu, *, record_its=False,
                               **options) -> MicrosolveOutput:
    """The plain version of K-B1: a Python loop doing the kernel's math
    in torch on A's device.  Scalars are float32 tensors, as in the
    kernel; with ``hp`` the f-values, the window, the backtracking dot,
    the BB numerator and (with ``restart_dd``) the restart dot
    accumulate in float64.  Only the order of the float32 sums differs
    from the kernel."""
    return _reference(A, b, x0, tau0, mu, record_its, _options(options))[0]


def microsolve_lasso_path_reference(A, b, x0, tau0, mus, *, warm=True,
                                    **options) -> MicrosolveOutput:
    """The plain version of K-B1p: the plain K-B1 loop per path point,
    with the kernel's warm carry of x and τ."""
    o = _options(options)
    return path_reference(
        lambda x, tau, mu: _reference(A, b, x, tau, mu, False, o), x0, tau0,
        mus, warm, o["accelerate"])


def microsolve_lasso_batch_reference(A, bs, x0s, tau0s, mu,
                                     **options) -> MicrosolveOutput:
    """The plain version of K-B1b: the plain K-B1 loop per instance, its
    outputs stacked on a leading axis."""
    o = _options(options)
    return batch_reference(
        lambda b, x0, tau0: _reference(A, b, x0, tau0, mu, False, o)[0],
        bs, x0s, tau0s, 1)


def batch_reference(solve, bs, x0s, tau0s, x0_dims):
    """A plain batch: ``solve(b, x₀, τ₀) -> output`` per instance, x₀
    shared (``x0_dims`` dimensions) or stacked, τ₀ a number or one per
    instance; outputs stacked on a leading axis."""
    runs = []
    for i in range(bs.shape[0]):
        x0 = x0s if x0s.ndim == x0_dims else x0s[i]
        tau0 = (float(tau0s[i]) if torch.is_tensor(tau0s) and tau0s.ndim
                else float(tau0s))
        runs.append(solve(bs[i], x0, tau0))
    return MicrosolveOutput(*(
        None if vals[0] is None else torch.stack(vals)
        for vals in zip(*runs)))


def path_reference(solve, x0, tau0, mus, warm, accelerate):
    """A plain path: ``solve(x_start, τ_start, μ) -> (output, last
    genuinely accepted τ)`` per point, with the whole-solve kernels' warm
    carry of x and τ (K-B1p, K-B6p); outputs stacked on a leading
    axis."""
    x_start, tau_start = x0, float(tau0)
    runs = []
    for i, mu in enumerate(torch.as_tensor(mus).tolist()):
        tau_i = (tau_start if warm and not accelerate and i > 0
                 and tau_start > 0.0 else float(tau0))
        out, tau_acc = solve(x_start if warm else x0, tau_i, mu)
        runs.append(out)
        ok = int(out.halt) != 2
        # a nonfinite abort sends the next point back to the cold x₀; the
        # τ carry keeps the point's own start τ when no τ was accepted
        x_start = out.x if ok else x0
        tau_start = (tau_acc if ok and int(out.iteration_count) > 0
                     and tau_acc > 0.0 else tau_i)
    return MicrosolveOutput(*(
        None if vals[0] is None else torch.stack(vals)
        for vals in zip(*runs)))


def _reference(A, b, x0, tau0, mu, record_its, o):
    """One plain dense solve; returns (output, last genuinely accepted
    τ)."""
    At = A.t()
    return solve_reference(lambda x: torch.matmul(A, x),
                           lambda r: torch.matmul(At, r), b, x0, tau0, mu,
                           record_its, o)


def solve_reference(fwd, adj, b, x0, tau0, mu, record_its, o):
    """The whole-solve kernels' loop in plain PyTorch over a linear
    operator given as ``fwd`` (x ↦ Ax) and ``adj`` (r ↦ Aᵀr), for x of
    any shape: K-B1's with a matrix, K-B6's with the TV stencils, K-B8's
    with the planar pair.  ``mu`` is the prox's weight, or a tensor for
    the anchor.  Returns (output, last genuinely accepted τ)."""
    dev = x0.device
    f32 = dict(device=dev, dtype=torch.float32)
    hp = bool(o["hp"])
    acc = torch.float64 if hp else torch.float32
    K, window, max_bt = o["max_iters"], o["window"], o["max_backtracks"]
    shrink_factor, accelerate = o["shrink_factor"], o["accelerate"]
    rdd = hp and o["restart_dd"]
    tau = torch.tensor(float(tau0), **f32)
    mu_t = mu if torch.is_tensor(mu) else torch.tensor(float(mu), **f32)
    fof, lgrad = _loss_fns(o["loss"], b, acc)
    prox, gval = _prox_fns(o["prox"], mu_t)

    def series(flag, dtype=torch.float32):
        return torch.zeros(K, device=dev, dtype=dtype) if flag else None

    taus, res_rec = series(True), series(True)
    fvals = series(o["record_fvals"])
    bts = series(o["record_bts"], torch.int32)
    objs = series(o["record_objs"])
    nres_rec = series(o["record_nres"])
    its = (torch.zeros((K,) + tuple(x0.shape), **f32) if record_its
           else None)

    def fb(x, g, tau):
        """The trial: x̂, x₁, Δx, A x₁ and f(A x₁)."""
        x1hat = x - tau * g
        x1 = prox(x1hat, tau)
        d1 = fwd(x1)
        return x1hat, x1, x1 - x, d1, fof(d1)

    x = x0                       # adaptive: the iterate; FISTA: y
    d0 = fwd(x0)
    g = adj(lgrad(d0))
    x_acc, d_acc = x0, d0        # FISTA: the last prox point and A·(it)
    alpha = torch.tensor(1.0, **f32)
    fwin = torch.full((window,), -math.inf, device=dev, dtype=acc)
    fwin[0] = fof(d0)
    maxres = torch.tensor(-math.inf, **f32)
    tau_acc = 0.0
    k, halt = 0, 0
    while k < K and halt == 0:
        x1hat, x1, dx, d1, f1 = fb(x, g, tau)
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
            if not (viol and bt < max_bt):
                break
            tau = tau * shrink_factor
            x1hat, x1, dx, d1, f1 = fb(x, g, tau)
            bt += 1
        if bt < max_bt:
            tau_acc = float(tau)

        res = torch.sqrt(nd2) / tau
        maxres = torch.maximum(maxres, res)
        sm = x1 - x1hat
        normalizer = torch.maximum(torch.sqrt(torch.sum(g * g)),
                                   torch.sqrt(torch.sum(sm * sm)) / tau) + 1e-8
        nres = res / normalizer
        stop = bool(stop_test(o["stop_rule"], res, nres, maxres, o["tol"],
                              _EPS_R))

        if accelerate:
            if rdd:
                rdot = torch.sum((x - x1).double()
                                 * (x1 - x_acc).double()).float()
            else:
                rdot = torch.sum((x - x1) * (x1 - x_acc))
            alpha0 = (torch.where(rdot > 0.0, 1.0, alpha) if o["restart"]
                      else alpha)
            alpha1 = (1.0 + torch.sqrt(1.0 + 4.0 * alpha0 * alpha0)) / 2.0
            beta = (alpha0 - 1.0) / alpha1
            y_n = x1 + beta * (x1 - x_acc)
            d_n = d1 + beta * (d1 - d_acc)          # A is linear
            g_n = adj(lgrad(d_n))
            f_rec = f1 if stop else fof(d_n)
            finite = bool(torch.isfinite(res) & torch.isfinite(tau)
                          & torch.isfinite(f_rec))
            tau_n = tau
        else:
            g_n = adj(lgrad(d1))
            # Zhou–Gao–Dai BB stepsize; Δg = g₁ + (x̂₁ − x)/τ
            dg = g_n + (x1hat - x) / tau
            if hp:
                dot = torch.sum(dx.double() * dg.double()).float()
            else:
                dot = torch.sum(dx * dg)
            ndg2 = torch.sum(dg * dg)
            tau_s = torch.where(dot != 0.0, nd2 / dot, math.inf)
            tau_m = torch.clamp_min(torch.where(ndg2 > 0.0, dot / ndg2, 0.0),
                                    0.0)
            tau_n = torch.where(2.0 * tau_m > tau_s, tau_m,
                                tau_s - 0.5 * tau_m)
            bad = (tau_n <= 0.0) | torch.isinf(tau_n) | torch.isnan(tau_n)
            tau_n = torch.where(bad, tau * 1.5, tau_n)
            f_rec = f1
            finite = bool(torch.isfinite(res) & torch.isfinite(tau_n)
                          & torch.isfinite(f1))
        halt = 2 if not finite else (1 if stop else 0)

        taus[k] = tau
        res_rec[k] = res
        if fvals is not None:
            fvals[k] = f_rec
        if bts is not None:
            bts[k] = bt
        if objs is not None:
            objs[k] = f1.float() + gval(x1)
        if nres_rec is not None:
            nres_rec[k] = nres
        if its is not None:
            its[k] = x1
        fwin[(k + 1) % window] = f_rec
        if accelerate:
            x, x_acc, d_acc, alpha = y_n, x1, d1, alpha1
        else:
            x = x1
        g, tau = g_n, tau_n
        k += 1
    # FISTA: a converged stop exits at the prox point, otherwise at y
    sol = x_acc if (accelerate and halt == 1) else x
    out = MicrosolveOutput(
        sol, taus, res_rec, torch.tensor(k, device=dev, dtype=torch.int32),
        torch.tensor(halt, device=dev, dtype=torch.int32), fvals, bts, objs,
        its, nres_rec)
    return out, tau_acc
