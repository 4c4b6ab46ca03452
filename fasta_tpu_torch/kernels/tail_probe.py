"""Kernel K-P3: the tail-ablation ladder of the dense whole-solve iteration.

``make(level, col=, thread=, vecscal=, fusedred=, condbt=)`` returns
``run(A, b, x0, K)``, which runs K iterations of one rung of a cumulative
ladder of the adaptive FBS body (LASSO with μ = 0.1, τ₀ = 0.05, window 10,
shrink 0.2, at most 20 backtracks) in one launch; port of
``benchmarks/micro_tail_probe.py:90`` (``make`` → ``run``, ``pallas_call``
at :411, bodies ``kern`` :243 and ``kern_vecscal`` :104).  The rungs add
the pieces of ``kern`` (:291-397) at the same positions:

* L0 x̂ = x − τg, d = A x, f, g₁ = Aᵀ(d − b); L1 + the shrink and Δx;
  L2 + the backtracking loop and its reductions; L3 + the window; L4 + the
  residual and stopping sums (the test never fires); L5 + the BB scalars;
  L6 + the τ / residual records.

Every iteration restarts from x₀ + 0·x₁, so the work stays the same; g and
τ carry over.  The X variants each change one thing of L6 and compute
L6's math (the source note says how each maps to this card): ``col`` (X1)
the adjoint by column tiles of A with no Aᵀ copy, ``thread`` (X2) ‖Δx‖²
and ⟨Δx,g⟩ reduced once and reused, ``vecscal`` (X3) the decision chain
in registers of every thread, ``fusedred`` (X4) the four stop/BB dots as
one stacked pass, ``condbt`` (X5) the first trial outside the loop.  One
flag at a time, over L6.

``run`` returns a ``TailOutput``: x (equal to x₀ while the run stays
finite, as the TPU kernel's output), the final g and τ, the first 128 τ
and residual records (L6 only, else zeros; the TPU kernel keeps them in
scratch) and the number of line-search trials.

The CUDA source is ``fasta_tpu_torch/csrc/tail_probe.cu``.  ``run``
launches the kernel for CUDA tensors and runs the plain version
(``tail_reference``, the same body in PyTorch) for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build

__all__ = ["make", "tail_reference", "TailOutput", "VARIANTS", "LAUNCHES",
           "MU", "TAU0", "WINDOW", "SHRINK", "MAX_BACKTRACKS", "RECORDS"]

# Launches of the ladder kernel, counted where it launches, nowhere else.
LAUNCHES = 0

# The probe's constants (micro_tail_probe.py:83-87) and record length
MU, TAU0, WINDOW, SHRINK, MAX_BACKTRACKS = 0.1, 0.05, 10, 0.2, 20
RECORDS = 128

# make()'s flags, in the order of the kernel's variant codes 1..5 (0: the
# ladder itself)
VARIANTS = ("col", "thread", "vecscal", "fusedred", "condbt")


class TailOutput(NamedTuple):
    x: torch.Tensor          # (n,)
    g: torch.Tensor          # (n,) the carried gradient after K iterations
    tau: torch.Tensor        # () the carried stepsize
    taus: torch.Tensor       # (128,) τ of iterations 0..127 (L6)
    residuals: torch.Tensor  # (128,) their residuals (L6)
    trials: torch.Tensor     # () int32, line-search trials in all


def _shrink(z, t):
    mag = torch.abs(z)
    return z * (torch.clamp_min(mag - t, 0.0) / torch.clamp_min(mag, 1e-30))


def tail_reference(A, b, x0, K: int, level: int = 6) -> TailOutput:
    """The plain version: K iterations of rung ``level`` of the ladder in
    PyTorch, float32, scalars as 0-d tensors (the X variants compute L6's
    function)."""
    f32 = dict(device=A.device, dtype=torch.float32)
    inf = torch.tensor(math.inf, **f32)

    def fb(xc, g, t):
        x1hat = xc - t * g
        x1 = _shrink(x1hat, t * MU) if level >= 1 else xc
        r = torch.mv(A, x1) - b
        return x1hat, x1, x1 - xc, 0.5 * torch.sum(r * r), torch.mv(A.mT, r)

    r0 = torch.mv(A, x0) - b
    g = torch.mv(A.mT, r0)
    fwin = torch.full((WINDOW,), -math.inf, **f32)
    fwin[0] = 0.5 * torch.sum(r0 * r0)
    tau = torch.tensor(TAU0, **f32)
    maxres = -inf
    taus, res_rec = torch.zeros(RECORDS, **f32), torch.zeros(RECORDS, **f32)
    x, stopf, trials = x0, torch.zeros((), **f32), 0
    for k in range(K):
        xc = x
        if level >= 2:
            M = torch.max(fwin) if level >= 3 else inf
            cnt = 0
            while True:
                trials += 1
                x1hat, x1, dx, f1, g1 = fb(xc, g, tau)
                nd2, rdg = torch.sum(dx * dx), torch.sum(dx * g)
                suff = M + rdg + nd2 / (2.0 * tau)
                if bool(f1 - 1e-12 > suff) and cnt < MAX_BACKTRACKS:
                    tau = tau * SHRINK
                    cnt += 1
                else:
                    break
        else:
            trials += 1
            x1hat, x1, dx, f1, g1 = fb(xc, g, tau)
        if level >= 3:
            fwin[(k + 1) % WINDOW] = f1
        res, tau_n, stop = f1, tau, torch.zeros((), dtype=torch.bool,
                                                device=A.device)
        if level >= 4:
            nd2 = torch.sum(dx * dx)
            res = torch.sqrt(nd2) / tau
            maxres = torch.maximum(maxres, res)
            sm = x1 - x1hat
            normalizer = torch.maximum(torch.sqrt(torch.sum(g * g)),
                                       torch.sqrt(torch.sum(sm * sm)) / tau) \
                + 1e-8
            stop = (res / (maxres + 1e-8) < -1.0) | (res / normalizer < -1.0)
        if level >= 5:
            dg = g1 + (x1hat - xc) / tau
            dot, ndg2 = torch.sum(dx * dg), torch.sum(dg * dg)
            tau_s = torch.where(dot != 0.0, nd2 / dot, inf)
            tau_m = torch.clamp_min(torch.where(ndg2 > 0.0, dot / ndg2,
                                                torch.zeros_like(dot)), 0.0)
            tau_n = torch.where(2.0 * tau_m > tau_s, tau_m,
                                tau_s - 0.5 * tau_m)
            bad = (tau_n <= 0.0) | torch.isinf(tau_n) | torch.isnan(tau_n)
            tau_n = torch.where(bad, tau * 1.5, tau_n)
        if level >= 6 and k < RECORDS:
            taus[k], res_rec[k] = tau, res
        stopf = torch.where(stop, 1.0, 0.0).to(torch.float32)
        x = x0 + 0.0 * x1 + 0.0 * stopf
        g, tau = g1, tau_n
    return TailOutput(x + 0.0 * g, g, tau, taus, res_rec,
                      torch.tensor(trials, dtype=torch.int32))


def _check(A, b, x0, K):
    if A.ndim != 2 or b.ndim != 1 or x0.ndim != 1 or \
            b.shape[0] != A.shape[0] or x0.shape[0] != A.shape[1]:
        raise ValueError(f"the tail probe needs A (m,n), b (m,) and x0 (n,); "
                         f"got {tuple(A.shape)}, {tuple(b.shape)}, "
                         f"{tuple(x0.shape)}")
    if int(K) < 1:
        raise ValueError(f"the tail probe needs K >= 1 iterations, got {K}")
    if A.device != b.device or A.device != x0.device:
        raise ValueError("the tail probe: A, b and x0 must share a device")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the tail probe: no kernel for device {A.device}")


def make(level: int, col: bool = False, thread: bool = False,
         vecscal: bool = False, fusedred: bool = False,
         condbt: bool = False):
    """``run(A, b, x0, K) -> TailOutput`` for rung ``level`` (0..6) or,
    with one flag, that X variant of L6.  CUDA tensors launch kernel K-P3
    (contiguous, 16-byte aligned float32, n % 4 == 0; anything else
    raises); CPU tensors run the plain version."""
    flags = dict(zip(VARIANTS, (col, thread, vecscal, fusedred, condbt)))
    on = [i + 1 for i, f in enumerate(flags.values()) if f]
    if not 0 <= int(level) <= 6:
        raise ValueError(f"level must be in 0..6, got {level}")
    if len(on) > 1 or (on and level != 6):
        raise ValueError("the X variants take one flag at a time, over "
                         "level 6")
    variant = on[0] if on else 0

    def run(A, b, x0, K: int) -> TailOutput:
        _check(A, b, x0, K)
        if A.device.type == "cpu":
            return tail_reference(A, b, x0, int(K), int(level))
        out = _launch(int(level), variant, A, b, x0, int(K))
        global LAUNCHES
        LAUNCHES += 1
        return out

    return run


def _launch(level, variant, A, b, x0, K) -> TailOutput:
    for name, t in (("A", A), ("b", b), ("x0", x0)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"the tail probe: {name} must be a contiguous "
                             f"float32 tensor, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"the tail probe: {name} must be 16-byte "
                             f"aligned")
    m, n = A.shape
    if n % 4:
        raise ValueError(f"the tail probe kernel takes n % 4 == 0 (16-byte "
                         f"rows), got n = {n}")
    dev = A.device
    nb = _grid(dev.index)
    nf, np_ = ctypes.c_int(), ctypes.c_int()
    _build.check(_build.library().fasta_tail_probe_work(
        m, n, nb, ctypes.byref(nf), ctypes.byref(np_)),
        "fasta_tail_probe_work")
    # X1 reads A by columns; the others a contiguous Aᵀ, made per call as
    # K-B1's wrapper makes it
    At = None if variant == 1 else A.t().contiguous()
    f32 = dict(device=dev, dtype=torch.float32)
    x, g, tau = torch.empty(n, **f32), torch.empty(n, **f32), \
        torch.empty(1, **f32)
    taus, res = torch.zeros(RECORDS, **f32), torch.zeros(RECORDS, **f32)
    trials = torch.zeros(1, device=dev, dtype=torch.int32)
    work_f, work_p = torch.empty(nf.value, **f32), torch.empty(np_.value,
                                                                **f32)
    with _build.on_device(dev) as stream:
        _build.check(_build.library().fasta_tail_probe(
            level, variant, A.data_ptr(), None if At is None else
            At.data_ptr(), b.data_ptr(), x0.data_ptr(), m, n, K,
            x.data_ptr(), g.data_ptr(), tau.data_ptr(),
            taus.data_ptr(), res.data_ptr(), trials.data_ptr(),
            work_f.data_ptr(), work_p.data_ptr(), nb, stream),
            "fasta_tail_probe")
    return TailOutput(x, g, tau[0], taus, res, trials[0])


@functools.lru_cache(maxsize=None)
def _grid(device_index: int) -> int:
    nb = ctypes.c_int()
    with torch.cuda.device(device_index):
        _build.check(_build.library().fasta_tail_probe_grid(
            ctypes.byref(nb)), "fasta_tail_probe_grid")
    if nb.value < 1:
        raise RuntimeError("the tail probe kernel cannot be resident on "
                           "this device")
    return nb.value
