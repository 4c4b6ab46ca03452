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

The CUDA source is ``fasta_tpu_torch/csrc/tail_probe.cu``: L6 is K-B1's
adaptive trial (the rows of A on the chip for the whole launch, the
adjoint from the same rows, two grid barriers a trial), each lower rung
that trial with the later pieces left out.  ``tail_plan`` places the rows
(``dense_plan`` at the probe's shared-memory budget, ``tail_budget``).
``run`` launches the kernel for CUDA tensors — one device operation a
call — and runs the plain version (``tail_reference``, the same body in
PyTorch) for CPU tensors.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from . import _build
from .microsolver import (H100_SMEM_OPTIN, STATE_MAX_N, DensePlan,
                          _rows_grid, _table, dense_lanes, dense_plan)

__all__ = ["make", "tail_reference", "tail_plan", "tail_budget",
           "TailOutput", "VARIANTS", "LAUNCHES", "MU", "TAU0", "WINDOW",
           "SHRINK", "MAX_BACKTRACKS", "RECORDS", "GRID_BARRIERS_PER_TRIAL",
           "H100_STATIC_SMEM"]

# Launches of the ladder kernel, counted where it launches, nowhere else.
LAUNCHES = 0

# The probe's constants (micro_tail_probe.py:83-87) and record length
MU, TAU0, WINDOW, SHRINK, MAX_BACKTRACKS = 0.1, 0.05, 10, 0.2, 20
RECORDS = 128

# Grid barriers an iteration's trial takes (csrc/tail_probe.cu; the start
# takes two more)
GRID_BARRIERS_PER_TRIAL = 2

# The static shared memory of the ladder's kernels as nvcc lays them out
# for sm_90a (the most of the twelve at a width): what ``tail_budget``
# takes by default; the card's own number comes from ``_grid``, which a
# card test holds against it.
H100_STATIC_SMEM = 7856

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


def tail_budget(n4: int, optin: int = H100_SMEM_OPTIN,
                static: int = H100_STATIC_SMEM) -> int:
    """The shared memory, in bytes, that a block of the ladder's kernel at
    width n4 has for rows of A: the per-block opt-in ``optin`` less the
    kernels' static shared memory ``static`` (by default the H100's) and
    the block's n-sized state (x, x₁, g twice, and the R − 1 other row
    lanes' shares, n4 floats each; K-B1 keeps x_acc besides); 0 where the
    state alone does not fit.  The arithmetic of ``state_bytes`` in
    csrc/tail_probe.cu; the card's ``_grid`` gives the same number."""
    if n4 < 4 or n4 % 4 or n4 > STATE_MAX_N:
        raise ValueError(f"tail_budget needs n4 a multiple of 4 in 4.."
                         f"{STATE_MAX_N}, got {n4}")
    R = dense_lanes(n4)[1]
    return max(0, optin - static - 4 * n4 * (3 + R))


def tail_plan(m: int, n4: int, nblocks: int, budget: int) -> DensePlan:
    """Where a ladder launch over an (m, n4) matrix keeps its rows: K-B1's
    ``dense_plan`` (bands of rows, the first step's rows in registers up
    to 2048 columns, then shared memory up to ``budget`` bytes a block,
    the rest read from L2 once a pass), with the probe's budget
    (``tail_budget``).  The probe holds the n-sized state in every block,
    so past ``STATE_MAX_N`` columns there is no plan: raises."""
    if n4 > STATE_MAX_N:
        raise ValueError(f"tail_plan: the ladder holds at most {STATE_MAX_N} "
                         f"columns in every block, got n4 = {n4}")
    return dense_plan(m, n4, nblocks, budget)


def make(level: int, col: bool = False, thread: bool = False,
         vecscal: bool = False, fusedred: bool = False,
         condbt: bool = False):
    """``run(A, b, x0, K) -> TailOutput`` for rung ``level`` (0..6) or,
    with one flag, that X variant of L6.  CUDA tensors launch kernel K-P3
    (contiguous, 16-byte aligned float32, n % 4 == 0 and n ≤ 8192;
    anything else raises) on ``tail_plan``'s plan at the card's budget;
    CPU tensors run the plain version."""
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


def _launch(level, variant, A, b, x0, K, plan=None) -> TailOutput:
    """One launch on ``plan`` (``tail_plan``'s at the card's budget when
    None); allocates nothing but the outputs (the partials, g and the
    barrier's counter live in the stream's scratch)."""
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
    if n > STATE_MAX_N:
        raise ValueError(f"the tail probe kernel holds at most "
                         f"{STATE_MAX_N} columns in every block, got n = {n}")
    dev = A.device
    if plan is None:
        plan, tiles, nb = _tiles(dev.index, m, n)
    else:
        if (plan.m, plan.n4) != (m, n):
            raise ValueError(f"the plan is for {plan.m}x{plan.n4}, not "
                             f"{m}x{n}")
        _grid(dev.index, n)      # sets the kernels' shared-memory cap
        tiles, nb = _table(plan, dev), len(plan.bands)
    f32 = dict(device=dev, dtype=torch.float32)
    x, g, tau = torch.empty(n, **f32), torch.empty(n, **f32), \
        torch.empty(1, **f32)
    taus, res = torch.empty(RECORDS, **f32), torch.empty(RECORDS, **f32)
    trials = torch.empty(1, device=dev, dtype=torch.int32)
    with _build.on_device(dev) as stream:
        work = _build.stream_scratch(dev, stream, _work(m, n, nb))
        _build.check(_build.library().fasta_tail_probe(
            level, variant, A.data_ptr(), b.data_ptr(), x0.data_ptr(), m, n,
            K, x.data_ptr(), g.data_ptr(), tau.data_ptr(), taus.data_ptr(),
            res.data_ptr(), trials.data_ptr(), tiles.data_ptr(),
            max(plan.smem_rows), work.data_ptr(), nb, stream),
            "fasta_tail_probe")
    return TailOutput(x, g, tau[0], taus, res, trials[0])


@functools.lru_cache(maxsize=None)
def _grid(device_index: int, n: int):
    """(blocks of the cooperative grid, shared-memory bytes a block has
    for rows of A, the device's per-block opt-in, the kernels' static
    shared memory) at width n on the device."""
    return _rows_grid(device_index, "fasta_tail_probe_grid", n)


@functools.lru_cache(maxsize=64)
def _tiles(device_index: int, m: int, n: int):
    """The card's plan for (m, n), its table on the card and its grid."""
    nb, budget = _grid(device_index, n)[:2]
    plan = tail_plan(m, n, nb, budget)
    return plan, _table(plan, torch.device("cuda", device_index)), nb


@functools.lru_cache(maxsize=None)
def _work(m: int, n: int, nblocks: int) -> int:
    return _build.ints("fasta_tail_probe_work", m, n, nblocks)[0]
