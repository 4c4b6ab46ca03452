"""Kernels K-B6, K-B6p and K-B6b: whole TV-dual solves in one launch.

K-B6, ``microsolve_tv``: the whole adaptive or FISTA solve of the TV
denoising dual  min_p ½‖μ·div p − b‖²  s.t. ‖p‖∞ ≤ 1  for a dual field p
(2, H, W) and an image b (H, W); port of
``fasta_tpu/kernels/microsolver_tv.py:34-538, 547-654`` (pallas_call at
:607).  K-B6p, ``microsolve_tv_path``: the same solve over a path of TV
weights in one launch, warm (each point from the previous dual field and,
adaptive, its last accepted stepsize) or cold (each point as a separate
``microsolve_tv`` call); port of ``microsolver_tv.py:664-790`` (pallas_call
at :731).  K-B6b, ``microsolve_tv_batch``: B images under one TV
weight, each with its own start and τ₀, in one launch; port of
``microsolve_tv`` under ``jax.vmap`` (``fasta_tpu/micro.py:435``).

The CUDA source is ``fasta_tpu_torch/csrc/microsolver_tv.cu``; its
header note gives the design.  Each block of the launch owns a band of
whole rows (``band_plan``); an image whose widest band fits a block's
shared memory takes the resident route, which keeps the band's state on
the chip for the whole solve, and a larger one the global route, which
keeps it in a work buffer in device memory.  Each wrapper launches the
kernel for CUDA tensors and runs its plain version (``microsolve_tv_reference``,
``microsolve_tv_path_reference``, ``microsolve_tv_batch_reference``: K-B1's
plain loop over the TV stencils, the same phases in PyTorch) for CPU
tensors.  Outputs are
:class:`~fasta_tpu_torch.kernels.microsolver.MicrosolveOutput`s without
iterates: a TV trajectory is a (2, H, W) field per iteration, which the
JAX kernel does not record either.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..options import STOP_RULES
from . import _build
from .microsolver import (MicrosolveOutput, _check_batch, _check_options,
                          _outputs, _points, _ptr, batch_reference,
                          path_reference, solve_reference)

__all__ = ["microsolve_tv", "microsolve_tv_reference", "microsolve_tv_path",
           "microsolve_tv_path_reference", "microsolve_tv_batch",
           "microsolve_tv_batch_reference", "band_plan", "BandPlan",
           "LAUNCHES", "PATH_LAUNCHES", "BATCH_LAUNCHES",
           "LAUNCHES_RESIDENT", "PATH_LAUNCHES_RESIDENT",
           "BATCH_LAUNCHES_RESIDENT"]

# Launches of the whole-solve kernel for one solve (K-B6), for a path
# (K-B6p) and for a batch (K-B6b), each counted where it launches, nowhere
# else; the _RESIDENT counts are the launches among them that took the
# resident route.
LAUNCHES = 0
PATH_LAUNCHES = 0
BATCH_LAUNCHES = 0
LAUNCHES_RESIDENT = 0
PATH_LAUNCHES_RESIDENT = 0
BATCH_LAUNCHES_RESIDENT = 0

# The kernel's per-pixel state slots and per-block edge rows
# (csrc/microsolver_tv.cu, StateSlot and EdgeSlot).
STATE_SLOTS = 12
EDGE_SLOTS = 14

# The JAX kernel's defaults (microsolver_tv.py:547-552): hp on.
_DEFAULTS = dict(max_iters=2000, window=10, tol=1e-5, shrink_factor=0.2,
                 max_backtracks=20, hp=True, stop_rule="hybrid_residual",
                 accelerate=False, restart=True, restart_dd=False,
                 record_fvals=False, record_bts=False, record_objs=False,
                 record_nres=False)


def _options(options):
    unknown = set(options) - set(_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown option(s) {sorted(unknown)}")
    o = {**_DEFAULTS, **options}
    _check_options("lstsq", "box", o["stop_rule"], o["window"],
                   o["max_iters"])
    # the plain loop's loss and prox: ½‖·−b‖² and the [−1,1] box
    return {**o, "loss": "lstsq", "prox": "box"}


def _check(b, p0, what):
    if b.ndim != 2 or p0.ndim != 3 or p0.shape[0] != 2 or \
            tuple(p0.shape[1:]) != tuple(b.shape):
        raise ValueError(f"{what} needs b (H,W) and p0 (2,H,W); got "
                         f"{tuple(b.shape)} and {tuple(p0.shape)}")
    for name, t in (("b", b), ("p0", p0)):
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32, got "
                             f"{t.dtype}")
    if b.device != p0.device:
        raise ValueError(f"{what}: b and p0 must share a device")
    if b.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {b.device}")


def microsolve_tv(b, p0, tau0, mu, **options) -> MicrosolveOutput:
    """Whole solve of the TV dual with weight ``mu`` in one launch.

    Same options and math as the TPU kernel: nonmonotone backtracking
    over a ``window`` of f-values, the Zhou–Gao–Dai BB stepsize or, with
    ``accelerate``, FISTA with O'Donoghue–Candès ``restart``
    (``restart_dd`` takes the restart dot in float64 under hp), the five
    stop rules and the halt code.  ``hp`` (default on, as in JAX)
    accumulates the decision scalars in float64.  ``record_fvals``,
    ``record_bts``, ``record_objs`` (the prox-point f, g being the box
    indicator) and ``record_nres`` add series; ``iterates`` is None.

    CUDA tensors launch kernel K-B6; CPU tensors run the plain version."""
    o = _options(options)
    _check(b, p0, "microsolve_tv")
    if b.device.type == "cpu":
        return microsolve_tv_reference(b, p0, tau0, mu, **options)
    out, resident = _launch(b, p0, tau0, torch.tensor([float(mu)]), 1, False,
                            o)
    global LAUNCHES, LAUNCHES_RESIDENT
    LAUNCHES += 1
    LAUNCHES_RESIDENT += resident
    return MicrosolveOutput(*(None if t is None else t[0] for t in out))


def microsolve_tv_path(b, p0, tau0, mus, *, warm=True,
                       **options) -> MicrosolveOutput:
    """The solve of ``microsolve_tv`` for each TV weight of ``mus`` (B,)
    in one launch; every output field gains a leading axis of B points.

    ``warm=True``: point i starts from point i−1's dual field and, in
    adaptive mode, its last genuinely accepted stepsize (fewer than
    ``max_backtracks`` trials, τ > 0), else τ₀; FISTA keeps τ₀.  A
    nonfinite point sends the next one back to ``p0`` with its own start
    τ (the JAX code, ``microsolver_tv.py:171-187, 528-535``).
    ``warm=False`` solves every point cold: each is bit-identical to a
    separate ``microsolve_tv`` call on the same device.

    CUDA tensors launch kernel K-B6p; CPU tensors run the plain version."""
    o = _options(options)
    _check(b, p0, "microsolve_tv_path")
    mus = torch.as_tensor(mus, dtype=torch.float32)
    if mus.ndim != 1 or mus.shape[0] < 1:
        raise ValueError("microsolve_tv_path: mus must be a non-empty 1-D "
                         "vector of TV weights")
    if b.device.type == "cpu":
        return microsolve_tv_path_reference(b, p0, tau0, mus, warm=warm,
                                            **options)
    out, resident = _launch(b, p0, tau0, mus.cpu(), mus.shape[0], warm, o)
    global PATH_LAUNCHES, PATH_LAUNCHES_RESIDENT
    PATH_LAUNCHES += 1
    PATH_LAUNCHES_RESIDENT += resident
    return MicrosolveOutput(*out)


def microsolve_tv_batch(bs, p0s, tau0s, mu, **options) -> MicrosolveOutput:
    """The solve of ``microsolve_tv`` for B images ``bs`` (B, H, W) under
    one TV weight ``mu`` in one launch, from starts ``p0s`` (B, 2, H, W) or
    one shared (2, H, W), with τ₀ a number or a (B,) tensor.  Every output
    field gains a leading axis of B images, each bit-identical to a
    separate ``microsolve_tv`` call on the same device.

    CUDA tensors launch kernel K-B6b; CPU tensors run the plain version."""
    o = _options(options)
    B = _check_batch(bs, bs, p0s, tau0s, 2, "microsolve_tv_batch")
    _check(bs[0], p0s if p0s.ndim == 3 else p0s[0], "microsolve_tv_batch")
    if bs.device.type == "cpu":
        return microsolve_tv_batch_reference(bs, p0s, tau0s, mu, **options)
    out, resident = _launch(bs, p0s, tau0s, torch.tensor([float(mu)]), B,
                            False, o)
    global BATCH_LAUNCHES, BATCH_LAUNCHES_RESIDENT
    BATCH_LAUNCHES += 1
    BATCH_LAUNCHES_RESIDENT += resident
    return MicrosolveOutput(*out)


class BandPlan(NamedTuple):
    """Which rows each block of a launch owns (``rows[k]`` = (first, end)),
    the blocks that own the row above and the row below each band (−1:
    none), the widest band and the route."""
    rows: tuple
    above: tuple
    below: tuple
    band_rows: int
    resident: bool


def resident_bytes(band_rows: int, W: int) -> int:
    """Shared memory a block of the resident route takes: the band's
    state slots, the r row below it and a copy of the neighbours' six edge
    rows (csrc/microsolver_tv.cu, ``resident_bytes``)."""
    return 4 * (STATE_SLOTS * band_rows * W + 7 * W)


def band_plan(H: int, W: int, nblocks: int, budget: int) -> BandPlan:
    """The band plan of an (H, W) image over ``nblocks`` blocks: block k
    owns rows ⌊kH/nblocks⌋ to ⌊(k+1)H/nblocks⌋ (none where the two
    agree), and the resident route is taken when the widest band's state
    fits ``budget`` bytes of shared memory.  A pure function of its
    arguments."""
    if min(H, W, nblocks) < 1 or budget < 0:
        raise ValueError(f"band_plan needs H, W, nblocks >= 1 and budget "
                         f">= 0; got {(H, W, nblocks, budget)}")
    starts = [k * H // nblocks for k in range(nblocks + 1)]
    rows = tuple(zip(starts[:-1], starts[1:]))
    # owner[r]: the block whose band holds row r
    owner = [k for k, (r0, r1) in enumerate(rows) for _ in range(r0, r1)]
    above = tuple(owner[r0 - 1] if r1 > r0 > 0 else -1 for r0, r1 in rows)
    below = tuple(owner[r1] if r0 < r1 < H else -1 for r0, r1 in rows)
    band_rows = max(r1 - r0 for r0, r1 in rows)
    return BandPlan(rows, above, below, band_rows,
                    resident_bytes(band_rows, W) <= budget)


@functools.lru_cache(maxsize=None)
def _grid(device_index: int):
    """(blocks of the cooperative grid, shared-memory budget of a block of
    the resident route) on the device."""
    nb, budget = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        _build.check(_build.library().fasta_microsolve_tv_grid(
            ctypes.byref(nb), ctypes.byref(budget)),
            "fasta_microsolve_tv_grid")
    if nb.value < 1:
        raise RuntimeError("the TV whole-solve kernel cannot be resident on "
                           "this device")
    return nb.value, budget.value


@functools.lru_cache(maxsize=64)
def _bands(device_index: int, H: int, W: int):
    """The band plan for an (H, W) image on the device and its (4,
    nblocks) int32 table on the card: first rows, end rows, the blocks
    above and below."""
    plan = band_plan(H, W, *_grid(device_index))
    table = torch.tensor([[r0 for r0, _ in plan.rows],
                          [r1 for _, r1 in plan.rows], list(plan.above),
                          list(plan.below)], dtype=torch.int32)
    return plan, table.to(torch.device("cuda", device_index))


def _launch(b, p0, tau0, mus, B, warm, o):
    """One launch over B points: b (H, W) or (B, H, W), p0 (2, H, W) or
    (B, 2, H, W), τ₀ a number or (B,), mus (1,) shared or (B,).  Returns
    the outputs and whether the launch took the resident route."""
    b, p0 = b.contiguous(), p0.contiguous()
    H, W = b.shape[-2:]
    K = o["max_iters"]
    dev = b.device
    nb = _grid(dev.index)[0]
    plan, bands = _bands(dev.index, H, W)
    f32 = dict(device=dev, dtype=torch.float32)
    mus_d = mus.to(**f32)
    b_stride, p0_stride, tau0s, tau0 = _points(B, b, 2, p0, 3, tau0, dev)
    x = torch.empty(B, 2, H, W, **f32)
    r = _outputs(B, K, o, dev, nb)
    # the band state of the global route; the edge rows of every block;
    # the grid barrier's counter — one set that every point reuses
    state = None if plan.resident else torch.empty(STATE_SLOTS * H * W,
                                                   **f32)
    edge = torch.empty(EDGE_SLOTS * nb * W, **f32)
    bar = torch.zeros(1, device=dev, dtype=torch.int32)

    flags = (int(bool(o["hp"])) | int(bool(o["accelerate"])) << 1
             | int(bool(o["restart"])) << 2 | int(bool(o["restart_dd"])) << 3
             | int(bool(warm)) << 4)
    with _build.on_device(dev) as stream:
        _build.check(_build.library().fasta_microsolve_tv(
            b.data_ptr(), b_stride, p0.data_ptr(), p0_stride,
            mus_d.data_ptr(), int(mus_d.numel() > 1), _ptr(tau0s), B, tau0,
            H, W, K, o["window"], float(o["tol"]), float(o["shrink_factor"]),
            o["max_backtracks"], STOP_RULES.index(o["stop_rule"]), flags,
            x.data_ptr(), r.taus.data_ptr(), r.res.data_ptr(),
            _ptr(r.fvals), _ptr(r.bts), _ptr(r.objs), _ptr(r.nres),
            r.k.data_ptr(), r.halt.data_ptr(), bands.data_ptr(),
            plan.band_rows, int(plan.resident), _ptr(state), edge.data_ptr(),
            bar.data_ptr(), r.work_d.data_ptr(), nb, stream),
            "fasta_microsolve_tv")
    return ((x, r.taus, r.res, r.k, r.halt, r.fvals, r.bts, r.objs, None,
             r.nres), plan.resident)


# --------------------------------------------------------------------------
# The plain versions
# --------------------------------------------------------------------------

def _solve(b, p, tau0, mu, o):
    """One plain TV solve: K-B1's plain loop with fwd = μ·div and
    adj = μ·grad (the JAX kernel's ``fwd``/``adj``, through
    ``ScaledOp(μ, TVDiv2D())``)."""
    from ..operators import ScaledOp, TVDiv2D
    op = ScaledOp(float(mu), TVDiv2D())
    return solve_reference(op, op.rmatvec, b, p, tau0, 0.0, False, o)


def microsolve_tv_reference(b, p0, tau0, mu, **options) -> MicrosolveOutput:
    """The plain version of K-B6, in torch on b's device.  With ``hp``
    the f-values, the window, the backtracking dot, the BB numerator and
    (with ``restart_dd``) the restart dot accumulate in float64; only the
    order of the float32 sums differs from the kernel."""
    return _solve(b, p0, tau0, mu, _options(options))[0]


def microsolve_tv_batch_reference(bs, p0s, tau0s, mu,
                                  **options) -> MicrosolveOutput:
    """The plain version of K-B6b: the plain K-B6 solve per image, its
    outputs stacked on a leading axis."""
    o = _options(options)
    return batch_reference(
        lambda b, p0, tau0: _solve(b, p0, tau0, mu, o)[0], bs, p0s, tau0s, 3)


def microsolve_tv_path_reference(b, p0, tau0, mus, *, warm=True,
                                 **options) -> MicrosolveOutput:
    """The plain version of K-B6p: the plain K-B6 solve per path point,
    with the kernel's warm carry of the dual field and τ."""
    o = _options(options)
    return path_reference(lambda p, tau, mu: _solve(b, p, tau, mu, o), p0,
                          tau0, mus, warm, o["accelerate"])
