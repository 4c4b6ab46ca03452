"""Kernels K-B8 and K-B8b: the whole planar PhaseMax solve in one launch.

``microsolve_planar_phasemax`` runs the adaptive or FISTA solve of
min ½ Σ max(|Ax| − b, 0)² − ⟨c, x⟩ on planar x (n, 2), A = Ar + i·Ai
(m, n), b (m,) magnitudes, c (n, 2) the anchor; port of
``fasta_tpu/kernels/microsolver_planar.py:45-64, 606-722`` (pallas_call at
:669).  ``microsolve_planar_phasemax_batch`` (K-B8b) solves B instances
sharing A, each with its own b, x₀ and τ₀ and with one shared anchor c
or its own, in one launch; port of the kernel under ``jax.vmap``
(``fasta_tpu/micro.py:435``, whose instances share c).  The CUDA
source is ``fasta_tpu_torch/csrc/microsolver_planar.cu``
(its header note gives the design).  ``tile_plan`` decides, on the
host, which rows of the channel matrices each block of a launch keeps on
the chip for the whole solve and which route runs: n ≤ 512 (padded) a
warp a row, up to 8192 the wide route (a row over a block), past it the
column fallback.  The wrappers launch the
kernel for CUDA tensors and run the plain versions
(``microsolve_planar_phasemax_reference``: K-B1's plain loop over the
planar pair with the hinge and the anchor, per instance for the batch)
for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple

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
           "supports_planar_microsolver", "row_chunk", "tile_plan", "TilePlan",
           "row_budget", "H100_SMEM_OPTIN", "H100_STATIC_SMEM",
           "WIDE_N", "WIDE_MAX_N", "REG_N", "REG_ROWS", "LAUNCHES",
           "BATCH_LAUNCHES", "WIDE_LAUNCHES", "WIDE_BATCH_LAUNCHES",
           "RESIDENT_LAUNCHES", "STREAMED_LAUNCHES", "COLUMN_LAUNCHES"]

# Launches of the whole-solve kernel for one solve (K-B8) and for a batch
# (K-B8b), on the route for n ≤ WIDE_N and past it, each counted where it
# launches, nowhere else.
LAUNCHES = 0
BATCH_LAUNCHES = 0
WIDE_LAUNCHES = 0
WIDE_BATCH_LAUNCHES = 0
# The same launches (K-B8 and K-B8b, every width) by the tile plan's
# route: every row of A on the chip for the whole launch ("resident"),
# some rows read from L2 every trial ("streamed"), or the column fallback.
RESIDENT_LAUNCHES = 0
STREAMED_LAUNCHES = 0
COLUMN_LAUNCHES = 0

# The widest signal (after padding to a multiple of 4) whose rows a warp
# takes, its lanes holding a row's columns in registers; wider signals
# take the wide route, a row spread over a block, up to WIDE_MAX_N, where
# a thread's four float4 slots of g span a row (the n-sized state in
# every block's shared memory up to 2048, in device memory past it);
# wider still, the column fallback (csrc/microsolver_planar.cu,
# kNarrowMax, kStateMax and kWideMax).
WIDE_N = 512
WIDE_MAX_N = 8192
# Up to REG_N columns each warp of the route for n ≤ WIDE_N keeps its
# first two rows of the band in registers: REG_ROWS rows a block
# (csrc/microsolver_planar.cu, kRegRows).
REG_N = 256
REG_ROWS = 32
# A block of the route for n ≤ WIDE_N sums its warps' gradient shares in
# eight buffers (kGw); up to STATE_MAX_N a block keeps the n-sized state in
# its shared memory (kStateMax).
_GW = 8
STATE_MAX_N = 2048
# The H100's shared memory a block may opt into, and the static shared
# memory of the kernels with rows on the chip as nvcc lays them out for
# sm_90a, the most of the four instantiations that run at a width: up to
# WIDE_N (microsolve_planar_kernel, a warp a row), up to STATE_MAX_N (the
# same kernel with the wide rows, whose row sums take 2 KB more), past it
# (microsolve_planar_wide_kernel).  What ``row_budget`` takes by default;
# the card's own numbers come from ``_grid``, which a card test holds
# against these.
H100_SMEM_OPTIN = 232448
H100_STATIC_SMEM = (8000, 10240, 10256)

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
    to a multiple of 4 with zero columns), on the kernel and with the rows
    on the chip that ``tile_plan`` gives for the card; CPU tensors run the
    plain version."""
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
    Ar and Ai in one launch: magnitudes ``bs`` (B, m), anchors ``c``
    (B, n, 2) or one shared (n, 2), starts ``x0s`` (B, n, 2) or one shared
    (n, 2), τ₀ a number or a (B,) tensor.  Every output field gains a
    leading axis of B instances, each bit-identical to a separate
    ``microsolve_planar_phasemax`` call on the same device.

    CUDA tensors launch kernel K-B8b; CPU tensors run the plain version."""
    o = _options(options)
    what = "microsolve_planar_phasemax_batch"
    B = _check_batch(Ar, bs, x0s, tau0s, 1, what)
    if c.ndim == 3 and c.shape[0] != B:
        raise ValueError(f"{what}: {c.shape[0]} anchors for {B} instances")
    _check(Ar, Ai, bs[0], c if c.ndim == 2 else c[0],
           x0s if x0s.ndim == 2 else x0s[0], what)
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
    """The plain version of K-B8b: the plain K-B8 solve per instance, with
    its own anchor where ``c`` is (B, n, 2), its outputs stacked on a
    leading axis."""
    o = _options(options)
    # batch_reference solves the instances in order
    anchors = iter(c) if c.ndim == 3 else itertools.repeat(c)
    return batch_reference(
        lambda b, x0, tau0: _solve(Ar, Ai, b, next(anchors), x0, tau0,
                                   False, o),
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


class TilePlan(NamedTuple):
    """Where a launch over (m, n4) channel matrices keeps them: ``kernel``
    ("rows" for n4 ≤ WIDE_N, "wide" up to WIDE_MAX_N, "columns" past it),
    for each block its band of rows (``bands[k]`` = (first, end)) and how
    many of them it keeps in registers (``reg_rows``) and in shared memory
    (``smem_rows``), the rest being read from L2 once a trial; ``route``
    is "resident" when no block reads rows from L2, "streamed" when some
    do, "columns" on the column fallback (no bands)."""
    kernel: str
    route: str
    m: int
    n4: int
    bands: tuple
    reg_rows: tuple
    smem_rows: tuple

    @property
    def streamed_rows(self) -> int:
        """Rows of A read from L2 once a trial (all m on the column
        fallback)."""
        if self.kernel == "columns":
            return self.m
        return self.m - sum(self.reg_rows) - sum(self.smem_rows)

    @property
    def resident_share(self) -> float:
        """The share of A's rows kept on the chip for the whole launch."""
        return 1.0 - self.streamed_rows / self.m

    @property
    def streamed_bytes(self) -> int:
        """Bytes of A a trial reads from L2 (Ar and Ai, 8 bytes a padded
        complex column): the streamed rows once, or on the column fallback
        all of A twice, by rows and by columns."""
        reads = 2 if self.kernel == "columns" else 1
        return 8 * self.n4 * self.streamed_rows * reads


def tile_plan(m: int, n4: int, nblocks: int, budget: int) -> TilePlan:
    """The tile plan of an (m, n4) pair of channel matrices (n4 the
    padded width, a multiple of 4) over ``nblocks`` blocks whose shared
    memory holds ``budget`` bytes of rows each (the device's, from the
    kernel's ``_grid``, or smaller to force a streamed remainder).  Block
    k owns rows ⌊km/nblocks⌋ to ⌊(k+1)m/nblocks⌋; up to REG_N columns it
    keeps its first min(rows, REG_ROWS) rows in registers; the next rows,
    as many as ``budget`` holds at 8·n4 bytes a row, in shared memory; the
    rest it reads from L2.  Past WIDE_MAX_N the column fallback keeps none.
    A pure function of its arguments; raises on a shape no kernel takes."""
    if min(m, n4, nblocks) < 1 or n4 % 4 or budget < 0:
        raise ValueError(f"tile_plan needs m, nblocks >= 1, n4 a positive "
                         f"multiple of 4 and budget >= 0; got "
                         f"{(m, n4, nblocks, budget)}")
    if 2 * m * n4 >= 1 << 31:
        raise ValueError(f"tile_plan: a {m}x{n4} pair of channel matrices "
                         f"is past the kernel's 32-bit offsets")
    if n4 > WIDE_MAX_N:
        return TilePlan("columns", "columns", m, n4, (), (), ())
    starts = [k * m // nblocks for k in range(nblocks + 1)]
    bands = tuple(zip(starts[:-1], starts[1:]))
    per_reg = REG_ROWS if n4 <= REG_N else 0
    cap = budget // (8 * n4)
    reg = tuple(min(r1 - r0, per_reg) for r0, r1 in bands)
    smem = tuple(min(r1 - r0 - g, cap) for (r0, r1), g in zip(bands, reg))
    streamed = any(r1 - r0 > g + s
                   for (r0, r1), g, s in zip(bands, reg, smem))
    return TilePlan("rows" if n4 <= WIDE_N else "wide",
                    "streamed" if streamed else "resident", m, n4, bands,
                    reg, smem)


def row_budget(n4: int, optin: int = H100_SMEM_OPTIN,
               static: int | None = None) -> int:
    """The shared memory, in bytes, that a block of K-B8 at padded width
    n4 has for rows of A: the per-block opt-in ``optin`` less the kernel's
    static shared memory ``static`` (by default the H100's,
    ``H100_STATIC_SMEM``) and the block's state — up to STATE_MAX_N the
    n-sized state (six vectors of 2·n4 floats) beside the warps' eight
    gradient buffers (n4 ≤ WIDE_N) or the R − 1 other row lanes' shares
    (R = 512 over the row's float4 slots rounded up to a warp), wider the
    wide kernel's scratch (x₁, or the row lanes' shares where R > 2);
    0 on the column fallback or where the state alone does not fit.  The
    arithmetic of ``state_bytes`` in csrc/microsolver_planar.cu; the
    card's ``_grid`` gives the same number."""
    if n4 < 4 or n4 % 4:
        raise ValueError(f"row_budget needs n4 a positive multiple of 4, "
                         f"got {n4}")
    if n4 > WIDE_MAX_N:
        return 0
    if static is None:
        static = H100_STATIC_SMEM[(n4 > WIDE_N) + (n4 > STATE_MAX_N)]
    nq = n4 // 4
    R = 512 // min(512, -(-nq // 32) * 32)
    if n4 <= WIDE_N:
        state = 6 + _GW
    elif n4 <= STATE_MAX_N:
        state = 6 + R - 1
    else:
        state = R - 1 if R > 2 else 1
    return max(0, optin - static - 8 * n4 * state)


_KERNELS = ("rows", "wide", "columns")


@functools.lru_cache(maxsize=None)
def _grid(device_index: int, n4: int):
    """(blocks of the cooperative grid, shared-memory bytes a block has
    for rows of A, the device's per-block opt-in, the kernel's static
    shared memory) at padded width n4 on the device."""
    nb, budget, optin, static = (ctypes.c_int() for _ in range(4))
    with torch.cuda.device(device_index):
        _build.check(_build.library().fasta_microsolve_planar_grid(
            n4, ctypes.byref(nb), ctypes.byref(budget), ctypes.byref(optin),
            ctypes.byref(static)), "fasta_microsolve_planar_grid")
    if nb.value < 1:
        raise RuntimeError("the planar whole-solve kernel cannot be resident "
                           "on this device")
    return nb.value, budget.value, optin.value, static.value


def _table(plan: TilePlan, device):
    """The plan's (4, nblocks) int32 table on the card: first rows, end
    rows, rows in registers, rows in shared memory (None on the column
    fallback)."""
    if plan.kernel == "columns":
        return None
    return torch.tensor([[r0 for r0, _ in plan.bands],
                         [r1 for _, r1 in plan.bands], list(plan.reg_rows),
                         list(plan.smem_rows)],
                        dtype=torch.int32).to(device)


@functools.lru_cache(maxsize=64)
def _tiles(device_index: int, m: int, n4: int):
    """The tile plan for (m, n4) on the device, its table on the card and
    its grid."""
    nb, budget = _grid(device_index, n4)[:2]
    plan = tile_plan(m, n4, nb, budget)
    return plan, _table(plan, torch.device("cuda", device_index)), nb


@functools.lru_cache(maxsize=None)
def _work(m: int, n4: int, nblocks: int, kernel: int) -> int:
    nf = ctypes.c_int()
    _build.check(_build.library().fasta_microsolve_planar_work(
        m, n4, nblocks, kernel, ctypes.byref(nf)),
        "fasta_microsolve_planar_work")
    return nf.value


def _aligned(t):
    """t itself, or a copy where its data is not 16-byte aligned (the
    kernels read rows, c and x₀ as float4)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _count(plan: TilePlan) -> None:
    global RESIDENT_LAUNCHES, STREAMED_LAUNCHES, COLUMN_LAUNCHES
    if plan.route == "resident":
        RESIDENT_LAUNCHES += 1
    elif plan.route == "streamed":
        STREAMED_LAUNCHES += 1
    else:
        COLUMN_LAUNCHES += 1


def _launch(Ar, Ai, b, c, x0, tau0, B, record_its, o, plan=None):
    """One launch over B instances: b (m,) or (B, m), c and x0 (n, 2) or
    (B, n, 2), τ₀ a number or (B,); ``plan`` the tile plan, by default
    the device's (``_tiles``).  Counts the launch by its route."""
    m, n = Ar.shape
    n4 = (n + 3) // 4 * 4
    pad = n4 - n
    # a copy per launch only where the layout needs one: zero columns up to
    # a multiple of 4 (16-byte rows)
    Ar, Ai = (F.pad(Ar, (0, pad)), F.pad(Ai, (0, pad))) if pad else (Ar, Ai)
    c, x0 = (F.pad(c, (0, 0, 0, pad)), F.pad(x0, (0, 0, 0, pad))) if pad \
        else (c, x0)
    Ar, Ai, b, c, x0 = (_aligned(t.contiguous()) for t in (Ar, Ai, b, c, x0))
    dev = Ar.device
    K = o["max_iters"]
    if plan is None:
        plan, tiles, nb = _tiles(dev.index, m, n4)
    else:
        if (plan.m, plan.n4) != (m, n4):
            raise ValueError(f"the tile plan is for {plan.m}x{plan.n4}, not "
                             f"{m}x{n4}")
        tiles = _table(plan, dev)
        nb = len(plan.bands) if plan.bands else _grid(dev.index, n4)[0]
    kernel = _KERNELS.index(plan.kernel)
    f32 = dict(device=dev, dtype=torch.float32)
    b_stride, x0_stride, tau0s, tau0 = _points(B, b, 1, x0, 2, tau0, dev)
    c_stride = c[0].numel() if c.ndim == 3 else 0
    x = torch.empty((B, n, 2), **f32)
    r = _outputs(B, K, o, dev, nb)
    its = torch.zeros((B, K, n, 2), **f32) if record_its else None
    work_f = torch.empty(_work(m, n4, nb, kernel), **f32)
    flags = (int(bool(o["hp"])) | int(bool(o["accelerate"])) << 1
             | int(bool(o["restart"])) << 2 | int(bool(o["restart_dd"])) << 3)
    with _build.on_device(dev) as stream:
        # the grid barrier's counter and exit ticket, left at zero by every
        # launch on the stream
        bar = _build.stream_scratch(dev, stream, 1)
        _build.check(_build.library().fasta_microsolve_planar(
            Ar.data_ptr(), Ai.data_ptr(), b.data_ptr(), b_stride,
            c.data_ptr(), c_stride, x0.data_ptr(), x0_stride, _ptr(tau0s), B,
            tau0, m, n, n4, K, o["window"],
            float(o["tol"]), float(o["shrink_factor"]), o["max_backtracks"],
            STOP_RULES.index(o["stop_rule"]), flags, x.data_ptr(),
            r.taus.data_ptr(), r.res.data_ptr(), _ptr(r.fvals), _ptr(r.bts),
            _ptr(r.objs), _ptr(r.nres), _ptr(its), r.k.data_ptr(),
            r.halt.data_ptr(), _ptr(tiles), kernel,
            max(plan.smem_rows, default=0), bar.data_ptr(),
            work_f.data_ptr(), r.work_d.data_ptr(), nb, stream),
            "fasta_microsolve_planar")
    _count(plan)
    return x, r.taus, r.res, r.k, r.halt, r.fvals, r.bts, r.objs, its, r.nres
