"""Kernel K-B7: the fused planar-complex gradient map in one read of the
two channel matrices.

``fused_planar_lstsq_gradmap(Ar, Ai, x, b)`` returns (d, f, g) for
f(x) = ½‖Ax − b‖² and ``fused_planar_hinge_gradmap(Ar, Ai, x, b)`` for the
PhaseMax hinge f(x) = ½ Σ max(|Ax| − b, 0)², on planar complex
A = Ar + i·Ai (m, n), x (n, 2), d (m, 2), g (n, 2); port of
``fasta_tpu/kernels/planar_fused.py:75-256`` (pallas_call at :197).  The
channels are float32 or bfloat16 (upcast to float32 in the kernel, x and
the outputs float32; the plain versions upcast them too).  Both
run the CUDA source ``fasta_tpu_torch/csrc/planar_fused.cu`` (its header
note gives the design) with a loss code; ``gradmap_plan`` is its launch
plan.  Each wrapper launches the kernel for CUDA tensors and runs its plain
version (``planar_lstsq_gradmap_reference``,
``planar_hinge_gradmap_reference``) for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

__all__ = ["fused_planar_lstsq_gradmap", "fused_planar_hinge_gradmap",
           "planar_lstsq_gradmap_reference", "planar_hinge_gradmap_reference",
           "gradmap_plan", "GradmapPlan", "LOSSES", "LAUNCHES",
           "BF16_LAUNCHES"]

# Launches of the CUDA kernel, either loss, over float32 and over bfloat16
# channels, counted where it launches, nowhere else.
LAUNCHES = 0
BF16_LAUNCHES = 0

# The storage types of the channels the kernel takes
DTYPES = (torch.float32, torch.bfloat16)

# The kernel's loss codes, in order (csrc/planar_fused.cu).
LOSSES = ("lstsq", "hinge")

# The plan's constants (csrc/planar_fused.cu: kThreads, kWarps, kWideTile,
# kCluster): threads a block, warps a block, rows a tile of route 3, and
# blocks a thread-block cluster.
THREADS = 512
WARPS = THREADS // 32
WIDE_TILE = 8
CLUSTER = 8


class GradmapPlan(NamedTuple):
    """How a launch of K-B7 covers an m×n pair of channels.  ``route`` 1
    takes a row a warp (n ≤ 512), 2 a row a block (n ≤ 8192; 2048 when
    rows are not 16-byte aligned), 3 a tile of up to WIDE_TILE rows a
    block; a thread owns ``cpt`` column groups of ``vec`` values (route 3:
    0).  ``blocks`` is a whole number of clusters of CLUSTER; block k takes
    the rows its route's grid-stride walk gives it (none, in the padding):
    route 1 rows k·WARPS + w, + blocks·WARPS, … (warp w), route 2 rows k,
    k + blocks, …, route 3 tiles k, k + blocks, … of ``tile_rows`` rows
    (1 on routes 1 and 2).  ``smem_bytes`` of dynamic shared memory a
    block, ``scratch_doubles`` of the stream's scratch: the ticket, an f
    partial a cluster, then from an even word a (2n,) gradient partial a
    cluster and, on route 3, a row a block."""
    route: int
    vec: int
    cpt: int
    blocks: int
    smem_bytes: int
    tile_rows: int
    scratch_doubles: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def gradmap_plan(m: int, n: int, bf16: bool, cluster_slots: int
                 ) -> GradmapPlan:
    """K-B7's plan for m×n channels stored as float32 or (``bf16``)
    bfloat16 on a card that holds ``cluster_slots`` clusters of the
    route's kernel at once (csrc/planar_fused.cu, ``plan``, computes the
    same on the card).  A pure function of its arguments; refuses empty
    shapes."""
    if m < 1 or n < 1 or cluster_slots < 1:
        raise ValueError(f"gradmap_plan takes m, n >= 1 and a card that "
                         f"holds a cluster (got m={m}, n={n}, "
                         f"cluster_slots={cluster_slots})")
    wide = 8 if bf16 else 4            # values of a 16-byte load
    vec = wide if n % wide == 0 else 1
    ng = n // vec
    # the float32 registers of a thread's columns bound routes 1 and 2
    warp_slots, block_slots = 16 // vec, 4 if vec == 1 else 16 // vec
    if ng <= 32 * warp_slots:
        route, cpt, rows = 1, _pow2_at_least(_cdiv(ng, 32)), WARPS
    elif ng <= THREADS * block_slots:
        route, rows = 2, 1
        cpt = _pow2_at_least(_cdiv(ng, THREADS))
        cpt = max(cpt, 2) if vec == 1 else cpt
    else:               # at least a row a block, then tiles of WIDE_TILE
        route, cpt, rows = 3, 0, 1
    clusters = min(_cdiv(m, rows * CLUSTER), cluster_slots)
    tile_rows = 1
    if route == 3:      # the tiles as even over the blocks as WIDE_TILE
        blocks = CLUSTER * clusters     # allows, then the clusters they need
        rounds = _cdiv(m, blocks * WIDE_TILE)
        tile_rows = _cdiv(m, blocks * rounds)
        clusters = _cdiv(_cdiv(_cdiv(m, tile_rows), rounds), CLUSTER)
    blocks = CLUSTER * clusters
    width = 2 * n
    smem = 4 * width * {1: WARPS + 1, 2: 1, 3: 0}[route]
    floats = clusters * width * (1 + (CLUSTER if route == 3 else 0))
    scratch = ((clusters + 2) & ~1) + _cdiv(floats, 2)
    return GradmapPlan(route, vec, cpt, blocks, smem, tile_rows, scratch)


def planar_lstsq_gradmap_reference(Ar, Ai, x, b):
    """The plain two-pass form over ``PlanarDenseOp``: d = A x, r = d − b,
    f = ½‖r‖², g = Aᴴr (bfloat16 channels upcast, as the operator
    does)."""
    from ..operators import PlanarDenseOp
    op = PlanarDenseOp(Ar, Ai)
    d = op(x)
    r = d - b
    return d, 0.5 * torch.sum(r * r), op.rmatvec(r)


def planar_hinge_gradmap_reference(Ar, Ai, x, b):
    """The plain two-pass form of the hinge over ``PlanarDenseOp``:
    d = A x, r = max(|d| − b, 0), f = ½Σr², g = Aᴴ(r/max(|d|, 1e-30)·d)."""
    from ..operators import PlanarDenseOp
    from ..terms import phase_hinge_parts
    op = PlanarDenseOp(Ar, Ai)
    d = op(x)
    r, s = phase_hinge_parts(torch.sqrt(torch.sum(d * d, dim=-1)), b)
    return d, 0.5 * torch.sum(r * r), op.rmatvec(s[:, None] * d)


def _check(Ar, Ai, x, b, planar_b, what):
    if Ar.ndim != 2 or Ar.shape != Ai.shape or x.ndim != 2 or \
            x.shape[-1] != 2:
        raise ValueError(f"{what} needs Ar, Ai (m,n) and x (n,2); got "
                         f"{tuple(Ar.shape)}, {tuple(Ai.shape)}, "
                         f"{tuple(x.shape)}")
    m, n = Ar.shape
    want = (m, 2) if planar_b else (m,)
    if x.shape[0] != n or tuple(b.shape) != want:
        raise ValueError(f"{what}: x {tuple(x.shape)} and b "
                         f"{tuple(b.shape)} for A {m}x{n} (b must be "
                         f"{want})")
    if len({Ar.device, Ai.device, x.device, b.device}) != 1:
        raise ValueError(f"{what}: Ar, Ai, x and b must share a device")
    if Ar.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {Ar.device}")


def fused_planar_lstsq_gradmap(Ar, Ai, x, b):
    """One-pass (d: (m,2), f: 0-d, g: (n,2)) for f(x) = ½‖Ax − b‖², b (m,2).

    CUDA tensors launch kernel K-B7, at any shape, and must be
    contiguous and 16-byte aligned, Ar and Ai float32 or bfloat16 (one
    type) and x, b float32; anything else raises.  CPU tensors run the
    plain version."""
    _check(Ar, Ai, x, b, True, "fused_planar_lstsq_gradmap")
    if Ar.device.type == "cpu":
        return planar_lstsq_gradmap_reference(Ar, Ai, x, b)
    return _launch(Ar, Ai, x, b, 0, "fused_planar_lstsq_gradmap")


def fused_planar_hinge_gradmap(Ar, Ai, x, b):
    """One-pass (d: (m,2), f: 0-d, g: (n,2)) for the PhaseMax hinge
    f(x) = ½ Σ max(|Ax| − b, 0)², b (m,) magnitudes.

    CUDA tensors launch kernel K-B7 under the rules of
    :func:`fused_planar_lstsq_gradmap`; CPU tensors run the plain
    version."""
    _check(Ar, Ai, x, b, False, "fused_planar_hinge_gradmap")
    if Ar.device.type == "cpu":
        return planar_hinge_gradmap_reference(Ar, Ai, x, b)
    return _launch(Ar, Ai, x, b, 1, "fused_planar_hinge_gradmap")


@functools.lru_cache(maxsize=None)
def _card_plan(device_index: int, m: int, n: int, bf16: bool = False):
    """(route, column slots per thread, blocks, dynamic shared bytes, tile
    rows, cluster slots) as the card plans an m×n pair of float32 or
    (``bf16``) bfloat16 channels (csrc/planar_fused.cu)."""
    lib = _build.library()
    out = [ctypes.c_int() for _ in range(6)]
    with torch.cuda.device(device_index):
        _build.check(lib.fasta_planar_gradmap_plan(
            m, n, int(bf16), *(ctypes.byref(v) for v in out)),
            "fasta_planar_gradmap_plan")
    return tuple(v.value for v in out)


@functools.lru_cache(maxsize=None)
def _plan(device_index: int, m: int, n: int, bf16: bool = False
          ) -> GradmapPlan:
    """The launch plan on the device: ``gradmap_plan`` at the card's
    cluster slots for the route's kernel."""
    return gradmap_plan(m, n, bf16, _card_plan(device_index, m, n, bf16)[5])


def _launch(Ar, Ai, x, b, loss_code, what):
    ptrs = []
    for name, t, types in (("Ar", Ar, DTYPES), ("Ai", Ai, (Ar.dtype,)),
                           ("x", x, DTYPES[:1]), ("b", b, DTYPES[:1])):
        if t.dtype not in types or not t.is_contiguous():
            kinds = " or ".join(str(d).removeprefix("torch.") for d in types)
            raise ValueError(f"{what}: {name} must be a contiguous {kinds} "
                             f"tensor, got {t.dtype}")
        ptrs.append(t.data_ptr())
        if ptrs[-1] % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    m, n = Ar.shape
    dev = Ar.device
    if torch.cuda.current_device() != dev.index:
        with torch.cuda.device(dev):
            return _launch(Ar, Ai, x, b, loss_code, what)
    bf16 = Ar.dtype == torch.bfloat16
    plan = _plan(dev.index, m, n, bf16)
    d = torch.empty((m, 2), device=dev, dtype=torch.float32)
    g = torch.empty((n, 2), device=dev, dtype=torch.float32)
    f = torch.empty((), device=dev, dtype=torch.float32)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    work = _build.stream_scratch(dev, stream, plan.scratch_doubles)
    err = _build.library().fasta_planar_gradmap(
        *ptrs, m, n, int(bf16), loss_code, plan.route, plan.cpt,
        plan.blocks, plan.smem_bytes, plan.tile_rows, d.data_ptr(),
        f.data_ptr(), g.data_ptr(), work.data_ptr(), stream)
    if err:
        _build.check(err, what)
    global LAUNCHES, BF16_LAUNCHES
    if bf16:
        BF16_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return d, f, g
