"""Kernels K-B3 and K-B3p: fused gradient maps in one read of A.

K-B3, ``fused_lstsq_gradmap``: (d, f, g) = (Ax, ½‖Ax−b‖², Aᵀ(Ax−b)),
port of ``fasta_tpu/kernels/lstsq_fused.py:148-164, 368-452``.  K-B3p,
``fused_pointwise_gradmap``: (d, f, g) = (Ax, Σℓ(Ax; y), Aᵀℓ′(Ax)) for
the logistic loss and the squared hinge, port of
``lstsq_fused.py:246-365``.  A is stored as float32 or bfloat16 (the
mixed-precision path, ``lstsq_fused.py:292-452``: a bfloat16 A is upcast
to float32 in the kernel, x and the outputs are float32).  Both run the
same CUDA source, ``fasta_tpu_torch/csrc/lstsq_fused.cu`` (its header
note gives the design), with a loss code: one kernel a call, its route
and grid as ``gradmap_plan`` gives them.  Each wrapper launches the
kernel for CUDA tensors and runs its plain version
(``lstsq_gradmap_reference``, ``pointwise_gradmap_reference``) for CPU
tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..operators import _promoted
from . import _build

__all__ = ["fused_lstsq_gradmap", "lstsq_gradmap_reference",
           "fused_pointwise_gradmap", "pointwise_gradmap_reference",
           "supports_fusion", "gradmap_plan", "GradmapPlan", "LOSSES",
           "LAUNCHES", "POINTWISE_LAUNCHES", "BF16_LAUNCHES",
           "POINTWISE_BF16_LAUNCHES"]

# Launches of the CUDA kernel for the least-squares loss (K-B3) and for a
# pointwise loss (K-B3p) over a float32 A, and over a bfloat16 A, each
# counted where it launches, nowhere else.
LAUNCHES = 0
POINTWISE_LAUNCHES = 0
BF16_LAUNCHES = 0
POINTWISE_BF16_LAUNCHES = 0

# The storage types of A the kernel takes
DTYPES = (torch.float32, torch.bfloat16)

# The kernel's loss codes, in order (csrc/losses.cuh).
LOSSES = ("lstsq", "logistic", "squared_hinge")

# The plan's constants (csrc/lstsq_fused.cu).  Routes 1 and 2: the block
# of route 1 and of route 2's narrower group (kRowThreads), the grid's
# blocks an SM at most (kBlocksPerSM) and the rows a group takes at once
# at most (kRowsMax).  Routes 3 and 4: the block
# (kThreads), the rows a tile (kTileMax), the cp.async ring's stages
# (kStages) and shared bytes at most (kStreamBudget), a cluster block's
# columns (kChunkMax) and the largest cluster (kClusterMax).
ROW_THREADS = 128
BLOCKS_PER_SM = 1
ROWS_MAX = 4
THREADS = 512
TILE_MAX = 8
STAGES = 3
STREAM_BUDGET = 224 * 1024
CHUNK_MAX = 16384
CLUSTER_MAX = 8


class GradmapPlan(NamedTuple):
    """How a launch of K-B3 / K-B3p covers an m×n matrix.  ``route`` 1
    takes a row a warp (rows of at most 512 values), 2 a row a group of
    ``threads`` (128 or 512; rows of at most 8192 values, 2048 when rows
    are not 16-byte aligned), 3 row tiles of ``tile_rows`` rows over
    clusters of ``cluster`` blocks, streamed through a cp.async ring (up
    to 131072 columns), 4 a tile of up to TILE_MAX rows a block.  A thread
    owns ``cpt`` column groups of ``vec`` values (route 4: 0).  Routes 1
    and 2: block k takes steps k, k + blocks, … of R·tr rows, its group r
    < R the tr = ``tile_rows`` rows from r·tr in each (R = threads / 32 on
    route 1, 1 on route 2); routes 3 and 4: cluster (block) k takes tiles
    k, k + parts, ….  ``blocks`` is a whole number of clusters (a cluster
    of 1 but on route 3); ``smem_bytes`` of dynamic shared memory a block.
    Every launch ends by a grid barrier, after which each block adds its
    slice of the columns over the parts' partials; ``scratch_doubles`` of
    the stream's scratch: the barrier's counters, an f partial a part (a
    block; a cluster on route 3), then from an even word an (n,) gradient
    partial a part."""
    route: int
    vec: int
    cpt: int
    threads: int
    blocks: int
    cluster: int
    smem_bytes: int
    tile_rows: int
    scratch_doubles: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def _row_group(ng: int, vec: int) -> int:
    """Routes 1 and 2: the smallest row group (32, 128 or 512 threads)
    whose threads hold a row of ng groups, 16 floats of x a thread (16
    values a lane in a warp, 4 in a larger group); 0 past it."""
    for group in (32, 128, 512):
        slots = (16 if group == 32 else 4) if vec == 1 else 16 // vec
        if ng <= group * slots:
            return group
    return 0


def rows_at_once(cpt: int, vec: int, threads: int) -> int:
    """Routes 1 and 2: the rows a group takes at once (the kernel's
    ``rows_at_once``): 64 values of A a thread in registers in a block of
    ROW_THREADS, 32 in a block of THREADS, at least 1 and at most
    ROWS_MAX."""
    return max(1, min(ROWS_MAX, (64 if threads == ROW_THREADS else 32)
                      // (cpt * vec)))


def gradmap_plan(m: int, n: int, bf16: bool, slots: int) -> GradmapPlan:
    """K-B3's plan for an m×n matrix stored as float32 or (``bf16``)
    bfloat16 on a card whose ``slots`` are the units the route's kernel is
    sized to: routes 1 and 2 the blocks the card holds at once (at most
    BLOCKS_PER_SM an SM), route 3 the clusters of its size (blocks,
    without clusters), route 4 the SMs (csrc/lstsq_fused.cu, ``plan``,
    computes the same on the card).  On routes 1 and 2 a group takes
    ``rows_at_once`` rows at a time.  A pure function of its arguments;
    refuses empty shapes."""
    if m < 1 or n < 1 or slots < 1:
        raise ValueError(f"gradmap_plan takes m, n >= 1 and a card that "
                         f"holds a block (got m={m}, n={n}, "
                         f"slots={slots})")
    wide = 8 if bf16 else 4            # values of a 16-byte load
    vec = wide if n % wide == 0 else 1
    ng = n // vec
    group = _row_group(ng, vec)
    if group:
        threads = max(ROW_THREADS, group)
        rows = threads // group
        cpt = _pow2_at_least(_cdiv(ng, group))
        tr = rows_at_once(cpt, vec, threads)
        blocks = min(_cdiv(m, rows * tr), slots)
        smem = 4 * n * rows if group == 32 else 0
        return _with_scratch(1 if group == 32 else 2, vec, cpt, threads,
                             blocks, 1, smem, tr, blocks, n)
    nc = _cdiv(n, CHUNK_MAX)
    if nc <= CLUSTER_MAX:
        cw = _cdiv(n, nc)
        if vec > 1:
            cw = _cdiv(cw, vec) * vec
        cpt = _pow2_at_least(_cdiv(cw // vec, THREADS))
        row = cw * (2 if bf16 else 4)
        tile = min(TILE_MAX, STREAM_BUDGET // (STAGES * row))
        parts = min(slots, _cdiv(m, tile))
        return _with_scratch(3, vec, cpt, THREADS, parts * nc, nc,
                             STAGES * row * tile, tile, parts, n)
    tile = min(TILE_MAX, _cdiv(m, slots))
    parts = min(slots, _cdiv(m, tile))
    return _with_scratch(4, vec, 0, THREADS, parts, 1, 0, tile, parts, n)


def _with_scratch(route, vec, cpt, threads, blocks, cluster, smem, tile,
                  parts, n) -> GradmapPlan:
    scratch = ((parts + 2) & ~1) + _cdiv(parts * n, 2)
    return GradmapPlan(route, vec, cpt, threads, blocks, cluster, smem,
                       tile, scratch)


def supports_fusion(m: int, n: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes an m×n matrix of ``dtype``: any float32 or
    bfloat16 matrix (the JAX package's dtype rule,
    ``lstsq_fused.py:144-145``).  Not a speed gate."""
    del m, n
    return dtype in DTYPES


def lstsq_gradmap_reference(A: torch.Tensor, x: torch.Tensor,
                            b: torch.Tensor):
    """The plain two-pass form: d = A x, r = d − b, f = ½‖r‖², g = Aᴴ r
    (a bfloat16 A upcast to float32)."""
    A, x = _promoted(A, x)
    d = torch.matmul(A, x)
    r = d - b
    f = 0.5 * torch.sum(torch.real(torch.conj(r) * r))
    g = torch.matmul(A.mH, r)
    return d, f, g


def pointwise_gradmap_reference(A: torch.Tensor, x: torch.Tensor,
                                data: torch.Tensor, loss: str):
    """The plain two-pass form of K-B3p: d = A x, (ℓ, ℓ′) elementwise,
    f = Σℓ, g = Aᵀℓ′ (``lstsq_fused.py``'s ``_logistic_elem`` and
    ``_hinge_elem``; the squared hinge's ℓ is ½r²; a bfloat16 A upcast to
    float32)."""
    from ..terms import hinge_residual, logistic_ell, logistic_grad
    A, x = _promoted(A, x)
    d = torch.matmul(A, x)
    if loss == "logistic":
        ell, dl = logistic_ell(d, data), logistic_grad(d, data)
    elif loss == "squared_hinge":
        r = hinge_residual(d, data)
        ell, dl = 0.5 * r * r, -data * r
    else:
        raise ValueError(f"unknown pointwise loss {loss!r} (choose "
                         f"logistic or squared_hinge)")
    return d, torch.sum(ell), torch.matmul(A.mT, dl)


@functools.lru_cache(maxsize=None)
def _card_plan(device_index: int, m: int, n: int, bf16: bool = False):
    """(route, column slots a thread, threads, blocks, cluster, dynamic
    shared bytes, tile rows, slots) as the card plans an m×n matrix of
    float32 or (``bf16``) bfloat16 (csrc/lstsq_fused.cu)."""
    lib = _build.library()
    out = [ctypes.c_int() for _ in range(8)]
    with torch.cuda.device(device_index):
        _build.check(lib.fasta_gradmap_plan(
            m, n, int(bf16), *(ctypes.byref(v) for v in out)),
            "fasta_gradmap_plan")
    return tuple(v.value for v in out)


@functools.lru_cache(maxsize=None)
def _plan(device_index: int, m: int, n: int, bf16: bool = False
          ) -> GradmapPlan:
    """The launch plan on the device: ``gradmap_plan`` at the card's slots
    for the route's kernel."""
    return gradmap_plan(m, n, bf16, _card_plan(device_index, m, n, bf16)[-1])


def _check(A, x, b, what):
    if A.ndim != 2 or x.ndim != 1 or b.ndim != 1:
        raise ValueError(f"{what} needs A (m,n), x (n,), b (m,); got "
                         f"{tuple(A.shape)}, {tuple(x.shape)}, "
                         f"{tuple(b.shape)}")
    m, n = A.shape
    if x.shape[0] != n or b.shape[0] != m:
        raise ValueError(f"{what}: x has {x.shape[0]} entries and b "
                         f"{b.shape[0]} for A {m}x{n}")
    if len({A.device, x.device, b.device}) != 1:
        raise ValueError(f"{what}: A, x and b must share a device")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {A.device}")


def fused_lstsq_gradmap(A: torch.Tensor, x: torch.Tensor, b: torch.Tensor):
    """One-pass (d: (m,), f: 0-d, g: (n,)) for f(x) = ½‖Ax−b‖².

    CUDA tensors launch kernel K-B3, at any shape, and must be
    contiguous and 16-byte aligned, A float32 or bfloat16 and x, b
    float32; anything else raises.  CPU tensors run the plain version."""
    _check(A, x, b, "fused_lstsq_gradmap")
    if A.device.type == "cpu":
        return lstsq_gradmap_reference(A, x, b)
    out = _launch(A, x, b, 0, "fused_lstsq_gradmap")
    global LAUNCHES, BF16_LAUNCHES
    if A.dtype == torch.bfloat16:
        BF16_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def fused_pointwise_gradmap(A: torch.Tensor, x: torch.Tensor,
                            data: torch.Tensor, loss: str):
    """One-pass (d: (m,), f = Σℓ: 0-d, g = Aᵀℓ′: (n,)) for the pointwise
    loss ``loss``: "logistic" (labels in {0,1}) or "squared_hinge"
    (labels ±1); ``data`` holds the labels.

    CUDA tensors launch kernel K-B3p under the same rules as K-B3; CPU
    tensors run the plain version."""
    if loss not in LOSSES[1:]:
        raise ValueError(f"unknown pointwise loss {loss!r} (choose "
                         f"logistic or squared_hinge)")
    _check(A, x, data, "fused_pointwise_gradmap")
    if A.device.type == "cpu":
        return pointwise_gradmap_reference(A, x, data, loss)
    out = _launch(A, x, data, LOSSES.index(loss), "fused_pointwise_gradmap")
    global POINTWISE_LAUNCHES, POINTWISE_BF16_LAUNCHES
    if A.dtype == torch.bfloat16:
        POINTWISE_BF16_LAUNCHES += 1
    else:
        POINTWISE_LAUNCHES += 1
    return out


def _launch(A, x, b, loss_code, what):
    """One launch on the current stream on the card's plan.  Counts
    nothing: the public wrappers count."""
    for name, t, types in (("A", A, DTYPES), ("x", x, DTYPES[:1]),
                           ("b", b, DTYPES[:1])):
        if t.dtype not in types or not t.is_contiguous():
            kinds = " or ".join(str(d).removeprefix("torch.") for d in types)
            raise ValueError(f"{what}: {name} must be a contiguous {kinds} "
                             f"tensor, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    m, n = A.shape
    dev = A.device
    if torch.cuda.current_device() != dev.index:
        with torch.cuda.device(dev):
            return _launch(A, x, b, loss_code, what)
    bf16 = A.dtype == torch.bfloat16
    plan = _plan(dev.index, m, n, bf16)
    # one allocation for the outputs: d (m,), g (n,), f
    out = torch.empty(m + n + 1, device=dev, dtype=torch.float32)
    d, g, f = out.split([m, n, 1])
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    work = _build.stream_scratch(dev, stream, plan.scratch_doubles)
    base = out.data_ptr()
    err = _build.library().fasta_gradmap(
        A.data_ptr(), x.data_ptr(), b.data_ptr(), m, n, int(bf16), loss_code,
        plan.route, plan.cpt, plan.threads, plan.blocks, plan.cluster,
        plan.smem_bytes, plan.tile_rows, base, base + 4 * (m + n),
        base + 4 * m, work.data_ptr(), stream)
    if err:
        _build.check(err, what)
    return d, f.reshape(()), g
