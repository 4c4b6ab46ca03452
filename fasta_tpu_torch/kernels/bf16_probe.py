"""Kernel K-P4: the bfloat16-storage probe, K chained forward and adjoint
passes over one matrix in one launch.

``bf16_probe(A, x0, K)`` runs K pairs d = A x, g = Aᵀd, x = x₀ + 0·g with
A (m, n) stored as float32 or bfloat16 and x₀ (n,) float32, and returns
the last pair's (x, g); port of ``benchmarks/bf16_matvec_probe.py:39-61``
(pallas_call at :53), which times the pairs at 1000×2000 to decide
whether bfloat16 storage pays when A is resident on the chip.  The CUDA
source is ``fasta_tpu_torch/csrc/bf16_probe.cu``: K-B1's design, the rows
of A staged on the chip once a launch (bfloat16 rows kept bfloat16, so
twice as many fit), one pass over them a pair for both products, two
grid barriers a pair.  ``bf16_probe_plan`` places the rows (``dense_plan``
at the probe's budget, ``bf16_probe_budget``).  The wrapper launches the
kernel for CUDA tensors — one device operation a call — and runs its
plain version (``bf16_probe_reference``, the same loop in PyTorch) for
CPU tensors.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .microsolver import (H100_SMEM_OPTIN, STATE_MAX_N, DensePlan,
                          _rows_grid, _table, dense_lanes, dense_plan)

__all__ = ["bf16_probe", "bf16_probe_reference", "bf16_probe_plan",
           "bf16_probe_budget", "probe_width", "LAUNCHES", "DTYPES",
           "GRID_BARRIERS_PER_PAIR", "H100_STATIC_SMEM"]

# Launches of the probe kernel, counted where it launches, nowhere else.
LAUNCHES = 0

# The storage types of A the kernel takes
DTYPES = (torch.float32, torch.bfloat16)

# Grid barriers a pair takes (csrc/bf16_probe.cu)
GRID_BARRIERS_PER_PAIR = 2

# The kernel's static shared memory as nvcc lays it out for sm_90a: what
# ``bf16_probe_budget`` takes by default; the card's own number comes from
# ``_grid``, which a card test holds against it.
H100_STATIC_SMEM = 3072


def bf16_probe_reference(A: torch.Tensor, x0: torch.Tensor, K: int):
    """The plain version: K pairs d = A x, g = Aᵀd, x = x₀ + 0·g with A
    upcast to float32; returns (x, g) of the last pair."""
    A = A.to(torch.float32)
    x, g = x0, None
    for _ in range(K):
        g = torch.matmul(A.mT, torch.matmul(A, x))
        x = x0 + 0.0 * g
    return x, g


def probe_width(n: int, bf16: bool) -> int:
    """The width the row machinery lays a row of n columns out at: 4 per
    16-byte slot, a slot holding 4 float32 or 8 bfloat16 values — the
    threads a row takes and its bytes in shared memory (4 a unit), as
    ``dense_lanes`` and ``dense_plan`` count them."""
    vec = 8 if bf16 else 4
    return 4 * -(-n // vec)


def _vec_width(n: int, bf16: bool) -> int:
    """The floats of g a padded row holds (its slots' values)."""
    if n < 1 or n > STATE_MAX_N:
        raise ValueError(f"the bf16 probe takes 1 <= n <= {STATE_MAX_N} "
                         f"columns (every block keeps its share of g), got "
                         f"n = {n}")
    return probe_width(n, bf16) * (2 if bf16 else 1)


def bf16_probe_budget(n: int, bf16: bool, optin: int = H100_SMEM_OPTIN,
                      static: int = H100_STATIC_SMEM) -> int:
    """The shared memory, in bytes, that a block of the probe has for rows
    of A with n columns stored as bfloat16 (``bf16``) or float32: the
    per-block opt-in ``optin`` less the kernel's static shared memory
    ``static`` (by default the H100's) and the R − 1 other row lanes'
    shares of g (float32, one a padded column); 0 where those alone do
    not fit.  The arithmetic of ``state_bytes`` in csrc/bf16_probe.cu; the
    card's ``_grid`` gives the same number."""
    npad = _vec_width(n, bf16)
    R = dense_lanes(probe_width(n, bf16))[1]
    return max(0, optin - static - 4 * npad * (R - 1))


def bf16_probe_plan(m: int, n: int, bf16: bool, nblocks: int,
                    budget: int) -> DensePlan:
    """Where a launch over an (m, n) matrix stored as bfloat16 (``bf16``)
    or float32 keeps its rows: K-B1's ``dense_plan`` at the row's width in
    slots (``probe_width``; a bfloat16 row takes half the threads and
    bytes of a float32 one), its budget the probe's
    (``bf16_probe_budget``): bands of rows, the first step's rows in
    registers up to 512 slots a row, the next in shared memory, the rest
    read from L2 once a pass.  Raises past 8192 columns."""
    _vec_width(n, bf16)
    return dense_plan(m, probe_width(n, bf16), nblocks, budget)


def _check(A, x0, K):
    if A.ndim != 2 or x0.ndim != 1 or x0.shape[0] != A.shape[1]:
        raise ValueError(f"bf16_probe needs A (m,n) and x0 (n,); got "
                         f"{tuple(A.shape)}, {tuple(x0.shape)}")
    if int(K) < 1:
        raise ValueError(f"bf16_probe needs K >= 1 pairs, got {K}")
    if A.device != x0.device:
        raise ValueError("bf16_probe: A and x0 must share a device")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bf16_probe: no kernel for device {A.device}")


def bf16_probe(A: torch.Tensor, x0: torch.Tensor, K: int):
    """(x, g) after K chained pairs.  CUDA tensors launch kernel K-P4 on
    ``bf16_probe_plan``'s plan at the card's budget and must be
    contiguous and 16-byte aligned, A float32 or bfloat16 with at most
    8192 columns and x0 float32; anything else raises.  Nothing is
    allocated but x and g.  CPU tensors run the plain version."""
    _check(A, x0, K)
    if A.device.type == "cpu":
        return bf16_probe_reference(A, x0, K)
    out = _launch(A, x0, int(K))
    global LAUNCHES
    LAUNCHES += 1
    return out


def _launch(A, x0, K, plan=None):
    """One launch on ``plan`` (``bf16_probe_plan``'s at the card's budget
    when None)."""
    for name, t, types in (("A", A, DTYPES), ("x0", x0, DTYPES[:1])):
        if t.dtype not in types or not t.is_contiguous():
            kinds = " or ".join(str(d).removeprefix("torch.") for d in types)
            raise ValueError(f"bf16_probe: {name} must be a contiguous "
                             f"{kinds} tensor, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"bf16_probe: {name} must be 16-byte aligned")
    m, n = A.shape
    bf16 = A.dtype == torch.bfloat16
    _vec_width(n, bf16)
    dev = A.device
    if plan is None:
        plan, tiles, nb = _tiles(dev.index, m, n, bf16)
    else:
        if (plan.m, plan.n4) != (m, probe_width(n, bf16)):
            raise ValueError(f"the plan is for {plan.m} rows of width "
                             f"{plan.n4}, not {m} of {probe_width(n, bf16)}")
        _grid(dev.index, bf16, n)   # sets the kernel's shared-memory cap
        tiles, nb = _table(plan, dev), len(plan.bands)
    f32 = dict(device=dev, dtype=torch.float32)
    x, g = torch.empty(n, **f32), torch.empty(n, **f32)
    with _build.on_device(dev) as stream:
        work = _build.stream_scratch(dev, stream, _work(bf16, n, nb))
        _build.check(_build.library().fasta_bf16_probe(
            A.data_ptr(), x0.data_ptr(), m, n, int(bf16), K, x.data_ptr(),
            g.data_ptr(), tiles.data_ptr(), max(plan.smem_rows),
            work.data_ptr(), nb, stream), "fasta_bf16_probe")
    return x, g


@functools.lru_cache(maxsize=None)
def _grid(device_index: int, bf16: bool, n: int):
    """(blocks of the cooperative grid, shared-memory bytes a block has
    for rows of A, the device's per-block opt-in, the kernel's static
    shared memory) for n columns stored as bfloat16 or float32."""
    return _rows_grid(device_index, "fasta_bf16_probe_grid", int(bf16), n)


@functools.lru_cache(maxsize=64)
def _tiles(device_index: int, m: int, n: int, bf16: bool):
    """The card's plan for (m, n) in the storage type, its table on the
    card and its grid."""
    nb, budget = _grid(device_index, bf16, n)[:2]
    plan = bf16_probe_plan(m, n, bf16, nb, budget)
    return plan, _table(plan, torch.device("cuda", device_index)), nb


@functools.lru_cache(maxsize=None)
def _work(bf16: bool, n: int, nblocks: int) -> int:
    return _build.ints("fasta_bf16_probe_work", int(bf16), n, nblocks)[0]
