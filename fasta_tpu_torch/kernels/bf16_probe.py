"""Kernel K-P4: the bfloat16-storage probe, K chained forward and adjoint
passes over one matrix in one launch.

``bf16_probe(A, x0, K)`` runs K pairs d = A x, g = Aᵀd, x = x₀ + 0·g with
A (m, n) stored as float32 or bfloat16 and x₀ (n,) float32, and returns
the last pair's (x, g); port of ``benchmarks/bf16_matvec_probe.py:39-61``
(pallas_call at :53), which times the pairs at 1000×2000 to decide
whether bfloat16 storage pays when A is resident on the chip.  The CUDA
source is ``fasta_tpu_torch/csrc/bf16_probe.cu`` (its header note gives
the design).  The wrapper launches the kernel for CUDA tensors and runs
its plain version (``bf16_probe_reference``, the same loop in PyTorch)
for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["bf16_probe", "bf16_probe_reference", "LAUNCHES", "DTYPES"]

# Launches of the probe kernel, counted where it launches, nowhere else.
LAUNCHES = 0

# The storage types of A the kernel takes
DTYPES = (torch.float32, torch.bfloat16)


def bf16_probe_reference(A: torch.Tensor, x0: torch.Tensor, K: int):
    """The plain version: K pairs d = A x, g = Aᵀd, x = x₀ + 0·g with A
    upcast to float32; returns (x, g) of the last pair."""
    A = A.to(torch.float32)
    x, g = x0, None
    for _ in range(K):
        g = torch.matmul(A.mT, torch.matmul(A, x))
        x = x0 + 0.0 * g
    return x, g


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
    """(x, g) after K chained pairs.  CUDA tensors launch kernel K-P4 and
    must be contiguous and 16-byte aligned, A float32 or bfloat16 and x0
    float32; anything else raises.  CPU tensors run the plain version."""
    _check(A, x0, K)
    if A.device.type == "cpu":
        return bf16_probe_reference(A, x0, K)
    for name, t, types in (("A", A, DTYPES), ("x0", x0, DTYPES[:1])):
        if t.dtype not in types or not t.is_contiguous():
            kinds = " or ".join(str(d).removeprefix("torch.") for d in types)
            raise ValueError(f"bf16_probe: {name} must be a contiguous "
                             f"{kinds} tensor, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"bf16_probe: {name} must be 16-byte aligned")
    m, n = A.shape
    dev = A.device
    bf16 = A.dtype == torch.bfloat16
    nb = _grid(dev.index, int(bf16), n)
    f32 = dict(device=dev, dtype=torch.float32)
    d, x, g = torch.empty(m, **f32), torch.empty(n, **f32), \
        torch.empty(n, **f32)
    with _build.on_device(dev) as stream:
        _build.check(_build.library().fasta_bf16_probe(
            A.data_ptr(), x0.data_ptr(), m, n, int(bf16), int(K),
            d.data_ptr(), x.data_ptr(), g.data_ptr(), nb, stream),
            "fasta_bf16_probe")
    global LAUNCHES
    LAUNCHES += 1
    return x, g


@functools.lru_cache(maxsize=None)
def _grid(device_index: int, bf16: int, n: int) -> int:
    nb = ctypes.c_int()
    with torch.cuda.device(device_index):
        _build.check(_build.library().fasta_bf16_probe_grid(
            bf16, n, ctypes.byref(nb)), "fasta_bf16_probe_grid")
    if nb.value < 1:
        raise RuntimeError("the probe kernel cannot be resident on this "
                           "device")
    return nb.value
