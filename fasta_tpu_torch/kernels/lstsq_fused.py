"""Kernel K-B3: the fused least-squares gradient map
(d, f, g) = (Ax, ½‖Ax−b‖², Aᵀ(Ax−b)) in one read of A.

Port of ``fasta_tpu/kernels/lstsq_fused.py:148-164, 368-452``.  The CUDA
source is ``fasta_tpu_torch/csrc/lstsq_fused.cu``; its header note gives
the design.  ``fused_lstsq_gradmap`` launches it for CUDA tensors and
runs the plain version ``lstsq_gradmap_reference`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["fused_lstsq_gradmap", "lstsq_gradmap_reference",
           "supports_fusion", "LAUNCHES"]

# Launches of the CUDA kernel pair (counted where it launches, nowhere
# else).
LAUNCHES = 0


def supports_fusion(m: int, n: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes an m×n matrix of ``dtype``: any float32
    matrix (the JAX package's dtype rule, without its bfloat16 storage,
    which is not ported yet).  Not a speed gate."""
    del m, n
    return dtype == torch.float32


def lstsq_gradmap_reference(A: torch.Tensor, x: torch.Tensor,
                            b: torch.Tensor):
    """The plain two-pass form: d = A x, r = d − b, f = ½‖r‖², g = Aᴴ r."""
    d = torch.matmul(A, x)
    r = d - b
    f = 0.5 * torch.sum(torch.real(torch.conj(r) * r))
    g = torch.matmul(A.mH, r)
    return d, f, g


@functools.lru_cache(maxsize=None)
def _plan(device_index: int, m: int, n: int):
    """(cluster, tile rows, parts, dynamic shared bytes) of the kernel
    for an m×n matrix on the device.  cluster ≥ 1: the clustered kernel,
    whose clusters of that many blocks split each row into chunks of at
    most 16384 columns; cluster 0: the wide kernel for rows of more than
    131072 columns.  parts is the row count of the gradient scratch."""
    lib = _build.library()
    out = [ctypes.c_int() for _ in range(4)]
    with torch.cuda.device(device_index):
        _build.check(lib.fasta_lstsq_gradmap_plan(
            m, n, *(ctypes.byref(v) for v in out)),
            "fasta_lstsq_gradmap_plan")
    return tuple(v.value for v in out)


def _check(A, x, b):
    if A.ndim != 2 or x.ndim != 1 or b.ndim != 1:
        raise ValueError(f"fused_lstsq_gradmap needs A (m,n), x (n,), "
                         f"b (m,); got {tuple(A.shape)}, {tuple(x.shape)}, "
                         f"{tuple(b.shape)}")
    m, n = A.shape
    if x.shape[0] != n or b.shape[0] != m:
        raise ValueError(f"fused_lstsq_gradmap: x has {x.shape[0]} entries "
                         f"and b {b.shape[0]} for A {m}x{n}")
    if len({A.device, x.device, b.device}) != 1:
        raise ValueError("fused_lstsq_gradmap: A, x and b must share a "
                         "device")


def fused_lstsq_gradmap(A: torch.Tensor, x: torch.Tensor, b: torch.Tensor):
    """One-pass (d: (m,), f: 0-d, g: (n,)) for f(x) = ½‖Ax−b‖².

    CUDA tensors launch kernel K-B3, at any shape, and must be float32,
    contiguous and 16-byte aligned; anything else raises.  CPU tensors
    run the plain version."""
    _check(A, x, b)
    if A.device.type == "cpu":
        return lstsq_gradmap_reference(A, x, b)
    if A.device.type != "cuda":
        raise ValueError(f"fused_lstsq_gradmap: no kernel for device "
                         f"{A.device}")
    for name, t in (("A", A), ("x", x), ("b", b)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fused_lstsq_gradmap: {name} must be a "
                             f"contiguous float32 tensor, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"fused_lstsq_gradmap: {name} must be 16-byte "
                             f"aligned")
    m, n = A.shape
    cluster, tm, nb, smem = _plan(A.device.index, m, n)
    # one allocation: gpart (nb, n) first, so its rows stay 16-byte
    # aligned, then fpart (nb,), d (m,), g (n,), f
    ws = torch.empty(nb * n + nb + m + n + 1, device=A.device,
                     dtype=torch.float32)
    base = ws.data_ptr()
    d, g, f = ws[nb * n + nb:].split([m, n, 1])
    with _build.on_device(A.device) as stream:
        _build.check(_build.library().fasta_lstsq_gradmap(
            A.data_ptr(), x.data_ptr(), b.data_ptr(), m, n, cluster, tm, nb,
            smem, d.data_ptr(), f.data_ptr(), g.data_ptr(), base,
            base + 4 * nb * n, stream), "fasta_lstsq_gradmap")
    global LAUNCHES
    LAUNCHES += 1
    return d, f.reshape(()), g
