"""Kernels K-B3 and K-B3p: fused gradient maps in one read of A.

K-B3, ``fused_lstsq_gradmap``: (d, f, g) = (Ax, ½‖Ax−b‖², Aᵀ(Ax−b)),
port of ``fasta_tpu/kernels/lstsq_fused.py:148-164, 368-452``.  K-B3p,
``fused_pointwise_gradmap``: (d, f, g) = (Ax, Σℓ(Ax; y), Aᵀℓ′(Ax)) for
the logistic loss and the squared hinge, port of
``lstsq_fused.py:246-365``.  A is stored as float32 or bfloat16 (the
mixed-precision path, ``lstsq_fused.py:292-452``: a bfloat16 A is upcast
to float32 in the kernel, x and the outputs are float32).  Both run the
same CUDA source, ``fasta_tpu_torch/csrc/lstsq_fused.cu`` (its header
note gives the design), with a loss code.  Each wrapper launches the
kernel for CUDA tensors and runs its plain version
(``lstsq_gradmap_reference``, ``pointwise_gradmap_reference``) for CPU
tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..operators import _promoted
from . import _build

__all__ = ["fused_lstsq_gradmap", "lstsq_gradmap_reference",
           "fused_pointwise_gradmap", "pointwise_gradmap_reference",
           "supports_fusion", "LOSSES", "LAUNCHES", "POINTWISE_LAUNCHES",
           "BF16_LAUNCHES", "POINTWISE_BF16_LAUNCHES"]

# Launches of the CUDA kernel pair for the least-squares loss (K-B3) and
# for a pointwise loss (K-B3p) over a float32 A, and over a bfloat16 A,
# each counted where it launches, nowhere else.
LAUNCHES = 0
POINTWISE_LAUNCHES = 0
BF16_LAUNCHES = 0
POINTWISE_BF16_LAUNCHES = 0

# The storage types of A the kernel takes
DTYPES = (torch.float32, torch.bfloat16)

# The kernel's loss codes, in order (csrc/losses.cuh).
LOSSES = ("lstsq", "logistic", "squared_hinge")


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
def _plan(device_index: int, m: int, n: int, bf16: bool = False):
    """(cluster, tile rows, parts, dynamic shared bytes) of the kernel
    for an m×n matrix on the device, stored as float32 or (``bf16``)
    bfloat16.  cluster ≥ 1: the clustered kernel, whose clusters of that
    many blocks split each row into chunks of at most 16384 columns;
    cluster 0: the wide kernel for rows of more than 131072 columns.
    parts is the row count of the gradient scratch."""
    lib = _build.library()
    out = [ctypes.c_int() for _ in range(4)]
    with torch.cuda.device(device_index):
        _build.check(lib.fasta_gradmap_plan(
            m, n, int(bf16), *(ctypes.byref(v) for v in out)),
            "fasta_gradmap_plan")
    return tuple(v.value for v in out)


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
    for name, t, types in (("A", A, DTYPES), ("x", x, DTYPES[:1]),
                           ("b", b, DTYPES[:1])):
        if t.dtype not in types or not t.is_contiguous():
            kinds = " or ".join(str(d).removeprefix("torch.") for d in types)
            raise ValueError(f"{what}: {name} must be a contiguous {kinds} "
                             f"tensor, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    m, n = A.shape
    bf16 = A.dtype == torch.bfloat16
    cluster, tm, nb, smem = _plan(A.device.index, m, n, bf16)
    # one allocation: gpart (nb, n) first, so its rows stay 16-byte
    # aligned, then fpart (nb,), d (m,), g (n,), f
    ws = torch.empty(nb * n + nb + m + n + 1, device=A.device,
                     dtype=torch.float32)
    base = ws.data_ptr()
    d, g, f = ws[nb * n + nb:].split([m, n, 1])
    with _build.on_device(A.device) as stream:
        _build.check(_build.library().fasta_gradmap(
            A.data_ptr(), x.data_ptr(), b.data_ptr(), m, n, int(bf16),
            loss_code, cluster, tm, nb, smem, d.data_ptr(), f.data_ptr(), g.data_ptr(),
            base, base + 4 * nb * n, stream), "fasta_gradmap")
    return d, f.reshape(()), g
