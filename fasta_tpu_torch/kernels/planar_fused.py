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
note gives the design) with a loss code.  Each wrapper launches the kernel
for CUDA tensors and runs its plain version
(``planar_lstsq_gradmap_reference``, ``planar_hinge_gradmap_reference``)
for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["fused_planar_lstsq_gradmap", "fused_planar_hinge_gradmap",
           "planar_lstsq_gradmap_reference", "planar_hinge_gradmap_reference",
           "LOSSES", "LAUNCHES", "BF16_LAUNCHES"]

# Launches of the CUDA kernel pair, either loss, over float32 and over
# bfloat16 channels, counted where it launches, nowhere else.
LAUNCHES = 0
BF16_LAUNCHES = 0

# The storage types of the channels the kernel takes
DTYPES = (torch.float32, torch.bfloat16)

# The kernel's loss codes, in order (csrc/planar_fused.cu).
LOSSES = ("lstsq", "hinge")


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
def _plan(device_index: int, m: int, n: int, bf16: bool = False):
    """(route, column slots per thread, blocks, dynamic shared bytes) of
    the kernel for an m×n pair of float32 or (``bf16``) bfloat16 channels
    on the device (csrc/planar_fused.cu)."""
    lib = _build.library()
    out = [ctypes.c_int() for _ in range(4)]
    with torch.cuda.device(device_index):
        _build.check(lib.fasta_planar_gradmap_plan(
            m, n, int(bf16), *(ctypes.byref(v) for v in out)),
            "fasta_planar_gradmap_plan")
    return tuple(v.value for v in out)


def _launch(Ar, Ai, x, b, loss_code, what):
    for name, t, types in (("Ar", Ar, DTYPES), ("Ai", Ai, (Ar.dtype,)),
                           ("x", x, DTYPES[:1]), ("b", b, DTYPES[:1])):
        if t.dtype not in types or not t.is_contiguous():
            kinds = " or ".join(str(d).removeprefix("torch.") for d in types)
            raise ValueError(f"{what}: {name} must be a contiguous {kinds} "
                             f"tensor, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    m, n = Ar.shape
    dev = Ar.device
    bf16 = Ar.dtype == torch.bfloat16
    route, cpt, nb, smem = _plan(dev.index, m, n, bf16)
    f32 = dict(device=dev, dtype=torch.float32)
    d = torch.empty((m, 2), **f32)
    g = torch.empty((n, 2), **f32)
    f = torch.empty((), **f32)
    gpart = torch.empty((nb, 2 * n), **f32)
    fpart = torch.empty(nb, device=dev, dtype=torch.float64)
    with _build.on_device(dev) as stream:
        _build.check(_build.library().fasta_planar_gradmap(
            Ar.data_ptr(), Ai.data_ptr(), x.data_ptr(), b.data_ptr(), m, n,
            int(bf16), loss_code, route, cpt, nb, smem, d.data_ptr(), f.data_ptr(),
            g.data_ptr(), gpart.data_ptr(), fpart.data_ptr(), stream),
            what)
    global LAUNCHES, BF16_LAUNCHES
    if bf16:
        BF16_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return d, f, g
