"""Kernel K-P5: the planar matvec layout probe.

``planar_probe(Ar, Ai, x, K, variant)`` runs K data-chained planar
forward-plus-adjoint pairs g = Aᴴ(A x), x ← x + 0·g, in one launch and
returns the last pair's g (n, 2); port of
``benchmarks/planar_matvec_probe.py:77-328`` (pallas_call at :314).  The
variants (``VARIANTS``) store the channel matrices split (the public
layout), interleaved or transposed (the TPU kernel's), each read once per
pair, plus the split layout read twice (forward, grid barrier, adjoint);
the fastest decides K-B8's storage (``PERF.md``).  The CUDA source is
``fasta_tpu_torch/csrc/planar_probe.cu``.  CUDA tensors launch the kernel
(the wrapper lays the matrices out first, outside the pairs); CPU tensors
run the plain version, K chained ``PlanarDenseOp`` pairs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["planar_probe", "planar_probe_reference", "layout", "VARIANTS",
           "LAUNCHES"]

# Launches of the probe kernel, counted where it launches, nowhere else.
LAUNCHES = 0

# The kernel's variant codes, in order (csrc/planar_probe.cu).
VARIANTS = ("split", "interleaved", "transposed", "split_two_pass")


def planar_probe_reference(Ar, Ai, x, K: int):
    """K chained ``PlanarDenseOp`` pairs: g = Aᴴ(A x), x ← x + 0·g."""
    from ..operators import PlanarDenseOp
    op = PlanarDenseOp(Ar, Ai)
    g = None
    for _ in range(K):
        g = op.rmatvec(op(x))
        x = x + 0.0 * g
    return g


def layout(Ar, Ai, variant: str):
    """The (A0, A1) operands of a variant: split and two-pass (Ar, Ai),
    interleaved one (m, n, 2) array, transposed (Arᵀ, Aiᵀ), contiguous."""
    if variant == "interleaved":
        return torch.stack([Ar, Ai], dim=-1).contiguous(), None
    if variant == "transposed":
        return Ar.t().contiguous(), Ai.t().contiguous()
    return Ar.contiguous(), Ai.contiguous()


def planar_probe(Ar, Ai, x, K: int, variant: str = "split"):
    """The last of K chained planar pairs, (n, 2).

    CUDA tensors launch kernel K-P5: float32, n of 128, 256 or 512, any
    m; anything else raises.  CPU tensors run the plain
    version."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (choose from "
                         f"{VARIANTS})")
    if Ar.ndim != 2 or Ar.shape != Ai.shape or tuple(x.shape) != \
            (Ar.shape[1], 2):
        raise ValueError(f"planar_probe needs Ar, Ai (m,n) and x (n,2); got "
                         f"{tuple(Ar.shape)}, {tuple(Ai.shape)}, "
                         f"{tuple(x.shape)}")
    if K < 1:
        raise ValueError("planar_probe needs K >= 1 pairs")
    if len({Ar.device, Ai.device, x.device}) != 1:
        raise ValueError("planar_probe: Ar, Ai and x must share a device")
    if Ar.device.type == "cpu":
        return planar_probe_reference(Ar, Ai, x, K)
    if Ar.device.type != "cuda":
        raise ValueError(f"planar_probe: no kernel for device {Ar.device}")
    m, n = Ar.shape
    if n not in (128, 256, 512):
        raise ValueError(f"planar_probe: n must be 128, 256 or 512, got {n}")
    for name, t in (("Ar", Ar), ("Ai", Ai), ("x", x)):
        if t.dtype != torch.float32:
            raise ValueError(f"planar_probe: {name} must be float32, got "
                             f"{t.dtype}")
    code = VARIANTS.index(variant)
    dev = Ar.device
    x = x.contiguous()
    A0, A1 = layout(Ar, Ai, variant)
    nb = _grid(dev.index, code, n)
    f32 = dict(device=dev, dtype=torch.float32)
    out = torch.empty((n, 2), **f32)
    gpart = torch.empty((nb, 2 * n), **f32)
    gbuf = torch.empty(2 * n, **f32)
    dbuf = torch.empty((m, 2), **f32) if variant == "split_two_pass" else None
    with _build.on_device(dev) as stream:
        _build.check(_build.library().fasta_planar_probe(
            code, A0.data_ptr(), None if A1 is None else A1.data_ptr(),
            x.data_ptr(), m, n, int(K), out.data_ptr(),
            gpart.data_ptr(), gbuf.data_ptr(),
            None if dbuf is None else dbuf.data_ptr(), nb, stream),
            "fasta_planar_probe")
    global LAUNCHES
    LAUNCHES += 1
    return out


@functools.lru_cache(maxsize=None)
def _grid(device_index: int, code: int, n: int) -> int:
    nb = ctypes.c_int()
    with torch.cuda.device(device_index):
        _build.check(_build.library().fasta_planar_probe_grid(
            code, n, ctypes.byref(nb)), "fasta_planar_probe_grid")
    if nb.value < 1:
        raise RuntimeError("the probe kernel cannot be resident on this "
                           "device")
    return nb.value
