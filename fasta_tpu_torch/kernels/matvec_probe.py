"""Kernels K-P1 and K-P2: the GEMV formulation probe and the one-pass
gradient-map check over a matrix resident on the card.

``run_variant(A, x0, b, variant, K)`` runs K data-chained operations of one
formulation in one launch (K-P1) and returns x and the last operation's
result; port of ``benchmarks/matvec_kernels.py:155`` (``pallas_call`` at
:158, body ``_body_factory`` at :41).  The chaining rules are the TPU
probe's (:122-149):

* ``fwd_vpu``, ``fwd_mxu``: d = A x, x ← x + d₀·1e-9; result d (m,);
* ``fwd_strip``, ``fwd_strip_auto``: s = Σ(A x), x ← x + s·1e-9; result s;
* ``gradmap_fused``: r = A x − b, f = ½‖r‖², g = Aᵀr,
  x ← (x + g·1e-12) + f·1e-12; result (f, g);
* ``adj_vpu``, ``adj_mxu``: g = Aᵀ(x₀·1) with x₀ the first entry of x,
  x ← x + g·1e-9; result g (n,).

With A/40, as the probe scales it, 1e-9·d sits below float32's epsilon for
most entries of x, so x alone barely moves: the result carries the check.

``check_gradmap_correct(A, x, b)`` is K-P2, port of
``matvec_kernels.py:169`` (``pallas_call`` at :199): one launch of the
fused pass → (f, g) (``gradmap_fused``), and the relative errors of f
and g against the float64 formulas.  The TPU probe held them against
XLA's float32 formulas; float64 is the stricter reference.

The CUDA source is ``fasta_tpu_torch/csrc/matvec_probe.cu`` (its header
note gives the design and how each TPU formulation maps to this card).
The wrappers launch the kernel for CUDA tensors and run the plain
versions (``run_variant_reference``, ``gradmap_reference``) for CPU
tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["run_variant", "run_variant_reference", "gradmap_fused",
           "check_gradmap_correct", "gradmap_reference", "VARIANTS",
           "LAUNCHES", "CHECK_LAUNCHES"]

# Launches of K-P1 (run_variant) and of K-P2 (gradmap_fused),
# each counted where it launches, nowhere else.
LAUNCHES = 0
CHECK_LAUNCHES = 0

# The formulations, in the order of the kernel's codes
VARIANTS = ("fwd_vpu", "fwd_mxu", "fwd_strip", "fwd_strip_auto",
            "gradmap_fused", "adj_vpu", "adj_mxu")


def gradmap_reference(A, x, b):
    """(f, g) = (½‖Ax − b‖², Aᵀ(Ax − b)) in float32."""
    r = torch.mv(A, x) - b
    return 0.5 * torch.sum(r * r), torch.mv(A.mT, r)


def run_variant_reference(A, x0, b, variant: str, K: int):
    """The plain version: K chained operations of ``variant`` in PyTorch;
    returns (x, result).  The tensor-core and strip formulations compute
    the same function as their CUDA-core forms."""
    x, out = x0, None
    for _ in range(K):
        if variant.startswith("fwd_strip"):
            out = torch.sum(torch.mv(A, x))
            x = x + out * 1e-9
        elif variant.startswith("fwd"):
            out = torch.mv(A, x)
            x = x + out[0] * 1e-9
        elif variant == "gradmap_fused":
            out = gradmap_reference(A, x, b)
            x = x + out[1] * 1e-12 + out[0] * 1e-12
        else:
            out = torch.mv(A.mT, x[0].expand(A.shape[0]))
            x = x + out * 1e-9
    return x, out


def _check(A, x0, b, K, what):
    if A.ndim != 2 or x0.ndim != 1 or b.ndim != 1 or \
            x0.shape[0] != A.shape[1] or b.shape[0] != A.shape[0]:
        raise ValueError(f"{what} needs A (m,n), x (n,) and b (m,); got "
                         f"{tuple(A.shape)}, {tuple(x0.shape)}, "
                         f"{tuple(b.shape)}")
    if int(K) < 1:
        raise ValueError(f"{what} needs K >= 1 operations, got {K}")
    if A.device != x0.device or A.device != b.device:
        raise ValueError(f"{what}: A, x and b must share a device")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {A.device}")


def _launch(code, A, x0, b, K, what):
    """One launch of the kernel; returns (x, d, g, s) of the last
    operation."""
    for name, t in (("A", A), ("x", x0), ("b", b)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous float32 "
                             f"tensor, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    m, n = A.shape
    if n % 4:
        raise ValueError(f"{what}: the kernel takes n % 4 == 0 (16-byte "
                         f"rows), got n = {n}")
    dev = A.device
    nb = _grid(dev.index, code, n)
    f32 = dict(device=dev, dtype=torch.float32)
    x, dbuf, xbuf = torch.empty(n, **f32), torch.empty(2, m, **f32), \
        torch.empty(2, n, **f32)
    g, scal = torch.empty(n, **f32), torch.empty(1, **f32)
    gpart = torch.empty(nb, n, **f32) if VARIANTS[code] == "gradmap_fused" \
        else None
    fpart = torch.empty(2, nb, device=dev, dtype=torch.float64)
    with _build.on_device(dev) as stream:
        _build.check(_build.library().fasta_matvec_probe(
            code, A.data_ptr(), x0.data_ptr(), b.data_ptr(), m, n, int(K),
            x.data_ptr(), dbuf.data_ptr(), xbuf.data_ptr(), g.data_ptr(),
            None if gpart is None else gpart.data_ptr(), fpart.data_ptr(),
            scal.data_ptr(), nb, stream), "fasta_matvec_probe")
    return x, dbuf[(int(K) - 1) % 2], g, scal[0]


def run_variant(A, x0, b, variant: str, K: int):
    """(x, result) after K chained operations of ``variant`` (see the
    module note).  CUDA tensors launch kernel K-P1 and must be contiguous,
    16-byte aligned float32 with n % 4 == 0; anything else raises.  CPU
    tensors run the plain version."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (choose from "
                         f"{VARIANTS})")
    _check(A, x0, b, K, "run_variant")
    if A.device.type == "cpu":
        return run_variant_reference(A, x0, b, variant, int(K))
    x, d, g, s = _launch(VARIANTS.index(variant), A, x0, b, K,
                         "run_variant")
    global LAUNCHES
    LAUNCHES += 1
    if variant.startswith("fwd_strip"):
        return x, s
    if variant.startswith("fwd"):
        return x, d
    return x, ((s, g) if variant == "gradmap_fused" else g)


def gradmap_fused(A, x, b):
    """(f, g) = (½‖Ax − b‖², Aᵀ(Ax − b)) in float32 from one fused pass
    over A.  CUDA tensors launch kernel K-P2 (the gradmap pass of K-P1
    once; the same rules as ``run_variant``); CPU tensors run the plain
    version."""
    _check(A, x, b, 1, "gradmap_fused")
    if A.device.type == "cpu":
        return gradmap_reference(A, x, b)
    _, _, g, f = _launch(VARIANTS.index("gradmap_fused"), A, x, b, 1,
                         "gradmap_fused")
    global CHECK_LAUNCHES
    CHECK_LAUNCHES += 1
    return f, g


def check_gradmap_correct(A, x, b):
    """(f, g, f_rel, g_rel): ``gradmap_fused`` and the relative errors of
    f and g (|Δf|/|f|, ‖Δg‖/‖g‖) against the same formulas in float64,
    printed as the TPU probe prints them."""
    f, g = gradmap_fused(A, x, b)
    f64, g64 = gradmap_reference(A.double(), x.double(), b.double())
    ferr = abs(float(f) - float(f64)) / max(abs(float(f64)), 1e-30)
    gerr = float(torch.linalg.norm(g.double() - g64)
                 / max(float(torch.linalg.norm(g64)), 1e-30))
    print(f"gradmap_fused correctness: f rel {ferr:.2e}, g rel {gerr:.2e}",
          flush=True)
    return f, g, ferr, gerr


@functools.lru_cache(maxsize=None)
def _grid(device_index: int, code: int, n: int) -> int:
    nb = ctypes.c_int()
    with torch.cuda.device(device_index):
        _build.check(_build.library().fasta_matvec_probe_grid(
            code, n, ctypes.byref(nb)), "fasta_matvec_probe_grid")
    if nb.value < 1:
        raise ValueError(f"the probe's {VARIANTS[code]} kernel cannot be "
                         f"resident with n = {n} columns on this device")
    return nb.value
