"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version beside it.

* K-B3 ``fused_lstsq_gradmap`` and K-B3p ``fused_pointwise_gradmap``
  over a float32 or bfloat16 A (``lstsq_fused.py``,
  ``csrc/lstsq_fused.cu``)
* K-B1 ``microsolve_lasso``, K-B1p ``microsolve_lasso_path`` and K-B1b
  ``microsolve_lasso_batch`` (``microsolver.py``, ``csrc/microsolver.cu``),
  with K-B2, the FP64 decision-scalar reduction (``csrc/reduce.cuh``),
  inlined.  The losses both sources share are in ``csrc/losses.cuh``; the
  row machinery K-B1 shares with K-P3, K-P4 and K-P1's gradmap form in
  ``csrc/dense_rows.cuh``.
* K-B4 ``fused_shrink_step``, the L1 trial step (``prox_fused.py``,
  ``csrc/prox_fused.cu``; its soft threshold is in ``csrc/prox.cuh``)
* the adaptive loop's elementwise chain over the lanes: ``residual_value``
  (r = d − b and ½‖r‖²), ``adaptive_sums`` (‖g‖², ⟨Δx, Δg⟩, ‖Δg‖²) and
  ``lane_update`` (x, ∇f, the solution and the best iterate in place)
  (``lane_fused.py``, ``csrc/lane_fused.cu``; no TPU kernel: XLA fuses
  that chain in the reference)
* K-B5 ``fused_tv_gradmap`` and its band form ``fused_tv_gradmap_band``
  over one rank's rows of a row-sharded image (``tv_fused.py``,
  ``csrc/tv_fused.cu``)
* K-B6 ``microsolve_tv``, K-B6p ``microsolve_tv_path`` and K-B6b
  ``microsolve_tv_batch`` (``microsolver_tv.py``, ``csrc/microsolver_tv.cu``)
* K-B7 ``fused_planar_lstsq_gradmap`` / ``fused_planar_hinge_gradmap``
  over float32 or bfloat16 channels (``planar_fused.py``,
  ``csrc/planar_fused.cu``)
* K-B8 ``microsolve_planar_phasemax`` and K-B8b
  ``microsolve_planar_phasemax_batch`` (``microsolver_planar.py``,
  ``csrc/microsolver_planar.cu``; a route for n ≤ 512 and one past it),
  whose row work they share with K-P5 (``csrc/planar_rows.cuh``)
* K-P5 ``planar_probe``, the planar layout probe (``planar_probe.py``,
  ``csrc/planar_probe.cu``)
* K-P4 ``bf16_probe``, the bfloat16-storage probe (``bf16_probe.py``,
  ``csrc/bf16_probe.cu``)
* K-P1 ``run_variant``, the GEMV formulation probe (``matvec_probe.py``,
  ``csrc/matvec_probe.cu``; its ``gradmap_fused`` form on K-B1's rows on
  the chip, ``csrc/gradmap_probe.cu``), and K-P2 ``gradmap_fused`` /
  ``check_gradmap_correct``, the one-pass gradient-map check
  (``matvec_probe.py``, ``csrc/matvec_probe.cu``)
* K-P3 ``make(level, ...)`` → ``run``, the tail-ablation ladder of the
  dense whole-solve iteration (``tail_probe.py``, ``csrc/tail_probe.cu``)

A wrapper runs its kernel for CUDA tensors and its plain version for CPU
tensors.  Each module counts its kernels' launches (``LAUNCHES``,
``POINTWISE_LAUNCHES``, ``PATH_LAUNCHES``, ``BATCH_LAUNCHES``,
``BAND_LAUNCHES`` for K-B5's band form, and
``BF16_LAUNCHES``, ``POINTWISE_BF16_LAUNCHES``, ``WIDE_LAUNCHES``,
``WIDE_BATCH_LAUNCHES`` for the bfloat16 forms and K-B8's wide route,
``CHECK_LAUNCHES`` for K-P2, ``RESIDUAL_LAUNCHES``, ``SUMS_LAUNCHES``
and ``UPDATE_LAUNCHES`` for the lane kernels); read
them as module attributes (``lstsq_fused.LAUNCHES``), since importing the
name copies the integer.  Nothing is compiled at import.
"""

from . import (bf16_probe, lane_fused, lstsq_fused, matvec_probe,
               microsolver, microsolver_planar, microsolver_tv, planar_fused,
               planar_probe, prox_fused, tail_probe, tv_fused)
from .lstsq_fused import (fused_lstsq_gradmap, fused_pointwise_gradmap,
                          lstsq_gradmap_reference,
                          pointwise_gradmap_reference, supports_fusion)
from .microsolver import (MicrosolveOutput, microsolve_lasso,
                          microsolve_lasso_batch,
                          microsolve_lasso_batch_reference,
                          microsolve_lasso_path,
                          microsolve_lasso_path_reference,
                          microsolve_lasso_reference, supports_microsolver)
from .microsolver_planar import (microsolve_planar_phasemax,
                                 microsolve_planar_phasemax_batch,
                                 microsolve_planar_phasemax_batch_reference,
                                 microsolve_planar_phasemax_reference)
from .microsolver_tv import (microsolve_tv, microsolve_tv_batch,
                             microsolve_tv_batch_reference,
                             microsolve_tv_path, microsolve_tv_path_reference,
                             microsolve_tv_reference)
from .prox_fused import fused_shrink_step, shrink_step_reference
from .planar_fused import (fused_planar_hinge_gradmap,
                           fused_planar_lstsq_gradmap,
                           planar_hinge_gradmap_reference,
                           planar_lstsq_gradmap_reference)
from .tv_fused import (fused_tv_gradmap, fused_tv_gradmap_band,
                       tv_gradmap_band_reference, tv_gradmap_reference)

__all__ = [
    "bf16_probe", "lane_fused", "lstsq_fused", "matvec_probe", "microsolver",
    "microsolver_planar", "microsolver_tv", "planar_fused", "planar_probe",
    "prox_fused", "tail_probe", "tv_fused",
    "fused_shrink_step", "shrink_step_reference",
    "microsolve_lasso_batch", "microsolve_lasso_batch_reference",
    "microsolve_tv_batch", "microsolve_tv_batch_reference",
    "microsolve_planar_phasemax_batch",
    "microsolve_planar_phasemax_batch_reference",
    "fused_planar_lstsq_gradmap", "fused_planar_hinge_gradmap",
    "planar_lstsq_gradmap_reference", "planar_hinge_gradmap_reference",
    "microsolve_planar_phasemax", "microsolve_planar_phasemax_reference",
    "fused_tv_gradmap", "tv_gradmap_reference", "fused_tv_gradmap_band",
    "tv_gradmap_band_reference", "microsolve_tv",
    "microsolve_tv_reference", "microsolve_tv_path",
    "microsolve_tv_path_reference",
    "fused_lstsq_gradmap", "lstsq_gradmap_reference",
    "fused_pointwise_gradmap", "pointwise_gradmap_reference",
    "supports_fusion", "MicrosolveOutput", "microsolve_lasso",
    "microsolve_lasso_reference", "microsolve_lasso_path",
    "microsolve_lasso_path_reference", "supports_microsolver",
]
