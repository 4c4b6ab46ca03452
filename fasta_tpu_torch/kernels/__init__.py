"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version beside it.

* K-B3 ``fused_lstsq_gradmap`` and K-B3p ``fused_pointwise_gradmap``
  (``lstsq_fused.py``, ``csrc/lstsq_fused.cu``)
* K-B1 ``microsolve_lasso`` and K-B1p ``microsolve_lasso_path``
  (``microsolver.py``, ``csrc/microsolver.cu``), with K-B2, the FP64
  decision-scalar reduction (``csrc/reduce.cuh``), inlined.  The losses
  both sources share are in ``csrc/losses.cuh``.
* K-B5 ``fused_tv_gradmap`` (``tv_fused.py``, ``csrc/tv_fused.cu``)
* K-B6 ``microsolve_tv`` and K-B6p ``microsolve_tv_path``
  (``microsolver_tv.py``, ``csrc/microsolver_tv.cu``)

A wrapper runs its kernel for CUDA tensors and its plain version for CPU
tensors.  Each module counts its kernels' launches (``LAUNCHES``,
``POINTWISE_LAUNCHES``, ``PATH_LAUNCHES``); read them as module
attributes (``lstsq_fused.LAUNCHES``), since importing the name copies
the integer.  Nothing is compiled at import.
"""

from . import lstsq_fused, microsolver, microsolver_tv, tv_fused
from .lstsq_fused import (fused_lstsq_gradmap, fused_pointwise_gradmap,
                          lstsq_gradmap_reference,
                          pointwise_gradmap_reference, supports_fusion)
from .microsolver import (MicrosolveOutput, microsolve_lasso,
                          microsolve_lasso_path,
                          microsolve_lasso_path_reference,
                          microsolve_lasso_reference, supports_microsolver)

from .microsolver_tv import (microsolve_tv, microsolve_tv_path,
                             microsolve_tv_path_reference,
                             microsolve_tv_reference)
from .tv_fused import fused_tv_gradmap, tv_gradmap_reference

__all__ = [
    "lstsq_fused", "microsolver", "microsolver_tv", "tv_fused",
    "fused_tv_gradmap", "tv_gradmap_reference", "microsolve_tv",
    "microsolve_tv_reference", "microsolve_tv_path",
    "microsolve_tv_path_reference",
    "fused_lstsq_gradmap", "lstsq_gradmap_reference",
    "fused_pointwise_gradmap", "pointwise_gradmap_reference",
    "supports_fusion", "MicrosolveOutput", "microsolve_lasso",
    "microsolve_lasso_reference", "microsolve_lasso_path",
    "microsolve_lasso_path_reference", "supports_microsolver",
]
