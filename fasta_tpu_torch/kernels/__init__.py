"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version beside it.

* K-B3 ``fused_lstsq_gradmap`` (``lstsq_fused.py``, ``csrc/lstsq_fused.cu``)
* K-B1 ``microsolve_lasso`` (``microsolver.py``, ``csrc/microsolver.cu``),
  with K-B2, the FP64 decision-scalar reduction (``csrc/reduce.cuh``),
  inlined.

A wrapper runs its kernel for CUDA tensors and its plain version for CPU
tensors.  Each module counts its kernel's launches in ``LAUNCHES``; read
it as a module attribute (``lstsq_fused.LAUNCHES``), since importing the
name copies the integer.  Nothing is compiled at import.
"""

from . import lstsq_fused, microsolver
from .lstsq_fused import (fused_lstsq_gradmap, lstsq_gradmap_reference,
                          supports_fusion)
from .microsolver import (MicrosolveOutput, microsolve_lasso,
                          microsolve_lasso_reference, supports_microsolver)

__all__ = [
    "lstsq_fused", "microsolver",
    "fused_lstsq_gradmap", "lstsq_gradmap_reference", "supports_fusion",
    "MicrosolveOutput", "microsolve_lasso", "microsolve_lasso_reference",
    "supports_microsolver",
]
