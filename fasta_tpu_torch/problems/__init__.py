"""Problem suite of the port (port of ``problems/__init__.py``): the 13
example problems, each built from the shared float64 generator
(``reference_oracle/generators.py``) and runnable as
``python -m fasta_tpu_torch.problems.<name>`` for the three-mode table.

  lasso             E1  sparse least squares, dense Gaussian 1000×2000
  nnls              E2  non-negative least squares (projection prox)
  logistic          E3  sparse logistic regression (non-quadratic f)
  tv                E4  total-variation denoising 512×512 (stencil op)
  phase_retrieval   E5  PhaseMax, complex A (or planar), 16384×256
  phase_retrieval_cdp E5b coded-diffraction phase retrieval (FFT stack)
  democratic        E6  L∞-penalized least squares
  mmv               E7  multiple-measurement-vector row sparsity (L2,1)
  matrix_completion E8  logistic 1-bit matrix completion (SVT prox)
  max_norm          E9  max-norm constrained least squares
  svm               E10 linear SVM (squared hinge, ridge)
  sparse_lasso      E10 LASSO over a scipy-sparse operator (SparseOp)
  nmf               E11 joint nonnegative matrix factorization
"""

from typing import Callable, Dict

REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        REGISTRY[name] = fn
        return fn
    return deco


def build(name: str, **kwargs):
    """Construct a named problem instance:
    ``build('lasso', m=..., device=...)``.  ``device`` defaults to the
    card, and raises without one: pass ``device="cpu"`` for the CPU."""
    from . import (democratic, lasso, logistic, matrix_completion,  # noqa: F401
                   max_norm, mmv, nmf, nnls, phase_retrieval,
                   phase_retrieval_cdp, sparse_lasso, svm, tv)
    if name not in REGISTRY:
        raise KeyError(f"no problem named {name!r}; registered: "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[name](**kwargs)
