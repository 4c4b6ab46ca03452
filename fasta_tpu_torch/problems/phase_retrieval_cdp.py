"""E5b — Coded-diffraction phase retrieval:  b = |F(m_k ⊙ x)| (port of
``problems/phase_retrieval_cdp.py``).

The structured-operator form of E5: K random unit-modulation masks, each
measured through a unitary FFT (``torch.fft``), no dense matrix; the
operator is a ``StackedOp`` of ``ComposeOp(MaskedFourierOp, DiagonalOp)``
with the exact adjoint.  The PhaseMax hinge and anchor of E5, complex
data.  The instance comes from the shared float64 generator, cast to
``dtype`` on ``device``.
"""

from __future__ import annotations

import torch

from reference_oracle.generators import make_phase_retrieval_cdp

from ..convert import problem_from_instance
from ..operators import default_device
from ..problem import Problem
from . import register

__all__ = ["build"]


@register("phase_retrieval_cdp")
def build(n: int = 256, K: int = 8, delta: float = 0.1, seed: int = 10,
          dtype: torch.dtype = torch.complex64, *, device=None) -> Problem:
    """The instance of ``make_phase_retrieval_cdp(n, K, delta, seed)`` as
    ``dtype`` (complex) tensors on ``device`` (the card when None)."""
    inst = make_phase_retrieval_cdp(n=n, K=K, delta=delta, seed=seed)
    return problem_from_instance(
        inst, device=default_device(device, "problems.build"), dtype=dtype)


if __name__ == "__main__":
    from ..harness import compare_modes, format_comparison
    problem = build()
    print(format_comparison(problem, compare_modes(problem, tol=1e-6,
                                                   max_iters=500)))
