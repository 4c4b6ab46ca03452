"""Problem container: one FASTA instance = operator + smooth + prox terms
(port of ``fasta_tpu/problem.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from .operators import LinearOp
from .options import FastaOptions
from .solver import DeviceResult, FastaResult, fasta, make_solver
from .terms import ProxTerm, SmoothTerm

__all__ = ["Problem"]


@dataclass
class Problem:
    """A fully specified  min f(Ax) + g(x)  instance.  Its tensors live on
    the device that ``problems.build`` (or ``convert``) was given."""

    name: str
    op: LinearOp
    fterm: SmoothTerm
    gterm: ProxTerm
    x0: Any
    tau0: Optional[float] = None       # explicit stepsize (RNG-parity mode)
    x_true: Optional[np.ndarray] = None
    instance: dict = field(default_factory=dict)   # raw NumPy arrays
    recover: Optional[Callable] = None  # solver variable -> signal (TV)

    def solve(self, options: Optional[FastaOptions] = None,
              **kwargs) -> FastaResult:
        """Run the solver on this instance (host-side result)."""
        kwargs.setdefault("tau0", self.tau0)
        return fasta(self.op, None, self.fterm, None, self.gterm, None,
                     torch.as_tensor(self.x0), options=options, **kwargs)

    def solve_device(self, options: Optional[FastaOptions] = None,
                     tau0: Optional[float] = None) -> DeviceResult:
        """Device-side solve — results stay on the device."""
        opts = options or FastaOptions()
        if tau0 is None:
            tau0 = self.tau0
        if tau0 is None:
            raise ValueError("device path needs an explicit tau0")
        return make_solver(opts)(self.op, self.fterm, self.gterm,
                                 torch.as_tensor(self.x0), tau0)

    def microsolve(self, **kwargs):
        """Whole-solve-in-one-kernel path (adaptive or FISTA); see
        :func:`fasta_tpu_torch.micro.microsolve`.  Raises ``ValueError``
        when this problem's structure has no kernel."""
        from .micro import microsolve as _micro
        return _micro(self, **kwargs)

    def microsolve_sweep(self, mus, **kwargs):
        """The regularization path over ``mus`` in one kernel launch,
        cold or (``warm_start=True``) warm; see
        :func:`fasta_tpu_torch.micro.microsolve_sweep`."""
        from .micro import microsolve_sweep as _sweep
        return _sweep(self, mus, **kwargs)
