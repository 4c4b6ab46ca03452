"""Problem container: one FASTA instance = operator + smooth + prox terms
(port of ``fasta_tpu/problem.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Optional

import numpy as np
import torch

from .operators import LinearOp
from .options import FastaOptions
from .profiling import span
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
    recover: Optional[Callable] = None  # solver variable -> signal

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

    def microsolve_batch(self, bs, x0s=None, **kwargs):
        """B instances sharing this problem's operator — measurements
        ``bs`` stacked on a leading axis, optional starts ``x0s`` and prox
        data ``prox=`` — in one kernel launch; see
        :func:`fasta_tpu_torch.micro.microsolve_batch`."""
        from .micro import microsolve_batch as _batch
        return _batch(self, bs, x0s=x0s, **kwargs)

    def solve_serving(self, bs=None, *, need_full_diagnostics=False,
                      **kwargs):
        """Solve on the serving path that
        :func:`fasta_tpu_torch.serving.recommend_path` picks for this
        problem and batch: ``bs`` stacks the requests' measurements on a
        leading axis, or is a :class:`~fasta_tpu_torch.serving.
        InstanceBatch` that also carries each instance's prox data and
        start (None: one solve of the problem's own); the other keyword
        arguments go to that path.  The whole request is the span
        ``fasta.serve``."""
        from .serving import recommend_path
        with span("fasta.serve"):
            batch = 1 if bs is None else len(bs)
            plan = recommend_path(self, batch,
                                  need_full_diagnostics=need_full_diagnostics)
            return plan.run(bs, **kwargs)

    def with_parts(self, **kwargs) -> "Problem":
        """A copy with the named fields replaced (``op``, ``fterm``,
        ``gterm``, ``x0``, ...)."""
        return replace(self, **kwargs)

    def recovery_error(self, x, recovered: Optional[bool] = None) -> float:
        """Relative error against the planted signal, phase-invariant for
        complex problems (the global phase is aligned first).

        ``recovered=False`` says ``x`` is a solver-layout iterate
        (``recover`` is applied when present), True that it is already a
        signal-space vector (e.g. the oracle's solution of a planar
        problem's complex formulation); None infers it from the shape, as
        the JAX package does (``fasta_tpu/problem.py:96-120``).  NaN
        without a planted signal."""
        if self.x_true is None:
            return float("nan")
        x = _host(x)
        xt = np.asarray(self.x_true)
        apply = (self.recover is not None
                 and (recovered is False
                      or (recovered is None and x.shape != xt.shape)))
        if apply:
            x = _host(self.recover(x))
        if np.iscomplexobj(xt) or np.iscomplexobj(x):
            phase = np.vdot(x, xt)
            x = x * (phase / max(abs(phase), 1e-30))
        return float(np.linalg.norm(x - xt) / max(np.linalg.norm(xt), 1e-30))


def _host(a) -> np.ndarray:
    """A tensor or array as a NumPy array on the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
