"""The serving path: which execution route a request takes, and running
it (port of ``fasta_tpu/serving.py``).

:func:`recommend_path` reads a problem's structure, dtype and size and the
request's batch size, and returns a :class:`ServingPlan` that names one
of four routes, says why, and runs it:

* ``"microsolve"`` — one solve in one launch of a whole-solve kernel
  (K-B1, K-B6 or K-B8): every single solve whose structure has a kernel.
* ``"microsolve_batch"`` — a batch in one launch of a batched whole-solve
  kernel (K-B1b, K-B6b or K-B8b), each instance over the whole card in
  turn: batches of problems with at least ``BATCH_CROSSOVER_UNKNOWNS``
  unknowns.
* ``"batch_solver"`` — the PyTorch loop over a lane axis
  (:func:`~fasta_tpu_torch.solver.make_batch_solver`): batches of smaller
  problems, whose iterations gain from running the instances side by
  side, and batches of structures without a kernel.
* ``"loop"`` — the PyTorch loop (``Problem.solve``): single solves of
  structures without a kernel, of float64 data, or that need the full
  diagnostics.  The reference calls this route ``"xla"``.

The decision tree and the crossover of 32,768 unknowns are the
reference's, kept so that the port routes every request as the reference
does; the reference set them by measurements on its TPU, and neither has
been measured on the H100 yet (ROADMAP M5).  :func:`recommend_path` does
no device work.

One fault of the reference is not inherited (ROADMAP C-ref-6): its plan
ignores ``bs`` on the single routes, so a one-row request solved the
problem's own measurements.  Here a single route given ``bs`` of one row
solves that row.

A request whose instances differ in more than the smooth term's data is
an :class:`InstanceBatch`: each instance also carries its own prox data
(planar PhaseMax's anchor) and start, which every route takes.  The
reference's plan has no such request: its batch routes share the
problem's prox term and start.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Optional

import torch

from .micro import microsolve_supported
from .options import FastaOptions
from .problem import Problem
from .profiling import span

__all__ = ["ServingPlan", "InstanceBatch", "recommend_path",
           "BATCH_CROSSOVER_UNKNOWNS", "ROUTES"]

# The reference's size crossover between the two batch routes (unknowns
# per instance); not measured on the H100 (ROADMAP M5).
BATCH_CROSSOVER_UNKNOWNS = 32_768

ROUTES = ("microsolve", "microsolve_batch", "batch_solver", "loop")


def _with_data(term, data):
    """A copy of the term ``term`` whose one data tensor is ``data``, in
    the dtype and on the device of the term's own."""
    field = getattr(term, "lane_field", None)
    if field is None:
        raise ValueError(
            f"the batch route replaces the term's one data tensor; "
            f"{type(term).__name__} has none — build the batched term "
            f"yourself and call make_batch_solver")
    old = getattr(term, field)
    out = copy.copy(term)
    setattr(out, field, torch.as_tensor(data).to(old.device, old.dtype))
    return out


@dataclass(eq=False)
class InstanceBatch:
    """A request of instances that share the problem's operator, each
    with its own data: ``data`` (B, ...) the smooth term's one data tensor
    an instance (what a plain ``bs`` holds), ``prox`` (B, ...) the prox
    term's one data tensor (its ``lane_field``: planar PhaseMax's anchor
    c) an instance, ``x0`` (B, ...) each instance's start; None shares the
    problem's own.  ``len`` is B; ``shape`` is ``data``'s and ``[i]``
    indexes the leading axis of all three, so an ``InstanceBatch`` of
    (P, B, ...) tensors is also a pool whose ``[i]`` is a request."""

    data: Any
    prox: Optional[Any] = None
    x0: Optional[Any] = None

    def __len__(self) -> int:
        return self.data.shape[0]

    @property
    def shape(self):
        return self.data.shape

    def __getitem__(self, i) -> "InstanceBatch":
        return InstanceBatch(self.data[i],
                             None if self.prox is None else self.prox[i],
                             None if self.x0 is None else self.x0[i])


def _instance(p: Problem, one: InstanceBatch) -> Problem:
    """``p`` with the data, prox data and start of one instance."""
    parts = dict(fterm=_with_data(p.fterm, one.data))
    if one.prox is not None:
        parts["gterm"] = _with_data(p.gterm, one.prox)
    if one.x0 is not None:
        x0 = torch.as_tensor(p.x0)
        parts["x0"] = torch.as_tensor(one.x0).to(x0.device, x0.dtype)
    return p.with_parts(**parts)


@dataclass
class ServingPlan:
    """A route (one of ``ROUTES``), the rule that chose it, and the
    problem and batch size it was chosen for.

    ``run(bs, ...)`` executes it.  ``bs`` stacks the requests'
    measurements on a leading axis (``(B,) +`` the smooth term's data
    shape), or is an :class:`InstanceBatch` whose instances also carry
    their own prox data and starts: the batch routes need it; a single
    route solves the problem's own measurements without it, or the one
    row of a ``bs`` of one row.
    Keyword arguments go to the route: :func:`~fasta_tpu_torch.micro.
    microsolve` / :func:`~fasta_tpu_torch.micro.microsolve_batch` options
    for the kernel routes, ``options=`` (a :class:`FastaOptions`) and
    ``tau0=`` for the loop routes.  The route's own call is the span
    ``fasta.route.<path>``; the set-up before it is not."""

    path: str
    reason: str
    problem: Problem
    batch_size: int

    def run(self, bs: Optional[Any] = None, **kwargs):
        p = self.problem
        route = span(f"fasta.route.{self.path}")
        if bs is not None and not isinstance(bs, InstanceBatch):
            bs = InstanceBatch(bs)
        if self.path in ("microsolve", "loop"):
            if bs is not None:
                if len(bs) != 1:
                    raise ValueError(
                        f"a {self.path!r} plan solves one instance, but bs "
                        f"holds {len(bs)}: ask recommend_path for batch size "
                        f"{len(bs)}")
                p = _instance(p, bs[0])
            with route:
                if self.path == "microsolve":
                    return p.microsolve(**kwargs)
                return p.solve(kwargs.pop("options", None), **kwargs)
        if bs is None:
            raise ValueError("a batched plan needs the stacked measurement "
                             "vectors bs")
        if self.path == "microsolve_batch":
            with route:
                return p.microsolve_batch(
                    bs.data, **{"x0s": bs.x0, "prox": bs.prox, **kwargs})
        from .solver import estimate_stepsize, make_batch_solver
        opts = kwargs.pop("options", None) or FastaOptions()
        tau0 = kwargs.pop("tau0", None)
        if kwargs:
            raise ValueError(f"the batch_solver route takes options= and "
                             f"tau0= only, got {sorted(kwargs)}")
        x0 = torch.as_tensor(p.x0)
        if tau0 is None:
            tau0 = p.tau0
        if tau0 is None:
            gen = torch.Generator(device=x0.device).manual_seed(0)
            tau0 = float(estimate_stepsize(p.op, p.fterm, x0, gen)[0])
        gterm, g_axis, x_axis = p.gterm, None, None
        if bs.prox is not None:
            gterm, g_axis = _with_data(p.gterm, bs.prox), 0
        if bs.x0 is not None:
            x0, x_axis = torch.as_tensor(bs.x0).to(x0.device, x0.dtype), 0
        solve = make_batch_solver(opts, in_axes=(None, 0, g_axis, x_axis,
                                                 None))
        fterm = _with_data(p.fterm, bs.data)
        with route:
            return solve(p.op, fterm, gterm, x0, tau0)


def recommend_path(problem: Problem, batch_size: int = 1, *,
                   need_full_diagnostics: bool = False) -> ServingPlan:
    """The route for ``problem`` at ``batch_size`` instances, by the
    reference's decision tree (module docstring).  Reads the problem's
    structure and shapes only: no device work.  ``need_full_diagnostics``
    sends the request to the loop routes (the TV kernel records no
    iterates)."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    supported, why = microsolve_supported(problem)
    dtype = torch.as_tensor(problem.x0).dtype
    f32 = dtype in (torch.float32, torch.complex64)

    if need_full_diagnostics or not supported or not f32:
        cause = ("full diagnostics requested (the TV kernel lacks "
                 "record_iterates)" if need_full_diagnostics
                 else (f"no whole-solve kernel: {why}" if not supported
                       else f"{str(dtype).removeprefix('torch.')} solve "
                            f"(the kernels are f32)"))
        if batch_size == 1:
            return ServingPlan("loop", f"PyTorch loop — {cause}", problem,
                               batch_size)
        return ServingPlan("batch_solver", f"batch solver — {cause}",
                           problem, batch_size)

    if batch_size == 1:
        return ServingPlan(
            "microsolve",
            "whole-solve kernel — every single solve with a kernel takes "
            "one launch, with no host round trip per iteration",
            problem, batch_size)

    n_unknowns = torch.as_tensor(problem.x0).numel()
    if n_unknowns >= BATCH_CROSSOVER_UNKNOWNS:
        return ServingPlan(
            "microsolve_batch",
            f"one-launch kernel batch — {n_unknowns} unknowns >= the "
            f"{BATCH_CROSSOVER_UNKNOWNS} crossover: a large instance keeps "
            f"the whole card busy on its own",
            problem, batch_size)
    return ServingPlan(
        "batch_solver",
        f"batch solver — {n_unknowns} unknowns < the "
        f"{BATCH_CROSSOVER_UNKNOWNS} crossover: small instances gain from "
        f"running side by side in one loop",
        problem, batch_size)
