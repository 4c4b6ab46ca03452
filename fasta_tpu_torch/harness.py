"""Mode-comparison harness (port of ``fasta_tpu/harness.py``).

The reference's test of every example: solve the same problem with plain
FBS, adaptive BB and FISTA, and compare the three.  Every problem
module's ``__main__`` prints this table.
"""

from __future__ import annotations

from typing import Dict, Optional

from .options import FastaOptions
from .problem import Problem
from .solver import FastaResult

__all__ = ["compare_modes", "format_comparison", "MODE_OPTIONS"]

MODE_OPTIONS = {
    "plain":       dict(adaptive=False, accelerate=False),
    "adaptive":    dict(adaptive=True, accelerate=False),
    "accelerated": dict(adaptive=False, accelerate=True),
}


def compare_modes(problem: Problem,
                  options: Optional[FastaOptions] = None,
                  **kwargs) -> Dict[str, FastaResult]:
    """Solve ``problem`` in all three modes (objectives recorded); the
    other keyword arguments go to ``Problem.solve``.  Returns mode →
    result (``fasta_tpu/harness.py:26``)."""
    base = options or FastaOptions()
    results = {}
    for mode, mode_kw in MODE_OPTIONS.items():
        opts = base.replace(record_objective=True, **mode_kw)
        results[mode] = problem.solve(options=opts, **kwargs)
    return results


def format_comparison(problem: Problem,
                      results: Dict[str, FastaResult]) -> str:
    """The mode-comparison table: iterations, convergence, final
    objective, residual, backtracks, recovery error and wall time
    (``fasta_tpu/harness.py:38``)."""
    lines = [
        f"problem: {problem.name}",
        f"{'mode':<12} {'iters':>6} {'converged':>9} {'objective':>14} "
        f"{'residual':>11} {'bt':>4} {'rel_err':>9} {'time_s':>8}",
    ]
    for mode, r in results.items():
        obj = r.objectives[-1] if r.objectives is not None else float("nan")
        err = problem.recovery_error(r.solution)
        lines.append(
            f"{mode:<12} {r.iteration_count:>6d} {str(r.converged):>9} "
            f"{obj:>14.6e} {r.residuals[-1]:>11.3e} "
            f"{r.total_backtracks:>4d} {err:>9.3e} {r.solve_time:>8.3f}")
    return "\n".join(lines)
