"""Run the whole example suite (port of ``problems/__main__.py``):

    python -m fasta_tpu_torch.problems [--quick] [--device cpu] [--out DIR]
                                       [NAME ...]

Prints each problem's three-mode comparison table and writes its
convergence and solution figure to ``build/figures/`` of the checkout (or
``--out``).  ``--quick`` takes ``QUICK_SIZES``; NAMEs run those problems
only.  The problems live on the card unless ``--device cpu`` is given.
Drawing a figure is best-effort: without matplotlib the runner says so
and goes on.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Optional

from ..harness import compare_modes, format_comparison
from . import build

QUICK_SIZES = {
    "lasso": dict(m=200, n=400, k=20),
    "nnls": dict(m=200, n=100),
    "logistic": dict(m=200, n=100),
    "tv": dict(h=64, w=64),
    "phase_retrieval": dict(m=1024, n=64),
    "phase_retrieval_cdp": dict(n=64, K=4),
    "democratic": dict(m=64, n=256),
    "mmv": dict(m=100, n=200, l=4, k=10),
    "matrix_completion": dict(d1=60, d2=60, rank=3),
    "max_norm": dict(d1=100, d2=20),
    "svm": dict(m=200, n=50),
    "nmf": dict(d1=40, d2=30, rank=3),
    "sparse_lasso": dict(m=300, n=600, density=0.05),
}

# the checkout's build/figures (gitignored; docs/figures holds the JAX
# package's figures)
FIGURES = Path(__file__).resolve().parents[2] / "build" / "figures"


def run_problem(name: str, *, quick: bool = False, device=None,
                out_dir: Optional[str] = None, tol: float = 1e-6,
                max_iters: int = 2000) -> dict:
    """One problem of the suite: built (at ``QUICK_SIZES`` with ``quick``)
    on ``device`` (the card when None), solved in the three modes, its
    table printed and its figure written to ``out_dir`` (``FIGURES`` when
    None).  Returns the problem, the results by mode and the figure's
    path (None when it was skipped)."""
    prob = build(name, device=device,
                 **(dict(QUICK_SIZES[name]) if quick else {}))
    results = compare_modes(prob, tol=tol, max_iters=max_iters)
    print(format_comparison(prob, results))
    out_dir = str(FIGURES if out_dir is None else out_dir)
    try:
        from ..plotting import save_comparison_figure
        os.makedirs(out_dir, exist_ok=True)
        path = save_comparison_figure(prob, results,
                                      os.path.join(out_dir, f"{name}.png"))
        print(f"  figure: {path}")
    except Exception as e:          # plotting is best-effort
        path = None
        print(f"  (figure skipped: {type(e).__name__}: {e})")
    print()
    return dict(problem=prob, results=results, figure=path)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m fasta_tpu_torch.problems",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", metavar="NAME",
                    help=f"problems to run (default: all of "
                         f"{', '.join(QUICK_SIZES)})")
    ap.add_argument("--quick", action="store_true",
                    help="the small sizes of QUICK_SIZES")
    ap.add_argument("--device", default=None,
                    help="where the problems live (default: the card)")
    ap.add_argument("--out", default=None,
                    help=f"the figures' directory (default: {FIGURES})")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.names) - set(QUICK_SIZES))
    if unknown:
        ap.error(f"no problem named {', '.join(unknown)}")
    for name in args.names or QUICK_SIZES:
        run_problem(name, quick=args.quick, device=args.device,
                    out_dir=args.out)


if __name__ == "__main__":
    main()
