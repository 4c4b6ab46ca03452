"""Matrix completion, max-norm and NMF — the identity-operator problems
over a matrix variable — through the port's public entry points, held
against the float64 oracle and ``fasta_tpu`` with the checks and bands
of tests/test_torch_problems_slice.py (CPU), and the mode-comparison
harness.

Bands: the final objective within 1e-5, the first 10 taus and f-values
rtol 1e-7, residuals rtol 1e-6 / atol 1e-12, the count equal on
max_norm and within max(5, 20%) elsewhere (tests/parity/test_parity.py);
NMF's ``recover`` against the JAX problem's within 1e-12; the harness's
three modes on max-norm with JAX's counts and objectives within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fasta_tpu as ft
import problems as jax_problems
from fasta_tpu.harness import format_comparison as jax_format
from fasta_tpu_torch import harness, problems
from test_torch_problems_slice import (MODES, check_build_needs_a_card,
                                       check_jax_adaptive,
                                       check_microsolve_raises,
                                       check_oracle_parity)

torch.set_num_threads(1)

HERE = ["matrix_completion", "max_norm", "nmf"]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", HERE)
def test_modes_match_the_oracle(name, mode):
    check_oracle_parity(name, mode)


@pytest.mark.parametrize("name", HERE)
def test_adaptive_matches_fasta_tpu(name):
    check_jax_adaptive(name)


@pytest.mark.parametrize("name", HERE)
def test_microsolve_raises_as_the_reference_does(name):
    check_microsolve_raises(name)


@pytest.mark.parametrize("name", HERE)
def test_build_without_device_needs_a_card(name):
    check_build_needs_a_card(name)


def test_nmf_recover_and_recovery_error_match_jax():
    pt = problems.build("nmf", d1=30, d2=20, rank=3, dtype=torch.float64,
                        device="cpu")
    pj = jax_problems.build("nmf", d1=30, d2=20, rank=3, dtype=jnp.float64)
    X = np.abs(np.random.default_rng(0).standard_normal((50, 3)))
    np.testing.assert_allclose(np.asarray(pt.recover(torch.from_numpy(X))),
                               np.asarray(pj.recover(jnp.asarray(X))),
                               atol=1e-12)
    assert pt.recovery_error(X) == pytest.approx(pj.recovery_error(X),
                                                 rel=1e-12)


def test_all_thirteen_problems_build_and_solve_on_the_cpu():
    """Every registered name builds on the CPU at a small size and takes
    a few iterations of each mode."""
    sizes = {
        "lasso": dict(m=40, n=80, k=5), "nnls": dict(m=40, n=20),
        "logistic": dict(m=40, n=20, k=4), "svm": dict(m=40, n=10),
        "tv": dict(h=8, w=8), "phase_retrieval": dict(m=64, n=8),
        "phase_retrieval_cdp": dict(n=16, K=2),
        "democratic": dict(m=16, n=32), "mmv": dict(m=20, n=30, l=3, k=4),
        "matrix_completion": dict(d1=10, d2=8, rank=2),
        "max_norm": dict(d1=10, d2=4),
        "sparse_lasso": dict(m=30, n=60, density=0.2, k=4),
        "nmf": dict(d1=10, d2=8, rank=2),
    }
    problems.build("lasso", device="cpu", **sizes["lasso"])
    assert sorted(problems.REGISTRY) == sorted(sizes)
    for name, kw in sizes.items():
        p = problems.build(name, device="cpu", **kw)
        for mode in MODES.values():
            r = p.solve(tau0=0.01, max_iters=3, stop_rule="iterations",
                        **mode)
            assert r.iteration_count == 3 and np.isfinite(r.fvals).all()
    with pytest.raises(KeyError, match="no problem named"):
        problems.build("no_such_problem", device="cpu")


def test_compare_modes_and_format_comparison_match_jax():
    """``compare_modes`` runs the three modes with objectives recorded;
    ``format_comparison``'s table has the JAX one's rows and columns, and
    the converged objectives agree with JAX's within 1e-5."""
    pt = problems.build("max_norm", d1=40, d2=8, dtype=torch.float64,
                        device="cpu")
    pj = jax_problems.build("max_norm", d1=40, d2=8, dtype=jnp.float64)
    pt.tau0 = pj.tau0 = 0.5
    rt = harness.compare_modes(pt, tol=1e-9, max_iters=200)
    rj = ft.harness.compare_modes(pj, tol=1e-9, max_iters=200)
    assert list(rt) == list(harness.MODE_OPTIONS) == list(rj)
    for mode in rt:
        assert rt[mode].converged and rt[mode].objectives is not None
        assert rt[mode].iteration_count == rj[mode].iteration_count
        assert rt[mode].objectives[-1] == pytest.approx(
            float(np.asarray(rj[mode].objectives)[-1]), rel=1e-5)
    table_t = harness.format_comparison(pt, rt).splitlines()
    table_j = jax_format(pj, rj).splitlines()
    assert table_t[:2] == table_j[:2]
    for lt, lj in zip(table_t[2:], table_j[2:]):
        # the same mode, count, flag and objective (to its printed
        # digits); residual and wall time are the solvers' own
        assert lt.split()[:4] == lj.split()[:4]


def test_later_modules_import_no_jax():
    """The seven problem modules, the harness and the structured
    operators import with jax and fasta_tpu blocked."""
    import subprocess
    import sys
    from pathlib import Path
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['jaxlib'] = None; sys.modules['fasta_tpu'] = None; "
            "import fasta_tpu_torch.harness; "
            "from fasta_tpu_torch.problems import (sparse_lasso, democratic, "
            "mmv, matrix_completion, max_norm, nmf, phase_retrieval_cdp); "
            "from fasta_tpu_torch import problems; "
            "problems.build('phase_retrieval_cdp', n=8, K=2, device='cpu'); "
            "problems.build('sparse_lasso', m=8, n=16, k=2, device='cpu'); "
            "bad = [m for m in sys.modules if sys.modules[m] is not None and "
            "(m == 'jax' or m.startswith(('jax.', 'jaxlib', 'fasta_tpu.')) "
            "or m == 'fasta_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
