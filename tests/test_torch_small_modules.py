"""The small modules of the port on the CPU: ``smooth``'s closure builders
against ``fasta_tpu.smooth`` on the same data (rtol 1e-12), the figures of
``tests/unit/test_plotting.py`` drawn from port results (Agg backend, no
display), and the suite runner ``python -m fasta_tpu_torch.problems`` for
LASSO at its quick size, writing into a temporary directory, and without
matplotlib."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fasta_tpu as ft
import fasta_tpu_torch as ftt
from fasta_tpu_torch import plotting, problems, smooth
from fasta_tpu_torch.harness import compare_modes, format_comparison
from fasta_tpu_torch.problems import __main__ as runner

torch.set_num_threads(1)

RNG = np.random.default_rng(2)


# --------------------------------------------------------------------------
# smooth
# --------------------------------------------------------------------------

def _pair_close(ours, theirs, d):
    np.testing.assert_allclose(float(ours(torch.from_numpy(d))),
                               float(theirs(jnp.asarray(d))), rtol=1e-12)


@pytest.mark.parametrize("name", ["least_squares", "logistic",
                                  "phase_hinge"])
def test_smooth_builder_matches_jax(name):
    n = {"least_squares": 32, "logistic": 24, "phase_hinge": 16}[name]
    if name == "logistic":
        b = (RNG.random(n) < 0.5).astype(np.float64)
    elif name == "phase_hinge":
        b = np.abs(RNG.standard_normal(n))
    else:
        b = RNG.standard_normal(n)
    d = RNG.standard_normal(n)
    if name == "phase_hinge":
        d = d + 1j * RNG.standard_normal(n)
    f, gradf = getattr(smooth, name)(torch.from_numpy(b))
    jf, jgradf = getattr(ft.smooth, name)(jnp.asarray(b))
    _pair_close(f, jf, d)
    np.testing.assert_allclose(gradf(torch.from_numpy(d)).numpy(),
                               np.asarray(jgradf(jnp.asarray(d))),
                               rtol=1e-12, atol=1e-12)
    # the builders bind the terms' own methods
    term = {"least_squares": ftt.LeastSquares, "logistic": ftt.Logistic,
            "phase_hinge": ftt.PhaseHinge}[name]
    assert isinstance(f.__self__, term) and gradf.__self__ is f.__self__


def test_objective_l1_builder_matches_jax():
    x = RNG.standard_normal(10)
    _pair_close(smooth.objective_l1(0.3), ft.smooth.objective_l1(0.3), x)
    np.testing.assert_allclose(float(smooth.objective_l1(0.3)(
        torch.from_numpy(x))), 0.3 * np.abs(x).sum(), rtol=1e-12)


# --------------------------------------------------------------------------
# plotting (tests/unit/test_plotting.py's figures)
# --------------------------------------------------------------------------

def test_comparison_figure(tmp_path):
    prob = problems.build("lasso", m=48, n=64, k=6, dtype=torch.float64,
                          device="cpu")
    prob.tau0 = 0.05
    results = compare_modes(prob, tol=1e-6, max_iters=40)
    path = plotting.save_comparison_figure(prob, results,
                                           str(tmp_path / "lasso.png"))
    assert os.path.exists(path) and os.path.getsize(path) > 1000
    table = format_comparison(prob, results)
    assert "adaptive" in table and "accelerated" in table


def test_image_problem_figure(tmp_path):
    prob = problems.build("tv", h=32, w=32, dtype=torch.float64,
                          device="cpu")
    prob.tau0 = 2.0
    results = compare_modes(prob, tol=1e-4, max_iters=30)
    path = plotting.save_comparison_figure(prob, results,
                                           str(tmp_path / "tv.png"))
    assert os.path.exists(path) and os.path.getsize(path) > 1000


def test_plot_convergence_takes_device_results():
    """A ``DeviceResult``'s tensors are drawn too (moved to the host)."""
    prob = problems.build("lasso", m=48, n=64, k=6, dtype=torch.float64,
                          device="cpu")
    out = prob.solve_device(ftt.FastaOptions(max_iters=20), tau0=0.05)
    ax = plotting.plot_convergence({"adaptive": out})
    assert len(ax.get_lines()) == 1
    assert len(ax.get_lines()[0].get_xdata()) == 20


# --------------------------------------------------------------------------
# the runner
# --------------------------------------------------------------------------

def test_runner_lasso_quick_on_the_cpu(tmp_path, capsys):
    out = runner.run_problem("lasso", quick=True, device="cpu",
                             out_dir=str(tmp_path))
    printed = capsys.readouterr().out
    assert "problem: lasso[200x400]" in printed and "figure:" in printed
    assert out["figure"] == str(tmp_path / "lasso.png")
    assert os.path.getsize(out["figure"]) > 1000
    assert set(out["results"]) == {"plain", "adaptive", "accelerated"}
    assert out["results"]["adaptive"].converged
    assert out["problem"].x0.device.type == "cpu"
    # the figures' default is the checkout's build/, never docs/
    assert runner.FIGURES.parts[-2:] == ("build", "figures")


def test_runner_goes_on_without_matplotlib(tmp_path, capsys, monkeypatch):
    """Where matplotlib is missing (the card's machine), the runner says
    that the figure was skipped and returns the results."""
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    runner.main(["--quick", "--device", "cpu", "--out", str(tmp_path),
                 "lasso"])
    printed = capsys.readouterr().out
    assert "figure skipped" in printed and "problem: lasso" in printed
    assert not os.listdir(tmp_path)


def test_runner_refuses_an_unknown_problem():
    with pytest.raises(SystemExit):
        runner.main(["--device", "cpu", "no_such_problem"])
