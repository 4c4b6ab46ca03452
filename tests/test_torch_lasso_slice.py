"""The whole slice — ``fasta()``, ``Problem.solve`` and
``Problem.microsolve`` — held against ``fasta_tpu`` and the float64
oracle on the same instances (CPU), plus the carry-across helpers and
two process-level checks.

Tolerances follow the JAX suite: in float64 the same iteration count,
taus and fvals rtol 1e-7 on the first 10 iterations, residuals rtol 1e-6
/ atol 1e-12 and solution atol 1e-8 (tests/parity/test_parity.py); in
float32 with precision="auto", taus and fvals rtol 1e-4 on the first 15
iterations and the iteration count within test_f32_hp.py's band.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fasta_tpu as ft
import fasta_tpu_torch as ftt
import problems as jax_problems
from fasta_tpu_torch import problems
from fasta_tpu_torch.convert import (problem_from_arrays,
                                     problem_from_instance, result_to_numpy)
from reference_oracle.fasta_numpy import fasta as fasta_np

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(m=150, n=300, k=15)
TAU0 = 0.05


def _oracle(inst, **kw):
    return fasta_np(inst["op"], None, inst["f"], inst["gradf"], inst["g"],
                    inst["proxg"], inst["x0"], **kw)


def _pair(dtype_j, dtype_t, mu=0.1):
    pj = jax_problems.build("lasso", mu=mu, dtype=dtype_j, **SMALL)
    pt = problem_from_instance(pj.instance, device="cpu", dtype=dtype_t)
    return pj, pt


def _assert_f64_parity(r_t, r_ref, exact_backtracks=True):
    assert r_t.iteration_count == r_ref.iteration_count
    k = r_ref.iteration_count
    ks = min(10, k)
    np.testing.assert_allclose(r_t.taus[:ks], r_ref.taus[:ks], rtol=1e-7)
    np.testing.assert_allclose(r_t.fvals[:ks], r_ref.fvals[:ks], rtol=1e-7,
                               atol=1e-12)
    np.testing.assert_allclose(r_t.residuals[:k], r_ref.residuals[:k],
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(r_t.solution, r_ref.solution, atol=1e-8)
    if exact_backtracks:
        np.testing.assert_array_equal(r_t.backtracks[:k],
                                      r_ref.backtracks[:k])


@pytest.mark.parametrize("fuse", [True, False])
def test_fasta_f64_matches_jax_and_oracle(fuse):
    pj, pt = _pair(jnp.float64, torch.float64)
    kw = dict(tau0=TAU0, tol=1e-9, max_iters=200, record_objective=True)
    inst = pj.instance
    r_t = ftt.fasta(pt.op.A, None, pt.fterm, None, pt.gterm, None, pt.x0,
                    fuse=fuse, **kw)
    r_j = ft.fasta(pj.op, None, pj.fterm, None, pj.gterm, None, pj.x0,
                   fuse=fuse, **kw)
    r_np = _oracle(inst, **kw)
    assert r_t.converged and r_j.converged and r_np.converged
    _assert_f64_parity(r_t, r_j)
    _assert_f64_parity(r_t, r_np)
    np.testing.assert_allclose(r_t.objectives[-1], r_np.objectives[-1],
                               rtol=1e-10)
    np.testing.assert_allclose(r_t.best_iterate, r_j.best_iterate, atol=1e-8)
    assert r_t.total_backtracks == r_j.total_backtracks


@pytest.mark.parametrize("stop_rule", list(ftt.STOP_RULES))
def test_stop_rules_match_jax_f64(stop_rule):
    pj, pt = _pair(jnp.float64, torch.float64)
    kw = dict(tau0=TAU0, tol=1e-6, max_iters=60, stop_rule=stop_rule)
    r_t, r_j = pt.solve(**kw), pj.solve(**kw)
    _assert_f64_parity(r_t, r_j)
    np.testing.assert_allclose(r_t.norm_residuals, r_j.norm_residuals,
                               rtol=1e-6, atol=1e-12)
    assert r_t.converged == r_j.converged


def test_f32_auto_precision_tracks_oracle():
    pj, pt = _pair(jnp.float32, torch.float32, mu=0.05)
    kw = dict(tau0=TAU0, tol=1e-7, max_iters=4000)
    r_np = _oracle(pj.instance, **kw)
    r_t = pt.solve(precision="auto", **kw)
    assert r_np.converged and r_t.converged
    k = min(15, r_np.iteration_count, r_t.iteration_count)
    np.testing.assert_allclose(r_t.taus[:k], r_np.taus[:k], rtol=1e-4)
    np.testing.assert_allclose(r_t.fvals[:k], r_np.fvals[:k], rtol=1e-4)
    assert (r_np.iteration_count / 1.25 <= r_t.iteration_count
            <= 1.25 * r_np.iteration_count + 10)
    # the same band holds against the JAX double-word path
    r_j = pj.solve(precision="auto", **kw)
    np.testing.assert_allclose(r_t.taus[:k], r_j.taus[:k], rtol=1e-4)
    assert (r_j.iteration_count / 1.25 <= r_t.iteration_count
            <= 1.25 * r_j.iteration_count + 10)


def test_f32_standard_precision_matches_jax_prefix():
    pj, pt = _pair(jnp.float32, torch.float32)
    kw = dict(tau0=TAU0, tol=1e-6, max_iters=300, precision="standard")
    r_t, r_j = pt.solve(**kw), pj.solve(**kw)
    assert r_t.converged and r_j.converged
    k = min(15, r_t.iteration_count, r_j.iteration_count)
    np.testing.assert_allclose(r_t.taus[:k], r_j.taus[:k], rtol=1e-4)
    np.testing.assert_allclose(r_t.solution, r_j.solution, atol=1e-5)


def test_problem_paths_reach_the_oracle_objective():
    pt = problems.build("lasso", device="cpu", **SMALL)   # float32
    pt.tau0 = TAU0
    inst = pt.instance
    r_np = _oracle(inst, tau0=TAU0, tol=1e-8, max_iters=2000,
                   record_objective=True)

    def obj(x):
        x = np.asarray(x, np.float64)
        return 0.5 * np.sum((inst["A"] @ x - inst["b"]) ** 2) + \
            inst["mu"] * np.abs(x).sum()

    ref = r_np.objectives[-1]
    r_solve = pt.solve(tol=1e-6, max_iters=2000)
    r_micro = pt.microsolve(tol=1e-6, max_iters=2000)
    assert r_solve.converged and r_micro.status == "converged"
    assert abs(obj(r_solve.solution) - ref) <= 1e-5 * abs(ref)
    assert abs(obj(r_micro.solution.numpy()) - ref) <= 1e-5 * abs(ref)
    dev = pt.solve_device(ftt.FastaOptions(tol=1e-6, max_iters=2000))
    assert dev.converged and dev.iteration_count == r_solve.iteration_count
    assert dev.solution.dtype == torch.float32
    with pytest.raises(ValueError, match="tau0"):
        problems.build("lasso", device="cpu", **SMALL).solve_device()


def test_stop_fn_guard_and_recordings_match_jax():
    pj, pt = _pair(jnp.float64, torch.float64)

    def stop_after_five(k, res, nres, max_res, f1):
        return k >= 4

    kw = dict(tau0=TAU0, tol=1e-12, max_iters=50, stop_fn=stop_after_five,
              record_iterates=True, record_objective=True)
    r_t, r_j = pt.solve(**kw), pj.solve(**kw)
    assert r_t.iteration_count == r_j.iteration_count == 5
    assert r_t.converged and r_j.converged
    np.testing.assert_allclose(r_t.iterates, r_j.iterates, atol=1e-10)
    np.testing.assert_allclose(r_t.objectives, r_j.objectives, rtol=1e-10)

    b = pj.instance["b"].copy()
    b[2] = np.nan
    pn = problem_from_arrays(pj.instance["A"], b, 0.1, pj.instance["x0"],
                             TAU0, device="cpu", dtype=torch.float64)
    pjn = jax_problems.build("lasso", dtype=jnp.float64, **SMALL)
    pjn.fterm = ft.LeastSquares(jnp.asarray(b))
    pjn.tau0 = TAU0
    kw = dict(tol=1e-6, max_iters=30, guard_nonfinite=True)
    r_t, r_j = pn.solve(**kw), pjn.solve(**kw)
    assert r_t.nonfinite and r_j.nonfinite
    assert not r_t.converged and not r_j.converged
    assert r_t.iteration_count == r_j.iteration_count

    lean = pt.solve(tau0=TAU0, tol=1e-9, max_iters=200,
                    record_diagnostics=False)
    assert lean.residuals is None and lean.taus is None
    assert lean.iteration_count == pt.solve(tau0=TAU0, tol=1e-9,
                                            max_iters=200).iteration_count


def test_estimate_stepsize_points_parity():
    pj, pt = _pair(jnp.float64, torch.float64)
    rng = np.random.default_rng(11)
    pts = (rng.standard_normal(SMALL["n"]), rng.standard_normal(SMALL["n"]))
    tau_t, L_t = ftt.estimate_stepsize(pt.op, pt.fterm, pt.x0, points=pts)
    tau_j, L_j = ft.estimate_stepsize(pj.op, pj.fterm, pj.x0, None,
                                      points=pts)
    np.testing.assert_allclose(float(L_t), float(L_j), rtol=1e-12)
    np.testing.assert_allclose(float(tau_t), float(tau_j), rtol=1e-12)
    # auto-τ₀ runs from the same points follow the oracle's trajectory
    kw = dict(tol=1e-9, max_iters=200, est_points=pts)
    r_t = pt.solve(**{**kw, "tau0": None})
    r_np = _oracle(pj.instance, **kw)
    np.testing.assert_allclose(r_t.initial_tau, r_np.initial_tau, rtol=1e-12)
    np.testing.assert_allclose(r_t.L_estimate, r_np.L_estimate, rtol=1e-12)
    _assert_f64_parity(r_t, r_np)
    # drawn points come from an explicit generator, reproducibly
    g = torch.Generator().manual_seed(5)
    a = ftt.estimate_stepsize(pt.op, pt.fterm, pt.x0, g)[0]
    g = torch.Generator().manual_seed(5)
    assert float(a) == float(ftt.estimate_stepsize(pt.op, pt.fterm, pt.x0,
                                                   g)[0])
    with pytest.raises(ValueError, match="Generator"):
        ftt.estimate_stepsize(pt.op, pt.fterm, pt.x0)


def test_unported_modes_raise():
    """The three modes run; every example problem is ported, so only a
    name that is none raises (the builder's registry, the converter's
    list)."""
    pt = problems.build("lasso", device="cpu", **SMALL)
    for mode in (dict(adaptive=False), dict(accelerate=True)):
        r = pt.solve(tau0=TAU0, max_iters=5, **mode)
        assert r.iteration_count == 5
    with pytest.raises(KeyError, match="no problem named"):
        problems.build("phase_retrieval_cdpx", device="cpu")
    with pytest.raises(ValueError, match="names no example problem"):
        problem_from_instance({"name": "mmvx"}, device="cpu",
                              dtype=torch.float32)


def test_convert_round_trip():
    pj = jax_problems.build("lasso", dtype=jnp.float64, **SMALL)
    pt = problem_from_instance(pj.instance, device="cpu",
                               dtype=torch.float64)
    np.testing.assert_array_equal(pt.op.A.numpy(), np.asarray(pj.op.A))
    np.testing.assert_array_equal(pt.fterm.b.numpy(), np.asarray(pj.fterm.b))
    np.testing.assert_array_equal(pt.x0.numpy(), np.asarray(pj.x0))
    assert pt.gterm.mu == pj.gterm.mu and pt.instance is pj.instance
    p2 = problem_from_arrays(np.asarray(pj.op.A), np.asarray(pj.fterm.b),
                             pj.gterm.mu, np.asarray(pj.x0), TAU0,
                             device="cpu", dtype=torch.float32)
    assert p2.op.A.dtype == torch.float32 and p2.tau0 == TAU0

    r = pt.solve(tau0=TAU0, tol=1e-6, max_iters=100)
    d = result_to_numpy(r)
    assert d["iteration_count"] == r.iteration_count
    np.testing.assert_array_equal(d["taus"], r.taus)
    dev = result_to_numpy(pt.solve_device(
        ftt.FastaOptions(tol=1e-6, max_iters=100), tau0=TAU0))
    assert isinstance(dev["solution"], np.ndarray)
    np.testing.assert_array_equal(dev["solution"], r.solution)
    mr = result_to_numpy(p2.microsolve(tol=1e-6, max_iters=100))
    assert isinstance(mr["solution"], np.ndarray) and mr["status"] == \
        "converged"


def _run(code_or_args, **kw):
    env = {k: v for k, v in os.environ.items()}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, *code_or_args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_port_imports_no_jax():
    """Every module of the port imports with jax blocked: an import of
    jax would raise."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['jaxlib'] = None; sys.modules['fasta_tpu'] = None; "
            "import fasta_tpu_torch, fasta_tpu_torch.kernels, "
            "fasta_tpu_torch.convert, fasta_tpu_torch.micro; "
            "from fasta_tpu_torch.problems import lasso, nnls, logistic, svm, "
            "tv; "
            "bad = [m for m in sys.modules if sys.modules[m] is not None and "
            "(m == 'jax' or m.startswith(('jax.', 'jaxlib', 'fasta_tpu.')) "
            "or m == 'fasta_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_fails_without_a_gpu():
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
