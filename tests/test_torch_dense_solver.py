"""The PyTorch loop in its three modes — plain, adaptive and FISTA with
restart — on the four dense problems, and the warm regularization path
``solve_path``, held against the float64 oracle and ``fasta_tpu`` (CPU).

Sizes, τ₀, stopping settings and bands are tests/parity/test_parity.py's:
the first 10 taus rtol 1e-7, residuals rtol 1e-6 / atol 1e-12 and fvals
rtol 1e-7 / atol 1e-12; the final objective within 1e-5 relative; equal
iteration counts on LASSO and NNLS, and within max(5, 20%) on the
knife-edge backtracking problems (logistic, SVM).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fasta_tpu as ft
import fasta_tpu_torch as ftt
import problems as jax_problems
from fasta_tpu.solver import solve_path as jax_solve_path
from fasta_tpu_torch.convert import problem_from_instance
from fasta_tpu_torch.harness import MODE_OPTIONS as MODES
from reference_oracle.fasta_numpy import fasta as fasta_np

torch.set_num_threads(1)

# name -> (builder kwargs, tau0, solver kwargs), as test_parity.py
CASES = {
    "lasso": (dict(m=150, n=300, k=15), 0.05, dict(tol=1e-9, max_iters=200)),
    "nnls": (dict(m=120, n=60), 0.08, dict(tol=1e-9, max_iters=200)),
    "logistic": (dict(m=150, n=80), 1.0, dict(tol=1e-8, max_iters=150)),
    "svm": (dict(m=120, n=30), 0.3, dict(tol=1e-8, max_iters=150)),
}


def _band(r_t, r_ref, name, what):
    k_strict = min(10, r_t.iteration_count, r_ref.iteration_count)
    np.testing.assert_allclose(r_t.taus[:k_strict], r_ref.taus[:k_strict],
                               rtol=1e-7, err_msg=f"{what}: taus")
    np.testing.assert_allclose(r_t.residuals[:k_strict],
                               r_ref.residuals[:k_strict], rtol=1e-6,
                               atol=1e-12, err_msg=f"{what}: residuals")
    np.testing.assert_allclose(r_t.fvals[:k_strict], r_ref.fvals[:k_strict],
                               rtol=1e-7, atol=1e-12, err_msg=f"{what}: f")
    scale = max(abs(r_ref.objectives[-1]), 1e-10)
    assert abs(r_t.objectives[-1] - r_ref.objectives[-1]) / scale < 1e-5, \
        f"{what}: objective {r_t.objectives[-1]} vs {r_ref.objectives[-1]}"
    drift = abs(r_t.iteration_count - r_ref.iteration_count)
    limit = 0 if name in ("lasso", "nnls") else \
        max(5, int(0.2 * r_ref.iteration_count))
    assert drift <= limit, \
        f"{what}: iterations {r_t.iteration_count} vs {r_ref.iteration_count}"


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("mode", list(MODES))
def test_loop_modes_match_oracle_and_jax_f64(name, mode):
    kwargs, tau0, skw = CASES[name]
    pj = jax_problems.build(name, dtype=jnp.float64, **kwargs)
    pt = problem_from_instance(pj.instance, device="cpu",
                               dtype=torch.float64)
    inst = pj.instance
    kw = dict(tau0=tau0, record_objective=True, **skw, **MODES[mode])
    r_np = fasta_np(inst["op"], inst.get("op_t"), inst["f"], inst["gradf"],
                    inst["g"], inst["proxg"], inst["x0"], **kw)
    r_t = pt.solve(**kw)
    r_j = pj.solve(**kw)
    _band(r_t, r_np, name, f"{name}/{mode} vs oracle")
    _band(r_t, r_j, name, f"{name}/{mode} vs fasta_tpu")
    assert r_t.converged == r_j.converged


@pytest.mark.parametrize("mode", ["plain", "accelerated"])
def test_new_modes_keep_recordings_and_solution_semantics(mode):
    """Lean mode and the recordings in the two new modes, against
    fasta_tpu: lean runs take the same path; with record_iterates the
    iterates match; FISTA at max_iters returns the extrapolated point."""
    kwargs, tau0, _ = CASES["lasso"]
    pj = jax_problems.build("lasso", dtype=jnp.float64, **kwargs)
    pt = problem_from_instance(pj.instance, device="cpu",
                               dtype=torch.float64)
    kw = dict(tau0=tau0, tol=1e-12, max_iters=25, record_iterates=True,
              record_objective=True, **MODES[mode])
    r_t, r_j = pt.solve(**kw), pj.solve(**kw)
    assert r_t.iteration_count == r_j.iteration_count == 25
    assert not r_t.converged and not r_j.converged
    np.testing.assert_allclose(r_t.iterates, r_j.iterates, atol=1e-10)
    np.testing.assert_allclose(r_t.solution, r_j.solution, atol=1e-10)
    np.testing.assert_allclose(r_t.best_iterate, r_j.best_iterate,
                               atol=1e-10)
    np.testing.assert_allclose(r_t.fvals, r_j.fvals, rtol=1e-9)
    if mode == "accelerated":
        assert not np.allclose(r_t.solution, r_t.iterates[-1], atol=1e-12)
    lean = pt.solve(tau0=tau0, tol=1e-12, max_iters=25,
                    record_diagnostics=False, **MODES[mode])
    assert lean.taus is None
    np.testing.assert_allclose(lean.solution, r_t.solution, atol=1e-12)


def test_accelerated_f32_uses_the_fused_affine_gradient():
    """FISTA in float32 on LASSO: the gradient at the extrapolated point
    is the affine combination of fused gradients (no adjoint matvec), and
    the run stays within the f32 band of the JAX package's."""
    pj = jax_problems.build("lasso", dtype=jnp.float32, m=150, n=300, k=15)
    pt = problem_from_instance(pj.instance, device="cpu",
                               dtype=torch.float32)
    calls = []

    class Counting(ftt.DenseOp):
        def rmatvec(self, y):
            calls.append(1)
            return super().rmatvec(y)

    pt.op = Counting(pt.op.A)
    kw = dict(tau0=0.05, tol=1e-6, max_iters=500, accelerate=True)
    r_t, r_j = pt.solve(**kw), pj.solve(**kw)
    assert r_t.converged and r_j.converged
    assert len(calls) == 1          # the initial gradient only
    assert (r_j.iteration_count / 1.25 <= r_t.iteration_count
            <= 1.25 * r_j.iteration_count + 10)
    np.testing.assert_allclose(r_t.solution, r_j.solution, atol=1e-4)


@pytest.mark.parametrize("mode", ["adaptive", "accelerated"])
def test_solve_path_matches_jax_solve_path(mode):
    """A 3-point LASSO μ path, strongest first, in float64: per-point
    iteration counts and objectives of fasta_tpu's solve_path."""
    pj = jax_problems.build("lasso", dtype=jnp.float64, m=120, n=240, k=10)
    pt = problem_from_instance(pj.instance, device="cpu",
                               dtype=torch.float64)
    mus = np.array([0.3, 0.1, 0.03])
    opts = dict(max_iters=400, tol=1e-8, stop_rule="residual",
                **MODES[mode])
    rj = jax_solve_path(pj.op, pj.fterm, ft.L1Norm(jnp.asarray(mus)),
                        jnp.asarray(pj.x0), 0.05, ft.FastaOptions(**opts))
    rt = ftt.solve_path(pt.op, pt.fterm, ftt.L1Norm(torch.tensor(mus)),
                        pt.x0, 0.05, ftt.FastaOptions(**opts))
    np.testing.assert_array_equal(rt.iteration_count,
                                  np.asarray(rj.iteration_count))
    assert rt.converged.all() and np.asarray(rj.converged).all()
    assert rt.solution.shape == (3, 240) and rt.taus.shape == (3, 400)
    A, b = pj.instance["A"], pj.instance["b"]
    for i, mu in enumerate(mus):
        def obj(x):
            x = np.asarray(x)
            return 0.5 * np.sum((A @ x - b) ** 2) + mu * np.abs(x).sum()
        np.testing.assert_allclose(obj(rt.solution[i].numpy()),
                                   obj(rj.solution[i]), rtol=1e-9)
    # the same path from a sequence of terms, and cold solves for scale
    seq = ftt.solve_path(pt.op, pt.fterm, [ftt.L1Norm(m) for m in mus],
                         pt.x0, 0.05, ftt.FastaOptions(**opts))
    np.testing.assert_array_equal(seq.iteration_count, rt.iteration_count)
    if mode == "adaptive":
        cold = sum(ftt.fasta(pt.op, None, pt.fterm, None, ftt.L1Norm(m),
                             None, pt.x0, tau0=0.05,
                             **opts).iteration_count for m in mus)
        assert rt.iteration_count.sum() < cold
    with pytest.raises(ValueError, match="record_diagnostics"):
        ftt.solve_path(pt.op, pt.fterm, ftt.L1Norm(torch.tensor(mus)),
                       pt.x0, 0.05, ftt.FastaOptions(record_diagnostics=False))
    with pytest.raises(ValueError, match="1-D weight"):
        ftt.solve_path(pt.op, pt.fterm, ftt.L1Norm(0.1), pt.x0, 0.05)
