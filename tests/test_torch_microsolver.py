"""The plain version of kernel K-B1 (``microsolve_lasso_reference``, which
the CPU path of ``microsolve_lasso`` runs) held against the JAX
whole-solve kernel in interpret mode, plus the microsolve dispatch and
the three reference faults the port does not inherit (CPU).

Tolerances follow tests/unit/test_microsolver.py: equal iteration count
and status, residuals rtol 1e-3 / atol 1e-6, solution atol 1e-5; with hp
the early taus agree to rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fasta_tpu_torch as ftt
from fasta_tpu.kernels.microsolver import microsolve_lasso as jax_microsolve
from fasta_tpu_torch import problems
from fasta_tpu_torch.convert import problem_from_arrays
from fasta_tpu_torch.kernels import microsolver
from fasta_tpu_torch.kernels.microsolver import (MicrosolveOutput,
                                                 microsolve_lasso,
                                                 microsolve_lasso_reference)
from reference_oracle.generators import make_lasso

torch.set_num_threads(1)

M, N, TAU0 = 200, 400, 0.05


@pytest.fixture(scope="module")
def lasso32():
    inst = make_lasso(m=M, n=N, k=20, seed=1)
    return {k: inst[k].astype(np.float32) for k in ("A", "b", "x0")} | {
        "mu": inst["mu"]}


def _both(data, b=None, **kw):
    b = data["b"] if b is None else b
    out_j = jax_microsolve(jnp.asarray(data["A"]), jnp.asarray(b),
                           jnp.asarray(data["x0"]), TAU0, data["mu"],
                           interpret=True, **kw)
    out_t = microsolve_lasso(torch.from_numpy(data["A"]), torch.from_numpy(b),
                             torch.from_numpy(data["x0"]), TAU0, data["mu"],
                             **kw)
    return out_j, out_t


@pytest.mark.parametrize("hp", [False, True])
@pytest.mark.parametrize("stop_rule,max_iters", [
    ("hybrid_residual", 150), ("residual", 150),
    # fixed-count runs stop before the float32 noise floor, where
    # ulp-level differences of sum order decide the steps
    ("iterations", 20)])
def test_plain_kernel_matches_jax_kernel(lasso32, hp, stop_rule, max_iters):
    out_j, out_t = _both(lasso32, max_iters=max_iters, tol=1e-6, hp=hp,
                         stop_rule=stop_rule, record_fvals=True,
                         record_bts=True)
    x_j, taus_j, res_j, k_j, halt_j, fv_j, bt_j = out_j
    k = int(out_t.iteration_count)
    assert k == int(k_j)
    assert int(out_t.halt) == int(halt_j)
    np.testing.assert_allclose(out_t.residuals[:k].numpy(),
                               np.asarray(res_j[:k]), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(out_t.x.numpy(), np.asarray(x_j), atol=1e-5)
    np.testing.assert_array_equal(out_t.backtracks[:k].numpy(),
                                  np.asarray(bt_j[:k]).astype(np.int32))
    np.testing.assert_allclose(out_t.fvals[:k].numpy(), np.asarray(fv_j[:k]),
                               rtol=1e-4)
    if hp:
        kk = min(k, 15)
        np.testing.assert_allclose(out_t.taus[:kk].numpy(),
                                   np.asarray(taus_j[:kk]), rtol=1e-4)
    # entries after the last iteration stay zero, as in the JAX kernel
    assert not out_t.taus[k:].any() and not out_t.residuals[k:].any()


@pytest.mark.parametrize("hp", [False, True])
def test_nonfinite_measurement_halts_as_nonfinite(lasso32, hp):
    b = lasso32["b"].copy()
    b[3] = np.nan
    out_j, out_t = _both(lasso32, b=b, max_iters=50, tol=1e-6, hp=hp)
    assert int(out_j[4]) == 2
    assert out_t.status == "nonfinite"
    assert int(out_t.iteration_count) == int(out_j[3])


def test_cpu_path_is_the_plain_version_and_counts_no_launch(lasso32):
    args = (torch.from_numpy(lasso32["A"]), torch.from_numpy(lasso32["b"]),
            torch.from_numpy(lasso32["x0"]), TAU0, lasso32["mu"])
    before = microsolver.LAUNCHES
    a = microsolve_lasso(*args, max_iters=30, tol=1e-6, hp=True)
    b = microsolve_lasso_reference(*args, max_iters=30, tol=1e-6, hp=True)
    assert microsolver.LAUNCHES == before
    for x, y in zip(a[:5], b[:5]):
        assert torch.equal(x, y)


def test_cref3_raw_wrapper_returns_a_named_tuple(lasso32):
    """C-ref-3: the JAX wrapper returns a positional tuple whose optional
    tail depends on the record_* flags; the port's is a NamedTuple."""
    out = microsolve_lasso(torch.from_numpy(lasso32["A"]),
                           torch.from_numpy(lasso32["b"]),
                           torch.from_numpy(lasso32["x0"]), TAU0,
                           lasso32["mu"], max_iters=40, tol=1e-6,
                           record_bts=True)
    assert isinstance(out, MicrosolveOutput)
    assert out._fields == ("x", "taus", "residuals", "iteration_count",
                           "halt", "fvals", "backtracks", "objectives",
                           "iterates", "norm_residuals")
    assert out.fvals is None and out.backtracks is not None
    assert out.objectives is None and out.iterates is None
    assert out.norm_residuals is None
    assert out.iteration_count.dtype == torch.int32


def _prob(data, b=None, tau0=TAU0):
    return problem_from_arrays(data["A"], data["b"] if b is None else b,
                               data["mu"], data["x0"], tau0, device="cpu",
                               dtype=torch.float32)


def test_cref2_status_is_a_string_never_a_truthy_int(lasso32):
    """C-ref-2: the JAX kernels' int32 status was called truthiness-
    compatible with the old bool, but the nonfinite code 2 is truthy."""
    ok = _prob(lasso32).microsolve(max_iters=150, tol=1e-6)
    assert ok.status == "converged" and ok.converged is True
    b = lasso32["b"].copy()
    b[0] = np.inf
    bad = _prob(lasso32, b=b).microsolve(max_iters=150, tol=1e-6)
    for r in (ok, bad):
        assert isinstance(r.status, str) and not isinstance(r.status, int)
        assert r.status in ("max_iters", "converged", "nonfinite")
    assert bad.status == "nonfinite" and bad.converged is False
    short = _prob(lasso32).microsolve(max_iters=3, tol=1e-6)
    assert short.status == "max_iters" and short.converged is False


def test_cref1_best_index_ignores_nan_and_is_none_after_abort(lasso32):
    """C-ref-1: the JAX micro.py takes np.argmin over a residual series
    that can hold NaN (micro.py:320), so after a nonfinite abort its
    best_index can point at the poisoned iterate.  The port uses
    nanargmin and reports None after a nonfinite abort."""
    r = _prob(lasso32).microsolve(max_iters=150, tol=1e-6)
    assert r.best_index == int(np.nanargmin(r.residuals))
    b = lasso32["b"].copy()
    b[5] = np.nan
    bad = _prob(lasso32, b=b).microsolve(max_iters=150, tol=1e-6)
    assert bad.status == "nonfinite" and np.isnan(bad.residuals).any()
    assert bad.best_index is None


def test_microsolve_matches_jax_problem_microsolve(lasso32):
    """The dispatch end to end: port Problem.microsolve against
    fasta_tpu's Problem.microsolve (interpret mode off-TPU) on the same
    instance and options."""
    import problems as jax_problems
    pj = jax_problems.build("lasso", m=M, n=N, k=20, dtype=jnp.float32)
    pt = problems.build("lasso", m=M, n=N, k=20, device="cpu")
    kw = dict(tau0=TAU0, max_iters=150, tol=1e-6, record_fvals=True)
    rj, rt = pj.microsolve(**kw), pt.microsolve(**kw)
    assert rt.iteration_count == rj.iteration_count
    assert rt.status == rj.status == "converged"
    k = rt.iteration_count
    np.testing.assert_allclose(rt.residuals, rj.residuals[:k], rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_allclose(rt.solution.numpy(), np.asarray(rj.solution),
                               atol=1e-5)
    np.testing.assert_array_equal(rt.backtracks, rj.backtracks)
    assert rt.total_backtracks == rj.total_backtracks


def test_microsolve_estimates_tau0_from_an_explicit_generator(lasso32):
    p = _prob(lasso32, tau0=None)
    a = p.microsolve(max_iters=150, tol=1e-6,
                     generator=torch.Generator().manual_seed(4))
    b = p.microsolve(max_iters=150, tol=1e-6,
                     generator=torch.Generator().manual_seed(4))
    assert a.status == "converged"
    np.testing.assert_array_equal(a.taus, b.taus)


def test_unported_options_raise(lasso32):
    """What the CUDA kernel has no counterpart for raises: the TPU
    engine and interpreter switches, unknown losses, proxes and stop
    rules, out-of-range windows and non-float32 data."""
    p = _prob(lasso32)
    with pytest.raises(ValueError, match="engine"):
        p.microsolve(engine="vpu")
    with pytest.raises(ValueError, match="interpret"):
        p.microsolve(interpret=True)
    A, b, x0 = (torch.from_numpy(lasso32[k]) for k in ("A", "b", "x0"))
    for kw, what in ((dict(loss="huber"), "loss"), (dict(prox="l2"), "prox"),
                     (dict(stop_rule="bogus"), "stop_rule"),
                     (dict(window=129), "window")):
        with pytest.raises(ValueError, match=what):
            microsolve_lasso(A, b, x0, TAU0, 0.1, **kw)
    with pytest.raises(TypeError, match="unknown option"):
        microsolve_lasso(A, b, x0, TAU0, 0.1, engine="vpu")
    with pytest.raises(ValueError, match="float32"):
        microsolve_lasso(A.double(), b, x0, TAU0, 0.1)


def test_dispatch_reasons(lasso32):
    ok, kind = ftt.microsolve_supported(_prob(lasso32))
    assert ok and kind == "dense"
    # the reference's 24 MB residency gate (a stride-0 view holds no data)
    big = ftt.Problem("big", ftt.DenseOp(torch.zeros(1).expand(3000, 3000)),
                      ftt.LeastSquares(torch.zeros(3000)), ftt.L1Norm(0.1),
                      torch.zeros(3000))
    ok, why = ftt.microsolve_supported(big)
    assert not ok and "24 MB" in why
    other = ftt.Problem("fn", ftt.DenseOp(torch.zeros(4, 3)),
                        ftt.LeastSquares(torch.zeros(4)),
                        ftt.as_prox_term(None, None), torch.zeros(3))
    ok, why = ftt.microsolve_supported(other)
    assert not ok and "L1Norm" in why
    with pytest.raises(ValueError, match="microsolve"):
        other.microsolve()
