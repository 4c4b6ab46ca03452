"""Kernels K-B1 (all 12 loss × prox pairs, adaptive and FISTA, the
objective, iterate and normalized-residual recordings) and K-B1p (the
path, warm and cold) through their plain versions, held against the JAX
whole-solve kernels in interpret mode; the dense dispatch; and the slice
end to end — ``problems.build`` → ``Problem.solve`` and
``Problem.microsolve`` — against ``fasta_tpu`` and the float64 oracle
(CPU).

Tolerances follow tests/test_torch_microsolver.py: equal iteration
count, status and backtracks; residuals rtol 1e-3 / atol 1e-6 (the
normalized residuals, a residual over its normalizer, the same); x atol
1e-5 of the solution's scale; f-values, objectives and iterates rtol
1e-4.  Runs that stop at a fixed count hold every series; runs to a
tolerance end at the float32 noise floor, where the order of float32 sums
moves the last residuals and, on flat optima, the solution within the
stopping tolerance, so they hold counts, status, backtracks and the
objective (the float64 objective of the solution to 1e-5, the recorded
series to rtol 1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fasta_tpu_torch as ftt
import problems as jax_problems
from fasta_tpu.kernels.microsolver import microsolve_lasso as jax_micro
from fasta_tpu.kernels.microsolver import \
    microsolve_lasso_path as jax_micro_path
from fasta_tpu_torch import problems
from fasta_tpu_torch.kernels import microsolver
from fasta_tpu_torch.kernels.microsolver import (LOSSES, PROXES,
                                                 microsolve_lasso,
                                                 microsolve_lasso_path)
from reference_oracle.fasta_numpy import fasta as fasta_np
from reference_oracle.generators import (make_lasso, make_logistic,
                                         make_nnls, make_svm)

torch.set_num_threads(1)

# loss -> (instance, tau0, weight μ of the l1 / ridge prox)
_INSTANCES = {
    "lstsq": (lambda: make_nnls(m=96, n=48, seed=2), 0.08, 0.05),
    "logistic": (lambda: make_logistic(m=96, n=32, k=5, seed=3), 1.0, 0.02),
    "squared_hinge": (lambda: make_svm(m=96, n=24, seed=11), 0.3, 0.2),
}
PAIRS = [(loss, prox) for loss in LOSSES for prox in PROXES]
RECORD = dict(record_fvals=True, record_bts=True, record_objs=True,
              record_nres=True, record_its=True)


@pytest.fixture(scope="module")
def data():
    out = {}
    for loss, (make, tau0, mu) in _INSTANCES.items():
        inst = make()
        out[loss] = ({k: inst[k].astype(np.float32) for k in ("A", "b", "x0")},
                     tau0, mu)
    return out


def _both(data, loss, prox, **kw):
    d, tau0, mu = data[loss]
    out_j = jax_micro(jnp.asarray(d["A"]), jnp.asarray(d["b"]),
                      jnp.asarray(d["x0"]), tau0, mu, interpret=True,
                      loss=loss, prox=prox, **RECORD, **kw)
    out_t = microsolve_lasso(torch.from_numpy(d["A"]),
                             torch.from_numpy(d["b"]),
                             torch.from_numpy(d["x0"]), tau0, mu, loss=loss,
                             prox=prox, **RECORD, **kw)
    names = ("x", "taus", "residuals", "k", "halt", "fvals", "backtracks",
             "objectives", "iterates", "norm_residuals")
    return dict(zip(names, map(np.asarray, out_j))), out_t


def _objective(data, loss, prox, x):
    """The float64 objective f(Ax) + g(x) at a float32 solution."""
    d, _, mu = data[loss]
    x = np.asarray(x, np.float64)
    z = d["A"].astype(np.float64) @ x
    b = d["b"].astype(np.float64)
    if loss == "lstsq":
        f = 0.5 * np.sum((z - b) ** 2)
    elif loss == "logistic":
        f = np.sum(np.maximum(z, 0) + np.log1p(np.exp(-np.abs(z))) - b * z)
    else:
        f = 0.5 * np.sum(np.maximum(0.0, 1.0 - b * z) ** 2)
    return f + {"l1": mu * np.abs(x).sum(), "ridge": 0.5 * mu * x @ x}.get(
        prox, 0.0)


def _assert_same_run(j, t, series=True, nres=True):
    k = int(t.iteration_count)
    assert k == int(j["k"])
    assert int(t.halt) == int(j["halt"])
    np.testing.assert_array_equal(t.backtracks[:k].numpy(),
                                  j["backtracks"][:k].astype(np.int32))
    if series:
        np.testing.assert_allclose(
            t.x.numpy(), j["x"], atol=1e-5 * max(1.0, np.abs(j["x"]).max()))
        np.testing.assert_allclose(t.residuals[:k].numpy(),
                                   j["residuals"][:k], rtol=1e-3, atol=1e-6)
        if nres:
            np.testing.assert_allclose(t.norm_residuals[:k].numpy(),
                                       j["norm_residuals"][:k], rtol=1e-3,
                                       atol=1e-6)
        np.testing.assert_allclose(t.fvals[:k].numpy(), j["fvals"][:k],
                                   rtol=1e-4)
        np.testing.assert_allclose(t.objectives[:k].numpy(),
                                   j["objectives"][:k], rtol=1e-4)
        np.testing.assert_allclose(t.iterates[:k].numpy(),
                                   j["iterates"][:k], rtol=1e-4, atol=1e-5)
    # entries after the last iteration stay zero, as in the JAX kernel
    assert not t.taus[k:].any() and not t.iterates[k:].any()


@pytest.mark.parametrize("loss,prox", PAIRS)
def test_pair_prefix_matches_jax_kernel(data, loss, prox):
    """Adaptive, hp off, 12 iterations: every recorded series."""
    j, t = _both(data, loss, prox, max_iters=12, stop_rule="iterations")
    _assert_same_run(j, t)


@pytest.mark.parametrize("loss,prox", PAIRS)
def test_pair_converges_like_jax_kernel(data, loss, prox):
    """Adaptive, hp off, to tol 1e-5 (hybrid rule)."""
    j, t = _both(data, loss, prox, max_iters=200, tol=1e-5)
    assert t.status == "converged"
    _assert_same_run(j, t, series=False)
    f_j = _objective(data, loss, prox, j["x"])
    f_t = _objective(data, loss, prox, t.x.numpy())
    assert abs(f_t - f_j) <= 1e-5 * abs(f_j)
    k = int(t.iteration_count)
    np.testing.assert_allclose(t.objectives[:k].numpy(),
                               j["objectives"][:k], rtol=1e-4)


# one pair per prox, each loss at least once
FISTA_PAIRS = [("logistic", "l1"), ("lstsq", "nonneg"),
               ("squared_hinge", "box"), ("squared_hinge", "ridge")]


@pytest.mark.parametrize("loss,prox", FISTA_PAIRS)
@pytest.mark.parametrize("hp", [False, True])
def test_fista_matches_jax_kernel(data, loss, prox, hp):
    """FISTA with restart.  hp off: 40 iterations, every series; hp on
    with the float64 restart dot: to tol 1e-5, every series but the
    normalized residuals, whose normalizer takes the float32 noise of the
    last iterations."""
    if hp:
        j, t = _both(data, loss, prox, max_iters=200, tol=1e-5,
                     accelerate=True, hp=True, restart_dd=True)
        assert t.status == "converged"
    else:
        j, t = _both(data, loss, prox, max_iters=40, stop_rule="iterations",
                     accelerate=True)
    _assert_same_run(j, t, nres=not hp)


def test_fista_without_restart_and_max_iters_solution(data):
    """restart=False keeps the momentum; at max_iters FISTA returns the
    extrapolated point, on a converged stop the prox point."""
    j, t = _both(data, "lstsq", "l1", max_iters=15, stop_rule="iterations",
                 accelerate=True, restart=False)
    _assert_same_run(j, t)
    k = int(t.iteration_count)
    assert not torch.equal(t.x, t.iterates[k - 1])
    _, c = _both(data, "lstsq", "l1", max_iters=200, tol=1e-4,
                 accelerate=True)
    assert c.status == "converged"
    assert torch.equal(c.x, c.iterates[int(c.iteration_count) - 1])


# --------------------------------------------------------------------------
# K-B1p: the path
# --------------------------------------------------------------------------

MUS = [0.3, 0.1, 0.03]          # strongest first
PATH_KW = dict(max_iters=200, tol=1e-6, stop_rule="residual",
               record_fvals=True, record_bts=True)


@pytest.fixture(scope="module")
def lasso():
    inst = make_lasso(m=64, n=128, k=8, seed=1)
    return [torch.from_numpy(inst[k].astype(np.float32))
            for k in ("A", "b", "x0")]


@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("accelerate", [False, True])
def test_path_matches_jax_path_kernel(lasso, warm, accelerate):
    """hp on, tol 1e-5.  Every point of a cold path and of a warm FISTA
    path (which carries x only) holds the full check.  A warm adaptive
    path carries the previous point's last accepted BB stepsize, which
    the float32 noise floor of that point sets, so its later points hold
    status, solution and iteration count within 2."""
    A, b, x0 = lasso
    kw = dict(PATH_KW, tol=1e-5, hp=True, accelerate=accelerate)
    t = microsolve_lasso_path(A, b, x0, 0.05, MUS, warm=warm, **kw)
    args = [jnp.asarray(v.numpy()) for v in lasso]
    if warm:
        j = jax_micro_path(*args, 0.05, jnp.asarray(MUS, jnp.float32),
                           interpret=True, **kw)
    else:
        # the JAX cold sweep is per-μ microsolve_lasso (vmapped)
        runs = [jax_micro(*args, 0.05, mu, interpret=True, **kw)
                for mu in MUS]
        j = [np.stack([np.asarray(r[i]) for r in runs]) for i in range(7)]
    np.testing.assert_array_equal(t.halt.numpy(), np.asarray(j[4]))
    assert (t.halt == 1).all()
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j[0]), atol=1e-5)
    ks, kj = t.iteration_count.numpy(), np.asarray(j[3])
    carried = warm and not accelerate
    for i, k in enumerate(ks):
        if carried and i > 0:
            assert abs(int(k) - int(kj[i])) <= 2
            continue
        assert k == kj[i]
        np.testing.assert_array_equal(t.backtracks[i, :k].numpy(),
                                      np.asarray(j[6])[i, :k])
        # the first f-values, before BB steps amplify the order of sums
        np.testing.assert_allclose(t.fvals[i, :10].numpy(),
                                   np.asarray(j[5])[i, :10], rtol=1e-4)


def test_path_points_bitmatch_separate_solves(lasso):
    """Cold: every point is a separate microsolve_lasso call; warm: the
    first point is (it has no predecessor)."""
    A, b, x0 = lasso
    cold = microsolve_lasso_path(A, b, x0, 0.05, MUS, warm=False, **PATH_KW)
    warm = microsolve_lasso_path(A, b, x0, 0.05, MUS, warm=True, **PATH_KW)
    for i, mu in enumerate(MUS):
        one = microsolve_lasso(A, b, x0, 0.05, mu, **PATH_KW)
        assert torch.equal(cold.x[i], one.x)
        assert torch.equal(cold.taus[i], one.taus)
        assert int(cold.iteration_count[i]) == int(one.iteration_count)
        if i == 0:
            assert torch.equal(warm.x[0], one.x)
            assert torch.equal(warm.taus[0], one.taus)
    # the continuation win: fewer total iterations warm than cold
    assert warm.iteration_count.sum() < cold.iteration_count.sum()


def test_warm_path_matches_solve_path_objectives(lasso):
    A, b, x0 = lasso
    warm = microsolve_lasso_path(A, b, x0, 0.05, MUS, warm=True, **PATH_KW)
    pr = ftt.solve_path(ftt.DenseOp(A), ftt.LeastSquares(b),
                        ftt.L1Norm(torch.tensor(MUS)), x0, 0.05,
                        ftt.FastaOptions(max_iters=200, tol=1e-6,
                                         stop_rule="residual",
                                         precision="standard"))
    for i, mu in enumerate(MUS):
        def obj(x):
            return float(0.5 * torch.sum((A @ x - b) ** 2)
                         + mu * torch.sum(torch.abs(x)))
        fw, fp = obj(warm.x[i]), obj(pr.solution[i])
        assert abs(fw - fp) <= 1e-4 * (1.0 + abs(fp)), (i, fw, fp)


def test_nonfinite_point_leaves_the_next_point_cold(lasso):
    """A nonfinite abort at point 1 sends point 2 back to the cold x₀.
    The stepsize it starts from is point 1's own start τ, as in the JAX
    kernel's code (microsolver.py:704-709; its docstring says the
    caller's τ₀, ROADMAP C-ref-4)."""
    A, b, x0 = lasso
    mus = [0.3, float("nan"), 0.03]
    t = microsolve_lasso_path(A, b, x0, 0.05, mus, warm=True, **PATH_KW)
    j = jax_micro_path(*[jnp.asarray(v.numpy()) for v in lasso], 0.05,
                       jnp.asarray(mus, jnp.float32), interpret=True,
                       **PATH_KW)
    assert [microsolver.STATUS_NAMES[int(h)] for h in t.halt] == \
        ["converged", "nonfinite", "converged"]
    np.testing.assert_array_equal(t.halt.numpy(), np.asarray(j[4]))
    tau1 = float(t.taus[1, 0])            # no backtrack: NaN compares False
    assert int(t.backtracks[1, 0]) == 0
    cold_x = microsolve_lasso(A, b, x0, tau1, 0.03, **PATH_KW)
    assert torch.equal(t.x[2], cold_x.x)
    assert torch.equal(t.taus[2], cold_x.taus)


# --------------------------------------------------------------------------
# The dispatch
# --------------------------------------------------------------------------

class _Stencil(ftt.LinearOp):
    """A matrix-free operator, as the TV-dual problem has."""

    def __call__(self, x):
        return x

    def rmatvec(self, y):
        return y


def test_dispatch_reasons_for_every_structure():
    z = torch.zeros(6)
    op = ftt.DenseOp(torch.zeros((6, 4)))
    x0 = torch.zeros(4)
    for f in (ftt.LeastSquares(z), ftt.Logistic(z), ftt.SquaredHinge(z)):
        for g in (ftt.L1Norm(0.1), ftt.NonnegIndicator(), ftt.BoxIndicator(),
                  ftt.L2Norm2(0.1)):
            ok, kind = ftt.microsolve_supported(ftt.Problem("p", op, f, g,
                                                            x0))
            assert ok and kind == "dense"
    cases = [
        (ftt.Problem("box2", op, ftt.LeastSquares(z), ftt.BoxIndicator(0, 2),
                     x0), "BoxIndicator(-1,1)"),
        (ftt.Problem("fn", op, ftt.LeastSquares(z),
                     ftt.as_prox_term(None, None), x0), "L1Norm"),
        (ftt.Problem("mus", op, ftt.LeastSquares(z),
                     ftt.L1Norm(torch.tensor([0.1, 0.2])), x0),
         "microsolve_sweep"),
        (ftt.Problem("lams", op, ftt.SquaredHinge(z),
                     ftt.L2Norm2(torch.tensor([0.1, 0.2])), x0),
         "microsolve_sweep"),
        (ftt.Problem("b2", op, ftt.Logistic(torch.zeros(6, 2)),
                     ftt.L1Norm(0.1), x0), "vector"),
        (ftt.Problem("smooth", op, ftt.as_smooth_term(lambda d: d.sum()),
                     ftt.L1Norm(0.1), x0), "least-squares, logistic"),
        (ftt.Problem("tv", _Stencil(), ftt.LeastSquares(z),
                     ftt.BoxIndicator(), x0), "the TV dual"),
    ]
    for prob, why in cases:
        ok, reason = ftt.microsolve_supported(prob)
        assert not ok and why in reason, (prob.name, reason)
        with pytest.raises(ValueError, match="microsolve"):
            prob.microsolve()
    with pytest.raises(ValueError, match="item 10"):
        cases[-1][0].microsolve_sweep([0.1, 0.2])


def test_sweep_rejects_the_projection_proxes():
    for g in (ftt.NonnegIndicator(), ftt.BoxIndicator()):
        p = problems.build("nnls", m=30, n=10, device="cpu")
        p.gterm = g
        with pytest.raises(ValueError, match="projection"):
            p.microsolve_sweep([0.1, 0.2], tau0=0.08)
    with pytest.raises(ValueError, match="1-D"):
        problems.build("lasso", m=30, n=60, k=3, device="cpu") \
            .microsolve_sweep([[0.1]], tau0=0.05)


def test_microsolve_sweep_results(lasso):
    """The public sweep: cold points equal separate Problem.microsolve
    calls field by field; warm runs fewer iterations; best indices follow
    the recorded objectives."""
    A, b, x0 = lasso
    p = ftt.Problem("lasso", ftt.DenseOp(A), ftt.LeastSquares(b),
                    ftt.L1Norm(0.1), x0, tau0=0.05)
    kw = dict(max_iters=200, tol=1e-6, stop_rule="residual",
              record_objs=True, record_nres=True)
    cold = p.microsolve_sweep(MUS, **kw)
    warm = p.microsolve_sweep(MUS, warm_start=True, **kw)
    assert cold.converged.all() and warm.converged.all()
    assert list(cold.statuses) == ["converged"] * 3
    assert warm.iteration_counts.sum() < cold.iteration_counts.sum()
    for i, mu in enumerate(MUS):
        p.gterm = ftt.L1Norm(mu)
        one = p.microsolve(**kw)
        assert torch.equal(cold.solutions[i], one.solution)
        np.testing.assert_array_equal(cold.residuals[i], one.residuals)
        np.testing.assert_array_equal(cold.objectives[i], one.objectives)
        np.testing.assert_array_equal(cold.backtracks[i], one.backtracks)
        assert cold.best_indices[i] == one.best_index == int(
            np.nanargmin(one.objectives))
        assert cold.total_backtracks[i] == one.total_backtracks


# --------------------------------------------------------------------------
# The slice end to end
# --------------------------------------------------------------------------

SLICE = {
    "nnls": (dict(m=120, n=60), 0.08),
    "logistic": (dict(m=150, n=80), 1.0),
    "svm": (dict(m=120, n=30), 0.3),
}


def _oracle(inst, **kw):
    return fasta_np(inst["op"], None, inst["f"], inst["gradf"], inst["g"],
                    inst["proxg"], inst["x0"], record_objective=True, **kw)


def _obj64(inst, x):
    x = np.asarray(x, np.float64)
    return float(inst["f"](inst["A"] @ x)) + float(inst["g"](x))


@pytest.mark.parametrize("name", list(SLICE))
def test_slice_end_to_end(name):
    kw, tau0 = SLICE[name]
    inst = jax_problems.build(name, dtype=jnp.float64, **kw).instance
    ref = _oracle(inst, tau0=tau0, tol=1e-10, max_iters=3000).objectives[-1]
    # the loop, float64, three modes; plain mode at a fixed τ converges
    # slowly, so it is held to the oracle's and fasta_tpu's run of the
    # same length (test_parity.py's objective check)
    p64 = problems.build(name, device="cpu", dtype=torch.float64, **kw)
    pj64 = jax_problems.build(name, dtype=jnp.float64, **kw)
    for mode in (dict(adaptive=False), dict(), dict(accelerate=True)):
        skw = dict(tau0=tau0, tol=1e-8, max_iters=3000, **mode)
        r = p64.solve(record_objective=True, **skw)
        rj = pj64.solve(record_objective=True, **skw)
        goal = ref
        if mode.get("adaptive") is False:
            goal = _oracle(inst, **skw).objectives[-1]
        else:
            assert r.converged and rj.converged, mode
        assert abs(r.objectives[-1] - goal) <= 1e-5 * abs(goal), mode
        assert abs(r.objectives[-1] - rj.objectives[-1]) <= 1e-5 * abs(goal)
    # the kernels' plain versions, float32
    p32 = problems.build(name, device="cpu", **kw)
    p32.tau0 = tau0
    pj32 = jax_problems.build(name, dtype=jnp.float32, **kw)
    for accelerate in (False, True):
        m = p32.microsolve(tol=1e-6, max_iters=3000, accelerate=accelerate,
                           hp=True, restart_dd=True)
        mj = pj32.microsolve(tau0=tau0, tol=1e-6, max_iters=3000,
                             accelerate=accelerate, hp=True,
                             restart_dd=True)
        assert m.status == mj.status == "converged"
        f_t, f_j = _obj64(inst, m.solution), _obj64(inst, mj.solution)
        assert abs(f_t - ref) <= 1e-4 * abs(ref)
        assert abs(f_t - f_j) <= 1e-4 * abs(ref)
