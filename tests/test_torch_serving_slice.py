"""The serving slice end to end on the CPU: ``make_batch_solver`` (the loop
over a lane axis) against ``fasta_tpu.make_batch_solver`` in float64 and
against separate port solves, ``recommend_path``'s route for every case of
``tests/unit/test_serving.py`` against ``fasta_tpu.recommend_path`` (its
"xla" route is the port's "loop"), every ``ServingPlan.run`` route and
``Problem.solve_serving``, the reference fault C-ref-6, and the L1 trial
step through kernel K-B4's plain version against the composition.

Tolerances: the float64 batch as ``tests/unit/test_batch.py`` holds the
JAX batch against its single solves — equal counts, τ rtol 1e-6,
solutions atol 1e-8 (1e-10 for the right-hand sides); a port lane against
a separate port solve the same; float32 runs against ``fasta_tpu`` hold
the objective (rtol 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fasta_tpu as ft
import fasta_tpu_torch as ftt
import problems as jax_problems
from fasta_tpu_torch import problems, solver
from fasta_tpu_torch.prox import shrink

torch.set_num_threads(1)


def _pair(name, dtype=np.float32, **kw):
    jd = jnp.float64 if dtype == np.float64 else jnp.float32
    td = torch.float64 if dtype == np.float64 else torch.float32
    return (jax_problems.build(name, dtype=jd, **kw),
            problems.build(name, dtype=td, device="cpu", **kw))


# --------------------------------------------------------------------------
# make_batch_solver
# --------------------------------------------------------------------------

def _hold_lanes(out, singles, atol):
    for i, single in enumerate(singles):
        k = int(single.iteration_count)
        assert int(out.iteration_count[i]) == k
        np.testing.assert_allclose(np.asarray(out.taus[i])[:k],
                                   np.asarray(single.taus)[:k], rtol=1e-6)
        np.testing.assert_allclose(np.asarray(out.solution[i]),
                                   np.asarray(single.solution), atol=atol)


def test_mu_sweep_matches_jax_and_separate_solves():
    pj, pt = _pair("lasso", np.float64, m=64, n=96, k=8)
    opts_j = ft.FastaOptions(tol=1e-8, max_iters=100)
    opts_t = ftt.FastaOptions(tol=1e-8, max_iters=100)
    mus = np.array([0.02, 0.05, 0.1, 0.3])
    out_j = ft.make_batch_solver(
        opts_j, in_axes=(None, None, ft.L1Norm(0), None, None))(
        pj.op, pj.fterm, ft.L1Norm(jnp.asarray(mus)), jnp.asarray(pj.x0),
        0.05)
    out_t = ftt.make_batch_solver(opts_t, in_axes=(None, None, 0, None, None))(
        pt.op, pt.fterm, ftt.L1Norm(torch.from_numpy(mus)), pt.x0, 0.05)
    assert out_t.solution.shape == (4, 96)
    assert isinstance(out_t.iteration_count, np.ndarray)
    # against the JAX batch, lane by lane
    _hold_lanes(out_t, [type("R", (), dict(
        iteration_count=out_j.iteration_count[i], taus=out_j.taus[i],
        solution=out_j.solution[i])) for i in range(4)], atol=1e-8)
    # against separate port solves
    _hold_lanes(out_t, [ftt.solve(pt.op, pt.fterm, ftt.L1Norm(float(mu)),
                                  pt.x0, 0.05, opts_t) for mu in mus],
                atol=1e-8)
    assert out_t.converged.all() and not out_t.nonfinite.any()


def test_batched_rhs_matches_jax_and_separate_solves():
    pj, pt = _pair("nnls", np.float64, m=48, n=24)
    opts_j = ft.FastaOptions(tol=1e-8, max_iters=80)
    opts_t = ftt.FastaOptions(tol=1e-8, max_iters=80)
    B = np.random.default_rng(0).standard_normal((3, 48))
    out_j = ft.make_batch_solver(
        opts_j, in_axes=(None, ft.LeastSquares(0), None, None, None))(
        pj.op, ft.LeastSquares(jnp.asarray(B)), pj.gterm, jnp.asarray(pj.x0),
        0.08)
    out_t = ftt.make_batch_solver(opts_t, in_axes=(None, 0, None, None, None))(
        pt.op, ftt.LeastSquares(torch.from_numpy(B)), pt.gterm, pt.x0, 0.08)
    assert out_t.solution.shape == (3, 24)
    np.testing.assert_array_equal(out_t.iteration_count,
                                  np.asarray(out_j.iteration_count))
    np.testing.assert_allclose(out_t.solution.numpy(),
                               np.asarray(out_j.solution), atol=1e-10)
    _hold_lanes(out_t, [ftt.solve(pt.op, ftt.LeastSquares(torch.from_numpy(
        B[i])), pt.gterm, pt.x0, 0.08, opts_t) for i in range(3)],
        atol=1e-10)


def test_lanes_stop_apart_and_freeze():
    """Lanes of different lengths: a stopped lane keeps its solution and
    writes no record past its own count; a lane whose τ₀ is NaN aborts as
    nonfinite without touching the others."""
    pt = problems.build("lasso", m=64, n=96, k=8, dtype=torch.float64,
                        device="cpu")
    opts = ftt.FastaOptions(tol=1e-8, max_iters=150, record_objective=True,
                            guard_nonfinite=True)
    tau0 = torch.tensor([0.05, float("nan"), 0.01], dtype=torch.float64)
    out = ftt.make_batch_solver(opts, in_axes=(None, None, None, None, 0))(
        pt.op, pt.fterm, pt.gterm, pt.x0, tau0)
    assert out.nonfinite.tolist() == [False, True, False]
    assert out.converged.tolist() == [True, False, True]
    for i in (0, 2):
        single = ftt.solve(pt.op, pt.fterm, pt.gterm, pt.x0, float(tau0[i]),
                           opts)
        k = single.iteration_count
        assert out.iteration_count[i] == k
        np.testing.assert_allclose(out.solution[i], single.solution,
                                   atol=1e-10)
        np.testing.assert_allclose(out.objectives[i, :k], single.objectives[:k],
                                   rtol=1e-10)
        assert torch.all(out.residuals[i, k:] == 0)
        assert out.total_backtracks[i] == single.total_backtracks
    assert out.iteration_count[1] == 1


def test_float32_l1_lanes_match_separate_solves():
    """Float32 LASSO lanes take kernel K-B4 (its plain version here) over
    all lanes at once; each lane's objective matches a separate solve."""
    pt = problems.build("lasso", m=120, n=240, k=10, device="cpu")
    b = pt.fterm.b
    bs = torch.stack([b * (1.0 + 0.02 * i) for i in range(3)])
    opts = ftt.FastaOptions(tol=1e-6, max_iters=300)
    out = ftt.make_batch_solver(opts, in_axes=(None, 0, None, None, None))(
        pt.op, ftt.LeastSquares(bs), pt.gterm, pt.x0, 0.05)
    for i in range(3):
        single = ftt.solve(pt.op, ftt.LeastSquares(bs[i]), pt.gterm, pt.x0,
                           0.05, opts)
        f = [float(ftt.LeastSquares(bs[i].double()).value(
            pt.op.A.double() @ x.double()) + 0.1 * x.double().abs().sum())
            for x in (out.solution[i], single.solution)]
        assert abs(f[0] - f[1]) <= 1e-5 * abs(f[1])
        assert out.converged[i] and single.converged


@pytest.mark.parametrize("taus", [[8.0], [8.0, 0.5, 30.0]])
def test_backtracking_lanes_count_their_own_trials(taus):
    """Lanes that backtrack different amounts (τ₀ far above 1/L): each
    lane's per-iteration backtracks, total and count equal a separate
    solve's, for one lane (whose counts the loop keeps on the host) and
    for three; a lane-wise ``stop_fn`` sees each lane's own count."""
    pt = problems.build("logistic", m=60, n=30, k=4, dtype=torch.float64,
                        device="cpu")
    seen = []

    def stop_fn(k, res, nres, max_res, f):
        seen.append(torch.as_tensor(k).clone())
        return torch.zeros_like(res, dtype=torch.bool)

    opts = ftt.FastaOptions(tol=1e-8, max_iters=60, max_backtracks=6)
    out = ftt.make_batch_solver(opts.replace(stop_fn=stop_fn),
                                in_axes=(None, None, None, None, 0))(
        pt.op, pt.fterm, pt.gterm, pt.x0,
        torch.tensor(taus, dtype=torch.float64))
    assert isinstance(out.total_backtracks, np.ndarray)
    assert out.total_backtracks.shape == (len(taus),)
    for i, tau0 in enumerate(taus):
        single = ftt.solve(pt.op, pt.fterm, pt.gterm, pt.x0, tau0, opts)
        k = single.iteration_count
        assert single.total_backtracks > 0
        assert out.iteration_count[i] == k
        assert out.total_backtracks[i] == single.total_backtracks
        assert torch.equal(out.backtracks[i, :k], single.backtracks[:k])
        np.testing.assert_allclose(out.solution[i], single.solution,
                                   atol=1e-10)
    assert seen[0].tolist() == [0] * len(taus)
    assert seen[-1].tolist() == [int(c) - 1 for c in out.iteration_count]


def test_batch_solver_rejects_what_it_does_not_take():
    pt = problems.build("lasso", m=20, n=30, k=3, device="cpu")
    # a batched operator is a stack of matrices; an operator without one
    # and a lone matrix are refused
    by_op = ftt.make_batch_solver(ftt.FastaOptions(max_iters=5),
                                  (0, None, None, None, None))
    with pytest.raises(ValueError, match="no matrix to batch"):
        by_op(ftt.IdentityOp(), pt.fterm, pt.gterm, pt.x0, 0.1)
    with pytest.raises(ValueError, match="not a stack of matrices"):
        by_op(pt.op, pt.fterm, pt.gterm, pt.x0, 0.1)
    with pytest.raises(ValueError, match="None or 0"):
        ftt.make_batch_solver(ftt.FastaOptions(), (None, 1, None, None, None))
    solve = ftt.make_batch_solver(ftt.FastaOptions(max_iters=5),
                                  (None, None, 0, 0, None))
    with pytest.raises(ValueError, match="no data tensor"):
        solve(pt.op, pt.fterm, ftt.NonnegIndicator(), torch.zeros(2, 30), 0.1)
    with pytest.raises(ValueError, match="disagree"):
        solve(pt.op, pt.fterm, ftt.L1Norm(torch.ones(3)), torch.zeros(2, 30),
              0.1)
    with pytest.raises(ValueError, match="batches nothing"):
        ftt.make_batch_solver(ftt.FastaOptions(),
                              (None,) * 5)(pt.op, pt.fterm, pt.gterm, pt.x0,
                                           0.1)


# --------------------------------------------------------------------------
# K-B4 in the loop's L1 trial step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", [dict(), dict(accelerate=True),
                                  dict(adaptive=False, max_iters=60),
                                  dict(precision="standard")])
def test_l1_trial_step_through_kb4_matches_the_composition(mode,
                                                           monkeypatch):
    """The float32 LASSO loop with L1Norm (K-B4's plain version: x₁ and
    the step's sums in one pass, the sums in float64) against the same
    loop with an equal FunctionProx (the composition, float32 sums): equal
    counts, status and backtracks, the first 10 τ within rtol 1e-6, every τ
    within 1e-2 (past iteration 14 the run nears tol 1e-6 and a last-bit
    difference of ‖Δx‖² moves the BB ratio, as between the kernels and
    their plain versions) and the objective within rtol 1e-6."""
    calls = []
    real = solver.fused_shrink_step
    monkeypatch.setattr(solver, "fused_shrink_step",
                        lambda *a: calls.append(1) or real(*a))
    pt = problems.build("lasso", m=120, n=240, k=10, device="cpu")
    mu = float(pt.gterm.mu)
    comp = ftt.FunctionProx(lambda x: mu * torch.sum(torch.abs(x)),
                            lambda z, t: shrink(z, t * mu))
    opts = ftt.FastaOptions(**{"tol": 1e-6, "max_iters": 500, **mode})
    a = ftt.solve(pt.op, pt.fterm, pt.gterm, pt.x0, 0.05, opts)
    n_b4 = len(calls)
    b = ftt.solve(pt.op, pt.fterm, comp, pt.x0, 0.05, opts)
    assert n_b4 >= a.iteration_count and len(calls) == n_b4
    assert a.iteration_count == b.iteration_count
    assert a.converged == b.converged
    assert torch.equal(a.backtracks, b.backtracks)
    k = a.iteration_count
    np.testing.assert_allclose(a.taus[:10], b.taus[:10], rtol=1e-6)
    np.testing.assert_allclose(a.taus[:k], b.taus[:k], rtol=1e-2)
    f = [float(0.5 * ((pt.op.A.double() @ x.double() - pt.fterm.b.double())
                      ** 2).sum() + mu * x.double().abs().sum())
         for x in (a.solution, b.solution)]
    assert abs(f[0] - f[1]) <= 1e-6 * f[1]


def test_complex_and_float64_l1_keep_the_composition(monkeypatch):
    monkeypatch.setattr(solver, "fused_shrink_step", None)   # never called
    pt = problems.build("lasso", m=40, n=80, k=4, dtype=torch.float64,
                        device="cpu")
    r = pt.solve(tau0=0.05, tol=1e-8, max_iters=200)
    assert r.converged
    A = torch.complex(pt.op.A, 0.5 * pt.op.A).to(torch.complex64)
    out = ftt.solve(ftt.DenseOp(A), ftt.LeastSquares(A @ torch.ones(
        80, dtype=torch.complex64)), ftt.L1Norm(0.1),
        torch.zeros(80, dtype=torch.complex64), 0.02,
        ftt.FastaOptions(max_iters=20))
    assert out.iteration_count == 20


# --------------------------------------------------------------------------
# recommend_path, ServingPlan, solve_serving
# --------------------------------------------------------------------------

def _route(path):
    return "loop" if path == "xla" else path


def _routes_agree(pj, pt, batch, **kw):
    plan_j = ft.recommend_path(pj, batch, **kw)
    plan_t = ftt.recommend_path(pt, batch, **kw)
    assert plan_t.path == _route(plan_j.path), (plan_t, plan_j.path)
    assert plan_t.batch_size == batch and plan_t.problem is pt
    return plan_t


def test_recommend_path_routes_match_jax():
    pj, pt = _pair("lasso", m=120, n=240, k=10)
    assert _routes_agree(pj, pt, 1).path == "microsolve"
    big_j, big_t = _pair("tv", h=256, w=256)
    assert _routes_agree(big_j, big_t, 8).path == "microsolve_batch"
    assert "crossover" in ftt.recommend_path(big_t, 8).reason
    small_j, small_t = _pair("tv", h=64, w=64)
    assert _routes_agree(small_j, small_t, 64).path == "batch_solver"
    assert _routes_agree(small_j, small_t, 1).path == "microsolve"
    # a structure that both packages build and no kernel takes
    ident = (lambda z, t: z)
    fj = pj.with_parts(gterm=ft.FunctionProx(None, ident))
    fp = pt.with_parts(gterm=ftt.FunctionProx(None, ident))
    plan = _routes_agree(fj, fp, 1)
    assert plan.path == "loop" and "no whole-solve kernel" in plan.reason
    assert _routes_agree(fj, fp, 4).path == "batch_solver"
    d64_j, d64_t = _pair("lasso", np.float64, m=120, n=240, k=10)
    plan = _routes_agree(d64_j, d64_t, 1)
    assert plan.path == "loop" and "f32" in plan.reason
    plan = _routes_agree(pj, pt, 1, need_full_diagnostics=True)
    assert plan.path == "loop" and "diagnostics" in plan.reason
    assert _routes_agree(pj, pt, 4, need_full_diagnostics=True).path \
        == "batch_solver"
    for name, kw in (("phase_retrieval", dict(m=128, n=16, planar=True)),
                     ("logistic", dict(m=100, n=50, k=5)),
                     ("svm", dict(m=80, n=20))):
        a, b = _pair(name, **kw)
        for batch in (1, 16):
            _routes_agree(a, b, batch)
    with pytest.raises(ValueError, match="batch_size"):
        ftt.recommend_path(pt, 0)
    assert ftt.BATCH_CROSSOVER_UNKNOWNS == ft.serving.BATCH_CROSSOVER_UNKNOWNS


def test_plan_runners_execute():
    pj, pt = _pair("lasso", m=120, n=240, k=10)
    b = pt.fterm.b
    bs = torch.stack([b, b * 1.01])
    plan = ftt.recommend_path(pt, 2)
    assert plan.path == "batch_solver"
    opts = ftt.FastaOptions(max_iters=200, tol=1e-6, precision="standard")
    res = plan.run(bs, tau0=0.05, options=opts)
    assert res.solution.shape == (2, 240) and res.converged.all()
    res_j = ft.recommend_path(pj, 2).run(
        jnp.asarray(bs.numpy()), tau0=0.05,
        options=ft.FastaOptions(max_iters=200, tol=1e-6,
                                precision="standard"))
    np.testing.assert_allclose(res.solution.numpy(),
                               np.asarray(res_j.solution), atol=1e-4)
    with pytest.raises(ValueError, match="options= and tau0= only"):
        plan.run(bs, tau0=0.05, max_iters=3)

    r = ftt.recommend_path(pt, 1).run(tau0=0.05, max_iters=200, tol=1e-6)
    assert isinstance(r, ftt.MicroResult) and r.converged

    xplan = ftt.recommend_path(pt, 1, need_full_diagnostics=True)
    r = xplan.run(options=opts, tau0=0.05)
    assert isinstance(r, ftt.FastaResult)
    assert r.converged and r.objectives is None


def test_kernel_batch_runner_executes():
    big = problems.build("tv", h=256, w=256, device="cpu")
    plan = ftt.recommend_path(big, 2)
    assert plan.path == "microsolve_batch"
    b = big.fterm.b
    rb = plan.run(torch.stack([b, b * 1.01]), max_iters=20, tol=1e-3)
    assert rb.solutions.shape == (2, 2, 256, 256)
    with pytest.raises(ValueError, match="bs"):
        plan.run()


def test_solve_serving_method():
    pt = problems.build("lasso", m=120, n=240, k=10, device="cpu")
    r = pt.solve_serving(tau0=0.05, max_iters=200, tol=1e-6)
    assert r.converged and isinstance(r, ftt.MicroResult)
    b = pt.fterm.b
    res = pt.solve_serving(torch.stack([b, b]), tau0=0.05,
                           options=ftt.FastaOptions(max_iters=200, tol=1e-6,
                                                    precision="standard"))
    assert res.solution.shape == (2, 240)
    assert torch.equal(res.solution[0], res.solution[1])
    arrays = ftt.convert.result_to_numpy(res)
    assert arrays["solution"].shape == (2, 240)
    mb = pt.microsolve_batch(torch.stack([b, b]), tau0=0.05, max_iters=50)
    arrays = ftt.convert.result_to_numpy(mb)
    assert isinstance(arrays["solutions"], np.ndarray)
    assert all(isinstance(t, np.ndarray) for t in arrays["taus"])


@pytest.mark.parametrize("need_full_diagnostics", [False, True])
def test_one_row_request_solves_its_own_measurements(need_full_diagnostics):
    """C-ref-6: the reference's single routes ignore ``bs`` and solve the
    problem's own b.  Here a one-row request solves its row."""
    pt = problems.build("lasso", m=120, n=240, k=10, device="cpu")
    pt.tau0 = 0.05
    row = (pt.fterm.b * 1.5 + 0.1)[None]
    kw = (dict(options=ftt.FastaOptions(max_iters=300, tol=1e-6))
          if need_full_diagnostics else dict(max_iters=300, tol=1e-6))
    got = pt.solve_serving(row, need_full_diagnostics=need_full_diagnostics,
                           **kw)
    own = pt.solve_serving(need_full_diagnostics=need_full_diagnostics, **kw)
    asked = pt.with_parts(fterm=ftt.LeastSquares(row[0]))
    want = (asked.solve(**kw) if need_full_diagnostics
            else asked.microsolve(**kw))
    x, x_own, x_want = (torch.as_tensor(r.solution)
                        for r in (got, own, want))
    assert torch.equal(x, x_want)
    assert (x - x_own).abs().max() > 1e-2
    plan = ftt.recommend_path(pt, 1,
                              need_full_diagnostics=need_full_diagnostics)
    with pytest.raises(ValueError, match="solves one instance"):
        plan.run(torch.stack([pt.fterm.b, pt.fterm.b]))
