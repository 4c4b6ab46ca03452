"""The rest of the solver surface on the CPU: ``fasta()`` with the
reference's keywords (``key=``: ROADMAP C-6), the bounded solver cache,
``make_batch_solver`` over a batched operator (one matrix a lane) against
separate solves and ``fasta_tpu.make_batch_solver``, and the package's
exports and imports.

Tolerances: float64 throughout; a lane against its own single solve and
the batch against the JAX batch: equal counts, solutions, τ and
residuals within rtol 1e-10 (the products of a lane and of a single
solve round differently, 1e-15 relative).  The LASSO batches stop at
tol 1e-5 (18 to 26 iterations, τ within 7e-12): closer to the optimum
the BB stepsize ‖Δx‖²/⟨Δx,Δg⟩ cancels, and its rounding passes 1e-10
relative between any two implementations (1.6e-10 at tol 1e-6, 5e-9 at
1e-8).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fasta_tpu as ft
import fasta_tpu_torch as ftt
import problems as jax_problems
from fasta_tpu_torch import problems, solver

torch.set_num_threads(1)


def _lasso(seed=1, m=48, n=80, k=6):
    return problems.build("lasso", m=m, n=n, k=k, seed=seed,
                          dtype=torch.float64, device="cpu")


# --------------------------------------------------------------------------
# fasta() with the reference's keywords (C-6)
# --------------------------------------------------------------------------

def test_fasta_takes_the_reference_keywords():
    """The reference's call shape, ``key=`` included, runs in the port and
    gives the JAX package's solve."""
    p = _lasso()
    q = jax_problems.build("lasso", m=48, n=80, k=6, dtype=jnp.float64)
    kw = dict(key=3, tau0=0.05, tol=1e-8, max_iters=300,
              check_adjoint_first=True, record_objective=True)
    r = ftt.fasta(p.op.A, None, p.fterm, None, p.gterm, None, p.x0, **kw)
    jr = ft.fasta(np.asarray(q.op.A), None, q.fterm, None, q.gterm, None,
                  np.asarray(q.x0), **kw)
    assert r.converged and jr.converged
    assert r.iteration_count == jr.iteration_count
    np.testing.assert_allclose(r.solution, jr.solution, rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(r.objectives, jr.objectives, rtol=1e-10)


def test_fasta_key_seeds_the_stepsize_estimate():
    """Without τ₀, ``key`` seeds the generator of the estimate's points:
    the same key gives the same points (the same L), another key others;
    ``generator`` does the same with a ``torch.Generator``; the default is
    seed 0."""
    p = _lasso()

    def L(**kw):
        return ftt.fasta(p.op, None, p.fterm, None, p.gterm, None, p.x0,
                         max_iters=3, **kw).L_estimate
    assert L(key=3) == L(key=3)
    assert L(key=3) != L(key=4)
    assert L(key=3) == L(generator=torch.Generator().manual_seed(3))
    assert L() == L(key=0)


def test_fasta_refuses_key_and_generator_together():
    p = _lasso()
    with pytest.raises(ValueError, match="not both"):
        ftt.fasta(p.op, None, p.fterm, None, p.gterm, None, p.x0, key=1,
                  generator=torch.Generator().manual_seed(1), tau0=0.05)


# --------------------------------------------------------------------------
# the solver cache
# --------------------------------------------------------------------------

def test_solver_cache_reuses_one_function_per_option_set():
    opts = ftt.FastaOptions(max_iters=17, tol=1e-7)
    assert ftt.make_solver(opts) is ftt.make_solver(opts)
    assert ftt.make_solver(opts) is ftt.make_solver(
        ftt.FastaOptions(max_iters=17, tol=1e-7))
    assert ftt.make_stateful_solver(opts) is ftt.make_stateful_solver(opts)
    assert ftt.make_solver(opts) is not ftt.make_stateful_solver(opts)
    assert ftt.make_solver(opts) is not ftt.make_solver(
        opts.replace(max_iters=18))


def test_solver_cache_stays_at_its_capacity():
    cache = solver._SOLVER_CACHE
    for i in range(cache.capacity + 8):
        ftt.make_solver(ftt.FastaOptions(max_iters=1000 + i))
    assert len(cache) == cache.capacity
    # the least recently used entries went first
    newest = ftt.FastaOptions(max_iters=1000 + cache.capacity + 7)
    assert cache.get(("solve", newest)) is not None
    assert cache.get(("solve", ftt.FastaOptions(max_iters=1000))) is None


def test_lru_cache_evicts_the_least_recently_used():
    cache = solver._LRUCache(capacity=2)
    cache.put("a", 1)
    cache.put("b", 2)
    assert cache.get("a") == 1          # "a" is now the newest
    cache.put("c", 3)
    assert cache.get("b") is None and cache.get("a") == 1
    assert len(cache) == 2
    cache.clear()
    assert len(cache) == 0


# --------------------------------------------------------------------------
# make_batch_solver over a batched operator
# --------------------------------------------------------------------------

SEEDS = (1, 2, 3)


def _hold(lane, single, k=None):
    k = int(single.iteration_count) if k is None else k
    for name in ("solution", "taus", "residuals"):
        a, b = np.asarray(getattr(lane, name)), np.asarray(
            getattr(single, name))
        if name != "solution":
            a, b = a[:k], b[:k]
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-14,
                                   err_msg=name)


@pytest.mark.parametrize("lane_shape", [(80,), (80, 3)])
def test_stacked_dense_op_takes_lane_i_through_matrix_i(lane_shape):
    """A ``DenseOp`` over a stack (B, m, n): lane i's product and adjoint
    are matrix i's, for vector lanes and matrix lanes (MMV's (n, l))."""
    g = torch.Generator().manual_seed(0)
    A = torch.randn(3, 48, 80, generator=g, dtype=torch.float64)
    x = torch.randn((3,) + lane_shape, generator=g, dtype=torch.float64)
    y = torch.randn((3, 48) + lane_shape[1:], generator=g,
                    dtype=torch.float64)
    op = ftt.DenseOp(A)
    for i in range(3):
        torch.testing.assert_close(op.lanes(x)[i], A[i] @ x[i], rtol=1e-13,
                                   atol=1e-13)
        torch.testing.assert_close(op.rmatvec_lanes(y)[i], A[i].T @ y[i],
                                   rtol=1e-13, atol=1e-13)
    one = ftt.DenseOp(A[:1])
    torch.testing.assert_close(one.lanes(x[:1])[0], A[0] @ x[0], rtol=1e-13,
                               atol=1e-13)


def test_batched_operator_lanes_match_their_solves_and_jax():
    """in_axes=(0, 0, None, None, None): three LASSO instances 48×80 (A and
    b a lane) over one μ, one x0 and one τ₀."""
    ps = [_lasso(s) for s in SEEDS]
    As = torch.stack([p.op.A for p in ps])
    bs = torch.stack([p.fterm.b for p in ps])
    opts = ftt.FastaOptions(tol=1e-5, max_iters=300, record_objective=True)
    axes = (0, 0, None, None, None)
    out = ftt.make_batch_solver(opts, axes)(
        ftt.DenseOp(As), ftt.LeastSquares(bs), ps[0].gterm, ps[0].x0, 0.05)
    assert out.solution.shape == (3, 80)
    for i, p in enumerate(ps):
        single = ftt.solve(p.op, p.fterm, p.gterm, p.x0, 0.05, opts)
        assert out.iteration_count[i] == single.iteration_count
        assert out.total_backtracks[i] == single.total_backtracks
        assert out.converged[i] and single.converged
        _hold(type("Lane", (), dict(
            solution=out.solution[i], taus=out.taus[i],
            residuals=out.residuals[i]))(), single)

    qs = [jax_problems.build("lasso", m=48, n=80, k=6, seed=s,
                             dtype=jnp.float64) for s in SEEDS]
    jout = ft.make_batch_solver(ft.FastaOptions(
        tol=1e-5, max_iters=300, record_objective=True), in_axes=axes)(
        ft.DenseOp(jnp.stack([q.op.A for q in qs])),
        ft.LeastSquares(jnp.stack([q.fterm.b for q in qs])), qs[0].gterm,
        jnp.asarray(qs[0].x0), jnp.asarray(0.05))
    np.testing.assert_array_equal(out.iteration_count,
                                  np.asarray(jout.iteration_count))
    np.testing.assert_array_equal(out.total_backtracks,
                                  np.asarray(jout.total_backtracks))
    for i in range(3):
        _hold(type("Lane", (), dict(
            solution=out.solution[i], taus=out.taus[i],
            residuals=out.residuals[i]))(),
            type("Lane", (), dict(
                solution=jout.solution[i], taus=jout.taus[i],
                residuals=jout.residuals[i],
                iteration_count=jout.iteration_count[i]))())


def test_batched_operator_alone_and_with_a_lane_of_one():
    """Only the operator batched (one b for all), and a batch of one lane:
    each lane is its own solve (plain mode, 100 iterations: τ does not
    move without a backtrack and the residual stays far above rounding)."""
    ps = [_lasso(s) for s in SEEDS]
    opts = ftt.FastaOptions(adaptive=False, max_iters=100,
                            stop_rule="iterations")
    by_op = ftt.make_batch_solver(opts, (0, None, None, None, None))
    out = by_op(ftt.DenseOp(torch.stack([p.op.A for p in ps])),
                ps[0].fterm, ps[0].gterm, ps[0].x0, 0.05)
    for i, p in enumerate(ps):
        single = ftt.solve(p.op, ps[0].fterm, p.gterm, p.x0, 0.05, opts)
        assert out.iteration_count[i] == single.iteration_count
        _hold(type("Lane", (), dict(
            solution=out.solution[i], taus=out.taus[i],
            residuals=out.residuals[i]))(), single)
    one = by_op(ftt.DenseOp(ps[1].op.A[None]), ps[0].fterm, ps[0].gterm,
                ps[0].x0, 0.05)
    single = ftt.solve(ps[1].op, ps[0].fterm, ps[1].gterm, ps[1].x0, 0.05,
                       opts)
    assert one.iteration_count.tolist() == [single.iteration_count]
    _hold(type("Lane", (), dict(solution=one.solution[0], taus=one.taus[0],
                                residuals=one.residuals[0]))(), single)


def test_batched_planar_operator_lanes_match_their_solves():
    """A ``PlanarDenseOp`` with stacked channels (and its measurements a
    lane): each lane against its own planar solve."""
    ps = [problems.build("phase_retrieval", m=256, n=16, seed=s,
                         planar=True, dtype=torch.float64, device="cpu")
          for s in SEEDS]
    op = ftt.PlanarDenseOp(torch.stack([p.op.Ar for p in ps]),
                           torch.stack([p.op.Ai for p in ps]))
    opts = ftt.FastaOptions(tol=1e-8, max_iters=150)
    out = ftt.make_batch_solver(opts, (0, 0, 0, 0, None))(
        op, ftt.PlanarPhaseHinge(torch.stack([p.fterm.b for p in ps])),
        ftt.PlanarLinearAnchor(torch.stack([p.gterm.c for p in ps])),
        torch.stack([p.x0 for p in ps]), 1.0)
    assert out.solution.shape == (3, 16, 2)
    for i, p in enumerate(ps):
        single = ftt.solve(p.op, p.fterm, p.gterm, p.x0, 1.0, opts)
        assert out.iteration_count[i] == single.iteration_count
        _hold(type("Lane", (), dict(
            solution=out.solution[i], taus=out.taus[i],
            residuals=out.residuals[i]))(), single)


# --------------------------------------------------------------------------
# exports and imports
# --------------------------------------------------------------------------

def test_every_reference_name_is_exported():
    missing = sorted(set(ft.__all__) - set(ftt.__all__))
    assert not missing, missing
    for name in ftt.__all__:
        assert getattr(ftt, name) is not None, name


def test_import_loads_no_jax_and_no_matplotlib():
    code = ("import sys, fasta_tpu_torch; print(sorted(m for m in "
            "('jax', 'fasta_tpu', 'matplotlib') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
