"""TV denoising through the port's public entry points — the TV dispatch,
``Problem.solve`` in its three modes (with K-B5 on every trial),
``Problem.microsolve``, ``Problem.microsolve_sweep`` cold and warm,
``recover`` and ``convert`` — held against ``fasta_tpu`` and the float64
oracle (CPU), and ``fasta()``'s device rule.

The loop's bands are tests/parity/test_parity.py's for TV (32x32, τ₀ 2.0,
tol 1e-8, 120 iterations, float64): the first 10 taus rtol 1e-7,
residuals rtol 1e-6 / atol 1e-12, f-values rtol 1e-7 / atol 1e-12, the
final objective within 1e-5 and the iteration count within max(5, 20%).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fasta_tpu_torch as ftt
import problems as jax_problems
from fasta_tpu import microsolve as jax_microsolve
from fasta_tpu import microsolve_sweep as jax_microsolve_sweep
from fasta_tpu_torch import problems
from fasta_tpu_torch.convert import problem_from_instance
from fasta_tpu_torch.kernels import microsolver_tv, tv_fused
from reference_oracle.fasta_numpy import fasta as fasta_np
from reference_oracle.generators import make_lasso
from reference_oracle.generators import tv_div_2d as np_tv_div

torch.set_num_threads(1)

MODES = {
    "plain": dict(adaptive=False, accelerate=False),
    "adaptive": dict(adaptive=True, accelerate=False),
    "accelerated": dict(adaptive=False, accelerate=True),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_loop_modes_match_oracle_and_jax_f64(mode):
    pt = problems.build("tv", h=32, w=32, dtype=torch.float64, device="cpu")
    pj = jax_problems.build("tv", h=32, w=32, dtype=jnp.float64)
    inst = pt.instance
    skw = dict(tol=1e-8, max_iters=120, record_objective=True, **MODES[mode])
    r_np = fasta_np(inst["op"], inst.get("op_t"), inst["f"], inst["gradf"],
                    inst["g"], inst["proxg"], inst["x0"], tau0=2.0, **skw)
    pt.tau0 = pj.tau0 = 2.0
    r_t = pt.solve(**skw)
    r_j = pj.solve(**skw)
    for r_ref, what in ((r_np, "oracle"), (r_j, "fasta_tpu")):
        k = min(10, r_t.iteration_count, r_ref.iteration_count)
        np.testing.assert_allclose(r_t.taus[:k], r_ref.taus[:k], rtol=1e-7,
                                   err_msg=f"{what}: taus")
        np.testing.assert_allclose(r_t.residuals[:k], r_ref.residuals[:k],
                                   rtol=1e-6, atol=1e-12,
                                   err_msg=f"{what}: residuals")
        np.testing.assert_allclose(r_t.fvals[:k], r_ref.fvals[:k],
                                   rtol=1e-7, atol=1e-12,
                                   err_msg=f"{what}: f")
        scale = max(abs(r_ref.objectives[-1]), 1e-10)
        assert abs(r_t.objectives[-1] - r_ref.objectives[-1]) / scale < 1e-5
        assert abs(r_t.iteration_count - r_ref.iteration_count) <= max(
            5, int(0.2 * r_ref.iteration_count))


def test_f32_loop_takes_the_fused_gradient_map_on_every_trial(monkeypatch):
    """A float32 TV problem's loop evaluates K-B5's wrapper once per
    trial, in all three modes (FISTA through the zero-matvec affine
    extrapolation); a float64 image takes the plain version."""
    pt = problems.build("tv", h=16, w=16, device="cpu")
    calls = []
    real = tv_fused.fused_tv_gradmap

    def counted(p, b, mu):
        calls.append(p.shape)
        return real(p, b, mu)

    monkeypatch.setattr(tv_fused, "fused_tv_gradmap", counted)
    for mode in MODES.values():
        calls.clear()
        r = pt.solve(tau0=2.0, tol=1e-5, max_iters=60, **mode)
        assert len(calls) == r.iteration_count + r.total_backtracks
        assert set(calls) == {(2, 16, 16)}
    p64 = problems.build("tv", h=16, w=16, dtype=torch.float64, device="cpu")
    calls.clear()
    p64.solve(tau0=2.0, tol=1e-5, max_iters=20)
    assert not calls


def test_f32_loop_tracks_the_jax_hp_loop():
    """float32 with precision "auto" (float64 decision scalars): the
    first 10 taus and residuals of ``fasta_tpu``'s hp loop (rtol 1e-4)
    and its objective (1e-5)."""
    pt = problems.build("tv", h=32, w=32, device="cpu")
    pj = jax_problems.build("tv", h=32, w=32, dtype=jnp.float32)
    pj.tau0 = 2.0
    r_t = pt.solve(tau0=2.0, tol=1e-5, max_iters=400, record_objective=True)
    r_j = pj.solve(tol=1e-5, max_iters=400, record_objective=True)
    assert r_t.converged and r_j.converged
    np.testing.assert_allclose(r_t.taus[:10], r_j.taus[:10], rtol=1e-4)
    np.testing.assert_allclose(r_t.residuals[:10], r_j.residuals[:10],
                               rtol=1e-4)
    assert abs(r_t.objectives[-1] - r_j.objectives[-1]) <= 1e-5 * abs(
        r_j.objectives[-1])


def test_dispatch_and_rejections():
    pt = problems.build("tv", h=16, w=16, device="cpu")
    assert ftt.microsolve_supported(pt) == (True, "tv")
    flat = ftt.Problem("b1", pt.op, ftt.LeastSquares(pt.fterm.b.reshape(-1)),
                       pt.gterm, pt.x0)
    box = ftt.Problem("box", pt.op, pt.fterm, ftt.BoxIndicator(-2.0, 2.0),
                      pt.x0)
    for prob, why in ((flat, "2-D image"), (box, "[-1,1] dual ball")):
        ok, reason = ftt.microsolve_supported(prob)
        assert not ok and why in reason
        with pytest.raises(ValueError, match="microsolve"):
            prob.microsolve(tau0=2.0)
    with pytest.raises(ValueError, match="record_iterates"):
        pt.microsolve(tau0=2.0, record_iterates=True)
    with pytest.raises(ValueError, match="engine"):
        pt.microsolve(tau0=2.0, engine="vpu")
    with pytest.raises(ValueError, match="engine"):
        pt.microsolve_sweep([0.2, 0.1], tau0=2.0, warm_start=True,
                            engine="vpu")
    with pytest.raises(ValueError, match="interpret"):
        pt.microsolve(tau0=2.0, interpret=True)


def test_microsolve_matches_jax_and_defaults_hp_on():
    """``Problem.microsolve`` on TV: hp on by default, as in JAX; the
    solution keeps the (2,H,W) layout; the early trajectory matches the
    port's own loop and ``fasta_tpu.microsolve``."""
    pt = problems.build("tv", h=16, w=16, device="cpu")
    pj = jax_problems.build("tv", h=16, w=16, dtype=jnp.float32)
    r = pt.microsolve(tau0=2.0, max_iters=400, tol=1e-4)
    rj = jax_microsolve(pj, tau0=2.0, max_iters=400, tol=1e-4, hp=True)
    assert r.solution.shape == (2, 16, 16) and r.converged and rj.converged
    # knife-edge float32 backtracking: 89 against 88 iterations here
    assert abs(r.iteration_count - rj.iteration_count) <= max(
        5, int(0.2 * rj.iteration_count))
    np.testing.assert_allclose(r.taus[:10], rj.taus[:10], rtol=1e-4)
    r_hp = pt.microsolve(tau0=2.0, max_iters=400, tol=1e-4, hp=True)
    assert torch.equal(r.solution, r_hp.solution)
    rx = pt.solve(tau0=2.0, tol=1e-4, max_iters=400)
    kk = min(8, r.iteration_count, rx.iteration_count)
    np.testing.assert_allclose(r.taus[:kk], rx.taus[:kk], rtol=1e-4)
    ra = pt.microsolve(tau0=2.0, max_iters=400, tol=1e-4, accelerate=True,
                       restart_dd=True)
    assert ra.converged


def test_hp_non_power_of_two_image():
    """24x24 (the TPU kernel's zero-padded reduction case): the first 10
    taus and residuals of the JAX hp loop."""
    pt = problems.build("tv", h=24, w=24, device="cpu")
    pj = jax_problems.build("tv", h=24, w=24, dtype=jnp.float32)
    K = 10
    r = pt.microsolve(tau0=2.0, max_iters=K, tol=0.0, hp=True)
    assert r.iteration_count == K
    pj.tau0 = 2.0
    rx = pj.solve(tol=1e-12, max_iters=K, fuse=False,
                  stop_rule="iterations", precision="auto")
    np.testing.assert_allclose(r.taus, rx.taus[:K], rtol=1e-4)
    np.testing.assert_allclose(r.residuals, rx.residuals[:K], rtol=1e-4)


MUS = [0.2, 0.1, 0.05]


def _with_weight(prob, mu):
    return ftt.Problem(prob.name, ftt.ScaledOp(mu, ftt.TVDiv2D()),
                       prob.fterm, prob.gterm, prob.x0, tau0=prob.tau0)


def _dual(prob, mu, p):
    b = np.asarray(prob.instance["b"], np.float64)
    r = mu * np_tv_div(np.asarray(p, np.float64)) - b
    return 0.5 * np.sum(r * r)


def test_sweep_cold_points_bitmatch_separate_solves_and_jax():
    pt = problems.build("tv", h=16, w=16, device="cpu")
    pj = jax_problems.build("tv", h=16, w=16, dtype=jnp.float32)
    kw = dict(tau0=2.0, max_iters=600, tol=1e-5)
    sw = pt.microsolve_sweep(MUS, **kw)
    sj = jax_microsolve_sweep(pj, jnp.asarray(MUS, jnp.float32), **kw)
    assert sw.solutions.shape == (3, 2, 16, 16) and sw.converged.all()
    np.testing.assert_array_equal(sw.statuses, sj.statuses)
    for i, mu in enumerate(MUS):
        one = _with_weight(pt, mu).microsolve(**kw)
        assert torch.equal(one.solution, sw.solutions[i])
        np.testing.assert_array_equal(one.taus, sw.taus[i])
        assert abs(_dual(pt, mu, sw.solutions[i])
                   - _dual(pt, mu, sj.solutions[i])) <= 1e-6 * _dual(
                       pt, mu, sj.solutions[i])


@pytest.mark.parametrize("accelerate", [False, True])
def test_warm_sweep_first_point_is_cold_and_objectives_match(accelerate):
    """The JAX warm-path contract (tests/unit/test_micro_warm_path.py):
    point 0 bit-matches a cold solve; every point converges to the cold
    path's dual objective (1e-3, the JAX test's bound); FISTA composes
    with record_fvals."""
    pt = problems.build("tv", h=16, w=16, device="cpu")
    kw = dict(tau0=2.0, max_iters=600, tol=1e-5, stop_rule="residual",
              accelerate=accelerate)
    warm = pt.microsolve_sweep(MUS, warm_start=True, record_fvals=True, **kw)
    cold = pt.microsolve_sweep(MUS, **kw)
    r0 = _with_weight(pt, MUS[0]).microsolve(**kw)
    assert warm.iteration_counts[0] == r0.iteration_count
    assert torch.equal(warm.solutions[0], r0.solution)
    np.testing.assert_array_equal(warm.taus[0], r0.taus)
    assert warm.converged.all() and cold.converged.all()
    assert len(warm.fvals) == 3
    for i, mu in enumerate(MUS):
        fw = _dual(pt, mu, warm.solutions[i])
        fc = _dual(pt, mu, cold.solutions[i])
        assert abs(fw - fc) <= 1e-3 * (1.0 + abs(fc))


def test_recover_and_convert_round_trip():
    pj = jax_problems.build("tv", h=12, w=20, dtype=jnp.float64)
    pt = problem_from_instance(pj.instance, device="cpu",
                               dtype=torch.float64)
    assert isinstance(pt.op, ftt.ScaledOp) and pt.op.c == pj.op.c
    np.testing.assert_array_equal(pt.fterm.b.numpy(), np.asarray(pj.fterm.b))
    np.testing.assert_array_equal(pt.x0.numpy(), np.asarray(pj.x0))
    assert (pt.gterm.lo, pt.gterm.hi) == (-1.0, 1.0)
    p = np.random.default_rng(4).uniform(-1, 1, (2, 12, 20))
    np.testing.assert_allclose(pt.recover(torch.from_numpy(p)).numpy(),
                               pj.recover(p), atol=1e-12)
    assert pt.recover(p).dtype == torch.float64
    built = problems.build("tv", h=12, w=20, device="cpu")
    assert built.name == "tv[12x20]" and built.x0.dtype == torch.float32
    assert built.recover is not None


def test_slice_end_to_end_reaches_the_oracle_objective():
    """problems.build("tv") at 32x32, float32: the loop and both kernel
    modes reach the float64 oracle's dual objective within 1e-5."""
    pt = problems.build("tv", h=32, w=32, device="cpu")
    inst = pt.instance
    ref = fasta_np(inst["op"], inst["op_t"], inst["f"], inst["gradf"],
                   inst["g"],
                   inst["proxg"], inst["x0"], tau0=2.0, tol=1e-9,
                   max_iters=20000)
    goal = _dual(pt, inst["mu"], ref.solution)
    runs = [pt.solve(tau0=2.0, tol=1e-6, max_iters=5000).solution,
            pt.microsolve(tau0=2.0, tol=1e-6, max_iters=5000).solution,
            pt.microsolve(tau0=2.0, tol=1e-6, max_iters=5000,
                          accelerate=True).solution]
    for p in runs:
        assert abs(_dual(pt, inst["mu"], p) - goal) <= 1e-5 * goal
        x = pt.recover(p).numpy()
        np.testing.assert_allclose(x, inst["recover"](ref.solution),
                                   atol=1e-3)


def test_fasta_device_defaults_to_the_card(monkeypatch):
    """NumPy inputs go to ``device`` (default "cuda"): with no card the
    default raises rather than solve on the CPU in silence; device="cpu"
    solves as a CPU tensor call does; a placed tensor on another device
    than an explicit one raises."""
    inst = make_lasso(m=40, n=80, k=5, seed=1)
    A, b, x0 = inst["A"], inst["b"], inst["x0"]
    terms = (ftt.LeastSquares(torch.from_numpy(b)), None,
             ftt.L1Norm(inst["mu"]), None)
    kw = dict(tau0=0.05, tol=1e-8, max_iters=200)
    ref = ftt.fasta(torch.from_numpy(A), None, *terms, torch.from_numpy(x0),
                    **kw)
    got = ftt.fasta(A, None, *terms, x0, device="cpu", **kw)
    assert got.iteration_count == ref.iteration_count
    np.testing.assert_array_equal(got.solution, ref.solution)
    r_np = fasta_np(A, None, inst["f"], inst["gradf"], inst["g"],
                    inst["proxg"], x0, **kw)
    np.testing.assert_allclose(got.solution, np.asarray(r_np.solution),
                               atol=1e-8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ftt.fasta(A, None, *terms, x0, **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ftt.fasta(torch.from_numpy(A), None, *terms, x0, **kw)
    with pytest.raises(ValueError, match="never moves"):
        ftt.fasta(A, None, *terms, torch.from_numpy(x0), device="meta", **kw)
    # a NumPy matrix now lands on the requested device
    op = ftt.as_linear_op(A, device="cpu")
    assert op.A.device.type == "cpu" and op.A.dtype == torch.float64


def test_microsolve_counts_no_launch_on_the_cpu():
    pt = problems.build("tv", h=8, w=8, device="cpu")
    before = (tv_fused.LAUNCHES, microsolver_tv.LAUNCHES,
              microsolver_tv.PATH_LAUNCHES)
    pt.solve(tau0=2.0, max_iters=5)
    pt.microsolve(tau0=2.0, max_iters=5)
    pt.microsolve_sweep([0.2, 0.1], tau0=2.0, max_iters=5)
    assert (tv_fused.LAUNCHES, microsolver_tv.LAUNCHES,
            microsolver_tv.PATH_LAUNCHES) == before
