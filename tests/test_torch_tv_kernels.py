"""The TV stencils, kernel K-B5 (fused TV gradient map) and kernels K-B6 /
K-B6p (whole TV-dual solve) through their plain versions, held against
the oracle's stencils and the JAX kernels in interpret mode (CPU).

Tolerances are the JAX package's own (tests/unit/test_tv_fused.py,
test_microsolver_tv.py, test_micro_stoprules.py, test_micro_status.py):
the stencils to 1e-12 in float64; the gradient map to atol 1e-6 and f to
rtol 1e-5; whole solves over an iteration prefix — taus, residuals,
f-values, objectives and normalized residuals rtol 1e-4, backtracks
equal — because the TV dual's float32 backtracking is knife-edge and any
two implementations part after enough iterations; runs to a tolerance
hold the iteration count and status.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fasta_tpu_torch as ftt
import problems as jax_problems
from fasta_tpu import microsolve as jax_microsolve
from fasta_tpu.kernels.microsolver_tv import microsolve_tv as jax_micro_tv
from fasta_tpu.kernels.tv_fused import fused_tv_gradmap as jax_tv_gradmap
from fasta_tpu_torch import problems
from fasta_tpu_torch.kernels import microsolver_tv, tv_fused
from fasta_tpu_torch.kernels.microsolver_tv import microsolve_tv
from fasta_tpu_torch.operators import tv_div_2d, tv_grad_2d
from reference_oracle.generators import make_tv
from reference_oracle.generators import tv_div_2d as np_tv_div
from reference_oracle.generators import tv_grad_2d as np_tv_grad

torch.set_num_threads(1)
RNG = np.random.default_rng(9)
RECORD = dict(record_fvals=True, record_bts=True, record_objs=True,
              record_nres=True)


@pytest.mark.parametrize("shape", [(32, 48), (1, 5), (5, 1), (7, 9)])
def test_stencils_match_the_oracle_f64(shape):
    x = RNG.standard_normal(shape)
    p = RNG.standard_normal((2,) + shape)
    np.testing.assert_allclose(tv_grad_2d(torch.from_numpy(x)).numpy(),
                               np_tv_grad(x), atol=1e-12)
    np.testing.assert_allclose(tv_div_2d(torch.from_numpy(p)).numpy(),
                               np_tv_div(p), atol=1e-12)
    op = ftt.ScaledOp(0.3, ftt.TVDiv2D())
    np.testing.assert_allclose(op(torch.from_numpy(p)).numpy(),
                               0.3 * np_tv_div(p), atol=1e-12)
    np.testing.assert_allclose(op.rmatvec(torch.from_numpy(x)).numpy(),
                               0.3 * np_tv_grad(x), atol=1e-12)


def test_scaled_div_passes_the_adjoint_check():
    g = torch.Generator().manual_seed(3)
    p_like = torch.zeros((2, 12, 17), dtype=torch.float64)
    for op in (ftt.ScaledOp(0.1, ftt.TVDiv2D()), ftt.TVDiv2D()):
        assert ftt.check_adjoint(op, p_like, g, rtol=1e-12) <= 1e-12
    assert ftt.check_adjoint(ftt.TVGrad2D(), torch.zeros(
        (12, 17), dtype=torch.float64), g, rtol=1e-12) <= 1e-12


@pytest.mark.parametrize("shape", [(64, 64), (128, 256)])
def test_gradmap_plain_version_matches_jax_kernel_interpret(shape):
    h, w = shape
    p = RNG.standard_normal((2, h, w)).astype(np.float32)
    b = RNG.standard_normal((h, w)).astype(np.float32)
    d0, f0, g0 = jax_tv_gradmap(jnp.asarray(p), jnp.asarray(b), 0.1,
                                interpret=True)
    d, f, g = tv_fused.tv_gradmap_reference(torch.from_numpy(p),
                                            torch.from_numpy(b), 0.1)
    np.testing.assert_allclose(d.numpy(), np.asarray(d0), atol=1e-6)
    np.testing.assert_allclose(float(f), float(f0), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g0), atol=1e-6)


def test_gradmap_plain_version_matches_the_oracle_f64():
    h, w, mu = 32, 48, 0.3
    p = RNG.standard_normal((2, h, w))
    b = RNG.standard_normal((h, w))
    d, f, g = tv_fused.tv_gradmap_reference(torch.from_numpy(p),
                                            torch.from_numpy(b), mu)
    r = mu * np_tv_div(p) - b
    np.testing.assert_allclose(d.numpy(), mu * np_tv_div(p), atol=1e-12)
    np.testing.assert_allclose(float(f), 0.5 * (r ** 2).sum(), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), mu * np_tv_grad(r), atol=1e-12)


def test_gradmap_wrapper_on_cpu_is_the_plain_version_and_checks_shapes():
    p = torch.from_numpy(RNG.standard_normal((2, 9, 7)).astype(np.float32))
    b = torch.from_numpy(RNG.standard_normal((9, 7)).astype(np.float32))
    before = tv_fused.LAUNCHES
    out = tv_fused.fused_tv_gradmap(p, b, 0.2)
    ref = tv_fused.tv_gradmap_reference(p, b, 0.2)
    assert tv_fused.LAUNCHES == before
    for a, r in zip(out, ref):
        assert torch.equal(a, r)
    with pytest.raises(ValueError, match=r"p \(2,H,W\)"):
        tv_fused.fused_tv_gradmap(p[:, :8], b, 0.2)
    with pytest.raises(ValueError, match="device"):
        tv_fused.fused_tv_gradmap(p.to("meta"), b.to("meta"), 0.2)


def _tv_data(h, w):
    inst = make_tv(h=h, w=w)
    return (inst["b"].astype(np.float32), inst["x0"].astype(np.float32),
            inst["mu"])


def _jax_run(b, p0, tau0, mu, **kw):
    out = jax_micro_tv(jnp.asarray(b), jnp.asarray(p0), tau0, mu,
                       interpret=True, **RECORD, **kw)
    names = ("x", "taus", "residuals", "k", "halt", "fvals", "backtracks",
             "objectives", "norm_residuals")
    return dict(zip(names, map(np.asarray, out)))


# (size, hp, accelerate, extra options): the prefix tests of
# tests/unit/test_microsolver_tv.py — adaptive plain f32, adaptive hp, FISTA
# hp, plain-f32 FISTA
PREFIX = {
    "adaptive": (64, False, False, {}),
    "adaptive_hp": (64, True, False, {}),
    "fista_hp": (64, True, True, dict(restart_dd=True)),
    "fista": (32, False, True, {}),
}


@pytest.mark.parametrize("case", list(PREFIX))
def test_solve_prefix_matches_jax_kernel_interpret(case):
    n, hp, accelerate, extra = PREFIX[case]
    b, p0, mu = _tv_data(n, n)
    K = 12
    kw = dict(max_iters=K, tol=0.0, hp=hp, accelerate=accelerate, **extra)
    j = _jax_run(b, p0, 2.0, mu, **kw)
    t = microsolve_tv(torch.from_numpy(b), torch.from_numpy(p0), 2.0, mu,
                      **RECORD, **kw)
    assert int(t.iteration_count) == int(j["k"]) == K
    assert int(t.halt) == int(j["halt"])
    np.testing.assert_array_equal(t.backtracks.numpy(),
                                  j["backtracks"].astype(np.int32))
    for name in ("taus", "residuals", "fvals", "objectives",
                 "norm_residuals"):
        np.testing.assert_allclose(getattr(t, name).numpy(), j[name],
                                   rtol=1e-4, err_msg=name)
    assert t.iterates is None and t.x.shape == (2, n, n)


def test_fista_hp_to_tolerance_matches_jax_kernel_interpret():
    """The JAX test's full FISTA run (hp, restart_dd, tol 1e-5): equal
    iteration count and status, and the float64 dual objective to 1e-6.
    The dual fields themselves part by up to 5e-4 over the 684 iterations
    (the order of float32 sums), where the objective is flat."""
    b, p0, mu = _tv_data(64, 64)
    kw = dict(max_iters=3000, tol=1e-5, hp=True, accelerate=True,
              restart_dd=True)
    j = _jax_run(b, p0, 2.0, mu, **kw)
    t = microsolve_tv(torch.from_numpy(b), torch.from_numpy(p0), 2.0, mu,
                      **kw)
    assert t.status == "converged" and int(j["halt"]) == 1
    assert int(t.iteration_count) == int(j["k"])
    np.testing.assert_allclose(_dual(b, mu, t.x.numpy()),
                               _dual(b, mu, j["x"]), rtol=1e-6)


def _dual(b, mu, p):
    """The float64 dual objective ½‖μ·div p − b‖²."""
    r = mu * np_tv_div(np.asarray(p, np.float64)) - b
    return 0.5 * np.sum(r * r)


@pytest.mark.parametrize("rule", list(ftt.STOP_RULES))
def test_stop_rules_match_jax_microsolve(rule):
    """Each of the five rules at 16x16 (hp, tol 1e-3, 300 iterations):
    the iteration count and status of the JAX kernel."""
    pj = jax_problems.build("tv", h=16, w=16, dtype=jnp.float32)
    pt = problems.build("tv", h=16, w=16, device="cpu")
    kw = dict(tau0=2.0, max_iters=300, tol=1e-3, stop_rule=rule, hp=True)
    rj = jax_microsolve(pj, **kw)
    rt = pt.microsolve(**kw)
    assert rt.iteration_count == rj.iteration_count
    assert rt.status == rj.status and rt.converged == rj.converged
    np.testing.assert_allclose(rt.taus[:10], rj.taus[:10], rtol=1e-4)


def test_nonfinite_tau0_aborts_early():
    b, p0, mu = _tv_data(24, 24)
    t = microsolve_tv(torch.from_numpy(b), torch.from_numpy(p0), math.nan,
                      mu, max_iters=500, tol=1e-5)
    j = _jax_run(b, p0, math.nan, mu, max_iters=500, tol=1e-5)
    assert t.status == "nonfinite" and int(j["halt"]) == 2
    assert int(t.iteration_count) <= 3


def test_objectives_prefix_match_jax_microsolve():
    """The prox-point objectives (g is the box indicator, so f at the
    prox point) over 15 iterations at 32x32."""
    pj = jax_problems.build("tv", h=32, w=32, dtype=jnp.float32)
    pt = problems.build("tv", h=32, w=32, device="cpu")
    kw = dict(tau0=2.0, max_iters=15, tol=0.0, stop_rule="iterations",
              record_objs=True)
    rj = jax_microsolve(pj, **kw)
    rt = pt.microsolve(**kw)
    np.testing.assert_allclose(rt.objectives, rj.objectives, rtol=1e-4)
    assert rt.best_index == rj.best_index


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("accelerate", [False, True])
def test_path_plain_version_matches_jax_path_kernel(warm, accelerate):
    """K-B6p's plain version against ``microsolve_tv_path`` (warm) and
    per-μ ``microsolve_tv`` launches (cold) at 16x16: equal statuses,
    equal counts in FISTA mode, and each point's float64 dual objective
    to 1e-6."""
    from fasta_tpu.kernels.microsolver_tv import \
        microsolve_tv_path as jax_path
    b, p0, _ = _tv_data(16, 16)
    mus = np.array([0.2, 0.1, 0.05], np.float32)
    kw = dict(max_iters=400, tol=1e-5, stop_rule="residual",
              accelerate=accelerate)
    t = microsolver_tv.microsolve_tv_path(torch.from_numpy(b),
                                          torch.from_numpy(p0), 2.0, mus,
                                          warm=warm, **kw)
    if warm:
        out = jax_path(jnp.asarray(b), jnp.asarray(p0), 2.0,
                       jnp.asarray(mus), interpret=True, **kw)
        jx, jk, jh = (np.asarray(out[0]), np.asarray(out[3]),
                      np.asarray(out[4]))
    else:
        outs = [_jax_run(b, p0, 2.0, float(mu), **kw) for mu in mus]
        jx = np.stack([o["x"] for o in outs])
        jk = np.array([int(o["k"]) for o in outs])
        jh = np.array([int(o["halt"]) for o in outs])
    np.testing.assert_array_equal(t.halt.numpy(), jh)
    if accelerate:
        np.testing.assert_array_equal(t.iteration_count.numpy(), jk)
    else:
        # the BB steps part late at this tolerance (217 against 261
        # iterations at μ = 0.2): held to tests/parity/test_parity.py's
        # band for knife-edge backtracking, max(5, 20%)
        drift = np.abs(t.iteration_count.numpy() - jk)
        assert (drift <= np.maximum(5, 0.2 * jk)).all(), (t.iteration_count,
                                                          jk)
    for i, mu in enumerate(mus):
        np.testing.assert_allclose(_dual(b, mu, t.x[i].numpy()),
                                   _dual(b, mu, jx[i]), rtol=1e-6)


def test_solve_wrappers_reject_what_they_do_not_take():
    b, p0, mu = _tv_data(8, 8)
    bt, pt = torch.from_numpy(b), torch.from_numpy(p0)
    with pytest.raises(ValueError, match=r"p0 \(2,H,W\)"):
        microsolve_tv(bt, pt[:, :4], 2.0, mu)
    with pytest.raises(ValueError, match="float32"):
        microsolve_tv(bt.double(), pt.double(), 2.0, mu)
    with pytest.raises(TypeError, match="record_its"):
        microsolve_tv(bt, pt, 2.0, mu, record_its=True)
    with pytest.raises(ValueError, match="1-D"):
        microsolver_tv.microsolve_tv_path(bt, pt, 2.0, [[0.1]])
    before = (microsolver_tv.LAUNCHES, microsolver_tv.PATH_LAUNCHES)
    microsolve_tv(bt, pt, 2.0, mu, max_iters=3)
    microsolver_tv.microsolve_tv_path(bt, pt, 2.0, [0.1, 0.2], max_iters=3)
    assert (microsolver_tv.LAUNCHES, microsolver_tv.PATH_LAUNCHES) == before


# --------------------------------------------------------------------------
# K-B6's band plan: which rows each block owns, and the route
# --------------------------------------------------------------------------

# an H100's grid and a block's dynamic shared-memory budget: the per-block
# opt-in (232448 bytes) less a few KB of the kernel's static shared memory
H100_BLOCKS, H100_BUDGET = 132, 232448 - 4096
PLAN_SHAPES = [(512, 512), (2048, 2048), (7, 300), (300, 5), (1, 5),
               (16, 16), (133, 3), (1024, 1024)]


@pytest.mark.parametrize("nblocks", [1, 8, H100_BLOCKS])
@pytest.mark.parametrize("h,w", PLAN_SHAPES)
def test_band_plan_owns_every_row_once(h, w, nblocks):
    plan = microsolver_tv.band_plan(h, w, nblocks, H100_BUDGET)
    assert len(plan.rows) == len(plan.above) == len(plan.below) == nblocks
    owned = [r for r0, r1 in plan.rows for r in range(r0, r1)]
    assert owned == list(range(h))           # each row once, in block order
    assert plan.band_rows == max(r1 - r0 for r0, r1 in plan.rows)
    assert plan.band_rows == -(-h // nblocks)
    # images shorter than the grid leave blocks without rows
    assert sum(r1 > r0 for r0, r1 in plan.rows) == min(h, nblocks)


@pytest.mark.parametrize("nblocks", [1, 8, H100_BLOCKS])
@pytest.mark.parametrize("h,w", PLAN_SHAPES)
def test_band_plan_halo_rows_are_the_neighbours_edge_rows(h, w, nblocks):
    """The row above a band is the last row of the block named above, the
    row below it the first row of the block named below; a band at the
    image's edge, or a block without rows, names none."""
    plan = microsolver_tv.band_plan(h, w, nblocks, H100_BUDGET)
    for (r0, r1), up, down in zip(plan.rows, plan.above, plan.below):
        if r0 == r1:
            assert up == down == -1
            continue
        if r0 == 0:
            assert up == -1
        else:
            assert plan.rows[up][1] == r0 and plan.rows[up][0] < r0
        if r1 == h:
            assert down == -1
        else:
            assert plan.rows[down][0] == r1 and plan.rows[down][1] > r1


def test_band_plan_routes_by_shape():
    """512×512 keeps its bands in shared memory (4 rows, 110 KB a block);
    2048×2048 (16 rows, 1.5 MB) and 1024×1024 take the global route; the
    gate is the widest band's state against the budget."""
    plan = microsolver_tv.band_plan(512, 512, H100_BLOCKS, H100_BUDGET)
    assert plan.resident and plan.band_rows == 4
    assert microsolver_tv.resident_bytes(4, 512) == 4 * (12 * 4 * 512 + 7 * 512)
    for side in (1024, 2048):
        assert not microsolver_tv.band_plan(side, side, H100_BLOCKS,
                                            H100_BUDGET).resident
    need = microsolver_tv.resident_bytes(4, 512)
    assert microsolver_tv.band_plan(512, 512, H100_BLOCKS, need).resident
    assert not microsolver_tv.band_plan(512, 512, H100_BLOCKS,
                                        need - 1).resident
    # a single very wide row does not fit; many narrow rows do
    assert not microsolver_tv.band_plan(1, 10 ** 5, H100_BLOCKS,
                                        H100_BUDGET).resident
    assert microsolver_tv.band_plan(10 ** 5, 3, H100_BLOCKS,
                                    H100_BUDGET).resident


def test_band_plan_rejects_what_it_does_not_take():
    for args in ((0, 5, 132, 1000), (5, 0, 132, 1000), (5, 5, 0, 1000),
                 (5, 5, 132, -1)):
        with pytest.raises(ValueError, match="band_plan"):
            microsolver_tv.band_plan(*args)


def test_batch_wrapper_rejects_what_it_does_not_take():
    b, p0, mu = _tv_data(8, 8)
    bt, pt = torch.from_numpy(b), torch.from_numpy(p0)
    bs = torch.stack([bt, bt])
    with pytest.raises(ValueError, match="leading batch axis"):
        microsolver_tv.microsolve_tv_batch(bt, pt, 2.0, mu)
    with pytest.raises(ValueError, match=r"p0 \(2,H,W\)"):
        microsolver_tv.microsolve_tv_batch(bs, pt[:, :4], 2.0, mu)
    with pytest.raises(ValueError, match="float32"):
        microsolver_tv.microsolve_tv_batch(bs.double(), pt.double(), 2.0, mu)
    before = (microsolver_tv.BATCH_LAUNCHES,
              microsolver_tv.BATCH_LAUNCHES_RESIDENT)
    out = microsolver_tv.microsolve_tv_batch(bs, pt, 2.0, mu, max_iters=3)
    assert out.x.shape == (2, 2, 8, 8)
    assert (microsolver_tv.BATCH_LAUNCHES,
            microsolver_tv.BATCH_LAUNCHES_RESIDENT) == before
