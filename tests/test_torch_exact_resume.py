"""Exact mid-run resume in the port (the counterpart of
``tests/unit/test_exact_resume.py``): 50 iterations → ``SolverState`` →
``checkpoint.save_pytree`` / ``load_pytree`` → ``resume_state`` to 100
equals the uninterrupted 100-iteration run BIT FOR BIT (solution, τ,
residual, f and backtrack series, counts) in the three modes in float64,
in float32 with hp, in lean mode and with the records continued; and row
sharded over four gloo ranks (``test_resume_bitwise_sharded``, and over
the layouts the reference leaves to GSPMD,
``test_resume_bitwise_gspmd_layouts``), each rank's state saved to a file
of its own.

Across packages, on the same seeded LASSO 48×80 float64 instance: a state
saved by ``fasta_tpu.make_stateful_solver`` resumes in the port, and a
state saved by the port resumes in ``fasta_tpu.resume_state``; each
matches the other package's uninterrupted run with equal iteration and
backtrack counts and τ, residual and f series within rtol 1e-10 (the
continuation rounds differently in the two packages).  A residual
‖Δx‖/τ that cancels to 1e-7 carries float64 rounding of ‖x‖/τ, about
1e-15, so each series also takes an absolute 1e-12 of its own scale.
Plain and FISTA mode go 50 → 100 iterations; adaptive mode converges in
20 to 28 iterations at this size and its BB stepsize past that is
rounding noise in either package, so it stops by the hybrid rule at
tol 1e-6 (20 iterations in both), from a state of 10.  The FISTA carry
has the same arity in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fasta_tpu as ft
import fasta_tpu_torch as ftt
import problems as jax_problems
from fasta_tpu_torch import checkpoint, convert, problems
from gloo_ranks import SERIES as RANK_SERIES
from gloo_ranks import Ranks

torch.set_num_threads(1)

MODES = {
    "plain": dict(adaptive=False, accelerate=False),
    "adaptive": dict(adaptive=True, accelerate=False),
    "accelerated": dict(accelerate=True),
}
SERIES = ("taus", "residuals", "fvals", "backtracks")


def _args(dtype=torch.float64, name="lasso", **kw):
    kw = kw or dict(m=48, n=80, k=6)
    p = problems.build(name, dtype=dtype, device="cpu", **kw)
    return p.op, p.fterm, p.gterm, p.x0, 0.05


def _jax_args(name="lasso", **kw):
    kw = kw or dict(m=48, n=80, k=6)
    p = jax_problems.build(name, dtype=jnp.float64, **kw)
    return (p.op, p.fterm, p.gterm, jnp.asarray(p.x0, jnp.float64),
            jnp.asarray(0.05, jnp.float64))


def _opts(n, **kw):
    return ftt.FastaOptions(max_iters=n, stop_rule="iterations", **kw)


def _assert_bitwise(r_resumed, r_full):
    for name in ("solution",) + SERIES:
        assert torch.equal(getattr(r_resumed, name), getattr(r_full, name)), \
            name
    assert r_resumed.iteration_count == r_full.iteration_count
    assert r_resumed.total_backtracks == r_full.total_backtracks


def _saved_and_loaded(state, path):
    checkpoint.save_pytree(state, str(path))
    return checkpoint.load_pytree(state, str(path))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_resume_bitwise_equals_uninterrupted(mode, tmp_path):
    kw = MODES[mode]
    args = _args()
    _, s50 = ftt.make_stateful_solver(_opts(50, **kw))(*args)
    assert s50.k.dtype == torch.int32 and int(s50.k) == 50
    assert s50.stop.dtype == torch.bool and s50.stop.ndim == 0
    loaded = _saved_and_loaded(s50, tmp_path / f"state_{mode}.npz")
    r_resumed, s100 = ftt.resume_state(*args[:3], loaded, _opts(100, **kw))
    r_full, _ = ftt.make_stateful_solver(_opts(100, **kw))(*args)
    _assert_bitwise(r_resumed, r_full)
    assert int(s100.k) == 100


def test_resume_bitwise_f32_hp(tmp_path):
    """The hp carry — a float64 window and float64 decision scalars, the
    L1 trial through kernel K-B4's plain version — survives the round
    trip bit for bit too."""
    args = _args(torch.float32)
    _, s40 = ftt.make_stateful_solver(_opts(40))(*args)
    assert s40.fwin.dtype == torch.float64 and s40.x1.dtype == torch.float32
    loaded = _saved_and_loaded(s40, tmp_path / "hp.npz")
    r_resumed, _ = ftt.resume_state(*args[:3], loaded, _opts(80))
    r_full, _ = ftt.make_stateful_solver(_opts(80))(*args)
    _assert_bitwise(r_resumed, r_full)


def test_resume_converged_state_is_noop():
    args = _args()
    opts = ftt.FastaOptions(max_iters=500, tol=1e-10)
    r1, s1 = ftt.make_stateful_solver(opts)(*args)
    assert r1.converged and bool(s1.stop)
    r2, s2 = ftt.resume_state(*args[:3], s1, opts)
    assert r2.iteration_count == r1.iteration_count and r2.converged
    assert torch.equal(r2.solution, r1.solution)
    assert int(s2.k) == int(s1.k)


def test_resume_rejects_short_budget_and_mismatched_recording():
    args = _args()
    _, s50 = ftt.make_stateful_solver(_opts(50))(*args)
    with pytest.raises(ValueError, match="TOTAL budget"):
        ftt.resume_state(*args[:3], s50, _opts(20))
    with pytest.raises(ValueError, match="record_objective"):
        ftt.resume_state(*args[:3], s50, _opts(100, record_objective=True))
    with pytest.raises(ValueError, match="FISTA carry"):
        ftt.resume_state(*args[:3], s50, _opts(100, accelerate=True))


def test_resume_bitwise_lean_mode(tmp_path):
    args = _args()
    lean = dict(record_diagnostics=False)
    _, s30 = ftt.make_stateful_solver(_opts(30, **lean))(*args)
    loaded = _saved_and_loaded(s30, tmp_path / "lean.npz")
    r2, _ = ftt.resume_state(*args[:3], loaded, _opts(60, **lean))
    rf, _ = ftt.make_stateful_solver(_opts(60, **lean))(*args)
    assert torch.equal(r2.solution, rf.solution)
    assert r2.taus is None and r2.iteration_count == 60


def test_resume_continues_recorded_diagnostics():
    args = _args()
    rec = dict(record_objective=True)
    r30, s30 = ftt.make_stateful_solver(_opts(30, **rec))(*args)
    r60, _ = ftt.resume_state(*args[:3], s30, _opts(60, **rec))
    assert torch.equal(r60.objectives[:30], r30.objectives)
    assert torch.all(r60.objectives[30:] != 0.0)


def test_resume_leaves_the_state_as_it_was():
    """The loop writes the window and the records in place; a resume
    works on copies, so one state resumes twice to the same bits."""
    args = _args()
    _, s20 = ftt.make_stateful_solver(_opts(20))(*args)
    before = convert.solver_state_to_arrays(s20)
    r1, _ = ftt.resume_state(*args[:3], s20, _opts(40))
    r2, _ = ftt.resume_state(*args[:3], s20, _opts(40))
    _assert_bitwise(r1, r2)
    after = convert.solver_state_to_arrays(s20)
    np.testing.assert_array_equal(after["fwin"], before["fwin"])
    np.testing.assert_array_equal(after["diags"]["taus"],
                                  before["diags"]["taus"])


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(4, shapes=((2, 2),))
    yield r
    r.close()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_resume_bitwise_sharded(ranks, dtype, tmp_path):
    """The port of ``test_resume_bitwise_sharded``: LASSO 64×48 row-sharded
    over four gloo ranks, 30 iterations, each rank's ``SolverState``
    (its FISTA carry holds the rank's 16 rows of A x) through its own
    ``.npz``, ``resume_state`` to 60: on every rank, in the three modes,
    the uninterrupted run's bits; and the same bits on every rank."""
    outs = ranks.run("resume", str(tmp_path), dtype)
    assert len(list(tmp_path.glob("state_*.npz"))) == 4 * len(MODES)
    for mode in MODES:
        for out in outs:
            got, full = out[mode]["resumed"], out[mode]["full"]
            for key in RANK_SERIES:
                np.testing.assert_array_equal(got[key], full[key])
            assert got["iteration_count"] == full["iteration_count"] == 60
            assert got["total_backtracks"] == full["total_backtracks"]
            assert out[mode]["k"] == 60
            assert out[mode]["d_rows"] == (None if mode != "accelerated"
                                           else (16,))
            for key in RANK_SERIES:
                np.testing.assert_array_equal(got[key],
                                              outs[0][mode]["resumed"][key])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("layout", ["grid", "tv"])
def test_resume_bitwise_x_sharded(ranks, layout, dtype, tmp_path):
    """Exact resume where x itself is split: LASSO 64×48 on a 2×2 mesh
    (x's 24-entry block a rank, the iteration's sums over x completed by
    the operator's hook) and TV 16×16 over four ranks (p's (2, 4, 16)
    rows a rank, a halo exchange a map), 30 iterations, each rank's state
    through its own file, ``resume_state`` to 60: the uninterrupted run's
    bits on every rank in the three modes, and every rank's series the
    same."""
    name, shape, block = (("lasso", (2, 2), (24,)) if layout == "grid"
                          else ("tv", None, (2, 4, 16)))
    outs = ranks.run("resume_x", str(tmp_path), dtype, name, shape=shape)
    assert len(list(tmp_path.glob("state_*.npz"))) == 4 * len(MODES)
    for mode in MODES:
        for out in outs:
            got, full = out[mode]["resumed"], out[mode]["full"]
            for key in RANK_SERIES:
                np.testing.assert_array_equal(got[key], full[key])
            assert got["iteration_count"] == full["iteration_count"] == 60
            assert got["total_backtracks"] == full["total_backtracks"]
            assert out[mode]["k"] == 60
            assert out[mode]["x_block"] == block
            for key in ("taus", "residuals", "fvals", "backtracks"):
                np.testing.assert_array_equal(got[key],
                                              outs[0][mode]["resumed"][key])


# layout: (gloo_ranks.gspmd_problem spec, the operator class it places)
GSPMD_RESUME = {
    "bf16": (dict(name="lasso", build=dict(m=64, n=48, k=6,
                                           dtype="float32"),
                  tau0=0.05, variant="bf16"), "RowShardedLowPrecDenseOp"),
    "identity": (dict(name="matrix_completion",
                      build=dict(d1=64, d2=32, rank=2, dtype="float64"),
                      tau0=1.7), "RowShardedIdentityOp"),
}


@pytest.mark.parametrize("layout", sorted(GSPMD_RESUME))
def test_resume_bitwise_gspmd_layouts(ranks, layout, tmp_path):
    """Exact resume over the layouts the reference leaves to GSPMD: the
    bfloat16 LASSO 64×48 over rows (the two-call pass a rank, one
    all-reduce a map) and matrix completion 64×32 over the identity's
    rows, 20 iterations, each rank's state through its own file,
    ``resume_state`` to 40: the uninterrupted run's bits on every rank in
    the three modes, and every rank's series the same."""
    spec, cls = GSPMD_RESUME[layout]
    outs = ranks.run("resume_gspmd", str(tmp_path), spec)
    assert len(list(tmp_path.glob("state_*.npz"))) == 4 * len(MODES)
    for mode in MODES:
        for out in outs:
            got, full = out[mode]["resumed"], out[mode]["full"]
            assert out[mode]["op"] == cls
            for key in RANK_SERIES:
                np.testing.assert_array_equal(got[key], full[key])
            assert got["iteration_count"] == full["iteration_count"] == 40
            assert got["total_backtracks"] == full["total_backtracks"]
            assert out[mode]["k"] == 40
            for key in RANK_SERIES:
                np.testing.assert_array_equal(got[key],
                                              outs[0][mode]["resumed"][key])


# --------------------------------------------------------------------------
# across packages
# --------------------------------------------------------------------------

# mode -> (its options, the state's iterations, the total budget)
ACROSS = {
    "plain": (dict(MODES["plain"], stop_rule="iterations"), 50, 100),
    "adaptive": (dict(MODES["adaptive"], tol=1e-6), 10, 100),
    "accelerated": (dict(MODES["accelerated"], stop_rule="iterations"),
                    50, 100),
}


def _hold_against(r, ref):
    """A run against the other package's: equal counts, τ, residual and f
    series within rtol 1e-10 (and 1e-12 of the series' scale)."""
    assert int(r.iteration_count) == int(ref.iteration_count)
    assert int(r.total_backtracks) == int(ref.total_backtracks)
    np.testing.assert_array_equal(np.asarray(r.backtracks),
                                  np.asarray(ref.backtracks))
    for name in ("taus", "residuals", "fvals"):
        want = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(np.asarray(getattr(r, name)), want,
                                   rtol=1e-10,
                                   atol=1e-12 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("route", ["arrays", "file"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_jax_state_resumes_in_the_port(mode, route, tmp_path):
    kw, k0, total = ACROSS[mode]
    jargs = _jax_args()
    _, js = ft.make_stateful_solver(ft.FastaOptions(max_iters=k0,
                                                    **kw))(*jargs)
    path = str(tmp_path / "jax_state.npz")
    ft.checkpoint.save_pytree(js, path)
    args = _args()
    if route == "arrays":
        # no port run: the JAX state's leaves as NumPy arrays
        loaded = ft.checkpoint.load_pytree(js, path)
        state = convert.solver_state_from_arrays(
            jax.tree_util.tree_map(np.asarray, loaded), device="cpu")
    else:
        # the file read into a port state of the same options
        _, example = ftt.make_stateful_solver(
            ftt.FastaOptions(max_iters=1, **kw))(*args)
        state = checkpoint.load_pytree(example, path)
    assert int(state.k) == k0 and not bool(state.stop)
    r, s = ftt.resume_state(*args[:3], state,
                            ftt.FastaOptions(max_iters=total, **kw))
    jr_full = ft.make_solver(ft.FastaOptions(max_iters=total, **kw))(*jargs)
    _hold_against(r, jr_full)
    # the first records are the JAX run's own
    np.testing.assert_array_equal(r.taus[:k0].numpy(),
                                  np.asarray(js.diags.taus))
    assert int(s.k) == r.iteration_count


@pytest.mark.parametrize("route", ["file", "arrays"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_port_state_resumes_in_jax(mode, route, tmp_path):
    kw, k0, total = ACROSS[mode]
    args = _args()
    _, s = ftt.make_stateful_solver(ftt.FastaOptions(max_iters=k0,
                                                     **kw))(*args)
    jargs = _jax_args()
    if route == "file":
        path = str(tmp_path / "port_state.npz")
        checkpoint.save_pytree(s, path)
        _, example = ft.make_stateful_solver(ft.FastaOptions(
            max_iters=1, **kw))(*jargs)
        jstate = ft.checkpoint.load_pytree(example, path)
    else:
        d = convert.solver_state_to_arrays(s)
        jstate = ft.SolverState(**{**d, "diags": ft.Diagnostics(
            **d["diags"])})
    jr, _ = ft.resume_state(*jargs[:3], jstate,
                            ft.FastaOptions(max_iters=total, **kw))
    r_full = ftt.make_solver(ftt.FastaOptions(max_iters=total, **kw))(*args)
    _hold_against(jr, r_full)


@pytest.mark.parametrize("name, fuses", [("lasso", True),
                                         ("logistic", False)])
def test_fista_carry_arity_is_the_same_in_both(name, fuses):
    """(x, A x, Aᴴ∇f, α) where the one-pass gradient map serves an affine
    loss (least squares over a dense matrix), (x, A x, α) elsewhere."""
    size = dict(m=48, n=80, k=6) if name == "lasso" else dict(m=60, n=30, k=4)
    _, s = ftt.make_stateful_solver(_opts(3, **MODES["accelerated"]))(
        *_args(name=name, **size))
    _, js = ft.make_stateful_solver(ft.FastaOptions(
        max_iters=3, stop_rule="iterations", **MODES["accelerated"]))(
        *_jax_args(name=name, **size))
    assert len(s.accel) == len(js.accel) == (4 if fuses else 3)
    for a, ja in zip(s.accel, js.accel):
        assert tuple(a.shape) == tuple(np.shape(ja))
