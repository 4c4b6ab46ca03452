"""The port's layouts that shard x itself (``fasta_tpu_torch.sharding``):
the TV dual split over image rows (``RowShardedTVDivOp``, its halo
exchange and K-B5's band form) and the 2-D rows×cols meshes
(``GridShardedDenseOp``, ``GridShardedSparseOp``,
``GridShardedPlanarDenseOp``, ``shard_problem_2d``), with the solver's
x-space hook, on eight gloo ranks on the CPU: the counterpart of
``tests/sharded/test_sharded.py::test_sharded_tv_stencil``,
``test_sharded_breadth.py:117-360`` and ``test_collectives.py:85-195``.

The ranks are spawned once for the module (``gloo_ranks.Ranks``) with a
1-D mesh of 8 and a 2×4 mesh over the same world, as the JAX suite's 8
virtual devices make ``make_mesh()`` and ``make_mesh_2d(2, 4)``.  Each
solve is held against ``fasta_tpu.sharding`` on those devices, against
``fasta_tpu`` on one device and against the port's unsharded solve, at
the JAX suite's bars: the same iteration count, τ rtol 1e-6, residuals
rtol 1e-6 / atol 1e-12, the solution atol 1e-8 (LASSO, sparse,
democratic over 60 iterations), 1e-7 (planar, 40 iterations) or 1e-9
(TV).  Every rank's series are the same bit for bit, and ranks that hold
the same block of x hold the same bits.  The reduction order differs from
one device's, which the tolerances are for; the TV legs and the band-form
map's d and g are bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import fasta_tpu as ft
import fasta_tpu_torch as ftt
import problems as jax_problems
from fasta_tpu import sharding as jsh
from fasta_tpu.operators import ScaledOp as JScaledOp
from fasta_tpu.operators import TVDiv2D as JTVDiv2D
from fasta_tpu_torch import convert, problems
from fasta_tpu_torch import sharding as sh
from fasta_tpu_torch.kernels import tv_fused
from fasta_tpu_torch.operators import ScaledOp, TVDiv2D
from gloo_ranks import SERIES, Ranks, host_result
from jax.sharding import PartitionSpec as P

torch.set_num_threads(1)

WORLD = 8
GRID = (2, 4)
FISTA = dict(accelerate=True, adaptive=False)

# name: (problem, build keywords, τ₀, solve keywords, mesh shape) at the
# JAX suite's sizes; tol 1e-9 and 120 iterations unless it says
CASES = {
    "tv": ("tv", dict(h=64, w=64, dtype="float64"), 2.0,
           dict(tol=1e-6, max_iters=60), (WORLD,)),
    "tv_fista": ("tv", dict(h=64, w=64, dtype="float64"), 2.0,
                 dict(tol=1e-6, max_iters=60, **FISTA), (WORLD,)),
    "lasso": ("lasso", dict(m=160, n=64, k=8, dtype="float64"), 0.05, {},
              GRID),
    "democratic": ("democratic", dict(m=64, n=256, dtype="float64"), 0.05,
                   dict(max_iters=60), GRID),
    "sparse": ("sparse_lasso",
               dict(m=320, n=160, density=0.05, k=10, dtype="float64"), 0.05,
               {}, GRID),
    "planar": ("phase_retrieval",
               dict(m=64, n=64, planar=True, dtype="float64"), 1.0,
               dict(max_iters=40), GRID),
}


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(WORLD, shapes=(GRID,))
    yield r
    r.close()


def _solve_kw(case, **extra):
    kw = dict(tol=1e-9, max_iters=120)
    kw.update(CASES[case][3])
    kw.update(extra)
    return kw


@functools.lru_cache(maxsize=None)
def _jax(case: str, sharded: bool, explicit: bool = True) -> dict:
    """``fasta_tpu``'s solve of the case, on one device or on the 8
    virtual devices (TV: ``shard_problem``; the others:
    ``shard_problem_2d`` on the 2×4 mesh)."""
    name, build_kw, tau0, _, shape = CASES[case]
    kw = dict(build_kw, dtype=getattr(jnp, build_kw["dtype"]))
    prob = jax_problems.build(name, **kw)
    prob.tau0 = tau0
    if sharded and len(shape) == 1:
        prob = jsh.shard_problem(prob, jsh.make_mesh(), explicit=explicit)
    elif sharded:
        prob = jsh.shard_problem_2d(prob, jsh.make_mesh_2d(*shape))
    r = prob.solve(**_solve_kw(case))
    return {k: np.asarray(getattr(r, k)) for k in SERIES
            + ("iteration_count",)}


@functools.lru_cache(maxsize=None)
def _port_single(case: str) -> dict:
    name, build_kw, tau0, _, _ = CASES[case]
    kw = dict(build_kw, dtype=getattr(torch, build_kw["dtype"]),
              device="cpu")
    return host_result(problems.build(name, **kw).solve(tau0=tau0,
                                                          **_solve_kw(case)))


def _whole_x(outs, shape, key="solution"):
    """The whole x from the ranks' blocks: p's rows over the 1-D mesh;
    over a 2-D mesh the blocks of the first row of ranks (leading axis),
    which every other row of ranks holds bit for bit."""
    blocks = [out[key] for out in outs]
    if len(shape) == 1:
        return np.concatenate(blocks, axis=1)
    rows, cols = shape
    for r in range(1, rows):
        for c in range(cols):
            assert np.array_equal(blocks[r * cols + c], blocks[c]), (r, c)
    return np.concatenate(blocks[:cols], axis=0)


def _sharded(ranks, case: str, explicit: bool = True, **extra) -> dict:
    """The case on the ranks; every rank's series the same bit for bit,
    the solution gathered."""
    name, build_kw, tau0, _, shape = CASES[case]
    outs = ranks.run("solve", name, build_kw, tau0,
                     dict(_solve_kw(case, **extra), explicit=explicit),
                     shape=shape)
    for r, out in enumerate(outs[1:], start=1):
        for key in ("taus", "residuals", "fvals", "backtracks",
                    "iteration_count", "total_backtracks"):
            assert np.array_equal(out[key], outs[0][key]), (r, key)
        assert out["counts"] == outs[0]["counts"]
    got = dict(outs[0])
    got["solution"] = _whole_x(outs, shape)
    return got


def _hold(got, ref, taus=None, res=None, sol=None):
    """``got`` against ``ref`` at the JAX suite's bars for the case."""
    k = int(ref["iteration_count"])
    assert int(got["iteration_count"]) == k
    if taus is not None:
        np.testing.assert_allclose(got["taus"][:k], ref["taus"][:k],
                                   rtol=taus)
    if res is not None:
        np.testing.assert_allclose(got["residuals"][:k],
                                   ref["residuals"][:k], rtol=res,
                                   atol=1e-12)
    if sol is not None:
        np.testing.assert_allclose(got["solution"], ref["solution"],
                                   atol=sol)


def _hold_all(ranks, case, explicit=True, **bars):
    """The port's sharded solve against fasta_tpu sharded and unsharded
    and the port's unsharded solve."""
    got = _sharded(ranks, case, explicit)
    for ref in (_jax(case, True, explicit), _jax(case, False),
                _port_single(case)):
        _hold(got, ref, **bars)
    return got


# ------------------------------------------------------- the module API --

def test_the_reference_sharding_surface_is_ported():
    """Every name of ``fasta_tpu.sharding.__all__`` is in the port's."""
    assert set(jsh.__all__) <= set(sh.__all__)


# ----------------------------------------------------- test_sharded.py --

@pytest.mark.parametrize("explicit", [False, True])
def test_sharded_tv_stencil(ranks, explicit):
    """The TV dual with b and p split over image rows against the
    single-device runs (the port builds the halo operator either way: it
    has no partitioner)."""
    name, build_kw, tau0, _, _ = CASES["tv"]
    outs = ranks.run("solve", name, build_kw, tau0,
                     dict(_solve_kw("tv"), explicit=explicit))
    assert outs[0]["op"] == "RowShardedTVDivOp"
    got = dict(outs[0], solution=_whole_x(outs, (WORLD,)))
    for ref in (_jax("tv", True, explicit), _jax("tv", False),
                _port_single("tv")):
        _hold(got, ref, sol=1e-9)


# --------------------------------------------- test_sharded_breadth.py --

@pytest.mark.parametrize("hw", [(64, 32), (80, 24), (8, 200)])
def test_row_sharded_tv_op_bitmatch(ranks, hw):
    """Both halo-exchange legs equal the unsharded ``ScaledOp(TVDiv2D)``
    bit for bit — the JAX package's, the JAX sharded operator's and the
    port's; (8, 200) gives each rank one image row, so every vertical
    difference crosses ranks.  The adjoint check passes at 1e-10, and
    each leg makes one halo exchange and no all-reduce."""
    rng = np.random.default_rng(5)
    mu = 0.1
    p = rng.standard_normal((2,) + hw)
    y = rng.standard_normal(hw)
    ref = JScaledOp(mu, JTVDiv2D())
    jop = jsh.RowShardedTVDivOp(mu, jsh.make_mesh())
    outs = ranks.run("op_x", convert.sharded_op_arrays(jop), p, y)
    d = np.concatenate([o["d"] for o in outs])
    g = np.concatenate([o["g"] for o in outs], axis=1)
    port = ScaledOp(mu, TVDiv2D())
    for want_d, want_g in ((ref(jnp.asarray(p)), ref.rmatvec(jnp.asarray(y))),
                           (jop(jnp.asarray(p)), jop.rmatvec(jnp.asarray(y))),
                           (port(torch.as_tensor(p)),
                            port.rmatvec(torch.as_tensor(y)))):
        np.testing.assert_array_equal(d, np.asarray(want_d))
        np.testing.assert_array_equal(g, np.asarray(want_g))
    for out in outs:
        assert out["op"] == "RowShardedTVDivOp" and out["err"] <= 1e-10
        assert out["counts"] == {"halo": 2}


def test_sharded_tv_fused_gradmap_matches_lazy(ranks):
    """The fused map (one halo exchange, K-B5's band form, one all-reduce
    of f): d and g the unsharded composition's bit for bit, and the JAX
    sharded map's; f within rtol 1e-12 (the reduction order)."""
    rng = np.random.default_rng(7)
    mu = 0.1
    p = rng.standard_normal((2, 64, 32))
    b = rng.standard_normal((64, 32))
    outs = ranks.run("tv_map", p, b, mu)
    d = np.concatenate([o["d"] for o in outs])
    g = np.concatenate([o["g"] for o in outs], axis=1)
    ref = JScaledOp(mu, JTVDiv2D())
    d0 = ref(jnp.asarray(p))
    r0 = d0 - jnp.asarray(b)
    np.testing.assert_array_equal(d, np.asarray(d0))
    np.testing.assert_array_equal(g, np.asarray(ref.rmatvec(r0)))
    mesh = jsh.make_mesh()
    jd, jf, jg = jsh.sharded_tv_lstsq_gradmap(
        jsh.RowShardedTVDivOp(mu, mesh), jsh.shard_rows(jnp.asarray(b),
                                                        mesh))(jnp.asarray(p))
    np.testing.assert_array_equal(d, np.asarray(jd))
    np.testing.assert_array_equal(g, np.asarray(jg))
    for out in outs:
        np.testing.assert_allclose(out["f"], 0.5 * float(jnp.vdot(r0, r0)),
                                   rtol=1e-12)
        np.testing.assert_allclose(out["f"], float(jf), rtol=1e-12)
        assert out["f"] == outs[0]["f"]
        assert out["counts"] == {"halo": 1, "all_reduce": 1}


@pytest.mark.parametrize("case", ["tv", "tv_fista"],
                         ids=["adaptive", "fista"])
def test_sharded_tv_dual_scalar_sequence_identity(ranks, case):
    """The dual field itself split over image rows replays the
    single-device run."""
    got = _hold_all(ranks, case, taus=1e-6, res=1e-6, sol=1e-9)
    assert got["op"] == "RowShardedTVDivOp"
    assert got["name"] == f"tv[64x64]@{WORLD}dev"


def test_sharded_tv_indivisible_raises(ranks):
    prob = jax_problems.build("tv", h=36, w=36, dtype=jnp.float64)
    with pytest.raises(ValueError):
        jsh.shard_problem(prob, jsh.make_mesh())
    for kind, msg in ranks.run("raises", "tv",
                               dict(h=36, w=36, dtype="float64")):
        assert kind == "ValueError" and "H divisible" in msg


def test_mesh2d_construction(ranks):
    """The 2×4 mesh: rank r at row r // 4, column r % 4; the group of axis
    "rows" holds the ranks that differ in their row index (the ranks the
    reference's psum over "rows" sums), that of "cols" those of one mesh
    row."""
    assert dict(jsh.make_mesh_2d(2, 4).shape) == {"rows": 2, "cols": 4}
    meshes = ranks.run("mesh", shape=GRID)
    for r, m in enumerate(meshes):
        assert m["names"] == ("rows", "cols") and m["shape"] == GRID
        assert m["index"] == {"rows": r // 4, "cols": r % 4}
        assert m["groups"]["rows"] == [r % 4, r % 4 + 4]
        assert m["groups"]["cols"] == list(range(4 * (r // 4),
                                                 4 * (r // 4) + 4))


def _grid_outputs(ranks, arrays, x, y):
    """The grid operator on the ranks: d gathered over the mesh rows (the
    ranks of a row hold the same block bit for bit), g over the columns."""
    outs = ranks.run("op_x", arrays, x, y, shape=GRID)
    rows, cols = GRID
    for r, out in enumerate(outs):
        assert np.array_equal(out["d"], outs[(r // cols) * cols]["d"])
        assert out["err"] <= 1e-10
        assert out["counts"] == {"all_reduce": 2}
    d = np.concatenate([outs[i * cols]["d"] for i in range(rows)])
    return outs, d, _whole_x(outs, GRID, "g")


def test_grid_sharded_op_matches_dense(ranks):
    mesh = jsh.make_mesh_2d(2, 4)
    rng = np.random.default_rng(3)
    A_np = rng.standard_normal((64, 32))
    A = jax.device_put(jnp.asarray(A_np),
                       jax.sharding.NamedSharding(mesh, P("rows", "cols")))
    op = jsh.GridShardedDenseOp(A, mesh)
    x, y = rng.standard_normal(32), rng.standard_normal(64)
    ft.check_adjoint(op, jnp.asarray(x), jax.random.PRNGKey(4), rtol=1e-10)
    outs, d, g = _grid_outputs(ranks, convert.sharded_op_arrays(op), x, y)
    assert outs[0]["op"] == "GridShardedDenseOp"
    assert outs[0]["shape"] == (64, 32)
    np.testing.assert_allclose(d, A_np @ x, atol=1e-12)
    np.testing.assert_allclose(g, A_np.T @ y, atol=1e-12)
    np.testing.assert_allclose(d, np.asarray(op(jnp.asarray(x))),
                               atol=1e-12)


def test_sparse_2d_mesh_op_matches_bcoo(ranks):
    prob = jax_problems.build("sparse_lasso", m=320, n=160, density=0.05,
                              k=10, dtype=jnp.float64)
    sop = jsh.shard_problem_2d(prob, jsh.make_mesh_2d(2, 4)).op
    rng = np.random.default_rng(3)
    x, y = rng.standard_normal(160), rng.standard_normal(320)
    A = prob.instance["A_sparse"].toarray()
    outs, d, g = _grid_outputs(ranks, convert.sharded_op_arrays(sop), x, y)
    assert outs[0]["op"] == "GridShardedSparseOp"
    np.testing.assert_allclose(d, A @ x, atol=1e-12)
    np.testing.assert_allclose(g, A.T @ y, atol=1e-12)


def test_grid_sharded_planar_op_matches_dense(ranks):
    mesh = jsh.make_mesh_2d(2, 4)
    rng = np.random.default_rng(7)
    Ar = rng.standard_normal((64, 32))
    Ai = rng.standard_normal((64, 32))
    spec = jax.sharding.NamedSharding(mesh, P("rows", "cols"))
    op = jsh.GridShardedPlanarDenseOp(jax.device_put(jnp.asarray(Ar), spec),
                                      jax.device_put(jnp.asarray(Ai), spec),
                                      mesh)
    dense = ft.PlanarDenseOp(jnp.asarray(Ar), jnp.asarray(Ai))
    x = rng.standard_normal((32, 2))
    y = rng.standard_normal((64, 2))
    outs, d, g = _grid_outputs(ranks, convert.sharded_op_arrays(op), x, y)
    assert outs[0]["op"] == "GridShardedPlanarDenseOp"
    np.testing.assert_allclose(d, np.asarray(dense(jnp.asarray(x))),
                               atol=1e-12)
    np.testing.assert_allclose(g, np.asarray(dense.rmatvec(jnp.asarray(y))),
                               atol=1e-12)


@pytest.mark.parametrize("case", ["lasso", "democratic"])
def test_2d_mesh_scalar_sequence_identity(ranks, case):
    """x split over cols on the 2×4 mesh replays the single-device run;
    democratic is SURVEY.md:126's wide case (n ≫ m), its L∞ prox over the
    gathered x."""
    got = _hold_all(ranks, case, taus=1e-6, res=1e-6, sol=1e-8)
    assert got["op"] == "GridShardedDenseOp"


def test_sparse_2d_mesh_scalar_sequence_identity(ranks):
    got = _hold_all(ranks, "sparse", taus=1e-6, sol=1e-8)
    assert got["op"] == "GridShardedSparseOp"


def test_2d_mesh_planar_scalar_sequence_identity(ranks):
    got = _hold_all(ranks, "planar", taus=1e-6, res=1e-6, sol=1e-7)
    assert got["op"] == "GridShardedPlanarDenseOp"


def test_2d_placement_specs(ranks):
    """In place of the JAX ``sharding.spec`` checks: A's grid block, b's
    rows, x0's block over cols, on the rank's device."""
    blocks = ranks.run("blocks_x", "democratic",
                       dict(m=64, n=256, dtype="float64"), shape=GRID)
    for b in blocks:
        assert b["op"] == "GridShardedDenseOp"
        assert b["blocks"] == {"A": ((32, 64), True)}
        assert b["b"] == (32,) and b["b_rows"]
        assert b["x0"] == (64,) and b["x0_block"]
        assert b["fterm"] == "RowShardedSmooth"
        assert b["gterm"] == "SignalShardedProx"
        assert b["shape"] == (64, 256) and b["devices"] == {"cpu"}
        assert b["name"] == "democratic[64x256]@2x4dev"


def test_2d_planar_placement_specs(ranks):
    """Planar: both channels' grid blocks, the magnitudes' rows, x0 and the
    anchor c split on their signal axis (not the channel axis)."""
    blocks = ranks.run("blocks_x", "phase_retrieval",
                       dict(m=64, n=64, planar=True, dtype="float64"),
                       shape=GRID)
    for b in blocks:
        assert b["blocks"] == {"Ar": ((32, 16), True), "Ai": ((32, 16), True)}
        assert b["b"] == (32,) and b["b_rows"]
        assert b["x0"] == (16, 2) and b["x0_block"]
        assert b["anchors"] == {"c": ((16, 2), True)}


def test_tv_placement(ranks):
    """TV: p's rows (2, H/8, W), b's rows, and the next rank's first row of
    b on every rank but the last."""
    blocks = ranks.run("blocks_x", "tv", dict(h=64, w=64, dtype="float64"))
    for r, b in enumerate(blocks):
        assert b["op"] == "RowShardedTVDivOp"
        assert b["x0"] == (2, 8, 64) and b["x0_block"]
        assert b["b"] == (8, 64) and b["b_rows"]
        assert b["b_below"] == (None if r == WORLD - 1 else (64,))
        assert b["gterm"] == "SignalShardedProx"


def test_2d_mesh_indivisible_raises(ranks):
    prob = jax_problems.build("lasso", m=100, n=30, k=5, dtype=jnp.float64)
    with pytest.raises(ValueError):
        jsh.shard_problem_2d(prob, jsh.make_mesh_2d(2, 4))
    for kind, msg in ranks.run("raises", "lasso",
                               dict(m=100, n=30, k=5, dtype="float64"),
                               shape=GRID):
        assert kind == "ValueError" and "not divisible by mesh 2x4" in msg
    for kind, msg in ranks.run("raises", "tv",
                               dict(h=16, w=16, dtype="float64"),
                               shape=GRID):
        assert kind == "TypeError" and "ScaledOp" in msg


# ------------------------------------------------ test_collectives.py --

# (case, extra solve keywords, all-reduces: (set-up, per trial, per
# iteration), other kinds per trial, the reason).  A 2-D gradient map is
# two all-reduces (d over cols, (f, g) over rows); the set-up makes three
# (A x0 over cols, f(A x0) over rows, the first gradient over rows).  Each
# trial adds one x-space all-reduce (its ‖Δx‖² and ⟨Δx,g⟩, or K-B4's three
# sums), each iteration one more (the normalizer, the BB pair or the
# restart dot, the objective's g): two x-space all-reduces an adaptive
# iteration without backtracking, as the reference's two col-axis scalar
# psums.  FISTA adds f at the extrapolated point, and the hinge the
# gradient there.  TV: a map is one halo exchange and one all-reduce of f;
# the set-up one all-reduce (f(A x0)) and two exchanges (A x0, the first
# gradient); FISTA's extrapolated f one all-reduce more.
BUDGETS = {
    "2d lasso": ("lasso", {}, (3, 3, 1), {},
                 "adaptive: 2 a map + 1 x-space a trial, 1 an iteration"),
    "2d lasso objective": ("lasso", dict(record_objective=True), (3, 3, 1),
                           {}, "the objective's g rides the iteration's "
                               "one x-space all-reduce"),
    "2d lasso fista": ("lasso", FISTA, (3, 3, 2), {},
                       "FISTA: the restart dot, f at the extrapolated "
                       "point"),
    "2d sparse": ("sparse", {}, (3, 3, 1), {}, "as the dense 2-D mesh"),
    "2d planar": ("planar", {}, (3, 3, 1), {}, "the hinge, adaptive"),
    "2d planar fista": ("planar", FISTA, (3, 3, 3), {},
                        "FISTA, hinge: + the gradient at the extrapolated "
                        "point"),
    "2d democratic": ("democratic", {}, (3, 3, 1), {"all_gather": 1},
                      "the L∞ prox gathers x once a trial"),
    "tv": ("tv", {}, (1, 2, 1), {"halo": 1},
           "one exchange and one all-reduce a map, 1 x-space a trial"),
    "tv fista": ("tv_fista", {}, (1, 2, 2), {"halo": 1},
                 "FISTA: + f at the extrapolated point"),
}


@pytest.mark.parametrize("budget", sorted(BUDGETS))
def test_collective_budget(ranks, budget):
    """The collectives of a solve, read from the counter: all-reduces on
    the budget, a halo exchange a TV map (and the set-up's two), an
    all-gather only for the L∞ prox, nothing else."""
    case, extra, (setup, per_trial, per_iter), others, _ = BUDGETS[budget]
    name, build_kw, tau0, _, shape = CASES[case]
    kw = dict(_solve_kw(case, max_iters=50), **extra)
    for out in ranks.run("solve", name, build_kw, tau0, kw, shape=shape):
        k = int(out["iteration_count"])
        trials = k + int(out["total_backtracks"])
        want = {"all_reduce": setup + per_trial * trials + per_iter * k}
        for kind, n in others.items():
            want[kind] = n * trials + (2 if kind == "halo" else 0)
        assert out["counts"] == want


def test_linf_objective_takes_a_max_all_reduce(ranks):
    """Democratic with the objective recorded: the L∞ norm is no sum, so
    its value comes from one max all-reduce an iteration (its own kind),
    and the objectives match the unsharded port's."""
    name, build_kw, tau0, _, shape = CASES["democratic"]
    kw = _solve_kw("democratic", max_iters=30, record_objective=True)
    outs = ranks.run("solve", name, build_kw, tau0, kw, shape=shape)
    bkw = dict(build_kw, dtype=torch.float64, device="cpu")
    ref = problems.build(name, **bkw).solve(tau0=tau0, **kw)
    for out in outs:
        k = int(out["iteration_count"])
        assert out["counts"]["all_reduce_max"] == k
        np.testing.assert_allclose(out["taus"][:k], ref.taus, rtol=1e-6)


# ----------------------------------------------------- one-rank groups --

@pytest.fixture(scope="module")
def one_rank_meshes():
    """A 1-D and a 1×1 mesh in this process over a one-rank gloo group of
    its own, destroyed after the module."""
    assert not dist.is_initialized()
    meshes = (sh.make_mesh(device="cpu"), sh.make_mesh_2d(1, 1, device="cpu"))
    yield meshes
    dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32_hp", "float64"])
@pytest.mark.parametrize("mode", sorted(ftt.MODE_OPTIONS))
@pytest.mark.parametrize("layout", ["tv", "grid"])
def test_one_rank_group_gives_the_unsharded_bits(one_rank_meshes, layout,
                                                 mode, dtype):
    """A one-rank TV group and a 1×1 mesh solve exactly as the unsharded
    port: the all-reduces of one rank return their inputs, the band form
    with no halo rows is the unsharded map, and in hp mode the maps' f is
    the loop's f(d) bit for bit."""
    if layout == "tv":
        p = problems.build("tv", h=32, w=24, dtype=dtype, device="cpu")
        sp = sh.shard_problem(p, one_rank_meshes[0])
        assert sp.name == "tv[32x24]@1dev"
        tau0, kw = 2.0, dict(tol=1e-6, max_iters=60)
    else:
        p = problems.build("lasso", m=96, n=64, k=8, dtype=dtype,
                           device="cpu")
        sp = sh.shard_problem_2d(p, one_rank_meshes[1])
        assert sp.name == "lasso[96x64]@1x1dev"
        tau0, kw = 0.05, dict(tol=1e-9, max_iters=120)
    opts = ftt.FastaOptions(**kw, **ftt.MODE_OPTIONS[mode])
    got = ftt.make_solver(opts)(sp.op, sp.fterm, sp.gterm, sp.x0, tau0)
    ref = ftt.make_solver(opts)(p.op, p.fterm, p.gterm, p.x0, tau0)
    for key in SERIES:
        assert torch.equal(getattr(got, key), getattr(ref, key)), key
    assert got.iteration_count == ref.iteration_count
    assert got.total_backtracks == ref.total_backtracks


# ------------------------------------------------- K-B5's band form --

def _bands(p, b, ranks):
    """The band-form plain version over ``ranks`` bands of p and b, each
    with the halo rows the sharded map gives it; (d, f, g) joined."""
    hb = b.shape[0] // ranks
    ds, fs, gs = [], [], []
    for r in range(ranks):
        rows = slice(r * hb, (r + 1) * hb)
        above = None if r == 0 else p[0, r * hb - 1]
        below = b_below = None
        if r < ranks - 1:
            below = p[:, (r + 1) * hb].clone()
            if r + 2 == ranks and hb == 1:
                below[0] = 0.0
            b_below = b[(r + 1) * hb]
        d, f, g = tv_fused.tv_gradmap_band_reference(
            p[:, rows], b[rows], 0.1, above, below, b_below)
        ds.append(d)
        fs.append(f)
        gs.append(g)
    return torch.cat(ds), sum(float(f) for f in fs), torch.cat(gs, dim=1)


@pytest.mark.parametrize("hw", [(64, 32), (80, 24), (8, 200)])
def test_band_form_plain_version_matches_the_jax_sharded_map(hw):
    """K-B5's band form's plain version over 8 bands, each with its halo
    rows, against ``fasta_tpu.sharding.sharded_tv_lstsq_gradmap`` on the 8
    virtual devices: d and g bit for bit, f within rtol 1e-12; with no
    halo rows it is ``tv_gradmap_reference`` bit for bit."""
    rng = np.random.default_rng(11)
    p = rng.standard_normal((2,) + hw)
    b = rng.standard_normal(hw)
    mesh = jsh.make_mesh()
    jd, jf, jg = jsh.sharded_tv_lstsq_gradmap(
        jsh.RowShardedTVDivOp(0.1, mesh),
        jsh.shard_rows(jnp.asarray(b), mesh))(jnp.asarray(p))
    pt, bt = torch.as_tensor(p), torch.as_tensor(b)
    d, f, g = _bands(pt, bt, WORLD)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_allclose(f, float(jf), rtol=1e-12)
    whole = tv_fused.tv_gradmap_band_reference(pt, bt, 0.1)
    for got, want in zip(whole, tv_fused.tv_gradmap_reference(pt, bt, 0.1)):
        assert torch.equal(got, want)


def test_band_form_wrapper_checks_its_halo_rows():
    """The wrapper runs its plain version on the CPU, and refuses halo rows
    of the wrong shape or a row below without its image row."""
    p, b = torch.zeros(2, 4, 8), torch.zeros(4, 8)
    before = tv_fused.BAND_LAUNCHES
    out = tv_fused.fused_tv_gradmap_band(p, b, 0.1, torch.ones(8),
                                         torch.ones(2, 8), torch.ones(8))
    ref = tv_fused.tv_gradmap_band_reference(p, b, 0.1, torch.ones(8),
                                             torch.ones(2, 8), torch.ones(8))
    assert tv_fused.BAND_LAUNCHES == before
    for got, want in zip(out, ref):
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        tv_fused.fused_tv_gradmap_band(p, b, 0.1, torch.ones(7))
    with pytest.raises(ValueError):
        tv_fused.fused_tv_gradmap_band(p, b, 0.1, below=torch.ones(2, 8))
