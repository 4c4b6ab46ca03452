"""The layouts the reference leaves to XLA's partitioner, in the port
(``fasta_tpu_torch.sharding``): a bfloat16 ``LowPrecDenseOp`` over rows,
an ``IdentityOp`` whose smooth term holds x's rows (matrix completion,
max-norm), stacked operators over their lanes, the replicated layout
(``FunctionOp``, NMF) and the prox terms that need all of x, on four gloo
ranks on the CPU (a 1-D mesh and a 2×2 one).

Each solve is held against ``fasta_tpu.sharding.shard_problem`` (or
``shard_problem_2d`` on ``make_mesh_2d(2, 2)``) over the 8 virtual devices
of ``conftest.py`` and against the port's unsharded solve, with every
rank's series the same bit for bit:

* float64 cases at the JAX suite's bars (``tests/test_torch_sharding.py``:
  the same iteration count, τ and residuals rtol 1e-6, solution atol 1e-8);
* the bfloat16 cases at the bars of ``tests/test_torch_lowprec_slice.py``
  (the first 10 τ rtol 1e-4, the final objective rtol 1e-5, the counts
  within max(5, 20%)): the sums run in another order than one device's,
  and bfloat16 rounding of x on the two-call path makes that visible;
* the lane-split batches as ``tests/sharded/test_batch_composition.py``
  holds its batch: every lane's count equal, solutions atol 1e-8;
* the replicated layout bit for bit against the port's unsharded solve.

The collective budget of each layout comes from the counter, and
one-rank groups give the unsharded bits.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import fasta_tpu as ft
import fasta_tpu_torch as ftt
import problems as jax_problems
from fasta_tpu import sharding as jsh
from fasta_tpu_torch import convert, problems
from fasta_tpu_torch import sharding as sh
from gloo_ranks import Ranks, gspmd_problem, lane_data

torch.set_num_threads(1)

WORLD = 4
GRID = (2, 2)
FISTA = dict(accelerate=True, adaptive=False)
PLAIN = dict(adaptive=False, accelerate=False)
# the bfloat16 solve is the coarse leg of the mixed-precision workflow: its
# tolerance is the one tests/test_torch_lowprec_slice.py solves LASSO to
# (logistic's, 1e-2, stops before the bfloat16 floor, where even the
# reference's GSPMD and single-device runs part by a quarter in count)
BF16_KW = dict(max_iters=400, record_objective=True)

# name: (spec of gloo_ranks.gspmd_problem, solve keywords, mesh shape)
CASES = {
    "matrix_completion": (
        dict(name="matrix_completion",
             build=dict(d1=64, d2=32, rank=2, dtype="float64"), tau0=1.7),
        dict(tol=1e-9, max_iters=120), None),
    "matrix_completion_fista": (
        dict(name="matrix_completion",
             build=dict(d1=64, d2=32, rank=2, dtype="float64"), tau0=1.7),
        dict(tol=1e-9, max_iters=120, **FISTA), None),
    # the adaptive stepsize finds τ = 1 at once over the identity (3
    # iterations, as the reference's): a fixed τ iterates
    "max_norm": (
        dict(name="max_norm", build=dict(d1=64, d2=16, dtype="float64"),
             tau0=0.3),
        dict(tol=1e-9, max_iters=120, **PLAIN), None),
    "max_norm_fista": (
        dict(name="max_norm", build=dict(d1=64, d2=16, dtype="float64"),
             tau0=0.3),
        dict(tol=1e-9, max_iters=120, **FISTA), None),
    "nmf": (
        dict(name="nmf", build=dict(d1=40, d2=24, rank=3, dtype="float64"),
             tau0=0.0026),
        dict(tol=1e-9, max_iters=60), None),
    "function": (
        dict(name="lasso", build=dict(m=240, n=96, k=10, dtype="float64"),
             tau0=0.05, variant="function"),
        dict(tol=1e-9, max_iters=120), None),
    "bf16_lasso": (
        dict(name="lasso", build=dict(m=128, n=256, k=12, dtype="float32"),
             tau0=0.05, variant="bf16"),
        dict(BF16_KW, tol=2e-3), None),
    "bf16_logistic": (
        dict(name="logistic", build=dict(m=240, n=64, dtype="float32"),
             tau0=1.0, variant="bf16"),
        dict(BF16_KW, tol=1e-2), None),
    "lanes_dense": (
        dict(name="dense", build=(0, 8, 48, 32), tau0=0.5, weight=0.05,
             variant="lanes"),
        dict(tol=1e-9, max_iters=200), None),
    "lanes_planar": (
        dict(name="planar", build=(1, 8, 48, 32), tau0=0.5, weight=0.05,
             variant="lanes"),
        dict(tol=1e-9, max_iters=200), None),
    "nuclear_2d": (
        dict(name="mmv", build=dict(m=64, n=32, l=4, k=4, dtype="float64"),
             tau0=0.1, variant="nuclear", weight=0.05),
        dict(tol=1e-9, max_iters=40), GRID),
    "maxrow_2d": (
        dict(name="mmv", build=dict(m=64, n=32, l=4, k=4, dtype="float64"),
             tau0=0.1, variant="maxrow", weight=0.3),
        dict(tol=1e-9, max_iters=40), GRID),
}

OP_CLASS = {"matrix_completion": "RowShardedIdentityOp",
            "matrix_completion_fista": "RowShardedIdentityOp",
            "max_norm": "RowShardedIdentityOp",
            "max_norm_fista": "RowShardedIdentityOp", "nmf": "IdentityOp",
            "function": "FunctionOp",
            "bf16_lasso": "RowShardedLowPrecDenseOp",
            "bf16_logistic": "RowShardedLowPrecDenseOp",
            "lanes_dense": "LaneShardedDenseOp",
            "lanes_planar": "LaneShardedPlanarDenseOp",
            "nuclear_2d": "GridShardedDenseOp",
            "maxrow_2d": "GridShardedDenseOp"}


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(WORLD, shapes=(GRID,))
    yield r
    r.close()


def _jax_problem(spec):
    """The JAX package's problem of ``spec`` (``gspmd_problem``'s
    counterpart, on the same data)."""
    variant = spec.get("variant")
    if variant == "lanes":
        d = {k: jnp.asarray(v) for k, v in
             lane_data(spec["name"], *spec["build"]).items()}
        n = spec["build"][3]
        dense = spec["name"] == "dense"
        op = (ft.DenseOp(d["A"]) if dense
              else ft.PlanarDenseOp(d["Ar"], d["Ai"]))
        return ft.Problem(f"{spec['name']}_lanes", op=op,
                          fterm=ft.LeastSquares(d["b"]),
                          gterm=ft.L1Norm(spec["weight"]),
                          x0=jnp.zeros((n,) if dense else (n, 2)))
    kw = dict(spec["build"], dtype=getattr(jnp, spec["build"]["dtype"]))
    p = jax_problems.build(spec["name"], **kw)
    if variant == "bf16":
        return p.with_parts(op=ft.LowPrecDenseOp.from_dense(p.instance["A"]))
    if variant == "function":
        A = p.op.A
        return p.with_parts(op=ft.FunctionOp(lambda x: A @ x,
                                             lambda y: A.T @ y))
    if variant == "nuclear":
        return p.with_parts(gterm=ft.NuclearNorm(spec["weight"]))
    if variant == "maxrow":
        return p.with_parts(gterm=ft.MaxRowNormBall(spec["weight"]))
    return p


def _spec(case: str) -> dict:
    """The case's spec for the ranks: a bfloat16 case carries the JAX
    operator's bits, read through ``convert.sharded_op_arrays`` from the
    problem ``fasta_tpu.sharding.shard_problem`` placed."""
    spec = dict(CASES[case][0])
    if spec.get("variant") == "bf16":
        placed = jsh.shard_problem(_jax_problem(spec), jsh.make_mesh())
        arrays = convert.sharded_op_arrays(placed.op)
        assert arrays["kind"] == "lowprec"
        assert arrays["A"].dtype.name == "bfloat16"
        spec["A16"] = arrays["A"]
    return spec


def _keys(r) -> dict:
    out = {k: np.asarray(getattr(r, k)) for k in
           ("solution", "taus", "residuals", "iteration_count")}
    obj = getattr(r, "objectives", None)
    out["objectives"] = None if obj is None else np.asarray(obj)
    return out


@functools.lru_cache(maxsize=None)
def _jax(case: str) -> dict:
    """``fasta_tpu``'s solve of the case placed by ``shard_problem`` over
    the 8 virtual devices (``shard_problem_2d`` over a 2×2 mesh)."""
    spec, kw, shape = CASES[case]
    p = _jax_problem(spec)
    if shape is None:
        sp = jsh.shard_problem(p, jsh.make_mesh())
    else:
        sp = jsh.shard_problem_2d(p, jsh.make_mesh_2d(*shape))
    if spec.get("variant") == "lanes":
        out = ft.make_batch_solver(ft.FastaOptions(**kw),
                                   (0, 0, None, None, None))(
            sp.op, sp.fterm, sp.gterm, jnp.asarray(sp.x0), spec["tau0"])
        return _keys(out)
    sp.tau0 = spec["tau0"]
    return _keys(sp.solve(**kw))


@functools.lru_cache(maxsize=None)
def _port_single(case: str) -> dict:
    spec, kw, _ = CASES[case]
    if spec.get("variant") == "bf16":
        spec = dict(spec, A16=_spec(case)["A16"])
    p = gspmd_problem(spec)
    if spec.get("variant") == "lanes":
        return convert.result_to_numpy(ftt.make_batch_solver(
            ftt.FastaOptions(**kw), (0, 0, None, None, None))(
            p.op, p.fterm, p.gterm, p.x0, spec["tau0"]))
    return convert.result_to_numpy(p.solve(tau0=spec["tau0"], **kw))


_RUNS = {}


def _sharded(ranks, case: str) -> dict:
    """The case on the ranks (run once a module): every rank's series the
    same bit for bit, x gathered from a 2×2 mesh's blocks."""
    if case not in _RUNS:
        spec, kw, shape = CASES[case]
        outs = ranks.run("gspmd", _spec(case), kw, shape=shape)
        for r, out in enumerate(outs[1:], start=1):
            for key in ("taus", "residuals", "fvals", "backtracks",
                        "iteration_count", "total_backtracks"):
                assert np.array_equal(out[key], outs[0][key]), (r, key)
            assert out["counts"] == outs[0]["counts"]
        got = dict(outs[0])
        if shape is not None:
            for r in range(2, WORLD):
                assert np.array_equal(outs[r]["solution"],
                                      outs[r % 2]["solution"])
            got["solution"] = np.concatenate(
                [outs[0]["solution"], outs[1]["solution"]])
        else:
            for out in outs[1:]:
                assert np.array_equal(out["solution"], got["solution"])
        _RUNS[case] = got
    return _RUNS[case]


def _hold(got, ref):
    """At the JAX suite's bars."""
    k = int(ref["iteration_count"])
    assert int(got["iteration_count"]) == k
    np.testing.assert_allclose(got["taus"][:k], ref["taus"][:k], rtol=1e-6)
    np.testing.assert_allclose(got["residuals"][:k], ref["residuals"][:k],
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got["solution"], ref["solution"], atol=1e-8)


def _hold_bf16(got, ref):
    """At the bfloat16 bars."""
    np.testing.assert_allclose(got["taus"][:10], ref["taus"][:10],
                               rtol=1e-4)
    k, kr = int(got["iteration_count"]), int(ref["iteration_count"])
    assert got["objectives"][k - 1] == pytest.approx(
        float(ref["objectives"][kr - 1]), rel=1e-5)
    assert abs(k - kr) <= max(5, int(0.2 * kr))


def _hold_lanes(got, ref):
    np.testing.assert_array_equal(got["iteration_count"],
                                  ref["iteration_count"])
    np.testing.assert_allclose(got["solution"], ref["solution"], atol=1e-8)


# ------------------------------------------------------------ placement --

# problem: build keywords (dtype float64 unless given) for the 13 problems
# of problems.build, and the class shard_problem makes of its operator
PLACED = {
    "lasso": (dict(m=64, n=32, k=4), "RowShardedDenseOp"),
    "nnls": (dict(m=64, n=32), "RowShardedDenseOp"),
    "logistic": (dict(m=64, n=32), "RowShardedDenseOp"),
    "svm": (dict(m=64, n=32), "RowShardedDenseOp"),
    "tv": (dict(h=16, w=16), "RowShardedTVDivOp"),
    "phase_retrieval": (dict(m=64, n=16, dtype="complex128"),
                        "RowShardedDenseOp"),
    "phase_retrieval_cdp": (dict(n=16, K=4, dtype="complex128"),
                            "ShardedCDPOp"),
    "sparse_lasso": (dict(m=64, n=32, density=0.2, k=4),
                     "RowShardedSparseOp"),
    "democratic": (dict(m=64, n=128), "RowShardedDenseOp"),
    "mmv": (dict(m=64, n=32, l=3, k=4), "RowShardedDenseOp"),
    "matrix_completion": (dict(d1=16, d2=8, rank=2), "RowShardedIdentityOp"),
    "max_norm": (dict(d1=16, d2=8), "RowShardedIdentityOp"),
    "nmf": (dict(d1=12, d2=8, rank=2), "IdentityOp"),
}


@pytest.mark.parametrize("name", sorted(PLACED))
def test_every_problem_places(ranks, name):
    """``shard_problem`` places each of the 13 problems of
    ``problems.build`` on four ranks: none raises, the operator takes its
    layout and the name its ``@4dev``."""
    build, cls = PLACED[name]
    build = dict(build, dtype=build.get("dtype", "float64"))
    for out in ranks.run("place", dict(name=name, build=build)):
        assert out["op"] == cls
        assert out["name"].endswith(f"@{WORLD}dev")
        assert out["fterm"] == ("RowShardedSmooth" if cls != "IdentityOp"
                                else "NMFLoss")


@pytest.mark.parametrize("case", ["bf16_lasso", "function", "lanes_dense",
                                  "lanes_planar", "fsmooth", "tv_fsmooth"])
def test_the_other_operators_place(ranks, case):
    """A bfloat16 ``LowPrecDenseOp``, a ``FunctionOp``, the stacked
    ``DenseOp`` and ``PlanarDenseOp`` and a ``FunctionSmooth`` (over a
    matrix and over the TV dual) take their layouts: the stacked
    operators' smooth terms are split over the lanes and not wrapped, the
    ``FunctionOp``'s and the closures' problems are replicated whole."""
    spec = (_spec(case) if case in CASES else dict(
        name="lasso" if case == "fsmooth" else "tv", variant="fsmooth",
        build=(dict(m=64, n=32, k=4) if case == "fsmooth"
               else dict(h=16, w=16)) | dict(dtype="float64")))
    want = {"bf16_lasso": ("RowShardedLowPrecDenseOp", "RowShardedSmooth"),
            "fsmooth": ("DenseOp", "FunctionSmooth"),
            "tv_fsmooth": ("ScaledOp", "FunctionSmooth")}.get(
        case, (OP_CLASS.get(case), "LeastSquares"))
    for out in ranks.run("place", spec):
        assert (out["op"], out["fterm"]) == want
        assert out["name"].endswith(f"@{WORLD}dev")


def test_shard_problem_no_longer_names_a_missing_item():
    assert not hasattr(sh, "_NEXT_ITEM")


# --------------------------------------------- against the reference --

@pytest.mark.parametrize("case", ["matrix_completion",
                                  "matrix_completion_fista", "max_norm",
                                  "max_norm_fista", "nmf", "function"])
def test_float64_layouts_match_the_reference(ranks, case):
    """Matrix completion and max-norm over the identity's rows, NMF and
    the ``FunctionOp`` LASSO replicated: against the reference's GSPMD
    solve and the port's unsharded one."""
    got = _sharded(ranks, case)
    assert got["op"] == OP_CLASS[case]
    assert int(got["iteration_count"]) > 3
    _hold(got, _jax(case))
    _hold(got, _port_single(case))


@pytest.mark.parametrize("case", ["nmf", "function"])
def test_replicated_layout_is_the_unsharded_solve(ranks, case):
    """The replicated layout solves the whole problem on every rank with no
    collective: the unsharded port's bits."""
    got, ref = _sharded(ranks, case), _port_single(case)
    assert got["counts"] == {}
    for key in ("solution", "taus", "residuals", "fvals", "backtracks"):
        np.testing.assert_array_equal(got[key], ref[key])


@pytest.mark.parametrize("case", ["bf16_lasso", "bf16_logistic"])
def test_bf16_rows_match_the_reference(ranks, case):
    """The bfloat16 LASSO and logistic over the rank's rows (the whole
    matrix below the gate: the two-call pass, x rounded to bfloat16) at the
    bfloat16 bars against the reference's GSPMD solve and the port's
    unsharded one."""
    got = _sharded(ranks, case)
    assert got["op"] == "RowShardedLowPrecDenseOp" and got["converged"]
    _hold_bf16(got, _jax(case))
    _hold_bf16(got, _port_single(case))


@pytest.mark.parametrize("case", ["lanes_dense", "lanes_planar"])
def test_lane_split_batches_match_the_reference(ranks, case):
    """``make_batch_solver`` over a stacked ``DenseOp`` (8, 48, 32) and a
    stacked ``PlanarDenseOp``, the operator and b on axis 0: each rank
    runs its two lanes and the result holds all eight on every rank;
    every lane's count equal to the reference's and to the unsharded
    port's, solutions within 1e-8."""
    got = _sharded(ranks, case)
    assert got["lanes"][0] == 8 // WORLD
    assert got["solution"].shape[0] == 8 and got["converged"].all()
    _hold_lanes(got, _jax(case))
    _hold_lanes(got, _port_single(case))


@pytest.mark.parametrize("case", ["nuclear_2d", "maxrow_2d"])
def test_signal_sharded_prox_on_a_2x2_mesh(ranks, case):
    """MMV on a 2×2 mesh with the nuclear norm (the prox and the value on
    the gathered X, one all-gather each) and with the max-row-norm ball
    (separable over X's rows, local): against the reference's
    ``shard_problem_2d`` and the port's unsharded solve."""
    got = _sharded(ranks, case)
    assert got["gterm"] == "SignalShardedProx"
    _hold(got, _jax(case))
    _hold(got, _port_single(case))
    trials = int(got["iteration_count"]) + int(got["total_backtracks"])
    gathers = got["counts"].get("all_gather", 0)
    assert gathers == (trials if case == "nuclear_2d" else 0)


# ------------------------------------------------------------ budgets --

# case: (all-reduces at the set-up, a trial, an iteration), other kinds,
# the reason
BUDGETS = {
    "bf16_lasso": ((2, 1, 0), {}, "adaptive: one (f, g) all-reduce a map"),
    "bf16_logistic": ((2, 1, 0), {}, "adaptive, the logistic map"),
    "matrix_completion": ((2, 1, 0), {}, "adaptive over the identity's "
                                         "rows"),
    "matrix_completion_fista": ((2, 1, 2), {}, "FISTA, a non-affine "
                                               "gradient: f and the "
                                               "gradient at the "
                                               "extrapolated point"),
    "max_norm": ((2, 1, 0), {}, "fixed τ: one a map"),
    "max_norm_fista": ((2, 1, 2), {}, "FISTA: the unsharded solve has no "
                                      "map over the identity, so the "
                                      "gradient at the extrapolated point "
                                      "is evaluated, not extrapolated"),
    "lanes_dense": ((0, 0, 0), {"all_gather": 1},
                    "none in the loop, one gather after it"),
    "lanes_planar": ((0, 0, 0), {"all_gather": 1}, "as the dense stack"),
    "nmf": ((0, 0, 0), {}, "replicated: none"),
    "function": ((0, 0, 0), {}, "replicated: none"),
}


@pytest.mark.parametrize("case", sorted(BUDGETS))
def test_collective_budget(ranks, case):
    """Each layout's collectives by kind, from the counter: the row
    layouts one all-reduce a gradient map (2 at the set-up), the lane
    split one all-gather for the whole batch, the replicated layout
    none."""
    (setup, per_trial, per_iter), others, _ = BUDGETS[case]
    got = _sharded(ranks, case)
    k = int(np.max(got["iteration_count"]))
    trials = k + int(np.max(got["total_backtracks"]))
    want = dict(others)
    if setup:
        want["all_reduce"] = setup + per_trial * trials + per_iter * k
    assert got["counts"] == want


# ----------------------------------------------------------- the gate --

def test_the_bf16_gate_judges_the_whole_matrix(ranks):
    """The 64 MB gate chooses the function (the kernel keeps x in float32,
    the two-call path rounds it to bfloat16), so a rank judges the whole
    matrix's bytes, not its block's.  With the gate between the two
    (lowered so that a 256×64 matrix stands for one past 64 MB spread
    over four ranks), every rank keeps x in float32 as the unsharded
    operator does; with the gate above the whole matrix both round x."""
    rng = np.random.default_rng(5)
    A = jnp.asarray(rng.standard_normal((256, 64)), jnp.bfloat16)
    A16 = np.asarray(A)
    b = rng.standard_normal(256).astype(np.float32)
    x = (rng.standard_normal(64) / 3).astype(np.float32)
    whole = 256 * 64 * 2
    for gate, kernel in ((whole // 2, True), (2 * whole, False)):
        outs = ranks.run("gate", A16, b, x, gate)
        for r, out in enumerate(outs):
            assert out["block_bytes"] <= whole // 2 < whole
            assert out["kernel"] is kernel and out["rounded"] is not kernel
            rows = slice(r * 64, (r + 1) * 64)
            np.testing.assert_allclose(out["d"], out["whole_d"][rows],
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(out["g"], out["whole_g"], rtol=1e-5,
                                       atol=1e-5)
            assert out["f"] == pytest.approx(out["whole_f"], rel=1e-6)
    # the unsharded reference below the gate rounds x too
    op = ft.LowPrecDenseOp.from_dense(np.asarray(A, np.float64))
    d = np.concatenate([o["d"] for o in outs])
    np.testing.assert_allclose(d, np.asarray(op(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------ operators from JAX --

def test_lowprec_and_identity_ops_from_the_reference_arrays(ranks):
    """``convert.sharded_op_arrays`` of what ``fasta_tpu.sharding`` placed:
    the bfloat16 operator's bits and the identity's rows carried to each
    rank (``sharded_op_from_arrays``): the rank's rows of A x and the whole
    Aᵀ y equal the JAX operator's products (x rounded to bfloat16 in
    both), the identity's its rows and y itself."""
    p = _jax_problem(dict(CASES["bf16_lasso"][0]))
    op = jsh.shard_problem(p, jsh.make_mesh()).op
    arrays = convert.sharded_op_arrays(op)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(256).astype(np.float32)
    y = rng.standard_normal(128).astype(np.float32)
    outs = ranks.run("op", arrays, x, y, 5e-2)
    np.testing.assert_allclose(np.concatenate([o["d"] for o in outs]),
                               np.asarray(op(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-6)
    for out in outs:
        assert out["op"] == "RowShardedLowPrecDenseOp"
        assert out["shape"] == (128, 256)
        np.testing.assert_allclose(out["g"],
                                   np.asarray(op.rmatvec(jnp.asarray(y))),
                                   rtol=1e-5, atol=1e-5)
    mc = jsh.shard_problem(jax_problems.build(
        "matrix_completion", d1=16, d2=8, rank=2, dtype=jnp.float64),
        jsh.make_mesh())
    arrays = convert.sharded_op_arrays(mc.op, rows=16)
    X, Y = rng.standard_normal((16, 8)), rng.standard_normal((16, 8))
    outs = ranks.run("op", arrays, X, Y)
    np.testing.assert_array_equal(np.concatenate([o["d"] for o in outs]), X)
    for out in outs:
        assert out["op"] == "RowShardedIdentityOp"
        np.testing.assert_array_equal(out["g"], Y)
    with pytest.raises(ValueError):
        convert.sharded_op_arrays(mc.op)


def test_stacked_ops_from_the_reference_arrays(ranks):
    """The reference's ``RowShardedDenseOp`` and
    ``RowShardedPlanarDenseOp`` over stacked matrices cross as the lane
    kinds; each rank holds its members."""
    for case, kind in (("lanes_dense", "lanes_dense"),
                       ("lanes_planar", "lanes_planar")):
        p = _jax_problem(CASES[case][0])
        arrays = convert.sharded_op_arrays(
            jsh.shard_problem(p, jsh.make_mesh()).op)
        assert arrays["kind"] == kind
        for r, out in enumerate(ranks.run("lane_op", arrays)):
            lanes = slice(2 * r, 2 * r + 2)
            first = arrays["A" if kind == "lanes_dense" else "Ar"]
            assert out["op"] == ("LaneShardedDenseOp" if kind == "lanes_dense"
                                 else "LaneShardedPlanarDenseOp")
            np.testing.assert_array_equal(out["members"], first[lanes])
            assert out["shape"] == first.shape


# ----------------------------------------------------- one-rank groups --

@pytest.fixture(scope="module")
def one_rank_mesh():
    """``make_mesh`` in this process: a one-rank gloo group of its own,
    destroyed after the module."""
    assert not dist.is_initialized()
    mesh = sh.make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def _one_rank_problem(layout):
    if layout == "bf16":
        p = problems.build("lasso", m=96, n=64, k=8, dtype=torch.float32,
                           device="cpu")
        return p.with_parts(op=ftt.LowPrecDenseOp.from_dense(p.op.A)), 0.05
    if layout == "identity":
        return problems.build("matrix_completion", d1=16, d2=8, rank=2,
                              dtype=torch.float64, device="cpu"), 1.7
    if layout == "identity_lstsq":
        return problems.build("max_norm", d1=16, d2=8, dtype=torch.float32,
                              device="cpu"), 0.3
    return gspmd_problem(dict(CASES["function"][0])), 0.05


@pytest.mark.parametrize("mode", sorted(ftt.MODE_OPTIONS))
@pytest.mark.parametrize("layout", ["bf16", "identity", "identity_lstsq",
                                    "replicated"])
def test_one_rank_group_gives_the_unsharded_bits(one_rank_mesh, layout,
                                                 mode):
    """A one-rank group solves each new layout exactly as the unsharded
    port: the all-reduce of one rank returns its input."""
    p, tau0 = _one_rank_problem(layout)
    sp = sh.shard_problem(p, one_rank_mesh)
    assert sp.name == p.name + "@1dev"
    opts = ftt.FastaOptions(tol=1e-9, max_iters=60, **ftt.MODE_OPTIONS[mode])
    got = ftt.make_solver(opts)(sp.op, sp.fterm, sp.gterm, sp.x0, tau0)
    ref = ftt.make_solver(opts)(p.op, p.fterm, p.gterm, p.x0, tau0)
    for key in ("solution", "taus", "residuals", "fvals", "backtracks"):
        assert torch.equal(getattr(got, key), getattr(ref, key)), key
    assert got.iteration_count == ref.iteration_count


@pytest.mark.parametrize("kind", ["dense", "planar"])
def test_one_rank_lane_split_gives_the_unsharded_bits(one_rank_mesh, kind):
    """The lane split on one rank: the batch solver's bits, after the one
    (trivial) gather."""
    p = gspmd_problem(dict(name=kind, build=(2, 4, 24, 16), tau0=0.5,
                           weight=0.05, variant="lanes"))
    sp = sh.shard_problem(p, one_rank_mesh)
    batch = ftt.make_batch_solver(ftt.FastaOptions(tol=1e-9, max_iters=100),
                                  (0, 0, None, None, None))
    sh.reset_collective_counts()
    got = batch(sp.op, sp.fterm, sp.gterm, sp.x0, 0.5)
    assert sh.collective_counts() == {"all_gather": 1}
    ref = batch(p.op, p.fterm, p.gterm, p.x0, 0.5)
    for key in ("solution", "taus", "residuals", "backtracks"):
        assert torch.equal(getattr(got, key), getattr(ref, key)), key
    for key in ("iteration_count", "converged", "total_backtracks",
                "nonfinite"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key))
        assert getattr(got, key).dtype == getattr(ref, key).dtype


def test_lane_count_must_divide(ranks):
    for kind, msg in ranks.run("raises_spec", dict(
            name="dense", build=(0, 6, 8, 4), tau0=0.5, weight=0.05,
            variant="lanes")):
        assert kind == "ValueError" and "lane count 6" in msg
