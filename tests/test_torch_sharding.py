"""The port's row-sharded solves (``fasta_tpu_torch.sharding``) on four
gloo ranks on the CPU, held against ``fasta_tpu.sharding`` on the 8
virtual devices of ``conftest.py`` (the counterpart of
``tests/sharded/test_sharded.py``, ``test_sharded_breadth.py:29-115``,
``test_batch_composition.py``, ``test_collectives.py`` and
``test_multihost.py``, but their TV and 2-D cases, which
``tests/test_torch_sharding_x.py`` holds).

The ranks are spawned once for the module (``gloo_ranks.Ranks``); they
import no JAX, build each problem with the port's ``problems.build``
from the same generator as the JAX package's, shard it with
``shard_problem`` and send back NumPy.  Each solve is held, at the JAX
suite's bars (same iteration count; τ rtol 1e-6; residuals rtol 1e-6, atol
1e-12 — 1e-5 for phase retrieval and logistic, as there; solution atol
1e-8, 1e-6 for the SVM and adaptive CDP), against ``fasta_tpu`` sharded
and unsharded and against the port's unsharded solve; every rank's
series must be the same bit for bit.  The reduction order differs from
one device's, and the BB stepsize amplifies that, which is what the
tolerances are for.
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
from fasta_tpu_torch import convert, problems
from fasta_tpu_torch import sharding as sh
from gloo_ranks import SERIES, Ranks, host_result

torch.set_num_threads(1)

WORLD = 4
FISTA = dict(accelerate=True, adaptive=False)

# name: (problem, build keywords, τ₀, solve keywords) at the JAX suite's
# sizes; every solve at tol 1e-9 and 120 iterations unless it says
CASES = {
    "lasso": ("lasso", dict(m=240, n=96, k=10, dtype="float64"), 0.05, {}),
    "phase_retrieval": ("phase_retrieval",
                        dict(m=512, n=16, dtype="complex128"), 1.0, FISTA),
    "planar": ("phase_retrieval",
               dict(m=512, n=16, dtype="float64", planar=True), 1.0, FISTA),
    "mmv": ("mmv", dict(m=160, n=64, l=4, k=8, dtype="float64"), 0.08, {}),
    "logistic": ("logistic", dict(m=240, n=64, dtype="float64"), 1.0, {}),
    "svm": ("svm", dict(m=240, n=48, dtype="float64"), 0.3, {}),
    "cdp": ("phase_retrieval_cdp", dict(n=64, K=8, dtype="complex128"), 1.0,
            FISTA),
    "cdp_adaptive": ("phase_retrieval_cdp",
                     dict(n=64, K=8, dtype="complex128"), 1.0,
                     dict(max_iters=60)),
    "sparse": ("sparse_lasso",
               dict(m=320, n=160, density=0.05, k=10, dtype="float64"), 0.05,
               {}),
}


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(WORLD)
    yield r
    r.close()


def _solve_kw(case):
    kw = dict(tol=1e-9, max_iters=120)
    kw.update(CASES[case][3])
    return kw


@functools.lru_cache(maxsize=None)
def _jax(case: str, sharded: bool, explicit: bool = True) -> dict:
    """``fasta_tpu``'s solve of the case, on one device or row-sharded over
    the 8 virtual devices."""
    name, build_kw, tau0, _ = CASES[case]
    kw = dict(build_kw, dtype=getattr(jnp, build_kw["dtype"]))
    prob = jax_problems.build(name, **kw)
    prob.tau0 = tau0
    if sharded:
        prob = jsh.shard_problem(prob, jsh.make_mesh(), explicit=explicit)
    r = prob.solve(**_solve_kw(case))
    return {k: np.asarray(getattr(r, k)) for k in SERIES
            + ("iteration_count",)}


@functools.lru_cache(maxsize=None)
def _port_single(case: str) -> dict:
    name, build_kw, tau0, _ = CASES[case]
    kw = dict(build_kw, dtype=getattr(torch, build_kw["dtype"]),
              device="cpu")
    return host_result(problems.build(name, **kw).solve(tau0=tau0,
                                                          **_solve_kw(case)))


def _sharded(ranks, case: str, explicit: bool = True) -> dict:
    """The case on the ranks; every rank's result the same bit for bit."""
    name, build_kw, tau0, _ = CASES[case]
    outs = ranks.run("solve", name, build_kw, tau0,
                     dict(_solve_kw(case), explicit=explicit))
    for r, out in enumerate(outs[1:], start=1):
        for key in SERIES + ("iteration_count", "total_backtracks"):
            assert np.array_equal(out[key], outs[0][key]), (r, key)
        assert out["counts"] == outs[0]["counts"]
    return outs[0]


def _hold(got, ref, taus=None, res=None, res_atol=1e-12, sol=None):
    """``got`` against ``ref`` at the JAX suite's bars for the case."""
    k = int(ref["iteration_count"])
    assert int(got["iteration_count"]) == k
    if taus is not None:
        np.testing.assert_allclose(got["taus"][:k], ref["taus"][:k],
                                   rtol=taus)
    if res is not None:
        np.testing.assert_allclose(got["residuals"][:k],
                                   ref["residuals"][:k], rtol=res,
                                   atol=res_atol)
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


# ---------------------------------------------------- test_sharded.py --

def test_mesh_construction(ranks):
    meshes = ranks.run("mesh")
    assert [m["rank"] for m in meshes] == list(range(WORLD))
    for m in meshes:
        assert m["size"] == WORLD and m["names"] == ("rows",)
        assert m["device"] == "cpu"
        assert m["distributed"] and m["global_size"] == WORLD


def test_one_process_needs_no_set_up():
    """As the reference's: ``initialize`` for one process is a no-op."""
    from fasta_tpu_torch import distributed
    distributed.initialize(num_processes=1)
    assert not distributed.is_distributed()


def test_fasta_estimates_the_stepsize_and_checks_the_adjoint(ranks):
    """``fasta()`` with no τ₀ on the sharded problem: the adjoint check
    draws the whole y and takes each rank's rows, the estimate's norms are
    in x-space and its adjoints all-reduce, so the ranks get the unsharded
    port's L and τ₀ (within rounding) and the same solve."""
    p = problems.build("lasso", m=240, n=96, k=10, dtype=torch.float64,
                       device="cpu")
    ref = ftt.fasta(p.op, None, p.fterm, None, p.gterm, None, p.x0, key=7,
                    check_adjoint_first=True, tol=1e-9, max_iters=120)
    outs = ranks.run("fasta", 7)
    for out in outs:
        assert out["L"] == outs[0]["L"] and out["tau0"] == outs[0]["tau0"]
        np.testing.assert_allclose(out["L"], ref.L_estimate, rtol=1e-12)
        np.testing.assert_array_equal(out["taus"], outs[0]["taus"])
        _hold(out, host_result(ref), taus=1e-6, res=1e-6, sol=1e-8)


@pytest.mark.parametrize("explicit", [False, True])
def test_sharded_matches_single_device(ranks, explicit):
    got = _hold_all(ranks, "lasso", explicit, taus=1e-6, res=1e-6, sol=1e-8)
    assert got["op"] == "RowShardedDenseOp"
    assert got["name"] == f"lasso[240x96]@{WORLD}dev"


def test_sharded_complex_phase_retrieval(ranks):
    got = _hold_all(ranks, "phase_retrieval", res=1e-5)
    assert got["op"] == "RowShardedDenseOp"


def test_sharded_planar_phase_retrieval(ranks):
    got = _hold_all(ranks, "planar", res=1e-5, sol=1e-8)
    assert got["op"] == "RowShardedPlanarDenseOp"


def test_sharded_mmv_matrix_variable(ranks):
    got = _hold_all(ranks, "mmv", sol=1e-8)
    assert got["solution"].shape == (64, 4)


def test_sharded_logistic_fused_pointwise(ranks):
    _hold_all(ranks, "logistic", res=1e-5)


def test_sharded_svm_fused_pointwise(ranks):
    _hold_all(ranks, "svm", sol=1e-6)


def _dense_arrays(seed):
    """A JAX ``RowShardedDenseOp`` over a seeded 64×24 matrix, and the
    matrix."""
    mesh = jsh.make_mesh()
    A_np = np.random.default_rng(seed).standard_normal((64, 24))
    op = jsh.RowShardedDenseOp(jsh.shard_rows(jnp.asarray(A_np), mesh), mesh)
    return op, A_np


def test_row_sharded_op_adjoint(ranks):
    op, _ = _dense_arrays(0)
    ft.check_adjoint(op, jnp.zeros(24), jax.random.PRNGKey(0), rtol=1e-10)
    arrays = convert.sharded_op_arrays(op)
    outs = ranks.run("op", arrays, np.zeros(24), np.zeros(64))
    for out in outs:
        assert out["op"] == "RowShardedDenseOp" and out["err"] <= 1e-10
        assert out["shape"] == (64, 24)
    assert len({out["err"] for out in outs}) == 1


def test_row_sharded_op_matches_dense(ranks):
    op, A_np = _dense_arrays(1)
    rng = np.random.default_rng(1)
    rng.standard_normal((64, 24))
    x_np, y_np = rng.standard_normal(24), rng.standard_normal(64)
    np.testing.assert_allclose(op(jnp.asarray(x_np)), A_np @ x_np,
                               atol=1e-12)
    outs = ranks.run("op", convert.sharded_op_arrays(op), x_np, y_np)
    d = np.concatenate([out["d"] for out in outs])
    np.testing.assert_allclose(d, A_np @ x_np, atol=1e-12)
    np.testing.assert_allclose(d, np.asarray(op(jnp.asarray(x_np))),
                               atol=1e-12)
    for out in outs:
        np.testing.assert_allclose(out["g"], A_np.T @ y_np, atol=1e-12)
        assert np.array_equal(out["g"], outs[0]["g"])


def test_rank_blocks(ranks):
    """In place of ``test_placement_specs``: A and b hold each rank's
    rows, x0 all of it, on the rank's device."""
    blocks = ranks.run("blocks", dict(m=240, n=96, k=10, dtype="float64"))
    for b in blocks:
        assert b["A"] == (60, 96) and b["b"] == (60,) and b["x0"] == (96,)
        assert b["shape"] == (240, 96) and b["devices"] == {"cpu"}
        assert b["A_rows"] and b["b_rows"] and b["x0_whole"]


def test_indivisible_mesh_raises(ranks):
    prob = jax_problems.build("lasso", m=100, n=40, k=5, dtype=jnp.float64)
    with pytest.raises(ValueError):
        jsh.shard_problem(prob, jsh.make_mesh())
    # 100 divides by the 4 ranks; 102 by neither 4 nor 8
    for kind, msg in ranks.run("raises", "lasso",
                               dict(m=102, n=40, k=5, dtype="float64")):
        assert kind == "ValueError" and "not divisible" in msg
    for kind, msg in ranks.run("raises", "phase_retrieval_cdp",
                               dict(n=16, K=6, dtype="complex128")):
        assert kind == "ValueError" and "mask count 6" in msg


def test_tv_and_unported_layouts_raise(ranks):
    """The TV dual shards (its dual field over image rows, the halo layout
    of ``tests/test_torch_sharding_x.py``), and so does matrix completion's
    ``IdentityOp``, which the reference leaves to GSPMD (its term's rows
    split: ``tests/test_torch_sharding_gspmd.py``); what still raises is
    a split that does not divide, as in the reference."""
    for kind, msg in ranks.run("raises", "tv",
                               dict(h=16, w=16, dtype="float64")):
        assert kind is None and msg == ""
    for kind, msg in ranks.run("raises", "matrix_completion",
                               dict(d1=8, d2=8, rank=2, dtype="float64")):
        assert kind is None and msg == ""
    prob = jax_problems.build("matrix_completion", d1=10, d2=8, rank=2,
                              dtype=jnp.float64)
    with pytest.raises(ValueError):
        jsh.shard_problem(prob, jsh.make_mesh())
    for kind, msg in ranks.run("raises", "matrix_completion",
                               dict(d1=10, d2=8, rank=2, dtype="float64")):
        assert kind == "ValueError" and "not divisible" in msg


# --------------------------------------------- test_sharded_breadth.py --

def test_sharded_cdp_op_matches_stacked(ranks):
    prob = jax_problems.build("phase_retrieval_cdp", n=64, K=8,
                              dtype=jnp.complex128)
    sop = jsh.shard_problem(prob, jsh.make_mesh()).op
    rng = np.random.default_rng(0)
    x = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    y = rng.standard_normal((8, 64)) + 1j * rng.standard_normal((8, 64))
    outs = ranks.run("op", convert.sharded_op_arrays(sop), x, y)
    d = np.concatenate([out["d"] for out in outs])
    np.testing.assert_allclose(d, np.asarray(prob.op(jnp.asarray(x))),
                               atol=1e-12)
    for out in outs:
        assert out["op"] == "ShardedCDPOp" and out["err"] <= 1e-10
        assert out["shape"] == (8 * 64, 64)
        np.testing.assert_allclose(
            out["g"], np.asarray(prob.op.rmatvec(jnp.asarray(y))),
            atol=1e-12)


def test_sharded_cdp_scalar_sequence_identity(ranks):
    got = _hold_all(ranks, "cdp", taus=1e-6, res=1e-6, sol=1e-8)
    assert got["op"] == "ShardedCDPOp"


def test_sharded_cdp_adaptive_mode(ranks):
    _hold_all(ranks, "cdp_adaptive", sol=1e-6)


def test_sharded_sparse_op_matches_bcoo(ranks):
    prob = jax_problems.build("sparse_lasso", m=320, n=160, density=0.05,
                              k=10, dtype=jnp.float64)
    sop = jsh.shard_problem(prob, jsh.make_mesh()).op
    rng = np.random.default_rng(2)
    x, y = rng.standard_normal(160), rng.standard_normal(320)
    A = prob.instance["A_sparse"].toarray()
    outs = ranks.run("op", convert.sharded_op_arrays(sop), x, y)
    np.testing.assert_allclose(np.concatenate([o["d"] for o in outs]),
                               A @ x, atol=1e-12)
    for out in outs:
        assert out["op"] == "RowShardedSparseOp"
        np.testing.assert_allclose(out["g"], A.T @ y, atol=1e-12)


def test_sharded_sparse_scalar_sequence_identity(ranks):
    got = _hold_all(ranks, "sparse", taus=1e-6, sol=1e-8)
    assert got["op"] == "RowShardedSparseOp"


# ------------------------------------------- test_batch_composition.py --

MUS = (0.3, 0.1, 0.03)


@functools.lru_cache(maxsize=None)
def _jax_batch(path: bool, sharded: bool):
    prob = jax_problems.build("lasso", m=240, n=96, k=10, dtype=jnp.float64)
    if sharded:
        prob = jsh.shard_problem(prob, jsh.make_mesh())
    mus = jnp.asarray(MUS) * float(np.asarray(prob.gterm.mu))
    opts = ft.FastaOptions(max_iters=400, tol=1e-9)
    x0 = jnp.asarray(prob.x0)
    if path:
        r = ft.solve_path(prob.op, prob.fterm, ft.L1Norm(mus), x0, 0.05,
                          opts)
    else:
        r = ft.make_batch_solver(
            opts, in_axes=(None, None, ft.L1Norm(0), None, None))(
            prob.op, prob.fterm, ft.L1Norm(mus), x0, 0.05)
    return {k: np.asarray(getattr(r, k))
            for k in ("solution", "iteration_count", "converged")}


@pytest.mark.parametrize("path", [False, True], ids=["sweep", "solve_path"])
def test_mu_sweep_over_mesh(ranks, path):
    """``make_batch_solver`` over the μ lanes and the warm-started
    ``solve_path``, both over the sharded LASSO 240×96."""
    mu = float(problems.build("lasso", m=240, n=96, k=10, device="cpu",
                              dtype=torch.float64).gterm.mu)
    outs = ranks.run("batch", [m * mu for m in MUS], path)
    for out in outs[1:]:
        for key in outs[0]:
            assert np.array_equal(out[key], outs[0][key]), key
    got = outs[0]
    assert got["converged"].all()
    for ref in (_jax_batch(path, True), _jax_batch(path, False)):
        assert ref["converged"].all()
        if not path:
            np.testing.assert_array_equal(got["iteration_count"],
                                          ref["iteration_count"])
        np.testing.assert_allclose(got["solution"], ref["solution"],
                                   atol=1e-8)


# ----------------------------------------------------- the port's own --

@pytest.fixture(scope="module")
def one_rank_mesh():
    """``make_mesh`` in this process with no process group: a one-rank
    gloo group of its own, destroyed after the module."""
    assert not dist.is_initialized()
    mesh = sh.make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32_hp", "float64"])
@pytest.mark.parametrize("mode", sorted(ftt.MODE_OPTIONS))
def test_one_rank_group_gives_the_unsharded_bits(one_rank_mesh, mode, dtype):
    """A one-rank group solves exactly as the unsharded port: the float64
    all-reduce of one rank returns its input, and in hp mode the fused
    map's f is the unsharded loop's f(d) bit for bit."""
    p = problems.build("lasso", m=240, n=96, k=10, dtype=dtype,
                       device="cpu")
    sp = sh.shard_problem(p, one_rank_mesh)
    assert sp.name == "lasso[240x96]@1dev"
    opts = ftt.FastaOptions(tol=1e-9, max_iters=120,
                            **ftt.MODE_OPTIONS[mode])
    sh.reset_collective_counts()
    got = ftt.make_solver(opts)(sp.op, sp.fterm, sp.gterm, sp.x0, 0.05)
    counts = sh.collective_counts()
    ref = ftt.make_solver(opts)(p.op, p.fterm, p.gterm, p.x0, 0.05)
    for key in SERIES:
        assert torch.equal(getattr(got, key), getattr(ref, key)), key
    assert got.iteration_count == ref.iteration_count
    assert got.total_backtracks == ref.total_backtracks
    assert counts["all_reduce"] >= 2 + got.iteration_count


# (case, extra all-reduces per iteration, the reason): the set-up makes 2
# (f(A x0) and the first gradient map's adjoint), each trial one fused
# map; FISTA evaluates f at its extrapolated point for the window (+1),
# and where ∇f is not affine in d (the hinge) the gradient there too (+1)
BUDGETS = {
    "lasso": ("lasso", 0, "adaptive: one fused map a trial"),
    "lasso_fista": ("lasso", 1, "FISTA: f at the extrapolated point"),
    "sparse": ("sparse", 0, "adaptive: the sparse rows' fused map"),
    "cdp": ("cdp", 2, "FISTA, hinge: f and the gradient at the "
                      "extrapolated point"),
    "phase_retrieval": ("phase_retrieval", 2, "FISTA, hinge: f and the "
                                              "gradient at the extrapolated "
                                              "point"),
}


@pytest.mark.parametrize("budget", sorted(BUDGETS))
def test_collective_budget(ranks, budget):
    """The collectives of a solve, read from the counter: all-reduces only
    (nothing gathered), 2 for the set-up, one a gradient-map evaluation
    (a line-search trial) and the named extras a FISTA iteration."""
    case, per_iteration, _reason = BUDGETS[budget]
    name, build_kw, tau0, solve_kw = CASES[case]
    kw = dict(tol=1e-9, max_iters=50, **solve_kw)
    if budget == "lasso_fista":
        kw.update(FISTA)
    outs = ranks.run("solve", name, build_kw, tau0, kw)
    for out in outs:
        k = int(out["iteration_count"])
        trials = k + int(out["total_backtracks"])
        assert set(out["counts"]) == {"all_reduce"}
        assert out["counts"]["all_reduce"] == 2 + trials + per_iteration * k


def test_every_rank_takes_the_same_decisions(ranks):
    """The counterpart of ``test_multihost.py``: in all three modes, in
    float64 and in float32 with hp decisions, every rank's τ, residual, f
    and backtrack series, its solution and its iteration count are the
    same bit for bit."""
    for dtype in ("float32", "float64"):
        for mode, kw in ftt.MODE_OPTIONS.items():
            outs = ranks.run("solve", "lasso",
                             dict(m=240, n=96, k=10, dtype=dtype), 0.05,
                             dict(tol=1e-9, max_iters=120, **kw))
            for out in outs[1:]:
                for key in SERIES + ("iteration_count",):
                    assert np.array_equal(out[key], outs[0][key]), \
                        (dtype, mode, key)
