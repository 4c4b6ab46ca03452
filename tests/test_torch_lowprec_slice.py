"""Slice 6 of the port end to end on the CPU: bfloat16 storage
(``LowPrecDenseOp``, bfloat16 ``PlanarDenseOp``), its dispatch onto the
one-read gradient maps, the float32 refinement workflow, ``checkpoint``
(files both packages read) and the planar whole solve past 512 columns
(ROADMAP C-4), against ``fasta_tpu``.

bfloat16 matrices are rounded once, in JAX, and their bits carried to the
port (``convert``), so both packages hold the same values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fasta_tpu as ft
import fasta_tpu_torch as ftt
import problems as jax_problems
from fasta_tpu import checkpoint as jax_ckpt
from fasta_tpu.micro import _dispatch as jax_dispatch
from fasta_tpu.serving import recommend_path as jax_recommend_path
from fasta_tpu_torch import checkpoint, problems
from fasta_tpu_torch.convert import (bf16_tensor, lowprec_op_from_arrays,
                                     planar_op_from_arrays,
                                     problem_from_instance)
from fasta_tpu_torch.kernels import lstsq_fused, planar_fused
from fasta_tpu_torch.micro import _dispatch

torch.set_num_threads(1)


def _jax_bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


# --------------------------------------------------------------------------
# The operators
# --------------------------------------------------------------------------

def test_lowprec_products_match_jax_on_identical_bits():
    """``__call__`` and ``rmatvec`` round the vector to bfloat16 and sum
    exact products in float32, as JAX's dot_general does: rtol 1e-6 on the
    same bits; float32 outputs; the storage error of
    ``test_lowprec_matvec_accuracy`` (< 2e-2 of the float32 product)."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((64, 32)).astype(np.float32)
    x = rng.standard_normal(32).astype(np.float32)
    y = rng.standard_normal(64).astype(np.float32)
    op_j = ft.LowPrecDenseOp.from_dense(A)
    op_t = lowprec_op_from_arrays(np.asarray(op_j.A), device="cpu")
    assert op_t.A.dtype == torch.bfloat16 and op_t.shape == (64, 32)
    d = op_t(torch.from_numpy(x))
    g = op_t.rmatvec(torch.from_numpy(y))
    assert d.dtype == g.dtype == torch.float32
    np.testing.assert_allclose(d.numpy(), np.asarray(op_j(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g.numpy(),
                               np.asarray(op_j.rmatvec(jnp.asarray(y))),
                               rtol=1e-6, atol=1e-6)
    ref = A @ x
    assert np.abs(d.numpy() - ref).max() / np.abs(ref).max() < 2e-2
    # lanes: one batched product, each lane the single product
    X = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    torch.testing.assert_close(op_t.lanes(X), torch.stack([op_t(v) for v in X]),
                               rtol=1e-6, atol=1e-6)
    Y = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    torch.testing.assert_close(op_t.rmatvec_lanes(Y),
                               torch.stack([op_t.rmatvec(v) for v in Y]),
                               rtol=1e-6, atol=1e-6)


def test_lowprec_adjoint_and_construction():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((40, 20)).astype(np.float32)
    op = ftt.LowPrecDenseOp.from_dense(A, device="cpu")
    assert op.A.dtype == torch.bfloat16
    # the probe vectors are rounded to bf16 inside each op, so consistency
    # holds at bf16 level (tests/unit/test_mixed_precision.py)
    ftt.check_adjoint(op, torch.zeros(20), torch.Generator().manual_seed(0),
                      rtol=5e-2)
    half = ftt.LowPrecDenseOp.from_dense(torch.from_numpy(A), torch.float16)
    assert half.A.dtype == torch.float16 and half(torch.ones(20)).dtype == \
        torch.float32
    # not a DenseOp: no whole-solve kernel takes it, as in JAX
    assert not isinstance(op, ftt.DenseOp)
    p = problems.build("lasso", m=40, n=20, k=3, device="cpu")
    ok, why = ftt.microsolve_supported(p.with_parts(op=op))
    assert not ok and "LowPrecDenseOp" in why
    pj = jax_problems.build("lasso", m=40, n=20, k=3)
    assert jax_dispatch(pj.with_parts(
        op=ft.LowPrecDenseOp.from_dense(A)))[0] is None


def test_bf16_planar_and_dense_ops_promote_like_jax():
    """A bfloat16 PlanarDenseOp (and a DenseOp over a bfloat16 matrix)
    computes jnp.matmul's promoted product: the channels upcast, the
    vector in float32."""
    rng = np.random.default_rng(2)
    Ac = rng.standard_normal((48, 16)) + 1j * rng.standard_normal((48, 16))
    op_j = ft.PlanarDenseOp.from_complex(Ac, dtype=jnp.bfloat16)
    op_t = planar_op_from_arrays(op_j.Ar, op_j.Ai, device="cpu")
    assert op_t.Ar.dtype == torch.bfloat16
    x = rng.standard_normal((16, 2)).astype(np.float32)
    y = rng.standard_normal((48, 2)).astype(np.float32)
    d = op_t(torch.from_numpy(x))
    assert d.dtype == torch.float32
    # two float32 products per channel, summed in another order: 1e-6 of
    # the largest entry
    for got, want in ((d, op_j(jnp.asarray(x))),
                      (op_t.rmatvec(torch.from_numpy(y)),
                       op_j.rmatvec(jnp.asarray(y)))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    op_c = ftt.PlanarDenseOp.from_complex(Ac, torch.bfloat16, device="cpu")
    assert op_c.Ar.dtype == torch.bfloat16
    A16 = bf16_tensor(np.asarray(_jax_bf16(Ac.real)), device="cpu")
    dense = ftt.DenseOp(A16)
    v = torch.from_numpy(x[:, 0].copy())
    np.testing.assert_allclose(
        dense(v).numpy(), np.asarray(ft.DenseOp(_jax_bf16(Ac.real))(
            jnp.asarray(v.numpy()))), rtol=1e-6, atol=1e-6)


def test_bf16_tensor_carries_jax_bits_exactly():
    rng = np.random.default_rng(3)
    a = np.asarray(_jax_bf16(rng.standard_normal((5, 7)) * 1e3))
    t = bf16_tensor(a, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


# --------------------------------------------------------------------------
# The dispatch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("term", ["lstsq", "logistic", "squared_hinge"])
def test_lowprec_dispatch_gate(monkeypatch, term):
    """bfloat16 storage past the reference's 64 MB gate takes the kernel
    wrapper; at or below it, None (the two-call path); float16 always
    None.  Checked on meta tensors: nothing large is allocated."""
    calls = []
    for name in ("fused_lstsq_gradmap", "fused_pointwise_gradmap"):
        monkeypatch.setattr(lstsq_fused, name,
                            lambda *a, name=name: calls.append(name))
    m = 8192
    data = torch.zeros(m, device="meta")
    f = {"lstsq": ftt.LeastSquares, "logistic": ftt.Logistic,
         "squared_hinge": ftt.SquaredHinge}[term](data)

    def op(n, dtype=torch.bfloat16):
        return ftt.LowPrecDenseOp(torch.empty((m, n), dtype=dtype,
                                              device="meta"))

    assert f.fused_gradmap(op(4096)) is None              # 64 MB exactly
    fused = f.fused_gradmap(op(4097))
    assert fused is not None
    fused(torch.zeros(4097, device="meta"))
    assert calls == ["fused_lstsq_gradmap" if term == "lstsq"
                     else "fused_pointwise_gradmap"]
    assert f.fused_gradmap(op(8192, torch.float16)) is None
    assert f.fused_gradmap(ftt.LowPrecDenseOp(
        torch.empty((m, 8192), dtype=torch.bfloat16, device="meta"))) \
        is not None


def test_bf16_planar_takes_k_b7_at_any_size():
    p = problems.build("phase_retrieval", m=32, n=8, planar=True,
                       device="cpu")
    op = ftt.PlanarDenseOp(p.op.Ar.to(torch.bfloat16),
                           p.op.Ai.to(torch.bfloat16))
    for term, b in ((p.fterm, p.fterm.b),
                    (ftt.LeastSquares(torch.ones((32, 2))), None)):
        fused = term.fused_gradmap(op)
        assert fused is not None
        before = planar_fused.BF16_LAUNCHES
        d, f, g = fused(p.x0)
        assert planar_fused.BF16_LAUNCHES == before and g.dtype == \
            torch.float32
    half = ftt.PlanarDenseOp(p.op.Ar.half(), p.op.Ai.half())
    assert p.fterm.fused_gradmap(half) is None


# --------------------------------------------------------------------------
# The refinement workflow
# --------------------------------------------------------------------------

# The bfloat16 phase's tolerance.  tests/unit/test_mixed_precision.py asks
# for 1e-3, which sits on this instance's bfloat16 floor: its ratio
# residual hovers at 1.1e-3 from iteration 26, and whether a run stops
# there (JAX: at iteration 41) or stalls (the port: at 125, τ = 2.4e-7,
# a resume from which takes no step) turns on the order of float32 sums.
# 2e-3 stops both packages at the same iterate, before the floor.
TOL16 = 2e-3


def test_refinement_workflow_reaches_f32_quality_in_both_packages():
    """bf16 solve (coarse) + f32 warm restart reaches the from-scratch f32
    objective (within 1e-4) in fewer iterations, and JAX's refined
    objective within 1e-5, on identical bits."""
    pj = jax_problems.build("lasso", m=128, n=256, k=12, dtype=jnp.float32)
    pj.tau0 = 0.05
    op_j = ft.LowPrecDenseOp.from_dense(pj.instance["A"])
    j16 = pj.with_parts(op=op_j).solve(tol=TOL16, max_iters=400,
                                       record_objective=True)
    j_ref = jax_ckpt.resume(pj, j16, tol=1e-6, max_iters=400,
                            record_objective=True)

    pt = problem_from_instance(pj.instance, device="cpu", dtype=torch.float32)
    pt.tau0 = 0.05
    r_full = pt.solve(tol=1e-6, max_iters=400, record_objective=True)
    op_t = lowprec_op_from_arrays(np.asarray(op_j.A), device="cpu")
    r16 = pt.with_parts(op=op_t).solve(tol=TOL16, max_iters=400,
                                       record_objective=True)
    r_ref = checkpoint.resume(pt, r16, tol=1e-6, max_iters=400,
                              record_objective=True)
    assert r_ref.initial_tau == pytest.approx(float(r16.taus[-1]))
    assert abs(r_ref.objectives[-1] - r_full.objectives[-1]) < 1e-4 * max(
        abs(r_full.objectives[-1]), 1e-10)
    assert r_ref.iteration_count < r_full.iteration_count
    assert abs(r_ref.objectives[-1] - j_ref.objectives[-1]) < 1e-5 * abs(
        j_ref.objectives[-1])
    np.testing.assert_allclose(r16.taus[:10], np.asarray(j16.taus[:10]),
                               rtol=1e-4)


def test_planar_bf16_solve_tracks_jax_and_refines():
    """The planar bfloat16 solve at 1024x64 against JAX's (both compute A
    upcast with x in float32: the port through K-B7's plain version, JAX
    through its two-call path), held as the float32 planar slice is
    (tests/test_torch_phase_slice.py): the first 10 taus rtol 1e-4, the
    final objective rtol 1e-5, the counts within max(5, 20%).  Then the
    float32 resume, and Problem.microsolve on the bfloat16 problem, which
    solves the upcast channels."""
    pj = jax_problems.build("phase_retrieval", m=1024, n=64, planar=True,
                            dtype=jnp.float32)
    A = pj.instance["A"]
    op_j = ft.PlanarDenseOp.from_complex(A, dtype=jnp.bfloat16)
    jb = pj.with_parts(op=op_j).solve(tau0=1.0, tol=1e-3, max_iters=500,
                                      record_objective=True)
    pt = problem_from_instance(pj.instance, device="cpu", dtype=torch.float32,
                               planar=True)
    op_t = planar_op_from_arrays(op_j.Ar, op_j.Ai, device="cpu")
    pb = pt.with_parts(op=op_t)
    tb = pb.solve(tau0=1.0, tol=1e-3, max_iters=500, record_objective=True)
    assert tb.converged and jb.converged
    np.testing.assert_allclose(tb.taus[:10], np.asarray(jb.taus[:10]),
                               rtol=1e-4)
    assert tb.objectives[-1] == pytest.approx(float(jb.objectives[-1]),
                                              rel=1e-5)
    assert abs(tb.iteration_count - jb.iteration_count) <= max(
        5, int(0.2 * jb.iteration_count))
    full = pt.solve(tau0=1.0, tol=1e-5, max_iters=500, record_objective=True)
    ref = checkpoint.resume(pt, tb, tol=1e-5, max_iters=500,
                            record_objective=True)
    assert ref.converged
    assert abs(ref.objectives[-1] - full.objectives[-1]) <= 1e-4 * abs(
        full.objectives[-1])
    micro = pb.microsolve(tau0=1.0, max_iters=40, tol=0.0, hp=True)
    up = pt.with_parts(op=ftt.PlanarDenseOp(op_t.Ar.float(), op_t.Ai.float()))
    assert torch.equal(micro.solution, up.microsolve(
        tau0=1.0, max_iters=40, tol=0.0, hp=True).solution)


# --------------------------------------------------------------------------
# checkpoint (tests/unit/test_checkpoint.py, in the port)
# --------------------------------------------------------------------------

def test_pytree_roundtrip(tmp_path):
    prob = problems.build("lasso", m=64, n=96, k=8, dtype=torch.float64,
                          device="cpu")
    prob.tau0 = 0.05
    r = prob.solve(tol=1e-8, max_iters=30)
    path = str(tmp_path / "result.npz")
    checkpoint.save_pytree(r.__dict__, path)
    loaded = checkpoint.load_pytree(r.__dict__, path)
    np.testing.assert_allclose(loaded["solution"], r.solution)
    np.testing.assert_allclose(loaded["taus"], r.taus)
    # the dataclass itself, and a NamedTuple of tensors, keep their types
    back = checkpoint.load_pytree(r, checkpoint.save_pytree(
        r, str(tmp_path / "dc.npz")))
    assert type(back) is type(r) and back.iteration_count == \
        r.iteration_count and isinstance(back.iteration_count, int)
    dev = prob.solve_device(ftt.FastaOptions(tol=1e-8, max_iters=30))
    again = checkpoint.load_pytree(dev, checkpoint.save_pytree(
        dev, str(tmp_path / "nt.npz")))
    assert type(again) is type(dev) and torch.equal(again.solution,
                                                    dev.solution)
    assert again.objectives is None


def test_resume_continues_progress():
    prob = problems.build("lasso", m=64, n=96, k=8, dtype=torch.float64,
                          device="cpu")
    prob.tau0 = 0.05
    r1 = prob.solve(tol=1e-12, max_iters=10, record_objective=True)
    r2 = checkpoint.resume(prob, r1, tol=1e-12, max_iters=10,
                           record_objective=True)
    # warm restart must not regress the objective
    assert r2.objectives[-1] <= r1.objectives[-1] + 1e-9
    # and it starts from the prior solution
    assert r2.initial_tau == float(r1.taus[-1])


def test_resume_places_the_start_like_the_problem(monkeypatch):
    """A host result resumes in the problem's own dtype and on its own
    device (here a float32 problem on the meta device, whose solve is
    intercepted)."""
    prob = ftt.Problem("p", op=None, fterm=None, gterm=None,
                       x0=torch.zeros(4, device="meta"))
    seen = []
    monkeypatch.setattr(ftt.Problem, "solve",
                        lambda self, options=None, **kw: seen.append(
                            (self.x0, self.tau0)))
    res = ftt.FastaResult(
        solution=np.arange(4.0), best_iterate=None, iteration_count=2,
        converged=True, residuals=None, norm_residuals=None,
        taus=np.array([0.5, 0.25]), fvals=None, objectives=None,
        backtracks=None, total_backtracks=0, solve_time=0.0,
        L_estimate=None, initial_tau=0.5)
    checkpoint.resume(prob, res)
    x0, tau = seen[0]
    assert x0.device.type == "meta" and x0.dtype == torch.float32
    assert tau == 0.25


def test_complex_pytree_roundtrip(tmp_path):
    prob = problems.build("phase_retrieval", m=128, n=8,
                          dtype=torch.complex128, device="cpu")
    prob.tau0 = 1.0
    r = prob.solve(tol=1e-6, max_iters=10)
    path = str(tmp_path / "c.npz")
    checkpoint.save_pytree({"x": r.solution}, path)
    loaded = checkpoint.load_pytree({"x": r.solution}, path)
    np.testing.assert_allclose(loaded["x"], r.solution)


def test_load_legacy_positional_format(tmp_path):
    """Round-1 checkpoints used positional leaf_{i} keys; the loader
    falls back to flatten-order assignment for them."""
    src = {"a": np.arange(3.0), "b": np.ones((2, 2))}
    p = str(tmp_path / "legacy.npz")
    np.savez(p, leaf_0=src["a"], leaf_1=src["b"])
    out = checkpoint.load_pytree({"a": np.zeros(3), "b": np.zeros((2, 2))}, p)
    np.testing.assert_array_equal(out["a"], src["a"])
    np.testing.assert_array_equal(out["b"], src["b"])


def test_load_rejects_mismatched_structure(tmp_path):
    src = {"a": np.arange(3.0), "b": np.ones((2, 2))}
    p = str(tmp_path / "ck.npz")
    checkpoint.save_pytree(src, p)
    with pytest.raises(ValueError, match="does not match"):
        checkpoint.load_pytree({"a": np.arange(3.0), "c": np.ones((2, 2))}, p)
    out = checkpoint.load_pytree({"a": np.zeros(3), "b": np.zeros((2, 2))}, p)
    np.testing.assert_array_equal(out["a"], src["a"])
    np.testing.assert_array_equal(out["b"], src["b"])


def test_bf16_leaves_round_trip_exactly(tmp_path):
    """NumPy has no bfloat16: a bfloat16 tensor is stored as float32
    (exact) and comes back in the example's dtype."""
    t = bf16_tensor(np.asarray(_jax_bf16(np.linspace(-3, 3, 11))),
                    device="cpu")
    p = checkpoint.save_pytree({"A": t, "k": 3}, str(tmp_path / "b.npz"))
    with np.load(p) as data:
        assert data["A"].dtype == np.float32 and data["k"].shape == ()
    back = checkpoint.load_pytree({"A": t, "k": 0}, p)
    assert back["A"].dtype == torch.bfloat16 and torch.equal(back["A"], t)
    assert back["k"] == 3 and isinstance(back["k"], int)


def test_checkpoints_cross_load_between_packages(tmp_path):
    """A file written by fasta_tpu.checkpoint loads in the port and the
    port's loads in fasta_tpu: the same keys, the same arrays — a JAX
    result into a port result and back, and nested trees."""
    pj = jax_problems.build("lasso", m=64, n=96, k=8, dtype=jnp.float32)
    rj = pj.solve(tau0=0.05, tol=1e-8, max_iters=30)
    pt = problem_from_instance(pj.instance, device="cpu", dtype=torch.float32)
    rt = pt.solve(tau0=0.05, tol=1e-8, max_iters=30)
    pj_path = str(tmp_path / "from_jax.npz")
    jax_ckpt.save_pytree(rj.__dict__, pj_path)
    into_port = checkpoint.load_pytree(rt, pj_path)
    np.testing.assert_array_equal(into_port.solution, np.asarray(rj.solution))
    assert into_port.iteration_count == rj.iteration_count
    pt_path = str(tmp_path / "from_port.npz")
    checkpoint.save_pytree(rt, pt_path)
    into_jax = jax_ckpt.load_pytree(rj.__dict__, pt_path)
    np.testing.assert_array_equal(into_jax["taus"], rt.taus)
    tree = {"b": [np.ones(3), (np.arange(2.0), np.zeros(1))],
            "a": {"y": np.eye(2), "x": 1.5}, "none": None}
    for save, load in ((jax_ckpt.save_pytree, checkpoint.load_pytree),
                       (checkpoint.save_pytree, jax_ckpt.load_pytree)):
        path = save(tree, str(tmp_path / "tree.npz"))
        out = load(tree, path)
        np.testing.assert_array_equal(out["b"][1][0], tree["b"][1][0])
        np.testing.assert_array_equal(out["a"]["y"], tree["a"]["y"])
        assert float(out["a"]["x"]) == 1.5 and out["none"] is None
    with np.load(str(tmp_path / "tree.npz")) as data:
        assert set(data.files) == {"a/x", "a/y", "b/0", "b/1/0", "b/1/1"}
    jax_ckpt.save_pytree(np.arange(3.0), str(tmp_path / "root.npz"))
    np.testing.assert_array_equal(checkpoint.load_pytree(
        np.zeros(3), str(tmp_path / "root.npz")), np.arange(3.0))


# --------------------------------------------------------------------------
# C-4: the planar whole solve past 512 columns
# --------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 4])
def test_wide_planar_dispatch_and_routes_match_the_reference(batch):
    """At 256x516 the planar structure is inside the reference's gate:
    the port's microsolve_supported and recommend_path agree with
    fasta_tpu's, and the route runs (here the plain version)."""
    pj = jax_problems.build("phase_retrieval", m=256, n=516, planar=True,
                            dtype=jnp.float32)
    pt = problem_from_instance(pj.instance, device="cpu", dtype=torch.float32,
                               planar=True)
    pt.tau0 = pj.tau0 = 1.0
    assert ftt.microsolve_supported(pt) == (True, "planar")
    assert _dispatch(pt)[0] == jax_dispatch(pj)[0] == "planar"
    plan = ftt.recommend_path(pt, batch)
    assert plan.path == jax_recommend_path(pj, batch).path
    if batch == 1:
        r = plan.run(max_iters=20, tol=1e-5, hp=True)
        assert r.iteration_count == 20 and r.solution.shape == (516, 2)
    else:
        bs = torch.stack([pt.fterm.b * (1.0 + 0.02 * i) for i in range(4)])
        out = pt.microsolve_batch(bs, max_iters=10, tol=0.0)
        one = pt.with_parts(fterm=ftt.PlanarPhaseHinge(bs[3])).microsolve(
            max_iters=10, tol=0.0)
        assert torch.equal(out.solutions[3], one.solution)
