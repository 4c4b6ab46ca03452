"""Phase retrieval through the port's public entry points — the planar
and complex problems, ``PlanarDenseOp``, the terms, ``Problem.solve``,
``Problem.microsolve`` and its dispatch, ``recovery_error`` and
``convert`` — held against ``fasta_tpu`` and the float64 oracle (CPU),
and the default device of ``problems.build`` and ``as_linear_op``.

Bands: the planar loop is tests/parity/test_planar.py's (256x16, τ₀ 1.0,
tol 1e-8, 150 iterations, float64: equal counts, residuals and taus rtol
1e-4 — the planar product sums in another order than the complex
matvec — and the complex solution atol 1e-8); the complex loop is
tests/parity/test_parity.py's (complex128: the first 10 taus and
f-values rtol 1e-7, residuals rtol 1e-6 / atol 1e-12, the final
objective within 1e-5, the count within max(5, 20%)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fasta_tpu as ft
import fasta_tpu_torch as ftt
import problems as jax_problems
from fasta_tpu.micro import _dispatch as jax_dispatch
from fasta_tpu_torch import problems
from fasta_tpu_torch.convert import problem_from_instance, result_to_numpy
from fasta_tpu_torch.harness import MODE_OPTIONS as MODES
from fasta_tpu_torch.kernels import microsolver_planar, planar_fused
from fasta_tpu_torch.micro import _dispatch
from reference_oracle.fasta_numpy import fasta as fasta_np

torch.set_num_threads(1)


def _complex(xp):
    xp = np.asarray(xp)
    return xp[..., 0] + 1j * xp[..., 1]


def test_planar_dense_adjoint_and_complex_matvec():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((24, 10)) + 1j * rng.standard_normal((24, 10))
    op = ftt.PlanarDenseOp.from_complex(A, torch.float64, device="cpu")
    assert op.shape == (24, 10)
    assert ftt.check_adjoint(op, torch.zeros((10, 2), dtype=torch.float64),
                             torch.Generator().manual_seed(0),
                             rtol=1e-10) <= 1e-10
    x = rng.standard_normal(10) + 1j * rng.standard_normal(10)
    y = rng.standard_normal(24) + 1j * rng.standard_normal(24)
    xp = torch.from_numpy(np.stack([x.real, x.imag], -1))
    yp = torch.from_numpy(np.stack([y.real, y.imag], -1))
    np.testing.assert_allclose(_complex(op(xp)), A @ x, atol=1e-12)
    np.testing.assert_allclose(_complex(op.rmatvec(yp)), A.conj().T @ y,
                               atol=1e-12)
    op_j = ft.PlanarDenseOp.from_complex(A, jnp.float64)
    np.testing.assert_allclose(op(xp).numpy(), np.asarray(op_j(xp.numpy())),
                               atol=1e-13)
    np.testing.assert_allclose(op.rmatvec(yp).numpy(),
                               np.asarray(op_j.rmatvec(yp.numpy())),
                               atol=1e-13)


@pytest.mark.parametrize("planar", [True, False])
def test_terms_match_jax(planar):
    """The hinge's value, float64 value and gradient, and the anchor's
    value and prox, against the JAX terms (float64, 1e-12)."""
    pj = jax_problems.build("phase_retrieval", m=40, n=8, planar=planar,
                            dtype=jnp.complex128)
    pt = problems.build("phase_retrieval", m=40, n=8, planar=planar,
                        dtype=torch.complex128, device="cpu")
    x = np.asarray(pj.x0) * 1.3
    d_j = pj.op(jnp.asarray(x))
    d_t = pt.op(torch.from_numpy(np.array(x)))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-13)
    assert float(pt.fterm.value(d_t)) == pytest.approx(
        float(pj.fterm.value(d_j)), rel=1e-12)
    assert float(pt.fterm.value_f64(d_t)) == pytest.approx(
        float(pj.fterm.value(d_j)), rel=1e-12)
    np.testing.assert_allclose(pt.fterm.grad(d_t).numpy(),
                               np.asarray(pj.fterm.grad(d_j)), atol=1e-13)
    xt = torch.from_numpy(np.array(x))
    assert float(pt.gterm.value(xt)) == pytest.approx(
        float(pj.gterm.value(jnp.asarray(x))), rel=1e-12)
    np.testing.assert_allclose(pt.gterm.prox(xt, 0.7).numpy(),
                               np.asarray(pj.gterm.prox(jnp.asarray(x), 0.7)),
                               atol=1e-14)


@pytest.mark.parametrize("mode", ["adaptive", "accelerated"])
def test_planar_loop_matches_oracle_and_jax_f64(mode):
    pt = problems.build("phase_retrieval", m=256, n=16, planar=True,
                        dtype=torch.float64, device="cpu")
    pj = jax_problems.build("phase_retrieval", m=256, n=16, planar=True,
                            dtype=jnp.float64)
    inst = pt.instance
    skw = dict(tol=1e-8, max_iters=150, **MODES[mode])
    r_np = fasta_np(inst["op"], None, inst["f"], inst["gradf"], inst["g"],
                    inst["proxg"], inst["x0"], tau0=1.0, **skw)
    pt.tau0 = pj.tau0 = 1.0
    r_t = pt.solve(**skw)
    r_j = pj.solve(**skw)
    for r_ref in (r_np, r_j):
        assert r_t.iteration_count == r_ref.iteration_count
        k = r_t.iteration_count
        np.testing.assert_allclose(r_t.residuals[:k], r_ref.residuals[:k],
                                   rtol=1e-4, atol=1e-11)
        np.testing.assert_allclose(r_t.taus[:k], r_ref.taus[:k], rtol=1e-4)
    np.testing.assert_allclose(_complex(r_t.solution), r_np.solution,
                               atol=1e-8)
    np.testing.assert_allclose(r_t.solution, np.asarray(r_j.solution),
                               atol=1e-8)
    assert pt.recovery_error(r_t.solution) < 0.1


@pytest.mark.parametrize("mode", list(MODES))
def test_complex_loop_matches_oracle_c128(mode):
    pt = problems.build("phase_retrieval", m=256, n=16,
                        dtype=torch.complex128, device="cpu")
    inst = pt.instance
    skw = dict(tol=1e-8, max_iters=150, record_objective=True,
               **MODES[mode])
    r_np = fasta_np(inst["op"], None, inst["f"], inst["gradf"], inst["g"],
                    inst["proxg"], inst["x0"], tau0=1.0, **skw)
    pt.tau0 = 1.0
    r_t = pt.solve(**skw)
    k = min(10, r_t.iteration_count, r_np.iteration_count)
    np.testing.assert_allclose(r_t.taus[:k], r_np.taus[:k], rtol=1e-7)
    np.testing.assert_allclose(r_t.residuals[:k], r_np.residuals[:k],
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(r_t.fvals[:k], r_np.fvals[:k], rtol=1e-7,
                               atol=1e-12)
    scale = max(abs(r_np.objectives[-1]), 1e-10)
    assert abs(r_t.objectives[-1] - r_np.objectives[-1]) / scale < 1e-5
    assert abs(r_t.iteration_count - r_np.iteration_count) <= \
        max(5, int(0.2 * r_np.iteration_count))


def test_planar_f32_loop_takes_the_fused_map_and_tracks_jax(monkeypatch):
    """The float32 planar loop goes through K-B7's plain version on the
    CPU (no launch is counted) and tracks fasta_tpu's float32 loop: the
    first 10 taus rtol 1e-4 and the converged objective within 1e-5."""
    pt = problems.build("phase_retrieval", m=512, n=32, planar=True,
                        device="cpu")
    pj = jax_problems.build("phase_retrieval", m=512, n=32, planar=True,
                            dtype=jnp.float32)
    assert pt.fterm.fused_gradmap(pt.op) is not None
    calls = []
    real = planar_fused.planar_hinge_gradmap_reference

    def spy(*args):
        calls.append(1)
        return real(*args)

    before = planar_fused.LAUNCHES
    monkeypatch.setattr(planar_fused, "planar_hinge_gradmap_reference", spy)
    r_t = pt.solve(tau0=1.0, tol=1e-5, max_iters=500, record_objective=True)
    assert calls and planar_fused.LAUNCHES == before
    r_j = pj.solve(tau0=1.0, tol=1e-5, max_iters=500, record_objective=True)
    assert r_t.converged and r_j.converged
    np.testing.assert_allclose(r_t.taus[:10], r_j.taus[:10], rtol=1e-4)
    assert abs(r_t.objectives[-1] - r_j.objectives[-1]) <= \
        1e-5 * abs(r_j.objectives[-1])


def test_fused_gradmap_dispatch():
    """An f32 PlanarDenseOp takes K-B7 for either loss; float64 and the
    complex DenseOp take the two-call path, as in the JAX package."""
    p32 = problems.build("phase_retrieval", m=32, n=8, planar=True,
                         device="cpu")
    p64 = problems.build("phase_retrieval", m=32, n=8, planar=True,
                         dtype=torch.float64, device="cpu")
    pc = problems.build("phase_retrieval", m=32, n=8, device="cpu")
    x = p32.x0
    d, f, g = p32.fterm.fused_gradmap(p32.op)(x)
    d0, f0, g0 = planar_fused.planar_hinge_gradmap_reference(
        p32.op.Ar, p32.op.Ai, x, p32.fterm.b)
    assert torch.equal(d, d0) and torch.equal(f, f0) and torch.equal(g, g0)
    assert p64.fterm.fused_gradmap(p64.op) is None
    assert pc.fterm.fused_gradmap(pc.op) is None
    b = torch.ones((32, 2))
    lsq = ftt.LeastSquares(b).fused_gradmap(p32.op)
    d, f, g = lsq(x)
    d0, f0, g0 = planar_fused.planar_lstsq_gradmap_reference(
        p32.op.Ar, p32.op.Ai, x, b)
    assert torch.equal(g, g0) and torch.equal(f, f0)
    assert ftt.LeastSquares(b.double()).fused_gradmap(p64.op) is None


def test_microsolve_on_the_cpu_recovers_the_signal():
    """Problem.microsolve (K-B8's plain version on the CPU) at 512x32,
    hp, tol 1e-5: converged with recovery error < 0.05
    (tests/unit/test_microsolver_planar.py), iterates (k, n, 2)."""
    pt = problems.build("phase_retrieval", m=512, n=32, planar=True,
                        device="cpu")
    before = microsolver_planar.LAUNCHES
    r = pt.microsolve(tau0=1.0, max_iters=500, tol=1e-5, hp=True,
                      record_iterates=True, record_objs=True)
    assert microsolver_planar.LAUNCHES == before
    assert r.converged and r.status == "converged"
    assert r.solution.shape == (32, 2)
    assert r.iterates.shape == (r.iteration_count, 32, 2)
    np.testing.assert_array_equal(r.iterates[-1], r.solution.numpy())
    assert pt.recovery_error(r.solution, recovered=False) < 0.05
    assert r.best_index is not None
    pj = jax_problems.build("phase_retrieval", m=512, n=32, planar=True,
                            dtype=jnp.float32)
    rj = ft.microsolve(pj, tau0=1.0, max_iters=500, tol=1e-5, hp=True,
                       interpret=True)
    np.testing.assert_allclose(r.solution.numpy(), np.asarray(rj.solution),
                               atol=1e-4)


def _shaped(m, n):
    """A planar problem of shape m×n with no data (the dispatch reads
    shapes only), for both packages."""
    ops_t = ftt.PlanarDenseOp(torch.empty((m, n), device="meta"),
                              torch.empty((m, n), device="meta"))
    pt = ftt.Problem("p", ops_t, ftt.PlanarPhaseHinge(torch.empty(m)),
                     ftt.PlanarLinearAnchor(torch.empty((n, 2))),
                     torch.empty((n, 2)))
    shape = jax.ShapeDtypeStruct((m, n), jnp.float32)
    pj = ft.Problem("p", ft.PlanarDenseOp(shape, shape),
                    ft.PlanarPhaseHinge(jnp.zeros(m)),
                    ft.PlanarLinearAnchor(jnp.zeros((n, 2))),
                    jnp.zeros((n, 2)))
    return pt, pj


@pytest.mark.parametrize("m,n", [
    (2048, 3072), (2048, 3073), (2049, 16), (4096, 1536), (4096, 1537),
    (4100, 16), (16384, 256), (16384, 384), (16384, 385)])
def test_dispatch_gates_match_the_reference(m, n):
    """The reference's two gates — both channels within 48 MB, and m
    admitting a 128-multiple chunk past 2048 — give the same decision, for
    the same cause, on shapes that straddle each."""
    pt, pj = _shaped(m, n)
    kind_t, why_t = _dispatch(pt)
    kind_j, why_j = jax_dispatch(pj)
    assert kind_t == kind_j
    if kind_j is None:
        cause = "row chunk" if "row chunk" in why_j else "48 MB"
        assert cause in why_t


def test_dispatch_other_structures_and_sweep():
    pt = problems.build("phase_retrieval", m=64, n=8, planar=True,
                        device="cpu")
    assert ftt.microsolve_supported(pt) == (True, "planar")
    with pytest.raises(ValueError, match="no penalty weight to sweep"):
        pt.microsolve_sweep([0.1, 0.2], tau0=1.0)
    with pytest.raises(ValueError, match="interpret mode"):
        pt.microsolve(tau0=1.0, interpret=True)
    with pytest.raises(ValueError, match="engine"):
        pt.microsolve(tau0=1.0, engine="vpu")
    pc = problems.build("phase_retrieval", m=64, n=8, device="cpu")
    ok, why = ftt.microsolve_supported(pc)
    assert not ok and "PlanarDenseOp" in why


@pytest.mark.parametrize("planar", [True, False])
def test_recovery_error_matches_jax(planar):
    pj = jax_problems.build("phase_retrieval", m=64, n=8, planar=planar,
                            dtype=jnp.complex128)
    pt = problems.build("phase_retrieval", m=64, n=8, planar=planar,
                        dtype=torch.complex128, device="cpu")
    x = np.asarray(pj.x0) * (0.3 + 0.4j if not planar else 1.2)
    got = pt.recovery_error(torch.from_numpy(np.array(x)))
    assert got == pytest.approx(pj.recovery_error(x), rel=1e-12)
    if planar:
        sig = _complex(x)
        assert pt.recovery_error(sig, recovered=True) == pytest.approx(
            pj.recovery_error(sig, recovered=True), rel=1e-12)
        assert pt.recovery_error(x, recovered=False) == pytest.approx(
            pj.recovery_error(x, recovered=False), rel=1e-12)
        # phase invariance
        assert pt.recovery_error(sig * np.exp(0.7j), recovered=True) == \
            pytest.approx(pt.recovery_error(sig, recovered=True), abs=1e-12)
    pt.x_true = None
    assert np.isnan(pt.recovery_error(x))


@pytest.mark.parametrize("planar", [True, False])
def test_convert_carries_a_jax_instance_across(planar):
    """A JAX instance crosses to the port as the same numbers, solves to
    the same answer, and the result comes back as NumPy."""
    pj = jax_problems.build("phase_retrieval", m=96, n=8, planar=planar,
                            dtype=jnp.complex128)
    pt = problem_from_instance(pj.instance, device="cpu",
                               dtype=torch.complex128, planar=planar)
    if planar:
        assert pt.name == "phase_retrieval_planar[96x8]"
        np.testing.assert_array_equal(pt.op.Ar.numpy(), np.asarray(pj.op.Ar))
        np.testing.assert_array_equal(pt.op.Ai.numpy(), np.asarray(pj.op.Ai))
        assert torch.equal(pt.recover(pt.x0),
                           torch.from_numpy(_complex(np.asarray(pj.x0))))
    else:
        np.testing.assert_array_equal(pt.op.A.numpy(), np.asarray(pj.op.A))
    np.testing.assert_array_equal(pt.fterm.b.numpy(), np.asarray(pj.fterm.b))
    np.testing.assert_array_equal(pt.gterm.c.numpy(), np.asarray(pj.gterm.c))
    np.testing.assert_array_equal(pt.x0.numpy(), np.asarray(pj.x0))
    kw = dict(tau0=1.0, tol=1e-8, max_iters=100)
    r_t = result_to_numpy(pt.solve(**kw))
    r_j = pj.solve(**kw)
    assert r_t["iteration_count"] == r_j.iteration_count
    np.testing.assert_allclose(r_t["solution"], np.asarray(r_j.solution),
                               atol=1e-10)


# --------------------------------------------------------------------------
# C-3: entry points run on the card unless the caller asks for the CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("lasso", dict(m=20, n=40, k=4)), ("nnls", dict(m=20, n=10)),
    ("logistic", dict(m=20, n=10, k=3)), ("svm", dict(m=20, n=5)),
    ("tv", dict(h=6, w=5)), ("phase_retrieval", dict(m=16, n=4)),
    ("phase_retrieval", dict(m=16, n=4, planar=True))])
def test_build_defaults_to_the_card(monkeypatch, name, kw):
    """problems.build(name) with no device places the instance on the
    card; with no card it raises rather than build on the CPU, and
    device="cpu" still builds there."""
    cpu = problems.build(name, device="cpu", **kw)
    assert cpu.x0.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        problems.build(name, **kw)


def test_as_linear_op_defaults_to_the_card(monkeypatch):
    A = np.random.default_rng(0).standard_normal((5, 4))
    assert ftt.as_linear_op(A, device="cpu").A.device.type == "cpu"
    t = torch.from_numpy(A)
    assert ftt.as_linear_op(t).A is t        # a placed tensor stays put
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ftt.as_linear_op(A)
