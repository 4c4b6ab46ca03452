"""Kernels K-B7 (fused planar gradient map), K-P5 (planar layout probe)
and K-B8 (whole planar PhaseMax solve) through their plain versions, held
against the JAX kernels in interpret mode and against independent
formulations (CPU).

Tolerances are the JAX package's own (tests/unit/test_planar_fused.py,
tests/unit/test_microsolver_planar.py): the gradient map's d rtol 1e-4 /
atol 1e-5, f rtol 1e-5, g rtol 2e-4 / atol 1e-4 (float32 sums in another
order); whole solves over a 12-iteration prefix rtol 1e-2 (the hinge
amplifies the float32 accumulation order), runs to tol 1e-5 by status and
solution (hp atol 1e-4, FISTA atol 1e-3 with counts within 2 and the
first 20 residuals rtol 5e-4).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fasta_tpu as ft
import fasta_tpu_torch as ftt
import problems as jax_problems
from fasta_tpu.kernels.microsolver_planar import (
    microsolve_planar_phasemax as jax_micro_planar)
from fasta_tpu.kernels.planar_fused import (
    fused_planar_hinge_gradmap as jax_hinge_gradmap)
from fasta_tpu.kernels.planar_fused import (
    fused_planar_lstsq_gradmap as jax_lstsq_gradmap)
from fasta_tpu_torch.kernels import (microsolver_planar, planar_fused,
                                     planar_probe)
from fasta_tpu_torch.kernels.microsolver_planar import (
    microsolve_planar_phasemax)

torch.set_num_threads(1)
RECORD = dict(record_fvals=True, record_bts=True, record_objs=True,
              record_nres=True)


def _planar(m, n, dtype=np.float32, seed=3):
    """Seeded channel matrices scaled as the generator scales A (entries
    of variance 1/(2m)), x (n, 2), and the generator for further draws."""
    rng = np.random.default_rng(seed)
    Ar = (rng.standard_normal((m, n)) / np.sqrt(2 * m)).astype(dtype)
    Ai = (rng.standard_normal((m, n)) / np.sqrt(2 * m)).astype(dtype)
    x = rng.standard_normal((n, 2)).astype(dtype)
    return Ar, Ai, x, rng


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# --------------------------------------------------------------------------
# K-B7
# --------------------------------------------------------------------------

@pytest.mark.parametrize("loss", ["lstsq", "hinge"])
@pytest.mark.parametrize("m,n", [(64, 256), (130, 256)])  # pow2 + padded
def test_gradmap_plain_version_matches_jax_kernel_interpret(loss, m, n):
    Ar, Ai, x, rng = _planar(m, n)
    if loss == "lstsq":
        b = rng.standard_normal((m, 2)).astype(np.float32)
        jax_fn, ref = jax_lstsq_gradmap, \
            planar_fused.planar_lstsq_gradmap_reference
    else:
        b = (np.abs(rng.standard_normal(m)) + 0.1).astype(np.float32)
        jax_fn, ref = jax_hinge_gradmap, \
            planar_fused.planar_hinge_gradmap_reference
    d0, f0, g0 = jax_fn(*map(jnp.asarray, (Ar, Ai, x, b)), interpret=True)
    d, f, g = ref(*_t(Ar, Ai, x, b))
    np.testing.assert_allclose(d.numpy(), np.asarray(d0), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(f), float(f0), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g0), rtol=2e-4,
                               atol=1e-4)


def test_gradmap_plain_version_matches_the_complex_formulation():
    """The planar least-squares map equals the native complex one: the
    planar layout is the same math (tests/unit/test_planar_fused.py)."""
    m, n = 48, 32
    Ar, Ai, x, rng = _planar(m, n, np.float64)
    b = rng.standard_normal((m, 2))
    d, f, g = planar_fused.planar_lstsq_gradmap_reference(*_t(Ar, Ai, x, b))
    A = Ar + 1j * Ai
    xc, bc = x[:, 0] + 1j * x[:, 1], b[:, 0] + 1j * b[:, 1]
    r = A @ xc - bc
    np.testing.assert_allclose(d[:, 0].numpy() + 1j * d[:, 1].numpy(),
                               A @ xc, rtol=1e-12)
    assert float(f) == pytest.approx(0.5 * np.vdot(r, r).real, rel=1e-12)
    np.testing.assert_allclose(g[:, 0].numpy() + 1j * g[:, 1].numpy(),
                               A.conj().T @ r, rtol=1e-12, atol=1e-12)
    # the hinge: |d| − b on the complex rows, gradient Aᴴ(r·d/|d|)
    bm = np.abs(rng.standard_normal(m)) + 0.5
    d, f, g = planar_fused.planar_hinge_gradmap_reference(*_t(Ar, Ai, x,
                                                               bm))
    dc = A @ xc
    rr = np.maximum(np.abs(dc) - bm, 0.0)
    assert float(f) == pytest.approx(0.5 * np.sum(rr * rr), rel=1e-12)
    np.testing.assert_allclose(
        g[:, 0].numpy() + 1j * g[:, 1].numpy(),
        A.conj().T @ (rr * dc / np.abs(dc)), rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("loss", ["lstsq", "hinge"])
def test_gradmap_plain_version_matches_autodiff(loss):
    """The hand-written planar gradients equal torch.func.grad of the
    scalar objective, an oracle-independent check of the
    conjugate-adjoint channel algebra (rtol 1e-4 / atol 1e-5, the JAX
    test's)."""
    m, n = 48, 32
    Ar, Ai, x, rng = _planar(m, n)
    Ar, Ai, x = _t(Ar, Ai, x)
    if loss == "lstsq":
        b = torch.from_numpy(rng.standard_normal((m, 2)).astype(np.float32))
        ref = planar_fused.planar_lstsq_gradmap_reference

        def f(x):
            r = ftt.PlanarDenseOp(Ar, Ai)(x) - b
            return 0.5 * torch.sum(r * r)
    else:
        b = torch.from_numpy(
            (np.abs(rng.standard_normal(m)) + 0.5).astype(np.float32))
        ref = planar_fused.planar_hinge_gradmap_reference

        def f(x):
            d = ftt.PlanarDenseOp(Ar, Ai)(x)
            r = torch.clamp_min(torch.sqrt(torch.sum(d * d, -1)) - b, 0.0)
            return 0.5 * torch.sum(r * r)
    _, fv, g = ref(Ar, Ai, x, b)
    assert float(fv) == pytest.approx(float(f(x)), rel=1e-5)
    np.testing.assert_allclose(g.numpy(), torch.func.grad(f)(x).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_gradmap_wrappers_on_cpu_are_the_plain_versions_and_check_shapes():
    Ar, Ai, x, rng = _planar(9, 7)
    Ar, Ai, x = _t(Ar, Ai, x)
    bl = torch.from_numpy(rng.standard_normal((9, 2)).astype(np.float32))
    bh = torch.from_numpy(np.abs(rng.standard_normal(9)).astype(np.float32))
    before = planar_fused.LAUNCHES
    for fused, ref, b in (
            (planar_fused.fused_planar_lstsq_gradmap,
             planar_fused.planar_lstsq_gradmap_reference, bl),
            (planar_fused.fused_planar_hinge_gradmap,
             planar_fused.planar_hinge_gradmap_reference, bh)):
        for a, r in zip(fused(Ar, Ai, x, b), ref(Ar, Ai, x, b)):
            assert torch.equal(a, r)
    assert planar_fused.LAUNCHES == before
    with pytest.raises(ValueError, match=r"b must be \(9, 2\)"):
        planar_fused.fused_planar_lstsq_gradmap(Ar, Ai, x, bh)
    with pytest.raises(ValueError, match=r"b must be \(9,\)"):
        planar_fused.fused_planar_hinge_gradmap(Ar, Ai, x, bl)
    with pytest.raises(ValueError, match="device"):
        planar_fused.fused_planar_hinge_gradmap(
            *(t.to("meta") for t in (Ar, Ai, x, bh)))


# --------------------------------------------------------------------------
# K-P5
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,rtol,atol", [(np.float64, 1e-10, 1e-10),
                                             (np.float32, 2e-4, 1e-3)])
def test_probe_plain_version_matches_jax_planar_pairs(dtype, rtol, atol):
    """K chained pairs against fasta_tpu.PlanarDenseOp's forward and
    adjoint (float32: the JAX probe's --check tolerance)."""
    m, n, K = 96, 128, 3
    Ar, Ai, x, _ = _planar(m, n, dtype)
    op = ft.PlanarDenseOp(jnp.asarray(Ar), jnp.asarray(Ai))
    xj = jnp.asarray(x)
    for _ in range(K):
        gj = op.rmatvec(op(xj))
        xj = xj + 0.0 * gj
    got = planar_probe.planar_probe(*_t(Ar, Ai, x), K)
    np.testing.assert_allclose(got.numpy(), np.asarray(gj), rtol=rtol,
                               atol=atol)


def test_probe_wrapper_checks_and_layouts():
    Ar, Ai, x = _t(*_planar(10, 8)[:3])
    before = planar_probe.LAUNCHES
    for variant in planar_probe.VARIANTS:
        assert torch.equal(planar_probe.planar_probe(Ar, Ai, x, 2, variant),
                           planar_probe.planar_probe_reference(Ar, Ai, x, 2))
    assert planar_probe.LAUNCHES == before
    A0, A1 = planar_probe.layout(Ar, Ai, "interleaved")
    assert A1 is None and torch.equal(A0[..., 1], Ai)
    A0, A1 = planar_probe.layout(Ar, Ai, "transposed")
    assert torch.equal(A0, Ar.t()) and A0.is_contiguous()
    with pytest.raises(ValueError, match="unknown variant"):
        planar_probe.planar_probe(Ar, Ai, x, 2, "rowt")
    with pytest.raises(ValueError, match="K >= 1"):
        planar_probe.planar_probe(Ar, Ai, x, 0)


# --------------------------------------------------------------------------
# K-B8
# --------------------------------------------------------------------------

def _inst(m=256, n=32):
    """(numpy Ar, Ai, b, c, x0) float32 of the planar problem."""
    pj = jax_problems.build("phase_retrieval", m=m, n=n, planar=True,
                            dtype=jnp.float32)
    return tuple(np.asarray(a, np.float32) for a in (
        pj.op.Ar, pj.op.Ai, pj.fterm.b, pj.gterm.c, pj.x0))


def _jax_run(data, tau0, record_its=False, **kw):
    out = jax_micro_planar(*map(jnp.asarray, data), tau0, interpret=True,
                           record_its=record_its, **RECORD, **kw)
    names = ["x", "taus", "residuals", "k", "halt", "fvals", "backtracks",
             "objectives"] + (["iterates"] if record_its else []) + \
        ["norm_residuals"]
    return dict(zip(names, map(np.asarray, out)))


def _port_run(data, tau0, **kw):
    return microsolve_planar_phasemax(*_t(*data), tau0, **RECORD, **kw)


@pytest.mark.parametrize("m,n,K", [(256, 32, 12), (4096, 16, 6)])
def test_solve_prefix_matches_jax_kernel_interpret(m, n, K):
    """The 12-iteration prefix at 256x32 and the 6-iteration one at
    4096x16 (the JAX kernel's chunked matvec): taus and residuals rtol
    1e-2 (tests/unit/test_microsolver_planar.py)."""
    data = _inst(m, n)
    j = _jax_run(data, 1.0, max_iters=K, tol=0.0)
    t = _port_run(data, 1.0, max_iters=K, tol=0.0)
    assert int(t.iteration_count) == int(j["k"]) == K
    np.testing.assert_allclose(t.taus.numpy(), j["taus"], rtol=1e-2)
    np.testing.assert_allclose(t.residuals.numpy(), j["residuals"],
                               rtol=1e-2)


def test_every_record_matches_jax_kernel_over_12_iterations():
    """taus, residuals, f-values, backtracks, objectives f(x₁) − ⟨c, x₁⟩,
    normalized residuals and the (k, n, 2) iterates against the JAX
    kernel's, 12 iterations at 256x32 (rtol 1e-2 as the prefix; the
    iterates, entries of 0.01 to 1, with atol 1e-3 besides)."""
    data = _inst()
    kw = dict(max_iters=12, tol=0.0, hp=True)
    j = _jax_run(data, 1.0, record_its=True, **kw)
    t = _port_run(data, 1.0, record_its=True, **kw)
    for name in ("taus", "residuals", "fvals", "objectives",
                 "norm_residuals"):
        np.testing.assert_allclose(getattr(t, name).numpy(), j[name],
                                   rtol=1e-2, err_msg=name)
    np.testing.assert_array_equal(t.backtracks.numpy(),
                                  j["backtracks"].astype(np.int32))
    assert t.iterates.shape == j["iterates"].shape == (12, 32, 2)
    np.testing.assert_allclose(t.iterates.numpy(), j["iterates"], rtol=1e-2,
                               atol=1e-3)
    # the objective record is f(x₁) − ⟨c, x₁⟩ at the recorded iterate
    x1 = t.iterates[-1].double()
    Ar, Ai, b, c, _ = (t.double() for t in _t(*data))
    d = ftt.PlanarDenseOp(Ar, Ai)(x1)
    r = torch.clamp_min(torch.sqrt(torch.sum(d * d, -1)) - b, 0.0)
    assert float(t.objectives[-1]) == pytest.approx(
        float(0.5 * torch.sum(r * r) - torch.sum(c * x1)), rel=1e-5)


def test_hp_to_tolerance_matches_jax_kernel_interpret():
    data = _inst()
    kw = dict(max_iters=500, tol=1e-5, hp=True)
    j = _jax_run(data, 1.0, **kw)
    t = _port_run(data, 1.0, **kw)
    assert t.status == "converged" and int(j["halt"]) == 1
    np.testing.assert_allclose(t.x.numpy(), j["x"], atol=1e-4)


def test_fista_restart_dd_matches_jax_kernel_interpret():
    data = _inst()
    kw = dict(max_iters=500, tol=1e-5, hp=True, accelerate=True,
              restart_dd=True)
    j = _jax_run(data, 1.0, **kw)
    t = _port_run(data, 1.0, **kw)
    assert t.status == "converged" and int(j["halt"]) == 1
    assert abs(int(t.iteration_count) - int(j["k"])) <= 2
    np.testing.assert_allclose(t.x.numpy(), j["x"], atol=1e-3)
    np.testing.assert_allclose(t.residuals[:20].numpy(),
                               j["residuals"][:20], rtol=5e-4)


def test_nonfinite_tau0_aborts_like_the_jax_kernel():
    data = _inst()
    t = _port_run(data, math.nan, max_iters=50, tol=1e-5)
    j = _jax_run(data, math.nan, max_iters=50, tol=1e-5)
    assert t.status == "nonfinite" and int(j["halt"]) == 2
    assert int(t.iteration_count) == int(j["k"])


def test_wrapper_on_cpu_is_the_plain_version_and_checks_inputs():
    data = _t(*_inst(64, 8))
    before = microsolver_planar.LAUNCHES
    out = microsolve_planar_phasemax(*data, 1.0, max_iters=20)
    ref = microsolver_planar.microsolve_planar_phasemax_reference(
        *data, 1.0, max_iters=20)
    assert microsolver_planar.LAUNCHES == before
    assert torch.equal(out.x, ref.x) and torch.equal(out.taus, ref.taus)
    Ar, Ai, b, c, x0 = data
    with pytest.raises(ValueError, match="float32"):
        microsolve_planar_phasemax(Ar.double(), Ai.double(), b, c, x0, 1.0)
    with pytest.raises(ValueError, match=r"x0 \(n,2\)"):
        microsolve_planar_phasemax(Ar, Ai, b, c, x0[:, 0], 1.0)
    with pytest.raises(TypeError, match="unknown option"):
        microsolve_planar_phasemax(*data, 1.0, engine="vpu")
    with pytest.raises(ValueError, match="stop_rule"):
        microsolve_planar_phasemax(*data, 1.0, stop_rule="never")


@pytest.mark.parametrize("m,supported", [
    (2048, True), (2049, False), (4096, True), (4100, False), (16384, True)])
def test_row_chunk_gate_matches_the_reference(m, supported):
    from fasta_tpu.kernels.microsolver_planar import (
        _row_chunk, supports_planar_microsolver)
    assert microsolver_planar.row_chunk(m) == _row_chunk(m)
    for n in (256, 1536, 1537):
        assert microsolver_planar.supports_planar_microsolver(m, n) == \
            supports_planar_microsolver(m, n)
    assert microsolver_planar.supports_planar_microsolver(m, 16) == supported

