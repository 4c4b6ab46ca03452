"""The dense problems' terms and proxes, kernel K-B3p's plain version and
the carry-across of the NNLS, logistic and SVM instances, held against the
JAX package on the same seeded NumPy inputs (CPU).

Tolerances: terms and proxes in float64 to 1e-12 relative; K-B3p's plain
version against the Pallas kernel in interpret mode with d and g atol
1e-5·max(1, max|ref|) and f rtol 1e-5 (float32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fasta_tpu as ft
import fasta_tpu_torch as ftt
import problems as jax_problems
from fasta_tpu.kernels.lstsq_fused import \
    fused_pointwise_gradmap as jax_pointwise
from fasta_tpu.terms import _hinge_elem, _logistic_elem
from fasta_tpu_torch import problems as torch_problems
from fasta_tpu_torch.convert import problem_from_instance
from fasta_tpu_torch.kernels import lstsq_fused, microsolver
from fasta_tpu_torch.terms import hinge_residual, logistic_ell

torch.set_num_threads(1)


def _arrays(m, n, seed, labels):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    x = 2.0 * rng.standard_normal(n)
    if labels == "logistic":
        y = (rng.random(m) < 0.5).astype(np.float64)
    else:
        y = np.where(rng.random(m) < 0.5, -1.0, 1.0)
    return A, x, y


def _close(got, want, rtol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=1e-300)


@pytest.mark.parametrize("name", ["logistic", "squared_hinge"])
def test_pointwise_terms_match_jax_f64(name):
    A, x, y = _arrays(80, 30, 1, name)
    d = A @ x
    # include the kinks and the large-|d| tails
    d[:4] = [0.0, 40.0, -40.0, 1.0]
    cls_t = ftt.Logistic if name == "logistic" else ftt.SquaredHinge
    cls_j = ft.Logistic if name == "logistic" else ft.SquaredHinge
    t, j = cls_t(torch.from_numpy(y)), cls_j(jnp.asarray(y))
    dt, dj = torch.from_numpy(d), jnp.asarray(d)
    _close(float(t.value(dt)), float(j.value(dj)))
    _close(t.grad(dt).numpy(), j.grad(dj))
    assert not t.grad_affine and not j.grad_affine
    assert ftt.LeastSquares(dt).grad_affine
    # value_f64 of float32 data: an exact float64 sum of the float32
    # terms; against the JAX double-word value within float32 rounding of
    # the elementwise exp/log1p
    d32, y32 = d.astype(np.float32), y.astype(np.float32)
    t32 = cls_t(torch.from_numpy(y32))
    v64 = t32.value_f64(torch.from_numpy(d32))
    assert v64.dtype == torch.float64
    if name == "logistic":
        ell = logistic_ell(torch.from_numpy(d32), torch.from_numpy(y32))
        exact = np.sum(ell.numpy().astype(np.float64))
    else:
        r = hinge_residual(torch.from_numpy(d32),
                           torch.from_numpy(y32)).numpy()
        exact = 0.5 * np.sum(r.astype(np.float64) ** 2)
    np.testing.assert_allclose(float(v64), exact, rtol=1e-15)
    dd = cls_j(jnp.asarray(y32)).value_dd(jnp.asarray(d32))
    np.testing.assert_allclose(float(v64), float(dd.hi) + float(dd.lo),
                               rtol=1e-6)


def test_prox_terms_match_jax_f64():
    rng = np.random.default_rng(4)
    z = 3.0 * rng.standard_normal(50)
    z[:3] = [0.0, -1.0, 1.0]
    zt, zj = torch.from_numpy(z), jnp.asarray(z)
    pairs = [(ftt.NonnegIndicator(), ft.NonnegIndicator()),
             (ftt.BoxIndicator(), ft.BoxIndicator()),
             (ftt.BoxIndicator(-0.5, 2.0), ft.BoxIndicator(-0.5, 2.0)),
             (ftt.L2Norm2(0.3), ft.L2Norm2(0.3))]
    for t, j in pairs:
        for tau in (0.1, 2.0):
            _close(t.prox(zt, tau).numpy(), j.prox(zj, tau))
        _close(float(t.value(zt)), float(j.value(zj)))
    _close(ftt.project_nonneg(zt).numpy(), ft.prox.project_nonneg(zj))
    _close(ftt.project_box(zt, -1.0, 1.0).numpy(),
           ft.prox.project_box(zj, -1.0, 1.0))
    # NaN stays NaN, as with jnp.maximum / jnp.clip
    nan = torch.tensor([float("nan")], dtype=torch.float64)
    assert torch.isnan(ftt.project_nonneg(nan)).all()
    assert torch.isnan(ftt.project_box(nan, -1.0, 1.0)).all()


@pytest.mark.parametrize("loss", ["logistic", "squared_hinge"])
def test_pointwise_gradmap_reference_matches_jax_kernel_interpret(loss):
    """m = 197 is not a multiple of the 128-row tile, so the JAX kernel's
    padded-row mask is exercised."""
    A, x, y = _arrays(197, 64, 7, loss)
    A, x, y = (a.astype(np.float32) for a in (A, x, y))
    elem = _logistic_elem if loss == "logistic" else _hinge_elem
    dj, fj, gj = jax_pointwise(jnp.asarray(A), jnp.asarray(x),
                               (jnp.asarray(y),), elem, interpret=True)
    dt, f_t, gt = lstsq_fused.pointwise_gradmap_reference(
        torch.from_numpy(A), torch.from_numpy(x), torch.from_numpy(y), loss)
    dj, gj = np.asarray(dj), np.asarray(gj)
    np.testing.assert_allclose(dt.numpy(), dj,
                               atol=1e-5 * max(1.0, np.abs(dj).max()))
    np.testing.assert_allclose(gt.numpy(), gj,
                               atol=1e-5 * max(1.0, np.abs(gj).max()))
    np.testing.assert_allclose(float(f_t), float(fj), rtol=1e-5)


def test_pointwise_wrapper_and_dispatch_on_cpu():
    A, x, y = _arrays(30, 20, 3, "logistic")
    A, x, y = (torch.from_numpy(a.astype(np.float32)) for a in (A, x, y))
    before = lstsq_fused.POINTWISE_LAUNCHES
    got = lstsq_fused.fused_pointwise_gradmap(A, x, y, "logistic")
    want = lstsq_fused.pointwise_gradmap_reference(A, x, y, "logistic")
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    assert lstsq_fused.POINTWISE_LAUNCHES == before
    with pytest.raises(ValueError, match="loss"):
        lstsq_fused.fused_pointwise_gradmap(A, x, y, "lstsq")
    with pytest.raises(ValueError, match="x has"):
        lstsq_fused.fused_pointwise_gradmap(A, x[:5], y, "logistic")
    # a float32 DenseOp takes K-B3p; float64 and other operators the
    # two-call path (the JAX dtype rule)
    op = ftt.DenseOp(A)
    for term, loss in ((ftt.Logistic(y), "logistic"),
                       (ftt.SquaredHinge(2.0 * y - 1.0), "squared_hinge")):
        data = term.b if loss == "logistic" else term.y
        d, f, g = term.fused_gradmap(op)(x)
        d0, f0, g0 = lstsq_fused.pointwise_gradmap_reference(A, x, data,
                                                             loss)
        assert torch.equal(d, d0) and torch.equal(g, g0)
        assert torch.equal(f, f0)
        torch.testing.assert_close(f, term.value(d), rtol=1e-6, atol=0)
        torch.testing.assert_close(g, A.t() @ term.grad(d), rtol=1e-5,
                                   atol=1e-6)
        assert term.fused_gradmap(ftt.DenseOp(A.double())) is None
        assert term.fused_gradmap(object()) is None


def test_wrappers_raise_for_a_device_without_a_kernel():
    """A wrapper never falls back: a tensor that lies on no device with a
    kernel (here the meta device) raises instead of running the plain
    version."""
    A = torch.empty((8, 4), device="meta")
    x, b = torch.empty(4, device="meta"), torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        lstsq_fused.fused_pointwise_gradmap(A, x, b, "logistic")
    with pytest.raises(ValueError, match="no kernel"):
        lstsq_fused.fused_lstsq_gradmap(A, x, b)
    with pytest.raises(ValueError, match="no kernel"):
        microsolver.microsolve_lasso(A, b, x, 0.1, 0.1)
    with pytest.raises(ValueError, match="no kernel"):
        microsolver.microsolve_lasso_path(A, b, x, 0.1, [0.1, 0.05])


@pytest.mark.parametrize("name,kw", [
    ("nnls", dict(m=40, n=20)), ("logistic", dict(m=40, n=20, k=4)),
    ("svm", dict(m=40, n=12))])
def test_convert_round_trip(name, kw):
    """JAX Problem.instance → port Problem: the same value and gradient
    of f, value and prox of g, in float64."""
    pj = jax_problems.build(name, dtype=jnp.float64, **kw)
    pt = problem_from_instance(pj.instance, device="cpu",
                               dtype=torch.float64)
    assert type(pt.fterm).__name__ == type(pj.fterm).__name__
    assert type(pt.gterm).__name__ == type(pj.gterm).__name__
    assert pt.name == pj.name and pt.instance is pj.instance
    np.testing.assert_array_equal(pt.op.A.numpy(), np.asarray(pj.op.A))
    np.testing.assert_array_equal(pt.x0.numpy(), np.asarray(pj.x0))
    x = np.random.default_rng(9).standard_normal(kw["n"])
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    dt, dj = pt.op(xt), pj.op(xj)
    _close(dt.numpy(), dj)
    _close(float(pt.fterm.value(dt)), float(pj.fterm.value(dj)))
    _close(pt.fterm.grad(dt).numpy(), pj.fterm.grad(dj))
    _close(float(pt.gterm.value(xt)), float(pj.gterm.value(xj)))
    _close(pt.gterm.prox(xt, 0.3).numpy(), pj.gterm.prox(xj, 0.3))
    p32 = torch_problems.build(name, device="cpu", **kw)
    assert p32.op.A.dtype == torch.float32
    np.testing.assert_array_equal(p32.op.A.numpy(),
                                  pj.instance["A"].astype(np.float32))
