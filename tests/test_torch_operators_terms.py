"""Port operators, prox, terms, options and the K-B3 plain version held
against the JAX package on the same seeded NumPy inputs (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fasta_tpu as ft
import fasta_tpu_torch as ftt
from fasta_tpu.kernels.lstsq_fused import fused_lstsq_gradmap as jax_gradmap
from fasta_tpu.options import STOP_RULES as JAX_STOP_RULES
from fasta_tpu_torch.kernels import lstsq_fused

torch.set_num_threads(1)


def _rng_arrays(m, n, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    return A, rng.standard_normal(n), rng.standard_normal(m)


def test_denseop_matches_jax_f64():
    A, x, y = _rng_arrays(40, 30)
    op_t = ftt.DenseOp(torch.from_numpy(A))
    op_j = ft.DenseOp(jnp.asarray(A))
    np.testing.assert_allclose(op_t(torch.from_numpy(x)).numpy(),
                               np.asarray(op_j(jnp.asarray(x))),
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(op_t.rmatvec(torch.from_numpy(y)).numpy(),
                               np.asarray(op_j.rmatvec(jnp.asarray(y))),
                               rtol=1e-13, atol=1e-13)
    assert op_t.shape == (40, 30)
    # the adjoint operator swaps the two applications
    np.testing.assert_array_equal(op_t.H(torch.from_numpy(y)).numpy(),
                                  op_t.rmatvec(torch.from_numpy(y)).numpy())
    assert op_t.H.H is op_t


def test_check_adjoint_passes_and_catches_a_wrong_adjoint():
    A, x, _ = _rng_arrays(20, 12)
    gen = torch.Generator().manual_seed(3)
    op = ftt.DenseOp(torch.from_numpy(A))
    assert ftt.check_adjoint(op, torch.from_numpy(x), gen) < 1e-12

    class Broken(ftt.DenseOp):
        def rmatvec(self, y):
            return 2.0 * super().rmatvec(y)

    with pytest.raises(ValueError, match="adjoint check failed"):
        ftt.check_adjoint(Broken(torch.from_numpy(A)), torch.from_numpy(x),
                          gen)


def test_as_linear_op_forms():
    A, _, _ = _rng_arrays(5, 4)
    t = torch.from_numpy(A)
    assert isinstance(ftt.as_linear_op(t), ftt.DenseOp)
    assert ftt.as_linear_op(t).A is t        # stays on the caller's device
    op = ftt.as_linear_op(A)                 # NumPy: a CPU tensor
    assert op.A.device.type == "cpu"
    assert ftt.as_linear_op(op) is op
    with pytest.raises(NotImplementedError, match="Queue A item 2"):
        ftt.as_linear_op(None)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_shrink_matches_jax(dtype):
    z = np.array([-3.0, -0.5, -0.1, 0.0, 1e-31, 0.1, 0.5, 2.0], dtype)
    zt = torch.from_numpy(z)
    for t in (0.0, 0.1, 0.7):
        got = ftt.shrink(zt, torch.tensor(t, dtype=zt.dtype)).numpy()
        want = np.asarray(ft.prox.shrink(jnp.asarray(z), jnp.asarray(t, dtype)))
        np.testing.assert_array_equal(got, want)


def test_shrink_complex_keeps_phase():
    z = np.array([3 + 4j, 0.1 - 0.1j, 0.0], np.complex128)
    got = ftt.shrink(torch.from_numpy(z), 1.0).numpy()
    want = np.asarray(ft.prox.shrink(jnp.asarray(z), 1.0))
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=1e-15)


def test_least_squares_value_grad_and_f64_value():
    A, x, b = _rng_arrays(50, 30, seed=2)
    d = A @ x
    lt = ftt.LeastSquares(torch.from_numpy(b))
    lj = ft.LeastSquares(jnp.asarray(b))
    np.testing.assert_allclose(float(lt.value(torch.from_numpy(d))),
                               float(lj.value(jnp.asarray(d))), rtol=1e-14)
    np.testing.assert_array_equal(lt.grad(torch.from_numpy(d)).numpy(),
                                  np.asarray(lj.grad(jnp.asarray(d))))
    # float32 data: the float64-accumulated value against the JAX
    # double-word value and an exact float64 sum of the float32 residual
    d32, b32 = d.astype(np.float32), b.astype(np.float32)
    l32 = ftt.LeastSquares(torch.from_numpy(b32))
    v64 = l32.value_f64(torch.from_numpy(d32))
    assert v64.dtype == torch.float64
    r = (d32 - b32).astype(np.float64)
    np.testing.assert_allclose(float(v64), 0.5 * np.sum(r * r), rtol=1e-15)
    dd = ft.LeastSquares(jnp.asarray(b32)).value_dd(jnp.asarray(d32))
    np.testing.assert_allclose(float(v64),
                               float(dd.hi) + float(dd.lo), rtol=1e-12)


def test_function_terms_and_as_term():
    b = torch.tensor([1.0, -2.0], dtype=torch.float64)
    fs = ftt.as_smooth_term(lambda d: 0.5 * torch.sum((d - b) ** 2))
    d = torch.tensor([0.5, 0.5], dtype=torch.float64)
    np.testing.assert_allclose(fs.grad(d).numpy(), (d - b).numpy())
    ls = ftt.LeastSquares(b)
    assert ftt.as_smooth_term(ls) is ls
    zero = ftt.as_prox_term(None, None)
    assert float(zero.value(d)) == 0.0
    assert torch.equal(zero.prox(d, 0.3), d)
    l1 = ftt.L1Norm(0.5)
    assert ftt.as_prox_term(l1) is l1
    np.testing.assert_allclose(float(l1.value(d)), 0.5)


def test_options_match_jax():
    for kw in ({}, dict(adaptive=False), dict(accelerate=True),
               dict(stepsize_shrink=0.3)):
        o_t, o_j = ftt.FastaOptions(**kw), ft.FastaOptions(**kw)
        assert o_t.shrink_factor == o_j.shrink_factor
        assert o_t.effective_mode == o_j.effective_mode
    # accelerate wins over adaptive, as in the oracle
    assert ftt.FastaOptions(adaptive=True, accelerate=True).effective_mode \
        == "accelerated"
    assert ftt.STOP_RULES == JAX_STOP_RULES
    for bad in (dict(stop_rule="nope"), dict(precision="x"), dict(window=0),
                dict(max_iters=0),
                dict(record_diagnostics=False, record_objective=True)):
        with pytest.raises(ValueError):
            ftt.FastaOptions(**bad)
        with pytest.raises(ValueError):
            ft.FastaOptions(**bad)


def test_lstsq_gradmap_reference_matches_jax_kernel_interpret():
    """Plain K-B3 against the Pallas kernel in interpret mode at a ragged
    row count (300 is not a multiple of the 128-row tile): atol 1e-4 on
    d and g, rtol 1e-5 on f."""
    A, x, b = _rng_arrays(300, 256, seed=5)
    A, x, b = (a.astype(np.float32) for a in (A, x, b))
    dj, fj, gj = jax_gradmap(jnp.asarray(A), jnp.asarray(x), jnp.asarray(b),
                             interpret=True)
    dt, ft_, gt = lstsq_fused.lstsq_gradmap_reference(
        torch.from_numpy(A), torch.from_numpy(x), torch.from_numpy(b))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-4)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4)
    np.testing.assert_allclose(float(ft_), float(fj), rtol=1e-5)


def test_fused_wrapper_runs_plain_version_on_cpu_without_counting():
    A, x, b = _rng_arrays(30, 20, seed=6)
    A, x, b = (torch.from_numpy(a.astype(np.float32)) for a in (A, x, b))
    before = lstsq_fused.LAUNCHES
    got = lstsq_fused.fused_lstsq_gradmap(A, x, b)
    want = lstsq_fused.lstsq_gradmap_reference(A, x, b)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    assert lstsq_fused.LAUNCHES == before
    with pytest.raises(ValueError, match="x has"):
        lstsq_fused.fused_lstsq_gradmap(A, x[:5], b)


def test_fused_gradmap_dispatch_rules(monkeypatch):
    """float32 DenseOp of any width → the K-B3 wrapper; float64 → the
    two-pass form (the JAX dtype rule); other operators → no fusion."""
    assert lstsq_fused.supports_fusion(1000, 2000, torch.float32)
    assert lstsq_fused.supports_fusion(8192, 16384, torch.float32)
    assert lstsq_fused.supports_fusion(8, 16385, torch.float32)
    assert lstsq_fused.supports_fusion(4, 1 << 22, torch.float32)
    assert not lstsq_fused.supports_fusion(1000, 2000, torch.float64)
    calls = []
    monkeypatch.setattr(lstsq_fused, "fused_lstsq_gradmap",
                        lambda *a: calls.append(a[0].shape))
    wide = ftt.DenseOp(torch.zeros((2, 40001), dtype=torch.float32))
    ftt.LeastSquares(torch.zeros(2)).fused_gradmap(wide)(torch.zeros(40001))
    assert calls == [(2, 40001)]
    monkeypatch.undo()
    A, x, b = _rng_arrays(30, 20, seed=7)
    for dtype in (torch.float32, torch.float64):
        op = ftt.DenseOp(torch.from_numpy(A).to(dtype))
        term = ftt.LeastSquares(torch.from_numpy(b).to(dtype))
        d, f, g = term.fused_gradmap(op)(torch.from_numpy(x).to(dtype))
        np.testing.assert_allclose(d.numpy(), A @ x, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            g.numpy(), A.T @ (A @ x - b), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            float(f), 0.5 * np.sum((A @ x - b) ** 2), rtol=1e-5)
    assert ftt.LeastSquares(torch.zeros(3)).fused_gradmap(object()) is None
