"""The bfloat16 forms of K-B3, K-B3p and K-B7, the probe K-P4 and K-B8's
wide route (n > 512): the plain versions against the JAX kernels in
interpret mode (or, for the probe, a NumPy recomputation of its body).

A bfloat16 matrix is rounded once, in JAX, and its bits are carried to
the port (``convert.bf16_tensor``), so both packages hold the same
values.  Tolerances: d and g within 1e-5 of their largest entry and f
within rtol 1e-5 — the same function, float32 sums in another order.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import problems as jax_problems
from fasta_tpu.kernels.lstsq_fused import \
    fused_lstsq_gradmap as jax_lstsq_gradmap
from fasta_tpu.kernels.lstsq_fused import \
    fused_pointwise_gradmap as jax_pointwise_gradmap
from fasta_tpu.kernels.microsolver_planar import \
    microsolve_planar_phasemax as jax_micro_planar
from fasta_tpu.kernels.planar_fused import \
    fused_planar_hinge_gradmap as jax_hinge_gradmap
from fasta_tpu.kernels.planar_fused import \
    fused_planar_lstsq_gradmap as jax_planar_lstsq_gradmap
from fasta_tpu.terms import _hinge_elem, _logistic_elem
from fasta_tpu_torch.convert import bf16_tensor
from fasta_tpu_torch.kernels import (bf16_probe, lstsq_fused,
                                     microsolver_planar, planar_fused)

torch.set_num_threads(1)


def _bf16(rng, shape, scale):
    """A JAX bfloat16 array of seeded normals and its bits in the port."""
    a = jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)
    return a, bf16_tensor(np.asarray(a), device="cpu")


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


def _check_map(port, jax_out):
    (d, f, g), (d0, f0, g0) = port, jax_out
    _close(d.numpy(), d0)
    _close(g.numpy(), g0)
    assert float(f) == pytest.approx(float(f0), rel=1e-5)


# --------------------------------------------------------------------------
# K-B3 and K-B3p, bfloat16 A
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m", [64, 100])      # 100: ragged (padded in JAX)
def test_bf16_lstsq_plain_version_matches_jax_kernel_interpret(m):
    rng = np.random.default_rng(m)
    n = 256
    Aj, At = _bf16(rng, (m, n), 1 / math.sqrt(m))
    x = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    out = jax_lstsq_gradmap(Aj, jnp.asarray(x), jnp.asarray(b),
                            interpret=True)
    _check_map(lstsq_fused.lstsq_gradmap_reference(
        At, torch.from_numpy(x), torch.from_numpy(b)), out)


@pytest.mark.parametrize("loss", ["logistic", "squared_hinge"])
@pytest.mark.parametrize("m", [64, 100])
def test_bf16_pointwise_plain_version_matches_jax_kernel_interpret(loss, m):
    rng = np.random.default_rng(m + 7)
    n = 256
    Aj, At = _bf16(rng, (m, n), 1 / math.sqrt(m))
    x = rng.standard_normal(n).astype(np.float32)
    if loss == "logistic":
        y, elem = (rng.random(m) < 0.5).astype(np.float32), _logistic_elem
    else:
        y, elem = np.sign(rng.standard_normal(m)).astype(np.float32), \
            _hinge_elem
    out = jax_pointwise_gradmap(Aj, jnp.asarray(x), (jnp.asarray(y),), elem,
                                interpret=True)
    _check_map(lstsq_fused.pointwise_gradmap_reference(
        At, torch.from_numpy(x), torch.from_numpy(y), loss), out)


def test_bf16_gradmap_wrappers_on_cpu_are_the_plain_versions():
    """A bfloat16 A on the CPU runs the plain version (A upcast, x
    float32) and counts no launch; the dtype rule takes float32 and
    bfloat16 only."""
    rng = np.random.default_rng(0)
    _, A = _bf16(rng, (9, 20), 0.3)
    x = torch.from_numpy(rng.standard_normal(20).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(9).astype(np.float32))
    before = (lstsq_fused.BF16_LAUNCHES, lstsq_fused.POINTWISE_BF16_LAUNCHES,
              lstsq_fused.LAUNCHES)
    for got, want in (
            (lstsq_fused.fused_lstsq_gradmap(A, x, b),
             lstsq_fused.lstsq_gradmap_reference(A.float(), x, b)),
            (lstsq_fused.fused_pointwise_gradmap(A, x, (b > 0).float(),
                                                 "logistic"),
             lstsq_fused.pointwise_gradmap_reference(
                 A.float(), x, (b > 0).float(), "logistic"))):
        for a, r in zip(got, want):
            assert a.dtype == torch.float32 and torch.equal(a, r)
    assert (lstsq_fused.BF16_LAUNCHES, lstsq_fused.POINTWISE_BF16_LAUNCHES,
            lstsq_fused.LAUNCHES) == before
    assert lstsq_fused.supports_fusion(9, 20, torch.bfloat16)
    assert lstsq_fused.supports_fusion(9, 20, torch.float32)
    assert not lstsq_fused.supports_fusion(9, 20, torch.float16)
    assert not lstsq_fused.supports_fusion(9, 20, torch.float64)


# --------------------------------------------------------------------------
# K-B7, bfloat16 channels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("loss", ["lstsq", "hinge"])
@pytest.mark.parametrize("m", [64, 100])
def test_bf16_planar_plain_version_matches_jax_kernel_interpret(loss, m):
    rng = np.random.default_rng(m + 3)
    n = 256
    Arj, Art = _bf16(rng, (m, n), 1 / math.sqrt(2 * m))
    Aij, Ait = _bf16(rng, (m, n), 1 / math.sqrt(2 * m))
    x = rng.standard_normal((n, 2)).astype(np.float32)
    if loss == "lstsq":
        b = rng.standard_normal((m, 2)).astype(np.float32)
        jax_fn, ref = jax_planar_lstsq_gradmap, \
            planar_fused.planar_lstsq_gradmap_reference
    else:
        b = (np.abs(rng.standard_normal(m)) + 0.1).astype(np.float32)
        jax_fn, ref = jax_hinge_gradmap, \
            planar_fused.planar_hinge_gradmap_reference
    out = jax_fn(Arj, Aij, jnp.asarray(x), jnp.asarray(b), interpret=True)
    port = ref(Art, Ait, torch.from_numpy(x), torch.from_numpy(b))
    assert all(t.dtype == torch.float32 for t in port)
    _check_map(port, out)
    before = planar_fused.BF16_LAUNCHES
    wrapped = (planar_fused.fused_planar_lstsq_gradmap if loss == "lstsq"
               else planar_fused.fused_planar_hinge_gradmap)(
        Art, Ait, torch.from_numpy(x), torch.from_numpy(b))
    assert planar_fused.BF16_LAUNCHES == before
    assert all(torch.equal(a, r) for a, r in zip(wrapped, port))


# --------------------------------------------------------------------------
# K-P4
# --------------------------------------------------------------------------

def _probe_numpy(A, x0, K):
    """The body of benchmarks/bf16_matvec_probe.py's kernel, in NumPy
    (float32 sums of the upcast matrix): d = Σ_j A·x, g = Σ_i A·d,
    x = x₀ + 0·g, K times."""
    A = A.astype(np.float32)
    x = x0
    for _ in range(K):
        d = np.sum(A * x[None, :], axis=1, dtype=np.float32)
        g = np.sum(A * d[:, None], axis=0, dtype=np.float32)
        x = x0 + np.float32(0.0) * g
    return x, g


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_probe_plain_version_matches_numpy_body(storage):
    rng = np.random.default_rng(4)
    m, n, K = 64, 128, 3
    A = (rng.standard_normal((m, n)) / math.sqrt(m)).astype(np.float32)
    x0 = rng.standard_normal(n).astype(np.float32)
    if storage == "bfloat16":
        A = np.asarray(jnp.asarray(A, jnp.bfloat16))
        At = bf16_tensor(A, device="cpu")
    else:
        At = torch.from_numpy(A)
    before = bf16_probe.LAUNCHES
    x, g = bf16_probe.bf16_probe(At, torch.from_numpy(x0), K)
    assert bf16_probe.LAUNCHES == before
    x_np, g_np = _probe_numpy(A, x0, K)
    np.testing.assert_array_equal(x.numpy(), x0)
    np.testing.assert_array_equal(x_np, x0)
    _close(g.numpy(), g_np)


def test_probe_wrapper_checks():
    A = torch.zeros((4, 6))
    with pytest.raises(ValueError, match="x0 \\(n,\\)"):
        bf16_probe.bf16_probe(A, torch.zeros(4), 2)
    with pytest.raises(ValueError, match="K >= 1"):
        bf16_probe.bf16_probe(A, torch.zeros(6), 0)
    with pytest.raises(ValueError, match="device"):
        bf16_probe.bf16_probe(A.to("meta"), torch.zeros(6, device="meta"), 2)


# --------------------------------------------------------------------------
# K-B8 past n = 512 (C-4)
# --------------------------------------------------------------------------

def _inst(m, n):
    pj = jax_problems.build("phase_retrieval", m=m, n=n, planar=True,
                            dtype=jnp.float32)
    return tuple(np.asarray(a, np.float32) for a in (
        pj.op.Ar, pj.op.Ai, pj.fterm.b, pj.gterm.c, pj.x0))


@pytest.mark.parametrize("accelerate", [False, True])
def test_wide_planar_solve_matches_jax_kernel_interpret(accelerate):
    """At 256x516, past the 512 columns of the shared-memory route, the
    port's planar whole solve (its plain version on the CPU) against the
    JAX kernel in interpret mode over 8 iterations: equal counts, taus and
    residuals rtol 1e-2 (tests/unit/test_microsolver_planar.py), the
    solution within 1e-3."""
    data = _inst(256, 516)
    kw = dict(max_iters=8, tol=0.0, hp=True, accelerate=accelerate,
              restart_dd=accelerate)
    j = jax_micro_planar(*map(jnp.asarray, data), 1.0, interpret=True, **kw)
    t = microsolver_planar.microsolve_planar_phasemax(
        *(torch.from_numpy(np.array(a)) for a in data), 1.0, **kw)
    assert int(t.iteration_count) == int(j[3]) == 8
    np.testing.assert_allclose(t.taus.numpy(), np.asarray(j[1]), rtol=1e-2)
    np.testing.assert_allclose(t.residuals.numpy(), np.asarray(j[2]),
                               rtol=1e-2)
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j[0]), atol=1e-3)
    assert microsolver_planar._wide(516) and not microsolver_planar._wide(512)
