"""Kernel K-B4 (the fused shrink step) and the batched whole-solve kernels
K-B1b, K-B6b and K-B8b through their plain versions, held against the JAX
package on the CPU: ``fasta_tpu.kernels.fused_shrink_step`` in interpret
mode and its XLA composition, and ``fasta_tpu.microsolve_batch`` (the
whole-solve kernels under ``jax.vmap``, interpret mode) for every case of
``tests/unit/test_micro_batch.py``, at its sizes.

Tolerances: K-B4 as ``tests/unit/test_prox_fused.py`` holds the JAX
kernel — atol 1e-6 on x₁, rtol 1e-4 (atol 1e-5) on the sums, which the
port accumulates in float64 and the JAX kernel in float32.  The batches
(``_hold_batch``): over a fixed count of iterations, equal counts and
solutions within 1e-5; to the tests' tolerances, where the float32 sums
taken in another order move the last iterations at the noise floor,
equal statuses, counts within 20% (a run that parts early, as the planar
one from τ₀ = 0.01 does, ends 13% apart) and objectives within rtol
1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fasta_tpu
import problems as jax_problems
from fasta_tpu.kernels import fused_shrink_step as jax_shrink_step
from fasta_tpu.kernels import shrink_step_reference as jax_shrink_reference
from fasta_tpu_torch import problems
from fasta_tpu_torch.kernels import (microsolver, microsolver_planar,
                                     microsolver_tv, prox_fused)
from fasta_tpu_torch.kernels.prox_fused import (fused_shrink_step,
                                                shrink_step_reference)

torch.set_num_threads(1)


def _rows(R, n, seed, nan=False):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((R, n)).astype(np.float32)
    g = rng.standard_normal((R, n)).astype(np.float32)
    if nan:
        x0[0, n // 2] = np.nan
    return x0, g


def _hold(out, refs):
    """The port's (x₁, sums) against the JAX kernel's and its XLA
    reference's."""
    for ref in refs:
        np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]),
                                   atol=1e-6)
        for a, b in zip(out[1:], ref[1:]):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.parametrize("n", [2000, 128, 100])
def test_shrink_step_plain_version_matches_jax_kernel(n):
    x0, g = _rows(1, n, n)
    before = prox_fused.LAUNCHES
    out = fused_shrink_step(torch.from_numpy(x0[0]), torch.from_numpy(g[0]),
                            0.3, 0.5)
    assert prox_fused.LAUNCHES == before     # a CPU tensor: plain version
    assert out[0].shape == (n,) and out[1].dtype == torch.float64
    _hold(out, [jax_shrink_step(jnp.asarray(x0[0]), jnp.asarray(g[0]), 0.3,
                                0.5, interpret=True),
                jax_shrink_reference(jnp.asarray(x0[0]), jnp.asarray(g[0]),
                                     0.3, 0.5)])


@pytest.mark.parametrize("n", [2000, 128, 100])
def test_shrink_step_rows_match_jax_kernel_per_row(n):
    """R rows with a τ and a μ per row, each row held against the JAX
    function on that row."""
    R = 4
    x0, g = _rows(R, n, 7 + n)
    taus = np.array([0.3, 1.0, 0.05, 0.7], np.float32)
    mus = np.array([0.5, 0.1, 2.0, 0.0], np.float32)
    out = fused_shrink_step(torch.from_numpy(x0), torch.from_numpy(g),
                            torch.from_numpy(taus), torch.from_numpy(mus))
    assert out[0].shape == (R, n) and out[1].shape == (R,)
    for i in range(R):
        ref = jax_shrink_step(jnp.asarray(x0[i]), jnp.asarray(g[i]),
                              float(taus[i]), float(mus[i]), interpret=True)
        _hold((out[0][i],) + tuple(s[i] for s in out[1:]), [ref])
    # one μ shared by every row is the same as μ repeated
    shared = fused_shrink_step(torch.from_numpy(x0), torch.from_numpy(g),
                               torch.from_numpy(taus), 0.5)
    rep = fused_shrink_step(torch.from_numpy(x0), torch.from_numpy(g),
                            torch.from_numpy(taus), torch.full((R,), 0.5))
    assert all(torch.equal(a, b) for a, b in zip(shared, rep))


def test_shrink_step_propagates_nan_like_jax():
    """A NaN entry stays NaN in x₁ and in the sums (``jnp.maximum``), so
    the loop's nonfinite guard still fires."""
    x0, g = _rows(1, 128, 3, nan=True)
    out = fused_shrink_step(torch.from_numpy(x0[0]), torch.from_numpy(g[0]),
                            0.3, 0.5)
    ref = jax_shrink_step(jnp.asarray(x0[0]), jnp.asarray(g[0]), 0.3, 0.5,
                          interpret=True)
    np.testing.assert_array_equal(np.isnan(out[0].numpy()),
                                  np.isnan(np.asarray(ref[0])))
    assert np.isnan(out[0][64]) and all(np.isnan(float(s)) for s in out[1:])
    assert all(np.isnan(float(s)) for s in ref[1:])
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=1e-6)


def test_shrink_step_wrapper_checks_its_inputs():
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="one shape"):
        fused_shrink_step(x, torch.zeros(9), 0.1, 0.1)
    with pytest.raises(ValueError, match="float32"):
        fused_shrink_step(x.double(), x.double(), 0.1, 0.1)
    with pytest.raises(ValueError, match="3 values for 2 rows"):
        fused_shrink_step(torch.zeros(2, 4), torch.zeros(2, 4),
                          torch.ones(3), 0.1)
    a = shrink_step_reference(x, x, 0.1, 0.1)
    assert float(a[1]) == 0.0


# --------------------------------------------------------------------------
# The batched whole-solve kernels against fasta_tpu.microsolve_batch
# --------------------------------------------------------------------------

def _stack(b, B):
    """Instance i's measurements b·(1 + 0.02·i), the JAX tests' recipe."""
    b = np.asarray(b, np.float32)
    return np.stack([b * np.float32(1.0 + 0.02 * i) for i in range(B)])


# the prefix each batch is held over at a fixed count (the runs part at
# the float32 noise floor later: iterations 14-21 at these sizes)
PREFIX = 12


def _hold_batch(solve_t, solve_j, B, prefix=PREFIX, **kw):
    """The port's batch (``solve_t``, plain version) against JAX's
    (``solve_j``, interpret mode), each run twice.  At a fixed count of
    ``prefix`` iterations: equal counts, solutions within 1e-5 of their scale,
    taus rtol 1e-4.  To the test's tolerance, where each run ends at the
    float32 noise floor and the order of float32 sums moves the last
    iterations: equal statuses, counts within 20%, and each instance's
    last prox-point objective within rtol 1e-5."""
    fixed = dict(kw, max_iters=prefix, tol=0.0, stop_rule="iterations")
    rb, rj = solve_t(**fixed), solve_j(**fixed)
    assert rb.solutions.shape[0] == B
    np.testing.assert_array_equal(rb.iteration_counts, [prefix] * B)
    np.testing.assert_array_equal(np.asarray(rj.iteration_counts),
                                  [prefix] * B)
    ref = np.asarray(rj.solutions)
    np.testing.assert_allclose(rb.solutions.numpy(), ref,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))
    for i in range(B):
        np.testing.assert_allclose(rb.taus[i], np.asarray(rj.taus[i]),
                                   rtol=1e-4)
    rb, rj = solve_t(record_objs=True, **kw), solve_j(record_objs=True, **kw)
    np.testing.assert_array_equal(rb.statuses, np.asarray(rj.statuses))
    kj = np.asarray(rj.iteration_counts)
    assert np.all(np.abs(rb.iteration_counts - kj) <= 0.2 * kj), \
        (rb.iteration_counts, kj)
    for i in range(B):
        np.testing.assert_allclose(rb.objectives[i][-1],
                                   np.asarray(rj.objectives[i])[-1],
                                   rtol=1e-5)
    return rb


def _pair(name, **kw):
    return (jax_problems.build(name, dtype=jnp.float32, **kw),
            problems.build(name, device="cpu", **kw))


@pytest.mark.parametrize("mode", [dict(), dict(hp=True),
                                  dict(accelerate=True)])
def test_dense_batch_matches_jax(mode):
    pj, pt = _pair("lasso", m=120, n=240, k=10)
    B = 3
    bs = _stack(pj.fterm.b, B)
    before = microsolver.BATCH_LAUNCHES
    rb = _hold_batch(
        lambda **k: pt.microsolve_batch(torch.from_numpy(bs), **k),
        lambda **k: fasta_tpu.microsolve_batch(pj, jnp.asarray(bs), **k),
        B, tau0=0.05, max_iters=200, tol=1e-6, **mode)
    assert microsolver.BATCH_LAUNCHES == before   # CPU: the plain version
    assert rb.solutions.shape == (B, 240)
    # each instance is the plain single solve, record for record
    for i in range(B):
        ri = pt.with_parts(fterm=type(pt.fterm)(torch.from_numpy(bs[i]))) \
            .microsolve(tau0=0.05, max_iters=200, tol=1e-6, **mode)
        assert torch.equal(rb.solutions[i], ri.solution)
        np.testing.assert_array_equal(rb.taus[i], ri.taus)


def test_dense_batch_custom_starts_and_losses_match_jax():
    """x0s batching and the logistic loss."""
    pj, pt = _pair("logistic", m=100, n=50, k=5)
    B = 2
    bs = np.stack([np.asarray(pj.fterm.b, np.float32)] * B)
    x0s = np.stack([np.asarray(pj.x0, np.float32) * np.float32(1.0 + 0.1 * i)
                    for i in range(B)])
    _hold_batch(
        lambda **k: pt.microsolve_batch(torch.from_numpy(bs),
                                        x0s=torch.from_numpy(x0s), **k),
        lambda **k: fasta_tpu.microsolve_batch(pj, jnp.asarray(bs),
                                               x0s=jnp.asarray(x0s), **k),
        B, tau0=0.05, max_iters=300, tol=1e-5)


def test_tv_batch_matches_jax():
    pj, pt = _pair("tv", h=16, w=16)
    B = 2
    bs = _stack(pj.fterm.b, B)
    before = microsolver_tv.BATCH_LAUNCHES
    rb = _hold_batch(
        lambda **k: pt.microsolve_batch(torch.from_numpy(bs), **k),
        lambda **k: fasta_tpu.microsolve_batch(pj, jnp.asarray(bs), **k),
        B, tau0=2.0, max_iters=200, tol=1e-4)
    assert microsolver_tv.BATCH_LAUNCHES == before
    assert rb.solutions.shape == (B, 2, 16, 16)


def test_planar_batch_matches_jax():
    pj, pt = _pair("phase_retrieval", m=128, n=16, planar=True)
    B = 2
    bs = _stack(pj.fterm.b, B)
    before = microsolver_planar.BATCH_LAUNCHES
    rb = _hold_batch(
        lambda **k: pt.microsolve_batch(torch.from_numpy(bs), **k),
        lambda **k: fasta_tpu.microsolve_batch(pj, jnp.asarray(bs), **k),
        B, tau0=1.0, max_iters=150, tol=1e-4)
    assert microsolver_planar.BATCH_LAUNCHES == before
    assert rb.solutions.shape == (B, 16, 2)


def test_per_instance_tau0_matches_jax():
    pj, pt = _pair("lasso", m=120, n=240, k=10)
    B = 3
    bs = _stack(pj.fterm.b, B)
    t0s = np.array([0.02, 0.05, 0.09], np.float32)
    rb = _hold_batch(
        lambda **k: pt.microsolve_batch(torch.from_numpy(bs),
                                        tau0=torch.from_numpy(t0s), **k),
        lambda **k: fasta_tpu.microsolve_batch(pj, jnp.asarray(bs),
                                               tau0=jnp.asarray(t0s), **k),
        B, max_iters=200, tol=1e-6)
    for i in range(B):
        # each instance starts from its own τ₀
        assert rb.taus[i][0] == t0s[i] * 0.2 ** rb.backtracks[i][0]
    with pytest.raises(ValueError, match="per-instance tau0"):
        pt.microsolve_batch(torch.from_numpy(bs),
                            tau0=torch.tensor([0.05, 0.05]), max_iters=10)


def test_per_instance_tau0_planar_matches_jax():
    pj, pt = _pair("phase_retrieval", m=128, n=16, planar=True)
    B = 2
    bs = _stack(pj.fterm.b, B)
    t0s = np.array([0.01, 0.03], np.float32)
    _hold_batch(
        lambda **k: pt.microsolve_batch(torch.from_numpy(bs),
                                        tau0=torch.from_numpy(t0s), **k),
        lambda **k: fasta_tpu.microsolve_batch(pj, jnp.asarray(bs),
                                               tau0=jnp.asarray(t0s), **k),
        # the first BB step from τ₀ = 0.01 divides a tiny Δx by a Δg that
        # cancels, so the second τ agrees to 4e-4 only (single solves
        # alike: 33.967 against 33.979); held over the first iteration
        B, prefix=1, max_iters=200, tol=1e-4)


def test_batch_shape_errors_match_jax():
    pj, pt = _pair("lasso", m=64, n=128, k=6)
    b = np.asarray(pj.fterm.b, np.float32)
    for solve, arr in ((pt.microsolve_batch, torch.from_numpy),
                       (lambda *a, **k: fasta_tpu.microsolve_batch(pj, *a,
                                                                   **k),
                        jnp.asarray)):
        with pytest.raises(ValueError, match="leading batch axis"):
            solve(arr(b), tau0=0.05)
        with pytest.raises(ValueError, match="x0s shape"):
            solve(arr(_stack(b, 2)), x0s=arr(np.zeros((3, 128), np.float32)),
                  tau0=0.05)


def test_batch_raw_wrappers_match_separate_plain_solves():
    """The raw batched wrappers' plain versions are the single plain
    solves stacked, with a shared start and a shared τ₀ read as one."""
    pt = problems.build("lasso", m=40, n=80, k=4, device="cpu")
    A, b, x0 = pt.op.A, pt.fterm.b, pt.x0
    bs = torch.stack([b, 1.5 * b])
    out = microsolver.microsolve_lasso_batch(A, bs, x0, 0.05, 0.1,
                                             max_iters=50, record_bts=True)
    for i in range(2):
        one = microsolver.microsolve_lasso(A, bs[i], x0, 0.05, 0.1,
                                           max_iters=50, record_bts=True)
        assert all(torch.equal(u[i], v) for u, v in zip(out, one)
                   if v is not None)
    with pytest.raises(ValueError, match="leading batch axis"):
        microsolver.microsolve_lasso_batch(A, b, x0, 0.05, 0.1)
    with pytest.raises(ValueError, match="per-instance tau0"):
        microsolver.microsolve_lasso_batch(A, bs, x0, torch.ones(3), 0.1)
