"""The CUDA kernels against their plain versions on the card.

These tests need an NVIDIA Hopper GPU and the CUDA toolkit (the kernels
are built with nvcc at first use); elsewhere they skip.  Run them on the
card with

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from fasta_tpu_torch import problems
from fasta_tpu_torch.kernels import lstsq_fused, microsolver

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("m,n,cluster", [
    (1000, 2000, 1), (997, 1999, 1), (3, 5, 1), (4096, 8192, 1),
    # rows wider than one block holds (16384 floats) are split over a
    # cluster of up to 8 blocks; wider still, the wide kernel (0)
    (4096, 32768, 2), (37, 16385, 2), (300, 100000, 7), (9, 70001, 5),
    (64, 131072, 8), (40, 200000, 0), (7, 150001, 0)])
def test_gradmap_kernel_matches_plain(dev, m, n, cluster):
    """Aligned and ragged shapes (n % 4 != 0 takes the scalar path), each
    on the kernel variant its width selects; tolerance 1e-5 of the
    largest entry — float32 sums in another order."""
    assert lstsq_fused._plan(dev.index or 0, m, n)[0] == cluster
    g = torch.Generator(device=dev).manual_seed(m + n)
    A = torch.randn((m, n), generator=g, device=dev) / m ** 0.5
    x = torch.randn(n, generator=g, device=dev)
    b = torch.randn(m, generator=g, device=dev)
    before = lstsq_fused.LAUNCHES
    d, f, gr = lstsq_fused.fused_lstsq_gradmap(A, x, b)
    assert lstsq_fused.LAUNCHES == before + 1
    d0, f0, g0 = lstsq_fused.lstsq_gradmap_reference(A, x, b)
    torch.cuda.synchronize()
    assert (d - d0).abs().max() <= 1e-5 * max(1.0, float(d0.abs().max()))
    assert (gr - g0).abs().max() <= 1e-5 * max(1.0, float(g0.abs().max()))
    assert abs(float(f) - float(f0)) <= 1e-5 * abs(float(f0))
    # deterministic: no atomics, fixed summation order
    d2, f2, g2 = lstsq_fused.fused_lstsq_gradmap(A, x, b)
    assert torch.equal(d, d2) and torch.equal(gr, g2) and torch.equal(f, f2)


def test_gradmap_kernel_rejects_what_it_does_not_take(dev):
    A = torch.zeros((8, 8), device=dev)
    x, b = torch.zeros(8, device=dev), torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="float32"):
        lstsq_fused.fused_lstsq_gradmap(A.double(), x.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        lstsq_fused.fused_lstsq_gradmap(A.t(), x, b)


@pytest.mark.parametrize("hp", [False, True])
@pytest.mark.parametrize("stop_rule,m,n", [
    ("hybrid_residual", 500, 1000), ("residual", 500, 1000),
    ("normalized_residual", 500, 1000), ("ratio_residual", 500, 1000),
    # ragged rows and columns take the kernel's scalar-load path
    ("hybrid_residual", 301, 699)])
def test_microsolve_kernel_matches_plain(dev, hp, stop_rule, m, n):
    p = problems.build("lasso", m=m, n=n, k=m // 10, device=dev)
    A, b, x0 = p.op.A, p.fterm.b, p.x0
    kw = dict(max_iters=3000, tol=1e-6, hp=hp, stop_rule=stop_rule,
              record_fvals=True, record_bts=True)
    before = microsolver.LAUNCHES
    out = microsolver.microsolve_lasso(A, b, x0, 0.05, 0.1, **kw)
    assert microsolver.LAUNCHES == before + 1
    ref = microsolver.microsolve_lasso_reference(A, b, x0, 0.05, 0.1, **kw)
    assert out.status == ref.status == "converged"
    k1, k2 = int(out.iteration_count), int(ref.iteration_count)
    assert abs(k1 - k2) <= 2
    k = min(k1, k2)
    torch.testing.assert_close(out.residuals[:k], ref.residuals[:k],
                               rtol=1e-3, atol=1e-6)
    torch.testing.assert_close(out.x, ref.x, rtol=0, atol=1e-5)
    torch.testing.assert_close(out.taus[:10], ref.taus[:10], rtol=1e-3,
                               atol=0)
    # deterministic from run to run
    again = microsolver.microsolve_lasso(A, b, x0, 0.05, 0.1, **kw)
    assert torch.equal(again.x, out.x) and torch.equal(again.taus, out.taus)


def test_microsolve_kernel_fixed_iterations_and_window(dev):
    """stop_rule="iterations" runs exactly max_iters; a window of 1 is
    the monotone line search.  Fixed-count runs stop before the float32
    noise floor, so counts and early taus agree with the plain version.
    With hp the monotone search keeps its iteration count too; without
    it, see test_microsolve_kernel_monotone_window_float32."""
    p = problems.build("lasso", m=400, n=800, k=40, device=dev)
    for kw in (dict(stop_rule="iterations", max_iters=15),
               dict(window=1, max_iters=500, tol=1e-6, hp=True)):
        out = microsolver.microsolve_lasso(p.op.A, p.fterm.b, p.x0, 0.05,
                                           0.1, **kw)
        ref = microsolver.microsolve_lasso_reference(p.op.A, p.fterm.b,
                                                     p.x0, 0.05, 0.1, **kw)
        assert out.status == ref.status
        assert abs(int(out.iteration_count) - int(ref.iteration_count)) <= 2
        torch.testing.assert_close(out.taus[:10], ref.taus[:10], rtol=1e-3,
                                   atol=0)
    assert int(out.iteration_count) > 0


def test_microsolve_kernel_monotone_window_float32(dev):
    """window=1 with hp off: the monotone test compares f-values in
    float32.  Once f's decrease per iteration falls within float32
    resolution, the order of the float32 sums decides the test and the
    two runs may part.  Held to: equal status, taus rtol 1e-3 on the
    first 10 iterations, and equal backtracks and residuals rtol 1e-3 /
    atol 1e-6 on the prefix before the plain run's decrease first falls
    within 64 ulps of f."""
    p = problems.build("lasso", m=400, n=800, k=40, device=dev)
    kw = dict(window=1, max_iters=500, tol=1e-6, hp=False,
              record_fvals=True, record_bts=True)
    out = microsolver.microsolve_lasso(p.op.A, p.fterm.b, p.x0, 0.05, 0.1,
                                       **kw)
    ref = microsolver.microsolve_lasso_reference(p.op.A, p.fterm.b, p.x0,
                                                 0.05, 0.1, **kw)
    assert out.status == ref.status == "converged"
    torch.testing.assert_close(out.taus[:10], ref.taus[:10], rtol=1e-3,
                               atol=0)
    f = ref.fvals[:int(ref.iteration_count)].cpu().numpy()
    ulps = np.abs(np.diff(f)) / np.spacing(np.abs(f[1:]))
    prefix = 1 + int(np.argmax(ulps <= 64)) if (ulps <= 64).any() else len(f)
    assert prefix >= 10
    torch.testing.assert_close(out.backtracks[:prefix],
                               ref.backtracks[:prefix], rtol=0, atol=0)
    torch.testing.assert_close(out.residuals[:prefix],
                               ref.residuals[:prefix], rtol=1e-3, atol=1e-6)


def test_microsolve_kernel_halts_nonfinite(dev):
    p = problems.build("lasso", m=300, n=700, k=30, device=dev)
    b = p.fterm.b.clone()
    b[7] = float("nan")
    out = microsolver.microsolve_lasso(p.op.A, b, p.x0, 0.05, 0.1,
                                       max_iters=100, tol=1e-6)
    assert out.status == "nonfinite" and int(out.iteration_count) == 1


def test_main_path_on_the_card_reaches_the_cpu_result(dev):
    """The same instance through the port on the card and on the CPU:
    equal iteration counts (within 2) and solutions within 1e-5."""
    kw = dict(m=300, n=700, k=30)
    pg = problems.build("lasso", device=dev, **kw)
    pc = problems.build("lasso", device="cpu", **kw)
    for p in (pg, pc):
        p.tau0 = 0.05
    rg, rc = pg.solve(tol=1e-6, max_iters=2000), pc.solve(tol=1e-6,
                                                          max_iters=2000)
    assert rg.converged and rc.converged
    assert abs(rg.iteration_count - rc.iteration_count) <= 2
    np.testing.assert_allclose(rg.solution, rc.solution, atol=1e-5)
    mg, mc = pg.microsolve(tol=1e-6), pc.microsolve(tol=1e-6)
    assert mg.status == mc.status == "converged"
    np.testing.assert_allclose(mg.solution.cpu().numpy(),
                               mc.solution.numpy(), atol=1e-5)
