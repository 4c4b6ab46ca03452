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
from fasta_tpu_torch.kernels import (lstsq_fused, microsolver, microsolver_tv,
                                     tv_fused)

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


# --------------------------------------------------------------------------
# K-B3p, the rest of K-B1, K-B1p
# --------------------------------------------------------------------------

@pytest.mark.parametrize("loss", ["logistic", "squared_hinge"])
@pytest.mark.parametrize("m,n", [
    (1000, 500), (997, 1999), (3, 5), (4096, 32768), (40, 200000)])
def test_pointwise_gradmap_kernel_matches_plain(dev, loss, m, n):
    """K-B3p on the one-block, cluster and wide routes, ragged shapes
    included: only real rows are reduced, although ℓ(0) ≠ 0.  Tolerance
    as K-B3's."""
    g = torch.Generator(device=dev).manual_seed(m + n)
    A = torch.randn((m, n), generator=g, device=dev) / m ** 0.5
    x = 3.0 * torch.randn(n, generator=g, device=dev)
    y = (torch.rand(m, generator=g, device=dev) < 0.5).float()
    if loss == "squared_hinge":
        y = 2.0 * y - 1.0
    before = lstsq_fused.POINTWISE_LAUNCHES
    d, f, gr = lstsq_fused.fused_pointwise_gradmap(A, x, y, loss)
    assert lstsq_fused.POINTWISE_LAUNCHES == before + 1
    d0, f0, g0 = lstsq_fused.pointwise_gradmap_reference(A, x, y, loss)
    torch.cuda.synchronize()
    assert (d - d0).abs().max() <= 1e-5 * max(1.0, float(d0.abs().max()))
    assert (gr - g0).abs().max() <= 1e-5 * max(1.0, float(g0.abs().max()))
    assert abs(float(f) - float(f0)) <= 1e-5 * abs(float(f0))
    d2, f2, g2 = lstsq_fused.fused_pointwise_gradmap(A, x, y, loss)
    assert torch.equal(d, d2) and torch.equal(gr, g2) and torch.equal(f, f2)


def test_kernels_reject_what_they_do_not_take(dev):
    """A CUDA tensor launches the kernel or raises; none falls back."""
    A = torch.zeros((8, 8), device=dev)
    x, y = torch.zeros(8, device=dev), torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="float32"):
        lstsq_fused.fused_pointwise_gradmap(A.double(), x.double(),
                                            y.double(), "logistic")
    with pytest.raises(ValueError, match="contiguous"):
        lstsq_fused.fused_pointwise_gradmap(A.t(), x, y, "squared_hinge")
    with pytest.raises(ValueError, match="loss"):
        lstsq_fused.fused_pointwise_gradmap(A, x, y, "huber")
    with pytest.raises(ValueError, match="float32"):
        microsolver.microsolve_lasso(A.double(), y, x, 0.1, 0.1,
                                     loss="logistic")
    with pytest.raises(ValueError, match="contiguous"):
        microsolver.microsolve_lasso_path(A.t(), y, x, 0.1, [0.1, 0.05])
    with pytest.raises(ValueError, match="share a device"):
        microsolver.microsolve_lasso_path(A, y.cpu(), x, 0.1, [0.1])


def _dense(dev, loss):
    """(A, b, x0, tau0, μ) of each loss's full-width problem."""
    name, tau0, mu = {"lstsq": ("nnls", 0.08, 0.05),
                      "logistic": ("logistic", 1.0, 0.02),
                      "squared_hinge": ("svm", 0.3, 0.2)}[loss]
    p = problems.build(name, device=dev)
    data = p.fterm.y if loss == "squared_hinge" else p.fterm.b
    return p.op.A, data, p.x0, tau0, mu


def _objective(A, b, x, loss, prox, mu):
    A, b, x = A.double(), b.double(), x.double()
    z = A @ x
    if loss == "lstsq":
        f = 0.5 * torch.sum((z - b) ** 2)
    elif loss == "logistic":
        f = torch.sum(torch.clamp_min(z, 0) + torch.log1p(torch.exp(-z.abs()))
                      - b * z)
    else:
        f = 0.5 * torch.sum(torch.clamp_min(1 - b * z, 0) ** 2)
    g = {"l1": mu * x.abs().sum(), "ridge": 0.5 * mu * x @ x}.get(prox, 0.0)
    return float(f + g)


@pytest.mark.parametrize("accelerate", [False, True])
@pytest.mark.parametrize("loss", ["lstsq", "logistic", "squared_hinge"])
@pytest.mark.parametrize("prox", ["l1", "nonneg", "box", "ridge"])
def test_microsolve_kernel_pairs_match_plain(dev, loss, prox, accelerate):
    """Every loss × prox pair, adaptive and FISTA, hp on, at the
    problems' full widths: equal status, iteration counts within 2 (the
    logistic loss, whose backtracking is knife-edge: the objective
    check alone), first-10 taus rtol 1e-3, objective within 1e-5, and
    every recorded series present."""
    A, b, x0, tau0, mu = _dense(dev, loss)
    kw = dict(max_iters=2000, tol=1e-5, hp=True, restart_dd=True,
              loss=loss, prox=prox, accelerate=accelerate,
              record_fvals=True, record_bts=True, record_objs=True,
              record_nres=True)
    before = microsolver.LAUNCHES
    out = microsolver.microsolve_lasso(A, b, x0, tau0, mu, **kw)
    assert microsolver.LAUNCHES == before + 1
    ref = microsolver.microsolve_lasso_reference(A, b, x0, tau0, mu, **kw)
    assert out.status == ref.status == "converged"
    k1, k2 = int(out.iteration_count), int(ref.iteration_count)
    if loss != "logistic":
        assert abs(k1 - k2) <= 2
    torch.testing.assert_close(out.taus[:10], ref.taus[:10], rtol=1e-3,
                               atol=0)
    f1 = _objective(A, b, out.x, loss, prox, mu)
    f2 = _objective(A, b, ref.x, loss, prox, mu)
    assert abs(f1 - f2) <= 1e-5 * abs(f2)
    k = min(k1, k2)
    torch.testing.assert_close(out.objectives[:10], ref.objectives[:10],
                               rtol=1e-4, atol=0)
    assert torch.isfinite(out.norm_residuals[:k]).all()
    again = microsolver.microsolve_lasso(A, b, x0, tau0, mu, **kw)
    assert torch.equal(again.x, out.x)


def test_microsolve_kernel_records_iterates(dev):
    A, b, x0, tau0, mu = _dense(dev, "lstsq")
    out = microsolver.microsolve_lasso(A, b, x0, tau0, mu, prox="nonneg",
                                       max_iters=50, tol=1e-5,
                                       record_its=True)
    k = int(out.iteration_count)
    assert out.status == "converged"
    assert torch.equal(out.iterates[k - 1], out.x)
    assert not out.iterates[k:].any()
    assert (out.iterates[:k] >= 0).all()


@pytest.mark.parametrize("accelerate", [False, True])
def test_path_kernel_matches_plain_and_separate_solves(dev, accelerate):
    """K-B1p on LASSO 1000×2000: cold points bit-identical to separate
    K-B1 launches; warm points converge to the plain path's objectives
    in fewer total iterations."""
    p = problems.build("lasso", device=dev)
    A, b, x0 = p.op.A, p.fterm.b, p.x0
    mus = [0.4, 0.2, 0.1, 0.05]
    kw = dict(max_iters=3000, tol=1e-5, stop_rule="residual",
              accelerate=accelerate, record_bts=True)
    before = microsolver.PATH_LAUNCHES
    cold = microsolver.microsolve_lasso_path(A, b, x0, 0.05, mus,
                                             warm=False, **kw)
    warm = microsolver.microsolve_lasso_path(A, b, x0, 0.05, mus,
                                             warm=True, **kw)
    assert microsolver.PATH_LAUNCHES == before + 2
    for i, mu in enumerate(mus):
        one = microsolver.microsolve_lasso(A, b, x0, 0.05, mu, **kw)
        assert torch.equal(cold.x[i], one.x)
        assert torch.equal(cold.taus[i], one.taus)
        assert int(cold.iteration_count[i]) == int(one.iteration_count)
    assert (cold.halt == 1).all() and (warm.halt == 1).all()
    assert int(warm.iteration_count.sum()) < int(cold.iteration_count.sum())
    ref = microsolver.microsolve_lasso_path_reference(A, b, x0, 0.05, mus,
                                                      warm=True, **kw)
    for i, mu in enumerate(mus):
        f1 = _objective(A, b, warm.x[i], "lstsq", "l1", mu)
        f2 = _objective(A, b, ref.x[i], "lstsq", "l1", mu)
        assert abs(f1 - f2) <= 1e-5 * abs(f2)


def test_slice_main_path_on_the_card(dev):
    """problems.build → Problem.solve (three modes) and
    Problem.microsolve on the card reach the CPU run's objective, and the
    logistic and SVM loops go through K-B3p."""
    for name, tau0 in (("nnls", 0.08), ("logistic", 1.0), ("svm", 0.3)):
        pg = problems.build(name, device=dev)
        pg.tau0 = tau0
        before = lstsq_fused.POINTWISE_LAUNCHES
        r = pg.solve(tol=1e-6, max_iters=3000)
        assert r.converged
        if name != "nnls":
            assert lstsq_fused.POINTWISE_LAUNCHES > before
        for mode in (dict(adaptive=False, max_iters=200),
                     dict(accelerate=True, max_iters=3000)):
            rr = pg.solve(tol=1e-6, **mode)
            assert np.isfinite(rr.solution).all()
        m = pg.microsolve(tol=1e-6, max_iters=3000, accelerate=True,
                          hp=True)
        assert m.status == "converged"


@pytest.mark.parametrize("h,w", [(512, 512), (509, 517), (1, 7), (7, 1),
                                 (1, 1), (130, 70), (2049, 33)])
def test_tv_gradmap_kernel_matches_plain(dev, h, w):
    """K-B5 at aligned, ragged and one-row / one-column shapes: d and g
    round like the plain version (max|Δ| ≤ 1e-6 of the scale), f (an
    FP64 sum in the kernel) to rel 1e-5; deterministic from run to run."""
    g = torch.Generator(device=dev).manual_seed(h * w)
    p = torch.randn((2, h, w), generator=g, device=dev)
    b = torch.randn((h, w), generator=g, device=dev)
    before = tv_fused.LAUNCHES
    d, f, gr = tv_fused.fused_tv_gradmap(p, b, 0.1)
    assert tv_fused.LAUNCHES == before + 1
    d0, f0, g0 = tv_fused.tv_gradmap_reference(p, b, 0.1)
    torch.cuda.synchronize()
    assert (d - d0).abs().max() <= 1e-6 * max(1.0, float(d0.abs().max()))
    assert (gr - g0).abs().max() <= 1e-6 * max(1.0, float(g0.abs().max()))
    assert abs(float(f) - float(f0)) <= 1e-5 * max(abs(float(f0)), 1e-30)
    d2, f2, g2 = tv_fused.fused_tv_gradmap(p, b, 0.1)
    assert torch.equal(d, d2) and torch.equal(gr, g2) and torch.equal(f, f2)


def test_tv_kernels_reject_what_they_do_not_take(dev):
    p = torch.zeros((2, 8, 8), device=dev)
    b = torch.zeros((8, 8), device=dev)
    with pytest.raises(ValueError, match="float32"):
        tv_fused.fused_tv_gradmap(p.double(), b.double(), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        tv_fused.fused_tv_gradmap(p.transpose(1, 2), b, 0.1)
    with pytest.raises(ValueError, match="share a device"):
        tv_fused.fused_tv_gradmap(p, b.cpu(), 0.1)
    with pytest.raises(ValueError, match="float32"):
        microsolver_tv.microsolve_tv(b.double(), p.double(), 1.0, 0.1)


def _tv(dev, h=128, w=96):
    prob = problems.build("tv", h=h, w=w, device=dev)
    return prob.fterm.b, prob.x0, float(prob.instance["mu"])


@pytest.mark.parametrize("accelerate", [False, True])
@pytest.mark.parametrize("hp", [False, True])
@pytest.mark.parametrize("h,w", [(128, 96), (7, 300), (300, 5)])
def test_tv_microsolve_kernel_matches_plain(dev, accelerate, hp, h, w):
    """K-B6 against its plain version on the card over 40 iterations: the
    first 10 taus and residuals rtol 1e-3, the backtracks equal, the
    float64 dual objective rel 1e-5 (the order of float32 sums moves the
    knife-edge trajectory later on).  Images narrower or shorter than the
    grid leave blocks without pixels."""
    b, p0, mu = _tv(dev, h, w)
    kw = dict(max_iters=40, tol=0.0, stop_rule="iterations", hp=hp,
              accelerate=accelerate, record_bts=True, record_fvals=True,
              record_objs=True, record_nres=True)
    before = microsolver_tv.LAUNCHES
    out = microsolver_tv.microsolve_tv(b, p0, 2.0, mu, **kw)
    assert microsolver_tv.LAUNCHES == before + 1
    ref = microsolver_tv.microsolve_tv_reference(b, p0, 2.0, mu, **kw)
    torch.cuda.synchronize()
    assert int(out.iteration_count) == int(ref.iteration_count) == 40
    assert out.iterates is None
    torch.testing.assert_close(out.taus[:10], ref.taus[:10], rtol=1e-3,
                               atol=0.0)
    torch.testing.assert_close(out.residuals[:10], ref.residuals[:10],
                               rtol=1e-3, atol=1e-6)
    assert torch.equal(out.backtracks[:10], ref.backtracks[:10])

    def dual(p):
        r = mu * tv_fused.tv_gradmap_reference(p.double(), b.double(),
                                               1.0)[0] - b.double()
        return float(0.5 * (r * r).sum())
    assert abs(dual(out.x) - dual(ref.x)) <= 1e-5 * dual(ref.x)


def test_tv_microsolve_kernel_converges_and_halts_nonfinite(dev):
    b, p0, mu = _tv(dev)
    for accelerate in (False, True):
        out = microsolver_tv.microsolve_tv(b, p0, 2.0, mu, max_iters=5000,
                                           tol=1e-5, accelerate=accelerate)
        ref = microsolver_tv.microsolve_tv_reference(
            b, p0, 2.0, mu, max_iters=5000, tol=1e-5, accelerate=accelerate)
        assert out.status == ref.status == "converged"
        assert abs(int(out.iteration_count) - int(ref.iteration_count)) <= \
            max(5, int(0.2 * int(ref.iteration_count)))
    bad = microsolver_tv.microsolve_tv(b, p0, float("nan"), mu,
                                       max_iters=50)
    assert bad.status == "nonfinite" and int(bad.iteration_count) <= 3


def _warm_starts(out, tau0, accelerate, max_bt=20):
    """Each warm path point's start τ from the run's records: the last τ
    point i−1 accepted in fewer than ``max_bt`` trials, when > 0 and the
    point ended finite, else point i−1's own start; FISTA keeps τ₀."""
    starts, start = [], float(tau0)
    for i in range(out.iteration_count.shape[0]):
        starts.append(float(tau0) if accelerate else start)
        k = int(out.iteration_count[i])
        good = (out.backtracks[i, :k] < max_bt).nonzero().flatten()
        acc = float(out.taus[i, good[-1]]) if len(good) else 0.0
        if int(out.halt[i]) != 2 and acc > 0.0:
            start = acc
    return starts


@pytest.mark.parametrize("accelerate", [False, True])
def test_tv_path_kernel_cold_points_match_separate_solves(dev, accelerate):
    """K-B6p: cold points bit-identical to separate K-B6 launches from
    p₀; warm point i bit-identical to a K-B6 launch from point i−1's
    field with the τ the JAX code carries; the warm path converges at
    every weight."""
    b, p0, _ = _tv(dev)
    mus = [0.2, 0.1, 0.05]
    kw = dict(max_iters=5000, tol=1e-5, accelerate=accelerate,
              record_bts=True)
    before = microsolver_tv.PATH_LAUNCHES
    cold = microsolver_tv.microsolve_tv_path(b, p0, 2.0, mus, warm=False,
                                             **kw)
    warm = microsolver_tv.microsolve_tv_path(b, p0, 2.0, mus, warm=True,
                                             **kw)
    assert microsolver_tv.PATH_LAUNCHES == before + 2
    for i, mu in enumerate(mus):
        one = microsolver_tv.microsolve_tv(b, p0, 2.0, mu, **kw)
        assert torch.equal(cold.x[i], one.x)
        assert torch.equal(cold.taus[i], one.taus)
        assert int(cold.iteration_count[i]) == int(one.iteration_count)
    assert (cold.halt == 1).all() and (warm.halt == 1).all()
    starts = _warm_starts(warm, 2.0, accelerate)
    for i, mu in enumerate(mus):
        start = warm.x[i - 1] if i > 0 else p0
        one = microsolver_tv.microsolve_tv(b, start, starts[i], mu, **kw)
        assert torch.equal(warm.x[i], one.x)
        assert torch.equal(warm.taus[i], one.taus)
        assert int(warm.iteration_count[i]) == int(one.iteration_count)
    if not accelerate:
        assert starts[1] != 2.0      # the τ carry is exercised


def test_tv_main_path_on_the_card(dev):
    """problems.build("tv") → Problem.solve (three modes, K-B5 on the
    float32 loop), Problem.microsolve and microsolve_sweep on the card
    reach the CPU run's dual objective."""
    pg = problems.build("tv", h=96, w=80, device=dev)
    pc = problems.build("tv", h=96, w=80, device="cpu")
    mu = float(pg.instance["mu"])

    def dual(p):
        r = mu * tv_fused.tv_gradmap_reference(
            torch.as_tensor(p).double().cpu(), pc.fterm.b.double(), 1.0)[0] \
            - pc.fterm.b.double()
        return float(0.5 * (r * r).sum())

    goal = dual(pc.solve(tau0=2.0, tol=1e-6, max_iters=5000).solution)
    before = tv_fused.LAUNCHES
    for mode in (dict(), dict(adaptive=False), dict(accelerate=True)):
        r = pg.solve(tau0=2.0, tol=1e-6, max_iters=5000, **mode)
        assert np.isfinite(r.solution).all()
        if not mode:
            assert r.converged and abs(dual(r.solution) - goal) <= 1e-5 * goal
    assert tv_fused.LAUNCHES > before
    m = pg.microsolve(tau0=2.0, tol=1e-6, max_iters=5000)
    assert m.status == "converged" and m.solution.is_cuda
    assert abs(dual(m.solution) - goal) <= 1e-5 * goal
    sw = pg.microsolve_sweep([0.2, mu], tau0=2.0, tol=1e-6, max_iters=5000,
                             warm_start=True)
    assert sw.converged.all() and sw.solutions.shape == (2, 2, 96, 80)
