"""The CUDA kernels against their plain versions on the card.

These tests need an NVIDIA Hopper GPU and the CUDA toolkit (the kernels
are built with nvcc at first use); elsewhere they skip.  Run them on the
card with

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q
"""

import numpy as np
import pytest
import torch

import fasta_tpu_torch as ftt
from fasta_tpu_torch import problems
from fasta_tpu_torch.kernels.microsolver import MicrosolveOutput
from fasta_tpu_torch.kernels import (bf16_probe, lane_fused, lstsq_fused,
                                     matvec_probe, microsolver,
                                     microsolver_planar, microsolver_tv,
                                     planar_fused, planar_probe, prox_fused,
                                     tail_probe, tv_fused)

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("m,n,route,cluster", [
    # rows of up to 8192 values (2048 ragged): a warp (route 1) or a
    # group of threads (route 2) a row, no clusters
    (1000, 2000, 2, 1), (997, 1999, 2, 1), (3, 5, 1, 1), (4096, 8192, 2, 1),
    # wider rows stream over a cluster of up to 8 blocks of 16384 columns
    # each (route 3); wider still, the wide kernel (route 4)
    (4096, 32768, 3, 2), (37, 16385, 3, 2), (300, 100000, 3, 7),
    (9, 70001, 3, 5), (64, 131072, 3, 8), (40, 200000, 4, 1),
    (7, 150001, 4, 1)])
def test_gradmap_kernel_matches_plain(dev, m, n, route, cluster):
    """Aligned and ragged shapes (n % 4 != 0 takes the scalar path), each
    on the route its width selects; tolerance 1e-5 of the largest entry —
    float32 sums in another order."""
    plan = lstsq_fused._plan(dev.index or 0, m, n)
    assert (plan.route, plan.cluster) == (route, cluster)
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


def _gradmap_data(dev, m, n, loss, bf16=False):
    g = torch.Generator(device=dev).manual_seed(m * 7 + n)
    A = torch.randn((m, n), generator=g, device=dev) / m ** 0.5
    if bf16:
        A = A.to(torch.bfloat16)
    x = 3.0 * torch.randn(n, generator=g, device=dev)
    y = torch.randn(m, generator=g, device=dev)
    if loss == "logistic":
        y = (y > 0).float()
    elif loss == "squared_hinge":
        y = torch.where(y > 0, 1.0, -1.0)
    return A, x, y


def _gradmap_call(A, x, y, loss):
    if loss == "lstsq":
        return lstsq_fused.fused_lstsq_gradmap(A, x, y)
    return lstsq_fused.fused_pointwise_gradmap(A, x, y, loss)


def _gradmap_ref(A, x, y, loss):
    if loss == "lstsq":
        return lstsq_fused.lstsq_gradmap_reference(A, x, y)
    return lstsq_fused.pointwise_gradmap_reference(A, x, y, loss)


def _close(got, ref):
    (d, f, g), (d0, f0, g0) = got, ref
    torch.cuda.synchronize()
    assert (d - d0).abs().max() <= 1e-5 * max(1.0, float(d0.abs().max()))
    assert (g - g0).abs().max() <= 1e-5 * max(1.0, float(g0.abs().max()))
    assert abs(float(f) - float(f0)) <= 1e-5 * abs(float(f0))


@pytest.mark.parametrize("bf16", [False, True])
def test_gradmap_card_plan_is_the_pure_plan(dev, bf16):
    """K-B3's plan on the card (csrc/lstsq_fused.cu: route, column slots,
    threads, blocks, cluster, shared bytes, rows at once or a tile) is
    ``gradmap_plan`` at the card's slots, on every route, aligned and
    ragged, at the main paths' shapes and past the card's slots; the rows
    routes' slots are BLOCKS_PER_SM blocks an SM, which the card holds at
    once (the grid barrier needs it)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m, n in [(256, 1024), (1000, 2000), (1000, 500), (800, 100),
                 (3, 5), (1000, 1003), (997, 1999), (4096, 8192),
                 (100000, 512), (50000, 2048), (37, 16385), (4096, 32768),
                 (300, 100000), (64, 131072), (40, 200000), (7, 150001),
                 (8192, 16384), (1024, 200000)]:
        card = lstsq_fused._card_plan(dev.index or 0, m, n, bf16)
        plan = lstsq_fused.gradmap_plan(m, n, bf16, card[-1])
        assert card[:-1] == (plan.route, plan.cpt, plan.threads, plan.blocks,
                             plan.cluster, plan.smem_bytes,
                             plan.tile_rows), (m, n)
        assert lstsq_fused._plan(dev.index or 0, m, n, bf16) == plan
        if plan.route in (1, 2):
            assert card[-1] == lstsq_fused.BLOCKS_PER_SM * sms, (m, n)


@pytest.mark.parametrize("loss", ["lstsq", "logistic", "squared_hinge"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m,n", [(800, 100), (1000, 500), (256, 1024),
                                 (1000, 2000), (333, 511), (50, 6000)])
def test_gradmap_rows_routes_match_plain(dev, loss, bf16, m, n):
    """Routes 1 and 2 against the plain version, within 1e-5 of the
    largest entry, a second call bit for bit; the call leaves the
    stream's counters at zero."""
    A, x, y = _gradmap_data(dev, m, n, loss, bf16)
    assert lstsq_fused._plan(dev.index or 0, m, n, bf16).route in (1, 2)
    got = _gradmap_call(A, x, y, loss)
    _close(got, _gradmap_ref(A, x, y, loss))
    assert all(torch.equal(u, v)
               for u, v in zip(got, _gradmap_call(A, x, y, loss)))
    stream = torch.cuda.current_stream().cuda_stream
    from fasta_tpu_torch.kernels import _build
    work = _build.stream_scratch(dev, stream, 1)
    torch.cuda.synchronize()
    assert float(work[0]) == 0.0


def _gradmap_cases(dev):
    """One call a route: 800×100 (route 1), 256×1024 and 1000×2000 (route
    2), 300×20000 (route 3), 24×140000 (route 4), the three losses among
    them, one over a bfloat16 A."""
    cases = []
    for m, n, loss, bf16 in [(800, 100, "squared_hinge", False),
                             (256, 1024, "lstsq", False),
                             (1000, 2000, "logistic", False),
                             (300, 20000, "lstsq", True),
                             (24, 140000, "lstsq", False)]:
        A, x, y = _gradmap_data(dev, m, n, loss, bf16)
        cases.append(lambda A=A, x=x, y=y, loss=loss: _gradmap_call(
            A, x, y, loss))
    routes = sorted({lstsq_fused._plan(dev.index or 0, *shape).route
                     for shape in [(800, 100), (256, 1024), (1000, 2000),
                                   (24, 140000)]}
                    | {lstsq_fused._plan(dev.index or 0, 300, 20000,
                                         True).route})
    assert routes == [1, 2, 3, 4]
    return cases


def test_gradmap_graph_replay_and_shared_ticket_are_deterministic(dev):
    """Every route gives the same bits on two calls, on two replays of one
    captured CUDA graph of two calls each, and on a call right after a
    K-B4 and a K-B7 launch on the same stream (the kernels that share the
    stream's scratch and its first word).  The graph is captured on the
    side stream its warm-up ran on, so its scratch was zeroed before the
    capture: the graph holds the kernels and no memset, and its replays
    pass only if every launch leaves its counters at zero."""
    cases = _gradmap_cases(dev)
    want = [fn() for fn in cases]
    again = [fn() for fn in cases]
    for u, v in zip(want, again):
        assert all(torch.equal(a, b) for a, b in zip(u, v))
    g = torch.Generator(device=dev).manual_seed(17)
    x0 = torch.randn((1, 1 << 22), generator=g, device=dev)
    gr = torch.randn((1, 1 << 22), generator=g, device=dev)
    Ar, Ai, xp, _, bh = _planar_data(dev, 4099, 256)
    for fn, ref in zip(cases, want):
        prox_fused.fused_shrink_step(x0, gr, 0.3, 0.5)
        planar_fused.fused_planar_hinge_gradmap(Ar, Ai, xp, bh)
        assert all(torch.equal(a, b) for a, b in zip(fn(), ref))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in cases:
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        first = [fn() for fn in cases]
        second = [fn() for fn in cases]
    from fasta_tpu_torch import profiling
    kinds = profiling.graph_node_kinds(graph)
    assert (kinds["kernel"], kinds["memset"], kinds["memcpy"]) == \
        (2 * len(cases), 0, 0), kinds
    for _ in range(2):
        for out in first + second:
            for t in out:
                t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for outs in (first, second):
            for u, v in zip(outs, want):
                assert all(torch.equal(a, b) for a, b in zip(u, v))


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
                                 (1, 1), (130, 70), (2049, 33),
                                 # band and strip boundaries, W % 4 != 0
                                 (4, 4), (5, 1025), (3, 1030), (263, 4099),
                                 (1, 100000), (66000, 3), (4096, 4096)])
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


@pytest.mark.parametrize("hb,w,edges", [
    (128, 512, "middle"), (128, 512, "top"), (128, 512, "bottom"),
    (1, 512, "middle"), (1, 512, "last below"), (128, 509, "middle"),
    (7, 33, "middle"), (3, 2000, "top"), (128, 512, "whole")])
def test_tv_band_kernel_matches_plain(dev, hb, w, edges):
    """K-B5's band form (a rank's rows of a row-sharded image) against its
    plain version: with both halos, at the image's top or bottom, a
    one-row band (and one above the image's last row), ragged widths; d
    and g to max|Δ| ≤ 1e-6 of the scale, f to rel 1e-5; with no halo rows
    the K-B5 launch's bits."""
    g = torch.Generator(device=dev).manual_seed(hb * w + len(edges))
    p = torch.randn((2, hb, w), generator=g, device=dev)
    b = torch.randn((hb, w), generator=g, device=dev)
    above = torch.randn(w, generator=g, device=dev)
    below = torch.randn((2, w), generator=g, device=dev)
    b_below = torch.randn(w, generator=g, device=dev)
    if edges == "last below":
        below[0] = 0.0
    halo = {"middle": (above, below, b_below), "top": (None, below, b_below),
            "bottom": (above, None, None), "last below": (above, below,
                                                          b_below),
            "whole": (None, None, None)}[edges]
    before = tv_fused.BAND_LAUNCHES
    d, f, gr = tv_fused.fused_tv_gradmap_band(p, b, 0.1, *halo)
    assert tv_fused.BAND_LAUNCHES == before + 1
    d0, f0, g0 = tv_fused.tv_gradmap_band_reference(p, b, 0.1, *halo)
    torch.cuda.synchronize()
    assert (d - d0).abs().max() <= 1e-6 * max(1.0, float(d0.abs().max()))
    assert (gr - g0).abs().max() <= 1e-6 * max(1.0, float(g0.abs().max()))
    assert abs(float(f) - float(f0)) <= 1e-5 * max(abs(float(f0)), 1e-30)
    if edges == "whole":
        for u, v in zip((d, f, gr), tv_fused.fused_tv_gradmap(p, b, 0.1)):
            assert torch.equal(u, v)


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


def _resident(dev, h, w):
    """Whether an (h, w) image takes K-B6's resident route on the card."""
    return microsolver_tv._bands(dev.index, h, w)[0].resident


@pytest.mark.parametrize("accelerate", [False, True])
@pytest.mark.parametrize("hp", [False, True])
@pytest.mark.parametrize("h,w,resident", [
    (128, 96, True), (7, 300, True), (300, 5, True), (512, 512, True),
    (1024, 1024, False)])
def test_tv_microsolve_kernel_matches_plain(dev, accelerate, hp, h, w,
                                            resident):
    """K-B6 against its plain version on the card over 40 iterations, on
    the resident route and past its gate on the global route (the route
    counter shows which ran): the first 10 taus and residuals rtol 1e-3,
    the backtracks equal, the float64 dual objective rel 1e-5 (the order
    of float32 sums moves the knife-edge trajectory later on).  Images
    narrower or shorter than the grid leave blocks without pixels."""
    b, p0, mu = _tv(dev, h, w)
    kw = dict(max_iters=40, tol=0.0, stop_rule="iterations", hp=hp,
              accelerate=accelerate, record_bts=True, record_fvals=True,
              record_objs=True, record_nres=True)
    assert _resident(dev, h, w) == resident
    before = (microsolver_tv.LAUNCHES, microsolver_tv.LAUNCHES_RESIDENT)
    out = microsolver_tv.microsolve_tv(b, p0, 2.0, mu, **kw)
    assert (microsolver_tv.LAUNCHES, microsolver_tv.LAUNCHES_RESIDENT) == \
        (before[0] + 1, before[1] + resident)
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


# --------------------------------------------------------------------------
# K-B7, K-P5, K-B8: phase retrieval
# --------------------------------------------------------------------------

def _planar_data(dev, m, n):
    g = torch.Generator(device=dev).manual_seed(m * n)
    Ar = torch.randn((m, n), generator=g, device=dev) / (2 * m) ** 0.5
    Ai = torch.randn((m, n), generator=g, device=dev) / (2 * m) ** 0.5
    x = torch.randn((n, 2), generator=g, device=dev)
    bl = torch.randn((m, 2), generator=g, device=dev)
    bh = torch.rand(m, generator=g, device=dev) + 0.1
    return Ar, Ai, x, bl, bh


@pytest.mark.parametrize("loss", ["lstsq", "hinge"])
@pytest.mark.parametrize("m,n,route", [
    (16384, 256, 1), (1000, 37, 1), (4099, 256, 1), (5, 3, 1),
    # rows wider than 512 floats: a block per row; past 8192 (2048 when
    # n % 4 != 0) the wide route
    (1000, 1024, 2), (300, 2046, 2), (40, 9000, 3), (33, 3001, 3)])
def test_planar_gradmap_kernel_matches_plain(dev, loss, m, n, route):
    """K-B7 on each route, aligned and ragged: d, g within 1e-5 of the
    largest entry and f rel 1e-5 (float32 sums in another order), and the
    same result on every run."""
    assert planar_fused._plan(dev.index or 0, m, n)[0] == route
    Ar, Ai, x, bl, bh = _planar_data(dev, m, n)
    fused, ref, b = ((planar_fused.fused_planar_lstsq_gradmap,
                      planar_fused.planar_lstsq_gradmap_reference, bl)
                     if loss == "lstsq" else
                     (planar_fused.fused_planar_hinge_gradmap,
                      planar_fused.planar_hinge_gradmap_reference, bh))
    before = planar_fused.LAUNCHES
    d, f, g = fused(Ar, Ai, x, b)
    assert planar_fused.LAUNCHES == before + 1
    d0, f0, g0 = ref(Ar, Ai, x, b)
    torch.cuda.synchronize()
    assert (d - d0).abs().max() <= 1e-5 * max(1.0, float(d0.abs().max()))
    assert (g - g0).abs().max() <= 1e-5 * max(1.0, float(g0.abs().max()))
    assert abs(float(f) - float(f0)) <= 1e-5 * abs(float(f0))
    d2, f2, g2 = fused(Ar, Ai, x, b)
    assert torch.equal(d, d2) and torch.equal(g, g2) and torch.equal(f, f2)


@pytest.mark.parametrize("bf16", [False, True])
def test_planar_gradmap_card_plan_is_the_pure_plan(dev, bf16):
    """K-B7's plan on the card (csrc/planar_fused.cu: route, column slots,
    blocks, shared bytes, tile rows) is ``gradmap_plan`` at the card's
    cluster slots, on every route, aligned and ragged, small and past the
    card's slots."""
    for m, n in [(16384, 256), (1000, 37), (5, 3), (1000, 512),
                 (1000, 511), (1000, 1024), (300, 2046), (16384, 4096),
                 (1000, 8192), (40, 9000), (1024, 16384), (33, 3001),
                 (100000, 9000), (64, 8)]:
        card = planar_fused._card_plan(dev.index or 0, m, n, bf16)
        plan = planar_fused.gradmap_plan(m, n, bf16, card[-1])
        assert card[:-1] == (plan.route, plan.cpt, plan.blocks,
                             plan.smem_bytes, plan.tile_rows), (m, n)
        assert planar_fused._plan(dev.index or 0, m, n, bf16) == plan


def test_planar_kernels_reject_what_they_do_not_take(dev):
    Ar, Ai, x, bl, bh = _planar_data(dev, 8, 8)
    with pytest.raises(ValueError, match="float32"):
        planar_fused.fused_planar_hinge_gradmap(Ar.double(), Ai.double(),
                                                x.double(), bh.double())
    with pytest.raises(ValueError, match="contiguous"):
        planar_fused.fused_planar_lstsq_gradmap(Ar.t(), Ai, x, bl)
    with pytest.raises(ValueError, match="share a device"):
        planar_fused.fused_planar_hinge_gradmap(Ar, Ai, x, bh.cpu())
    with pytest.raises(ValueError, match="n must be"):
        planar_probe.planar_probe(Ar, Ai, x, 2)
    # a signal wider than 512 takes the wide route rather than raising
    g = torch.Generator(device=dev).manual_seed(600)
    wide = [torch.randn((8, 600), generator=g, device=dev) / 4.0
            for _ in range(2)]
    c, x0 = (torch.randn((600, 2), generator=g, device=dev) for _ in range(2))
    before = microsolver_planar.WIDE_LAUNCHES
    out = microsolver_planar.microsolve_planar_phasemax(*wide, bh, c, x0, 1.0,
                                                        max_iters=20)
    assert microsolver_planar.WIDE_LAUNCHES == before + 1
    ref = microsolver_planar.microsolve_planar_phasemax_reference(
        *wide, bh, c, x0, 1.0, max_iters=20)
    assert int(out.iteration_count) == int(ref.iteration_count)
    torch.testing.assert_close(out.taus[:10], ref.taus[:10], rtol=1e-3,
                               atol=0.0)


@pytest.mark.parametrize("variant", planar_probe.VARIANTS)
@pytest.mark.parametrize("m,n", [(1000, 256), (4099, 128), (517, 512)])
def test_planar_probe_kernel_matches_plain(dev, variant, m, n):
    """K-P5: the last of 3 chained pairs within 1e-5 of the largest
    entry of the plain PlanarDenseOp pairs, on every layout."""
    Ar, Ai, x, _, _ = _planar_data(dev, m, n)
    before = planar_probe.LAUNCHES
    out = planar_probe.planar_probe(Ar, Ai, x, 3, variant)
    assert planar_probe.LAUNCHES == before + 1
    ref = planar_probe.planar_probe_reference(Ar, Ai, x, 3)
    torch.cuda.synchronize()
    assert (out - ref).abs().max() <= 1e-5 * float(ref.abs().max())


def _phase(dev, m, n):
    p = problems.build("phase_retrieval", m=m, n=n, planar=True, device=dev)
    return p, (p.op.Ar, p.op.Ai, p.fterm.b, p.gterm.c, p.x0)


def _phase_objective(p, x):
    """f(x) − ⟨c, x⟩ in float64 on the card."""
    Ar, Ai = p.op.Ar.double(), p.op.Ai.double()
    x = x.double()
    d = ftt.PlanarDenseOp(Ar, Ai)(x)
    r = torch.clamp_min(torch.sqrt(torch.sum(d * d, -1)) - p.fterm.b.double(),
                        0.0)
    return float(0.5 * torch.sum(r * r) - torch.sum(p.gterm.c.double() * x))


@pytest.mark.parametrize("accelerate", [False, True])
@pytest.mark.parametrize("hp", [False, True])
@pytest.mark.parametrize("m,n", [(256, 32), (1000, 37), (4099, 256)])
def test_planar_microsolve_kernel_matches_plain(dev, accelerate, hp, m, n):
    """K-B8 against its plain version on the card over 40 iterations: the
    first 10 taus and residuals rtol 1e-3 and backtracks equal (the hinge
    amplifies the order of float32 sums), the float64 objective rel 1e-5,
    every record present; the last iterate is the returned x (adaptive)."""
    p, data = _phase(dev, m, n)
    kw = dict(max_iters=40, tol=0.0, stop_rule="iterations", hp=hp,
              accelerate=accelerate, restart_dd=hp, record_bts=True,
              record_fvals=True, record_objs=True, record_nres=True)
    before = microsolver_planar.LAUNCHES
    out = microsolver_planar.microsolve_planar_phasemax(*data, 1.0,
                                                        record_its=True, **kw)
    assert microsolver_planar.LAUNCHES == before + 1
    ref = microsolver_planar.microsolve_planar_phasemax_reference(
        *data, 1.0, record_its=True, **kw)
    torch.cuda.synchronize()
    assert int(out.iteration_count) == int(ref.iteration_count) == 40
    torch.testing.assert_close(out.taus[:10], ref.taus[:10], rtol=1e-3,
                               atol=0.0)
    torch.testing.assert_close(out.residuals[:10], ref.residuals[:10],
                               rtol=1e-3, atol=1e-6)
    assert torch.equal(out.backtracks[:10], ref.backtracks[:10])
    f1, f2 = _phase_objective(p, out.x), _phase_objective(p, ref.x)
    assert abs(f1 - f2) <= 1e-5 * abs(f2)
    assert out.iterates.shape == (40, n, 2)
    if not accelerate:
        assert torch.equal(out.iterates[-1], out.x)
    torch.testing.assert_close(out.objectives[:10], ref.objectives[:10],
                               rtol=1e-3, atol=0.0)
    again = microsolver_planar.microsolve_planar_phasemax(*data, 1.0, **kw)
    assert torch.equal(again.x, out.x) and torch.equal(again.taus, out.taus)


def test_planar_microsolve_kernel_converges_and_halts_nonfinite(dev):
    p, data = _phase(dev, 4099, 256)
    for accelerate in (False, True):
        kw = dict(max_iters=2000, tol=1e-5, hp=True, accelerate=accelerate,
                  restart_dd=True)
        out = microsolver_planar.microsolve_planar_phasemax(*data, 1.0, **kw)
        ref = microsolver_planar.microsolve_planar_phasemax_reference(
            *data, 1.0, **kw)
        assert out.status == ref.status == "converged"
        f1, f2 = _phase_objective(p, out.x), _phase_objective(p, ref.x)
        assert abs(f1 - f2) <= 1e-6 * abs(f2)
    bad = microsolver_planar.microsolve_planar_phasemax(*data, float("nan"),
                                                        max_iters=50)
    assert bad.status == "nonfinite" and int(bad.iteration_count) == 1


def test_phase_main_path_on_the_card(dev):
    """problems.build("phase_retrieval") → Problem.solve through K-B7 and
    Problem.microsolve through one K-B8 launch reach the CPU run's
    objective; the complex form solves through the loop."""
    pg = problems.build("phase_retrieval", m=2048, n=64, planar=True,
                        device=dev)
    pc = problems.build("phase_retrieval", m=2048, n=64, planar=True,
                        device="cpu")
    goal = _phase_objective(pc, torch.as_tensor(pc.solve(
        tau0=1.0, tol=1e-5, max_iters=2000).solution))
    before = planar_fused.LAUNCHES
    r = pg.solve(tau0=1.0, tol=1e-5, max_iters=2000)
    assert r.converged and planar_fused.LAUNCHES > before
    assert abs(_phase_objective(pc, torch.as_tensor(r.solution)) - goal) \
        <= 1e-5 * abs(goal)
    before = microsolver_planar.LAUNCHES
    m = pg.microsolve(tau0=1.0, tol=1e-5, max_iters=2000, hp=True)
    assert microsolver_planar.LAUNCHES == before + 1
    assert m.status == "converged" and m.solution.is_cuda
    assert abs(_phase_objective(pg, m.solution) - goal) <= 1e-5 * abs(goal)
    assert pg.recovery_error(m.solution) < 0.05
    cx = problems.build("phase_retrieval", m=2048, n=64, device=dev)
    rc = cx.solve(tau0=1.0, tol=1e-5, max_iters=2000)
    assert rc.converged and cx.recovery_error(rc.solution) < 0.05


# --------------------------------------------------------------------------
# K-B4 and the batched whole-solve kernels K-B1b, K-B6b, K-B8b
# --------------------------------------------------------------------------

@pytest.mark.parametrize("R,n", [(1, 2000), (1, 128), (1, 100), (1, 37),
                                 (32, 2000), (3, 37), (1, 1 << 22),
                                 (300, 5)])
def test_shrink_step_kernel_matches_plain(dev, R, n):
    """x₁ bit for bit (the _rn intrinsics round like PyTorch's separate
    operations), the float64 sums within rtol 1e-12 (their order), a τ
    and a μ per row, and the same sums on a second call (no atomics)."""
    g = torch.Generator(device=dev).manual_seed(R * 7 + n)
    x0 = torch.randn((R, n), generator=g, device=dev)
    gr = torch.randn((R, n), generator=g, device=dev)
    tau = torch.rand(R, generator=g, device=dev) + 0.05
    mu = torch.rand(R, generator=g, device=dev)
    before = prox_fused.LAUNCHES
    out = prox_fused.fused_shrink_step(x0, gr, tau, mu)
    assert prox_fused.LAUNCHES == before + 1
    ref = prox_fused.shrink_step_reference(x0, gr, tau, mu)
    torch.cuda.synchronize()
    assert torch.equal(out[0], ref[0])
    for a, b in zip(out[1:], ref[1:]):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    again = prox_fused.fused_shrink_step(x0, gr, tau, mu)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    one = prox_fused.fused_shrink_step(x0[0], gr[0], tau[0], mu[0])
    assert torch.equal(one[0], out[0][0])


@pytest.mark.parametrize("R,n,route", [
    (1, prox_fused.ROW_MAX_N, "row"), (1, prox_fused.ROW_MAX_N + 1, "stream"),
    (1, prox_fused.ROW_MAX_N + 3, "stream"), (3, prox_fused.ROW_MAX_N + 1,
                                              "stream"),
    (2, 1 << 20, "stream"), (4, 65535, "stream"), (600, 40000, "row"),
    (65535, 8, "row"), (1, 4096, "row"), (7, 8191, "row"),
    (300, 2000, "row"), (7, 30001, "stream")])
def test_shrink_step_routes_at_their_boundaries(dev, R, n, route):
    """Each route of K-B4 at its edges (the plan says which; n % 4 != 0
    with several rows takes masked scalars): x₁ bit for bit, the sums
    within rtol 1e-12, a second call equal (the ticket reset)."""
    assert prox_fused._plan(dev.index or 0, R, n).route == route
    g = torch.Generator(device=dev).manual_seed(R + n)
    x0 = torch.randn((R, n), generator=g, device=dev)
    gr = torch.randn((R, n), generator=g, device=dev)
    tau = torch.rand(R, generator=g, device=dev, dtype=torch.float64) + 0.05
    out = prox_fused.fused_shrink_step(x0, gr, tau, 0.4)
    ref = prox_fused.shrink_step_reference(x0, gr, tau, 0.4)
    torch.cuda.synchronize()
    assert torch.equal(out[0], ref[0])
    for a, b in zip(out[1:], ref[1:]):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    again = prox_fused.fused_shrink_step(x0, gr, tau, 0.4)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


def _ticket_inputs(dev):
    g = torch.Generator(device=dev).manual_seed(77)
    big = [torch.randn((1, 1 << 22), generator=g, device=dev)
           for _ in range(2)]
    rows = [torch.randn((32, 2000), generator=g, device=dev)
            for _ in range(2)]
    tau = torch.rand(32, generator=g, device=dev) + 0.05
    p = torch.randn((2, 512, 512), generator=g, device=dev)
    b = torch.randn((512, 512), generator=g, device=dev)
    planar = _planar_data(dev, 4099, 256)
    wide = _planar_data(dev, 40, 9000)
    probe = _probe_data(dev, 1000, 2048, 1 / 40)
    gradmaps = [_gradmap_data(dev, m, n, "lstsq") for m, n in
                ((1000, 2000), (300, 20000))]
    assert [lstsq_fused._plan(dev.index or 0, m, n).route
            for m, n in ((1000, 2000), (300, 20000))] == [2, 3]
    return big, rows, tau, p, b, planar, wide, probe, gradmaps


def _ticket_calls(big, rows, tau, p, b, planar, wide, probe, gradmaps):
    """K-B4 on its stream route and its row route, K-B5 with its ticket,
    K-B7 on routes 1 and 3 with its last-cluster ticket, K-P2, K-P1's
    gradmap kernel and K-B3 on routes 2 and 3 with their barrier's counter
    and exit ticket: every one keeps them in the stream's scratch."""
    Ar, Ai, x, bl, bh = planar
    Wr, Wi, wx, _, wb = wide
    xg, (fg, gg) = matvec_probe.run_variant(*probe, "gradmap_fused", 3)
    b3 = tuple(t for A3, x3, y3 in gradmaps
               for t in lstsq_fused.fused_lstsq_gradmap(A3, x3, y3))
    return (xg, fg, gg) + b3 + (
            prox_fused.fused_shrink_step(big[0], big[1], 0.3, 0.5)
            + prox_fused.fused_shrink_step(rows[0], rows[1], tau, 0.2)
            + tv_fused.fused_tv_gradmap(p, b, 0.1)
            + planar_fused.fused_planar_hinge_gradmap(Ar, Ai, x, bh)
            + planar_fused.fused_planar_lstsq_gradmap(Ar, Ai, x, bl)
            + planar_fused.fused_planar_hinge_gradmap(Wr, Wi, wx, wb)
            + matvec_probe.gradmap_fused(*probe))


def test_ticket_kernels_on_two_streams_match_one_after_another(dev):
    """C-2: calls on two streams at once (each stream its own ticket)
    give what the same calls give one after the other."""
    data = _ticket_inputs(dev)
    want = _ticket_calls(*data)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in range(2)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(4):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(_ticket_calls(*data))
    torch.cuda.synchronize()
    for outs in got:
        for out in outs:
            assert all(torch.equal(a, b) for a, b in zip(out, want))


def test_ticket_kernels_replay_in_a_cuda_graph(dev):
    """Two calls of each kernel captured in one CUDA graph and replayed
    twice equal eager calls: every launch leaves its ticket at zero.  The
    graph is captured on the side stream its warm-up ran on, whose
    scratch was zeroed before the capture, so it holds no memset."""
    data = _ticket_inputs(dev)
    want = _ticket_calls(*data)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _ticket_calls(*data)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        first = _ticket_calls(*data)
        second = _ticket_calls(*data)
    for _ in range(2):
        for t in first + second:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for out in (first, second):
            assert all(torch.equal(a, b) for a, b in zip(out, want))
    again = _ticket_calls(*data)
    assert all(torch.equal(a, b) for a, b in zip(again, want))


@pytest.mark.parametrize("what", ["b4 1x2000", "b4 32x2000", "b4 1x2^22",
                                  "b4 scalars", "b5 512x512", "b5 1x7",
                                  "b1 1000x2000", "b1 fista 3000x1000",
                                  "b1 columns 100x9000", "b1b 300x600x4",
                                  "b7 16384x256", "b7 bf16 16384x4096",
                                  "b7 wide 64x9000", "p2 1000x2048",
                                  "p1 gradmap 1000x2048",
                                  "p3 1000x2000", "p3 x1 200x300",
                                  "p4 1000x2000", "p4 bf16 37x1003",
                                  "b3 256x1024", "b3 1000x2000",
                                  "b3p 800x100", "b3 bf16 300x20000",
                                  "b3 wide 24x140000"])
def test_one_device_operation_per_call(dev, what, tmp_path):
    """A call of K-B4, K-B5, K-B1 (one solve or a batch), K-B7 (routes 1,
    2 and 3), K-B3 / K-B3p (routes 1 to 4, either end), K-P2, K-P1's
    gradmap form (K = 3), K-P3 (L6 and X1) or K-P4 (float32, bfloat16) is
    one
    kernel on the card: no memset, no copy (τ and μ by value or read where
    they lie; K-B1 and K-P3 make no copy of A and write their own records;
    K-B7, K-P1, K-P2, K-P3 and K-P4 keep their tickets and partials in the
    stream's scratch), in a profiling.trace of 10 calls."""
    from fasta_tpu_torch import profiling
    g = torch.Generator(device=dev).manual_seed(5)
    if what.startswith("b3"):
        m, n = (int(v) for v in what.split()[-1].split("x"))
        loss = "squared_hinge" if what.startswith("b3p") else "lstsq"
        A, x, y = _gradmap_data(dev, m, n, loss, "bf16" in what)

        def fn():
            return _gradmap_call(A, x, y, loss)
    elif what.startswith("p3"):
        m, n = (200, 300) if "x1" in what else (1000, 2000)
        A, x0, b = _probe_data(dev, m, n, 1.0)
        run = tail_probe.make(6, col="x1" in what)

        def fn():
            return run(A, b, x0, 3)
    elif what.startswith("p4"):
        m, n = (37, 1003) if "bf16" in what else (1000, 2000)
        A, x0, _ = _probe_data(dev, m, n, 1 / m ** 0.5)
        if "bf16" in what:
            A = A.to(torch.bfloat16)

        def fn():
            return bf16_probe.bf16_probe(A, x0, 3)
    elif what.startswith("b7"):
        m, n = {"b7 16384x256": (16384, 256), "b7 bf16 16384x4096":
                (16384, 4096), "b7 wide 64x9000": (64, 9000)}[what]
        Ar, Ai, x, bl, bh = _planar_data(dev, m, n)
        if "bf16" in what:
            Ar, Ai = Ar.to(torch.bfloat16), Ai.to(torch.bfloat16)
        assert planar_fused._plan(dev.index or 0, m, n, "bf16" in what
                                  ).route == {16384: 1 + (n > 512)}.get(m, 3)

        def fn():
            return planar_fused.fused_planar_hinge_gradmap(Ar, Ai, x, bh)
    elif what.startswith("p2"):
        A, x, b = _probe_data(dev, 1000, 2048, 1 / 40)

        def fn():
            return matvec_probe.gradmap_fused(A, x, b)
    elif what.startswith("p1"):
        A, x, b = _probe_data(dev, 1000, 2048, 1 / 40)

        def fn():
            return matvec_probe.run_variant(A, x, b, "gradmap_fused", 3)
    elif what.startswith("b1"):
        m, n = {"b1 1000x2000": (1000, 2000), "b1 fista 3000x1000":
                (3000, 1000), "b1 columns 100x9000": (100, 9000),
                "b1b 300x600x4": (300, 600)}[what]
        p = problems.build("lasso", m=m, n=n, k=max(1, m // 10), device=dev)
        A, b, x0 = p.op.A, p.fterm.b, p.x0
        kw = dict(max_iters=50, tol=1e-6, record_bts=True, record_fvals=True,
                  accelerate="fista" in what)
        if what.startswith("b1b"):
            bs = _stack(b, 4)
            t0s = torch.tensor([0.02, 0.05, 0.09, 0.05], device=dev)

            def fn():
                return microsolver.microsolve_lasso_batch(A, bs, x0, t0s, 0.1,
                                                          **kw)
        else:
            def fn():
                return microsolver.microsolve_lasso(A, b, x0, 0.05, 0.1, **kw)
    elif what.startswith("b4"):
        R, n = {"b4 1x2000": (1, 2000), "b4 32x2000": (32, 2000),
                "b4 1x2^22": (1, 1 << 22), "b4 scalars": (1, 2000)}[what]
        x0 = torch.randn((R, n), generator=g, device=dev)
        gr = torch.randn((R, n), generator=g, device=dev)
        tau = (0.3 if what == "b4 scalars" else
               torch.rand(R, generator=g, device=dev) + 0.05)
        mu = (0.5 if what == "b4 scalars" else
              torch.rand(R, generator=g, device=dev))

        def fn():
            return prox_fused.fused_shrink_step(x0, gr, tau, mu)
    else:
        h, w = {"b5 512x512": (512, 512), "b5 1x7": (1, 7)}[what]
        p = torch.randn((2, h, w), generator=g, device=dev)
        b = torch.randn((h, w), generator=g, device=dev)

        def fn():
            return tv_fused.fused_tv_gradmap(p, b, 0.1)
    ops = profiling.device_ops(fn, 10, str(tmp_path / "trace"))
    # the profiler may drop an event, never add one
    assert 8 <= ops["events"]["kernel"] <= 10, ops
    assert ops["events"]["gpu_memset"] == 0, ops
    assert ops["events"]["gpu_memcpy"] == 0, ops


def test_shrink_step_kernel_propagates_nan_and_rejects(dev):
    x0 = torch.randn(2000, device=dev)
    x0[700] = float("nan")
    g = torch.randn(2000, device=dev)
    out = prox_fused.fused_shrink_step(x0, g, 0.3, 0.5)
    ref = prox_fused.shrink_step_reference(x0, g, 0.3, 0.5)
    assert torch.isnan(out[0][700]) and torch.equal(
        torch.isnan(out[0]), torch.isnan(ref[0]))
    assert all(torch.isnan(s) for s in out[1:])
    with pytest.raises(ValueError, match="contiguous"):
        prox_fused.fused_shrink_step(torch.zeros(4, 8, device=dev).t(),
                                     torch.zeros(8, 4, device=dev), 0.1, 0.1)


def _stack(b, B):
    return torch.stack([b * (1.0 + 0.02 * i) for i in range(B)])


def _same(batch, singles):
    """Each instance of a batched output equal, field by field, to its
    separate launch."""
    for i, one in enumerate(singles):
        for name, a, b in zip(one._fields, batch, one):
            if b is not None:
                assert torch.equal(a[i], b), (i, name)


@pytest.mark.parametrize("mode", [dict(), dict(hp=True),
                                  dict(accelerate=True, hp=True,
                                       restart_dd=True)])
def test_batch_kernel_dense_is_separate_launches(dev, mode):
    p = problems.build("lasso", m=300, n=600, k=20, device=dev)
    A, x0 = p.op.A, p.x0
    bs = _stack(p.fterm.b, 4)
    t0s = torch.tensor([0.02, 0.05, 0.09, 0.05], device=dev)
    kw = dict(max_iters=400, tol=1e-6, record_bts=True, record_fvals=True,
              record_objs=True, record_nres=True, **mode)
    before = microsolver.BATCH_LAUNCHES
    out = microsolver.microsolve_lasso_batch(A, bs, x0, t0s, 0.1, **kw)
    assert microsolver.BATCH_LAUNCHES == before + 1
    _same(out, [microsolver.microsolve_lasso(A, bs[i], x0, float(t0s[i]), 0.1,
                                             **kw) for i in range(4)])
    # stacked starts and the logistic loss
    q = problems.build("logistic", m=400, n=200, k=10, device=dev)
    x0s = torch.stack([q.x0 + 0.1 * i for i in range(3)])
    bs = torch.stack([q.fterm.b] * 3)
    out = microsolver.microsolve_lasso_batch(q.op.A, bs, x0s, 0.5, 0.02,
                                             loss="logistic", **kw)
    _same(out, [microsolver.microsolve_lasso(q.op.A, bs[i], x0s[i], 0.5, 0.02,
                                             loss="logistic", **kw)
                for i in range(3)])


@pytest.mark.parametrize("accelerate", [False, True])
@pytest.mark.parametrize("h,w,resident", [(64, 48, True), (512, 512, True),
                                          (1024, 1024, False)])
def test_batch_kernel_tv_is_separate_launches(dev, accelerate, h, w,
                                              resident):
    """K-B6b: each image bit-identical to its own K-B6 launch, on either
    route (the route counter shows which ran)."""
    b, p0, mu = _tv(dev, h, w)
    bs = _stack(b, 3)
    kw = dict(max_iters=600 if h < 512 else 150, tol=1e-4,
              accelerate=accelerate, record_bts=True, record_fvals=True)
    assert _resident(dev, h, w) == resident
    before = (microsolver_tv.BATCH_LAUNCHES,
              microsolver_tv.BATCH_LAUNCHES_RESIDENT)
    out = microsolver_tv.microsolve_tv_batch(bs, p0, 2.0, mu, **kw)
    assert (microsolver_tv.BATCH_LAUNCHES,
            microsolver_tv.BATCH_LAUNCHES_RESIDENT) == \
        (before[0] + 1, before[1] + resident)
    _same(out, [microsolver_tv.microsolve_tv(bs[i], p0, 2.0, mu, **kw)
                for i in range(3)])


@pytest.mark.parametrize("m,n", [(2048, 64), (1000, 37)])
def test_batch_kernel_planar_is_separate_launches(dev, m, n):
    p, (Ar, Ai, b, c, x0) = _phase(dev, m, n)
    bs = _stack(b, 3)
    t0s = torch.tensor([1.0, 0.3, 2.0], device=dev)
    for mode in (dict(), dict(hp=True, accelerate=True, restart_dd=True)):
        kw = dict(max_iters=300, tol=1e-5, record_bts=True, **mode)
        before = microsolver_planar.BATCH_LAUNCHES
        out = microsolver_planar.microsolve_planar_phasemax_batch(
            Ar, Ai, bs, c, x0, t0s, **kw)
        assert microsolver_planar.BATCH_LAUNCHES == before + 1
        _same(out, [microsolver_planar.microsolve_planar_phasemax(
            Ar, Ai, bs[i], c, x0, float(t0s[i]), **kw) for i in range(3)])


def test_batch_kernel_nonfinite_instance_ends_alone(dev):
    """A NaN τ₀ aborts its own instance; the next starts clean."""
    p = problems.build("lasso", m=300, n=600, k=20, device=dev)
    bs = _stack(p.fterm.b, 3)
    t0s = torch.tensor([0.05, float("nan"), 0.05], device=dev)
    out = microsolver.microsolve_lasso_batch(p.op.A, bs, p.x0, t0s, 0.1,
                                             max_iters=300, tol=1e-6)
    assert out.halt.tolist() == [1, 2, 1]
    one = microsolver.microsolve_lasso(p.op.A, bs[2], p.x0, 0.05, 0.1,
                                       max_iters=300, tol=1e-6)
    assert torch.equal(out.x[2], one.x)


def test_serving_routes_on_the_card(dev):
    """The batch loop's L1 trials launch K-B4 and agree with separate
    solves; the kernel batch equals separate microsolves."""
    p = problems.build("lasso", m=300, n=600, k=20, device=dev)
    p.tau0 = 0.05
    bs = _stack(p.fterm.b, 4)
    opts = ftt.FastaOptions(tol=1e-6, max_iters=500)
    before = prox_fused.LAUNCHES
    out = ftt.recommend_path(p, 4).run(bs, options=opts)
    assert prox_fused.LAUNCHES > before
    for i in range(4):
        one = p.with_parts(fterm=ftt.LeastSquares(bs[i])).solve_device(opts)
        assert out.converged[i] and one.converged
        f = [float(0.5 * ((p.op.A.double() @ x.double() - bs[i].double())
                          ** 2).sum() + 0.1 * x.double().abs().sum())
             for x in (out.solution[i], one.solution)]
        assert abs(f[0] - f[1]) <= 1e-6 * abs(f[1])
    mb = p.microsolve_batch(bs, max_iters=500, tol=1e-6)
    for i in range(4):
        one = p.with_parts(fterm=ftt.LeastSquares(bs[i])).microsolve(
            max_iters=500, tol=1e-6)
        assert torch.equal(mb.solutions[i], one.solution)



# --------------------------------------------------------------------------
# Slice 6: the bfloat16 forms of K-B3, K-B3p and K-B7, K-P4, K-B8 past
# n = 512
# --------------------------------------------------------------------------

def _bf16_data(dev, m, n):
    g = torch.Generator(device=dev).manual_seed(m * 3 + n)
    A = (torch.randn((m, n), generator=g, device=dev) / m ** 0.5).to(
        torch.bfloat16)
    x = torch.randn(n, generator=g, device=dev)
    b = torch.randn(m, generator=g, device=dev)
    return A, x, b


@pytest.mark.parametrize("loss", ["lstsq", "logistic", "squared_hinge"])
@pytest.mark.parametrize("m,n,route,cluster", [
    (1000, 2000, 2, 1), (1000, 1003, 2, 1), (3, 5, 1, 1), (4096, 8192, 2, 1),
    (37, 16385, 3, 2), (300, 100000, 3, 7), (64, 131072, 3, 8),
    (40, 200000, 4, 1), (7, 150001, 4, 1)])
def test_bf16_gradmap_kernel_matches_plain(dev, loss, m, n, route, cluster):
    """K-B3 and K-B3p over a bfloat16 A against the plain version (A
    upcast to float32, x float32) on every route, aligned (n % 8 == 0:
    16-byte groups) and ragged: 1e-5 of the largest entry, float32 sums
    in another order; deterministic; counted as bfloat16 launches."""
    plan = lstsq_fused._plan(dev.index or 0, m, n, True)
    assert (plan.route, plan.cluster) == (route, cluster)
    A, x, b = _bf16_data(dev, m, n)
    if loss == "lstsq":
        fused = lambda: lstsq_fused.fused_lstsq_gradmap(A, x, b)  # noqa: E731
        ref = lstsq_fused.lstsq_gradmap_reference(A, x, b)
        counter = "BF16_LAUNCHES"
    else:
        y = (b > 0).float() if loss == "logistic" else torch.sign(b)
        fused = lambda: lstsq_fused.fused_pointwise_gradmap(  # noqa: E731
            A, x, y, loss)
        ref = lstsq_fused.pointwise_gradmap_reference(A, x, y, loss)
        counter = "POINTWISE_BF16_LAUNCHES"
    before = getattr(lstsq_fused, counter), lstsq_fused.LAUNCHES
    d, f, g = fused()
    assert (getattr(lstsq_fused, counter), lstsq_fused.LAUNCHES) == \
        (before[0] + 1, before[1])
    d0, f0, g0 = ref
    torch.cuda.synchronize()
    assert (d - d0).abs().max() <= 1e-5 * max(1.0, float(d0.abs().max()))
    assert (g - g0).abs().max() <= 1e-5 * max(1.0, float(g0.abs().max()))
    assert abs(float(f) - float(f0)) <= 1e-5 * abs(float(f0))
    d2, f2, g2 = fused()
    assert torch.equal(d, d2) and torch.equal(g, g2) and torch.equal(f, f2)


def test_lowprec_operator_routes_to_the_bf16_kernel(dev):
    """A bfloat16 LowPrecDenseOp past the 64 MB gate takes K-B3 bf16 in
    LeastSquares.fused_gradmap (and K-B3p in Logistic); at or below it,
    the two-call path, which rounds x to bfloat16."""
    A, x, b = _bf16_data(dev, 4096, 8200)           # 67.2 MB
    op = ftt.LowPrecDenseOp(A)
    before = lstsq_fused.BF16_LAUNCHES
    d, f, g = ftt.LeastSquares(b).fused_gradmap(op)(x)
    assert lstsq_fused.BF16_LAUNCHES == before + 1
    d0, _, g0 = lstsq_fused.lstsq_gradmap_reference(A, x, b)
    assert (g - g0).abs().max() <= 1e-5 * float(g0.abs().max())
    assert ftt.Logistic((b > 0).float()).fused_gradmap(op) is not None
    small = ftt.LowPrecDenseOp(A[:1024])                # 16.8 MB
    assert ftt.LeastSquares(b[:1024]).fused_gradmap(small) is None
    xr = x.to(torch.bfloat16).float()
    torch.testing.assert_close(small(x), A[:1024].float() @ xr, rtol=1e-6,
                               atol=1e-5)


def test_bf16_kernels_reject_what_they_do_not_take(dev):
    A, x, b = _bf16_data(dev, 8, 8)
    with pytest.raises(ValueError, match="float32"):
        lstsq_fused.fused_lstsq_gradmap(A, x.to(torch.bfloat16), b)
    with pytest.raises(ValueError, match="bfloat16"):
        lstsq_fused.fused_lstsq_gradmap(A.half(), x, b)
    with pytest.raises(ValueError, match="bfloat16"):
        planar_fused.fused_planar_hinge_gradmap(A, A.float(),
                                                torch.zeros((8, 2), device=dev),
                                                b.abs())
    with pytest.raises(ValueError, match="bfloat16"):
        bf16_probe.bf16_probe(A.half(), x, 2)


@pytest.mark.parametrize("loss", ["lstsq", "hinge"])
@pytest.mark.parametrize("m,n,route", [
    (1000, 256, 1), (517, 37, 1), (300, 4096, 2), (100, 2046, 2),
    (40, 16384, 3), (33, 9001, 3)])
def test_bf16_planar_gradmap_kernel_matches_plain(dev, loss, m, n, route):
    """K-B7 over bfloat16 channels against the plain version (channels
    upcast, x float32) on every route, aligned and ragged: 1e-5 of the
    largest entry; deterministic; counted as bfloat16 launches."""
    assert planar_fused._plan(dev.index or 0, m, n, True)[0] == route
    Ar, Ai, x, bl, bh = _planar_data(dev, m, n)
    Ar, Ai = Ar.to(torch.bfloat16), Ai.to(torch.bfloat16)
    fused, ref, b = ((planar_fused.fused_planar_lstsq_gradmap,
                      planar_fused.planar_lstsq_gradmap_reference, bl)
                     if loss == "lstsq" else
                     (planar_fused.fused_planar_hinge_gradmap,
                      planar_fused.planar_hinge_gradmap_reference, bh))
    before = planar_fused.BF16_LAUNCHES, planar_fused.LAUNCHES
    d, f, g = fused(Ar, Ai, x, b)
    assert (planar_fused.BF16_LAUNCHES, planar_fused.LAUNCHES) == \
        (before[0] + 1, before[1])
    d0, f0, g0 = ref(Ar, Ai, x, b)
    torch.cuda.synchronize()
    assert (d - d0).abs().max() <= 1e-5 * max(1.0, float(d0.abs().max()))
    assert (g - g0).abs().max() <= 1e-5 * max(1.0, float(g0.abs().max()))
    assert abs(float(f) - float(f0)) <= 1e-5 * abs(float(f0))
    d2, f2, g2 = fused(Ar, Ai, x, b)
    assert torch.equal(d, d2) and torch.equal(g, g2) and torch.equal(f, f2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n", [(1000, 2000), (37, 1003), (64, 8),
                                 (500, 1500), (300, 2052)])
def test_bf16_probe_kernel_matches_plain(dev, dtype, m, n):
    """K-P4: the last of 3 chained pairs' g within 1e-5 of its largest
    entry of the plain loop's, and x equal to x₀."""
    g = torch.Generator(device=dev).manual_seed(m + n)
    A = (torch.randn((m, n), generator=g, device=dev) / m ** 0.5).to(dtype)
    x0 = torch.randn(n, generator=g, device=dev)
    before = bf16_probe.LAUNCHES
    x, gk = bf16_probe.bf16_probe(A, x0, 3)
    assert bf16_probe.LAUNCHES == before + 1
    x_ref, g_ref = bf16_probe.bf16_probe_reference(A, x0, 3)
    torch.cuda.synchronize()
    assert torch.equal(x, x0) and torch.equal(x_ref, x0)
    assert (gk - g_ref).abs().max() <= 1e-5 * float(g_ref.abs().max())


# PhaseMax needs m ≳ 4n measurements for a bounded solution: at 2048x1024
# and 256x8192 (inside the reference's gate, so a route must serve them)
# the iterates run off along the anchor c with τ growing 1.5x an
# iteration, so past a prefix only the counts compare; 8192x640 and
# 4099x601 are well posed.
WELL_POSED = {(8192, 640), (4099, 601)}


def _reordered(data, perm):
    """The same planar problem with its columns in the order ``perm``: the
    plain version's products summed in another order."""
    Ar, Ai, b, c, x0 = data
    return (Ar[:, perm].contiguous(), Ai[:, perm].contiguous(), b,
            c[perm].contiguous(), x0[perm].contiguous())


def _spread(a, b):
    """The largest relative difference of two positive series."""
    return float(((a - b).abs() / b.abs()).max())


@pytest.mark.parametrize("accelerate", [False, True])
@pytest.mark.parametrize("hp", [False, True])
@pytest.mark.parametrize("m,n", [(8192, 640), (4099, 601), (2048, 1024),
                                 (256, 8192)])
def test_planar_wide_microsolve_kernel_matches_plain(dev, accelerate, hp, m,
                                                     n):
    """K-B8's wide route (n > 512) against its plain version over 40
    iterations: backtracks equal and the first 10 taus and residuals
    within rtol max(1e-3, twice the plain version's own spread when its
    columns are reversed or rolled), every record; where the problem is
    well posed the float64 objective within max(1e-5, twice that spread);
    deterministic.  The spread is the hinge's: the plain version against
    itself with another order of float32 sums differs by 2e-3 to 4e-3 in
    the tenth τ at 8192x640, 4099x601 and 16384x256 (PERF.md)."""
    p, data = _phase(dev, m, n)
    kw = dict(max_iters=40, tol=0.0, stop_rule="iterations", hp=hp,
              accelerate=accelerate, restart_dd=hp, record_bts=True,
              record_fvals=True, record_objs=True, record_nres=True)
    before = microsolver_planar.WIDE_LAUNCHES, microsolver_planar.LAUNCHES
    out = microsolver_planar.microsolve_planar_phasemax(*data, 1.0,
                                                        record_its=True, **kw)
    assert (microsolver_planar.WIDE_LAUNCHES, microsolver_planar.LAUNCHES) \
        == (before[0] + 1, before[1])
    ref = microsolver_planar.microsolve_planar_phasemax_reference(
        *data, 1.0, record_its=True, **kw)
    # the plain version with its columns reversed and rolled by half
    perms = [torch.arange(n - 1, -1, -1, device=dev),
             torch.arange(n, device=dev).roll(n // 2)]
    others = [(perm, microsolver_planar.microsolve_planar_phasemax_reference(
        *_reordered(data, perm), 1.0, **kw)) for perm in perms]
    torch.cuda.synchronize()
    assert int(out.iteration_count) == int(ref.iteration_count) == 40
    tol = max([1e-3] + [2.0 * _spread(o.taus[:10], ref.taus[:10])
                        for _, o in others]
              + [2.0 * _spread(o.residuals[:10], ref.residuals[:10])
                 for _, o in others])
    torch.testing.assert_close(out.taus[:10], ref.taus[:10], rtol=tol,
                               atol=0.0)
    torch.testing.assert_close(out.residuals[:10], ref.residuals[:10],
                               rtol=tol, atol=1e-6)
    assert torch.equal(out.backtracks[:10], ref.backtracks[:10])
    if (m, n) in WELL_POSED:
        f1, f2 = _phase_objective(p, out.x), _phase_objective(p, ref.x)
        fo = [_phase_objective(p, o.x[perm.argsort()]) for perm, o in others]
        assert abs(f1 - f2) <= max([1e-5 * abs(f2)]
                                   + [2.0 * abs(f - f2) for f in fo])
    assert out.iterates.shape == (40, n, 2)
    if not accelerate:
        assert torch.equal(out.iterates[-1], out.x)
    torch.testing.assert_close(out.objectives[:10], ref.objectives[:10],
                               rtol=tol, atol=0.0)
    again = microsolver_planar.microsolve_planar_phasemax(*data, 1.0, **kw)
    assert torch.equal(again.x, out.x) and torch.equal(again.taus, out.taus)


def test_planar_wide_converges_and_serves(dev):
    """At 8192x640, inside the reference's gate and well posed: the wide
    route to tolerance within 1e-6 of the plain version's float64
    objective; recommend_path(p, 1).run() on it; a NaN τ₀ halts as
    nonfinite."""
    p, (Ar, Ai, b, c, x0) = _phase(dev, 8192, 640)
    # adaptive; FISTA's hinge solve here takes more than 6000 iterations in
    # the plain version (the 40-iteration test holds FISTA)
    kw = dict(max_iters=2000, tol=1e-5, hp=True)
    out = microsolver_planar.microsolve_planar_phasemax(Ar, Ai, b, c, x0, 1.0,
                                                        **kw)
    ref = microsolver_planar.microsolve_planar_phasemax_reference(
        Ar, Ai, b, c, x0, 1.0, **kw)
    assert out.status == ref.status == "converged"
    f1, f2 = _phase_objective(p, out.x), _phase_objective(p, ref.x)
    assert abs(f1 - f2) <= 1e-6 * abs(f2)
    p.tau0 = 1.0
    assert ftt.microsolve_supported(p) == (True, "planar")
    plan = ftt.recommend_path(p, 1)
    assert plan.path == "microsolve"
    before = microsolver_planar.WIDE_LAUNCHES
    r = plan.run(max_iters=2000, tol=1e-5, hp=True)
    assert microsolver_planar.WIDE_LAUNCHES == before + 1
    assert r.status == "converged" and p.recovery_error(r.solution) < 0.05
    bad = microsolver_planar.microsolve_planar_phasemax(Ar, Ai, b, c, x0,
                                                        float("nan"),
                                                        max_iters=50)
    assert bad.status == "nonfinite" and int(bad.iteration_count) == 1


@pytest.mark.parametrize("m,n", [(8192, 640), (2048, 1024), (256, 8192)])
def test_planar_wide_batch_and_routes(dev, m, n):
    """K-B8b on the wide route, adaptive and FISTA: each instance
    bit-identical to its own K-B8 launch; recommend_path(p, 1).run() is
    that launch, and Problem.microsolve_batch the batched one; a batch of
    4 takes the reference's route (the batch loop below 32768 unknowns)."""
    p, (Ar, Ai, b, c, x0) = _phase(dev, m, n)
    bs = _stack(b, 3)
    t0s = torch.tensor([1.0, 0.3, 2.0], device=dev)
    for mode in (dict(), dict(hp=True, accelerate=True, restart_dd=True)):
        kw = dict(max_iters=300, tol=1e-5, record_bts=True, **mode)
        before = microsolver_planar.WIDE_BATCH_LAUNCHES
        out = microsolver_planar.microsolve_planar_phasemax_batch(
            Ar, Ai, bs, c, x0, t0s, **kw)
        assert microsolver_planar.WIDE_BATCH_LAUNCHES == before + 1
        _same(out, [microsolver_planar.microsolve_planar_phasemax(
            Ar, Ai, bs[i], c, x0, float(t0s[i]), **kw) for i in range(3)])
    p.tau0 = 1.0
    kw = dict(max_iters=300, tol=1e-5, hp=True)
    one = ftt.recommend_path(p, 1).run(**kw)
    direct = microsolver_planar.microsolve_planar_phasemax(Ar, Ai, b, c, x0,
                                                           1.0, **kw)
    assert torch.equal(one.solution, direct.x)
    mb = p.microsolve_batch(bs, **kw)
    assert torch.equal(mb.solutions[0], direct.x)
    plan = ftt.recommend_path(p, 4)
    assert plan.path == "batch_solver"
    res = plan.run(_stack(b, 4), options=ftt.FastaOptions(max_iters=20))
    assert res.solution.shape == (4, n, 2)


# --------------------------------------------------------------------------
# Slice 7: the probes K-P1, K-P2 and K-P3
# --------------------------------------------------------------------------

def _rel(got, ref):
    got, ref = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _probe_data(dev, m, n, scale):
    g = torch.Generator(device=dev).manual_seed(m + n)
    return (torch.randn((m, n), generator=g, device=dev) * scale,
            torch.randn(n, generator=g, device=dev),
            torch.randn(m, generator=g, device=dev))


@pytest.mark.parametrize("variant", matvec_probe.VARIANTS)
@pytest.mark.parametrize("m,n", [(1000, 2048), (37, 100), (300, 516)])
def test_matvec_probe_kernel_matches_plain(dev, variant, m, n):
    """K-P1: the last of 3 chained operations within 1e-5 of its largest
    entry of the plain version's (float32 sums in another order; the
    tensor-core forms at 3xTF32), x within 1e-6; two runs equal."""
    A, x0, b = _probe_data(dev, m, n, 1 / 40)
    before = matvec_probe.LAUNCHES
    x, res = matvec_probe.run_variant(A, x0, b, variant, 3)
    assert matvec_probe.LAUNCHES == before + 1
    xr, rr = matvec_probe.run_variant_reference(A, x0, b, variant, 3)
    torch.cuda.synchronize()
    if variant == "gradmap_fused":
        assert _rel(res[0], rr[0]) <= 1e-5 and _rel(res[1], rr[1]) <= 1e-5
    else:
        assert _rel(res, rr) <= 1e-5
    assert _rel(x, xr) <= 1e-6
    x2, res2 = matvec_probe.run_variant(A, x0, b, variant, 3)
    assert torch.equal(x, x2)
    assert all(torch.equal(u, v) for u, v in zip(
        res if variant == "gradmap_fused" else [res],
        res2 if variant == "gradmap_fused" else [res2]))


@pytest.mark.parametrize("barrier", matvec_probe.BARRIERS)
def test_matvec_probe_barriers(dev, barrier):
    """K-P1's barrier alone, of each kind, launches and returns; an
    unknown kind raises."""
    before = matvec_probe.LAUNCHES
    matvec_probe.run_barriers(50, dev, barrier)
    torch.cuda.synchronize()
    assert matvec_probe.LAUNCHES == before + 1
    with pytest.raises(ValueError, match="unknown barrier"):
        matvec_probe.run_barriers(2, dev, "spin")


@pytest.mark.parametrize("m,n", [(1000, 2048), (37, 100)])
def test_gradmap_check_kernel_matches_plain_and_float64(dev, m, n):
    """K-P2: f and g within rel 1e-5 of float64 and of the plain version."""
    A, x, b = _probe_data(dev, m, n, 1 / 40)
    before = matvec_probe.CHECK_LAUNCHES
    f, g, ferr, gerr = matvec_probe.check_gradmap_correct(A, x, b)
    assert matvec_probe.CHECK_LAUNCHES == before + 1
    f0, g0 = matvec_probe.gradmap_reference(A, x, b)
    assert max(ferr, gerr) <= 1e-5
    assert _rel(f, f0) <= 1e-5 and _rel(g, g0) <= 1e-5


def _gradmap_streamed_m(dev, n=2048):
    """The smallest m at which the card's gradmap plan streams rows at
    n ≤ 2048 columns: every block full, 8 rows in registers and its
    budget's in shared memory."""
    nb, budget = matvec_probe._gradmap_grid(dev.index, n)[:2]
    m = (8 + budget // (4 * n)) * nb + 1
    plan = matvec_probe.gradmap_probe_plan
    assert plan(m - 1, n, nb, budget).route == "resident"
    assert plan(m, n, nb, budget).route == "streamed"
    return m


@pytest.mark.parametrize("m,n", [(2000, 1500), (500, 4096), (300, 8192),
                                 (16, 16), (None, 2048)])
def test_gradmap_probe_kernel_matches_plain(dev, m, n):
    """K-P1's gradmap kernel (csrc/gradmap_probe.cu) where
    test_matvec_probe_kernel_matches_plain does not take it: a short row
    lane (1500), two and four slots a thread (4096, 8192, which the former
    form refused), 16×16 and the first shape whose plan streams rows at
    n = 2048 (None).  At K = 3 the result within 1e-5 of its largest entry
    of the plain version's, x within 1e-6 and equal to the plain version's
    (each update rounds as the plain version's does, and sits far below
    x's spacing), one launch, two runs equal."""
    m = _gradmap_streamed_m(dev, n) if m is None else m
    A, x0, b = _probe_data(dev, m, n, 1 / 40)
    before = matvec_probe.LAUNCHES
    x, (f, g) = matvec_probe.run_variant(A, x0, b, "gradmap_fused", 3)
    assert matvec_probe.LAUNCHES == before + 1
    xr, (fr, gr) = matvec_probe.run_variant_reference(A, x0, b,
                                                      "gradmap_fused", 3)
    torch.cuda.synchronize()
    assert f.shape == () and _rel(f, fr) <= 1e-5 and _rel(g, gr) <= 1e-5
    assert _rel(x, xr) <= 1e-6 and torch.equal(x, xr)
    x2, (f2, g2) = matvec_probe.run_variant(A, x0, b, "gradmap_fused", 3)
    assert torch.equal(x, x2) and torch.equal(f, f2) and torch.equal(g, g2)


@pytest.mark.parametrize("m,n", [(1000, 2048), (2000, 1500), (300, 8192),
                                 (16, 16), (None, 2048)])
def test_gradmap_probe_kernel_chains_its_ops(dev, m, n):
    """Each gradmap operation starts from the x the one before wrote: from
    x₀ = 0 each update (about f·1e-12) moves x, so x after 3 operations,
    within 1e-5 of its largest entry of the plain version's, is far (2/3
    of it) from x after one operation, which a kernel that read x₀ on
    every operation would return."""
    m = _gradmap_streamed_m(dev, n) if m is None else m
    A, x0, b = _probe_data(dev, m, n, 1 / 40)
    x0 = torch.zeros_like(x0)
    x = matvec_probe.run_variant(A, x0, b, "gradmap_fused", 3)[0]
    xr = matvec_probe.run_variant_reference(A, x0, b, "gradmap_fused", 3)[0]
    x1 = matvec_probe.run_variant_reference(A, x0, b, "gradmap_fused", 1)[0]
    torch.cuda.synchronize()
    assert _rel(x, xr) <= 1e-5
    assert _rel(x1, xr) >= 0.1


@pytest.mark.parametrize("m,n", [(3000, 2048), (2000, 1500), (500, 4096),
                                 (300, 8192)])
def test_gradmap_probe_streamed_plan_gives_the_card_plan_bits(dev, m, n):
    """Where a row lies never changes the order of a sum: the gradmap
    kernel on plans forced to stream rows (budget 0 and half the card's)
    gives the card's own plan's x, g and f bits over 5 operations."""
    A, x0, b = _probe_data(dev, m, n, 1 / 40)
    own = matvec_probe._gradmap_tiles(dev.index, m, n)[0]
    nb, budget = matvec_probe._gradmap_grid(dev.index, n)[:2]
    assert own.route == "resident" and max(own.smem_rows) > 0
    assert matvec_probe.gradmap_probe_plan(m, n, nb, 0).route == "streamed"
    x, (f, g) = matvec_probe.run_variant(A, x0, b, "gradmap_fused", 5)
    for forced in (0, budget // 2):
        plan = matvec_probe.gradmap_probe_plan(m, n, nb, forced)
        got = matvec_probe._gradmap_launch(A, x0, b, 5, plan)
        assert all(torch.equal(u, v) for u, v in zip(got, (x, g, f))), forced


@pytest.mark.parametrize("n", [16, 1500, 2048, 4096, 8192])
def test_gradmap_probe_grid_budget_is_gradmap_probe_budget(dev, n):
    """The card's shared memory for rows of A in the gradmap kernel
    (``_gradmap_grid``) is ``gradmap_probe_budget`` of its opt-in and the
    kernel's static shared memory; on the H100 those are the module's H100
    numbers, which the CPU tests of the plan take."""
    nb, budget, optin, static = matvec_probe._gradmap_grid(dev.index, n)
    assert nb == torch.cuda.get_device_properties(dev).multi_processor_count
    assert budget == matvec_probe.gradmap_probe_budget(n, optin, static)
    if "H100" in torch.cuda.get_device_name(dev):
        assert optin == microsolver.H100_SMEM_OPTIN
        assert static == matvec_probe.H100_STATIC_SMEM
        assert budget == matvec_probe.gradmap_probe_budget(n)


def test_gradmap_probe_refuses_wide_rows(dev):
    """Past 8192 columns K-P1's gradmap form has no kernel on the card
    (every block keeps its share of g) and no fallback: it raises."""
    A, x, b = _probe_data(dev, 8, 8196, 1.0)
    before = matvec_probe.LAUNCHES
    with pytest.raises(ValueError, match="8192"):
        matvec_probe.run_variant(A, x, b, "gradmap_fused", 2)
    assert matvec_probe.LAUNCHES == before


TAIL_RUNGS = [(f"L{i}", dict(level=i)) for i in range(7)] + [
    (f"X-{f}", {"level": 6, f: True}) for f in tail_probe.VARIANTS]


@pytest.mark.parametrize("name,kw", TAIL_RUNGS, ids=[r[0] for r in TAIL_RUNGS])
@pytest.mark.parametrize("m,n", [(1000, 2000), (200, 300), (300, 1500)])
def test_tail_probe_kernel_matches_plain(dev, name, kw, m, n):
    """K-P3 at K = 3: records, g and τ within 1e-5 of their largest entry
    of the plain version's (float32 sums in another order), the same
    trials, x equal to x₀."""
    A, x0, b = _probe_data(dev, m, n, 1.0)
    before = tail_probe.LAUNCHES
    out = tail_probe.make(**kw)(A, b, x0, 3)
    assert tail_probe.LAUNCHES == before + 1
    ref = tail_probe.tail_reference(A, b, x0, 3, kw["level"])
    for got, want in zip(out[1:5], ref[1:5]):
        if want.any():
            assert _rel(got, want) <= 1e-5
        else:  # the records below L6: nothing written
            assert not got.any()
    assert int(out.trials) == int(ref.trials)
    assert torch.equal(out.x, x0) and torch.equal(ref.x, x0)


def test_tail_probe_variants_keep_l6_sums(dev):
    """X2 (one ‖Δx‖²), X3 (decisions in registers), X4 (stacked dots) and
    X5 (the first trial outside the loop) keep L6's summation order:
    bit-identical to L6 over 200 iterations."""
    A, x0, b = _probe_data(dev, 1000, 2000, 1.0)
    l6 = tail_probe.make(6)(A, b, x0, 200)
    for flag in ("thread", "vecscal", "fusedred", "condbt"):
        out = tail_probe.make(6, **{flag: True})(A, b, x0, 200)
        assert all(torch.equal(u, v) for u, v in zip(out, l6)), flag


@pytest.mark.parametrize("n4", [16, 300, 2000, 2048, 2052, 4100, 8192])
def test_tail_grid_budget_is_tail_budget(dev, n4):
    """The card's shared memory for rows of A in the ladder's kernels
    (``_grid``) is ``tail_budget`` of its opt-in and the kernels' static
    shared memory; on the H100 those two are the module's H100 numbers,
    which the CPU tests of the plan take."""
    nb, budget, optin, static = tail_probe._grid(dev.index, n4)
    assert nb == torch.cuda.get_device_properties(dev).multi_processor_count
    assert budget == tail_probe.tail_budget(n4, optin, static)
    if "H100" in torch.cuda.get_device_name(dev):
        assert optin == microsolver.H100_SMEM_OPTIN
        assert static == tail_probe.H100_STATIC_SMEM
        assert budget == tail_probe.tail_budget(n4)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n", [8, 1003, 2000, 4096, 8192])
def test_bf16_probe_grid_budget_is_bf16_probe_budget(dev, n, bf16):
    """The same for K-P4 in each storage type."""
    nb, budget, optin, static = bf16_probe._grid(dev.index, bf16, n)
    assert nb == torch.cuda.get_device_properties(dev).multi_processor_count
    assert budget == bf16_probe.bf16_probe_budget(n, bf16, optin, static)
    if "H100" in torch.cuda.get_device_name(dev):
        assert static == bf16_probe.H100_STATIC_SMEM
        assert budget == bf16_probe.bf16_probe_budget(n, bf16)


@pytest.mark.parametrize("m,n", [(3000, 2000), (600, 2052), (2000, 1500)])
def test_tail_probe_streamed_plan_gives_the_card_plan_bits(dev, m, n):
    """Where a row lies — registers, shared memory or L2 — never changes
    the order of a sum: L6 and X1 on plans forced to stream rows (budget
    0 and half the card's) give the card's own plan's bits over 20
    iterations."""
    A, x0, b = _probe_data(dev, m, n, 1.0)
    own = tail_probe._tiles(dev.index, m, n)[0]
    nb, budget = tail_probe._grid(dev.index, n)[:2]
    assert own.route == "resident" and max(own.smem_rows) > 0
    assert tail_probe.tail_plan(m, n, nb, 0).route == "streamed"
    for variant, kw in ((0, dict()), (1, dict(col=True))):
        want = tail_probe.make(6, **kw)(A, b, x0, 20)
        for forced in (0, budget // 2):
            plan = tail_probe.tail_plan(m, n, nb, forced)
            got = tail_probe._launch(6, variant, A, b, x0, 20, plan)
            assert all(torch.equal(u, v) for u, v in zip(got, want)), forced


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n", [(3000, 2000), (2000, 2052), (5000, 1003),
                                 (4000, 1500)])
def test_bf16_probe_streamed_plan_gives_the_card_plan_bits(dev, dtype, m, n):
    """K-P4 on plans forced to stream rows (budget 0 and half the card's)
    gives the card's own plan's bits, in either storage type."""
    A, x0, _ = _probe_data(dev, m, n, 1 / m ** 0.5)
    A = A.to(dtype)
    bf16 = dtype == torch.bfloat16
    own = bf16_probe._tiles(dev.index, m, n, bf16)[0]
    nb, budget = bf16_probe._grid(dev.index, bf16, n)[:2]
    assert max(own.smem_rows) > 0
    assert bf16_probe.bf16_probe_plan(m, n, bf16, nb, 0).route == "streamed"
    want = bf16_probe.bf16_probe(A, x0, 5)
    for forced in (0, budget // 2):
        plan = bf16_probe.bf16_probe_plan(m, n, bf16, nb, forced)
        got = bf16_probe._launch(A, x0, 5, plan)
        assert all(torch.equal(u, v) for u, v in zip(got, want)), forced


def test_probe_kernels_refuse_wide_rows(dev):
    """Past 8192 columns neither K-P3 nor K-P4 has a kernel on the card:
    every block keeps the n-sized state or its share of g."""
    A, x, b = _probe_data(dev, 8, 8196, 1.0)
    with pytest.raises(ValueError, match="8192"):
        tail_probe.make(6)(A, b, x, 2)
    with pytest.raises(ValueError, match="8192"):
        bf16_probe.bf16_probe(A.to(torch.bfloat16), x, 2)


def test_probe_kernels_reject_what_they_do_not_take(dev):
    A, x, b = _probe_data(dev, 64, 128, 1.0)
    run = tail_probe.make(6)
    for call in (lambda A, x, b: matvec_probe.run_variant(A, x, b,
                                                          "fwd_vpu", 2),
                 lambda A, x, b: matvec_probe.gradmap_fused(A, x, b),
                 lambda A, x, b: run(A, b, x, 2)):
        with pytest.raises(ValueError, match="contiguous"):
            call(A.t().contiguous().t(), x, b)
        with pytest.raises(ValueError, match="float32"):
            call(A.double(), x.double(), b.double())
        with pytest.raises(ValueError, match="aligned"):
            call(A, torch.zeros(129, device=dev)[1:], b)
        A2, x2, _ = _probe_data(dev, 64, 130, 1.0)
        with pytest.raises(ValueError, match="n % 4"):
            call(A2, x2, b)


# --------------------------------------------------------------------------
# Slice 10: K-B8's routes with the channel matrices on the chip
# --------------------------------------------------------------------------

# (m, n, budget or None for the card's own, kernel, route): each route of
# the tile plan at a small shape; a budget forces a streamed remainder.
# The wide rows run beside the n-sized state in shared memory up to
# n = 2048 (microsolve_planar_kernel), past it in the wide kernel, whose
# threads take two slots of a row up to n = 4096 and four past it; each
# of the two has a streamed case.
PLANAR_ROUTES = {
    "rows, registers": (1000, 37, None, "rows", "resident"),
    "rows, shared": (2000, 300, None, "rows", "resident"),
    "rows, streamed": (8192, 256, 0, "rows", "streamed"),
    "rows past 256, streamed": (2000, 300, 5 * 8 * 300, "rows", "streamed"),
    "wide rows": (4099, 601, None, "wide", "resident"),
    "wide rows, streamed": (4099, 601, 9 * 8 * 604, "wide", "streamed"),
    "wide kernel, two slots": (1000, 2100, None, "wide", "resident"),
    "wide kernel, streamed": (400, 5000, 8 * 5000, "wide", "streamed"),
    "wide kernel, two slots, streamed": (400, 3000, 8 * 3000, "wide",
                                         "streamed"),
    "columns": (300, 8300, None, "columns", "columns"),
}
# m ≥ 4n: a bounded solution, whose objective the kernel must reach
POSED = {(1000, 37), (2000, 300), (8192, 256), (4099, 601)}


@pytest.mark.parametrize("n4", [4, 256, 260, 512, 516, 1024, 2048, 2052,
                                4096, 5000, 8192, 8196])
def test_planar_grid_budget_is_row_budget(dev, n4):
    """The card's shared memory for rows of A (``_grid``) is
    ``row_budget`` of its opt-in and the kernel's static shared memory; on
    the H100 those two are the module's H100 numbers, which the CPU tests
    of the tile plan take."""
    mp = microsolver_planar
    nb, budget, optin, static = mp._grid(dev.index, n4)
    assert nb == torch.cuda.get_device_properties(dev).multi_processor_count
    assert budget == mp.row_budget(n4, optin, static)
    if "H100" in torch.cuda.get_device_name(dev):
        assert optin == mp.H100_SMEM_OPTIN
        if n4 <= mp.WIDE_MAX_N:
            assert static == mp.H100_STATIC_SMEM[(n4 > mp.WIDE_N)
                                                 + (n4 > mp.STATE_MAX_N)]
        assert budget == mp.row_budget(n4)


def _plan(dev, m, n, budget):
    n4 = (n + 3) // 4 * 4
    if budget is None:
        return microsolver_planar._tiles(dev.index, m, n4)[0]
    nb = microsolver_planar._grid(dev.index, n4)[0]
    return microsolver_planar.tile_plan(m, n4, nb, budget)


def _planar_launch(data, tau0, kw, plan, B=1, record_its=False):
    """K-B8 (B = 1) or K-B8b on a given tile plan."""
    Ar, Ai, b, c, x0 = data
    out = microsolver_planar._launch(Ar, Ai, b, c, x0, tau0, B, record_its,
                                     microsolver_planar._options(kw), plan)
    if B == 1:
        return MicrosolveOutput(*(None if t is None else t[0] for t in out))
    return MicrosolveOutput(*out)


def _route_counts():
    return (microsolver_planar.RESIDENT_LAUNCHES,
            microsolver_planar.STREAMED_LAUNCHES,
            microsolver_planar.COLUMN_LAUNCHES)


@pytest.mark.parametrize("accelerate", [False, True])
@pytest.mark.parametrize("hp", [False, True])
@pytest.mark.parametrize("case", list(PLANAR_ROUTES))
def test_planar_routes_match_plain(dev, case, hp, accelerate):
    """Each route of K-B8 against its plain version over 40 iterations
    (the route counter shows which ran): backtracks equal and the first 10
    taus and residuals within rtol max(1e-3, twice the plain version's own
    spread with its columns reversed), every record; where the problem is
    well posed the float64 objective within max(1e-5, twice that
    spread)."""
    m, n, budget, kernel, route = PLANAR_ROUTES[case]
    p, data = _phase(dev, m, n)
    plan = _plan(dev, m, n, budget)
    assert (plan.kernel, plan.route) == (kernel, route)
    kw = dict(max_iters=40, tol=0.0, stop_rule="iterations", hp=hp,
              accelerate=accelerate, restart_dd=hp, record_bts=True,
              record_fvals=True, record_objs=True, record_nres=True)
    before = np.array(_route_counts())
    out = _planar_launch(data, 1.0, kw, plan, record_its=True)
    step = {"resident": (1, 0, 0), "streamed": (0, 1, 0),
            "columns": (0, 0, 1)}[route]
    assert tuple(np.array(_route_counts()) - before) == step
    ref = microsolver_planar.microsolve_planar_phasemax_reference(
        *data, 1.0, record_its=True, **kw)
    perm = torch.arange(n - 1, -1, -1, device=dev)
    rev = microsolver_planar.microsolve_planar_phasemax_reference(
        *_reordered(data, perm), 1.0, **kw)
    torch.cuda.synchronize()
    assert int(out.iteration_count) == int(ref.iteration_count) == 40
    tol = max(1e-3, 2.0 * _spread(rev.taus[:10], ref.taus[:10]),
              2.0 * _spread(rev.residuals[:10], ref.residuals[:10]))
    torch.testing.assert_close(out.taus[:10], ref.taus[:10], rtol=tol,
                               atol=0.0)
    torch.testing.assert_close(out.residuals[:10], ref.residuals[:10],
                               rtol=tol, atol=1e-6)
    assert torch.equal(out.backtracks[:10], ref.backtracks[:10])
    torch.testing.assert_close(out.objectives[:10], ref.objectives[:10],
                               rtol=tol, atol=0.0)
    assert out.iterates.shape == (40, n, 2)
    if not accelerate:
        assert torch.equal(out.iterates[-1], out.x)
    if (m, n) in POSED:
        f1, f2 = _phase_objective(p, out.x), _phase_objective(p, ref.x)
        f_rev = _phase_objective(p, rev.x[perm.argsort()])
        assert abs(f1 - f2) <= max(1e-5 * abs(f2), 2.0 * abs(f_rev - f2))


@pytest.mark.parametrize("case", ["rows, streamed", "rows past 256, streamed",
                                  "wide rows, streamed",
                                  "wide kernel, streamed",
                                  "wide kernel, two slots, streamed"])
def test_planar_streamed_remainder_gives_the_resident_bits(dev, case):
    """Where a row lies — registers, shared memory or L2 — never changes
    the order of a sum: a plan forced to stream rows gives the same bits
    as the card's own plan, one solve and a batch, adaptive and FISTA;
    and the batch on the forced plan is its separate launches."""
    m, n, budget, _, _ = PLANAR_ROUTES[case]
    p, data = _phase(dev, m, n)
    forced = _plan(dev, m, n, budget)
    own = _plan(dev, m, n, None)
    assert forced.route == "streamed" and own.route == "resident"
    assert forced.streamed_rows > 0
    bs = _stack(data[2], 3)
    t0s = torch.tensor([1.0, 0.3, 2.0], device=dev)
    for mode in (dict(), dict(hp=True, accelerate=True, restart_dd=True)):
        kw = dict(max_iters=200, tol=1e-5, record_bts=True,
                  record_fvals=True, **mode)
        one = _planar_launch(data, 1.0, kw, forced)
        assert all(a is None and b is None or torch.equal(a, b)
                   for a, b in zip(one, _planar_launch(data, 1.0, kw, own)))
        batched = (data[0], data[1], bs, data[3], data[4])
        out = _planar_launch(batched, t0s, kw, forced, B=3)
        _same(out, [_planar_launch((data[0], data[1], bs[i], data[3],
                                    data[4]), float(t0s[i]), kw, forced)
                    for i in range(3)])


@pytest.mark.parametrize("case", list(PLANAR_ROUTES))
def test_planar_batch_takes_each_instance_anchor(dev, case):
    """K-B8b with one anchor an instance (c (B, n, 2)), on every route:
    each instance bit-identical to its own K-B8 launch with its anchor,
    start and τ₀, adaptive and FISTA; the same anchor given B times gives
    the bits of the shared anchor."""
    m, n, budget, _, _ = PLANAR_ROUTES[case]
    p, (Ar, Ai, b, c, x0) = _phase(dev, m, n)
    plan = _plan(dev, m, n, budget)
    bs = _stack(b, 3)
    cs = torch.stack([torch.roll(c, i, 0) * (1.0 + 0.2 * i)
                      for i in range(3)])
    x0s = torch.stack([torch.roll(x0, i, 0) for i in range(3)])
    t0s = torch.tensor([1.0, 0.3, 2.0], device=dev)
    for mode in (dict(), dict(hp=True, accelerate=True, restart_dd=True)):
        kw = dict(max_iters=150, tol=1e-5, record_bts=True,
                  record_fvals=True, record_objs=True, **mode)
        out = _planar_launch((Ar, Ai, bs, cs, x0s), t0s, kw, plan, B=3)
        _same(out, [_planar_launch((Ar, Ai, bs[i], cs[i], x0s[i]),
                                   float(t0s[i]), kw, plan)
                    for i in range(3)])
        shared = _planar_launch((Ar, Ai, bs, c, x0s), t0s, kw, plan, B=3)
        given = _planar_launch((Ar, Ai, bs, c.expand(3, -1, -1), x0s), t0s,
                               kw, plan, B=3)
        assert all(a is None and g is None or torch.equal(a, g)
                   for a, g in zip(shared, given))
        assert not torch.equal(out.x[1:], shared.x[1:])


def test_planar_batch_own_anchors_at_the_cell_shape(dev):
    """At 16384×256, through ``microsolve_batch``: four signals, each with
    its own magnitudes, anchor and start, bit-identical to four
    ``microsolve`` calls."""
    p, (Ar, Ai, b, c, x0) = _phase(dev, 16384, 256)
    bs = _stack(b, 4)
    cs = torch.stack([torch.roll(c, 7 * i, 0) for i in range(4)])
    x0s = torch.stack([torch.roll(x0, 7 * i, 0) for i in range(4)])
    kw = dict(max_iters=300, tol=1e-5, tau0=1.0)
    out = p.microsolve_batch(bs, x0s=x0s, prox=cs, **kw)
    for i in range(4):
        one = p.with_parts(fterm=ftt.PlanarPhaseHinge(bs[i]),
                           gterm=ftt.PlanarLinearAnchor(cs[i]),
                           x0=x0s[i]).microsolve(**kw)
        assert torch.equal(out.solutions[i], one.solution)
        assert int(out.iteration_counts[i]) == one.iteration_count
        np.testing.assert_array_equal(out.taus[i], one.taus)


def test_planar_column_fallback_batches_and_halts(dev):
    """Past 8192 columns the column fallback: a batch of 3 bit-identical
    to its separate launches (each counted on the route), and a NaN τ₀
    halts as nonfinite after one iteration."""
    m, n = 300, 8300
    p, (Ar, Ai, b, c, x0) = _phase(dev, m, n)
    bs = _stack(b, 3)
    t0s = torch.tensor([1.0, 0.3, 2.0], device=dev)
    kw = dict(max_iters=100, tol=1e-5, record_bts=True, hp=True)
    before = microsolver_planar.COLUMN_LAUNCHES
    out = microsolver_planar.microsolve_planar_phasemax_batch(
        Ar, Ai, bs, c, x0, t0s, **kw)
    _same(out, [microsolver_planar.microsolve_planar_phasemax(
        Ar, Ai, bs[i], c, x0, float(t0s[i]), **kw) for i in range(3)])
    assert microsolver_planar.COLUMN_LAUNCHES == before + 4
    bad = microsolver_planar.microsolve_planar_phasemax(Ar, Ai, b, c, x0,
                                                        float("nan"),
                                                        max_iters=50)
    assert bad.status == "nonfinite" and int(bad.iteration_count) == 1


@pytest.mark.parametrize("case", list(PLANAR_ROUTES))
def test_planar_routes_halt_nonfinite_and_leave_the_barrier_at_zero(dev,
                                                                    case):
    """A NaN τ₀ halts every route as nonfinite after one iteration, in one
    solve and in a batch beside a finite instance, which the halt leaves
    intact; after each launch the grid barrier's counter and exit ticket in
    the stream's scratch are back at zero, so the next launch needs no
    memset."""
    m, n, budget, _, _ = PLANAR_ROUTES[case]
    p, data = _phase(dev, m, n)
    plan = _plan(dev, m, n, budget)
    kw = dict(max_iters=50, tol=1e-5)
    bad = _planar_launch(data, float("nan"), kw, plan)
    assert bad.status == "nonfinite" and int(bad.iteration_count) == 1
    bs = _stack(data[2], 2)
    t0s = torch.tensor([float("nan"), 1.0], device=dev)
    out = _planar_launch((data[0], data[1], bs, data[3], data[4]), t0s, kw,
                         plan, B=2)
    assert out.halt[0].item() == 2
    good = _planar_launch((data[0], data[1], bs[1], data[3], data[4]), 1.0,
                          kw, plan)
    assert torch.equal(out.x[1], good.x)
    torch.cuda.synchronize()
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    from fasta_tpu_torch.kernels import _build
    bar = _build.stream_scratch(dev, stream, 1)
    assert bar[:1].view(torch.int32).tolist() == [0, 0]


# --------------------------------------------------------------------------
# Slice 11: K-B1's routes with A on the chip
# --------------------------------------------------------------------------

# (m, n, budget or None for the card's own, kernel, route): each route of
# the dense plan at a small shape; a budget forces a streamed remainder.
# A thread takes one float4 slot of a row up to n = 2048 (its first step's
# rows in registers), two up to 4096 and four up to 8192; past it the
# column fallback.
DENSE_ROUTES = {
    "rows, registers": (1000, 500, None, "rows", "resident"),
    "rows, shared": (3000, 1000, None, "rows", "resident"),
    "rows, streamed": (3000, 1000, 0, "rows", "streamed"),
    "rows, ragged": (301, 699, None, "rows", "resident"),
    "rows, two slots": (500, 3000, None, "rows", "resident"),
    "rows, two slots, streamed": (500, 3000, 4 * 3000, "rows", "streamed"),
    "rows, four slots, streamed": (300, 7000, None, "rows", "streamed"),
    # one row lane of 12 warps: the block's last 4 warps hold no slot
    "rows, one short row lane": (600, 1500, None, "rows", "resident"),
    "rows, one short row lane, streamed": (2000, 1500, 0, "rows",
                                           "streamed"),
    "columns": (100, 9000, None, "columns", "columns"),
}


def _dense_plan(dev, m, n, budget):
    n4 = (n + 3) // 4 * 4
    if budget is None:
        return microsolver._tiles(dev.index, m, n4)[0]
    nb = microsolver._grid(dev.index, n4)[0]
    return microsolver.dense_plan(m, n4, nb, budget)


def _dense_launch(data, tau0, kw, plan, B=1, record_its=False):
    """K-B1 (B = 1) or K-B1b on a given dense plan."""
    A, b, x0 = data
    out = microsolver._launch(A, b, x0, tau0, 0.1, B, False, record_its,
                              microsolver._options(kw), plan)
    if B == 1:
        return MicrosolveOutput(*(None if t is None else t[0] for t in out))
    return MicrosolveOutput(*out)


def _dense_routes():
    return (microsolver.RESIDENT_LAUNCHES, microsolver.STREAMED_LAUNCHES,
            microsolver.COLUMN_LAUNCHES)


def _lasso_data(dev, m, n):
    p = problems.build("lasso", m=m, n=n, k=max(1, m // 10), device=dev)
    return p.op.A, p.fterm.b, p.x0


@pytest.mark.parametrize("n4", [4, 16, 100, 500, 1000, 2000, 2048, 2052,
                                4096, 6000, 8192, 8196])
def test_dense_grid_budget_is_dense_budget(dev, n4):
    """The card's shared memory for rows of A (``_grid``) is
    ``dense_budget`` of its opt-in and the row kernel's static shared
    memory; on the H100 those two are the module's H100 numbers, which
    the CPU tests of the dense plan take."""
    nb, budget, optin, static = microsolver._grid(dev.index, n4)
    assert nb == torch.cuda.get_device_properties(dev).multi_processor_count
    assert budget == microsolver.dense_budget(n4, optin, static)
    if "H100" in torch.cuda.get_device_name(dev):
        assert optin == microsolver.H100_SMEM_OPTIN
        if n4 <= microsolver.STATE_MAX_N:
            assert static == microsolver.H100_STATIC_SMEM
        assert budget == microsolver.dense_budget(n4)


@pytest.mark.parametrize("accelerate", [False, True])
@pytest.mark.parametrize("hp", [False, True])
@pytest.mark.parametrize("case", list(DENSE_ROUTES))
def test_dense_routes_match_plain(dev, case, hp, accelerate):
    """Each route of K-B1 against its plain version on LASSO over 40
    iterations (the route counter shows which ran): the first 10 taus
    rtol 1e-3, residuals rtol 1e-3 / atol 1e-6, objectives rtol 1e-4 and
    backtracks equal, every record, and where the problem is well posed
    (m ≥ n) the float64 objective after 40 iterations within max(rel
    1e-5, twice the plain version's own spread with its columns reversed),
    K-B8's route test's rule.  (At 100×9000 the plain version's objective
    after 40 iterations moves by 3% when only its columns are reversed:
    the BB trajectories of the underdetermined shapes part with the order
    of float32 sums.)"""
    m, n, budget, kernel, route = DENSE_ROUTES[case]
    data = _lasso_data(dev, m, n)
    plan = _dense_plan(dev, m, n, budget)
    assert (plan.kernel, plan.route) == (kernel, route)
    kw = dict(max_iters=40, tol=0.0, stop_rule="iterations", hp=hp,
              accelerate=accelerate, restart_dd=hp, record_bts=True,
              record_fvals=True, record_objs=True, record_nres=True)
    before = np.array(_dense_routes())
    out = _dense_launch(data, 0.05, kw, plan, record_its=True)
    step = {"resident": (1, 0, 0), "streamed": (0, 1, 0),
            "columns": (0, 0, 1)}[route]
    assert tuple(np.array(_dense_routes()) - before) == step
    ref = microsolver.microsolve_lasso_reference(*data, 0.05, 0.1,
                                                 record_its=True, **kw)
    torch.cuda.synchronize()
    assert int(out.iteration_count) == int(ref.iteration_count) == 40
    torch.testing.assert_close(out.taus[:10], ref.taus[:10], rtol=1e-3,
                               atol=0.0)
    torch.testing.assert_close(out.residuals[:10], ref.residuals[:10],
                               rtol=1e-3, atol=1e-6)
    assert torch.equal(out.backtracks[:10], ref.backtracks[:10])
    torch.testing.assert_close(out.objectives[:10], ref.objectives[:10],
                               rtol=1e-4, atol=0.0)
    assert torch.isfinite(out.norm_residuals).all()
    assert out.iterates.shape == (40, n)
    if not accelerate:
        assert torch.equal(out.iterates[-1], out.x)
    if m < n:
        return
    perm = torch.arange(n - 1, -1, -1, device=dev)
    rev = microsolver.microsolve_lasso_reference(
        data[0][:, perm].contiguous(), data[1], data[2][perm].contiguous(),
        0.05, 0.1, **kw)
    f1 = _objective(data[0], data[1], out.x, "lstsq", "l1", 0.1)
    f2 = _objective(data[0], data[1], ref.x, "lstsq", "l1", 0.1)
    f_rev = _objective(data[0], data[1], rev.x[perm.argsort()], "lstsq",
                       "l1", 0.1)
    assert abs(f1 - f2) <= max(1e-5 * abs(f2), 2.0 * abs(f_rev - f2))


@pytest.mark.parametrize("case", ["rows, streamed",
                                  "rows, two slots, streamed",
                                  "rows, one short row lane, streamed"])
def test_dense_streamed_remainder_gives_the_resident_bits(dev, case):
    """Where a row lies — registers, shared memory or L2 — never changes
    the order of a sum: plans forced to stream rows (the case's budget and
    half the card's) give the same bits as the card's own plan, one solve
    and a batch, adaptive and FISTA; and the batch on the forced plan is
    its separate launches."""
    m, n, budget, _, _ = DENSE_ROUTES[case]
    data = _lasso_data(dev, m, n)
    own = _dense_plan(dev, m, n, None)
    half = _dense_plan(dev, m, n, microsolver._grid(dev.index, own.n4)[1] // 2)
    forced = _dense_plan(dev, m, n, budget)
    assert forced.route == "streamed" and own.route == "resident"
    assert forced.streamed_rows > 0
    bs = _stack(data[1], 3)
    t0s = torch.tensor([0.02, 0.05, 0.09], device=dev)
    for mode in (dict(), dict(hp=True, accelerate=True, restart_dd=True)):
        kw = dict(max_iters=200, tol=1e-6, record_bts=True,
                  record_fvals=True, **mode)
        want = _dense_launch(data, 0.05, kw, own)
        for plan in (forced, half):
            got = _dense_launch(data, 0.05, kw, plan)
            assert all(a is None and b is None or torch.equal(a, b)
                       for a, b in zip(got, want))
        out = _dense_launch((data[0], bs, data[2]), t0s, kw, forced, B=3)
        _same(out, [_dense_launch((data[0], bs[i], data[2]), float(t0s[i]),
                                  kw, forced) for i in range(3)])


def test_dense_kernel_on_two_streams_and_in_a_cuda_graph(dev):
    """K-B1 calls on two streams at once (each stream its own barrier
    counter), and two calls captured in one CUDA graph and replayed twice,
    give what the same calls give one after the other: every launch leaves
    its counter at zero and allocates nothing on the card."""
    small = _lasso_data(dev, 300, 600)
    big = _lasso_data(dev, 1000, 2000)
    kw = dict(max_iters=300, tol=1e-6, record_bts=True)

    def calls():
        return (microsolver.microsolve_lasso(*small, 0.05, 0.1, **kw)
                + microsolver.microsolve_lasso(*big, 0.05, 0.1,
                                               accelerate=True, **kw))
    want = calls()
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in range(2)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(3):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(calls())
    torch.cuda.synchronize()
    for outs in got:
        for out in outs:
            assert all(a is None and b is None or torch.equal(a, b)
                       for a, b in zip(out, want))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        first = calls()
        second = calls()
    for _ in range(2):
        for t in first + second:
            if t is not None:
                t.fill_(-7)
        graph.replay()
        torch.cuda.synchronize()
        for out in (first, second):
            assert all(a is None and b is None or torch.equal(a, b)
                       for a, b in zip(out, want))


@pytest.mark.parametrize("case", list(DENSE_ROUTES))
def test_dense_routes_halt_nonfinite_and_leave_the_barrier_at_zero(dev,
                                                                   case):
    """A NaN τ₀ halts every route as nonfinite after one iteration, in one
    solve and in a batch beside a finite instance, which the halt leaves
    intact, and the kernel zeroes the records past that iteration; after
    each launch the grid barrier's counter and exit ticket in the stream's
    scratch are back at zero."""
    m, n, budget, _, _ = DENSE_ROUTES[case]
    data = _lasso_data(dev, m, n)
    plan = _dense_plan(dev, m, n, budget)
    kw = dict(max_iters=50, tol=1e-6)
    bad = _dense_launch(data, float("nan"), dict(kw, record_fvals=True),
                        plan, record_its=True)
    assert bad.status == "nonfinite" and int(bad.iteration_count) == 1
    assert not bad.taus[1:].any() and not bad.fvals[1:].any()
    assert not bad.iterates[1:].any()
    bs = _stack(data[1], 2)
    t0s = torch.tensor([float("nan"), 0.05], device=dev)
    out = _dense_launch((data[0], bs, data[2]), t0s, kw, plan, B=2)
    assert out.halt[0].item() == 2
    good = _dense_launch((data[0], bs[1].clone(), data[2]), 0.05, kw, plan)
    assert torch.equal(out.x[1], good.x)
    torch.cuda.synchronize()
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    from fasta_tpu_torch.kernels import _build
    bar = _build.stream_scratch(dev, stream, 1)
    assert bar[:1].view(torch.int32).tolist() == [0, 0]


@pytest.mark.parametrize("name", ["sparse_lasso", "democratic"])
def test_later_problem_loops_take_their_kernels_and_repeat_bits(dev, name):
    """Sparse LASSO (``SparseOp``, cuSPARSE) takes K-B4 on its loop path
    and democratic (the L∞ prox) K-B3, float32 at their default sizes;
    two solves give the same bits (count, taus and solution)."""
    p = problems.build(name, device=dev)
    p.tau0 = 0.1
    counter = (prox_fused, "LAUNCHES") if name == "sparse_lasso" else \
        (lstsq_fused, "LAUNCHES")
    before = getattr(*counter)
    runs = [p.solve(tol=1e-6, max_iters=500) for _ in range(2)]
    assert getattr(*counter) > before
    assert runs[0].iteration_count == runs[1].iteration_count
    np.testing.assert_array_equal(runs[0].taus, runs[1].taus)
    np.testing.assert_array_equal(runs[0].solution, runs[1].solution)
    assert np.isfinite(runs[0].solution).all()


# --------------------------------------------------------------------------
# The lane kernels of the adaptive loop (lane_fused)
# --------------------------------------------------------------------------

def _lane_rows(dev, R, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((R, n), generator=g, device=dev) for _ in range(4)], \
        torch.rand(R, generator=g, device=dev) + 0.05


def _close64(a, b, scale):
    """Float64 sums that differ only in their order: within 1e-12 of the
    sum of their terms' magnitudes (``scale``)."""
    assert ((a - b).abs() <= 1e-12 * scale).all(), (a - b).abs().max()


@pytest.mark.parametrize("R,m,per_row", [(16384, 1000, True),
                                         (16384, 2000, False), (3, 1001, True),
                                         (3, 1001, False), (1, 1000, False),
                                         (5, 7, True)])
@pytest.mark.parametrize("hp", [True, False])
def test_lane_residual_kernel_matches_plain(dev, R, m, per_row, hp):
    """r bit for bit, f within 1e-12 of its terms with hp (float64 sums
    in another order) and rtol 1e-5 without (float32), b shared or a row
    a lane, aligned and ragged rows; a second call gives the same bits."""
    (d, b, _, _), _ = _lane_rows(dev, R, m, R + m)
    b = b if per_row else b[0].clone()
    before = lane_fused.RESIDUAL_LAUNCHES
    r, f = lane_fused.residual_value(d, b, hp)
    assert lane_fused.RESIDUAL_LAUNCHES == before + 1
    r0, f0 = lane_fused.residual_value_reference(d, b, hp)
    torch.cuda.synchronize()
    assert torch.equal(r, r0) and f.dtype == f0.dtype
    if hp:
        _close64(f, f0, f0)
    else:
        torch.testing.assert_close(f, f0, rtol=1e-5, atol=0)
    again = lane_fused.residual_value(d, b, hp)
    assert torch.equal(again[0], r) and torch.equal(again[1], f)


@pytest.mark.parametrize("R,n", [(16384, 2000), (3, 1001), (1, 2000),
                                 (7, 5), (1, lane_fused.ROW_MAX_N)])
@pytest.mark.parametrize("hp", [True, False])
def test_lane_sums_kernel_matches_plain(dev, R, n, hp):
    """⟨Δx, Δg⟩ within 1e-12 of Σ|ΔxΔg| with hp — so x̂₁, Δx and Δg
    round in registers as the composition rounds them — and the float32
    sums within rtol 1e-5 (their order); a second call equal."""
    (x, g, x1, gf1), tau = _lane_rows(dev, R, n, 3 * R + n)
    before = lane_fused.SUMS_LAUNCHES
    out = lane_fused.adaptive_sums(x, g, x1, gf1, tau, hp)
    assert lane_fused.SUMS_LAUNCHES == before + 1
    ref = lane_fused.adaptive_sums_reference(x, g, x1, gf1, tau, hp)
    torch.cuda.synchronize()
    assert [t.dtype for t in out] == [t.dtype for t in ref]
    torch.testing.assert_close(out[0], ref[0], rtol=1e-5, atol=0)
    torch.testing.assert_close(out[2], ref[2], rtol=1e-5, atol=0)
    t = tau[:, None]
    dx = (x1 - x).double()
    dg = (gf1 + ((x - t * g) - x) / t).double()
    if hp:
        _close64(out[1], ref[1], (dx * dg).abs().sum(1))
    else:
        assert ((out[1] - ref[1]).abs().double()
                <= 1e-5 * (dx * dg).abs().sum(1)).all()
    again = lane_fused.adaptive_sums(x, g, x1, gf1, tau, hp)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("R,n", [(16384, 2000), (3, 1001), (1, 2000),
                                 (9, 6)])
def test_lane_update_kernel_matches_plain_and_keeps_stopped_rows(dev, R, n):
    """The three outputs bit for bit as the plain version's; a row whose
    live flag is clear keeps its bits in all three, best_x changes only
    where better is set, and x1 and ∇f₁ are not written."""
    (x1, gf1, a, b), _ = _lane_rows(dev, R, n, 5 * R + n)
    g = torch.Generator(device=dev).manual_seed(R)
    live = torch.rand(R, generator=g, device=dev) < 0.6
    live[0] = True
    better = live & (torch.rand(R, generator=g, device=dev) < 0.5)
    olds = [a, b, b.neg()]
    outs = [t.clone() for t in olds]
    refs = [t.clone() for t in olds]
    keep = (x1.clone(), gf1.clone())
    before = lane_fused.UPDATE_LAUNCHES
    lane_fused.lane_update(x1, gf1, live, better, *outs)
    assert lane_fused.UPDATE_LAUNCHES == before + 1
    lane_fused.lane_update_reference(x1, gf1, live, better, *refs)
    torch.cuda.synchronize()
    assert all(torch.equal(o, r) for o, r in zip(outs, refs))
    assert torch.equal(x1, keep[0]) and torch.equal(gf1, keep[1])
    for out, old in zip(outs, olds):
        assert torch.equal(out[~live], old[~live])
    assert torch.equal(outs[2][~better], olds[2][~better])
    assert torch.equal(outs[2][better], x1[better])


def test_lane_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros((4, 8), device=dev)
    tau = torch.ones(4, device=dev)
    with pytest.raises(ValueError, match="float32"):
        lane_fused.adaptive_sums(x.double(), x, x, x, tau, True)
    with pytest.raises(ValueError, match="contiguous"):
        lane_fused.residual_value(torch.zeros((8, 4), device=dev).t(), x,
                                  True)
    with pytest.raises(ValueError, match="lane_plan"):
        lane_fused.adaptive_sums(*(torch.zeros((1, 9000), device=dev),) * 4,
                                 tau[:1], True)
    assert lane_fused.lanes_route(torch.zeros((1, lane_fused.ROW_MAX_N),
                                              device=dev))
    assert not lane_fused.lanes_route(torch.zeros((1, 9000), device=dev))


def _composition(monkeypatch):
    """Make the loop choose today's composition on the card: the setting
    of every solve with the lane kernels off."""
    from fasta_tpu_torch import solver
    real = solver._setting

    def off(*a, **kw):
        return real(*a, **kw)._replace(lanes_fused=False, residual=False)
    monkeypatch.setattr(solver, "_setting", off)


def test_batch_lasso_on_the_lane_kernels_matches_the_composition(
        dev, monkeypatch):
    """A batch LASSO 1000×2000 × 256 through make_batch_solver, adaptive,
    hp: the route engages (every loop iteration launches each lane
    kernel once a trial or an iteration), the composition launches none,
    and the caller's x0 is never written.  The solutions' bound checks
    only that the two runs end near each other: the two round their sums
    in another order, so their float32 trajectories part, and each stops
    at a normalized residual of 1e-6, where the composition itself lies
    1.3e-6 to 1.8e-6 from the float64 solution (PERF.md, section 2); at
    2e-6 relative it cannot tell a wrong sum precision from that
    reordering.  The kernel tests above, at 1e-12 of the float64 sums'
    terms and bit for bit elsewhere, guard the arithmetic."""
    p = problems.build("lasso", device=dev)
    g = torch.Generator(device=dev).manual_seed(9)
    B = 256
    bs = p.fterm.b + 0.01 * torch.randn((B, p.fterm.b.numel()), generator=g,
                                        device=dev)
    x0 = 0.01 * torch.randn((B, p.x0.numel()), generator=g, device=dev)
    x0_bits = x0.clone()
    opts = ftt.FastaOptions(max_iters=1000, tol=1e-6, adaptive=True,
                            precision="high",
                            stop_rule="hybrid_residual")
    solve = ftt.make_batch_solver(opts, in_axes=(None, 0, None, 0, None))
    counts = [lane_fused.RESIDUAL_LAUNCHES, lane_fused.SUMS_LAUNCHES,
              lane_fused.UPDATE_LAUNCHES]
    fused = solve(p.op, ftt.LeastSquares(bs), p.gterm, x0, 0.05)
    counts = [c1 - c0 for c0, c1 in zip(counts, [
        lane_fused.RESIDUAL_LAUNCHES, lane_fused.SUMS_LAUNCHES,
        lane_fused.UPDATE_LAUNCHES])]
    loops = int(np.max(fused.iteration_count))
    assert counts[1] == counts[2] == loops and counts[0] >= loops + 1
    assert torch.equal(x0, x0_bits)
    _composition(monkeypatch)
    before = lane_fused.SUMS_LAUNCHES
    plain = solve(p.op, ftt.LeastSquares(bs), p.gterm, x0, 0.05)
    assert lane_fused.SUMS_LAUNCHES == before
    assert np.all(fused.converged) and np.all(plain.converged)
    gap = np.abs(np.asarray(fused.iteration_count)
                 - np.asarray(plain.iteration_count))
    assert gap.max() <= 2, gap.max()
    rel = (torch.linalg.vector_norm(fused.solution - plain.solution, dim=1)
           / torch.linalg.vector_norm(plain.solution, dim=1))
    assert float(rel.max()) <= 2e-6, float(rel.max())


def test_single_solve_and_resume_keep_the_callers_tensors(dev):
    """A single LASSO solve on the lane kernels (one row) leaves its x0,
    and a resume leaves the state it continues from, bit for bit; the
    resumed run equals the uninterrupted one."""
    p = problems.build("lasso", device=dev)
    x0 = 0.01 * torch.ones_like(p.x0)
    x0_bits = x0.clone()
    before = lane_fused.UPDATE_LAUNCHES
    run = ftt.make_stateful_solver(ftt.FastaOptions(max_iters=20, tol=1e-12))
    half, state = run(p.op, p.fterm, p.gterm, x0, 0.05)
    assert lane_fused.UPDATE_LAUNCHES == before + 20
    assert torch.equal(x0, x0_bits)
    bits = [t.clone() for t in (state.x1, state.gradf1, state.solution,
                                state.best_x)]
    out, _ = ftt.resume_state(p.op, p.fterm, p.gterm, state,
                              ftt.FastaOptions(max_iters=40, tol=1e-12))
    assert all(torch.equal(a, b) for a, b in zip(
        bits, (state.x1, state.gradf1, state.solution, state.best_x)))
    whole = ftt.make_solver(ftt.FastaOptions(max_iters=40, tol=1e-12))(
        p.op, p.fterm, p.gterm, x0, 0.05)
    assert torch.equal(out.solution, whole.solution)
