"""The lane kernels of the adaptive loop (``kernels/lane_fused.py``) on
the CPU: their plain versions are the loop's composition bit for bit,
the wrappers run them for CPU tensors, the loop chooses the kernels for
real float32 adaptive lanes whose trial is K-B4 (the residual kernel with
the plain least-squares term only), and a solve through them equals the
composition's bit for bit without writing the caller's tensors.  The
kernels themselves run on the card: ``tests/test_torch_cuda_kernels.py
-k lane``.
"""

import numpy as np
import pytest
import torch

import fasta_tpu_torch as ftt
from fasta_tpu_torch import problems, solver
from fasta_tpu_torch.kernels import lane_fused
from fasta_tpu_torch.precision import lane, lane_dot64, lane_norm2, lane_redot

torch.set_num_threads(1)


def _rows(R, n, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((R, n), generator=g, dtype=dtype) for _ in range(4)]


def _bits(a, b):
    return torch.equal(a, b) and a.dtype == b.dtype


# --------------------------------------------------------------------------
# The plain versions are the composition
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hp", [True, False])
@pytest.mark.parametrize("per_row", [True, False])
def test_residual_plain_version_is_the_least_squares_composition(hp,
                                                                 per_row):
    d, b, _, _ = _rows(5, 33, 1)
    b = b if per_row else b[0]
    term = ftt.LeastSquares(b)
    r, f = lane_fused.residual_value_reference(d, b, hp)
    want = (term.value_f64_lanes(d) if hp
            else term.value_lanes(d).to(torch.float32))
    assert _bits(f, want) and _bits(r, term.grad_lanes(d))
    out = lane_fused.residual_value(d, b, hp)
    assert _bits(out[0], r) and _bits(out[1], f)


@pytest.mark.parametrize("hp", [True, False])
def test_sums_plain_version_is_the_adaptive_composition(hp):
    x, g, x1, gf1 = _rows(4, 37, 2)
    tau = torch.rand(4, generator=torch.Generator().manual_seed(3)) + 0.1
    x1hat = x - lane(tau, x) * g
    Dx = x1 - x
    Dg = gf1 + (x1hat - x) / lane(tau, x)
    want = (lane_norm2(g), lane_dot64(Dx, Dg) if hp else lane_redot(Dx, Dg),
            lane_norm2(Dg))
    got = lane_fused.adaptive_sums_reference(x, g, x1, gf1, tau, hp)
    assert all(_bits(a, b) for a, b in zip(got, want))
    got = lane_fused.adaptive_sums(x, g, x1, gf1, tau, hp)
    assert all(_bits(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("wrapper", [True, False])
def test_update_plain_version_is_the_loops_keeps(wrapper):
    x1, gf1, a, b = _rows(6, 11, 4)
    live = torch.tensor([True, False, True, True, False, True])
    better = live & torch.tensor([True, True, False, True, True, False])
    olds = [a, b, b.neg()]
    want = [torch.where(lane(live, x1), x1, olds[0]),
            torch.where(lane(live, gf1), gf1, olds[1]),
            torch.where(lane(better, x1), x1, olds[2])]
    outs = [t.clone() for t in olds]
    fn = (lane_fused.lane_update if wrapper
          else lane_fused.lane_update_reference)
    assert fn(x1, gf1, live, better, *outs) is None
    assert all(_bits(o, w) for o, w in zip(outs, want))
    for out, old in zip(outs, olds):
        assert torch.equal(out[~live], old[~live])


def test_fits_and_refusals():
    """The routes the loop decides once a solve, and the wrappers'
    refusals of what a kernel would read or write past."""
    x, g, x1, gf1 = _rows(3, 8)
    tau = torch.ones(3)
    cpu = torch.device("cpu")
    assert lane_fused.lanes_route(x) and not lane_fused.lanes_route(x.double())
    assert not lane_fused.lanes_route(x.to(torch.complex64))
    assert not lane_fused.lanes_route(
        torch.zeros((2, lane_fused.ROW_MAX_N + 1)))
    assert lane_fused.residual_route(g[0], 3, cpu)
    assert lane_fused.residual_route(g, 3, cpu)
    assert not lane_fused.residual_route(g.double(), 3, cpu)
    assert not lane_fused.residual_route(g.t(), 8, cpu)
    assert not lane_fused.residual_route(g.to(torch.complex64), 3, cpu)
    with pytest.raises(ValueError, match="float32"):
        lane_fused.adaptive_sums(x.double(), g, x1, gf1, tau, True)
    with pytest.raises(ValueError, match="per-row"):
        lane_fused.adaptive_sums(x, g, x1, gf1, tau.double(), True)
    with pytest.raises(ValueError, match="one shape"):
        lane_fused.adaptive_sums(x, g, x1[:2], gf1, tau, True)
    with pytest.raises(ValueError, match="contiguous"):
        lane_fused.adaptive_sums(x, g, x1.t().contiguous().t(), gf1, tau,
                                 True)
    with pytest.raises(ValueError, match="b"):
        lane_fused.residual_value(x, g[0, :5], True)
    with pytest.raises(ValueError, match="float32"):
        lane_fused.residual_value(x.to(torch.complex64),
                                  g.to(torch.complex64), True)
    live = torch.ones(3, dtype=torch.bool)
    with pytest.raises(ValueError, match="per-row"):
        lane_fused.lane_update(x1, gf1, live.int(), live, x, g, gf1)


@pytest.mark.parametrize("R,n,fits", [
    (1, lane_fused.ROW_MAX_N, True), (1, lane_fused.ROW_MAX_N + 1, False),
    (16384, 2000, True), (2111, 9000, False), (2112, 9000, False),
    (3, 1001, True), (0, 5, False), (5, 0, False), (1 << 31, 4, False)])
def test_lane_plan(R, n, fits):
    """A warp a row: rows of up to ROW_MAX_N at any count, longer rows
    never (one warp a row would leave the card idle)."""
    assert lane_fused.lane_plan(R, n) is fits


# --------------------------------------------------------------------------
# The loop's choice
# --------------------------------------------------------------------------

def _setting(name="lasso", dtype=torch.float32, B=3, n=40, **opts):
    kw = dict(m=20, n=n, dtype=dtype, device="cpu")
    if name == "lasso":
        kw["k"] = 4
    p = problems.build(name, **kw)
    x = torch.as_tensor(p.x0).expand((B,) + tuple(p.x0.shape))
    return solver._setting(ftt.FastaOptions(**opts), p.op, p.fterm, p.gterm,
                           x)


@pytest.mark.parametrize("case,lanes,residual", [
    (dict(), True, True),
    (dict(B=1), True, True),
    (dict(precision="standard"), True, True),
    (dict(dtype=torch.float64), False, False),
    (dict(accelerate=True), False, False),
    (dict(adaptive=False), False, False),
    (dict(record_iterates=True), False, False),
    (dict(name="logistic"), True, False),
    (dict(name="nnls"), False, False),
    (dict(n=lane_fused.ROW_MAX_N + 1), False, False),
])
def test_route_choice(case, lanes, residual):
    """The lane kernels for real float32 adaptive lanes whose trial is
    K-B4 (an L1 prox), no iterate record, rows that lane_plan admits; the
    residual kernel with the plain least-squares term on those lanes
    only."""
    st = _setting(**case)
    assert (st.lanes_fused, st.residual) == (lanes, residual)


def test_route_choice_refuses_complex():
    A = torch.randn(6, 8, dtype=torch.complex64)
    x = torch.zeros(2, 8, dtype=torch.complex64)
    st = solver._setting(ftt.FastaOptions(), ftt.DenseOp(A),
                         ftt.LeastSquares(torch.zeros(6, dtype=A.dtype)),
                         ftt.L1Norm(0.1), x)
    assert not st.lanes_fused and not st.residual


def _off(monkeypatch):
    real = solver._setting

    def off(*a, **kw):
        return real(*a, **kw)._replace(lanes_fused=False, residual=False)
    monkeypatch.setattr(solver, "_setting", off)


def _counting(monkeypatch):
    calls = {"residual": 0, "sums": 0, "update": 0}
    for key, name in (("residual", "residual_value_reference"),
                      ("sums", "adaptive_sums_reference"),
                      ("update", "lane_update_reference")):
        real = getattr(lane_fused, name)

        def counted(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(lane_fused, name, counted)
    return calls


def _batch(B=6, m=30, n=60, seed=5):
    p = problems.build("lasso", m=m, n=n, k=5, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed)
    bs = p.fterm.b + 0.05 * torch.randn((B, m), generator=g)
    x0 = 0.01 * torch.randn((B, n), generator=g)
    return p, bs, x0


@pytest.mark.parametrize("precision", ["high", "standard"])
def test_batch_solve_on_the_lane_route_is_the_composition(monkeypatch,
                                                          precision):
    """A float32 LASSO batch takes the plain versions on every trial and
    iteration and equals the composition's run bit for bit: counts,
    solutions, best iterates, τ and f records; x0 is not written."""
    p, bs, x0 = _batch()
    x0_bits = x0.clone()
    opts = ftt.FastaOptions(max_iters=300, tol=1e-6, precision=precision)
    solve = ftt.make_batch_solver(opts, in_axes=(None, 0, None, 0, None))
    calls = _counting(monkeypatch)
    fused = solve(p.op, ftt.LeastSquares(bs), p.gterm, x0, 0.05)
    loops = int(np.max(fused.iteration_count))
    assert calls["sums"] == calls["update"] == loops
    assert calls["residual"] >= loops + 1
    assert torch.equal(x0, x0_bits)
    _off(monkeypatch)
    plain = solve(p.op, ftt.LeastSquares(bs), p.gterm, x0, 0.05)
    assert calls["sums"] == loops
    np.testing.assert_array_equal(fused.iteration_count,
                                  plain.iteration_count)
    for name in ("solution", "best_iterate", "taus", "fvals", "residuals"):
        assert torch.equal(getattr(fused, name), getattr(plain, name)), name


def test_single_solve_and_resume_leave_the_callers_tensors(monkeypatch):
    """One row: the same bits as the composition, x0 unwritten, and a
    resume leaves the state it continues from as it was and equals the
    uninterrupted run."""
    p = problems.build("lasso", m=30, n=60, k=5, device="cpu")
    x0 = 0.01 * torch.ones_like(p.x0)
    x0_bits = x0.clone()
    opts = ftt.FastaOptions(max_iters=12, tol=1e-12)
    half, state = ftt.make_stateful_solver(opts)(p.op, p.fterm, p.gterm, x0,
                                                 0.05)
    assert torch.equal(x0, x0_bits)
    fields = ("x1", "gradf1", "solution", "best_x")
    bits = [getattr(state, f).clone() for f in fields]
    longer = ftt.FastaOptions(max_iters=24, tol=1e-12)
    out, _ = ftt.resume_state(p.op, p.fterm, p.gterm, state, longer)
    assert all(torch.equal(b, getattr(state, f))
               for b, f in zip(bits, fields))
    whole = ftt.make_solver(longer)(p.op, p.fterm, p.gterm, x0, 0.05)
    assert torch.equal(out.solution, whole.solution)
    solver._SOLVER_CACHE.clear()
    _off(monkeypatch)
    plain = ftt.make_solver(longer)(p.op, p.fterm, p.gterm, x0, 0.05)
    assert torch.equal(whole.solution, plain.solution)
    assert torch.equal(whole.best_iterate, plain.best_iterate)
    assert torch.equal(whole.fvals, plain.fvals)


def test_logistic_lanes_take_sums_and_update_without_the_residual(
        monkeypatch):
    """Sparse logistic regression: the sums and the update kernels' plain
    versions, never the residual's (its loss is not least squares); the
    same bits as the composition."""
    p = problems.build("logistic", m=40, n=30, device="cpu")
    p.tau0 = 0.1
    calls = _counting(monkeypatch)
    opts = ftt.FastaOptions(max_iters=60, tol=1e-6)
    fused = ftt.make_solver(opts)(p.op, p.fterm, p.gterm, p.x0, 0.1)
    assert calls["sums"] == calls["update"] == fused.iteration_count > 0
    assert calls["residual"] == 0
    solver._SOLVER_CACHE.clear()
    _off(monkeypatch)
    plain = ftt.make_solver(opts)(p.op, p.fterm, p.gterm, p.x0, 0.1)
    assert torch.equal(fused.solution, plain.solution)
    assert fused.iteration_count == plain.iteration_count
