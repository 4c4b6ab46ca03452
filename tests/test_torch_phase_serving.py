"""Planar PhaseMax served with each instance's own anchor and start on the
CPU (m = 256, n = 16, B = 4): ``Problem.solve_serving`` of an
``InstanceBatch`` on ``batch_solver`` against separate loop solves and
against the benchmark's plain float64 reference, the plain K-B8b with one
anchor an instance against separate ``microsolve`` calls, the single
routes, the kernels that take no per-instance prox data, and the planar
product spans.

Tolerances: a lane against a separate float64 solve as
``tests/test_torch_serving_slice.py`` holds them (equal counts, τ rtol
1e-6, solutions atol 1e-8); against the plain reference, which repeats
the algorithm in another order of operations, equal counts, solutions
rtol 1e-9 and atol 1e-10 (1e-10 as for the right-hand sides there);
the plain K-B8b bit for bit."""

import collections
import math

import numpy as np
import pytest
import torch

import fasta_tpu_torch as ftt
from fasta_tpu_torch.serving import ServingPlan
from portbench.reference import phase_retrieval as ref

torch.set_num_threads(1)

M, N, B = 256, 16, 4
TAU0 = 1.0


def _data(dtype=torch.float64, seed=5):
    """A = (Ar + i·Ai)/√(2m), planted x♮, b = |A x♮|, and each instance's
    anchor c = 0.1·x̂₀ and start x̂₀, x̂₀ a unit-norm noisy x♮ (the
    generator's math), planar."""
    g = torch.Generator().manual_seed(seed)
    Ar, Ai = (torch.randn((M, N), generator=g, dtype=torch.float64)
              / math.sqrt(2 * M) for _ in range(2))
    x_true = torch.randn((B, N, 2), generator=g, dtype=torch.float64)
    b = torch.linalg.vector_norm(ref.forward(Ar, Ai, x_true), dim=-1)
    norms = torch.linalg.vector_norm(x_true, dim=(1, 2), keepdim=True)
    xhat = x_true + 0.5 / math.sqrt(2 * N) * norms * torch.randn(
        (B, N, 2), generator=g, dtype=torch.float64)
    xhat = xhat / torch.linalg.vector_norm(xhat, dim=(1, 2), keepdim=True)
    return tuple(t.to(dtype) for t in (Ar, Ai, b, 0.1 * xhat, xhat))


def _problem(Ar, Ai, b, c, x0, i=0):
    return ftt.Problem(name="phase", op=ftt.PlanarDenseOp(Ar, Ai),
                       fterm=ftt.PlanarPhaseHinge(b[i]),
                       gterm=ftt.PlanarLinearAnchor(c[i]), x0=x0[i],
                       tau0=TAU0)


OPTS = ftt.FastaOptions(tol=1e-8, max_iters=400)


def test_instance_batch_indexes_its_leading_axis():
    Ar, Ai, b, c, x0 = _data()
    req = ftt.InstanceBatch(b, prox=c, x0=x0)
    assert len(req) == B and req.shape == b.shape
    one = req[2]
    assert torch.equal(one.data, b[2]) and torch.equal(one.prox, c[2])
    assert torch.equal(one.x0, x0[2])
    pool = ftt.InstanceBatch(torch.stack([b, b]), prox=torch.stack([c, c]),
                             x0=None)
    assert len(pool) == 2 and pool.shape[:2] == (2, B)
    assert len(pool[1]) == B and pool[1].x0 is None
    # lanes that disagree are refused where the lanes are made
    with pytest.raises(ValueError, match="disagree on the number of lanes"):
        _problem(*_data()).solve_serving(ftt.InstanceBatch(b, prox=c[:3]),
                                         options=OPTS)


def test_batch_solver_lanes_match_separate_solves():
    """Each lane of one request solves its own instance: the count, the
    stepsizes and the solution of a separate loop solve with that lane's
    magnitudes, anchor and start."""
    data = _data()
    Ar, Ai, b, c, x0 = data
    p = _problem(*data)
    assert ftt.recommend_path(p, B).path == "batch_solver"
    out = p.solve_serving(ftt.InstanceBatch(b, prox=c, x0=x0), options=OPTS)
    assert out.solution.shape == (B, N, 2) and out.converged.all()
    for i in range(B):
        one = ftt.solve(p.op, ftt.PlanarPhaseHinge(b[i]),
                        ftt.PlanarLinearAnchor(c[i]), x0[i], TAU0, OPTS)
        k = int(one.iteration_count)
        assert int(out.iteration_count[i]) == k
        np.testing.assert_allclose(np.asarray(out.taus[i])[:k],
                                   np.asarray(one.taus)[:k], rtol=1e-6)
        np.testing.assert_allclose(np.asarray(out.solution[i]),
                                   np.asarray(one.solution), atol=1e-8)


def test_batch_solver_matches_the_plain_reference():
    data = _data()
    Ar, Ai, b, c, x0 = data
    out = _problem(*data).solve_serving(ftt.InstanceBatch(b, prox=c, x0=x0),
                                        options=OPTS)
    cfg = dict(options=dict(tau0=TAU0, tol=1e-8, max_iters=400))
    r = ref.solve(Ar, Ai, b, c, x0, cfg)
    assert r.converged.all()
    np.testing.assert_array_equal(out.iteration_count, r.iterations.numpy())
    np.testing.assert_array_equal(out.total_backtracks, r.backtracks.numpy())
    x = torch.as_tensor(out.solution)
    np.testing.assert_allclose(x.numpy(), r.solution.numpy(), rtol=1e-9,
                               atol=1e-10)
    np.testing.assert_allclose(ref.objective(Ar, Ai, b, c, x).numpy(),
                               ref.objective(Ar, Ai, b, c, r.solution).numpy(),
                               rtol=1e-12)


def test_a_shared_anchor_solves_another_problem():
    """Without its own anchor and start every lane but the first solves
    the problem's instance 0's anchor: a different answer."""
    data = _data()
    Ar, Ai, b, c, x0 = data
    p = _problem(*data)
    own = p.solve_serving(ftt.InstanceBatch(b, prox=c, x0=x0), options=OPTS)
    shared = p.solve_serving(b, options=OPTS)
    np.testing.assert_allclose(np.asarray(shared.solution[0]),
                               np.asarray(own.solution[0]), atol=1e-8)
    for i in range(1, B):
        gap = torch.linalg.vector_norm(torch.as_tensor(
            shared.solution[i] - own.solution[i]))
        assert gap > 1e-2 * torch.linalg.vector_norm(
            torch.as_tensor(own.solution[i]))


def test_a_plain_request_is_an_instance_batch_of_data_alone():
    data = _data(torch.float32)
    p = _problem(*data)
    opts = ftt.FastaOptions(tol=1e-5, max_iters=300)
    plain = p.solve_serving(data[2], options=opts)
    batch = p.solve_serving(ftt.InstanceBatch(data[2]), options=opts)
    assert torch.equal(plain.solution, batch.solution)
    np.testing.assert_array_equal(plain.iteration_count,
                                  batch.iteration_count)


KW = dict(max_iters=300, tol=1e-5, record_bts=True, record_fvals=True)


def test_plain_kb8b_with_its_own_anchors_is_separate_microsolves():
    data = _data(torch.float32)
    Ar, Ai, b, c, x0 = data
    p = _problem(*data)
    out = p.microsolve_batch(b, x0s=x0, prox=c, **KW)
    for i in range(B):
        one = _problem(*data, i=i).microsolve(**KW)
        assert torch.equal(out.solutions[i], one.solution)
        assert int(out.iteration_counts[i]) == one.iteration_count
        np.testing.assert_array_equal(out.taus[i], one.taus)
        np.testing.assert_array_equal(out.backtracks[i], one.backtracks)
    # the route takes the request's anchors and starts
    plan = ServingPlan("microsolve_batch", "test", p, B)
    routed = plan.run(ftt.InstanceBatch(b, prox=c, x0=x0), **KW)
    assert torch.equal(routed.solutions, out.solutions)
    shared = p.microsolve_batch(b, x0s=x0, **KW)
    assert not torch.equal(shared.solutions[1:], out.solutions[1:])
    with pytest.raises(ValueError, match="prox shape"):
        p.microsolve_batch(b, prox=c[:, :8], **KW)


@pytest.mark.parametrize("path", ["microsolve", "loop"])
def test_a_single_route_takes_the_one_instance(path):
    data = _data(torch.float32)
    Ar, Ai, b, c, x0 = data
    req = ftt.InstanceBatch(b[2:3], prox=c[2:3], x0=x0[2:3])
    p = _problem(*data)
    kw = (dict(max_iters=300, tol=1e-5) if path == "microsolve"
          else dict(options=ftt.FastaOptions(tol=1e-5, max_iters=300)))
    out = ServingPlan(path, "test", p, 1).run(req, **kw)
    alone = ServingPlan(path, "test", _problem(*data, i=2), 1).run(None,
                                                                   **kw)
    assert torch.equal(torch.as_tensor(out.solution),
                       torch.as_tensor(alone.solution))


def test_kernels_without_per_instance_prox_data_refuse_it():
    from fasta_tpu_torch import problems
    lasso = problems.build("lasso", m=60, n=120, k=6, device="cpu")
    lasso.tau0 = 0.05
    bs = torch.stack([lasso.fterm.b] * 2)
    with pytest.raises(ValueError, match="K-B1b"):
        lasso.microsolve_batch(bs, prox=torch.tensor([0.1, 0.2]))
    tv = problems.build("tv", h=16, w=16, device="cpu")
    images = torch.stack([tv.fterm.b] * 2)
    plan = ServingPlan("microsolve_batch", "test", tv, 2)
    with pytest.raises(ValueError, match="K-B6b"):
        plan.run(ftt.InstanceBatch(images, prox=torch.ones(2)), max_iters=5)


def test_planar_products_are_spans_of_the_loop():
    """Under a profiler each lane product is one ``fasta.op.planar.*``
    span inside the loop's set-up or an iteration; the answers are the
    same bits with the profiler on and off."""
    data = _data(torch.float32)
    Ar, Ai, b, c, x0 = data
    p = _problem(*data)
    req = ftt.InstanceBatch(b, prox=c, x0=x0)
    opts = ftt.FastaOptions(tol=1e-5, max_iters=300)
    off = p.solve_serving(req, options=opts)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = p.solve_serving(req, options=opts)
    assert torch.equal(on.solution, off.solution)
    events = sorted(((e.name(), e.start_ns(), e.end_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith("fasta.")),
                    key=lambda s: (s[1], -s[2]))
    count = collections.Counter(n for n, _, _ in events)
    iters = int(max(on.iteration_count))
    # one forward a trial (and the start's), one adjoint an iteration
    assert count["fasta.op.planar.adjoint"] == iters + 1
    assert count["fasta.op.planar.forward"] >= iters + 1
    loop = [e for e in events if e[0] in ("fasta.loop.setup",
                                          "fasta.loop.iteration")]
    for name, s, e in events:
        if name.startswith("fasta.op.planar."):
            assert any(ls <= s and e <= le for _, ls, le in loop), name
