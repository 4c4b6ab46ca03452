"""The plain reference against the program's plain CPU solve at a tiny
size, in float64: the same iterations, backtracks and answers."""

import numpy as np
import torch

import fasta_tpu_torch as ftt
from portbench import harness
from portbench.reference import lasso, tv_denoise


def test_lasso_reference_follows_the_program(cells):
    cell = cells["lasso-1000x2000.batch16384"]
    gen = torch.Generator().manual_seed(3)
    data = harness.kind(cell.cfg).make_inputs(cell.cfg, cell.traffic, gen,
                                              "cpu")
    A, b = data["A"].double(), data["pool"][0, :4].double()
    n, mu, tau0 = cell.cfg["n"], cell.cfg["mu"], 0.05
    cfg = dict(mu=mu, options=dict(tau0=tau0, tol=1e-8, max_iters=500))
    ref = lasso.solve(A, b, cfg)
    for i in range(4):
        out = ftt.fasta(ftt.DenseOp(A), None, ftt.LeastSquares(b[i]), None,
                        ftt.L1Norm(mu), None,
                        torch.zeros(n, dtype=torch.float64),
                        options=ftt.FastaOptions(tol=1e-8, max_iters=500),
                        tau0=tau0)
        assert out.iteration_count == int(ref.iterations[i])
        assert out.total_backtracks == int(ref.backtracks[i])
        assert bool(ref.converged[i]) and out.converged
        np.testing.assert_allclose(out.solution, ref.solution[i].numpy(),
                                   rtol=1e-9, atol=1e-12)


def test_tv_reference_follows_the_program():
    gen = torch.Generator().manual_seed(4)
    b = torch.rand((2, 16, 16), generator=gen, dtype=torch.float64)
    mu, tau0 = 0.1, 2.0
    cfg = dict(mu=mu, options=dict(tau0=tau0, tol=1e-6, max_iters=3000))
    ref = tv_denoise.solve(b, cfg)
    for i in range(2):
        out = ftt.fasta(ftt.ScaledOp(mu, ftt.TVDiv2D()), None,
                        ftt.LeastSquares(b[i]), None,
                        ftt.BoxIndicator(-1.0, 1.0), None,
                        torch.zeros((2, 16, 16), dtype=torch.float64),
                        options=ftt.FastaOptions(tol=1e-6, max_iters=3000),
                        tau0=tau0)
        assert out.iteration_count == int(ref.iterations[i])
        np.testing.assert_allclose(out.solution, ref.solution[i].numpy(),
                                   rtol=1e-8, atol=1e-10)


def test_tv_stencils_are_adjoint():
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((3, 7, 9), generator=gen, dtype=torch.float64)
    p = torch.randn((3, 2, 7, 9), generator=gen, dtype=torch.float64)
    lhs = (tv_denoise.grad(x) * p).sum()
    rhs = (x * tv_denoise.div(p)).sum()
    assert torch.allclose(lhs, rhs, rtol=1e-12)
    np.testing.assert_allclose(
        tv_denoise.div(p)[0].numpy(),
        ftt.TVDiv2D()(p[0]).numpy(), rtol=1e-12, atol=1e-12)
