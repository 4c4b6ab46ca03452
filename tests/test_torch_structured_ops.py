"""The port's structured operators — ``SparseOp``, ``IdentityOp``,
``FunctionOp``, ``MaskedFourierOp``, ``DiagonalOp``, ``ComposeOp``,
``StackedOp`` — and the five forms of ``as_linear_op``, held against
``fasta_tpu``'s on the same seeded float64 / complex128 inputs (CPU).

Tolerances: every product against the JAX operator's within 1e-12
(absolute, on entries of order one); ``check_adjoint`` within 1e-10;
``SparseOp`` against scipy's ``M @ x`` within 1e-12 (the sum order
differs from BCOO's and scipy's, so not bit-exact); a lane axis of
B = 3 against the per-lane products within 1e-13; the sparse solve
against the densified solve within 1e-6 of the objective and the first
20 taus within rtol 1e-9 (tests/unit/test_sparse_op.py's bands);
``fasta()`` through each form against the dense form as the test says.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import fasta_tpu as ft
import fasta_tpu_torch as ftt

torch.set_num_threads(1)

RNG = np.random.default_rng(4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _cplx(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _cdp_pair(n=16, K=3, seed=0):
    """The coded-diffraction stack of both packages over K random unit
    masks, complex128."""
    rng = np.random.default_rng(seed)
    masks = np.exp(2j * np.pi * rng.random((K, n)))
    ones = np.ones(n, np.complex128)
    op_j = ft.StackedOp([ft.ComposeOp(ft.MaskedFourierOp(jnp.asarray(ones)),
                                      ft.DiagonalOp(jnp.asarray(m)))
                         for m in masks])
    op_t = ftt.StackedOp([ftt.ComposeOp(ftt.MaskedFourierOp(_t(ones)),
                                        ftt.DiagonalOp(_t(m)))
                          for m in masks])
    return op_j, op_t


def _ops(name):
    """(JAX operator, port operator, x-like, y-like) of each structured
    operator, float64 or complex128."""
    rng = np.random.default_rng(7)
    if name == "sparse":
        M = sp.random(40, 24, density=0.2, format="csr", random_state=1)
        return (ft.SparseOp.from_scipy(M, dtype=jnp.float64),
                ftt.SparseOp.from_scipy(M, device="cpu"),
                rng.standard_normal(24), rng.standard_normal(40))
    if name == "sparse complex":
        M = (sp.random(30, 20, density=0.25, format="csr", random_state=2)
             + 1j * sp.random(30, 20, density=0.25, format="csr",
                              random_state=3)).tocsr()
        return (ft.SparseOp.from_scipy(M), ftt.SparseOp.from_scipy(
            M, device="cpu"), _cplx(rng, 20), _cplx(rng, 30))
    if name == "identity":
        return (ft.IdentityOp(), ftt.IdentityOp(), rng.standard_normal(9),
                rng.standard_normal(9))
    if name == "function":
        A = rng.standard_normal((12, 7))
        return (ft.FunctionOp(lambda x: A @ x, lambda y: A.T @ y),
                ftt.FunctionOp(lambda x: _t(A) @ x, lambda y: _t(A).T @ y),
                rng.standard_normal(7), rng.standard_normal(12))
    if name == "masked fourier":
        mask = (rng.random(16) < 0.6).astype(np.complex128)
        return (ft.MaskedFourierOp(jnp.asarray(mask)),
                ftt.MaskedFourierOp(_t(mask)), _cplx(rng, 16),
                _cplx(rng, 16))
    if name == "diagonal":
        d = _cplx(rng, 11)
        return (ft.DiagonalOp(jnp.asarray(d)), ftt.DiagonalOp(_t(d)),
                _cplx(rng, 11), _cplx(rng, 11))
    if name == "compose":
        A, B = rng.standard_normal((9, 6)), rng.standard_normal((6, 5))
        return (ft.ComposeOp(ft.DenseOp(jnp.asarray(A)),
                             ft.DenseOp(jnp.asarray(B))),
                ftt.ComposeOp(ftt.DenseOp(_t(A)), ftt.DenseOp(_t(B))),
                rng.standard_normal(5), rng.standard_normal(9))
    if name == "stacked":
        op_j, op_t = _cdp_pair()
        return op_j, op_t, _cplx(rng, 16), _cplx(rng, 3, 16)
    raise KeyError(name)


OPS = ["sparse", "sparse complex", "identity", "function", "masked fourier",
       "diagonal", "compose", "stacked"]


@pytest.mark.parametrize("name", OPS)
def test_operator_matches_jax_f64(name):
    op_j, op_t, x, y = _ops(name)
    _close(op_t(_t(x)).numpy(), op_j(jnp.asarray(x)))
    _close(op_t.rmatvec(_t(y)).numpy(), op_j.rmatvec(jnp.asarray(y)))
    # the adjoint as an operator swaps the two
    _close(op_t.H(_t(y)).numpy(), op_t.rmatvec(_t(y)).numpy(), atol=0)


@pytest.mark.parametrize("name", OPS)
def test_check_adjoint(name):
    _, op_t, x, _ = _ops(name)
    assert ftt.check_adjoint(op_t, _t(x), torch.Generator().manual_seed(0),
                             rtol=1e-10) <= 1e-10


@pytest.mark.parametrize("name", OPS)
def test_lanes_are_the_per_lane_products(name):
    """A lane axis of B = 3: ``lanes`` / ``rmatvec_lanes`` against one
    call per lane."""
    _, op_t, x, y = _ops(name)
    rng = np.random.default_rng(1)
    scale = rng.standard_normal(3)
    X = np.stack([x * s for s in scale])
    Y = np.stack([y * s + 0.5 for s in scale])
    got = op_t.lanes(_t(X))
    _close(got.numpy(), torch.stack([op_t(_t(v)) for v in X]).numpy(),
           atol=1e-13)
    got = op_t.rmatvec_lanes(_t(Y))
    _close(got.numpy(),
           torch.stack([op_t.rmatvec(_t(v)) for v in Y]).numpy(), atol=1e-13)


def test_sparse_op_against_scipy_products():
    """After tests/unit/test_sparse_op.py: M @ x and Mᵀ y, a right side of
    several columns, the shape, and the float32 form."""
    M = sp.random(40, 24, density=0.2, format="csr", random_state=1)
    op = ftt.SparseOp.from_scipy(M, device="cpu")
    x, y = RNG.standard_normal(24), RNG.standard_normal(40)
    _close(op(_t(x)).numpy(), M @ x)
    _close(op.rmatvec(_t(y)).numpy(), M.T @ y)
    X = RNG.standard_normal((24, 3))
    _close(op(_t(X)).numpy(), M @ X)
    assert op.shape == (40, 24)
    op32 = ftt.SparseOp.from_scipy(M, torch.float32, device="cpu")
    assert op32.M.dtype == torch.float32
    got = op32(_t(x).float())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), M @ x, rtol=1e-5, atol=1e-5)
    # a CSC matrix goes through its CSR form
    op_c = ftt.SparseOp.from_scipy(M.tocsc(), device="cpu")
    _close(op_c(_t(x)).numpy(), M @ x)


def test_sparse_op_default_device_is_the_card():
    M = sp.random(4, 3, density=0.5, format="csr", random_state=1)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ftt.SparseOp.from_scipy(M)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ftt.as_linear_op(M)


def test_sparse_solve_matches_dense():
    """tests/unit/test_sparse_op.py's solve: the sparse operator's solve
    against the densified one (overdetermined, a unique minimizer)."""
    M = sp.random(90, 60, density=0.15, format="csr", random_state=3)
    b = _t(RNG.standard_normal(90))
    opts = ftt.FastaOptions(tol=1e-8, max_iters=200, record_objective=True)
    r_sp = ftt.solve(ftt.SparseOp.from_scipy(M, device="cpu"),
                     ftt.LeastSquares(b), ftt.L1Norm(0.05),
                     torch.zeros(60, dtype=torch.float64), 0.1, opts)
    r_dn = ftt.solve(ftt.DenseOp(_t(M.toarray())), ftt.LeastSquares(b),
                     ftt.L1Norm(0.05), torch.zeros(60, dtype=torch.float64),
                     0.1, opts.replace(fuse=False))
    np.testing.assert_allclose(r_sp.taus[:20].numpy(),
                               r_dn.taus[:20].numpy(), rtol=1e-9)
    obj_sp = float(r_sp.objectives[r_sp.iteration_count - 1])
    obj_dn = float(r_dn.objectives[r_dn.iteration_count - 1])
    assert abs(obj_sp - obj_dn) < 1e-6 * abs(obj_dn)


class _Frame:
    """A scipy-LinearOperator-like object: ``matvec``, ``rmatvec`` and
    ``shape`` over NumPy arrays, counting its calls."""

    def __init__(self, A):
        self.A, self.shape, self.calls = A, A.shape, 0

    def matvec(self, v):
        self.calls += 1
        return self.A @ v

    def rmatvec(self, v):
        self.calls += 1
        return self.A.T @ v


def _forms():
    """Each of the reference's five operator forms, given alike to both
    packages: (form, argument for the port, argument for JAX, At)."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((15, 8))
    M = sp.random(15, 8, density=0.3, format="csr", random_state=5)
    A_t = _t(A)
    return {
        "none": (None, None, None),
        "matrix": (A, A, None),
        "scipy sparse": (M, M, None),
        "linear operator": (spla.aslinearoperator(A),
                            spla.aslinearoperator(A), None),
        "closure pair": ((lambda x: A_t @ x), (lambda x: jnp.asarray(A) @ x),
                         ((lambda y: A_t.T @ y),
                          (lambda y: jnp.asarray(A).T @ y))),
    }


@pytest.mark.parametrize("form", list(_forms()))
def test_as_linear_op_forms_match_jax(form):
    """Each form gives the JAX operator's class and products within
    1e-12 in float64 (the host round trip of the ``matvec`` form keeps
    the tensor's dtype and device)."""
    arg_t, arg_j, At = _forms()[form]
    At_t, At_j = At if At is not None else (None, None)
    op_t = ftt.as_linear_op(arg_t, At_t, device="cpu")
    op_j = ft.as_linear_op(arg_j, At_j)
    assert type(op_t).__name__ == type(op_j).__name__
    n = 9 if form == "none" else 8
    m = 9 if form == "none" else 15
    rng = np.random.default_rng(11)
    x, y = rng.standard_normal(n), rng.standard_normal(m)
    d_j, g_j = op_j(jnp.asarray(x)), op_j.rmatvec(jnp.asarray(y))
    d_t, g_t = op_t(_t(x)), op_t.rmatvec(_t(y))
    assert d_t.dtype == torch.float64 and d_t.device.type == "cpu"
    _close(d_t.numpy(), d_j)
    _close(g_t.numpy(), g_j)


def test_as_linear_op_rejects_what_it_does_not_take():
    A = np.ones((3, 2))
    with pytest.raises(ValueError, match="adjoint"):
        ftt.as_linear_op(A, A.T, device="cpu")
    with pytest.raises(ValueError, match="At must be"):
        ftt.as_linear_op(lambda x: x)
    with pytest.raises(TypeError, match="unsupported operator"):
        ftt.as_linear_op("A")
    frame = _Frame(A)
    op = ftt.as_linear_op(frame, device="cpu")
    op(torch.ones(2, dtype=torch.float64))
    op.rmatvec(torch.ones(3, dtype=torch.float64))
    assert isinstance(op, ftt.FunctionOp) and frame.calls == 2


@pytest.mark.parametrize("form", ["matrix", "scipy sparse",
                                  "linear operator", "closure pair"])
def test_fasta_through_each_form_matches_the_dense_solve(form):
    """``fasta()`` through each form of the same matrix (an overdetermined
    LASSO, a unique minimizer) gives the dense form's trajectory: equal
    counts, the first 20 taus rtol 1e-9, the residuals rtol 1e-6 / atol
    1e-12 and the solution atol 1e-8 (the BB ratios near convergence
    amplify the products' other summation order)."""
    rng = np.random.default_rng(2)
    A = rng.standard_normal((30, 20)) / np.sqrt(30)
    b = rng.standard_normal(30)
    arg = {"matrix": A, "scipy sparse": sp.csr_matrix(A),
           "linear operator": spla.aslinearoperator(A),
           "closure pair": (lambda x: _t(A) @ x)}[form]
    At = (lambda y: _t(A).T @ y) if form == "closure pair" else None
    kw = dict(tau0=0.1, tol=1e-8, max_iters=150, device="cpu")
    ref = ftt.fasta(A, None, ftt.LeastSquares(_t(b)), None,
                    ftt.L1Norm(0.1), None, np.zeros(20), **kw)
    r = ftt.fasta(arg, At, ftt.LeastSquares(_t(b)), None, ftt.L1Norm(0.1),
                  None, np.zeros(20), **kw)
    assert r.converged and r.iteration_count == ref.iteration_count
    np.testing.assert_allclose(r.taus[:20], ref.taus[:20], rtol=1e-9)
    np.testing.assert_allclose(r.residuals, ref.residuals, rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(r.solution, ref.solution, atol=1e-8)
