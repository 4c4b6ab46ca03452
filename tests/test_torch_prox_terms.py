"""The port's prox library and the terms of the seven later problems —
``LinfNorm``, ``L21Norm``, ``NuclearNorm``, ``LinfBallIndicator``,
``MaxRowNormBall``, ``ZeroTerm``, ``MaskedLogistic``, ``NMFLoss`` — held
against ``fasta_tpu``'s on the same seeded inputs (CPU).

Tolerances: in float64 (complex128) every prox, value and gradient
against the JAX function's within 1e-12 (absolute, entries of order
one) or rel 1e-12 for values; the L1-ball projection's vertex on ties
and the identity inside the ball exactly as the JAX function and the
NumPy oracle give them (within 1e-15); the float64 value of float32
data against the JAX double-word value (hi + lo) within rel 1e-6, the
float32 elementwise functions of the two libraries differing by an ulp;
lanes at B = 3 against one call per lane within 1e-13.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fasta_tpu as ft
import fasta_tpu.prox as jprox
import fasta_tpu_torch as ftt
import fasta_tpu_torch.prox as tprox
from reference_oracle import generators as gen

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _vec(seed=0, n=13, complex_=False):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(n)
    return z + 1j * rng.standard_normal(n) if complex_ else z


def _mat(seed=0, shape=(9, 6)):
    return np.random.default_rng(seed).standard_normal(shape)


# name -> (port call, JAX call, inputs)
PROX = {
    "prox_l1": (lambda z: tprox.prox_l1(z, 0.3, 0.7),
                lambda z: jprox.prox_l1(z, 0.3, 0.7), [_vec(), _vec(1, complex_=True)]),
    "project_linf_ball": (lambda z: tprox.project_linf_ball(z, 0.8),
                          lambda z: jprox.project_linf_ball(z, 0.8),
                          [_vec(), _vec(1, complex_=True)]),
    "project_l1_ball": (lambda z: tprox.project_l1_ball(z, 1.5),
                        lambda z: jprox.project_l1_ball(z, 1.5),
                        [_vec(), _vec(1, complex_=True), _mat(2)]),
    "prox_linf": (lambda z: tprox.prox_linf(z, 0.4),
                  lambda z: jprox.prox_linf(z, 0.4),
                  [_vec(), _vec(1, complex_=True), _mat(3)]),
    "svt": (lambda z: tprox.svt(z, 0.9), lambda z: jprox.svt(z, 0.9),
            [_mat(), _mat(4, (5, 8))]),
    "shrink_rows": (lambda z: tprox.shrink_rows(z, 0.6),
                    lambda z: jprox.shrink_rows(z, 0.6),
                    [_mat(), _vec(5), _mat(6) + 1j * _mat(7)]),
    "prox_linear": (lambda z: tprox.prox_linear(z, 0.2, _t(_vec(8))),
                    lambda z: jprox.prox_linear(z, 0.2, jnp.asarray(_vec(8))),
                    [_vec()]),
    "prox_zero": (lambda z: tprox.prox_zero(z, 0.2),
                  lambda z: jprox.prox_zero(z, 0.2), [_vec(), _mat()]),
}


@pytest.mark.parametrize("name", list(PROX))
def test_prox_matches_jax_f64(name):
    port, jax_fn, inputs = PROX[name]
    for z in inputs:
        got = port(_t(z))
        assert got.dtype == _t(z).dtype
        _close(got.numpy(), jax_fn(jnp.asarray(z)))


@pytest.mark.parametrize("radius", [0.5, 2.0, 6.0])
def test_l1_ball_ties_land_on_the_jax_vertex(radius):
    """Equal magnitudes at the top and at the threshold: the projection is
    the JAX function's and the oracle's, vertex for vertex."""
    z = np.array([3.0, -3.0, 3.0, 1.0, -1.0, 1.0, 0.0, 0.5])
    got = tprox.project_l1_ball(_t(z), radius).numpy()
    _close(got, jprox.project_l1_ball(jnp.asarray(z), radius), atol=1e-15)
    _close(got, gen.project_l1_ball(z, radius), atol=1e-15)
    assert np.sum(np.abs(got)) == pytest.approx(radius, rel=1e-12)


def test_l1_ball_inside_passes_through_and_linf_guard():
    z = np.array([0.1, -0.2, 0.05, 0.0])
    assert torch.equal(tprox.project_l1_ball(_t(z), 1.0), _t(z))
    zc = _vec(3, 6, complex_=True) * 0.01
    assert torch.equal(tprox.project_l1_ball(_t(zc), 1.0), _t(zc))
    # t <= 0: the identity, not the NaN of z/0 (a μ = 0 sweep point)
    for t in (0.0, -1.0):
        assert torch.equal(tprox.prox_linf(_t(_vec()), t), _t(_vec()))


def test_lanes_prox_never_mixes_lanes():
    """The lane forms against one call per lane, each lane with its own
    radius or t (B = 3)."""
    Z = np.stack([_vec(s) * (s + 1) for s in range(3)])
    r = torch.tensor([0.5, 2.0, 100.0], dtype=torch.float64)
    got = tprox.project_l1_ball_lanes(_t(Z), r)
    want = torch.stack([tprox.project_l1_ball(_t(z), float(ri))
                        for z, ri in zip(Z, r)])
    _close(got.numpy(), want.numpy(), atol=1e-13)
    assert torch.equal(got[2], _t(Z[2]))            # inside its own ball
    t = torch.tensor([0.0, 0.3, 1.2], dtype=torch.float64)
    got = tprox.prox_linf_lanes(_t(Z), t)
    want = torch.stack([tprox.prox_linf(_t(z), float(ti))
                        for z, ti in zip(Z, t)])
    _close(got.numpy(), want.numpy(), atol=1e-13)


def _obs(seed=0, shape=(7, 5)):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) < 0.5).astype(np.float64),
            (rng.random(shape) < 0.6).astype(np.float64))


# name -> (port term, JAX term, the variable's shape)
def _prox_terms():
    return {
        "LinfNorm": (ftt.LinfNorm(0.7), ft.LinfNorm(0.7), (13,)),
        "L21Norm": (ftt.L21Norm(0.4), ft.L21Norm(0.4), (9, 4)),
        "NuclearNorm": (ftt.NuclearNorm(1.3), ft.NuclearNorm(1.3), (8, 6)),
        "LinfBallIndicator": (ftt.LinfBallIndicator(0.5),
                              ft.LinfBallIndicator(0.5), (11,)),
        "MaxRowNormBall": (ftt.MaxRowNormBall(0.9), ft.MaxRowNormBall(0.9),
                           (10, 3)),
        "ZeroTerm": (ftt.ZeroTerm(), ft.ZeroTerm(), (6,)),
    }


@pytest.mark.parametrize("name", list(_prox_terms()))
def test_prox_term_matches_jax_f64(name):
    term_t, term_j, shape = _prox_terms()[name]
    x = _mat(1, shape) if len(shape) == 2 else _vec(1, shape[0])
    assert float(term_t.value(_t(x))) == pytest.approx(
        float(term_j.value(jnp.asarray(x))), rel=1e-12, abs=1e-15)
    for t in (0.05, 0.8):
        _close(term_t.prox(_t(x), t).numpy(), term_j.prox(jnp.asarray(x), t))


@pytest.mark.parametrize("name", list(_prox_terms()))
def test_prox_term_lanes(name):
    """value_lanes and prox_lanes at B = 3, one stepsize a lane, against
    per-lane calls; a lane weight (the batch solver's sweep) where the
    term has one."""
    term, _, shape = _prox_terms()[name]
    X = np.stack([_mat(s, shape) if len(shape) == 2 else _vec(s, shape[0])
                  for s in range(3)])
    t = torch.tensor([0.05, 0.3, 0.9], dtype=torch.float64)
    _close(term.value_lanes(_t(X)).numpy(),
           torch.stack([term.value(_t(x)) for x in X]).numpy(), atol=1e-13)
    _close(term.prox_lanes(_t(X), t).numpy(),
           torch.stack([term.prox(_t(x), float(ti))
                        for x, ti in zip(X, t)]).numpy(), atol=1e-13)
    if term.lane_field == "mu":
        mus = torch.tensor([0.1, 0.5, 2.0], dtype=torch.float64)
        swept = type(term)(mus)
        _close(swept.prox_lanes(_t(X), t).numpy(),
               torch.stack([type(term)(float(m)).prox(_t(x), float(ti))
                            for x, ti, m in zip(X, t, mus)]).numpy(),
               atol=1e-13)
        _close(swept.value_lanes(_t(X)).numpy(),
               torch.stack([type(term)(float(m)).value(_t(x))
                            for x, m in zip(X, mus)]).numpy(), atol=1e-13)


def test_complex_linf_ball_indicator_keeps_phases():
    z = _vec(2, 9, complex_=True)
    got = ftt.LinfBallIndicator(0.5).prox(_t(z), 1.0).numpy()
    _close(got, ft.LinfBallIndicator(0.5).prox(jnp.asarray(z), 1.0))
    assert np.max(np.abs(got)) <= 0.5 + 1e-15


def _smooth_terms(dtype=np.float64):
    Y, mask = _obs()
    W = np.abs(_mat(5, (7 + 4, 3)))
    return {
        "MaskedLogistic": (
            ftt.MaskedLogistic(_t(Y.astype(dtype)), _t(mask.astype(dtype))),
            ft.MaskedLogistic(jnp.asarray(Y, dtype), jnp.asarray(mask, dtype)),
            3.0 * _mat(8, (7, 5))),
        "NMFLoss": (ftt.NMFLoss(_t(_mat(9, (7, 4)).astype(dtype))),
                    ft.NMFLoss(jnp.asarray(_mat(9, (7, 4)), dtype)), W),
    }


@pytest.mark.parametrize("name", ["MaskedLogistic", "NMFLoss"])
def test_smooth_term_matches_jax_f64(name):
    term_t, term_j, d = _smooth_terms()[name]
    v_j = float(term_j.value(jnp.asarray(d)))
    assert float(term_t.value(_t(d))) == pytest.approx(v_j, rel=1e-12)
    v64 = term_t.value_f64(_t(d))
    assert v64.dtype == torch.float64
    assert float(v64) == pytest.approx(v_j, rel=1e-12)
    _close(term_t.grad(_t(d)).numpy(), term_j.grad(jnp.asarray(d)))
    assert not term_t.grad_affine
    assert term_t.fused_gradmap(ftt.IdentityOp()) is None


@pytest.mark.parametrize("name", ["MaskedLogistic", "NMFLoss"])
def test_smooth_term_f64_value_of_float32_data(name):
    """The float64 decision value of float32 data against the JAX
    double-word value (hi + lo)."""
    term_t, term_j, d = _smooth_terms(np.float32)[name]
    d32 = d.astype(np.float32)
    v64 = term_t.value_f64(_t(d32))
    assert v64.dtype == torch.float64
    hi, lo = term_j.value_dd(jnp.asarray(d32))
    assert float(v64) == pytest.approx(float(hi) + float(lo), rel=1e-6)


@pytest.mark.parametrize("name", ["MaskedLogistic", "NMFLoss"])
def test_smooth_term_lanes(name):
    term, _, d = _smooth_terms()[name]
    D = np.stack([d * s for s in (1.0, -0.5, 2.0)])
    _close(term.value_lanes(_t(D)).numpy(),
           torch.stack([term.value(_t(x)) for x in D]).numpy(), atol=1e-12)
    _close(term.value_f64_lanes(_t(D)).numpy(),
           torch.stack([term.value_f64(_t(x)) for x in D]).numpy(),
           atol=1e-12)
    _close(term.grad_lanes(_t(D)).numpy(),
           torch.stack([term.grad(_t(x)) for x in D]).numpy(), atol=1e-13)


def test_as_prox_term_none_is_the_zero_term():
    zero = ftt.as_prox_term(None, None)
    assert isinstance(zero, ftt.ZeroTerm)
    assert isinstance(ft.as_prox_term(None, None), ft.ZeroTerm)
    x = _t(_vec())
    assert float(zero.value(x)) == 0.0 and torch.equal(zero.prox(x, 0.3), x)
    fp = ftt.as_prox_term(None, lambda z, t: 2 * z)
    assert isinstance(fp, ftt.FunctionProx)
