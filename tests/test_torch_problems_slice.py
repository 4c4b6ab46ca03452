"""The later example problems through the port's public entry points —
sparse LASSO, democratic representations, MMV and coded-diffraction
phase retrieval here; matrix completion, max-norm and NMF in
tests/test_torch_problems_slice_mc.py, which shares this file's checks —
held against the float64 oracle and ``fasta_tpu`` (CPU).

Bands: tests/parity/test_parity.py's CASES (sizes, τ₀, tol and
max_iters), float64 (complex128 for CDP): the first 10 taus and f-values
rtol 1e-7 (f atol 1e-12), residuals rtol 1e-6 / atol 1e-12, the final
objective within 1e-5 (democratic 1e-3: the L∞ prox's degenerate
vertices), the iteration count equal on max_norm and within
max(5, 20%) elsewhere.  The adaptive mode against ``fasta_tpu`` in the
same bands.  ``Problem.microsolve`` raises ``ValueError`` with the JAX
dispatch's reason (the same text where a dense kernel exists; the
reference's first clause, operator and loss named, where none does).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import problems as jax_problems
from fasta_tpu.micro import _dispatch as jax_dispatch
from fasta_tpu.serving import recommend_path as jax_recommend
from fasta_tpu_torch import problems
from fasta_tpu_torch.convert import problem_from_instance
from fasta_tpu_torch.harness import MODE_OPTIONS as MODES
from fasta_tpu_torch.kernels import lstsq_fused, prox_fused
from fasta_tpu_torch.micro import _dispatch
from fasta_tpu_torch.serving import recommend_path
from reference_oracle.fasta_numpy import fasta as fasta_np

torch.set_num_threads(1)

# name -> (builder kwargs, tau0, solver kwargs): tests/parity/test_parity.py
CASES = {
    "phase_retrieval_cdp": (dict(n=32, K=4), 1.0,
                            dict(tol=1e-8, max_iters=120)),
    "democratic": (dict(m=64, n=256), 0.05, dict(tol=1e-8, max_iters=120)),
    "mmv": (dict(m=80, n=160, l=4, k=10), 0.08,
            dict(tol=1e-8, max_iters=150)),
    "matrix_completion": (dict(d1=30, d2=30, rank=2), 1.0,
                          dict(tol=1e-7, max_iters=80)),
    "max_norm": (dict(d1=40, d2=8), 0.5, dict(tol=1e-9, max_iters=80)),
    "sparse_lasso": (dict(m=200, n=400, density=0.05, k=15), 0.05,
                     dict(tol=1e-9, max_iters=200)),
    "nmf": (dict(d1=30, d2=20, rank=3), 0.05,
            dict(tol=1e-8, max_iters=150)),
}

HERE = ["sparse_lasso", "democratic", "mmv", "phase_retrieval_cdp"]


def _dtypes(name):
    if name == "phase_retrieval_cdp":
        return torch.complex128, jnp.complex128
    return torch.float64, jnp.float64


def _build(name, **extra):
    dt, _ = _dtypes(name)
    kwargs, tau0, _ = CASES[name]
    p = problems.build(name, dtype=dt, device="cpu", **kwargs, **extra)
    p.tau0 = tau0
    return p


def _assert_parity(name, mode, r_t, r_ref):
    k = min(10, r_ref.iteration_count, r_t.iteration_count)
    np.testing.assert_allclose(r_t.taus[:k], r_ref.taus[:k], rtol=1e-7,
                               err_msg=f"{name}/{mode}: taus")
    np.testing.assert_allclose(r_t.residuals[:k], r_ref.residuals[:k],
                               rtol=1e-6, atol=1e-12,
                               err_msg=f"{name}/{mode}: residuals")
    np.testing.assert_allclose(r_t.fvals[:k], r_ref.fvals[:k], rtol=1e-7,
                               atol=1e-12, err_msg=f"{name}/{mode}: fvals")
    obj_tol = 1e-3 if name == "democratic" else 1e-5
    ref = np.asarray(r_ref.objectives)[r_ref.iteration_count - 1]
    got = r_t.objectives[-1]
    assert abs(got - ref) / max(abs(ref), 1e-10) < obj_tol, \
        f"{name}/{mode}: final objective {got} vs {ref}"
    drift = abs(r_t.iteration_count - int(r_ref.iteration_count))
    limit = 0 if name == "max_norm" else \
        max(5, int(0.2 * int(r_ref.iteration_count)))
    assert drift <= limit, f"{name}/{mode}: iterations {r_t.iteration_count}" \
        f" vs {r_ref.iteration_count}"


def check_oracle_parity(name, mode):
    p = _build(name)
    inst = p.instance
    _, tau0, skw = CASES[name]
    r_np = fasta_np(inst["op"], inst.get("op_t"), inst["f"], inst["gradf"],
                    inst["g"], inst["proxg"], inst["x0"], tau0=tau0,
                    record_objective=True, **skw, **MODES[mode])
    r_t = p.solve(record_objective=True, **skw, **MODES[mode])
    assert r_t.solution.shape == np.shape(inst["x0"])
    assert np.isfinite(r_t.objectives).all()
    _assert_parity(name, mode, r_t, r_np)


def check_jax_adaptive(name):
    """The adaptive mode against ``fasta_tpu``'s on the JAX module's
    problem, built from the same generator; the port's problem carried
    across from the JAX instance has the JAX problem's name."""
    kwargs, tau0, skw = CASES[name]
    dt_t, dt_j = _dtypes(name)
    pj = jax_problems.build(name, dtype=dt_j, **kwargs)
    pt = problem_from_instance(pj.instance, device="cpu", dtype=dt_t)
    assert pt.name == pj.name
    pj.tau0 = pt.tau0 = tau0
    r_j = pj.solve(record_objective=True, **skw)
    r_t = pt.solve(record_objective=True, **skw)
    _assert_parity(name, "adaptive", r_t, r_j)


def check_microsolve_raises(name):
    """``Problem.microsolve`` raises ``ValueError`` with the reference's
    reason, and the serving plan takes the loop (the reference's "xla")."""
    kwargs = CASES[name][0]
    pt = problems.build(name, device="cpu", **kwargs)
    pj = jax_problems.build(name, **kwargs)
    kind_j, why_j = jax_dispatch(pj)
    kind_t, why_t = _dispatch(pt)
    assert kind_j is None and kind_t is None
    # where no kernel exists the two messages share their first clause
    assert why_t.split(":")[0] == why_j.split(" (supported")[0].split(":")[0]
    with pytest.raises(ValueError, match="microsolve: "):
        pt.microsolve()
    with pytest.raises(ValueError, match="microsolve: "):
        pj.microsolve()
    plan = recommend_path(pt, 1)
    assert plan.path == "loop" and jax_recommend(pj, 1).path == "xla"
    r = pt.solve_serving(tau0=CASES[name][1], max_iters=5,
                        stop_rule="iterations")
    assert r.iteration_count == 5


def check_build_needs_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        problems.build(name, **CASES[name][0])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", HERE)
def test_modes_match_the_oracle(name, mode):
    check_oracle_parity(name, mode)


@pytest.mark.parametrize("name", HERE)
def test_adaptive_matches_fasta_tpu(name):
    check_jax_adaptive(name)


@pytest.mark.parametrize("name", HERE)
def test_microsolve_raises_as_the_reference_does(name):
    check_microsolve_raises(name)


@pytest.mark.parametrize("name", HERE)
def test_build_without_device_needs_a_card(name):
    check_build_needs_a_card(name)


def test_dense_kernel_reasons_are_the_references():
    """Democratic (L∞ prox) and MMV (a matrix of measurements) meet the
    dense kernel's gate and fail on its term checks, with the same text
    as the JAX dispatch."""
    for name in ("democratic", "mmv"):
        kwargs = CASES[name][0]
        why_t = _dispatch(problems.build(name, device="cpu", **kwargs))[1]
        why_j = jax_dispatch(jax_problems.build(name, **kwargs))[1]
        assert why_t == why_j


def test_float32_loop_paths_take_the_kernels_plain_versions(monkeypatch):
    """On the CPU, sparse LASSO's float32 loop takes K-B4's plain version
    on every trial and democratic's K-B3's, no launch counted; MMV's
    matrix of measurements takes the two-call path."""
    calls = {"b3": 0, "b4": 0}
    real_b3 = lstsq_fused.lstsq_gradmap_reference
    real_b4 = prox_fused.shrink_step_reference

    def b3(*a, **kw):
        calls["b3"] += 1
        return real_b3(*a, **kw)

    def b4(*a, **kw):
        calls["b4"] += 1
        return real_b4(*a, **kw)

    monkeypatch.setattr(lstsq_fused, "lstsq_gradmap_reference", b3)
    monkeypatch.setattr(prox_fused, "shrink_step_reference", b4)
    launches = (lstsq_fused.LAUNCHES, prox_fused.LAUNCHES)
    sl = problems.build("sparse_lasso", device="cpu", **CASES["sparse_lasso"][0])
    r = sl.solve(tau0=0.05, tol=1e-6, max_iters=300)
    assert r.converged and calls["b4"] >= r.iteration_count
    assert calls["b3"] == 0
    dem = problems.build("democratic", device="cpu", **CASES["democratic"][0])
    r = dem.solve(tau0=0.05, max_iters=20)
    assert calls["b3"] >= 20
    mmv = problems.build("mmv", device="cpu", **CASES["mmv"][0])
    assert mmv.fterm.fused_gradmap(mmv.op) is None
    assert (lstsq_fused.LAUNCHES, prox_fused.LAUNCHES) == launches
