"""The probes K-P1, K-P2 and K-P3: the port's plain versions against the
TPU probes run on the CPU as the probes themselves run there; and what
the K-P3 and K-P4 kernels refuse, before anything reaches the card.

* K-P3 (``benchmarks/micro_tail_probe.py``) through ``make(...,
  interpret=True)`` at its ``--check`` shape (M, N, K = 128, 256, 3).  Its
  output is x; its records stay in the kernel's scratch, so τ, the
  residuals and g are held against a NumPy float32 transcription of the
  body ``kern`` (:291-397).
* K-P1 and K-P2 (``benchmarks/matvec_kernels.py``) inside
  ``force_tpu_interpret_mode()``; the last operation's result is held
  against the JAX formulas (``Precision.HIGHEST``) at the x the JAX kernel
  reaches one operation earlier.

Tolerances: x exactly (it is x₀ plus updates far below most entries'
spacing, and the same float32 operations); results within rtol 1e-5 of
their largest entry, and f within rtol 1e-5 — float32 sums taken in
another order.
"""

import contextlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fasta_tpu_torch.kernels import bf16_probe, matvec_probe, tail_probe

torch.set_num_threads(1)

HIGHEST = jax.lax.Precision.HIGHEST
# the probe variants' keyword arguments in the TPU module (cumulative)
# and in the port (one flag over L6)
TAIL_VARIANTS = [(f"L{i}", dict(level=i), dict(level=i)) for i in range(7)] + [
    ("X1", dict(level=6, col=True), dict(level=6, col=True)),
    ("X2", dict(level=6, col=True, thread=True), dict(level=6, thread=True)),
    ("X3", dict(level=6, vecscal=True), dict(level=6, vecscal=True)),
    ("X4", dict(level=6, vecscal=True, fusedred=True),
     dict(level=6, fusedred=True)),
    ("X5", dict(level=6, vecscal=True, fusedred=True, condbt=True),
     dict(level=6, condbt=True)),
]


@pytest.fixture(scope="module")
def probes():
    """The two TPU probe modules; both set the JAX compilation cache when
    imported, which is put back afterwards."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        import benchmarks.matvec_kernels as mk
        import benchmarks.micro_tail_probe as mtp
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mk, mtp


@contextlib.contextmanager
def _x32():
    """The suite runs JAX with 64-bit types; the tail probe's record index
    needs the 32-bit loop counter it was written for."""
    saved = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", saved)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


# --------------------------------------------------------------------------
# K-P3: the tail-ablation ladder
# --------------------------------------------------------------------------

def _tail_numpy(A, b, x0, K, level):
    """The body of micro_tail_probe.py's ``kern`` in NumPy float32, with
    the records it keeps in scratch: (x, g, τ, taus, residuals, trials)."""
    f = np.float32
    A, b, x0 = A.astype(f), b.astype(f), x0.astype(f)

    def fb(xc, g, t):
        x1hat = xc - t * g
        if level >= 1:
            mag = np.abs(x1hat)
            x1 = x1hat * (np.maximum(mag - t * f(tail_probe.MU), f(0))
                          / np.maximum(mag, f(1e-30)))
        else:
            x1 = xc
        r = (A @ x1).astype(f) - b
        return (x1hat, x1, x1 - xc, f(0.5) * np.sum(r * r, dtype=f),
                (A.T @ r).astype(f))

    r0 = (A @ x0).astype(f) - b
    g = (A.T @ r0).astype(f)
    fwin = np.full(tail_probe.WINDOW, -np.inf, f)
    fwin[0] = f(0.5) * np.sum(r0 * r0, dtype=f)
    tau, maxres = f(tail_probe.TAU0), f(-np.inf)
    taus = np.zeros(tail_probe.RECORDS, f)
    res_rec = np.zeros(tail_probe.RECORDS, f)
    x, trials = x0, 0
    for k in range(K):
        xc = x
        if level >= 2:
            M = np.max(fwin) if level >= 3 else f(np.inf)
            cnt = 0
            while True:
                trials += 1
                x1hat, x1, dx, f1, g1 = fb(xc, g, tau)
                nd2, rdg = np.sum(dx * dx, dtype=f), np.sum(dx * g, dtype=f)
                if f1 - f(1e-12) > M + rdg + nd2 / (f(2) * tau) and \
                        cnt < tail_probe.MAX_BACKTRACKS:
                    tau, cnt = tau * f(tail_probe.SHRINK), cnt + 1
                else:
                    break
        else:
            trials += 1
            x1hat, x1, dx, f1, g1 = fb(xc, g, tau)
        if level >= 3:
            fwin[(k + 1) % tail_probe.WINDOW] = f1
        res, tau_n, stop = f1, tau, False
        if level >= 4:
            nd2 = np.sum(dx * dx, dtype=f)
            res = np.sqrt(nd2) / tau
            maxres = np.maximum(maxres, res)
            sm = x1 - x1hat
            nrm = np.maximum(np.sqrt(np.sum(g * g, dtype=f)),
                             np.sqrt(np.sum(sm * sm, dtype=f)) / tau) + f(1e-8)
            stop = bool(res / (maxres + f(1e-8)) < -1) or bool(res / nrm < -1)
        if level >= 5:
            dg = g1 + (x1hat - xc) / tau
            dot, ndg2 = np.sum(dx * dg, dtype=f), np.sum(dg * dg, dtype=f)
            tau_s = nd2 / dot if dot != 0 else f(np.inf)
            tau_m = max(dot / ndg2 if ndg2 > 0 else f(0), f(0))
            tau_n = tau_m if f(2) * tau_m > tau_s else tau_s - f(0.5) * tau_m
            if not (tau_n > 0 and np.isfinite(tau_n)):
                tau_n = tau * f(1.5)
        if level >= 6 and k < tail_probe.RECORDS:
            taus[k], res_rec[k] = tau, res
        x = x0 + f(0) * x1 + f(0) * f(stop)
        g, tau = g1, f(tau_n)
    return x + f(0) * g, g, tau, taus, res_rec, trials


def _tail_data(m=128, n=256):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((m, n)).astype(np.float32),
            rng.standard_normal(m).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


@pytest.mark.parametrize("name,jax_kw,port_kw", TAIL_VARIANTS,
                         ids=[v[0] for v in TAIL_VARIANTS])
def test_tail_plain_version_matches_tpu_probe_interpret(probes, monkeypatch,
                                                        name, jax_kw,
                                                        port_kw):
    _, mtp = probes
    monkeypatch.setattr(mtp, "M", 128)
    monkeypatch.setattr(mtp, "N", 256)
    monkeypatch.setattr(mtp, "K", 3)
    A, b, x0 = _tail_data()
    with _x32():
        x_jax = np.asarray(mtp.make(interpret=True, **jax_kw)(
            jnp.asarray(A), jnp.asarray(b), jnp.asarray(x0[None, :])))[0]
    before = tail_probe.LAUNCHES
    out = tail_probe.make(**port_kw)(torch.from_numpy(A), torch.from_numpy(b),
                                     torch.from_numpy(x0), 3)
    assert tail_probe.LAUNCHES == before
    np.testing.assert_array_equal(out.x.numpy(), x_jax)
    x_np, g_np, tau_np, taus_np, res_np, trials_np = _tail_numpy(
        A, b, x0, 3, port_kw["level"])
    np.testing.assert_array_equal(x_np, x_jax)
    _close(out.g.numpy(), g_np)
    assert float(out.tau) == pytest.approx(float(tau_np), rel=1e-5)
    _close(out.taus.numpy(), taus_np)
    _close(out.residuals.numpy(), res_np)
    assert int(out.trials) == trials_np
    if port_kw["level"] == 6:
        assert np.all(taus_np[:3] > 0) and np.all(taus_np[3:] == 0)
    else:
        assert not out.taus.any() and not out.residuals.any()


def test_tail_ladder_backtracks_and_stays_finite():
    """At 64×128 L6 backtracks within 6 iterations (9 trials) with its
    records equal to the NumPy body's; the probe's trajectory is chaotic
    (x restarts at x₀, BB swings τ), and a change of summation order parts
    the two after about 9 iterations, so 40 iterations are held to finite
    values only.  L2, whose test has no window, never backtracks."""
    A, b, x0 = _tail_data(64, 128)
    t = [torch.from_numpy(v) for v in (A, b, x0)]
    out = tail_probe.make(6)(*t, 6)
    _, g_np, _, taus_np, res_np, trials_np = _tail_numpy(A, b, x0, 6, 6)
    assert int(out.trials) == trials_np > 6
    _close(out.taus.numpy(), taus_np)
    _close(out.residuals.numpy(), res_np)
    _close(out.g.numpy(), g_np)
    out = tail_probe.make(6)(*t, 40)
    assert all(bool(torch.isfinite(v).all()) for v in out[:5])
    assert int(tail_probe.make(2)(*t, 40).trials) == 40


def test_tail_wrapper_checks():
    A, b, x0 = torch.zeros((4, 8)), torch.zeros(4), torch.zeros(8)
    with pytest.raises(ValueError, match="x0 \\(n,\\)"):
        tail_probe.make(6)(A, b, torch.zeros(4), 2)
    with pytest.raises(ValueError, match="K >= 1"):
        tail_probe.make(6)(A, b, x0, 0)
    with pytest.raises(ValueError, match="device"):
        tail_probe.make(6)(A.to("meta"), b.to("meta"), x0.to("meta"), 2)
    with pytest.raises(ValueError, match="level"):
        tail_probe.make(7)
    with pytest.raises(ValueError, match="one flag"):
        tail_probe.make(6, col=True, thread=True)
    with pytest.raises(ValueError, match="one flag"):
        tail_probe.make(5, condbt=True)


def _tail_call(m, n, dtype=torch.float32, plan=None):
    A, b, x0 = torch.zeros((m, n), dtype=dtype), torch.zeros(m, dtype=dtype), \
        torch.zeros(n, dtype=dtype)
    return lambda: tail_probe._launch(6, 0, A, b, x0, 2, plan)


def _bf16_call(m, n, dtype, plan=None):
    A, x0 = torch.zeros((m, n), dtype=dtype), torch.zeros(n)
    return lambda: bf16_probe._launch(A, x0, 2, plan)


@pytest.mark.parametrize("what,call,match", [
    ("tail past 8192 columns", _tail_call(4, 8196), "8192"),
    ("tail n % 4", _tail_call(4, 130), "n % 4"),
    ("tail float64", _tail_call(4, 16, torch.float64), "float32"),
    ("tail another shape's plan",
     _tail_call(4, 16, plan=tail_probe.tail_plan(8, 16, 132, 0)),
     "plan is for"),
    ("bf16 probe past 8192 columns, float32",
     _bf16_call(4, 8193, torch.float32), "8192"),
    ("bf16 probe past 8192 columns, bfloat16",
     _bf16_call(4, 8200, torch.bfloat16), "8192"),
    ("bf16 probe float16", _bf16_call(4, 8, torch.float16), "bfloat16"),
    ("bf16 probe the float32 plan for bfloat16 rows",
     _bf16_call(4, 2000, torch.bfloat16,
                bf16_probe.bf16_probe_plan(4, 2000, False, 132, 0)),
     "plan is for")])
def test_probe_kernel_launches_refuse_before_the_card(what, call, match):
    """What the K-P3 and K-P4 kernels do not take — more than 8192
    columns (every block keeps the n-sized state or its share of g),
    another storage type, a plan for another shape or storage — raises
    before anything reaches the card."""
    with pytest.raises(ValueError, match=match):
        call()


# --------------------------------------------------------------------------
# K-P1 and K-P2: the GEMV formulations and the one-pass gradient map
# --------------------------------------------------------------------------

def _matvec_data(m=64, n=256):
    rng = np.random.default_rng(0)
    return ((rng.standard_normal((m, n)) / 40).astype(np.float32),
            rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(m).astype(np.float32))


def _formula(variant, A, x, b):
    """The last operation's result at x by the JAX formulas."""
    A, x, b = jnp.asarray(A), jnp.asarray(x), jnp.asarray(b)
    if variant.startswith("fwd"):
        d = jnp.dot(A, x, precision=HIGHEST)
        return jnp.sum(d) if variant.startswith("fwd_strip") else d
    if variant == "gradmap_fused":
        r = jnp.dot(A, x, precision=HIGHEST) - b
        return 0.5 * jnp.dot(r, r, precision=HIGHEST), \
            jnp.dot(A.T, r, precision=HIGHEST)
    return jnp.dot(A.T, jnp.full(A.shape[0], x[0]), precision=HIGHEST)


@pytest.mark.parametrize("variant", matvec_probe.VARIANTS)
def test_matvec_plain_version_matches_tpu_probe_interpret(probes, variant):
    mk, _ = probes
    A, x0, b = _matvec_data()
    K = 3
    with pltpu.force_tpu_interpret_mode():
        xs = [np.asarray(mk.run_variant(
            jnp.asarray(A), jnp.asarray(x0[None, :]),
            jnp.asarray(b[:, None]), variant, k))[0] for k in (K - 1, K)]
    before = matvec_probe.LAUNCHES
    x, res = matvec_probe.run_variant(torch.from_numpy(A),
                                      torch.from_numpy(x0),
                                      torch.from_numpy(b), variant, K)
    assert matvec_probe.LAUNCHES == before
    np.testing.assert_array_equal(x.numpy(), xs[1])
    want = _formula(variant, A, xs[0], b)
    if variant == "gradmap_fused":
        assert float(res[0]) == pytest.approx(float(want[0]), rel=1e-5)
        _close(res[1].numpy(), want[1])
    elif variant.startswith("fwd_strip"):
        assert float(res) == pytest.approx(float(want), rel=1e-5)
    else:
        _close(res.numpy(), want)


def _printed(text):
    return [tuple(map(float, m)) for m in re.findall(
        r"f rel ([0-9.e+-]+), g rel ([0-9.e+-]+)", text)]


def test_gradmap_check_plain_version_matches_tpu_probe_interpret(probes,
                                                                  capsys):
    mk, _ = probes
    A, x, b = _matvec_data()
    with pltpu.force_tpu_interpret_mode():
        mk.check_gradmap_correct(jnp.asarray(A), jnp.asarray(x[None, :]),
                                 jnp.asarray(b[:, None]))
    (jax_errs,) = _printed(capsys.readouterr().out)
    assert max(jax_errs) < 1e-5
    before = matvec_probe.CHECK_LAUNCHES
    f, g, ferr, gerr = matvec_probe.check_gradmap_correct(
        torch.from_numpy(A), torch.from_numpy(x), torch.from_numpy(b))
    assert matvec_probe.CHECK_LAUNCHES == before
    assert _printed(capsys.readouterr().out) == [
        (float(f"{ferr:.2e}"), float(f"{gerr:.2e}"))]
    assert max(ferr, gerr) < 1e-5
    f_ref, g_ref = _formula("gradmap_fused", A, x, b)
    assert float(f) == pytest.approx(float(f_ref), rel=1e-5)
    _close(g.numpy(), g_ref)


def _gradmap_call(m, n, dtype=torch.float32, plan=None):
    A, x0, b = torch.zeros((m, n), dtype=dtype), torch.zeros(n, dtype=dtype), \
        torch.zeros(m, dtype=dtype)
    return lambda: matvec_probe._gradmap_launch(A, x0, b, 2, plan)


@pytest.mark.parametrize("what,call,match", [
    ("past 8192 columns", _gradmap_call(4, 8196), "8192"),
    ("n % 4", _gradmap_call(4, 130), "n % 4"),
    ("float64", _gradmap_call(4, 16, torch.float64), "float32"),
    ("another shape's plan",
     _gradmap_call(4, 16, plan=matvec_probe.gradmap_probe_plan(8, 16, 132, 0)),
     "plan is for")])
def test_gradmap_kernel_launch_refuses_before_the_card(what, call, match):
    """What K-P1's gradmap kernel does not take — more than 8192 columns
    (every block keeps its share of g), ragged rows, another type, a plan
    for another shape — raises before anything reaches the card."""
    with pytest.raises(ValueError, match=match):
        call()


def test_gradmap_on_the_cpu_runs_the_plain_version_and_keeps_its_shape():
    """On CPU tensors ``run_variant(..., "gradmap_fused", K)`` is the plain
    loop, launches nothing and returns (x, (f, g)) with f a 0-d tensor, as
    the card's wrapper returns it."""
    A, x0, b = (torch.from_numpy(v) for v in _matvec_data(16, 16))
    before = matvec_probe.LAUNCHES
    x, (f, g) = matvec_probe.run_variant(A, x0, b, "gradmap_fused", 3)
    assert matvec_probe.LAUNCHES == before
    assert f.shape == () and g.shape == (16,) and x.shape == (16,)
    xr, (fr, gr) = matvec_probe.run_variant_reference(A, x0, b,
                                                      "gradmap_fused", 3)
    assert torch.equal(x, xr) and torch.equal(f, fr) and torch.equal(g, gr)


def test_matvec_wrapper_checks():
    A, x, b = torch.zeros((4, 8)), torch.zeros(8), torch.zeros(4)
    with pytest.raises(ValueError, match="unknown variant"):
        matvec_probe.run_variant(A, x, b, "fwd_wgmma", 2)
    with pytest.raises(ValueError, match="x \\(n,\\)"):
        matvec_probe.run_variant(A, torch.zeros(4), b, "fwd_vpu", 2)
    with pytest.raises(ValueError, match="b \\(m,\\)"):
        matvec_probe.check_gradmap_correct(A, x, torch.zeros(8))
    with pytest.raises(ValueError, match="K >= 1"):
        matvec_probe.run_variant(A, x, b, "adj_mxu", 0)
    with pytest.raises(ValueError, match="device"):
        matvec_probe.run_variant(A.to("meta"), x.to("meta"), b.to("meta"),
                                 "fwd_vpu", 2)
    with pytest.raises(ValueError, match="device"):
        matvec_probe.check_gradmap_correct(A.to("meta"), x.to("meta"),
                                           b.to("meta"))
