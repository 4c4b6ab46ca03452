"""Drive the PyTorch/CUDA port's main paths once on an NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and the script exits
non-zero without the final ``ok`` line):

1. device: the card's name and power limit, TF32 off;
2. build: compile the CUDA kernels from ``fasta_tpu_torch/csrc``;
3. K-B3 (fused least-squares gradient map) against its plain version at
   1000×2000 and 8192×16384 float32, with median times over 20 runs;
4. K-B1 (whole-solve kernel) against its plain version on the card, on
   LASSO 1000×2000, hp off and on;
5. the LASSO main path through the public entry points —
   ``Problem.microsolve`` and ``Problem.solve`` on
   ``problems.build("lasso", device="cuda")`` — checked against the
   float64 oracle, with the launch counters proving that both kernels
   ran; then the it/s of the kernel path and of the PyTorch loop path at
   a fixed 2000 iterations;
6. K-B3p (fused pointwise gradient map) against its plain version for the
   logistic loss and the squared hinge at 1000×500, 997×1999 and
   8192×16384 float32;
7. K-B1 against its plain version for all 12 loss × prox pairs on the
   full-width NNLS, logistic and SVM instances, adaptive (hp off, and hp
   on for one pair per loss) and FISTA with restart (hp on; hp off held
   to the objective);
8. K-B1p: the cold and the warm path on LASSO 1000×2000 over
   μ = 0.4, 0.2, 0.1, 0.05 against the plain version, the cold points
   against separate ``Problem.microsolve`` calls;
9. the dense family's main path — ``Problem.solve`` in the three modes,
   ``Problem.microsolve`` adaptive and FISTA and ``Problem.microsolve_sweep``
   on ``problems.build("nnls" | "logistic" | "svm", device="cuda")`` —
   against the float64 oracle, with the launch counters proving that
   K-B1, K-B1p and K-B3p ran; then the it/s of each problem's kernel and
   loop paths at a fixed 2000 iterations;
10. K-B5 (fused TV gradient map) against its plain version at 512×512,
    509×517 and 4096×4096 float32, with stream times over 20 runs;
11. K-B6 (whole TV-dual solve) against its plain version at 512×512,
    adaptive and FISTA, hp on (to tol 1e-5) and off (300 iterations), and
    the nonfinite abort;
12. K-B6p: the cold and the warm adaptive TV path and the warm FISTA
    path over μ = 0.4, 0.2, 0.1, 0.05 (tol 1e-4) against the plain
    version, each point against a separate K-B6 launch from the start
    that the path's carry gives it;
13. the TV main path — ``Problem.microsolve`` (adaptive, FISTA),
    ``Problem.solve`` and ``Problem.microsolve_sweep`` (cold, warm) on
    ``problems.build("tv", device="cuda")`` (512×512) — against a float64
    reference (the port's float64 loop on the card), with the launch
    counters proving that K-B5, K-B6 and K-B6p ran; then the it/s of the
    kernel and loop paths at a fixed 2000 iterations.

The line before the last is a JSON object describing each kernel, with
its bound: the larger of the bytes it must move (each input read once,
each output written once) over 3.35 TB/s and its float32 operations
over 67 TFLOP/s (the H100 SXM data sheet).  A whole-solve kernel's
operations are counted from its body for the line-search trials and
iterations of the measured run; ``hbm_state_ms`` adds, for those
kernels, the time to move the state of every iteration once through
device memory (the kernels keep it in L2).  The last line is
``{"ok": true, "device": {...}}``.  There is no CPU path: without a CUDA
device the script fails at once.  Imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py needs a CUDA device; none is available")

import fasta_tpu_torch as ftt  # noqa: E402
from fasta_tpu_torch import problems  # noqa: E402
from fasta_tpu_torch.kernels import (_build, lstsq_fused, microsolver,  # noqa: E402
                                     microsolver_tv, tv_fused)
from reference_oracle.fasta_numpy import fasta as fasta_np  # noqa: E402
from reference_oracle.generators import make_lasso  # noqa: E402

DEV = torch.device("cuda", 0)
PROXES = microsolver.PROXES


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, runs: int, warmup: int = 3) -> float:
    """Median wall time of ``fn`` on the card over ``runs`` runs (CUDA
    events around each run, after ``warmup`` runs)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def stream_ms(fn, runs: int = 20) -> float:
    """Mean time per run of ``fn`` on the card's stream: CUDA events
    around ``runs`` back-to-back runs with no host sync between them,
    after a warm-up.  Where the host enqueues a run more slowly than the
    card computes it (small shapes), the host's rate bounds this time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / runs
    require(ms > 0.0, "CUDA events measured no time on the stream")
    return ms


# H100 SXM data sheet: HBM3 bytes/s and float32 (non-tensor-core) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of ``nbytes`` over
    the memory rate and ``flops`` over the float32 peak, and which."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def trials(out) -> tuple:
    """(line-search trials, accepted iterations) of a whole-solve run
    recorded with ``record_bts``, over all its path points: each
    iteration takes one trial plus one per backtrack."""
    ks = out.iteration_count.reshape(-1).tolist()
    bts = out.backtracks.reshape(len(ks), -1)
    return (sum(k + int(bts[i, :k].sum()) for i, k in enumerate(ks)),
            sum(ks))


def dense_flops(m: int, n: int, tried: int, accepted: int, points: int,
                accelerate: bool) -> float:
    """float32 operations of K-B1 on lstsq × l1 (csrc/microsolver.cu), an
    fmaf counting 2, a compare or clamp 1, index arithmetic 0, values the
    kernel recomputes rather than stores not counted again.  Per trial:
    phase 1, per column, x̂ = x − τg (2), the shrink (6), Δx and x₁ − x̂
    (2), ‖Δx‖², ‖g‖², ‖x₁ − x̂‖² (6) and ⟨Δx,g⟩ (2), FISTA's restart dot
    (4) besides; phase 2, A x₁ (2mn) and per row r = d − b and Σr² (3);
    adaptive phase 3, Aᵀr (2mn) and per column Δg (3), ⟨Δx,Δg⟩ and ‖Δg‖²
    (4).  Per FISTA acceptance: phase A, per row d_n, r_n and Σr_n² (6);
    phase B, Aᵀr_n (2mn) and y_n (3 per column).  Per path point: A x₀,
    r₀ and Aᵀr₀ (4mn + 3m)."""
    if accelerate:
        per_trial = 2 * m * n + 22 * n + 3 * m
        per_accept = 2 * m * n + 6 * m + 3 * n
    else:
        per_trial = 4 * m * n + 25 * n + 3 * m
        per_accept = 0
    return float(tried * per_trial + accepted * per_accept
                 + points * (4 * m * n + 3 * m))


def tv_flops(h: int, w: int, tried: int, accepted: int, points: int,
             accelerate: bool) -> float:
    """float32 operations of K-B6 (csrc/microsolver_tv.cu), counted as in
    ``dense_flops``, per pixel (both channels).  Per trial: phase T,
    x̂ = y − τg (4), x₁ = clamp (4), Δx and x₁ − x̂ (4), ‖Δx‖², ‖g‖²,
    ‖x₁ − x̂‖² (12), ⟨Δx,g⟩ (4), d = μ·div x₁ (4), r = d − b (1) and Σr²
    (2), FISTA's restart dot (8) besides; adaptive phase G, g₁ = μ·grad r
    (4), Δg = g₁ + (x̂ − y)/τ (6), ⟨Δx,Δg⟩ (4) and ‖Δg‖² (4).  The x₁
    halo that phase T recomputes from y and g, and the x̂ and Δx that
    phase G recomputes, are not counted again.  Per FISTA acceptance:
    phase A, d_n, r_n and Σr_n² (6); phase B, g_n = μ·grad r_n (4) and
    y_n (6).  Per path point: d₀, r₀, Σr₀² and g₀ (11)."""
    per_trial = 43 if accelerate else 53
    per_accept = 16 if accelerate else 0
    return float(h * w * (tried * per_trial + accepted * per_accept
                          + points * 11))


def reset_launches() -> None:
    lstsq_fused.LAUNCHES = lstsq_fused.POINTWISE_LAUNCHES = 0
    microsolver.LAUNCHES = microsolver.PATH_LAUNCHES = 0
    tv_fused.LAUNCHES = 0
    microsolver_tv.LAUNCHES = microsolver_tv.PATH_LAUNCHES = 0


def read_launches() -> dict:
    return {"K-B1": microsolver.LAUNCHES,
            "K-B1p": microsolver.PATH_LAUNCHES,
            "K-B3": lstsq_fused.LAUNCHES,
            "K-B3p": lstsq_fused.POINTWISE_LAUNCHES,
            "K-B5": tv_fused.LAUNCHES,
            "K-B6": microsolver_tv.LAUNCHES,
            "K-B6p": microsolver_tv.PATH_LAUNCHES}


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[1 device] TF32 off for matmul and cuDNN: float32 products run "
          "in full float32")
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.library()
    print(f"[2 build] {_build.library_path()} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{' '.join(_build.NVCC_FLAGS)})")


def phase_gradmap() -> dict:
    """K-B3 against the plain two-pass form on the same seeded inputs.
    Tolerance: max|Δd|, max|Δg| ≤ 1e-5·max(1, max|ref|) and
    |Δf| ≤ 1e-5·|f| — float32 sums taken in another order."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    worst, ms = 0.0, {}
    for m, n in ((1000, 2000), (8192, 16384)):
        A = torch.randn((m, n), generator=gen, device=DEV) / m ** 0.5
        x = torch.randn(n, generator=gen, device=DEV)
        b = torch.randn(m, generator=gen, device=DEV)
        d, f, g = lstsq_fused.fused_lstsq_gradmap(A, x, b)
        d0, f0, g0 = lstsq_fused.lstsq_gradmap_reference(A, x, b)
        torch.cuda.synchronize()
        err_d = float((d - d0).abs().max())
        err_g = float((g - g0).abs().max())
        rel_f = abs(float(f) - float(f0)) / abs(float(f0))
        tol_d = 1e-5 * max(1.0, float(d0.abs().max()))
        tol_g = 1e-5 * max(1.0, float(g0.abs().max()))
        kernel_fn = lambda: lstsq_fused.fused_lstsq_gradmap(A, x, b)  # noqa: E731
        plain_fn = lambda: lstsq_fused.lstsq_gradmap_reference(A, x, b)  # noqa: E731
        kern, plain = cuda_ms(kernel_fn, 20), cuda_ms(plain_fn, 20)
        kern_stream = stream_ms(kernel_fn)
        plain_stream = stream_ms(plain_fn)
        print(f"[3 K-B3 {m}x{n}] max|dd| {err_d:.3e} (tol {tol_d:.1e}) "
              f"max|dg| {err_g:.3e} (tol {tol_g:.1e}) rel df {rel_f:.3e} "
              f"(tol 1e-5); call, median of 20: kernel {kern:.4f} ms, plain "
              f"{plain:.4f} ms; stream time, 20 back-to-back runs: kernel "
              f"{kern_stream:.4f} ms, plain {plain_stream:.4f} ms; kernel "
              f"reads A once: {m * n * 4 / kern_stream / 1e6:.1f} GB/s of "
              f"stream time")
        require(err_d <= tol_d and err_g <= tol_g and rel_f <= 1e-5,
                f"K-B3 {m}x{n} disagrees with its plain version")
        worst = max(worst, err_d, err_g)
        ms[(m, n)] = (kern, plain, kern_stream, plain_stream)
        del A
    big, small = ms[(8192, 16384)], ms[(1000, 2000)]
    m, n = 8192, 16384
    # A, x, b read once; d, g written once; two multiply-adds per entry
    return dict(max_abs_err=worst, ms=big[0], plain_ms=big[1],
                **bound(4.0 * (m * n + 2 * n + 2 * m), 4.0 * m * n),
                library_ms=None,
                shape="8192x16384", stream_ms=big[2], plain_stream_ms=big[3],
                ms_1000x2000=small[0], plain_ms_1000x2000=small[1],
                stream_ms_1000x2000=small[2],
                plain_stream_ms_1000x2000=small[3])


def phase_microsolver() -> dict:
    """K-B1 against its plain version on the card.  Tolerances: equal
    status; iteration counts within 2; taus rtol 1e-3 on the first 10
    iterations; residuals rtol 1e-3 / atol 1e-6 on the common prefix;
    solution atol 1e-5 — float32 sums taken in another order."""
    inst = make_lasso(m=1000, n=2000, k=100, mu=0.1, seed=1)
    A = torch.tensor(inst["A"], dtype=torch.float32, device=DEV)
    b = torch.tensor(inst["b"], dtype=torch.float32, device=DEV)
    x0 = torch.zeros(2000, dtype=torch.float32, device=DEV)
    kw = dict(max_iters=5000, tol=1e-6, record_fvals=True, record_bts=True)
    worst, times = 0.0, {}
    for hp in (False, True):
        out = microsolver.microsolve_lasso(A, b, x0, 0.05, 0.1, hp=hp, **kw)
        ref = microsolver.microsolve_lasso_reference(A, b, x0, 0.05, 0.1,
                                                     hp=hp, **kw)
        k1, k2 = int(out.iteration_count), int(ref.iteration_count)
        k = min(k1, k2)
        kt = min(k, 10)
        tau_err = float(((out.taus[:kt] - ref.taus[:kt]).abs()
                         / ref.taus[:kt]).max())
        res_ok = torch.allclose(out.residuals[:k], ref.residuals[:k],
                                rtol=1e-3, atol=1e-6)
        x_err = float((out.x - ref.x).abs().max())
        kern = cuda_ms(lambda: microsolver.microsolve_lasso(
            A, b, x0, 0.05, 0.1, hp=hp, **kw), 10)
        plain = cuda_ms(lambda: microsolver.microsolve_lasso_reference(
            A, b, x0, 0.05, 0.1, hp=hp, **kw), 3, warmup=1)
        print(f"[4 K-B1 hp={hp}] iterations kernel {k1} plain {k2}; status "
              f"{out.status}/{ref.status}; taus[:{kt}] max rel {tau_err:.2e} "
              f"(tol 1e-3); residuals allclose(1e-3, 1e-6) {res_ok}; "
              f"max|dx| {x_err:.2e} (tol 1e-5); solve to tol 1e-6: kernel "
              f"{kern:.3f} ms (median of 10), plain loop on the card "
              f"{plain:.3f} ms (median of 3)")
        require(out.status == ref.status == "converged",
                f"K-B1 hp={hp} status {out.status} vs {ref.status}")
        require(abs(k1 - k2) <= 2, f"K-B1 hp={hp} iterations {k1} vs {k2}")
        require(tau_err <= 1e-3 and res_ok and x_err <= 1e-5,
                f"K-B1 hp={hp} disagrees with its plain version")
        worst = max(worst, x_err)
        times[hp] = (kern, plain, trials(out))
    m, n = 1000, 2000
    tried, k = times[False][2]
    # A, b, x₀ in; x and the k entries of taus, residuals, backtracks and
    # f-values out
    return dict(max_abs_err=worst, ms=times[False][0],
                plain_ms=times[False][1],
                **bound(4.0 * (m * n + m + 2 * n + 4 * k),
                        dense_flops(m, n, tried, k, 1, False)),
                hbm_state_ms=k * dense_iteration_bytes(m, n)
                / HBM_BYTES_PER_S * 1e3,
                library_ms=None, iterations=k, trials=tried,
                ms_hp=times[True][0], plain_ms_hp=times[True][1])


def dense_iteration_bytes(m: int, n: int) -> float:
    """The state one adaptive K-B1 iteration would move through device
    memory were none of it kept on chip: A (once, for both products), x,
    g and b in, x₁ and g₁ out."""
    return 4.0 * (m * n + 4 * n + m)


def objective64(inst, x) -> float:
    """f(Ax) + g(x) of a generator instance, in float64 on the host."""
    x = np.asarray(x, np.float64)
    return float(inst["f"](inst["A"] @ x)) + float(inst["g"](x))


def phase_main_path() -> dict:
    """The public entry points on the card, held against the float64
    oracle: objectives within rtol 1e-5 (float32 data near the optimum)."""
    prob = problems.build("lasso", device=DEV)      # 1000×2000 float32
    prob.tau0 = 0.05
    inst = prob.instance
    oracle = fasta_np(inst["op"], None, inst["f"], inst["gradf"], inst["g"],
                      inst["proxg"], inst["x0"], tau0=0.05, tol=1e-6,
                      max_iters=5000)
    obj_ref = objective64(inst, oracle.solution)

    reset_launches()
    micro = prob.microsolve(max_iters=5000, tol=1e-6)
    loop = prob.solve(tol=1e-6, max_iters=5000)
    launches = read_launches()

    obj_micro = objective64(inst, micro.solution.cpu().numpy())
    obj_loop = objective64(inst, loop.solution)
    rel_micro = abs(obj_micro - obj_ref) / abs(obj_ref)
    rel_loop = abs(obj_loop - obj_ref) / abs(obj_ref)
    print(f"[5 main path] oracle f64: {oracle.iteration_count} iterations, "
          f"objective {obj_ref:.9g}")
    print(f"[5 main path] Problem.microsolve: {micro.status} in "
          f"{micro.iteration_count} iterations, objective {obj_micro:.9g} "
          f"(rel {rel_micro:.2e}, tol 1e-5)")
    print(f"[5 main path] Problem.solve: converged={loop.converged} in "
          f"{loop.iteration_count} iterations, objective {obj_loop:.9g} "
          f"(rel {rel_loop:.2e}, tol 1e-5)")
    print(f"[5 main path] launches during the two solves: {launches}")
    require(launches["K-B1p"] == 0 and launches["K-B3p"] == 0,
            f"the LASSO path launched a kernel it does not use: {launches}")
    require(micro.status == "converged" and loop.converged,
            "a main-path solve did not converge")
    require(rel_micro <= 1e-5 and rel_loop <= 1e-5,
            "a main-path objective disagrees with the float64 oracle")
    require(launches["K-B1"] >= 1 and launches["K-B3"] >= 1,
            f"a kernel of the main path never launched: {launches}")

    iters = 2000
    kern = cuda_ms(lambda: prob.microsolve(max_iters=iters, tol=0.0,
                                           stop_rule="iterations"),
                   5, warmup=1)
    opts = ftt.FastaOptions(max_iters=iters, stop_rule="iterations")
    loop_ms = cuda_ms(lambda: prob.solve_device(opts), 2, warmup=1)
    print(f"[5 main path] {iters} iterations: kernel path "
          f"{iters / kern * 1e3:.1f} it/s ({kern:.3f} ms), PyTorch loop path "
          f"{iters / loop_ms * 1e3:.1f} it/s ({loop_ms:.3f} ms)")
    return launches


def phase_pointwise() -> dict:
    """K-B3p against the plain two-pass form on the same seeded inputs,
    with phase 3's tolerance."""
    gen = torch.Generator(device=DEV).manual_seed(1)
    worst, ms = 0.0, {}
    for m, n in ((1000, 500), (997, 1999), (8192, 16384)):
        A = torch.randn((m, n), generator=gen, device=DEV) / m ** 0.5
        x = 3.0 * torch.randn(n, generator=gen, device=DEV)
        labels = (torch.rand(m, generator=gen, device=DEV) < 0.5).float()
        for loss, y in (("logistic", labels),
                        ("squared_hinge", 2.0 * labels - 1.0)):
            d, f, g = lstsq_fused.fused_pointwise_gradmap(A, x, y, loss)
            d0, f0, g0 = lstsq_fused.pointwise_gradmap_reference(A, x, y,
                                                                 loss)
            torch.cuda.synchronize()
            err_d = float((d - d0).abs().max())
            err_g = float((g - g0).abs().max())
            rel_f = abs(float(f) - float(f0)) / abs(float(f0))
            tol_d = 1e-5 * max(1.0, float(d0.abs().max()))
            tol_g = 1e-5 * max(1.0, float(g0.abs().max()))
            kernel_fn = lambda: lstsq_fused.fused_pointwise_gradmap(  # noqa: E731
                A, x, y, loss)
            plain_fn = lambda: lstsq_fused.pointwise_gradmap_reference(  # noqa: E731
                A, x, y, loss)
            kern, plain = cuda_ms(kernel_fn, 20), cuda_ms(plain_fn, 20)
            kern_stream = stream_ms(kernel_fn)
            plain_stream = stream_ms(plain_fn)
            print(f"[6 K-B3p {loss} {m}x{n}] max|dd| {err_d:.3e} (tol "
                  f"{tol_d:.1e}) max|dg| {err_g:.3e} (tol {tol_g:.1e}) rel "
                  f"df {rel_f:.3e} (tol 1e-5); call, median of 20: kernel "
                  f"{kern:.4f} ms, plain {plain:.4f} ms; stream time, 20 "
                  f"back-to-back runs: kernel {kern_stream:.4f} ms, plain "
                  f"{plain_stream:.4f} ms; kernel reads A once: "
                  f"{m * n * 4 / kern_stream / 1e6:.1f} GB/s of stream time")
            require(err_d <= tol_d and err_g <= tol_g and rel_f <= 1e-5,
                    f"K-B3p {loss} {m}x{n} disagrees with its plain version")
            worst = max(worst, err_d, err_g)
            ms[(loss, m, n)] = (kern, plain, kern_stream, plain_stream)
        del A
    big = ms[("logistic", 8192, 16384)]
    small = ms[("logistic", 1000, 500)]
    m, n = 8192, 16384
    return dict(max_abs_err=worst, ms=big[0], plain_ms=big[1],
                **bound(4.0 * (m * n + 2 * n + 2 * m), 4.0 * m * n),
                library_ms=None,
                shape="logistic 8192x16384", stream_ms=big[2],
                plain_stream_ms=big[3], ms_1000x500=small[0],
                plain_ms_1000x500=small[1], stream_ms_1000x500=small[2],
                plain_stream_ms_1000x500=small[3])


# loss -> (problem, tau0, weight μ of the l1 / ridge prox)
DENSE = {"lstsq": ("nnls", 0.08, 0.05), "logistic": ("logistic", 1.0, 0.02),
         "squared_hinge": ("svm", 0.3, 0.2)}


def objective(A, b, x, loss, prox, mu) -> float:
    """f(Ax) + g(x) in float64 on the card."""
    A, b, x = A.double(), b.double(), x.double()
    z = A @ x
    if loss == "lstsq":
        f = 0.5 * torch.sum((z - b) ** 2)
    elif loss == "logistic":
        f = torch.sum(torch.clamp_min(z, 0.0)
                      + torch.log1p(torch.exp(-z.abs())) - b * z)
    else:
        f = 0.5 * torch.sum(torch.clamp_min(1.0 - b * z, 0.0) ** 2)
    g = {"l1": mu * x.abs().sum(), "ridge": 0.5 * mu * (x @ x)}
    return float(f + g.get(prox, 0.0))


def phase_pairs() -> dict:
    """K-B1 against its plain version on the card, to tol 1e-5 (hybrid
    rule), for every loss × prox pair.  Phase 4's tolerances: equal
    status; iteration counts within 2; the first 10 taus rtol 1e-3, first
    10 residuals rtol 1e-3 / atol 1e-6 and first 10 backtracks equal —
    later iterations reach the float32 noise floor, where the order of
    float32 sums moves the trajectory; the solution atol 1e-5 of its
    scale; and the float64 objective within 1e-5.  The logistic loss's
    backtracking is knife-edge (tests/parity/test_parity.py), so its
    iteration count and solution are held to the objective check instead.
    FISTA with hp off runs 30 iterations: to a tolerance its float32
    window can stall, for the kernel and the plain version alike (LASSO
    ridge: neither converged in 3000 iterations), so it is held to the
    first 10 iterations' checks and the objective after 30."""
    worst = 0.0
    timed = {}
    for loss, (name, tau0, mu) in DENSE.items():
        p = problems.build(name, device=DEV)
        A, x0 = p.op.A, p.x0
        b = p.fterm.y if loss == "squared_hinge" else p.fterm.b
        runs = [(prox, False, False) for prox in PROXES]
        runs += [("l1", False, True)]
        runs += [(prox, True, True) for prox in PROXES]
        runs += [(prox, True, False) for prox in PROXES]
        for prox, accelerate, hp in runs:
            fista_f32 = accelerate and not hp
            kw = dict(max_iters=3000, tol=1e-5, loss=loss, prox=prox,
                      accelerate=accelerate, hp=hp, restart_dd=hp,
                      record_bts=True)
            if fista_f32:
                kw.update(max_iters=30, stop_rule="iterations")
            out = microsolver.microsolve_lasso(A, b, x0, tau0, mu, **kw)
            t0 = time.perf_counter()
            ref = microsolver.microsolve_lasso_reference(A, b, x0, tau0, mu,
                                                         **kw)
            torch.cuda.synchronize()
            plain = (time.perf_counter() - t0) * 1e3
            kern = cuda_ms(lambda: microsolver.microsolve_lasso(
                A, b, x0, tau0, mu, **kw), 5, warmup=1)
            k1, k2 = int(out.iteration_count), int(ref.iteration_count)
            f1 = objective(A, b, out.x, loss, prox, mu)
            f2 = objective(A, b, ref.x, loss, prox, mu)
            rel_f = abs(f1 - f2) / abs(f2)
            x_err = float((out.x - ref.x).abs().max())
            x_tol = 1e-5 * max(1.0, float(ref.x.abs().max()))
            kt = min(k1, k2, 10)
            tau_err = float(((out.taus[:kt] - ref.taus[:kt]).abs()
                             / ref.taus[:kt]).max())
            res_ok = torch.allclose(out.residuals[:kt], ref.residuals[:kt],
                                    rtol=1e-3, atol=1e-6)
            bt_ok = torch.equal(out.backtracks[:kt], ref.backtracks[:kt])
            if fista_f32:
                rule = "FISTA hp off: 30 iterations, objective check"
                ok = (k1 == k2 == 30 and rel_f <= 1e-5 and tau_err <= 1e-3
                      and res_ok and bt_ok)
            elif loss == "logistic":
                rule = "logistic: objective check for count and solution"
                ok = (out.status == ref.status == "converged"
                      and rel_f <= 1e-5 and tau_err <= 1e-3 and res_ok
                      and bt_ok)
            else:
                rule = "phase 4's tolerances"
                ok = (out.status == ref.status == "converged"
                      and abs(k1 - k2) <= 2 and rel_f <= 1e-5
                      and tau_err <= 1e-3 and res_ok and bt_ok
                      and x_err <= x_tol)
            mode = "FISTA" if accelerate else "adaptive"
            print(f"[7 K-B1 {loss} x {prox} {mode} hp={hp}] iterations "
                  f"kernel {k1} plain {k2}; status {out.status}/{ref.status}; "
                  f"taus[:{kt}] max rel {tau_err:.2e}; residuals[:{kt}] "
                  f"allclose {res_ok}; backtracks[:{kt}] equal {bt_ok}; "
                  f"max|dx| {x_err:.2e} (tol {x_tol:.1e}); objective rel "
                  f"{rel_f:.2e} (tol 1e-5); held to {rule}; "
                  f"{'30 iterations' if fista_f32 else 'to tol 1e-5'}: "
                  f"kernel {kern:.3f} ms (median of 5), plain loop on the "
                  f"card {plain:.3f} ms (one run)")
            require(ok, f"K-B1 {loss} x {prox} {mode} hp={hp} disagrees "
                    f"with its plain version")
            if not fista_f32 and loss != "logistic":
                worst = max(worst, x_err)
            timed[(loss, prox, accelerate, hp)] = (kern, plain)
    return dict(max_abs_err_pairs=worst,
                ms_pairs={f"{k[0]}x{k[1]}{'/fista' if k[2] else ''}"
                          f"{'/hp' if k[3] else ''}": v[0]
                          for k, v in timed.items()},
                plain_ms_pairs={f"{k[0]}x{k[1]}{'/fista' if k[2] else ''}"
                                f"{'/hp' if k[3] else ''}": v[1]
                                for k, v in timed.items()})


PATH_MUS = [0.4, 0.2, 0.1, 0.05]


def phase_path() -> dict:
    """K-B1p against its plain version on LASSO 1000×2000.  The cold
    points must be bit-identical to per-μ Problem.microsolve calls; the
    warm points converge, within 1e-5 of the plain warm path's objective
    at each μ, in fewer total iterations than the cold path."""
    prob = problems.build("lasso", device=DEV)
    A, b, x0 = prob.op.A, prob.fterm.b, prob.x0
    kw = dict(max_iters=3000, tol=1e-5, stop_rule="residual",
              record_bts=True)
    out = {}
    for warm in (False, True):
        ker = microsolver.microsolve_lasso_path(A, b, x0, 0.05, PATH_MUS,
                                                warm=warm, **kw)
        t0 = time.perf_counter()
        ref = microsolver.microsolve_lasso_path_reference(
            A, b, x0, 0.05, PATH_MUS, warm=warm, **kw)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        kern = cuda_ms(lambda: microsolver.microsolve_lasso_path(
            A, b, x0, 0.05, PATH_MUS, warm=warm, **kw), 5, warmup=1)
        rel = max(abs(objective(A, b, ker.x[i], "lstsq", "l1", mu)
                      - objective(A, b, ref.x[i], "lstsq", "l1", mu))
                  / objective(A, b, ref.x[i], "lstsq", "l1", mu)
                  for i, mu in enumerate(PATH_MUS))
        err = float((ker.x - ref.x).abs().max())
        ks, kr = ker.iteration_count.tolist(), ref.iteration_count.tolist()
        name = "warm" if warm else "cold"
        print(f"[8 K-B1p {name}] iterations per mu kernel {ks} (total "
              f"{sum(ks)}), plain {kr} (total {sum(kr)}); statuses "
              f"{ker.halt.tolist()}; max|dx| {err:.2e}; objective max rel "
              f"{rel:.2e} (tol 1e-5); path: kernel {kern:.3f} ms (median "
              f"of 5), plain loop on the card {plain:.3f} ms (one run)")
        require(bool((ker.halt == 1).all() and (ref.halt == 1).all())
                and rel <= 1e-5, f"K-B1p {name} disagrees with its plain "
                f"version")
        out[name] = (ker, kern, plain, err)
    cold, warm = out["cold"][0], out["warm"][0]
    p = problems.build("lasso", device=DEV)
    p.tau0 = 0.05
    same = True
    for i, mu in enumerate(PATH_MUS):
        p.gterm = ftt.L1Norm(mu)
        one = p.microsolve(stop_rule="residual", max_iters=3000, tol=1e-5)
        same &= (torch.equal(one.solution, cold.x[i])
                 and one.iteration_count == int(cold.iteration_count[i]))
    total_w = int(warm.iteration_count.sum())
    total_c = int(cold.iteration_count.sum())
    print(f"[8 K-B1p] cold points bit-identical to per-mu "
          f"Problem.microsolve: {same}; total iterations warm {total_w}, "
          f"cold {total_c}")
    require(same, "a cold path point differs from its separate solve")
    require(total_w < total_c, "the warm path took no fewer iterations")
    m, n, B = 1000, 2000, len(PATH_MUS)
    tried = trials(warm)[0]
    # A, b, x₀ in; each point's x and the entries of taus, residuals and
    # backtracks out
    return dict(max_abs_err=max(out["cold"][3], out["warm"][3]),
                ms=out["warm"][1], plain_ms=out["warm"][2],
                **bound(4.0 * (m * n + m + n + B * n + 3 * total_w),
                        dense_flops(m, n, tried, total_w, B, False)),
                hbm_state_ms=total_w * dense_iteration_bytes(m, n)
                / HBM_BYTES_PER_S * 1e3,
                library_ms=None, trials=tried,
                ms_cold=out["cold"][1], plain_ms_cold=out["cold"][2],
                iterations_warm=total_w, iterations_cold=total_c)


MAIN = {"nnls": 0.08, "logistic": 1.0, "svm": 0.3}


def phase_dense_main_path() -> dict:
    """The dense family through the public entry points on the card, each
    objective within rtol 1e-5 of the float64 oracle's: the converged
    oracle for the adaptive and FISTA solves, the oracle's run of the same
    length for plain mode (a fixed τ converges slowly)."""
    objs, probs = {}, {}
    for name, tau0 in MAIN.items():
        prob = problems.build(name, device=DEV)
        prob.tau0 = tau0
        inst = prob.instance
        oracle = fasta_np(inst["op"], None, inst["f"], inst["gradf"],
                          inst["g"], inst["proxg"], inst["x0"], tau0=tau0,
                          tol=1e-10, max_iters=20000)
        plain_np = fasta_np(inst["op"], None, inst["f"], inst["gradf"],
                            inst["g"], inst["proxg"], inst["x0"], tau0=tau0,
                            tol=1e-6, max_iters=500, adaptive=False)
        objs[name] = (objective64(inst, oracle.solution),
                      objective64(inst, plain_np.solution),
                      oracle.iteration_count)
        probs[name] = prob

    reset_launches()
    results = []
    for name, prob in probs.items():
        lam = float(prob.instance["mu"])    # μ of the l1, λ of the ridge
        results.append((name, "solve adaptive", prob.solve(
            tol=1e-6, max_iters=5000)))
        results.append((name, "solve plain", prob.solve(
            tol=1e-6, max_iters=500, adaptive=False)))
        results.append((name, "solve FISTA", prob.solve(
            tol=1e-6, max_iters=5000, accelerate=True)))
        results.append((name, "microsolve adaptive", prob.microsolve(
            tol=1e-6, max_iters=5000)))
        results.append((name, "microsolve FISTA", prob.microsolve(
            tol=1e-6, max_iters=5000, accelerate=True, hp=True,
            restart_dd=True)))
        # the weight path ends at the problem's own weight; the NNLS
        # projection has no weight to sweep.  The SVM path runs cold: a
        # warm start carries the last accepted τ, and the SVM's solves
        # end on stalled steps whose accepted τ is ≈ 4e-7 (PERF.md)
        if name == "logistic":
            results.append((name, "microsolve_sweep warm",
                            prob.microsolve_sweep(
                                [4.0 * lam, 2.0 * lam, lam], warm_start=True,
                                stop_rule="residual", tol=1e-6,
                                max_iters=5000)))
        elif name == "svm":
            results.append((name, "microsolve_sweep cold",
                            prob.microsolve_sweep(
                                [4.0 * lam, 2.0 * lam, lam], tol=1e-6,
                                max_iters=5000)))
    launches = read_launches()

    for name, what, r in results:
        ref, ref_plain, k_ref = objs[name]
        if what.startswith("microsolve_sweep"):
            x = r.solutions[-1].cpu().numpy()
            ok = bool(r.converged.all())
            k = r.iteration_counts.tolist()
        else:
            x = (r.solution.cpu().numpy() if isinstance(r.solution,
                                                        torch.Tensor)
                 else r.solution)
            ok = r.converged
            k = r.iteration_count
        if what == "solve plain":
            goal, how = ref_plain, "its 500 plain iterations"
        else:
            goal, how = ref, f"converged in {k_ref} iterations"
        obj = objective64(probs[name].instance, x)
        rel = abs(obj - goal) / abs(goal)
        print(f"[9 main path {name}] {what}: converged={ok} in {k} "
              f"iterations, objective {obj:.9g} against the float64 "
              f"oracle's {goal:.9g} ({how}): rel {rel:.2e} (tol 1e-5)")
        if what != "solve plain":
            require(ok, f"{name} {what} did not converge")
        require(rel <= 1e-5, f"{name} {what}: objective disagrees with the "
                f"float64 oracle")
    print(f"[9 main path] launches during the solves: {launches}")
    for kernel in ("K-B1", "K-B1p", "K-B3p", "K-B3"):
        require(launches[kernel] >= 1,
                f"{kernel} never launched on the dense main path: "
                f"{launches}")

    iters = 2000
    for name, prob in probs.items():
        kern = cuda_ms(lambda: prob.microsolve(
            max_iters=iters, tol=0.0, stop_rule="iterations"), 3, warmup=1)
        opts = ftt.FastaOptions(max_iters=iters, stop_rule="iterations")
        loop_ms = cuda_ms(lambda: prob.solve_device(opts), 1, warmup=1)
        print(f"[9 main path {name}] {iters} iterations: kernel path "
              f"{iters / kern * 1e3:.1f} it/s ({kern:.3f} ms), PyTorch loop "
              f"path {iters / loop_ms * 1e3:.1f} it/s ({loop_ms:.3f} ms)")
    return launches


def phase_tv_gradmap() -> dict:
    """K-B5 against its plain version on the same seeded inputs.  The
    kernel rounds each elementwise step like the plain version, so d and g
    are held to max|Δ| ≤ 1e-6·max(1, max|ref|), and f (an FP64 sum in the
    kernel, a float32 one in the plain version) to rel 1e-5."""
    gen = torch.Generator(device=DEV).manual_seed(2)
    worst, ms = 0.0, {}
    for h, w in ((512, 512), (509, 517), (4096, 4096)):
        p = torch.randn((2, h, w), generator=gen, device=DEV)
        b = torch.randn((h, w), generator=gen, device=DEV)
        d, f, g = tv_fused.fused_tv_gradmap(p, b, 0.1)
        d0, f0, g0 = tv_fused.tv_gradmap_reference(p, b, 0.1)
        torch.cuda.synchronize()
        err_d = float((d - d0).abs().max())
        err_g = float((g - g0).abs().max())
        rel_f = abs(float(f) - float(f0)) / abs(float(f0))
        tol_d = 1e-6 * max(1.0, float(d0.abs().max()))
        tol_g = 1e-6 * max(1.0, float(g0.abs().max()))
        kernel_fn = lambda: tv_fused.fused_tv_gradmap(p, b, 0.1)  # noqa: E731
        plain_fn = lambda: tv_fused.tv_gradmap_reference(p, b, 0.1)  # noqa: E731
        kern, plain = cuda_ms(kernel_fn, 20), cuda_ms(plain_fn, 20)
        kern_stream, plain_stream = stream_ms(kernel_fn), stream_ms(plain_fn)
        nbytes = 24.0 * h * w
        print(f"[10 K-B5 {h}x{w}] max|dd| {err_d:.3e} (tol {tol_d:.1e}) "
              f"max|dg| {err_g:.3e} (tol {tol_g:.1e}) rel df {rel_f:.3e} "
              f"(tol 1e-5); call, median of 20: kernel {kern:.4f} ms, plain "
              f"{plain:.4f} ms; stream time, 20 back-to-back runs: kernel "
              f"{kern_stream:.4f} ms, plain {plain_stream:.4f} ms; 24 B per "
              f"pixel: {nbytes / kern_stream / 1e6:.1f} GB/s of stream time, "
              f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
        require(err_d <= tol_d and err_g <= tol_g and rel_f <= 1e-5,
                f"K-B5 {h}x{w} disagrees with its plain version")
        worst = max(worst, err_d, err_g)
        ms[(h, w)] = (kern, plain, kern_stream, plain_stream)
        del p, b, d, g, d0, g0
    main, big = ms[(512, 512)], ms[(4096, 4096)]
    # per pixel, from csrc/tv_fused.cu: d = μ·div p (4), r = d − b (1), Σr²
    # (2), g = μ·grad r (4); the halo the kernel recomputes is not counted
    return dict(max_abs_err=worst, ms=main[2], plain_ms=main[3],
                **bound(24.0 * 512 * 512, 11.0 * 512 * 512),
                library_ms=None, shape="512x512, stream time",
                call_ms=main[0], plain_call_ms=main[1],
                stream_ms_4096x4096=big[2], plain_stream_ms_4096x4096=big[3],
                bound_ms_4096x4096=bound(24.0 * 4096 * 4096,
                                         11.0 * 4096 * 4096)["bound_ms"])


def tv_iteration_bytes(h: int, w: int, accelerate: bool) -> float:
    """The state one K-B6 iteration would move through device memory were
    none of it kept on chip: adaptive, y, g and b in and x₁, g₁ out (36 B
    per pixel); FISTA also x_acc and d_acc in and out (60 B per pixel)."""
    return (60.0 if accelerate else 36.0) * h * w


def tv_objective(b, mu, p) -> float:
    """The dual objective ½‖μ·div p − b‖² in float64 on the card."""
    r = mu * ftt.TVDiv2D()(p.double()) - b.double()
    return float(0.5 * torch.sum(r * r))


def tv_image_err(b, mu, p1, p2) -> float:
    """max|Δx| of the denoised images x = b − μ·div p of two dual fields:
    the primal solution is unique where the dual field is not, so two
    solves that part late in float32 are compared here."""
    return float((mu * ftt.TVDiv2D()(p1.double() - p2.double())).abs().max())


def phase_tv_microsolver() -> dict:
    """K-B6 against its plain version on the card at 512×512.  hp on, to
    tol 1e-5: both converge; the first 10 taus rtol 1e-3, residuals rtol
    1e-3 / atol 1e-6 and backtracks equal; the float64 objective within
    1e-5.  Counts are not held equal: the TV dual's backtracking is
    knife-edge in float32 (tests/unit/test_microsolver_tv.py), so the
    order of the float32 sums moves the trajectory by the 40th iteration.
    hp off runs 300 iterations (its float32 window stalls near the
    optimum) under the same prefix and objective checks.  A nonfinite τ₀
    aborts with status "nonfinite" in both versions.  ``max_abs_err`` is
    the largest max|Δx| of the denoised images (``tv_image_err``)."""
    prob = problems.build("tv", device=DEV)
    b, p0, mu = prob.fterm.b, prob.x0, 0.1
    worst, timed = 0.0, {}
    for accelerate in (False, True):
        for hp in (True, False):
            kw = dict(max_iters=5000, tol=1e-5, hp=hp, accelerate=accelerate,
                      restart_dd=hp, record_bts=True)
            if not hp:
                kw.update(max_iters=300, stop_rule="iterations")
            out = microsolver_tv.microsolve_tv(b, p0, 2.0, mu, **kw)
            t0 = time.perf_counter()
            ref = microsolver_tv.microsolve_tv_reference(b, p0, 2.0, mu, **kw)
            torch.cuda.synchronize()
            plain = (time.perf_counter() - t0) * 1e3
            kern = cuda_ms(lambda: microsolver_tv.microsolve_tv(
                b, p0, 2.0, mu, **kw), 3, warmup=1)
            k1, k2 = int(out.iteration_count), int(ref.iteration_count)
            f1, f2 = tv_objective(b, mu, out.x), tv_objective(b, mu, ref.x)
            rel_f = abs(f1 - f2) / abs(f2)
            kt = min(k1, k2, 10)
            tau_err = float(((out.taus[:kt] - ref.taus[:kt]).abs()
                             / ref.taus[:kt]).max())
            res_ok = torch.allclose(out.residuals[:kt], ref.residuals[:kt],
                                    rtol=1e-3, atol=1e-6)
            bt_ok = torch.equal(out.backtracks[:kt], ref.backtracks[:kt])
            x_err = float((out.x - ref.x).abs().max())
            img_err = tv_image_err(b, mu, out.x, ref.x)
            status_ok = (out.status == ref.status == "converged" if hp
                         else k1 == k2 == 300)
            mode = "FISTA" if accelerate else "adaptive"
            print(f"[11 K-B6 {mode} hp={hp}] iterations kernel {k1} plain "
                  f"{k2}; status {out.status}/{ref.status}; taus[:{kt}] max "
                  f"rel {tau_err:.2e} (tol 1e-3); residuals[:{kt}] allclose "
                  f"{res_ok}; backtracks[:{kt}] equal {bt_ok}; max|dp| "
                  f"{x_err:.2e}, image max|dx| {img_err:.2e}; objective "
                  f"{f1:.9g} vs {f2:.9g}, rel "
                  f"{rel_f:.2e} (tol 1e-5); "
                  f"{'to tol 1e-5' if hp else '300 iterations'}: kernel "
                  f"{kern:.3f} ms (median of 3, {kern / k1 * 1e3:.2f} us per "
                  f"iteration), plain loop on the card {plain:.3f} ms (one "
                  f"run)")
            require(status_ok and tau_err <= 1e-3 and res_ok and bt_ok
                    and rel_f <= 1e-5,
                    f"K-B6 {mode} hp={hp} disagrees with its plain version")
            worst = max(worst, img_err)
            timed[(accelerate, hp)] = (kern, plain, trials(out))
    bad = microsolver_tv.microsolve_tv(b, p0, float("nan"), mu, max_iters=50)
    bad_ref = microsolver_tv.microsolve_tv_reference(b, p0, float("nan"), mu,
                                                     max_iters=50)
    print(f"[11 K-B6] tau0 = nan: kernel {bad.status} after "
          f"{int(bad.iteration_count)} iterations, plain {bad_ref.status} "
          f"after {int(bad_ref.iteration_count)}")
    require(bad.status == bad_ref.status == "nonfinite",
            "K-B6 did not abort a nonfinite solve")
    kern, plain, (tried, k) = timed[(False, True)]
    h = w = 512
    # b and p₀ in; p and the k entries of taus, residuals and backtracks
    # out
    return dict(max_abs_err=worst, ms=kern, plain_ms=plain,
                **bound(4.0 * (h * w + 2 * h * w + 2 * h * w + 3 * k),
                        tv_flops(h, w, tried, k, 1, False)),
                hbm_state_ms=k * tv_iteration_bytes(h, w, False)
                / HBM_BYTES_PER_S * 1e3,
                library_ms=None, iterations=k, trials=tried,
                ms_fista=timed[(True, True)][0],
                plain_ms_fista=timed[(True, True)][1],
                iterations_fista=timed[(True, True)][2][1])


TV_MUS = [0.4, 0.2, 0.1, 0.05]


# the TV path's stopping: at tol 1e-5 the strong weights (μ = 0.4) do not
# converge within 30000 iterations (PERF.md)
TV_PATH_KW = dict(max_iters=10000, tol=1e-4)


def warm_starts(out, tau0: float, accelerate: bool) -> list:
    """The start τ of each point of a warm K-B6p run, derived from the
    run's own records by the JAX code's rule: point i−1's last genuinely
    accepted τ (fewer than max_backtracks trials) when that point ended
    finite and the τ is > 0, else point i−1's own start τ; FISTA always
    τ₀."""
    max_bt = microsolver_tv._DEFAULTS["max_backtracks"]
    starts, start = [], float(tau0)
    for i in range(out.iteration_count.shape[0]):
        starts.append(float(tau0) if accelerate else start)
        k = int(out.iteration_count[i])
        good = (out.backtracks[i, :k] < max_bt).nonzero().flatten()
        acc = float(out.taus[i, good[-1]]) if len(good) else 0.0
        if int(out.halt[i]) != 2 and acc > 0.0:
            start = acc
    return starts


def phase_tv_path() -> dict:
    """K-B6p against its plain version at 512×512 (hp on, hybrid rule, tol
    1e-4), cold and warm adaptive and warm FISTA.  Every point converges in
    both, with the float64 objective within 1e-5 of the plain path's at
    each μ, and each point's first 10 taus (rtol 1e-3), residuals (rtol
    1e-3, atol 1e-6) and backtracks (equal) against the plain version
    started where the kernel's point started: p₀ for a cold point or the
    first one; for a warm point i > 0 the kernel's point i−1 solution and
    the τ that ``warm_starts`` derives from the kernel's records.  (Held
    against the plain path's own carry instead, the τ would follow the end
    of two knife-edge float32 trajectories thousands of iterations long.)
    Every point is also bit-identical to a separate K-B6 launch from that
    start — the cold ones from p₀, the warm ones from the carried field and
    τ — so the warm carry is the JAX code's, exactly.  The warm FISTA
    path's iteration counts equal the plain path's.  The total iterations
    of the warm and the cold path are reported, not held: the TV dual has
    no reliable warm-start gain (``microsolver_tv.py:681-697``)."""
    prob = problems.build("tv", device=DEV)
    b, p0 = prob.fterm.b, prob.x0
    out = {}
    for warm, accelerate in ((False, False), (True, False), (True, True)):
        kw = dict(record_bts=True, accelerate=accelerate, **TV_PATH_KW)
        ker = microsolver_tv.microsolve_tv_path(b, p0, 2.0, TV_MUS, warm=warm,
                                                **kw)
        t0 = time.perf_counter()
        ref = microsolver_tv.microsolve_tv_path_reference(
            b, p0, 2.0, TV_MUS, warm=warm, **kw)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        kern = cuda_ms(lambda: microsolver_tv.microsolve_tv_path(
            b, p0, 2.0, TV_MUS, warm=warm, **kw), 3, warmup=1)
        rel = max(abs(tv_objective(b, mu, ker.x[i])
                      - tv_objective(b, mu, ref.x[i]))
                  / tv_objective(b, mu, ref.x[i])
                  for i, mu in enumerate(TV_MUS))
        ks, kr = ker.iteration_count.tolist(), ref.iteration_count.tolist()
        img = max(tv_image_err(b, mu, ker.x[i], ref.x[i])
                  for i, mu in enumerate(TV_MUS))
        starts = (warm_starts(ker, 2.0, accelerate) if warm
                  else [2.0] * len(TV_MUS))
        prefix_ok, same = True, True
        for i, mu in enumerate(TV_MUS):
            p_start = ker.x[i - 1] if warm and i > 0 else p0
            k = int(ker.iteration_count[i])
            kt = min(k, 10)
            head = microsolver_tv.microsolve_tv_reference(
                b, p_start, starts[i], mu,
                **{**kw, "max_iters": kt, "stop_rule": "iterations"})
            prefix_ok &= (torch.allclose(ker.taus[i, :kt], head.taus[:kt],
                                         rtol=1e-3, atol=0.0)
                          and torch.allclose(ker.residuals[i, :kt],
                                             head.residuals[:kt], rtol=1e-3,
                                             atol=1e-6)
                          and torch.equal(ker.backtracks[i, :kt],
                                          head.backtracks[:kt]))
            one = microsolver_tv.microsolve_tv(b, p_start, starts[i], mu,
                                               **kw)
            same &= (torch.equal(one.x, ker.x[i])
                     and torch.equal(one.taus, ker.taus[i])
                     and int(one.iteration_count) == k)
        name = (("warm" if warm else "cold")
                + (" FISTA" if accelerate else ""))
        print(f"[12 K-B6p {name}] iterations per mu kernel {ks} (total "
              f"{sum(ks)}), plain {kr} (total {sum(kr)}); image max|dx| "
              f"{img:.2e}; statuses "
              f"{ker.halt.tolist()}/{ref.halt.tolist()}; objective max rel "
              f"{rel:.2e} (tol 1e-5); start taus {starts}; first 10 taus, "
              f"residuals, backtracks of each point against the plain "
              f"version from the same start: {prefix_ok}; each point "
              f"bit-identical to a K-B6 launch from its start: {same}; "
              f"path: kernel {kern:.3f} ms (median of 3), plain loop on "
              f"the card {plain:.3f} ms (one run)")
        require(bool((ker.halt == 1).all() and (ref.halt == 1).all())
                and rel <= 1e-5 and prefix_ok,
                f"K-B6p {name} disagrees with its plain version")
        require(same, f"a K-B6p {name} point differs from a K-B6 launch "
                f"from its start")
        if accelerate:
            require(ks == kr, f"K-B6p {name}: iteration counts {ks} against "
                    f"the plain path's {kr}")
        out[name] = (ker, kern, plain, img)
    cold, warm = out["cold"][0], out["warm"][0]
    total_w = int(warm.iteration_count.sum())
    total_c = int(cold.iteration_count.sum())
    print(f"[12 K-B6p] total iterations warm {total_w}, cold {total_c}")
    h = w = 512
    B = len(TV_MUS)
    tried = trials(warm)[0]
    # b and p₀ in; each point's p and the entries of taus, residuals and
    # backtracks out
    return dict(max_abs_err=max(v[3] for v in out.values()),
                ms=out["warm"][1], plain_ms=out["warm"][2],
                **bound(4.0 * (h * w + 2 * h * w + B * 2 * h * w
                               + 3 * total_w),
                        tv_flops(h, w, tried, total_w, B, False)),
                hbm_state_ms=total_w * tv_iteration_bytes(h, w, False)
                / HBM_BYTES_PER_S * 1e3,
                library_ms=None, trials=tried, ms_cold=out["cold"][1],
                plain_ms_cold=out["cold"][2], iterations_warm=total_w,
                iterations_cold=total_c, ms_warm_fista=out["warm FISTA"][1],
                plain_ms_warm_fista=out["warm FISTA"][2],
                iterations_warm_fista=int(
                    out["warm FISTA"][0].iteration_count.sum()))


def phase_tv_main_path() -> dict:
    """The TV main path through the public entry points on the card at
    512×512, tol 1e-5 (the weight sweeps over μ = 0.2, 0.1, whose last
    point is the problem's weight, up to 20000 iterations): each dual
    objective within rtol 1e-5 of the float64 reference's and each
    recovered image x = b − μ·div p within rel 1e-3 (L2) of the
    reference's.  The reference is the port's float64 loop on the card
    (``problems.build("tv", dtype=float64)``, adaptive, tol 1e-7: 14435
    iterations, about 23 s); the NumPy oracle's loop on the host would
    take several times longer."""
    ref_prob = problems.build("tv", dtype=torch.float64, device=DEV)
    t0 = time.perf_counter()
    ref = ref_prob.solve(tau0=2.0, tol=1e-7, max_iters=30000)
    ref_s = time.perf_counter() - t0
    p_ref = torch.as_tensor(ref.solution, device=DEV)
    b64, mu = ref_prob.fterm.b, 0.1
    obj_ref = tv_objective(b64, mu, p_ref)
    x_ref = ref_prob.recover(p_ref)
    print(f"[13 TV main path] float64 reference (the port's loop on the "
          f"card): converged={ref.converged} in {ref.iteration_count} "
          f"iterations ({ref_s:.1f} s), dual objective {obj_ref:.9g}")
    require(ref.converged, "the float64 TV reference did not converge")

    prob = problems.build("tv", device=DEV)          # 512×512 float32
    prob.tau0 = 2.0
    reset_launches()
    runs = [("microsolve adaptive", prob.microsolve(max_iters=5000,
                                                    tol=1e-5)),
            ("microsolve FISTA", prob.microsolve(max_iters=5000, tol=1e-5,
                                                 accelerate=True)),
            ("solve adaptive", prob.solve(tol=1e-5, max_iters=5000)),
            ("microsolve_sweep cold", prob.microsolve_sweep(
                [0.2, 0.1], max_iters=20000, tol=1e-5)),
            ("microsolve_sweep warm", prob.microsolve_sweep(
                [0.2, 0.1], max_iters=20000, tol=1e-5, warm_start=True))]
    launches = read_launches()
    for what, r in runs:
        if what.startswith("microsolve_sweep"):
            p, ok = r.solutions[-1], bool(r.converged.all())
            k = r.iteration_counts.tolist()
        else:
            p = torch.as_tensor(r.solution, device=DEV)
            ok, k = r.converged, r.iteration_count
        obj = tv_objective(b64, mu, p)
        rel = abs(obj - obj_ref) / abs(obj_ref)
        x = prob.recover(p)
        x_rel = float(torch.linalg.norm(x - x_ref) / torch.linalg.norm(x_ref))
        print(f"[13 TV main path] {what}: converged={ok} in {k} iterations, "
              f"dual objective {obj:.9g}: rel {rel:.2e} (tol 1e-5); "
              f"recovered image rel L2 {x_rel:.2e} (tol 1e-3)")
        require(ok, f"TV {what} did not converge")
        require(rel <= 1e-5 and x_rel <= 1e-3,
                f"TV {what} disagrees with the float64 reference")
    print(f"[13 TV main path] launches during the solves: {launches}")
    for kernel in ("K-B5", "K-B6", "K-B6p"):
        require(launches[kernel] >= 1,
                f"{kernel} never launched on the TV main path: {launches}")
    require(launches["K-B1"] == launches["K-B1p"] == launches["K-B3"]
            == launches["K-B3p"] == 0,
            f"the TV path launched a dense kernel: {launches}")

    iters = 2000
    kern = cuda_ms(lambda: prob.microsolve(
        max_iters=iters, tol=0.0, stop_rule="iterations"), 3, warmup=1)
    opts = ftt.FastaOptions(max_iters=iters, stop_rule="iterations")
    loop_ms = cuda_ms(lambda: prob.solve_device(opts), 1, warmup=1)
    print(f"[13 TV main path] {iters} iterations: kernel path "
          f"{iters / kern * 1e3:.1f} it/s ({kern:.3f} ms), PyTorch loop path "
          f"{iters / loop_ms * 1e3:.1f} it/s ({loop_ms:.3f} ms)")
    return launches


def main() -> None:
    name = phase_device()
    phase_build()
    b3 = phase_gradmap()
    b1 = phase_microsolver()
    lasso = phase_main_path()
    b3p = phase_pointwise()
    b1_pairs = phase_pairs()
    b1p = phase_path()
    dense = phase_dense_main_path()
    b5 = phase_tv_gradmap()
    b6 = phase_tv_microsolver()
    b6p = phase_tv_path()
    tv = phase_tv_main_path()
    launches = {k: lasso[k] + dense[k] + tv[k] for k in lasso}
    kernels = [
        dict(name="K-B3 fused_lstsq_gradmap", route="cuda",
             source="fasta_tpu_torch/csrc/lstsq_fused.cu",
             replaces="fasta_tpu/kernels/lstsq_fused.py:407",
             launches=launches["K-B3"], **b3),
        dict(name="K-B3p fused_pointwise_gradmap", route="cuda",
             source="fasta_tpu_torch/csrc/lstsq_fused.cu",
             replaces="fasta_tpu/kernels/lstsq_fused.py:331",
             launches=launches["K-B3p"], **b3p),
        dict(name="K-B1 microsolve_lasso (with K-B2 reduce.cuh)",
             route="cuda", source="fasta_tpu_torch/csrc/microsolver.cu",
             replaces="fasta_tpu/kernels/microsolver.py:810",
             launches=launches["K-B1"], **b1, **b1_pairs),
        dict(name="K-B1p microsolve_lasso_path", route="cuda",
             source="fasta_tpu_torch/csrc/microsolver.cu",
             replaces="fasta_tpu/kernels/microsolver.py:908",
             launches=launches["K-B1p"], **b1p),
        dict(name="K-B5 fused_tv_gradmap", route="cuda",
             source="fasta_tpu_torch/csrc/tv_fused.cu",
             replaces="fasta_tpu/kernels/tv_fused.py:82",
             launches=launches["K-B5"], **b5),
        dict(name="K-B6 microsolve_tv", route="cuda",
             source="fasta_tpu_torch/csrc/microsolver_tv.cu",
             replaces="fasta_tpu/kernels/microsolver_tv.py:607",
             launches=launches["K-B6"], **b6),
        dict(name="K-B6p microsolve_tv_path", route="cuda",
             source="fasta_tpu_torch/csrc/microsolver_tv.cu",
             replaces="fasta_tpu/kernels/microsolver_tv.py:731",
             launches=launches["K-B6p"], **b6p),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
