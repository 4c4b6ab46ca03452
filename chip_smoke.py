"""Drive the PyTorch/CUDA port's LASSO main path once on an NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and the script exits
non-zero without the final ``ok`` line):

1. device: the card's name and power limit, TF32 off;
2. build: compile the CUDA kernels from ``fasta_tpu_torch/csrc``;
3. K-B3 (fused least-squares gradient map) against its plain version at
   1000×2000 and 8192×16384 float32, with median times over 20 runs;
4. K-B1 (whole-solve kernel) against its plain version on the card, on
   LASSO 1000×2000, hp off and on;
5. the main path through the public entry points — ``Problem.microsolve``
   and ``Problem.solve`` on ``problems.build("lasso", device="cuda")`` —
   checked against the float64 oracle, with the launch counters proving
   that both kernels ran; then the it/s of the kernel path and of the
   PyTorch loop path at a fixed 2000 iterations.

The line before the last is a JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.  There is no CPU path:
without a CUDA device the script fails at once.  Imports no JAX.
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
from fasta_tpu_torch.kernels import _build, lstsq_fused, microsolver  # noqa: E402
from reference_oracle.fasta_numpy import fasta as fasta_np  # noqa: E402
from reference_oracle.generators import make_lasso  # noqa: E402

DEV = torch.device("cuda", 0)


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


def device_ms(fn, runs: int = 20) -> float:
    """Mean device time of ``fn`` per run: the card's kernel time summed
    by ``torch.profiler`` over ``runs`` runs (host overhead excluded)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    return total_us / runs / 1e3


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
        kern_dev, plain_dev = device_ms(kernel_fn), device_ms(plain_fn)
        print(f"[3 K-B3 {m}x{n}] max|dd| {err_d:.3e} (tol {tol_d:.1e}) "
              f"max|dg| {err_g:.3e} (tol {tol_g:.1e}) rel df {rel_f:.3e} "
              f"(tol 1e-5); call, median of 20: kernel {kern:.4f} ms, plain "
              f"{plain:.4f} ms; device time, mean of 20: kernel "
              f"{kern_dev:.4f} ms, plain {plain_dev:.4f} ms; kernel reads A "
              f"once: {m * n * 4 / kern_dev / 1e6:.1f} GB/s of device time")
        require(err_d <= tol_d and err_g <= tol_g and rel_f <= 1e-5,
                f"K-B3 {m}x{n} disagrees with its plain version")
        worst = max(worst, err_d, err_g)
        ms[(m, n)] = (kern, plain, kern_dev, plain_dev)
        del A
    big, small = ms[(8192, 16384)], ms[(1000, 2000)]
    return dict(max_abs_err=worst, ms=big[0], plain_ms=big[1],
                shape="8192x16384", device_ms=big[2], plain_device_ms=big[3],
                ms_1000x2000=small[0], plain_ms_1000x2000=small[1],
                device_ms_1000x2000=small[2],
                plain_device_ms_1000x2000=small[3])


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
        times[hp] = (kern, plain)
    return dict(max_abs_err=worst, ms=times[False][0],
                plain_ms=times[False][1], ms_hp=times[True][0],
                plain_ms_hp=times[True][1])


def objective64(inst, x) -> float:
    x = np.asarray(x, np.float64)
    r = inst["A"] @ x - inst["b"]
    return 0.5 * float(r @ r) + inst["mu"] * float(np.abs(x).sum())


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

    lstsq_fused.LAUNCHES = 0
    microsolver.LAUNCHES = 0
    micro = prob.microsolve(max_iters=5000, tol=1e-6)
    loop = prob.solve(tol=1e-6, max_iters=5000)
    launches = {"K-B1": microsolver.LAUNCHES, "K-B3": lstsq_fused.LAUNCHES}

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


def main() -> None:
    name = phase_device()
    phase_build()
    b3 = phase_gradmap()
    b1 = phase_microsolver()
    launches = phase_main_path()
    kernels = [
        dict(name="K-B3 fused_lstsq_gradmap", route="cuda",
             source="fasta_tpu_torch/csrc/lstsq_fused.cu",
             replaces="fasta_tpu/kernels/lstsq_fused.py:368",
             launches=launches["K-B3"], **b3),
        dict(name="K-B1 microsolve_lasso (with K-B2 reduce.cuh)",
             route="cuda", source="fasta_tpu_torch/csrc/microsolver.cu",
             replaces="fasta_tpu/kernels/microsolver.py:721",
             launches=launches["K-B1"], **b1),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
