"""Drive the PyTorch/CUDA port's main paths once on an NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and the script exits
non-zero without the final ``ok`` line):

1. device: the card's name and power limit, TF32 off;
2. build: compile the CUDA kernels from ``fasta_tpu_torch/csrc``;
3. K-B3 (fused least-squares gradient map) against its plain version at
   1000×2000 and 8192×16384 float32, with median times over 20 runs;
4. K-B1 (whole-solve kernel) against its plain version on the card, on
   LASSO 1000×2000, hp off and on, with its dense plan (``dense_plan``:
   the route, the share of A kept on the chip) and µs a trial; the route
   counters show that every launch kept A on the chip;
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
   to the objective), each problem's dense plan and each run's µs a
   trial;
8. K-B1p: the cold and the warm path on LASSO 1000×2000 over
   μ = 0.4, 0.2, 0.1, 0.05 against the plain version, the cold points
   against separate ``Problem.microsolve`` calls, with the dense plan and
   µs a trial;
9. the dense family's main path — ``Problem.solve`` in the three modes,
   ``Problem.microsolve`` adaptive and FISTA and ``Problem.microsolve_sweep``
   on ``problems.build("nnls" | "logistic" | "svm", device="cuda")`` —
   against the float64 oracle, with the launch counters proving that
   K-B1, K-B1p and K-B3p ran; then the it/s of each problem's kernel and
   loop paths at a fixed 2000 iterations;
10. K-B5 (fused TV gradient map) against its plain version at 512×512,
    509×517 and 4096×4096 float32, with stream times over 20 runs, and
    at each shape the card time per call (a ``profiling.trace``), the
    host time per call and the device operations per call (one kernel);
11. K-B6 (whole TV-dual solve) against its plain version at 512×512 on
    its resident route (the route counter proves it), adaptive and FISTA,
    hp on (to tol 1e-5) and off (300 iterations), and the nonfinite
    abort; µs an iteration at a fixed 2000 iterations at 512×512 and at
    16×16 (the floor: barriers, reductions, decisions); the global route
    past the gate, 2048×2048 for 300 iterations, against its plain
    version, and its µs an iteration;
12. K-B6p: the cold and the warm adaptive TV path and the warm FISTA
    path over μ = 0.4, 0.2, 0.1, 0.05 (tol 1e-4) against the plain
    version, each point against a separate K-B6 launch from the start
    that the path's carry gives it, on the resident route;
13. the TV main path — ``Problem.microsolve`` (adaptive, FISTA),
    ``Problem.solve`` and ``Problem.microsolve_sweep`` (cold, warm) on
    ``problems.build("tv", device="cuda")`` (512×512) — against a float64
    reference (the port's float64 loop on the card), with the launch
    counters proving that K-B5, K-B6 and K-B6p ran; then the it/s of the
    kernel and loop paths at a fixed 2000 iterations;
14. K-B7 (fused planar gradient map) against its plain version, the
    least-squares and hinge forms, at 16384×256 (33.6 MB, in L2), 1000×37
    and 16384×4096 (537 MB, streaming from HBM), a second call's bits,
    with call and stream times over 20 runs, and the hinge form at
    16384×256 and 16384×4096 split into card time (a ``profiling.trace``),
    host time and device operations per call (one kernel, no memset);
15. K-P5 (planar layout probe): every layout at 16384×256 against its
    plain version, then µs per chained pair and the implied GB/s, in
    turns; the layout K-B8 uses;
16. K-B8 (whole planar PhaseMax solve) against its plain version at
    16384×256: adaptive hp to tol 1e-5, adaptive hp off for 300
    iterations, FISTA hp to tol 1e-5, and the nonfinite abort, with µs an
    iteration and a trial; the tile plan (``tile_plan``) and the route
    counters show that every launch kept A on the chip (the resident
    route);
17. the phase-retrieval main path — ``Problem.microsolve`` (adaptive,
    FISTA), ``Problem.solve`` (adaptive, FISTA) on
    ``problems.build("phase_retrieval", planar=True)`` (16384×256 on the
    default device) and the complex form's ``Problem.solve`` — against the
    float64 NumPy oracle, with the launch counters proving that K-B7 and
    K-B8 ran and no dense or TV kernel did; then the it/s of the kernel
    and loop paths at a fixed 2000 iterations;
18. K-B4 (fused shrink step) against its plain version at 1×2000,
    1×128, 1×100, 32×2000 and 1×2²⁴, a NaN entry, two calls equal; call
    and stream times at 1×2000, 32×2000 and 1×2²⁴ against the bound, and
    there the card time, the host time and the device operations per
    call, as in phase 10;
19. K-B1b (the dense whole solve over a batch): LASSO 1000×2000, 32
    instances, adaptive and FISTA, per-instance τ₀, each instance
    bit-identical to a separate K-B1 launch, two against the plain batch,
    with the dense plan, µs a trial and the route counters;
20. K-B6b: TV 512×512, 8 images, adaptive and FISTA, each bit-identical
    to a separate K-B6 launch, one against the plain version, on the
    resident route;
21. K-B8b: planar phase retrieval 16384×256, 16 instances, as phase 19,
    each launch on the resident route (the route counters), µs an
    iteration and a trial;
22. the serving main path — ``recommend_path(...).run(bs)`` and
    ``Problem.solve_serving`` on TV 512×512 × 8, LASSO 1000×2000 × 32 and
    planar phase retrieval 16384×256 × 16, one request of each, and
    LASSO with full diagnostics — its routes, the launch counters of
    K-B4, K-B1b, K-B6b and K-B8b (and no call of their plain versions),
    objectives against the float64 references, the batch loop's lanes
    against separate solves, and the wall time per instance of a batch
    against separate calls on both batch routes;
23. K-B3 and K-B3p over a bfloat16 A against their plain versions at
    8192×16384, 1000×1003 (ragged) and 1024×200000 (the wide route), with
    call and stream times beside K-B3 over the float32 A;
24. K-B7 over bfloat16 channels at 16384×256, 16384×4096 and 1024×16384
    (the wide route), both losses, the hinge form at 16384×256 and
    16384×4096 split as in phase 14;
25. K-P4 (the bfloat16-storage probe) at 1000×2000, float32 against
    bfloat16 storage: its plan, a call's device operations, µs per chained
    pair in turns beside the bound (A once a launch) and the former
    reckoning (A once a pair); then, printed, the same at n = 2000 and the
    smallest m at which the float32 plan streams a remainder and the
    bfloat16 plan does not;
26. K-B8 and K-B8b on the route past n = 512 (C-4) at 8192×640 (to
    tolerance), 2048×1024 and 256×8192 (300 iterations: no bounded
    solution), adaptive and FISTA, against the plain version, each batch
    instance bit-identical to its own launch, µs an iteration and a trial,
    and the route counters: 2048×1024 and 256×8192 on the resident route,
    8192×640 on the streamed one (more than half of A on the chip); then
    ``recommend_path(p, 1).run()``, ``Problem.microsolve_batch`` and
    ``recommend_path(p, 4).run(bs)`` with the launch counters;
27. the bfloat16 main paths: LASSO 8192×16384 through
    ``LowPrecDenseOp`` (K-B3 bf16), a checkpoint round trip and the
    float32 ``checkpoint.resume``, against the float32 solve from scratch
    in float64 objective and iterations; logistic and the squared hinge
    over the bfloat16 matrix (K-B3p bf16); planar phase retrieval
    16384×256 over bfloat16 channels (K-B7 bf16), its float32 resume
    against the float64 oracle and ``Problem.microsolve`` on it;
28. K-P2 (the one-pass gradient-map check) at 1000×2048 against its plain
    version and float64, a second call's bits, the call's time and its
    split into card time, host time and device operations (one kernel);
29. K-P1 (the GEMV formulation probe): every formulation at 1000×2048
    against its plain version, two runs equal, then the barrier alone (K
    grid barriers of each kind, nothing else) and µs per chained
    operation at K = 2000 beside ``torch.mv``'s card time (a CUDA graph
    of calls, and its kernels in a ``profiling.trace``); then the
    ``gradmap_fused`` form's own kernel (``csrc/gradmap_probe.cu``) at
    1000×2048, 16×16 and the first shape whose plan streams rows at
    n = 2048: its plan, the checks of K = 3 at each, a call's device
    operations (a ``profiling.trace`` of K = 3), µs per op at K = 2000
    beside the bound and the four-call library chain (two GEMVs, a
    subtraction and a dot in one CUDA graph);
30. K-P3 (the tail-ablation ladder, L6 K-B1's adaptive trial) at
    1000×2000: every rung L0…L6 and X variant against its plain version at
    K = 3, X2–X5 bit-identical to L6, a call's device operations, then µs
    per iteration and per trial at K = 5000 beside K-B1
    (``microsolve_lasso``) at the same K (L6 / K-B1), X1's adjoint from A
    in L2 against the rows on the chip, and the rungs at 16×16 beside
    K-B1's floor (128×16).

The line before the last is a JSON object describing each kernel, with
its bound: the larger of the bytes it must move (each input read once,
each output written once) over 3.35 TB/s and its float32 operations
over 67 TFLOP/s (the H100 SXM data sheet).  A whole-solve kernel's
operations are counted from its body for the line-search trials and
iterations of the measured run; ``hbm_state_ms`` adds, for those
kernels, the time to move the state of every iteration once through
device memory (the kernels keep it in L2); K-B1's and K-B8's entries also
give the launches by route that their route counters counted over the
whole phase, its timed runs included (the dense and tile plans
themselves, computed on the host, are printed in the phases' lines).
The last line is
``{"ok": true, "device": {...}}``.  There is no CPU path: without a CUDA
device the script fails at once.  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py needs a CUDA device; none is available")

import fasta_tpu_torch as ftt  # noqa: E402
from fasta_tpu_torch import checkpoint, problems, profiling  # noqa: E402
from fasta_tpu_torch.kernels import (_build, bf16_probe, lstsq_fused,  # noqa: E402
                                     matvec_probe, microsolver,
                                     microsolver_planar, microsolver_tv,
                                     planar_fused, planar_probe, prox_fused,
                                     tail_probe, tv_fused)
from reference_oracle.fasta_numpy import fasta as fasta_np  # noqa: E402
from reference_oracle.generators import make_lasso  # noqa: E402

DEV = torch.device("cuda", 0)
PROXES = microsolver.PROXES
# float64 references that a later phase reuses: phase 13's TV (dual
# objective, recovered image) and phase 17's phase-retrieval objective
REFS = {}


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


# H100 SXM data sheet: HBM3 bytes/s (profiling's rate) and float32
# (non-tensor-core) FLOP/s
HBM_BYTES_PER_S = profiling.H100_HBM_GBPS * 1e9
F32_FLOPS = 67e12


def graph_ms(fn, calls: int = 200) -> float:
    """Card time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, the replay timed by CUDA events (median of 3) and divided by
    ``calls``.  The graph takes the host's enqueueing out of the time;
    stream order still runs each call after the last."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, 3, warmup=1) / calls


def call_split(tag: str, fn, calls: int = 20, traced: bool = False) -> tuple:
    """A call of ``fn`` split: (card ms, host ms, device operations) — the
    card's time per call from a ``profiling.trace`` of ``calls`` calls, the
    host clock around 200 calls with no wait, and the calls with the
    kernels, memsets and copies the trace counted in them — printed.  The trace
    must show no memset and no copy, and no more kernels than calls (K-B4,
    K-B5, K-B7, K-P2: one kernel a call; the profiler may drop an event,
    so the card time is the mean kernel's).  A trace that holds no kernel
    event at all is taken again, up to twice; if none holds one, the split
    gives (None, host ms, 0 kernels), and with ``traced`` the phase fails:
    its device operations were not measured."""
    for _ in range(3):
        ops = profiling.device_ops(fn, calls, str(_build._BUILD_DIR.parent /
                                                  "chip_smoke_trace"))
        if ops["events"]["kernel"]:
            break
    host = profiling.host_us(fn, 200) / 1e3
    n = ops["events"]
    print(f"{tag} device operations in {calls} calls (trace): "
          f"{n['kernel']} kernels, {n['gpu_memset']} memsets, "
          f"{n['gpu_memcpy']} copies; host time per call (200 calls, no "
          f"wait) {host * 1e3:.2f} us")
    if n["kernel"] == 0:
        print(f"{tag} three traces held no kernel event: card time and "
              f"device operations not measured")
        require(not traced, f"{tag} no trace held a kernel event")
        return None, host, dict(calls=calls, **n)
    require(n["gpu_memset"] == 0 and n["gpu_memcpy"] == 0
            and n["kernel"] <= calls, f"{tag} one kernel and nothing else a "
                                      f"call")
    card = ops["dur_us"] / n["kernel"] / 1e3
    print(f"{tag} card time per call (trace) {card * 1e3:.3f} us")
    return card, host, dict(calls=calls, **n)


def split_keys(split: tuple, suffix: str = "") -> dict:
    """The kernels line's keys of a ``call_split``: card and host µs per
    call, and the device operations its trace counted in its calls (the
    profiler may drop a kernel event, never add one)."""
    card, host, ops = split
    return {f"card_us{suffix}": None if card is None else card * 1e3,
            f"host_us{suffix}": host * 1e3, f"device_ops{suffix}": ops}


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
    lstsq_fused.BF16_LAUNCHES = lstsq_fused.POINTWISE_BF16_LAUNCHES = 0
    planar_fused.BF16_LAUNCHES = bf16_probe.LAUNCHES = 0
    microsolver_planar.WIDE_LAUNCHES = 0
    microsolver_planar.WIDE_BATCH_LAUNCHES = 0
    microsolver.LAUNCHES = microsolver.PATH_LAUNCHES = 0
    tv_fused.LAUNCHES = 0
    microsolver_tv.LAUNCHES = microsolver_tv.PATH_LAUNCHES = 0
    microsolver_tv.LAUNCHES_RESIDENT = 0
    microsolver_tv.PATH_LAUNCHES_RESIDENT = 0
    microsolver_tv.BATCH_LAUNCHES_RESIDENT = 0
    planar_fused.LAUNCHES = microsolver_planar.LAUNCHES = 0
    planar_probe.LAUNCHES = 0
    prox_fused.LAUNCHES = 0
    microsolver.BATCH_LAUNCHES = microsolver_tv.BATCH_LAUNCHES = 0
    microsolver_planar.BATCH_LAUNCHES = 0
    matvec_probe.LAUNCHES = matvec_probe.CHECK_LAUNCHES = 0
    tail_probe.LAUNCHES = 0


def read_launches() -> dict:
    return {"K-B1": microsolver.LAUNCHES,
            "K-B1p": microsolver.PATH_LAUNCHES,
            "K-B3": lstsq_fused.LAUNCHES,
            "K-B3p": lstsq_fused.POINTWISE_LAUNCHES,
            "K-B5": tv_fused.LAUNCHES,
            "K-B6": microsolver_tv.LAUNCHES,
            "K-B6p": microsolver_tv.PATH_LAUNCHES,
            "K-B7": planar_fused.LAUNCHES,
            "K-B8": microsolver_planar.LAUNCHES,
            "K-P5": planar_probe.LAUNCHES,
            "K-B4": prox_fused.LAUNCHES,
            "K-B1b": microsolver.BATCH_LAUNCHES,
            "K-B6b": microsolver_tv.BATCH_LAUNCHES,
            "K-B6 resident": microsolver_tv.LAUNCHES_RESIDENT,
            "K-B6p resident": microsolver_tv.PATH_LAUNCHES_RESIDENT,
            "K-B6b resident": microsolver_tv.BATCH_LAUNCHES_RESIDENT,
            "K-B8b": microsolver_planar.BATCH_LAUNCHES,
            "K-B3 bf16": lstsq_fused.BF16_LAUNCHES,
            "K-B3p bf16": lstsq_fused.POINTWISE_BF16_LAUNCHES,
            "K-B7 bf16": planar_fused.BF16_LAUNCHES,
            "K-P4": bf16_probe.LAUNCHES,
            "K-B8w": microsolver_planar.WIDE_LAUNCHES,
            "K-B8bw": microsolver_planar.WIDE_BATCH_LAUNCHES,
            "K-P1": matvec_probe.LAUNCHES,
            "K-P2": matvec_probe.CHECK_LAUNCHES,
            "K-P3": tail_probe.LAUNCHES}


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


def dense_plan_line(m: int, n: int) -> str:
    """K-B1's dense plan on this card at m×n, as the host computes it
    (microsolver.dense_plan): the kernel, the route, the share of A's rows
    kept on the chip and the bytes of A an adaptive trial reads from L2.
    Printed beside the route counters; not a measurement."""
    plan = microsolver._tiles(DEV.index, m, (n + 3) // 4 * 4)[0]
    return (f"dense plan {plan.kernel}/{plan.route}, "
            f"{100.0 * plan.resident_share:.1f}% of A on the chip "
            f"({sum(plan.reg_rows)} rows in registers, "
            f"{sum(plan.smem_rows)} in shared memory), "
            f"{plan.streamed_bytes / 1e6:.2f} MB a trial from L2")


def dense_route_counts() -> tuple:
    return (microsolver.RESIDENT_LAUNCHES, microsolver.STREAMED_LAUNCHES,
            microsolver.COLUMN_LAUNCHES)


def dense_routes_ran(before: tuple) -> dict:
    """K-B1's launches (K-B1, K-B1p, K-B1b) by route since ``before`` (a
    ``dense_route_counts()``)."""
    return dict(zip(("resident", "streamed", "columns"),
                    (b - a for a, b in zip(before, dense_route_counts()))))


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
    print(f"[4 K-B1 1000x2000] {dense_plan_line(1000, 2000)}")
    before = dense_route_counts()
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
        tried = trials(out)[0]
        print(f"[4 K-B1 hp={hp}] iterations kernel {k1} plain {k2}; status "
              f"{out.status}/{ref.status}; taus[:{kt}] max rel {tau_err:.2e} "
              f"(tol 1e-3); residuals allclose(1e-3, 1e-6) {res_ok}; "
              f"max|dx| {x_err:.2e} (tol 1e-5); solve to tol 1e-6: kernel "
              f"{kern:.3f} ms (median of 10; {tried} trials, "
              f"{kern / tried * 1e3:.3f} us a trial, launch included), plain "
              f"loop on the card {plain:.3f} ms (median of 3)")
        require(out.status == ref.status == "converged",
                f"K-B1 hp={hp} status {out.status} vs {ref.status}")
        require(abs(k1 - k2) <= 2, f"K-B1 hp={hp} iterations {k1} vs {k2}")
        require(tau_err <= 1e-3 and res_ok and x_err <= 1e-5,
                f"K-B1 hp={hp} disagrees with its plain version")
        worst = max(worst, x_err)
        times[hp] = (kern, plain, trials(out))
    ran = dense_routes_ran(before)
    print(f"[4 K-B1] launches by route during the phase: {ran}")
    require(ran["streamed"] == ran["columns"] == 0 and ran["resident"] > 0,
            f"K-B1 at 1000x2000 left the resident route: {ran}")
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
                us_per_trial=times[False][0] / tried * 1e3,
                phase_launches_by_route=ran,
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
    before = dense_route_counts()
    for loss, (name, tau0, mu) in DENSE.items():
        p = problems.build(name, device=DEV)
        A, x0 = p.op.A, p.x0
        print(f"[7 K-B1 {name} {A.shape[0]}x{A.shape[1]}] "
              f"{dense_plan_line(*A.shape)}")
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
            tried = trials(out)[0]
            print(f"[7 K-B1 {loss} x {prox} {mode} hp={hp}] iterations "
                  f"kernel {k1} plain {k2}; status {out.status}/{ref.status}; "
                  f"taus[:{kt}] max rel {tau_err:.2e}; residuals[:{kt}] "
                  f"allclose {res_ok}; backtracks[:{kt}] equal {bt_ok}; "
                  f"max|dx| {x_err:.2e} (tol {x_tol:.1e}); objective rel "
                  f"{rel_f:.2e} (tol 1e-5); held to {rule}; "
                  f"{'30 iterations' if fista_f32 else 'to tol 1e-5'}: "
                  f"kernel {kern:.3f} ms (median of 5; "
                  f"{kern / tried * 1e3:.3f} us a trial, launch included), "
                  f"plain loop on the card {plain:.3f} ms (one run)")
            require(ok, f"K-B1 {loss} x {prox} {mode} hp={hp} disagrees "
                    f"with its plain version")
            if not fista_f32 and loss != "logistic":
                worst = max(worst, x_err)
            timed[(loss, prox, accelerate, hp)] = (kern, plain)
    ran = dense_routes_ran(before)
    print(f"[7 K-B1] launches by route during the phase: {ran}")
    require(ran["streamed"] == ran["columns"] == 0,
            f"a dense family problem left the resident route: {ran}")
    return dict(max_abs_err_pairs=worst, phase_launches_by_route_pairs=ran,
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
    print(f"[8 K-B1p 1000x2000] {dense_plan_line(1000, 2000)}")
    before = dense_route_counts()
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
        tried = trials(ker)[0]
        print(f"[8 K-B1p {name}] iterations per mu kernel {ks} (total "
              f"{sum(ks)}), plain {kr} (total {sum(kr)}); statuses "
              f"{ker.halt.tolist()}; max|dx| {err:.2e}; objective max rel "
              f"{rel:.2e} (tol 1e-5); path: kernel {kern:.3f} ms (median "
              f"of 5; {kern / tried * 1e3:.3f} us a trial, launch "
              f"included), plain loop on the card {plain:.3f} ms (one run)")
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
    ran = dense_routes_ran(before)
    print(f"[8 K-B1p] launches by route during the phase: {ran}")
    require(ran["streamed"] == ran["columns"] == 0,
            f"K-B1p left the resident route: {ran}")
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
                us_per_trial=out["warm"][1] / tried * 1e3,
                phase_launches_by_route=ran,
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
        card, host, _ = call_split(f"[10 K-B5 {h}x{w}]", kernel_fn)
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
        ms[(h, w)] = (kern, plain, kern_stream, plain_stream, card, host)
        del p, b, d, g, d0, g0
    main, big = ms[(512, 512)], ms[(4096, 4096)]
    # per pixel, from csrc/tv_fused.cu: d = μ·div p (4), r = d − b (1), Σr²
    # (2), g = μ·grad r (4); the halo the kernel recomputes is not counted
    return dict(max_abs_err=worst, ms=main[2], plain_ms=main[3],
                **bound(24.0 * 512 * 512, 11.0 * 512 * 512),
                library_ms=None, shape="512x512, stream time",
                card_ms=main[4], host_ms=main[5],
                call_ms=main[0], plain_call_ms=main[1],
                card_ms_509x517=ms[(509, 517)][4],
                host_ms_509x517=ms[(509, 517)][5],
                stream_ms_4096x4096=big[2], plain_stream_ms_4096x4096=big[3],
                card_ms_4096x4096=big[4], host_ms_4096x4096=big[5],
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
            before = microsolver_tv.LAUNCHES_RESIDENT
            out = microsolver_tv.microsolve_tv(b, p0, 2.0, mu, **kw)
            require(microsolver_tv.LAUNCHES_RESIDENT == before + 1,
                    "K-B6 at 512x512 did not take the resident route")
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
    glob = tv_global_route(mu)
    worst = max(worst, glob.pop("image_err"))
    split = tv_split(b, p0, mu)
    kern, plain, (tried, k) = timed[(False, True)]
    h = w = 512
    hbm_state = k * tv_iteration_bytes(h, w, False) / HBM_BYTES_PER_S * 1e3
    print(f"[11 K-B6] resident route at 512x512: {kern / k * 1e3:.3f} us an "
          f"iteration to tol 1e-5, "
          f"{split['us_per_iteration']:.3f} us at 2000 iterations; 16x16 "
          f"floor {split['floor_us_per_iteration']:.3f} us an iteration; "
          f"global route at 2048x2048 "
          f"{glob['us_per_iteration']:.3f} us an iteration; hbm_state_ms "
          f"{hbm_state:.3f} (36 B a pixel an iteration through HBM)")
    # b and p₀ in; p and the k entries of taus, residuals and backtracks
    # out
    return dict(max_abs_err=worst, ms=kern, plain_ms=plain,
                **bound(4.0 * (h * w + 2 * h * w + 2 * h * w + 3 * k),
                        tv_flops(h, w, tried, k, 1, False)),
                hbm_state_ms=hbm_state,
                library_ms=None, iterations=k, trials=tried,
                ms_fista=timed[(True, True)][0],
                plain_ms_fista=timed[(True, True)][1],
                iterations_fista=timed[(True, True)][2][1], **split,
                global_route_2048x2048=glob)


def tv_split(b, p0, mu, iters: int = 2000) -> dict:
    """K-B6 adaptive, hp, for a fixed ``iters`` iterations at 512×512 (b)
    and at 16×16, where a trial is only its barrier, reductions and
    decision: µs an iteration (CUDA events around one launch, median of
    3), both on the resident route."""
    small = problems.build("tv", h=16, w=16, device=DEV)
    out = {}
    for tag, (bb, pp, m) in (("", (b, p0, mu)),
                             ("floor_", (small.fterm.b, small.x0,
                                         float(small.instance["mu"])))):
        before = microsolver_tv.LAUNCHES_RESIDENT
        ms = cuda_ms(lambda: microsolver_tv.microsolve_tv(
            bb, pp, 2.0, m, max_iters=iters, tol=0.0,
            stop_rule="iterations"), 3, warmup=1)
        require(microsolver_tv.LAUNCHES_RESIDENT == before + 4,
                f"K-B6 at {tuple(bb.shape)} left the resident route")
        out[f"{tag}us_per_iteration"] = ms / iters * 1e3
    return out


def tv_global_route(mu, side: int = 2048, iters: int = 300) -> dict:
    """K-B6 past the resident route's gate, at side×side on the global
    route: 300 iterations, adaptive, hp, against the plain version under
    phase 11's checks (the first 10 taus rtol 1e-3, residuals rtol 1e-3 /
    atol 1e-6, backtracks equal, the float64 dual objective within 1e-5),
    then µs an iteration (median of 3)."""
    prob = problems.build("tv", h=side, w=side, device=DEV)
    b, p0 = prob.fterm.b, prob.x0
    kw = dict(max_iters=iters, tol=0.0, stop_rule="iterations",
              record_bts=True)
    before = (microsolver_tv.LAUNCHES, microsolver_tv.LAUNCHES_RESIDENT)
    out = microsolver_tv.microsolve_tv(b, p0, 2.0, mu, **kw)
    require((microsolver_tv.LAUNCHES, microsolver_tv.LAUNCHES_RESIDENT)
            == (before[0] + 1, before[1]),
            f"K-B6 at {side}x{side} did not take the global route")
    ref = microsolver_tv.microsolve_tv_reference(b, p0, 2.0, mu, **kw)
    torch.cuda.synchronize()
    tau_err = float(((out.taus[:10] - ref.taus[:10]).abs()
                     / ref.taus[:10]).max())
    res_ok = torch.allclose(out.residuals[:10], ref.residuals[:10],
                            rtol=1e-3, atol=1e-6)
    bt_ok = torch.equal(out.backtracks[:10], ref.backtracks[:10])
    f1, f2 = tv_objective(b, mu, out.x), tv_objective(b, mu, ref.x)
    rel_f = abs(f1 - f2) / abs(f2)
    img = tv_image_err(b, mu, out.x, ref.x)
    ms = cuda_ms(lambda: microsolver_tv.microsolve_tv(b, p0, 2.0, mu, **kw),
                 3, warmup=1)
    print(f"[11 K-B6 global route {side}x{side}] {iters} iterations: taus[:10] "
          f"max rel {tau_err:.2e} (tol 1e-3); residuals[:10] allclose "
          f"{res_ok}; backtracks[:10] equal {bt_ok}; objective rel "
          f"{rel_f:.2e} (tol 1e-5); image max|dx| {img:.2e}; kernel "
          f"{ms:.3f} ms (median of 3, {ms / iters * 1e3:.3f} us an "
          f"iteration)")
    require(tau_err <= 1e-3 and res_ok and bt_ok and rel_f <= 1e-5,
            "K-B6's global route disagrees with its plain version")
    return dict(ms=ms, us_per_iteration=ms / iters * 1e3, iterations=iters,
                image_err=img,
                hbm_state_ms=iters * tv_iteration_bytes(side, side, False)
                / HBM_BYTES_PER_S * 1e3)


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
        before = microsolver_tv.PATH_LAUNCHES_RESIDENT
        ker = microsolver_tv.microsolve_tv_path(b, p0, 2.0, TV_MUS, warm=warm,
                                                **kw)
        require(microsolver_tv.PATH_LAUNCHES_RESIDENT == before + 1,
                "K-B6p at 512x512 did not take the resident route")
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
    REFS["tv"] = (obj_ref, x_ref)
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
    for kernel in ("K-B6", "K-B6p"):
        require(launches[f"{kernel} resident"] == launches[kernel],
                f"{kernel} left the resident route at 512x512: {launches}")
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


def planar_data(m: int, n: int, seed: int):
    """Seeded planar channel matrices scaled as the generator scales A,
    x (n, 2), planar measurements and hinge magnitudes, on the card."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    Ar = torch.randn((m, n), generator=gen, device=DEV) / (2 * m) ** 0.5
    Ai = torch.randn((m, n), generator=gen, device=DEV) / (2 * m) ** 0.5
    x = torch.randn((n, 2), generator=gen, device=DEV)
    bl = torch.randn((m, 2), generator=gen, device=DEV)
    bh = torch.rand(m, generator=gen, device=DEV) + 0.1
    return Ar, Ai, x, bl, bh


def planar_gradmap_bytes(m: int, n: int, hinge: bool) -> float:
    """K-B7's inputs read once and outputs written once: Ar, Ai, x, b
    (m for the hinge, 2m for least squares), d (2m) and g (2n)."""
    return 4.0 * (2 * m * n + 2 * n + (m if hinge else 2 * m) + 2 * m
                  + 2 * n)


def planar_plan_line(phase: int, m: int, n: int, bf16: bool) -> str:
    """K-B7's launch plan for an m×n call (``gradmap_plan``) and the
    clusters of 8 blocks the card holds at once for its kernel."""
    return (f"[{phase} K-B7 {m}x{n}{' bf16' if bf16 else ''}] plan "
            f"{planar_fused._plan(0, m, n, bf16)}; the card holds "
            f"{planar_fused._card_plan(0, m, n, bf16)[-1]} clusters of "
            f"{planar_fused.CLUSTER} blocks of this kernel at once")


def phase_planar_gradmap() -> dict:
    """K-B7 against the plain two-pass form on the same seeded inputs,
    both losses, with phase 3's tolerance: max|Δd|, max|Δg| ≤
    1e-5·max(1, max|ref|) and |Δf| ≤ 1e-5·|f| (float32 sums in another
    order), and a second call's bits.  Operations: 16·m·n for the two
    products.  The hinge form at 16384×256 and 16384×4096 split into card
    time, host time and device operations (one kernel a call)."""
    worst, ms, splits = 0.0, {}, {}
    for i, (m, n) in enumerate(((16384, 256), (1000, 37), (16384, 4096))):
        Ar, Ai, x, bl, bh = planar_data(m, n, 10 + i)
        print(planar_plan_line(14, m, n, False))
        for loss, fused, ref, b in (
                ("hinge", planar_fused.fused_planar_hinge_gradmap,
                 planar_fused.planar_hinge_gradmap_reference, bh),
                ("lstsq", planar_fused.fused_planar_lstsq_gradmap,
                 planar_fused.planar_lstsq_gradmap_reference, bl)):
            d, f, g = fused(Ar, Ai, x, b)
            d0, f0, g0 = ref(Ar, Ai, x, b)
            torch.cuda.synchronize()
            err_d = float((d - d0).abs().max())
            err_g = float((g - g0).abs().max())
            rel_f = abs(float(f) - float(f0)) / abs(float(f0))
            tol_d = 1e-5 * max(1.0, float(d0.abs().max()))
            tol_g = 1e-5 * max(1.0, float(g0.abs().max()))
            same = all(torch.equal(u, v) for u, v in
                       zip((d, f, g), fused(Ar, Ai, x, b)))
            kernel_fn = lambda: fused(Ar, Ai, x, b)  # noqa: E731
            plain_fn = lambda: ref(Ar, Ai, x, b)  # noqa: E731
            kern, plain = cuda_ms(kernel_fn, 20), cuda_ms(plain_fn, 20)
            kern_stream, plain_stream = stream_ms(kernel_fn), stream_ms(plain_fn)
            nbytes = planar_gradmap_bytes(m, n, loss == "hinge")
            bd = bound(nbytes, 16.0 * m * n)
            print(f"[14 K-B7 {loss} {m}x{n}] max|dd| {err_d:.3e} (tol "
                  f"{tol_d:.1e}) max|dg| {err_g:.3e} (tol {tol_g:.1e}) rel df "
                  f"{rel_f:.3e} (tol 1e-5); call, median of 20: kernel "
                  f"{kern:.4f} ms, plain {plain:.4f} ms; stream time, 20 "
                  f"back-to-back runs: kernel {kern_stream:.4f} ms, plain "
                  f"{plain_stream:.4f} ms; kernel reads Ar and Ai once: "
                  f"{2 * m * n * 4 / kern_stream / 1e6:.1f} GB/s of stream "
                  f"time; bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}); "
                  f"second call equal {same}")
            require(err_d <= tol_d and err_g <= tol_g and rel_f <= 1e-5
                    and same,
                    f"K-B7 {loss} {m}x{n} disagrees with its plain version")
            if loss == "hinge" and m == 16384:
                splits[n] = call_split(f"[14 K-B7 {loss} {m}x{n}]",
                                       kernel_fn)
            worst = max(worst, err_d, err_g)
            ms[(loss, m, n)] = (kern, plain, kern_stream, plain_stream,
                                bd["bound_ms"])
        del Ar, Ai
    main, big = ms[("hinge", 16384, 256)], ms[("hinge", 16384, 4096)]
    lsq = ms[("lstsq", 16384, 256)]
    m, n = 16384, 256
    return dict(max_abs_err=worst, ms=main[0], plain_ms=main[1],
                **bound(planar_gradmap_bytes(m, n, True), 16.0 * m * n),
                library_ms=None, shape="hinge 16384x256",
                **split_keys(splits[256]),
                **split_keys(splits[4096], "_16384x4096"),
                stream_ms=main[2], plain_stream_ms=main[3],
                lstsq_ms=lsq[0], lstsq_plain_ms=lsq[1],
                lstsq_stream_ms=lsq[2], lstsq_plain_stream_ms=lsq[3],
                stream_ms_16384x4096=big[2],
                plain_stream_ms_16384x4096=big[3],
                bound_ms_16384x4096=big[4],
                stream_ms_1000x37=ms[("hinge", 1000, 37)][2],
                plain_stream_ms_1000x37=ms[("hinge", 1000, 37)][3])


# K-B8's storage (csrc/microsolver_planar.cu kInterleaved = false)
PLANAR_LAYOUT = "split"


def phase_planar_probe() -> dict:
    """K-P5 at 16384×256: each layout's last of 3 chained pairs against
    the plain PlanarDenseOp pairs (max|Δ| ≤ 1e-5 of the largest entry),
    then µs per pair as the difference of a 1100- and a 100-pair launch
    over 1000 (the launch and the layout copy cancel), best of 3, each
    layout in turns twice (in order, then reversed).  Implied GB/s counts
    one read of both channel matrices per pair.  The fastest layout by the
    mean of its two turns decides K-B8's storage, unless the split
    layout is within the spread of the turns: then the layout that needs
    no copy wins, since K-B8's copy counts in its time."""
    m, n = 16384, 256
    Ar, Ai, x, _, _ = planar_data(m, n, 20)
    worst = 0.0
    for variant in planar_probe.VARIANTS:
        out = planar_probe.planar_probe(Ar, Ai, x, 3, variant)
        ref = planar_probe.planar_probe_reference(Ar, Ai, x, 3)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        tol = 1e-5 * float(ref.abs().max())
        print(f"[15 K-P5 {variant}] last of 3 pairs max|dg| {err:.3e} (tol "
              f"{tol:.1e})")
        require(err <= tol, f"K-P5 {variant} disagrees with its plain version")
        worst = max(worst, err)
    plain = cuda_ms(lambda: planar_probe.planar_probe_reference(Ar, Ai, x, 10),
                    5) / 10

    def launch_ms(variant, K):
        best = float("inf")
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            planar_probe.planar_probe(Ar, Ai, x, K, variant)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        return best

    reset_launches()
    turns = {v: [] for v in planar_probe.VARIANTS}
    for order in (planar_probe.VARIANTS, planar_probe.VARIANTS[::-1]):
        for variant in order:
            launch_ms(variant, 100)                      # warm-up
            per = (launch_ms(variant, 1100) - launch_ms(variant, 100)) / 1000
            turns[variant].append(per)
    launches = read_launches()
    one_read = 2.0 * m * n * 4
    mean = {v: statistics.mean(t) for v, t in turns.items()}
    for v, t in turns.items():
        print(f"[15 K-P5 {v}] {mean[v] * 1e3:.3f} us per pair (turns "
              f"{', '.join(f'{u * 1e3:.3f}' for u in t)}); "
              f"{one_read / (mean[v] * 1e-3) / 1e9:.1f} GB/s implied (one "
              f"read of Ar and Ai per pair)")
    fastest = min(mean, key=mean.get)
    spread = max(max(t) - min(t) for t in turns.values())
    tie = mean["split"] - mean[fastest] <= spread
    chosen = "split" if tie else fastest
    print(f"[15 K-P5] fastest {fastest} ({mean[fastest] * 1e3:.3f} us); "
          f"split {mean['split'] * 1e3:.3f} us, within the turns' spread "
          f"({spread * 1e3:.3f} us): {tie}; layout by the rule: {chosen}; "
          f"K-B8 uses {PLANAR_LAYOUT}; plain pair {plain * 1e3:.3f} us; "
          f"launches during the timed runs: {launches['K-P5']}")
    require(launches["K-P5"] >= 1, "the probe's timed runs launched no K-P5")
    return dict(max_abs_err=worst, ms=mean[PLANAR_LAYOUT], plain_ms=plain,
                **bound(one_read + 4.0 * 4 * n, 16.0 * m * n),
                library_ms=None, launches_timed=launches["K-P5"],
                shape="16384x256, per chained pair",
                us_per_pair={v: mean[v] * 1e3 for v in mean},
                layout_by_rule=chosen, layout_used=PLANAR_LAYOUT)


def planar_flops(m: int, n: int, tried: int, accepted: int,
                 accelerate: bool) -> float:
    """float32 operations of K-B8 (csrc/microsolver_planar.cu), counted as
    in ``dense_flops``, n-sized work over both channels.  Per trial: the
    step x̂ = x − τg and x₁ = x̂ + τc (4 per entry), Δx and x₁ − x̂ (2),
    ‖Δx‖², ‖g‖², ‖x₁ − x̂‖², ⟨c, x₁⟩, ⟨Δx, g⟩ (10), FISTA's restart dot
    (4) besides; on the rows, A x₁ (8 per complex entry: 8mn) and the hinge
    with its f term (10 per row); adaptive, the adjoint (8mn) and per entry
    x̂ again, Δg, ⟨Δx,Δg⟩ and ‖Δg‖² (10).  Per FISTA acceptance: d_n
    (6 per row), the hinge (10), the adjoint (8mn), y_n (3 per entry).
    The start: A x₀ and its adjoint (16mn) and the hinge (10m)."""
    if accelerate:
        per_trial = 8 * m * n + 10 * m + 2 * n * 20
        per_accept = 8 * m * n + 16 * m + 2 * n * 3
    else:
        per_trial = 16 * m * n + 10 * m + 2 * n * 26
        per_accept = 0
    return float(tried * per_trial + accepted * per_accept
                 + 16 * m * n + 10 * m)


def phase_objective(A, b, c, x) -> float:
    """½Σmax(|Ax| − b, 0)² − Re⟨c, x⟩ of a complex signal, in float64 on
    the host."""
    x = np.asarray(x, np.complex128)
    r = np.maximum(np.abs(A @ x) - b, 0.0)
    return float(0.5 * np.sum(r * r) - np.real(np.vdot(c, x)))


def planar_complex(x) -> np.ndarray:
    x = x.detach().cpu().double().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float64)
    return x[..., 0] + 1j * x[..., 1]


def planar_plan(m: int, n: int) -> dict:
    """K-B8's tile plan on this card at m×n, as the host computes it: the
    kernel, the route, the share of A's rows kept on the chip and the
    bytes a trial reads from L2 (microsolver_planar.tile_plan).  Printed
    beside the route counters; not a measurement."""
    plan = microsolver_planar._tiles(DEV.index, m, (n + 3) // 4 * 4)[0]
    return dict(tile_kernel=plan.kernel, tile_route=plan.route,
                resident_share=plan.resident_share,
                l2_bytes_per_trial=plan.streamed_bytes)


def route_counts() -> tuple:
    return (microsolver_planar.RESIDENT_LAUNCHES,
            microsolver_planar.STREAMED_LAUNCHES,
            microsolver_planar.COLUMN_LAUNCHES)


def routes_ran(before: tuple) -> dict:
    """K-B8's launches by route since ``before`` (a ``route_counts()``)."""
    return dict(zip(("resident", "streamed", "columns"),
                    (b - a for a, b in zip(before, route_counts()))))


def phase_planar_microsolver() -> dict:
    """K-B8 against its plain version on the card at 16384×256 (τ₀ 1.0).
    The first 10 taus and residuals rtol 1e-3 and backtracks equal: the
    two sum the rows' float32 products in another order, which the hinge
    carries into τ at the 1e-4 level by the tenth iteration.  hp to tol
    1e-5: both converge; hp off, 300 iterations (its float32 window can
    stall short of tol 1e-5); FISTA hp (restart_dd) to tol 1e-5.  The
    float64 objective of each solution within rel 1e-6 of the plain
    version's.  A nonfinite τ₀ aborts with status "nonfinite"."""
    prob = problems.build("phase_retrieval", planar=True, device=DEV)
    data = (prob.op.Ar, prob.op.Ai, prob.fterm.b, prob.gterm.c, prob.x0)
    inst = prob.instance
    A, bm = inst["A"], inst["b"]
    c = inst["delta"] * inst["x0_hat"]
    worst, timed = 0.0, {}
    plan = planar_plan(16384, 256)
    before = route_counts()
    for accelerate, hp in ((False, True), (False, False), (True, True)):
        kw = dict(max_iters=2000, tol=1e-5, hp=hp, accelerate=accelerate,
                  restart_dd=hp, record_bts=True)
        if not hp:
            kw.update(max_iters=300, tol=0.0, stop_rule="iterations")
        out = microsolver_planar.microsolve_planar_phasemax(*data, 1.0, **kw)
        t0 = time.perf_counter()
        ref = microsolver_planar.microsolve_planar_phasemax_reference(
            *data, 1.0, **kw)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        kern = cuda_ms(lambda: microsolver_planar.microsolve_planar_phasemax(
            *data, 1.0, **kw), 3, warmup=1)
        k1, k2 = int(out.iteration_count), int(ref.iteration_count)
        kt = min(k1, k2, 10)
        tau_err = float(((out.taus[:kt] - ref.taus[:kt]).abs()
                         / ref.taus[:kt]).max())
        res_ok = torch.allclose(out.residuals[:kt], ref.residuals[:kt],
                                rtol=1e-3, atol=1e-6)
        bt_ok = torch.equal(out.backtracks[:kt], ref.backtracks[:kt])
        f1 = phase_objective(A, bm, c, planar_complex(out.x))
        f2 = phase_objective(A, bm, c, planar_complex(ref.x))
        rel_f = abs(f1 - f2) / abs(f2)
        x_err = float((out.x - ref.x).abs().max())
        status_ok = (out.status == ref.status == "converged" if hp
                     else k1 == k2 == 300)
        mode = "FISTA" if accelerate else "adaptive"
        tried = trials(out)[0]
        print(f"[16 K-B8 {mode} hp={hp}] iterations kernel {k1} plain {k2}; "
              f"status {out.status}/{ref.status}; taus[:{kt}] max rel "
              f"{tau_err:.2e} (tol 1e-3); residuals[:{kt}] allclose(1e-3) "
              f"{res_ok}; backtracks[:{kt}] equal {bt_ok}; max|dx| "
              f"{x_err:.2e}; objective {f1:.12g} vs {f2:.12g}, rel "
              f"{rel_f:.2e} (tol 1e-6); "
              f"{'to tol 1e-5' if hp else '300 iterations'}: kernel "
              f"{kern:.3f} ms (median of 3, {kern / k1 * 1e3:.2f} us per "
              f"iteration, {tried} trials, {kern / tried * 1e3:.2f} us per "
              f"trial), plain loop on the card {plain:.3f} ms (one run)")
        require(status_ok and tau_err <= 1e-3 and res_ok and bt_ok
                and rel_f <= 1e-6,
                f"K-B8 {mode} hp={hp} disagrees with its plain version")
        worst = max(worst, x_err)
        timed[(accelerate, hp)] = (kern, plain, trials(out))
    bad = microsolver_planar.microsolve_planar_phasemax(*data, float("nan"),
                                                        max_iters=50)
    bad_ref = microsolver_planar.microsolve_planar_phasemax_reference(
        *data, float("nan"), max_iters=50)
    print(f"[16 K-B8] tau0 = nan: kernel {bad.status} after "
          f"{int(bad.iteration_count)} iterations, plain {bad_ref.status} "
          f"after {int(bad_ref.iteration_count)}")
    require(bad.status == bad_ref.status == "nonfinite",
            "K-B8 did not abort a nonfinite solve")
    ran = routes_ran(before)
    print(f"[16 K-B8] tile plan at 16384x256: {plan}; launches by route in "
          f"this phase: {ran}")
    require(plan["tile_route"] == "resident" and ran["resident"] > 0
            and ran["streamed"] == ran["columns"] == 0,
            f"K-B8 at 16384x256 did not keep A on the chip: {plan}, {ran}")
    kern, plain, (tried, k) = timed[(False, True)]
    m, n = 16384, 256
    state = 2.0 * m * n * 4       # the channel matrices, once per trial
    # Ar, Ai, b, c, x₀ in; x and the k entries of taus, residuals and
    # backtracks out
    return dict(max_abs_err=worst, ms=kern, plain_ms=plain,
                **bound(4.0 * (2 * m * n + m + 4 * n + 2 * n + 3 * k),
                        planar_flops(m, n, tried, k, False)),
                hbm_state_ms=tried * state / HBM_BYTES_PER_S * 1e3,
                library_ms=None, phase_launches_by_route=ran,
                us_per_iteration=kern / k * 1e3,
                us_per_trial=kern / tried * 1e3, iterations=k, trials=tried,
                ms_hp_off_300=timed[(False, False)][0],
                plain_ms_hp_off_300=timed[(False, False)][1],
                ms_fista=timed[(True, True)][0],
                plain_ms_fista=timed[(True, True)][1],
                iterations_fista=timed[(True, True)][2][1])


def phase_pr_main_path() -> dict:
    """The phase-retrieval main path through the public entry points at
    16384×256 (τ₀ 1.0, tol 1e-5), against the float64 NumPy oracle on the
    host (adaptive, tol 1e-8): each objective within rtol 1e-5 of the
    oracle's and each solution, its global phase aligned to the oracle's,
    within rel 1e-3 (L2)."""
    prob = problems.build("phase_retrieval", planar=True)   # the card
    require(prob.op.Ar.is_cuda, "problems.build did not default to the card")
    prob.tau0 = 1.0
    inst = prob.instance
    A, bm = inst["A"], inst["b"]
    c = inst["delta"] * inst["x0_hat"]
    t0 = time.perf_counter()
    oracle = fasta_np(inst["op"], None, inst["f"], inst["gradf"], inst["g"],
                      inst["proxg"], inst["x0"], tau0=1.0, tol=1e-8,
                      max_iters=5000)
    oracle_s = time.perf_counter() - t0
    x_ref = np.asarray(oracle.solution)
    obj_ref = phase_objective(A, bm, c, x_ref)
    REFS["pr"] = obj_ref
    print(f"[17 phase main path] float64 oracle on the host: "
          f"converged={oracle.converged} in {oracle.iteration_count} "
          f"iterations ({oracle_s:.1f} s), objective {obj_ref:.12g}, "
          f"recovery error {prob.recovery_error(x_ref, recovered=True):.4e}")
    require(oracle.converged, "the float64 oracle did not converge")
    cplx = problems.build("phase_retrieval")                # complex64
    cplx.tau0 = 1.0

    reset_launches()
    runs = [("microsolve adaptive", prob.microsolve(max_iters=2000, tol=1e-5,
                                                    hp=True)),
            ("microsolve FISTA", prob.microsolve(max_iters=2000, tol=1e-5,
                                                 hp=True, accelerate=True)),
            ("solve adaptive", prob.solve(tol=1e-5, max_iters=2000)),
            ("solve FISTA", prob.solve(tol=1e-5, max_iters=2000,
                                       accelerate=True)),
            ("complex solve adaptive", cplx.solve(tol=1e-5,
                                                  max_iters=2000))]
    launches = read_launches()
    for what, r in runs:
        sol = r.solution
        x = (planar_complex(sol) if not what.startswith("complex")
             else np.asarray(sol, np.complex128))
        obj = phase_objective(A, bm, c, x)
        rel = abs(obj - obj_ref) / abs(obj_ref)
        phase = np.vdot(x, x_ref)
        x_rel = float(np.linalg.norm(x * phase / abs(phase) - x_ref)
                      / np.linalg.norm(x_ref))
        err = (prob if not what.startswith("complex") else cplx) \
            .recovery_error(sol)
        print(f"[17 phase main path] {what}: converged={r.converged} in "
              f"{r.iteration_count} iterations, objective {obj:.12g}: rel "
              f"{rel:.2e} (tol 1e-5); phase-aligned solution rel L2 "
              f"{x_rel:.2e} (tol 1e-3); recovery error {err:.4e}")
        require(r.converged, f"phase retrieval {what} did not converge")
        require(rel <= 1e-5 and x_rel <= 1e-3,
                f"phase retrieval {what} disagrees with the float64 oracle")
    print(f"[17 phase main path] launches during the solves: {launches}")
    for kernel in ("K-B7", "K-B8"):
        require(launches[kernel] >= 1,
                f"{kernel} never launched on the phase retrieval main path: "
                f"{launches}")
    require(all(launches[k] == 0 for k in ("K-B1", "K-B1p", "K-B3", "K-B3p",
                                            "K-B5", "K-B6", "K-B6p")),
            f"the phase retrieval path launched a dense or TV kernel: "
            f"{launches}")

    iters = 2000
    for accelerate in (False, True):
        kern = cuda_ms(lambda: prob.microsolve(
            max_iters=iters, tol=0.0, stop_rule="iterations", hp=True,
            accelerate=accelerate), 3, warmup=1)
        opts = ftt.FastaOptions(max_iters=iters, stop_rule="iterations",
                                accelerate=accelerate)
        loop_ms = cuda_ms(lambda: prob.solve_device(opts), 1, warmup=1)
        mode = "FISTA" if accelerate else "adaptive"
        print(f"[17 phase main path] {mode}, {iters} iterations: kernel path "
              f"{iters / kern * 1e3:.1f} it/s ({kern:.3f} ms), PyTorch loop "
              f"path {iters / loop_ms * 1e3:.1f} it/s ({loop_ms:.3f} ms)")
    return launches


# --------------------------------------------------------------------------
# Slice 5: K-B4, the batched whole-solve kernels and the serving path
# --------------------------------------------------------------------------

def stack_requests(b, B: int):
    """B requests' measurements: instance i's are b·(1 + 0.02·i) (the JAX
    package's batch tests' recipe, tests/unit/test_micro_batch.py)."""
    return torch.stack([b * (1.0 + 0.02 * i) for i in range(B)])


def identical(batch, singles) -> bool:
    """Every instance of a batched output equal, field by field, to its
    own single launch."""
    return all(b is None or torch.equal(a[i], b)
               for i, one in enumerate(singles) for a, b in zip(batch, one))


def prefix_ok(out, i, ref) -> tuple:
    """Phase 4's prefix checks of instance i of a batched output against a
    plain run: (first 10 taus' max rel, residuals allclose(1e-3, 1e-6),
    backtracks equal)."""
    k = min(int(out.iteration_count[i]), int(ref.iteration_count), 10)
    tau_err = float(((out.taus[i, :k] - ref.taus[:k]).abs()
                     / ref.taus[:k]).max())
    res = torch.allclose(out.residuals[i, :k], ref.residuals[:k], rtol=1e-3,
                         atol=1e-6)
    return tau_err, res, torch.equal(out.backtracks[i, :k], ref.backtracks[:k])


def phase_shrink_step() -> dict:
    """K-B4 against its plain version on the same seeded rows, a τ and a μ
    per row: x₁ bit for bit (both round each operation alike: the _rn
    intrinsics), the float64 sums within rtol 1e-10 (their order), the
    same sums on a second call (no atomics), and a NaN carried into x₁ and
    every sum.  Call time (median of 20) and stream time (20 back-to-back
    calls) at 1×2000 (a trial of the LASSO loop), 32×2000 (a trial of the
    serving batch loop) and 1×2²⁴ (streaming), against the bound of 12
    bytes per entry (x₀ and g read, x₁ written) over 3.35 TB/s."""
    gen = torch.Generator(device=DEV).manual_seed(18)
    worst, ms = 0.0, {}
    for R, n in ((1, 2000), (1, 128), (1, 100), (32, 2000), (1, 1 << 24)):
        x0 = torch.randn((R, n), generator=gen, device=DEV)
        g = torch.randn((R, n), generator=gen, device=DEV)
        tau = torch.rand(R, generator=gen, device=DEV) + 0.05
        mu = torch.rand(R, generator=gen, device=DEV)
        out = prox_fused.fused_shrink_step(x0, g, tau, mu)
        ref = prox_fused.shrink_step_reference(x0, g, tau, mu)
        again = prox_fused.fused_shrink_step(x0, g, tau, mu)
        torch.cuda.synchronize()
        err = float((out[0] - ref[0]).abs().max())
        rel = max(float(((a - b).abs() / b.abs()).max())
                  for a, b in zip(out[1:], ref[1:]))
        same = all(torch.equal(a, b) for a, b in zip(out, again))
        line = (f"[18 K-B4 {R}x{n}] max|dx1| {err:.1e} (tol 0: bit for bit); "
                f"sums max rel {rel:.2e} (tol 1e-10); second call equal "
                f"{same}")
        require(err == 0.0 and rel <= 1e-10 and same,
                f"K-B4 {R}x{n} disagrees with its plain version")
        worst = max(worst, err)
        if n in (2000, 1 << 24):
            kernel_fn = lambda: prox_fused.fused_shrink_step(  # noqa: E731
                x0, g, tau, mu)
            plain_fn = lambda: prox_fused.shrink_step_reference(  # noqa: E731
                x0, g, tau, mu)
            kern, plain = cuda_ms(kernel_fn, 20), cuda_ms(plain_fn, 20)
            ks, ps = stream_ms(kernel_fn), stream_ms(plain_fn)
            card, host, _ = call_split(f"[18 K-B4 {R}x{n}]", kernel_fn)
            bd = bound(12.0 * R * n, 16.0 * R * n)
            line += (f"; call, median of 20: kernel {kern:.4f} ms, plain "
                     f"{plain:.4f} ms; stream time, 20 back-to-back calls: "
                     f"kernel {ks:.4f} ms, plain {ps:.4f} ms; "
                     f"{12.0 * R * n / ks / 1e6:.1f} GB/s of stream time; "
                     f"bound {bd['bound_ms']:.5f} ms ({bd['bound_by']})")
            ms[(R, n)] = (kern, plain, ks, ps, bd["bound_ms"], card, host)
        print(line)
        del x0, g
    x0 = torch.randn(2000, generator=gen, device=DEV)
    x0[700] = float("nan")
    g = torch.randn(2000, generator=gen, device=DEV)
    out = prox_fused.fused_shrink_step(x0, g, 0.3, 0.5)
    ref = prox_fused.shrink_step_reference(x0, g, 0.3, 0.5)
    nan_ok = (bool(torch.isnan(out[0][700]))
              and torch.equal(torch.isnan(out[0]), torch.isnan(ref[0]))
              and all(bool(torch.isnan(s)) for s in out[1:]))
    print(f"[18 K-B4] a NaN entry stays NaN in x1 and in the three sums: "
          f"{nan_ok}")
    require(nan_ok, "K-B4 dropped a NaN")
    main, one, big = ms[(32, 2000)], ms[(1, 2000)], ms[(1, 1 << 24)]
    return dict(max_abs_err=worst, ms=main[0], plain_ms=main[1],
                **bound(12.0 * 32 * 2000, 16.0 * 32 * 2000), library_ms=None,
                shape="32x2000 (a batch-loop trial), call time",
                card_ms=main[5], host_ms=main[6],
                stream_ms=main[2], plain_stream_ms=main[3],
                ms_1x2000=one[0], plain_ms_1x2000=one[1],
                stream_ms_1x2000=one[2], plain_stream_ms_1x2000=one[3],
                card_ms_1x2000=one[5], host_ms_1x2000=one[6],
                bound_ms_1x2000=one[4], stream_ms_1x2pow24=big[2],
                plain_stream_ms_1x2pow24=big[3], bound_ms_1x2pow24=big[4],
                card_ms_1x2pow24=big[5], host_ms_1x2pow24=big[6])


def phase_batch_dense() -> dict:
    """K-B1b on LASSO 1000×2000, 32 instances (b·(1 + 0.02·i), τ₀ 0.05,
    0.075 or 0.1 by i mod 3), adaptive and FISTA (restart_dd), hp, tol
    1e-6: every instance bit-identical (x, records, count, status) to a
    separate K-B1 launch; the first and the last instance against the
    plain batch with phase 4's tolerances (status, counts within 2, the
    first 10 taus rtol 1e-3, residuals and backtracks) and the float64
    objective within 1e-5."""
    prob = problems.build("lasso", device=DEV)
    A, x0, inst = prob.op.A, prob.x0, prob.instance
    B = 32
    bs = stack_requests(prob.fterm.b, B)
    t0s = torch.tensor([0.05 * (1.0 + (i % 3) / 2.0) for i in range(B)],
                       device=DEV)
    timed, worst = {}, 0.0
    print(f"[19 K-B1b 1000x2000] {dense_plan_line(1000, 2000)}")
    before = dense_route_counts()
    for accelerate in (False, True):
        kw = dict(max_iters=5000, tol=1e-6, hp=True, accelerate=accelerate,
                  restart_dd=True, record_bts=True)
        out = microsolver.microsolve_lasso_batch(A, bs, x0, t0s, 0.1, **kw)
        singles = [microsolver.microsolve_lasso(A, bs[i], x0, float(t0s[i]),
                                                0.1, **kw) for i in range(B)]
        same = identical(out, singles)
        t0 = time.perf_counter()
        ref = microsolver.microsolve_lasso_batch_reference(A, bs, x0, t0s, 0.1,
                                                           **kw)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        kern = cuda_ms(lambda: microsolver.microsolve_lasso_batch(
            A, bs, x0, t0s, 0.1, **kw), 5, warmup=1)
        sep = cuda_ms(lambda: [microsolver.microsolve_lasso(
            A, bs[i], x0, float(t0s[i]), 0.1, **kw) for i in range(B)], 3,
            warmup=1)
        mode = "FISTA" if accelerate else "adaptive"
        ks = out.iteration_count.tolist()
        ok = same
        for i in (0, B - 1):
            one = ref._replace(**{f: None if getattr(ref, f) is None
                                  else getattr(ref, f)[i]
                                  for f in ref._fields})
            tau_err, res_ok, bt_ok = prefix_ok(out, i, one)
            f1 = lasso_objective(A, bs[i], out.x[i])
            f2 = lasso_objective(A, bs[i], one.x)
            rel = abs(f1 - f2) / abs(f2)
            worst = max(worst, float((out.x[i] - one.x).abs().max()))
            k1, k2 = ks[i], int(one.iteration_count)
            good = (int(out.halt[i]) == int(one.halt) == 1 and abs(k1 - k2) <= 2
                    and tau_err <= 1e-3 and res_ok and bt_ok and rel <= 1e-5)
            print(f"[19 K-B1b {mode} instance {i}] iterations kernel {k1} "
                  f"plain {k2}; taus[:10] max rel {tau_err:.2e} (tol 1e-3); "
                  f"residuals allclose {res_ok}; backtracks equal {bt_ok}; "
                  f"objective rel {rel:.2e} (tol 1e-5): {good}")
            ok &= good
        print(f"[19 K-B1b {mode}] {B} instances, iterations {min(ks)}-"
              f"{max(ks)} (total {sum(ks)}); each bit-identical to its own "
              f"K-B1 launch: {same}; one K-B1b launch {kern:.3f} ms (median "
              f"of 5, {kern / B:.3f} ms per instance, "
              f"{kern / trials(out)[0] * 1e3:.3f} us a trial), {B} K-B1 "
              f"launches {sep:.3f} ms (median of 3), plain batch on the card "
              f"{plain:.3f} ms (one run)")
        require(ok, f"K-B1b {mode} disagrees with its separate launches or "
                f"its plain version")
        timed[accelerate] = (kern, plain, sep, trials(out))
    ran = dense_routes_ran(before)
    print(f"[19 K-B1b] launches by route during the phase: {ran}")
    require(ran["streamed"] == ran["columns"] == 0,
            f"K-B1b left the resident route: {ran}")
    kern, plain, sep, (tried, k) = timed[False]
    m, n = A.shape
    # A, the B measurement vectors, x₀ and the τ₀s in; each instance's x
    # and the k entries of taus, residuals and backtracks out
    return dict(max_abs_err=worst, ms=kern, plain_ms=plain,
                **bound(4.0 * (m * n + B * m + n + B + B * n + 3 * k),
                        dense_flops(m, n, tried, k, B, False)),
                hbm_state_ms=k * dense_iteration_bytes(m, n)
                / HBM_BYTES_PER_S * 1e3,
                library_ms=None, instances=B, iterations=k, trials=tried,
                us_per_trial=kern / tried * 1e3, phase_launches_by_route=ran,
                separate_launches_ms=sep, ms_fista=timed[True][0],
                plain_ms_fista=timed[True][1],
                separate_launches_ms_fista=timed[True][2])


def lasso_objective(A, b, x) -> float:
    """½‖Ax − b‖² + 0.1‖x‖₁ in float64 on the card."""
    x = x.double()
    r = A.double() @ x - b.double()
    return float(0.5 * (r @ r) + 0.1 * x.abs().sum())


def phase_batch_tv() -> dict:
    """K-B6b on TV 512×512, 8 images (b·(1 + 0.02·i)), hp, tol 1e-5,
    adaptive and FISTA: every image bit-identical to a separate K-B6
    launch; the first image against the plain version with phase 11's
    checks (status, the first 10 taus rtol 1e-3, residuals, backtracks,
    the float64 dual objective within 1e-5)."""
    prob = problems.build("tv", device=DEV)
    b, p0, mu = prob.fterm.b, prob.x0, 0.1
    B = 8
    bs = stack_requests(b, B)
    timed, worst = {}, 0.0
    for accelerate in (False, True):
        kw = dict(max_iters=5000, tol=1e-5, accelerate=accelerate,
                  record_bts=True)
        before = microsolver_tv.BATCH_LAUNCHES_RESIDENT
        out = microsolver_tv.microsolve_tv_batch(bs, p0, 2.0, mu, **kw)
        require(microsolver_tv.BATCH_LAUNCHES_RESIDENT == before + 1,
                "K-B6b at 512x512 did not take the resident route")
        singles = [microsolver_tv.microsolve_tv(bs[i], p0, 2.0, mu, **kw)
                   for i in range(B)]
        same = identical(out, singles)
        t0 = time.perf_counter()
        ref = microsolver_tv.microsolve_tv_reference(bs[0], p0, 2.0, mu, **kw)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        kern = cuda_ms(lambda: microsolver_tv.microsolve_tv_batch(
            bs, p0, 2.0, mu, **kw), 3, warmup=1)
        sep = cuda_ms(lambda: [microsolver_tv.microsolve_tv(
            bs[i], p0, 2.0, mu, **kw) for i in range(B)], 1, warmup=0)
        tau_err, res_ok, bt_ok = prefix_ok(out, 0, ref)
        f1 = tv_objective(bs[0], mu, out.x[0])
        f2 = tv_objective(bs[0], mu, ref.x)
        rel = abs(f1 - f2) / abs(f2)
        img = tv_image_err(bs[0], mu, out.x[0], ref.x)
        ks = out.iteration_count.tolist()
        mode = "FISTA" if accelerate else "adaptive"
        good = (int(out.halt[0]) == int(ref.halt) == 1 and tau_err <= 1e-3
                and res_ok and bt_ok and rel <= 1e-5)
        print(f"[20 K-B6b {mode}] {B} images, iterations {ks}; each "
              f"bit-identical to its own K-B6 launch: {same}; image 0 against "
              f"the plain version: iterations {ks[0]} vs "
              f"{int(ref.iteration_count)}, taus[:10] max rel {tau_err:.2e}, "
              f"residuals {res_ok}, backtracks {bt_ok}, objective rel "
              f"{rel:.2e} (tol 1e-5), image max|dx| {img:.2e}: {good}; one "
              f"K-B6b launch {kern:.3f} ms (median of 3, {kern / B:.3f} ms "
              f"per image), {B} K-B6 launches {sep:.3f} ms, plain image 0 "
              f"{plain:.3f} ms (one run)")
        require(same and good, f"K-B6b {mode} disagrees with its separate "
                f"launches or its plain version")
        worst = max(worst, img)
        timed[accelerate] = (kern, plain, sep, trials(out))
    kern, plain, sep, (tried, k) = timed[False]
    h = w = 512
    # the 8 images, p₀ and τ₀ in; each image's p and the k entries of
    # taus, residuals and backtracks out
    return dict(max_abs_err=worst, ms=kern, plain_ms=plain,
                plain_ms_covers="image 0 of 8 (the plain loop takes ~3 s "
                "per image)",
                **bound(4.0 * (B * h * w + 2 * h * w + 1 + B * 2 * h * w
                               + 3 * k),
                        tv_flops(h, w, tried, k, B, False)),
                hbm_state_ms=k * tv_iteration_bytes(h, w, False)
                / HBM_BYTES_PER_S * 1e3,
                library_ms=None, instances=B, iterations=k, trials=tried,
                separate_launches_ms=sep, ms_fista=timed[True][0],
                plain_ms_fista=timed[True][1],
                separate_launches_ms_fista=timed[True][2])


def phase_batch_planar() -> dict:
    """K-B8b on planar phase retrieval 16384×256, 16 instances (b·(1 +
    0.02·i), τ₀ 1.0, 1.5 or 2.0 by i mod 3), hp, tol 1e-5, adaptive and
    FISTA (restart_dd): every instance bit-identical to a separate K-B8
    launch; the first and the last against the plain batch with phase 16's
    checks (status, the first 10 taus rtol 1e-3, residuals, backtracks,
    the float64 objective within 1e-6)."""
    prob = problems.build("phase_retrieval", planar=True, device=DEV)
    Ar, Ai, b, c, x0 = (prob.op.Ar, prob.op.Ai, prob.fterm.b, prob.gterm.c,
                        prob.x0)
    inst = prob.instance
    A, bm, cc = inst["A"], inst["b"], inst["delta"] * inst["x0_hat"]
    B = 16
    bs = stack_requests(b, B)
    t0s = torch.tensor([1.0 + (i % 3) / 2.0 for i in range(B)], device=DEV)
    timed, worst = {}, 0.0
    plan = planar_plan(16384, 256)
    routes = dict(resident=0, streamed=0, columns=0)
    for accelerate in (False, True):
        kw = dict(max_iters=2000, tol=1e-5, hp=True, accelerate=accelerate,
                  restart_dd=True, record_bts=True)
        before = route_counts()
        out = microsolver_planar.microsolve_planar_phasemax_batch(
            Ar, Ai, bs, c, x0, t0s, **kw)
        ran = routes_ran(before)
        require(ran == dict(resident=1, streamed=0, columns=0),
                f"K-B8b at 16384x256 did not keep A on the chip: {ran}")
        routes = {r: routes[r] + ran[r] for r in routes}
        singles = [microsolver_planar.microsolve_planar_phasemax(
            Ar, Ai, bs[i], c, x0, float(t0s[i]), **kw) for i in range(B)]
        same = identical(out, singles)
        t0 = time.perf_counter()
        ref = microsolver_planar.microsolve_planar_phasemax_batch_reference(
            Ar, Ai, bs, c, x0, t0s, **kw)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        kern = cuda_ms(lambda: microsolver_planar.microsolve_planar_phasemax_batch(
            Ar, Ai, bs, c, x0, t0s, **kw), 3, warmup=1)
        sep = cuda_ms(lambda: [microsolver_planar.microsolve_planar_phasemax(
            Ar, Ai, bs[i], c, x0, float(t0s[i]), **kw) for i in range(B)], 3,
            warmup=1)
        mode = "FISTA" if accelerate else "adaptive"
        ks = out.iteration_count.tolist()
        ok = same
        for i in (0, B - 1):
            one = ref._replace(**{f: None if getattr(ref, f) is None
                                  else getattr(ref, f)[i]
                                  for f in ref._fields})
            tau_err, res_ok, bt_ok = prefix_ok(out, i, one)
            scale = 1.0 + 0.02 * i
            f1 = phase_objective(A, bm * scale, cc, planar_complex(out.x[i]))
            f2 = phase_objective(A, bm * scale, cc, planar_complex(one.x))
            rel = abs(f1 - f2) / abs(f2)
            worst = max(worst, float((out.x[i] - one.x).abs().max()))
            good = (int(out.halt[i]) == int(one.halt) == 1 and tau_err <= 1e-3
                    and res_ok and bt_ok and rel <= 1e-6)
            print(f"[21 K-B8b {mode} instance {i}] iterations kernel {ks[i]} "
                  f"plain {int(one.iteration_count)}; taus[:10] max rel "
                  f"{tau_err:.2e} (tol 1e-3); residuals {res_ok}; backtracks "
                  f"{bt_ok}; objective rel {rel:.2e} (tol 1e-6): {good}")
            ok &= good
        tried = trials(out)[0]
        print(f"[21 K-B8b {mode}] {B} instances, iterations {min(ks)}-"
              f"{max(ks)} (total {sum(ks)}, {tried} trials); each "
              f"bit-identical to its own K-B8 launch: {same}; one K-B8b "
              f"launch {kern:.3f} ms (median of 3, {kern / B:.3f} ms per "
              f"instance, {kern / sum(ks) * 1e3:.2f} us per iteration, "
              f"{kern / tried * 1e3:.2f} us per trial; route {ran}; tile "
              f"plan {plan}), {B} "
              f"K-B8 launches {sep:.3f} ms (median of 3), plain batch on the "
              f"card {plain:.3f} ms (one run)")
        require(ok, f"K-B8b {mode} disagrees with its separate launches or "
                f"its plain version")
        timed[accelerate] = (kern, plain, sep, trials(out))
    kern, plain, sep, (tried, k) = timed[False]
    m, n = 16384, 256
    # Ar, Ai, the B magnitude vectors, c, x₀ and the τ₀s in; each
    # instance's x and the k entries of taus, residuals and backtracks out
    return dict(max_abs_err=worst, ms=kern, plain_ms=plain,
                **bound(4.0 * (2 * m * n + B * m + 2 * n + 2 * n + B
                               + B * 2 * n + 3 * k),
                        planar_flops(m, n, tried, k, False)
                        + (B - 1) * (16.0 * m * n + 10 * m)),
                hbm_state_ms=tried * 2.0 * m * n * 4 / HBM_BYTES_PER_S * 1e3,
                library_ms=None, phase_launches_by_route=routes,
                us_per_iteration=kern / k * 1e3,
                us_per_trial=kern / tried * 1e3, instances=B, iterations=k,
                trials=tried,
                separate_launches_ms=sep, ms_fista=timed[True][0],
                plain_ms_fista=timed[True][1],
                separate_launches_ms_fista=timed[True][2])


# The plain versions of the serving path's kernels, counted during phase
# 22 by wrapping the module attributes the wrappers call.
PLAIN = {"K-B4": (prox_fused, "shrink_step_reference"),
         "K-B1b": (microsolver, "microsolve_lasso_batch_reference"),
         "K-B6b": (microsolver_tv, "microsolve_tv_batch_reference"),
         "K-B8b": (microsolver_planar,
                   "microsolve_planar_phasemax_batch_reference"),
         "K-B1": (microsolver, "microsolve_lasso_reference"),
         "K-B6": (microsolver_tv, "microsolve_tv_reference")}


@contextlib.contextmanager
def counting_plain():
    counts = dict.fromkeys(PLAIN, 0)
    saved = {k: getattr(mod, name) for k, (mod, name) in PLAIN.items()}

    def counted(k):
        def fn(*a, **kw):
            counts[k] += 1
            return saved[k](*a, **kw)
        return fn

    for k, (mod, name) in PLAIN.items():
        setattr(mod, name, counted(k))
    try:
        yield counts
    finally:
        for k, (mod, name) in PLAIN.items():
            setattr(mod, name, saved[k])


def wall_ms(fn) -> float:
    """Host wall time of ``fn`` to its last result on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_serving() -> dict:
    """The serving path through ``recommend_path(...).run(bs)`` and
    ``Problem.solve_serving`` on every configuration of the slice, at full
    width on the card: TV 512×512 × 8 images (τ₀ 2.0, tol 1e-5), LASSO
    1000×2000 × 32 right-hand sides (τ₀ 0.05, tol 1e-6) and planar phase
    retrieval 16384×256 × 16 measurement vectors (τ₀ 1.0, tol 1e-5), each
    batch request and one request of each; ``Problem.microsolve_batch``
    on LASSO and planar; LASSO with ``need_full_diagnostics``.  Held: the
    route of each; through the launch counters, that K-B4, K-B1b, K-B6b
    and K-B8b (and K-B1, K-B6, K-B8, K-B3) ran and that no plain version
    of the four did; the objectives of the first and last instance of
    each batch (and of each single request) within rtol 1e-5 of the
    float64 reference's (LASSO and phase retrieval: the NumPy oracle; TV:
    the port's float64 loop, its recovered image within rel 1e-3); each
    batch-loop lane within rtol 1e-6 in objective of a separate
    ``Problem.solve_device``.  Then the wall time per instance of each
    route, a batch of B against B separate calls, for both batch routes
    at each configuration (TV at a fixed 300 iterations, the others to
    tolerance)."""
    lasso = problems.build("lasso", device=DEV)
    lasso.tau0 = 0.05
    tv = problems.build("tv", device=DEV)
    tv.tau0 = 2.0
    pr = problems.build("phase_retrieval", planar=True, device=DEV)
    pr.tau0 = 1.0
    sizes = {"tv": 8, "lasso": 32, "pr": 16}
    probs = {"tv": tv, "lasso": lasso, "pr": pr}
    data = {"tv": tv.fterm.b, "lasso": lasso.fterm.b, "pr": pr.fterm.b}
    reqs = {k: stack_requests(data[k], sizes[k]) for k in probs}
    kernel_kw = {"tv": dict(max_iters=5000, tol=1e-5),
                 "lasso": dict(max_iters=5000, tol=1e-6),
                 "pr": dict(max_iters=2000, tol=1e-5, hp=True)}
    loop_opts = {"tv": ftt.FastaOptions(tol=1e-5, max_iters=5000),
                 "lasso": ftt.FastaOptions(tol=1e-6, max_iters=5000),
                 "pr": ftt.FastaOptions(tol=1e-5, max_iters=2000)}
    routes = {"tv": "microsolve_batch", "lasso": "batch_solver",
              "pr": "batch_solver"}

    # the float64 references of the first and last instance of each batch
    # (instance 0's measurements are the problem's own: phases 13 and 17
    # computed its TV and phase-retrieval references)
    refs = {}
    t0 = time.perf_counter()
    linst = lasso.instance
    for i in (0, sizes["lasso"] - 1):
        bi = linst["b"] * (1.0 + 0.02 * i)
        o = fasta_np(linst["op"], None, lambda d, bi=bi: 0.5 * np.sum(
            (d - bi) ** 2), lambda d, bi=bi: d - bi, linst["g"],
            linst["proxg"], linst["x0"], tau0=0.05, tol=1e-10,
            max_iters=20000)
        refs[("lasso", i)] = lasso_objective(
            lasso.op.A, reqs["lasso"][i], torch.as_tensor(o.solution,
                                                          device=DEV))
    tv_last = sizes["tv"] - 1
    ref_prob = problems.build("tv", dtype=torch.float64, device=DEV)
    refs[("tv", 0)] = REFS["tv"]
    b_last = ref_prob.fterm.b * (1.0 + 0.02 * tv_last)
    r64 = ref_prob.with_parts(fterm=ftt.LeastSquares(b_last)).solve(
        tau0=2.0, tol=1e-7, max_iters=30000)
    require(r64.converged, "the float64 TV reference did not converge")
    p64 = torch.as_tensor(r64.solution, device=DEV)
    refs[("tv", tv_last)] = (tv_objective(b_last, 0.1, p64),
                             b_last - 0.1 * ftt.TVDiv2D()(p64))
    pinst = pr.instance
    A_c, bm, cc = pinst["A"], pinst["b"], pinst["delta"] * pinst["x0_hat"]
    refs[("pr", 0)] = REFS["pr"]
    i = sizes["pr"] - 1
    bi = bm * (1.0 + 0.02 * i)

    def hinge_f(d, bi=bi):
        r = np.maximum(np.abs(d) - bi, 0.0)
        return 0.5 * float(np.sum(r * r))

    def hinge_g(d, bi=bi):
        mag = np.abs(d)
        return np.maximum(mag - bi, 0.0) * d / np.maximum(mag, 1e-30)

    o = fasta_np(pinst["op"], None, hinge_f, hinge_g, pinst["g"],
                 pinst["proxg"], pinst["x0"], tau0=1.0, tol=1e-8,
                 max_iters=5000)
    require(o.converged, "the float64 phase-retrieval oracle did not "
            "converge")
    refs[("pr", i)] = phase_objective(A_c, bi, cc, np.asarray(o.solution))
    print(f"[22 serving] float64 references of the first and last instance "
          f"of each batch in {time.perf_counter() - t0:.1f} s (the TV "
          f"reference: {r64.iteration_count} iterations of the port's float64 "
          f"loop on the card)")

    def objective(name, i, x) -> float:
        scale = 1.0 + 0.02 * i
        if name == "lasso":
            return lasso_objective(lasso.op.A, reqs["lasso"][i], x)
        if name == "tv":
            return tv_objective(reqs["tv"][i], 0.1, x)
        return phase_objective(A_c, bm * scale, cc, planar_complex(x))

    with counting_plain() as plain_calls:
        reset_launches()
        runs = []       # (config, what, result, instances)
        for name, p in probs.items():
            plan = ftt.recommend_path(p, sizes[name])
            print(f"[22 serving {name} x {sizes[name]}] route {plan.path}: "
                  f"{plan.reason}")
            require(plan.path == routes[name], f"{name}: route {plan.path}")
            kw = (kernel_kw[name] if plan.path == "microsolve_batch"
                  else dict(options=loop_opts[name]))
            runs.append((name, "recommend_path.run", plan.run(reqs[name],
                                                              **kw)))
            runs.append((name, "solve_serving", p.solve_serving(reqs[name],
                                                                **kw)))
            if name != "tv":
                runs.append((name, "microsolve_batch", p.microsolve_batch(
                    reqs[name], **kernel_kw[name])))
            plan1 = ftt.recommend_path(p, 1)
            require(plan1.path == "microsolve", f"{name} single: route "
                    f"{plan1.path}")
            runs.append((name, "one request", p.solve_serving(
                **kernel_kw[name])))
        diag = ftt.recommend_path(lasso, 1, need_full_diagnostics=True)
        require(diag.path == "loop", f"full diagnostics: route {diag.path}")
        runs.append(("lasso", "one request, full diagnostics",
                     lasso.solve_serving(need_full_diagnostics=True,
                                         tol=1e-6, max_iters=5000)))
        torch.cuda.synchronize()
        launches = read_launches()
    plain = dict(plain_calls)

    worst = 0.0
    for name, what, r in runs:
        if isinstance(r, ftt.MicroBatchResult):
            xs, ok = r.solutions, bool(r.converged.all())
            ks = r.iteration_counts.tolist()
        elif isinstance(r, ftt.DeviceResult):
            xs, ok = r.solution, bool(r.converged.all())
            ks = r.iteration_count.tolist()
        else:
            xs = torch.as_tensor(r.solution, device=DEV)[None]
            ok, ks = bool(r.converged), [r.iteration_count]
        line = []
        for i in ((0, sizes[name] - 1) if xs.shape[0] > 1 else (0,)):
            ref = refs[(name, i)]
            f = objective(name, i, xs[i])
            goal = ref[0] if name == "tv" else ref
            rel = abs(f - goal) / abs(goal)
            worst = max(worst, rel)
            good = rel <= 1e-5
            if name == "tv":
                img = reqs["tv"][i].double() - 0.1 * ftt.TVDiv2D()(
                    xs[i].double())
                x_rel = float(torch.linalg.norm(img - ref[1])
                              / torch.linalg.norm(ref[1]))
                good &= x_rel <= 1e-3
                line.append(f"instance {i} objective rel {rel:.2e}, image "
                            f"rel {x_rel:.2e}")
            else:
                line.append(f"instance {i} objective rel {rel:.2e}")
            require(good, f"{name} {what}: instance {i} disagrees with the "
                    f"float64 reference")
        print(f"[22 serving {name}] {what}: converged={ok}, iterations "
              f"{min(ks)}-{max(ks)}; {'; '.join(line)} (tol 1e-5)")
        require(ok, f"{name} {what} did not converge")

    # each batch-loop lane against a separate loop solve
    for name in ("lasso", "pr"):
        r = next(r for n, w, r in runs if n == name
                 and w == "recommend_path.run")
        p = probs[name]
        rel = 0.0
        for i in range(sizes[name]):
            one = p.with_parts(fterm=type(p.fterm)(reqs[name][i])) \
                .solve_device(loop_opts[name])
            f1, f2 = objective(name, i, r.solution[i]), objective(
                name, i, one.solution)
            rel = max(rel, abs(f1 - f2) / abs(f2))
        print(f"[22 serving {name}] batch-loop lanes against "
              f"{sizes[name]} separate Problem.solve_device: objective max "
              f"rel {rel:.2e} (tol 1e-6)")
        require(rel <= 1e-6, f"{name}: a batch-loop lane disagrees with its "
                f"separate solve")

    print(f"[22 serving] launches during the main path: {launches}; plain "
          f"versions called: {plain}")
    for kernel in ("K-B4", "K-B1b", "K-B6b", "K-B8b", "K-B1", "K-B6", "K-B8",
                   "K-B3"):
        require(launches[kernel] >= 1, f"{kernel} never launched on the "
                f"serving path: {launches}")
    require(not any(plain.values()), f"a plain version ran on the serving "
            f"path: {plain}")

    # M5: a batch of B against B separate calls, both batch routes
    m5 = {}
    fixed = dict(max_iters=300, tol=0.0, stop_rule="iterations")
    for name, p in probs.items():
        B = sizes[name]
        kkw = dict(fixed) if name == "tv" else kernel_kw[name]
        opts = (ftt.FastaOptions(**fixed) if name == "tv"
                else loop_opts[name])
        solve = ftt.make_batch_solver(opts, (None, 0, None, None, None))
        one = [p.with_parts(fterm=type(p.fterm)(reqs[name][i]))
               for i in range(B)]
        t = {"microsolve_batch": wall_ms(lambda: p.microsolve_batch(
                 reqs[name], **kkw)),
             "microsolve x B": wall_ms(lambda: [q.microsolve(**kkw)
                                                for q in one]),
             "batch_solver": wall_ms(lambda: solve(
                 p.op, type(p.fterm)(reqs[name]), p.gterm, p.x0, p.tau0)),
             "solve_device x B": wall_ms(lambda: [q.solve_device(opts)
                                                  for q in one])}
        m5[name] = {k: v / B for k, v in t.items()}
        how = "300 iterations" if name == "tv" else "to tolerance"
        print(f"[22 serving M5 {name} x {B}, {how}] ms per instance: "
              + ", ".join(f"{k} {v:.3f}" for k, v in m5[name].items()))
    return dict(launches=launches, m5=m5, worst_rel=worst)


# --------------------------------------------------------------------------
# Slice 6: bfloat16 storage and refinement, K-P4, K-B8 past n = 512
# --------------------------------------------------------------------------

def check_map(tag, got, ref) -> float:
    """Phase 3's tolerance between a gradient map and its plain version:
    max|Δd|, max|Δg| ≤ 1e-5·max(1, max|ref|) and |Δf| ≤ 1e-5·|f|.
    Returns the larger of the two errors."""
    (d, f, g), (d0, f0, g0) = got, ref
    torch.cuda.synchronize()
    err_d = float((d - d0).abs().max())
    err_g = float((g - g0).abs().max())
    rel_f = abs(float(f) - float(f0)) / abs(float(f0))
    tol_d = 1e-5 * max(1.0, float(d0.abs().max()))
    tol_g = 1e-5 * max(1.0, float(g0.abs().max()))
    print(f"{tag} max|dd| {err_d:.3e} (tol {tol_d:.1e}) max|dg| {err_g:.3e} "
          f"(tol {tol_g:.1e}) rel df {rel_f:.3e} (tol 1e-5)")
    require(err_d <= tol_d and err_g <= tol_g and rel_f <= 1e-5,
            f"{tag} disagrees with its plain version")
    return max(err_d, err_g)


def gradmap_bytes(m: int, n: int, itemsize: int) -> float:
    """K-B3's inputs read once and outputs written once: A, x, b, d, g."""
    return itemsize * m * n + 4.0 * (2 * n + 2 * m)


def phase_bf16_gradmap() -> tuple:
    """K-B3 and K-B3p over a bfloat16 A against their plain versions (A
    upcast to float32, x float32) at 8192×16384 (268.4 MB), 1000×1003
    (rows not 16-byte aligned: one value a group) and 1024×200000 (the
    wide route), with phase 3's tolerance; call and stream times beside
    K-B3 over the float32 A at the same shape, and GB/s against the
    0.0801 ms byte bound of one bfloat16 read."""
    gen = torch.Generator(device=DEV).manual_seed(23)
    worst, ms = {"lstsq": 0.0, "pointwise": 0.0}, {}
    for m, n in ((8192, 16384), (1000, 1003), (1024, 200000)):
        A32 = torch.randn((m, n), generator=gen, device=DEV) / m ** 0.5
        A = A32.to(torch.bfloat16)
        x = torch.randn(n, generator=gen, device=DEV)
        b = torch.randn(m, generator=gen, device=DEV)
        labels = (b > 0).float()
        route = lstsq_fused._plan(0, m, n, True)[0]
        cases = [("lstsq", lambda: lstsq_fused.fused_lstsq_gradmap(A, x, b),
                  lambda: lstsq_fused.lstsq_gradmap_reference(A, x, b))]
        for loss, y in (("logistic", labels),
                        ("squared_hinge", 2.0 * labels - 1.0)):
            cases.append((loss, lambda loss=loss, y=y: lstsq_fused.
                          fused_pointwise_gradmap(A, x, y, loss),
                          lambda loss=loss, y=y: lstsq_fused.
                          pointwise_gradmap_reference(A, x, y, loss)))
        for loss, kernel_fn, plain_fn in cases:
            tag = f"[23 K-B3{'' if loss == 'lstsq' else 'p'} bf16 {loss} {m}x{n}]"
            err = check_map(tag, kernel_fn(), plain_fn())
            key = "lstsq" if loss == "lstsq" else "pointwise"
            worst[key] = max(worst[key], err)
            kern, plain = cuda_ms(kernel_fn, 20), cuda_ms(plain_fn, 20)
            kern_stream, plain_stream = stream_ms(kernel_fn), stream_ms(plain_fn)
            bd = bound(gradmap_bytes(m, n, 2), 4.0 * m * n)
            print(f"{tag} route {'wide' if route == 0 else f'cluster {route}'}; "
                  f"call, median of 20: kernel {kern:.4f} ms, plain "
                  f"{plain:.4f} ms; stream time, 20 back-to-back runs: kernel "
                  f"{kern_stream:.4f} ms, plain {plain_stream:.4f} ms; "
                  f"{m * n * 2 / kern_stream / 1e6:.1f} GB/s of stream time; "
                  f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}), "
                  f"{kern_stream / bd['bound_ms']:.2f}x")
            ms[(loss, m, n)] = (kern, plain, kern_stream, plain_stream)
        f32_fn = lambda: lstsq_fused.fused_lstsq_gradmap(A32, x, b)  # noqa: E731
        f32_call, f32_stream = cuda_ms(f32_fn, 20), stream_ms(f32_fn)
        print(f"[23 K-B3 float32 {m}x{n}] beside it: call {f32_call:.4f} ms, "
              f"stream {f32_stream:.4f} ms ({m * n * 4 / f32_stream / 1e6:.1f} "
              f"GB/s), bound {bound(gradmap_bytes(m, n, 4), 4.0 * m * n)['bound_ms']:.4f} ms")
        ms[("f32", m, n)] = (f32_call, f32_stream)
        del A32, A
    m, n = 8192, 16384
    big, lg = ms[("lstsq", m, n)], ms[("logistic", m, n)]
    wide = ms[("lstsq", 1024, 200000)]
    b3 = dict(max_abs_err=worst["lstsq"], ms=big[0], plain_ms=big[1],
              **bound(gradmap_bytes(m, n, 2), 4.0 * m * n), library_ms=None,
              shape="8192x16384 bfloat16", stream_ms=big[2],
              plain_stream_ms=big[3], f32_ms=ms[("f32", m, n)][0],
              f32_stream_ms=ms[("f32", m, n)][1],
              stream_ms_1024x200000=wide[2],
              plain_stream_ms_1024x200000=wide[3],
              f32_stream_ms_1024x200000=ms[("f32", 1024, 200000)][1],
              stream_ms_1000x1003=ms[("lstsq", 1000, 1003)][2])
    b3p = dict(max_abs_err=worst["pointwise"], ms=lg[0], plain_ms=lg[1],
               **bound(gradmap_bytes(m, n, 2), 4.0 * m * n), library_ms=None,
               shape="logistic 8192x16384 bfloat16", stream_ms=lg[2],
               plain_stream_ms=lg[3],
               hinge_stream_ms=ms[("squared_hinge", m, n)][2])
    return b3, b3p


def phase_bf16_planar_gradmap() -> dict:
    """K-B7 over bfloat16 channels against its plain version (channels
    upcast, x float32), both losses, at 16384×256, 16384×4096 (268.4 MB of
    channels) and 1024×16384 (the wide route), with phase 3's tolerance;
    call and stream times, GB/s against the byte bound of one bfloat16
    read of Ar and Ai; the hinge form at 16384×256 and 16384×4096 split
    into card time, host time and device operations (one kernel a
    call)."""
    worst, ms, splits = 0.0, {}, {}
    for i, (m, n) in enumerate(((16384, 256), (16384, 4096), (1024, 16384))):
        Ar, Ai, x, bl, bh = planar_data(m, n, 24 + i)
        Ar, Ai = Ar.to(torch.bfloat16), Ai.to(torch.bfloat16)
        route = planar_fused._plan(0, m, n, True).route
        print(planar_plan_line(24, m, n, True))
        for loss, fused, ref, b in (
                ("hinge", planar_fused.fused_planar_hinge_gradmap,
                 planar_fused.planar_hinge_gradmap_reference, bh),
                ("lstsq", planar_fused.fused_planar_lstsq_gradmap,
                 planar_fused.planar_lstsq_gradmap_reference, bl)):
            tag = f"[24 K-B7 bf16 {loss} {m}x{n}]"
            worst = max(worst, check_map(tag, fused(Ar, Ai, x, b),
                                         ref(Ar, Ai, x, b)))
            kernel_fn = lambda: fused(Ar, Ai, x, b)  # noqa: E731
            plain_fn = lambda: ref(Ar, Ai, x, b)  # noqa: E731
            kern, plain = cuda_ms(kernel_fn, 20), cuda_ms(plain_fn, 20)
            kern_stream, plain_stream = stream_ms(kernel_fn), stream_ms(plain_fn)
            nbytes = planar_gradmap_bytes(m, n, loss == "hinge") \
                - 4.0 * m * n                 # channels at 2 bytes
            bd = bound(nbytes, 16.0 * m * n)
            print(f"{tag} route {route}; call, median of 20: kernel "
                  f"{kern:.4f} ms, plain {plain:.4f} ms; stream time, 20 "
                  f"back-to-back runs: kernel {kern_stream:.4f} ms, plain "
                  f"{plain_stream:.4f} ms; "
                  f"{2 * m * n * 2 / kern_stream / 1e6:.1f} GB/s of stream "
                  f"time; bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
            ms[(loss, m, n)] = (kern, plain, kern_stream, plain_stream,
                                bd["bound_ms"])
            if loss == "hinge" and m == 16384:
                splits[n] = call_split(f"{tag}", kernel_fn)
        del Ar, Ai
    m, n = 16384, 4096
    big = ms[("hinge", m, n)]
    return dict(max_abs_err=worst, ms=big[0], plain_ms=big[1],
                **bound(planar_gradmap_bytes(m, n, True) - 4.0 * m * n,
                        16.0 * m * n),
                library_ms=None, shape="hinge 16384x4096 bfloat16",
                **split_keys(splits[4096]),
                **split_keys(splits[256], "_16384x256"),
                stream_ms=big[2], plain_stream_ms=big[3],
                stream_ms_16384x256=ms[("hinge", 16384, 256)][2],
                plain_stream_ms_16384x256=ms[("hinge", 16384, 256)][3],
                stream_ms_1024x16384=ms[("hinge", 1024, 16384)][2],
                plain_stream_ms_1024x16384=ms[("hinge", 1024, 16384)][3])


def pair_ms(A, x0, K: int) -> float:
    """One K-P4 launch of K pairs: CUDA events around it, best of 3."""
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        bf16_probe.bf16_probe(A, x0, K)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def phase_bf16_probe() -> dict:
    """K-P4 at the probe's 1000×2000, float32 and bfloat16 storage: the
    last of 3 chained pairs' g within 1e-5 of its largest entry of the
    plain loop's and x equal to x₀; a call's device operations (one
    kernel, a ``profiling.trace``); then µs per pair as the difference of a
    1100- and a 100-pair launch over 1000, best of 3, in turns (float32,
    bfloat16, bfloat16, float32).  Then the same, printed and not gated,
    at the second shape: n = 2000 and the smallest m at which the card's
    float32 plan (``bf16_probe_plan``) must stream a remainder from L2
    while its bfloat16 plan keeps every row on the chip.  The bound
    reckons the work: A read once a launch (spread over the timed
    launch's 1100 pairs), x₀ read and x, g written once, 4mn operations a
    pair; the former reckoning, one read of A a pair, is printed beside
    it."""
    n = 2000
    grids = {bf16: bf16_probe._grid(0, bf16, n)[:2] for bf16 in (False, True)}

    def card_plan(m, bf16):
        nb, budget = grids[bf16]
        return bf16_probe.bf16_probe_plan(m, n, bf16, nb, budget)

    m2 = next(m for m in range(1000, 40000)
              if card_plan(m, False).route == "streamed")
    require(card_plan(m2, True).route == "resident",
            f"K-P4 at {m2}x{n}: the bfloat16 plan streams too")
    gen = torch.Generator(device=DEV).manual_seed(25)
    shapes, worst = {}, 0.0
    for m in (1000, m2):
        A32 = torch.randn((m, n), generator=gen, device=DEV) / m ** 0.5
        x0 = torch.randn(n, generator=gen, device=DEV)
        shapes[m] = ({"float32": A32, "bfloat16": A32.to(torch.bfloat16)}, x0)
        for name, A in shapes[m][0].items():
            plan = card_plan(m, name == "bfloat16")
            x, g = bf16_probe.bf16_probe(A, x0, 3)
            xr, gr = bf16_probe.bf16_probe_reference(A, x0, 3)
            torch.cuda.synchronize()
            err = float((g - gr).abs().max())
            tol = 1e-5 * float(gr.abs().max())
            print(f"[25 K-P4 {m}x{n} {name}] plan {plan.route}, "
                  f"{plan.resident_share:.3f} of A on the chip "
                  f"({max(plan.reg_rows)} rows a block in registers, "
                  f"{max(plan.smem_rows)} in shared memory), "
                  f"{plan.streamed_bytes / 1e6:.2f} MB a pass from L2; last "
                  f"of 3 pairs max|dg| {err:.3e} (tol {tol:.1e}); x equal to "
                  f"x0: {torch.equal(x, x0)}")
            require(err <= tol and torch.equal(x, x0) and torch.equal(xr, x0),
                    f"K-P4 {m}x{n} {name} disagrees with its plain version")
            worst = max(worst, err)
    mats, x0 = shapes[1000]
    splits = {name: call_split(f"[25 K-P4 1000x{n} {name}, 3 pairs]",
                               lambda A=A: bf16_probe.bf16_probe(A, x0, 3),
                               10, traced=True) for name, A in mats.items()}
    print(f"[25 K-P4] grid barriers a pair: "
          f"{bf16_probe.GRID_BARRIERS_PER_PAIR}")
    plain = {k: cuda_ms(lambda A=A: bf16_probe.bf16_probe_reference(A, x0, 10),
                        5) / 10 for k, A in mats.items()}
    per, launches = {}, 0
    for m, (mats_m, x0_m) in shapes.items():
        reset_launches()
        turns = {k: [] for k in mats_m}
        for name in ("float32", "bfloat16", "bfloat16", "float32"):
            A = mats_m[name]
            pair_ms(A, x0_m, 100)                        # warm-up
            turns[name].append((pair_ms(A, x0_m, 1100)
                                - pair_ms(A, x0_m, 100)) / 1000)
        launches += read_launches()["K-P4"]
        per[m] = {k: statistics.mean(t) for k, t in turns.items()}
        for name in mats_m:
            item = 4 if name == "float32" else 2
            work = bound((item * m * n + 12.0 * n) / 1100, 4.0 * m * n)
            old = bound(item * m * n + 8.0 * n, 4.0 * m * n)
            print(f"[25 K-P4 {m}x{n} {name}] {per[m][name] * 1e3:.3f} us per "
                  f"pair (turns {', '.join(f'{u * 1e3:.3f}' for u in turns[name])}); "
                  f"bound {work['bound_ms'] * 1e3:.4f} us ({work['bound_by']}: "
                  f"A once a launch of 1100 pairs, 4mn operations a pair), "
                  f"{per[m][name] / work['bound_ms']:.1f}x; the former "
                  f"reckoning (A read once a pair, {item * m * n / 1e6:.1f} MB) "
                  f"{old['bound_ms'] * 1e3:.4f} us, "
                  f"{per[m][name] / old['bound_ms']:.2f}x"
                  + (f"; plain pair {plain[name] * 1e3:.3f} us" if m == 1000
                     else ""))
        print(f"[25 K-P4 {m}x{n}] bfloat16 storage against float32: "
              f"{per[m]['float32'] / per[m]['bfloat16']:.3f}x")
    print(f"[25 K-P4] launches during the timed runs: {launches}")
    require(launches >= 1, "the probe's timed runs launched no K-P4")
    m = 1000
    return dict(max_abs_err=worst, ms=per[m]["bfloat16"],
                plain_ms=plain["bfloat16"],
                **bound((2.0 * m * n + 12.0 * n) / 1100, 4.0 * m * n),
                library_ms=None, launches_timed=launches,
                shape="1000x2000, per chained pair, bfloat16 storage",
                us_per_pair={f"{mm}x{n} {k}": v * 1e3
                             for mm, p in per.items() for k, v in p.items()},
                f32_ms=per[m]["float32"], f32_plain_ms=plain["float32"],
                f32_bound_ms=bound((4.0 * m * n + 12.0 * n) / 1100,
                                   4.0 * m * n)["bound_ms"],
                second_shape=f"{m2}x{n}",
                bf16_speedup={f"{mm}x{n}": p["float32"] / p["bfloat16"]
                              for mm, p in per.items()},
                **split_keys(splits["bfloat16"]),
                **split_keys(splits["float32"], "_f32"))


def phase_objective_t(p, x) -> float:
    """f(x) − ⟨c, x⟩ of a planar problem in float64 on the card."""
    x = torch.as_tensor(x, device=DEV).double()
    d = ftt.PlanarDenseOp(p.op.Ar.double(), p.op.Ai.double())(x)
    r = torch.clamp_min(torch.sqrt(torch.sum(d * d, -1))
                        - p.fterm.b.double(), 0.0)
    return float(0.5 * torch.sum(r * r) - torch.sum(p.gterm.c.double() * x))


def reversed_columns(data):
    """A planar problem's (Ar, Ai, b, c, x₀) with the columns in reverse
    order: the same problem, its products summed in another order."""
    Ar, Ai, b, c, x0 = data
    r = torch.arange(Ar.shape[1] - 1, -1, -1, device=Ar.device)
    return (Ar[:, r].contiguous(), Ai[:, r].contiguous(), b,
            c[r].contiguous(), x0[r].contiguous())


def rel_spread(a, b) -> float:
    """The largest relative difference of two positive series."""
    return float(((a - b).abs() / b.abs()).max())


# PhaseMax needs m ≳ 4n measurements for a bounded solution: 2048×1024
# and 256×8192, inside the reference's gate, have none (the iterates run
# off along the anchor), so they run a fixed 300 iterations and hold the
# prefix; 8192×640, also inside the gate, is well posed and runs to
# tolerance.
WIDE_SHAPES = ((8192, 640), (2048, 1024), (256, 8192))


def phase_wide_planar() -> dict:
    """K-B8 and K-B8b on the route past n = 512 (C-4) against the plain
    version, adaptive and FISTA (hp, restart_dd): backtracks equal and the
    first 10 taus and residuals within rtol max(1e-3, twice the plain
    version's own spread when its columns are reversed — the hinge carries
    a change in the order of float32 sums into τ at the 1e-3 level by the
    tenth iteration, the plain version against itself too), equal counts
    and status, and where the problem is well posed (8192×640, tol 1e-5)
    the float64 objective within 1e-6; a batch of 4 bit-identical to
    separate launches; then the public routes — recommend_path(p,
    1).run(), Problem.microsolve_batch and recommend_path(p, 4).run(bs) —
    with the launch counters."""
    worst, timed = 0.0, {}
    probs, plans, rans = {}, {}, {}
    for m, n in WIDE_SHAPES:
        p = problems.build("phase_retrieval", m=m, n=n, planar=True,
                           device=DEV)
        p.tau0 = 1.0
        probs[(m, n)] = p
        plans[(m, n)] = planar_plan(m, n)
        before = route_counts()
        posed = (m, n) == WIDE_SHAPES[0]
        data = (p.op.Ar, p.op.Ai, p.fterm.b, p.gterm.c, p.x0)
        require(ftt.microsolve_supported(p) == (True, "planar"),
                f"{m}x{n} is outside the planar gate")
        for accelerate in (False, True):
            # adaptive runs the well-posed shape to tolerance; FISTA's hinge
            # solve there takes more than 6000 iterations in the plain
            # version, so it runs 300 as the other shapes do
            to_tol = posed and not accelerate
            kw = dict(max_iters=2000, tol=1e-5, hp=True, accelerate=accelerate,
                      restart_dd=True, record_bts=True)
            if not to_tol:
                kw.update(max_iters=300, tol=0.0, stop_rule="iterations")
            out = microsolver_planar.microsolve_planar_phasemax(*data, 1.0,
                                                                **kw)
            t0 = time.perf_counter()
            ref = microsolver_planar.microsolve_planar_phasemax_reference(
                *data, 1.0, **kw)
            torch.cuda.synchronize()
            plain = (time.perf_counter() - t0) * 1e3
            kern = cuda_ms(lambda: microsolver_planar.microsolve_planar_phasemax(
                *data, 1.0, **kw), 3, warmup=1)
            k1, k2 = int(out.iteration_count), int(ref.iteration_count)
            kt = min(k1, k2, 10)
            rev = microsolver_planar.microsolve_planar_phasemax_reference(
                *reversed_columns(data), 1.0,
                **(kw if not to_tol else {**kw, "max_iters": kt, "tol": 0.0,
                                          "stop_rule": "iterations"}))
            spread = max(rel_spread(rev.taus[:kt], ref.taus[:kt]),
                         rel_spread(rev.residuals[:kt], ref.residuals[:kt]))
            tol = max(1e-3, 2.0 * spread)
            tau_err = rel_spread(out.taus[:kt], ref.taus[:kt])
            res_ok = torch.allclose(out.residuals[:kt], ref.residuals[:kt],
                                    rtol=tol, atol=1e-6)
            bt_ok = torch.equal(out.backtracks[:kt], ref.backtracks[:kt])
            f1, f2 = phase_objective_t(p, out.x), phase_objective_t(p, ref.x)
            rel_f = abs(f1 - f2) / abs(f2)
            f_tol = 1e-6
            if not to_tol:
                f_rev = phase_objective_t(p, rev.x.flip(0))
                f_tol = max(1e-6, 2.0 * abs(f_rev - f2) / abs(f2))
            ok = tau_err <= tol and res_ok and bt_ok
            if to_tol:
                ok &= out.status == ref.status == "converged"
            else:
                ok &= k1 == k2 == 300
            if posed:
                ok &= rel_f <= f_tol
            mode = "FISTA" if accelerate else "adaptive"
            tried = trials(out)[0]
            print(f"[26 K-B8 wide {m}x{n} {mode}] iterations kernel {k1} plain "
                  f"{k2}; status {out.status}/{ref.status}; taus[:{kt}] max rel "
                  f"{tau_err:.2e} (tol {tol:.2e}: the plain version against "
                  f"itself, columns reversed, {spread:.2e}); residuals "
                  f"{res_ok}; backtracks "
                  f"{bt_ok}; objective {f1:.12g} vs {f2:.12g}, rel "
                  f"{rel_f:.2e}{f' (tol {f_tol:.2e})' if posed else ''}; kernel "
                  f"{kern:.3f} ms (median of 3, {kern / k1 * 1e3:.2f} us per "
                  f"iteration, {tried} trials, {kern / tried * 1e3:.2f} us per "
                  f"trial), plain loop on the card {plain:.3f} ms (one "
                  f"run)")
            require(ok, f"K-B8 wide {m}x{n} {mode} disagrees with its plain "
                    f"version")
            if posed:
                worst = max(worst, float((out.x - ref.x).abs().max()))
            timed[(m, n, accelerate)] = (kern, plain, trials(out))
            bs = stack_requests(p.fterm.b, 4)
            t0s = torch.tensor([1.0, 0.3, 2.0, 1.5], device=DEV)
            batch = microsolver_planar.microsolve_planar_phasemax_batch(
                data[0], data[1], bs, data[3], data[4], t0s, **kw)
            singles = [microsolver_planar.microsolve_planar_phasemax(
                data[0], data[1], bs[i], data[3], data[4], float(t0s[i]),
                **kw) for i in range(4)]
            same = identical(batch, singles)
            print(f"[26 K-B8b wide {m}x{n} {mode}] 4 instances, each "
                  f"bit-identical to its own K-B8 launch: {same}")
            require(same, f"K-B8b wide {m}x{n} {mode} differs from its "
                    f"separate launches")
        ran = rans[(m, n)] = routes_ran(before)
        want = "streamed" if (m, n) == (8192, 640) else "resident"
        print(f"[26 K-B8 wide {m}x{n}] tile plan: {plans[(m, n)]}; launches "
              f"by route: {ran}")
        require(plans[(m, n)]["tile_route"] == want and ran[want] > 0
                and sum(ran.values()) == ran[want],
                f"K-B8 at {m}x{n} took another route than {want}: "
                f"{plans[(m, n)]}, {ran}")

    # the C-4 routes through the public entry points
    reset_launches()
    runs = []
    for (m, n), p in probs.items():
        posed = (m, n) == WIDE_SHAPES[0]
        kw = (dict(max_iters=2000, tol=1e-5, hp=True) if posed else
              dict(max_iters=300, tol=0.0, stop_rule="iterations", hp=True))
        plan = ftt.recommend_path(p, 1)
        require(plan.path == "microsolve", f"{m}x{n}: route {plan.path}")
        one = plan.run(**kw)
        bs = stack_requests(p.fterm.b, 4)
        mb = p.microsolve_batch(bs, **kw)
        plan4 = ftt.recommend_path(p, 4)
        loop = plan4.run(bs, options=ftt.FastaOptions(max_iters=50))
        runs.append(((m, n), one, mb, plan4.path, loop))
    torch.cuda.synchronize()
    launches = read_launches()
    for (m, n), one, mb, path4, loop in runs:
        same = torch.equal(mb.solutions[0], one.solution)
        print(f"[26 C-4 {m}x{n}] recommend_path(p, 1).run(): {one.status} in "
              f"{one.iteration_count} iterations; Problem.microsolve_batch "
              f"x 4, instance 0 equal to it: {same}; recommend_path(p, 4): "
              f"{path4}, solutions {tuple(loop.solution.shape)}")
        require(same, f"C-4 {m}x{n}: the batch differs from the single solve")
        if (m, n) == WIDE_SHAPES[0]:
            require(one.status == "converged", "C-4 8192x640 did not converge")
    print(f"[26 C-4] launches during the routes: {launches}")
    require(launches["K-B8w"] >= 3 and launches["K-B8bw"] >= 3,
            f"the wide route never launched on the C-4 path: {launches}")
    require(launches["K-B8"] == launches["K-B8b"] == 0,
            f"a C-4 route took the n <= 512 kernel: {launches}")
    m, n = 2048, 1024
    kern, plain, (tried, k) = timed[(m, n, False)]
    return dict(max_abs_err=worst, ms=kern, plain_ms=plain,
                **bound(4.0 * (2 * m * n + m + 4 * n + 2 * n + 3 * k),
                        planar_flops(m, n, tried, k, False)),
                hbm_state_ms=tried * 2.0 * m * n * 4 / HBM_BYTES_PER_S * 1e3,
                library_ms=None, shape="2048x1024, 300 iterations, hp",
                phase_launches_by_route=rans[(m, n)],
                us_per_iteration=kern / k * 1e3,
                us_per_trial=kern / tried * 1e3,
                phase_launches_by_route_8192x640=rans[(8192, 640)],
                phase_launches_by_route_256x8192=rans[(256, 8192)], iterations=k, trials=tried,
                ms_fista=timed[(m, n, True)][0],
                plain_ms_fista=timed[(m, n, True)][1],
                ms_256x8192=timed[(256, 8192, False)][0],
                plain_ms_256x8192=timed[(256, 8192, False)][1],
                ms_8192x640_to_tol=timed[(8192, 640, False)][0],
                plain_ms_8192x640_to_tol=timed[(8192, 640, False)][1],
                iterations_8192x640=timed[(8192, 640, False)][2][1],
                launches=launches)


def lasso_objective64(A64, b64, mu, x) -> float:
    """½‖Ax − b‖² + μ‖x‖₁ in float64 on the card."""
    x = torch.as_tensor(x, device=DEV).double()
    r = A64 @ x - b64
    return float(0.5 * torch.dot(r, r) + mu * x.abs().sum())


def phase_bf16_main_path() -> dict:
    """The bfloat16 main paths through the public entry points.

    LASSO 8192×16384 (make_lasso k=100, μ 0.1, seed 1; τ₀ 0.05): the
    float32 solve from scratch (tol 1e-6), then the bfloat16 solve over
    ``LowPrecDenseOp.from_dense(A)`` (tol 1e-3), ``checkpoint.save_pytree``
    / ``load_pytree`` of its result, and ``checkpoint.resume`` of the
    float32 problem (tol 1e-6): the refined float64 objective within 1e-4
    of the from-scratch one in fewer iterations (test_mixed_precision.py's
    bars), every bfloat16 trial one K-B3 bf16 launch.  Logistic and the
    squared hinge over the same bfloat16 matrix (labels from b), 20
    iterations each through K-B3p bf16.  Phase retrieval 16384×256
    planar: the bfloat16 solve over ``PlanarDenseOp.from_complex(A,
    torch.bfloat16)`` (tol 1e-3) through K-B7 bf16, its checkpoint, the
    float32 resume (tol 1e-5) within 1e-5 of the float64 oracle's
    objective (phase 17), and ``Problem.microsolve`` on the bfloat16
    problem, equal to the kernel's run on the upcast channels."""
    import tempfile
    t0 = time.perf_counter()
    inst = make_lasso(m=8192, n=16384, k=100, mu=0.1, seed=1)
    A64 = torch.as_tensor(inst["A"], device=DEV)
    del inst["A"], inst["op"]             # the host copy: 1.07 GB
    b64 = torch.as_tensor(inst["b"], device=DEV)
    mu = float(inst["mu"])
    prob = ftt.Problem("lasso[8192x16384]", op=ftt.DenseOp(A64.float()),
                       fterm=ftt.LeastSquares(b64.float()),
                       gterm=ftt.L1Norm(mu),
                       x0=torch.zeros(16384, device=DEV), tau0=0.05)
    op16 = ftt.LowPrecDenseOp.from_dense(A64)
    p16 = prob.with_parts(op=op16)
    print(f"[27 bf16 main path] LASSO 8192x16384 built in "
          f"{time.perf_counter() - t0:.1f} s: float32 A "
          f"{prob.op.A.numel() * 4 / 1e6:.1f} MB, bfloat16 A "
          f"{op16.A.numel() * 2 / 1e6:.1f} MB")

    def timed_solve(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t) * 1e3

    reset_launches()
    r_full, w_full = timed_solve(lambda: prob.solve(tol=1e-6, max_iters=2000))
    before = lstsq_fused.BF16_LAUNCHES
    r16, w16 = timed_solve(lambda: p16.solve(tol=1e-3, max_iters=2000))
    bf16_trials = lstsq_fused.BF16_LAUNCHES - before
    with tempfile.TemporaryDirectory() as tmp:
        path = checkpoint.save_pytree(r16, f"{tmp}/bf16_result.npz")
        loaded = checkpoint.load_pytree(r16, path)
    require(np.array_equal(loaded.solution, r16.solution)
            and np.array_equal(loaded.taus, r16.taus),
            "the checkpoint round trip changed the result")
    r_ref, w_ref = timed_solve(lambda: checkpoint.resume(
        prob, loaded, tol=1e-6, max_iters=2000))
    pointwise = []
    for loss, term in (("logistic", ftt.Logistic((b64 > 0).float())),
                       ("squared_hinge",
                        ftt.SquaredHinge(2.0 * (b64 > 0).float() - 1.0))):
        r, w = timed_solve(lambda term=term: p16.with_parts(fterm=term).solve(
            tau0=0.05, tol=0.0, max_iters=20))
        pointwise.append((loss, r, w))

    # planar phase retrieval 16384×256, bfloat16 then float32
    pr = problems.build("phase_retrieval", planar=True, device=DEV)
    pr.tau0 = 1.0
    pinst = pr.instance
    opb = ftt.PlanarDenseOp.from_complex(pinst["A"], torch.bfloat16,
                                         device=DEV)
    prb = pr.with_parts(op=opb)
    rpb, wpb = timed_solve(lambda: prb.solve(tol=1e-3, max_iters=2000))
    with tempfile.TemporaryDirectory() as tmp:
        loaded_p = checkpoint.load_pytree(rpb, checkpoint.save_pytree(
            rpb, f"{tmp}/planar.npz"))
    rpr, wpr = timed_solve(lambda: checkpoint.resume(
        pr, loaded_p, tol=1e-5, max_iters=2000))
    micro = prb.microsolve(max_iters=2000, tol=1e-5, hp=True)
    torch.cuda.synchronize()
    launches = read_launches()
    up = pr.with_parts(op=ftt.PlanarDenseOp(opb.Ar.float(), opb.Ai.float()))
    micro_up = up.microsolve(max_iters=2000, tol=1e-5, hp=True)

    f_full = lasso_objective64(A64, b64, mu, r_full.solution)
    f16 = lasso_objective64(A64, b64, mu, r16.solution)
    f_ref = lasso_objective64(A64, b64, mu, r_ref.solution)
    rel = abs(f_ref - f_full) / abs(f_full)
    print(f"[27 bf16 main path] float32 from scratch: {r_full.iteration_count} "
          f"iterations, {w_full:.1f} ms, objective {f_full:.12g}")
    print(f"[27 bf16 main path] bfloat16 (LowPrecDenseOp, tol 1e-3): "
          f"{r16.iteration_count} iterations, {r16.total_backtracks} "
          f"backtracks, {w16:.1f} ms, objective {f16:.12g} (rel "
          f"{abs(f16 - f_full) / abs(f_full):.2e}); K-B3 bf16 launches "
          f"{bf16_trials} for {r16.iteration_count + r16.total_backtracks} "
          f"trials")
    print(f"[27 bf16 main path] checkpoint round trip, float32 resume (tau0 "
          f"{r_ref.initial_tau:.6g}): {r_ref.iteration_count} iterations, "
          f"{w_ref:.1f} ms, objective {f_ref:.12g}: rel {rel:.2e} (tol 1e-4); "
          f"bfloat16 + resume {w16 + w_ref:.1f} ms against {w_full:.1f} ms")
    require(r_full.converged and r16.converged and r_ref.converged,
            "a LASSO solve of the bf16 main path did not converge")
    require(rel <= 1e-4, "the refined objective misses the float32 one")
    require(r_ref.iteration_count < r_full.iteration_count,
            "the refinement took no fewer iterations than the solve from "
            "scratch")
    require(bf16_trials == r16.iteration_count + r16.total_backtracks,
            "a bfloat16 trial did not launch K-B3 bf16")
    for loss, r, w in pointwise:
        f = r.fvals[-1]
        print(f"[27 bf16 main path] {loss} over the bfloat16 matrix: "
              f"{r.iteration_count} iterations in {w:.1f} ms, f {f:.9g} "
              f"(from {r.fvals[0]:.9g})")
        require(np.isfinite(r.solution).all() and f < r.fvals[0],
                f"the {loss} solve over the bfloat16 matrix made no progress")

    A_c, bm, cc = pinst["A"], pinst["b"], pinst["delta"] * pinst["x0_hat"]
    goal = REFS["pr"]
    fpb = phase_objective(A_c, bm, cc, planar_complex(rpb.solution))
    fpr = phase_objective(A_c, bm, cc, planar_complex(rpr.solution))
    relp = abs(fpr - goal) / abs(goal)
    same = torch.equal(micro.solution, micro_up.solution)
    print(f"[27 bf16 main path] planar 16384x256 bfloat16 (tol 1e-3): "
          f"{rpb.iteration_count} iterations, {wpb:.1f} ms, objective "
          f"{fpb:.12g}; float32 resume (tol 1e-5): {rpr.iteration_count} "
          f"iterations, {wpr:.1f} ms, objective {fpr:.12g}: rel {relp:.2e} "
          f"to the float64 oracle (tol 1e-5)")
    print(f"[27 bf16 main path] Problem.microsolve on the bfloat16 planar "
          f"problem: {micro.status} in {micro.iteration_count} iterations, "
          f"equal to the kernel on the upcast channels: {same}")
    require(rpb.converged and rpr.converged and relp <= 1e-5,
            "the planar bfloat16 path misses the float64 oracle")
    require(same and micro.status == "converged",
            "Problem.microsolve on the bfloat16 planar problem")
    print(f"[27 bf16 main path] launches: {launches}")
    for kernel in ("K-B3 bf16", "K-B3p bf16", "K-B7 bf16", "K-B3", "K-B7",
                   "K-B8"):
        require(launches[kernel] >= 1, f"{kernel} never launched on the "
                f"bfloat16 main paths: {launches}")
    del A64
    return dict(launches=launches, rel=rel, relp=relp,
                iterations=(r_full.iteration_count, r16.iteration_count,
                            r_ref.iteration_count),
                walls_ms=(w_full, w16, w_ref))


# --------------------------------------------------------------------------
# Slice 7: the probes K-P2, K-P1 and K-P3
# --------------------------------------------------------------------------

def probe_matrix():
    """The GEMV probe's data (matvec_kernels.py:219-225): A 1000×2048
    (n padded to a lane multiple on the TPU) scaled by 1/40, x, b; seed 0."""
    rng = np.random.default_rng(0)
    m, n = 1000, 2048
    A = rng.standard_normal((m, n)).astype(np.float32) / 40
    x = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    return [torch.from_numpy(v).to(DEV) for v in (A, x, b)]


def rel_err(got, ref) -> float:
    """max|got − ref| over max|ref| (a scalar: its relative error)."""
    got, ref = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def phase_gradmap_check() -> dict:
    """K-P2 at 1000×2048 (A/40, seed 0): the kernel's (f, g) against its
    plain version (rel 1e-5: float32 sums in another order) and against
    float64 (rel 1e-5, the kernel's own report), and a second call's bits;
    call times, median of 20; a call split into card time, host time and
    device operations (one kernel a call)."""
    A, x, b = probe_matrix()
    m, n = A.shape
    f, g, ferr, gerr = matvec_probe.check_gradmap_correct(A, x, b)
    f0, g0 = matvec_probe.gradmap_reference(A, x, b)
    torch.cuda.synchronize()
    err_f, err_g = rel_err(f, f0), rel_err(g, g0)
    same = all(torch.equal(u, v) for u, v in
               zip((f, g), matvec_probe.gradmap_fused(A, x, b)))
    print(f"[28 K-P2 {m}x{n}] against float64: f rel {ferr:.3e}, g rel "
          f"{gerr:.3e} (tol 1e-5); against its plain version: f rel "
          f"{err_f:.3e}, max|dg|/max|g| {err_g:.3e} (tol 1e-5); second "
          f"call equal {same}")
    require(max(ferr, gerr, err_f, err_g) <= 1e-5 and same,
            "K-P2 disagrees with float64 or its plain version")
    reset_launches()
    kern = cuda_ms(lambda: matvec_probe.gradmap_fused(A, x, b), 20)
    launches = read_launches()["K-P2"]
    plain = cuda_ms(lambda: matvec_probe.gradmap_reference(A, x, b), 20)
    bd = bound(4.0 * (m * n + 2 * n + m + 1), 4.0 * m * n)
    print(f"[28 K-P2] call, median of 20: {kern:.4f} ms, plain {plain:.4f} ms; bound "
          f"{bd['bound_ms']:.5f} ms ({bd['bound_by']}); launches {launches}")
    split = call_split("[28 K-P2]",
                       lambda: matvec_probe.gradmap_fused(A, x, b))
    return dict(max_abs_err=float((g - g0).abs().max()), ms=kern,
                plain_ms=plain, **bd, library_ms=None, **split_keys(split),
                launches_timed=launches, f_rel_f64=ferr, g_rel_f64=gerr,
                shape="1000x2048 float32, A/40")


def phase_matvec_probe() -> dict:
    """K-P1 at 1000×2048: every formulation against its plain version at
    K = 3 on the last operation's result (rel 1e-5 of its largest entry:
    float32 sums in another order; the tensor-core forms at 3×TF32), x
    within 1e-6 of its largest entry, two runs equal; then the barrier
    alone (K grid barriers of each kind, no load, no update), µs per
    operation at K = 2000 (CUDA events around one launch, median of 3),
    the GB/s of one read of A per operation, the same chains over a 16×16
    corner of A (the barrier with its dependent load and update), and the
    card time of torch.mv(A, x) / torch.mv(A.mT,
    r) per call (200 calls in one CUDA graph, ``graph_ms``) as the library
    time of the fwd and adj rows, beside their kernels' own time in a
    ``profiling.trace``.  TF32 is off for torch.mv (phase 1)."""
    A, x0, b = probe_matrix()
    m, n = A.shape
    worst = 0.0
    for v in matvec_probe.VARIANTS:
        x, res = matvec_probe.run_variant(A, x0, b, v, 3)
        x2, res2 = matvec_probe.run_variant(A, x0, b, v, 3)
        xr, rr = matvec_probe.run_variant_reference(A, x0, b, v, 3)
        torch.cuda.synchronize()
        err = max(rel_err(res[0], rr[0]), rel_err(res[1], rr[1])) \
            if v == "gradmap_fused" else rel_err(res, rr)
        err_x = rel_err(x, xr)
        same = torch.equal(x, x2) and all(
            torch.equal(u, w) for u, w in zip(
                res if v == "gradmap_fused" else [res],
                res2 if v == "gradmap_fused" else [res2]))
        print(f"[29 K-P1 {v}] last of 3 ops rel {err:.3e} (tol 1e-5); x rel "
              f"{err_x:.3e} (tol 1e-6), equal {torch.equal(x, xr)}; two "
              f"runs equal {same}")
        require(err <= 1e-5 and err_x <= 1e-6 and same,
                f"K-P1 {v} disagrees with its plain version or itself")
        worst = max(worst, err)
    K, nbytes = 2000, 4.0 * m * n
    bd = bound(nbytes + 8.0 * n, 2.0 * m * n)
    d, g = torch.empty(m, device=DEV), torch.empty(n, device=DEV)
    mv = {"fwd": lambda: torch.mv(A, x0, out=d),
          "adj": lambda: torch.mv(A.mT, b, out=g)}
    lib = {k: graph_ms(fn) for k, fn in mv.items()}
    traced = {}
    for k, fn in mv.items():
        ops = profiling.device_ops(fn, 20, str(_build._BUILD_DIR.parent /
                                               "chip_smoke_trace"))
        # a call is one gemv kernel: its mean, which a dropped event
        # leaves as it is
        nk = ops["events"]["kernel"]
        us = ops["dur_us"] / nk if nk else None
        names = ops["names"]
        traced[k] = us
        print(f"[29 torch.mv {k}] {lib[k] * 1e3:.3f} us a call in a CUDA "
              f"graph of 200; its kernels in profiling.trace: "
              + ("no kernel events (not measured)" if us is None else
                 f"{us:.3f} us a call, the mean of {nk} kernel events for 20 "
                 f"calls ({', '.join(names)})"))
    reset_launches()
    # the barrier alone, each kind: K barriers and nothing else
    alone = {kind: cuda_ms(lambda kind=kind: matvec_probe.run_barriers(
        K, DEV, kind), 3, warmup=1) / K for kind in matvec_probe.BARRIERS}
    print(f"[29 K-P1 barrier alone] " + ", ".join(
        f"{kind} {t * 1e3:.3f} us" for kind, t in alone.items())
        + f" a barrier (K = {K}, median of 3); the forms end each op with "
        f"{matvec_probe.BARRIERS[0]}")
    per = {}
    for v in matvec_probe.VARIANTS:
        if v == "gradmap_fused":   # its own kernel, timed by phase_gradmap_probe
            continue
        ms = cuda_ms(lambda v=v: matvec_probe.run_variant(A, x0, b, v, K), 3,
                     warmup=1) / K
        per[v] = ms
        ref = lib.get(v[:3])
        note = "" if ref is None else (
            f"; torch.mv {ref * 1e3:.3f} us, "
            f"{'SLOWER than' if ms > ref else 'faster than'} torch.mv "
            f"({ms / ref:.2f}x)")
        print(f"[29 K-P1 {v}] {ms * 1e3:.3f} us per op (K = {K}, median of "
              f"3); {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s of one read of A; "
              f"bound {bd['bound_ms'] * 1e3:.3f} us{note}")
    # the barrier floor: the same chains over a 16×16 corner of A, where an
    # op is its grid barrier and a few dependent loads
    As, xs, bs = (A[:16, :16].contiguous(), x0[:16].contiguous(),
                  b[:16].contiguous())
    floor = {v: cuda_ms(lambda v=v: matvec_probe.run_variant(As, xs, bs, v, K),
                        3, warmup=1) / K for v in ("fwd_vpu", "adj_vpu")}
    print(f"[29 K-P1 16x16] barrier floor: fwd_vpu "
          f"{floor['fwd_vpu'] * 1e3:.3f} us, adj_vpu "
          f"{floor['adj_vpu'] * 1e3:.3f} us per op")
    launches = read_launches()["K-P1"]
    plain = cuda_ms(lambda: matvec_probe.run_variant_reference(
        A, x0, b, "fwd_vpu", K), 3, warmup=1) / K
    print(f"[29 K-P1] plain fwd per op {plain * 1e3:.3f} us; launches "
          f"during the timed runs {launches}")
    return dict(max_abs_err=worst, ms=per["fwd_vpu"], plain_ms=plain, **bd,
                library_ms=lib["fwd"], launches_timed=launches,
                us_per_op={v: t * 1e3 for v, t in per.items()},
                barrier_alone_us={k: t * 1e3 for k, t in alone.items()},
                torch_mv_us={k: t * 1e3 for k, t in lib.items()},
                torch_mv_traced_kernel_us=traced,
                floor_16x16_us={k: t * 1e3 for k, t in floor.items()},
                shape="1000x2048 float32, A/40, per chained op (K = 2000)")


def gradmap_probe_plan_line(m: int, n: int) -> str:
    """The card's plan of K-P1's gradmap kernel for (m, n), printed."""
    plan = matvec_probe._gradmap_tiles(0, m, n)[0]
    return (f"plan {plan.route}: {sum(plan.reg_rows)} rows in registers "
            f"(at most {max(plan.reg_rows)} a block), {sum(plan.smem_rows)} "
            f"in shared memory (at most {max(plan.smem_rows)}), "
            f"{plan.streamed_rows} read from L2 once a pass; "
            f"{plan.resident_share:.4f} of A on the chip")


def phase_gradmap_probe() -> dict:
    """K-P1's ``gradmap_fused`` form on its own kernel (rows on the chip,
    ``gradmap_probe_plan``): at 1000×2048 (the probe's data), its 16×16
    corner and the smallest m at which the card's plan streams rows at
    n = 2048 (A/40, seed 29), the plan printed; the result of K = 3
    within rel 1e-5 of its largest entry of the plain version's, x within
    1e-6 and equal to the plain version's (each update rounds as the
    plain version's does, far below x's spacing), two runs equal; from
    x₀ = 0, where each update moves x, x after 3 ops within rel 1e-5 of
    the plain version's and far (rel ≥ 0.1) from x after one, which a
    kernel that did not chain its ops would return; a call's device operations (one kernel, no
    memset, a ``profiling.trace`` of 10 calls of K = 3); µs per op at
    K = 2000 (CUDA events around one launch, median of 3) beside the bound
    (A once a launch and 4mn operations an op; the former reckoning, one
    read of A an op, printed) and beside the four-call library chain
    torch.mv(A, x), sub b, dot, torch.mv(A.mT, r) — two library GEMVs,
    not one call — in a CUDA graph of 200 chains (``graph_ms``)."""
    A, x0, b = probe_matrix()
    n = A.shape[1]
    nb, budget = matvec_probe._gradmap_grid(0, n)[:2]
    m_s = (8 + budget // (4 * n)) * nb + 1
    plan = matvec_probe.gradmap_probe_plan
    require(plan(m_s - 1, n, nb, budget).route == "resident"
            and plan(m_s, n, nb, budget).route == "streamed",
            f"K-P1 gradmap: {m_s}x{n} is not the first streamed shape")
    gen = torch.Generator(device=DEV).manual_seed(29)
    shapes = {"1000x2048": (A, x0, b),
              "16x16": (A[:16, :16].contiguous(), x0[:16].contiguous(),
                        b[:16].contiguous()),
              f"{m_s}x{n}": (torch.randn((m_s, n), generator=gen,
                                         device=DEV) / 40, x0,
                             torch.randn(m_s, generator=gen, device=DEV))}
    worst = 0.0
    for tag, (Am, xm, bm) in shapes.items():
        x, (f, g) = matvec_probe.run_variant(Am, xm, bm, "gradmap_fused", 3)
        x2, (f2, g2) = matvec_probe.run_variant(Am, xm, bm, "gradmap_fused", 3)
        xr, (fr, gr) = matvec_probe.run_variant_reference(
            Am, xm, bm, "gradmap_fused", 3)
        torch.cuda.synchronize()
        err = max(rel_err(f, fr), rel_err(g, gr))
        err_x, eq_x = rel_err(x, xr), torch.equal(x, xr)
        same = torch.equal(x, x2) and torch.equal(f, f2) and torch.equal(g, g2)
        xs = torch.zeros_like(xm)
        xc = matvec_probe.run_variant(Am, xs, bm, "gradmap_fused", 3)[0]
        xcr = matvec_probe.run_variant_reference(Am, xs, bm, "gradmap_fused",
                                                 3)[0]
        xc1 = matvec_probe.run_variant_reference(Am, xs, bm, "gradmap_fused",
                                                 1)[0]
        err_c, apart = rel_err(xc, xcr), rel_err(xc1, xcr)
        print(f"[29 K-P1 gradmap_fused {tag}] "
              f"{gradmap_probe_plan_line(*Am.shape)}; last of 3 ops rel "
              f"{err:.3e} (tol 1e-5); x rel {err_x:.3e} (tol 1e-6), equal "
              f"{eq_x}; two runs equal {same}; from x0 = 0: x rel "
              f"{err_c:.3e} (tol 1e-5), after 1 op {apart:.3f} away (>= 0.1)")
        require(f.shape == () and err <= 1e-5 and err_x <= 1e-6 and eq_x
                and same and err_c <= 1e-5 and apart >= 0.1,
                f"K-P1 gradmap_fused {tag} disagrees with its plain version "
                f"or itself, or does not chain its ops")
        worst = max(worst, float((f - fr).abs()), float((g - gr).abs().max()))
    print(f"[29 K-P1 gradmap_fused] grid barriers an op: "
          f"{matvec_probe.GRID_BARRIERS_PER_OP}")
    split = call_split("[29 K-P1 gradmap_fused 1000x2048, K = 3]",
                       lambda: matvec_probe.run_variant(
                           A, x0, b, "gradmap_fused", 3), 10, traced=True)
    K = 2000
    reset_launches()
    per = {tag: cuda_ms(lambda d=d: matvec_probe.run_variant(
        *d, "gradmap_fused", K), 3, warmup=1) / K for tag, d in shapes.items()}
    launches = read_launches()["K-P1"]
    m = A.shape[0]
    dv, rv, gv, fv = (torch.empty(m, device=DEV), torch.empty(m, device=DEV),
                      torch.empty(n, device=DEV), torch.empty((), device=DEV))

    def chain():
        torch.mv(A, x0, out=dv)
        torch.sub(dv, b, out=rv)
        torch.dot(rv, rv, out=fv)
        torch.mv(A.mT, rv, out=gv)
    chain_ms = graph_ms(chain)
    plain = cuda_ms(lambda: matvec_probe.run_variant_reference(
        A, x0, b, "gradmap_fused", 100), 3, warmup=1) / 100
    flops = 4.0 * m * n + 3.0 * m + 3.0 * n
    bd = bound((4.0 * m * n + 4.0 * m + 12.0 * n + 4.0) / K, flops)
    once = bound(4.0 * m * n + 4.0 * m + 12.0 * n + 4.0, flops)
    for tag, ms in per.items():
        print(f"[29 K-P1 gradmap_fused {tag}] {ms * 1e3:.3f} us per op (K = "
              f"{K}, median of 3)" + (
                  f"; bound {bd['bound_ms'] * 1e3:.4f} us ({bd['bound_by']}: A "
                  f"once a launch, 4mn operations an op), "
                  f"{ms / bd['bound_ms']:.1f}x; the former reckoning (A read "
                  f"once an op) {once['bound_ms'] * 1e3:.3f} us, "
                  f"{ms / once['bound_ms']:.2f}x; the four-call library chain "
                  f"(two library GEMVs, not one call) {chain_ms * 1e3:.3f} us, "
                  f"{chain_ms / ms:.2f}x the kernel; plain op "
                  f"{plain * 1e3:.3f} us" if tag == "1000x2048" else ""))
    print(f"[29 K-P1 gradmap_fused] launches during the timed runs {launches}")
    require(launches >= 1, "the timed runs launched no gradmap kernel")
    return dict(max_abs_err=worst, ms=per["1000x2048"], plain_ms=plain, **bd,
                library_ms=None, launches_timed=launches,
                chain4_graph_ms=chain_ms,
                chain4_note="torch.mv(A, x), sub b, dot, torch.mv(A.mT, r) in "
                            "one CUDA graph: two library GEMVs, not one call",
                us_per_op={tag: t * 1e3 for tag, t in per.items()},
                **split_keys(split),
                shape="1000x2048 float32, A/40, per chained op (K = 2000)")


def tail_flops(m: int, n: int, tried: int) -> float:
    """float32 operations of a K-P3 L6 run, counted as ``dense_flops``
    counts K-B1's: per trial, the step per column x̂ (2), the shrink (6),
    Δx and x₁ − x̂ (2), ‖Δx‖² twice, ⟨Δx,g⟩, ‖g‖², ‖x₁ − x̂‖² (10); the
    pass A x₁ (2mn), r and Σr² (3 per row) and Aᵀr (2mn); Δg (3),
    ⟨Δx,Δg⟩ and ‖Δg‖² (4) per column; at the start A x₀, r₀, Aᵀr₀."""
    return float(tried * (4 * m * n + 27 * n + 3 * m) + 4 * m * n + 3 * m)


def phase_tail_probe() -> dict:
    """K-P3 at 1000×2000 (seed 0, as micro_tail_probe.py:429-432): every
    rung and X variant against its plain version at K = 3 — τ and residual
    records, g and τ within 1e-5 of their largest entry (float32 sums in
    another order; the trajectory is chaotic, so only short runs are
    compared), trials equal; X2, X3, X4 and X5 bit-identical to L6; a
    call's device operations (one kernel, a ``profiling.trace``) and the
    grid barriers a trial.  Then µs per iteration and per trial at
    K = 5000 (CUDA events around one launch, median of 3; each X variant
    in turns with L6, L6 X X L6; records finite — L1 and L2 keep τ = 0.05
    against ‖AᵀA‖ ≈ 5.8e3, so their g overflows, as in the TPU probe), the
    step between rungs, X1…X5 against L6 (X1: the adjoint from A in L2
    against the rows on the chip), the plain L6 per iteration; the
    fidelity row: K-B1 (microsolve_lasso, hp off, stop_rule="iterations",
    tol 0) on the same A, b, x₀ at the same K, each rung's µs a trial
    beside K-B1's and L6 / K-B1; and the rungs over a 16×16 corner of A (a
    trial without its pass over A) beside K-B1's floor, LASSO 128×16."""
    rng = np.random.default_rng(0)
    m, n = 1000, 2000
    A, b, x0 = [torch.from_numpy(v).to(DEV) for v in (
        rng.standard_normal((m, n)).astype(np.float32),
        rng.standard_normal(m).astype(np.float32),
        rng.standard_normal(n).astype(np.float32))]
    rungs = [(f"L{i}", dict(level=i)) for i in range(7)] + [
        (f"X{i + 1}-{f}", {"level": 6, f: True})
        for i, f in enumerate(tail_probe.VARIANTS)]
    worst, outs = 0.0, {}
    for name, kw in rungs:
        out = tail_probe.make(**kw)(A, b, x0, 3)
        ref = tail_probe.tail_reference(A, b, x0, 3, kw["level"])
        torch.cuda.synchronize()
        # below L6 both record arrays are all zero: rel_err against a zero
        # reference is 0 only for a zero result
        err = max(rel_err(out.g, ref.g), rel_err(out.tau, ref.tau),
                  rel_err(out.taus, ref.taus),
                  rel_err(out.residuals, ref.residuals))
        same = int(out.trials) == int(ref.trials) and \
            torch.equal(out.x, ref.x)
        print(f"[30 K-P3 {name}] K = 3: records, g, tau rel {err:.3e} (tol "
              f"1e-5); trials {int(out.trials)}/{int(ref.trials)}; x equal "
              f"{torch.equal(out.x, ref.x)}")
        require(err <= 1e-5 and same,
                f"K-P3 {name} disagrees with its plain version")
        worst = max(worst, err)
        outs[name] = out
    same_bits = ("X2-thread", "X3-vecscal", "X4-fusedred", "X5-condbt")
    for name in same_bits:
        require(all(torch.equal(a, c) for a, c in zip(outs[name],
                                                      outs["L6"])),
                f"K-P3 {name} is not bit-identical to L6")
    print(f"[30 K-P3] {', '.join(same_bits)} bit-identical to L6: True")
    l6 = tail_probe.make(6)
    split = call_split("[30 K-P3 L6 1000x2000, K = 3]",
                       lambda: l6(A, b, x0, 3), 10, traced=True)
    print(f"[30 K-P3] grid barriers a trial: "
          f"{tail_probe.GRID_BARRIERS_PER_TRIAL} (the start: 2)")
    K = 5000
    reset_launches()
    per, tried, finite, beside = {}, {}, {}, {}

    def launch_ms(run) -> float:
        return cuda_ms(lambda: run(A, b, x0, K), 3, warmup=0) / K

    for name, kw in rungs:
        run = tail_probe.make(**kw)
        out = run(A, b, x0, K)              # the warm-up run, checked
        require(bool(torch.isfinite(out.taus).all()
                     and torch.isfinite(out.residuals).all()),
                f"K-P3 {name} at K = {K}: records not finite")
        finite[name], tried[name] = bool(torch.isfinite(out.g).all()), \
            int(out.trials)
        if name.startswith("X"):
            # in turns with L6 (L6, X, X, L6): the spread between calls is
            # as large as the smaller effects
            t = [launch_ms(r) for r in (l6, run, run, l6)]
            per[name], beside[name] = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        else:
            per[name] = launch_ms(run)
    # the same rungs over a 16×16 corner of A: a trial is then its two
    # grid barriers, its reductions and decisions, and almost no pass
    As, bs, xs = (A[:16, :16].contiguous(), b[:16].contiguous(),
                  x0[:16].contiguous())
    small = {}
    for name, kw in rungs[:7]:
        run = tail_probe.make(**kw)
        tr = int(run(As, bs, xs, K).trials)
        small[name] = cuda_ms(lambda run=run: run(As, bs, xs, K), 3,
                              warmup=0) / tr
    launches = read_launches()["K-P3"]

    # K-B1 itself at the same K: on the ladder's data, and its floor
    def kb1(A_, b_, x0_):
        return lambda: microsolver.microsolve_lasso(  # noqa: E731
            A_, b_, x0_, tail_probe.TAU0, tail_probe.MU, max_iters=K,
            tol=0.0, stop_rule="iterations", hp=False, record_bts=True)
    floor = problems.build("lasso", m=128, n=16, k=12, device=DEV)
    b1 = {}
    for key, fn in (("1000x2000", kb1(A, b, x0)),
                    ("128x16", kb1(floor.op.A, floor.fterm.b, floor.x0))):
        b1_tried, b1_k = trials(fn())
        b1_ms = cuda_ms(fn, 3, warmup=1)
        b1[key] = dict(us_per_trial=b1_ms / b1_tried * 1e3,
                       us_per_iteration=b1_ms / b1_k * 1e3,
                       trials_per_iteration=b1_tried / b1_k)
    plain = cuda_ms(lambda: tail_probe.tail_reference(A, b, x0, 50, 6), 3,
                    warmup=1) / 50
    trial_us = {k: per[k] * K / tried[k] * 1e3 for k in per}
    prev = None
    for name, _ in rungs:
        us = per[name] * 1e3
        step = "" if name.startswith("X") or prev is None else \
            f" (+{us - prev:.3f} us)"
        if name.startswith("X"):
            step = (f" ({beside[name] / per[name]:.3f}x L6 in turns, L6 "
                    f"{beside[name] * 1e3:.3f} us)")
        else:
            prev = us
        print(f"[30 K-P3 {name}] {us:.3f} us per iteration, "
              f"{tried[name] / K:.3f} trials per iteration, "
              f"{trial_us[name]:.3f} us per trial "
              f"({trial_us[name] / b1['1000x2000']['us_per_trial']:.3f}x "
              f"K-B1's){step}; g finite {finite[name]}"
              + ("" if name not in small else
                 f"; at 16x16 {small[name] * 1e3:.3f} us per trial"))
    fid = trial_us["L6"] / b1["1000x2000"]["us_per_trial"]
    print(f"[30 K-B1 fidelity] microsolve_lasso hp off on the ladder's "
          f"data, K = {K}: {b1['1000x2000']['us_per_trial']:.3f} us per "
          f"trial, {b1['1000x2000']['trials_per_iteration']:.3f} trials per "
          f"iteration; L6 {trial_us['L6']:.3f} us per trial, L6 / K-B1 "
          f"{fid:.3f}; its floor (LASSO 128x16) "
          f"{b1['128x16']['us_per_trial']:.3f} us per trial beside the "
          f"rungs at 16x16 (L0 {small['L0'] * 1e3:.3f}, L6 "
          f"{small['L6'] * 1e3:.3f})")
    print(f"[30 K-P3] X1, A from L2 against A on the chip: the adjoint by "
          f"column chunks of A from L2 {trial_us['X1-col']:.3f} us per trial "
          f"against the rows on the chip (L6 in turns) "
          f"{beside['X1-col'] * K / tried['L6'] * 1e3:.3f}: "
          f"{(per['X1-col'] - beside['X1-col']) * 1e3:+.3f} us per iteration;"
          f" plain L6 {plain * 1e3:.3f} us per iteration; launches during "
          f"the timed runs {launches}")
    bd = bound(4.0 * (m * n + m + 2 * n) / K,
               tail_flops(m, n, tried["L6"]) / K)
    return dict(max_abs_err=worst, ms=per["L6"], plain_ms=plain, **bd,
                library_ms=None, launches_timed=launches,
                us_per_iteration={k: v * 1e3 for k, v in per.items()},
                us_per_trial=trial_us,
                trials_per_iteration={k: v / K for k, v in tried.items()},
                l6_in_turns_us={k: v * 1e3 for k, v in beside.items()},
                kb1=b1, l6_over_kb1=fid,
                us_per_trial_16x16={k: v * 1e3 for k, v in small.items()},
                **split_keys(split),
                shape="1000x2000 float32, L6, per iteration (K = 5000)")


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
    b7 = phase_planar_gradmap()
    p5 = phase_planar_probe()
    b8 = phase_planar_microsolver()
    pr = phase_pr_main_path()
    b4 = phase_shrink_step()
    b1b = phase_batch_dense()
    b6b = phase_batch_tv()
    b8b = phase_batch_planar()
    serving = phase_serving()
    b3_16, b3p_16 = phase_bf16_gradmap()
    b7_16 = phase_bf16_planar_gradmap()
    p4 = phase_bf16_probe()
    b8w = phase_wide_planar()
    bf16 = phase_bf16_main_path()
    p2 = phase_gradmap_check()
    p1 = phase_matvec_probe()
    p1g = phase_gradmap_probe()
    p3 = phase_tail_probe()
    launches = {k: lasso[k] + dense[k] + tv[k] + pr[k]
                + serving["launches"][k] + b8w["launches"][k]
                + bf16["launches"][k] for k in lasso}
    del b8w["launches"]
    launches["K-P5"] = p5.pop("launches_timed")
    launches["K-P4"] = p4.pop("launches_timed")
    for key, p in (("K-P1", p1), ("K-P1 gradmap", p1g), ("K-P2", p2),
                   ("K-P3", p3)):
        launches[key] = p.pop("launches_timed")
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
        dict(name="K-B7 fused_planar_gradmap (hinge and least-squares forms)",
             route="cuda", source="fasta_tpu_torch/csrc/planar_fused.cu",
             replaces="fasta_tpu/kernels/planar_fused.py:197",
             launches=launches["K-B7"], **b7),
        dict(name="K-B8 microsolve_planar_phasemax", route="cuda",
             source="fasta_tpu_torch/csrc/microsolver_planar.cu",
             replaces="fasta_tpu/kernels/microsolver_planar.py:669",
             launches=launches["K-B8"], **b8),
        dict(name="K-P5 planar_probe (launches: phase 15's timed runs)",
             route="cuda", source="fasta_tpu_torch/csrc/planar_probe.cu",
             replaces="benchmarks/planar_matvec_probe.py:314",
             launches=launches["K-P5"], **p5),
        dict(name="K-B4 fused_shrink_step", route="cuda",
             source="fasta_tpu_torch/csrc/prox_fused.cu",
             replaces="fasta_tpu/kernels/prox_fused.py:101",
             launches=launches["K-B4"], **b4),
        dict(name="K-B1b microsolve_lasso_batch", route="cuda",
             source="fasta_tpu_torch/csrc/microsolver.cu",
             replaces="fasta_tpu/kernels/microsolver.py:810 under vmap, "
                      "fasta_tpu/micro.py:435",
             launches=launches["K-B1b"], **b1b),
        dict(name="K-B6b microsolve_tv_batch", route="cuda",
             source="fasta_tpu_torch/csrc/microsolver_tv.cu",
             replaces="fasta_tpu/kernels/microsolver_tv.py:607 under vmap, "
                      "fasta_tpu/micro.py:435",
             launches=launches["K-B6b"], **b6b),
        dict(name="K-B8b microsolve_planar_phasemax_batch", route="cuda",
             source="fasta_tpu_torch/csrc/microsolver_planar.cu",
             replaces="fasta_tpu/kernels/microsolver_planar.py:669 under "
                      "vmap, fasta_tpu/micro.py:435",
             launches=launches["K-B8b"], **b8b),
        dict(name="K-B3 bf16 fused_lstsq_gradmap (bfloat16 A)", route="cuda",
             source="fasta_tpu_torch/csrc/lstsq_fused.cu",
             replaces="fasta_tpu/kernels/lstsq_fused.py:407",
             launches=launches["K-B3 bf16"], **b3_16),
        dict(name="K-B3p bf16 fused_pointwise_gradmap (bfloat16 A)",
             route="cuda", source="fasta_tpu_torch/csrc/lstsq_fused.cu",
             replaces="fasta_tpu/kernels/lstsq_fused.py:331",
             launches=launches["K-B3p bf16"], **b3p_16),
        dict(name="K-B7 bf16 fused_planar_gradmap (bfloat16 channels)",
             route="cuda", source="fasta_tpu_torch/csrc/planar_fused.cu",
             replaces="fasta_tpu/kernels/planar_fused.py:197",
             launches=launches["K-B7 bf16"], **b7_16),
        dict(name="K-P4 bf16_probe (launches: phase 25's timed runs)",
             route="cuda", source="fasta_tpu_torch/csrc/bf16_probe.cu",
             replaces="benchmarks/bf16_matvec_probe.py:53",
             launches=launches["K-P4"], **p4),
        dict(name="K-B8w microsolve_planar_phasemax, the route past n = 512 "
                  "(launches: K-B8 and K-B8b on it)", route="cuda",
             source="fasta_tpu_torch/csrc/microsolver_planar.cu",
             replaces="fasta_tpu/kernels/microsolver_planar.py:669",
             launches=launches["K-B8w"] + launches["K-B8bw"], **b8w),
        dict(name="K-P2 check_gradmap_correct (launches: phase 28's timed "
                  "runs)", route="cuda",
             source="fasta_tpu_torch/csrc/matvec_probe.cu",
             replaces="benchmarks/matvec_kernels.py:199",
             launches=launches["K-P2"], **p2),
        dict(name="K-P1 run_variant, fwd and adj forms (launches: phase "
                  "29's timed runs; ms: fwd_vpu per op)", route="cuda",
             source="fasta_tpu_torch/csrc/matvec_probe.cu",
             replaces="benchmarks/matvec_kernels.py:158",
             launches=launches["K-P1"], **p1),
        dict(name="K-P1 run_variant, gradmap_fused form (launches: phase "
                  "29's timed runs; ms: per op at 1000x2048)", route="cuda",
             source="fasta_tpu_torch/csrc/gradmap_probe.cu",
             replaces="benchmarks/matvec_kernels.py:158",
             launches=launches["K-P1 gradmap"], **p1g),
        dict(name="K-P3 tail_probe ladder (launches: phase 30's timed runs; "
                  "ms: L6 per iteration)", route="cuda",
             source="fasta_tpu_torch/csrc/tail_probe.cu",
             replaces="benchmarks/micro_tail_probe.py:411",
             launches=launches["K-P3"], **p3),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
