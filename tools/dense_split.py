"""Time the dense whole-solve kernel K-B1 (and K-B1b, K-B1p) per iteration
and per trial at the shapes of its routes, in several checkouts of the
repository, one fresh process per checkout, in the order given, on one
CUDA card.

    python3 tools/dense_split.py [--streamed] ROOT [ROOT ...]
    python3 tools/dense_split.py --phases ROOT

Each ROOT is the top of a checkout: its ``fasta_tpu_torch`` is imported
from there and its kernels are built into ROOT/build/.  To compare two
checkouts on one card, give them as A B B A.  Per shape (LASSO,
``problems.build("lasso", m=, n=, k=m // 10)``; τ₀ 0.05, μ 0.1,
adaptive, hp off, ``stop_rule="iterations"``) — 1000×2000, 1000×500 and
800×100 for 2000 iterations, the tall and the wide shape at the 24 MB
gate, 6000×1000 and 1000×6000, for 300, and the floor, where a trial is
only its barriers, reductions and decisions: 128×16 for 2000 —
K-B1 (``microsolve_lasso``) runs once to count its trials, then:

* ``us_per_iteration`` and ``us_per_trial``: CUDA events around one
  launch, median of 3;
* ``traced_us_per_iteration``: the kernel's own time in a
  ``profiling.trace`` of one launch (None when the trace holds none);
* where the checkout's wrapper has a dense plan (``dense_plan``): the
  route, the share of A kept on the chip and the bytes an adaptive trial
  reads from L2.

Then the kernel path of NNLS, logistic and SVM at their problems' sizes
(``Problem.microsolve``, 2000 iterations: it/s); LASSO 1000×2000 to tol
1e-6 (hp off, ms a launch and iterations); K-B1b over 32 instances
(b·(1 + 0.02i), τ₀ 0.05, 0.075, 0.1 by i mod 3, tol 1e-6, hp, restart_dd:
ms a launch); K-B1p over μ = 0.4, 0.2, 0.1, 0.05, warm (tol 1e-5,
``stop_rule="residual"``: ms a launch).  These three also give
``traced_ms``, the kernel's own time in a trace of one launch: a launch
this short also times the host's work around it.

Where the checkout has a dense plan, the streamed sweep prices the
residency at a fixed shape: 2500×2000 and 6000×1000 (300 iterations
each) and 1000×6000 (300) run again on plans whose blocks keep a half
and none of the rows that the card's plan keeps in shared memory
(``dense_plan`` with the card's budget times 1, 1/2 and 0; the rows in
registers stay), the rest read from L2 every pass with each thread's own
16-byte loads.  Per run: the budget, the share of A on the chip, the
bytes a trial reads from L2 and µs an iteration and a trial.
``--streamed`` runs the sweep alone.

``--phases`` (this tree alone) splits an adaptive trial of the row
kernel: it copies ``fasta_tpu_torch/csrc`` into ``build/dense_phases/``,
puts a ``clock64`` probe at each phase boundary of ``dense_rows_kernel``
(block 0, thread 0; the cycles of each phase summed in shared memory and
written out at the end of the launch), builds that copy into its own
library and runs LASSO 128×16, 1000×500 and 1000×2000 (hp off, 2000
iterations): per phase the cycles a trial, their share, and µs at the
launch's own rate (CUDA events around the probed launch over its cycles).
The probes cost a few cycles each; the phases are block 0's view, so a
barrier's phase holds the wait for the slowest block.

Prints the card's name and power limit, then one JSON line per checkout.
Fails without a CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

# (m, n): iterations at a fixed count
SHAPES = {(1000, 2000): 2000, (1000, 500): 2000, (800, 100): 2000,
          (6000, 1000): 300, (1000, 6000): 300, (128, 16): 2000}
STREAM_SWEEP = {(2500, 2000): 300, (6000, 1000): 300, (1000, 6000): 300}
FAMILY = {"nnls": 0.08, "logistic": 1.0, "svm": 0.3}
BATCH = 32
MUS = [0.4, 0.2, 0.1, 0.05]


def _median_ms(fn, runs=3):
    import torch
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


_NAMES = ("dense_rows_kernel", "dense_columns_kernel", "microsolve_kernel")


def _traced_ms(fn, logdir):
    """The summed card time of the K-B1 kernels one call of ``fn``
    launches, from a profiling.trace (None when the trace holds none)."""
    import torch
    from fasta_tpu_torch import profiling
    fn()
    torch.cuda.synchronize()
    with profiling.trace(logdir) as d:
        fn()
    with open(os.path.join(d, "trace.json")) as fh:
        events = [e for e in json.load(fh).get("traceEvents", [])
                  if e.get("cat") == "kernel"
                  and any(k in e.get("name", "") for k in _NAMES)]
    return sum(float(e["dur"]) for e in events) / 1e3 if events else None


def _route(ms, m, n):
    """The dense plan's route on this card, where the checkout has one."""
    if not hasattr(ms, "dense_plan"):
        return None
    plan = ms._tiles(0, m, (n + 3) // 4 * 4)[0]
    return dict(kernel=plan.kernel, route=plan.route,
                resident_share=plan.resident_share,
                l2_bytes_per_trial=plan.streamed_bytes)


def _lasso(shapes):
    from fasta_tpu_torch import problems
    return {(m, n): problems.build("lasso", m=m, n=n, k=max(1, m // 10),
                                   device="cuda") for m, n in shapes}


def _fixed(iters):
    return dict(max_iters=iters, tol=0.0, stop_rule="iterations", hp=False,
                record_bts=True)


def _sweep(ms, probs):
    """The shapes of STREAM_SWEEP on plans that keep 1, 1/2 and none of
    the card's shared-memory rows (see the module's note)."""
    rows = []
    for (m, n), iters in STREAM_SWEEP.items():
        p = probs[(m, n)]
        n4 = (n + 3) // 4 * 4
        nb, budget = ms._grid(0, n4)[:2]
        o = ms._options(_fixed(iters))
        for share in (1.0, 0.5, 0.0):
            plan = ms.dense_plan(m, n4, nb, int(budget * share))

            def run():
                return ms._launch(p.op.A, p.fterm.b, p.x0, 0.05, 0.1, 1,
                                  False, False, o, plan)
            res = run()
            k = int(res[3][0])
            trials = k + int(res[6][0][:k].sum())
            ms_ = _median_ms(run)
            rows.append(dict(
                shape=f"{m}x{n}", budget=int(budget * share),
                route=plan.route, resident_share=plan.resident_share,
                l2_bytes_per_trial=plan.streamed_bytes, iterations=k,
                trials=trials, ms=ms_, us_per_iteration=ms_ / k * 1e3,
                us_per_trial=ms_ / trials * 1e3))
            print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    return rows


def _child(root: str, sweep_only: bool = False) -> None:
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("dense_split needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from fasta_tpu_torch import problems
    from fasta_tpu_torch.kernels import microsolver as ms
    logdir = os.path.join(root, "build", "dense_split_trace")
    out = {"root": root}
    if sweep_only:
        out["streamed sweep"] = _sweep(ms, _lasso(STREAM_SWEEP))
        print(json.dumps(out), flush=True)
        return
    probs = _lasso(set(SHAPES) | set(STREAM_SWEEP))
    for (m, n), iters in SHAPES.items():
        p = probs[(m, n)]

        def run():
            return ms.microsolve_lasso(p.op.A, p.fterm.b, p.x0, 0.05, 0.1,
                                       **_fixed(iters))
        res = run()
        k = int(res.iteration_count)
        trials = k + int(res.backtracks[:k].sum())
        t = _median_ms(run)
        traced = _traced_ms(run, logdir)
        tag = f"{m}x{n}"
        out[tag] = dict(
            iterations=k, trials=trials, ms=t,
            us_per_iteration=t / k * 1e3, us_per_trial=t / trials * 1e3,
            traced_us_per_iteration=None if traced is None
            else traced / k * 1e3,
            traced_us_per_trial=None if traced is None
            else traced / trials * 1e3,
            plan=_route(ms, m, n))
        print(json.dumps({tag: out[tag]}), file=sys.stderr, flush=True)
    for name, tau0 in FAMILY.items():
        prob = problems.build(name, device="cuda")
        prob.tau0 = tau0

        def path():
            return prob.microsolve(max_iters=2000, tol=0.0,
                                   stop_rule="iterations")
        t = _median_ms(path)
        out[f"{name} kernel path"] = dict(ms=t, it_per_s=2000 / t * 1e3)
    p = probs[(1000, 2000)]
    A, b, x0 = p.op.A, p.fterm.b, p.x0

    def solve():
        return ms.microsolve_lasso(A, b, x0, 0.05, 0.1, max_iters=5000,
                                   tol=1e-6, record_fvals=True,
                                   record_bts=True)
    res = solve()
    out["1000x2000 to tol 1e-6"] = dict(
        ms=_median_ms(solve, 10), traced_ms=_traced_ms(solve, logdir),
        iterations=int(res.iteration_count), status=res.status)
    bs = torch.stack([b * (1.0 + 0.02 * i) for i in range(BATCH)])
    t0s = torch.tensor([0.05 * (1.0 + (i % 3) / 2.0) for i in range(BATCH)],
                       device="cuda")

    def batch():
        return ms.microsolve_lasso_batch(A, bs, x0, t0s, 0.1, max_iters=5000,
                                         tol=1e-6, hp=True, restart_dd=True,
                                         record_bts=True)
    res = batch()
    out[f"K-B1b 1000x2000 x {BATCH}"] = dict(
        ms=_median_ms(batch), traced_ms=_traced_ms(batch, logdir),
        iterations=int(res.iteration_count.sum()))

    def path_mus():
        return ms.microsolve_lasso_path(A, b, x0, 0.05, MUS, warm=True,
                                        max_iters=3000, tol=1e-5,
                                        stop_rule="residual", record_bts=True)
    res = path_mus()
    out["K-B1p 4 mu warm"] = dict(
        ms=_median_ms(path_mus), traced_ms=_traced_ms(path_mus, logdir),
        iterations=int(res.iteration_count.sum()))
    if hasattr(ms, "dense_plan"):
        out["streamed sweep"] = _sweep(ms, probs)
    print(json.dumps(out), flush=True)


# (name, anchor in csrc/microsolver.cu, where): the probe that ends each
# phase of an adaptive trial of dense_rows_kernel, before or after its
# anchor; phase 0 starts at the top of the trial loop
PHASES = (
    ("loop", "      ++trial;\n", "after"),
    ("step: x1", "      // ---- the rows at x₁: f (and the adaptive gradient's shares)\n",
     "before"),
    ("rows pass", "      grid_arrive(a.bar, gen);\n      // ---- while the others arrive",
     "before"),
    ("arrive", "      grid_arrive(a.bar, gen);\n", "after"),
    ("step sums, decision's first half",
     "        if (warp == 1) decide_prepare<Acc, ACCEL>(st, tot, fwin, a.ctl, prep);\n      }\n",
     "after"),
    ("barrier 1 wait", "      grid_wait(a.bar, nb, gen);\n\n      if (!ACCEL) {\n", "after"),
    ("reduce g, BB sums",
     "        reduce_shares<Acc, true>(a, P + kF * nb, red, xc, gc, x1, tau);\n", "after"),
    ("barrier 2", "        barrier();\n        // warp 0's loads", "after19"),
    ("loads: g, BB sums, f", "        copy_g(a.gvec, G(cur ^ 1), nq);\n", "after"),
    ("decision", "      __syncthreads();\n      if (a.its && st.accepted", "after23"),
    ("records, loop test", "      if (st.done) break;\n    }\n\n    // ---- point end: the solution (FISTA",
     "before"),
)


def _probed_source(src: str) -> str:
    """csrc/microsolver.cu with a probe at the end of each of PHASES."""
    defs = ("__shared__ unsigned long long s_phase[16];\n"
            "__shared__ unsigned long long s_last;\n"
            "__device__ unsigned long long g_phase[16];\n"
            "#define PHASE(k) do { if (blockIdx.x == 0 && threadIdx.x == 0) { "
            "const unsigned long long t_ = clock64(); s_phase[k] += t_ - s_last; "
            "s_last = t_; } } while (0)\n")
    anchor = "namespace {\n\nconstexpr int kThreads = 512;"
    if anchor not in src:
        raise SystemExit("dense_split --phases: csrc/microsolver.cu has moved")
    src = src.replace(anchor, "namespace {\n" + defs + "\nconstexpr int kThreads = 512;", 1)
    for k, (name, text, where) in enumerate(PHASES):
        i = src.find(text)
        if i < 0:
            raise SystemExit(f"dense_split --phases: no anchor for {name!r}")
        probe = f"      PHASE({k});\n"
        if where == "before":
            j = i
        elif where == "after":
            j = i + len(text)
        else:  # after the first n characters of the anchor
            j = i + int(where[5:])
        src = src[:j] + probe + src[j:]
    start = "  if (tid == 0) {\n    carry_ok = 0;\n    tprev = 0.f;\n"
    end = ("  grid_exit(a.bar, nb);\n}\n\n// ----------------------------------"
           "-----------------------------------------\n// dense_columns_kernel")
    if start not in src or end not in src:
        raise SystemExit("dense_split --phases: csrc/microsolver.cu has moved")
    src = src.replace(start, start + "    for (int k = 0; k < 16; ++k) s_phase[k] = 0;\n"
                      "    s_last = clock64();\n", 1)
    src = src.replace(end, "  if (blk == 0 && tid == 0)\n    for (int k = 0; k < 16; ++k) "
                      "g_phase[k] = s_phase[k];\n" + end, 1)
    return src + ('\nextern "C" int fasta_dense_phases(unsigned long long* out) {\n'
                  "  return cudaMemcpyFromSymbol(out, g_phase, 16 * sizeof(unsigned long long));\n"
                  "}\n")


def _phases(root: str) -> None:
    """The --phases split (see the module's note), in this process."""
    import ctypes
    import shutil
    from pathlib import Path
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("dense_split needs a CUDA device")
    from fasta_tpu_torch.kernels import _build
    from fasta_tpu_torch.kernels import microsolver as ms
    work = Path(root) / "build" / "dense_phases"
    csrc = work / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build._CSRC, csrc)
    (csrc / "microsolver.cu").write_text(
        _probed_source((csrc / "microsolver.cu").read_text()))
    _build._CSRC, _build._BUILD_DIR = csrc, work / "lib"
    lib = _build.library()
    lib.fasta_dense_phases.argtypes = [ctypes.c_void_p]
    out = {"root": root, "phases": [name for name, _, _ in PHASES]}
    for m, n in ((128, 16), (1000, 500), (1000, 2000)):
        p = _lasso([(m, n)])[(m, n)]

        def run():
            return ms.microsolve_lasso(p.op.A, p.fterm.b, p.x0, 0.05, 0.1,
                                       **_fixed(2000))
        res = run()
        k = int(res.iteration_count)
        trials = k + int(res.backtracks[:k].sum())
        t = _median_ms(run)
        buf = (ctypes.c_ulonglong * 16)()
        _build.check(lib.fasta_dense_phases(ctypes.addressof(buf)),
                     "fasta_dense_phases")
        cycles = [buf[i] / trials for i in range(len(PHASES))]
        total = sum(cycles)
        us = t / trials * 1e3
        out[f"{m}x{n}"] = dict(
            trials=trials, us_per_trial=us, cycles_per_trial=total,
            phases={name: dict(cycles=c, share=c / total, us=c * us / total)
                    for (name, _, _), c in zip(PHASES, cycles)})
        print(json.dumps({f"{m}x{n}": out[f"{m}x{n}"]}), file=sys.stderr,
              flush=True)
    print(json.dumps(out), flush=True)


def main(roots, sweep_only: bool = False) -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for root in roots:
        root = os.path.abspath(root)
        env = dict(os.environ, PYTHONPATH=root)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        root] + ["--streamed"] * sweep_only, cwd=root,
                       env=env, check=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--child"] and len(args) in (2, 3):
        _child(args[1], args[2:] == ["--streamed"])
    elif args[:1] == ["--streamed"] and len(args) > 1:
        main(args[1:], True)
    elif args[:1] == ["--phases"] and len(args) == 2:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(), flush=True)
        _phases(os.path.abspath(args[1]))
    elif args and not args[0].startswith("-"):
        main(args)
    else:
        raise SystemExit(__doc__)
