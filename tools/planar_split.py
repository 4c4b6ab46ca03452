"""Time the planar whole-solve kernel K-B8 (and K-B8b) per iteration and
per trial at the shapes of its routes, in several checkouts of the
repository, one fresh process per checkout, in the order given, on one
CUDA card.

    python3 tools/planar_split.py [--streamed] ROOT [ROOT ...]

Each ROOT is the top of a checkout: its ``fasta_tpu_torch`` is imported
from there and its kernels are built into ROOT/build/.  To compare two
checkouts on one card, give them as A B B A.  Per shape (phase retrieval,
planar, ``problems.build``; τ₀ 1.0, adaptive, hp) — 16384×256 for 2000
iterations, 2048×1024, 8192×640 and 256×8192 for 300 (``stop_rule=
"iterations"``), and the floors, where a trial is only its barriers,
reductions and decisions: 128×16 for 2000 iterations (n ≤ 512) and
128×1024 for 300 (the wide route) — K-B8 (``microsolve_planar_phasemax``)
runs once to count its trials, then:

* ``us_per_iteration`` and ``us_per_trial``: CUDA events around one
  launch, median of 3;
* ``traced_us_per_iteration``: the kernel's own time in a
  ``profiling.trace`` of one launch (None when the trace holds none);
* the trials the run took and the route the launch took where the
  checkout's wrapper has a tile plan (``tile_plan``: the route, the share
  of A kept on the chip, the bytes a trial reads from L2).

Where the checkout has a tile plan, the streamed sweep prices the
residency at a fixed shape: 16384×256 (2000 iterations), 8192×640 and
2048×1024 (300 each) run again on plans whose blocks keep a half and
none of the rows that the card's plan keeps in shared memory
(``tile_plan`` with the card's budget times 1, 1/2 and 0; at 16384×256
the 32 register rows a block stay), the rest read from L2 every trial
with each thread's own 16-byte loads.  Per run: the budget, the share of
A on the chip, the bytes a trial reads from L2 and µs an iteration and a
trial.  The extra µs a trial over the extra streamed rows is what the
streamed remainder costs, and so the most that hiding its loads could
buy.  ``--streamed`` runs the sweep alone.

Then K-B8 to tol 1e-5 at 16384×256 and 8192×640 (ms a launch, iterations)
and K-B8b over 16 instances at 16384×256 (b·(1 + 0.02i), τ₀ 1.0, 1.5,
2.0 by i mod 3, tol 1e-5: ms a launch).  Prints the card's name and power
limit, then one JSON line per checkout.  Fails without a CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

# (m, n): iterations at a fixed count
SHAPES = {(16384, 256): 2000, (2048, 1024): 300, (8192, 640): 300,
          (256, 8192): 300, (128, 16): 2000, (128, 1024): 300}
TO_TOL = ((16384, 256), (8192, 640))
STREAM_SWEEP = {(16384, 256): 2000, (8192, 640): 300, (2048, 1024): 300}
BATCH = 16


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


def _traced_ms(fn, logdir):
    """The summed card time of the K-B8 kernels one call of ``fn``
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
                  and "microsolve_planar" in e.get("name", "")]
    return sum(float(e["dur"]) for e in events) / 1e3 if events else None


def _route(mp, m, n):
    """The tile plan's route on this card, where the checkout has one."""
    if not hasattr(mp, "tile_plan"):
        return None
    plan = mp._tiles(0, m, (n + 3) // 4 * 4)[0]
    return dict(kernel=plan.kernel, route=plan.route,
                resident_share=plan.resident_share,
                l2_bytes_per_trial=plan.streamed_bytes)


def _sweep(mp, probs):
    """The shapes of STREAM_SWEEP on plans that keep 1, 1/2 and none of
    the card's shared-memory rows (see the module's note)."""
    rows = []
    for (m, n), iters in STREAM_SWEEP.items():
        p = probs[(m, n)]
        data = (p.op.Ar, p.op.Ai, p.fterm.b, p.gterm.c, p.x0)
        n4 = (n + 3) // 4 * 4
        nb, budget = mp._grid(0, n4)[:2]
        o = mp._options(dict(max_iters=iters, tol=0.0,
                             stop_rule="iterations", hp=True,
                             record_bts=True))
        for share in (1.0, 0.5, 0.0):
            plan = mp.tile_plan(m, n4, nb, int(budget * share))

            def run():
                return mp._launch(*data, 1.0, 1, False, o, plan)
            res = run()
            k = int(res[3][0])
            trials = k + int(res[6][0][:k].sum())
            ms = _median_ms(run)
            rows.append(dict(
                shape=f"{m}x{n}", budget=int(budget * share),
                route=plan.route, resident_share=plan.resident_share,
                l2_bytes_per_trial=plan.streamed_bytes, iterations=k,
                trials=trials, ms=ms, us_per_iteration=ms / k * 1e3,
                us_per_trial=ms / trials * 1e3))
            print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    return rows


def _problems(shapes):
    from fasta_tpu_torch import problems
    return {(m, n): problems.build("phase_retrieval", m=m, n=n, planar=True,
                                   device="cuda") for m, n in shapes}


def _child(root: str, sweep_only: bool = False) -> None:
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("planar_split needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from fasta_tpu_torch.kernels import microsolver_planar as mp
    logdir = os.path.join(root, "build", "planar_split_trace")
    out = {"root": root}
    if sweep_only:
        out["streamed sweep"] = _sweep(mp, _problems(STREAM_SWEEP))
        print(json.dumps(out), flush=True)
        return
    probs = _problems(SHAPES)
    for (m, n), iters in SHAPES.items():
        p = probs[(m, n)]
        data = (p.op.Ar, p.op.Ai, p.fterm.b, p.gterm.c, p.x0)

        def run():
            return mp.microsolve_planar_phasemax(
                *data, 1.0, max_iters=iters, tol=0.0, stop_rule="iterations",
                hp=True, record_bts=True)
        res = run()
        k = int(res.iteration_count)
        trials = k + int(res.backtracks[:k].sum())
        ms = _median_ms(run)
        traced = _traced_ms(run, logdir)
        tag = f"{m}x{n}"
        out[tag] = dict(
            iterations=k, trials=trials, ms=ms,
            us_per_iteration=ms / k * 1e3, us_per_trial=ms / trials * 1e3,
            traced_us_per_iteration=None if traced is None
            else traced / k * 1e3,
            traced_us_per_trial=None if traced is None
            else traced / trials * 1e3,
            plan=_route(mp, m, n))
        print(json.dumps({tag: out[tag]}), file=sys.stderr, flush=True)
    if hasattr(mp, "tile_plan"):
        out["streamed sweep"] = _sweep(mp, probs)
    for m, n in TO_TOL:
        p = probs[(m, n)]
        data = (p.op.Ar, p.op.Ai, p.fterm.b, p.gterm.c, p.x0)

        def solve():
            return mp.microsolve_planar_phasemax(*data, 1.0, max_iters=2000,
                                                 tol=1e-5, hp=True)
        res = solve()
        out[f"{m}x{n} to tol 1e-5"] = dict(
            ms=_median_ms(solve), iterations=int(res.iteration_count),
            status=res.status)
    p = probs[(16384, 256)]
    bs = torch.stack([p.fterm.b * (1.0 + 0.02 * i) for i in range(BATCH)])
    t0s = torch.tensor([1.0 + (i % 3) / 2.0 for i in range(BATCH)],
                       device="cuda")

    def batch():
        return mp.microsolve_planar_phasemax_batch(
            p.op.Ar, p.op.Ai, bs, p.gterm.c, p.x0, t0s, max_iters=2000,
            tol=1e-5, hp=True, restart_dd=True)
    res = batch()
    out[f"K-B8b 16384x256 x {BATCH}"] = dict(
        ms=_median_ms(batch), iterations=int(res.iteration_count.sum()))
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
    elif args and not args[0].startswith("-"):
        main(args)
    else:
        raise SystemExit(__doc__)
