"""Split the TV whole-solve kernel's time into its floor and its pixels'
work, in several checkouts of the repository, one fresh process per
checkout, in the order given, on one CUDA card.

    python3 tools/tv_split.py ROOT [ROOT ...]

Each ROOT is the top of a checkout: its ``fasta_tpu_torch`` is imported
from there and its kernels are built into ROOT/build/.  For each image
(16×16, where a trial is only its barriers, reductions and decisions;
512×512; 2048×2048), K-B6 (``microsolve_tv``, adaptive, hp, the problem's
weight) runs a fixed 2000 iterations (``stop_rule="iterations"``; 200 at
2048×2048).  Prints the card's name and power limit, then one JSON line
per checkout: µs an iteration from CUDA events around one launch (median
of 3) and from the kernel's own time in a ``profiling.trace``, the trials
the run took, and the route each launch took where the checkout counts
routes.  Fails without a CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

ITERS = {16: 2000, 512: 2000, 2048: 200}


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
    """The summed card time of the kernels one call of ``fn`` launches,
    from a profiling.trace (None when the trace holds no kernel)."""
    import torch
    from fasta_tpu_torch import profiling
    fn()
    torch.cuda.synchronize()
    with profiling.trace(logdir) as d:
        fn()
    with open(os.path.join(d, "trace.json")) as fh:
        events = [e for e in json.load(fh).get("traceEvents", [])
                  if e.get("cat") == "kernel"]
    tv = [e for e in events if "microsolve_tv" in e.get("name", "")]
    return sum(float(e["dur"]) for e in tv) / 1e3 if tv else None


def _child(root: str) -> None:
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("tv_split needs a CUDA device")
    from fasta_tpu_torch import problems
    from fasta_tpu_torch.kernels import microsolver_tv as mt
    out = {"root": root}
    for side, iters in ITERS.items():
        prob = problems.build("tv", h=side, w=side, device="cuda")
        b, p0 = prob.fterm.b, prob.x0
        mu = float(prob.instance["mu"])

        def run():
            return mt.microsolve_tv(b, p0, 2.0, mu, max_iters=iters, tol=0.0,
                                    stop_rule="iterations", record_bts=True)
        before = getattr(mt, "LAUNCHES_RESIDENT", None)
        res = run()
        if before is not None:
            out[f"resident_{side}"] = mt.LAUNCHES_RESIDENT > before
        k = int(res.iteration_count)
        ms = _median_ms(run)
        traced = _traced_ms(run, os.path.join(root, "build", "tv_split_trace"))
        out[f"us_per_iteration_{side}"] = ms / k * 1e3
        out[f"traced_us_per_iteration_{side}"] = (
            None if traced is None else traced / k * 1e3)
        out[f"trials_{side}"] = k + int(res.backtracks[:k].sum())
        out[f"iterations_{side}"] = k
    print(json.dumps(out), flush=True)


def main(roots) -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for root in roots:
        root = os.path.abspath(root)
        env = dict(os.environ, PYTHONPATH=root)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        root], cwd=root, env=env, check=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        _child(sys.argv[2])
    elif len(sys.argv) > 1:
        main(sys.argv[1:])
    else:
        raise SystemExit(__doc__)
