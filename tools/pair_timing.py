"""Time the port's whole-solve kernels and PyTorch loop paths in several
checkouts of the repository, one fresh process per checkout, in the order
given, on one CUDA card.

    python3 tools/pair_timing.py ROOT [ROOT ...]

Each ROOT is the top of a checkout: its ``fasta_tpu_torch`` and
``reference_oracle`` are imported from there and its kernels are built
into ROOT/build/.  To compare two checkouts on one card, give them as
A B B A.  Prints the card's name and power limit, then one JSON line per
run: K-B1 on LASSO 1000×2000 to tol 1e-6 (hp off and on, median of 20),
K-B6 on TV 512×512 to tol 1e-5 (median of 3), K-B8 on planar phase
retrieval 16384×256 to tol 1e-5 (hp, median of 5) — CUDA events around
each solve — and the it/s of the loop path (``Problem.solve_device``)
at 2000 iterations on LASSO and sparse logistic regression (host clock,
the median of five runs after a 200-iteration warm-up; every run is
printed, since the host clock spreads more than the card's).  Fails
without a CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

LOOP_RUNS = 5


def _median_ms(fn, runs):
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


def _child(root: str) -> None:
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("pair_timing needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    import fasta_tpu_torch as ftt
    from fasta_tpu_torch import problems
    out = {"root": root}
    lasso = problems.build("lasso", device="cuda")
    lasso.tau0 = 0.05
    for hp in (False, True):
        out[f"kb1_ms_hp{int(hp)}"] = _median_ms(
            lambda: lasso.microsolve(max_iters=5000, tol=1e-6, hp=hp), 20)
    tv = problems.build("tv", device="cuda")
    tv.tau0 = 2.0
    out["kb6_ms"] = _median_ms(lambda: tv.microsolve(max_iters=5000,
                                                     tol=1e-5), 3)
    pr = problems.build("phase_retrieval", planar=True, device="cuda")
    pr.tau0 = 1.0
    out["kb8_ms"] = _median_ms(lambda: pr.microsolve(max_iters=2000,
                                                     tol=1e-5, hp=True), 5)
    logistic = problems.build("logistic", device="cuda")
    logistic.tau0 = 1.0
    for name, p in (("lasso", lasso), ("logistic", logistic)):
        p.solve_device(ftt.FastaOptions(max_iters=200,
                                        stop_rule="iterations"))
        torch.cuda.synchronize()
        rates = []
        for _ in range(LOOP_RUNS):
            t0 = time.perf_counter()
            p.solve_device(ftt.FastaOptions(max_iters=2000,
                                            stop_rule="iterations"))
            torch.cuda.synchronize()
            rates.append(2000 / (time.perf_counter() - t0))
        out[f"loop_its_{name}"] = statistics.median(rates)
        out[f"loop_its_{name}_runs"] = rates
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
