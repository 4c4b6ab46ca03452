"""Profile the PyTorch loop path (``Problem.solve_device``) on LASSO
1000×2000 on one CUDA card, in several checkouts of the repository, one
fresh process per checkout, in the order given.

    python3 tools/loop_profile.py ROOT [ROOT ...]

For each checkout (imported from ROOT, kernels built into ROOT/build/):
the host wall time per iteration over 500 iterations
(``stop_rule="iterations"``, after a warm-up), then a ``torch.profiler``
trace of 100 iterations: kernel launches, host syncs and device time per
iteration, and the ten host-side operations that take the most CPU time
under the profiler.  The card's busy share is the traced device time per
iteration over the untraced wall per iteration (the profiler's own host
cost makes the traced wall meaningless).  Prints the card's name and power
limit first.  Fails without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def _child(root: str) -> None:
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("loop_profile needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    import fasta_tpu_torch as ftt
    from fasta_tpu_torch import problems
    p = problems.build("lasso", device="cuda")

    def run(n):
        out = p.solve_device(ftt.FastaOptions(max_iters=n,
                                              stop_rule="iterations"),
                             tau0=0.05)
        torch.cuda.synchronize()
        return out

    run(200)
    t0 = time.perf_counter()
    run(500)
    wall_us = (time.perf_counter() - t0) / 500 * 1e6
    n = 100
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(n)
    ev = prof.key_averages()
    launches = sum(e.count for e in ev if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cudaLaunchCooperativeKernel", "cudaMemsetAsync"))
    syncs = sum(e.count for e in ev if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaMemcpyAsync"))
    device_us = sum(getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
                    for e in ev) / n
    top = sorted((e for e in ev if e.key.startswith("aten::")),
                 key=lambda e: -e.self_cpu_time_total)[:10]
    print(json.dumps({
        "root": root, "wall_us_per_iteration": wall_us,
        "launches_and_memsets_per_iteration": launches / n,
        "syncs_and_copies_per_iteration": syncs / n,
        "device_us_per_iteration": device_us,
        "device_busy_share": device_us / wall_us,
        "top_host_ops_us_per_iteration": {
            e.key: e.self_cpu_time_total / n for e in top}}), flush=True)


def main(roots) -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for root in roots:
        root = os.path.abspath(root)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        root], cwd=root, env=dict(os.environ,
                                                  PYTHONPATH=root),
                       check=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        _child(sys.argv[2])
    elif len(sys.argv) > 1:
        main(sys.argv[1:])
    else:
        raise SystemExit(__doc__)
