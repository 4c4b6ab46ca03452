"""Time one all-reduce over gloo between ranks that share one CUDA card,
as the sharded solves of ``chip_smoke.py`` (phases 33, 34) make them.

    python3 tools/gloo_allreduce.py [--threads N] [WORLD ...]

For each world size (default 2 and 4): that many processes on card 0,
one gloo group through a ``FileStore`` under ``build/``, and for each
buffer size (3, 1024 and 8192 float64 values — the scalar sums, a rank's
block of x at 2000 columns over 2, the largest (f, g) buffer of phases 33
and 34) the host wall time per all-reduce, the median over 5 rounds of 50
calls each (after 20 warm-up calls), of three transports: the CUDA tensor
handed to gloo, the tensor copied to the host, all-reduced there and
copied back, and a host tensor alone.  ``--threads N`` sets each rank's
``torch.set_num_threads`` first (PyTorch's default otherwise).  Prints
the card's name and power limit, then rank 0's JSON line per (world,
size).  Fails without a CUDA device.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import statistics
import subprocess
import sys
import tempfile
import time

SIZES = (3, 1024, 8192)
ROUNDS, CALLS, WARMUP = 5, 50, 20


def _rank(rank: int, world: int, store: str, out, threads) -> None:
    import torch
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(store, world))
    torch.cuda.set_device(0)
    try:
        rows = {}
        for n in SIZES:
            dev = torch.ones(n, dtype=torch.float64, device="cuda")
            host = torch.ones(n, dtype=torch.float64)

            def on_card():
                dist.all_reduce(dev)

            def staged():
                buf = dev.cpu()
                dist.all_reduce(buf)
                dev.copy_(buf)

            def on_host():
                dist.all_reduce(host)

            for name, fn in (("card", on_card), ("staged", staged),
                             ("host", on_host)):
                for _ in range(WARMUP):
                    fn()
                torch.cuda.synchronize()
                dist.barrier()
                times = []
                for _ in range(ROUNDS):
                    t0 = time.perf_counter()
                    for _ in range(CALLS):
                        fn()
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) / CALLS * 1e3)
                    dist.barrier()
                rows.setdefault(n, {})[name] = statistics.median(times)
        out.put((rank, rows))
    finally:
        dist.destroy_process_group()


def main(worlds, threads=None) -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("gloo_allreduce needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build")
    os.makedirs(root, exist_ok=True)
    ctx = mp.get_context("spawn")
    for world in worlds:
        tmp = tempfile.mkdtemp(prefix="gloo_store_", dir=root)
        out = ctx.Queue()
        procs = [ctx.Process(target=_rank,
                             args=(r, world, os.path.join(tmp, "store"), out,
                                   threads))
                 for r in range(world)]
        for p in procs:
            p.start()
        rows = dict(out.get(timeout=600) for _ in procs)
        for p in procs:
            p.join(timeout=60)
        for n in SIZES:
            print(json.dumps({"world": world, "threads": threads,
                              "float64_values": n,
                              "ms_per_all_reduce": rows[0][n]}))


if __name__ == "__main__":
    args = sys.argv[1:]
    threads = None
    if args[:1] == ["--threads"]:
        threads, args = int(args[1]), args[2:]
    main([int(w) for w in args] or [2, 4], threads)
