"""Split each call of K-B4 (the fused shrink step), K-B5 (the fused TV
gradient map), K-B7 (the fused planar gradient map, hinge form) and K-P2
(the one-pass gradient-map check) into its card time, its host time and
its stream time, and time the PyTorch loop paths that call the first
three, in several checkouts of the repository, one fresh process per
checkout, in the order given, on one CUDA card.

    python3 tools/call_split.py [--kernels] ROOT [ROOT ...]
    python3 tools/call_split.py --sweep

Each ROOT is the top of a checkout: its ``fasta_tpu_torch`` is imported
from there and its kernels are built into ROOT/build/.  To compare two
checkouts on one card, give them as A B B A.  The timing helpers are this
file's own checkout's ``fasta_tpu_torch/profiling.py``, so every checkout
is read alike.  Per shape — K-B4 at 1×2000 (a LASSO loop trial), 32×2000
(a serving batch-loop trial) and 1×2²⁴, a τ and a μ per row on the card;
K-B5 at 512×512 (a TV loop trial) and 4096×4096; K-B7's hinge form over
float32 channels at 16384×256 (a phase-retrieval loop trial, A in L2) and
16384×4096 (A streamed from device memory) and 1000×37 (rows not 16-byte
aligned), and over bfloat16 channels at 16384×4096 and 1024×16384 (the
wide route); K-P2 at 1000×2048 (A/40, seed 0, as ``chip_smoke.py``) —

* ``card_us``: the card's time per call, summed over the kernels,
  memsets and copies of 20 calls in a ``profiling.trace``, and ``ops``,
  how many of each a call made;
* ``host_us``: the host clock around 200 calls with no wait for the card
  (where the card is faster than the host, a call's cost to a loop), the
  median of five such runs;
* ``stream_ms``: CUDA events around 20 back-to-back calls, the median of
  five such runs;
* ``call_ms``: CUDA events around one call, the median of 20 (the
  host's work inside, as ``chip_smoke.py`` times a call).

Beside K-P2, K-P1's µs per chained operation over the same A (fwd_vpu,
gradmap_fused, adj_vpu at K = 2000, and the grid barrier alone; CUDA
events around one launch, median of 3), which shares K-P2's kernel.

``--sweep`` sets the two kernels' plans from the card: in this checkout
alone, K-B4's routes against each other over n and K-B5's bands and
blocks per SM, card µs per call from a CUDA graph of 50 calls.

Then, unless ``--kernels`` is given, the it/s of the loop path
(``Problem.solve_device``, adaptive) at 2000 iterations on LASSO
1000×2000 (K-B4 on every trial), TV 512×512 (K-B5 on every trial) and
planar phase retrieval 16384×256 (K-B7 on every trial): host clock, the
median of five runs after a 200-iteration warm-up, every run printed.  Prints the card's name and
power limit, then one JSON line per checkout.  Fails without a CUDA
device.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

B4_SHAPES = ((1, 2000), (32, 2000), (1, 1 << 24))
B5_SHAPES = ((512, 512), (4096, 4096))
B7_SHAPES = ((16384, 256, "float32"), (16384, 4096, "float32"),
             (16384, 4096, "bfloat16"), (1024, 16384, "bfloat16"),
             (1000, 37, "float32"))
LOOP_RUNS = 5
_HERE = os.path.dirname(os.path.abspath(__file__))


def _profiling():
    """This checkout's profiling module, loaded by path (it imports only
    torch), whichever checkout's package is being timed."""
    path = os.path.join(_HERE, os.pardir, "fasta_tpu_torch", "profiling.py")
    spec = importlib.util.spec_from_file_location("_call_split_prof", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stream_ms(fn, runs=20):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def _call_ms(fn, runs=20):
    import torch
    for _ in range(3):
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


def _split(prof, fn, logdir, calls=20, runs=5) -> dict:
    ops = prof.device_ops(fn, calls, logdir)
    return dict(card_us=ops["dur_us"] / calls,
                ops={k: n / calls for k, n in ops["events"].items()},
                names=ops["names"],
                host_us=statistics.median(prof.host_us(fn, 200)
                                          for _ in range(runs)),
                stream_ms=statistics.median(_stream_ms(fn)
                                            for _ in range(runs)),
                call_ms=_call_ms(fn))


def _loop_its(p, opts_cls):
    import torch
    p.solve_device(opts_cls(max_iters=200, stop_rule="iterations"))
    torch.cuda.synchronize()
    rates = []
    for _ in range(LOOP_RUNS):
        t0 = time.perf_counter()
        p.solve_device(opts_cls(max_iters=2000, stop_rule="iterations"))
        torch.cuda.synchronize()
        rates.append(2000 / (time.perf_counter() - t0))
    return statistics.median(rates), rates


def _child(root: str, kernels_only: bool) -> None:
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("call_split needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    prof = _profiling()
    import fasta_tpu_torch as ftt
    from fasta_tpu_torch import problems
    from fasta_tpu_torch.kernels import (matvec_probe, planar_fused,
                                         prox_fused, tv_fused)
    dev = torch.device("cuda", 0)
    logdir = os.path.join(root, "build", "call_split_trace")
    gen = torch.Generator(device=dev).manual_seed(9)
    out = {"root": root}
    for R, n in B4_SHAPES:
        x0 = torch.randn((R, n), generator=gen, device=dev)
        g = torch.randn((R, n), generator=gen, device=dev)
        tau = torch.rand(R, generator=gen, device=dev) + 0.05
        mu = torch.rand(R, generator=gen, device=dev)
        out[f"K-B4 {R}x{n}"] = _split(
            prof, lambda: prox_fused.fused_shrink_step(x0, g, tau, mu),
            logdir)
        del x0, g
    for h, w in B5_SHAPES:
        p = torch.randn((2, h, w), generator=gen, device=dev)
        b = torch.randn((h, w), generator=gen, device=dev)
        out[f"K-B5 {h}x{w}"] = _split(
            prof, lambda: tv_fused.fused_tv_gradmap(p, b, 0.1), logdir)
        del p, b
    for m, n, dtype in B7_SHAPES:
        dt = getattr(torch, dtype)
        Ar = (torch.randn((m, n), generator=gen, device=dev)
              / (2 * m) ** 0.5).to(dt)
        Ai = (torch.randn((m, n), generator=gen, device=dev)
              / (2 * m) ** 0.5).to(dt)
        x = torch.randn((n, 2), generator=gen, device=dev)
        bm = torch.rand(m, generator=gen, device=dev) + 0.1
        tag = f"K-B7 {m}x{n}" + ("" if dtype == "float32" else f" {dtype}")
        out[tag] = _split(
            prof, lambda: planar_fused.fused_planar_hinge_gradmap(
                Ar, Ai, x, bm), logdir)
        del Ar, Ai
    rng = np.random.default_rng(0)
    A, xp, bp = (torch.from_numpy(v).to(dev) for v in (
        rng.standard_normal((1000, 2048)).astype(np.float32) / 40,
        rng.standard_normal(2048).astype(np.float32),
        rng.standard_normal(1000).astype(np.float32)))
    out["K-P2 1000x2048"] = _split(
        prof, lambda: matvec_probe.gradmap_fused(A, xp, bp), logdir)
    K = 2000
    per_op = {v: _call_ms(lambda v=v: matvec_probe.run_variant(
        A, xp, bp, v, K), 3) / K * 1e3
        for v in ("fwd_vpu", "gradmap_fused", "adj_vpu")}
    per_op["barrier"] = _call_ms(lambda: matvec_probe.run_barriers(
        K, dev), 3) / K * 1e3
    out["K-P1 us_per_op"] = per_op
    if kernels_only:
        print(json.dumps(out), flush=True)
        return
    lasso = problems.build("lasso", device="cuda")
    lasso.tau0 = 0.05
    tv = problems.build("tv", device="cuda")
    tv.tau0 = 2.0
    pr = problems.build("phase_retrieval", planar=True, device="cuda")
    pr.tau0 = 1.0
    for name, p in (("lasso", lasso), ("tv", tv), ("phase_retrieval", pr)):
        before = (prox_fused.LAUNCHES, tv_fused.LAUNCHES,
                  planar_fused.LAUNCHES)
        its, runs = _loop_its(p, ftt.FastaOptions)
        out[f"loop_its_{name}"] = its
        out[f"loop_its_{name}_runs"] = runs
        out[f"loop_launches_{name}"] = [
            prox_fused.LAUNCHES - before[0], tv_fused.LAUNCHES - before[1],
            planar_fused.LAUNCHES - before[2]]
    print(json.dumps(out), flush=True)


def _graph_us(fn, calls=50):
    """Card time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph on a stream warmed up first, the replay timed by CUDA events
    (median of 5).  Launch gaps between the graph's kernels are
    included."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times) / calls * 1e3


def _sweep() -> None:
    """This checkout's routes and plans against each other: K-B4's row and
    stream routes over n (R = 1, 8, 32) and K-B5's blocks per SM and
    least band rows at three sizes, beside yardsticks (PyTorch's own
    kernels moving the same bytes, the smallest kernel); card µs per call
    from ``_graph_us``."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("call_split needs a CUDA device")
    from fasta_tpu_torch.kernels import _build, prox_fused, tv_fused
    dev = torch.device("cuda", 0)
    sms = _build.sm_count(0)
    gen = torch.Generator(device=dev).manual_seed(3)
    edge = prox_fused.ROW_MAX_N
    for R in (1, 8, 32):
        for n in (2000, 4096, 6144, 8192, 12288, 16384, 32768, 1 << 20):
            x0 = torch.randn((R, n), generator=gen, device=dev)
            g = torch.randn((R, n), generator=gen, device=dev)
            line = {"kernel": "K-B4", "R": R, "n": n,
                    "plan": prox_fused.shrink_plan(R, n, sms).route}
            for route, reach in (("row", 1 << 30), ("stream", 0)):
                prox_fused.ROW_MAX_N = reach
                plan = prox_fused.shrink_plan(R, n, sms)
                if plan.route == route:
                    line[f"{route}_blocks"] = plan.grid[0]
                    line[f"{route}_us"] = _graph_us(
                        lambda: prox_fused._launch(x0, g, 0.3, 0.5, plan))
            prox_fused.ROW_MAX_N = edge
            print(json.dumps(line), flush=True)
    # yardsticks: the same bytes through PyTorch's own elementwise
    # kernels, and the smallest kernel's time in a graph
    x = torch.randn(1 << 24, generator=gen, device=dev)
    y = torch.randn(1 << 24, generator=gen, device=dev)
    z = torch.empty_like(x)
    print(json.dumps({"yardstick": "torch.add 1x2^24 (12 B an entry)",
                      "us": _graph_us(lambda: torch.add(x, y, out=z), 10)}))
    big = torch.randn(3 * 4096 * 4096, generator=gen, device=dev)
    out = torch.empty_like(big)
    print(json.dumps({"yardstick": "copy_ of 3x4096x4096 floats (24 B a "
                                   "pixel)",
                      "us": _graph_us(lambda: out.copy_(big), 10)}))
    small = torch.randn(3 * 512 * 512, generator=gen, device=dev)
    out2 = torch.empty_like(small)
    print(json.dumps({"yardstick": "copy_ of 3x512x512 floats",
                      "us": _graph_us(lambda: out2.copy_(small))}))
    one = torch.zeros(1, device=dev)
    print(json.dumps({"yardstick": "add_ on one float (the launch floor)",
                      "us": _graph_us(lambda: one.add_(1.0))}))
    del x, y, z, big, out
    defaults = (tv_fused.BLOCKS_PER_SM, tv_fused.MIN_BAND_ROWS)
    for h, w in ((512, 512), (1024, 1024), (4096, 4096)):
        p = torch.randn((2, h, w), generator=gen, device=dev)
        b = torch.randn((h, w), generator=gen, device=dev)
        for per_sm in (1, 2, 3, 4):
            for least in (2, 4, 8):
                tv_fused.BLOCKS_PER_SM, tv_fused.MIN_BAND_ROWS = per_sm, least
                plan = tv_fused.tv_plan(h, w, sms)
                us = _graph_us(lambda: tv_fused._launch(p, b, 0.1, plan),
                               10 if h * w > 1 << 22 else 50)
                print(json.dumps({"kernel": "K-B5", "shape": f"{h}x{w}",
                                  "blocks_per_sm": per_sm,
                                  "min_band_rows": least,
                                  "bands": len(plan.bands),
                                  "strips": plan.strips, "us": us}),
                      flush=True)
        tv_fused.BLOCKS_PER_SM, tv_fused.MIN_BAND_ROWS = defaults


def main(roots, kernels_only=False) -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for root in roots:
        root = os.path.abspath(root)
        env = dict(os.environ, PYTHONPATH=root)
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--child-kernels" if kernels_only else "--child",
                        root], cwd=root, env=env, check=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] in ("--child", "--child-kernels"):
        _child(sys.argv[2], sys.argv[1] == "--child-kernels")
    elif len(sys.argv) > 2 and sys.argv[1] == "--kernels":
        main(sys.argv[2:], kernels_only=True)
    elif sys.argv[1:] == ["--sweep"]:
        sys.path.insert(0, os.path.join(_HERE, os.pardir))
        _sweep()
    elif len(sys.argv) > 1:
        main(sys.argv[1:])
    else:
        raise SystemExit(__doc__)
