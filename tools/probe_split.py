"""Time the probes K-P3 (the tail-ablation ladder), K-P4 (the
bfloat16-storage probe) and K-P1 (the GEMV formulation probe) in several
checkouts of the repository, one fresh process per checkout, in the order
given, on one CUDA card.

    python3 tools/probe_split.py ROOT [ROOT ...]

Each ROOT is the top of a checkout: its ``fasta_tpu_torch`` is imported
from there and its kernels are built into ROOT/build/.  To compare two
checkouts on one card, give them as A B B A.  Per checkout, through the
probes' public calls only (``tail_probe.make(...)(A, b, x0, K)``,
``bf16_probe.bf16_probe(A, x0, K)``, ``microsolver.microsolve_lasso``,
``matvec_probe.run_variant(A, x0, b, variant, K)``,
``matvec_probe.run_barriers(K, device)``), so that a checkout whose
kernels differ behind those calls times alike:

* K-P3 at 1000×2000 (seed 0, as micro_tail_probe.py:429-432): every rung
  L0…L6 and X variant for K = 2000 iterations — µs an iteration and a
  trial (CUDA events around one launch, median of 3) and trials an
  iteration; the rungs L0…L6 over the 16×16 corner of A (a trial without
  its pass over A), µs a trial; and K-B1 (``microsolve_lasso``, hp off,
  ``stop_rule="iterations"``) on the same A, b, x₀ at the same K, µs a
  trial: the fidelity row, with L6 / K-B1;
* K-P4 at 1000×2000 and at 4753×2000 (on the H100 the smallest m at which
  the K-P4 plan streams float32 rows from L2 and keeps every
  bfloat16 row on the chip), float32 and bfloat16 storage: µs a pair as
  the difference of a 1100- and a 100-pair launch over 1000, each the
  best of 3, in turns (float32, bfloat16, bfloat16, float32);
* K-P1: ``gradmap_fused`` at 1000×2048 (A/40, seed 0, as
  matvec_kernels.py:219-225), its 16×16 corner and 4621×2048 (on the H100
  the smallest m at which the gradmap kernel's plan streams rows at
  n = 2048), µs an op at K = 2000 (CUDA events around one launch, median
  of 3); at 1000×2048 every other formulation and the barrier alone
  (``hand``) the same way.

Prints the card's name and power limit, then one JSON line per checkout.
Fails without a CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

K_TAIL = 2000
P4_SHAPES = ((1000, 2000), (4753, 2000))
K_P1 = 2000
P1_STREAMED = (4621, 2048)


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


def _best_ms(fn, runs=3):
    import torch
    best = float("inf")
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def _tail(A, b, x0):
    from fasta_tpu_torch.kernels import microsolver, tail_probe
    rungs = [(f"L{i}", dict(level=i)) for i in range(7)] + [
        (f"X{i + 1}-{f}", {"level": 6, f: True})
        for i, f in enumerate(tail_probe.VARIANTS)]
    out = {}
    for name, kw in rungs:
        run = tail_probe.make(**kw)
        tried = int(run(A, b, x0, K_TAIL).trials)
        ms = _median_ms(lambda: run(A, b, x0, K_TAIL))
        out[name] = dict(us_per_iteration=ms / K_TAIL * 1e3,
                         us_per_trial=ms / tried * 1e3,
                         trials_per_iteration=tried / K_TAIL)
    As, bs, xs = (A[:16, :16].contiguous(), b[:16].contiguous(),
                  x0[:16].contiguous())
    for name, kw in rungs[:7]:
        run = tail_probe.make(**kw)
        tried = int(run(As, bs, xs, K_TAIL).trials)
        out[name]["us_per_trial_16x16"] = \
            _median_ms(lambda: run(As, bs, xs, K_TAIL)) / tried * 1e3

    def kb1():
        return microsolver.microsolve_lasso(
            A, b, x0, tail_probe.TAU0, tail_probe.MU, max_iters=K_TAIL,
            tol=0.0, stop_rule="iterations", hp=False, record_bts=True)
    res = kb1()
    k = int(res.iteration_count)
    tried = k + int(res.backtracks[:k].sum())
    us = _median_ms(kb1) / tried * 1e3
    out["K-B1"] = dict(us_per_trial=us, trials_per_iteration=tried / k)
    out["L6/K-B1"] = out["L6"]["us_per_trial"] / us
    return out


def _pairs(m, n):
    import torch
    from fasta_tpu_torch.kernels import bf16_probe
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(25)
    A32 = torch.randn((m, n), generator=gen, device=dev) / m ** 0.5
    x0 = torch.randn(n, generator=gen, device=dev)
    mats = {"float32": A32, "bfloat16": A32.to(torch.bfloat16)}
    turns = {k: [] for k in mats}
    for name in ("float32", "bfloat16", "bfloat16", "float32"):
        A = mats[name]
        bf16_probe.bf16_probe(A, x0, 100)
        long = _best_ms(lambda: bf16_probe.bf16_probe(A, x0, 1100))
        short = _best_ms(lambda: bf16_probe.bf16_probe(A, x0, 100))
        turns[name].append((long - short) / 1000 * 1e3)
    return {k: dict(us_per_pair=statistics.mean(t), turns=t)
            for k, t in turns.items()}


def _p1(A, x0, b):
    import torch
    from fasta_tpu_torch.kernels import matvec_probe
    dev = A.device

    def per_op(A, x0, b, v):
        return _median_ms(lambda: matvec_probe.run_variant(
            A, x0, b, v, K_P1)) / K_P1 * 1e3
    gen = torch.Generator(device=dev).manual_seed(29)
    m, n = P1_STREAMED
    shapes = {"1000x2048": (A, x0, b),
              "16x16": (A[:16, :16].contiguous(), x0[:16].contiguous(),
                        b[:16].contiguous()),
              f"{m}x{n}": (torch.randn((m, n), generator=gen, device=dev) / 40,
                           x0, torch.randn(m, generator=gen, device=dev))}
    out = {f"gradmap_fused {k}": per_op(*d, "gradmap_fused")
           for k, d in shapes.items()}
    for v in matvec_probe.VARIANTS:
        if v != "gradmap_fused":
            out[v] = per_op(A, x0, b, v)
    out["barrier"] = _median_ms(lambda: matvec_probe.run_barriers(
        K_P1, dev)) / K_P1 * 1e3
    return out


def _child(root: str) -> None:
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    A, b, x0 = [torch.from_numpy(v).to(dev) for v in (
        rng.standard_normal((1000, 2000)).astype(np.float32),
        rng.standard_normal(1000).astype(np.float32),
        rng.standard_normal(2000).astype(np.float32))]
    out = dict(root=root, tail=_tail(A, b, x0))
    out["pairs"] = {f"{m}x{n}": _pairs(m, n) for m, n in P4_SHAPES}
    rng = np.random.default_rng(0)
    out["p1_us_per_op"] = _p1(*[torch.from_numpy(v).to(dev) for v in (
        rng.standard_normal((1000, 2048)).astype(np.float32) / 40,
        rng.standard_normal(2048).astype(np.float32),
        rng.standard_normal(1000).astype(np.float32))])
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
    args = sys.argv[1:]
    if args[:1] == ["--child"] and len(args) == 2:
        _child(args[1])
    elif args and not args[0].startswith("-"):
        main(args)
    else:
        raise SystemExit(__doc__)
