"""Check that the dense kernels K-B1 (and K-B1b, K-B1p), K-P3, K-P4, K-P2
and K-P1 give the same bits in several checkouts of the repository, one
fresh process per checkout, on one CUDA card.

    python3 tools/dense_bits.py [--gradmap] ROOT [ROOT ...]

Each ROOT is the top of a checkout: its ``fasta_tpu_torch`` is imported
from there and its kernels are built into ROOT/build/.  A change that
should keep the kernels' bits (a refactor of shared device code) is run
as ``tools/dense_bits.py PARENT CHANGE``.  Per checkout, on data made
from fixed seeds:

* K-B1 (``microsolve_lasso``, 60 iterations, every record) at the shapes
  of its routes — registers, shared memory, ragged, two and four slots a
  thread, one short row lane, the column fallback and the floor — for
  each loss × prox pair of lstsq × l1, logistic × l1, squared hinge × box,
  lstsq × nonneg and lstsq × ridge, adaptive and FISTA, hp off and on;
* K-B1 on dense plans forced to stream rows (budget 0 and 12 rows' worth)
  at 3000×1000, 2000×1500 and 500×3000, adaptive and FISTA;
* K-B1p (three weights, warm) and K-B1b (four instances) at 1000×2000;
* every K-P3 rung and X variant (K = 20) at 1000×2000, 200×300, 16×16
  and 600×1500; K-P4 (5 pairs) in float32 and bfloat16 at 1000×2000,
  37×1003, 64×8 and 4753×2000;
* K-P2 (``gradmap_fused``, the check form) and the K-P1 formulations of
  csrc/matvec_probe.cu (K = 5; not ``gradmap_fused``, whose own kernel
  sums in another order than the form it replaced) at 1000×2048, 37×100
  and 300×516;
* with ``--gradmap``, for checkouts that all hold K-P1's own gradmap
  kernel (csrc/gradmap_probe.cu), ``gradmap_fused`` (K = 5) at those
  shapes and at 2000×1500, 500×4096, 300×8192, 16×16 and 4621×2048.

Every output tensor of a case is hashed.  Prints the card's name and
power limit, one JSON line per checkout (the number of cases and the
cases whose hash differs from the first checkout's) and exits 1 when
any case differs.  Fails without a CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

SHAPES = ((1000, 500), (3000, 1000), (301, 699), (500, 3000), (300, 7000),
          (600, 1500), (1000, 2000), (128, 16), (100, 9000))
PAIRS = (("lstsq", "l1"), ("logistic", "l1"), ("squared_hinge", "box"),
         ("lstsq", "nonneg"), ("lstsq", "ridge"))
STREAMED = ((3000, 1000), (2000, 1500), (500, 3000))
TAIL_SHAPES = ((1000, 2000), (200, 300), (16, 16), (600, 1500))
P4_SHAPES = ((1000, 2000), (37, 1003), (64, 8), (4753, 2000))
P1_SHAPES = ((1000, 2048), (37, 100), (300, 516))
GRADMAP_SHAPES = P1_SHAPES[:1] + ((2000, 1500), (500, 4096), (300, 8192),
                                  (16, 16), (4621, 2048))


def _digest(outputs) -> str:
    import torch
    h = hashlib.sha256()
    for t in outputs:
        if t is None:
            continue
        t = torch.as_tensor(t).detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.float()
        h.update(t.numpy().tobytes())
    return h.hexdigest()[:16]


def _child(root: str, gradmap: bool) -> None:
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("dense_bits needs a CUDA device")
    from fasta_tpu_torch.kernels import (bf16_probe, matvec_probe,
                                         microsolver, tail_probe)
    dev = torch.device("cuda")
    out = {}

    def data(m, n, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        A = torch.randn((m, n), generator=g, device=dev) / m ** 0.5
        k = max(1, n // 10)
        xt = torch.zeros(n, device=dev)
        xt[:k] = torch.randn(k, generator=g, device=dev)
        return A, A @ xt, torch.zeros(n, device=dev)

    for m, n in SHAPES:
        A, d, x0 = data(m, n, m + n)
        for loss, prox in PAIRS:
            b = {"lstsq": d, "logistic": (d > 0).float(),
                 "squared_hinge": torch.where(d > 0, 1.0, -1.0)}[loss]
            for acc in (False, True):
                for hp in (False, True):
                    out[f"{m}x{n} {loss} {prox} acc={acc} hp={hp}"] = \
                        _digest(microsolver.microsolve_lasso(
                            A, b, x0, 0.05, 0.1, loss=loss, prox=prox,
                            accelerate=acc, hp=hp, restart_dd=hp,
                            max_iters=60, tol=0.0, stop_rule="iterations",
                            record_bts=True, record_fvals=True,
                            record_objs=True, record_nres=True,
                            record_its=(m, n) == (600, 1500)))
    for m, n in STREAMED:
        A, d, x0 = data(m, n, 7)
        n4 = (n + 3) // 4 * 4
        nb = microsolver._grid(dev.index, n4)[0]
        for acc in (False, True):
            o = microsolver._options(dict(
                max_iters=60, tol=0.0, stop_rule="iterations",
                accelerate=acc, record_bts=True))
            for budget in (0, 12 * n4):
                plan = microsolver.dense_plan(m, n4, nb, budget)
                out[f"streamed {m}x{n} acc={acc} budget={budget}"] = _digest(
                    microsolver._launch(A, d, x0, 0.05, 0.1, 1, False, False,
                                        o, plan))
    A, d, x0 = data(1000, 2000, 3)
    mus = torch.tensor([0.4, 0.2, 0.1], device=dev)
    bs = torch.stack([d * (1 + 0.02 * i) for i in range(4)])
    tau0s = torch.tensor([0.05, 0.075, 0.1, 0.05], device=dev)
    for acc in (False, True):
        out[f"K-B1p acc={acc}"] = _digest(microsolver.microsolve_lasso_path(
            A, d, x0, 0.05, mus, warm=True, accelerate=acc, max_iters=80,
            tol=1e-5))
        out[f"K-B1b acc={acc}"] = _digest(microsolver.microsolve_lasso_batch(
            A, bs, torch.zeros(4, 2000, device=dev), tau0s, 0.1,
            accelerate=acc, max_iters=80, tol=1e-6))
    for m, n in TAIL_SHAPES:
        A, b, _ = data(m, n, 11)
        x0 = torch.randn(n, generator=torch.Generator(device=dev)
                         .manual_seed(5), device=dev)
        runs = {f"L{lv}": tail_probe.make(lv) for lv in range(7)}
        runs.update({v: tail_probe.make(6, **{v: True})
                     for v in tail_probe.VARIANTS})
        for name, run in runs.items():
            out[f"K-P3 {name} {m}x{n}"] = _digest(run(A, b, x0, 20))
    for m, n in P4_SHAPES:
        A, _, _ = data(m, n, 13)
        x0 = torch.randn(n, generator=torch.Generator(device=dev)
                         .manual_seed(6), device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            out[f"K-P4 {m}x{n} {dtype}"] = _digest(bf16_probe.bf16_probe(
                A.to(dtype).contiguous(), x0, 5))
    for m, n in P1_SHAPES:
        g = torch.Generator(device=dev).manual_seed(m + n)
        A, x, b = (torch.randn((m, n), generator=g, device=dev) / 40,
                   torch.randn(n, generator=g, device=dev),
                   torch.randn(m, generator=g, device=dev))
        out[f"K-P2 {m}x{n}"] = _digest(matvec_probe.gradmap_fused(A, x, b))
        for v in matvec_probe.VARIANTS:
            if v != "gradmap_fused":
                out[f"K-P1 {v} {m}x{n}"] = _digest(
                    matvec_probe.run_variant(A, x, b, v, 5))
    for m, n in GRADMAP_SHAPES if gradmap else ():
        g = torch.Generator(device=dev).manual_seed(m + n)
        A, x, b = (torch.randn((m, n), generator=g, device=dev) / 40,
                   torch.randn(n, generator=g, device=dev),
                   torch.randn(m, generator=g, device=dev))
        x, (f, g) = matvec_probe.run_variant(A, x, b, "gradmap_fused", 5)
        out[f"K-P1 gradmap_fused {m}x{n}"] = _digest((x, f, g))
    torch.cuda.synchronize()
    print(json.dumps(out), flush=True)


def main(roots, gradmap: bool) -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    first, rc = None, 0
    for root in roots:
        root = os.path.abspath(root)
        env = dict(os.environ, PYTHONPATH=root)
        got = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", root, *["--gradmap"] * gradmap],
                             cwd=root, env=env,
                             check=True, stdout=subprocess.PIPE, text=True)
        hashes = json.loads(got.stdout.strip().splitlines()[-1])
        first = first or hashes
        differ = sorted(k for k in set(first) | set(hashes)
                        if first.get(k) != hashes.get(k))
        rc = rc or int(bool(differ))
        print(json.dumps(dict(root=root, cases=len(hashes), differ=differ)),
              flush=True)
    return rc


if __name__ == "__main__":
    args = sys.argv[1:]
    with_gradmap = "--gradmap" in args
    args = [a for a in args if a != "--gradmap"]
    if args[:1] == ["--child"] and len(args) == 2:
        _child(args[1], with_gradmap)
    elif args and not args[0].startswith("-"):
        sys.exit(main(args, with_gradmap))
    else:
        raise SystemExit(__doc__)
