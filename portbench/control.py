"""Readings for the limits of ``correct``: the numbers compared, for the
program over many seeds and for the control over a few, at the cell's
own sizes and load, in one process on the card.

    python3 -m portbench.control --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --requests 16 --kept-per-request 32

from the root of the checkout.
Each seed runs the cell's set-up and ``--requests`` requests (the
control ``--control-requests``), keeps ``--kept-per-request`` answers of
each, and judges them as a run does.  The control is the configuration's
``control``: ``"tf32"`` runs the program with TF32 products (its own path
in the next precision below float32 with TF32 off); a dtype name puts the
plain reference, computed in that dtype, in the program's place.  Prints
a JSON line a seed and side, then each number's largest program reading
and smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from portbench import harness


def readings(cell: harness.Cell, seed: int, device, ftt, requests: int,
             kept_per_request: int, control: bool = False) -> dict:
    """The numbers a run of ``requests`` requests compares (its checks'
    values), for the program or, with ``control``, the control."""
    cell = cell._replace(traffic=dict(
        cell.traffic, kept_requests=requests,
        kept_per_request=kept_per_request))
    how = cell.cfg["control"]
    session = harness.Session(cell, seed, device, ftt, log=lambda s: None)
    session.setup()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = control and how == "tf32"
    try:
        session.window(count=requests)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    low = getattr(torch, how) if control and how != "tf32" else None
    checks, info = session.judge(control=low)
    return dict({k: c["value"] for k, c in checks.items()}, **info)


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--requests", type=int, required=True)
    p.add_argument("--control-requests", type=int)
    p.add_argument("--kept-per-request", type=int, required=True)
    args = p.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    cell = harness.load_cell(root, args.workload)
    if not torch.cuda.is_available():
        print("portbench.control needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import fasta_tpu_torch as ftt
    dev = torch.device("cuda", 0)
    sides = {"program": [], "control": []}
    for side, seeds, n in (
            ("program", args.seeds, args.requests),
            ("control", args.control_seeds,
             args.control_requests or args.requests)):
        for seed in (int(s) for s in seeds.split(",")):
            r = readings(cell, seed, dev, ftt, n, args.kept_per_request,
                         control=side == "control")
            sides[side].append(r)
            print(json.dumps(dict(side=side, seed=seed, **r)), flush=True)
    names = [k for k in cell.cfg["limits"]] + ["unconverged"]
    print(json.dumps({k: {"lower": max(r[k] for r in sides["program"]),
                          "upper": min(r[k] for r in sides["control"]),
                          "limit": cell.cfg["limits"].get(k, 0)}
                      for k in names}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
