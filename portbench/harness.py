"""One run of one cell of ``BENCHMARK.json``: set-up, the measured window,
the traced segment, the check of the answers, and the result's line.

A cell names a configuration (``portbench/configs/<name>.json``, whose
``kind`` names a module of ``portbench/kinds/``) and a traffic mix
(``portbench/traffic/<name>.json``); each per-layer metric is read by
``portbench/metrics/<name>.py``.  The harness finds all of them by name.

The traffic is a closed loop of one client: each request is one
``Problem.solve_serving(bs)`` call over the next batch of a pool made on
the card from the seed, and ends when the call has returned and the card
has finished (``torch.cuda.synchronize``).  The window opens after the
set-up and closes at the first completion at or after ``--seconds``.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import roofline, stats, tracing

# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "fasta_tpu")

HERE = Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    chips: int
    cfg: dict
    traffic: dict
    end_to_end: list     # BENCHMARK.json's entries this cell reports
    per_layer: list


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, its configuration
    and traffic files read, and the metrics it reports: the end-to-end
    ones that list it or list no cells, the per-layer ones that list it."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in "
                         f"BENCHMARK.json; it has {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{w['traffic']}.json").read_text())

    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    per = [m for m in spec["per_layer"] if workload in m["workloads"]]
    return Cell(workload, w["chips"], cfg, traffic, e2e, per)


def kind(cfg: dict):
    return importlib.import_module(f"portbench.kinds.{cfg['kind']}")


def reader(name: str):
    """The per-layer metric reader ``portbench/metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def serving_kwargs(options: dict, route: str, ftt) -> dict:
    """The configuration's solve options as the keyword arguments of
    ``route`` (τ₀ goes in the ``Problem``)."""
    if options["mode"] != "adaptive":
        raise ValueError(f"portbench runs the adaptive mode only, got "
                         f"{options['mode']!r}")
    if route == "batch_solver":
        return dict(options=ftt.FastaOptions(
            max_iters=options["max_iters"], tol=options["tol"],
            stop_rule=options["stop_rule"], adaptive=True,
            precision="high" if options["hp"] else "standard"))
    return dict(max_iters=options["max_iters"], tol=options["tol"],
                stop_rule=options["stop_rule"], hp=options["hp"])


def answers(out, ftt):
    """(route, solutions (B, ...) on the device, iteration counts,
    backtracks, converged) of a batch route's result; the counts and the
    flags on the host, as the routes return them."""
    if isinstance(out, ftt.MicroBatchResult):
        return ("microsolve_batch", out.solutions,
                np.asarray(out.iteration_counts),
                np.asarray(out.total_backtracks), np.asarray(out.converged))
    if (isinstance(out, ftt.DeviceResult)
            and np.ndim(out.iteration_count) == 1):
        return ("batch_solver", out.solution,
                np.asarray(out.iteration_count),
                np.asarray(out.total_backtracks),
                np.asarray(out.converged) & ~np.asarray(out.nonfinite))
    raise TypeError(f"the serving path returned a {type(out).__name__}, "
                    f"not the result of a batch route")


class Tally:
    """What a run of requests did: their times, and over their instances
    the line-search trials and failures; the loop's
    own iterations (the slowest lane's count a request) on the
    ``batch_solver`` route; requests that took another route than the traffic's."""

    def __init__(self):
        self.requests = []
        self.per_request = []      # (instances, trials, accepted)
        self.instances = self.trials = 0
        self.failed = self.loop_iterations = self.wrong_route = 0

    def add(self, issued, completed, route, expected, iters, bts, ok):
        n = len(iters)
        self.requests.append(stats.Request(issued, completed, n))
        trials = int(iters.sum() + bts.sum())
        self.per_request.append((n, trials, int(iters.sum())))
        self.instances += n
        self.trials += trials
        self.failed += int((~ok).sum())
        self.wrong_route += route != expected
        if route == "batch_solver":
            self.loop_iterations += int(iters.max())


class Keeper:
    """A sample, drawn from the seed, of the answers of the window: a
    reservoir of ``slots`` requests, ``per_request`` instances of each,
    copied on the card into one buffer as the requests complete."""

    def __init__(self, slots: int, per_request: int, rng: random.Random):
        self.slots, self.per, self.rng = slots, per_request, rng
        self.buf, self.meta, self.seen = None, {}, 0

    def offer(self, batch: int, sol, iters) -> None:
        i, self.seen = self.seen, self.seen + 1
        slot = i if i < self.slots else self.rng.randrange(i + 1)
        if slot >= self.slots:
            return
        if self.buf is None:
            self.buf = torch.empty((self.slots * self.per,)
                                   + tuple(sol.shape[1:]), dtype=sol.dtype,
                                   device=sol.device)
        for j, lane in enumerate(self.rng.sample(range(sol.shape[0]),
                                                 self.per)):
            k = slot * self.per + j
            self.buf[k].copy_(sol[lane])
            self.meta[k] = (batch, lane, int(iters[lane]))

    def kept(self):
        """(slots as (batch, instance) pairs, the kept answers)."""
        ks = sorted(self.meta)
        return ([self.meta[k][:2] for k in ks],
                dict(solutions=self.buf[ks],
                     iterations=np.array([self.meta[k][2] for k in ks])))


class Readings(NamedTuple):
    """What a per-layer metric reader reads (``portbench/metrics``)."""
    cfg: dict
    traffic: dict
    rates: Optional[dict]          # the card's peaks, None if unknown
    window: Tally
    traced: Optional[Tally]
    trace: Optional[tracing.Trace]
    counters: dict                 # the program's launch counters, traced
    notes: list

    def note(self, text: str) -> None:
        self.notes.append(text)


def launch_counters() -> dict:
    """Every launch counter of the program's kernel modules, by
    ``<module>.<NAME>``."""
    out = {}
    for name, mod in list(sys.modules.items()):
        if name.startswith("fasta_tpu_torch.kernels.") and mod is not None:
            for attr, v in vars(mod).items():
                if attr.endswith("LAUNCHES") and isinstance(v, int):
                    out[f"{name.rsplit('.', 1)[1]}.{attr}"] = v
    return out


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Session:
    """A cell's run after the program is imported: ``setup`` makes the
    inputs and warms up, ``window`` measures, ``traced`` traces a segment,
    ``judge`` checks the kept answers, ``result`` builds the line."""

    def __init__(self, cell: Cell, seed: int, device, ftt, log=None):
        tr = cell.traffic
        if tr["loop"] != "closed" or tr["clients"] != 1:
            raise ValueError(f"portbench drives a closed loop of one client; "
                             f"traffic {tr['name']!r} asks for {tr['loop']} "
                             f"with {tr['clients']} clients")
        self.cell, self.seed, self.ftt = cell, seed, ftt
        self.device = torch.device(device)
        self.kind = kind(cell.cfg)
        self.log = log or (lambda s: print(s, file=sys.stderr, flush=True))
        self.rng = random.Random(seed)
        self.notes = []
        self.traced_tally = self.trace = None
        self.counters = {}

    def setup(self) -> dict:
        """Inputs on the device from the seed, the problem, the route and
        one warm-up request; the seconds of each piece."""
        cfg, tr = self.cell.cfg, self.cell.traffic
        t0 = time.perf_counter()
        gen = torch.Generator(device=self.device).manual_seed(
            self.seed % 2 ** 64)
        self.inputs = self.kind.make_inputs(cfg, tr, gen, self.device)
        self.pool = self.inputs["pool"]
        self.problem = self.kind.problem(cfg, self.inputs, self.ftt)
        plan = self.ftt.recommend_path(self.problem, tr["batch"])
        self.kwargs = serving_kwargs(cfg["options"], plan.path, self.ftt)
        sync(self.device)
        t1 = time.perf_counter()
        self.log(f"route: {plan.path} ({plan.reason}); the traffic's: "
                 f"{tr['route']}")
        self.request(self.pool[0])
        sync(self.device)
        return dict(inputs_s=t1 - t0, warmup_s=time.perf_counter() - t1)

    def request(self, bs):
        return self.problem.solve_serving(bs, **self.kwargs)

    def _run(self, tally: Tally, start_index: int, until=None, count=None,
             keeper: Optional[Keeper] = None, annotate=False) -> int:
        """Requests in turn from the pool, from ``start_index``, until the
        first completion at or after ``until`` (perf_counter) or for
        ``count`` requests; returns the next index."""
        i, P = start_index, self.pool.shape[0]
        expected = self.cell.traffic["route"]
        while True:
            bs = self.pool[i % P]
            span = (torch.profiler.record_function(tracing.REQUEST)
                    if annotate else contextlib.nullcontext())
            issued = time.perf_counter()
            with span:
                out = self.request(bs)
                sync(self.device)
            completed = time.perf_counter()
            route, sol, iters, bts, ok = answers(out, self.ftt)
            tally.add(issued, completed, route, expected, iters, bts, ok)
            if keeper is not None:
                keeper.offer(i % P, sol, iters)
            del out, sol
            i += 1
            if (until is not None and completed >= until) or (
                    count is not None and i - start_index >= count):
                return i

    def window(self, seconds: Optional[float] = None,
               count: Optional[int] = None) -> None:
        """The measured requests, from the pool's second batch: until the
        first completion at or after ``seconds``, or ``count`` of them;
        the sample of their answers kept as they complete."""
        tr = self.cell.traffic
        self.keeper = Keeper(tr["kept_requests"], tr["kept_per_request"],
                             self.rng)
        self.tally = Tally()
        self.start = time.perf_counter()
        self.next = self._run(
            self.tally, 1, count=count, keeper=self.keeper,
            until=None if seconds is None else self.start + seconds)

    def traced(self) -> None:
        """``traffic["traced_requests"]`` more requests under
        ``torch.profiler``, after the window."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        before = launch_counters()
        self.traced_tally = Tally()
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        with torch.profiler.record_function(tracing.TRACED):
            self._run(self.traced_tally, self.next,
                      count=self.cell.traffic["traced_requests"],
                      annotate=True)
        prof.stop()
        after = launch_counters()
        self.counters = {k: after[k] - before.get(k, 0) for k in after}
        self.prof = prof

    def read_trace(self) -> None:
        if self.traced_tally is not None:
            self.trace = tracing.read(self.prof)
            del self.prof

    def memory_peak(self) -> int:
        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0

    def judge(self, control: Optional[torch.dtype] = None) -> tuple:
        """The numbers compared and the others, after the program's state
        is freed: the reference solves the kept instances again in
        float64.  ``control`` puts the reference, in that dtype, in the
        program's place for the kept instances."""
        slots, kept = self.keeper.kept()
        data = self.kind.reference_inputs(self.inputs, slots)
        del self.problem, self.inputs, self.pool
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        failed = self.tally.failed
        if control is not None:
            low = self.kind.reference_solve(self.cell.cfg, data, control)
            kept = dict(solutions=low.solution,
                        iterations=low.iterations.cpu().numpy())
            failed = int((~low.converged).sum())
        numbers = self.kind.judge(self.cell.cfg, data, kept)
        limits = self.cell.cfg["limits"]
        checks = {k: {"value": numbers[k], "limit": limits[k]}
                  for k in limits}
        checks["unconverged"] = {"value": failed, "limit": 0}
        checks["wrong_route"] = {"value": self.tally.wrong_route,
                                 "limit": 0}
        checks["kept"] = {"value": len(slots), "limit": 1}
        info = {k: v for k, v in numbers.items() if k not in limits}
        return checks, info

    def readings(self) -> Readings:
        return Readings(
            self.cell.cfg, self.cell.traffic,
            roofline.peaks(device_name(self.device)), self.tally,
            self.traced_tally, self.trace, self.counters, self.notes)


def passed(checks: dict) -> bool:
    """Every number within its limit (``kept`` at least its limit), NaN
    failing."""
    return all((c["value"] >= c["limit"]) if name == "kept"
               else (c["value"] <= c["limit"])
               for name, c in checks.items())


def device_name(device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def end_to_end(session: Session, setup_s: float) -> dict:
    t = session.tally
    return {"solves_per_s": stats.solves_per_s(t.requests, session.start),
            "request_ms_p95": stats.percentile(stats.request_ms(t.requests),
                                               95),
            "setup_s": setup_s}


def result(session: Session, setup_s: float, trace: bool, checks: dict,
           memory_peak: int) -> dict:
    """The result's line: the cell's end-to-end metrics (``trace`` off)
    or its per-layer metrics (on), the device, the checks last."""
    cell = session.cell
    metrics = {}
    if trace:
        r = session.readings()
        for m in cell.per_layer:
            v = reader(m["name"]).read(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = end_to_end(session, setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = session.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": device_name(dev), "count": cell.chips,
              "memory_peak_bytes": memory_peak}
    out = {"correct": passed(checks),
           "attempted": session.tally.instances,
           "failed": session.tally.failed, "metrics": metrics,
           "device": device}
    if trace and session.trace is not None:
        device["busy_s"] = session.trace.busy_s
        device["window_s"] = session.trace.window_s
        out["breakdown"] = {"device_ops": session.trace.device_ops(),
                            "idle_gaps": session.trace.idle_gaps()}
    out["checks"] = checks
    return out


def card_state() -> str:
    """The card's name, power limit, clock and temperature, by
    ``nvidia-smi`` (after the window)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN_MODULES))


def process_age_s() -> Optional[float]:
    """Seconds since this process started, from /proc (None elsewhere)."""
    try:
        start = int(Path("/proc/self/stat").read_text()
                    .rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, root: Path) -> int:
    """A run on the card; exits non-zero and prints no result without
    the cards the cell asks for, when the program is not this
    checkout's, or when JAX or the JAX package was loaded."""
    args = parse(argv)
    cell = load_cell(root, args.workload)
    log = (lambda s: print(s, file=sys.stderr, flush=True))
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        log(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
            f"found {found}")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    before = process_age_s()
    # The CUDA context comes before set-up, as torch's import does: a
    # caller of a PyTorch CUDA library has both.  Its creation takes
    # 0.2 s or 0.7-1.4 s from run to run (PERF.md, the set-up study).
    t_ctx = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    torch.empty(1, device=dev)
    torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    import fasta_tpu_torch as ftt
    from fasta_tpu_torch.kernels import _build
    t_import = time.perf_counter()
    where = Path(ftt.__file__).resolve().parent.parent
    if where != root.resolve():
        log(f"portbench: fasta_tpu_torch was imported from {where}, not "
            f"from this checkout {root}")
        return 2
    _build.library()
    t_lib = time.perf_counter()
    session = Session(cell, args.seed, dev, ftt, log)
    pieces = session.setup()
    setup_s = time.perf_counter() - t0
    log("setup pieces: " + json.dumps(dict(
        process_s=before, context_s=t0 - t_ctx, import_s=t_import - t0,
        library_s=t_lib - t_import, **pieces, setup_s=setup_s)))

    session.window(args.seconds)
    if args.trace:
        session.traced()
    peak = session.memory_peak()
    bad = forbidden_modules()
    if bad:
        log(f"portbench: the run loaded {bad}; the benchmark measures "
            f"fasta_tpu_torch without JAX")
        return 3
    log(f"card: {card_state()}")
    session.read_trace()
    t = session.tally
    log(f"window: {len(t.requests)} requests, {t.instances} instances, "
        f"{t.requests[-1].completed - session.start:.6f} s; loop "
        f"iterations {t.loop_iterations}")
    checks, info = session.judge()
    line = result(session, setup_s, bool(args.trace), checks, peak)
    for text in session.notes:
        log(text)
    log(f"reference: {json.dumps(info)}")
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0
