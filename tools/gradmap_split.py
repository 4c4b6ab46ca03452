"""Split each call of K-B3 / K-B3p (the fused gradient maps) into its card
time, its kernels and its host time, at the main paths' shapes, in
several checkouts of the repository, one fresh process per checkout, in
the order given, on one CUDA card.

    python3 tools/gradmap_split.py ROOT [ROOT ...]
    python3 tools/gradmap_split.py --sweep

Each ROOT is the top of a checkout: its ``fasta_tpu_torch`` is imported
from there and its kernels are built into ROOT/build/.  To compare two
checkouts on one card, give them as A B B A.  The timing helpers are this
file's own checkout's ``fasta_tpu_torch/profiling.py``, so every checkout
is read alike.  Shapes (A randn/√m, x and b randn, seed 0; labels b > 0,
±1 for the hinge): K-B3 at 256×1024 (democratic's loop), 1000×2000
(LASSO's loop and exact resume), 1000×500 (NNLS); K-B3p logistic at
1000×500 and the squared hinge at 800×100 (the dense family's loops);
K-B3 and K-B3p logistic at 8192×16384 over float32 and bfloat16 A
(streamed from device memory).  Per shape:

* ``graph_us``: the card's time per call, ``calls`` calls captured in one
  CUDA graph, the replay timed by CUDA events (median of 5; 200 calls, 20
  at 8192×16384), the host's enqueueing taken out;
* ``kernels``: the trace's device operations per call by name, each with
  its mean µs a call (20 calls in a ``profiling.trace``), and ``ops``,
  the kernels, memsets and copies a call made;
* ``host_us``: the host clock around 200 calls with no wait for the card,
  the median of five such runs;
* ``plan``: the checkout's launch plan at the shape, where it has one.

``--phases`` (this tree alone) splits a call into its phases: it builds
copies of ``csrc/lstsq_fused.cu`` into build/gradmap_variants/, each cut
short at one point — ``empty`` returns at once (the launch), ``rows``
stops after the row loop and the block's share written to the scratch
(no barrier, no sum), ``full`` is the source as it is — and times each
at 256×1024, 800×100 and 1000×2000 (routes 1 and 2) and at 8192×16384
over float32 and bfloat16 A (route 3).

``--sweep`` (this tree alone) sets the rows routes' two constants from
the card: copies of the source with kBlocksPerSM (the grid's blocks an
SM at most) at 1, 2 and 4 and kRowsMax (the rows a group takes at once
at most) at 1, 2 and 4, each timed at 256×1024, 1000×500, 800×100,
1000×2000 and 4096×2048 (a wider route-2 shape), with the floor:
PyTorch's ``add_`` on one float in the same graph form.

Both print, per copy and shape, the card's plan, the card µs a call in a
CUDA graph of 200 (20 at 8192×16384), the kernel's µs a call in a trace
and the largest error against this tree's own build, relative to the
largest entry.  Prints the card's name and power limit first, then one
JSON line per checkout (per copy and shape).  Fails without a CUDA
device.
"""

from __future__ import annotations

import importlib.util
import itertools
import json
import os
import statistics
import subprocess
import sys

# (m, n, loss, dtype): the main paths' shapes, then the streamed ones
SHAPES = ((256, 1024, "lstsq", "float32"), (1000, 2000, "lstsq", "float32"),
          (1000, 500, "lstsq", "float32"), (1000, 500, "logistic", "float32"),
          (800, 100, "squared_hinge", "float32"),
          (8192, 16384, "lstsq", "float32"),
          (8192, 16384, "logistic", "float32"),
          (8192, 16384, "lstsq", "bfloat16"),
          (8192, 16384, "logistic", "bfloat16"))
SWEEP = ((256, 1024), (1000, 500), (800, 100), (1000, 2000), (4096, 2048))
_HERE = os.path.dirname(os.path.abspath(__file__))


def _profiling():
    """This checkout's profiling module, loaded by path (it imports only
    torch), whichever checkout's package is being timed."""
    path = os.path.join(_HERE, os.pardir, "fasta_tpu_torch", "profiling.py")
    spec = importlib.util.spec_from_file_location("_gradmap_split_prof", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _graph_us(fn, calls=200, runs=5):
    """Card time per call of ``fn``: ``calls`` calls in one CUDA graph
    captured on a warmed-up side stream, the replay timed by CUDA events
    (median of ``runs``)."""
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
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times) / calls * 1e3


def _kernels(prof, fn, logdir, calls=20) -> dict:
    """The device operations of ``calls`` calls in a trace: per kind a
    call, and per kernel name its count and mean µs a call."""
    fn()
    import torch
    torch.cuda.synchronize()
    with prof.trace(logdir) as d:
        for _ in range(calls):
            fn()
    with open(os.path.join(d, "trace.json")) as fh:
        events = [e for e in json.load(fh).get("traceEvents", [])
                  if e.get("cat") in prof.DEVICE_OP_KINDS]
    by_name = {}
    for e in events:
        key = f"{e['cat']}:{e.get('name', '?')[:60]}"
        n, us = by_name.get(key, (0, 0.0))
        by_name[key] = (n + 1, us + float(e.get("dur", 0.0)))
    return dict(ops={k: sum(e["cat"] == k for e in events) / calls
                     for k in prof.DEVICE_OP_KINDS},
                kernels={k: dict(per_call=n / calls, us_per_call=us / calls)
                         for k, (n, us) in sorted(by_name.items())})


def _data(dev, m, n, loss, dtype, seed=0):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    A = (torch.randn((m, n), generator=gen, device=dev) / m ** 0.5).to(
        getattr(torch, dtype))
    x = torch.randn(n, generator=gen, device=dev)
    b = torch.randn(m, generator=gen, device=dev)
    if loss == "logistic":
        b = (b > 0).float()
    elif loss == "squared_hinge":
        b = torch.where(b > 0, 1.0, -1.0)
    return A, x, b


def _call(lstsq_fused, A, x, b, loss):
    if loss == "lstsq":
        return lambda: lstsq_fused.fused_lstsq_gradmap(A, x, b)
    return lambda: lstsq_fused.fused_pointwise_gradmap(A, x, b, loss)


def _child(root: str) -> None:
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("gradmap_split needs a CUDA device")
    prof = _profiling()
    from fasta_tpu_torch.kernels import lstsq_fused
    dev = torch.device("cuda", 0)
    logdir = os.path.join(root, "build", "gradmap_split_trace")
    out = {"root": root}
    for m, n, loss, dtype in SHAPES:
        A, x, b = _data(dev, m, n, loss, dtype)
        fn = _call(lstsq_fused, A, x, b, loss)
        big = m * n > 1 << 24
        plan = lstsq_fused._plan(0, m, n, dtype == "bfloat16")
        out[f"{loss} {m}x{n} {dtype}"] = dict(
            graph_us=_graph_us(fn, 20 if big else 200),
            host_us=statistics.median(prof.host_us(fn, 200)
                                      for _ in range(5)),
            plan=list(plan), **_kernels(prof, fn, logdir))
        del A
    print(json.dumps(out), flush=True)


# (anchor, replacement) edits of a copy of csrc/lstsq_fused.cu
_TOP = "  const int tid = threadIdx.x, lane = tid % GROUP, grp = tid / GROUP, warp = tid >> 5;\n"
_TOP3 = "  cg::cluster_group cluster = cg::this_cluster();\n"
_END = "  grid_end<T>(work, gridDim.x, n, loss, f, g);\n"
_END3 = "  grid_end<kThreads>(work, ncl, n, loss, f, g);\n"
PHASES = {"empty": [(_TOP, "  if (m > 0) return;\n" + _TOP),
                    (_TOP3, "  if (m > 0) return;\n" + _TOP3)],
          "rows": [(_END, ""), (_END3, "")], "full": []}
PHASE_SHAPES = ((256, 1024, "float32"), (800, 100, "float32"),
                (1000, 2000, "float32"), (8192, 16384, "float32"),
                (8192, 16384, "bfloat16"))
SWEEP_SHAPES = tuple((m, n, "float32") for m, n in SWEEP)


def _sweep_edits(per_sm: int, rows: int) -> list:
    return [("constexpr int kBlocksPerSM = 1;",
             f"constexpr int kBlocksPerSM = {per_sm};"),
            ("constexpr int kRowsMax = 4;", f"constexpr int kRowsMax = {rows};")]


SWEEP_COPIES = {f"{per_sm} an SM, {rows} rows": _sweep_edits(per_sm, rows)
                for per_sm, rows in itertools.product((1, 2, 4), (1, 2, 4))}


def _variant_libs(root: str, variants: dict) -> dict:
    """Build each copy of lstsq_fused.cu (``variants``: name -> edits) into
    its own library, all at once, nvcc's log (ptxas's registers and spills
    a kernel) beside it; returns name -> path."""
    from fasta_tpu_torch.kernels import _build
    src = os.path.join(root, "fasta_tpu_torch", "csrc")
    out = os.path.join(root, "build", "gradmap_variants")
    os.makedirs(out, exist_ok=True)
    text = open(os.path.join(src, "lstsq_fused.cu")).read()
    procs, libs = [], {}
    for k, (name, edits) in enumerate(variants.items()):
        t = text
        for old, new in edits:
            assert old in t, (name, old)
            t = t.replace(old, new)
        cu = os.path.join(out, f"v{k}.cu")
        open(cu, "w").write(t)
        libs[name] = os.path.join(out, f"libv{k}.so")
        procs.append(subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", src, "-shared", "-o",
             libs[name], cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for name, proc in zip(variants, procs):
        log = proc.communicate()[0]
        with open(libs[name][:-3] + ".log", "w") as fh:
            fh.write(log)
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
    return libs


def _variants(variants: dict, shapes, floor: bool = False) -> None:
    """Time each copy of the source at each shape, on the copy's own plan
    as its card entry point gives it."""
    import ctypes
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("gradmap_split needs a CUDA device")
    root = os.path.join(_HERE, os.pardir)
    prof = _profiling()
    from fasta_tpu_torch.kernels import _build, lstsq_fused
    dev = torch.device("cuda", 0)
    logdir = os.path.join(root, "build", "gradmap_split_trace")
    libs = _variant_libs(root, variants)
    if floor:
        one = torch.zeros(1, device=dev)
        print(json.dumps({"floor": "add_ on one float", "us": _graph_us(
            lambda: one.add_(1.0))}), flush=True)
    data = {shape: _data(dev, *shape[:2], "lstsq", shape[2])
            for shape in shapes}
    want = {shape: lstsq_fused.fused_lstsq_gradmap(*data[shape])
            for shape in shapes}
    torch.cuda.synchronize()

    def card_plan(device_index, m, n, bf16=False):
        route, cpt, threads, blocks, cluster, smem, tm, _ = \
            lstsq_fused._card_plan(device_index, m, n, bf16)
        wide = 8 if bf16 else 4
        return lstsq_fused._with_scratch(
            route, wide if n % wide == 0 else 1, cpt, threads, blocks,
            cluster, smem, tm, blocks // cluster, n)

    lstsq_fused._plan = card_plan
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        for fn_name in ("fasta_gradmap_plan", "fasta_gradmap"):
            getattr(lib, fn_name).argtypes = _build._SIGNATURES[fn_name]
            getattr(lib, fn_name).restype = ctypes.c_int
        lib.fasta_error_string.argtypes = [ctypes.c_int]
        lib.fasta_error_string.restype = ctypes.c_char_p
        _build.library = lambda lib=lib: lib
        lstsq_fused._card_plan.cache_clear()
        for shape in shapes:
            A, x, b = data[shape]
            plan = card_plan(0, *shape[:2], shape[2] == "bfloat16")
            fn = lambda A=A, x=x, b=b: lstsq_fused._launch(  # noqa: E731
                A, x, b, 0, "variant")
            got = fn()
            torch.cuda.synchronize()
            err = max(float((u - v).abs().max() / max(1.0, float(
                v.abs().max()))) for u, v in zip(got, want[shape]))
            k = _kernels(prof, fn, logdir)["kernels"]
            big = shape[0] * shape[1] > 1 << 24
            print(json.dumps({
                "copy": name, "shape": f"{shape[0]}x{shape[1]} {shape[2]}",
                "plan": list(plan), "graph_us": _graph_us(fn, 20 if big
                                                          else 200),
                "trace_us": sum(v["us_per_call"] for v in k.values()),
                "rel_err_vs_tree": err}), flush=True)


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
    elif sys.argv[1:] == ["--sweep"]:
        sys.path.insert(0, os.path.join(_HERE, os.pardir))
        _variants(SWEEP_COPIES, SWEEP_SHAPES, floor=True)
    elif sys.argv[1:] == ["--phases"]:
        sys.path.insert(0, os.path.join(_HERE, os.pardir))
        _variants(PHASES, PHASE_SHAPES)
    elif len(sys.argv) > 1:
        main(sys.argv[1:])
    else:
        raise SystemExit(__doc__)
