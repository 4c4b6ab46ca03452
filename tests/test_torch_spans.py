"""The program's spans (``profiling.span``) on the CPU: with no profiler
running no ``record_function`` is made; under ``torch.profiler`` each route
of ``Problem.solve_serving`` opens its spans nested as the README names
them, the loop's counted once an iteration; and the answers are the same
bits with the profiler on and off."""

import collections

import pytest
import torch

import fasta_tpu_torch as ftt
from fasta_tpu_torch import problems, profiling

torch.set_num_threads(1)

OPTS = ftt.FastaOptions(max_iters=200, tol=1e-6, precision="standard")


def _lasso():
    p = problems.build("lasso", m=60, n=120, k=6, device="cpu")
    p.tau0 = 0.05
    return p


def _request(route):
    """(problem, bs, keyword arguments) of a small request that
    ``recommend_path`` sends to ``route``."""
    if route == "microsolve_batch":
        # 2 × 128 × 128 dual unknowns: at the crossover, the kernel route
        p = problems.build("tv", h=128, w=128, device="cpu")
        b = p.fterm.b
        return p, torch.stack([b, b * 1.01]), dict(max_iters=8, tol=1e-3)
    p = _lasso()
    b = p.fterm.b
    if route == "batch_solver":
        return p, torch.stack([b, b * 1.01, b * 0.9]), dict(options=OPTS)
    if route == "loop":
        return p, None, dict(need_full_diagnostics=True, options=OPTS)
    return p, None, dict(max_iters=200, tol=1e-6)


def _serve(route):
    p, bs, kw = _request(route)
    return p.solve_serving(bs, **kw)


def _profiled(fn):
    """``fn()``'s result and the ``fasta.*`` spans of its trace as
    (name, start, end), in order of start."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name(), e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("fasta.")),
                   key=lambda s: (s[1], -s[2]))
    return out, spans


def _parents(spans):
    """Each span's name with its innermost enclosing span's (None at the
    top)."""
    out, stack = [], []
    for name, s, e in spans:
        while stack and stack[-1][2] <= s:
            stack.pop()
        assert not stack or e <= stack[-1][2], "spans overlap"
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, s, e))
    return out


def _solution(out):
    return out.solutions if hasattr(out, "solutions") else torch.as_tensor(
        out.solution)


ROUTES = ("batch_solver", "microsolve_batch", "microsolve", "loop")


def test_span_without_a_profiler_is_one_shared_null_context():
    assert profiling.span("fasta.a") is profiling.span("fasta.b")
    with profiling.span("fasta.a") as inside:
        assert inside is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(profiling.span("fasta.a"),
                          torch.profiler.record_function)


@pytest.mark.parametrize("route", ["batch_solver", "microsolve_batch"])
def test_no_profiler_makes_no_record_function(route, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function with no profiler running")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _serve(route)


@pytest.mark.parametrize("route", ROUTES)
def test_each_route_nests_its_spans_under_serve(route):
    p, bs, kw = _request(route)
    plan = ftt.recommend_path(p, 1 if bs is None else len(bs),
                              need_full_diagnostics=route == "loop")
    assert plan.path == route
    _, spans = _profiled(lambda: _serve(route))
    parents = _parents(spans)
    assert parents[:2] == [("fasta.serve", None),
                           (f"fasta.route.{route}", "fasta.serve")]
    assert collections.Counter(n for n, _ in parents)["fasta.serve"] == 1
    want = {"fasta.loop.setup": f"fasta.route.{route}",
            "fasta.loop.iteration": f"fasta.route.{route}",
            "fasta.loop.result": f"fasta.route.{route}",
            "fasta.loop.read.backtrack": "fasta.loop.iteration",
            "fasta.loop.read.stop": "fasta.loop.iteration",
            "fasta.micro.start": f"fasta.route.{route}",
            "fasta.micro.launch": f"fasta.route.{route}",
            "fasta.micro.result": f"fasta.route.{route}"}
    for name, parent in parents[2:]:
        assert want[name] == parent, (name, parent)
    names = {n for n, _ in parents}
    if route in ("batch_solver", "loop"):
        assert {"fasta.loop.setup", "fasta.loop.iteration",
                "fasta.loop.read.stop", "fasta.loop.result"} <= names
    else:
        assert {"fasta.micro.start", "fasta.micro.launch",
                "fasta.micro.result"} <= names
        assert not any(n.startswith("fasta.loop.") for n in names)


def test_loop_spans_count_the_iterations_and_reads():
    out, spans = _profiled(lambda: _serve("batch_solver"))
    count = collections.Counter(n for n, _, _ in spans)
    iters = int(max(out.iteration_count))
    assert min(out.iteration_count) < iters     # the lanes stop apart
    assert count["fasta.loop.iteration"] == iters
    assert count["fasta.loop.read.stop"] == iters
    assert count["fasta.loop.read.backtrack"] >= iters
    assert count["fasta.loop.setup"] == count["fasta.loop.result"] == 1
    assert count["fasta.loop.read.resume"] == 0


def test_a_resume_reads_its_state_once():
    p = _lasso()
    args = (p.op, p.fterm, p.gterm, p.x0, p.tau0)
    opts = ftt.FastaOptions(max_iters=5, tol=1e-12)
    _, state = ftt.make_stateful_solver(opts)(*args)
    more = ftt.FastaOptions(max_iters=9, tol=1e-12)
    (out, _), spans = _profiled(
        lambda: ftt.resume_state(*args[:3], state, more))
    count = collections.Counter(n for n, _, _ in spans)
    assert out.iteration_count == 9
    assert count["fasta.loop.read.resume"] == 1
    assert count["fasta.loop.iteration"] == 4


@pytest.mark.parametrize("route", ROUTES)
def test_spans_leave_the_answers_bit_for_bit(route):
    off = _serve(route)
    on, _ = _profiled(lambda: _serve(route))
    assert type(on) is type(off)
    assert torch.equal(_solution(on), _solution(off))
    counts = ("iteration_counts" if route == "microsolve_batch"
              else "iteration_count")
    assert (torch.as_tensor(getattr(on, counts))
            == torch.as_tensor(getattr(off, counts))).all()
