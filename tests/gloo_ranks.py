"""Gloo ranks on the CPU for the port's sharding tests (a helper module, not
a test file).

``Ranks(world, shapes)`` spawns ``world`` processes (the ``spawn`` start
method), which rendezvous through a ``FileStore`` in a temporary
directory (no TCP port, so concurrent test processes cannot collide),
form one gloo group and, over it, one ``DeviceMesh`` on the CPU for each
mesh shape of ``shapes`` (the 1-D ``(world,)`` always; ``(2, 4)`` a 2-D
rows × cols mesh), and then run cases by name until closed:
``ranks.run("solve", ..., shape=(2, 4))`` runs the case on the mesh of
that shape (the 1-D one by default) and returns each rank's result, in
rank order, as NumPy.  A rank that raises, dies or overruns the timeout
fails the call.  The ranks import torch and the port, never JAX: the cases
below are the ranks' side, and the test files hold them against the JAX
package in the pytest process.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np


class Ranks:
    """``world`` gloo ranks on the CPU, alive until :meth:`close`."""

    def __init__(self, world: int = 4, shapes=(), timeout: float = 240.0):
        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        shapes = ((world,),) + tuple(tuple(sh) for sh in shapes)
        self._dir = tempfile.mkdtemp(prefix="gloo_ranks_")
        store = os.path.join(self._dir, "store")
        self._inboxes = [ctx.Queue() for _ in range(world)]
        self._outbox = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, world, store, shapes,
                                         self._inboxes[r], self._outbox),
                                   daemon=True)
                       for r in range(world)]
        for p in self._procs:
            p.start()

    def run(self, case: str, *args, shape=None) -> list:
        """Every rank runs ``CASES[case](mesh, *args)`` on the mesh of
        ``shape`` (the 1-D mesh when None); their results in rank
        order."""
        for q in self._inboxes:
            q.put((case, args, shape or (self.world,)))
        results, deadline = {}, time.monotonic() + self.timeout
        while len(results) < self.world:
            try:
                rank, ok, value = self._outbox.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(
                        f"case {case!r}: ranks {dead} died or the case ran "
                        f"past {self.timeout} s; results from "
                        f"{sorted(results)}")
                continue
            results[rank] = (ok, value)
        failed = {r: v for r, (ok, v) in results.items() if not ok}
        if failed:
            raise AssertionError(f"case {case!r} failed on ranks "
                                 f"{sorted(failed)}:\n"
                                 f"{next(iter(failed.values()))}")
        return [results[r][1] for r in range(self.world)]

    def close(self) -> None:
        for q in self._inboxes:
            q.put(None)
        for p in self._procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(self._dir, ignore_errors=True)
        alive = [p.pid for p in self._procs if p.is_alive()]
        if alive:
            raise RuntimeError(f"ranks {alive} did not stop")


def _rank_main(rank, world, store_path, shapes, inbox, outbox):
    import torch
    import torch.distributed as dist

    from fasta_tpu_torch import sharding
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        meshes = {sh: (sharding.make_mesh(device="cpu") if len(sh) == 1
                       else sharding.make_mesh_2d(*sh, device="cpu"))
                  for sh in shapes}
        while True:
            msg = inbox.get()
            if msg is None:
                break
            case, args, shape = msg
            try:
                outbox.put((rank, True, CASES[case](meshes[shape], *args)))
            except Exception:           # reported to the test, which fails
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# The ranks' side of the cases
# --------------------------------------------------------------------------

SERIES = ("solution", "taus", "residuals", "fvals", "backtracks")


def host_result(r) -> dict:
    """A solve's result (``FastaResult`` or ``DeviceResult``) as NumPy."""
    from fasta_tpu_torch import convert
    out = convert.result_to_numpy(r)
    return {k: out[k] for k in SERIES + ("iteration_count", "converged",
                                         "total_backtracks")}


def _dtype(name: str):
    import torch
    return getattr(torch, name)


def case_mesh(mesh):
    """The mesh as this rank sees it: its axes, size, shape, device, this
    rank's index on each axis and the global ranks of each axis's group."""
    import torch.distributed as dist

    from fasta_tpu_torch import distributed
    whole = distributed.global_mesh(device="cpu")
    names = mesh.mesh_dim_names
    return dict(names=names, size=mesh.size(), shape=tuple(mesh.shape),
                device=mesh.device_type, rank=mesh.get_local_rank("rows"),
                index={a: mesh.get_local_rank(a) for a in names},
                groups={a: dist.get_process_group_ranks(mesh.get_group(a))
                        for a in names},
                distributed=distributed.is_distributed(),
                global_size=whole.size())


def case_fasta(mesh, key):
    """``fasta()`` on the sharded LASSO 240×96 float64 with no τ₀ (the
    stepsize estimate) and the adjoint check first."""
    import torch

    import fasta_tpu_torch as ftt
    from fasta_tpu_torch import problems
    from fasta_tpu_torch import sharding as sh
    p = problems.build("lasso", m=240, n=96, k=10, dtype=torch.float64,
                       device="cpu")
    sp = sh.shard_problem(p, mesh)
    r = ftt.fasta(sp.op, None, sp.fterm, None, sp.gterm, None, sp.x0,
                  key=key, check_adjoint_first=True, tol=1e-9,
                  max_iters=120)
    out = host_result(r)
    out.update(L=r.L_estimate, tau0=r.initial_tau)
    return out


def _place(mesh, problem, explicit=True):
    """``shard_problem`` on a 1-D mesh, ``shard_problem_2d`` on a 2-D
    one."""
    from fasta_tpu_torch import sharding as sh
    if len(mesh.mesh_dim_names) == 2:
        return sh.shard_problem_2d(problem, mesh)
    return sh.shard_problem(problem, mesh, explicit=explicit)


def case_solve(mesh, name, build_kw, tau0, solve_kw):
    """``name`` built by the port at ``build_kw`` (``dtype`` named as a
    string), placed on the mesh (``shard_problem``, or
    ``shard_problem_2d`` on a 2-D mesh), ``Problem.solve``: the result,
    the operator's class and the collectives the solve made."""
    from fasta_tpu_torch import problems
    from fasta_tpu_torch import sharding as sh
    kw = dict(build_kw, dtype=_dtype(build_kw["dtype"]), device="cpu")
    explicit = solve_kw.pop("explicit", True)
    sp = _place(mesh, problems.build(name, **kw), explicit)
    sh.reset_collective_counts()
    r = sp.solve(tau0=tau0, **solve_kw)
    out = host_result(r)
    out.update(counts=sh.collective_counts(), op=type(sp.op).__name__,
               name=sp.name)
    return out


def case_op(mesh, arrays, x, y, rtol=1e-10):
    """The operator of ``convert.sharded_op_from_arrays``: this rank's
    block of A x, Aᴴ y (y whole; the rank takes its rows) and the adjoint
    check's error (at ``rtol``: a bfloat16 operator rounds its vectors)."""
    import torch

    from fasta_tpu_torch import check_adjoint, convert
    from fasta_tpu_torch import sharding as sh
    op = convert.sharded_op_from_arrays(arrays, mesh)
    x, y = torch.as_tensor(x), sh.shard_rows(y, mesh)
    err = check_adjoint(op, torch.zeros_like(x),
                        torch.Generator().manual_seed(0), rtol=rtol)
    return dict(d=op(x).numpy(), g=op.rmatvec(y).numpy(), err=err,
                op=type(op).__name__, shape=getattr(op, "shape", None))


def case_blocks(mesh, build_kw):
    """The shapes and devices of what ``shard_problem`` placed, and whether
    they hold this rank's rows of the whole problem's (x0 all of it)."""
    import torch

    from fasta_tpu_torch import problems
    from fasta_tpu_torch import sharding as sh
    kw = dict(build_kw, dtype=_dtype(build_kw["dtype"]), device="cpu")
    p = problems.build("lasso", **kw)
    sp = sh.shard_problem(p, mesh)
    rank = mesh.get_local_rank("rows")
    rows = slice(rank * sp.op.A.shape[0], (rank + 1) * sp.op.A.shape[0])
    return dict(A=tuple(sp.op.A.shape), b=tuple(sp.fterm.term.b.shape),
                x0=tuple(sp.x0.shape), shape=sp.op.shape,
                A_rows=torch.equal(sp.op.A, p.op.A[rows]),
                b_rows=torch.equal(sp.fterm.term.b, p.fterm.b[rows]),
                x0_whole=torch.equal(sp.x0, p.x0),
                devices={str(t.device) for t in (sp.op.A, sp.fterm.term.b,
                                                 sp.x0)})


def case_raises(mesh, name, build_kw):
    """What ``shard_problem`` (``shard_problem_2d`` on a 2-D mesh) raises
    on ``name``: (class name, message)."""
    from fasta_tpu_torch import problems
    kw = dict(build_kw, dtype=_dtype(build_kw["dtype"]), device="cpu")
    try:
        _place(mesh, problems.build(name, **kw))
    except (ValueError, NotImplementedError, TypeError) as e:
        return type(e).__name__, str(e)
    return None, ""


def _x_blocks(op, x, y):
    """This rank's blocks of a whole signal ``x`` and measurement ``y`` for
    an x-sharded operator: x on its split axis (p's rows for the TV dual,
    the leading axis over cols on a 2-D mesh), y on its rows."""
    import torch

    from fasta_tpu_torch import sharding as sh
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    if isinstance(op, sh.RowShardedTVDivOp):
        return (sh._block(x, op.mesh, op.axis_name, 1),
                sh.shard_rows(y, op.mesh, op.axis_name))
    return (sh.shard_rows(x, op.mesh, op.col_axis),
            sh.shard_rows(y, op.mesh, op.row_axis))


def case_op_x(mesh, arrays, x, y):
    """The x-sharded operator of ``convert.sharded_op_from_arrays`` at this
    rank's blocks of the whole x and y: its blocks of A x and Aᴴ y, the
    adjoint check's error (the draws whole, each rank's block kept) and
    the collectives of the two products."""
    import torch

    from fasta_tpu_torch import check_adjoint, convert
    from fasta_tpu_torch import sharding as sh
    op = convert.sharded_op_from_arrays(arrays, mesh)
    xb, yb = _x_blocks(op, x, y)
    sh.reset_collective_counts()
    d, g = op(xb), op.rmatvec(yb)
    counts = sh.collective_counts()
    err = check_adjoint(op, torch.zeros_like(xb),
                        torch.Generator().manual_seed(0), rtol=1e-10)
    return dict(d=d.numpy(), g=g.numpy(), err=err, counts=counts,
                op=type(op).__name__, shape=getattr(op, "shape", None))


def case_tv_map(mesh, p, b, mu):
    """``sharded_tv_lstsq_gradmap`` at this rank's rows of p and b (b's
    halo row fetched when the map is built): its (d, f, g) and the
    collectives of one call."""
    from fasta_tpu_torch import sharding as sh
    op = sh.RowShardedTVDivOp(mu, mesh)
    fn = sh.sharded_tv_lstsq_gradmap(op, sh.shard_rows(b, mesh))
    pb, _ = _x_blocks(op, p, b)
    sh.reset_collective_counts()
    d, f, g = fn(pb)
    return dict(d=d.numpy(), f=float(f), g=g.numpy(),
                counts=sh.collective_counts())


def case_blocks_x(mesh, name, build_kw):
    """What ``shard_problem_2d`` (a 2-D mesh) or ``shard_problem`` (TV)
    placed: the classes, shapes and devices, and whether each holds this
    rank's block of the whole problem's."""
    import torch

    from fasta_tpu_torch import problems
    from fasta_tpu_torch import sharding as sh
    kw = dict(build_kw, dtype=_dtype(build_kw["dtype"]), device="cpu")
    p = problems.build(name, **kw)
    sp = _place(mesh, p)
    op = sp.op
    out = dict(op=type(op).__name__, gterm=type(sp.gterm).__name__,
               fterm=type(sp.fterm).__name__, name=sp.name,
               x0=tuple(sp.x0.shape))
    fb = next(v for v in vars(sp.fterm.term).values()
              if isinstance(v, torch.Tensor))
    whole_b = next(v for v in vars(p.fterm).values()
                   if isinstance(v, torch.Tensor))
    if isinstance(op, sh.RowShardedTVDivOp):
        xb, bb = _x_blocks(op, p.x0, whole_b)
        out.update(b=tuple(fb.shape), b_rows=torch.equal(fb, bb),
                   x0_block=torch.equal(sp.x0, xb),
                   b_below=(None if sp.fterm.b_below is None
                            else tuple(sp.fterm.b_below.shape)))
        return out
    xb, bb = _x_blocks(op, p.x0, whole_b)
    mats = {"GridShardedDenseOp": ("A",),
            "GridShardedPlanarDenseOp": ("Ar", "Ai")}
    blocks = {}
    for field in mats.get(type(op).__name__, ()):
        whole = getattr(p.op, field)
        blocks[field] = (tuple(getattr(op, field).shape),
                         torch.equal(getattr(op, field),
                                     sh._grid_block(whole, mesh, "rows",
                                                    "cols")))
    anchors = {k: (tuple(v.shape), torch.equal(v, sh.shard_rows(
        getattr(p.gterm, k), mesh, "cols")))
        for k, v in vars(sp.gterm.term).items()
        if isinstance(v, torch.Tensor)}
    out.update(b=tuple(fb.shape), b_rows=torch.equal(fb, bb),
               x0_block=torch.equal(sp.x0, xb), blocks=blocks,
               anchors=anchors, shape=op.shape,
               devices={str(t.device) for t in (fb, sp.x0)})
    return out


def case_batch(mesh, mus, path):
    """The μ sweep through ``make_batch_solver`` (``path=False``) or
    ``solve_path`` over the sharded LASSO 240×96 float64."""
    import torch

    import fasta_tpu_torch as ftt
    from fasta_tpu_torch import problems
    from fasta_tpu_torch import sharding as sh
    p = problems.build("lasso", m=240, n=96, k=10, dtype=torch.float64,
                       device="cpu")
    sp = sh.shard_problem(p, mesh)
    opts = ftt.FastaOptions(max_iters=400, tol=1e-9)
    mus = torch.as_tensor(np.asarray(mus))
    if path:
        r = ftt.solve_path(sp.op, sp.fterm, ftt.L1Norm(mus), sp.x0, 0.05,
                           opts)
    else:
        batch = ftt.make_batch_solver(opts, (None, None, 0, None, None))
        r = batch(sp.op, sp.fterm, ftt.L1Norm(mus), sp.x0, 0.05)
    return dict(solution=r.solution.numpy(), taus=r.taus.numpy(),
                iteration_count=np.asarray(r.iteration_count),
                converged=np.asarray(r.converged))


def case_resume(mesh, state_dir, dtype):
    """The sharded exact resume: LASSO 64×48 row-sharded, 30 iterations,
    each rank's ``SolverState`` through ``checkpoint.save_pytree`` /
    ``load_pytree`` (one file a rank), ``resume_state`` to 60, against
    the uninterrupted 60-iteration run, in the three modes."""
    import torch

    import fasta_tpu_torch as ftt
    from fasta_tpu_torch import checkpoint, problems
    from fasta_tpu_torch import sharding as sh
    rank = mesh.get_local_rank("rows")
    p = problems.build("lasso", m=64, n=48, k=6, dtype=_dtype(dtype),
                       device="cpu")
    sp = sh.shard_problem(p, mesh)
    args = (sp.op, sp.fterm, sp.gterm, sp.x0, 0.05)
    out = {}
    for mode, kw in ftt.MODE_OPTIONS.items():
        o30 = ftt.FastaOptions(max_iters=30, stop_rule="iterations", **kw)
        o60 = o30.replace(max_iters=60)
        _, s30 = ftt.make_stateful_solver(o30)(*args)
        path = os.path.join(state_dir, f"state_{mode}_{dtype}_{rank}.npz")
        checkpoint.save_pytree(s30, path)
        loaded = checkpoint.load_pytree(s30, path)
        r_res, s60 = ftt.resume_state(*args[:3], loaded, o60)
        r_full, _ = ftt.make_stateful_solver(o60)(*args)
        out[mode] = dict(
            resumed=host_result(r_res), full=host_result(r_full),
            k=int(s60.k), d_rows=(None if s30.accel is None
                                  else tuple(s30.accel[1].shape)))
    return out


def case_resume_x(mesh, state_dir, dtype, name):
    """The x-sharded exact resume: LASSO 64×48 on a 2-D mesh
    (``shard_problem_2d``) or TV 16×16 over the 1-D mesh (p split over
    image rows), 30 iterations, each rank's ``SolverState`` (its block of
    x, and FISTA's carry) through its own file, ``resume_state`` to 60,
    against the uninterrupted 60-iteration run, in the three modes."""
    import torch

    import fasta_tpu_torch as ftt
    from fasta_tpu_torch import checkpoint, problems
    rank = torch.distributed.get_rank()
    kw = (dict(h=16, w=16) if name == "tv" else dict(m=64, n=48, k=6))
    p = problems.build(name, dtype=_dtype(dtype), device="cpu", **kw)
    sp = _place(mesh, p)
    args = (sp.op, sp.fterm, sp.gterm, sp.x0, 2.0 if name == "tv" else 0.05)
    out = {}
    for mode, kw in ftt.MODE_OPTIONS.items():
        o30 = ftt.FastaOptions(max_iters=30, stop_rule="iterations", **kw)
        o60 = o30.replace(max_iters=60)
        _, s30 = ftt.make_stateful_solver(o30)(*args)
        path = os.path.join(state_dir,
                            f"state_{name}_{mode}_{dtype}_{rank}.npz")
        checkpoint.save_pytree(s30, path)
        loaded = checkpoint.load_pytree(s30, path)
        r_res, s60 = ftt.resume_state(*args[:3], loaded, o60)
        r_full, _ = ftt.make_stateful_solver(o60)(*args)
        out[mode] = dict(resumed=host_result(r_res), full=host_result(r_full),
                         k=int(s60.k), x_block=tuple(s30.x1.shape))
    return out


# ---------------------------------------------- the GSPMD layouts (13c) --

def lane_data(kind: str, seed: int, B: int, m: int, n: int) -> dict:
    """A stack of B seeded instances, one a lane: ``kind`` "dense" (A
    (B, m, n), b (B, m)) or "planar" (Ar, Ai (B, m, n), b (B, m, 2)), as
    float64 NumPy; both packages build their problems from these."""
    rng = np.random.default_rng(seed)
    if kind == "dense":
        return dict(A=rng.standard_normal((B, m, n)) / np.sqrt(m),
                    b=rng.standard_normal((B, m)))
    return dict(Ar=rng.standard_normal((B, m, n)) / np.sqrt(2 * m),
                Ai=rng.standard_normal((B, m, n)) / np.sqrt(2 * m),
                b=np.abs(rng.standard_normal((B, m, 2))))


def gspmd_problem(spec: dict):
    """The port's problem of a case of ``test_torch_sharding_gspmd.py``:
    ``name`` built at ``build`` (``dtype`` a string), then its
    ``variant``: "bf16" (the operator a ``LowPrecDenseOp`` over the JAX
    operator's bfloat16 bits ``A16``, or over the matrix rounded here), "function" (a ``FunctionOp``
    closing over the matrix), "nuclear" or "maxrow" (the prox term a
    ``NuclearNorm`` or ``MaxRowNormBall`` of weight ``weight``), "lanes"
    (a stacked ``DenseOp`` or ``PlanarDenseOp`` over :func:`lane_data`,
    ``LeastSquares`` of each lane's b, ``L1Norm(weight)``)."""
    import torch

    import fasta_tpu_torch as ftt
    from fasta_tpu_torch import convert, problems
    variant = spec.get("variant")
    if variant == "lanes":
        d = {k: torch.as_tensor(v) for k, v in
             lane_data(spec["name"], *spec["build"]).items()}
        op = (ftt.DenseOp(d["A"]) if spec["name"] == "dense"
              else ftt.PlanarDenseOp(d["Ar"], d["Ai"]))
        n = spec["build"][3]
        x0 = torch.zeros((n,) if spec["name"] == "dense" else (n, 2),
                         dtype=torch.float64)
        return ftt.Problem(f"{spec['name']}_lanes", op=op,
                           fterm=ftt.LeastSquares(d["b"]),
                           gterm=ftt.L1Norm(spec["weight"]), x0=x0)
    kw = dict(spec["build"], dtype=_dtype(spec["build"]["dtype"]),
              device="cpu")
    p = problems.build(spec["name"], **kw)
    if variant == "bf16":
        if spec.get("A16") is None:       # rounded here, not carried
            return p.with_parts(op=ftt.LowPrecDenseOp.from_dense(p.op.A))
        return p.with_parts(op=convert.lowprec_op_from_arrays(
            spec["A16"], device="cpu"))
    if variant == "function":
        A = p.op.A
        return p.with_parts(op=ftt.FunctionOp(lambda x: A @ x,
                                              lambda y: A.mT @ y))
    if variant == "fsmooth":
        b = p.fterm.b
        return p.with_parts(fterm=ftt.FunctionSmooth(
            lambda d: 0.5 * torch.sum((d - b) ** 2), lambda d: d - b))
    if variant == "nuclear":
        return p.with_parts(gterm=ftt.NuclearNorm(spec["weight"]))
    if variant == "maxrow":
        return p.with_parts(gterm=ftt.MaxRowNormBall(spec["weight"]))
    return p


def case_gspmd(mesh, spec, solve_kw):
    """:func:`gspmd_problem` placed (``shard_problem``, or
    ``shard_problem_2d`` on a 2-D mesh) and solved — a lanes case through
    ``make_batch_solver`` with the operator and the smooth term on axis 0:
    the result, the objectives when recorded, the classes, the name and
    the collectives the solve made."""
    import fasta_tpu_torch as ftt
    from fasta_tpu_torch import convert
    from fasta_tpu_torch import sharding as sh
    sp = _place(mesh, gspmd_problem(spec))
    sh.reset_collective_counts()
    if spec.get("variant") == "lanes":
        r = ftt.make_batch_solver(ftt.FastaOptions(**solve_kw),
                                  (0, 0, None, None, None))(
            sp.op, sp.fterm, sp.gterm, sp.x0, spec["tau0"])
    else:
        r = sp.solve(tau0=spec["tau0"], **solve_kw)
    counts = sh.collective_counts()
    out = convert.result_to_numpy(r)
    out.update(counts=counts, op=type(sp.op).__name__,
               gterm=type(sp.gterm).__name__, name=sp.name,
               lanes=tuple(getattr(sp.op, "A", getattr(sp.op, "Ar", None))
                           .shape) if spec.get("variant") == "lanes"
               else None)
    return out


def case_place(mesh, spec):
    """What ``shard_problem`` makes of :func:`gspmd_problem`: the classes
    and the name (nothing solved)."""
    sp = _place(mesh, gspmd_problem(spec))
    return dict(op=type(sp.op).__name__, fterm=type(sp.fterm).__name__,
                gterm=type(sp.gterm).__name__, name=sp.name)


def case_gate(mesh, A16, b, x, gate):
    """The bfloat16 LASSO map on this rank's rows with the 64 MB gate set
    to ``gate`` bytes: whether the rank's map kept x in float32 (the
    kernel's function) or rounded it to bfloat16 (the two-call path), and
    its (d, f, g) beside the unsharded operator's map at the same gate."""
    import torch

    from fasta_tpu_torch import convert, terms
    from fasta_tpu_torch import sharding as sh
    x, b = torch.as_tensor(x), torch.as_tensor(b)
    saved = terms._STREAMING_BYTES
    terms._STREAMING_BYTES = gate
    try:
        op = convert.sharded_op_from_arrays({"kind": "lowprec", "A": A16},
                                            mesh)
        whole = convert.lowprec_op_from_arrays(A16, device="cpu")
        fn = sh.sharded_lstsq_gradmap(op, sh.shard_rows(b, mesh))
        d, f, g = fn(x)
        term = terms.LeastSquares(b)
        ref = term.fused_gradmap(whole)
        d1, f1, g1 = (ref(x) if ref is not None else
                      (whole(x), term.value(whole(x)),
                       whole.rmatvec(term.grad(whole(x)))))
    finally:
        terms._STREAMING_BYTES = saved
    rows = op.A.float()
    return dict(kernel=torch.equal(d, rows @ x),
                rounded=torch.equal(d, rows @ x.bfloat16().float()),
                block_bytes=op.A.numel() * 2, d=d.numpy(), f=float(f),
                g=g.numpy(), whole_d=d1.numpy(), whole_f=float(f1),
                whole_g=g1.numpy())


def case_lane_op(mesh, arrays):
    """The stacked operator of ``convert.sharded_op_from_arrays``: its
    class, this rank's members (the first channel) and its shape."""
    from fasta_tpu_torch import convert
    op = convert.sharded_op_from_arrays(arrays, mesh)
    first = op.A if hasattr(op, "A") else op.Ar
    return dict(op=type(op).__name__, members=first.numpy(), shape=op.shape)


def case_raises_spec(mesh, spec):
    """What ``shard_problem`` raises on :func:`gspmd_problem`: (class
    name, message)."""
    try:
        _place(mesh, gspmd_problem(spec))
    except (ValueError, NotImplementedError, TypeError) as e:
        return type(e).__name__, str(e)
    return None, ""


def case_resume_gspmd(mesh, state_dir, spec):
    """Exact resume over a layout of ``gspmd_problem(spec)``: 20
    iterations, each rank's ``SolverState`` through its own file,
    ``resume_state`` to 40, against the uninterrupted 40-iteration run,
    in the three modes."""
    import torch

    import fasta_tpu_torch as ftt
    from fasta_tpu_torch import checkpoint
    rank = torch.distributed.get_rank()
    sp = _place(mesh, gspmd_problem(spec))
    args = (sp.op, sp.fterm, sp.gterm, sp.x0, spec["tau0"])
    out = {}
    for mode, kw in ftt.MODE_OPTIONS.items():
        o20 = ftt.FastaOptions(max_iters=20, stop_rule="iterations", **kw)
        o40 = o20.replace(max_iters=40)
        _, s20 = ftt.make_stateful_solver(o20)(*args)
        path = os.path.join(state_dir,
                            f"state_{spec['name']}_{mode}_{rank}.npz")
        checkpoint.save_pytree(s20, path)
        loaded = checkpoint.load_pytree(s20, path)
        r_res, s40 = ftt.resume_state(*args[:3], loaded, o40)
        r_full, _ = ftt.make_stateful_solver(o40)(*args)
        out[mode] = dict(resumed=host_result(r_res), full=host_result(r_full),
                         k=int(s40.k), op=type(sp.op).__name__)
    return out


CASES = {"mesh": case_mesh, "fasta": case_fasta, "solve": case_solve, "op": case_op,
         "blocks": case_blocks, "raises": case_raises, "batch": case_batch,
         "resume": case_resume, "resume_x": case_resume_x,
         "op_x": case_op_x, "tv_map": case_tv_map, "blocks_x": case_blocks_x,
         "gspmd": case_gspmd, "place": case_place, "gate": case_gate,
         "resume_gspmd": case_resume_gspmd, "lane_op": case_lane_op,
         "raises_spec": case_raises_spec}
