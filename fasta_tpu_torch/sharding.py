"""Sharded FASTA over ``torch.distributed`` (port of
``fasta_tpu/sharding.py``).

Two families of layouts, both driving the one solver:

* **Row layouts** (the measurement dimension m split): each rank holds a
  block of rows ``A_i`` of the operator and the matching block of b,
  computes ``A_i x`` locally, and the adjoint ``Aᴴ y = Σ_i A_iᴴ y_i`` is
  an all-reduce.  x is replicated, so everything the solver does in
  x-space is local.  One all-reduce of (f, Aᴴ∇f) per gradient-map
  evaluation, and one of f where the solver evaluates f(d) apart from a
  gradient map.  ``RowShardedDenseOp``, ``RowShardedPlanarDenseOp``,
  ``ShardedCDPOp`` (the mask axis split), ``RowShardedSparseOp`` and
  ``shard_problem``.
* **Layouts that shard x itself**: the TV dual field p (2, H, W) split
  over image rows (``RowShardedTVDivOp``: each stencil leg one halo
  exchange of one row with each neighbour; the fused map one exchange,
  K-B5's band form on the rank's rows and one all-reduce of f), and the
  2-D rows×cols meshes of wide problems (``make_mesh_2d``,
  ``GridShardedDenseOp``, ``GridShardedSparseOp``,
  ``GridShardedPlanarDenseOp``, ``shard_problem_2d``: A in a grid of
  blocks, measurement vectors split on rows, signal vectors on cols; a
  gradient map is one all-reduce over cols for d and one over rows for
  (f, g)).  The solver's sums over x are then partial on each rank: the
  operator's ``signal_sum`` hook completes them, one all-reduce for a
  trial's sums and one for the iteration's others, and the prox term is
  wrapped in ``SignalShardedProx`` (its value completed, the L∞ norm's
  prox over the gathered x).

* **The layouts the reference leaves to XLA's partitioner** (GSPMD places
  the leaves and partitions the rest; PyTorch has none, so each is a
  layout here): a bfloat16 ``LowPrecDenseOp`` over rows
  (``RowShardedLowPrecDenseOp``: K-B3 / K-B3p bf16 on the rank's rows,
  the 64 MB gate judged on the whole matrix); an ``IdentityOp`` whose
  smooth term's data has x's rows (``RowShardedIdentityOp``: x
  replicated, the term's rows split, one all-reduce a gradient map); a
  stacked ``DenseOp`` or ``PlanarDenseOp`` over its lanes
  (``LaneShardedDenseOp``, ``LaneShardedPlanarDenseOp``: whole members a
  rank, no collective in the batch solver's loop, one all-gather of the
  result after it); and the replicated layout for what has no split form
  (``FunctionOp``, a ``FunctionSmooth``, NMF, the other structured
  operators): every rank solves the whole problem with no collective.

An all-reduce hands every rank the same sum, so **every rank takes the
same stepsize and stopping decisions**, bit for bit.

In PyTorch's idiom: a ``torch.distributed.device_mesh.DeviceMesh`` stands
for the ``jax.sharding.Mesh`` (``mesh.get_group("rows")`` is the group
whose ranks differ in their row index, the one the reference's
``psum(..., "rows")`` sums over), each rank holds plain tensors for its
own block, and the collectives are explicit (no DTensor).  The
reference's two mechanisms — GSPMD placement (``explicit=False``) and
hand-placed ``shard_map`` collectives — become one: PyTorch has no
partitioner, so both build the explicit operators here.

Every all-reduce sums in float64 (complex as float64 pairs) and rounds
each result back to its own dtype once; on one rank it returns its input
bit for bit, so a one-rank group solves exactly as the unsharded port
does.  Nothing is gathered but x for a prox that needs all of it (L∞,
the nuclear norm, a closure) and a lane-split batch's result.  Every
collective goes through one function that counts it by kind
(:func:`collective_counts`).
"""

from __future__ import annotations

import copy
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as torch_dist

from .operators import (ComposeOp, DenseOp, DiagonalOp, IdentityOp,
                        LinearOp, LowPrecDenseOp, MaskedFourierOp,
                        PlanarDenseOp, ScaledOp, SparseOp, StackedOp,
                        TVDiv2D, randn_like)
from .problem import Problem
from .terms import (BoxIndicator, FunctionSmooth, L1Norm, L2Norm2, L21Norm,
                    LeastSquares, LinearAnchor, LinfBallIndicator, LinfNorm,
                    Logistic, MaskedLogistic, MaxRowNormBall,
                    NonnegIndicator, PhaseHinge, PlanarLinearAnchor,
                    PlanarPhaseHinge, ProxTerm, SmoothTerm, SquaredHinge,
                    ZeroTerm)

__all__ = [
    "make_mesh", "make_mesh_2d", "mesh_device", "replicate", "shard_rows",
    "shard_cols", "shard_problem", "shard_problem_2d", "RowShardedDenseOp",
    "RowShardedPlanarDenseOp", "ShardedCDPOp", "RowShardedSparseOp",
    "RowShardedLowPrecDenseOp", "RowShardedIdentityOp",
    "LaneShardedDenseOp", "LaneShardedPlanarDenseOp",
    "GridShardedDenseOp", "GridShardedSparseOp", "GridShardedPlanarDenseOp",
    "RowShardedTVDivOp", "RowShardedSmooth", "SignalShardedProx",
    "sharded_lstsq_gradmap", "sharded_pointwise_gradmap",
    "sharded_phase_hinge_gradmap", "sharded_planar_phase_hinge_gradmap",
    "sharded_cdp_phase_hinge_gradmap", "sharded_lstsq_gradmap_2d",
    "sharded_sparse_lstsq_gradmap_2d", "sharded_planar_lstsq_gradmap_2d",
    "sharded_planar_phase_hinge_gradmap_2d", "sharded_tv_lstsq_gradmap",
    "collective_counts", "reset_collective_counts",
]


# --------------------------------------------------------------------------
# Collectives: one counted entry point
# --------------------------------------------------------------------------

# Collectives this process made, by kind: sums ("all_reduce"), the L∞
# norm's max ("all_reduce_max"), gathers ("all_gather": x for a prox that
# needs all of it, a lane-split batch's result) and the TV stencils'
# neighbour exchanges ("halo").  Gloo takes card
# tensors in its collectives itself, through host copies of its own
# (staging them here saved nothing: tools/gloo_allreduce.py).
_COLLECTIVES = {"all_reduce": 0, "all_reduce_max": 0, "all_gather": 0,
                "halo": 0}


def collective_counts() -> dict:
    """The collectives this process has made since the last reset, by
    kind; a kind it has not made is absent (the row layouts make only
    all-reduces)."""
    return {kind: n for kind, n in _COLLECTIVES.items() if n}


def reset_collective_counts() -> None:
    for kind in _COLLECTIVES:
        _COLLECTIVES[kind] = 0


def _sum_over_ranks(group, *parts: torch.Tensor) -> list:
    """Each of ``parts`` summed over the ranks of ``group`` in ONE
    all-reduce: the parts flattened into one float64 buffer (complex parts
    as their real and imaginary float64 pairs), each sum rounded back to
    its part's dtype once."""
    flat = [torch.view_as_real(p.to(torch.complex128)).reshape(-1)
            if p.is_complex() else p.to(torch.float64).reshape(-1)
            for p in parts]
    buf = torch.cat(flat)
    _COLLECTIVES["all_reduce"] += 1
    torch_dist.all_reduce(buf, group=group)
    out, at = [], 0
    for p, f in zip(parts, flat):
        seg = buf[at:at + f.numel()]
        at += f.numel()
        if p.is_complex():
            pairs = seg.view(-1, 2)
            seg = torch.complex(pairs[:, 0], pairs[:, 1])
        out.append(seg.view(p.shape).to(p.dtype))
    return out


def _max_over_ranks(group, part: torch.Tensor) -> torch.Tensor:
    """The elementwise max of a real ``part`` over the ranks of
    ``group``: one all-reduce, counted as its own kind."""
    buf = part.clone()
    _COLLECTIVES["all_reduce_max"] += 1
    torch_dist.all_reduce(buf, op=torch_dist.ReduceOp.MAX, group=group)
    return buf


def _gather_over_ranks(group, size: int, block: torch.Tensor,
                       dim: int) -> torch.Tensor:
    """The ranks' blocks of ``group`` joined along ``dim`` in rank order:
    one all-gather, counted."""
    _COLLECTIVES["all_gather"] += 1
    parts = [torch.empty_like(block) for _ in range(size)]
    torch_dist.all_gather(parts, block.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _halo(group, rank: int, size: int, to_prev=None, to_next=None,
          prev_like=None, next_like=None) -> tuple:
    """ONE halo exchange over the ranks of ``group`` in their order:
    ``to_prev`` goes to the previous rank and ``to_next`` to the next; a
    tensor shaped like ``prev_like`` comes from the previous rank and one
    like ``next_like`` from the next.  Returns (from previous, from next),
    None where the rank has no such neighbour or asked for nothing.  One
    ``batch_isend_irecv`` of all of them, counted once as kind "halo" on
    every rank (a one-rank group exchanges nothing).  Gloo's send and
    receive hand the tensor's pointer to its TCP transport, which reads
    host memory (its collectives copy card tensors themselves), so over
    gloo the rows of card tensors are staged through host copies; over
    NCCL they stay on the card."""
    _COLLECTIVES["halo"] += 1
    like = next(t for t in (to_prev, to_next, prev_like, next_like)
                if t is not None)
    stage = (like.device.type != "cpu"
             and torch_dist.get_backend(group) == "gloo")

    def wire(t):
        return t.cpu() if stage else t.contiguous()

    def peer(r):
        return torch_dist.get_global_rank(group, r)
    ops, got = [], [None, None]
    for side, r, send, want in ((0, rank - 1, to_prev, prev_like),
                                (1, rank + 1, to_next, next_like)):
        if not 0 <= r < size:
            continue
        if send is not None:
            ops.append(torch_dist.P2POp(torch_dist.isend, wire(send),
                                        peer(r), group))
        if want is not None:
            got[side] = torch.empty(want.shape, dtype=want.dtype,
                                    device="cpu" if stage else want.device)
            ops.append(torch_dist.P2POp(torch_dist.irecv, got[side],
                                        peer(r), group))
    if ops:
        for req in torch_dist.batch_isend_irecv(ops):
            req.wait()
    return tuple(None if t is None else t.to(like.device) for t in got)


def _draw_block(v: torch.Tensor, generator, dim: int, rank: int,
                size: int) -> torch.Tensor:
    """This rank's block along ``dim`` of one standard normal draw shaped
    like the whole vector whose block is ``v`` (every rank draws all of
    it, so the generators stay in step and the block is the unsharded
    draw's)."""
    shape = list(v.shape)
    k = shape[dim]
    shape[dim] = k * size
    whole = torch.empty(shape, dtype=v.dtype, device=v.device)
    return randn_like(whole, generator).narrow(dim, rank * k, k)


# --------------------------------------------------------------------------
# Mesh and placement
# --------------------------------------------------------------------------

def _rank_device(device) -> torch.device:
    """This rank's device: ``device`` when given, else
    ``cuda:{local_rank % device_count}`` (``LOCAL_RANK`` from the
    environment, else the global rank).  No card and no ``device`` raises
    rather than fall back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: the default device is 'cuda' and no CUDA device is "
            "available; pass device='cpu' to shard on the CPU")
    rank = (torch_dist.get_rank() if torch_dist.is_initialized() else 0)
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def _world(device) -> torch.device:
    """This rank's device, with a process group formed when none exists
    (a one-rank group: NCCL on the card, gloo on the CPU, an in-memory
    store), and the card made current."""
    dev = _rank_device(device)
    if not torch_dist.is_initialized():
        torch_dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=torch_dist.HashStore(), rank=0, world_size=1)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "rows",
              device=None):
    """1-D ``DeviceMesh`` over every rank of the world, its one axis
    ``axis_name``; this rank's device is ``device`` (the card when None:
    ``cuda:{local_rank % device_count}``).

    With no process group this forms a one-rank group (NCCL on the card,
    gloo on the CPU, an in-memory store), since the reference's mesh needs
    no set-up on one host.  ``n_devices`` must be the world size when
    given: the mesh spans the whole group."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = _world(device)
    world = torch_dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: the mesh spans the world's {world} "
                         f"ranks, not {n_devices}")
    return init_device_mesh(dev.type, (world,), mesh_dim_names=(axis_name,))


def make_mesh_2d(rows: int, cols: int, row_axis: str = "rows",
                 col_axis: str = "cols", device=None):
    """2-D ``DeviceMesh`` (``rows`` × ``cols``, axes ``row_axis`` and
    ``col_axis``) over every rank of the world, rank r at row r // cols
    and column r % cols (``fasta_tpu/sharding.py:75-89``): measurement
    rows × signal columns, the layout of wide problems.  The device and
    the one-rank group as :func:`make_mesh`; rows × cols must be the
    world size (``ValueError``)."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = _world(device)
    world = torch_dist.get_world_size()
    if rows < 1 or cols < 1 or rows * cols != world:
        raise ValueError(f"mesh {rows}x{cols} needs {rows * cols} ranks; "
                         f"the world has {world}")
    return init_device_mesh(dev.type, (rows, cols),
                            mesh_dim_names=(row_axis, col_axis))


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def _axis(mesh, axis_name: str):
    """(this rank's index on ``axis_name``, the axis's size, its group)."""
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        raise ValueError(f"the mesh has no axis {axis_name!r} (it has "
                         f"{names})")
    dim = names.index(axis_name)
    return (mesh.get_local_rank(axis_name), mesh.size(dim),
            mesh.get_group(axis_name))


def replicate(x, mesh) -> torch.Tensor:
    """``x`` whole on this rank's device (every rank holds all of it)."""
    return torch.as_tensor(x).to(mesh_device(mesh))


def _block(x, mesh, axis_name: str, dim: int) -> torch.Tensor:
    x = torch.as_tensor(x)
    rank, size, _ = _axis(mesh, axis_name)
    if x.shape[dim] % size:
        raise ValueError(f"axis of {x.shape[dim]} not divisible by mesh "
                         f"size {size}")
    k = x.shape[dim] // size
    blk = x.narrow(dim, rank * k, k)
    # a copy of its own: the rank owns its rows (and a fresh allocation is
    # aligned for the kernels)
    return blk.to(mesh_device(mesh), copy=True).contiguous()


def shard_rows(x, mesh, axis_name: str = "rows") -> torch.Tensor:
    """This rank's block of ``x``'s leading axis, on its device."""
    return _block(x, mesh, axis_name, 0)


def shard_cols(x, mesh, axis_name: str = "cols") -> torch.Tensor:
    """This rank's block of ``x``'s last axis, on its device."""
    return _block(x, mesh, axis_name, torch.as_tensor(x).ndim - 1)


# --------------------------------------------------------------------------
# Row-sharded operators
# --------------------------------------------------------------------------

class _RowSharded(LinearOp):
    """A linear operator whose rank holds a block of rows as the plain
    operator ``local``: the forward product is local (no communication,
    d keeps the row split), the adjoint is the local adjoint and one
    all-reduce.  Lanes take one all-reduce for all of them."""

    def __init__(self, local: LinearOp, mesh, axis_name: str = "rows"):
        self.local = local
        self.mesh = mesh
        self.axis_name = axis_name
        self.rank, self.size, self.group = _axis(mesh, axis_name)

    def __call__(self, x):
        return self.local(x)

    def rmatvec(self, y):
        return _sum_over_ranks(self.group, self.local.rmatvec(y))[0]

    def lanes(self, x):
        return self.local.lanes(x)

    def rmatvec_lanes(self, y):
        return _sum_over_ranks(self.group, self.local.rmatvec_lanes(y))[0]

    def measurement_draw(self, d, generator):
        """This rank's rows of one draw shaped like the whole measurement
        vector (:func:`_draw_block`)."""
        return _draw_block(d, generator, 0, self.rank, self.size)

    def measurement_sum(self, s):
        """A sum over this rank's rows completed over the ranks."""
        return _sum_over_ranks(self.group, s)[0]


class RowShardedDenseOp(_RowSharded):
    """Dense operator with its rows split over the mesh
    (``fasta_tpu/sharding.py:112-165``): ``A`` is this rank's block of
    rows (:func:`shard_rows` of the whole matrix).  Forward: the local
    product, no communication.  Adjoint: the local ``A_iᴴ y_i`` and one
    all-reduce.  A matrix-valued x (MMV) works as with ``DenseOp``."""

    def __init__(self, A: torch.Tensor, mesh, axis_name: str = "rows"):
        super().__init__(DenseOp(A), mesh, axis_name)
        self.A = A

    @property
    def shape(self):
        m, n = self.A.shape
        return (m * self.size, n)


class RowShardedPlanarDenseOp(_RowSharded):
    """Planar-complex dense operator (``operators.PlanarDenseOp``) with its
    rows split over the mesh (``fasta_tpu/sharding.py:168-223``): ``Ar``
    and ``Ai`` are this rank's blocks of the channels; the fused hinge map
    runs kernel K-B7 on them."""

    def __init__(self, Ar: torch.Tensor, Ai: torch.Tensor, mesh,
                 axis_name: str = "rows"):
        super().__init__(PlanarDenseOp(Ar, Ai), mesh, axis_name)
        self.Ar, self.Ai = Ar, Ai

    @property
    def shape(self):
        m, n = self.Ar.shape
        return (m * self.size, n)


class _CDPStack(LinearOp):
    """d_k = w_k ⊙ FFT(m_k ⊙ x) for a block of masks (K, n), batched in one
    unitary FFT over the masks; the adjoint Σ_k conj(m_k) ⊙ IFFT(conj(w_k)
    ⊙ y_k).  Leading axes of x (and of y before the mask axis) are
    lanes."""

    def __init__(self, mods: torch.Tensor, wins: torch.Tensor):
        self.mods, self.wins = mods, wins

    def __call__(self, x):
        return self.wins * torch.fft.fft(self.mods * x[..., None, :],
                                         norm="ortho")

    def rmatvec(self, y):
        xs = torch.conj(self.mods) * torch.fft.ifft(torch.conj(self.wins) * y,
                                                    norm="ortho")
        return torch.sum(xs, dim=-2)

    lanes, rmatvec_lanes = __call__, rmatvec


class ShardedCDPOp(_RowSharded):
    """The coded-diffraction stack d_k = w_k ⊙ FFT(m_k ⊙ x) with its MASK
    axis split over the mesh (``fasta_tpu/sharding.py:334-391``):
    ``mods`` and ``wins`` are this rank's (K/ranks, n) masks and windows.
    Forward: a batched local FFT, no communication; adjoint: the local sum
    over the rank's masks and one all-reduce.  It replaces the
    ``StackedOp(ComposeOp(MaskedFourierOp, DiagonalOp))`` of
    ``problems.phase_retrieval_cdp`` under :func:`shard_problem`."""

    def __init__(self, mods: torch.Tensor, wins: torch.Tensor, mesh,
                 axis_name: str = "rows"):
        super().__init__(_CDPStack(mods, wins), mesh, axis_name)
        self.mods, self.wins = mods, wins

    @property
    def shape(self):
        K, n = self.mods.shape
        return (K * self.size * n, n)


class RowShardedSparseOp(_RowSharded):
    """Sparse operator with its rows split over the mesh
    (``fasta_tpu/sharding.py:418-516``): this rank's rows as the port's
    ``SparseOp`` (CSR with its stored adjoint), so no padding is needed.
    Forward local, adjoint local and one all-reduce."""

    def __init__(self, M: SparseOp, mesh, axis_name: str = "rows"):
        super().__init__(M, mesh, axis_name)
        self.M = M

    @classmethod
    def from_scipy(cls, sp_matrix, mesh, axis_name: str = "rows",
                   dtype: Optional[torch.dtype] = None
                   ) -> "RowShardedSparseOp":
        """This rank's equal block of rows of a scipy sparse matrix, as
        ``dtype`` CSR tensors (scipy's type when None)."""
        sp_matrix = sp_matrix.tocsr()
        m = sp_matrix.shape[0]
        rank, size, _ = _axis(mesh, axis_name)
        if m % size != 0:
            raise ValueError(f"row count {m} not divisible by mesh {size}")
        br = m // size
        block = sp_matrix[rank * br:(rank + 1) * br]
        return cls(SparseOp.from_scipy(block, dtype,
                                       device=mesh_device(mesh)),
                   mesh, axis_name)

    @classmethod
    def from_sparse_op(cls, op: SparseOp, mesh, axis_name: str = "rows"
                       ) -> "RowShardedSparseOp":
        """Split a port ``SparseOp`` (the counterpart of the reference's
        ``from_bcoo``): its CSR matrix read to the host and split as
        :meth:`from_scipy`."""
        return cls.from_scipy(_host_csr(op), mesh, axis_name,
                              dtype=op.M.dtype)

    @property
    def shape(self):
        m, n = self.M.shape
        return (m * self.size, n)


def _host_csr(op: SparseOp):
    """A port ``SparseOp``'s matrix as a scipy CSR matrix on the host."""
    import scipy.sparse as sp
    M = op.M.to_sparse_csr().cpu()
    return sp.csr_matrix((M.values().numpy(), M.col_indices().numpy(),
                          M.crow_indices().numpy()), shape=tuple(M.shape))


class _LowPrecRows(LowPrecDenseOp):
    """A rank's rows of a ``LowPrecDenseOp``, which answers the 64 MB gate
    for the whole matrix (``whole_bytes``): the gate chooses the function
    (the kernel keeps x in float32, the two-call path rounds it to
    bfloat16), so every rank must choose what the unsharded solve
    chooses."""

    def __init__(self, A: torch.Tensor, whole_bytes: int):
        super().__init__(A)
        self.whole_bytes = whole_bytes

    @property
    def stored_bytes(self) -> int:
        return self.whole_bytes


class RowShardedLowPrecDenseOp(_RowSharded):
    """A low-precision (bfloat16) dense operator with its rows split over
    the mesh: ``A`` is this rank's block of rows in the storage type
    (:func:`shard_rows` of ``LowPrecDenseOp.A``).  The reference places
    A's rows on the mesh and leaves the product to XLA
    (``fasta_tpu/sharding.py:1095-1106``); here, as
    :class:`RowShardedDenseOp`: the forward local, x rounded to the
    storage type as ``LowPrecDenseOp`` rounds it; the adjoint local and
    one all-reduce.  The fused map is the rank's one-read pass — kernel
    K-B3 bf16 for least squares, K-B3p bf16 for the logistic loss and the
    squared hinge — and one all-reduce, when the WHOLE matrix passes the
    64 MB gate (``terms._lowprec_fused``, judged as the reference's gate
    judges the global matrix), else the two-call pass and one
    all-reduce."""

    def __init__(self, A: torch.Tensor, mesh, axis_name: str = "rows"):
        size = _axis(mesh, axis_name)[1]
        super().__init__(_LowPrecRows(A, A.numel() * A.element_size() * size),
                         mesh, axis_name)
        self.A = A

    @property
    def shape(self):
        m, n = self.A.shape
        return (m * self.size, n)


class _Rows(LinearOp):
    """The rows [lo, lo + k) of a variable whose leading axis is m: the
    forward takes them, the adjoint puts them back into a zero tensor
    shaped like the variable.  Leading axes of ``lanes`` are lanes."""

    def __init__(self, lo: int, k: int, m: int):
        self.lo, self.k, self.m = lo, k, m

    def __call__(self, x):
        return x[self.lo:self.lo + self.k]

    def rmatvec(self, y):
        out = y.new_zeros((self.m,) + tuple(y.shape[1:]))
        out[self.lo:self.lo + self.k] = y
        return out

    def lanes(self, x):
        return x[:, self.lo:self.lo + self.k]

    def rmatvec_lanes(self, y):
        out = y.new_zeros((y.shape[0], self.m) + tuple(y.shape[2:]))
        out[:, self.lo:self.lo + self.k] = y
        return out


class RowShardedIdentityOp(_RowSharded):
    """The identity with the smooth term's rows split over the mesh: x
    (its leading axis of ``m`` rows) is replicated, and this rank's
    measurements are its rows of x (matrix completion's
    ``MaskedLogistic``, max-norm's ``LeastSquares``: the reference places
    the term's Y, mask or b by rows and leaves the elementwise loss to
    XLA, ``fasta_tpu/sharding.py:1095-1106``).  Forward: the rank's rows,
    no communication.  Adjoint: the rows put back into a zero tensor
    shaped like x and one all-reduce (the float64 sum of one nonzero
    block and zeros is that block, so the gradient is the unsharded
    one's bit for bit).  The fused map is the rank's two-call pass and
    one all-reduce of (f, g); the prox runs on the replicated x on every
    rank."""

    def __init__(self, m: int, mesh, axis_name: str = "rows"):
        rank, size, _ = _axis(mesh, axis_name)
        if m % size:
            raise ValueError(f"row count {m} not divisible by mesh {size}")
        k = m // size
        super().__init__(_Rows(rank * k, k, m), mesh, axis_name)
        self.m = m


def _gather_lanes(group, size: int, result):
    """A batch result over this rank's lanes (``solver.DeviceResult``) with
    every rank's lanes in rank order: ONE all-gather of one float64 buffer
    (B/ranks, ...) holding every field — the counts and flags too — each
    field then restored to its own type (every value is exact in float64:
    float32, complex parts, counts below 2⁵³, flags)."""
    dev = result.solution.device
    fields, flat = [], []
    for name, v in zip(result._fields, result):
        if v is None:
            continue
        t = torch.as_tensor(v, device=dev)
        wide = torch.view_as_real(t.to(torch.complex128)) if t.is_complex() \
            else t.to(torch.float64)
        fields.append((name, v, t))
        flat.append(wide.reshape(t.shape[0], -1))
    whole = _gather_over_ranks(group, size, torch.cat(flat, dim=1), 0)
    out, at = {}, 0
    for (name, v, t), f in zip(fields, flat):
        seg = whole[:, at:at + f.shape[1]]
        at += f.shape[1]
        shape = (whole.shape[0],) + tuple(t.shape[1:])
        if t.is_complex():
            pairs = seg.reshape(shape + (2,))
            seg = torch.complex(pairs[..., 0], pairs[..., 1])
        seg = seg.reshape(shape).to(t.dtype)
        out[name] = (seg.cpu().numpy() if isinstance(v, np.ndarray)
                     else seg.contiguous())
    return result._replace(**out)


class _LaneSharded:
    """A stacked operator (one matrix a lane of
    ``solver.make_batch_solver``, its leading axis the lanes) whose rank
    holds whole members: B/ranks of them.  Every product is the rank's
    own, so the batch solver's loop makes no collective — a lane never
    depends on another lane, a stopped lane being frozen — and its result
    over the rank's lanes is gathered once after the loop
    (:meth:`gather_lanes`, one all-gather), so that every rank holds every
    lane, as the reference's global arrays do."""

    def _on_mesh(self, mesh, axis_name: str):
        self.mesh, self.axis_name = mesh, axis_name
        self.rank, self.size, self.group = _axis(mesh, axis_name)

    def gather_lanes(self, result):
        return _gather_lanes(self.group, self.size, result)

    @property
    def shape(self):
        B, m, n = getattr(self, self.lane_fields[0]).shape
        return (B * self.size, m, n)


class LaneShardedDenseOp(_LaneSharded, DenseOp):
    """A stacked ``DenseOp`` (A (B, m, n)) with its lanes split over the
    mesh: ``A`` is this rank's (B/ranks, m, n) members (the reference's
    ``RowShardedDenseOp`` over a 3-D A, placed ``P('rows', None, None)``,
    ``fasta_tpu/sharding.py:1095-1124``).  See :class:`_LaneSharded`."""

    def __init__(self, A: torch.Tensor, mesh, axis_name: str = "rows"):
        DenseOp.__init__(self, A)
        self._on_mesh(mesh, axis_name)


class LaneShardedPlanarDenseOp(_LaneSharded, PlanarDenseOp):
    """A stacked ``PlanarDenseOp`` (Ar, Ai (B, m, n)) with its lanes split
    over the mesh: ``Ar`` and ``Ai`` are this rank's members (the
    reference sends it to ``RowShardedPlanarDenseOp`` by the same rule,
    ``fasta_tpu/sharding.py:1125-1127``).  See :class:`_LaneSharded`."""

    def __init__(self, Ar: torch.Tensor, Ai: torch.Tensor, mesh,
                 axis_name: str = "rows"):
        PlanarDenseOp.__init__(self, Ar, Ai)
        self._on_mesh(mesh, axis_name)


# --------------------------------------------------------------------------
# Layouts that shard x: the 2-D rows×cols meshes
# --------------------------------------------------------------------------

class _GridSharded(LinearOp):
    """A linear operator on a 2-D (rows × cols) mesh whose rank holds the
    block (row index i, column index j) of A as the plain operator
    ``local``: measurement vectors are split on rows (each held whole by
    the ranks of a row), signal vectors on cols along their leading axis.
    Forward: the local product and one all-reduce over cols (d split on
    rows); adjoint: the local adjoint and one all-reduce over rows (g
    split on cols).  ``signal_sum`` completes sums over x over cols."""

    def __init__(self, local: LinearOp, mesh, row_axis: str = "rows",
                 col_axis: str = "cols"):
        self.local = local
        self.mesh = mesh
        self.row_axis, self.col_axis = row_axis, col_axis
        self.row_rank, self.rows, self.row_group = _axis(mesh, row_axis)
        self.col_rank, self.cols, self.col_group = _axis(mesh, col_axis)

    def __call__(self, x):
        return _sum_over_ranks(self.col_group, self.local(x))[0]

    def rmatvec(self, y):
        return _sum_over_ranks(self.row_group, self.local.rmatvec(y))[0]

    def lanes(self, x):
        return _sum_over_ranks(self.col_group, self.local.lanes(x))[0]

    def rmatvec_lanes(self, y):
        return _sum_over_ranks(self.row_group, self.local.rmatvec_lanes(y))[0]

    def measurement_draw(self, d, generator):
        return _draw_block(d, generator, 0, self.row_rank, self.rows)

    def measurement_sum(self, s):
        return _sum_over_ranks(self.row_group, s)[0]

    def signal_draw(self, x, generator):
        return _draw_block(x, generator, 0, self.col_rank, self.cols)

    def signal_sum(self, *parts):
        return tuple(_sum_over_ranks(self.col_group, *parts))

    @property
    def shape(self):
        m, n = self.local.shape
        return (m * self.rows, n * self.cols)


def _grid_block(A, mesh, row_axis: str, col_axis: str) -> torch.Tensor:
    """This rank's block of a matrix on a 2-D mesh, on its device."""
    A = torch.as_tensor(A)
    i, R, _ = _axis(mesh, row_axis)
    j, C, _ = _axis(mesh, col_axis)
    m, n = A.shape
    if m % R or n % C:
        raise ValueError(f"matrix {m}x{n} not divisible by mesh {R}x{C}")
    blk = A[i * (m // R):(i + 1) * (m // R), j * (n // C):(j + 1) * (n // C)]
    return blk.to(mesh_device(mesh), copy=True).contiguous()


class GridShardedDenseOp(_GridSharded):
    """Dense operator on a 2-D mesh (``fasta_tpu/sharding.py:518-575``):
    ``A`` is this rank's (m/R, n/C) block (``_grid_block`` of the whole
    matrix).  Forward ``torch.matmul`` of the block and one all-reduce
    over cols; adjoint the block's and one all-reduce over rows."""

    def __init__(self, A: torch.Tensor, mesh, row_axis: str = "rows",
                 col_axis: str = "cols"):
        super().__init__(DenseOp(A), mesh, row_axis, col_axis)
        self.A = A


class GridShardedSparseOp(_GridSharded):
    """Sparse operator on a 2-D mesh (``fasta_tpu/sharding.py:604-715``):
    this rank's (m/R, n/C) block as the port's ``SparseOp`` (CSR with its
    stored adjoint; cuSPARSE on the card), so no padding is needed; the
    collectives of :class:`GridShardedDenseOp`."""

    def __init__(self, M: SparseOp, mesh, row_axis: str = "rows",
                 col_axis: str = "cols"):
        super().__init__(M, mesh, row_axis, col_axis)
        self.M = M

    @classmethod
    def from_scipy(cls, sp_matrix, mesh, row_axis: str = "rows",
                   col_axis: str = "cols",
                   dtype: Optional[torch.dtype] = None
                   ) -> "GridShardedSparseOp":
        """This rank's block of a scipy sparse matrix, as ``dtype`` CSR
        tensors (scipy's type when None)."""
        sp_matrix = sp_matrix.tocsr()
        m, n = sp_matrix.shape
        i, R, _ = _axis(mesh, row_axis)
        j, C, _ = _axis(mesh, col_axis)
        if m % R or n % C:
            raise ValueError(f"sparse {m}x{n} not divisible by mesh "
                             f"{R}x{C}")
        br, bc = m // R, n // C
        block = sp_matrix[i * br:(i + 1) * br, j * bc:(j + 1) * bc]
        return cls(SparseOp.from_scipy(block, dtype,
                                       device=mesh_device(mesh)),
                   mesh, row_axis, col_axis)

    @classmethod
    def from_sparse_op(cls, op: SparseOp, mesh, row_axis: str = "rows",
                       col_axis: str = "cols") -> "GridShardedSparseOp":
        """Split a port ``SparseOp`` (the reference's ``from_bcoo``)."""
        return cls.from_scipy(_host_csr(op), mesh, row_axis, col_axis,
                              dtype=op.M.dtype)


class GridShardedPlanarDenseOp(_GridSharded):
    """Planar-complex dense operator on a 2-D mesh
    (``fasta_tpu/sharding.py:740-814``): ``Ar`` and ``Ai`` are this rank's
    blocks of the channels; planar signal vectors (n, 2) are split on
    their signal axis over cols, planar measurements (m, 2) on rows."""

    def __init__(self, Ar: torch.Tensor, Ai: torch.Tensor, mesh,
                 row_axis: str = "rows", col_axis: str = "cols"):
        super().__init__(PlanarDenseOp(Ar, Ai), mesh, row_axis, col_axis)
        self.Ar, self.Ai = Ar, Ai


# --------------------------------------------------------------------------
# Layouts that shard x: the TV dual over image rows
# --------------------------------------------------------------------------

class RowShardedTVDivOp(LinearOp):
    """The TV dual's operator ``c·div`` with the dual field itself split
    over image rows (``fasta_tpu/sharding.py:869-960``): this rank holds
    p's rows (2, H/ranks, W) and the image's rows (H/ranks, W).

    Each stencil leg needs one neighbour row, in ONE halo exchange
    (:func:`_halo`): the forward ``c·div p`` reads the previous rank's
    last vertical-dual row, the adjoint ``c·grad y`` the next rank's first
    row.  Rank 0 and the last rank take zeros there, the Neumann edge, and
    the image's last row is zeroed on the last rank, so both legs equal
    the unsharded ``ScaledOp(c, TVDiv2D())`` bit for bit (the band
    stencils of ``kernels/tv_fused.py``).  The variable is split, so the
    solver's sums over p complete over the same ranks (``signal_sum``)."""

    def __init__(self, c: float, mesh, axis_name: str = "rows"):
        self.c = c
        self.mesh = mesh
        self.axis_name = axis_name
        self.rank, self.size, self.group = _axis(mesh, axis_name)

    @property
    def last(self) -> bool:
        """Whether this rank holds the image's last row."""
        return self.rank == self.size - 1

    def halo(self, to_prev=None, to_next=None, prev_like=None,
             next_like=None) -> tuple:
        """One halo exchange with this rank's neighbours (:func:`_halo`)."""
        return _halo(self.group, self.rank, self.size, to_prev, to_next,
                     prev_like, next_like)

    def __call__(self, p):
        from .kernels.tv_fused import tv_div_band
        above, _ = self.halo(to_next=p[0, -1], prev_like=p[0, -1])
        return self.c * tv_div_band(p, above, self.last)

    def rmatvec(self, y):
        from .kernels.tv_fused import tv_grad_band
        _, below = self.halo(to_prev=y[0], next_like=y[0])
        return self.c * tv_grad_band(y, below)

    def measurement_draw(self, d, generator):
        return _draw_block(d, generator, 0, self.rank, self.size)

    def measurement_sum(self, s):
        return _sum_over_ranks(self.group, s)[0]

    def signal_draw(self, x, generator):
        return _draw_block(x, generator, 1, self.rank, self.size)

    def signal_sum(self, *parts):
        return tuple(_sum_over_ranks(self.group, *parts))


# --------------------------------------------------------------------------
# The row-sharded smooth term and its fused gradient maps
# --------------------------------------------------------------------------

def _local_pass(local_op: LinearOp, term: SmoothTerm):
    """x ↦ (d_i, f_i, A_iᴴ∇f(d_i)) on this rank's rows: the unsharded fused
    map of the rank's block where the term has one (K-B3 for a float32
    dense least-squares block, K-B3p for logistic or the squared hinge,
    K-B7 for planar float32 or bfloat16 channels: the CUDA kernel for CUDA
    tensors, its plain version for CPU tensors), else the plain two-pass
    form (complex and float64 blocks, sparse rows, the CDP stack), as
    ``terms.py`` chooses for one device."""
    fused = term.fused_gradmap(local_op)
    if fused is not None:
        return fused

    def two_pass(x):
        d = local_op(x)
        return d, term.value(d), local_op.rmatvec(term.grad(d))
    return two_pass


class _ShardedGradmap:
    """x ↦ (d_i, f, Aᴴ∇f): this rank's local pass, then ONE all-reduce of
    one flat float64 buffer holding (f, g), the partial g's summed in
    float64 and rounded back to g's dtype once (complex g as real pairs).
    ``decision=True`` is the form the solver takes in hp mode
    (:meth:`decision_precision`): f is then the float64 sum of the ranks'
    ``value_f64`` of their rows, so that an hp trial costs one collective,
    not a second one to evaluate f(d) again."""

    def __init__(self, local_op: LinearOp, term: SmoothTerm, group,
                 decision: bool = False):
        self.local_op, self.term, self.group = local_op, term, group
        self.decision = decision
        self._local = _local_pass(local_op, term)
        # Over the rows of a LowPrecDenseOp below the gate and of the
        # identity, the unsharded solve has no map: it takes the two-call
        # path and FISTA evaluates the gradient at the extrapolated point
        # (for bfloat16 storage, the rounding makes the map no affine
        # function of d), so the solver must not extrapolate this map's.
        self.affine = (term.fused_gradmap(local_op) is not None
                       or not isinstance(local_op, (LowPrecDenseOp, _Rows)))

    def __call__(self, x):
        d, f, g = self._local(x)
        if self.decision:
            f = self.term.value_f64_lanes(d[None])[0]
        f, g = _sum_over_ranks(self.group, f, g)
        return d, f, g

    def decision_precision(self) -> "_ShardedGradmap":
        """This map with f in float64, the solver's hp decision value."""
        return _ShardedGradmap(self.local_op, self.term, self.group, True)


class _GridGradmap:
    """x ↦ (d_i, f, g_j) over a 2-D mesh's operator
    (``fasta_tpu/sharding.py:577-600``): the block's product and ONE
    all-reduce over cols for d, the rank's residual, f and adjoint, then
    ONE all-reduce over rows of one float64 (f, g) buffer.  f's partials
    come from d's rows, which the ranks of a mesh row share, so f sums
    over rows only.  The products are the block operator's
    (``torch.matmul``, the sparse product): d needs the column sum between
    the two legs, so no one-pass kernel applies.  ``decision=True``: f in
    float64, the solver's hp decision value."""

    def __init__(self, op: _GridSharded, term: SmoothTerm,
                 decision: bool = False):
        self.op, self.term, self.decision = op, term, decision

    def __call__(self, x):
        op, term = self.op, self.term
        d = _sum_over_ranks(op.col_group, op.local(x))[0]
        f = (term.value_f64_lanes(d[None])[0] if self.decision
             else term.value(d))
        g = op.local.rmatvec(term.grad(d))
        f, g = _sum_over_ranks(op.row_group, f, g)
        return d, f, g

    def decision_precision(self) -> "_GridGradmap":
        return _GridGradmap(self.op, self.term, True)


# RowShardedSmooth's default b_below: the TV map fetches the row itself
_FETCH = "fetch"


class _TVGradmap:
    """p ↦ (d_i, f, g_i) over a :class:`RowShardedTVDivOp`, the rank's
    rows of d = c·div p, f = ½‖d − b‖² and g = c·grad(d − b): ONE halo
    exchange (this rank's first rows of both dual channels to the previous
    rank, its last vertical-dual row to the next), ONE launch of kernel
    K-B5's band form on the rank's rows (its plain version for CPU
    tensors, and for a dtype other than float32), then ONE all-reduce of
    f.

    The reference makes two exchanges, one a stencil leg
    (``fasta_tpu/sharding.py:963-981``): the adjoint leg needs the
    residual's row below the band, r = d − b there.  b is static, so the
    rank holds the next rank's first row of b (``b_below``, placed by
    :func:`shard_problem`, or fetched by one exchange when the map is
    built), and forms that row of d from the halo rows of p it received
    in the same exchange: one exchange a call.  ``decision=True``: f in
    float64 (the rank's share evaluated again in float64, as
    ``_ShardedGradmap`` does), the solver's hp decision value."""

    def __init__(self, op: RowShardedTVDivOp, term: LeastSquares,
                 b_below=_FETCH, decision: bool = False):
        self.op, self.term, self.decision = op, term, decision
        if isinstance(b_below, str):
            _, b_below = op.halo(to_prev=term.b[0], next_like=term.b[0])
        self.b_below = b_below

    def __call__(self, p):
        from .kernels.tv_fused import (fused_tv_gradmap_band,
                                       tv_gradmap_band_reference)
        op, b = self.op, self.term.b
        above, below = op.halo(to_prev=p[:, 0], to_next=p[0, -1],
                               prev_like=p[0, -1], next_like=p[:, 0])
        if below is not None and op.rank + 2 == op.size and p.shape[1] == 1:
            # the row below is the image's last: its vertical dual is not
            # read (generators.tv_div_2d)
            below = torch.stack([torch.zeros_like(below[0]), below[1]])
        args = (p, b, op.c, above, below,
                None if below is None else self.b_below)
        d, f, g = (fused_tv_gradmap_band(*args) if b.dtype == torch.float32
                   else tv_gradmap_band_reference(*args))
        if self.decision:
            f = self.term.value_f64_lanes(d[None])[0]
        f = _sum_over_ranks(op.group, f)[0]
        return d, f, g

    def decision_precision(self) -> "_TVGradmap":
        return _TVGradmap(self.op, self.term, self.b_below, True)


class RowShardedSmooth(SmoothTerm):
    """A smooth term over a row-sharded measurement space: ``term`` holds
    this rank's rows of its data (b, y, ...).  What GSPMD did in the
    reference is explicit here: ``value_lanes`` and ``value_f64_lanes``
    all-reduce the rank's partial sums (the solver evaluates f(d) on the
    rank's rows at its set-up, FISTA's extrapolated point and the two-call
    path), ``grad_lanes`` stays local, and ``fused_gradmap`` is the
    sharded fused map of the operator's layout: over a row-sharded
    operator one all-reduce an evaluation, over a 2-D mesh's two, over the
    TV dual's rows (a least-squares term) one halo exchange and one
    all-reduce.  ``b_below`` is the TV map's halo row of b (the next
    rank's first row; None on the last rank): by default the map fetches
    it with one exchange when it is built.  :func:`shard_problem` and
    :func:`shard_problem_2d` build it."""

    lane_field = None

    def __init__(self, term: SmoothTerm, mesh, axis_name: str = "rows",
                 b_below=_FETCH):
        self.term = term
        self.mesh = mesh
        self.axis_name = axis_name
        self.group = _axis(mesh, axis_name)[2]
        self.grad_affine = term.grad_affine
        self.b_below = b_below

    def value_lanes(self, d):
        return _sum_over_ranks(self.group, self.term.value_lanes(d))[0]

    def value_f64_lanes(self, d):
        return _sum_over_ranks(self.group, self.term.value_f64_lanes(d))[0]

    def grad(self, d):
        return self.term.grad(d)

    def grad_lanes(self, d):
        return self.term.grad_lanes(d)

    def fused_gradmap(self, op):
        if isinstance(op, _RowSharded):
            return _ShardedGradmap(op.local, self.term, self.group)
        if isinstance(op, _GridSharded):
            return _GridGradmap(op, self.term)
        if (isinstance(op, RowShardedTVDivOp)
                and isinstance(self.term, LeastSquares)):
            return _TVGradmap(op, self.term, self.b_below)
        return None


def _sharded_map(op, term: SmoothTerm, axis_name: str):
    return RowShardedSmooth(term, op.mesh, axis_name).fused_gradmap(op)


def sharded_lstsq_gradmap(op: RowShardedDenseOp, b: torch.Tensor):
    """x ↦ (A_i x, ½‖Ax−b‖², Aᴴ(Ax−b)) with one all-reduce
    (``fasta_tpu/sharding.py:291-331``); ``b`` is this rank's rows.  The
    local pass is K-B3 on a float32 block on the card."""
    return _sharded_map(op, LeastSquares(b), op.axis_name)


def sharded_pointwise_gradmap(op: RowShardedDenseOp, data: torch.Tensor,
                              loss: str):
    """x ↦ (A_i x, Σℓ, Aᵀℓ′) for ``loss`` "logistic" or "squared_hinge"
    with one all-reduce (``fasta_tpu/sharding.py:262-288``); ``data`` is
    this rank's labels.  The local pass is K-B3p on a float32 block on the
    card."""
    terms = {"logistic": Logistic, "squared_hinge": SquaredHinge}
    if loss not in terms:
        raise ValueError(f"unknown pointwise loss {loss!r} (choose "
                         f"logistic or squared_hinge)")
    return _sharded_map(op, terms[loss](data), op.axis_name)


def sharded_phase_hinge_gradmap(op: RowShardedDenseOp, b: torch.Tensor):
    """The PhaseMax hinge over a complex row-sharded matrix, Wirtinger
    gradient, one all-reduce (``fasta_tpu/sharding.py:311-331``)."""
    return _sharded_map(op, PhaseHinge(b), op.axis_name)


def sharded_planar_phase_hinge_gradmap(op: RowShardedPlanarDenseOp,
                                       b: torch.Tensor):
    """The PhaseMax hinge over planar channels, one all-reduce
    (``fasta_tpu/sharding.py:226-259``); the local pass is K-B7 on float32
    or bfloat16 channels on the card."""
    return _sharded_map(op, PlanarPhaseHinge(b), op.axis_name)


def sharded_cdp_phase_hinge_gradmap(op: ShardedCDPOp, b: torch.Tensor):
    """The PhaseMax hinge over the coded-diffraction stack: batched local
    FFTs, one all-reduce (``fasta_tpu/sharding.py:394-416``); ``b`` is this
    rank's (K/ranks, n) magnitudes."""
    return _sharded_map(op, PhaseHinge(b), op.axis_name)


def sharded_lstsq_gradmap_2d(op: GridShardedDenseOp, b: torch.Tensor):
    """x ↦ (d_i, ½‖Ax−b‖², Aᴴ(Ax−b)) on a 2-D mesh with two all-reduces,
    one over cols for d and one over rows for (f, g)
    (``fasta_tpu/sharding.py:577-600``); ``b`` is this rank's rows."""
    return _sharded_map(op, LeastSquares(b), op.row_axis)


def sharded_sparse_lstsq_gradmap_2d(op: GridShardedSparseOp,
                                    b: torch.Tensor):
    """The least-squares map on the sparse 2-D mesh, with the budget of
    :func:`sharded_lstsq_gradmap_2d` (``fasta_tpu/sharding.py:718-737``)."""
    return _sharded_map(op, LeastSquares(b), op.row_axis)


def sharded_planar_lstsq_gradmap_2d(op: GridShardedPlanarDenseOp,
                                    b: torch.Tensor):
    """The planar least-squares map on the 2-D mesh, ``b`` planar (m/R, 2)
    (``fasta_tpu/sharding.py:846-852``)."""
    return _sharded_map(op, LeastSquares(b), op.row_axis)


def sharded_planar_phase_hinge_gradmap_2d(op: GridShardedPlanarDenseOp,
                                          b: torch.Tensor):
    """The PhaseMax hinge over planar channels on the 2-D mesh, ``b`` this
    rank's (m/R,) magnitudes (``fasta_tpu/sharding.py:855-865``)."""
    return _sharded_map(op, PlanarPhaseHinge(b), op.row_axis)


def sharded_tv_lstsq_gradmap(op: RowShardedTVDivOp, b: torch.Tensor,
                             b_below=_FETCH):
    """p ↦ (c·div p, ½‖c·div p − b‖², c·grad(c·div p − b)) on the rank's
    image rows (``fasta_tpu/sharding.py:963-981``): one halo exchange, one
    launch of K-B5's band form, one all-reduce of f (the reference makes
    two exchanges; see ``_TVGradmap``).  ``b`` is this rank's rows;
    ``b_below`` the next rank's first row of b (None on the last rank),
    fetched with one exchange when not given."""
    return _TVGradmap(op, LeastSquares(b), b_below)


# --------------------------------------------------------------------------
# The prox term over a block of x
# --------------------------------------------------------------------------

# Prox terms whose value is a sum over x's entries and whose prox acts on
# each entry (each row, for the L2,1 norm and the max-row-norm ball, whose
# rows run along x's split axis) alone: on a block of x they need only
# the value completed.
_SEPARABLE = (L1Norm, L21Norm, L2Norm2, LinearAnchor, PlanarLinearAnchor,
              NonnegIndicator, BoxIndicator, LinfBallIndicator,
              MaxRowNormBall, ZeroTerm)


class SignalShardedProx(ProxTerm):
    """A prox term over this rank's block of x, its anchors (c of the
    linear anchors) this rank's block too: x is split along ``dim`` over
    the ranks of ``axis_name``.

    The separable terms (the L1, L2,1 and ridge norms, the linear
    anchors, the indicators, the max-row-norm ball) act on the block: the
    prox is local and the value a sum all-reduce, which the solver
    gathers into its iteration's one sum over x (``partial_value_lanes``);
    ``block_term`` is the wrapped term, so the solver still sees an
    ``L1Norm`` and runs kernel K-B4 on the rank's block.  ``LinfNorm``'s
    value is a **max** all-reduce (its own kind in
    :func:`collective_counts`).  Every other term — ``LinfNorm``'s prox,
    which sorts all of x, the nuclear norm, a ``FunctionProx`` — needs the
    whole of x: one all-gather of the blocks (its own kind), the prox (and
    the value, with no sum) on the whole x on every rank, the rank's
    block of the prox kept, as the reference's 2-D democratic case does
    (``tests/sharded/test_sharded_breadth.py:250-279``) and as GSPMD
    gathers a sharded operand of a non-elementwise function."""

    def __init__(self, term: ProxTerm, mesh, axis_name: str = "cols",
                 dim: int = 0):
        self.term = term
        self.mesh = mesh
        self.axis_name = axis_name
        self.dim = dim
        self.rank, self.size, self.group = _axis(mesh, axis_name)
        self._local = isinstance(term, _SEPARABLE)
        self._max = isinstance(term, LinfNorm)

    @property
    def block_term(self) -> ProxTerm:
        return self.term

    def _gathered(self, z, dim: int):
        """The whole of x from the ranks' blocks: one all-gather."""
        return _gather_over_ranks(self.group, self.size, z, dim)

    def _whole(self, fn, z, t, dim: int):
        """``fn`` (the wrapped term's prox) on the gathered x, this rank's
        block of the result."""
        k = z.shape[dim]
        return fn(self._gathered(z, dim), t).narrow(
            dim, self.rank * k, k).clone()

    def value(self, x):
        return self.value_lanes(x[None])[0]

    def value_lanes(self, x):
        if self._local:
            return _sum_over_ranks(self.group, self.term.value_lanes(x))[0]
        if self._max:
            return _max_over_ranks(self.group, self.term.value_lanes(x))
        return self.term.value_lanes(self._gathered(x, self.dim + 1))

    def partial_value_lanes(self, x):
        return self.term.value_lanes(x) if self._local else None

    def prox(self, z, t):
        if self._local:
            return self.term.prox(z, t)
        return self._whole(self.term.prox, z, t, self.dim)

    def prox_lanes(self, z, t):
        if self._local:
            return self.term.prox_lanes(z, t)
        return self._whole(self.term.prox_lanes, z, t, self.dim + 1)


# --------------------------------------------------------------------------
# Problem placement
# --------------------------------------------------------------------------

def _is_cdp_stack(op) -> bool:
    return (isinstance(op, StackedOp)
            and all(isinstance(member, ComposeOp)
                    and isinstance(member.outer, MaskedFourierOp)
                    and isinstance(member.inner, DiagonalOp)
                    for member in op.ops))


def _rows_of(obj, m: int, mesh, axis_name: str):
    """A copy of a term whose tensors with a leading axis of m hold this
    rank's rows (the reference's placement rule), the others on this
    rank's device."""
    out = copy.copy(obj)
    for name, value in vars(obj).items():
        if isinstance(value, torch.Tensor):
            setattr(out, name,
                    shard_rows(value, mesh, axis_name)
                    if value.ndim >= 1 and value.shape[0] == m
                    else replicate(value, mesh))
    return out


def _sharded_term(term: SmoothTerm, m: int, mesh, axis_name: str,
                  **kwargs):
    """A copy of ``term`` whose tensors with a leading axis of m hold this
    rank's rows, wrapped to sum over the ranks."""
    if isinstance(term, RowShardedSmooth):
        raise ValueError("shard_problem: the problem is placed already")
    return RowShardedSmooth(_rows_of(term, m, mesh, axis_name), mesh,
                            axis_name, **kwargs)


def _replicated(obj, mesh):
    """A copy of an operator or a term with its tensors — and those of the
    operators and terms it holds — on this rank's device (a tensor there
    already is kept, not copied); closures are left as they are."""
    def place(v):
        if isinstance(v, torch.Tensor):
            return replicate(v, mesh)
        if isinstance(v, (LinearOp, SmoothTerm, ProxTerm)):
            return _replicated(v, mesh)
        if isinstance(v, tuple) and v and all(isinstance(u, LinearOp)
                                              for u in v):
            return tuple(_replicated(u, mesh) for u in v)
        return v
    out = copy.copy(obj)
    for name, value in vars(obj).items():
        setattr(out, name, place(value))
    return out


def _signal_term(term: ProxTerm, x0: torch.Tensor, mesh, axis_name: str,
                 dim: int) -> SignalShardedProx:
    """A copy of ``term`` whose tensors shaped like x (its anchors) hold
    this rank's block along ``dim``, the others whole, wrapped as a
    :class:`SignalShardedProx`."""
    out = copy.copy(term)
    for name, value in vars(term).items():
        if isinstance(value, torch.Tensor):
            setattr(out, name,
                    _block(value, mesh, axis_name, dim)
                    if tuple(value.shape) == tuple(x0.shape)
                    else replicate(value, mesh))
    return SignalShardedProx(out, mesh, axis_name, dim)


def _shard_tv(problem: Problem, mesh, axis_name: str) -> Problem:
    """The TV dual split over image rows: p's rows and b's on each rank,
    with the next rank's first row of b for the fused map's halo."""
    rank, size, _ = _axis(mesh, axis_name)
    x0 = torch.as_tensor(problem.x0)
    if x0.ndim != 3 or x0.shape[1] % size != 0:
        raise ValueError(f"TV dual field {tuple(x0.shape)} needs H "
                         f"divisible by mesh size {size}")
    fterm = problem.fterm
    H = x0.shape[1]
    hb = H // size
    b_below = (None if rank == size - 1 else
               fterm.b[(rank + 1) * hb].to(mesh_device(mesh), copy=True))
    return problem.with_parts(
        op=RowShardedTVDivOp(float(problem.op.c), mesh, axis_name),
        fterm=_sharded_term(fterm, H, mesh, axis_name, b_below=b_below),
        gterm=_signal_term(problem.gterm, x0, mesh, axis_name, 1),
        x0=_block(x0, mesh, axis_name, 1),
        name=problem.name + f"@{size}dev")


# Smooth terms whose value is a sum over the rows of d and whose gradient
# is elementwise: over the identity, their rows of x can be split
_ROWWISE = (LeastSquares, Logistic, SquaredHinge, PhaseHinge,
            PlanarPhaseHinge, MaskedLogistic)


def _shard_replicated(problem: Problem, mesh, n_dev: int) -> Problem:
    """The replicated layout: every rank holds the whole problem on its
    device and solves it alone, with no collective, bit for bit as the
    unsharded port does."""
    return problem.with_parts(
        op=_replicated(problem.op, mesh),
        fterm=_replicated(problem.fterm, mesh),
        gterm=_replicated(problem.gterm, mesh),
        x0=replicate(problem.x0, mesh),
        name=problem.name + f"@{n_dev}dev")


def _shard_lanes(problem: Problem, mesh, axis_name: str) -> Problem:
    """A stacked operator split over its lanes: each rank's members, and
    the terms' tensors with a leading axis of B (one a lane) split the
    same way; x0 replicated."""
    op = problem.op
    _, size, _ = _axis(mesh, axis_name)
    B = getattr(op, op.lane_fields[0]).shape[0]
    if B % size:
        raise ValueError(f"lane count {B} not divisible by mesh size "
                         f"{size}")
    blocks = [shard_rows(getattr(op, f), mesh, axis_name)
              for f in op.lane_fields]
    cls = (LaneShardedDenseOp if isinstance(op, DenseOp)
           else LaneShardedPlanarDenseOp)
    return problem.with_parts(
        op=cls(*blocks, mesh, axis_name),
        fterm=_rows_of(problem.fterm, B, mesh, axis_name),
        gterm=_rows_of(problem.gterm, B, mesh, axis_name),
        x0=replicate(problem.x0, mesh),
        name=problem.name + f"@{size}dev")


def _holds_rows(term: SmoothTerm, m: int) -> bool:
    """Whether a row-wise term holds data with x's m rows."""
    return isinstance(term, _ROWWISE) and any(
        isinstance(v, torch.Tensor) and v.ndim >= 1 and v.shape[0] == m
        for v in vars(term).values())


def shard_problem(problem: Problem, mesh, axis_name: str = "rows",
                  explicit: bool = True) -> Problem:
    """Place a problem on the mesh (``fasta_tpu/sharding.py:1066-1148``).

    Row layouts, over the measurements: the operator becomes its
    row-sharded form — ``DenseOp`` → :class:`RowShardedDenseOp`,
    ``PlanarDenseOp`` → :class:`RowShardedPlanarDenseOp`, ``SparseOp`` →
    :class:`RowShardedSparseOp`, a 2-D ``LowPrecDenseOp`` →
    :class:`RowShardedLowPrecDenseOp`, the coded-diffraction
    ``StackedOp`` → :class:`ShardedCDPOp` (its K members collapsed into
    mask arrays) — holding this rank's rows; an ``IdentityOp`` whose
    row-wise smooth term holds data with x's rows (matrix completion,
    max-norm) → :class:`RowShardedIdentityOp`.  The smooth term's tensors
    whose leading axis is the measurement dimension m are split the same
    way and the term wrapped in :class:`RowShardedSmooth`; the prox term
    and x0 (signal space) are replicated; m (for the CDP stack, the mask
    count) must divide by the mesh size (``ValueError``, as in the
    reference).

    The TV dual (``ScaledOp(c, TVDiv2D())``) with a least-squares term
    splits the dual field itself over image rows: the operator becomes :class:`RowShardedTVDivOp`, x0
    (2, H, W) and b (H, W) hold this rank's rows (and b's next row, the
    fused map's halo), the prox term is a :class:`SignalShardedProx` over
    p's rows; H must divide by the mesh size.

    A stacked ``DenseOp`` or ``PlanarDenseOp`` (one matrix a lane of
    ``make_batch_solver``) splits its lanes: :class:`LaneShardedDenseOp`
    or :class:`LaneShardedPlanarDenseOp` with B/ranks whole members, the
    terms' tensors with a leading axis of B split alike (the reference's
    rule, B being its measurement dimension there: a shared tensor whose
    leading axis happens to be B is split too); B must divide by the mesh
    size.

    Everything else takes the replicated layout, which is what GSPMD
    itself does with what it cannot split: a ``FunctionOp`` (its closures
    are opaque: the reference splits b and gathers A x, which here would
    cost an all-gather a gradient for nothing), a ``FunctionSmooth``, an
    ``IdentityOp`` whose terms hold no tensor with x's rows (NMF), a bare
    ``MaskedFourierOp``, a non-CDP ``StackedOp`` or ``ComposeOp``,
    ``TVGrad2D``, a non-TV ``ScaledOp``, the TV dual with another smooth
    term.  Every rank holds the whole
    problem and solves it with no collective, bit for bit as the
    unsharded port does; nothing is split, so nothing need divide.

    The result is named ``"<name>@<ranks>dev"``.  ``explicit=False``
    builds the same layouts: the reference then left the collectives to
    GSPMD, which has no PyTorch counterpart."""
    del explicit            # one mechanism: see the docstring
    op, fterm = problem.op, problem.fterm
    _, n_dev, _ = _axis(mesh, axis_name)
    x0 = torch.as_tensor(problem.x0)
    if isinstance(fterm, FunctionSmooth):
        return _shard_replicated(problem, mesh, n_dev)
    if (isinstance(op, ScaledOp) and isinstance(op.op, TVDiv2D)
            and isinstance(fterm, LeastSquares)):
        return _shard_tv(problem, mesh, axis_name)
    if ((isinstance(op, DenseOp) and op.A.ndim == 3)
            or (isinstance(op, PlanarDenseOp) and op.Ar.ndim == 3)):
        return _shard_lanes(problem, mesh, axis_name)
    dense = isinstance(op, DenseOp) and op.A.ndim == 2
    planar = isinstance(op, PlanarDenseOp) and op.Ar.ndim == 2
    lowprec = isinstance(op, LowPrecDenseOp) and op.A.ndim == 2
    cdp = _is_cdp_stack(op)
    rows = (isinstance(op, IdentityOp) and x0.ndim >= 1
            and _holds_rows(fterm, x0.shape[0]))
    if not (dense or planar or lowprec or cdp or rows
            or isinstance(op, SparseOp)):
        return _shard_replicated(problem, mesh, n_dev)
    m = op(x0).shape[0]
    if m % n_dev != 0:
        if cdp:
            raise ValueError(f"CDP mask count {m} not divisible by mesh "
                             f"size {n_dev}")
        raise ValueError(
            f"measurement dim {m} not divisible by mesh size {n_dev}; "
            f"pad the problem or choose a different mesh")
    if dense:
        sop = RowShardedDenseOp(shard_rows(op.A, mesh, axis_name), mesh,
                                axis_name)
    elif planar:
        sop = RowShardedPlanarDenseOp(shard_rows(op.Ar, mesh, axis_name),
                                      shard_rows(op.Ai, mesh, axis_name),
                                      mesh, axis_name)
    elif lowprec:
        sop = RowShardedLowPrecDenseOp(shard_rows(op.A, mesh, axis_name),
                                       mesh, axis_name)
    elif rows:
        sop = RowShardedIdentityOp(m, mesh, axis_name)
    elif cdp:
        mods = torch.stack([member.inner.d for member in op.ops])
        wins = torch.stack([member.outer.mask for member in op.ops])
        sop = ShardedCDPOp(shard_rows(mods, mesh, axis_name),
                           shard_rows(wins, mesh, axis_name), mesh,
                           axis_name)
    else:
        sop = RowShardedSparseOp.from_sparse_op(op, mesh, axis_name)
    return problem.with_parts(
        op=sop, fterm=_sharded_term(fterm, m, mesh, axis_name),
        gterm=_replicated(problem.gterm, mesh),
        x0=replicate(problem.x0, mesh),
        name=problem.name + f"@{n_dev}dev")


def shard_problem_2d(problem: Problem, mesh, row_axis: str = "rows",
                     col_axis: str = "cols") -> Problem:
    """Place a problem on a 2-D (rows × cols) mesh, the wide-problem
    layout (``fasta_tpu/sharding.py:984-1055``): A in a grid of blocks,
    the smooth term's measurement-space tensors (leading axis m) split on
    rows, the signal-space ones (x0, the prox term's anchors) split on
    cols along x's leading axis — a planar (n, 2) vector on its signal
    axis — so neither x nor A's columns are replicated.  ``DenseOp`` →
    :class:`GridShardedDenseOp`, ``PlanarDenseOp`` →
    :class:`GridShardedPlanarDenseOp`, ``SparseOp`` →
    :class:`GridShardedSparseOp`; the smooth term is wrapped in
    :class:`RowShardedSmooth` over rows (its fused map: two all-reduces),
    the prox term in :class:`SignalShardedProx` over cols.  Other
    operators raise ``TypeError``, shapes that do not divide by the mesh
    ``ValueError``, as in the reference.  The result is named
    ``"<name>@<R>x<C>dev"``."""
    op = problem.op
    planar = isinstance(op, PlanarDenseOp) and op.Ar.ndim == 2
    sparse = isinstance(op, SparseOp)
    dense = isinstance(op, DenseOp) and op.A.ndim == 2
    if not (planar or sparse or dense):
        raise TypeError("shard_problem_2d supports DenseOp, PlanarDenseOp "
                        f"and SparseOp problems (got {type(op).__name__})")
    m, n = op.shape
    _, R, _ = _axis(mesh, row_axis)
    _, C, _ = _axis(mesh, col_axis)
    if m % R != 0 or n % C != 0:
        raise ValueError(f"problem {m}x{n} not divisible by mesh {R}x{C}")
    if sparse:
        sop = GridShardedSparseOp.from_sparse_op(op, mesh, row_axis,
                                                 col_axis)
    elif planar:
        sop = GridShardedPlanarDenseOp(
            _grid_block(op.Ar, mesh, row_axis, col_axis),
            _grid_block(op.Ai, mesh, row_axis, col_axis), mesh, row_axis,
            col_axis)
    else:
        sop = GridShardedDenseOp(_grid_block(op.A, mesh, row_axis,
                                             col_axis),
                                 mesh, row_axis, col_axis)
    x0 = torch.as_tensor(problem.x0)
    return problem.with_parts(
        op=sop, fterm=_sharded_term(problem.fterm, m, mesh, row_axis),
        gterm=_signal_term(problem.gterm, x0, mesh, col_axis, 0),
        x0=_block(x0, mesh, col_axis, 0),
        name=problem.name + f"@{R}x{C}dev")
