"""Row-sharded FASTA over ``torch.distributed`` (port of the row layouts of
``fasta_tpu/sharding.py``).

The scaling axis is the measurement dimension m: each rank holds a block
of rows ``A_i`` of the operator and the matching block of b, computes
``A_i x`` locally, and the adjoint ``Aᴴ y = Σ_i A_iᴴ y_i`` is an
all-reduce.  The signal x is replicated: every rank holds all of it, so
everything the solver does in x-space (the prox, ⟨Δx,Δg⟩, ‖Δg‖², the
residuals, the stopping rules) is local and the same on every rank.  The
only communication is one all-reduce of (f, Aᴴ∇f) per gradient-map
evaluation, and an all-reduce of f where the solver evaluates f(d) apart
from a gradient map (the set-up, FISTA's extrapolated point, the two-call
path).  An all-reduce hands every rank the same sum, so **every rank takes
the same stepsize and stopping decisions**, bit for bit.

In PyTorch's idiom: a ``torch.distributed.device_mesh.DeviceMesh`` stands
for the ``jax.sharding.Mesh``, each rank holds plain tensors for its own
rows, and the collectives are explicit (no DTensor).  The reference's two
mechanisms — GSPMD placement (``explicit=False``) and hand-placed
``shard_map`` collectives — become one: PyTorch has no partitioner, so
both build the explicit operators here.

Every all-reduce sums in float64 (complex as float64 pairs) and rounds
each result back to its own dtype once; on one rank it returns its input
bit for bit, so a one-rank group solves exactly as the unsharded port
does.  No collective gathers anything.  Every collective goes through one
function that counts it by kind (:func:`collective_counts`).

Ported here: ``RowShardedDenseOp``, ``RowShardedPlanarDenseOp``,
``ShardedCDPOp``, ``RowShardedSparseOp``, the sharded fused gradient maps
and ``shard_problem``.  The layouts that shard x itself — the TV dual
split over image rows with its halo exchange and the 2-D rows×cols
meshes — are ROADMAP Queue A item 13b.
"""

from __future__ import annotations

import copy
import os
from typing import Optional

import torch
import torch.distributed as torch_dist

from .operators import (ComposeOp, DenseOp, DiagonalOp, LinearOp,
                        MaskedFourierOp, PlanarDenseOp, ScaledOp, SparseOp,
                        StackedOp, TVDiv2D, randn_like)
from .problem import Problem
from .terms import FunctionSmooth, SmoothTerm

__all__ = [
    "make_mesh", "mesh_device", "replicate", "shard_rows", "shard_cols",
    "shard_problem", "RowShardedDenseOp", "RowShardedPlanarDenseOp",
    "ShardedCDPOp", "RowShardedSparseOp", "RowShardedSmooth",
    "sharded_lstsq_gradmap", "sharded_pointwise_gradmap",
    "sharded_phase_hinge_gradmap", "sharded_planar_phase_hinge_gradmap",
    "sharded_cdp_phase_hinge_gradmap", "collective_counts",
    "reset_collective_counts",
]

_NEXT_ITEM = ("ROADMAP Queue A item 13b (the layouts that shard x: the TV "
              "halo exchange and the 2-D meshes)")


# --------------------------------------------------------------------------
# Collectives: one counted entry point
# --------------------------------------------------------------------------

# Collectives this process made, by kind.  Only all-reduces exist: the row
# layouts gather nothing.
_COLLECTIVES = {"all_reduce": 0}


def collective_counts() -> dict:
    """The collectives this process has made since the last reset, by
    kind."""
    return dict(_COLLECTIVES)


def reset_collective_counts() -> None:
    for kind in _COLLECTIVES:
        _COLLECTIVES[kind] = 0


def _all_reduce(buf: torch.Tensor, group) -> None:
    """The one place this module communicates: a sum of ``buf`` over
    ``group`` in place, counted."""
    _COLLECTIVES["all_reduce"] += 1
    torch_dist.all_reduce(buf, group=group)


def _sum_over_ranks(group, *parts: torch.Tensor) -> list:
    """Each of ``parts`` summed over the ranks of ``group`` in ONE
    all-reduce: the parts flattened into one float64 buffer (complex parts
    as their real and imaginary float64 pairs), each sum rounded back to
    its part's dtype once."""
    flat = [torch.view_as_real(p.to(torch.complex128)).reshape(-1)
            if p.is_complex() else p.to(torch.float64).reshape(-1)
            for p in parts]
    buf = torch.cat(flat)
    _all_reduce(buf, group)
    out, at = [], 0
    for p, f in zip(parts, flat):
        seg = buf[at:at + f.numel()]
        at += f.numel()
        if p.is_complex():
            pairs = seg.view(-1, 2)
            seg = torch.complex(pairs[:, 0], pairs[:, 1])
        out.append(seg.view(p.shape).to(p.dtype))
    return out


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
    dev = _rank_device(device)
    if not torch_dist.is_initialized():
        torch_dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=torch_dist.HashStore(), rank=0, world_size=1)
    world = torch_dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: the mesh spans the world's {world} "
                         f"ranks, not {n_devices}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, (world,), mesh_dim_names=(axis_name,))


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
        vector (every rank draws all of it, so the generators stay in
        step and the rows are the unsharded draw's)."""
        whole = torch.empty((d.shape[0] * self.size,) + tuple(d.shape[1:]),
                            dtype=d.dtype, device=d.device)
        k = d.shape[0]
        return randn_like(whole, generator)[self.rank * k:(self.rank + 1) * k]

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
        import scipy.sparse as sp
        M = op.M.to_sparse_csr().cpu()
        csr = sp.csr_matrix((M.values().numpy(), M.col_indices().numpy(),
                             M.crow_indices().numpy()), shape=tuple(M.shape))
        return cls.from_scipy(csr, mesh, axis_name, dtype=M.dtype)

    @property
    def shape(self):
        m, n = self.M.shape
        return (m * self.size, n)


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

    def __call__(self, x):
        d, f, g = self._local(x)
        if self.decision:
            f = self.term.value_f64_lanes(d[None])[0]
        f, g = _sum_over_ranks(self.group, f, g)
        return d, f, g

    def decision_precision(self) -> "_ShardedGradmap":
        """This map with f in float64, the solver's hp decision value."""
        return _ShardedGradmap(self.local_op, self.term, self.group, True)


class RowShardedSmooth(SmoothTerm):
    """A smooth term over a row-sharded measurement space: ``term`` holds
    this rank's rows of its data (b, y, ...).  What GSPMD did in the
    reference is explicit here: ``value_lanes`` and ``value_f64_lanes``
    all-reduce the rank's partial sums (the solver evaluates f(d) on the
    rank's rows at its set-up, FISTA's extrapolated point and the two-call
    path), ``grad_lanes`` stays local, and ``fused_gradmap`` over a
    row-sharded operator is the sharded fused map (one all-reduce an
    evaluation).  :func:`shard_problem` builds it."""

    lane_field = None

    def __init__(self, term: SmoothTerm, mesh, axis_name: str = "rows"):
        self.term = term
        self.mesh = mesh
        self.axis_name = axis_name
        self.group = _axis(mesh, axis_name)[2]
        self.grad_affine = term.grad_affine

    def value_lanes(self, d):
        return _sum_over_ranks(self.group, self.term.value_lanes(d))[0]

    def value_f64_lanes(self, d):
        return _sum_over_ranks(self.group, self.term.value_f64_lanes(d))[0]

    def grad(self, d):
        return self.term.grad(d)

    def grad_lanes(self, d):
        return self.term.grad_lanes(d)

    def fused_gradmap(self, op):
        if not isinstance(op, _RowSharded):
            return None
        return _ShardedGradmap(op.local, self.term, self.group)


def _sharded_map(op: _RowSharded, term: SmoothTerm):
    return RowShardedSmooth(term, op.mesh, op.axis_name).fused_gradmap(op)


def sharded_lstsq_gradmap(op: RowShardedDenseOp, b: torch.Tensor):
    """x ↦ (A_i x, ½‖Ax−b‖², Aᴴ(Ax−b)) with one all-reduce
    (``fasta_tpu/sharding.py:291-331``); ``b`` is this rank's rows.  The
    local pass is K-B3 on a float32 block on the card."""
    from .terms import LeastSquares
    return _sharded_map(op, LeastSquares(b))


def sharded_pointwise_gradmap(op: RowShardedDenseOp, data: torch.Tensor,
                              loss: str):
    """x ↦ (A_i x, Σℓ, Aᵀℓ′) for ``loss`` "logistic" or "squared_hinge"
    with one all-reduce (``fasta_tpu/sharding.py:262-288``); ``data`` is
    this rank's labels.  The local pass is K-B3p on a float32 block on the
    card."""
    from .terms import Logistic, SquaredHinge
    terms = {"logistic": Logistic, "squared_hinge": SquaredHinge}
    if loss not in terms:
        raise ValueError(f"unknown pointwise loss {loss!r} (choose "
                         f"logistic or squared_hinge)")
    return _sharded_map(op, terms[loss](data))


def sharded_phase_hinge_gradmap(op: RowShardedDenseOp, b: torch.Tensor):
    """The PhaseMax hinge over a complex row-sharded matrix, Wirtinger
    gradient, one all-reduce (``fasta_tpu/sharding.py:311-331``)."""
    from .terms import PhaseHinge
    return _sharded_map(op, PhaseHinge(b))


def sharded_planar_phase_hinge_gradmap(op: RowShardedPlanarDenseOp,
                                       b: torch.Tensor):
    """The PhaseMax hinge over planar channels, one all-reduce
    (``fasta_tpu/sharding.py:226-259``); the local pass is K-B7 on float32
    or bfloat16 channels on the card."""
    from .terms import PlanarPhaseHinge
    return _sharded_map(op, PlanarPhaseHinge(b))


def sharded_cdp_phase_hinge_gradmap(op: ShardedCDPOp, b: torch.Tensor):
    """The PhaseMax hinge over the coded-diffraction stack: batched local
    FFTs, one all-reduce (``fasta_tpu/sharding.py:394-416``); ``b`` is this
    rank's (K/ranks, n) magnitudes."""
    from .terms import PhaseHinge
    return _sharded_map(op, PhaseHinge(b))


# --------------------------------------------------------------------------
# Problem placement
# --------------------------------------------------------------------------

def _is_cdp_stack(op) -> bool:
    return (isinstance(op, StackedOp)
            and all(isinstance(member, ComposeOp)
                    and isinstance(member.outer, MaskedFourierOp)
                    and isinstance(member.inner, DiagonalOp)
                    for member in op.ops))


def _sharded_term(term: SmoothTerm, m: int, mesh, axis_name: str):
    """A copy of ``term`` whose tensors with a leading axis of m hold this
    rank's rows (the reference's placement rule), wrapped to sum over the
    ranks."""
    if isinstance(term, (FunctionSmooth, RowShardedSmooth)):
        raise NotImplementedError(
            f"shard_problem: {type(term).__name__} holds no data tensor to "
            f"place on the mesh")
    local = copy.copy(term)
    for name, value in vars(term).items():
        if isinstance(value, torch.Tensor) and value.ndim >= 1 \
                and value.shape[0] == m:
            setattr(local, name, shard_rows(value, mesh, axis_name))
    return RowShardedSmooth(local, mesh, axis_name)


def _replicated(term, mesh):
    """A copy of a prox term with its tensors on this rank's device."""
    out = copy.copy(term)
    for name, value in vars(term).items():
        if isinstance(value, torch.Tensor):
            setattr(out, name, replicate(value, mesh))
    return out


def shard_problem(problem: Problem, mesh, axis_name: str = "rows",
                  explicit: bool = True) -> Problem:
    """Place a problem on the mesh, row-sharded over its measurements
    (``fasta_tpu/sharding.py:1066-1148``).

    The operator becomes its row-sharded form — ``DenseOp`` →
    :class:`RowShardedDenseOp`, ``PlanarDenseOp`` →
    :class:`RowShardedPlanarDenseOp`, ``SparseOp`` →
    :class:`RowShardedSparseOp`, the coded-diffraction ``StackedOp`` →
    :class:`ShardedCDPOp` (its K members collapsed into mask arrays) —
    holding this rank's rows; the smooth term's tensors whose leading axis
    is the measurement dimension m are split the same way and the term
    wrapped in :class:`RowShardedSmooth`; the prox term and x0 (signal
    space) are replicated.  The result is named ``"<name>@<ranks>dev"``.

    ``explicit=False`` builds the same operators: the reference then left
    the collectives to GSPMD, which has no PyTorch counterpart.  The TV
    dual (``ScaledOp(TVDiv2D)``), which the reference splits over image
    rows with a halo exchange, and every operator the reference leaves to
    GSPMD (``LowPrecDenseOp``, ``FunctionOp``, ``IdentityOp``, a batched
    matrix, ...) raise ``NotImplementedError``: there is no silent
    unsharded fallback.  m (for the CDP stack, the mask count) must divide
    by the mesh size (``ValueError``, as in the reference)."""
    del explicit            # one mechanism: see the docstring
    op = problem.op
    _, n_dev, _ = _axis(mesh, axis_name)
    if isinstance(op, ScaledOp) and isinstance(op.op, TVDiv2D):
        raise NotImplementedError(
            f"shard_problem: the TV dual's row split with its halo "
            f"exchange is not ported yet: {_NEXT_ITEM}")
    dense = isinstance(op, DenseOp) and op.A.ndim == 2
    planar = isinstance(op, PlanarDenseOp) and op.Ar.ndim == 2
    cdp = _is_cdp_stack(op)
    if not (dense or planar or cdp or isinstance(op, SparseOp)):
        raise NotImplementedError(
            f"shard_problem: {type(op).__name__} has no row-sharded form "
            f"(the reference leaves it to GSPMD); see {_NEXT_ITEM}")
    m = op(torch.as_tensor(problem.x0)).shape[0]
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
    elif cdp:
        mods = torch.stack([member.inner.d for member in op.ops])
        wins = torch.stack([member.outer.mask for member in op.ops])
        sop = ShardedCDPOp(shard_rows(mods, mesh, axis_name),
                           shard_rows(wins, mesh, axis_name), mesh,
                           axis_name)
    else:
        sop = RowShardedSparseOp.from_sparse_op(op, mesh, axis_name)
    return problem.with_parts(
        op=sop, fterm=_sharded_term(problem.fterm, m, mesh, axis_name),
        gterm=_replicated(problem.gterm, mesh),
        x0=replicate(problem.x0, mesh),
        name=problem.name + f"@{n_dev}dev")
