"""Multi-process set-up over ``torch.distributed`` (port of
``fasta_tpu/distributed.py``).

The reference scales across hosts with ``jax.distributed`` and one
row-sharded mesh; the port does the same with a process group and a 1-D
``DeviceMesh`` over all of its ranks.  Failure semantics are fail-stop,
as in the reference: a lost rank aborts the job (a collective times out),
and re-running beats elastic machinery for solves of seconds to minutes.

A typical program, one process a rank:

    import fasta_tpu_torch.distributed as dist
    dist.initialize("host:port", num_processes=4, process_id=rank)
    mesh = dist.global_mesh()              # 1-D mesh over every rank
    sprob = sharding.shard_problem(problem, mesh)
    result = sprob.solve(...)              # identical on every rank

Every stepsize and stopping decision inside the solve reads values that
an all-reduce made identical on every rank, so all ranks take the same
branches: no other synchronisation is needed.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as torch_dist

from .sharding import make_mesh

__all__ = ["initialize", "global_mesh", "is_distributed", "default_backend"]


def default_backend() -> str:
    """"nccl" when this process's tensors live on a card, "gloo" on the
    CPU."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Initialize the default process group; a no-op for one process or
    when a group exists already, as ``jax.distributed.initialize`` in the
    reference.

    ``coordinator_address`` is "host:port" (rank 0 listens there) or any
    ``init_method`` URL ("tcp://...", "file://..."); None reads
    ``MASTER_ADDR`` / ``MASTER_PORT`` from the environment.
    ``num_processes`` and ``process_id`` default to ``WORLD_SIZE`` and
    ``RANK`` from the environment.  ``backend`` defaults to
    :func:`default_backend`; a caller may ask for "gloo" on the card
    (several ranks on one card, which NCCL refuses)."""
    if torch_dist.is_initialized():
        return
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    torch_dist.init_process_group(backend or default_backend(),
                                  init_method=init_method,
                                  world_size=num_processes, rank=process_id)


def is_distributed() -> bool:
    """Whether this process is one of several ranks."""
    return torch_dist.is_initialized() and torch_dist.get_world_size() > 1


def global_mesh(axis_name: str = "rows", device=None):
    """1-D mesh over every rank of every host (``sharding.make_mesh``)."""
    return make_mesh(axis_name=axis_name, device=device)
