"""Checkpoint and resume (port of ``fasta_tpu/checkpoint.py``).

* ``save_pytree`` / ``load_pytree`` write a tree of tensors and arrays —
  a ``FastaResult``, ``DeviceResult`` or ``MicroResult``, a dict of a
  problem's tensors — to one ``.npz`` file, each leaf keyed by its path
  in the tree, and read it back into the structure of an example.  The
  keys are the JAX package's (``jax.tree_util`` key paths: dict keys in
  sorted order, field names, sequence indices, joined by "/";
  ``"<root>"`` for a bare leaf; None is an empty subtree), so a file
  written by either package loads in the other.  Loading checks the key
  set and refuses a checkpoint of another structure.  NumPy has no
  bfloat16: such leaves are stored as float32, which holds them exactly,
  and cast back to the example's type on load.
* ``resume(problem, result, ...)`` warm-restarts a solve from a previous
  result at its last iterate and last stepsize: the second half of the
  mixed-precision workflow (solve over a ``LowPrecDenseOp`` to a loose
  tolerance, then resume the float32 problem).  It rebuilds the
  nonmonotone window and the FISTA momentum.

For BIT-EXACT mid-run resume — window, momentum, BB stepsize and the
records' cursor all continued — take the whole ``SolverState`` from
``fasta_tpu_torch.make_stateful_solver``, ``save_pytree`` /
``load_pytree`` it (its keys are the JAX package's, so either package's
state file loads in the other), and continue with
``fasta_tpu_torch.resume_state``: the resumed trajectory equals the
uninterrupted run bit for bit (``tests/test_torch_exact_resume.py``).
The state's counts are 0-d tensors, so they load as tensors.

No JAX import: the tree walk is written out here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .options import FastaOptions

__all__ = ["save_pytree", "load_pytree", "resume"]


def _children(node):
    """(keys, children, rebuild) of an inner node of the tree, or None for
    a leaf.  ``rebuild(children)`` makes a node of the same kind."""
    if node is None:
        return (), (), lambda _: None
    if isinstance(node, dict):
        keys = sorted(node)
        return keys, [node[k] for k in keys], \
            lambda ch: type(node)(zip(keys, ch))
    if isinstance(node, tuple) and hasattr(node, "_fields"):   # NamedTuple
        return node._fields, list(node), lambda ch: type(node)(*ch)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        names = [f.name for f in dataclasses.fields(node)]
        return names, [getattr(node, k) for k in names], \
            lambda ch: dataclasses.replace(node, **dict(zip(names, ch)))
    if isinstance(node, (list, tuple)):
        return range(len(node)), list(node), lambda ch: type(node)(ch)
    return None


def _flatten(tree, path=()):
    """[(path, leaf)] in the order ``jax.tree_util`` flattens."""
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    for key, child in zip(kids[0], kids[1]):
        out += _flatten(child, path + (key,))
    return out


def _unflatten(example, leaves):
    """``example``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    kids = _children(example)
    if kids is None:
        return next(leaves)
    return kids[2]([_unflatten(c, leaves) for c in kids[1]])


def _path_key(path) -> str:
    return "/".join(str(p) for p in path) or "<root>"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)              # exact
        return t.numpy()
    return np.asarray(leaf)


def _like(value: np.ndarray, example):
    """A stored array as the example leaf's type: a tensor in the
    example's dtype on its device, a Python scalar as that scalar type,
    anything else as the NumPy array loaded."""
    if isinstance(example, torch.Tensor):
        return torch.as_tensor(value).to(example.device, example.dtype)
    if isinstance(example, (bool, int, float, complex)) and value.ndim == 0:
        return type(example)(value.item())
    return value


def save_pytree(tree: Any, path: str) -> str:
    """Write the leaves of ``tree`` to ``path`` (.npz), each keyed by its
    tree path, so that a checkpoint can only be restored into the
    structure it came from."""
    flat = _flatten(tree)
    arrays = {_path_key(p): _to_numpy(leaf) for p, leaf in flat}
    if len(arrays) != len(flat):
        raise ValueError("pytree has colliding path keys; cannot save")
    np.savez(path, **arrays)
    return path


def load_pytree(example: Any, path: str) -> Any:
    """Rebuild a tree saved by ``save_pytree`` (by either package) in the
    structure of ``example``.  The checkpoint's key set must equal the
    example's (shapes load as stored), else ``ValueError``; the positional
    ``leaf_{i}`` keys of the oldest format load in flatten order.  Each
    leaf comes back as the example's leaf does: a tensor in its dtype on
    its device, a Python scalar as its type, else a NumPy array."""
    with np.load(path) as data:
        flat = _flatten(example)
        want = [_path_key(p) for p, _ in flat]
        have = set(data.files)
        if have == {f"leaf_{i}" for i in range(len(flat))}:
            want = [f"leaf_{i}" for i in range(len(flat))]
        elif set(want) != have:
            missing = sorted(set(want) - have)
            extra = sorted(have - set(want))
            raise ValueError(
                f"checkpoint does not match the example structure: "
                f"missing keys {missing[:5]}, unexpected keys {extra[:5]} "
                f"({len(missing)} missing / {len(extra)} unexpected total)")
        leaves = [_like(data[k], leaf) for k, (_, leaf) in zip(want, flat)]
    return _unflatten(example, iter(leaves))


def resume(problem, result, options: Optional[FastaOptions] = None,
           **kwargs):
    """Continue a solve from a previous result (a ``FastaResult``,
    ``DeviceResult`` or ``MicroResult``, or one loaded from a checkpoint):
    ``problem.solve`` warm-started at ``result.solution`` with the last
    recorded stepsize as τ₀.  The start is moved to the device and dtype
    of the problem's own x0 (a host result resumes on the card for a
    problem on the card)."""
    taus = np.asarray(torch.as_tensor(result.taus).cpu())
    taus = taus[:int(result.iteration_count)]
    tau = float(taus[-1]) if len(taus) else None
    like = torch.as_tensor(problem.x0)
    x0 = torch.as_tensor(result.solution).to(like.device, like.dtype)
    return problem.with_parts(x0=x0, tau0=tau).solve(options=options,
                                                     **kwargs)
