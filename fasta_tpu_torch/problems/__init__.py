"""Problem suite of the port (port of ``problems/__init__.py``): the dense
problems LASSO, NNLS, sparse logistic regression and the SVM, TV
denoising and phase retrieval (complex or planar); the other problems
come with their terms (ROADMAP Queue A items 2 and 7)."""

from typing import Callable, Dict

REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        REGISTRY[name] = fn
        return fn
    return deco


def build(name: str, **kwargs):
    """Construct a named problem instance:
    ``build('lasso', m=..., device=...)``.  ``device`` defaults to the
    card, and raises without one: pass ``device="cpu"`` for the CPU."""
    from . import lasso, logistic, nnls, phase_retrieval, svm, tv  # noqa: F401
    if name not in REGISTRY:
        raise NotImplementedError(
            f"problem {name!r} is not ported yet (ROADMAP Queue A items 2 "
            f"and 7); ported: {sorted(REGISTRY)}")
    return REGISTRY[name](**kwargs)
