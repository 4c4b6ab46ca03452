"""Problem suite of the port (port of ``problems/__init__.py``): the dense
problems LASSO, NNLS, sparse logistic regression and the SVM, and TV
denoising; the other problems come with their terms (ROADMAP Queue A
items 7 and 10)."""

from typing import Callable, Dict

REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        REGISTRY[name] = fn
        return fn
    return deco


def build(name: str, **kwargs):
    """Construct a named problem instance:
    ``build('lasso', m=..., device=...)``."""
    from . import lasso, logistic, nnls, svm, tv  # noqa: F401
    if name not in REGISTRY:
        raise NotImplementedError(
            f"problem {name!r} is not ported yet (ROADMAP Queue A items 7 "
            f"and 10); ported: {sorted(REGISTRY)}")
    return REGISTRY[name](**kwargs)
