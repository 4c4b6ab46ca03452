"""The benchmark's tests run from the root of the checkout
(``python -m pytest portbench/tests``); they import ``portbench`` and the
program from there, and need no card unless marked ``cuda``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small(cell, **sizes):
    """``cell`` with its configuration and traffic cut to a CPU test's
    sizes: the configuration's keys among ``sizes`` go to the
    configuration, the rest to the traffic."""
    cfg = {k: v for k, v in sizes.items() if k in cell.cfg}
    tr = {k: v for k, v in sizes.items() if k not in cell.cfg}
    return cell._replace(cfg=dict(cell.cfg, **cfg),
                         traffic=dict(cell.traffic, **tr))


# A CPU test's cut of each cell: LASSO keeps the batch route at 120
# unknowns, TV needs 2 × 128 × 128 = 32768 unknowns for the kernel route
SMALL = {
    "lasso-1000x2000.batch16384": dict(m=60, n=120, k=6, batch=64, pool=4,
                                       kept_requests=4, kept_per_request=4,
                                       traced_requests=1),
    "tv-512x512.batch8": dict(h=128, w=128, batch=2, pool=2,
                              kept_requests=2, kept_per_request=1,
                              traced_requests=1),
}


@pytest.fixture
def cells():
    from portbench import harness
    return {name: small(harness.load_cell(ROOT, name), **sizes)
            for name, sizes in SMALL.items()}


@pytest.fixture
def card():
    """Skips the test without a CUDA device."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
