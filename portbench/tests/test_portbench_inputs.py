"""The inputs are made from the seed: the same seed gives the same
inputs, another seed others."""

import pytest
import torch

from conftest import ROOT, small
from portbench import harness


def inputs(cell, seed):
    gen = torch.Generator().manual_seed(seed % 2 ** 64)
    return harness.kind(cell.cfg).make_inputs(cell.cfg, cell.traffic, gen,
                                              "cpu")


@pytest.mark.parametrize("name", ["lasso-1000x2000.batch16384",
                                  "tv-512x512.batch8"])
def test_a_seed_repeats_and_seeds_differ(cells, name):
    cell = cells[name]
    a, b = inputs(cell, 2 ** 31 + 11), inputs(cell, 2 ** 31 + 11)
    c = inputs(cell, 2 ** 31 + 12)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k], c[k])
    tr = cell.traffic
    assert a["pool"].shape[:2] == (tr["pool"], tr["batch"])
    assert len({a["pool"][i].sum().item() for i in range(tr["pool"])}) == \
        tr["pool"]


def test_tv_images_lie_in_the_unit_range_before_noise():
    cell = small(harness.load_cell(ROOT, "tv-512x512.batch8"), h=64, w=64,
                 sigma=0.0, batch=4, pool=2)
    pool = inputs(cell, 3)["pool"]
    assert float(pool.amin()) == 0.0 and float(pool.amax()) == 1.0
    flat = pool.reshape(-1, 64 * 64)
    assert bool((flat.amax(dim=1) == 1.0).all())
