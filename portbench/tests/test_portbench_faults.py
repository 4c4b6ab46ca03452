"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have: a solve that returns its start
unchanged, half of each batch left out, an answer altered where it is
produced.  (One chip: no exchange between chips to leave out.)  The
harness's look for a chip is skipped; the rest of a run is driven on the
CPU at a test's size."""

import dataclasses

import pytest
import torch

import fasta_tpu_torch as ftt
from portbench import harness


def unchanged(x):
    return torch.zeros_like(x)          # every cell starts from zero


def half_left_out(x):
    x = x.clone()
    x[x.shape[0] // 2:] = 0
    return x


def altered(x):
    x = x.clone()
    x.reshape(x.shape[0], -1)[:, 0] += 0.5
    return x


def broken(fault):
    real = ftt.Problem.solve_serving

    def solve_serving(self, bs=None, **kwargs):
        out = real(self, bs, **kwargs)
        if isinstance(out, ftt.MicroBatchResult):
            return dataclasses.replace(out, solutions=fault(out.solutions))
        return out._replace(solution=fault(out.solution))
    return solve_serving


def correct(cell, seed):
    s = harness.Session(cell, seed, "cpu", ftt, log=lambda t: None)
    s.setup()
    s.window(count=2)
    checks, _ = s.judge()
    return harness.passed(checks)


NAMES = ["lasso-1000x2000.batch16384", "tv-512x512.batch8"]


@pytest.mark.parametrize("name", NAMES)
def test_a_sound_run_is_correct(cells, name):
    assert correct(cells[name], 2 ** 31 + 101)


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
@pytest.mark.parametrize("name", NAMES)
def test_a_broken_run_is_not_correct(cells, name, fault, monkeypatch):
    monkeypatch.setattr(ftt.Problem, "solve_serving", broken(fault))
    assert not correct(cells[name], 2 ** 31 + 101)
