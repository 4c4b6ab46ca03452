"""The control of each cell comes out not correct: the reference in the
next precision below the configuration's in the program's place (TV:
bfloat16, on the CPU at a test's size), and the program's own TF32
products (LASSO: float32 with TF32 off; on the card only)."""

import pytest

import fasta_tpu_torch as ftt
from conftest import ROOT, small
from portbench import control, harness


def test_tv_bfloat16_control_fails(cells):
    cell = cells["tv-512x512.batch8"]
    assert cell.cfg["control"] == "bfloat16"
    r = control.readings(cell, 2 ** 31 + 7, "cpu", ftt, 2, 1, control=True)
    limits = cell.cfg["limits"]
    assert any(r[k] > limits[k] for k in limits)


@pytest.mark.cuda
def test_lasso_tf32_control_fails(card):
    cell = small(harness.load_cell(ROOT, "lasso-1000x2000.batch16384"),
                 batch=2048, pool=2)
    assert cell.cfg["control"] == "tf32"
    sound = control.readings(cell, 2 ** 31 + 7, card, ftt, 2, 64)
    low = control.readings(cell, 2 ** 31 + 7, card, ftt, 2, 64,
                           control=True)
    limits = cell.cfg["limits"]
    assert all(sound[k] <= limits[k] for k in limits)
    assert any(low[k] > limits[k] for k in limits)
