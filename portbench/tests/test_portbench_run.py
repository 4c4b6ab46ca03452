"""``portbench/run.py`` as the driver runs it: no result, and a non-zero
exit, without the cards the cell asks for or outside a whole checkout."""

import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

ARGS = ["--workload", "lasso-1000x2000.batch16384", "--seed",
        str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"]


def run(cwd):
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_without_a_card_there_is_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = run(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_an_unknown_workload_gives_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "no-such.cell", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
