"""Nothing the benchmark runs imports JAX or the JAX package, comparing
top-level module names whole (``fasta_tpu_torch`` is not ``fasta_tpu``);
the plain reference imports nothing of the program or of
``reference_oracle``; a run leaves none of them in ``sys.modules``."""

import ast
import json
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench import harness

PORTBENCH = ROOT / "portbench"
SOURCES = sorted(p for p in PORTBENCH.rglob("*.py")
                 if "tests" not in p.relative_to(PORTBENCH).parts)


def imported(path):
    """Top-level names a source imports; a relative import as '.'."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("." if node.level else node.module.split(".")[0])
    return out


def test_the_check_compares_whole_names():
    assert harness.FORBIDDEN_MODULES == ("jax", "jaxlib", "flax",
                                         "fasta_tpu")
    assert "fasta_tpu_torch" not in harness.FORBIDDEN_MODULES


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not imported(path) & set(harness.FORBIDDEN_MODULES)


def test_the_reference_imports_only_torch_and_itself():
    for path in (PORTBENCH / "reference").glob("*.py"):
        assert imported(path) <= {"__future__", "typing", "torch", "."}


def test_a_run_loads_no_forbidden_module():
    code = f"""
import sys, json
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(PORTBENCH / 'tests')!r})
import torch
from conftest import SMALL, small
from portbench import harness
import fasta_tpu_torch as ftt
name = "lasso-1000x2000.batch16384"
cell = small(harness.load_cell(harness.Path({str(ROOT)!r}), name),
             **SMALL[name])
s = harness.Session(cell, 5, "cpu", ftt, log=lambda t: None)
s.setup()
s.window(count=2)
print(json.dumps(harness.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
