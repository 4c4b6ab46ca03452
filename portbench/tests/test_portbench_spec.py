"""BENCHMARK.json and the files it names: every configuration, traffic mix
and per-layer metric loads by name, and the file keeps the contract's
shapes."""

import json
import re

import pytest

from conftest import ROOT
from portbench import harness

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KIND_FUNCTIONS = ("make_inputs", "problem", "reference_inputs",
                  "reference_solve", "judge")


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_loads_by_name(workload):
    cell = harness.load_cell(ROOT, workload)
    kind = harness.kind(cell.cfg)
    assert all(callable(getattr(kind, f)) for f in KIND_FUNCTIONS)
    assert cell.traffic["name"] == workload.split(".", 1)[1]
    assert {m["name"] for m in cell.end_to_end} == {
        "solves_per_s", "request_ms_p95", "setup_s"}
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]).read)
    assert set(cell.cfg["limits"]) <= set(cell.cfg) | {
        "solution_rel_dist", "objective_rel_gap", "iteration_gap",
        "image_max_dist", "dual_objective_rel_gap"}


def test_configs_name_their_files_and_sources():
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert c["file"].startswith("portbench/configs/")


def test_names_units_and_keys_keep_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    configs = {c["name"] for c in SPEC["configs"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["better"] in ("higher", "lower")
        assert set(m["workloads"]) <= {w["name"] for w in SPEC["workloads"]}
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_an_unknown_workload_is_refused():
    with pytest.raises(SystemExit, match="no workload"):
        harness.load_cell(ROOT, "no-such.cell")
