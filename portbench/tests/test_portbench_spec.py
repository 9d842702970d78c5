"""``BENCHMARK.json`` keeps the contract's shape, and every cell,
configuration and metric resolves from its own file; a new cell is files
and entries alone."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import check, spec
from portbench.reference.training import model_module
from portbench.tests.conftest import ROOT, run_small, small_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configs_cells_and_metrics_are_well_formed():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert (ROOT / c["file"]).is_file()
        assert _line(c["why"]) and _line(c["source"])
        assert c["reduced"] == []
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and _line(w["why"])
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"setup_s", "fold_epochs_per_s", "peak_mem_gib"} <= e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    assert "kernels" in layers and "train step" in layers


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_from_its_files(name):
    cell = spec.cell(name)
    assert cell.config["reference"] and cell.traffic["protocol"]
    assert {"loss1", "nonfinite"} <= set(cell.limits) <= set(check.NUMBERS)
    assert cell.limits["nonfinite"] == 0
    mod = model_module(cell.config["reference"])
    assert mod.train_step_flops(cell.config, 64) > 0
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}


@pytest.mark.parametrize("name", METRICS)
def test_metric_resolves_to_a_reader(name):
    assert callable(spec.reader(name))


def test_a_new_cell_is_files_and_entries_alone(tmp_path):
    """``eegnet.within36`` from a copy: one new limits file and new JSON
    entries; every file the benchmark has stays byte for byte."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "eegnet.within36", "config": "eegnet", "traffic": "within36",
        "chips": 1, "why": "36 within-subject folds of EEGNet"})
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("eegnet.within36")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(ROOT / "portbench/limits/eegnet.cross90.json",
                tmp_path / "portbench/limits/eegnet.within36.json")

    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "portbench").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        Path("portbench/limits/eegnet.within36.json")}

    cell = small_cell("eegnet.within36", tmp_path)
    assert cell.config["model"] == "eegnet"
    assert cell.traffic["protocol"] == "within_subject"
    assert {m["name"] for m in cell.per_layer} == set(METRICS)
    result, _ = run_small(cell, 20_231_018)
    assert result["correct"], result["compared"]
    assert result["attempted"] == 8
