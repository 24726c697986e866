"""``BENCHMARK.json`` keeps to the benchmark's contract, and every cell's
files are found by name."""

import json
import re

import pytest

from benchmark.harness import manifest as M

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
MAN = M.load_manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level():
    assert set(MAN) == TOP_KEYS
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


def test_names_units_and_lines():
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    for group in (MAN["configs"], MAN["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in MAN["configs"] + MAN["workloads"]:
        assert LINE.match(x["why"])
    for c in MAN["configs"]:
        assert LINE.match(c["source"]) and c["source"].startswith("https://")
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["reduced"] == []
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] == 1
    for m in MAN["per_layer"]:
        assert LINE.match(m["layer"]) and m["moves"] in {e["name"] for e in MAN["end_to_end"]}


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w = M.cell(MAN, cell)
    config = M.load_json("configs", w["config"])
    assert config["name"] == w["config"]
    assert {c["name"]: c["file"] for c in MAN["configs"]}[w["config"]] == f"benchmark/configs/{w['config']}.json"
    traffic = M.load_json("traffic", w["traffic"])
    driver = M.load_module("drivers", traffic["driver"])
    assert callable(driver.run)
    assert M.load_json("limits", cell)["limits"]
    e2e = M.metrics_of(MAN, cell, trace=False)
    layer = M.metrics_of(MAN, cell, trace=True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    for m in layer:
        assert callable(M.load_module("metrics", m["name"]).read)
        assert m["moves"] in {x["name"] for x in e2e}


def test_every_config_and_listed_cell_exists():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
