"""Every cell of BENCHMARK.json resolves to files of its own, and the file
keeps to the contract's shape rules."""

import json
import re

import pytest

from portbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    spec = harness.cell_spec(cell, BENCH)
    assert spec["config"]["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert (harness.HERE / "systems" / (spec["config"]["system"] + ".py")).exists()
    assert (harness.HERE / "reference" / (spec["config"]["reference"] + ".py")).exists()
    assert (harness.HERE / "traffic" / (spec["traffic"]["generator"] + ".py")).exists()
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert (harness.HERE / "metrics" / (m["name"] + ".py")).exists()
        assert m["moves"] in names
    assert set(spec["limits"]) >= {"dist_err", "rank_gap", "bad_ids", "missing"}


def test_names_units_and_bounds():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in seen
            seen.add(entry["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    data = harness.load_json(harness.ROOT / conf["file"])
    assert data["name"] == conf["name"] and data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"]
    assert data["assumed"]
