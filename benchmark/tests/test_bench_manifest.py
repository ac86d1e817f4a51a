"""BENCHMARK.json and the files it names keep to the benchmark's contract:
every cell, configuration and per-layer metric has its file, and names and
units keep to their characters."""

import json
import os
import re

import pytest

from benchmark.harness import HERE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["benchmark"]
    assert m["command"][1] == "benchmark/run.py"
    assert 1 <= m["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units():
    m = manifest()
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in m[key]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names)) == len(names)
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"]), metric
        assert metric["better"] in ("lower", "higher")
    for cell in m["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        assert cell["chips"] in (1, 4)
        assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]


@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_cell_files(cell):
    m = manifest()
    entry = next(w for w in m["workloads"] if w["name"] == cell)
    with open(os.path.join(HERE, "workloads", f"{entry['traffic']}.json")) as f:
        workload = json.load(f)
    assert workload["config"] == entry["config"]
    assert workload["why"] == entry["why"]
    assert os.path.exists(os.path.join(HERE, "drivers",
                                       f"{workload['driver']}.py"))
    assert workload["limits"], "a cell compares at least one number"
    reported = [e for e in m["end_to_end"]
                if cell in e.get("workloads", [cell])]
    assert "setup_s" in [e["name"] for e in reported] and len(reported) >= 2
    assert any(cell in p.get("workloads", []) for p in m["per_layer"])


@pytest.mark.parametrize("config", [c["name"] for c in manifest()["configs"]])
def test_config_files(config):
    entry = next(c for c in manifest()["configs"] if c["name"] == config)
    assert entry["file"].startswith("benchmark/configs/")
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == config and cfg["reduced"] == entry["reduced"]
    assert all(key in cfg and key in cfg["published"]
               for key in entry["reduced"])


@pytest.mark.parametrize("metric", [p["name"] for p in manifest()["per_layer"]])
def test_metric_readers(metric):
    assert os.path.exists(os.path.join(HERE, "metrics", f"{metric}.py"))
    entry = next(p for p in manifest()["per_layer"] if p["name"] == metric)
    assert entry["moves"] in [e["name"] for e in manifest()["end_to_end"]]
    assert entry["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
