"""BENCHMARK.json and the files it names: every configuration, traffic
mix, driver, metric reader and limits file loads by name, and the
manifest keeps the contract's shape."""

from __future__ import annotations

import json
import re

import pytest

from portbench import compare, harness

MANIFEST = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in MANIFEST["configs"]] + CELLS
             + [m["name"] for m in METRICS])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in CELLS


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_moves_an_end_to_end_metric_of_its_cells():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert harness.applies(moved, w), (m["name"], w)
        assert "\n" not in m["layer"] and 0 < len(m["layer"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c, cfg, traffic = harness.find_cell(MANIFEST, cell)
    assert c["chips"] == 1 and len(c["why"]) <= 200
    assert harness.load_driver(traffic) is not None
    limits = compare.load_limits(cell)
    assert limits and all(v >= 0 for v in limits.values())
    e2e = [m for m in MANIFEST["end_to_end"] if harness.applies(m, cell)]
    per_layer = [m for m in MANIFEST["per_layer"]
                 if harness.applies(m, cell)]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    MANIFEST["per_layer"]])
def test_metric_reader_loads(metric):
    assert callable(harness.metric_reader(metric).read)


@pytest.mark.parametrize("config", MANIFEST["configs"],
                         ids=lambda c: c["name"])
def test_config_names_its_source_cuts_and_assumptions(config):
    with open(harness.ROOT / config["file"]) as f:
        cfg = json.load(f)
    assert config["file"].startswith("portbench/configs/")
    assert "arXiv:1903.08114" in cfg["source"]
    assert cfg["reduced"] == config["reduced"]
    for key in cfg["reduced"]:
        assert cfg[key] != cfg["published"][key]
    for key, v in cfg["published"].items():
        if key not in cfg["reduced"] and key in cfg:
            assert cfg[key] == v, key
    assert cfg["assumed"]
