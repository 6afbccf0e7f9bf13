"""BENCHMARK.json and the files it names keep to the rules of the format:
names, units and lengths, every configuration, traffic and reader found
by name."""

import json
import re

import pytest

from mmfbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
BENCH = spec.benchmark()
ALL_METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["benchmark"]
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/")
        assert ".." not in word


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]]
                         + [w["name"] for w in BENCH["workloads"]]
                         + [m["name"] for m in ALL_METRICS]
                         + [w[k] for w in BENCH["workloads"]
                            for k in ("config", "traffic")]
                         + [k for c in BENCH["configs"]
                            for k in c["reduced"]])
def test_names(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", ALL_METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


def test_end_to_end():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names and len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_readers_and_moves():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert callable(spec.reader(m["name"]))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_name_is_unique():
    for group in (BENCH["configs"], BENCH["workloads"], ALL_METRICS):
        names = [g["name"] for g in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cells_load(cell):
    c = spec.cell(cell)
    w = {w["name"]: w for w in BENCH["workloads"]}[cell]
    assert c.chips == 1 and LINE.match(w["why"])
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert c.config["name"] == w["config"]
    assert set(c.config["limits"]) == {
        f"{n}.{k}" for n in ("gap", "gap_all")
        for k in ("start", "boundary", "interior")} | {"kept_changed"}
    assert c.config["limits"]["kept_changed"] == 0
    assert 0.0 <= c.config["trim"] < 0.01
    assert c.config["control"] in ("float32", "bf16_state")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entries(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    data = json.loads((spec.ROOT / entry["file"]).read_text())
    assert data["reduced"] == entry["reduced"] and len(entry["reduced"]) <= 16
    assert LINE.match(entry["source"]) and LINE.match(entry["why"])
    for key in entry["reduced"]:
        assert not key.endswith(("_dim", "_rank")) and key in data["run"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert entry["name"] in used
