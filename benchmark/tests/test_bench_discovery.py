"""BENCHMARK.json against the benchmark's contract, and every config,
mix, loop, generator, limit file and metric reader found by its name."""

import json
import os
import re

import pytest

from benchmark import harness

SPEC = harness.load_json(harness.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
E2E = {m["name"] for m in SPEC["end_to_end"]}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|head")


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(harness.ROOT,
                                        "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entry_and_file(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(config["name"]) and line(config["why"])
    assert line(config["source"])
    assert config["file"].startswith("benchmark/configs/")
    body = harness.load_json(harness.ROOT, config["file"])
    assert body["name"] == config["name"]
    assert len(config["reduced"]) <= 16
    for key in config["reduced"]:
        assert NAME.match(key) and not WIDTH.search(key)
        assert key in body and key in body["reduced"]
    assert set(body["reduced"]) == set(config["reduced"])
    assert harness.load_module("gen", body["generator"]).generate
    assert body["value_type"] in ("float32", "float64")
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files_and_metrics(cell):
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and line(w["why"])
    cs = harness.cell_spec(cell)
    assert cs["config"]["name"] == w["config"]
    loop = harness.load_module("loops", cs["mix"]["loop"])
    assert hasattr(loop, "Loop")
    assert all(isinstance(v, (int, float)) for v in cs["limits"].values())
    e2e = {m["name"] for m in cs["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cs["per_layer"]
    for m in cs["per_layer"]:
        assert m["moves"] in e2e


def test_pairs_of_config_and_traffic_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(CELLS) == len(set(CELLS))


@pytest.mark.parametrize("m", SPEC["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) <= {"name", "unit", "better", "bound", "source",
                      "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    assert line(m["layer"]) and m["moves"] in E2E
    assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert callable(harness.metric_reader(m["name"]).read)
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"


def test_layers_are_named_alike():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert len({s.lower() for s in layers}) == len(layers)


def test_metric_names_are_unique():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        harness.cell_spec("no-such-cell")
    with pytest.raises(FileNotFoundError):
        harness.load_module("metrics", "no_such_metric")


def test_a_split_metric_is_read_by_its_quantity():
    base = harness.metric_reader("device.idle_pct")
    assert harness.metric_reader("device.idle_pct.cg").__file__ \
        == base.__file__
    with pytest.raises(FileNotFoundError):
        harness.metric_reader("no_such_metric.cg")


def test_a_spec_given_in_place_of_the_file_is_read():
    spec = json.loads(json.dumps(SPEC))
    spec["per_layer"] = [m for m in spec["per_layer"]
                         if m["name"] == "tune.preproc_s"]
    cs = harness.cell_spec(CELLS[0], spec)
    assert [m["name"] for m in cs["per_layer"]] == ["tune.preproc_s"]
