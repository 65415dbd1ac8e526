"""BENCHMARK.json parses, and every name in it finds its file."""

import json
import re

import pytest

from port_bench import manifest
from port_bench.manifest import Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def m():
    return Manifest.load()


def test_top_level_keys(m):
    assert set(m.data) == {"command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"}
    assert m.data["paths"] == ["port_bench"]
    assert 1 <= m.data["run_seconds"] <= 51
    assert len(json.dumps(m.data)) < 64 * 1024


def test_cells_find_their_files(m):
    for cell in m.cells:
        w = m.cell(cell)
        assert NAME.match(cell) and w["chips"] in (1, 4)
        assert 0 < len(w["why"]) <= 200
        config = m.config(w["config"])
        traffic = m.traffic(w["traffic"])
        assert config["name"] == w["config"]
        assert traffic["kind"] in ("train", "serve")
        assert set(m.configs[w["config"]]["reduced"]) <= set(config)
    pairs = [(w["config"], w["traffic"]) for w in m.data["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_unknown_cell_is_named(m):
    with pytest.raises(KeyError, match="no workload"):
        m.cell("no-such-cell")


def test_every_config_is_used(m):
    used = {w["config"] for w in m.data["workloads"]}
    assert used == set(m.configs)


def test_metrics(m):
    names = [x["name"] for x in m.data["end_to_end"] + m.data["per_layer"]]
    assert len(names) == len(set(names))
    for x in m.data["end_to_end"] + m.data["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
        assert x["source"] in SOURCES
        assert set(x.get("workloads", m.cells)) <= set(m.cells)
    for x in m.data["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    e2e = {x["name"] for x in m.data["end_to_end"]}
    for x in m.data["per_layer"]:
        assert x["moves"] in e2e and "\n" not in x["layer"]
        for cell in x["workloads"]:
            assert x["moves"] in {e["name"] for e in m.end_to_end(cell)}


@pytest.mark.parametrize("name", [x["name"] for x in json.load(open(
    manifest.ROOT / "BENCHMARK.json"))["per_layer"]])
def test_each_per_layer_metric_has_a_reader(name):
    assert callable(manifest.reader(name))


def test_every_cell_reports_setup_another_metric_and_a_layer(m):
    for cell in m.cells:
        e2e = {x["name"] for x in m.end_to_end(cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert m.per_layer(cell)


def test_a_reader_returns_none_without_its_kernel():
    from port_bench.trace import Trace
    tr = Trace([{"ph": "X", "cat": "user_annotation",
                 "name": "port_bench.window", "ts": 0, "dur": 100}])
    ctx = {"kind": "train", "trace": tr, "steps_traced": 8,
           "traffic": {"batch": 256},
           "config": json.load(open(manifest.HERE / "configs"
                                    / "posepriornet.json"))}
    for name in ("k1_roofline.train", "k2_roofline.train",
                 "k3_roofline.train"):
        assert manifest.reader(name)(ctx) is None
