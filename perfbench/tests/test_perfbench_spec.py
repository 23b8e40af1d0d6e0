"""The benchmark's files are found by their names, and a new one is picked up
without an edit."""
from __future__ import annotations

import json
import os
import re

from perfbench_tiny import ROOT, tiny_root

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_file_is_found_by_name():
    spec = _spec()
    for w in spec["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell["config"]["name"] == w["config"]
        assert cell["traffic"]["read_len"] > 0
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert callable(harness.metric_module(ROOT, m["name"]).read)
    for c in spec["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.metric_module(ROOT, m["name"]).read)


def test_a_new_traffic_file_is_picked_up_without_an_edit(tmp_path):
    root = tiny_root(tmp_path)
    with open(os.path.join(root, "perfbench/traffic/pe150-k10m.json")) as f:
        tr = json.load(f)
    tr["insert_mean"] = 500
    with open(os.path.join(root, "perfbench/traffic/pe150-wide.json"), "w") as f:
        json.dump(tr, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["workloads"].append(dict(name="ecoli.pe150.wide", config="ecoli-k12",
                                  traffic="pe150-wide", chips=1, why="test"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    cell = harness.load_cell("ecoli.pe150.wide", root)
    assert cell["traffic"]["insert_mean"] == 500
    # a metric without a workloads list follows the end-to-end metric it moves
    assert {m["name"] for m in cell["end_to_end"]} == {"setup_s"}


def test_benchmark_json_keeps_to_its_shape():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
    cfgs = {c["name"] for c in spec["configs"]}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            reports = e2e[m["moves"]].get("workloads")
            assert reports is None or w in reports
    cells = {w["name"] for w in spec["workloads"]}
    for w in cells:
        cell = harness.load_cell(w)
        assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
