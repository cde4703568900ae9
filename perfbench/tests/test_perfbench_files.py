"""Every file under configs/, workloads/ and metrics/ loads by the name
BENCHMARK.json gives it, and agrees with it."""

import json
import os
import re

import pytest

from perfbench import run as bench

ROOT = bench.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_loads_by_name(cfg):
    data = bench.load_json("configs", f"{cfg['name']}.json")
    assert cfg["file"] == f"perfbench/configs/{cfg['name']}.json"
    assert data["name"] == cfg["name"]
    assert data["source"] == cfg["source"] and data["reduced"] == cfg["reduced"]
    assert isinstance(data["sizes"], dict) and data["assumed"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_workload_loads_by_name(cell):
    spec, cfg = bench.cell_spec(cell["name"])
    assert spec["config"] == cell["config"] and spec["why"] == cell["why"]
    assert cell["traffic"] == cell["name"].split(".", 1)[1]
    entry = bench.load_module("entries", spec["entry"])
    assert set(spec["limits"]) == set(entry.NUMBERS)
    assert all(0 < v < 1 for v in spec["limits"].values())
    assert cell["chips"] == 1


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_loads_by_name(metric):
    mod = bench.load_module("metrics", metric["name"])
    assert callable(mod.read) and mod.__doc__.startswith(f"``{metric['name']}``")
    assert f"({metric['unit']})" in mod.__doc__
    if "moves" in metric:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        cells = {c["name"] for c in BENCH["workloads"]}
        assert set(metric["workloads"]) <= cells


def test_names_and_limits_of_the_contract():
    names = ([c["name"] for c in BENCH["configs"]]
             + [c["name"] for c in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert 1 <= BENCH["run_seconds"] <= 51
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
