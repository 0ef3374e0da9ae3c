"""BENCHMARK.json and the files it names: every configuration, traffic mix,
cell and per-layer metric is found by its name and parses; names, units
and words keep to the contract's characters; a new cell and metric need
only new files and entries."""

import json
import os
import re
import shutil

import pytest

import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "nkbench/run.py"]
    assert b["paths"] == ["nkbench"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_words(key):
    b = bench()
    names = [e["name"] for e in b[key]]
    assert len(names) == len(set(names))
    for e in b[key]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for w in ("why", "layer", "source"):
            if w in e and key in ("configs", "workloads", "per_layer"):
                assert 1 <= len(e[w]) <= 200 and "\n" not in e[w] and "\t" not in e[w]


def test_every_cell_loads_by_name():
    b = bench()
    for w in b["workloads"]:
        assert w["chips"] == 1
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        spec = harness.load_cell(w["name"])
        assert spec.config["name"] == w["config"]
        assert spec.traffic["particles"] > 0
        assert set(spec.limits) == set(harness_numbers())
        assert {m["name"] for m in spec.end_to_end} == {"updates_per_s", "setup_s"}
        assert len(spec.per_layer) == 6 and all(callable(r) for r in spec.readers.values())


def harness_numbers():
    from reference.check import NUMBERS

    return NUMBERS


def test_configs_name_their_files():
    b = bench()
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for c in b["configs"]:
        assert c["file"].startswith("nkbench/configs/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert {"source", "assumed", "args", "material"} <= set(cfg)


def test_metrics_and_bounds():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert os.path.exists(os.path.join(harness.BENCH, "metrics", m["name"] + ".py"))


def test_a_new_cell_and_metric_are_only_new_files(tmp_path):
    """A temporary copy with one more traffic mix, cell, limits file and
    per-layer metric: the harness finds them by name, no file edited."""
    copy = tmp_path / "co"
    shutil.copytree(harness.BENCH, copy / "nkbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy / "BENCHMARK.json")
    b = json.loads((copy / "BENCHMARK.json").read_text())
    (copy / "nkbench/traffic/n2e6.json").write_text(json.dumps({"particles": 2000000, "pool_margin": 1.25}))
    (copy / "nkbench/workloads/film-2e6.json").write_text(
        (copy / "nkbench/workloads/film-1e6.json").read_text())
    (copy / "nkbench/metrics/driver.observe_ms.py").write_text(
        "def read(ctx):\n    ts = ctx.phases.get('host_observe', [])\n"
        "    return 1e3 * sum(ts) / len(ts) if ts else None\n")
    b["workloads"].append({"name": "film-2e6", "config": "si_film", "traffic": "n2e6", "chips": 1,
                           "why": "a dummy"})
    b["per_layer"].append({"name": "driver.observe_ms", "unit": "ms", "better": "lower",
                           "source": "program_span", "layer": "driver", "moves": "updates_per_s",
                           "workloads": ["film-2e6"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(b))
    spec = harness.load_cell("film-2e6", root=str(copy))
    assert spec.traffic["particles"] == 2000000
    assert [m["name"] for m in spec.per_layer] == ["driver.observe_ms"]
    ctx = type("C", (), {"phases": {"host_observe": [0.002, 0.004]}})()
    assert spec.readers["driver.observe_ms"](ctx) == pytest.approx(3.0)
    assert harness.load_cell("film-1e6", root=str(copy)).traffic["particles"] == 1000000
