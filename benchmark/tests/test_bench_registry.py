"""BENCHMARK.json and the files it names: every cell, configuration,
mix, metric and limit is found by name, and the file keeps the
benchmark's contract."""
import json
import re
from pathlib import Path

import pytest

import harness
import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_bounds_and_window(bench):
    assert 1 <= bench["run_seconds"] <= 51
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert [m["bound"] for m in bench["end_to_end"]
            if m["name"] == "setup_s"] == [0.25]
    # a full check of 24 cells fits its 43,200 seconds
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_cell_reports(bench, kind):
    for w in bench["workloads"]:
        names = run.metric_names(bench, w, kind)
        if kind == "end_to_end":
            assert "setup_s" in names and len(names) >= 2
        else:
            assert names


def test_files_found_by_name(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        _, work, config, mix = run.cell(ROOT, w["name"])
        runner = run.runner_class(mix)
        for method in ("unit", "traced_unit", "attempted", "end_to_end",
                       "free_program", "checks", "layer_context",
                       "calibration"):
            assert callable(getattr(runner, method)), method
        file = configs[w["config"]]["file"]
        assert file.startswith("benchmark/configs/")
        assert config["source"] == configs[w["config"]]["source"]
        assert config["reduced"] == configs[w["config"]]["reduced"]
        limits = harness.load_limits(BENCH, w["name"])
        assert limits
    for m in bench["per_layer"]:
        path = BENCH / "metrics" / f"{m['name']}.py"
        assert path.is_file(), path
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_reduced_keys_exist(bench):
    """Each key `reduced` names is a path into its configuration file."""
    for c in bench["configs"]:
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        for key in c["reduced"]:
            node = cfg
            for part in key.split("."):
                node = node[part]
            assert node == 0.0, key
