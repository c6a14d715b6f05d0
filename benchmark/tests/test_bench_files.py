"""Every configuration, traffic mix, cell and metric of BENCHMARK.json
resolves to its files, and the file keeps to the benchmark's contract."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank|_size|channels|heads|expansion|hidden|intermediate|latent|"
                   r"state|projection|experts_per_tok)")


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and cfg["file"].startswith("benchmark/configs/")
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    assert not any(WIDTH.search(k) for k in cfg["reduced"])
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and len(cell["why"]) <= 200
    c = harness.Cell(cell["name"], ROOT)
    assert c.generator.exists() and c.chips in (1, 4)
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    assert all(m["moves"] in reported for m in c.per_layer)
    for m in c.metrics(False) + c.metrics(True):
        assert callable(c.reader(m["name"]).read)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (ROOT / "benchmark" / "metrics" / f"{metric['name']}.py").exists()
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        e2e = {m["name"]: m for m in BENCH["end_to_end"]}
        moved = e2e[metric["moves"]]
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))


def test_unique_names():
    for key in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_size_and_layers():
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    layers = {}
    for m in BENCH["per_layer"]:
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
