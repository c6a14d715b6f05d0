"""Runs one cell of the benchmark once and prints its result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a configuration
(``configs/<name>.json``, the model sizes and settings) under a traffic mix
(``traffic/<name>.json``, the parameters that the generator named by its
``kind``, ``generators/<kind>.py``, reads).  The generator sets the system
up, drives it through the window and checks what it produced against the
plain reference; it returns its raw readings.  Each metric is a reader of
its own, ``metrics/<name>.py``, found by the metric's name in
``BENCHMARK.json``: ``read(readings)`` returns a number, or None where it
finds nothing to read, and the metric is then left out of the line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_module(path: Path):
    """A module from a file, by path (names may hold dots and dashes)."""
    spec = importlib.util.spec_from_file_location(f"_bench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic and metrics."""

    def __init__(self, name: str, root: Path):
        self.root = root
        bench = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
        self.workload = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(root / configs[self.workload["config"]]["file"])
        self.traffic = load_json(root / "benchmark" / "traffic" / f"{self.workload['traffic']}.json")
        self.generator = root / "benchmark" / "generators" / f"{self.traffic['kind']}.py"
        self.chips = int(self.workload["chips"])
        e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in e2e}
        self.end_to_end = e2e
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name] if m["moves"] in reported else [])]

    def metrics(self, trace: bool):
        return self.per_layer if trace else self.end_to_end

    def reader(self, metric_name: str):
        return load_module(self.root / "benchmark" / "metrics" / f"{metric_name}.py")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, root: Path = HERE.parent,
             device=None, t_start: float = None) -> dict:
    """One run of a cell -> the result (with ``notes``, which ``main``
    prints apart).  ``device``: the card (default ``cuda:0``); the CPU tests
    pass the CPU."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(workload, root)
    device = torch.device("cuda", 0) if device is None else device
    gen = load_module(cell.generator)
    readings = gen.run(cell, int(seed), float(seconds), bool(trace), device, t_start)
    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"]).read(readings)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    compared = readings["compared"]
    correct = bool(readings["correct"]) and all(c["value"] <= c["limit"] for c in compared.values())
    result = {"correct": correct, "attempted": int(readings["attempted"]),
              "failed": int(readings["failed"]), "metrics": metrics,
              "device": readings["device"]}
    if trace and readings.get("breakdown"):
        result["breakdown"] = readings["breakdown"]
    result["notes"] = readings.get("notes", {})
    result["compared"] = compared
    return result


def set_cache_dirs(root: Path):
    """Every compile cache of the run at a fixed path inside the checkout."""
    cache = root / "build" / "bench-cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")


def main(argv=None, t_start: float = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = HERE.parent
    set_cache_dirs(root)
    from . import guard

    guard.check("start")
    cell = Cell(args.workload, root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), root,
                      t_start=t_start)
    guard.check("after the window")
    print(f"notes: {json.dumps(result.pop('notes'))}", file=sys.stderr)
    result["compared"] = result.pop("compared")
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
