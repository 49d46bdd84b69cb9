"""Finds a cell's pieces by the names in BENCHMARK.json.

- a configuration: rtbench/configs/<config>.json (the generator under
  rtbench/scenes/ and its parameters);
- a traffic mix: rtbench/traffic/<traffic>.json (read by workload.py);
- a per-layer metric: rtbench/metrics/<metric>.py, a `read(ctx)` that
  returns a number or None.

A new cell, configuration, mix or metric is a new entry and new files:
nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, here: Path = HERE) -> dict:
    with open(here / "configs" / f"{name}.json") as f:
        return json.load(f)


def traffic(name: str, here: Path = HERE) -> dict:
    with open(here / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metric_reader(name: str, here: Path = HERE):
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "rtbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell_name: str, trace: bool):
    """The metric entries a cell reports: end_to_end with --trace 0,
    per_layer with --trace 1 (an entry without "workloads" is reported by
    every cell that reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    out = []
    for m in bench["per_layer"]:
        ok = (cell_name in m["workloads"]) if "workloads" in m \
            else m["moves"] in names
        if ok:
            out.append(m)
    return out
