"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
runs the cell's driver once, reads the per-layer metrics, and builds the
result line.

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own, found by name under ``portbench/``:

- ``configs/<config>.json`` (the manifest's ``file``): the model's sizes;
- ``traffic/<traffic>.json``: the mix's parameters, whose ``driver`` key
  names the driver, ``drivers/<driver>.py`` (``run(cell) -> Run``);
- ``limits/<cell>.json``: each compared number's limit;
- ``metrics/<metric>.py``: a per-layer metric's reader,
  ``read(run) -> float | None`` (None: nothing to read, left out).

A new cell, configuration, mix or metric is new files and manifest
entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional, Tuple

MANIFEST = "BENCHMARK.json"
# Top-level module names that may not be loaded in the process that
# prints a result: JAX and the JAX package the program was ported from.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_operator")


@dataclasses.dataclass
class Cell:
    """One cell as its files give it (``overrides`` merged in: the tests'
    CPU forms at tiny sizes)."""

    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    manifest: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: str
    clock_start: float  # perf_counter() at the process's start
    root: Path


@dataclasses.dataclass
class Run:
    """What a driver hands back. ``end_to_end``: host-clock metrics by
    name; ``checks``: {number: value} compared against the cell's limits;
    ``data``: what the per-layer readers take (the driver's own keys);
    ``trace``: the reduced profiler window (``profiling.reduce``)."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: Dict[str, float]
    memory_peak_bytes: int
    device_kind: str
    device_count: int
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)
    trace: Optional[Dict[str, Any]] = None
    counters: Dict[str, Any] = dataclasses.field(default_factory=dict)


def load_json(path: Path) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
         device: str, clock_start: float,
         overrides: Optional[Dict[str, Dict]] = None) -> Cell:
    """The cell ``name`` of ``root``'s manifest with its files read."""
    root = Path(root)
    manifest = load_json(root / MANIFEST)
    work = {w["name"]: w for w in manifest["workloads"]}.get(name)
    if work is None:
        raise KeyError(f"no workload {name!r} in {root / MANIFEST}")
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[work["config"]]
    overrides = overrides or {}
    bench = root / "portbench"
    config = {**load_json(root / cfg_entry["file"]),
              **overrides.get("config", {})}
    traffic = {**load_json(bench / "traffic" / f"{work['traffic']}.json"),
               **overrides.get("traffic", {})}
    limits = load_json(bench / "limits" / f"{name}.json")
    return Cell(name, work, config, traffic, limits, manifest, int(seed),
                float(seconds), bool(trace), device, clock_start, root)


def metric_names(c: Cell) -> Tuple[List[Dict], List[Dict]]:
    """The cell's end-to-end metrics (those that list it or list no cells)
    and its per-layer metrics (those that list it: each lists its cells)."""
    e2e = [m for m in c.manifest["end_to_end"]
           if c.name in m.get("workloads", [c.name])]
    layers = [m for m in c.manifest["per_layer"] if c.name in m["workloads"]]
    return e2e, layers


def run_cell(c: Cell) -> Tuple[Dict[str, Any], Run]:
    """Run the cell's driver once and build its result line."""
    root_bench = c.root / "portbench"
    driver = load_module(root_bench / "drivers" / f"{c.traffic['driver']}.py",
                         f"portbench_driver_{c.traffic['driver']}")
    run: Run = driver.run(c)
    e2e, layers = metric_names(c)
    metrics: Dict[str, Dict[str, Any]] = {}
    if not c.trace:
        for m in e2e:
            if m["name"] not in run.end_to_end:
                raise KeyError(f"the {c.traffic['driver']} driver gave no "
                               f"{m['name']}")
            value = run.end_to_end[m["name"]]
            # A latency with requests missing is infinite, which JSON
            # cannot carry: null (the run's ``failed`` says why).
            metrics[m["name"]] = {"value": value if math.isfinite(value)
                                  else None, "unit": m["unit"]}
    else:
        for m in layers:
            reader = load_module(root_bench / "metrics" / f"{m['name']}.py",
                                 "portbench_metric_" + m["name"].replace(
                                     ".", "_"))
            value = reader.read(run)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": v, "limit": c.limits[k]}
              for k, v in run.checks.items()}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    device = {"platform": "gpu" if c.device == "cuda" else c.device,
              "kind": run.device_kind, "count": run.device_count,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    line: Dict[str, Any] = {"correct": bool(correct),
                            "attempted": int(run.attempted),
                            "failed": int(run.failed),
                            "metrics": metrics, "device": device}
    if c.trace and run.trace is not None:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        line["breakdown"] = {"device_ops": run.trace["device_ops"],
                             "idle_gaps": run.trace["idle_gaps"]}
    if run.counters:
        line["counters"] = run.counters
    line["checks"] = checks
    return line, run


def forbidden_loaded() -> List[str]:
    """Loaded top-level module names that are JAX's or the JAX package's,
    compared whole (``tpu_operator_torch`` is not ``tpu_operator``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def check_lines(line: Dict[str, Any]) -> List[str]:
    """The compared numbers beside their limits, one a line."""
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in line["checks"].items()]
