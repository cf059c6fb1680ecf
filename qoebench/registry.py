"""Everything the harness runs is found by name: a cell in BENCHMARK.json
names a configuration and a traffic mix, and each of those, each cell's
correctness limit and each per-layer metric is a file of its own under
this folder. Adding one is adding a file (README.md)."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent


def benchmark(root: Path) -> dict:
    """BENCHMARK.json at the root of the checkout."""
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found: run from the checkout's "
                                "root")
    return json.loads(path.read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def _json(base: Path, folder: str, name: str) -> dict:
    path = Path(base) / folder / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder[:-1]} file {path}")
    return json.loads(path.read_text())


def config(name: str, base: Path = HERE) -> dict:
    """configs/<name>.json: the model, its serving settings, its source."""
    return _json(base, "configs", name)


def traffic(name: str, base: Path = HERE) -> dict:
    """traffic/<name>.json: the mix's parameters for frozen.workload."""
    return _json(base, "traffic", name)


def cell(name: str, base: Path = HERE) -> dict:
    """cells/<workload>.json: the cell's correctness sample and limits."""
    return _json(base, "cells", name)


def metric(name: str, base: Path = HERE) -> ModuleType:
    """The reader of a per-layer metric: ``metrics/<name>.py`` or, where
    there is none, the reader of the quantity the name splits (the name
    up to its last dot: ``device_idle.serve`` reads ``device_idle.py``).
    A reader defines NAME (its file's), UNIT, LAYER and
    read(record) -> float | None; what a metric moves is its entry's
    ``moves`` in BENCHMARK.json."""
    stem = name
    path = Path(base) / "metrics" / f"{stem}.py"
    while not path.is_file() and "." in stem:
        stem = stem.rsplit(".", 1)[0]
        path = Path(base) / "metrics" / f"{stem}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no metric file for {name!r} under "
                                f"{Path(base) / 'metrics'}")
    spec = importlib.util.spec_from_file_location(
        f"qoebench_metric_{stem.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if getattr(mod, "NAME", None) != stem:
        raise ValueError(f"{path} defines NAME {getattr(mod, 'NAME', None)!r}")
    return mod


def per_layer_for(bench: dict, cell_name: str) -> List[dict]:
    """The per-layer entries a cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_for(bench, cell_name)}
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e:
            out.append(m)
    return out


def end_to_end_for(bench: dict, cell_name: str) -> List[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def read_metrics(entries: List[dict], record: dict,
                 base: Path = HERE) -> Dict[str, dict]:
    """Each entry's reader over the run's record; a reader that finds
    nothing to read returns None and its metric is left out."""
    out = {}
    for m in entries:
        value = metric(m["name"], base).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
