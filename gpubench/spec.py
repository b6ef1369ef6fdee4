"""What one cell is: its entry in ``BENCHMARK.json`` and the files the
entry names, found by name.

- a configuration: ``BENCHMARK.json``'s ``configs[].file``;
- a traffic mix: ``gpubench/traffic/<traffic>.json``;
- a per-layer metric: ``gpubench/metrics/<name>.py`` with ``read(ctx)``;
- the limits of the comparison that decides ``correct``:
  ``gpubench/limits/<cell>.json``.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    limits: Dict


def load_json(path: str) -> Dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _reports(metric: Dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m
           or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    limits = load_json(os.path.join(HERE, "limits", name + ".json"))
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer,
                limits)


def reader(metric_name: str):
    """The ``read(ctx)`` of ``gpubench/metrics/<metric_name>.py``."""
    return importlib.import_module(f"gpubench.metrics.{metric_name}").read
