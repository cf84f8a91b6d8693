"""Find a cell and what belongs to it by name: its entry in ``BENCHMARK.json``,
its configuration (``benchmark/configs/<config>.json``), its traffic mix
(``benchmark/traffic/<traffic>.json``), its limits
(``benchmark/workloads/<cell>.json``) and the readers of its per-layer
metrics (``benchmark/metrics/<metric>.py``, each with ``read(ctx)``). A
later cell, configuration or metric is new files and new entries; no file
here names one."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reported(entries: list, cell: str, moved: set | None = None) -> list:
    """The metric entries a cell reports: those that list it under
    ``workloads``, and those without the key (for a per-layer metric: when
    the cell reports the end-to-end metric it ``moves``)."""
    out = []
    for e in entries:
        if "workloads" in e:
            if cell in e["workloads"]:
                out.append(e)
        elif moved is None or e.get("moves") in moved:
            out.append(e)
    return out


def load_cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    bench = _load(root / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = _load(here / "configs" / f"{entry['config']}.json")
    e2e = reported(bench["end_to_end"], name)
    return Cell(name=name, chips=entry["chips"], config=config,
                traffic=_load(here / "traffic" / f"{entry['traffic']}.json"),
                limits=_load(here / "workloads" / f"{name}.json")["limits"],
                end_to_end=e2e, per_layer=reported(bench["per_layer"], name, {e["name"] for e in e2e}))


def reader(metric: str, here: Path = HERE):
    """The ``read(ctx)`` of ``benchmark/metrics/<metric>.py``."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
