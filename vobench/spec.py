"""Finding a cell's parts by name: BENCHMARK.json's entry, its configuration
(configs/<name>.json), its traffic mix (traffic/<name>.json), the limits of
its output check (limits/<cell>.json) and the per-layer metrics
(metrics/<name>.py). A later cell or metric is a new file and a new entry,
never an edit of this module."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json
    limits: dict        # limits/<cell>.json: number -> limit
    end_to_end: list    # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: list     # and its per-layer metrics
    chips: int


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """Whether `cell` reports `metric` (a BENCHMARK.json metric entry)."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None, root: Path = HERE) -> Cell:
    """The cell `name` of BENCHMARK.json (or of `bench`), its files read from
    `root` (vobench/ by default)."""
    if bench is None:
        bench = _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(cells)}")
    w = cells[name]
    return Cell(
        name=name,
        config=_json(root / "configs" / f"{w['config']}.json"),
        traffic=_json(root / "traffic" / f"{w['traffic']}.json"),
        limits=_json(root / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)],
        chips=w["chips"],
    )


def metric_reader(name: str, root: Path = HERE):
    """metrics/<name>.py's read(record) -> value or None."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"vobench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def with_overrides(obj, data: dict):
    """A frozen dataclass (a Config) with `data`'s keys replaced, nested
    dataclasses by their own dicts; an unknown key raises."""
    kw = {}
    for key, value in data.items():
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur):
            value = with_overrides(cur, value)
        elif isinstance(cur, tuple) and isinstance(value, list):
            value = tuple(value)
        kw[key] = value
    return dataclasses.replace(obj, **kw)


def n_frames(config: dict) -> int:
    """The sequence's frames: start_frame .. end_frame, as the upstream
    config counts them."""
    p = config["pipeline"]
    return p["end_frame"] - p.get("start_frame", 0) + 1
