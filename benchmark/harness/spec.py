"""A cell of ``BENCHMARK.json`` and the files the harness finds by name,
under the benchmark's folder: ``configs/<config>.json`` (by the entry's
``file``), ``traffic/<traffic>.json``, ``paths/<path>.py`` and
``drivers/<driver>.py`` (named by the traffic file),
``checks/<workload>.json`` and ``metrics/<metric>.py``.

A metric's name may carry a suffix after its first dot
(``frames_per_s.batch``): the part before it names the quantity, the whole
name the entry with its own bound or cells.  A metric reader is found by the whole name, else by
the part before the dot."""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def quantity(name: str) -> str:
    """The quantity a metric's name stands for: the part before its first
    dot."""
    return name.split(".")[0]


def load_module(kind: str, name: str, bench_dir: str = BENCH_DIR):
    """``<bench_dir>/<kind>/<name>.py`` as a module; for ``metrics``, the
    reader of the name's quantity where the whole name has none."""
    path = os.path.join(bench_dir, kind, f"{name}.py")
    if kind == "metrics" and not os.path.isfile(path):
        path = os.path.join(bench_dir, kind, f"{quantity(name)}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    bench_dir: str = BENCH_DIR

    def reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def module(self, kind: str, name: str):
        return load_module(kind, name, self.bench_dir)


def load_cell(name: str, bench_path: str = None) -> Cell:
    """The cell ``name`` of ``bench_path`` (the repo's ``BENCHMARK.json``),
    its files read from the ``benchmark/`` folder beside it."""
    bench_path = bench_path or os.path.join(ROOT, "BENCHMARK.json")
    root = os.path.dirname(os.path.abspath(bench_path))
    bench_dir = os.path.join(root, os.path.basename(BENCH_DIR))
    bench = _json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    cell = Cell(name, int(w["chips"]),
                _json(os.path.join(root, cfg["file"])),
                _json(os.path.join(bench_dir, "traffic",
                                   f"{w['traffic']}.json")),
                _json(os.path.join(bench_dir, "checks", f"{name}.json")),
                bench_dir=bench_dir)
    cell.end_to_end = [m for m in bench["end_to_end"] if cell.reports(m)]
    cell.per_layer = [m for m in bench["per_layer"] if cell.reports(m)]
    return cell
