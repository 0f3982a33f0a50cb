"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (its ``file``), its traffic mix (``traffic/<traffic>.json``),
the numbers that decide ``correct`` (``checks/<cell>.json``) and one
reader per metric (``metrics/<metric>.py``, whose ``read(run)`` returns
the value or None when the run holds nothing to read).
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Dict, List

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(manifest: Dict, name: str) -> Dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: Dict, cell_entry: Dict, root: str = ROOT) -> Dict:
    entry = next(c for c in manifest["configs"]
                 if c["name"] == cell_entry["config"])
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def metrics(manifest: Dict, cell_name: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones: each entry with no ``workloads`` key or with the cell in it."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]


def reader_path(name: str) -> str:
    return os.path.join(BENCH, "metrics", f"{name}.py")


def reader(name: str):
    """The ``read`` function of metric ``name``'s own file."""
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + re.sub(r"\W", "_", name), reader_path(name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
