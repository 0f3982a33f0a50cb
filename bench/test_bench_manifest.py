"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name: configurations, traffic mixes, the numbers that
decide ``correct`` and one reader per metric. Also the import boundary:
nothing under ``bench/`` imports JAX or the JAX package (top-level names
compared whole), the reference imports nothing of the program, and only
``harness/program.py`` imports the port."""
import ast
import json
import os
import re
import sys

import pytest

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)

from harness import judge, manifest  # noqa: E402
from harness.cell import Run  # noqa: E402
from traffic import generate  # noqa: E402

MAN = manifest.load(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["bench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert all(LINE.match(w) for w in MAN["command"])
    assert not any(os.path.isabs(w) or ".." in w for w in MAN["command"])
    assert len(json.dumps(MAN)) < 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in MAN["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w["traffic"] for w in MAN["workloads"]]
             + [k for c in MAN["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    for group in ([c["name"] for c in MAN["configs"]], CELLS,
                  [m["name"] for m in METRICS]):
        assert len(group) == len(set(group))
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in MAN["configs"]]
                 + [c["source"] for c in MAN["configs"]]
                 + [w["why"] for w in MAN["workloads"]]
                 + [m["layer"] for m in MAN["per_layer"]]):
        assert LINE.match(text), text


def test_metrics_keys_and_bounds():
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25
               for m in MAN["end_to_end"])
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        moved = next(x for x in MAN["end_to_end"] if x["name"] == m["moves"])
        for cell in m.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in manifest.metrics(MAN, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.metrics(MAN, cell, True)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry = manifest.cell(MAN, cell)
    assert entry["chips"] in (1, 4)
    cfg = manifest.config(MAN, entry, ROOT)
    assert cfg["name"] == entry["config"]
    mix = generate.load(entry["traffic"])
    assert mix["kind"] in ("images", "tokens")
    limits = judge.load_limits(cell)
    assert limits and all(v > 0 for v in limits.values())


def test_config_files():
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["file"].startswith("bench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["deployment"]


@pytest.mark.parametrize("name", [m["name"] for m in METRICS])
def test_metric_reader_found_and_silent_without_data(name):
    read = manifest.reader(name)
    cfg = manifest.config(MAN, manifest.cell(MAN, CELLS[0]), ROOT)
    run = Run(cfg, generate.load(manifest.cell(MAN, CELLS[0])["traffic"]), 1)
    value = read(run)
    # an empty run holds nothing to read but the set-up time
    assert value is None or name == "setup_s"


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                out.add(node.module.split(".")[0])
    return out


def _sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    for path in _sources():
        bad = _imports(path) & {"jax", "jaxlib", "flax", "repro"}
        assert not bad, (path, bad)


def test_only_the_adapter_imports_the_port():
    users = {os.path.relpath(p, BENCH) for p in _sources()
             if "repro_torch" in _imports(p)}
    assert users == {os.path.join("harness", "program.py")}


def test_reference_stands_alone():
    for path in _sources():
        rel = os.path.relpath(path, BENCH)
        if rel.startswith("reference" + os.sep):
            assert _imports(path) <= {"__future__", "importlib", "math",
                                      "dataclasses", "typing", "numpy",
                                      "torch", "reference"}, rel
