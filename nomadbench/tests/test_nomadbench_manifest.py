"""BENCHMARK.json keeps to its contract's names and shapes, and every
name in it finds its file: adding a configuration, a mix, a driver kind
or a metric takes new files and entries only."""

import importlib
import json
import re

from conftest import BENCH, ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_and_units_use_only_the_allowed_characters():
    named = (MANIFEST["configs"] + MANIFEST["workloads"]
             + MANIFEST["end_to_end"] + MANIFEST["per_layer"])
    for x in named:
        assert NAME.match(x["name"]), x["name"]
    for c in MANIFEST["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_files_under_the_benchmark_are_named_from_name_characters():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


def test_every_name_finds_its_file():
    for c in MANIFEST["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) == set(cfg["reduced"])
    for w in MANIFEST["workloads"]:
        assert (BENCH / "configs" / f"{w['config']}.json").exists()
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        importlib.import_module(f"nomadbench.drivers.{mix['driver']}")
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        if m["name"] != "setup_s":
            assert (BENCH / "metrics" / f"{m['name']}.py").exists()


def test_each_cell_reports_what_its_layer_metrics_move():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in moved.get("workloads", cells)
    for cell in cells:
        assert any(cell in m.get("workloads", cells)
                   for m in MANIFEST["end_to_end"] if m["name"] != "setup_s")
        assert any(cell in m["workloads"] for m in MANIFEST["per_layer"])
