"""Fixtures of the benchmark's CPU tests: a tiny copy of each cell (a few
hundred nodes, the same drivers and metric readers) that runs the whole
harness on the port's plain CPU versions in seconds."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "nomadbench"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Tiny cells, one a driver kind: name -> (config, mix, config overrides,
# mix overrides). Only update50k-roll is a cell of BENCHMARK.json today;
# the others keep every driver and reader tested for the cells that
# PERF.md keeps for later.
TINY = {
    "batch10k-waves": ("nomad-10k", "batch-waves", {"nodes.count": 200},
                       {"tasks_per_job": 250, "jobs_per_wave": 4}),
    "service10k-open": ("nomad-10k", "service-open", {"nodes.count": 200},
                        {"rate_per_s": 8.0, "warmup_s": 0.5,
                         "lifetime_mean_s": 0.5, "count.max": 60,
                         "prefill.tasks_per_job": 100}),
    "update50k-roll": ("nomad-50k", "update-roll",
                       {"nodes.count": 400, "job.count": 60,
                        "job.max_parallel": 20, "stagger_s": 0.1}, {}),
    "update50k-inplace": ("nomad-50k", "update-inplace",
                          {"nodes.count": 400, "job.count": 60,
                           "job.max_parallel": 20, "stagger_s": 0.1}, {}),
}
# Every metric reader and the tiny cells it reads in.
WAVES, SERVICE, ROLL, INPLACE = TINY
METRICS = {
    "end_to_end": {
        "placements_per_s": (WAVES, ROLL),
        "eval_p50_ms": (WAVES, SERVICE, INPLACE),
        "eval_p95_ms": (SERVICE,),
        "stop_p95_ms": (SERVICE,),
        "setup_s": (WAVES, SERVICE, ROLL, INPLACE),
    },
    "per_layer": {
        "broker_wait_ms.service": (SERVICE,),
        "handoff_ms.batch": (WAVES,),
        "plan_apply_ms.service": (SERVICE,),
        "stop_apply_ms.batch": (WAVES,),
        "staging_ms.update": (ROLL,),
        "verify_ms.update": (ROLL,),
        "fsm_apply_ms.inplace": (INPLACE,),
        "dispatch_width.batch": (WAVES,),
        "waterfill_roofline_pct": (WAVES, ROLL),
        "greedy_roofline_pct": (SERVICE,),
        "device_idle_pct.batch": (WAVES,),
        "device_idle_pct.service": (SERVICE,),
        "device_idle_pct.update": (ROLL,),
    },
}
SOURCES = {"setup_s": "host_clock", "placements_per_s": "host_clock",
           "dispatch_width.batch": "program_counter"}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")


def _override(doc: dict, changes: dict) -> dict:
    for dotted, value in changes.items():
        node = doc
        *path, last = dotted.split(".")
        for key in path:
            node = node[key]
        node[last] = value
    return doc


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(manifest, base dir) of the tiny cells."""
    base = tmp_path_factory.mktemp("tiny")
    (base / "configs").mkdir()
    (base / "traffic").mkdir()
    (base / "metrics").symlink_to(BENCH / "metrics")
    cells = []
    for name, (config, mix, cfg_over, mix_over) in TINY.items():
        cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
        traffic = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
        (base / "configs" / f"tiny-{name}.json").write_text(
            json.dumps(_override(cfg, cfg_over)))
        (base / "traffic" / f"tiny-{name}.json").write_text(
            json.dumps(_override(traffic, mix_over)))
        cells.append({"name": name, "config": f"tiny-{name}",
                      "traffic": f"tiny-{name}", "chips": 1, "why": "tiny"})
    manifest = {"workloads": cells}
    for group, metrics in METRICS.items():
        manifest[group] = [
            {"name": m, "unit": "x", "better": "lower",
             "source": SOURCES.get(m, "device_trace" if "pct" in m
                                   else "program_span"),
             "workloads": list(on)} for m, on in metrics.items()]
    return manifest, base
