"""One run of one cell: build the system from the cell's configuration,
set up and warm up through the cell's driver, measure for ``seconds``,
then judge what the window committed with the plain reference and read
the cell's metrics.

Everything that belongs to one configuration, traffic mix or metric is
found by name: ``configs/<config>.json``, ``traffic/<mix>.json`` (whose
``driver`` names ``drivers/<kind>.py``), ``metrics/<metric>.py``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import cluster, observe, reference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"
# The tracer's ring in a traced run: every eval of a window fits.
TRACE_MAX_TRACES = 200_000
TRACE_MAX_SPANS = 4096
FORBIDDEN = ("jax", "jaxlib", "flax", "nomad_tpu")


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_of(manifest: dict, name: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str, base: Path = HERE) -> dict:
    with open(base / kind / f"{name}.json") as f:
        return json.load(f)


def load_driver(kind: str):
    return importlib.import_module(f"nomadbench.drivers.{kind}")


def load_reader(name: str, base: Path = HERE):
    """The reader of one metric: ``metrics/<name>.py``'s ``read(run)``."""
    path = base / "metrics" / f"{name}.py"
    mod_name = "nomadbench.metrics._" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(manifest: dict, cell: str, traced: bool) -> List[dict]:
    """The cell's end-to-end metrics (untraced) or per-layer ones."""
    group = manifest["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    """Top-level module names, compared whole, that the benchmark may not
    hold: jax, jaxlib, flax and the JAX package."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Run:
    """What one run hands its cell's driver and metric readers."""

    def __init__(self, cell: dict, cfg: dict, traffic: dict, seed: int,
                 seconds: float, traced: bool, device: str):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.seconds = float(seconds)
        self.traced = traced
        self.device = device
        self.srv = None
        self.records: List[dict] = []
        # (snapshot, {job id: spec}, [eval status]) judged after the window.
        self.samples: List[tuple] = []
        # (snapshot before, snapshot after, job id, [eval id], destructive)
        # of an update, judged by its diff after the window.
        self.diffs: List[tuple] = []
        self.extra_checks: Dict[str, tuple] = {}
        self.counters: Dict[str, float] = {}
        self.t0 = self.t_close = 0.0
        self.launches = None
        self.devtrace = None
        self._spans: Dict[str, List[dict]] = {}
        self._allocs: Dict[tuple, list] = {}
        self.state: dict = {}

    # -- for drivers ---------------------------------------------------------

    def record(self, **fields) -> dict:
        rec = dict(kind="", group=None, due=0.0, sent=None, done=None,
                   status="", eval_id="", job_id="", placed=0,
                   in_window=True)
        rec.update(fields)
        self.records.append(rec)
        return rec

    def job_id(self, prefix: str) -> str:
        return f"{prefix}-{int(self.rng.integers(1 << 62)):016x}"

    def live_allocs(self, snap, job_id: str) -> List[tuple]:
        """``observe.live_allocs`` of a snapshot, read once (after the
        window: it spells out every id)."""
        key = (id(snap), job_id)
        if key not in self._allocs:
            self._allocs[key] = observe.live_allocs(snap, job_id)
        return self._allocs[key]

    # -- for readers ---------------------------------------------------------

    @property
    def window_s(self) -> float:
        return self.t_close - self.t0

    def window_records(self, kind: str) -> List[dict]:
        return [r for r in self.records if r["kind"] == kind
                and r["in_window"]]

    def spans(self, eval_id: str) -> List[dict]:
        if eval_id not in self._spans:
            from nomad_tpu_torch import trace

            self._spans[eval_id] = trace.get_tracer().get_trace(eval_id) or []
        return self._spans[eval_id]


def judge(run: Run) -> Dict[str, tuple]:
    """Every number compared, with its limit: the reference's counts over
    each sampled state (summed), and the driver's own."""
    table = reference.NodeTable(run.cfg)
    totals = dict.fromkeys(reference.LIMITS, 0)
    for snap, jobs, statuses in run.samples:
        got = reference.judge(table, jobs, observe.live_rows(snap), statuses)
        for k, v in got.items():
            totals[k] += v
    for before, after, job_id, evals, destructive in run.diffs:
        got = reference.judge_update(
            (aid for aid, _e in run.live_allocs(before, job_id)),
            run.live_allocs(after, job_id), evals, destructive)
        for k, v in got.items():
            totals[k] += v
    out = {k: (v, reference.LIMITS[k]) for k, v in totals.items()}
    out.update(run.extra_checks)
    return out


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool,
             device: str, t_start: float, manifest: Optional[dict] = None,
             base: Path = HERE, plant=None) -> dict:
    """One run; returns the result line as a dict. ``t_start`` is the
    time.monotonic() that set-up counts from; ``plant`` (a context
    manager factory of ``faults``) breaks the timed path underneath."""
    manifest = manifest or load_manifest()
    cell = cell_of(manifest, cell_name)
    cfg = load_json("configs", cell["config"], base)
    traffic = load_json("traffic", cell["traffic"], base)
    driver = load_driver(traffic["driver"])
    run = Run(cell, cfg, traffic, seed, seconds, traced, device)
    if traced:
        from nomad_tpu_torch import trace

        trace.configure(max_traces=TRACE_MAX_TRACES,
                        max_spans=TRACE_MAX_SPANS)
    data_dir = tempfile.mkdtemp(prefix="nomadbench-raft-")
    io0 = _io_written()
    try:
        run.srv = cluster.start_server(cfg, device, data_dir, seed)
        run.srv.node_batch_register(cluster.build_nodes(cfg))
        driver.setup(run)
        _sync(device)
        setup_s = time.monotonic() - t_start
        with (plant(run) if plant is not None else _nothing()):
            _window(run, driver)
        peak = _memory_peak(device)
        checks = judge(run)
    finally:
        if run.srv is not None:
            cluster.shutdown(run.srv)
        disk = _dir_bytes(data_dir)
        shutil.rmtree(data_dir, ignore_errors=True)
    run.counters["journal_bytes"] = disk
    run.counters["written_bytes"] = _io_written() - io0
    metrics = {}
    for m in metrics_for(manifest, cell_name, traced):
        if m["name"] == "setup_s":
            value = setup_s
        else:
            value = load_reader(m["name"], base)(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    attempted = sum(1 for r in run.records if r["in_window"])
    failed = sum(1 for r in run.records if r["in_window"]
                 and (r["done"] is None or r["status"] != "complete"))
    correct = all(v <= limit for v, limit in checks.values())
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": _device(device, peak)}
    if traced and run.devtrace is not None:
        dt = run.devtrace
        result["device"]["busy_s"] = dt.busy_s()
        result["device"]["window_s"] = dt.window_s
        spans = [s for r in run.records if r["eval_id"]
                 for s in run.spans(r["eval_id"])]
        result["breakdown"] = {"device_ops": dt.device_ops(),
                               "idle_gaps": dt.idle_gaps(spans)}
    result["window"] = {"seconds": run.window_s, "steps_s": _steps(run),
                        "journal_bytes": disk,
                        "written_bytes": run.counters["written_bytes"],
                        **{k: v for k, v in run.counters.items()
                           if k.startswith(("generator_", "gc_"))}}
    result["checks"] = {k: {"value": v, "limit": limit}
                        for k, (v, limit) in checks.items()}
    return result


class _GCPauses:
    """Counts the interpreter's collections and their pause inside the
    window (every thread of the process stops for each)."""

    def __init__(self):
        self.n = [0, 0, 0]
        self.pause_s = 0.0
        self._t = 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.n[info["generation"]] += 1
            self.pause_s += time.perf_counter() - self._t


def _window(run: Run, driver) -> None:
    from nomad_tpu_torch.ops import greedy, waterfill

    from . import devtrace

    before = (waterfill.LAUNCHES, greedy.LAUNCHES)
    pauses = _GCPauses()
    gc.callbacks.append(pauses)
    if run.traced:
        cuda = run.device.startswith("cuda")
        run.launches = devtrace.LaunchLog(cuda)
        run.launches.__enter__()
        if cuda:
            run.devtrace = devtrace.DeviceTrace(run.launches.side)
            run.devtrace.start()
    try:
        run.t0 = time.perf_counter()
        run.t_close = driver.window(run, run.t0, run.seconds)
        if run.devtrace is not None:
            run.devtrace.stop()
    finally:
        gc.callbacks.remove(pauses)
        if run.traced:
            run.launches.__exit__(None, None, None)
    run.counters["gc_collections"] = pauses.n
    run.counters["gc_pause_s"] = pauses.pause_s
    run.counters["waterfill_launches"] = waterfill.LAUNCHES - before[0]
    run.counters["greedy_launches"] = greedy.LAUNCHES - before[1]
    driver.finish(run)


def _steps(run: Run) -> List[float]:
    """Seconds of each step of a closed loop (a wave, a roll, an update),
    first due to last done, in order; none for an open loop."""
    spans: Dict[object, list] = {}
    for r in run.records:
        if r["in_window"] and r["group"] is not None and r["done"]:
            lo, hi = spans.get(r["group"], (r["due"], r["done"]))
            spans[r["group"]] = (min(lo, r["due"]), max(hi, r["done"]))
    return [round(hi - lo, 4) for _g, (lo, hi) in sorted(spans.items())]


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def _memory_peak(device: str) -> int:
    if device.startswith("cuda"):
        import torch

        return int(torch.cuda.max_memory_allocated())
    return 0


def _device(device: str, peak: int) -> dict:
    import torch

    if device.startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": peak}


def _io_written() -> int:
    """Bytes this process has written (``/proc/self/io`` wchar), or 0
    where the kernel does not say."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


def _dir_bytes(path: str) -> int:
    total = 0
    for dirpath, _dirs, files in os.walk(path):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(dirpath, name))
            except OSError:
                pass
    return total
