"""The port's SLO layer and lifecycle timelines against nomad_tpu's.

Each piece gets the same inputs in both packages, made from a seed:

- ``telemetry.AggregateSample`` and ``BurnRateWindow`` (the aggregates
  the SLO monitor, the express lane and the read books keep): the same
  samples give the same mean, quantiles and burn-rate stats;
- ``slo``: objective parsing (and its errors), ``SLOMonitor`` fed the
  same event stream (snapshot, burn rate, summary, the warmup reset),
  ``evaluate_artifact`` and ``evaluate_read_lanes`` over seeded sections;
- ``lifecycle``: ``scan_events``, ``stitch`` and ``attribution`` over
  seeded synthetic spans and anchors, and over the events and spans of a
  real run of the port's ``Server``; the port's one stage of its own,
  ``broker_delay`` (a delayed eval's ``broker.delay``), reads 0 where no
  eval carries that span and takes the stagger out of ``unattributed``
  where one does.

Tolerance: exact. These are host computations on identical inputs (at
most 256 samples per aggregate, so no reservoir draw is involved); the
``broker_delay`` case compares sums of differently grouped floats, to
``pytest.approx``'s default relative 1e-6.
"""

import random

import pytest
import torch

from nomad_tpu import lifecycle as jlc
from nomad_tpu import slo as jslo
from nomad_tpu import telemetry as jtel
from nomad_tpu.events import Event as JaxEvent
from nomad_tpu.events import EventBroker as JaxBroker
from nomad_tpu_torch import lifecycle as plc
from nomad_tpu_torch import mock, structs
from nomad_tpu_torch import slo as pslo
from nomad_tpu_torch import telemetry as ptel
from nomad_tpu_torch import trace
from nomad_tpu_torch.events import Event as PortEvent
from nomad_tpu_torch.events import EventBroker as PortBroker
from nomad_tpu_torch.server.server import Server, ServerConfig

torch.set_num_threads(2)

SEEDS = [0, 3, 11, 42]


# -- telemetry aggregates -----------------------------------------------------


def samples(seed, n):
    rng = random.Random(seed)
    return [rng.expovariate(0.02) for _ in range(n)]


@pytest.mark.parametrize("n", [0, 1, 2, 17, 256])
@pytest.mark.parametrize("seed", SEEDS)
def test_aggregate_sample_equals_reference(seed, n):
    ref, got = jtel.AggregateSample(), ptel.AggregateSample()
    for v in samples(seed, n):
        ref.ingest(v)
        got.ingest(v)
    assert (got.count, got.sum, got.min, got.max) == \
        (ref.count, ref.sum, ref.min, ref.max)
    assert got.mean == ref.mean and got.stddev == ref.stddev
    assert got.quantiles() == ref.quantiles()
    assert got.reservoir == ref.reservoir


@pytest.mark.parametrize("objective", [0.5, 0.95, 0.99])
@pytest.mark.parametrize("seed", SEEDS)
def test_burn_rate_window_equals_reference(seed, objective):
    rng = random.Random(seed)
    ref = jtel.BurnRateWindow(window_s=60.0, objective=objective,
                              max_samples=300)
    got = ptel.BurnRateWindow(window_s=60.0, objective=objective,
                              max_samples=300)
    t = 0.0
    for _ in range(500):
        t += rng.random()
        good = rng.random() < 0.93
        ref.record(good, t=t)
        got.record(good, t=t)
        if rng.random() < 0.05:
            assert got.stats(now=t) == ref.stats(now=t)
    for now in (t, t + 30.0, t + 120.0):
        assert got.stats(now=now) == ref.stats(now=now)


@pytest.mark.parametrize("objective", [0.0, 1.0, 1.5])
def test_burn_rate_window_refuses_what_reference_refuses(objective):
    with pytest.raises(ValueError) as ref:
        jtel.BurnRateWindow(objective=objective)
    with pytest.raises(ValueError) as got:
        ptel.BurnRateWindow(objective=objective)
    assert str(got.value) == str(ref.value)


# -- objectives ---------------------------------------------------------------


@pytest.mark.parametrize("name, ms", [
    ("submit_to_placed_p95_ms", 250),
    ("submit_to_running_p50_ms", 1000.0),
    ("express_placed_p50_ms", 1.0),
    ("express_placed_p99_ms", 3),
    ("submit_to_placed_p100_ms", 250),
    ("submit_to_placed_p0_ms", 250),
    ("bogus_metric_p95_ms", 250),
    ("submit_to_placed_95", 250),
    ("submit_to_placed_p95_ms", 0),
    ("submit_to_placed_p95_ms", -3),
])
def test_objective_parse_equals_reference(name, ms):
    try:
        ref = jslo.Objective.parse(name, ms)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pslo.Objective.parse(name, ms)
        assert str(got.value) == str(e)
        return
    got = pslo.Objective.parse(name, ms)
    assert (got.name, got.metric, got.percentile, got.threshold_ms,
            got.window_s) == (ref.name, ref.metric, ref.percentile,
                              ref.threshold_ms, ref.window_s)


def test_objective_tables_equal_reference():
    assert pslo.METRICS == jslo.METRICS
    assert pslo.DEFAULT_OBJECTIVES == jslo.DEFAULT_OBJECTIVES
    assert pslo.EXPRESS_OBJECTIVES == jslo.EXPRESS_OBJECTIVES
    assert pslo.SCENARIO_OBJECTIVES == jslo.SCENARIO_OBJECTIVES
    assert pslo.READ_LANE_OBJECTIVES == jslo.READ_LANE_OBJECTIVES
    for spec in (None, {}, {"express_placed_p50_ms": 1.0,
                            "submit_to_placed_p99_ms": 40}):
        got = [(o.name, o.percentile, o.threshold_ms)
               for o in pslo.parse_objectives(spec, 60.0)]
        ref = [(o.name, o.percentile, o.threshold_ms)
               for o in jslo.parse_objectives(spec, 60.0)]
        assert got == ref


# -- the live monitor ---------------------------------------------------------


def event_pair(index, topic, etype, key, payload, t):
    """One event in each package with the same fields and wall stamp."""
    ref = JaxEvent(index, topic, etype, key=key, payload=dict(payload))
    got = PortEvent(index, topic, etype, key=key, payload=dict(payload))
    ref.time = got.time = t
    return ref, got


def lifecycle_stream(seed, n_evals=40):
    """Seeded submit -> placed -> running streams for ``n_evals`` evals,
    express placements and noise, as (reference events, port events)."""
    rng = random.Random(seed)
    rows = []
    t0 = 1_700_000_000.0
    for k in range(n_evals):
        key = f"ev-{seed}-{k}"
        t = t0 + rng.random() * 20.0
        rows.append(("Eval", "EvalUpdated", key,
                     {"status": structs.EVAL_STATUS_PENDING,
                      "job_id": f"job-{k}", "triggered_by": "job-register"},
                     t))
        if rng.random() < 0.9:
            t_placed = t + rng.expovariate(1 / 0.2)
            rows.append(("Plan", "PlanApplied", key, {}, t_placed))
            if rng.random() < 0.6:
                rows.append(("Alloc", "AllocClientUpdated", f"a-{k}",
                             {"eval_id": key,
                              "client_status":
                                  structs.ALLOC_CLIENT_STATUS_RUNNING},
                             t_placed + rng.expovariate(1 / 0.5)))
        if rng.random() < 0.3:
            rows.append(("Express", "ExpressPlaced", f"x-{k}",
                         {"job_id": f"xjob-{k}", "tasks": 1,
                          "placed_ms": round(rng.random() * 2.0, 4)},
                         t + rng.random()))
        if rng.random() < 0.2:
            rows.append(("Node", "NodeRegistered", f"n-{k}", {}, t))
    rows.sort(key=lambda r: r[4])
    pairs = [event_pair(i + 1, *row) for i, row in enumerate(rows)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def monitors(objectives=None):
    ref = jslo.SLOMonitor(JaxBroker(register=False), objectives)
    got = pslo.SLOMonitor(PortBroker(register=False), objectives)
    return ref, got


@pytest.mark.parametrize("objectives", [
    None,
    {"submit_to_placed_p95_ms": 150, "express_placed_p50_ms": 1.0},
    {"submit_to_running_p50_ms": 400, "submit_to_placed_p99_ms": 900},
])
@pytest.mark.parametrize("seed", SEEDS)
def test_slo_monitor_snapshot_equals_reference(seed, objectives):
    ref_events, port_events = lifecycle_stream(seed)
    ref, got = monitors(objectives)
    half = len(ref_events) // 2
    ref.observe(ref_events[:half])
    got.observe(port_events[:half])
    assert got.snapshot() == ref.snapshot()
    ref.observe(ref_events[half:])
    got.observe(port_events[half:])
    assert got.snapshot() == ref.snapshot()
    assert got.summary() == ref.summary()
    for metric in pslo.METRICS:
        assert got.burn_rate(metric) == ref.burn_rate(metric)


@pytest.mark.parametrize("seed", SEEDS)
def test_slo_monitor_reset_equals_reference(seed):
    """The warmup boundary: both monitors drain their brokers, wipe the
    books and count what they excluded; later samples land alike."""
    ref_events, port_events = lifecycle_stream(seed)
    ref, got = monitors()
    ref.observe(ref_events[:20])
    got.observe(port_events[:20])
    ref.reset()
    got.reset()
    assert got.snapshot() == ref.snapshot()
    ref.observe(ref_events[20:])
    got.observe(port_events[20:])
    assert got.snapshot() == ref.snapshot()


def test_slo_monitor_polls_its_broker():
    """The monitor's thread consumes its own event ring."""
    broker = PortBroker(register=False)
    mon = pslo.SLOMonitor(broker, poll_interval=0.01)
    broker.publish("Eval", "EvalUpdated", key="e1",
                   payload={"status": structs.EVAL_STATUS_PENDING})
    broker.publish("Plan", "PlanApplied", key="e1")
    mon.poll()
    snap = mon.snapshot()
    assert snap["samples"]["submit_to_placed"]["count"] == 1
    assert snap["pending_evals"] == 0


# -- offline verdicts ---------------------------------------------------------


def attribution_section(seed):
    rng = random.Random(seed)

    def block():
        n = rng.choice([0, 1, 12, 300])
        vals = sorted(rng.expovariate(0.01) for _ in range(3))
        return {"n": n, "p50_ms": round(vals[0], 2),
                "p95_ms": round(vals[1], 2), "p99_ms": round(vals[2], 2)}

    out = {"submit_to_placed_ms": block(),
           "submit_to_running_ms": block()}
    if rng.random() < 0.5:
        out["express_placed_ms"] = block()
    return out


@pytest.mark.parametrize("objectives", [
    None, pslo.EXPRESS_OBJECTIVES,
    {"submit_to_placed_p90_ms": 100, "submit_to_running_p97_ms": 300},
    {"submit_to_placed_p99_ms": 50},
])
@pytest.mark.parametrize("seed", SEEDS)
def test_evaluate_artifact_equals_reference(seed, objectives):
    att = attribution_section(seed)
    assert (pslo.evaluate_artifact(att, objectives)
            == jslo.evaluate_artifact(att, objectives))


def lanes_artifact(seed):
    rng = random.Random(seed)
    if rng.random() < 0.15:
        return {"reads": {"lanes": {"enabled": False, "members": 3}}}
    lanes = {
        "enabled": True,
        "members": rng.choice([1, 3]),
        "follower_serve_share": round(rng.random(), 4),
        "stale_bound_ms": rng.choice([None, 0, 5000.0]),
        "stale_age_ms": rng.choice([{"n": 0},
                                    {"n": 9, "p95": rng.random() * 7000}]),
        "linear_violations": rng.choice([None, 0, 2]),
        "stamp_missing": rng.choice([None, 0, 1]),
    }
    return {"reads": {"lanes": lanes}}


@pytest.mark.parametrize("objectives", [None,
                                        {"follower_serve_share_min": 0.5}])
@pytest.mark.parametrize("seed", range(8))
def test_evaluate_read_lanes_equals_reference(seed, objectives):
    art = lanes_artifact(seed)
    assert (pslo.evaluate_read_lanes(art, objectives)
            == jslo.evaluate_read_lanes(art, objectives))


def test_evaluate_read_lanes_without_lanes_is_empty():
    assert pslo.evaluate_read_lanes({}) == jslo.evaluate_read_lanes({}) == []


# -- lifecycle timelines ------------------------------------------------------


class SpanTable:
    """A tracer stand-in: eval id -> span dicts (tracer.get_trace shape)."""

    def __init__(self, spans):
        self.spans = spans

    def get_trace(self, eval_id):
        return self.spans.get(eval_id)


SPAN_NAMES = ("broker.wait", "worker.wait_for_index",
              "worker.invoke_scheduler", "solver.staging", "solver.execute",
              "worker.submit_plan", "plan.queue_wait", "plan.evaluate",
              "plan.apply", "express.pick", "express.lease",
              "express.commit")


def synthetic_spans(ref_events, seed):
    """Seeded span trees for the evals of a stream: the root, the broker
    wait, one or more scheduler attempts with nested plan stages (some
    bounced), and express stages for express keys; some spans open."""
    rng = random.Random(seed)
    out = {}
    for e in ref_events:
        if e.type not in ("EvalUpdated", "ExpressPlaced") or e.key in out:
            continue
        if rng.random() < 0.15:
            continue  # trace evicted: the timeline degrades
        t = e.time
        spans = [{"name": "eval", "start": t, "end": t + 2.0,
                  "annotations": {"job_id": "j", "type": "batch",
                                  "triggered_by": "job-register"}}]
        for name in SPAN_NAMES:
            for _ in range(rng.choice([0, 1, 1, 2])):
                start = t + rng.random() * 0.5
                end = (None if rng.random() < 0.05
                       else start + rng.random() * 0.2)
                ann = ({"refresh_index": rng.choice([0, 0, 7])}
                       if name == "plan.evaluate" else {})
                spans.append({"name": name, "start": start, "end": end,
                              "annotations": ann})
        out[e.key] = spans
    return out


def timelines_dict(tls):
    return {k: v.to_dict() for k, v in sorted(tls.items())}


def without_delay(att):
    """The port's attribution less its ``broker_delay`` row, the one stage
    nomad_tpu has not: it reads 0 where no eval carries a broker.delay."""
    rows = [r for r in att["waterfall"] if r["stage"] == "broker_delay"]
    assert all(r["total_ms"] == 0.0 for r in rows), rows
    return dict(att, waterfall=[r for r in att["waterfall"]
                                if r["stage"] != "broker_delay"])


@pytest.mark.parametrize("seed", SEEDS)
def test_scan_events_equals_reference(seed):
    ref_events, port_events = lifecycle_stream(seed)
    assert plc.scan_events(port_events) == jlc.scan_events(ref_events)
    dicts = [e.to_dict() for e in ref_events]
    assert plc.scan_events(dicts) == jlc.scan_events(dicts)


@pytest.mark.parametrize("seed", SEEDS)
def test_stitch_and_attribution_equal_reference(seed):
    ref_events, port_events = lifecycle_stream(seed)
    table = SpanTable(synthetic_spans(ref_events, seed))
    got = plc.stitch(port_events, tracer=table)
    ref = jlc.stitch(ref_events, tracer=table)
    assert timelines_dict(got) == timelines_dict(ref)
    assert (without_delay(plc.attribution(got.values()))
            == jlc.attribution(ref.values()))
    assert plc.worst_k(got.values(), 5) == jlc.worst_k(ref.values(), 5)
    assert plc.STAGES == ("broker_delay",) + jlc.STAGES
    assert plc.STAGE_KINDS == {**jlc.STAGE_KINDS, "broker_delay": "queue"}


@pytest.mark.parametrize("seed", SEEDS)
def test_broker_delay_takes_the_stagger_out_of_unattributed(seed):
    """Delayed evals (a roll's rounds): the port puts each one's
    broker.delay in ``broker_delay``, where nomad_tpu leaves it in
    ``unattributed``; every other stage is the same, and the stage sums
    still reconcile with submit->placed."""
    rng = random.Random(seed)
    rows, spans = [], {}
    for k in range(12):
        key = f"round-{seed}-{k}"
        t = 1_700_000_000.0 + 2.0 * k
        wait = rng.choice([0.5, 1.0])
        ready = t + wait + rng.random() * 0.001
        start = ready + rng.random() * 0.002
        end = start + 0.02 + rng.random() * 0.1
        rows.append(("Eval", "EvalUpdated", key,
                     {"status": structs.EVAL_STATUS_PENDING,
                      "job_id": "job-roll",
                      "triggered_by": "rolling-update"}, t))
        rows.append(("Plan", "PlanApplied", key, {}, end + 0.001))
        spans[key] = [
            {"name": "eval", "start": t, "end": end + 0.002,
             "annotations": {"job_id": "job-roll", "type": "service",
                             "triggered_by": "rolling-update"}},
            {"name": "broker.delay", "start": t, "end": ready,
             "annotations": {"wait_s": wait}},
            {"name": "broker.wait", "start": ready, "end": start,
             "annotations": {}},
            {"name": "worker.invoke_scheduler", "start": start,
             "end": end, "annotations": {}},
        ]
    pairs = [event_pair(i + 1, *row) for i, row in enumerate(rows)]
    table = SpanTable(spans)
    got = plc.stitch([p[1] for p in pairs], tracer=table)
    ref = jlc.stitch([p[0] for p in pairs], tracer=table)
    assert set(got) == set(ref) == set(spans)
    for key, tl in got.items():
        delay = next(s for s in spans[key] if s["name"] == "broker.delay")
        delay_ms = (delay["end"] - delay["start"]) * 1000.0
        mine, theirs = tl.stage_ms, ref[key].stage_ms
        assert mine["broker_delay"] == pytest.approx(delay_ms)
        assert mine["unattributed"] == pytest.approx(
            theirs["unattributed"] - delay_ms)
        assert {k: v for k, v in mine.items()
                if k not in ("broker_delay", "unattributed")} == {
            k: v for k, v in theirs.items() if k != "unattributed"}
        assert sum(mine.values()) == pytest.approx(tl.submit_to_placed_ms)
    att = plc.attribution(got.values())
    rows = {r["stage"]: r for r in att["waterfall"]}
    assert [r["stage"] for r in att["waterfall"]] == list(plc.STAGES)
    assert rows["broker_delay"]["kind"] == "queue"
    assert rows["broker_delay"]["share"] > rows["unattributed"]["share"]
    assert att["reconciliation"]["attributed_fraction"] == pytest.approx(
        1.0, abs=1e-3)


def test_attribution_of_nothing_equals_reference():
    assert plc.attribution([]) == jlc.attribution([])


def test_real_run_stitches_like_reference():
    """The events and spans of a real run of the port's Server (one
    worker, host scheduler) stitch to the same timelines in both
    packages: the port's span names and event payloads are the ones
    nomad_tpu's stitcher reads."""
    srv = Server(ServerConfig(device="cpu", scheduler_workers=1,
                              scheduler_backend="host",
                              prewarm_shapes=False,
                              min_heartbeat_ttl=3600.0))
    srv.start()
    try:
        for i in range(4):
            node = mock.node()
            node.id = f"node-{i}"
            srv.node_register(node)
        eval_ids = []
        for k in range(3):
            job = mock.job()
            job.id = f"job-{k}"
            job.task_groups[0].count = 2
            job.task_groups[0].tasks[0].resources.networks = []
            eid, _ = srv.job_register(job)
            eval_ids.append(eid)
        for eid in eval_ids:
            assert srv.wait_for_eval(eid).status == "complete"
    finally:
        srv.shutdown()
    # After shutdown: every span of the evals (the root's too) has ended.
    events = srv.fsm.events.all_events()
    tracer = trace.get_tracer()
    table = SpanTable({eid: tracer.get_trace(eid) for eid in eval_ids})
    dicts = [e.to_dict() for e in events]
    got = plc.stitch(dicts, tracer=table)
    ref = jlc.stitch(dicts, tracer=table)
    assert timelines_dict(got) == timelines_dict(ref)
    for eid in eval_ids:
        tl = got[eid]
        assert tl.submit_to_placed_ms is not None and tl.spans_seen > 0
        assert tl.stage_ms.get("plan_verify", 0.0) >= 0.0
    assert (without_delay(plc.attribution(got.values()))
            == jlc.attribution(ref.values()))
    one = plc.stitch_from_server(srv, eval_ids[0])
    assert one.to_dict() == got[eval_ids[0]].to_dict()
    assert plc.stitch_from_server(srv, "no-such-eval") is None
