"""The port's simcluster (nomad_tpu_torch.simcluster) against nomad_tpu's.

- Schedules: every injector's ``actions()`` equals the reference's for
  three seeds (``at``, ``kind`` and the whole payload; a ``build``
  callable is compared by the job it builds, through ``to_dict``; a
  seeded stream by its state). The registry equals the reference's, spec
  for spec. ``sim_node`` equals the reference's field by field.
- Reductions: ``canonical_events`` and ``_quantiles`` agree on the same
  synthetic inputs.
- Check 3: steady-1k at seed 42 through both packages
  (``attribution_layer=False``, the port on ``device="cpu"``) gives the
  same canonical digest and per-type counts, equal to the committed
  reference file too; the stats sections the runner reads carry the
  reference's keys and, where the run pins them, its values.
- Check 2 at simcluster level: steady-1k with one worker and
  ``eval_batch_size=1`` commits the same node -> count map per job in
  both packages. nomad_tpu reproduces that map across two of its own
  runs (checked when this test was written), so the maps are compared
  exactly. Tolerance: exact; the fleet's nodes are identical, so no two
  candidate scores sit inside the pow contract's band (ROADMAP Queue 3).
- A same-seed replay of the reference's ``steady-mini`` spec reproduces
  the port's own digest; a ``tls`` server override is handled as
  nomad_tpu's runner handles it; a contrast arm runs, and steady-10k's
  profiler-off arm (on a small spec) keeps the digest and gives the
  ``profiler_overhead`` verdict, the profiled arm carrying the profile
  section with the lock watchdog's table.
- The capacity and raft observatories' smokes: ``churn-frag-200`` (both
  arms: the capacity-off contrast arm must reproduce the main arm's
  digest) and ``restart-800`` (the leader killed at t=2 s and restarted
  from its durable log) at seed 42 give nomad_tpu's committed digests,
  and each reproduces its own digest at seed 11.
"""

import dataclasses
import json
import os
import random

import pytest
import torch

from nomad_tpu.api.codec import to_dict as jax_to_dict
from nomad_tpu.events import Event as JaxEvent
from nomad_tpu.simcluster import scenario as jsc
from nomad_tpu.simcluster import simnode as jsn
from nomad_tpu.simcluster import workload as jwl
from nomad_tpu_torch.api.codec import to_dict as port_to_dict
from nomad_tpu_torch.events import Event as PortEvent
from nomad_tpu_torch.simcluster import scenario as psc
from nomad_tpu_torch.simcluster import simload
from nomad_tpu_torch.simcluster import simnode as psn
from nomad_tpu_torch.simcluster import workload as pwl

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = [0, 7, 42]

# Small instances of every injector, by class name.
INJECTORS = {
    "BatchBurstInjector": dict(bursts=2, jobs_per_burst=3,
                               tasks_per_job=300),
    "ExpressStreamInjector": dict(tasks=12, every=0.06, start=0.5,
                                  until=5.0),
    "FragmentationChurnInjector": dict(fill_jobs=6, tasks_per_job=40,
                                       probe_jobs=2, probe_tasks=10),
    "LeaderRestartInjector": dict(at=2.0),
    "NodeChurnInjector": dict(count=7, at=3.0),
    "NodeRefreshInjector": dict(count=5, every=0.9, start=0.7, until=6.0),
    "OverdriveInjector": dict(clients=3, jobs_per_client=4,
                              tasks_per_job=10),
    "ReadFleetInjector": dict(pollers=3, watchers=2, sse_tails=1),
    "SteadyServiceInjector": dict(jobs=5, tasks_per_job=50, over=4.0),
    "UpdateChurnInjector": dict(base_jobs=3, tasks_per_job=40, updates=6),
}

# Every scenario of nomad_tpu's registry and the three chaos families run.
RUNNABLE = ["burst-100k", "churn", "churn-frag-200", "churn-fragmentation",
            "express-1k", "express-mix", "follower-crash-rejoin",
            "overdrive-100k", "overdrive-1k", "partition-flap",
            "rack-failure", "read-storm", "read-storm-800", "restart-800",
            "restart-under-load", "steady-100k-nodes", "steady-10k",
            "steady-1k"]



def payload_view(payload, to_dict):
    out = {}
    for k, v in payload.items():
        if k == "build":
            out[k] = to_dict(v())
        elif isinstance(v, random.Random):
            out[k] = v.getstate()
        else:
            out[k] = v
    return out


def schedule(injectors, to_dict):
    return [(type(inj).__name__, a.at, a.kind,
             payload_view(a.payload, to_dict))
            for inj in injectors for a in inj.actions()]


# -- schedules, nodes, registry -----------------------------------------------


def test_every_injector_is_compared():
    port = {name for name, cls in vars(pwl).items()
            if isinstance(cls, type) and issubclass(cls, pwl.Injector)
            and cls is not pwl.Injector}
    assert port == set(INJECTORS)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(INJECTORS))
def test_injector_schedule_equals_reference(name, seed):
    kw = INJECTORS[name]
    got = schedule([getattr(pwl, name)(seed, **kw)], port_to_dict)
    ref = schedule([getattr(jwl, name)(seed, **kw)], jax_to_dict)
    assert got and got == ref


@pytest.mark.parametrize("i, dc", [(0, "dc1"), (1, "dc2"), (4999, "dc2"),
                                   (99_999, "dc1")])
def test_sim_node_equals_reference(i, dc):
    assert port_to_dict(psn.sim_node(i, dc)) == jax_to_dict(
        jsn.sim_node(i, dc))


SPEC_FIELDS = ("n_nodes", "quiesce_timeout", "server_overrides",
               "faults_spec", "warmup_count", "ack_cap", "deterministic",
               "contrast_overrides", "contrast_digest_invariant",
               "durable_raft", "cluster_overrides", "cluster_members",
               "description")


@pytest.mark.parametrize("name", sorted(psc.SCENARIOS))
def test_registry_spec_equals_reference(name):
    got, ref = psc.SCENARIOS[name], jsc.SCENARIOS[name]
    for f in SPEC_FIELDS:
        assert getattr(got, f) == getattr(ref, f), f
    assert (schedule(got.injectors(42), port_to_dict)
            == schedule(ref.injectors(42), jax_to_dict))


def test_registry_leaves_out_only_chaos_families():
    """Nothing is left out any more: the chaos families are registered
    too, and the registry is nomad_tpu's, name for name."""
    rest = set(jsc.SCENARIOS) - set(psc.SCENARIOS)
    assert not rest
    assert set(psc.SCENARIOS) == set(jsc.SCENARIOS) == set(RUNNABLE)
    assert ({n for n, s in psc.SCENARIOS.items() if s.chaos_check}
            == {n for n, s in jsc.SCENARIOS.items() if s.chaos_check})


# -- reductions ---------------------------------------------------------------

TOPICS = ["Eval", "Plan", "Alloc", "Job", "Node", "Capacity", "Raft",
          "Fault"]
TYPES = ["EvalUpdated", "PlanApplied", "AllocUpserted", "JobRegistered",
         "NodeBatchRegistered", "CapacitySnapshot", "FaultInjected"]


def synthetic_events(seed: int, n: int):
    rng = random.Random(seed)
    rows = [(rng.choice(TOPICS), rng.choice(TYPES), f"k{rng.randrange(9)}")
            for _ in range(n)]
    return ([JaxEvent(i, t, ty, key=k) for i, (t, ty, k) in enumerate(rows)],
            [PortEvent(i, t, ty, key=k)
             for i, (t, ty, k) in enumerate(rows)])


@pytest.mark.parametrize("seed, n", [(1, 0), (2, 1), (3, 40), (4, 500)])
def test_canonical_events_equals_reference(seed, n):
    ref_events, port_events = synthetic_events(seed, n)
    assert (psc.canonical_events(port_events)
            == jsc.canonical_events(ref_events))


@pytest.mark.parametrize("samples", [
    [], [0.25], [0.003, 0.001, 0.002],
    [random.Random(5).expovariate(20.0) for _ in range(101)],
])
def test_quantiles_equal_reference(samples):
    assert psc._quantiles(samples) == jsc._quantiles(samples)


# -- check 3: steady-1k through both packages ---------------------------------


@pytest.fixture(scope="module")
def steady_1k():
    ref = jsc.run_scenario("steady-1k", seed=42, attribution_layer=False,
                           contrast=False)
    port = psc.run_scenario("steady-1k", seed=42, attribution_layer=False,
                            contrast=False, device="cpu")
    return {"nomad_tpu": ref, "port": port}


def test_steady_1k_digest_equals_reference(steady_1k):
    got, ref = steady_1k["port"]["events"], steady_1k["nomad_tpu"]["events"]
    assert got["digest"] == ref["digest"]
    assert got["by_type"] == ref["by_type"]
    assert got["groups"] == ref["groups"]


def test_steady_1k_digest_equals_committed_reference(steady_1k):
    with open(os.path.join(REPO, "nomad_tpu_torch", "simcluster",
                           "reference_digests.json")) as f:
        ref = json.load(f)["scenarios"]["steady-1k"]
    assert steady_1k["port"]["events"]["digest"] == ref["digest"]
    assert steady_1k["port"]["events"]["by_type"] == ref["by_type"]


@pytest.mark.parametrize("who", ["nomad_tpu", "port"])
def test_steady_1k_counts(steady_1k, who):
    art = steady_1k[who]
    assert art["placements"]["placed"] == 6 * 260
    assert art["placements"]["evals_injected"] == 6
    assert art["placements"]["plans_applied"] == 6
    assert art["heartbeat"]["timers"] == 1000
    assert art["alloc_ack"]["acked"] == 150
    assert art["events"]["truncated"] is False
    assert art["plan_latency_ms"]["n"] == art["eval_latency_ms"]["n"] == 6


def test_steady_1k_sections_equal_reference(steady_1k):
    """The stats the runner reads (heartbeat, mirror cache, plan pipeline,
    solver panel) carry the reference's keys in the port, and equal
    values where the run pins them."""
    got, ref = steady_1k["port"], steady_1k["nomad_tpu"]
    for section in ("heartbeat", "mirror", "plan_pipeline", "placements",
                    "registration", "peaks"):
        assert set(got[section]) == set(ref[section]), section
    gw, rw = got["solver_panel"]["window"], ref["solver_panel"]["window"]
    assert set(gw) == set(rw)
    for key in ("solves", "requested", "placed", "equiv"):
        assert gw[key] == rw[key], key
    for key in ("plans", "committed", "noops", "workers",
                "pipeline_batch_max"):
        assert got["plan_pipeline"][key] == ref["plan_pipeline"][key], key
    assert set(got["solver_panel"]) == set(ref["solver_panel"])
    assert got["heartbeat"]["equilibrium_renewals_per_sec"] == \
        ref["heartbeat"]["equilibrium_renewals_per_sec"]


def test_steady_1k_absent_sections_are_listed(steady_1k):
    """No section is left out any more: the artifact has nomad_tpu's
    sections, the profile section among them (the attribution layer is
    off, so no watchdog ran)."""
    art = steady_1k["port"]
    ref = steady_1k["nomad_tpu"]
    assert "not_ported" not in art
    assert set(art) == set(ref)
    assert art["profile"]["enabled"] is True
    assert set(art["profile"]) == set(ref["profile"])
    assert set(art["profile"]["bytes"]) == set(ref["profile"]["bytes"])
    assert art["profile"]["locks"] == ref["profile"]["locks"] == {
        "installed": False}
    assert art["profile"]["bytes"]["mirror"]["projected_1m_rows"] == \
        ref["profile"]["bytes"]["mirror"]["projected_1m_rows"] == 1_048_576
    # The capacity and raft sections stand as in nomad_tpu's artifact.
    for section in ("capacity", "raft"):
        assert art[section]["enabled"] is True
        assert set(art[section]) == set(ref[section]), section
    assert set(art["capacity"]["final"]) == set(ref["capacity"]["final"])
    assert art["capacity"]["final"]["nodes"] == ref["capacity"]["final"][
        "nodes"]
    assert set(art["raft"]["write_path"]) == set(ref["raft"]["write_path"])
    # Admission, the read books and lifecycle/SLO are ported: their
    # sections stand as in nomad_tpu's artifact (the attribution layer is
    # off here, so latency_attribution and slo are None; the lane is off,
    # so there is no express section; no read fleet, so no lanes).
    assert set(art["admission"]) == set(ref["admission"])
    assert art["admission"]["injector"] == ref["admission"]["injector"]
    assert art["admission"]["controller"]["admitted"] == \
        ref["admission"]["controller"]["admitted"]
    assert art["reads"]["enabled"] is True and "lanes" not in art["reads"]
    assert art["latency_attribution"] is None and art["slo"] is None
    assert "express" not in art and "express" not in ref
    assert art["admission"]["injector"]["offered"] == 6
    assert art["backend"] == "cpu"


# -- check 2 at simcluster level, replay, contrast ----------------------------


def node_counts(runner):
    """job key -> {node id: live tasks} from the leader's store."""
    snap = runner._srv.state_store.snapshot()
    out = {}
    for key, job in sorted(runner._jobs.items()):
        m = {}
        for a in snap.allocs_by_job(job.id):
            if a.desired_status == "run":
                m[a.node_id] = m.get(a.node_id, 0) + 1
        out[key] = m
    return out


def test_one_worker_node_choices_equal_reference():
    overrides = {"scheduler_workers": 1, "eval_batch_size": 1}
    maps = []
    for mod, kw in ((jsc, {}), (psc, {"device": "cpu"})):
        spec = dataclasses.replace(mod.SCENARIOS["steady-1k"],
                                   server_overrides=overrides)
        runner = mod.ScenarioRunner(spec, seed=42, attribution_layer=False,
                                    **kw)
        runner.run()
        maps.append(node_counts(runner))
    assert maps[0] == maps[1]
    assert [sum(m.values()) for m in maps[1].values()] == [260] * 6


def steady_mini(**kw):
    """tests/test_simcluster.py's steady-mini spec."""
    return psc.ScenarioSpec(
        name="steady-mini", n_nodes=300,
        injectors=lambda seed: [pwl.SteadyServiceInjector(
            seed, jobs=3, tasks_per_job=260, over=1.0,
        )],
        quiesce_timeout=60.0, ack_cap=40, **kw,
    )


def test_same_seed_replay_reproduces_digest():
    a = psc.ScenarioRunner(steady_mini(), seed=33, device="cpu").run()
    b = psc.ScenarioRunner(steady_mini(), seed=33, device="cpu").run()
    assert a["events"]["digest"] == b["events"]["digest"]
    assert a["events"]["by_type"] == b["events"]["by_type"]
    assert a["placements"]["placed"] == b["placements"]["placed"] == 3 * 260


def tiny(contrast):
    return psc.ScenarioSpec(
        name="tiny", n_nodes=200,
        injectors=lambda seed: [pwl.SteadyServiceInjector(
            seed, jobs=2, tasks_per_job=150, over=0.4,
        )],
        quiesce_timeout=60.0, ack_cap=0, warmup_count=0,
        contrast_overrides=contrast, contrast_digest_invariant=True,
    )


def test_three_member_durable_cell_gives_the_one_member_digest():
    """``cluster_members=3`` (a raft cell; the fleet on the elected
    leader) with ``durable_raft`` (each member journals into its own
    directory, removed after the run) commits the same canonical history
    as one member."""
    raft = {"election_timeout_min": 0.4, "election_timeout_max": 0.8,
            "heartbeat_interval": 0.1}
    arts = []
    for members in (1, 3):
        spec = dataclasses.replace(
            tiny(None), ack_cap=20, cluster_members=members,
            durable_raft=members > 1, cluster_overrides=raft)
        runner = psc.ScenarioRunner(spec, seed=3, device="cpu")
        arts.append(runner.run())
        assert len(runner._members) == members
        assert runner._data_dir is None
    assert arts[0]["events"]["digest"] == arts[1]["events"]["digest"]
    assert arts[1]["placements"]["placed"] == 300
    assert arts[1]["alloc_ack"]["acked"] == 20


def test_contrast_arm_runs_when_its_modules_are_ported(monkeypatch):
    monkeypatch.setitem(psc.SCENARIOS, "tiny", tiny({"eval_batch_size": 1}))
    art = psc.run_scenario("tiny", seed=3, device="cpu")
    assert art["contrast"]["run"] is True
    assert art["contrast"]["digest_matches"] is True
    assert art["contrast"]["placements"]["placed"] == 300


def test_profiler_off_arm_keeps_the_digest_and_gives_the_overhead(
        monkeypatch):
    """steady-10k's profiler-off contrast arm, on a small spec: it runs,
    reproduces the main arm's digest, profiles nothing, and the artifact
    carries the profiler_overhead verdict (the profiled arm's plan p50
    over the off arm's). The profiled arm ran under the port's lock
    watchdog, uninstalled after: its table is non-empty, with no
    violation."""
    from nomad_tpu_torch import telemetry

    monkeypatch.setitem(psc.SCENARIOS, "tiny", tiny(
        psc.SCENARIOS["steady-10k"].contrast_overrides))
    art = psc.run_scenario("tiny", seed=3, device="cpu")
    assert telemetry.active_lock_watchdog() is None
    contrast = art["contrast"]
    assert contrast["run"] is True and contrast["digest_matches"] is True
    assert contrast["profile"] == {"enabled": False}
    over = contrast["profiler_overhead"]
    assert over["overhead_fraction"] == round(
        over["plan_p50_ms_profiled"] / over["plan_p50_ms_disabled"] - 1, 4)
    assert over["plan_p50_ms_profiled"] == art["plan_latency_ms"]["p50_ms"]
    assert over["plan_p50_ms_disabled"] == \
        contrast["plan_latency_ms"]["p50_ms"]
    prof = art["profile"]
    assert prof["enabled"] is True and prof["profiler"]["samples"] > 0
    assert prof["locks"]["installed"] is True
    assert prof["locks"]["contention"] and prof["locks"]["violations"] == 0
    assert prof["bytes"]["mirror"]["projected_1m_bytes"] > 0


def test_profiler_overhead_needs_both_arms_planned():
    on = {"plan_latency_ms": {"p50_ms": 12.0}}
    assert psc.profiler_overhead(on, {"plan_latency_ms": {}}) is None
    assert psc.profiler_overhead(on, {"plan_latency_ms": {"p50_ms": 10.0}}) \
        == {"plan_p50_ms_profiled": 12.0, "plan_p50_ms_disabled": 10.0,
            "overhead_fraction": 0.2}


# -- the capacity and raft observatories' smokes ------------------------------


def committed_reference(name, seed=42):
    with open(os.path.join(REPO, "nomad_tpu_torch", "simcluster",
                           "reference_digests.json")) as f:
        ref = json.load(f)["scenarios"][name]
    return ref if seed == ref["seed"] else ref["other_seeds"][str(seed)]


@pytest.fixture(scope="module")
def churn_frag_200():
    return psc.run_scenario("churn-frag-200", seed=42, device="cpu")


@pytest.fixture(scope="module")
def restart_800():
    return psc.run_scenario("restart-800", seed=42, device="cpu")


@pytest.mark.parametrize("fixture", ["churn_frag_200", "restart_800"])
def test_smoke_digest_equals_committed_reference(fixture, request):
    art = request.getfixturevalue(fixture)
    ref = committed_reference(art["scenario"])
    assert art["events"]["digest"] == ref["digest"]
    assert art["events"]["by_type"] == ref["by_type"]
    assert art["placements"]["placed"] == ref["placed"]
    assert art["events"]["truncated"] is False


def test_churn_frag_200_capacity_off_arm_keeps_the_digest(churn_frag_200):
    """The observatory-off contrast arm reproduces the main arm's digest:
    the accountant reads cluster state and changes no decision."""
    contrast = churn_frag_200["contrast"]
    assert contrast["run"] is True
    assert contrast["capacity"] == {"enabled": False}
    assert contrast["digest_matches"] is True
    assert contrast["events"]["digest"] == churn_frag_200["events"]["digest"]
    assert contrast["placements"]["placed"] == 6 * 400 + 2 * 40


def test_churn_frag_200_capacity_section(churn_frag_200):
    """tests/test_simcluster.py's churn-frag-200 smoke, on the port."""
    art = churn_frag_200
    assert art["placements"]["placed"] == 6 * 400 + 2 * 40
    assert art["placements"]["stopped"] == 3 * 400
    cap = art["capacity"]
    assert cap["enabled"] is True and len(cap["trajectory"]) >= 3
    final = cap["final"]
    assert final["nodes"]["schedulable"] == 200
    assert final["nodes"]["occupied"] > 0
    assert 0 < final["binpack_density"]["cpu"] <= 1
    assert final["accountant"]["rebuilds"] <= 1
    assert final["accountant"]["rolls"] >= 1
    assert {s["shape"] for s in final["stranded"]} == {"small", "medium",
                                                      "large"}
    utils = [s["utilization"]["cpu"] for s in cap["trajectory"]]
    assert max(utils) > min(utils)


def test_restart_800_recovery(restart_800):
    """tests/test_simcluster.py's restart-800 smoke, on the port: every
    pre-kill placement survives the replay (same alloc id, same node) and
    the recovery timeline is populated."""
    raft = restart_800["raft"]
    assert restart_800["placements"]["placed"] == 6 * 120
    restart = raft["restart"]
    assert restart["placements_survived"] is True
    assert restart["pre_kill_placements"] > 0
    assert restart["surviving_placements"] == restart["pre_kill_placements"]
    recovery = raft["recovery"]
    assert recovery["cold_start"] is True
    assert recovery["entries_replayed"] > 0
    assert recovery["replayed_by_type"].get("alloc_update", 0) >= 1
    for key in ("replay_wall_ms", "time_to_leader_ms",
                "time_to_serving_ms"):
        assert recovery[key] is not None, key
    assert recovery["replay_entries_per_s"] > 0
    assert raft["write_path"]["alloc_update"]["count"] >= 6
    assert raft["write_path"]["alloc_update"]["total_ms"]["p95"] > 0


@pytest.mark.parametrize("name", ["churn-frag-200", "restart-800"])
def test_smoke_reproduces_at_seed_11(name):
    """Same seed, same digest (tests/test_simcluster.py's seed-11
    determinism tests), equal to nomad_tpu's at that seed."""
    a = psc.run_scenario(name, seed=11, contrast=False, device="cpu",
                         attribution_layer=False)
    b = psc.run_scenario(name, seed=11, contrast=False, device="cpu",
                         attribution_layer=False)
    assert a["events"]["digest"] == b["events"]["digest"]
    assert a["events"]["by_type"] == b["events"]["by_type"]
    assert a["events"]["digest"] == committed_reference(name, 11)["digest"]


@pytest.mark.slow
@pytest.mark.parametrize("name", ["rack-failure", "partition-flap",
                                  "follower-crash-rejoin"])
def test_chaos_family_end_to_end(name):
    """A chaos family at its registry size on the CPU (60-100 s each): the
    verdict ok and the digest one of those nomad_tpu gave."""
    art = psc.run_scenario(name, seed=42, device="cpu", contrast=False)
    assert art["chaos"]["ok"] is True
    ref = committed_reference(name)
    seen = ref.get("digests_seen") or {ref["digest"]: ref}
    assert art["events"]["digest"] in seen
    assert art["placements"]["placed"] == ref["placed"]


# -- overrides, the registry and the device -----------------------------------


def test_tls_override_is_handled_as_nomad_tpu_handles_it():
    """A ``tls`` server override goes to each member's ServerConfig as
    nomad_tpu's runner passes it: a mapping where a TLSConfig belongs
    fails the first member's construction in both packages alike,
    before the run starts."""
    errors = []
    for mod, kw in ((jsc, {}), (psc, {"device": "cpu"})):
        spec = dataclasses.replace(
            mod.SCENARIOS["steady-1k"], name="tls",
            server_overrides={"tls": {"ca_file": "ca.pem"}})
        runner = mod.ScenarioRunner(spec, seed=42, **kw)
        with pytest.raises(AttributeError) as info:
            runner.run()
        assert runner._srv is None
        errors.append(str(info.value))
    assert errors[1] == errors[0]
    assert "incoming_context" in errors[0]


def test_every_registry_scenario_runs():
    """The port's registry is nomad_tpu's, and every entry runs here."""
    assert sorted(psc.SCENARIOS) == sorted(jsc.SCENARIOS) == RUNNABLE


def test_runner_defaults_to_cuda():
    spec = psc.SCENARIOS["steady-1k"]
    if torch.cuda.is_available():
        assert psc.ScenarioRunner(spec).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        psc.ScenarioRunner(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        psc.run_scenario("steady-1k")


# -- the CLI ------------------------------------------------------------------


def test_simload_lists_what_runs_and_what_waits(capsys):
    """Every scenario runs: nothing waits for a module any more."""
    assert simload.main(["--list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(psc.SCENARIOS)
    state = {line.split()[0]: line for line in lines}
    assert sorted(state) == RUNNABLE
    for name in RUNNABLE:
        assert state[name].endswith("runs")


@pytest.mark.parametrize("args, word", [
    (["--scenario", "churn", "--verify-determinism"], "deterministic"),
    (["--scenario", "no-such"], "unknown scenario"),
])
def test_simload_refuses(args, word, capsys):
    assert simload.main(args + ["--device", "cpu"]) == 2
    assert word in capsys.readouterr().err


def test_simload_runs_and_verifies_determinism(tmp_path, capsys):
    out = tmp_path / "art.json"
    assert simload.main(["--scenario", "steady-1k", "--nodes", "300",
                         "--device", "cpu", "--verify-determinism",
                         "--out", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    art = json.loads(out.read_text())
    assert line["placed"] == art["placements"]["placed"] == 1560
    assert line["determinism_verified"] is True
    assert art["determinism"]["digests"][0] == art["determinism"]["digests"][1]
    assert line["backend"] == "cpu"
    assert art["profile"]["enabled"] is True
    assert art["profile"]["locks"]["installed"] is True
