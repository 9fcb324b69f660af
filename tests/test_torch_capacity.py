"""The port's capacity observatory (capacity.py) against nomad_tpu's.

- ``CapacityConfig.parse``: the same defaults, the same parsed values and
  the same rejections as ``tests/test_capacity.py`` asks of nomad_tpu.
- The accountant: one seeded script of node and alloc writes (numpy
  draws: node sizes, reserved holdback, jobs of every lane, express
  jobs, placements, stops, drain flips, status flips, deletions and
  re-registrations, columnar blocks) goes into a nomad_tpu store and a
  port store, each watched by its package's accountant, refreshed at
  the same points. Every snapshot is equal, apart from the store uid:
  histograms, stranded %, ``placeable_count``, density, lanes, and the
  roll and rebuild counts, past the change log's horizon too.
- The accountant publishes ``Capacity`` events on the observer topic, as
  nomad_tpu's does.

Tolerance: exact (host numpy on identical inputs).
"""

import numpy as np
import pytest

from nomad_tpu import capacity as jcap
from nomad_tpu import mock as jmock
from nomad_tpu import structs as jstructs
from nomad_tpu.api.codec import to_dict
from nomad_tpu.state import store as jstore_mod
from nomad_tpu.state.store import StateStore as JaxStore
from nomad_tpu_torch import capacity as pcap
from nomad_tpu_torch import structs as pstructs
from nomad_tpu_torch.convert import structs_from_reference
from nomad_tpu_torch.events import EventBroker, OBSERVER_TOPICS
from nomad_tpu_torch.state import store as pstore_mod
from nomad_tpu_torch.state.store import StateStore as PortStore

# -- config -------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    None,
    {},
    {"enabled": False},
    {"poll_interval": 0.25, "events_interval": 0},
    {"reference_shapes": [{"name": "gpu-box", "cpu": 8000,
                           "memory_mb": 32768, "iops": 10}]},
])
def test_capacity_config_parse_equals_reference(spec):
    got = pcap.CapacityConfig.parse(spec)
    ref = jcap.CapacityConfig.parse(spec)
    assert vars(got) == vars(ref)


@pytest.mark.parametrize("spec, word", [
    ({"poll_intervall": 1.0}, "unknown"),  # typo'd key
    ({"poll_interval": 0}, "poll_interval"),
    ({"events_interval": -1}, "events_interval"),
    ({"reference_shapes": []}, "non-empty"),
    ({"reference_shapes": [{"name": "zero"}]}, "asks for nothing"),
    ({"reference_shapes": [{"cpu": 10}]}, "name"),
    ("not a mapping", "mapping"),
])
def test_capacity_config_rejections_equal_reference(spec, word):
    with pytest.raises(ValueError, match=word) as got:
        pcap.CapacityConfig.parse(spec)
    with pytest.raises(ValueError) as ref:
        jcap.CapacityConfig.parse(spec)
    assert str(got.value) == str(ref.value)


def test_taxonomy_equals_reference():
    assert pcap.LANES == jcap.LANES
    assert pcap.FRAG_BINS == jcap.FRAG_BINS
    assert pcap.DEFAULT_REFERENCE_SHAPES == jcap.DEFAULT_REFERENCE_SHAPES


# -- the accountant over one seeded write script ------------------------------

LANE_TYPES = [(jstructs.JOB_TYPE_SERVICE, False),
              (jstructs.JOB_TYPE_BATCH, False),
              (jstructs.JOB_TYPE_SYSTEM, False),
              (jstructs.JOB_TYPE_BATCH, True)]


def ref_node(rng, i):
    n = jmock.node()
    n.id = f"cap-node-{i:03d}"
    n.resources = jstructs.Resources(
        cpu=int(rng.choice([1000, 2000, 4000, 8000])),
        memory_mb=int(rng.choice([1024, 4096, 8192, 16384])),
        disk_mb=100 * 1024, iops=150)
    n.reserved = jstructs.Resources(cpu=int(rng.choice([0, 100, 500])),
                                    memory_mb=int(rng.choice([0, 256])))
    return n


def ref_job(k, rng):
    jtype, express = LANE_TYPES[k % len(LANE_TYPES)]
    job = jmock.job()
    job.id = job.name = f"cap-job-{k:02d}"
    job.type = jtype
    job.express = express
    return job


def ref_alloc(rng, job, node_id):
    return jstructs.Allocation(
        id=jstructs.generate_uuid(), eval_id=jstructs.generate_uuid(),
        name=f"{job.name}.web[0]", node_id=node_id, job_id=job.id, job=job,
        task_group="web",
        resources=jstructs.Resources(
            cpu=int(rng.integers(1, 40)) * 50,
            memory_mb=int(rng.integers(1, 32)) * 64),
        desired_status=jstructs.ALLOC_DESIRED_STATUS_RUN)


def write_script(seed, n_nodes=24, n_jobs=8, steps=160):
    """[(kind, reference payload)] drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    nodes = {i: ref_node(rng, i) for i in range(n_nodes)}
    jobs = [ref_job(k, rng) for k in range(n_jobs)]
    script = [("nodes", list(nodes.values()))]
    live = []
    deleted = set()
    for _ in range(steps):
        r = rng.random()
        present = sorted(set(nodes) - deleted)
        if r < 0.45:
            k = int(rng.integers(1, 5))
            batch = []
            for _ in range(k):
                job = jobs[int(rng.integers(n_jobs))]
                node = nodes[present[int(rng.integers(len(present)))]]
                batch.append(ref_alloc(rng, job, node.id))
            live += batch
            script.append(("allocs", batch))
        elif r < 0.55 and live:
            a = live.pop(int(rng.integers(len(live)))).copy()
            a.desired_status = jstructs.ALLOC_DESIRED_STATUS_STOP
            script.append(("allocs", [a]))
        elif r < 0.62:
            i = present[int(rng.integers(len(present)))]
            script.append(("drain", (f"cap-node-{i:03d}",
                                     bool(rng.random() < 0.5))))
        elif r < 0.69:
            i = present[int(rng.integers(len(present)))]
            script.append(("status", (f"cap-node-{i:03d}",
                                      str(rng.choice(["down", "ready"])))))
        elif r < 0.73 and len(present) > 4:
            i = present[int(rng.integers(len(present)))]
            deleted.add(i)
            script.append(("delete", f"cap-node-{i:03d}"))
        elif r < 0.77 and deleted:
            i = sorted(deleted)[int(rng.integers(len(deleted)))]
            deleted.discard(i)
            nodes[i] = ref_node(rng, i)
            script.append(("nodes", [nodes[i]]))
        elif r < 0.82:
            job = jobs[int(rng.integers(n_jobs))]
            node_ids = [nodes[present[int(rng.integers(len(present)))]].id
                        for _ in range(int(rng.integers(1, 4)))]
            # Distinct node ids: a block's runs are one per node.
            node_ids = sorted(set(node_ids))
            script.append(("block", (job, node_ids,
                                     int(rng.integers(1, 20)) * 50,
                                     int(rng.integers(1, 2**62)))))
        else:
            script.append(("refresh", None))
    return script


def port_of(obj, cls):
    return structs_from_reference(to_dict(obj), cls)


def apply_write(store, index, kind, payload, port):
    if kind == "nodes":
        store.upsert_nodes(index, [port_of(n, "Node") if port else n
                                   for n in payload])
    elif kind == "allocs":
        store.upsert_allocs(index, [port_of(a, "Allocation") if port else a
                                    for a in payload])
    elif kind == "drain":
        store.update_node_drain(index, *payload)
    elif kind == "status":
        store.update_node_status(index, *payload)
    elif kind == "delete":
        store.delete_node(index, payload)
    elif kind == "block":
        job, node_ids, cpu, seed = payload
        mod = pstructs if port else jstructs
        counts = [1 + (seed + k) % 3 for k in range(len(node_ids))]
        store.upsert_alloc_blocks(index, [mod.AllocBatch(
            eval_id=f"eval-{index}", job=port_of(job, "Job") if port else job,
            tg_name=job.task_groups[0].name,
            resources=mod.Resources(cpu=cpu, memory_mb=128),
            node_ids=node_ids, node_counts=counts,
            name_idx=list(range(sum(counts))), ids_seed=seed)])


def snapshot_view(acct):
    snap = acct.snapshot()
    snap["generation"] = {k: v for k, v in snap["generation"].items()
                          if k != "store_uid"}
    return snap


def run_both(seed, horizon=None, monkeypatch=None):
    if horizon is not None:
        for mod in (jstore_mod, pstore_mod):
            monkeypatch.setattr(mod, "NODE_LOG_HORIZON", horizon)
            monkeypatch.setattr(mod, "ALLOC_LOG_HORIZON", horizon)
    stores = {"ref": JaxStore(), "port": PortStore()}
    accts = {
        "ref": jcap.CapacityAccountant(lambda: stores["ref"]),
        "port": pcap.CapacityAccountant(lambda: stores["port"]),
    }
    views = []
    for index, (kind, payload) in enumerate(write_script(seed), start=1):
        if kind == "refresh":
            got = {}
            for who, acct in accts.items():
                acct.refresh()
                got[who] = snapshot_view(acct)
            assert got["port"] == got["ref"], index
            views.append(got["port"])
            continue
        for who, store in stores.items():
            apply_write(store, index, kind, payload, who == "port")
    for acct in accts.values():
        acct.refresh()
    final = {who: snapshot_view(acct) for who, acct in accts.items()}
    assert final["port"] == final["ref"]
    views.append(final["port"])
    return views


@pytest.mark.parametrize("seed", [3, 11, 42])
def test_accountant_snapshots_equal_reference(seed):
    views = run_both(seed)
    last = views[-1]["accountant"]
    assert last["rebuilds"] == 1 and last["rolls"] >= 5
    assert any(s["placeable_count"] > 0
               for v in views for s in v["stranded"])
    assert any(v["lanes"]["express"]["allocs"] for v in views)


@pytest.mark.parametrize("seed", [5, 42])
def test_accountant_past_the_log_horizon_equals_reference(seed,
                                                          monkeypatch):
    """Change logs cut to a horizon of 2: most polls see a change set past
    it and rebuild in full, counted the same way in both packages."""
    views = run_both(seed, horizon=2, monkeypatch=monkeypatch)
    last = views[-1]["accountant"]
    assert last["rebuilds"] > 1 and last["rolls"] >= 1


def test_capacity_event_is_observer_topic():
    store = PortStore()
    store.upsert_nodes(1, [port_of(ref_node(np.random.default_rng(0), 0),
                                   "Node")])
    broker = EventBroker(capacity=64)
    acct = pcap.CapacityAccountant(lambda: store, events=broker)
    acct.refresh()
    acct.publish_event()
    _latest, evs, _truncated = broker.events_after(0)
    assert [(e.topic, e.type, e.key) for e in evs] == [
        ("Capacity", "CapacitySnapshot", "capacity")]
    assert "Capacity" in OBSERVER_TOPICS
    assert set(evs[0].payload) == {"utilization", "binpack_density",
                                   "stranded", "nodes"}
    assert acct.events_published == 1


# -- the config surfaces: server, agent file ----------------------------------


def test_server_config_parses_both_observatory_blocks():
    from nomad_tpu.server.server import ServerConfig as JaxServerConfig
    from nomad_tpu_torch.server.server import ServerConfig

    spec = {"capacity": {"poll_interval": 0.25, "events_interval": 2.0},
            "raft_observe": {"enabled": False}}
    got = ServerConfig(device="cpu", **spec)
    ref = JaxServerConfig(**spec)
    assert vars(got.capacity_config) == vars(ref.capacity_config)
    assert vars(got.raft_observe_config) == vars(ref.raft_observe_config)
    for bad in ({"capacity": {"poll_interval": 0}},
                {"raft_observe": {"bogus": 1}}):
        with pytest.raises(ValueError):
            ServerConfig(device="cpu", **bad)


AGENT_HCL = """
server {
  enabled = true
  capacity { poll_interval = 0.5  events_interval = 0 }
  raft_observe { poll_interval = 2 }
}
"""


def test_agent_file_parses_both_observatory_blocks(tmp_path):
    from nomad_tpu_torch import agent_config
    from nomad_tpu_torch.agent import AgentConfig

    path = tmp_path / "agent.hcl"
    path.write_text(AGENT_HCL)
    fc = agent_config.load_config_file(str(path))
    assert fc.server.capacity == {"poll_interval": 0.5,
                                  "events_interval": 0}
    assert fc.server.raft_observe == {"poll_interval": 2}
    cfg = AgentConfig.from_file_config(fc)
    assert cfg.capacity == fc.server.capacity
    assert cfg.raft_observe == fc.server.raft_observe
    # A typo'd knob fails the config load, not the agent start.
    path.write_text(AGENT_HCL.replace("poll_interval = 2", "poll = 2"))
    with pytest.raises(ValueError, match="raft_observe"):
        agent_config.load_config_file(str(path))
