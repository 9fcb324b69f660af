"""The system under test: one nomad_tpu_torch ``ClusterServer`` member,
its nodes and jobs, built from a configuration file and a traffic mix,
and the waits that see an eval complete in its state store.

This is the only module (with ``observe.py``, ``faults.py`` and
``devtrace.py``) that touches the port; the reference never imports it.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional

# An eval that is not terminal this long after it was due has failed.
EVAL_WAIT_S = 60.0
POLL_S = 0.0005


def node_ids(cfg: dict) -> List[str]:
    spec = cfg["nodes"]
    return [spec["id_format"].format(i=i) for i in range(spec["count"])]


def node_dc(cfg: dict, i: int) -> str:
    dcs = cfg["nodes"]["datacenters"]
    return dcs[i % len(dcs)]


def build_nodes(cfg: dict):
    """The configuration's node table as port ``Node``s."""
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.structs import Node, Resources

    spec = cfg["nodes"]
    res = spec["resources"]
    return [Node(
        id=nid, datacenter=node_dc(cfg, i), name=f"n{i}",
        attributes=dict(spec["attributes"]),
        resources=Resources(cpu=res["cpu"], memory_mb=res["memory_mb"],
                            disk_mb=res["disk_mb"], iops=res["iops"]),
        status=structs.NODE_STATUS_READY,
    ) for i, nid in enumerate(node_ids(cfg))]


def start_server(cfg: dict, device: str, data_dir: str, seed: int):
    """One ``ClusterServer`` member bootstrapped alone (bootstrap_expect
    1) with its raft journal under ``data_dir``, returned once it leads."""
    from nomad_tpu_torch.server.cluster import (
        ClusterConfig, ClusterServer, wait_for_leader,
    )
    from nomad_tpu_torch.server.server import ServerConfig

    spec = cfg["server"]
    if spec["members"] != 1:
        raise ValueError("only a single-member server is built here")
    srv = ClusterServer(
        ServerConfig(scheduler_backend=spec["scheduler_backend"],
                     device=device,
                     scheduler_workers=spec["scheduler_workers"],
                     min_heartbeat_ttl=spec["min_heartbeat_ttl_s"],
                     seed=seed % (2 ** 31), **spec.get("config", {})),
        ClusterConfig(node_id="server-1", raft_data_dir=data_dir,
                      bootstrap_expect=spec["bootstrap_expect"]),
    )
    srv.start()
    wait_for_leader([srv], timeout=30.0)
    # The leader enables its broker once its barrier is through.
    deadline = time.monotonic() + 30.0
    while not srv.eval_broker.enabled:
        if time.monotonic() > deadline:
            raise TimeoutError("the leader's eval broker never enabled")
        time.sleep(0.01)
    return srv


def job_from_spec(spec: dict):
    """A port ``Job`` from a plain job spec (the dicts ``reference.judge``
    reads)."""
    from nomad_tpu_torch.structs import (
        Constraint, Job, Resources, RestartPolicy, Task, TaskGroup,
        UpdateStrategy,
    )

    cons = [Constraint(l_target=c["attribute"], r_target=c["value"],
                       operand="=") for c in spec.get("constraints", ())]
    update = None
    if spec.get("max_parallel"):
        update = UpdateStrategy(stagger=spec["stagger_s"],
                                max_parallel=spec["max_parallel"])
    return Job(
        region="global", id=spec["id"], name=spec["name"],
        type=spec["type"], priority=50, datacenters=list(spec["datacenters"]),
        constraints=cons, update=update,
        task_groups=[TaskGroup(
            name="work", count=spec["count"],
            restart_policy=RestartPolicy(
                attempts=spec.get("restart_attempts", 1), interval=600.0,
                delay=5.0),
            tasks=[Task(name="work", driver="exec",
                        env=dict(spec.get("env", {})),
                        resources=Resources(cpu=spec["cpu"],
                                            memory_mb=spec["memory_mb"]))],
        )],
    )


def eval_state(srv, eval_id: str):
    """(terminal, status, next_eval) of one eval in the state store."""
    ev = srv.state_store.eval_by_id(eval_id)
    if ev is None or not ev.terminal_status():
        return False, "", ""
    return True, ev.status, ev.next_eval


def wait_evals(srv, eval_ids: Iterable[str], deadline: float) -> Dict:
    """Poll the store until every eval is terminal or ``deadline``
    (perf_counter) passes; returns {eval id: (perf_counter seen or None,
    status)}."""
    todo = set(eval_ids)
    out: Dict[str, tuple] = {}
    while todo:
        now = time.perf_counter()
        for eid in list(todo):
            done, status, _ = eval_state(srv, eid)
            if done:
                out[eid] = (now, status)
                todo.discard(eid)
        if not todo or now > deadline:
            break
        time.sleep(POLL_S)
    for eid in todo:
        out[eid] = (None, "")
    return out


def wait_eval(srv, eval_id: str, deadline: float):
    return wait_evals(srv, [eval_id], deadline)[eval_id]


def follow_chain(srv, eval_id: str, start: float,
                 max_len: int) -> List[tuple]:
    """Follow an eval and its delayed follow-ups (a rolling update's
    rounds) to the end, each given EVAL_WAIT_S from the end of the one
    before (``start`` for the first): [(eval id, perf_counter done or
    None, status)]."""
    chain = []
    eid, prev = eval_id, start
    while eid and len(chain) < max_len:
        seen, status = wait_eval(srv, eid, prev + EVAL_WAIT_S)
        chain.append((eid, seen, status))
        if seen is None:
            break
        prev = seen
        _, _, eid = eval_state(srv, eid)
    return chain


def reap(srv, eval_ids: List[str], job_ids: List[str], snap=None) -> None:
    """Delete a finished wave's evals and allocations through the raft
    log (``Server.eval_reap``: the ``eval_delete`` entry the eval GC
    applies)."""
    if snap is None:
        snap = srv.state_store.snapshot()
    alloc_ids = [a.id for jid in job_ids for a in snap.allocs_by_job(jid)]
    srv.eval_reap(list(eval_ids), alloc_ids)


def shutdown(srv) -> None:
    srv.shutdown(drain_timeout=10.0)


def _env(job) -> dict:
    return dict(job.task_groups[0].tasks[0].env or {})


def live_count(snap, job_id: str, env: Optional[dict] = None) -> int:
    """Live tasks of a job (of those whose task env is ``env``, if
    given)."""
    n = 0
    for blk in snap.job_alloc_blocks(job_id):
        if env is None or _env(blk.job) == env:
            n += sum(int(c) for _nid, c in blk.live_node_counts())
    for a in snap.allocs_by_job_objects(job_id):
        if not a.terminal_status() and (env is None or _env(a.job) == env):
            n += 1
    return n
