"""The plain reference that decides ``correct``.

Plain Python and NumPy. It imports neither ``jax``, nor the JAX package,
nor anything of ``nomad_tpu_torch``, and takes nothing the port made: it
builds its own node table from the configuration file, reads each job's
spec as the benchmark wrote it, and judges the allocations the port
committed (read out of its state store as plain rows) against them.

The checks follow ``chip_smoke.py``'s ``check_committed`` and
``committed_usage`` (frozen here: later changes to that script do not
move the yardstick), widened to the stop path, the update paths and the
spread of the water-fill and the anti-affinity penalty.

A live row is ``(job_id, node_id, count, cpu, memory_mb, disk_mb, iops,
env)``: ``count`` live tasks of one job on one node with the ask and
task env they were committed with. An update is judged besides by the
ids of the job's live allocations before it and after it (``judge_update``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np

# Every number compared, each with its limit. All are counts of
# violations, so each comparison is exact: the limit is 0.
LIMITS = {
    "count_gap": 0,
    "off_eligible": 0,
    "over_capacity": 0,
    "ask_mismatch": 0,
    "stale_version": 0,
    "doubled": 0,
    "spread_gap": 0,
    "evals_not_complete": 0,
    "not_replaced": 0,
    "not_created": 0,
    "not_in_place": 0,
}


class NodeTable:
    """The configuration's nodes: ids, datacenters, attributes and
    capacity [N, 4] (cpu, memory, disk, iops), with no reservation."""

    def __init__(self, cfg: dict):
        spec = cfg["nodes"]
        n = int(spec["count"])
        dcs = list(spec["datacenters"])
        self.ids = [spec["id_format"].format(i=i) for i in range(n)]
        self.index = {nid: i for i, nid in enumerate(self.ids)}
        self.dc = [dcs[i % len(dcs)] for i in range(n)]
        self.attributes = dict(spec["attributes"])
        res = spec["resources"]
        self.cap = np.tile(np.array([res["cpu"], res["memory_mb"],
                                     res["disk_mb"], res["iops"]],
                                    dtype=np.int64), (n, 1))

    def eligible(self, job: dict) -> np.ndarray:
        """Nodes of the job's datacenters that meet its constraints."""
        dcs = set(job["datacenters"])
        ok = np.array([d in dcs for d in self.dc], dtype=bool)
        for c in job.get("constraints", ()):
            key = c["attribute"]
            if key.startswith("$attr."):
                key = key[len("$attr."):]
            if self.attributes.get(key) != c["value"]:
                ok[:] = False
        return ok


def ask_of(job: dict) -> np.ndarray:
    return np.array([job["cpu"], job["memory_mb"], 0, 0], dtype=np.int64)


def judge(table: NodeTable, jobs: Dict[str, dict], rows: Iterable[Sequence],
          eval_statuses: Iterable[str] = ()) -> Dict[str, int]:
    """Judge the committed state against the jobs as the benchmark wrote
    them. ``jobs`` maps a job id to its spec: ``count`` (the live count
    it must hold now; 0 once deregistered), ``cpu``, ``memory_mb``,
    ``env``, ``datacenters``, ``constraints``, and optional ``spread``
    ("waterfill": its eligible nodes each hold the level or one more)
    and ``one_per_node`` (the anti-affinity penalty outweighs every score
    gap in the cell, so no node takes a second task). ``eval_statuses``
    are the final statuses of the evals the window drove ("" for one
    that never ended). Returns the count of each kind of violation."""
    out = dict.fromkeys(LIMITS, 0)
    n = len(table.ids)
    usage = np.zeros((n, 4), dtype=np.int64)
    live = {jid: np.zeros(n, dtype=np.int64) for jid in jobs}
    for jid, nid, cnt, cpu, mem, disk, iops, env in rows:
        cnt = int(cnt)
        job = jobs.get(jid)
        i = table.index.get(nid)
        if job is None:
            # A live task of no job the benchmark holds live.
            out["count_gap"] += cnt
            if i is not None:
                usage[i] += cnt * np.array([cpu, mem, disk, iops], np.int64)
            continue
        if i is None:
            out["off_eligible"] += cnt
            continue
        live[jid][i] += cnt
        usage[i] += cnt * ask_of(job)
        if (int(cpu), int(mem)) != (job["cpu"], job["memory_mb"]):
            out["ask_mismatch"] += cnt
        if dict(env or {}) != dict(job.get("env") or {}):
            out["stale_version"] += cnt
    out["over_capacity"] = int(np.any(usage > table.cap, axis=1).sum())
    spread_jobs = []
    for jid, job in jobs.items():
        per_node = live[jid]
        out["count_gap"] += abs(int(per_node.sum()) - int(job["count"]))
        elig = table.eligible(job)
        out["off_eligible"] += int(per_node[~elig].sum())
        if job.get("one_per_node"):
            out["doubled"] += int((per_node > 1).sum())
        if job.get("spread") == "waterfill" and job["count"] > 0:
            spread_jobs.append((job, per_node, elig))
    out["spread_gap"] = spread_gap(table, spread_jobs)
    out["evals_not_complete"] = sum(1 for s in eval_statuses
                                    if s != "complete")
    return out


def spread_gap(table: NodeTable, spread_jobs: List[tuple]) -> int:
    """Eligible nodes that hold other than the level L = count // |E| or
    L + 1 of a water-filled job. The water-fill gives every eligible
    node min(cap, L) and the L + 1-th to the best-scored candidates;
    where no cap binds (checked here: every spread job's L + 1 tasks on
    one node fit it together), that is exactly L or L + 1."""
    if not spread_jobs:
        return 0
    need = sum((job["count"] // max(int(elig.sum()), 1) + 1) * ask_of(job)
               for job, _pn, elig in spread_jobs)
    if np.any(need > table.cap.min(axis=0)):
        return 0  # a cap may bind: the property does not hold here
    gap = 0
    for job, per_node, elig in spread_jobs:
        level = job["count"] // max(int(elig.sum()), 1)
        held = per_node[elig]
        gap += int(((held != level) & (held != level + 1)).sum())
    return gap


def judge_update(before: Iterable[str], after: Iterable[Sequence],
                 evals: Iterable[str], destructive: bool) -> Dict[str, int]:
    """Judge one update of a job by its diff. ``before`` holds the ids of
    the job's live allocations when the update was registered, ``after``
    one ``(alloc_id, eval_id)`` a live allocation once the update's evals
    ended, ``evals`` those evals. A destructive update replaces every
    allocation: none of ``before`` is live after (``not_replaced``), and
    every other live one was placed by the update's evals
    (``not_created``). An in-place update keeps every allocation: the live
    ids after are those before (``not_in_place`` counts the difference)."""
    before, evals = set(before), set(evals)
    out = {"not_replaced": 0, "not_created": 0, "not_in_place": 0}
    after_ids = set()
    for aid, eid in after:
        after_ids.add(aid)
        if not destructive:
            continue
        if aid in before:
            out["not_replaced"] += 1
        elif eid not in evals:
            out["not_created"] += 1
    if not destructive:
        out["not_in_place"] = len(before ^ after_ids)
    return out


def verdict(numbers: Dict[str, int]) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)
