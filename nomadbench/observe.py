"""Read the port's committed state out as the plain rows the reference
judges (see ``reference``): the program's outputs, and nothing else of
it, cross to the reference."""

from __future__ import annotations

from typing import Dict, List, Tuple


def _env(job) -> Dict[str, str]:
    if job is None or not job.task_groups or not job.task_groups[0].tasks:
        return {}
    return dict(job.task_groups[0].tasks[0].env or {})


def live_rows(snap) -> List[Tuple]:
    """Every live task in the snapshot as ``(job_id, node_id, count, cpu,
    memory_mb, disk_mb, iops, env)`` rows: a stored block's runs and the
    object rows that are not terminal."""
    rows = []
    for blk in snap.alloc_blocks():
        res = blk.resources
        env = _env(blk.job)
        for nid, cnt in blk.live_node_counts():
            rows.append((blk.job_id, nid, int(cnt), res.cpu, res.memory_mb,
                         res.disk_mb, res.iops, env))
    for a in snap.allocs_objects():
        if not a.terminal_status():
            res = a.resources
            rows.append((a.job_id, a.node_id, 1, res.cpu, res.memory_mb,
                         res.disk_mb, res.iops, _env(a.job)))
    return rows


def live_allocs(snap, job_id: str) -> List[Tuple[str, str]]:
    """Every live allocation of one job as ``(alloc_id, eval_id)``: the
    id it is addressed by and the eval that last wrote it (a block's
    members share the block's eval)."""
    rows = []
    for blk in snap.job_alloc_blocks(job_id):
        rows.extend((blk.alloc_id(pos), blk.eval_id)
                    for pos in blk.live_positions())
    for a in snap.allocs_by_job_objects(job_id):
        if not a.terminal_status():
            rows.append((a.id, a.eval_id))
    return rows
