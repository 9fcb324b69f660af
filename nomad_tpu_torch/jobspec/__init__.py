"""Jobspec: HCL -> Job.

Reference: upstream jobspec/parse.go. Semantics preserved:
- exactly one ``job "<id>"`` block; id + name default to the label
- defaults: priority 50, region "global", type "service" (parse.go:98-101)
- repeated ``meta`` blocks merge; values stringified (weak decode)
- standalone ``task`` blocks become single-task groups with count 1
  (parse.go:144-160)
- constraint sugar: ``version``/``regexp``/``distinct_hosts`` keys set the
  operand (parse.go:296-347); default operand "="
- durations like "60s"/"10m" in update/restart blocks
- dynamic port labels validated against ^[a-zA-Z0-9_]+$ with
  case-insensitive collision detection (parse.go:19-20, 499-514)
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

from nomad_tpu_torch import structs
from nomad_tpu_torch.jobspec.hcl import Block, Body, HCLParseError, parse as hcl_parse
from nomad_tpu_torch.structs import (
    Constraint,
    Job,
    NetworkResource,
    Resources,
    RestartPolicy,
    Task,
    TaskGroup,
    UpdateStrategy,
    new_restart_policy,
)

RE_DYNAMIC_PORTS = re.compile(r"^[a-zA-Z0-9_]+$")


class JobspecError(Exception):
    pass


_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")
_DURATION_UNITS = {
    "ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3,
    "s": 1.0, "m": 60.0, "h": 3600.0,
}


def parse_duration(value: Any) -> float:
    """Go-style duration to seconds: "60s", "10m", "1h30m". Bare numbers are
    nanoseconds, like Go's time.Duration integer semantics."""
    if isinstance(value, (int, float)):
        return float(value) * 1e-9
    s = str(value).strip()
    if not s:
        return 0.0
    pos = 0
    total = 0.0
    for m in _DURATION_RE.finditer(s):
        if m.start() != pos:
            raise JobspecError(f"invalid duration {value!r}")
        total += float(m.group(1)) * _DURATION_UNITS[m.group(2)]
        pos = m.end()
    if pos != len(s):
        raise JobspecError(f"invalid duration {value!r}")
    return total


def _stringify(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def _stringify_map(m: Dict[str, Any]) -> Dict[str, str]:
    """Weak decode: HCL numbers/bools in meta/env become strings."""
    return {k: _stringify(v) for k, v in m.items()}


def _config_map(m: Dict[str, Any]) -> Dict[str, Any]:
    """Task config keeps list values (reference Config is
    map[string]interface{}); scalars are stringified."""
    return {
        k: [_stringify(i) for i in v] if isinstance(v, list) else _stringify(v)
        for k, v in m.items()
    }


def parse(text: str) -> Job:
    """Parse a jobspec string into a Job (reference: parse.go:22-58)."""
    try:
        root = hcl_parse(text)
    except HCLParseError as e:
        raise JobspecError(f"error parsing: {e}") from e

    jobs = root.blocks("job")
    if not jobs:
        raise JobspecError("'job' stanza not found")
    if len(jobs) > 1:
        raise JobspecError("only one 'job' block allowed")
    return _parse_job(jobs[0])


def parse_file(path: str) -> Job:
    """reference: parse.go:60-74"""
    with open(path) as f:
        return parse(f.read())


def _parse_job(block: Block) -> Job:
    """reference: parse.go:76-170"""
    if not block.labels:
        raise JobspecError("job block requires a name label")
    body = block.body

    job = Job(
        id=body.get("id", block.labels[0]),
        name=body.get("name", block.labels[0]),
        region=str(body.get("region", "global")),
        type=str(body.get("type", "service")),
        priority=int(body.get("priority", 50)),
        all_at_once=bool(body.get("all_at_once", False)),
        # Express-lane opt-in (nomad_tpu_torch/server/express.py; tpu-native
        # extension, no reference analog): `express = true` on a batch
        # job requests leader-local sub-millisecond placement.
        express=bool(body.get("express", False)),
        datacenters=[str(d) for d in body.get("datacenters", [])],
    )

    job.constraints = _parse_constraints(body)
    updates = body.blocks("update")
    if updates:
        if len(updates) > 1:
            raise JobspecError("only one 'update' block allowed per job")
        u = updates[0].body
        job.update = UpdateStrategy(
            stagger=parse_duration(u.get("stagger", 0)),
            max_parallel=int(u.get("max_parallel", 0)),
        )
    job.meta = _stringify_map(body.merged_map("meta"))

    # Standalone tasks become single-task groups (parse.go:144-160)
    for task in _parse_tasks(body):
        job.task_groups.append(
            TaskGroup(
                name=task.name,
                count=1,
                tasks=[task],
                restart_policy=new_restart_policy(job.type),
            )
        )

    seen = set()
    for group_block in body.blocks("group"):
        if not group_block.labels:
            raise JobspecError("group block requires a name label")
        name = group_block.labels[0]
        if name in seen:
            raise JobspecError(f"group '{name}' defined more than once")
        seen.add(name)
        job.task_groups.append(_parse_group(name, group_block.body, job.type))

    return job


def _parse_group(name: str, body: Body, job_type: str) -> TaskGroup:
    """reference: parse.go:172-260"""
    group = TaskGroup(
        name=name,
        count=int(body.get("count", 1)),
        constraints=_parse_constraints(body),
        meta=_stringify_map(body.merged_map("meta")),
        tasks=_parse_tasks(body),
        restart_policy=new_restart_policy(job_type),
    )
    restarts = body.blocks("restart")
    if restarts:
        if len(restarts) > 1:
            raise JobspecError("only one 'restart' block allowed")
        r = restarts[0].body
        group.restart_policy = RestartPolicy(
            attempts=int(r.get("attempts", 0)),
            interval=parse_duration(r.get("interval", 0)),
            delay=parse_duration(r.get("delay", 0)),
        )
    return group


def _parse_tasks(body: Body) -> List[Task]:
    """reference: parse.go:349-452"""
    tasks: List[Task] = []
    seen = set()
    for task_block in body.blocks("task"):
        if not task_block.labels:
            raise JobspecError("task block requires a name label")
        name = task_block.labels[0]
        if name in seen:
            raise JobspecError(f"task '{name}' defined more than once")
        seen.add(name)
        tb = task_block.body

        task = Task(
            name=name,
            driver=str(tb.get("driver", "")),
            env=_stringify_map(tb.merged_map("env")),
            config=_config_map(tb.merged_map("config")),
            constraints=_parse_constraints(tb),
            meta=_stringify_map(tb.merged_map("meta")),
        )

        resources = tb.blocks("resources")
        if resources:
            if len(resources) > 1:
                raise JobspecError("only one 'resource' block allowed per task")
            task.resources = _parse_resources(resources[0].body)
        tasks.append(task)
    return tasks


def _parse_resources(body: Body) -> Resources:
    """reference: parse.go:454-520"""
    res = Resources(
        cpu=int(body.get("cpu", 0)),
        memory_mb=int(body.get("memory", 0)),
        disk_mb=int(body.get("disk", 0)),
        iops=int(body.get("iops", 0)),
    )
    networks = body.blocks("network")
    if networks:
        if len(networks) > 1:
            raise JobspecError("only one 'network' resource allowed")
        nb = networks[0].body
        net = NetworkResource(
            mbits=int(nb.get("mbits", 0)),
            reserved_ports=[int(p) for p in nb.get("reserved_ports", [])],
            dynamic_ports=[str(p) for p in nb.get("dynamic_ports", [])],
        )
        seen_label: Dict[str, str] = {}
        for label in net.dynamic_ports:
            if not RE_DYNAMIC_PORTS.match(label):
                raise JobspecError(
                    "DynamicPort label does not conform to naming requirements "
                    + RE_DYNAMIC_PORTS.pattern
                )
            first = seen_label.get(label.lower())
            if first is not None:
                raise JobspecError(
                    f"Found a port label collision: `{label}` overlaps with "
                    f"previous `{first}`"
                )
            seen_label[label.lower()] = label
        res.networks = [net]
    return res


def _parse_constraints(body: Body) -> List[Constraint]:
    """reference: parse.go:296-347"""
    out: List[Constraint] = []
    for block in body.blocks("constraint"):
        b = block.body
        l_target = str(b.get("attribute", "") or "")
        r_target = b.get("value", "")
        operand = str(b.get("operator", "") or "")

        if b.has(structs.CONSTRAINT_VERSION):
            operand = structs.CONSTRAINT_VERSION
            r_target = b.get(structs.CONSTRAINT_VERSION)
        if b.has(structs.CONSTRAINT_REGEX):
            operand = structs.CONSTRAINT_REGEX
            r_target = b.get(structs.CONSTRAINT_REGEX)
        if b.has(structs.CONSTRAINT_DISTINCT_HOSTS):
            raw = str(b.get(structs.CONSTRAINT_DISTINCT_HOSTS)).lower()
            if raw not in ("true", "false", "1", "0", "t", "f"):
                raise JobspecError(f"invalid distinct_hosts value {raw!r}")
            if raw in ("false", "0", "f"):
                continue
            operand = structs.CONSTRAINT_DISTINCT_HOSTS

        if not operand:
            operand = "="
        out.append(
            Constraint(l_target=l_target, r_target=str(r_target), operand=operand)
        )
    return out
