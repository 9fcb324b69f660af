"""Core data model for the scheduler.

This is a fresh, Python-idiomatic data model with the same capabilities as the
reference's ``nomad/structs/structs.go`` (see SURVEY.md §2.2). Field-for-field
parity is intentional where the scheduler semantics depend on it (resource
dimensions, statuses, plan shape); representation is not (dataclasses instead
of msgpack-tagged Go structs).

Reference citations (``file:line`` into the upstream Nomad tree):
- Node:            nomad/structs/structs.go:447-543
- Resources:       nomad/structs/structs.go:547-621
- Job/TaskGroup/Task: nomad/structs/structs.go:742-1075
- Constraint:      nomad/structs/structs.go:1077-1112
- Allocation:      nomad/structs/structs.go:1129-1222
- AllocMetric:     nomad/structs/structs.go:1227-1307
- Evaluation:      nomad/structs/structs.go:1341-1457
- Plan/PlanResult: nomad/structs/structs.go:1462-1575
- fit/score funcs: nomad/structs/funcs.go:9-124
"""

from __future__ import annotations

import copy as _copy
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Constants
# ---------------------------------------------------------------------------

NODE_STATUS_INIT = "initializing"
NODE_STATUS_READY = "ready"
NODE_STATUS_DOWN = "down"

JOB_TYPE_CORE = "_core"
JOB_TYPE_SERVICE = "service"
JOB_TYPE_BATCH = "batch"
JOB_TYPE_SYSTEM = "system"

JOB_STATUS_PENDING = "pending"
JOB_STATUS_RUNNING = "running"
JOB_STATUS_COMPLETE = "complete"
JOB_STATUS_DEAD = "dead"

JOB_MIN_PRIORITY = 1
JOB_DEFAULT_PRIORITY = 50

# Blocking-query wait ceiling (rpc.go:283-291 maxQueryTime): the server
# clamps client-supplied ?wait to this; transport hops (uplink provider,
# SDK socket) allow MAX_QUERY_TIME + MAX_QUERY_TIME_PAD so a max-length
# poll always outlives the server's clamp, never the other way around.
MAX_QUERY_TIME = 300.0
MAX_QUERY_TIME_PAD = 30.0
JOB_MAX_PRIORITY = 100
CORE_JOB_PRIORITY = JOB_MAX_PRIORITY * 2

ALLOC_DESIRED_STATUS_RUN = "run"
ALLOC_DESIRED_STATUS_STOP = "stop"
ALLOC_DESIRED_STATUS_EVICT = "evict"
ALLOC_DESIRED_STATUS_FAILED = "failed"

ALLOC_CLIENT_STATUS_PENDING = "pending"
ALLOC_CLIENT_STATUS_RUNNING = "running"
ALLOC_CLIENT_STATUS_DEAD = "dead"
ALLOC_CLIENT_STATUS_FAILED = "failed"

EVAL_STATUS_PENDING = "pending"
EVAL_STATUS_COMPLETE = "complete"
EVAL_STATUS_FAILED = "failed"

EVAL_TRIGGER_JOB_REGISTER = "job-register"
EVAL_TRIGGER_JOB_DEREGISTER = "job-deregister"
EVAL_TRIGGER_NODE_UPDATE = "node-update"
EVAL_TRIGGER_SCHEDULED = "scheduled"
EVAL_TRIGGER_ROLLING_UPDATE = "rolling-update"
# Express lane (nomad_tpu/server/express.py): the in-line placement's
# COMPLETE eval, and the PENDING eval a bounced-out/failed-over entry
# reconciles through (the generic scheduler accepts the latter).
EVAL_TRIGGER_EXPRESS = "express"
EVAL_TRIGGER_EXPRESS_RECONCILE = "express-reconcile"

CONSTRAINT_DISTINCT_HOSTS = "distinct_hosts"
CONSTRAINT_REGEX = "regexp"
CONSTRAINT_VERSION = "version"

CORE_JOB_EVAL_GC = "eval-gc"
CORE_JOB_NODE_GC = "node-gc"

# The dense resource dimensions the TPU solver packs into a vector.
# Order matters: it is the column order of node/ask tensors in nomad_tpu.ops.
RESOURCE_DIMS = ("cpu", "memory_mb", "disk_mb", "iops")


def generate_uuid() -> str:
    """Random UUID (reference: nomad/structs/funcs.go:126-139).

    Formatted from os.urandom directly — ~3x faster than uuid.uuid4() and
    hot at bench scale (one per Allocation, 100k per big eval)."""
    h = os.urandom(16).hex()
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"


def generate_uuids(n: int) -> List[str]:
    """Batch of ``n`` UUIDs from one urandom read. One uuid per Allocation is
    hot at bench scale (100k per big eval); batching is ~4x generate_uuid."""
    h = os.urandom(16 * n).hex()
    return [
        f"{h[i:i + 8]}-{h[i + 8:i + 12]}-{h[i + 12:i + 16]}"
        f"-{h[i + 16:i + 20]}-{h[i + 20:i + 32]}"
        for i in range(0, 32 * n, 32)
    ]


# ---------------------------------------------------------------------------
# Errors
# ---------------------------------------------------------------------------


class ValidationError(Exception):
    """Aggregated validation failure (reference uses go-multierror)."""

    def __init__(self, errors: List[str]):
        self.errors = errors
        super().__init__("; ".join(errors))


# ---------------------------------------------------------------------------
# Typed admission/backpressure rejection (nomad_tpu/server/admission.py)
# ---------------------------------------------------------------------------

# Rejection reasons. The front door's whole contract is that a rejection
# is CHEAP and TYPED: the caller learns why it was turned away and when to
# come back, and — critically — that the request provably executed NO
# server-side side effect, so replaying it is always safe.
REJECT_QUEUE_FULL = "QUEUE_FULL"      # acceptance queue at its cap
REJECT_RATE_LIMITED = "RATE_LIMITED"  # per-client token-bucket lane empty
REJECT_SHED = "SHED"                  # SLO-coupled load shedding
REJECT_WATCH_LIMIT = "WATCH_LIMIT"    # blocking-query watcher cap reached
# Stale-lane staleness bound exceeded: the serving follower's last leader
# contact is older than the client's max_stale bound. Retriable by
# construction — a read has no side effects and another server (or the
# same one after its next heartbeat) can satisfy the bound.
REJECT_STALE_BOUND = "STALE_BOUND"

# The wire marker RejectError stringifies to. It must survive the RPC
# error envelope (handlers' exceptions cross as "RejectError: <str(e)>"
# inside a RemoteError) and nested forwarding prefixes, so parse_reject
# regex-searches rather than anchors.
_REJECT_RE = re.compile(
    r"REJECT\[([A-Z_]+) retry_after=([0-9.]+)\](?::\s*(.*))?"
)


class RejectError(Exception):
    """Typed, cheap rejection from the admission/backpressure machinery.

    Carries the reason and a retry-after hint (seconds). Raised BEFORE any
    raft apply / queue mutation, so a rejected request had zero side
    effects and the client may replay it after the hint — the property the
    SDK's retry discipline (backoff.retry_undelivered, api/client.py)
    relies on. Stringifies to a greppable ``REJECT[...]`` marker that
    ``parse_reject`` recovers on the far side of an RPC/HTTP boundary.
    """

    def __init__(self, reason: str, message: str = "",
                 retry_after: float = 0.0):
        self.reason = reason
        self.retry_after = max(0.0, float(retry_after))
        self.message = message
        super().__init__(
            f"REJECT[{reason} retry_after={self.retry_after:.3f}]"
            + (f": {message}" if message else "")
        )


def parse_reject(text: str) -> Optional[RejectError]:
    """Recover a typed RejectError from an error string that crossed a
    transport boundary (RemoteError message, HTTP error body). Returns
    None when the text carries no REJECT marker."""
    m = _REJECT_RE.search(text or "")
    if m is None:
        return None
    try:
        retry_after = float(m.group(2))
    except ValueError:
        retry_after = 0.0
    return RejectError(m.group(1), (m.group(3) or "").strip(),
                       retry_after=retry_after)


# ---------------------------------------------------------------------------
# Resources & network
# ---------------------------------------------------------------------------


@dataclass
class NetworkResource:
    """Network ask/offer (reference: nomad/structs/structs.go:625-703)."""

    device: str = ""
    cidr: str = ""
    ip: str = ""
    mbits: int = 0
    reserved_ports: List[int] = field(default_factory=list)
    dynamic_ports: List[str] = field(default_factory=list)
    # True once this is an *offer* with assigned dynamic ports appended to
    # reserved_ports (set by NetworkIndex.assign_network); raw asks are False.
    offered: bool = False

    def copy(self) -> "NetworkResource":
        new = _copy.copy(self)
        new.reserved_ports = list(self.reserved_ports)
        new.dynamic_ports = list(self.dynamic_ports)
        return new

    def add(self, delta: "NetworkResource") -> None:
        if delta.reserved_ports:
            self.reserved_ports.extend(delta.reserved_ports)
        self.mbits += delta.mbits
        self.dynamic_ports.extend(delta.dynamic_ports)

    def map_dynamic_ports(self) -> Dict[str, int]:
        """Label -> assigned port for dynamic ports; the offer process appends
        assigned dynamic ports to reserved_ports (structs.go:659-696).
        Returns {} on a raw (unoffered) ask — there is nothing assigned yet."""
        if not self.offered:
            return {}
        ports = self.reserved_ports[len(self.reserved_ports) - len(self.dynamic_ports):]
        return {label: ports[i] for i, label in enumerate(self.dynamic_ports)}

    def list_static_ports(self) -> List[int]:
        return self.reserved_ports[: len(self.reserved_ports) - len(self.dynamic_ports)]


@dataclass
class Resources:
    """Schedulable resources (reference: nomad/structs/structs.go:547-621)."""

    cpu: int = 0
    memory_mb: int = 0
    disk_mb: int = 0
    iops: int = 0
    networks: List[NetworkResource] = field(default_factory=list)

    def copy(self) -> "Resources":
        new = _copy.copy(self)
        new.networks = [n.copy() for n in self.networks]
        return new

    def net_index(self, n: NetworkResource) -> int:
        for idx, net in enumerate(self.networks):
            if net.device == n.device:
                return idx
        return -1

    def superset(self, other: "Resources") -> Tuple[bool, str]:
        """Dimension-wise >= check, network handled by NetworkIndex
        (structs.go:577-594)."""
        if self.cpu < other.cpu:
            return False, "cpu exhausted"
        if self.memory_mb < other.memory_mb:
            return False, "memory exhausted"
        if self.disk_mb < other.disk_mb:
            return False, "disk exhausted"
        if self.iops < other.iops:
            return False, "iops exhausted"
        return True, ""

    def add(self, delta: Optional["Resources"]) -> None:
        if delta is None:
            return
        self.cpu += delta.cpu
        self.memory_mb += delta.memory_mb
        self.disk_mb += delta.disk_mb
        self.iops += delta.iops
        for n in delta.networks:
            idx = self.net_index(n)
            if idx == -1:
                self.networks.append(n.copy())
            else:
                self.networks[idx].add(n)

    def as_vector(self) -> Tuple[int, int, int, int]:
        """Dense vector in RESOURCE_DIMS order for the TPU solver."""
        return (self.cpu, self.memory_mb, self.disk_mb, self.iops)


# ---------------------------------------------------------------------------
# Node
# ---------------------------------------------------------------------------


def should_drain_node(status: str) -> bool:
    """Whether a node status forces migrations (structs.go:423-434)."""
    if status in (NODE_STATUS_INIT, NODE_STATUS_READY):
        return False
    if status == NODE_STATUS_DOWN:
        return True
    raise ValueError(f"unhandled node status {status}")


def valid_node_status(status: str) -> bool:
    return status in (NODE_STATUS_INIT, NODE_STATUS_READY, NODE_STATUS_DOWN)


@dataclass
class Node:
    """A schedulable client node (reference: nomad/structs/structs.go:447-543)."""

    id: str = ""
    datacenter: str = ""
    name: str = ""
    attributes: Dict[str, str] = field(default_factory=dict)
    resources: Optional[Resources] = None
    reserved: Optional[Resources] = None
    links: Dict[str, str] = field(default_factory=dict)
    meta: Dict[str, str] = field(default_factory=dict)
    node_class: str = ""
    drain: bool = False
    status: str = ""
    status_description: str = ""
    create_index: int = 0
    modify_index: int = 0

    def terminal_status(self) -> bool:
        return self.status == NODE_STATUS_DOWN

    def copy(self) -> "Node":
        new = _copy.copy(self)
        new.attributes = dict(self.attributes)
        new.links = dict(self.links)
        new.meta = dict(self.meta)
        new.resources = self.resources.copy() if self.resources else None
        new.reserved = self.reserved.copy() if self.reserved else None
        return new

    def stub(self) -> Dict[str, Any]:
        """Summarized view for list endpoints (structs.go:516-529)."""
        return {
            "id": self.id,
            "datacenter": self.datacenter,
            "name": self.name,
            "node_class": self.node_class,
            "drain": self.drain,
            "status": self.status,
            "status_description": self.status_description,
            "create_index": self.create_index,
            "modify_index": self.modify_index,
        }


# ---------------------------------------------------------------------------
# Job / TaskGroup / Task / Constraint
# ---------------------------------------------------------------------------


@dataclass
class UpdateStrategy:
    """Rolling update control (reference: structs.go:897-908).
    ``stagger`` is in seconds (the reference uses time.Duration)."""

    stagger: float = 0.0
    max_parallel: int = 0

    def rolling(self) -> bool:
        return self.stagger > 0 and self.max_parallel > 0


@dataclass
class RestartPolicy:
    """Client-side task restart policy (reference: structs.go:912-935).
    Durations are seconds."""

    attempts: int = 0
    interval: float = 0.0
    delay: float = 0.0

    def validate(self) -> None:
        if self.attempts * self.delay > self.interval:
            raise ValidationError(
                [
                    f"can't restart task group {self.attempts} times in an interval "
                    f"of {self.interval}s with a delay of {self.delay}s"
                ]
            )


DEFAULT_SERVICE_RESTART_POLICY = RestartPolicy(attempts=2, interval=600.0, delay=15.0)
DEFAULT_BATCH_RESTART_POLICY = RestartPolicy(attempts=15, interval=7 * 24 * 3600.0, delay=15.0)


def new_restart_policy(job_type: str) -> Optional[RestartPolicy]:
    if job_type in (JOB_TYPE_SERVICE, JOB_TYPE_SYSTEM):
        return _copy.copy(DEFAULT_SERVICE_RESTART_POLICY)
    if job_type == JOB_TYPE_BATCH:
        return _copy.copy(DEFAULT_BATCH_RESTART_POLICY)
    return None


@dataclass
class Constraint:
    """Placement restriction (reference: structs.go:1077-1112)."""

    l_target: str = ""
    r_target: str = ""
    operand: str = ""

    def __str__(self) -> str:
        return f"{self.l_target} {self.operand} {self.r_target}"

    def validate(self) -> None:
        errors: List[str] = []
        if not self.operand:
            errors.append("missing constraint operand")
        if self.operand == CONSTRAINT_REGEX:
            try:
                re.compile(self.r_target)
            except re.error as e:
                errors.append(f"regular expression failed to compile: {e}")
        elif self.operand == CONSTRAINT_VERSION:
            from nomad_tpu_torch.version import parse_constraints

            try:
                parse_constraints(self.r_target)
            except ValueError as e:
                errors.append(f"version constraint is invalid: {e}")
        if errors:
            raise ValidationError(errors)


@dataclass
class Task:
    """A single schedulable process (reference: structs.go:1027-1075)."""

    name: str = ""
    driver: str = ""
    config: Dict[str, Any] = field(default_factory=dict)
    env: Dict[str, str] = field(default_factory=dict)
    constraints: List[Constraint] = field(default_factory=list)
    resources: Optional[Resources] = None
    meta: Dict[str, str] = field(default_factory=dict)

    def validate(self) -> None:
        errors: List[str] = []
        if not self.name:
            errors.append("missing task name")
        if not self.driver:
            errors.append("missing task driver")
        if self.resources is None:
            errors.append("missing task resources")
        for idx, constr in enumerate(self.constraints):
            try:
                constr.validate()
            except ValidationError as e:
                errors.append(f"constraint {idx + 1} validation failed: {e}")
        if errors:
            raise ValidationError(errors)


@dataclass
class TaskGroup:
    """Atomic unit of placement (reference: structs.go:940-1024)."""

    name: str = ""
    count: int = 1
    constraints: List[Constraint] = field(default_factory=list)
    restart_policy: Optional[RestartPolicy] = None
    tasks: List[Task] = field(default_factory=list)
    meta: Dict[str, str] = field(default_factory=dict)

    def lookup_task(self, name: str) -> Optional[Task]:
        for t in self.tasks:
            if t.name == name:
                return t
        return None

    def validate(self) -> None:
        errors: List[str] = []
        if not self.name:
            errors.append("missing task group name")
        if self.count <= 0:
            errors.append("task group count must be positive")
        if not self.tasks:
            errors.append("missing tasks for task group")
        for idx, constr in enumerate(self.constraints):
            try:
                constr.validate()
            except ValidationError as e:
                errors.append(f"constraint {idx + 1} validation failed: {e}")
        if self.restart_policy is not None:
            try:
                self.restart_policy.validate()
            except ValidationError as e:
                errors.append(str(e))
        else:
            errors.append(f"task group {self.name} should have a restart policy")
        seen: Dict[str, int] = {}
        for idx, task in enumerate(self.tasks):
            if not task.name:
                errors.append(f"task {idx + 1} missing name")
            elif task.name in seen:
                errors.append(
                    f"task {idx + 1} redefines '{task.name}' from task {seen[task.name] + 1}"
                )
            else:
                seen[task.name] = idx
        for idx, task in enumerate(self.tasks):
            try:
                task.validate()
            except ValidationError as e:
                errors.append(f"task {idx + 1} validation failed: {e}")
        if errors:
            raise ValidationError(errors)


@dataclass
class Job:
    """Scope of a scheduling request (reference: structs.go:742-894)."""

    region: str = ""
    id: str = ""
    name: str = ""
    type: str = ""
    priority: int = JOB_DEFAULT_PRIORITY
    all_at_once: bool = False
    # Express-lane opt-in (nomad_tpu/server/express.py): short-lived
    # batch work that prefers sub-millisecond leader-local placement
    # over globally-optimal solving. Eligibility is checked server-side
    # (batch type, small count, no ports); ineligible or lane-off
    # submissions take the ordinary path — the flag is a hint, not a
    # contract change.
    express: bool = False
    datacenters: List[str] = field(default_factory=list)
    constraints: List[Constraint] = field(default_factory=list)
    task_groups: List[TaskGroup] = field(default_factory=list)
    update: UpdateStrategy = field(default_factory=UpdateStrategy)
    meta: Dict[str, str] = field(default_factory=dict)
    status: str = ""
    status_description: str = ""
    create_index: int = 0
    modify_index: int = 0

    def lookup_task_group(self, name: str) -> Optional[TaskGroup]:
        for tg in self.task_groups:
            if tg.name == name:
                return tg
        return None

    def validate(self) -> None:
        errors: List[str] = []
        if not self.region:
            errors.append("missing job region")
        if not self.id:
            errors.append("missing job ID")
        elif " " in self.id:
            errors.append("job ID contains a space")
        if not self.name:
            errors.append("missing job name")
        if not self.type:
            errors.append("missing job type")
        if self.priority < JOB_MIN_PRIORITY or self.priority > JOB_MAX_PRIORITY:
            errors.append(
                f"job priority must be between [{JOB_MIN_PRIORITY}, {JOB_MAX_PRIORITY}]"
            )
        if not self.datacenters:
            errors.append("missing job datacenters")
        if not self.task_groups:
            errors.append("missing job task groups")
        for idx, constr in enumerate(self.constraints):
            try:
                constr.validate()
            except ValidationError as e:
                errors.append(f"constraint {idx + 1} validation failed: {e}")
        seen: Dict[str, int] = {}
        for idx, tg in enumerate(self.task_groups):
            if not tg.name:
                errors.append(f"job task group {idx + 1} missing name")
            elif tg.name in seen:
                errors.append(
                    f"job task group {idx + 1} redefines '{tg.name}' from group {seen[tg.name] + 1}"
                )
            else:
                seen[tg.name] = idx
            if self.type == JOB_TYPE_SYSTEM and tg.count != 1:
                errors.append(
                    f"job task group {idx + 1} has count {tg.count}; "
                    "only count of 1 is supported with system scheduler"
                )
        for idx, tg in enumerate(self.task_groups):
            try:
                tg.validate()
            except ValidationError as e:
                errors.append(f"task group {idx + 1} validation failed: {e}")
        if errors:
            raise ValidationError(errors)

    def stub(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "name": self.name,
            "type": self.type,
            "priority": self.priority,
            "status": self.status,
            "status_description": self.status_description,
            "create_index": self.create_index,
            "modify_index": self.modify_index,
        }


# ---------------------------------------------------------------------------
# Allocation
# ---------------------------------------------------------------------------


@dataclass
class AllocMetric:
    """Per-placement scheduling observability (reference: structs.go:1227-1307)."""

    nodes_evaluated: int = 0
    nodes_filtered: int = 0
    class_filtered: Dict[str, int] = field(default_factory=dict)
    constraint_filtered: Dict[str, int] = field(default_factory=dict)
    nodes_exhausted: int = 0
    class_exhausted: Dict[str, int] = field(default_factory=dict)
    dimension_exhausted: Dict[str, int] = field(default_factory=dict)
    scores: Dict[str, float] = field(default_factory=dict)
    allocation_time: float = 0.0  # seconds
    coalesced_failures: int = 0

    def evaluate_node(self, n: int = 1) -> None:
        self.nodes_evaluated += n

    def filter_node(self, node: Optional[Node], constraint: str, n: int = 1) -> None:
        self.nodes_filtered += n
        if node is not None and node.node_class:
            self.class_filtered[node.node_class] = (
                self.class_filtered.get(node.node_class, 0) + n
            )
        if constraint:
            self.constraint_filtered[constraint] = (
                self.constraint_filtered.get(constraint, 0) + n
            )

    def exhausted_node(self, node: Optional[Node], dimension: str, n: int = 1) -> None:
        self.nodes_exhausted += n
        if node is not None and node.node_class:
            self.class_exhausted[node.node_class] = (
                self.class_exhausted.get(node.node_class, 0) + n
            )
        if dimension:
            self.dimension_exhausted[dimension] = (
                self.dimension_exhausted.get(dimension, 0) + n
            )

    def score_node(self, node: Node, name: str, score: float) -> None:
        self.scores[f"{node.id}.{name}"] = score


@dataclass
class Allocation:
    """Placement of a task group on a node (reference: structs.go:1129-1222)."""

    id: str = ""
    eval_id: str = ""
    name: str = ""
    node_id: str = ""
    job_id: str = ""
    job: Optional[Job] = None
    task_group: str = ""
    resources: Optional[Resources] = None
    task_resources: Dict[str, Resources] = field(default_factory=dict)
    metrics: Optional[AllocMetric] = None
    desired_status: str = ""
    desired_description: str = ""
    client_status: str = ""
    client_description: str = ""
    create_index: int = 0
    modify_index: int = 0

    def terminal_status(self) -> bool:
        """Based on desired status, like the reference (structs.go:1179-1188)."""
        return self.desired_status in (
            ALLOC_DESIRED_STATUS_STOP,
            ALLOC_DESIRED_STATUS_EVICT,
            ALLOC_DESIRED_STATUS_FAILED,
        )

    def copy(self) -> "Allocation":
        """Shallow copy mirroring Go's ``*newAlloc = *alloc``."""
        return _copy.copy(self)

    def stub(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "eval_id": self.eval_id,
            "name": self.name,
            "node_id": self.node_id,
            "job_id": self.job_id,
            "task_group": self.task_group,
            "desired_status": self.desired_status,
            "desired_description": self.desired_description,
            "client_status": self.client_status,
            "client_description": self.client_description,
            "create_index": self.create_index,
            "modify_index": self.modify_index,
        }


# ---------------------------------------------------------------------------
# Evaluation / Plan
# ---------------------------------------------------------------------------


@dataclass
class Evaluation:
    """Unit of scheduler work (reference: structs.go:1341-1457)."""

    id: str = ""
    priority: int = 0
    type: str = ""
    triggered_by: str = ""
    job_id: str = ""
    job_modify_index: int = 0
    node_id: str = ""
    node_modify_index: int = 0
    status: str = ""
    status_description: str = ""
    wait: float = 0.0  # seconds
    next_eval: str = ""
    previous_eval: str = ""
    create_index: int = 0
    modify_index: int = 0

    def terminal_status(self) -> bool:
        return self.status in (EVAL_STATUS_COMPLETE, EVAL_STATUS_FAILED)

    def copy(self) -> "Evaluation":
        return _copy.copy(self)

    def should_enqueue(self) -> bool:
        if self.status == EVAL_STATUS_PENDING:
            return True
        if self.status in (EVAL_STATUS_COMPLETE, EVAL_STATUS_FAILED):
            return False
        raise ValueError(f"unhandled evaluation ({self.id}) status {self.status}")

    def make_plan(self, job: Optional[Job]) -> "Plan":
        plan = Plan(
            eval_id=self.id,
            priority=self.priority,
            node_update={},
            node_allocation={},
        )
        if job is not None:
            plan.all_at_once = job.all_at_once
        return plan

    def next_rolling_eval(self, wait: float) -> "Evaluation":
        return Evaluation(
            id=generate_uuid(),
            priority=self.priority,
            type=self.type,
            triggered_by=EVAL_TRIGGER_ROLLING_UPDATE,
            job_id=self.job_id,
            job_modify_index=self.job_modify_index,
            status=EVAL_STATUS_PENDING,
            wait=wait,
            previous_eval=self.id,
        )


class AllocBatch:
    """Columnar block of placements sharing one (eval, job, task group).

    The TPU-native alternative to per-Allocation object flow: a big solve
    returns per-node placement counts, and this block carries them through
    plan verification and commit as arrays — node runs, name indices, and a
    single hex block for ids — materializing Allocation objects only at the
    FSM/state boundary. The reference has no analog (every placement is an
    individual Allocation, structs.go:1129-1222); semantically a batch is
    exactly its ``materialize()`` expansion.

    Layout:
    - ``node_ids``/``node_counts``: run-length encoded placements per node,
      in solve-output order.
    - ``name_idx``: per-placement index into the task group's count
      expansion (util.go:19-34 names ``job.tg[i]``), aligned with the
      run expansion order.
    - ``ids_hex``: 32 hex chars per placement; alloc ids are formatted
      lazily from slices. The hex itself is DERIVED, not stored: a batch
      built with ``ids_seed`` (a 128-bit int) expands the seed through a
      deterministic SHAKE-256 stream on first read — id i is always bytes
      [16i, 16i+16) of the stream, so every replica's FSM derives
      identical ids from the 16-byte seed that rode the wire/log instead
      of a multi-MB hex column. The scheduler's hot path never reads ids
      (plan verify is columnar), so at headline scale the entropy+hex
      cost (~4ms/100k ids) simply never happens until a client syncs.
    """

    __slots__ = (
        "eval_id", "job", "tg_name", "resources", "task_resources",
        "metrics", "node_ids", "node_counts", "name_idx", "_ids_hex",
        "ids_seed", "src_ids_ref", "src_rows",
    )

    def __init__(self, eval_id="", job=None, tg_name="", resources=None,
                 task_resources=None, metrics=None, node_ids=None,
                 node_counts=None, name_idx=None, ids_hex="",
                 ids_seed=None):
        self.eval_id = eval_id
        self.job = job
        self.tg_name = tg_name
        self.resources = resources
        self.task_resources = task_resources or {}
        self.metrics = metrics
        self.node_ids: List[str] = node_ids or []
        self.node_counts: List[int] = node_counts or []
        # Always an int64 ndarray: every consumer (block reconcile, name
        # materialization) may index or .max() it, and construction paths
        # (filter_nodes partial keep, from_wire) otherwise hand in lists.
        import numpy as _np

        self.name_idx = (
            None if name_idx is None
            else _np.asarray(name_idx, dtype=_np.int64)
        )
        self.ids_seed = ids_seed
        # Explicit hex wins (wire compat, partial-keep slices); a seed
        # without hex stays lazy until something actually reads ids.
        self._ids_hex = ids_hex if ids_hex or ids_seed is None else None
        # Optional solver-mirror row hint (NOT serialized): the mirror's
        # id array plus row indices into it, aligned with node_ids. Lets
        # the plan verifier resolve node runs as array gathers; any path
        # that can't keep the alignment (wire, partial keep) leaves it
        # None and the verifier falls back to id lookups.
        self.src_ids_ref = None
        self.src_rows = None

    @property
    def n(self) -> int:
        return len(self.name_idx) if self.name_idx is not None else 0

    @property
    def src_hint(self):
        """(mirror id array, row indices) when the solver recorded where
        this batch's node runs live in its mirror, else None."""
        if self.src_rows is None or self.src_ids_ref is None:
            return None
        return (self.src_ids_ref, self.src_rows)

    @property
    def ids_hex(self) -> str:
        h = self._ids_hex
        if h is None:
            h = self._derive_ids_hex(self.n)
            self._ids_hex = h
        return h

    def _derive_ids_hex(self, count: int) -> str:
        """Expand the seed into ``count`` 32-hex-char ids via SHAKE-256.
        An XOF's output is a stream — shorter digests are prefixes of
        longer ones — and FIPS-202 pins the stream bit-for-bit forever,
        so replicas (and future interpreter/library versions) derive
        identical ids from a logged seed. A PRNG would be faster but
        numpy guarantees no cross-version stream stability, which a
        durable id column cannot tolerate."""
        import hashlib

        seed = int(self.ids_seed).to_bytes(16, "little", signed=False)
        return hashlib.shake_256(seed).hexdigest(16 * count)

    @property
    def ids_lazy(self) -> bool:
        """True while the id column is still an unexpanded seed."""
        return self._ids_hex is None

    def alloc_id(self, i: int) -> str:
        if self._ids_hex is None and i == 0:
            # First-member id (the deterministic block id) without
            # expanding the whole column: an XOF's 16-byte digest is a
            # prefix of any longer digest from the same input.
            h = self._derive_ids_hex(1)
        else:
            h = self.ids_hex[32 * i: 32 * i + 32]
        return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"

    def resource_vector(self) -> List[int]:
        if self.resources is None:
            return [0, 0, 0, 0]
        return self.resources.as_vector()

    def filter_nodes(self, fit: Dict[str, bool]) -> "AllocBatch":
        """Committable subset: keep only runs on nodes with fit=True.
        Per-placement columns stay aligned because runs are contiguous."""
        if all(fit.get(nid, False) for nid in self.node_ids):
            return self
        node_ids: List[str] = []
        node_counts: List[int] = []
        keep_slices = []
        pos = 0
        for nid, cnt in zip(self.node_ids, self.node_counts):
            if fit.get(nid, False):
                node_ids.append(nid)
                node_counts.append(cnt)
                keep_slices.append((pos, pos + cnt))
            pos += cnt
        name_idx = [v for s, e in keep_slices for v in self.name_idx[s:e]]
        ids_hex = "".join(
            self.ids_hex[32 * s: 32 * e] for s, e in keep_slices
        )
        return AllocBatch(
            eval_id=self.eval_id, job=self.job, tg_name=self.tg_name,
            resources=self.resources, task_resources=self.task_resources,
            metrics=self.metrics, node_ids=node_ids, node_counts=node_counts,
            name_idx=name_idx, ids_hex=ids_hex,
        )

    # Stored-form overrides (state/blocks.py StoredAllocBlock): a plain
    # batch has no commit indexes and no excluded members.
    create_index = 0
    modify_index = 0
    excluded: frozenset = frozenset()

    def _template(self) -> dict:
        job_name = self.job.name if self.job is not None else ""
        job_id = self.job.id if self.job is not None else ""
        return {
            "id": "", "eval_id": self.eval_id, "name": "", "node_id": "",
            "job_id": job_id, "job": self.job, "task_group": self.tg_name,
            "resources": self.resources,
            "task_resources": self.task_resources, "metrics": self.metrics,
            "desired_status": ALLOC_DESIRED_STATUS_RUN,
            "desired_description": "",
            "client_status": ALLOC_CLIENT_STATUS_PENDING,
            "client_description": "",
            "create_index": self.create_index,
            "modify_index": self.modify_index,
            "_job_name": job_name,
        }

    def _materialize_span(self, template: dict, node_id: str, start: int,
                          end: int, out: List["Allocation"]) -> None:
        """Expand positions [start, end) on one node, skipping excluded
        members. The single template-and-expand implementation shared by
        the wire batch and the stored block."""
        new = object.__new__
        copy_t = template.copy
        prefix = f"{template['_job_name']}.{self.tg_name}["
        excluded = self.excluded
        for i in range(start, end):
            if i in excluded:
                continue
            d = copy_t()
            del d["_job_name"]
            d["id"] = self.alloc_id(i)
            d["name"] = f"{prefix}{self.name_idx[i]}]"
            d["node_id"] = node_id
            alloc = new(Allocation)
            alloc.__dict__ = d
            out.append(alloc)

    def materialize(self) -> List["Allocation"]:
        """Expand to Allocation objects (the FSM/state-boundary form)."""
        out: List[Allocation] = []
        template = self._template()
        pos = 0
        for nid, cnt in zip(self.node_ids, self.node_counts):
            self._materialize_span(template, nid, pos, pos + cnt, out)
            pos += cnt
        return out

    def to_wire(self) -> dict:
        from nomad_tpu_torch.api.codec import to_dict

        d = {
            "eval_id": self.eval_id,
            "job": to_dict(self.job),
            "tg_name": self.tg_name,
            "resources": to_dict(self.resources),
            "task_resources": to_dict(self.task_resources),
            "metrics": to_dict(self.metrics),
            "node_ids": list(self.node_ids),
            "node_counts": [int(c) for c in self.node_counts],
            "name_idx": [int(i) for i in self.name_idx],
        }
        if self._ids_hex is None:
            # Still seed-form: 32 hex chars ride the wire instead of the
            # 32·n-char expanded column; the receiver derives identically.
            d["ids_seed"] = "{:032x}".format(self.ids_seed)
        else:
            d["ids_hex"] = self._ids_hex
        return d

    @staticmethod
    def from_wire(d: dict) -> "AllocBatch":
        from nomad_tpu_torch.api.codec import from_dict

        seed = d.get("ids_seed")
        return AllocBatch(
            eval_id=d.get("eval_id", ""),
            job=from_dict(Job, d.get("job")),
            tg_name=d.get("tg_name", ""),
            resources=from_dict(Resources, d.get("resources")),
            metrics=from_dict(AllocMetric, d.get("metrics")),
            task_resources={
                k: from_dict(Resources, v)
                for k, v in (d.get("task_resources") or {}).items()
            },
            node_ids=d.get("node_ids") or [],
            node_counts=d.get("node_counts") or [],
            name_idx=d.get("name_idx") or [],
            ids_hex=d.get("ids_hex", ""),
            ids_seed=int(seed, 16) if seed is not None else None,
        )


class AllocUpdateBatch:
    """Columnar in-place update block: re-stamp existing allocations with a
    new job version without per-allocation device selects or object churn
    in the scheduler (reference semantics: util.go:316-398 inplaceUpdate).
    tasksUpdated (util.go:265-302) deliberately ignores cpu/mem changes,
    so an in-place update may grow or shrink the allocation: feasibility
    is the per-node sum of (new - old) resource deltas against current
    usage, checked vectorized by the scheduler and re-checked by plan
    evaluation.

    Locally the batch holds references to the existing allocations; on the
    wire it carries only their ids (the receiving server re-resolves them
    against its own state), plus the shared replacement fields.
    """

    __slots__ = ("eval_id", "job", "tg_name", "resources", "task_resources",
                 "metrics", "allocs", "alloc_ids",
                 "src_node_ids", "src_node_counts", "src_resources")

    def __init__(self, eval_id="", job=None, tg_name="", resources=None,
                 task_resources=None, metrics=None, allocs=None,
                 alloc_ids=None, src_node_ids=None, src_node_counts=None,
                 src_resources=None):
        self.eval_id = eval_id
        self.job = job
        self.tg_name = tg_name
        self.resources = resources
        self.task_resources = task_resources or {}
        self.metrics = metrics
        self.allocs: List[Allocation] = allocs or []
        # Wire-side form: ids only, resolved via snapshot at materialize.
        self.alloc_ids: List[str] = alloc_ids or [
            a.id for a in (allocs or [])
        ]
        # Block-columnar source form (the fully object-free path): when a
        # whole StoredAllocBlock updates in place, the batch carries the
        # block's node run-length encoding and the SHARED old Resources —
        # plan evaluation computes per-node deltas from these columns and
        # never materializes a member. alloc_ids stay populated (position
        # order) for the store's member addressing.
        self.src_node_ids: List[str] = src_node_ids or []
        self.src_node_counts: List[int] = src_node_counts or []
        self.src_resources: Optional[Resources] = src_resources

    @property
    def n(self) -> int:
        return len(self.alloc_ids)

    def node_ids(self) -> List[str]:
        return [a.node_id for a in self.allocs]

    def resource_vector(self) -> List[int]:
        if self.resources is None:
            return [0, 0, 0, 0]
        return self.resources.as_vector()

    def resolve(self, snap) -> None:
        """Rebind alloc references from ids against a state snapshot (the
        wire path). Unknown ids are dropped — they were removed while the
        plan was in flight, exactly the staleness plan evaluation guards.
        The block-columnar form needs no rebinding: its delta accounting
        reads the source columns and the store addresses members by id."""
        if self.src_node_ids:
            return
        if self.allocs and len(self.allocs) == len(self.alloc_ids):
            return
        out = []
        for aid in self.alloc_ids:
            a = snap.alloc_by_id(aid)
            if a is not None:
                out.append(a)
        self.allocs = out
        self.alloc_ids = [a.id for a in out]

    def filter_nodes(self, fit: Dict[str, bool]) -> "AllocUpdateBatch":
        if self.src_node_ids:
            if all(fit.get(nid, False) for nid in self.src_node_ids):
                return self
            # Drop unfit nodes' runs: alloc_ids are in position order, so
            # each run owns a contiguous id slice.
            keep_ids: List[str] = []
            keep_nids: List[str] = []
            keep_counts: List[int] = []
            pos = 0
            for nid, cnt in zip(self.src_node_ids, self.src_node_counts):
                if fit.get(nid, False):
                    keep_ids.extend(self.alloc_ids[pos:pos + cnt])
                    keep_nids.append(nid)
                    keep_counts.append(cnt)
                pos += cnt
            return AllocUpdateBatch(
                eval_id=self.eval_id, job=self.job, tg_name=self.tg_name,
                resources=self.resources,
                task_resources=self.task_resources,
                metrics=self.metrics, alloc_ids=keep_ids,
                src_node_ids=keep_nids, src_node_counts=keep_counts,
                src_resources=self.src_resources,
            )
        if all(fit.get(a.node_id, False) for a in self.allocs):
            return self
        kept = [a for a in self.allocs if fit.get(a.node_id, False)]
        return AllocUpdateBatch(
            eval_id=self.eval_id, job=self.job, tg_name=self.tg_name,
            resources=self.resources, task_resources=self.task_resources,
            metrics=self.metrics, allocs=kept,
        )

    def materialize(self) -> List["Allocation"]:
        out = []
        for alloc in self.allocs:
            new_alloc = alloc.copy()
            new_alloc.eval_id = self.eval_id
            new_alloc.job = self.job
            if self.resources is not None:
                new_alloc.resources = self.resources
            if self.task_resources:
                new_alloc.task_resources = self.task_resources
            new_alloc.metrics = self.metrics
            new_alloc.desired_status = ALLOC_DESIRED_STATUS_RUN
            new_alloc.desired_description = ""
            new_alloc.client_status = ALLOC_CLIENT_STATUS_PENDING
            out.append(new_alloc)
        return out

    def to_wire(self) -> dict:
        from nomad_tpu_torch.api.codec import to_dict

        return {
            "kind": "update",
            "eval_id": self.eval_id,
            "job": to_dict(self.job),
            "tg_name": self.tg_name,
            "resources": to_dict(self.resources),
            "task_resources": to_dict(self.task_resources),
            "metrics": to_dict(self.metrics),
            "alloc_ids": list(self.alloc_ids),
            "src_node_ids": list(self.src_node_ids),
            "src_node_counts": list(self.src_node_counts),
            "src_resources": to_dict(self.src_resources),
        }

    @staticmethod
    def from_wire(d: dict) -> "AllocUpdateBatch":
        from nomad_tpu_torch.api.codec import from_dict

        return AllocUpdateBatch(
            eval_id=d.get("eval_id", ""),
            job=from_dict(Job, d.get("job")),
            tg_name=d.get("tg_name", ""),
            resources=from_dict(Resources, d.get("resources")),
            task_resources={
                k: from_dict(Resources, v)
                for k, v in (d.get("task_resources") or {}).items()
            },
            metrics=from_dict(AllocMetric, d.get("metrics")),
            alloc_ids=d.get("alloc_ids") or [],
            src_node_ids=d.get("src_node_ids") or [],
            src_node_counts=d.get("src_node_counts") or [],
            src_resources=from_dict(Resources, d.get("src_resources")),
        )


@dataclass
class Plan:
    """Commit plan for task allocations (reference: structs.go:1462-1532).

    ``alloc_batches`` extends the reference's per-node Allocation lists with
    columnar placement blocks (AllocBatch) for large solves;
    ``update_batches`` carries columnar in-place updates."""

    eval_id: str = ""
    eval_token: str = ""
    # Trace span context of the submitting worker (nomad_tpu.trace): rides
    # the Plan.Submit envelope so the leader's applier parents its plan.*
    # spans on the worker's submit span across the RPC boundary.
    span_ctx: Dict[str, str] = field(default_factory=dict)
    priority: int = 0
    all_at_once: bool = False
    # Raft applied index of the snapshot the submitting worker evaluated
    # against — the optimistic-concurrency transaction timestamp (Omega
    # posture): the plan pipeline attributes a verification failure as a
    # CONFLICT iff capacity committed after this index overlaps the
    # plan's touched nodes. 0 = unknown (legacy/wire submitters): no
    # attribution, plain stale-data refresh semantics.
    snapshot_index: int = 0
    # Express-lane provenance (nomad_tpu/server/express.py): the id of
    # the leased capacity reservation this plan's placements were
    # promised under. Non-empty marks an express async-commit plan: the
    # pipeline skips broker bookkeeping for it (the eval never rode the
    # broker) and plan verification exempts THIS lease from the ledger
    # debits it folds in (a plan must not double-count its own
    # reservation against itself).
    express_lease: str = ""
    node_update: Dict[str, List[Allocation]] = field(default_factory=dict)
    node_allocation: Dict[str, List[Allocation]] = field(default_factory=dict)
    failed_allocs: List[Allocation] = field(default_factory=list)
    alloc_batches: List[AllocBatch] = field(default_factory=list)
    update_batches: List[AllocUpdateBatch] = field(default_factory=list)

    def append_update(self, alloc: Allocation, status: str, desc: str) -> None:
        new_alloc = alloc.copy()
        new_alloc.desired_status = status
        new_alloc.desired_description = desc
        self.node_update.setdefault(alloc.node_id, []).append(new_alloc)

    def pop_update(self, alloc: Allocation) -> None:
        existing = self.node_update.get(alloc.node_id, [])
        if existing and existing[-1].id == alloc.id:
            existing.pop()
            if not existing:
                self.node_update.pop(alloc.node_id, None)

    def append_alloc(self, alloc: Allocation) -> None:
        self.node_allocation.setdefault(alloc.node_id, []).append(alloc)

    def append_batch(self, batch: AllocBatch) -> None:
        self.alloc_batches.append(batch)

    def append_update_batch(self, batch: AllocUpdateBatch) -> None:
        self.update_batches.append(batch)

    def append_failed(self, alloc: Allocation) -> None:
        self.failed_allocs.append(alloc)

    def is_noop(self) -> bool:
        return (
            not self.node_update
            and not self.node_allocation
            and not self.failed_allocs
            and not self.alloc_batches
            and not self.update_batches
        )


@dataclass
class PlanResult:
    """Result of a plan submitted to the leader (reference: structs.go:1534-1575)."""

    node_update: Dict[str, List[Allocation]] = field(default_factory=dict)
    node_allocation: Dict[str, List[Allocation]] = field(default_factory=dict)
    failed_allocs: List[Allocation] = field(default_factory=list)
    alloc_batches: List[AllocBatch] = field(default_factory=list)
    update_batches: List[AllocUpdateBatch] = field(default_factory=list)
    refresh_index: int = 0
    alloc_index: int = 0
    # Transaction-time conflict attribution (plan_pipeline): the refresh
    # was caused by capacity another plan committed after this plan's
    # snapshot (same pipeline batch or since) — as opposed to data that
    # was already stale in the submitter's own snapshot.
    conflict: bool = False

    def is_noop(self) -> bool:
        return (
            not self.node_update
            and not self.node_allocation
            and not self.failed_allocs
            and not self.alloc_batches
            and not self.update_batches
        )

    def full_commit(self, plan: Plan) -> Tuple[bool, int, int]:
        expected = 0
        actual = 0
        for node_id, alloc_list in plan.node_allocation.items():
            expected += len(alloc_list)
            actual += len(self.node_allocation.get(node_id, []))
        expected += sum(b.n for b in plan.alloc_batches)
        actual += sum(b.n for b in self.alloc_batches)
        expected += sum(b.n for b in plan.update_batches)
        actual += sum(b.n for b in self.update_batches)
        return actual == expected, expected, actual


# ---------------------------------------------------------------------------
# Fit & score functions (reference: nomad/structs/funcs.go)
# ---------------------------------------------------------------------------


def remove_allocs(allocs: List[Allocation], remove: List[Allocation]) -> List[Allocation]:
    """Remove allocs with matching IDs (funcs.go:9-29). Non-destructive."""
    remove_set = {a.id for a in remove}
    return [a for a in allocs if a.id not in remove_set]


def filter_terminal_allocs(allocs: List[Allocation]) -> List[Allocation]:
    """Drop terminal-state allocations (funcs.go:31-42). Non-destructive."""
    return [a for a in allocs if not a.terminal_status()]


def allocs_fit(
    node: Node,
    allocs: List[Allocation],
    net_idx: Optional["NetworkIndex"] = None,
) -> Tuple[bool, str, Resources]:
    """Check if a set of allocations fits on a node: resource superset +
    port-collision + bandwidth overcommit (funcs.go:44-87).

    Returns (fit, exhausted_dimension, used_resources).
    """
    from nomad_tpu_torch.network import NetworkIndex

    used = Resources()
    if node.reserved is not None:
        used.add(node.reserved)
    for alloc in allocs:
        used.add(alloc.resources)

    ok, dimension = node.resources.superset(used)
    if not ok:
        return False, dimension, used

    if net_idx is None:
        net_idx = NetworkIndex()
        if net_idx.set_node(node) or net_idx.add_allocs(allocs):
            return False, "reserved port collision", used

    if net_idx.overcommitted():
        return False, "bandwidth exceeded", used

    return True, "", used


def score_fit(node: Node, util: Resources) -> float:
    """Google "BestFit v3" bin-packing score (funcs.go:89-124).

    0 at empty node, 18 at perfect fit; higher is better. The TPU solver
    computes exactly this in nomad_tpu.ops.fit.score_fit_kernel, so the two
    paths are numerically comparable.
    """
    node_cpu = float(node.resources.cpu)
    node_mem = float(node.resources.memory_mb)
    if node.reserved is not None:
        node_cpu -= float(node.reserved.cpu)
        node_mem -= float(node.reserved.memory_mb)

    # A fully-reserved dimension has no schedulable capacity; treat as
    # -inf free so 10**x underflows to 0 and the score clamps, matching
    # Go's Inf-tolerant division + math.Pow instead of raising.
    free_pct_cpu = 1.0 - (float(util.cpu) / node_cpu) if node_cpu > 0 else float("-inf")
    free_pct_ram = (
        1.0 - (float(util.memory_mb) / node_mem) if node_mem > 0 else float("-inf")
    )
    total = 10.0**free_pct_cpu + 10.0**free_pct_ram
    score = 20.0 - total
    return min(18.0, max(0.0, score))
