"""Canonical test fixtures, mirroring the reference's mock package
(upstream nomad/mock/mock.go) so ported scheduler tests anchor to the
same cluster shapes (4000 CPU / 8GB node; service job with count=10 exec web
task; system job; pending eval; running alloc).
"""

from __future__ import annotations

from nomad_tpu_torch import structs
from nomad_tpu_torch.structs import (
    Allocation,
    Constraint,
    Evaluation,
    Job,
    NetworkResource,
    Node,
    Plan,
    PlanResult,
    Resources,
    RestartPolicy,
    Task,
    TaskGroup,
    generate_uuid,
)


def node() -> Node:
    """reference: mock.go:8-55"""
    return Node(
        id=generate_uuid(),
        datacenter="dc1",
        name="foobar",
        attributes={
            "kernel.name": "linux",
            "arch": "x86",
            "version": "0.1.0",
            "driver.exec": "1",
        },
        resources=Resources(
            cpu=4000,
            memory_mb=8192,
            disk_mb=100 * 1024,
            iops=150,
            networks=[
                NetworkResource(device="eth0", cidr="192.168.0.100/32", mbits=1000)
            ],
        ),
        reserved=Resources(
            cpu=100,
            memory_mb=256,
            disk_mb=4 * 1024,
            networks=[
                NetworkResource(
                    device="eth0",
                    ip="192.168.0.100",
                    reserved_ports=[22],
                    mbits=1,
                )
            ],
        ),
        links={"consul": "foobar.dc1"},
        meta={"pci-dss": "true"},
        node_class="linux-medium-pci",
        status=structs.NODE_STATUS_READY,
    )


def job() -> Job:
    """reference: mock.go:57-120"""
    return Job(
        region="global",
        id=generate_uuid(),
        name="my-job",
        type=structs.JOB_TYPE_SERVICE,
        priority=50,
        all_at_once=False,
        datacenters=["dc1"],
        constraints=[
            Constraint(l_target="$attr.kernel.name", r_target="linux", operand="=")
        ],
        task_groups=[
            TaskGroup(
                name="web",
                count=10,
                restart_policy=RestartPolicy(attempts=3, interval=600.0, delay=60.0),
                tasks=[
                    Task(
                        name="web",
                        driver="exec",
                        config={"command": "/bin/date", "args": "+%s"},
                        env={"FOO": "bar"},
                        resources=Resources(
                            cpu=500,
                            memory_mb=256,
                            networks=[
                                NetworkResource(mbits=50, dynamic_ports=["http"])
                            ],
                        ),
                    )
                ],
                meta={
                    "elb_check_type": "http",
                    "elb_check_interval": "30s",
                    "elb_check_min": "3",
                },
            )
        ],
        meta={"owner": "armon"},
        status=structs.JOB_STATUS_PENDING,
        create_index=42,
        modify_index=99,
    )


def system_job() -> Job:
    """reference: mock.go:122-177"""
    return Job(
        region="global",
        id=generate_uuid(),
        name="my-job",
        type=structs.JOB_TYPE_SYSTEM,
        priority=100,
        all_at_once=False,
        datacenters=["dc1"],
        constraints=[
            Constraint(l_target="$attr.kernel.name", r_target="linux", operand="=")
        ],
        task_groups=[
            TaskGroup(
                name="web",
                count=1,
                restart_policy=RestartPolicy(attempts=3, interval=600.0, delay=60.0),
                tasks=[
                    Task(
                        name="web",
                        driver="exec",
                        config={"command": "/bin/date", "args": "+%s"},
                        resources=Resources(
                            cpu=500,
                            memory_mb=256,
                            networks=[
                                NetworkResource(mbits=50, dynamic_ports=["http"])
                            ],
                        ),
                    )
                ],
            )
        ],
        meta={"owner": "armon"},
        status=structs.JOB_STATUS_PENDING,
        create_index=42,
        modify_index=99,
    )


def evaluation() -> Evaluation:
    """reference: mock.go:179-188"""
    return Evaluation(
        id=generate_uuid(),
        priority=50,
        type=structs.JOB_TYPE_SERVICE,
        job_id=generate_uuid(),
        status=structs.EVAL_STATUS_PENDING,
    )


def alloc() -> Allocation:
    """reference: mock.go:190-230"""
    j = job()
    a = Allocation(
        id=generate_uuid(),
        eval_id=generate_uuid(),
        node_id="foo",
        task_group="web",
        resources=Resources(
            cpu=500,
            memory_mb=256,
            networks=[
                NetworkResource(
                    device="eth0",
                    ip="192.168.0.100",
                    reserved_ports=[12345],
                    mbits=100,
                    dynamic_ports=["http"],
                )
            ],
        ),
        task_resources={
            "web": Resources(
                cpu=500,
                memory_mb=256,
                networks=[
                    NetworkResource(
                        device="eth0",
                        ip="192.168.0.100",
                        reserved_ports=[5000],
                        mbits=50,
                        dynamic_ports=["http"],
                        offered=True,
                    )
                ],
            )
        },
        job=j,
        job_id=j.id,
        desired_status=structs.ALLOC_DESIRED_STATUS_RUN,
        client_status=structs.ALLOC_CLIENT_STATUS_PENDING,
    )
    return a


def plan() -> Plan:
    return Plan(priority=50)


def plan_result() -> PlanResult:
    return PlanResult()
