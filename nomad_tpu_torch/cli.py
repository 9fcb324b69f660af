"""Command-line interface (port of nomad_tpu/cli.py; run it as
``python -m nomad_tpu_torch <command>``).

Reference: upstream commands.go:13-82 + command/*.go. Commands:
agent, agent-info, alloc-status, eval-monitor, init, node-drain,
node-status, run, server-members, server-join, server-force-leave,
status, stop, validate, version. ``eval-monitor``/``run`` without
``-detach`` reproduce the polling monitor UI (command/monitor.go).

``agent`` takes ``-device`` (default ``cuda``): where its server solves.
``agent -dev`` runs a server and a client in one process.
``spawn-daemon`` is the drivers' re-exec target (discover.py); its path
imports neither ``torch`` nor the server, so a task start stays cheap.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import time
from typing import Optional

from nomad_tpu_torch import __version__
from nomad_tpu_torch.api import ApiClient, ApiError

EXAMPLE_JOB = '''# Example job specification (reference: command/init.go)
job "example" {
    datacenters = ["dc1"]
    type = "service"

    group "cache" {
        count = 1

        restart {
            attempts = 10
            interval = "5m"
            delay = "25s"
        }

        task "redis" {
            driver = "exec"

            config {
                command = "/usr/bin/redis-server"
            }

            resources {
                cpu = 500
                memory = 256

                network {
                    mbits = 10
                    dynamic_ports = ["redis"]
                }
            }
        }
    }
}
'''


def _client(args) -> ApiClient:
    return ApiClient(address=args.address)


def _monitor_eval(client: ApiClient, eval_id: str, timeout: float = 60.0) -> int:
    """Poll an evaluation to a terminal state, reporting placements and
    failures (reference: command/monitor.go)."""
    print(f"==> Monitoring evaluation \"{eval_id[:8]}\"")
    seen_allocs = set()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            ev, _ = client.evaluations().info(eval_id)
        except ApiError as e:
            print(f"Error reading evaluation: {e}")
            return 1
        allocs, _ = client.evaluations().allocations(eval_id)
        for alloc in allocs:
            if alloc["id"] in seen_allocs:
                continue
            seen_allocs.add(alloc["id"])
            if alloc["desired_status"] == "failed":
                print(
                    f"    Scheduling error for group \"{alloc['task_group']}\" "
                    f"({alloc['desired_description']})"
                )
            else:
                print(
                    f"    Allocation \"{alloc['id'][:8]}\" created: "
                    f"node \"{alloc['node_id'][:8]}\", "
                    f"group \"{alloc['task_group']}\""
                )
        if ev.status in ("complete", "failed"):
            print(f"==> Evaluation status changed: \"pending\" -> \"{ev.status}\"")
            if ev.status_description:
                print(f"    {ev.status_description}")
            return 0 if ev.status == "complete" else 2
        time.sleep(0.2)
    print("==> Monitor timed out")
    return 1


# -- commands ---------------------------------------------------------------


def _read_agent_config(args):
    """Merged config: defaults <- (-dev) <- config files/dirs <- CLI flags
    (reference: command/agent/command.go readConfig)."""
    from nomad_tpu_torch import agent_config as ac

    config = ac.dev_config() if args.dev else ac.default_config()
    for path in args.config or []:
        config = config.merge(ac.load_config_path(path))

    flags = ac.FileConfig()
    flags.data_dir = args.data_dir
    flags.log_level = "" if args.log_level == "INFO" else args.log_level
    flags.bind_addr = args.bind
    flags.region = args.region
    flags.datacenter = args.dc
    flags.name = args.node
    flags.server.enabled = args.server
    flags.client.enabled = args.client
    flags.scheduler_backend = (
        "" if args.scheduler_backend == "tpu" else args.scheduler_backend
    )
    flags.device = "" if args.device == "cuda" else args.device
    if args.http_port != 4646:
        flags.ports.http = args.http_port
    config = config.merge(flags)

    if config.atlas.endpoint:
        # Mirror the agent's session-key fallback (agent.py start()) so
        # the banner names the key a broker will actually see.
        infra = config.atlas.infrastructure or config.name or "default"
        print(f"==> Atlas/SCADA uplink: {config.atlas.endpoint} "
              f"(infrastructure: {infra})")
    elif config.atlas.infrastructure:
        from nomad_tpu_torch.scada import scada_unavailable_reason

        print(f"==> Atlas/SCADA disabled: {scada_unavailable_reason()}")
    return config


def cmd_agent(args) -> int:
    """reference: command/agent/command.go"""
    import logging

    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s [%(levelname)s] %(name)s: %(message)s",
    )
    from nomad_tpu_torch.agent import Agent, AgentConfig

    file_config = _read_agent_config(args)
    config = AgentConfig.from_file_config(file_config)
    if args.dev:
        config.dev_mode = True

    agent = Agent(config)
    agent.start()
    print(f"==> nomad-tpu agent started! HTTP at {agent.http.addr}")
    print(f"    Server: {agent.server is not None}, "
          f"Client: {agent.client is not None}, "
          f"Scheduler backend: {config.scheduler_backend}, "
          f"Device: {agent.server.device if agent.server else '-'}",
          flush=True)

    stop = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    try:
        while not stop:
            time.sleep(0.2)
    finally:
        print("==> Caught signal, gracefully shutting down")
        agent.shutdown()
    return 0


def cmd_run(args) -> int:
    """reference: command/run.go"""
    from nomad_tpu_torch import jobspec

    try:
        job = jobspec.parse_file(args.jobfile)
        job.validate()
    except Exception as e:
        print(f"Error parsing job file {args.jobfile}: {e}")
        return 1

    client = _client(args)
    try:
        eval_id, _ = client.jobs().register(job)
    except ApiError as e:
        print(f"Error submitting job: {e}")
        return 1

    if args.detach:
        print(eval_id)
        return 0
    return _monitor_eval(client, eval_id)


def cmd_validate(args) -> int:
    """reference: command/validate.go"""
    from nomad_tpu_torch import jobspec

    try:
        job = jobspec.parse_file(args.jobfile)
        job.validate()
    except Exception as e:
        print(f"Error validating job: {e}")
        return 1
    print("Job validation successful")
    return 0


def cmd_init(args) -> int:
    """reference: command/init.go"""
    import os

    if os.path.exists("example.hcl"):
        print("Job 'example.hcl' already exists")
        return 1
    with open("example.hcl", "w") as f:
        f.write(EXAMPLE_JOB)
    print("Example job file written to example.hcl")
    return 0


def cmd_status(args) -> int:
    """reference: command/status.go"""
    client = _client(args)
    if args.job_id:
        try:
            job, _ = client.jobs().info(args.job_id)
        except ApiError as e:
            print(f"Error querying job: {e}")
            return 1
        print(f"ID          = {job.id}")
        print(f"Name        = {job.name}")
        print(f"Type        = {job.type}")
        print(f"Priority    = {job.priority}")
        print(f"Datacenters = {','.join(job.datacenters)}")
        print(f"Status      = {job.status or '<none>'}")
        allocs, _ = client.jobs().allocations(args.job_id)
        print("\n==> Allocations")
        print(f"{'ID':<10} {'Node':<10} {'Group':<12} {'Desired':<8} {'Status':<8}")
        for a in allocs:
            print(
                f"{a['id'][:8]:<10} {a['node_id'][:8]:<10} "
                f"{a['task_group']:<12} {a['desired_status']:<8} "
                f"{a['client_status']:<8}"
            )
        return 0

    jobs, _ = client.jobs().list()
    if not jobs:
        print("No running jobs")
        return 0
    print(f"{'ID':<24} {'Type':<8} {'Priority':<9} {'Status':<8}")
    for j in jobs:
        print(f"{j['id']:<24} {j['type']:<8} {j['priority']:<9} {j['status']:<8}")
    return 0


def cmd_stop(args) -> int:
    """reference: command/stop.go"""
    client = _client(args)
    try:
        eval_id, _ = client.jobs().deregister(args.job_id)
    except ApiError as e:
        print(f"Error deregistering job: {e}")
        return 1
    if args.detach:
        print(eval_id)
        return 0
    return _monitor_eval(client, eval_id)


def cmd_node_status(args) -> int:
    """reference: command/node_status.go"""
    client = _client(args)
    if args.node_id:
        try:
            node, _ = client.nodes().info(args.node_id)
        except ApiError as e:
            print(f"Error querying node: {e}")
            return 1
        print(f"ID         = {node.id}")
        print(f"Name       = {node.name}")
        print(f"Class      = {node.node_class or '<none>'}")
        print(f"Datacenter = {node.datacenter}")
        print(f"Drain      = {node.drain}")
        print(f"Status     = {node.status}")
        if node.resources:
            print(f"Resources  = cpu:{node.resources.cpu} "
                  f"mem:{node.resources.memory_mb}MB "
                  f"disk:{node.resources.disk_mb}MB")
        allocs, _ = client.nodes().allocations(args.node_id)
        print("\n==> Allocations")
        for a in allocs:
            print(f"{a.id[:8]}  {a.job_id[:8]}  {a.task_group}  "
                  f"{a.desired_status}  {a.client_status}")
        return 0

    nodes, _ = client.nodes().list()
    if not nodes:
        print("No nodes registered")
        return 0
    print(f"{'ID':<10} {'DC':<8} {'Name':<16} {'Class':<12} {'Drain':<6} {'Status':<8}")
    for n in nodes:
        print(
            f"{n['id'][:8]:<10} {n['datacenter']:<8} {n['name']:<16} "
            f"{(n['node_class'] or '<none>'):<12} {str(n['drain']):<6} "
            f"{n['status']:<8}"
        )
    return 0


def cmd_node_drain(args) -> int:
    """reference: command/node_drain.go"""
    if not (args.enable or args.disable):
        print("Either the '-enable' or '-disable' flag must be set")
        return 1
    client = _client(args)
    try:
        client.nodes().toggle_drain(args.node_id, args.enable)
    except ApiError as e:
        print(f"Error toggling drain: {e}")
        return 1
    return 0


def cmd_eval_monitor(args) -> int:
    """reference: command/eval_monitor.go"""
    return _monitor_eval(_client(args), args.eval_id)


def cmd_alloc_status(args) -> int:
    """reference: command/alloc_status.go"""
    client = _client(args)
    try:
        alloc, _ = client.allocations().info(args.alloc_id)
    except ApiError as e:
        print(f"Error querying allocation: {e}")
        return 1
    print(f"ID             = {alloc.id}")
    print(f"Eval ID        = {alloc.eval_id}")
    print(f"Name           = {alloc.name}")
    print(f"Node ID        = {alloc.node_id or '<none>'}")
    print(f"Job ID         = {alloc.job_id}")
    print(f"Task Group     = {alloc.task_group}")
    print(f"Desired Status = {alloc.desired_status}")
    print(f"Desired Desc   = {alloc.desired_description or '<none>'}")
    print(f"Client Status  = {alloc.client_status}")
    if alloc.metrics:
        m = alloc.metrics
        print("\n==> Placement Metrics")
        print(f"  * Nodes evaluated: {m.nodes_evaluated}")
        print(f"  * Nodes filtered:  {m.nodes_filtered}")
        print(f"  * Nodes exhausted: {m.nodes_exhausted}")
        for key, score in sorted(m.scores.items()):
            print(f"  * Score {key}: {score:.3f}")
    return 0


def cmd_agent_info(args) -> int:
    """reference: command/agent_info.go"""
    client = _client(args)
    try:
        info = client.agent().self_info()
    except ApiError as e:
        print(f"Error querying agent: {e}")
        return 1
    print(json.dumps(info, indent=2))
    return 0


def cmd_server_members(args) -> int:
    """reference: command/server_members.go"""
    client = _client(args)
    members = client.agent().members()
    print(f"{'Name':<16} {'Addr':<28} {'Status':<8} {'Leader':<6}")
    for m in members:
        print(f"{m['name']:<16} {m['addr']:<28} {m['status']:<8} "
              f"{str(m['leader']):<6}")
    return 0


def cmd_version(args) -> int:
    print(f"nomad-tpu v{__version__}")
    return 0


def cmd_server_join(args) -> int:
    """reference: command/server_join.go"""
    client = _client(args)
    n = client.agent().join(args.addr)
    print(f"Joined {n} servers successfully")
    return 0


def cmd_server_force_leave(args) -> int:
    """reference: command/server_force_leave.go"""
    client = _client(args)
    client.agent().force_leave(args.node)
    return 0


def cmd_client_config(args) -> int:
    """reference: command/client_config.go — view the client's known
    servers (the 0.1.2-era command surfaces -servers only)."""
    client = _client(args)
    if not args.servers:
        print("Must specify -servers")
        return 1
    servers, _ = client.query("/v1/agent/servers")
    for server in servers:
        print(server)
    return 0


def cmd_spawn_daemon(args) -> int:
    """reference: command/spawn_daemon.go — internal plumbing command; the
    exec/raw_exec drivers re-exec this to double-fork user tasks so they
    survive agent restarts."""
    from nomad_tpu_torch.client.driver.spawn import _daemon_main

    return _daemon_main(args.spec)


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="nomad-tpu",
        description="A TPU-native cluster scheduler with the capabilities of Nomad",
    )
    parser.add_argument(
        "--address", default="http://127.0.0.1:4646",
        help="Address of the agent HTTP API",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("agent", help="Run an agent")
    p.add_argument("-dev", dest="dev", action="store_true",
                   help="Dev mode: in-memory server + client")
    p.add_argument("-server", dest="server", action="store_true")
    p.add_argument("-client", dest="client", action="store_true")
    p.add_argument("-config", dest="config", action="append", default=[],
                   help="Config file or directory (repeatable; later "
                        "files override earlier)")
    p.add_argument("-data-dir", dest="data_dir", default="")
    p.add_argument("-bind", dest="bind", default="")
    p.add_argument("-region", dest="region", default="")
    p.add_argument("-dc", dest="dc", default="")
    p.add_argument("-node", dest="node", default="")
    p.add_argument("-http-port", dest="http_port", type=int, default=4646)
    p.add_argument("-log-level", dest="log_level", default="INFO")
    p.add_argument("-scheduler-backend", dest="scheduler_backend",
                   default="tpu", choices=["tpu", "host"])
    p.add_argument("-device", dest="device", default="cuda",
                   help="Where the server solves: cuda (the card) or cpu")
    p.set_defaults(func=cmd_agent)

    p = sub.add_parser("run", help="Run a new job")
    p.add_argument("jobfile")
    p.add_argument("-detach", dest="detach", action="store_true")
    p.set_defaults(func=cmd_run)

    p = sub.add_parser("validate", help="Checks if a given job specification is valid")
    p.add_argument("jobfile")
    p.set_defaults(func=cmd_validate)

    p = sub.add_parser("init", help="Create an example job file")
    p.set_defaults(func=cmd_init)

    p = sub.add_parser("status", help="Display status information about jobs")
    p.add_argument("job_id", nargs="?", default="")
    p.set_defaults(func=cmd_status)

    p = sub.add_parser("stop", help="Stop a running job")
    p.add_argument("job_id")
    p.add_argument("-detach", dest="detach", action="store_true")
    p.set_defaults(func=cmd_stop)

    p = sub.add_parser("node-status", help="Display status information about nodes")
    p.add_argument("node_id", nargs="?", default="")
    p.set_defaults(func=cmd_node_status)

    p = sub.add_parser("node-drain", help="Toggle drain mode on a node")
    p.add_argument("node_id")
    p.add_argument("-enable", dest="enable", action="store_true")
    p.add_argument("-disable", dest="disable", action="store_true")
    p.set_defaults(func=cmd_node_drain)

    p = sub.add_parser("eval-monitor", help="Monitor an evaluation interactively")
    p.add_argument("eval_id")
    p.set_defaults(func=cmd_eval_monitor)

    p = sub.add_parser("alloc-status", help="Display allocation status")
    p.add_argument("alloc_id")
    p.set_defaults(func=cmd_alloc_status)

    p = sub.add_parser("agent-info", help="Display status information about the agent")
    p.set_defaults(func=cmd_agent_info)

    p = sub.add_parser("server-members", help="Display the server membership")
    p.set_defaults(func=cmd_server_members)

    p = sub.add_parser("server-join", help="Join the local server to a cluster")
    p.add_argument("addr")
    p.set_defaults(func=cmd_server_join)

    p = sub.add_parser("server-force-leave",
                       help="Force a server into the 'left' state")
    p.add_argument("node")
    p.set_defaults(func=cmd_server_force_leave)

    p = sub.add_parser("client-config", help="View client configuration")
    p.add_argument("-servers", dest="servers", action="store_true",
                   help="List the known server addresses")
    p.set_defaults(func=cmd_client_config)

    p = sub.add_parser("spawn-daemon",
                       help="Internal: daemonize a task (used by drivers)")
    p.add_argument("spec", help="JSON spawn spec")
    p.set_defaults(func=cmd_spawn_daemon)

    p = sub.add_parser("version", help="Print the version")
    p.set_defaults(func=cmd_version)

    return parser


def main(argv: Optional[list] = None) -> int:
    args = make_parser().parse_args(argv)
    try:
        return args.func(args)
    except ApiError as e:
        print(f"Error: {e}")
        return 1


if __name__ == "__main__":
    sys.exit(main())
