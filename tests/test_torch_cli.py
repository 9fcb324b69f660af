"""The port's CLI (nomad_tpu_torch.cli, ``python -m nomad_tpu_torch``)
against nomad_tpu's.

Each command runs in process through each package's ``cli.main`` against
that package's agent (server-only dev mode, the same seeded nodes, as in
tests/test_torch_api.py): the exit codes are equal and so is the output
once server-made ids (full and 8-character short uuids) and listener
addresses are masked; lines that list allocations are compared as sorted
sets, as the two servers may list them in another order. ``agent-info``
prints each package's own server stats: its ``config`` block is compared.
``client-config`` answers as nomad_tpu's, ``spawn-daemon`` runs a
spec, ``agent -dev`` defaults to the card (a dev agent on the CPU runs
in tests/test_torch_client.py); ``python -m nomad_tpu_torch version``
runs as a process.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import pytest

from nomad_tpu import cli as jcli
from nomad_tpu.scheduler import wait_for_device
import torch

from nomad_tpu_torch import cli as pcli

from test_torch_api import _nodes, _start

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                  r"[0-9a-f]{12}")
SHORT = re.compile(r"\b[0-9a-f]{8}\b")
ADDR = re.compile(r"(http://)?127\.0\.0\.1:\d+")

JOB = '''
job "cli-job" {
    datacenters = ["dc1", "dc2"]
    type = "service"
    group "web" {
        count = 3
        task "server" {
            driver = "exec"
            config { command = "/bin/sleep" }
            resources { cpu = 250 memory = 128 }
        }
    }
}
'''


@pytest.fixture(scope="module")
def agents():
    assert wait_for_device(timeout=120.0) is not None
    pair = [_start("jax"), _start("port")]
    try:
        nodes = _nodes()
        for side in pair:
            side.agent.server.node_batch_register(
                [side.convert(n, "Node") for n in nodes])
        yield pair
    finally:
        for side in pair:
            side.agent.shutdown()


def run(main, side, *argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--address", side.addr, *argv])
    return rc, buf.getvalue()


def masked(text):
    text = UUID.sub("<id>", text)
    text = SHORT.sub("<id>", text)
    return ADDR.sub("<addr>", text)


def both(agents, *argv, sort=False):
    """(rc, masked output) of a command in both packages; equal."""
    out = []
    for main, side in ((jcli.main, agents[0]), (pcli.main, agents[1])):
        rc, text = run(main, side, *argv)
        text = masked(text)
        out.append((rc, sorted(text.splitlines()) if sort else text))
    assert out[1] == out[0], argv
    return out[0]


def test_version_and_init_validate(agents, tmp_path, monkeypatch):
    assert both(agents, "version") == (0, "nomad-tpu v0.1.0\n")
    for i, main in enumerate((jcli.main, pcli.main)):
        d = tmp_path / str(i)
        d.mkdir()
        monkeypatch.chdir(d)
        first = run(main, agents[i], "init")
        second = run(main, agents[i], "init")
        valid = run(main, agents[i], "validate", "example.hcl")
        (d / "bad.hcl").write_text('job "a" { unclosed ')
        bad = run(main, agents[i], "validate", "bad.hcl")
        if i == 0:
            want = (first, second, valid, bad)
    assert (first, second, valid, bad) == want
    assert first[0] == 0 and second[0] == 1 and valid[0] == 0 and bad[0] == 1


def test_run_status_stop(agents, tmp_path):
    path = tmp_path / "job.hcl"
    path.write_text(JOB)
    rc, text = both(agents, "run", str(path), sort=True)
    assert rc == 0 and sum("created" in line for line in text) == 3
    both(agents, "status")
    rc, text = both(agents, "status", "cli-job", sort=True)
    assert rc == 0 and sum(" run " in line for line in text) == 3
    both(agents, "status", "nope")
    rc, _ = both(agents, "run", "-detach", str(path))
    assert rc == 0
    rc, _ = both(agents, "stop", "cli-job")
    assert rc == 0
    # A stopped job is deregistered: status no longer finds it.
    rc, text = both(agents, "status", "cli-job")
    assert rc == 1 and "job not found" in text


def test_node_and_alloc_status(agents, tmp_path):
    node = _nodes()[1].id
    both(agents, "node-status", sort=True)
    both(agents, "node-status", node, sort=True)
    both(agents, "node-status", "nope")
    both(agents, "node-drain", node)
    both(agents, "node-drain", "-enable", node)
    both(agents, "node-drain", "-disable", node)
    path = tmp_path / "job.hcl"
    path.write_text(JOB.replace("cli-job", "alloc-job"))
    rc, _ = both(agents, "run", str(path), sort=True)
    assert rc == 0
    outs = []
    for main, side in ((jcli.main, agents[0]), (pcli.main, agents[1])):
        allocs, _ = side.client.jobs().allocations("alloc-job")
        first = sorted(allocs, key=lambda a: (a["name"], a["node_id"]))[0]
        outs.append(masked(run(main, side, "alloc-status", first["id"])[1]))
        ev = side.client.jobs().evaluations("alloc-job")[0][0]
        outs.append(sorted(masked(
            run(main, side, "eval-monitor", ev.id)[1]).splitlines()))
    assert outs[2:] == outs[:2]
    both(agents, "alloc-status", "nope")


def test_agent_info_and_members(agents):
    infos = []
    for main, side in ((jcli.main, agents[0]), (pcli.main, agents[1])):
        rc, text = run(main, side, "agent-info")
        assert rc == 0
        infos.append(json.loads(text)["config"])
    assert {k: infos[1][k] for k in infos[0]} == infos[0]
    rc, _ = both(agents, "server-members")
    assert rc == 0


@pytest.mark.parametrize("argv", [["agent", "-dev"],
                                  ["client-config", "-servers"],
                                  ["spawn-daemon", "<spec>"]])
def test_client_commands_raise_naming_client(argv, agents, tmp_path,
                                            monkeypatch):
    """The client's commands, which raised until ``client/`` was ported,
    now work: ``client-config`` prints what nomad_tpu's prints,
    ``spawn-daemon`` runs its spec to an exit status, and ``agent -dev``
    starts a server on the card, so it raises where there is none."""
    if argv[0] == "agent":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            pcli.main(argv)
    elif argv[0] == "client-config":
        rc, text = both(agents, *argv)
        assert rc == 0 and text == "<addr>\n"
        assert both(agents, "client-config") == (1, "Must specify -servers\n")
    else:
        prefix = str(tmp_path / "task")
        spec = json.dumps({
            "command": "/bin/sh", "args": ["-c", "exit 4"], "env": {},
            "cwd": str(tmp_path), "stdout": str(tmp_path / "out"),
            "stderr": str(tmp_path / "err"), "state_prefix": prefix})
        assert pcli.main(["spawn-daemon", spec]) == 0
        with open(prefix + ".status") as f:
            assert json.load(f)["exit_code"] == 4


def test_python_m_runs_the_cli():
    out = subprocess.run(
        [sys.executable, "-m", "nomad_tpu_torch", "version"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout == "nomad-tpu v0.1.0\n"
