"""The port's client (nomad_tpu_torch.client, discover.py, the drivers and
the GPU fingerprint) against nomad_tpu's on the CPU.

Each piece goes through both packages on the same inputs, made from a
numpy seed: ``diff_allocs``, the restart trackers under an injected
clock, ``AllocDir`` trees, ``task_environment``, the host fingerprints,
the raw_exec and mock drivers, the spawn daemon and the artifact getter.
Then each package's ``Server`` runs one ``Client`` of its own package
through the same jobs (mock tasks at count 3 and at count 256, whose
allocations the server commits as a columnar block, since both packages'
``TPUGenericScheduler.BATCH_PLACE_THRESHOLD`` is 256; a raw_exec job under
a batch restart policy; a service job that is deregistered), and the
registered node attributes, each allocation's client-status sequence,
the task events and the restart counts are compared. The port's client
also runs over RPC against a one-member ``ClusterServer``, and
``agent -dev -device cpu`` and ``spawn-daemon`` run in subprocesses that
cannot import ``jax``, ``nomad_tpu`` (nor, for the daemon, ``torch``).

Tolerance: exact, after masking server-made ids, times, the alloc and
state dirs' temporary roots and the free disk space (``storage.bytesfree``
and ``disk_mb``, which move between two reads). Two threads race to
report an alloc's stop in both packages (the watch's "alloc stopped" and
the task runner's "task destroyed"), so an alloc's descriptions are
compared as a multiset beside its ordered status sequence. The cloud
metadata fingerprints are given no network in both packages.
"""

import hashlib
import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch

from nomad_tpu.scheduler import wait_for_device

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 60.0
SEED = 9
MODULES = ("structs", "mock", "client", "client.client", "client.config",
           "client.allocdir", "client.restarts", "client.getter",
           "client.fingerprint", "client.alloc_runner",
           "client.driver.driver", "client.driver.spawn", "server.server")


def package(root: str) -> types.SimpleNamespace:
    ns = types.SimpleNamespace(name=root)
    for mod in MODULES:
        setattr(ns, mod.split(".")[-1],
                importlib.import_module(f"{root}.{mod}"))
    ns.pkg = importlib.import_module(f"{root}.client")
    return ns


JAX = package("nomad_tpu")
PORT = package("nomad_tpu_torch")
BOTH = (JAX, PORT)


@pytest.fixture(autouse=True)
def no_metadata_network(monkeypatch):
    """The AWS/GCE metadata fingerprints read a link-local address: give
    them no network in both packages (each then reports itself absent)."""
    for p in BOTH:
        monkeypatch.setattr(p.fingerprint._MetadataFingerprint, "_get",
                            lambda self, path: None)


def wait_until(pred, timeout=WAIT_S, every=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(every)
    return False


# -- pieces ---------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_diff_allocs(seed):
    rng = np.random.default_rng(seed)
    ids = [f"alloc-{i:02d}" for i in range(40)]
    existing = {i: int(rng.integers(1, 4)) for i in ids if rng.random() < 0.6}
    pushed = [(i, int(rng.integers(1, 4))) for i in ids if rng.random() < 0.7]
    outs = []
    for p in BOTH:
        allocs = [p.structs.Allocation(id=i, modify_index=m)
                  for i, m in pushed]
        added, removed, updates, ignored = p.client.diff_allocs(
            dict(existing), allocs)
        outs.append(([a.id for a in added], removed,
                     [a.id for a in updates], ignored))
    assert outs[1] == outs[0]


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


@pytest.mark.parametrize("job_type", ["service", "system", "batch"])
def test_restart_trackers_decide_alike(monkeypatch, job_type):
    seqs = []
    for p in BOTH:
        clock = FakeClock()
        monkeypatch.setattr(p.restarts, "time", clock)
        rng = np.random.default_rng(SEED)
        policy = p.structs.RestartPolicy(attempts=3, interval=30.0,
                                         delay=1.5)
        tracker = p.restarts.new_restart_tracker(job_type, policy)
        seq = [type(tracker).__name__]
        for _ in range(40):
            clock.now += float(rng.exponential(4.0))
            seq.append(tracker.next_restart())
        seqs.append(seq)
    assert seqs[1] == seqs[0]
    assert len(set(seqs[0][1:])) > 1


def tree(root: str):
    out = []
    for dirpath, dirs, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        out += [os.path.join(rel, d) + "/" for d in dirs]
        out += [os.path.join(rel, f) for f in files]
    return sorted(out)


def test_alloc_dir_trees(tmp_path):
    rng = np.random.default_rng(SEED)
    tasks = [f"task{int(i)}" for i in rng.choice(50, 4, replace=False)]
    views = []
    for p in BOTH:
        root = str(tmp_path / p.name / "alloc")
        d = p.allocdir.AllocDir(root)
        d.build(tasks)
        views.append((tree(root), os.path.relpath(d.log_dir(), root),
                      {t: os.path.relpath(v, root)
                       for t, v in d.task_dirs.items()}))
        d.destroy()
        assert not os.path.exists(root)
    assert views[1] == views[0]


def test_task_environment(tmp_path):
    rng = np.random.default_rng(SEED)
    ports = [int(x) for x in rng.integers(20000, 30000, 4)]
    envs = []
    for p in BOTH:
        st = p.structs
        root = str(tmp_path / p.name / "alloc")
        d = p.allocdir.AllocDir(root)
        d.build(["web"])
        ctx = p.driver.ExecContext(d, "alloc-0000")
        task = st.Task(
            name="web", driver="raw_exec",
            env={"A": "1", "NOMAD_CPU_LIMIT": "override"},
            meta={"team-name": "core", "tier": "front"},
            resources=st.Resources(
                cpu=int(ports[0] % 900) + 100, memory_mb=256,
                networks=[st.NetworkResource(
                    ip="10.1.2.3", mbits=10, reserved_ports=ports,
                    dynamic_ports=["http", "admin"], offered=True)]))
        env = p.driver.task_environment(ctx, task)
        envs.append({k: v.replace(root, "<root>") for k, v in env.items()})
    assert envs[1] == envs[0]
    assert envs[0]["NOMAD_PORT_admin"] == str(ports[-1])


HOST_FINGERPRINTS = ["ArchFingerprint", "HostFingerprint", "CPUFingerprint",
                     "MemoryFingerprint", "NetworkFingerprint",
                     "StorageFingerprint"]


def masked_node(node, roots):
    from nomad_tpu_torch.api.codec import to_dict

    doc = to_dict(node)
    attrs = doc["attributes"]
    attrs.pop("storage.bytesfree", None)
    for root in roots:
        for key, value in attrs.items():
            attrs[key] = value.replace(root, "<root>")
    if doc.get("resources"):
        doc["resources"]["disk_mb"] = "<free>"
    doc.pop("id", None)
    return doc


@pytest.mark.parametrize("name", HOST_FINGERPRINTS)
def test_host_fingerprints(tmp_path, name):
    docs = []
    for p in BOTH:
        alloc_dir = str(tmp_path / p.name)
        os.makedirs(alloc_dir)
        config = p.config.ClientConfig(alloc_dir=alloc_dir)
        node = p.structs.Node(id="n", resources=p.structs.Resources())
        applied = getattr(p.fingerprint, name)().fingerprint(config, node)
        docs.append((applied, masked_node(node, [alloc_dir])))
    assert docs[1] == docs[0]
    assert docs[0][0] is True


def test_builtin_fingerprints_keep_nomad_tpus_order():
    names = [c.name for c in JAX.fingerprint.BUILTIN_FINGERPRINTS]
    assert [c.name for c in PORT.fingerprint.BUILTIN_FINGERPRINTS] == [
        "gpu" if n == "tpu" else n for n in names]
    assert set(PORT.driver.builtin_driver_classes()) == set(
        JAX.driver.builtin_driver_classes())


def exec_ctx(p, tmp_path, tasks):
    d = p.allocdir.AllocDir(str(tmp_path / p.name / "alloc"))
    d.build(tasks)
    return p.driver.ExecContext(d, "0123abcd-alloc")


@pytest.mark.parametrize("code", [0, 3])
def test_raw_exec_exit_codes(tmp_path, code):
    outs = []
    for p in BOTH:
        ctx = exec_ctx(p, tmp_path, ["t"])
        task = p.structs.Task(name="t", driver="raw_exec", config={
            "command": "/bin/sh", "args": f'-c "echo out-{code}; exit {code}"'})
        handle = p.driver.new_driver("raw_exec", ctx).start(task)
        got = handle.wait(timeout=WAIT_S)
        with open(os.path.join(ctx.alloc_dir.log_dir(), "t.stdout")) as f:
            outs.append((got, f.read(), handle.is_running()))
    assert outs[1] == outs[0] == (code, f"out-{code}\n", False)


def test_raw_exec_kill(tmp_path):
    outs = []
    for p in BOTH:
        ctx = exec_ctx(p, tmp_path, ["t"])
        task = p.structs.Task(name="t", driver="raw_exec", config={
            "command": "/bin/sleep", "args": ["300"]})
        handle = p.driver.new_driver("raw_exec", ctx).start(task)
        pid = p.spawn.read_pid(handle.id())
        running = handle.is_running()
        handle.kill()
        code = handle.wait(timeout=WAIT_S)
        assert wait_until(lambda: not p.spawn.pid_alive(pid))
        outs.append((running, code, handle.is_running()))
    assert outs[1] == outs[0]
    assert outs[0][0] is True and outs[0][2] is False


def test_mock_driver(tmp_path):
    rng = np.random.default_rng(SEED)
    cases = [(float(rng.uniform(0.02, 0.1)), int(rng.integers(0, 4)))
             for _ in range(3)]
    outs = []
    for p in BOTH:
        ctx = exec_ctx(p, tmp_path, ["m"])
        drv = p.driver.new_driver("mock_driver", ctx)
        got = []
        for run_for, code in cases:
            h = drv.start(p.structs.Task(name="m", driver="mock_driver",
                                         config={"run_for": run_for,
                                                 "exit_code": code}))
            got.append((h.is_running(), h.wait(timeout=WAIT_S)))
        h = drv.start(p.structs.Task(name="m", driver="mock_driver",
                                     config={"run_for": 300}))
        h.kill()
        got.append((h.is_running(), h.wait(timeout=1.0)))
        outs.append(got)
    assert outs[1] == outs[0]
    assert outs[0][-1] == (False, 137)


def test_spawn_daemon_round_trip(tmp_path):
    outs = []
    for p in BOTH:
        base = tmp_path / p.name
        base.mkdir()
        prefix = str(base / "task")
        pid = p.spawn.spawn_detached(
            "/bin/sh", ["-c", "echo hello; echo oops >&2; exit 3"],
            {"PATH": "/usr/bin:/bin"}, str(base), str(base / "out"),
            str(base / "err"), prefix)
        code = p.spawn.wait(prefix, timeout=WAIT_S)
        missing = str(base / "missing")
        p.spawn.spawn_detached("/no/such/bin", [], {}, str(base),
                               str(base / "o2"), str(base / "e2"), missing)
        outs.append((pid > 0, code, (base / "out").read_text(),
                     (base / "err").read_text(),
                     p.spawn.wait(missing, timeout=WAIT_S)))
    assert outs[1] == outs[0] == (True, 3, "hello\n", "oops\n", 127)


def test_getter_local_file_with_checksum(tmp_path):
    rng = np.random.default_rng(SEED)
    src = tmp_path / "artifact.bin"
    src.write_bytes(rng.integers(0, 256, 4096, dtype=np.uint8).tobytes())
    data = src.read_bytes()
    outs = []
    for p in BOTH:
        dest = tmp_path / p.name
        dest.mkdir()
        got = []
        for checksum in ("", "md5:" + hashlib.md5(data).hexdigest(),
                         "sha256:" + hashlib.sha256(data).hexdigest().upper()):
            path = p.getter.get_artifact(str(src), str(dest), checksum)
            with open(path, "rb") as f:
                got.append((os.path.relpath(path, dest), f.read() == data,
                            os.access(path, os.X_OK)))
        for source, checksum in ((str(src), "sha256:" + "0" * 64),
                                 (str(src), "nope"),
                                 (str(src), "crc:00"),
                                 ("ftp://host/x", ""),
                                 (str(tmp_path / "missing"), "")):
            with pytest.raises(p.getter.ArtifactError) as e:
                p.getter.get_artifact(source, str(dest), checksum)
            got.append(str(e.value).replace(str(dest), "<dest>"))
        outs.append(got)
    assert outs[1] == outs[0]


# -- the port's own: GPUFingerprint, TLS, discover ------------------------------


def gpu_node():
    return PORT.structs.Node(id="n", resources=PORT.structs.Resources())


def gpu_config(enable=True):
    return PORT.config.ClientConfig(
        options={"fingerprint.gpu.enable": "1"} if enable else {})


def test_gpu_fingerprint_is_off_by_default():
    node = gpu_node()
    assert PORT.fingerprint.GPUFingerprint().fingerprint(
        gpu_config(False), node) is False
    assert node.attributes == {}


def test_gpu_fingerprint_without_cuda_returns_false(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    node = gpu_node()
    assert PORT.fingerprint.GPUFingerprint().fingerprint(
        gpu_config(), node) is False
    assert node.attributes == {}


def fake_cuda(monkeypatch, name="NVIDIA H100 80GB HBM3"):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i=0: (9, 0))
    if isinstance(name, Exception):
        def boom(i=0):
            raise name
        monkeypatch.setattr(torch.cuda, "get_device_name", boom)
    else:
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: name)


def test_gpu_fingerprint_sets_its_attributes(monkeypatch):
    fake_cuda(monkeypatch)
    node = gpu_node()
    assert PORT.fingerprint.GPUFingerprint().fingerprint(gpu_config(), node)
    assert node.attributes == {
        "gpu.count": "1", "gpu.platform": "cuda",
        "gpu.device_kind": "NVIDIA H100 80GB HBM3",
        "gpu.capability": "9.0", "driver.gpu": "1"}


def test_gpu_fingerprint_error_fails_the_client(monkeypatch, tmp_path):
    """nomad_tpu's TPUFingerprint swallows every error; the port's fails
    rather than hide the card, and so does the client's construction."""
    fake_cuda(monkeypatch, RuntimeError("CUDA error: device lost"))
    with pytest.raises(RuntimeError, match="device lost"):
        PORT.fingerprint.GPUFingerprint().fingerprint(gpu_config(), gpu_node())
    config = gpu_config()
    config.state_dir = str(tmp_path / "state")
    config.alloc_dir = str(tmp_path / "allocs")
    config.rpc_handler = object()
    with pytest.raises(RuntimeError, match="device lost"):
        PORT.client.Client(config)


def test_client_tls_dials_with_the_outgoing_context(tmp_path):
    """``ClientConfig.tls`` gives the client's server pool the TLS
    config's outgoing context, with the options nomad_tpu's client gets."""
    from nomad_tpu.tlsutil import TLSConfig as JaxTLS
    from nomad_tpu_torch.tlsutil import TLSConfig as PortTLS

    opts = []
    for p, tls_cls in ((JAX, JaxTLS), (PORT, PortTLS)):
        client = p.client.Client(p.config.ClientConfig(
            servers=["127.0.0.1:1"], tls=tls_cls(enabled=True),
            state_dir=str(tmp_path / p.name / "state"),
            alloc_dir=str(tmp_path / p.name / "allocs")))
        ctx = client.endpoint.pool._ssl_context
        opts.append((ctx.minimum_version, ctx.maximum_version,
                     ctx.verify_mode, ctx.check_hostname, ctx.options))
        client.endpoint.shutdown()
    assert opts[1] == opts[0]


def test_discover_runs_the_ports_module():
    from nomad_tpu_torch import discover

    assert discover.nomad_command() == [sys.executable, "-m",
                                        "nomad_tpu_torch"]
    assert discover.spawn_daemon_command("{}")[-2:] == ["spawn-daemon", "{}"]


# -- end to end: each package's Server with one Client --------------------------


E2E_JOBS = ("mock-3", "mock-256", "restart", "stop-me")


def e2e_job(p, name):
    st = p.structs
    job = p.mock.job()
    job.id = job.name = name
    job.datacenters = ["dc1"]
    job.type = st.JOB_TYPE_SERVICE if name == "stop-me" else st.JOB_TYPE_BATCH
    tg = job.task_groups[0]
    tg.count = {"mock-3": 3, "mock-256": 256, "restart": 1, "stop-me": 2}[name]
    task = tg.tasks[0]
    task.resources = st.Resources(cpu=20, memory_mb=16)
    if name == "restart":
        tg.restart_policy = st.RestartPolicy(attempts=2, interval=300.0,
                                             delay=0.05)
        task.driver = "raw_exec"
        task.config = {"command": "/bin/sh", "args": ["-c", "exit 3"]}
    else:
        task.driver = "mock_driver"
        task.config = {"run_for": 3600 if name == "stop-me" else 0.2}
    return job


class Recorder:
    """Every Node.UpdateAlloc a server took, and every task event its
    client's alloc runners saw, keyed by allocation name."""

    def __init__(self):
        self.lock = threading.Lock()
        self.status = defaultdict(list)
        self.events = defaultdict(list)
        self.block_members = []

    def wrap_server(self, srv):
        inner = srv.update_allocs_from_client

        def update(allocs):
            with self.lock:
                for a in allocs:
                    self.status[a.name].append(
                        (a.client_status, a.client_description))
            return inner(allocs)
        srv.update_allocs_from_client = update
        apply = srv.fsm.apply

        def fsm_apply(index, msg_type, payload):
            if msg_type == "alloc_update":
                self.block_members += [
                    b.n for b in payload.get("alloc_batches") or []]
            return apply(index, msg_type, payload)
        srv.fsm.apply = fsm_apply

    def wrap_alloc_runner(self, monkeypatch, mod):
        inner = mod.AllocRunner._on_task_status
        rec = self

        def on_task_status(self, task_name, status, desc):
            with rec.lock:
                rec.events[self.alloc.name].append((task_name, status, desc))
            return inner(self, task_name, status, desc)
        monkeypatch.setattr(mod.AllocRunner, "_on_task_status",
                            on_task_status)


def new_server(p):
    kw = dict(scheduler_backend="tpu", num_schedulers=1, eval_batch_size=1,
              min_heartbeat_ttl=3600.0, prewarm_shapes=False, seed=SEED)
    if p is PORT:
        kw["device"] = "cpu"
    return p.server.Server(p.server.ServerConfig(**kw))


def client_config(p, root, **kw):
    return p.config.ClientConfig(
        dev_mode=True, state_dir=os.path.join(root, "state"),
        alloc_dir=os.path.join(root, "allocs"), datacenter="dc1",
        node_name="client-1",
        options={"driver.raw_exec.enable": "1",
                 "driver.mock_driver.enable": "1"}, **kw)


def live_allocs(store, job_id):
    return [a for a in store.allocs_by_job(job_id)
            if a.desired_status == "run"]


def drive(p, srv, client, rec):
    """Run E2E_JOBS through one server and its client; returns what the
    server committed and the client counted."""
    store = lambda: srv.state_store  # noqa: E731
    assert wait_until(lambda: (n := store().node_by_id(client.node.id))
                      is not None and n.status == "ready")
    out = {"node": store().node_by_id(client.node.id)}

    def finals(job_id):
        return Counter(a.client_status for a in store().allocs_by_job(job_id))

    for name in ("mock-3", "mock-256", "restart"):
        members = len(rec.block_members)
        eid, _ = srv.job_register(e2e_job(p, name))
        assert srv.wait_for_eval(eid, timeout=WAIT_S).status == "complete"
        want = e2e_job(p, name).task_groups[0].count
        final = "failed" if name == "restart" else "dead"
        assert wait_until(lambda: finals(name) == Counter({final: want})), (
            name, finals(name))
        out[f"block members {name}"] = rec.block_members[members:]
        # Every block member the client reported on was promoted to an
        # object row.
        assert not store().job_alloc_blocks(name)
    runner = next(r for r in client.alloc_runners.values()
                  if r.alloc.job_id == "restart")
    out["restarts"] = runner.task_runners[
        runner.alloc.job.task_groups[0].tasks[0].name].restart_tracker.count
    eid, _ = srv.job_register(e2e_job(p, "stop-me"))
    assert srv.wait_for_eval(eid, timeout=WAIT_S).status == "complete"
    assert wait_until(lambda: finals("stop-me") == Counter({"running": 2}))
    eid, _ = srv.job_deregister("stop-me")
    assert srv.wait_for_eval(eid, timeout=WAIT_S).status == "complete"
    assert wait_until(lambda: not live_allocs(store(), "stop-me"))
    assert wait_until(lambda: all(
        not r.alive() for r in client.alloc_runners.values()
        if r.alloc.job_id == "stop-me"))
    assert wait_until(lambda: finals("stop-me") == Counter({"dead": 2}))
    # Let the last racing reports land before they are read.
    time.sleep(0.3)
    return out


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    assert wait_for_device(timeout=120.0) is not None
    mp = pytest.MonkeyPatch()
    results = {}
    try:
        for p in BOTH:
            mp.setattr(p.fingerprint._MetadataFingerprint, "_get",
                       lambda self, path: None)
            rec = Recorder()
            rec.wrap_alloc_runner(mp, p.alloc_runner)
            root = str(tmp_path_factory.mktemp(p.name))
            srv = new_server(p)
            srv.start()
            rec.wrap_server(srv)
            client = p.pkg.Client(client_config(p, root, rpc_handler=srv))
            client.start()
            try:
                out = drive(p, srv, client, rec)
            finally:
                client.shutdown(destroy_allocs=True)
                srv.shutdown()
            out["root"] = root
            out["rec"] = rec
            results[p.name] = out
    finally:
        mp.undo()
    return results["nomad_tpu"], results["nomad_tpu_torch"]


def test_e2e_registers_the_same_node(e2e):
    docs = [masked_node(side["node"], [side["root"]]) for side in e2e]
    for doc in docs:
        for key in ("create_index", "modify_index", "status_updated_at"):
            doc.pop(key, None)
    assert docs[1] == docs[0]
    assert docs[0]["attributes"]["driver.mock_driver"] == "1"


def by_job(job_id, table):
    return {name: seq for name, seq in table.items()
            if name.startswith(job_id + ".")}


STOPPED = ("dead", "alloc stopped")


def once_stopped(seq):
    """nomad_tpu's alloc runner reports a stopped alloc again on every
    watch wake its own report causes; the port reports it once."""
    return [s for i, s in enumerate(seq)
            if s != STOPPED or STOPPED not in seq[:i]]


@pytest.mark.parametrize("job_id", E2E_JOBS)
def test_e2e_client_status_sequences(e2e, job_id):
    views = []
    for side in e2e:
        seqs = by_job(job_id, side["rec"].status)
        if side is e2e[0]:
            seqs = {name: once_stopped(seq) for name, seq in seqs.items()}
        views.append({name: ([s for s, _ in seq], Counter(seq))
                      for name, seq in seqs.items()})
    assert views[1] == views[0]
    want = {"mock-3": 3, "mock-256": 256, "restart": 1, "stop-me": 2}[job_id]
    assert len(views[0]) == want


@pytest.mark.parametrize("job_id", E2E_JOBS)
def test_e2e_task_events(e2e, job_id):
    views = []
    for side in e2e:
        seqs = by_job(job_id, side["rec"].events)
        views.append({name: ([s for _, s, _ in seq], Counter(seq))
                      for name, seq in seqs.items()})
    assert views[1] == views[0]


def test_e2e_port_reports_a_stop_once(e2e):
    seqs = by_job("stop-me", e2e[1]["rec"].status)
    assert [seq.count(STOPPED) for seq in seqs.values()] == [1, 1]
    assert all(seq[0] == ("running", "") for seq in seqs.values())


def test_e2e_restart_counts_and_blocks(e2e):
    jax_side, port_side = e2e
    keys = ["restarts"] + [f"block members {n}" for n in E2E_JOBS[:3]]
    assert {k: port_side[k] for k in keys} == {k: jax_side[k] for k in keys}
    assert jax_side["restarts"] == 2
    # Only the count-256 job's allocations were committed as a block.
    assert jax_side["block members mock-256"] == [256]
    assert jax_side["block members mock-3"] == []
    events = jax_side["rec"].events["restart.web[0]"]
    assert [s for _, s, _ in events].count("running") == 3


# -- the network path -----------------------------------------------------------


def test_client_over_rpc_against_a_cluster_member(tmp_path):
    from nomad_tpu_torch.server.cluster import form_cluster, wait_for_leader
    from nomad_tpu_torch.server.server import ServerConfig

    (srv,) = form_cluster(1, ServerConfig(
        device="cpu", num_schedulers=1, eval_batch_size=1,
        min_heartbeat_ttl=3600.0, prewarm_shapes=False, seed=SEED))
    client = None
    try:
        wait_for_leader([srv])
        client = PORT.pkg.Client(client_config(
            PORT, str(tmp_path), servers=[srv.rpc_addr]))
        assert type(client.endpoint).__name__ == "RemoteEndpoint"
        client.start()
        for name in ("mock-256", "restart"):
            job = e2e_job(PORT, name)
            eid, _ = srv.job_register(job)
            assert srv.wait_for_eval(eid, timeout=WAIT_S).status == "complete"
            final = "failed" if name == "restart" else "dead"
            want = Counter({final: job.task_groups[0].count})
            assert wait_until(lambda: Counter(
                a.client_status for a in srv.state_store.allocs_by_job(name))
                == want)
        node = srv.state_store.node_by_id(client.node.id)
        assert node.status == "ready"
        assert all(a.node_id == node.id
                   for a in srv.state_store.allocs_by_job("mock-256"))
    finally:
        if client is not None:
            client.shutdown(destroy_allocs=True)
        srv.shutdown(drain_timeout=5.0)


def test_client_only_agent(tmp_path):
    """A client-only agent: no server, a servers list, client stats in
    /v1/agent/self. (nomad_tpu's Agent refuses this config at
    construction: it checks ``self.client``, which only start() builds.)"""
    from nomad_tpu.agent import Agent as JaxAgent
    from nomad_tpu.agent import AgentConfig as JaxAgentConfig
    from nomad_tpu_torch.agent import Agent, AgentConfig
    from nomad_tpu_torch.api import ApiClient, ApiError
    from nomad_tpu_torch.server.cluster import form_cluster, wait_for_leader
    from nomad_tpu_torch.server.server import ServerConfig

    with pytest.raises(ValueError, match="at least client or server"):
        JaxAgent(JaxAgentConfig(client_enabled=True, http_port=0,
                                client_servers=["127.0.0.1:1"]))
    with pytest.raises(ValueError, match="servers list"):
        Agent(AgentConfig(client_enabled=True, http_port=0))
    (srv,) = form_cluster(1, ServerConfig(
        device="cpu", num_schedulers=1, min_heartbeat_ttl=3600.0,
        prewarm_shapes=False))
    agent = None
    try:
        wait_for_leader([srv])
        agent = Agent(AgentConfig(
            client_enabled=True, http_port=0, data_dir=str(tmp_path),
            client_servers=[srv.rpc_addr],
            client_options={"driver.mock_driver.enable": "1"}))
        agent.start()
        api = ApiClient(address=f"http://127.0.0.1:{agent.http.port}")
        info = api.agent().self_info()
        assert info["stats"]["client"]["node_id"] == agent.client.node.id
        assert "server" not in info["stats"]
        assert api.agent().servers() == [srv.rpc_addr]
        assert api.agent().members() == []
        with pytest.raises(ApiError, match="no server running"):
            api.jobs().list()
        assert wait_until(lambda: srv.state_store.node_by_id(
            agent.client.node.id) is not None)
    finally:
        if agent is not None:
            agent.shutdown()
        srv.shutdown(drain_timeout=5.0)


# -- subprocesses that cannot import jax or nomad_tpu ---------------------------


BLOCK = "import sys\n" + "".join(
    f"sys.modules[{m!r}] = None\n" for m in ("jax", "nomad_tpu"))

RAW_JOB = '''job "dev-raw" {
    type = "batch"
    datacenters = ["dc1"]
    group "g" {
        count = 1
        task "echo" {
            driver = "raw_exec"
            config {
                command = "/bin/sh"
                args = ["-c", "echo from-the-task"]
            }
            resources {
                cpu = 100
                memory = 64
            }
        }
    }
}
'''


def blocked_env():
    # No network for the cloud metadata fingerprints: urllib goes through
    # a closed loopback port, except for the loopback itself.
    return dict(os.environ, PYTHONPATH=REPO, http_proxy="http://127.0.0.1:1",
                no_proxy="127.0.0.1,localhost")


def test_dev_agent_runs_a_raw_exec_job_without_jax(tmp_path):
    code = BLOCK + (
        "from nomad_tpu_torch.cli import main\n"
        "rc = main(sys.argv[1:])\n"
        "loaded = [m for m, v in sys.modules.items() if v is not None\n"
        "          and m.split('.')[0] in ('jax', 'nomad_tpu')]\n"
        "assert not loaded, loaded\n"
        "sys.exit(rc)\n")
    job_path = tmp_path / "raw.hcl"
    job_path.write_text(RAW_JOB)
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "agent", "-dev", "-device", "cpu",
         "-http-port", "0", "-data-dir", str(tmp_path / "data")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=blocked_env())
    try:
        addr = None
        for line in proc.stdout:
            if "HTTP at " in line:
                addr = line.split("HTTP at ")[1].strip()
                break
        assert addr, proc.stderr.read()[-3000:]

        def cli(*argv):
            out = subprocess.run(
                [sys.executable, "-c", BLOCK + (
                    "from nomad_tpu_torch.cli import main\n"
                    "sys.exit(main(sys.argv[1:]))\n"), "--address", addr,
                 *argv], capture_output=True, text=True, cwd=REPO,
                env=blocked_env(), timeout=WAIT_S)
            assert out.returncode == 0, (argv, out.stdout, out.stderr)
            return out.stdout

        from nomad_tpu_torch.api import ApiClient

        assert "complete" in cli("run", str(job_path))
        assert wait_until(lambda: " dead" in cli("status", "dev-raw"),
                          every=0.2)
        (stub,), _ = ApiClient(address=addr).jobs().allocations("dev-raw")
        alloc_id = stub["id"]
        assert "Client Status  = dead" in cli("alloc-status", alloc_id)
        stdout = (tmp_path / "data" / "allocs" / alloc_id / "alloc" / "logs"
                  / "echo.stdout")
        assert stdout.read_text() == "from-the-task\n"
        assert cli("client-config", "-servers").split() != []
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=WAIT_S) == 0, proc.stderr.read()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_spawn_daemon_runs_without_torch(tmp_path):
    prefix = str(tmp_path / "task")
    spec = json.dumps({
        "command": "/bin/sh", "args": ["-c", "echo spawned; exit 5"],
        "env": {"PATH": "/usr/bin:/bin"}, "cwd": str(tmp_path),
        "stdout": str(tmp_path / "out"), "stderr": str(tmp_path / "err"),
        "state_prefix": prefix})
    code = BLOCK + "sys.modules['torch'] = None\n" + (
        "from nomad_tpu_torch.cli import main\n"
        "rc = main(['spawn-daemon', sys.argv[1]])\n"
        "loaded = [m for m, v in sys.modules.items() if v is not None\n"
        "          and m.split('.')[0] in ('jax', 'nomad_tpu', 'torch')]\n"
        "assert not loaded, loaded\n"
        "sys.exit(rc)\n")
    out = subprocess.run([sys.executable, "-c", code, spec],
                         capture_output=True, text=True, cwd=REPO,
                         env=blocked_env(), timeout=WAIT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    assert PORT.spawn.read_status(prefix) == 5
    assert (tmp_path / "out").read_text() == "spawned\n"
