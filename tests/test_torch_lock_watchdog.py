"""The port's LockWatchdog (nomad_tpu_torch.telemetry) against nomad_tpu's.

Each behaviour is driven the same way through both packages' watchdogs
and must give the same books: contended-acquisition timing, the untimed
uncontended fast path, the closure (proven-edge) and rank violation
semantics, ``install()`` wrapping only the construction sites it knows,
and the published active watchdog. Then the port's own lock analysis
(``tools.nomadlint.lockorder`` over ``nomad_tpu_torch``): no cycle, every
site inside the port, and a port ``Server`` driven through a burst of
evals under the watchdog records no violation while it exercises edges
the analysis proved.

Tolerance: counts and violation sets exact; a wait or hold is held to a
range around the injected 50 ms (timings are never compared across the
packages).
"""

import threading

import pytest

from nomad_tpu import telemetry as jt
from nomad_tpu_torch import mock, structs
from nomad_tpu_torch import telemetry as pt
from nomad_tpu_torch.server.server import Server, ServerConfig

MODS = pytest.mark.parametrize("mod", [jt, pt], ids=["nomad_tpu", "port"])


def _contend(mod):
    wd = mod.LockWatchdog(order=["a", "b"], sites={})
    lock = wd.watch(threading.Lock(), "a")
    holding, release = threading.Event(), threading.Event()

    def holder():
        with lock:
            holding.set()
            release.wait(5)

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    assert holding.wait(5)
    timer = threading.Timer(0.05, release.set)
    timer.start()
    with lock:
        pass
    t.join(5)
    return wd.stats()


@MODS
def test_contention_is_timed(mod):
    stats = _contend(mod)
    assert stats["installed"] is False
    (row,) = stats["contention"]
    assert (row["lock"], row["acquisitions"], row["contended"],
            row["contention_rate"]) == ("a", 2, 1, 0.5)
    assert 10.0 < row["wait_total_ms"] < 5000.0
    assert row["wait_ms"]["p95"] >= 10.0
    assert row["hold_ms"]["max"] >= 10.0


def test_contention_rows_keep_nomad_tpus_keys():
    j, p = _contend(jt), _contend(pt)
    assert set(p) == set(j)
    assert set(p["contention"][0]) == set(j["contention"][0])
    for k in ("wait_ms", "hold_ms"):
        assert set(p["contention"][0][k]) == set(j["contention"][0][k])


@MODS
def test_uncontended_fast_path_is_untimed(mod):
    wd = mod.LockWatchdog(order=["a"], sites={})
    lock = wd.watch(threading.Lock(), "a")
    for _ in range(5):
        with lock:
            pass
    (row,) = wd.stats()["contention"]
    assert (row["acquisitions"], row["contended"], row["wait_total_ms"]) \
        == (5, 0, 0)


def _drive(wd):
    la = wd.watch(threading.Lock(), "a")
    lb = wd.watch(threading.Lock(), "b")
    lc = wd.watch(threading.Lock(), "c")
    with lb:
        with la:
            pass
    with lc:
        with la:
            pass
    with la:
        with lb:
            pass


@pytest.mark.parametrize("closure", [None, {("a", "b")}, set()],
                         ids=["ranks", "proven-edge", "no-edges"])
def test_violation_semantics_equal_nomad_tpus(closure):
    """Without ``closure=`` a rank inversion is a violation; with it,
    only an inversion of a proven edge is, and other pairs are only
    observed."""
    got = []
    for mod in (jt, pt):
        wd = mod.LockWatchdog(order=["a", "b", "c"], sites={},
                              closure=closure)
        _drive(wd)
        got.append(([(v.held, v.acquired, v.thread) for v in wd.violations],
                    sorted(wd.observed_edges())))
    assert got[1] == got[0]
    want = {None: [("b", "a"), ("c", "a")], "proven-edge": [("b", "a")]}
    key = None if closure is None else ("proven-edge" if closure
                                        else "no-edges")
    assert [v[:2] for v in got[1][0]] == want.get(key, [])


def test_assert_clean_names_the_inversion():
    wd = pt.LockWatchdog(order=["m.A", "m.B"], sites={})
    a = wd.watch(threading.Lock(), "m.A")
    b = wd.watch(threading.Lock(), "m.B")
    with a:
        with b:
            pass
    wd.assert_clean()
    with b:
        with a:
            pass
    with pytest.raises(AssertionError, match="m.B -> m.A"):
        wd.assert_clean()


@MODS
def test_install_wraps_only_known_sites(mod, tmp_path):
    src = tmp_path / "fixmod.py"
    src.write_text("import threading\n"
                   "def build():\n"
                   "    return threading.Lock(), threading.RLock()\n")
    ns = {}
    exec(compile(src.read_text(), str(src), "exec"), ns)
    real = (threading.Lock, threading.RLock)
    wd = mod.LockWatchdog(order=["fix.L"], sites={("fixmod.py", 3): "fix.L"},
                          repo=str(tmp_path))
    with wd:
        known, known_r = ns["build"]()
        unknown = threading.Lock()  # this test file: not a known site
    assert isinstance(known, mod._WatchedLock)
    assert isinstance(known_r, mod._WatchedLock)
    assert not isinstance(unknown, mod._WatchedLock)
    with known, known_r, known_r:
        pass
    assert (threading.Lock, threading.RLock) == real
    assert wd.violations == []
    # Each acquire of the id is booked, the RLock's reentry too.
    assert wd.stats()["contention"][0]["acquisitions"] == 3


@MODS
def test_install_publishes_the_active_watchdog(mod):
    wd = mod.LockWatchdog(order=["x"], sites={})
    assert mod.active_lock_watchdog() is None
    with wd:
        assert mod.active_lock_watchdog() is wd
        assert wd.stats()["installed"] is True
        with pytest.raises(RuntimeError, match="already installed"):
            wd.install()
    assert mod.active_lock_watchdog() is None
    assert wd.stats()["installed"] is False


def test_port_analysis_has_no_cycle_and_only_port_sites():
    from tools.nomadlint import lockorder
    from tools.nomadlint.project import Project

    an = lockorder.analyze(Project(roots=("nomad_tpu_torch",)))
    assert an.order and not an.cycles
    sites = an.sites()
    assert sites and all(f.startswith("nomad_tpu_torch/") for f, _l in sites)
    assert all(lock.startswith("nomad_tpu_torch.") for lock in an.order)
    wd = pt.port_lock_watchdog()
    assert wd._sites == {tuple(k): v for k, v in sites.items()}
    assert wd._closure == an.closure()


def test_port_server_burst_records_no_violation():
    """A port Server built and driven under the agent's watchdog (the
    closure semantics): no nested acquisition of a 4-worker burst inverts
    an edge the port's analysis proved. (Rank semantics would also flag
    pairs the analysis never related, e.g. the SLO monitor's poll lock
    and the event broker's lock, unrelated in nomad_tpu's analysis too.)"""
    from tools.nomadlint import lockorder
    from tools.nomadlint.project import Project

    an = lockorder.analyze(Project(roots=("nomad_tpu_torch",)))
    wd = pt.port_lock_watchdog()
    with wd:
        srv = Server(ServerConfig(device="cpu", scheduler_workers=4,
                                  min_heartbeat_ttl=3600.0,
                                  prewarm_shapes=False))
        try:
            srv.start()
            srv.node_batch_register([mock.node() for _ in range(10)])
            jobs = []
            for i in range(6):
                job = mock.job()
                job.task_groups[0].count = 3 if i % 2 else 200
                if not i % 2:
                    job.type = structs.JOB_TYPE_BATCH
                    job.task_groups[0].tasks[0].resources.networks = []
                    job.task_groups[0].tasks[0].resources.cpu = 20
                    job.task_groups[0].tasks[0].resources.memory_mb = 10
                jobs.append(job)
            eval_ids = [srv.job_register(j)[0] for j in jobs]
            for eid in eval_ids:
                ev = srv.wait_for_eval(eid, timeout=30.0)
                assert ev.status == structs.EVAL_STATUS_COMPLETE
        finally:
            srv.shutdown()
    wd.assert_clean()
    stats = wd.stats()
    assert stats["locks_tracked"] > 5 and stats["violations"] == 0
    observed = wd.observed_edges()
    assert observed & an.closure(), sorted(observed)[:5]


def test_agent_that_fails_to_build_leaves_no_watchdog():
    """The agent installs the watchdog before it builds its server; a
    construction that raises uninstalls it (no shutdown will come)."""
    from nomad_tpu_torch.agent import Agent, AgentConfig

    real = (threading.Lock, threading.RLock)
    with pytest.raises(ValueError, match="client or server"):
        Agent(AgentConfig(lock_watchdog=True))
    assert pt.active_lock_watchdog() is None
    assert (threading.Lock, threading.RLock) == real
