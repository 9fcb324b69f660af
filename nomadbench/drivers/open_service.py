"""Open-loop service jobs over a half-full cluster.

Set-up fills the cluster to ``prefill.cpu_share`` of its cpu with batch
jobs (the water-fill). Service jobs then arrive at ``rate_per_s`` as a
Poisson process; each is deregistered ``lifetime`` after it was placed.
Every request is timed from when it was due, so a stall counts against
every request it delays; the lateness of the generator itself is
reported apart.

Every seed sends the same work in another order: the inter-arrival gaps,
the counts and the lifetimes are the quantiles (i + 0.5) / n of their
distributions, each permuted by the seed. Counts are log-normal (median
and sigma of the mix) rounded and clipped to [min, max].
"""

from __future__ import annotations

import heapq
import math
import statistics
import threading
import time
from typing import Dict, List

import numpy as np

from nomadbench import cluster


def schedule(traffic: dict, rng, seconds: float):
    """(arrival offsets s, counts, lifetimes s) of the requests one window
    of ``seconds`` sends."""
    rate = float(traffic["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    expo = -np.log1p(-q)
    gaps = rng.permutation(expo / rate)
    offsets = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    c = traffic["count"]
    z = np.array([statistics.NormalDist().inv_cdf(x) for x in q])
    counts = np.clip(np.rint(c["median"] * np.exp(c["sigma"] * z)),
                     c["min"], c["max"]).astype(int)
    lifetimes = expo * traffic["lifetime_mean_s"]
    return offsets, rng.permutation(counts), rng.permutation(lifetimes)


def _job_spec(run, count: int) -> dict:
    t = run.traffic
    return dict(id=run.job_id("svc"), name="svc", type="service",
                datacenters=list(t["datacenters"]),
                constraints=[t["constraint"]], count=int(count),
                cpu=t["cpu"], memory_mb=t["memory_mb"], env={},
                # Counts far under the node count on nodes within a few
                # tasks of one another: the anti-affinity penalty (10)
                # outweighs every BestFit gap.
                one_per_node=True)


class OpenLoop:
    """A submitter thread that sends each request at its due time and a
    monitor thread that sees each eval end in the store; a completed
    registration schedules the job's stop ``lifetime`` later, if that
    falls before the close."""

    def __init__(self, run, t0: float, seconds: float, in_window: bool,
                 rng):
        self.run, self.t0, self.close = run, t0, t0 + seconds
        self.in_window = in_window
        self.specs: Dict[str, dict] = {}
        self.stopped: set = set()
        self.recs: List[dict] = []
        self._heap: list = []
        self._seq = 0
        self._cv = threading.Condition()
        self._outstanding: Dict[str, dict] = {}
        self._closed = False
        offsets, counts, lifetimes = schedule(run.traffic, rng, seconds)
        for off, cnt, life in zip(offsets, counts, lifetimes):
            self._push(t0 + off, "register", (int(cnt), float(life)))

    def _push(self, due, kind, payload):
        with self._cv:
            heapq.heappush(self._heap, (due, self._seq, kind, payload))
            self._seq += 1
            self._cv.notify()

    def _record(self, **rec) -> dict:
        rec["in_window"] = self.in_window
        rec = self.run.record(**rec) if self.in_window else dict(
            rec, done=None, status="")
        self.recs.append(rec)
        return rec

    def _submit(self, due, kind, payload) -> None:
        srv = self.run.srv
        sent = time.perf_counter()
        if kind == "register":
            count, life = payload
            spec = _job_spec(self.run, count)
            self.specs[spec["id"]] = spec
            call = lambda: srv.job_register(cluster.job_from_spec(spec))
            jid = spec["id"]
        else:
            jid, life = payload, 0.0
            self.stopped.add(jid)
            call = lambda: srv.job_deregister(jid)
        rec = self._record(kind=kind, due=due, sent=sent, job_id=jid)
        rec["lifetime"] = life
        try:
            rec["eval_id"], _ = call()
        except Exception as e:  # a refused request counts as failed
            rec["error"] = repr(e)
            return
        with self._cv:
            self._outstanding[rec["eval_id"]] = rec

    def submitter(self) -> None:
        while True:
            with self._cv:
                while True:
                    if self._closed:
                        return
                    now = time.perf_counter()
                    if self._heap and self._heap[0][0] <= now:
                        due, _s, kind, payload = heapq.heappop(self._heap)
                        break
                    wait = self._heap[0][0] - now if self._heap else 0.05
                    self._cv.wait(min(wait, 0.05))
            if due >= self.close:
                with self._cv:
                    self._closed = True
                return
            self._submit(due, kind, payload)

    def monitor(self, until: float) -> None:
        """Poll the outstanding evals until none is left and the
        submitter is done, or ``until`` (perf_counter) passes."""
        srv = self.run.srv
        while True:
            with self._cv:
                items = list(self._outstanding.items())
                idle = self._closed and not items
            if idle or time.perf_counter() > until:
                return
            now = time.perf_counter()
            for eid, rec in items:
                done, status, _ = cluster.eval_state(srv, eid)
                if not done:
                    continue
                rec["done"], rec["status"] = now, status
                with self._cv:
                    self._outstanding.pop(eid, None)
                if (rec["kind"] == "register" and status == "complete"
                        and now + rec["lifetime"] < self.close):
                    self._push(now + rec["lifetime"], "deregister",
                               rec["job_id"])
            time.sleep(cluster.POLL_S)

    def drive(self) -> None:
        """Send until the close."""
        sub = threading.Thread(target=self.submitter,
                               name="nomadbench-submit", daemon=True)
        sub.start()
        self.monitor(until=self.close)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        sub.join()

    def settle(self) -> None:
        """Wait for what was sent before the close."""
        self.monitor(until=self.close + cluster.EVAL_WAIT_S)

    def wanted(self) -> Dict[str, dict]:
        """Each job the loop sent, with the live count it must hold now."""
        return {jid: dict(spec, count=0 if jid in self.stopped
                          else spec["count"])
                for jid, spec in self.specs.items()}


def _prefill(run) -> Dict[str, dict]:
    t, cfg = run.traffic, run.cfg
    p = t["prefill"]
    res = cfg["nodes"]["resources"]
    tasks = p["cpu_share"] * cfg["nodes"]["count"] * res["cpu"] / t["cpu"]
    n_jobs = math.ceil(tasks / p["tasks_per_job"])
    specs = {}
    for j in range(n_jobs):
        s = dict(id=run.job_id(f"fill{j}"), name="fill", type="batch",
                 datacenters=list(p["datacenters"]),
                 constraints=[t["constraint"]], count=p["tasks_per_job"],
                 cpu=t["cpu"], memory_mb=t["memory_mb"], env={},
                 spread="waterfill")
        specs[s["id"]] = s
    t0 = time.perf_counter()
    eids = [run.srv.job_register(cluster.job_from_spec(s))[0]
            for s in specs.values()]
    got = cluster.wait_evals(run.srv, eids, t0 + cluster.EVAL_WAIT_S)
    bad = [s for _d, s in got.values() if s != "complete"]
    if bad:
        raise RuntimeError(f"the prefill's evals ended {bad}")
    return specs


def _stop_all(run, loop: OpenLoop) -> None:
    srv = run.srv
    live = [jid for jid in loop.specs if jid not in loop.stopped]
    t0 = time.perf_counter()
    eids = [srv.job_deregister(jid)[0] for jid in live]
    loop.stopped.update(live)
    cluster.wait_evals(srv, eids, t0 + cluster.EVAL_WAIT_S)


def setup(run) -> None:
    run.state["fill"] = _prefill(run)
    warm = OpenLoop(run, time.perf_counter(), run.traffic["warmup_s"],
                    in_window=False,
                    rng=np.random.default_rng([run.seed % (2 ** 63), 1]))
    warm.drive()
    warm.settle()
    _stop_all(run, warm)
    run.state["warm"] = warm.wanted()


def window(run, t0: float, seconds: float) -> float:
    loop = OpenLoop(run, t0, seconds, in_window=True, rng=run.rng)
    run.state["loop"] = loop
    loop.drive()
    return time.perf_counter()


def finish(run) -> None:
    loop = run.state["loop"]
    loop.settle()
    late = [(r["sent"] - r["due"]) * 1000.0 for r in loop.recs]
    if late:
        run.counters["generator_late_p50_ms"] = float(np.median(late))
        run.counters["generator_late_max_ms"] = float(max(late))
    jobs = {**run.state["fill"], **run.state["warm"], **loop.wanted()}
    run.samples.append((run.srv.state_store.snapshot(), jobs,
                        [r["status"] for r in loop.recs]))
