"""The traced run's device view: torch.profiler (CUPTI) over the window,
each kernel launch's inputs, and the breakdown of busy and idle time.

``LaunchLog`` wraps the coalescer's two kernel entries for the window:
each water-fill's inputs are copied to pinned host memory on a stream of
the harness's own (the roofline's work is reckoned from them after the
window), each greedy scan keeps its shapes. ``DeviceTrace`` reads the
device events out of the profiler, leaves out that stream's, and aligns
them with the program's spans through a marker op over the window.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import yardstick

WATERFILL_KERNEL = "waterfill_kernel"
GREEDY_KERNEL = "greedy_kernel"
# The marker kernel (torch.cuda._sleep) that opens and closes the window.
MARKER = "spin_kernel"
MARKER_CYCLES = 1000
TOP = 10


class LaunchLog:
    """While active, records every water-fill and greedy launch the
    coalescer makes."""

    def __init__(self, cuda: bool):
        self.waterfill: List[tuple] = []
        self.greedy: List[Tuple[int, int, int]] = []
        # The stream the captures run on, off the program's timeline.
        self.side = None
        if cuda:
            import torch

            self.side = torch.cuda.Stream()

    def _capture(self, args) -> tuple:
        """The inputs as host tensors. On the card each is copied to
        pinned host memory on ``side`` once the launching stream has
        written it: no device memory is taken, and the copies are the
        side stream's events, which ``DeviceTrace`` leaves out."""
        if self.side is None:
            return tuple(a.clone() if hasattr(a, "clone") else a
                         for a in args)
        import torch

        self.side.wait_stream(torch.cuda.current_stream())
        out = []
        with torch.cuda.stream(self.side):
            for a in args:
                if hasattr(a, "is_cuda") and a.is_cuda:
                    host = torch.empty(a.shape, dtype=a.dtype,
                                       pin_memory=True)
                    host.copy_(a, non_blocking=True)
                    # The caching allocator may not reuse the input's
                    # memory before the copy has read it.
                    a.record_stream(self.side)
                    a = host
                out.append(a)
        return tuple(out)

    def __enter__(self):
        from nomad_tpu_torch.ops import coalesce

        self._coalesce = coalesce
        self._wf = coalesce.solve_waterfill_batched
        self._gr = coalesce.solve_greedy_batched_shared

        def waterfill(*args):
            self.waterfill.append(self._capture(args))
            return self._wf(*args)

        def greedy(*args):
            used0, k = args[2], args[12]
            self.greedy.append((int(used0.shape[0]), int(used0.shape[1]),
                                int(k)))
            return self._gr(*args)

        coalesce.solve_waterfill_batched = waterfill
        coalesce.solve_greedy_batched_shared = greedy
        return self

    def __exit__(self, *exc):
        self._coalesce.solve_waterfill_batched = self._wf
        self._coalesce.solve_greedy_batched_shared = self._gr

    def waterfill_bounds_ms(self) -> List[float]:
        if self.side is not None:
            self.side.synchronize()
        out = []
        for args in self.waterfill:
            arrays = [a.numpy() if hasattr(a, "numpy") else a
                      for a in args]
            out.append(yardstick.bound_ms(
                *yardstick.waterfill_work(*arrays))[0])
        return out

    def greedy_bounds_ms(self) -> List[float]:
        return [yardstick.bound_ms(*yardstick.greedy_work(b, n, k))[0]
                for b, n, k in self.greedy]


def _kineto_events(prof):
    """(name, is_device, start s, duration s, stream) of every event, in
    the profiler's own time base (a device event's stream is its
    ``device_resource_id``)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns() / 1e9, e.duration_ns() / 1e9
        else:
            start, dur = e.start_us() / 1e6, e.duration_us() / 1e6
        out.append((e.name(), e.device_type() == DeviceType.CUDA, start,
                    dur, getattr(e, "device_resource_id", lambda: None)()))
    return out


def _union(intervals: List[Tuple[float, float]]):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


class DeviceTrace:
    """torch.profiler's device activity (CUPTI: kernels and copies, no
    host ops, so the traced run's host path runs near its untraced pace)
    over the window, which a marker kernel opens and closes on the
    device; the host clock read just before the first marker's launch
    aligns the device timeline with the program's spans."""

    def __init__(self, side=None):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.kernels: List[Tuple[str, float, float]] = []
        self.window = (0.0, 0.0)
        self.offset = None  # program span clock - profiler clock
        # The harness's own stream (``LaunchLog.side``): a marker on it,
        # launched first, names its events, which are left out.
        self.side = side

    def _marker(self) -> float:
        self._torch.cuda.synchronize()
        from nomad_tpu_torch import trace

        t = trace.now()
        self._torch.cuda._sleep(MARKER_CYCLES)
        return t

    def start(self) -> None:
        self.prof.__enter__()
        if self.side is not None:
            with self._torch.cuda.stream(self.side):
                self._torch.cuda._sleep(MARKER_CYCLES)
        self._mark_epoch = self._marker()

    def stop(self) -> None:
        self._marker()
        self._torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        events = [e for e in _kineto_events(self.prof) if e[1]]
        marks = sorted((s, d, r) for n, _dev, s, d, r in events
                       if MARKER in n)
        if self.side is not None and marks and marks[0][2] is not None:
            side = marks.pop(0)[2]
            events = [e for e in events if e[4] != side]
            marks = [m for m in marks if m[2] != side]
        if len(marks) >= 2:
            self.window = (marks[0][0], marks[-1][0] + marks[-1][1])
            self.offset = self._mark_epoch - marks[0][0]
        elif events:
            self.window = (min(e[2] for e in events),
                           max(e[2] + e[3] for e in events))
        w0, w1 = self.window
        self.kernels = [(n, s, d) for n, _dev, s, d, _r in events
                        if MARKER not in n and s + d > w0 and s < w1]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self):
        w0, w1 = self.window
        return _union([(max(s, w0), min(s + d, w1))
                       for _n, s, d in self.kernels if s + d > w0 and s < w1])

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_times_s(self, name: str) -> List[float]:
        return [d for n, _s, d in self.kernels if name in n]

    def device_ops(self) -> List[list]:
        by: Dict[str, float] = {}
        for n, _s, d in self.kernels:
            by[n] = by.get(n, 0.0) + d
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])
                ][:TOP]

    def idle_gaps(self, spans: List[dict]) -> List[list]:
        """The longest idle stretches of the device in the window, each
        named by the program span (a leaf: no child span of its trace
        covers it) that overlaps it most, or "no span"."""
        w0, w1 = self.window
        busy = self.busy_intervals()
        gaps, prev = [], w0
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if w1 > prev:
            gaps.append((prev, w1))
        gaps.sort(key=lambda g: g[0] - g[1])
        gaps = gaps[:TOP]
        parents = {s["parent_id"] for s in spans}
        leaves = [(s["start"], s["end"], s["name"]) for s in spans
                  if s["end"] is not None and s["span_id"] not in parents]
        out = []
        for g0, g1 in gaps:
            label = "no span"
            if self.offset is not None:
                e0, e1 = g0 + self.offset, g1 + self.offset
                cover: Dict[str, float] = {}
                for s0, s1, name in leaves:
                    ov = min(s1, e1) - max(s0, e0)
                    if ov > 0:
                        cover[name] = cover.get(name, 0.0) + ov
                if cover:
                    label = max(cover.items(), key=lambda x: x[1])[0]
            out.append([label, g1 - g0])
        return out


def roofline_pct(bounds_ms: List[float], times_s: List[float]
                 ) -> Optional[float]:
    """Least time over device time, in %, over the launches of the
    window: the launches' bounds summed over their kernels' device time
    summed (launch i is the i-th kernel event). None with nothing to
    read."""
    n = min(len(bounds_ms), len(times_s))
    if n == 0:
        return None
    dev_ms = sum(times_s[:n]) * 1000.0
    if dev_ms <= 0:
        return None
    return 100.0 * sum(bounds_ms[:n]) / dev_ms
