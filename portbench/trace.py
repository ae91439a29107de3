"""The traced run's instruments: host spans, device markers and the
``torch.profiler`` trace of the card, reduced to what the per-layer metric
readers take (``Reading``).

Spans are the benchmark's own: a driver wraps a program function, looked up
by its name where the program calls it, in a span that records its host
start and end (``perf_counter_ns``). A marker is a one-cycle kernel
(``torch.cuda._sleep``) launched on an idle card at a known host time; the
markers tie the trace's clocks to the host's, so that device operations,
and the host calls that queued them, can be set against the spans.
"""

from __future__ import annotations

import bisect
import contextlib
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

MARKER_KERNEL = "spin_kernel"  # the kernel torch.cuda._sleep launches


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int


class Spans:
    """Host spans, kept in memory; ``wrap`` swaps a module attribute for a
    function that records a span around each call, ``restore`` undoes it."""

    def __init__(self):
        self.spans: List[Span] = []
        self.marks: List[int] = []  # host ns of each marker's launch
        self._swapped: List[Tuple[object, str, object]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append(Span(name, t0, time.perf_counter_ns()))

    def mark(self) -> None:
        """A marker kernel; call it with the card idle."""
        import torch

        self.marks.append(time.perf_counter_ns())
        torch.cuda._sleep(1)

    def wrap(self, module, attr: str, name: str, before=None, after=None):
        fn = getattr(module, attr)

        def wrapped(*a, **k):
            if before is not None:
                before()
            with self.span(name):
                out = fn(*a, **k)
                if after is not None:
                    after(out)
            return out

        setattr(module, attr, wrapped)
        self._swapped.append((module, attr, fn))

    def restore(self) -> None:
        for module, attr, fn in reversed(self._swapped):
            setattr(module, attr, fn)
        self._swapped.clear()


@dataclass
class DeviceOp:
    name: str
    start_ns: int  # on the host's perf_counter clock once aligned
    dur_ns: int
    launch_ns: Optional[int] = None  # the host call that queued it, on the same clock


def _times(e) -> Tuple[int, int]:
    if hasattr(e, "start_ns"):
        return int(e.start_ns()), int(e.duration_ns())
    return int(e.start_us() * 1000), int(e.duration_us() * 1000)


def _kineto_ops(prof) -> List[Tuple[str, int, int, Optional[int]]]:
    """(name, start, duration, launch) in ns of every operation the card
    ran; launch is the start of the runtime or driver call with the same
    correlation id (the host side of the trace), or None."""
    events = list(prof.profiler.kineto_results.events())
    calls: Dict[int, int] = {}
    for e in events:
        if e.device_type().name == "CPU" and e.correlation_id() > 0:
            calls.setdefault(e.correlation_id(), _times(e)[0])
    out = []
    for e in events:
        if e.device_type().name == "CUDA":
            out.append((e.name(), *_times(e), calls.get(e.correlation_id())))
    out.sort(key=lambda x: x[1])
    return out


def _offset(found: List[int], marks: List[int]) -> Optional[float]:
    """Median of trace time less host time over the markers, the last found
    matched to the last launched (a trace can lose its first records)."""
    n = min(len(found), len(marks))
    return statistics.median(d - h for d, h in zip(found[-n:], marks[-n:])) if n else None


class DeviceTrace:
    """``torch.profiler`` over the card alone for the measured window."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.spans.mark()

    def stop(self) -> List[DeviceOp]:
        """The card's operations on the host clock: the markers' median
        offset moves every operation's device times, and the markers'
        launch calls move the launch times."""
        import torch

        torch.cuda.synchronize()
        self.spans.mark()
        torch.cuda.synchronize()
        self.prof.stop()
        raw = _kineto_ops(self.prof)
        self.prof = None
        markers = [r for r in raw if MARKER_KERNEL in r[0]]
        offset = _offset([r[1] for r in markers], self.spans.marks)
        if offset is None:
            return []
        host = _offset([r[3] for r in markers if r[3] is not None], self.spans.marks)
        return [DeviceOp(name, int(s - offset), d,
                         None if launch is None or host is None else int(launch - host))
                for name, s, d, launch in raw if MARKER_KERNEL not in name]


@dataclass
class Reading:
    """What a per-layer metric reader takes. Times in seconds; ``ops`` on
    the host clock, relative to nothing in particular (compare them with
    ``window`` and the spans)."""

    window: Tuple[int, int]  # host ns
    calls: int
    units: Dict[str, float]
    flops_done: float
    peaks: Dict[str, float]
    ops: List[DeviceOp] = field(default_factory=list)
    spans: List[Span] = field(default_factory=list)
    kernel_bounds: Dict[str, float] = field(default_factory=dict)  # kernel → least s a launch
    span_device_ms: Dict[str, List[float]] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        """Seconds in the window in which the card ran an operation (the
        union of the operations' intervals)."""
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        w0, w1 = self.window
        merged: List[List[int]] = []
        for op in self.ops:
            a, b = max(op.start_ns, w0), min(op.start_ns + op.dur_ns, w1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def kernels(self) -> List[DeviceOp]:
        return [op for op in self.ops if not op.name.startswith(("Memcpy", "Memset"))]

    def kernel_time(self, part: str) -> Tuple[int, float]:
        """(launches, seconds) of the kernels whose name holds ``part``."""
        ks = [op for op in self.kernels() if part in op.name]
        return len(ks), sum(op.dur_ns for op in ks) / 1e9

    def kernels_in(self, name: str) -> List[int]:
        """Kernels launched inside each ``name`` span, by the host call that
        queued them; nothing where the trace has no launch times."""
        launched = sorted(op.launch_ns for op in self.kernels() if op.launch_ns is not None)
        if not launched:
            return []
        return [bisect.bisect_left(launched, s.end_ns) - bisect.bisect_left(launched, s.start_ns)
                for s in self.spans if s.name == name]

    def span_walls(self, name: str) -> List[int]:
        """The wall of each ``name`` span (spans that end on an idle card)
        from the moment its work could start on the card: the later of the
        span's start and the end of the device work launched before it;
        nothing where the trace has no launch times."""
        ops = sorted((op for op in self.ops if op.launch_ns is not None), key=lambda op: op.launch_ns)
        if not ops:
            return []
        launched, done, end = [], [], self.window[0]
        for op in ops:
            end = max(end, op.start_ns + op.dur_ns)
            launched.append(op.launch_ns)
            done.append(end)
        walls = []
        for s in self.spans:
            if s.name == name:
                k = bisect.bisect_left(launched, s.start_ns)
                walls.append(s.end_ns - max(s.start_ns, done[k - 1] if k else self.window[0]))
        return walls

    def idle_by_span(self) -> Dict[str, float]:
        """Idle seconds of the card in the window, by the innermost host span
        open at each gap's middle ("harness" outside every span)."""
        spans = sorted(self.spans, key=lambda sp: sp.start_ns)
        gaps: Dict[str, float] = {}
        active: List[Span] = []
        i, prev = 0, self.window[0]
        for a, b in self.busy_intervals() + [(self.window[1], self.window[1])]:
            if a > prev:
                t = (prev + a) // 2
                while i < len(spans) and spans[i].start_ns <= t:
                    active.append(spans[i])
                    i += 1
                active = [sp for sp in active if sp.end_ns > t]
                inner = max(active, key=lambda sp: (sp.start_ns, -sp.end_ns), default=None)
                label = inner.name if inner else "harness"
                gaps[label] = gaps.get(label, 0.0) + (a - prev) / 1e9
            prev = max(prev, b)
        return gaps

    def breakdown(self) -> dict:
        """The ten device operations that took most time, by name, and the
        card's idle time by what the host was doing."""
        by_op: Dict[str, float] = {}
        for op in self.ops:
            by_op[op.name[:120]] = by_op.get(op.name[:120], 0.0) + op.dur_ns / 1e9
        gaps = self.idle_by_span()
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in idle]}
