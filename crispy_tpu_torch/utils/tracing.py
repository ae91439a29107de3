"""Stage timers and spans: the port of ``crispy_tpu/utils/tracing.py``.

    with stage("transcribe-batch", bus):    # emits {"stage", "seconds", ...}
        ...
    with span("denoise.upload"):            # recorded while a profiler records
        ...

A span records its name, start and end on ``time.perf_counter_ns()``, the
span open around it in the same thread (``parent``), the outermost one
(``root``: the call it belongs to), the thread and its attributes. Spans
are recorded exactly while a ``torch.profiler`` session records in the
process; outside one, ``span()`` reads one flag and returns a shared no-op
context. They stay in memory, the newest ``MAX_SPANS`` of them, and nothing
is written to disk. To read them, run the work inside a session:

    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        denoise_batch(...)
    for s in tracing.spans():
        ...

``stage()`` records a span as well as its ``stage-timing`` event. Enable
debug prints with CRISPY_DEBUG=1.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
import threading
import time
from collections import deque
from typing import List, NamedTuple, Optional

from torch.autograd import profiler as _torch_profiler

from ..api.events import BUS, EventBus

DEBUG = os.environ.get("CRISPY_DEBUG", "") not in ("", "0", "false")

MAX_SPANS = 1 << 20  # the oldest spans go first beyond this


def debug(msg: str) -> None:
    if DEBUG:
        print(f"[crispy] {msg}", file=sys.stderr)


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    parent: Optional[int]  # id of the enclosing span in the same thread
    root: int  # id of the outermost span of that thread's stack (its own where none)
    thread: int
    attrs: dict


_SPANS: deque = deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_open = threading.local()  # .stack: the thread's open spans


def profiling() -> bool:
    """Whether a ``torch.profiler`` session records in this process: the
    module flag torch sets for fast checks from Python, for any set of
    activities."""
    return _torch_profiler._is_profiler_enabled


class _Recording:
    __slots__ = ("name", "attrs", "id", "parent", "root", "start_ns")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = None, self.id
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _open.stack.pop()
        _SPANS.append(Span(self.id, self.name, self.start_ns, end, self.parent, self.root,
                           threading.get_ident(), self.attrs))
        return False


_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """A context that records a span around its body while a profiler
    session records (``profiling()``), and does nothing otherwise."""
    if not profiling():
        return _OFF
    return _Recording(name, attrs)


def spans() -> List[Span]:
    """A copy of the recorded spans, oldest first by end."""
    return list(_SPANS)


@contextlib.contextmanager
def stage(name: str, bus: EventBus = BUS, extra: Optional[dict] = None):
    t0 = time.perf_counter()
    try:
        with span(name, **(extra or {})):
            yield
    finally:
        dt = time.perf_counter() - t0
        payload = {"stage": name, "seconds": dt, **(extra or {})}
        bus.emit("stage-timing", payload)
        debug(f"{name}: {dt*1000:.1f} ms")
