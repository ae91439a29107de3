"""Stage timers and device traces: the port of ``crispy_tpu/utils/tracing.py``.

    with stage("transcribe-batch", bus):    # emits {"stage", "seconds", ...}
        ...
    with device_trace("/tmp/trace"):        # torch.profiler capture
        ...

``Timings`` sums the ``stage-timing`` events by stage. ``device_trace``
writes a ``torch.profiler`` Chrome trace where the JAX package writes a
``jax.profiler`` one. Enable debug prints with CRISPY_DEBUG=1.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from pathlib import Path
from typing import Dict, Optional

from ..api.events import BUS, EventBus

DEBUG = os.environ.get("CRISPY_DEBUG", "") not in ("", "0", "false")


def debug(msg: str) -> None:
    if DEBUG:
        print(f"[crispy] {msg}", file=sys.stderr)


@contextlib.contextmanager
def stage(name: str, bus: EventBus = BUS, extra: Optional[dict] = None):
    t0 = time.monotonic()
    try:
        yield
    finally:
        dt = time.monotonic() - t0
        payload = {"stage": name, "seconds": dt, **(extra or {})}
        bus.emit("stage-timing", payload)
        debug(f"{name}: {dt*1000:.1f} ms")


@contextlib.contextmanager
def device_trace(trace_dir: str):
    """torch.profiler capture of the host and, where there is one, the card,
    written as a Chrome trace (``trace.json``) into ``trace_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


class Timings:
    """Collect stage-timing events into per-stage totals (for reports/tests)."""

    def __init__(self, bus: EventBus = BUS):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._unlisten = bus.listen("stage-timing", self._on)

    def _on(self, payload):
        s = payload["stage"]
        self.totals[s] = self.totals.get(s, 0.0) + payload["seconds"]
        self.counts[s] = self.counts.get(s, 0) + 1

    def report(self) -> str:
        lines = [f"{s}: {self.totals[s]*1000:.1f} ms over {self.counts[s]} call(s)"
                 for s in sorted(self.totals, key=self.totals.get, reverse=True)]
        return "\n".join(lines)

    def close(self):
        self._unlisten()
