"""Stage timers: the port's copy of ``stage`` from ``crispy_tpu/utils/tracing.py``.

    with stage("transcribe-batch", bus):    # emits {"stage", "seconds", ...}
        ...

Device timelines come from ``torch.profiler`` (``cli bench --profile``,
``chip_smoke.py``), not from here. Enable debug prints with CRISPY_DEBUG=1.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Optional

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
