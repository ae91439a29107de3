"""The program's own spans (``crispy_tpu_torch.utils.tracing``, recorded
while the traced run's profiler session records) that lie inside a traced
run's window, for the readers of the metrics built on them.

Each record has ``name``, ``start_ns`` and ``end_ns`` on the host's
``perf_counter_ns``, as ``trace.Span`` has them, with its ``id`` and the
``parent`` span's id (None for a root: the program's call). A program
without spans, as one older than its tracing, gives None, and so does a
window in which it recorded none: each reader then returns None, and the
run leaves its metric out of the result line.
"""

from __future__ import annotations

from typing import Iterable, Optional


def program_spans(reading) -> Optional[list]:
    try:
        from crispy_tpu_torch.utils.tracing import spans
    except ImportError:
        return None
    w0, w1 = reading.window
    return [s for s in spans() if w0 <= s.start_ns and s.end_ns <= w1] or None


def per_span_ms(reading, summed: Iterable[str], counted: str) -> Optional[float]:
    """Milliseconds of the spans named in ``summed``, all together, over the
    number of ``counted`` spans; None without spans or without a ``counted``."""
    spans = program_spans(reading)
    if spans is None:
        return None
    n = sum(s.name == counted for s in spans)
    if not n:
        return None
    names = set(summed)
    return sum(s.end_ns - s.start_ns for s in spans if s.name in names) / 1e6 / n
