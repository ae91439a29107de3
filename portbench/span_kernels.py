"""The card's kernels set against the program's own spans: those whose
launch call the host made inside a span of a given name (by the trace's
correlation ids, ``trace.DeviceOp.launch_ns``), for the readers of the
metrics that divide them by the spans.

Every span of one name that these readers take runs the same operations
(a cached step, an encoder pass over a batch of one shape), so each
launches the same number of kernels. Launch times come to the host's clock
through the markers, a few microseconds off, so a kernel launched at a
span's very edge can fall outside it: a span one kernel short of the
others is that, and is read as it is. Spans whose counts scatter further
show a trace that set kernels under the wrong spans (it lost records, and
its clocks were tied to the host's at the wrong markers), and then the
readers report nothing rather than a number off by that: fewer than
``AGREE`` of the spans launch the most common count, or one lies more than
one kernel from it.

A program without spans, a window in which it recorded none of the name,
a trace without launch times, or spans whose counts scatter gives None,
and the reader returns None.
"""

from __future__ import annotations

import bisect
from collections import Counter
from typing import List, Optional, Tuple

from .program_spans import program_spans

AGREE = 0.9  # least share of the spans that launch the most common count


def kernels_in(reading, name: str) -> Optional[Tuple[int, List[List]]]:
    """(the kernels most ``name`` spans launched, the kernels launched
    inside each ``name`` span, a list a span); None where the spans'
    counts scatter."""
    spans = program_spans(reading)
    if spans is None:
        return None
    mine = [(s.start_ns, s.end_ns) for s in spans if s.name == name]
    ks = sorted((op for op in reading.kernels() if op.launch_ns is not None),
                key=lambda op: op.launch_ns)
    if not mine or not ks:
        return None
    launched = [op.launch_ns for op in ks]
    inside = [ks[bisect.bisect_left(launched, a): bisect.bisect_left(launched, b)] for a, b in mine]
    counts = Counter(len(k) for k in inside)
    mode, agree = counts.most_common(1)[0]
    if agree < AGREE * len(inside) or any(abs(c - mode) > 1 for c in counts):
        return None
    return mode, inside


def device_ms_per_span(reading, name: str) -> Optional[float]:
    """Device milliseconds of the kernels launched inside ``name`` spans,
    over the number of those spans."""
    found = kernels_in(reading, name)
    if found is None:
        return None
    _, inside = found
    return sum(op.dur_ns for k in inside for op in k) / 1e6 / len(inside)
