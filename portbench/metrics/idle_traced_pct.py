"""Share of the card's idle time in the window that the program's spans
explain: the idle gaps whose middle lies in a span of the program other
than a root (a call as a whole), by ``Reading.idle_by_span``'s rule over
the program's spans alone."""

import dataclasses

from portbench.program_spans import program_spans


def read(r):
    spans = program_spans(r)
    if not r.ops or spans is None:
        return None
    gaps = dataclasses.replace(r, spans=[s for s in spans if s.parent is not None]).idle_by_span()
    idle = sum(gaps.values())
    if idle <= 0:
        return None
    return 100.0 * (idle - gaps.get("harness", 0.0)) / idle
