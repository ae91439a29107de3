"""Host time to queue one cached decode step: the program's ``canary.step``
spans, their mean."""

from portbench.program_spans import per_span_ms


def read(r):
    return per_span_ms(r, ("canary.step",), "canary.step")
