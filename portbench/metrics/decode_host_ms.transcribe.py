"""Host time to queue one cached decode step: the program's ``whisper.step``
spans, their mean."""

from portbench.program_spans import per_span_ms


def read(r):
    return per_span_ms(r, ("whisper.step",), "whisper.step")
