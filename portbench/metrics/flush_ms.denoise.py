"""Host time a block in the flushes (the wait for the card, then the
concatenation into the output): the program's ``denoise.flush`` spans over
its ``denoise.step`` spans."""

from portbench.program_spans import per_span_ms


def read(r):
    return per_span_ms(r, ("denoise.flush",), "denoise.step")
