"""Device time a cached decode step: the summed durations of the kernels
launched inside the program's ``canary.step`` spans, over the steps
(``decode_step_ms.transcribe`` is a wall instead, from when the step's
work could start on the card)."""

from portbench.span_kernels import device_ms_per_span


def read(r):
    return device_ms_per_span(r, "canary.step")
