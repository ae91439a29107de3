"""The encoder's device time a batch: the summed durations of the kernels
launched inside the program's ``canary.encode`` spans, over the spans
(``encoder_ms.transcribe`` is a wall instead, between CUDA events)."""

from portbench.span_kernels import device_ms_per_span


def read(r):
    return device_ms_per_span(r, "canary.encode")
