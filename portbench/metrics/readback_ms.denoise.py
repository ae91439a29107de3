"""Host time a block to queue its output's copy to pinned host memory: the
program's ``denoise.readback`` spans over its ``denoise.step`` spans."""

from portbench.program_spans import per_span_ms


def read(r):
    return per_span_ms(r, ("denoise.readback",), "denoise.step")
