"""Host time a block to slice its input and upload it: the program's
``denoise.slice`` and ``denoise.upload`` spans over its ``denoise.step``
spans (one a block and shard)."""

from portbench.program_spans import per_span_ms


def read(r):
    return per_span_ms(r, ("denoise.slice", "denoise.upload"), "denoise.step")
