"""Kernel launches a cached decode step: the kernels whose launch call the
host made inside the program's ``canary.step`` spans, the count most steps
show (every step runs the same operations; nothing is read where the
steps' counts scatter, ``span_kernels``)."""

from portbench.span_kernels import kernels_in


def read(r):
    found = kernels_in(r, "canary.step")
    return None if found is None else found[0]
