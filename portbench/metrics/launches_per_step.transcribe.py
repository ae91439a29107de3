"""Kernel launches a decode step: the kernels whose launch call the host
made inside the spans around ``sample_decode``, over the cached steps they
ran."""


def read(r):
    counts = r.kernels_in("decode loop")
    steps = r.units.get("decode_steps", 0)
    if not r.ops or not steps or len(counts) != r.calls:
        return None
    return sum(counts) / steps
