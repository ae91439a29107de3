"""Device time a block: the union of the card's kernels and copies in the
traced window, over the block steps completed (``block step``)."""


def read(r):
    blocks = r.units.get("blocks", 0)
    if not r.ops or not blocks:
        return None
    return r.busy_s() / blocks * 1e3
