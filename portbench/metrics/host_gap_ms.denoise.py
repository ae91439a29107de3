"""Host gap a block: the traced window's wall less the time in which the
card ran anything, over the block steps completed (``host loop``)."""


def read(r):
    blocks = r.units.get("blocks", 0)
    if not r.ops or not blocks:
        return None
    return (r.window_s - r.busy_s()) / blocks * 1e3
