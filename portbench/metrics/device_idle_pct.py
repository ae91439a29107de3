"""Share of the traced window in which the card ran nothing."""


def read(r):
    if not r.ops:
        return None
    return 100.0 * (1.0 - r.busy_s() / r.window_s)
