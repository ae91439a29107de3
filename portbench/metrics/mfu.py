"""The whole step's share of the card's float32 peak: the operations the
algorithm needs for the work completed in the window (``counts.py``) over
the window's wall times the peak."""


def read(r):
    if not r.ops or r.flops_done <= 0:
        return None
    return 100.0 * r.flops_done / (r.window_s * r.peaks["f32_flops_per_s"])
