"""K1's share of its roofline: its launches times the least time a launch
needs (``counts.k1_counts`` against ``peaks.json``) over its profiled time."""


def read(r):
    n, t = r.kernel_time("nn_scan")
    if not n or t <= 0 or "nn_scan" not in r.kernel_bounds:
        return None
    return 100.0 * n * r.kernel_bounds["nn_scan"] / t
