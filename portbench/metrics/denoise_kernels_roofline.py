"""The hand-written kernels' share of their rooflines together: the summed
least times of every launch of K1-K6 that ran, over their summed profiled
times."""


def read(r):
    least = spent = 0.0
    for part, bound in r.kernel_bounds.items():
        n, t = r.kernel_time(part)
        least += n * bound
        spent += t
    if spent <= 0:
        return None
    return 100.0 * least / spent
