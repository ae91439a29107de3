"""Synthetic inputs of K2, the remove_doubling continuation scan
(``rnn_kernels.rd_scan``): packed ``[S, F, 74]`` f32 rows laid out as
``pipeline._pitch_index`` packs them (T1[14], g1[14], valid[14], g0, T0,
Tout[15], pg[15]) and the carries (last_period, last_gain), both ``[S]``.

The kernel tests and ``chip_smoke.py`` draw their K2 rows from here, so
both mean the same by "random" and "continuation-heavy" rows.
"""

from __future__ import annotations

import numpy as np


def random_rows(rng: np.random.Generator, S: int, F: int):
    """Random candidates, gains and valid flags, and random carries."""
    f32 = np.float32
    packed = np.concatenate([
        rng.integers(20, 380, (S, F, 14)).astype(f32),
        rng.random((S, F, 14)).astype(f32),
        (rng.random((S, F, 14)) > 0.3).astype(f32),
        rng.random((S, F, 1)).astype(f32),
        rng.integers(30, 384, (S, F, 1)).astype(f32),
        rng.integers(60, 768, (S, F, 15)).astype(f32),
        rng.random((S, F, 15)).astype(f32),
    ], axis=-1)
    return packed, rng.integers(60, 768, S).astype(f32), rng.random(S).astype(f32)


def continuation_rows(rng: np.random.Generator, S: int, F: int):
    """Rows heavy in continuations, with exact ties: each stream's output
    periods lie within 2 of one period P and its candidates within 3 of
    P // 2, so most sit one or two from the previous frame's half-period;
    T0 in [150, 384), so 5 (k+2)^2 < T0 holds for k up to 2..6; valid flags
    a prefix, as the pipeline's cumprod makes them; g0 and g1 on a 1/8 grid
    (g1 at most 5/8); pitch gains in {1/8, 1/4}, small enough that a - cont
    can pass the floor lo; and ~40% of g1 set exactly to a threshold
    a - cont, cont one of 0, the pitch gains and their halves."""
    f32 = np.float32
    packed, _, lg0 = random_rows(rng, S, F)
    P = rng.integers(120, 700, (S, 1, 1))
    packed[..., 0:14] = P // 2 + rng.integers(-3, 4, (S, F, 14))
    packed[..., 14:28] = np.round(packed[..., 14:28] * 5) / 8
    packed[..., 28:42] = np.arange(14) < rng.integers(0, 15, (S, F, 1))
    packed[..., 42] = np.round(packed[..., 42] * 8) / 8
    packed[..., 43] = rng.integers(150, 384, (S, F))
    packed[..., 44:59] = P + rng.integers(-2, 3, (S, F, 15))
    packed[..., 59:74] = rng.choice(np.array([0.125, 0.25], f32), (S, F, 15))
    g0 = packed[..., 42:43]
    a = np.where(packed[..., 0:14] < 90, f32(0.85) * g0, f32(0.7) * g0)
    cont = rng.choice(np.array([0.0, 0.0625, 0.125, 0.25], f32), (S, F, 14))
    packed[..., 14:28] = np.where(rng.random((S, F, 14)) < 0.4, a - cont, packed[..., 14:28])
    return packed, P[:, 0, 0].astype(f32), lg0
