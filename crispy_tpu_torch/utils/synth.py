"""Synthetic multi-speaker audio: alternating AM tones (distinct spectral
envelopes standing in for speakers) separated by silent gaps.

The port's copy of ``crispy_tpu/utils/synth.py``: the same draws, the same
samples. ``chip_smoke.py`` diarizes an hour of it on the card.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def synth_speaker_hour(
    minutes: float = 60,
    sr: int = 16000,
    durs: Sequence[float] = (2.0, 3.0, 4.0, 6.0, 8.0),
    freqs: Sequence[float] = (150.0, 450.0, 1200.0),
    gap_seconds: float = 0.8,
    level: float = 0.4,
    noise: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """[minutes·60·sr] float32 mono: alternating AM tone bouts + gaps.

    Bout durations cycle through `durs` and carrier frequencies through
    `freqs` (each frequency acts as one "speaker"); every bout gets a
    (2 + i%3) Hz amplitude modulation so the level varies like speech.
    `noise` adds white noise at that amplitude (0 keeps bouts clean).
    """
    target = int(minutes * 60 * sr)
    rng = np.random.default_rng(seed)
    gap = np.zeros(int(gap_seconds * sr), np.float32)
    pieces, total, i = [], 0, 0
    while total < target:
        d = durs[i % len(durs)]
        f = freqs[i % len(freqs)]
        t = np.arange(int(d * sr)) / sr
        am = 1.0 + 0.3 * np.sin(2 * np.pi * (2 + (i % 3)) * t)
        tone = level * np.sin(2 * np.pi * f * t) * am
        if noise:
            tone = tone + noise * rng.standard_normal(t.size)
        pieces += [tone.astype(np.float32), gap]
        total += t.size + gap.size
        i += 1
    return np.concatenate(pieces)[:target]
