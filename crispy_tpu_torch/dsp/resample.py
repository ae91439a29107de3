"""Anti-aliased rational resampling on the host (scipy).

The port's copy of the host branch of ``crispy_tpu/dsp/resample.py``
(``_kaiser_sinc_filter`` and ``resample_poly``'s scipy path, the branch the
JAX package itself takes off the TPU). ``denoise_file`` uses it to bring
inputs that are not at 48 kHz to the denoiser's rate.
"""

from __future__ import annotations

import math

import numpy as np


def _kaiser_sinc_filter(up: int, down: int, taps_per_phase: int = 24, beta: float = 9.0):
    """Lowpass prototype for rational-rate conversion by up/down.

    The length scales with max(up, down), not up: for down-heavy
    conversions (48k→16k: up=1, down=3) an up-scaled filter collapses to
    ~taps_per_phase taps and the anti-alias stopband evaporates. scipy's
    resample_poly sizes its default window the same way
    (half_len = 10 * max(up, down))."""
    cutoff = 0.5 / max(up, down)  # normalized to the upsampled rate
    half = taps_per_phase * max(up, down) // 2
    n = np.arange(-half, half + 1, dtype=np.float64)
    h = 2 * cutoff * np.sinc(2 * cutoff * n)
    h *= np.kaiser(n.size, beta)
    h *= up  # gain compensation for zero-stuffing
    return h.astype(np.float64)


def resample_poly(x: np.ndarray, from_rate: int, to_rate: int) -> np.ndarray:
    """Anti-aliased rational resampling (e.g. 44100 → 48000) of a 1-D signal,
    as polyphase convolution with a Kaiser-windowed sinc (≥90 dB stopband)."""
    x = np.asarray(x, dtype=np.float32)
    if from_rate == to_rate or x.size == 0:
        return x.copy()
    from scipy.signal import resample_poly as sp_resample_poly

    g = math.gcd(int(from_rate), int(to_rate))
    up, down = int(to_rate) // g, int(from_rate) // g
    h = _kaiser_sinc_filter(up, down)
    # scipy treats an array window as the FIR coefficients, compensates the
    # group delay and applies the x up gain itself: hand it the unscaled
    # prototype.
    return sp_resample_poly(x.astype(np.float64), up, down, window=h / up).astype(np.float32)
