"""Anti-aliased rational resampling: on the host (scipy) or on the device
(one polyphase ``conv1d``).

The port's copy of ``resample_poly`` from ``crispy_tpu/dsp/resample.py``:
``_kaiser_sinc_filter``, the scipy branch the JAX package takes off the TPU
(``denoise_file`` uses it to bring inputs to 48 kHz), and the device branch
``make_resampler_jax`` (``:278-321``) as ``make_resampler``, which
``run_transcription`` uses to bring a recording to 16 kHz on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device


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


def _rates(from_rate: int, to_rate: int):
    g = math.gcd(int(from_rate), int(to_rate))
    return int(to_rate) // g, int(from_rate) // g


def resample_poly(x: np.ndarray, from_rate: int, to_rate: int, wire: str = "f32",
                  device_out: bool = False, device=None):
    """Anti-aliased rational resampling (e.g. 48000 → 16000, 44100 → 48000)
    of a 1-D signal, as polyphase convolution with a Kaiser-windowed sinc
    (≥90 dB stopband).

    By default on the host (scipy), returning numpy. ``device_out=True``, or
    an explicit ``device``, runs the conv on ``device`` (default: the card)
    and returns the result there, for consumers that feed it straight back
    into device compute (run_transcription's chunk batches). ``wire="i16"``
    then uploads the input as int16 PCM: exact when the samples sit on the
    int16 grid, i.e. came from a 16-bit WAV, and half the bytes.
    """
    x = np.asarray(x, dtype=np.float32)
    if not device_out and device is None:
        if from_rate == to_rate or x.size == 0:
            return x.copy()
        from scipy.signal import resample_poly as sp_resample_poly

        up, down = _rates(from_rate, to_rate)
        h = _kaiser_sinc_filter(up, down)
        # scipy treats an array window as the FIR coefficients, compensates
        # the group delay and applies the x up gain itself: hand it the
        # unscaled prototype.
        return sp_resample_poly(x.astype(np.float64), up, down, window=h / up).astype(np.float32)
    dev = resolve_device(device)
    if from_rate == to_rate or x.size == 0:
        return torch.from_numpy(x.copy()).to(dev)
    if wire == "i16":
        x = (x * 32768.0).astype(np.int16)  # exact for 16-bit sources
    return make_resampler(from_rate, to_rate, dev)(torch.from_numpy(x).to(dev))


def make_resampler(from_rate: int, to_rate: int, device=None):
    """Device-resident polyphase resampler: returns a function of a 1-D
    tensor on ``device`` (default: the card), f32 or int16 PCM, of any
    length n → f32 [ceil(n·up/down)] there. One strided ``conv1d`` in f32
    (TF32 is off): y[b*up + c] = Σ_t xpad[b*down + t] · F[c, t] with
    F[c, t] = h[pad + up*(i_lo + t) − down*c] (0 outside)."""
    dev = resolve_device(device)
    up, down = _rates(from_rate, to_rate)
    h = _kaiser_sinc_filter(up, down)
    L = h.size
    pad = L // 2
    i_lo = int(np.floor(-pad / up))
    i_hi = int(np.floor((down * (up - 1) - pad + L - 1) / up))
    c = np.arange(up)[:, None]
    t = np.arange(i_hi - i_lo + 1)[None, :]
    hidx = pad + up * (i_lo + t) - down * c
    filt = np.where((hidx >= 0) & (hidx < L), h[np.clip(hidx, 0, L - 1)], 0.0)
    weight = torch.from_numpy(filt.astype(np.float32))[:, None, :].to(dev)  # [up, 1, T]

    def fn(x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.int16:  # i16 wire: exact power-of-two rescale
            x = x.float() / 32768.0
        n = x.shape[0]
        nout = int(np.ceil(n * up / down))
        B = -(-nout // up)
        rpad = max(0, (B - 1) * down + i_hi + 1 - n)
        xp = F.pad(x, (-i_lo, rpad))[None, None, :]
        out = F.conv1d(xp, weight, stride=down)[0]  # [up, B']
        return out.T.reshape(-1)[:nout]

    return fn
