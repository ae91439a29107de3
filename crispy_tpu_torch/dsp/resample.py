"""Sample-rate conversion: the streaming linear resamplers on the host, and
anti-aliased rational resampling on the host (scipy) or on the device (one
polyphase ``conv1d``).

The port's copies from ``crispy_tpu/dsp/resample.py``:

  * ``LinearResampler`` — the input-side streaming linear interpolator
    (src-tauri/src/audio.rs:73-134): same-rate bypass (<1 Hz delta), full
    state reset on a rate swap, whole blocks with the reference's emission
    pattern.
  * ``PullResampler`` — the output-side ring-buffer interpolator of the NS
    processors' ``next_sample`` (audio.rs:140-199, 297-315).
  * ``resample_block`` — one-shot linear block resampling of the capture
    feeds (src-tauri/src/recording.rs:13-39).
  * ``_kaiser_sinc_filter`` and ``resample_poly``: the scipy branch the JAX
    package takes off the TPU (``denoise_file`` uses it to bring inputs to
    48 kHz) and the device branch ``make_resampler_jax`` (``:278-321``) as
    ``make_resampler``, which ``run_transcription`` and the CLI's
    ``resample`` use on the card.

The three streaming classes are host NumPy, as in the JAX package, and give
its bits.
"""

from __future__ import annotations

import math
from collections import deque

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device


class LinearResampler:
    """Streaming linear interpolator with reference emission semantics.

    Feeding sample x_n (n >= 1 after the priming sample) emits outputs for
    every pending output position p <= n, each valued
    lerp(x_{n-1}, x_n, clamp(p - (n-1), 0, 1)); output positions advance by
    step = in_rate / out_rate. Rates within 1 Hz bypass entirely.
    """

    def __init__(self, input_rate: float, output_rate: float):
        self.input_rate = float(input_rate)
        self.output_rate = float(output_rate)
        self._reset()

    def _reset(self):
        self.last_sample = np.float32(0.0)
        self.has_last = False
        self.input_pos = 0.0
        self.next_output_pos = 0.0

    def set_rates(self, input_rate: float, output_rate: float) -> None:
        self.input_rate = float(input_rate)
        self.output_rate = float(output_rate)
        self._reset()

    @property
    def bypass(self) -> bool:
        return abs(self.input_rate - self.output_rate) < 1.0

    def process(self, samples: np.ndarray) -> np.ndarray:
        """Consume a block, return all emitted output samples (float32)."""
        x = np.asarray(samples, dtype=np.float32)
        if x.size == 0:
            return x
        if self.bypass:
            return x.copy()

        if not self.has_last:
            self.last_sample = x[0]
            self.has_last = True
            self.input_pos = 0.0
            self.next_output_pos = 0.0
            x = x[1:]
            if x.size == 0:
                return np.empty(0, np.float32)

        # f32 division then f64 accumulation — the reference's exact step
        # arithmetic (audio.rs:124: `(input_rate / output_rate) as f64`).
        step = float(np.float32(self.input_rate) / np.float32(self.output_rate))
        n0 = self.input_pos  # position of last consumed sample
        n_last = n0 + x.size
        # Pending output positions p_k = next_output_pos + k*step, p_k <= n_last.
        if self.next_output_pos > n_last:
            k = 0
        else:
            k = int(math.floor((n_last - self.next_output_pos) / step)) + 1
            while self.next_output_pos + k * step <= n_last:  # fp guard
                k += 1
        if k == 0:
            self.input_pos = n_last
            self.last_sample = x[-1]
            return np.empty(0, np.float32)

        p = self.next_output_pos + step * np.arange(k, dtype=np.float64)
        # Emitting input index n(p) = first integer n >= p within (n0, n_last].
        n = np.maximum(np.ceil(p), np.float64(n0 + 1.0))
        t = np.clip(p - (n - 1.0), 0.0, 1.0).astype(np.float32)
        li = (n - n0 - 1).astype(np.int64)  # local index of x_n in this block
        prev = np.concatenate([[self.last_sample], x[:-1]])
        out = prev[li] + (x[li] - prev[li]) * t

        self.next_output_pos = float(p[-1] + step)
        self.input_pos = n_last
        self.last_sample = x[-1]
        return out.astype(np.float32)


class PullResampler:
    """Output-side interpolating reader over a bounded ring buffer.

    Mirrors the NS processors' ``next_sample`` loop: keeps a read position
    in [0, 1), pops consumed samples, returns 0.0 while fewer than two
    samples are buffered. The buffer is a bounded deque that drops its
    oldest samples, as the JAX package's list does one ``pop(0)`` at a time:
    the same samples, without a copy of the whole 1 s buffer per sample
    pushed once it is full (~6 ms a 480-sample frame, when nothing pulls).
    """

    def __init__(self, input_rate: float, output_rate: float, max_len: int):
        self.input_rate = float(input_rate)
        self.output_rate = float(output_rate)
        self.max_len = int(max_len)
        self._buf: deque = deque(maxlen=self.max_len)
        self.resample_pos = 0.0

    def push(self, samples) -> None:
        self._buf.extend(np.asarray(samples, dtype=np.float32).ravel())

    def next_sample_opt(self):
        """One output sample, or None when under-buffered (the reference's
        early `return 0.0` paths, audio.rs:168-179 — distinct from a real
        0.0 sample so callers can skip their post-processing exactly when
        the reference does)."""
        if len(self._buf) < 2:
            return None
        step = self.input_rate / self.output_rate
        while self.resample_pos >= 1.0:
            self._buf.popleft()
            self.resample_pos -= 1.0
            if len(self._buf) < 2:
                return None
        s0, s1 = self._buf[0], self._buf[1]
        frac = np.float32(self.resample_pos)
        self.resample_pos += step
        return float(s0 + (s1 - s0) * frac)

    def next_sample(self) -> float:
        s = self.next_sample_opt()
        return 0.0 if s is None else s


def resample_block(samples: np.ndarray, from_rate: float, to_rate: float) -> np.ndarray:
    """One-shot linear block resample (recording.rs:13-39 semantics).

    The host path the recording worker's capture feeds use: capture blocks
    are small and arrive on host threads, where a device round trip would
    cost more than the arithmetic. ``resample_poly`` is the anti-aliased
    bulk path; the native runtime's ``resampler_process`` mirrors the
    streaming ``LinearResampler``."""
    x = np.asarray(samples, dtype=np.float32)
    if abs(from_rate - to_rate) < 1e-6 or x.size == 0:
        return x.copy()
    ratio = float(from_rate) / float(to_rate)
    out_len = int(x.size / ratio)
    idx = np.arange(out_len, dtype=np.float64) * ratio
    i0 = np.minimum(idx.astype(np.int64), x.size - 1)
    i1 = np.minimum(i0 + 1, x.size - 1)
    frac = (idx - i0).astype(np.float32)
    return (x[i0] + (x[i1] - x[i0]) * frac).astype(np.float32)


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
