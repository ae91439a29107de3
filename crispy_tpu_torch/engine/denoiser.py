"""Batched file and array denoising on the card (the port of the batch
surface of ``crispy_tpu/engine/denoiser.py``).

``denoise_file`` and ``denoise_array`` run whole files, or batches of
streams, through ``pipeline.denoise_batch`` in fixed blocks. They take
``device=None``, which means the CUDA card; with no card they raise. The
streaming processors of the JAX package (``RnnNoiseProcessor``, ``NsState``,
``LegacyProcessor``) belong to later slices of the port; ``_Lcg``, the legacy
models' noise source, is copied for the CLI's ``--ns-model noisy``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..dsp.rnnoise import pipeline
from ..dsp.rnnoise.constants import FRAME_SIZE as FRAME
from ..dsp.rnnoise.weights import RNNoiseModel
from ..io import wav as wavio

class _Lcg:
    """The legacy models' 32-bit LCG noise source (audio.rs:157-163)."""

    A = 1_664_525
    C = 1_013_904_223
    M = 1 << 32

    def __init__(self, seed: int = 0x1234_ABCD):
        self.state = np.uint32(seed)
        self._jump_n = 0
        self._a_pow = None
        self._c_geo = None

    def next_noise(self) -> float:
        self.state = np.uint32(
            (np.uint64(self.state) * np.uint64(self.A) + np.uint64(self.C))
            & np.uint64(0xFFFFFFFF)
        )
        return (float(self.state) / float(0xFFFFFFFF)) * 2.0 - 1.0

    def next_block(self, n: int) -> np.ndarray:
        """n sequential draws, vectorized via the closed form
        state_j = a^j s0 + c (a^{j-1} + ... + 1)  (mod 2^32) — bit-identical
        to n next_noise() calls, no per-sample Python loop."""
        if n <= 0:
            return np.zeros(0, np.float32)
        if self._jump_n != n:
            a_pow = np.empty(n, np.uint64)
            c_geo = np.empty(n, np.uint64)
            ap, geo = 1, 0
            for j in range(n):
                geo = (geo * self.A + 1) % self.M  # a^j + .. + 1 after j+1 steps
                ap = (ap * self.A) % self.M
                a_pow[j] = ap
                c_geo[j] = geo
            self._jump_n, self._a_pow, self._c_geo = n, a_pow, c_geo
        s0 = np.uint64(self.state)
        states = (self._a_pow * s0 + np.uint64(self.C) * self._c_geo) & np.uint64(0xFFFFFFFF)
        self.state = np.uint32(states[-1])
        return states.astype(np.float64) / float(0xFFFFFFFF) * 2.0 - 1.0  # f64


def denoise_array(
    audio: np.ndarray,
    model: Optional[RNNoiseModel] = None,
    drop_first_frame: bool = False,
    block_frames: int = 500,
    params=None,
    device=None,
) -> np.ndarray:
    """Denoise [T] or [S, T] float32 audio in [-1, 1].

    With ``drop_first_frame`` the warm-up frame is replaced by silence, the
    way the reference's streaming path never emits it.
    """
    out = pipeline.denoise_batch(audio, model=model, block_frames=block_frames,
                                 params=params, device=device)
    out = np.clip(out, -1.0, 1.0)
    if drop_first_frame:
        out[..., :FRAME] = 0.0
    return out


def denoise_file(
    in_path,
    out_path,
    model: Optional[RNNoiseModel] = None,
    block_frames: int = 500,
    device=None,
) -> dict:
    """WAV → denoised WAV (every channel processed as one batched stream).

    16-bit 48 kHz sources take the int16-wire path: PCM crosses to and from
    the device as int16 with bit-identical output — the decode scale is an
    exact power-of-two divide and the device quantization matches
    write_wav's. Other rates are first resampled to 48 kHz on the host.
    """
    fmt = wavio.read_format(in_path)
    audio, sr = wavio.read_wav(in_path)  # [frames, channels]
    if sr == 48000 and fmt is not None and fmt.bits_per_sample == 16:
        pcm = (audio.T * 32768.0).astype(np.int16)  # exact round-trip
        out16 = pipeline.denoise_batch(pcm, model=model, block_frames=block_frames,
                                       wire="i16", device=device)
        wavio.write_wav(out_path, out16.T, 48000)
        return {"channels": int(pcm.shape[0]), "samples": int(pcm.shape[1]),
                "sample_rate": 48000}
    if sr != 48000:
        from ..dsp.resample import resample_poly

        audio = np.stack([resample_poly(audio[:, c], sr, 48000)
                          for c in range(audio.shape[1])], axis=1)
    streams = audio.T.astype(np.float32)  # [channels, T]
    out = denoise_array(streams, model=model, block_frames=block_frames, device=device)
    wavio.write_wav(out_path, out.T, 48000)
    return {"channels": int(streams.shape[0]), "samples": int(streams.shape[1]),
            "sample_rate": 48000}
