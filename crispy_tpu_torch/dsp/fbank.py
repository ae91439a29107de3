"""Kaldi-style log-mel filterbank features (the knf-rs analog), in PyTorch.

The port of ``crispy_tpu/dsp/fbank.py``. The reference computes these with
kaldi-native-fbank (managers/diarization.rs:53-74 via knf-rs): 25 ms frames
every 10 ms, snip-edges framing, per-frame DC removal, 0.97 pre-emphasis
inside the frame, Povey window, kaldi mel scale (1127 ln(1 + f/700)) with
80 unnormalized triangular bins from 20 Hz to Nyquist, natural-log energies
floored at epsilon. SenseVoice reads them; CAM++ will.

Batched, on the device the audio lies on: [B, T] 16 kHz → [B, frames, n_mels].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SAMPLE_RATE = 16000
FRAME_LENGTH = 400  # 25 ms
FRAME_SHIFT = 160  # 10 ms
PREEMPH = 0.97
N_FFT = 512  # kaldi rounds 400 up to the next power of two


def povey_window(n: int = FRAME_LENGTH) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * i / (n - 1))
    return (hann ** 0.85).astype(np.float32)


def kaldi_mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def kaldi_mel_inv(m):
    return 700.0 * (np.exp(np.asarray(m, np.float64) / 1127.0) - 1.0)


def mel_banks(n_mels: int = 80, n_fft: int = N_FFT, sr: int = SAMPLE_RATE,
              low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """[n_mels, n_fft//2+1] kaldi triangular banks (unnormalized)."""
    if high_freq <= 0.0:
        high_freq = sr / 2.0 + high_freq
    mel_lo, mel_hi = kaldi_mel(low_freq), kaldi_mel(high_freq)
    centers = np.linspace(mel_lo, mel_hi, n_mels + 2)
    bins = np.arange(n_fft // 2 + 1) * sr / n_fft
    mbins = kaldi_mel(bins)
    fb = np.zeros((n_mels, n_fft // 2 + 1), np.float64)
    for m in range(n_mels):
        left, center, right = centers[m], centers[m + 1], centers[m + 2]
        up = (mbins - left) / (center - left)
        down = (right - mbins) / (right - center)
        fb[m] = np.clip(np.minimum(up, down), 0.0, None)
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _tables(n_mels: int, device: torch.device):
    """The Povey window [400] and the banks [257, n_mels] on device."""
    return (torch.from_numpy(povey_window()).to(device),
            torch.from_numpy(mel_banks(n_mels).T.copy()).to(device))


def fbank(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """[T] or [B, T] 16 kHz in [-1, 1] → [.., frames, n_mels] log-mel.

    Kaldi convention: waveform scaled to int16 range, snip-edges framing
    (frames fully inside the signal), per-frame DC removal, pre-emphasis
    after DC removal, Povey window, power spectrum, natural log with floor.
    """
    squeeze = audio.dim() == 1
    x = torch.atleast_2d(audio).float() * 32768.0
    B, T = x.shape
    n_frames = max(0, 1 + (T - FRAME_LENGTH) // FRAME_SHIFT)
    if n_frames == 0:
        out = x.new_zeros((B, 0, n_mels))
        return out[0] if squeeze else out
    frames = x.unfold(-1, FRAME_LENGTH, FRAME_SHIFT)  # [B, F, 400]
    frames = frames - frames.mean(dim=-1, keepdim=True)  # remove_dc_offset
    # pre-emphasis within the frame (kaldi: x[0] -= p*x[0])
    pre = frames - PREEMPH * torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    window, banks = _tables(n_mels, x.device)
    spec = torch.fft.rfft(pre * window, n=N_FFT, dim=-1)
    mel = torch.matmul(spec.real ** 2 + spec.imag ** 2, banks)
    out = torch.log(mel.clamp(min=1.1920929e-07))  # kaldi epsilon floor
    return out[0] if squeeze else out
