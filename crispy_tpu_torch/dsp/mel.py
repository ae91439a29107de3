"""Whisper-style log-mel spectrogram frontend, in PyTorch.

The port of ``crispy_tpu/dsp/mel.py``: n_fft=400, hop=160, periodic Hann
window, 80 (or 128) slaney-scale mel bins, log10 clamped at 1e-10, a
dynamic range of 8 below each item's max, then (x+4)/4. The filterbank is
a numpy copy of the JAX package's; the spectrum is ``torch.fft.rfft`` of
the windowed frames, the JAX package's own branch off the TPU.

30 s of 16 kHz audio → [80, 3000] features (the reflected signal yields
T//HOP + 1 frames; the last is dropped, as the reference frontends do).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
CHUNK_SECONDS = 30
CHUNK_SAMPLES = CHUNK_SECONDS * SAMPLE_RATE  # 480000
N_FRAMES = CHUNK_SAMPLES // HOP  # 3000


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa htk=False), used by Whisper's filterbank."""
    f = np.asarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):
        log_branch = min_log_mel + np.log(np.maximum(f, 1e-30) / min_log_hz) / logstep
    return np.where(f >= min_log_hz, log_branch, mel)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(n_mels: int = 80, sr: int = SAMPLE_RATE, n_fft: int = N_FFT) -> np.ndarray:
    """[n_mels, n_fft//2+1] slaney-normalized triangular filterbank."""
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sr / 2, n_bins)
    mel_pts = np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    fb *= enorm[:, None]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _tables(n_mels: int, device: torch.device):
    """The periodic Hann window [400] and the filterbank [201, n_mels] on device."""
    window = np.hanning(N_FFT + 1)[:-1].astype(np.float32)
    return (torch.from_numpy(window).to(device),
            torch.from_numpy(mel_filterbank(n_mels).T.copy()).to(device))


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80,
                        pad_to_chunk: bool = False) -> torch.Tensor:
    """[T] or [B, T] 16 kHz audio in [-1, 1] → [.., n_mels, T//HOP] features,
    computed on the device the audio lies on.

    Matches the public Whisper frontend: reflect-pad N_FFT//2 both sides,
    Hann STFT, magnitude^2, mel projection, log10 clamped at 1e-10, dynamic
    range limited to 8 below the max, then (x + 4) / 4.
    """
    squeeze = audio.dim() == 1
    x = torch.atleast_2d(audio).float()
    if pad_to_chunk:
        pad = CHUNK_SAMPLES - x.shape[-1]
        x = F.pad(x, (0, pad)) if pad > 0 else x[:, :CHUNK_SAMPLES]
    T = x.shape[-1]
    xp = F.pad(x[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = xp.unfold(-1, N_FFT, HOP)[:, : T // HOP]  # [B, n_frames, 400]
    window, fb = _tables(n_mels, x.device)
    mag = torch.fft.rfft(frames * window, n=N_FFT, dim=-1).abs() ** 2
    log_spec = torch.log10(torch.clamp(torch.matmul(mag, fb), min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    out = ((log_spec + 4.0) / 4.0).transpose(1, 2)  # [B, n_mels, n_frames]
    return out[0] if squeeze else out
