"""ASR feature frontends of the native engine families, in PyTorch.

The port of ``crispy_tpu/dsp/asr_frontend.py``; the reference's
transcribe-rs engines compute these before their model call
(managers/transcription.rs:119-172). Public definitions:

  * NeMo AudioToMelSpectrogramPreprocessor (parakeet, canary): preemphasis
    0.97, 512-point STFT (400 Hann window, hop 160, center/reflect), power
    spectrum, 80 slaney mel bins, log(x + 2^-24), per-feature mean/std
    normalization over the valid frames.
  * GigaAM featurizer: torchaudio MelSpectrogram(n_fft=400, hop=160, 64 HTK
    mel bins, no norm), log(clamp(1e-9)).
  * FunASR low-frame-rate stacking (SenseVoice).

The spectrum is ``torch.fft.rfft`` of the windowed frames (the JAX package
multiplies the frames by DFT tables of the same window); the CPU tests hold
the features within 1e-5 of the JAX package's largest magnitude. Everything
runs on the device the audio lies on.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .mel import mel_filterbank  # slaney-normalized (librosa htk=False)

SAMPLE_RATE = 16000
HOP = 160
# a frame is valid when some bin is above log(2^-24) + 1e-3, summed in f32
_VALID_ABOVE = float(np.float32(np.log(2.0 ** -24)) + np.float32(1e-3))


def _htk_mel_filterbank(n_mels: int, sr: int, n_fft: int) -> np.ndarray:
    """[n_mels, n_fft//2+1] HTK-scale triangles, no area normalization
    (torchaudio MelScale defaults: mel_scale='htk', norm=None)."""
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sr / 2, n_bins)

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2), n_mels + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    return np.maximum(0.0, np.minimum(lower, upper)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _window(n_fft: int, win_length: int, device: torch.device) -> torch.Tensor:
    """The periodic Hann window of win_length, zero-padded symmetrically to
    n_fft (as torch.stft pads it), on device."""
    win = np.zeros(n_fft, np.float64)
    off = (n_fft - win_length) // 2
    win[off: off + win_length] = np.hanning(win_length + 1)[:-1]
    return torch.from_numpy(win.astype(np.float32)).to(device)


@functools.lru_cache(maxsize=8)
def _filterbank(kind: str, n_mels: int, device: torch.device) -> torch.Tensor:
    """[n_fft//2+1, n_mels]: slaney over 512 points (nemo) or HTK over 400
    (gigaam), on device."""
    fb = (mel_filterbank(n_mels, SAMPLE_RATE, 512) if kind == "nemo"
          else _htk_mel_filterbank(n_mels, SAMPLE_RATE, 400))
    return torch.from_numpy(fb.T.copy()).to(device)


def _power_stft(x: torch.Tensor, n_fft: int, win_length: int) -> torch.Tensor:
    """[B, T] → [B, T//HOP + 1, n_fft//2+1] power spectrum, center=True/reflect."""
    xp = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = xp.unfold(-1, n_fft, HOP)  # [B, T//HOP + 1, n_fft]
    spec = torch.fft.rfft(frames * _window(n_fft, win_length, x.device), dim=-1)
    return spec.real ** 2 + spec.imag ** 2


def nemo_raw_log_mel(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """[B, T] 16 kHz → [B, T//160 + 1, n_mels] log mel energies before the
    normalization."""
    x = torch.atleast_2d(audio).float()
    x = torch.cat([x[:, :1], x[:, 1:] - 0.97 * x[:, :-1]], dim=1)
    mel = torch.matmul(_power_stft(x, 512, 400), _filterbank("nemo", n_mels, x.device))
    return torch.log(mel + 2.0 ** -24)


def valid_frames(logmel: torch.Tensor) -> torch.Tensor:
    """[B, F, M] → [B, F, 1] bool: the frames that count in the statistics.

    NeMo normalizes over seq_len: zero-padded tail frames sit at the
    log(2^-24) floor in every bin and would drag the statistics toward
    silence, so a frame counts when some bin is above floor + 1e-3. A row
    with no such frame (digital silence) counts all of its frames: against
    mu=0/var=0 every bin would blow up to ~-1.7e6."""
    valid = (logmel > _VALID_ABOVE).any(dim=-1, keepdim=True)
    return valid | ~valid.any(dim=1, keepdim=True)


def nemo_log_mel(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """[B, T] 16 kHz → [B, n_mels, T//160 + 1] normalized NeMo features."""
    logmel = nemo_raw_log_mel(audio, n_mels)
    valid = valid_frames(logmel)
    nv = valid.sum(dim=1, keepdim=True).clamp(min=1)
    mu = torch.where(valid, logmel, 0.0).sum(dim=1, keepdim=True) / nv
    # torch.std's default, as NeMo takes it: unbiased (N-1)
    var = torch.where(valid, (logmel - mu) ** 2, 0.0).sum(dim=1, keepdim=True) \
        / (nv - 1).clamp(min=1)
    out = (logmel - mu) / (torch.sqrt(var) + 1e-5)
    return out.transpose(1, 2)


def gigaam_log_mel(audio: torch.Tensor, n_mels: int = 64) -> torch.Tensor:
    """[B, T] 16 kHz → [B, n_mels, T//160 + 1] GigaAM features."""
    x = torch.atleast_2d(audio).float()
    mel = torch.matmul(_power_stft(x, 400, 400), _filterbank("gigaam", n_mels, x.device))
    return torch.log(mel.clamp(1e-9, 1e9)).transpose(1, 2)


def lfr(feats: torch.Tensor, m: int = 7, n: int = 6) -> torch.Tensor:
    """Low-frame-rate stacking (FunASR WavFrontend, SenseVoice): stack m
    frames every n, left-padded with (m-1)//2 copies of the first frame.
    [B, T, F] → [B, ceil(T/n), m*F]."""
    B, T, Fd = feats.shape
    lpad = (m - 1) // 2
    n_out = -(-T // n)  # ceil
    need = (n_out - 1) * n + m
    tail = max(0, need - (T + lpad))
    x = torch.cat([feats[:, :1].expand(B, lpad, Fd), feats,
                   feats[:, -1:].expand(B, tail, Fd)], dim=1)
    return x.unfold(1, m, n)[:, :n_out].transpose(2, 3).reshape(B, n_out, m * Fd)
