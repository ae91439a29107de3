"""The one-upload diarization frontend: both stand-in nets on one device copy
of the recording.

The port of ``crispy_tpu/engine/diar_device.py``. The recording is
quantized to int16 once, on the device (it is uploaded as f32 first unless
it already lies there, as ``run_transcription``'s 16 kHz audio does), and
both stages read that one device array:

  1. the energy-VAD margin of every frame of every 10 s window (fetch: one
     [W, 589] row per window);
  2. a single log-mel over the whole recording, with per-chunk statistics
     as segmented reductions over the frame axis (fetch: [n_chunks, 160]).

Decode, merge and chunk semantics stay in ``engine/diarization.py``.

Numerical note against the per-chunk host stand-in: frames here lie on the
recording's global 160-sample grid (chunk boundaries fall mid-frame) and
reflect padding exists only at the recording's ends, so per-chunk
statistics differ from the host path by O(boundary frames / chunk frames),
about 1%.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..dsp import mel as meldsp
from .diarization import FRAME_START, FRAME_STEP, N_SEG_FRAMES, SAMPLE_RATE, WINDOW_SAMPLES

HOP = meldsp.HOP  # 160
N_FFT = meldsp.N_FFT  # 400
_MINUTE = 60 * SAMPLE_RATE


def pad_length(n: int) -> int:
    """Window multiple plus one all-zero window (the reference's
    trailing-speech terminator), in whole minutes (the JAX package's
    buckets; 60 s is a multiple of the window and of HOP)."""
    need = -(-n // WINDOW_SAMPLES) * WINDOW_SAMPLES + WINDOW_SAMPLES
    return -(-need // _MINUTE) * _MINUTE


def quantize_i16(audio: torch.Tensor, pad_to: int) -> torch.Tensor:
    """float [-1, 1] → int16 ×32768, rounded half to even (``np.rint``, as
    the JAX package rounds on the host), zero-padded to pad_to, on the
    device the audio lies on."""
    q = torch.zeros(pad_to, dtype=torch.int16, device=audio.device)
    q[:audio.shape[0]] = torch.clamp(torch.round(audio.float() * 32768.0),
                                     -32768, 32767).to(torch.int16)
    return q


def segmentation_margins(dev_audio: torch.Tensor, pad_to: int) -> np.ndarray:
    """[pad_to] int16 on the device → [W, 589] energy-VAD margins (the
    class-1 logit; logits = [−m, m]) of ``diarization.energy_vad_logits``:
    540-sample frame energies, −40 dBFS gate."""
    W = pad_to // WINDOW_SAMPLES
    start = FRAME_START - FRAME_STEP  # the first block; no frame is clipped
    n_blocks = N_SEG_FRAMES + 1
    w = dev_audio.float().mul_(1.0 / 32768.0).reshape(W, WINDOW_SAMPLES)
    sq = w[:, start:start + n_blocks * FRAME_STEP].square()
    blocks = sq.reshape(W, n_blocks, FRAME_STEP).sum(2)
    sums = blocks[:, :-1] + blocks[:, 1:]
    rms = torch.sqrt(sums / (2 * FRAME_STEP) + 1e-12)
    return (8.0 * (torch.log10(rms + 1e-12) + 3.0)).cpu().numpy()


def frame_chunk_ids(pad_to: int, ranges: List[Tuple[int, int]]) -> np.ndarray:
    """[pad_to // HOP] chunk index of each global frame; len(ranges) for a
    frame in no chunk. A chunk claims floor(len/HOP) frames starting at
    round(start/HOP); a later chunk wins a shared boundary frame."""
    ids = np.full(pad_to // HOP, len(ranges), np.int64)
    for i, (a, b) in enumerate(ranges):
        g0 = int(round(a / HOP))
        ids[g0: g0 + max(1, (b - a) // HOP)] = i
    return ids


def chunk_stats(dev_audio: torch.Tensor, pad_to: int,
                ranges: List[Tuple[int, int]]) -> np.ndarray:
    """Per-chunk log-mel mean/std statistics [n_chunks, 160] from the same
    device audio. ranges: [(sample_start, sample_end)] per chunk,
    non-overlapping, ascending. Per chunk as ``melstats_embedding``: log10
    floor 1e-10, the (chunk max − 8) clamp, (x + 4)/4, per-bin mean and
    std (two-pass, unlike the JAX package's E[v²] − E[v]²), then centred
    across the 160 values."""
    dev = dev_audio.device
    F_total = pad_to // HOP
    ns = len(ranges) + 1  # the last slot collects frames in no chunk
    ids = torch.from_numpy(frame_chunk_ids(pad_to, ranges)).to(dev)
    x = dev_audio.float().mul_(1.0 / 32768.0)
    xp = F.pad(x[None, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[0, 0]
    frames = xp.unfold(0, N_FFT, HOP)[:F_total]  # [F, 400]
    window, fb = meldsp._tables(80, dev)
    mag = torch.fft.rfft(frames * window, n=N_FFT, dim=-1).abs() ** 2
    lg = torch.log10(torch.clamp(torch.matmul(mag, fb), min=1e-10))  # [F, 80]
    del frames, mag

    row_max = lg.amax(1)
    cmax = torch.full((ns,), -torch.inf, device=dev).scatter_reduce_(
        0, ids, row_max, "amax", include_self=False)
    v = (torch.maximum(lg, (cmax[ids] - 8.0)[:, None]) + 4.0) / 4.0
    cnt = torch.zeros(ns, device=dev).index_add_(
        0, ids, torch.ones(F_total, device=dev)).clamp_(min=1.0)[:, None]
    mean = torch.zeros((ns, 80), device=dev).index_add_(0, ids, v) / cnt
    # two passes: E[v²] − E[v]² in f32 leaves ~1e-7 of rounding in the
    # variance of a bin that is constant over its chunk (clamped at the
    # chunk's max − 8), and its square root, ~3e-4, then depends on the
    # order of the sums (atomics on the card)
    var = torch.zeros((ns, 80), device=dev).index_add_(0, ids, (v - mean[ids]) ** 2) / cnt
    stats = torch.cat([mean, torch.sqrt(var)], dim=1)[:-1]
    return (stats - stats.mean(1, keepdim=True)).cpu().numpy()
