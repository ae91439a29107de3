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
from ..parallel import gather
from .diarization import FRAME_START, FRAME_STEP, N_SEG_FRAMES, SAMPLE_RATE, WINDOW_SAMPLES

HOP = meldsp.HOP  # 160
N_FFT = meldsp.N_FFT  # 400
_MINUTE = 60 * SAMPLE_RATE
LOGMEL_BLOCK = 1 << 16  # frames a log-mel product in chunk_stats (~11 min of audio)


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


def segmentation_margins(dev_audio: torch.Tensor, pad_to: int, mesh=None) -> np.ndarray:
    """[pad_to] int16 on the device → [W, 589] energy-VAD margins (the
    class-1 logit; logits = [−m, m]) of ``diarization.energy_vad_logits``:
    540-sample frame energies, −40 dBFS gate. With a ``parallel.Mesh`` the
    windows split over its data rows, each row scanning its own stretch of
    the recording."""
    W = pad_to // WINDOW_SAMPLES
    w = dev_audio.reshape(W, WINDOW_SAMPLES)
    if mesh is None:
        return _margins(w).cpu().numpy()
    parts = [_margins(p.to(d)) for p, d in zip(w.tensor_split(mesh.dp), mesh.data_devices())]
    return torch.cat([p.cpu() for p in parts]).numpy()


def _margins(w16: torch.Tensor) -> torch.Tensor:
    """[W, 160000] int16 windows → [W, 589] margins, on their device."""
    W = w16.shape[0]
    start = FRAME_START - FRAME_STEP  # the first block; no frame is clipped
    n_blocks = N_SEG_FRAMES + 1
    w = w16.float().mul_(1.0 / 32768.0)
    sq = w[:, start:start + n_blocks * FRAME_STEP].square()
    blocks = sq.reshape(W, n_blocks, FRAME_STEP).sum(2)
    sums = blocks[:, :-1] + blocks[:, 1:]
    rms = torch.sqrt(sums / (2 * FRAME_STEP) + 1e-12)
    return 8.0 * (torch.log10(rms + 1e-12) + 3.0)


def frame_chunk_ids(pad_to: int, ranges: List[Tuple[int, int]]) -> np.ndarray:
    """[pad_to // HOP] chunk index of each global frame; len(ranges) for a
    frame in no chunk. A chunk claims floor(len/HOP) frames starting at
    round(start/HOP); a later chunk wins a shared boundary frame."""
    ids = np.full(pad_to // HOP, len(ranges), np.int64)
    for i, (a, b) in enumerate(ranges):
        g0 = int(round(a / HOP))
        ids[g0: g0 + max(1, (b - a) // HOP)] = i
    return ids


def _log_mel(frames: torch.Tensor) -> torch.Tensor:
    """[F, 400] frames → [F, 80] log10 mel energies (floor 1e-10)."""
    window, fb = meldsp._tables(80, frames.device)
    mag = torch.fft.rfft(frames * window, n=N_FFT, dim=-1).abs() ** 2
    return torch.log10(torch.clamp(torch.matmul(mag, fb), min=1e-10))


def chunk_stats(dev_audio: torch.Tensor, pad_to: int,
                ranges: List[Tuple[int, int]], mesh=None) -> np.ndarray:
    """Per-chunk log-mel mean/std statistics [n_chunks, 160] from the same
    device audio. ranges: [(sample_start, sample_end)] per chunk,
    non-overlapping, ascending. Per chunk as ``melstats_embedding``: log10
    floor 1e-10, the (chunk max − 8) clamp, (x + 4)/4, per-bin mean and
    std (two-pass, unlike the JAX package's E[v²] − E[v]²), then centred
    across the 160 values. With a ``parallel.Mesh`` the frames' log-mel
    (the stage's cost) splits over its data rows in whole blocks; the
    per-chunk reductions run on the audio's device over the gathered
    [F, 80] rows."""
    dev = dev_audio.device
    F_total = pad_to // HOP
    ns = len(ranges) + 1  # the last slot collects frames in no chunk
    ids_np = frame_chunk_ids(pad_to, ranges)
    ids = torch.from_numpy(ids_np).to(dev)
    x = dev_audio.float().mul_(1.0 / 32768.0)
    xp = F.pad(x[None, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[0, 0]
    frames = xp.unfold(0, N_FFT, HOP)[:F_total]  # [F, 400]
    # the log-mel in blocks of LOGMEL_BLOCK frames, whole blocks to each
    # data row: every block is the same product with or without a mesh,
    # so the statistics are too
    blocks = frames.split(LOGMEL_BLOCK)
    if mesh is None:
        lg = torch.cat([_log_mel(b) for b in blocks])  # [F, 80]
    else:
        rows = np.array_split(np.arange(len(blocks)), mesh.dp)
        lg = gather([_log_mel(blocks[i].to(d)) for r, d in zip(rows, mesh.data_devices())
                     for i in r], dev)
    del frames, blocks

    row_max = lg.amax(1)
    cmax = torch.full((ns,), -torch.inf, device=dev).scatter_reduce_(
        0, ids, row_max, "amax", include_self=False)
    v = (torch.maximum(lg, (cmax[ids] - 8.0)[:, None]) + 4.0) / 4.0
    # each chunk's sums in one fixed order (segment_reduce over the frames
    # sorted by chunk, not atomics), so the statistics are the same in
    # every run and with or without a mesh
    order = torch.from_numpy(np.argsort(ids_np, kind="stable")).to(dev)
    lengths = torch.from_numpy(np.bincount(ids_np, minlength=ns)).to(dev)
    cnt = lengths.clamp(min=1).float()[:, None]

    def seg_sum(x: torch.Tensor) -> torch.Tensor:
        return torch.segment_reduce(x[order], "sum", lengths=lengths, axis=0)

    mean = seg_sum(v) / cnt
    # two passes: E[v²] − E[v]² in f32 leaves ~1e-7 of rounding in the
    # variance of a bin that is constant over its chunk (clamped at the
    # chunk's max − 8), and its square root, ~3e-4, then depends on the
    # order of the sums
    var = seg_sum((v - mean[ids]) ** 2) / cnt
    stats = torch.cat([mean, torch.sqrt(var)], dim=1)[:-1]
    return (stats - stats.mean(1, keepdim=True)).cpu().numpy()
