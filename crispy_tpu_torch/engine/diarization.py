"""Speaker diarization: powerset VAD segmentation → embeddings → NME-SC.

The port of ``crispy_tpu/engine/diarization.py``, a rebuild of the
reference pipeline (src-tauri/src/managers/diarization.rs):
  * Powerset VAD (diarization.rs:77-272): 10 s windows on the frame grid
    start=721/step=270, softmax index 0 = silence (p>0.5), 11-tap median
    filter, cross-window speech-run tracking with a 100 ms start snap,
    merge gaps ≤ merge_gap, drop segments <1.5 s with a keep-longest
    fallback. All windows run through the segmentation net as one batch.
  * ≤4 s chunking of long segments (diarization.rs:314-338).
  * NME-SC clustering (diarization.rs:422-611, Park et al. 2019), on the
    device (``nme_device``); ``nme_sc_host`` is the NumPy oracle.
  * Chronological speaker ids, consecutive-merge, word-midpoint speaker
    lookup, `[Speaker N|start]` formatting (diarization.rs:612-724).

The decode, merge and chunk helpers are the JAX package's host NumPy. The
nets are pluggable callables: the built-in stand-ins are an energy VAD and
log-mel statistics embeddings; ``models/segmentation`` (PyanNet) and
``models/campplus`` (CAM++) are the real architectures, and
``models/onnx_nets`` runs a downloaded net's .onnx graph through the ONNX
executor. From two minutes of audio on, ``diarize`` uploads the recording
once as int16 and forms the windows and chunks on the device
(``diar_device``, or the nets' ``from_device``). A failure on the device raises: nothing is redone on
the host.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

SAMPLE_RATE = 16000
WINDOW_SAMPLES = SAMPLE_RATE * 10  # diarization.rs:103
FRAME_START = 721  # :101-102
FRAME_STEP = 270
MIN_SEGMENT_SECONDS = 1.5  # :227
MAX_CHUNK_SECONDS = 4.0  # :315
N_SEG_FRAMES = 589  # pyannote segmentation-3.0 frames per 10 s window


@dataclass
class SpeakerSegment:
    start: float
    end: float
    speaker: str


@dataclass
class VadSegment:
    start: float
    end: float
    samples: np.ndarray  # or a view of the device recording (one-upload routes)
    offset: int = -1  # sample offset into the source audio (-1 = unknown)


# ---------------------------------------------------------------------------
# Pure helpers (reference: diarization.rs:612-724)
# ---------------------------------------------------------------------------

def cosine_distance(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    na, nb = float(a @ a), float(b @ b)
    if na == 0.0 or nb == 0.0:
        return 1.0
    return max(0.0, 1.0 - float(a @ b) / (np.sqrt(na) * np.sqrt(nb)))


def cosine_similarity(a, b) -> float:
    return float(np.clip(1.0 - cosine_distance(a, b), 0.0, 1.0))


def f32_to_i16(samples: np.ndarray) -> np.ndarray:
    return np.trunc(np.clip(samples, -1.0, 1.0) * 32767.0).astype(np.int16)


def merge_consecutive_segments(
    segments: Sequence[SpeakerSegment], merge_gap: float
) -> List[SpeakerSegment]:
    merged: List[SpeakerSegment] = []
    for seg in segments:
        if merged:
            last = merged[-1]
            gap = max(0.0, seg.start - last.end)
            if last.speaker == seg.speaker and gap <= merge_gap:
                last.end = max(last.end, seg.end)
                continue
        merged.append(SpeakerSegment(seg.start, seg.end, seg.speaker))
    return merged


def find_speaker_at_time(time: float, segments: Sequence[SpeakerSegment]) -> str:
    for seg in segments:
        if seg.start <= time <= seg.end:
            return seg.speaker
    closest, min_dist = "Speaker ?", float("inf")
    for seg in segments:
        dist = seg.start - time if time < seg.start else time - seg.end
        if dist < min_dist:
            min_dist, closest = dist, seg.speaker
    return closest


def format_diarized_text(
    text_segments: Sequence[Tuple[float, float, str]],
    speaker_segments: Sequence[SpeakerSegment],
) -> str:
    if not speaker_segments or not text_segments:
        return " ".join(t for _, _, t in text_segments)
    lines: List[str] = []
    cur_speaker: Optional[str] = None
    cur_words: List[str] = []
    for start, end, text in text_segments:
        t = text.strip()
        if not t:
            continue
        speaker = find_speaker_at_time((start + end) / 2.0, speaker_segments)
        if cur_speaker != speaker:
            if cur_words:
                lines.append(" ".join(cur_words))
                cur_words = []
            cur_speaker = speaker
            lines.append(f"\n[{speaker}|{start:.1f}]")
        cur_words.append(t)
    if cur_words:
        lines.append(" ".join(cur_words))
    return "\n".join(lines).strip()


# ---------------------------------------------------------------------------
# NME-SC (diarization.rs:422-611)
# ---------------------------------------------------------------------------

def pruned_normalized_laplacian(aff: np.ndarray, p: int) -> np.ndarray:
    n = aff.shape[0]
    a = np.zeros_like(aff)
    keep = min(p, n - 1)
    for i in range(n):
        # stable descending sort: equal affinities keep ascending index order
        # (the reference's Rust sort_by is stable; matters for tied values)
        order = np.argsort(-aff[i], kind="stable")
        order = order[order != i][:keep]
        a[i, order] = aff[i, order]
    a = np.maximum(a, a.T)  # symmetrize by max
    dinv = 1.0 / np.sqrt(np.maximum(a.sum(axis=1), 1e-9))
    norm_a = dinv[:, None] * a * dinv[None, :]
    lap = -norm_a
    np.fill_diagonal(lap, 1.0 - np.diag(norm_a))
    return lap


def max_eigengap(evals_sorted_asc: np.ndarray, kmax: int) -> Tuple[int, float]:
    lim = min(kmax + 1, len(evals_sorted_asc))
    best_k, best_gap = 1, -np.inf
    for i in range(1, lim):
        gap = evals_sorted_asc[i] - evals_sorted_asc[i - 1]
        if gap > best_gap:
            best_gap, best_k = gap, i
    return max(best_k, 1), max(float(best_gap), 0.0)


def kmeans(points: np.ndarray, k: int) -> np.ndarray:
    """Deterministic farthest-point-seeded k-means, 50 iterations."""
    n = points.shape[0]
    if k <= 1 or n == 0:
        return np.zeros(n, np.int64)
    if k >= n:
        return np.arange(n, dtype=np.int64)
    centers = [points[0]]
    while len(centers) < k:
        d = np.min(
            [np.sum((points - c) ** 2, axis=1) for c in centers], axis=0
        )
        centers.append(points[int(np.argmax(d))])
    centers = np.stack(centers)
    labels = np.zeros(n, np.int64)
    for _ in range(50):
        d = np.sum((points[:, None, :] - centers[None]) ** 2, axis=-1)
        new = np.argmin(d, axis=1)
        changed = np.any(new != labels)
        labels = new
        for c in range(k):
            m = labels == c
            if m.any():
                centers[c] = points[m].mean(axis=0)
        if not changed:
            break
    return labels


def _connected(lap: np.ndarray) -> bool:
    """Connectivity of the graph underlying a Laplacian (BFS on nonzeros)."""
    n = lap.shape[0]
    adj = lap != 0.0
    np.fill_diagonal(adj, False)
    seen = np.zeros(n, bool)
    stack = [0]
    seen[0] = True
    while stack:
        i = stack.pop()
        for j in np.nonzero(adj[i] & ~seen)[0]:
            seen[j] = True
            stack.append(int(j))
    return bool(seen.all())


def nme_sc(embeddings: np.ndarray, max_speakers: int, device=None) -> np.ndarray:
    """Spectral clustering with automatic speaker count (NME criterion), on
    ``device`` (default: the card; ``nme_device.nme_sc_device``).
    ``CRISPY_NME=host`` runs the NumPy oracle instead, by request only."""
    emb = np.asarray(embeddings, np.float32)
    if emb.shape[0] > 2 and os.environ.get("CRISPY_NME", "device") != "host":
        from . import nme_device

        return nme_device.nme_sc_device(emb, max_speakers, device=device)
    return nme_sc_host(emb, max_speakers)


def nme_sc_host(embeddings: np.ndarray, max_speakers: int) -> np.ndarray:
    """Host-numpy NME-SC (the device path's oracle)."""
    emb = np.asarray(embeddings, np.float32)
    n = emb.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    if n <= 2:
        return np.zeros(n, np.int64)
    kmax = max(1, min(max_speakers, n - 1))

    norms = np.linalg.norm(emb, axis=1, keepdims=True)
    normed = emb / np.maximum(norms, 1e-12)
    aff = np.clip(normed @ normed.T, 0.0, 1.0)
    aff[norms[:, 0] == 0, :] = 0.0
    aff[:, norms[:, 0] == 0] = 0.0
    np.fill_diagonal(aff, 0.0)

    p_max = min(n - 1, max(int(np.sqrt(n)), 2) * 2)
    best = None  # (ratio, p, k)
    best_connected = None
    for p in range(1, p_max + 1):
        lap = pruned_normalized_laplacian(aff, p)
        ev = np.sort(np.linalg.eigvalsh(lap))
        k, gap = max_eigengap(ev, kmax)
        ratio = (p / n) / max(gap, 1e-6)
        if best is None or ratio < best[0]:
            best = (ratio, p, k)
        # Robustness over the reference's raw sweep: at tiny p the pruned
        # graph fragments into arbitrary islands and the eigengap counts
        # fragments, not speakers. Prefer p where the graph is connected;
        # fall back to the raw criterion otherwise.
        if _connected(lap) and (best_connected is None or ratio < best_connected[0]):
            best_connected = (ratio, p, k)
    _, p_star, k = best_connected or best
    k = max(1, min(k, kmax))
    if k <= 1:
        return np.zeros(n, np.int64)

    lap = pruned_normalized_laplacian(aff, p_star)
    evals, evecs = np.linalg.eigh(lap)
    order = np.argsort(evals)
    spectral = evecs[:, order[:k]].astype(np.float32)
    rn = np.linalg.norm(spectral, axis=1, keepdims=True)
    spectral = np.where(rn > 1e-9, spectral / np.maximum(rn, 1e-9), spectral)
    labels = kmeans(spectral, k)

    # Separation validation (robustness beyond the reference): the raw
    # eigengap over-counts on near-uniform affinities (one speaker, tight
    # blob). If the found clusters aren't actually separated in affinity
    # space, collapse to one speaker.
    same = labels[:, None] == labels[None, :]
    triu = np.triu(np.ones((n, n), bool), 1)
    nw = int(np.count_nonzero(same & triu))
    nb = int(np.count_nonzero(~same & triu))
    within = float(aff[same & triu].sum())
    between = float(aff[~same & triu].sum())
    if nw and nb and (between / nb) > 0.9 * (within / nw):
        return np.zeros(n, np.int64)
    return labels


# ---------------------------------------------------------------------------
# Segmentation
# ---------------------------------------------------------------------------

def energy_vad_logits(windows: np.ndarray) -> np.ndarray:
    """Stand-in segmentation net: frame-energy VAD shaped like the pyannote
    powerset output [W, N_SEG_FRAMES, 2] (class 0 = silence logit).

    Frame energies come from non-overlapping FRAME_STEP-sample block sums:
    each frame integrates [center-STEP, center+STEP), frames stride by STEP,
    so frame_i = block_i + block_{i+1} exactly."""
    windows = np.asarray(windows, np.float32)
    W, T = windows.shape
    centers = FRAME_START + FRAME_STEP * np.arange(N_SEG_FRAMES)
    half = FRAME_STEP
    lo = np.clip(centers - half, 0, T)
    hi = np.clip(centers + half, 0, T)
    counts = np.maximum(hi - lo, 1)[None, :]

    start = max(FRAME_START - half, 0)  # first block edge
    n_blocks = N_SEG_FRAMES + 1
    need = start + n_blocks * FRAME_STEP
    blocks = np.empty((W, n_blocks), np.float64)
    for w0 in range(0, W, 64):  # bound temporaries to ~40 MB per slab
        slab = windows[w0:w0 + 64, :]
        sq = slab.astype(np.float64) ** 2
        if need > T:  # zero-pad ≡ the hi-clip (beyond-T contributes nothing)
            sq = np.pad(sq, ((0, 0), (0, need - T)))
        blocks[w0:w0 + 64] = sq[:, start:need].reshape(
            slab.shape[0], n_blocks, FRAME_STEP).sum(axis=2)
    sums = blocks[:, :-1] + blocks[:, 1:]  # [W, F]
    rms = np.sqrt(sums / counts + 1e-12)
    # logit margin ~ distance from a -40 dBFS gate
    margin = (8.0 * (np.log10(rms + 1e-12) + 3.0)).astype(np.float32)
    return np.stack([-margin, margin], axis=-1)


def segment_speech(
    audio: np.ndarray,
    merge_gap: float,
    segmentation_fn: Callable[[np.ndarray], np.ndarray] = energy_vad_logits,
) -> List[VadSegment]:
    """Powerset VAD with the reference's exact decode/smoothing/merging.

    audio: float32 mono 16 kHz in [-1, 1]. The net runs once over the whole
    [W, 160000] window batch.
    """
    n = audio.shape[0]
    if n == 0:
        return []
    # ceil to a window multiple PLUS one all-zero window — the reference
    # pads the same extra window ("to catch trailing speech",
    # managers/diarization.rs:106-112)
    pad_to = -(-n // WINDOW_SAMPLES) * WINDOW_SAMPLES + WINDOW_SAMPLES
    padded = np.zeros(pad_to, np.float32)
    padded[:n] = audio
    windows = padded.reshape(-1, WINDOW_SAMPLES)

    logits = np.asarray(segmentation_fn(windows))  # [W, F, C]
    merged = _runs_from_logits(logits, n, merge_gap)
    return _segments_from_runs(merged, audio)


def _runs_from_logits(
    logits: np.ndarray, n: int, merge_gap: float
) -> List[List[int]]:
    """Powerset logits [W, F, C] → merged speech runs [[s, t], ...] in
    samples (decode, median smoothing, run tracking, gap merging)."""
    # Powerset decode: p(silence) via softmax index 0 (diarization.rs:149-164).
    m = logits.max(axis=-1, keepdims=True)
    e = np.exp(logits - m)
    p_sil = e[..., 0] / e.sum(axis=-1)
    labels = (p_sil <= 0.5).astype(np.uint8)  # 1 = speech

    # 11-tap majority filter per window (:167-187), vectorized via cumsum.
    W, F = labels.shape
    idx = np.arange(F)
    lo = np.maximum(0, idx - 5)
    hi = np.minimum(F, idx + 6)
    cs = np.concatenate([np.zeros((W, 1), np.int32),
                         np.cumsum(labels.astype(np.int32), axis=1)], axis=1)
    smoothed = ((cs[:, hi] - cs[:, lo]) > (hi - lo)[None, :] // 2).astype(np.uint8)

    # Cross-window speech-run tracking (:189-211): transitions of the
    # flattened (window, frame) sequence against a prepended initial
    # silence state; starts and ends then alternate.
    flat = smoothed.reshape(-1)
    edges = np.flatnonzero(np.diff(np.concatenate([[np.uint8(0)], flat])))
    sidx = ((edges // F) * WINDOW_SAMPLES
            + FRAME_START + (edges % F) * FRAME_STEP).astype(np.int64)
    starts = sidx[0::2]
    ends = sidx[1::2]
    if starts.size > ends.size:  # trailing open run → terminate at n
        ends = np.concatenate([ends, [np.int64(n)]])
    starts = np.where(starts < 1600, 0, starts)  # 100 ms start snap
    starts = np.minimum(starts, n)
    ends = np.minimum(ends, n)
    keep = ends > starts
    raw: List[Tuple[int, int]] = [
        (int(s), int(t)) for s, t in zip(starts[keep], ends[keep])]

    # Merge gaps ≤ merge_gap (:216-240).
    raw.sort()
    merged: List[List[int]] = []
    gap_samples = int(SAMPLE_RATE * merge_gap)
    for s, t in raw:
        if merged and s <= merged[-1][1] + gap_samples:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def _segments_from_runs(
    merged: Sequence[Sequence[int]], audio: np.ndarray
) -> List[VadSegment]:
    """Merged sample runs → VadSegments: min-duration filter with the
    keep-longest fallback (diarization.rs:227,243-252)."""
    min_dur = int(SAMPLE_RATE * MIN_SEGMENT_SECONDS)
    out = [
        VadSegment(s / SAMPLE_RATE, t / SAMPLE_RATE, audio[s:t], offset=int(s))
        for s, t in merged if t - s >= min_dur
    ]
    if not out and merged:  # keep-longest fallback (:243-252)
        s, t = max(merged, key=lambda st: st[1] - st[0])
        out = [VadSegment(s / SAMPLE_RATE, t / SAMPLE_RATE, audio[s:t], offset=int(s))]
    return out


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def _melstats_device(batch: np.ndarray, device) -> torch.Tensor:
    """[b, T] audio → [b, 160] centred log-mel mean/std statistics on device.
    The audio crosses to the device as int16 (product audio is s16 WAV;
    re-quantizing float input loses < 3e-5) and only the statistics come
    back."""
    from ..dsp.mel import log_mel_spectrogram

    q = np.clip(np.round(batch * 32768.0), -32768, 32767).astype(np.int16)
    x = torch.from_numpy(q).to(device).float() / 32768.0
    mel = log_mel_spectrogram(x)  # [b, 80, F]
    v = torch.cat([mel.mean(2), mel.std(2, correction=0)], dim=1)
    # centre: the shared log-floor baseline otherwise dominates the cosine
    # similarity between segments
    return v - v.mean(1, keepdim=True)


def melstats_embedding(segments: List[np.ndarray], device=None) -> np.ndarray:
    """Stand-in speaker embedding: log-mel mean/std statistics per segment,
    on ``device`` (default: the card). The CAM++ net's call shape; enough
    to separate synthetic speakers by spectral envelope."""
    dev = resolve_device(device)
    # one batched call per distinct segment length
    buckets = {}
    for i, seg in enumerate(segments):
        buckets.setdefault(len(seg), []).append(i)
    out: List[Optional[np.ndarray]] = [None] * len(segments)
    for _n, idxs in buckets.items():
        batch = np.stack([np.asarray(segments[i], np.float32) for i in idxs])
        v = _melstats_device(batch, dev).cpu().numpy()  # [b, 160]
        for j, i in enumerate(idxs):
            out[i] = v[j]
    return np.stack(out).astype(np.float32)


def chunk_segments(segments: List[VadSegment]) -> List[VadSegment]:
    """Split long segments into ≤4 s chunks (diarization.rs:314-338)."""
    out: List[VadSegment] = []
    for seg in segments:
        dur = seg.end - seg.start
        if dur > MAX_CHUNK_SECONDS:
            n_chunks = int(np.ceil(dur / MAX_CHUNK_SECONDS))
            step = len(seg.samples) // n_chunks
            for i in range(n_chunks):
                s = i * step
                t = len(seg.samples) if i == n_chunks - 1 else (i + 1) * step
                out.append(VadSegment(
                    seg.start + s / SAMPLE_RATE, seg.start + t / SAMPLE_RATE,
                    seg.samples[s:t],
                    offset=seg.offset + s if seg.offset >= 0 else -1,
                ))
        else:
            out.append(seg)
    return out


# ---------------------------------------------------------------------------
# The one-upload routes (engine/diar_device.py, the nets' from_device)
# ---------------------------------------------------------------------------

FUSED_MIN_SAMPLES = SAMPLE_RATE * 120  # below this, the host VAD's latency wins


def _upload_i16(audio, dev: torch.device) -> Tuple[torch.Tensor, int]:
    """The recording as one padded int16 array on dev, quantized there
    (rounding 57.6 M samples on the host cost more than sending them as
    f32)."""
    from . import diar_device as dd

    pad_to = dd.pad_length(audio.shape[0])
    return dd.quantize_i16(torch.as_tensor(audio).to(dev), pad_to), pad_to


def _diarize_fused_frontend(
    audio, merge_gap: float, device=None
) -> Tuple[List[VadSegment], List[VadSegment], np.ndarray]:
    """The built-in stand-in nets on one device copy of the recording:
    energy-VAD margins and per-chunk mel statistics (``diar_device``).
    Decode/chunk semantics are the host helpers above."""
    from . import diar_device as dd

    dev = resolve_device(device)
    q, pad_to = _upload_i16(audio, dev)
    margin = dd.segmentation_margins(q, pad_to)  # [W, 589]
    logits = np.stack([-margin, margin], axis=-1)
    merged = _runs_from_logits(logits, audio.shape[0], merge_gap)
    segments = _segments_from_runs(merged, audio)
    if not segments:
        return [], [], np.zeros((0, 160), np.float32)
    chunks = chunk_segments(segments)
    ranges = [(c.offset, c.offset + len(c.samples)) for c in chunks]
    return segments, chunks, dd.chunk_stats(q, pad_to, ranges)


def _diarize_device_nets(
    audio, merge_gap: float, segmentation_fn: Callable, embedding_fn: Callable,
    device=None,
) -> Tuple[List[VadSegment], List[VadSegment], np.ndarray]:
    """Real nets that offer ``from_device`` (the native PyanNet and CAM++) on
    one device copy of the recording: int16, as the reference feeds them
    (diarization.rs:85-93); windows and chunks are formed on the device.
    Decode/merge/chunk semantics are the host helpers above."""
    dev = resolve_device(device)
    q, _pad_to = _upload_i16(audio, dev)
    logits = np.asarray(segmentation_fn.from_device(q))
    merged = _runs_from_logits(logits, audio.shape[0], merge_gap)
    segments = _segments_from_runs(merged, audio)
    if not segments:
        return [], [], np.zeros((0, 0), np.float32)
    chunks = chunk_segments(segments)
    ranges = [(c.offset, c.offset + len(c.samples)) for c in chunks]
    return segments, chunks, np.asarray(embedding_fn.from_device(q, ranges))


# ---------------------------------------------------------------------------
# Orchestration (diarization.rs:274-409)
# ---------------------------------------------------------------------------

def diarize(
    audio,
    sample_rate: int = SAMPLE_RATE,
    max_speakers: int = 4,
    merge_gap: float = 1.0,
    segmentation_fn: Callable = energy_vad_logits,
    embedding_fn: Callable = melstats_embedding,
    device=None,
) -> List[SpeakerSegment]:
    """float32 mono 16 kHz (an array, or a tensor on a device) →
    chronologically labeled speaker segments. The embeddings' clustering
    runs on ``device`` (default: the card); from FUSED_MIN_SAMPLES on, so
    do the frontends (``CRISPY_DIAR_FUSED=off`` keeps them on the host path
    by request)."""
    if sample_rate != SAMPLE_RATE:
        raise ValueError("diarization requires 16 kHz mono")
    dev = resolve_device(device)
    max_speakers = max(1, max_speakers)
    if not isinstance(audio, torch.Tensor):
        audio = np.asarray(audio, np.float32)

    fused = None
    device_ok = (audio.shape[0] >= FUSED_MIN_SAMPLES
                 and os.environ.get("CRISPY_DIAR_FUSED", "on") != "off")
    if (device_ok and segmentation_fn is energy_vad_logits
            and embedding_fn is melstats_embedding):
        fused = _diarize_fused_frontend(audio, merge_gap, dev)
    elif (device_ok and hasattr(segmentation_fn, "from_device")
          and hasattr(embedding_fn, "from_device")):
        fused = _diarize_device_nets(audio, merge_gap, segmentation_fn, embedding_fn, dev)
    if fused is not None:
        segments, chunks, embeddings = fused
        if not segments:
            return []
    else:
        if isinstance(audio, torch.Tensor):
            audio = audio.float().cpu().numpy()
        segments = segment_speech(audio, merge_gap, segmentation_fn)
        if not segments:
            return []
        chunks = chunk_segments(segments)
        if embedding_fn is melstats_embedding:
            embedding_fn = functools.partial(melstats_embedding, device=dev)
        embeddings = np.asarray(embedding_fn([c.samples for c in chunks]))
    n = len(chunks)
    labels = (np.zeros(n, np.int64) if n <= 2
              else nme_sc(embeddings, max_speakers, device=dev))

    appearance: List[int] = []
    for lbl in labels:
        if int(lbl) not in appearance:
            appearance.append(int(lbl))
    result = [
        SpeakerSegment(c.start, c.end, f"Speaker {appearance.index(int(l)) + 1}")
        for c, l in zip(chunks, labels)
    ]
    result.sort(key=lambda s: s.start)
    return merge_consecutive_segments(result, merge_gap)


def onnx_runner(net: str, path, device=None):
    """The reference's first route for a downloaded net: its .onnx run as a
    graph by the ONNX executor (``models.onnx_nets``) on ``device``."""
    from ..models import onnx_nets

    if net == "segmentation":
        return onnx_nets.segmentation_runner(path, device=device)
    return onnx_nets.embedding_runner(path, device=device)


def run_diarization(
    audio_16k,
    sample_rate: int,
    text_segments: Sequence[Tuple[float, float, str]],
    model_manager=None,
    max_speakers: int = 4,
    merge_gap: float = 1.0,
    bus=None,
    device=None,
) -> str:
    """Transcription hand-off: diarize + interleave with word segments.

    Network selection per net, best first:
      1. the downloaded .onnx through the ONNX executor (``onnx_runner``:
         pyannote segmentation-3.0 + WeSpeaker CAM++, the reference's pair
         — diarization.rs:40-75,133-134);
      2. the native port (``models.segmentation`` / ``models.campplus``
         ``from_onnx``) over the same file;
      3. the built-in stand-in (energy VAD / log-mel stats) — never chosen
         silently: a 'diarization-fallback' event carries both errors.
    """
    dev = resolve_device(device)

    def load(net: str, model_id: str, native: Callable):
        if model_manager is None or not model_manager.is_downloaded(model_id):
            return None
        path = model_manager.model_path(model_id)
        try:
            return onnx_runner(net, path, device=dev)
        except Exception as e1:
            try:
                return native(path, device=dev)
            except Exception as e2:  # a file the native port cannot map
                if bus is not None:
                    bus.emit("diarization-fallback",
                             {"net": net, "error": f"{e1}; native port: {e2}"})
                return None

    from ..models import campplus, segmentation

    seg_fn = load("segmentation", "diarize-segmentation", segmentation.from_onnx)
    emb_fn = load("embedding", "diarize-embedding", campplus.from_onnx)
    segs = diarize(audio_16k, sample_rate, max_speakers, merge_gap,
                   segmentation_fn=energy_vad_logits if seg_fn is None else seg_fn,
                   embedding_fn=melstats_embedding if emb_fn is None else emb_fn,
                   device=dev)
    return format_diarized_text(text_segments, segs)
