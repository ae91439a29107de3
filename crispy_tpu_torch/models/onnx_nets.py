"""Diarization nets from their distributed ONNX files, through the port's
ONNX executor (``models/onnx_exec``), on the card.

The port of ``crispy_tpu/models/onnx_nets.py``. The reference runs pyannote
segmentation-3.0 and WeSpeaker CAM++ through ONNX Runtime
(managers/diarization.rs:40-75,133-134: session.run per 10 s window / per
≤4 s chunk). Here the same .onnx files run eagerly on the device, the
whole window batch in one call, with input names and layouts introspected
from the graph rather than hardcoded. Each runner is a callable on host
arrays (``diarize``'s host route) with a ``from_device`` method that takes
the flat int16 recording on the device (the one-upload route).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..dsp.fbank import fbank
from .onnx_exec import OnnxRunner

WINDOW_SAMPLES = 160000  # 10 s at 16 kHz, the segmentation window


def _first_input(runner: OnnxRunner):
    infos = runner.input_info()
    if not infos:
        raise ValueError("ONNX graph has no runtime inputs")
    return infos[0]


def segmentation_runner(path, device=None) -> Callable[[np.ndarray], np.ndarray]:
    """segmentation .onnx → fn(windows [W, 160000]) → logits [W, F, C], on
    ``device`` (default: the card).

    pyannote segmentation-3.0 takes waveform [B, 1, T] and returns powerset
    logits [B, 589, 7]; the rank is read from the graph, so a [B, T] export
    also works, and a single-window [F, C] output gains its batch axis.
    """
    dev = resolve_device(device)
    runner = OnnxRunner.load(path).validate()
    name, _, shape = _first_input(runner)
    rank = len(shape) if shape else 3
    big = runner.lift_big_params(dev)

    def forward(windows: torch.Tensor) -> torch.Tensor:
        x = windows[:, None, :] if rank == 3 else windows
        y = runner(big, **{name: x})[runner.output_names[0]]
        return y[None] if y.ndim == 2 else y

    @torch.no_grad()
    def call(windows) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(windows, np.float32)).to(dev)
        return forward(x).cpu().numpy()

    @torch.no_grad()
    def from_device(dev_i16: torch.Tensor) -> np.ndarray:
        """The flat int16 recording on the device (padded to a window
        multiple) → [W, F, C]; the windows are a reshape of it there."""
        x = dev_i16.to(dev).float().mul_(1.0 / 32768.0)
        return forward(x.reshape(-1, WINDOW_SAMPLES)).cpu().numpy()

    call.from_device = from_device
    return call


def embedding_runner(path, feat_dim: int = 80,
                     device=None) -> Callable[[Sequence[np.ndarray]], np.ndarray]:
    """speaker-embedding .onnx → fn([segments]) → [N, D], on ``device``
    (default: the card).

    WeSpeaker CAM++ takes kaldi fbank feats [B, T, 80] ('feats' → 'embs').
    Segments are bucketed by sample count and each bucket runs as one batch
    (the reference runs one ONNX session per chunk — diarization.rs:53-74):
    fbank, per-utterance CMN and the net on the device, so the features
    never visit the host, and the embeddings leave it once a call. The JAX
    package pads each bucket's batch to a power of two so that XLA reuses a
    compiled program; eager PyTorch compiles nothing, so the port (like its
    CAM++ ``from_device``) runs each bucket at its own size.
    """
    dev = resolve_device(device)
    runner = OnnxRunner.load(path).validate()
    name, _, shape = _first_input(runner)
    if shape and len(shape) not in (2, 3):
        raise ValueError(f"unexpected embedding input rank {len(shape)}")
    big = runner.lift_big_params(dev)

    def run_audio(audio: torch.Tensor) -> torch.Tensor:
        feats = fbank(audio, feat_dim)
        # WeSpeaker applies per-utterance CMN (subtract the feature mean)
        feats = feats - feats.mean(dim=1, keepdim=True)
        return runner(big, **{name: feats.float()})[runner.output_names[0]]

    def gather(buckets: Dict[int, List[int]], rows) -> np.ndarray:
        """Each bucket's embeddings, in the segments' order, in one copy."""
        order, parts = [], []
        for n, idxs in buckets.items():
            parts.append(run_audio(rows(n, idxs)))
            order += idxs
        embs = torch.cat(parts)
        out = torch.empty_like(embs)
        out[torch.tensor(order, device=embs.device)] = embs
        return out.cpu().numpy().astype(np.float32)

    @torch.no_grad()
    def call(segments: Sequence[np.ndarray]) -> np.ndarray:
        if not len(segments):
            return np.zeros((0, 0), np.float32)
        buckets: Dict[int, List[int]] = {}
        for i, seg in enumerate(segments):
            buckets.setdefault(len(seg), []).append(i)
        return gather(buckets, lambda _n, idxs: torch.from_numpy(
            np.stack([np.asarray(segments[i], np.float32) for i in idxs])).to(dev))

    @torch.no_grad()
    def from_device(dev_i16: torch.Tensor, ranges) -> np.ndarray:
        """[(sample_start, sample_end)] chunk ranges over the flat int16
        recording on the device → [N, D], the chunks sliced there (a slice
        that would run past the end starts earlier, dynamic_slice's rule)."""
        if not len(ranges):
            return np.zeros((0, 0), np.float32)
        x = dev_i16.to(dev)
        buckets: Dict[int, List[int]] = {}
        for i, (a, b) in enumerate(ranges):
            buckets.setdefault(int(b - a), []).append(i)

        def rows(n: int, idxs: List[int]) -> torch.Tensor:
            starts = np.clip([ranges[i][0] for i in idxs], 0, x.shape[0] - n)
            idx = (torch.from_numpy(starts.astype(np.int64)).to(dev)[:, None]
                   + torch.arange(n, device=dev)[None, :])
            return x[idx].float().mul_(1.0 / 32768.0)

        return gather(buckets, rows)

    call.from_device = from_device
    return call
