"""PyanNet speech segmentation network (pyannote segmentation-3.0) in PyTorch.

The port of ``crispy_tpu/models/segmentation.py``. The reference runs
pyannote's segmentation-3.0 ONNX over 10 s windows
(managers/diarization.rs:77-272); this is the same architecture, all
windows in one batch on the device:

  SincNet: instance-norm → sinc band-pass conv (80 filters, k=251,
           stride 10) → |.| → 3x [maxpool(3) → instance-norm → leaky-relu
           (→ conv1d k=5 for the next stage)]
  4-layer bidirectional LSTM (hidden 128, cuDNN on the card) → 2 linear +
  leaky-relu (128) → 7-class powerset logits per frame (10 s at 16 kHz →
  589 frames, the reference's 721/270 frame grid).

The weights are the JAX package's flat dict (``init_random``, the same NumPy
draws; ``from_onnx``) carried into the module by ``params_to_module``.
``__call__`` takes a [W, 160000] window batch as ``segment_speech``'s
``segmentation_fn``; ``from_device`` takes the flat int16 recording on the
device (the one-upload route of ``diarize``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import data_sharding, gather, module_on
from .carry import load_params

WINDOW_SAMPLES = 160000


@dataclass(frozen=True)
class SegmentationConfig:
    sinc_filters: int = 80
    sinc_kernel: int = 251
    sinc_stride: int = 10
    conv_channels: int = 60
    lstm_hidden: int = 128
    lstm_layers: int = 4
    linear_dim: int = 128
    n_classes: int = 7  # powerset: silence + 3 speakers + 3 pairs
    sample_rate: int = 16000


def sinc_filterbank(low_hz: np.ndarray, band_hz: np.ndarray, kernel: int,
                    sample_rate: int) -> np.ndarray:
    """Band-pass filters from (low, band) parameters (SincNet construction):
    g[t] = (2 f2 sinc(2 f2 t) - 2 f1 sinc(2 f1 t)) * hamming(t)."""
    n_f = low_hz.shape[0]
    low = np.abs(low_hz) + 50.0  # min_low_hz
    high = np.clip(low + np.abs(band_hz) + 50.0, 50.0, sample_rate / 2)
    t = (np.arange(kernel) - (kernel - 1) / 2) / sample_rate  # seconds
    window = np.hamming(kernel)
    out = np.zeros((n_f, kernel), np.float64)
    for i in range(n_f):
        f1, f2 = low[i], high[i]
        bp = 2 * f2 * np.sinc(2 * f2 * t) - 2 * f1 * np.sinc(2 * f1 * t)
        bp = bp / (2 * (f2 - f1))
        out[i] = bp * window
    return out.astype(np.float32)


class Affine(nn.Module):
    """A per-channel gain and bias (an instance norm's affine, a folded
    batch norm), applied on the channel axis of [B, C, ...]."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * self.weight.view(shape) + self.bias.view(shape)


def _instance_norm(x: torch.Tensor, affine: Affine, eps: float = 1e-5) -> torch.Tensor:
    """[B, C, T]: normalize over T per (sample, channel), population variance."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return affine((x - mu) * torch.rsqrt(var + eps))


def layer_list(modules) -> nn.Module:
    """A holder whose ``layers`` list takes the carry's ``name.layers.i``."""
    m = nn.Module()
    m.layers = nn.ModuleList(modules)
    return m


class SegmentationModel(nn.Module):
    """[W, 160000] windows → [W, 589, n_classes] powerset logits."""

    def __init__(self, cfg: SegmentationConfig = SegmentationConfig(),
                 name: str = "pyannet"):
        super().__init__()
        self.cfg, self.name = cfg, name
        c, h = cfg.conv_channels, cfg.lstm_hidden
        self.wav_norm = Affine(1)
        self.sinc = nn.Conv1d(1, cfg.sinc_filters, cfg.sinc_kernel, cfg.sinc_stride,
                              bias=False)
        self.norm = layer_list([Affine(cfg.sinc_filters), Affine(c), Affine(c)])
        self.conv = layer_list([nn.Conv1d(cfg.sinc_filters, c, 5), nn.Conv1d(c, c, 5)])
        self.lstm = nn.LSTM(c, h, num_layers=cfg.lstm_layers, bidirectional=True,
                            batch_first=True)
        self.linear = layer_list([nn.Linear(2 * h, cfg.linear_dim),
                                  nn.Linear(cfg.linear_dim, cfg.linear_dim)])
        self.cls = nn.Linear(cfg.linear_dim, cfg.n_classes)

    @property
    def device(self) -> torch.device:
        return self.cls.weight.device

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = _instance_norm(wav[:, None, :], self.wav_norm)  # [B, 1, T]
        x = self.sinc(x).abs()
        x = F.leaky_relu(_instance_norm(F.max_pool1d(x, 3, 3), self.norm.layers[0]), 0.01)
        for conv, norm in zip(self.conv.layers, self.norm.layers[1:]):
            x = F.leaky_relu(_instance_norm(F.max_pool1d(conv(x), 3, 3), norm), 0.01)
        x = self.lstm(x.transpose(1, 2))[0]  # [B, T, 2H]: [forward, backward]
        for lin in self.linear.layers:
            x = F.leaky_relu(lin(x), 0.01)
        return self.cls(x)

    @torch.no_grad()
    def __call__(self, windows) -> np.ndarray:
        x = torch.as_tensor(np.atleast_2d(np.asarray(windows, np.float32)))
        return self.forward(x.to(self.device)).cpu().numpy()

    @torch.no_grad()
    def from_device(self, dev_i16: torch.Tensor, mesh=None) -> np.ndarray:
        """The one-upload route: the flat int16 recording on the device
        (padded to a 10 s window multiple) → [W, 589, C] logits; the windows
        are a reshape of it there. With a ``parallel.Mesh`` the windows split
        over its data rows (a copy of the net on each distinct device)."""
        x = dev_i16.to(self.device).float().mul_(1.0 / 32768.0)
        w = x.reshape(-1, WINDOW_SAMPLES)
        if mesh is None:
            return self.forward(w).cpu().numpy()
        parts = [module_on(self, p.device).forward(p)
                 for p in data_sharding(mesh, w, pad="edge")]
        return gather(parts, self.device, w.shape[0]).cpu().numpy()


def init_random(cfg: SegmentationConfig = SegmentationConfig(), seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX package's flat dict from the same NumPy draws."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(max(shape[0], 1))).astype(np.float32)

    low = rng.uniform(30, 4000, cfg.sinc_filters)
    band = rng.uniform(50, 2000, cfg.sinc_filters)
    filters = sinc_filterbank(low, band, cfg.sinc_kernel, cfg.sample_rate)
    p: Dict[str, np.ndarray] = {
        "sinc.filters": filters.T[:, None, :],  # [k, 1, 80]
        "wav_norm.g": np.ones(1, np.float32), "wav_norm.b": np.zeros(1, np.float32),
        "norm.0.g": np.ones(cfg.sinc_filters, np.float32),
        "norm.0.b": np.zeros(cfg.sinc_filters, np.float32),
        "conv.0.w": w(5, cfg.sinc_filters, cfg.conv_channels),
        "conv.0.b": np.zeros(cfg.conv_channels, np.float32),
        "norm.1.g": np.ones(cfg.conv_channels, np.float32),
        "norm.1.b": np.zeros(cfg.conv_channels, np.float32),
        "conv.1.w": w(5, cfg.conv_channels, cfg.conv_channels),
        "conv.1.b": np.zeros(cfg.conv_channels, np.float32),
        "norm.2.g": np.ones(cfg.conv_channels, np.float32),
        "norm.2.b": np.zeros(cfg.conv_channels, np.float32),
        "linear.0.w": w(2 * cfg.lstm_hidden, cfg.linear_dim),
        "linear.0.b": np.zeros(cfg.linear_dim, np.float32),
        "linear.1.w": w(cfg.linear_dim, cfg.linear_dim),
        "linear.1.b": np.zeros(cfg.linear_dim, np.float32),
        "cls.w": w(cfg.linear_dim, cfg.n_classes),
        "cls.b": np.zeros(cfg.n_classes, np.float32),
    }
    in_dim = cfg.conv_channels
    for l in range(cfg.lstm_layers):
        d = in_dim if l == 0 else 2 * cfg.lstm_hidden
        for direction in ("f", "b"):
            p[f"lstm.{l}.{direction}.ih.w"] = w(d, 4 * cfg.lstm_hidden)
            p[f"lstm.{l}.{direction}.ih.b"] = np.zeros(4 * cfg.lstm_hidden, np.float32)
            p[f"lstm.{l}.{direction}.hh.w"] = w(cfg.lstm_hidden, 4 * cfg.lstm_hidden)
            p[f"lstm.{l}.{direction}.hh.b"] = np.zeros(4 * cfg.lstm_hidden, np.float32)
    return p


def params_to_module(params: Dict[str, np.ndarray],
                     cfg: SegmentationConfig = SegmentationConfig(),
                     device=None, name: str = "pyannet") -> SegmentationModel:
    """The JAX package's flat params carried into a ``SegmentationModel`` on
    ``device`` (default: the card). The sinc filters [k, 1, 80] are an HIO
    conv kernel."""
    flat = {("sinc.w" if k == "sinc.filters" else k): v for k, v in params.items()}
    model = load_params(lambda: SegmentationModel(cfg, name), flat, device)
    model.lstm.flatten_parameters()  # one weight buffer for cuDNN
    return model


def from_onnx(path, cfg: SegmentationConfig = SegmentationConfig(),
              device=None) -> SegmentationModel:
    """Load the distributed segmentation-3.0.onnx via models.onnx_import.

    ONNX graphs name tensors by export order; this maps by shape signature
    (sinc params, conv kernels). Raises with the found inventory if the
    file's structure is unexpected.
    """
    from .onnx_import import load_onnx_weights

    raw = load_onnx_weights(path)
    by_shape: Dict[tuple, List[str]] = {}
    for k, v in raw.items():
        by_shape.setdefault(tuple(v.shape), []).append(k)

    def take(shape, n=1):
        names = by_shape.get(tuple(shape), [])
        if len(names) < n:
            raise ValueError(
                f"expected {n} tensor(s) of shape {shape} in {path}; "
                f"inventory: { {s: len(v) for s, v in by_shape.items()} }")
        return [raw[names[i]] for i in range(n)]

    p = init_random(cfg)  # fill structure, overwrite below
    low, band = take((cfg.sinc_filters, 1), 2)
    p["sinc.filters"] = sinc_filterbank(
        low[:, 0], band[:, 0], cfg.sinc_kernel, cfg.sample_rate).T[:, None, :]
    # conv kernels [out, in, k] → HIO
    c0 = take((cfg.conv_channels, cfg.sinc_filters, 5))[0]
    c1 = take((cfg.conv_channels, cfg.conv_channels, 5))[0]
    p["conv.0.w"], p["conv.1.w"] = c0.transpose(2, 1, 0), c1.transpose(2, 1, 0)
    return params_to_module(p, cfg, device, name="segmentation-3.0")
