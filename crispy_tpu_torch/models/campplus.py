"""CAM++ speaker-embedding network (WeSpeaker CAM++) in PyTorch.

The port of ``crispy_tpu/models/campplus.py``. The reference extracts
speaker embeddings with WeSpeaker's CAM++ ONNX
(``wespeaker_en_voxceleb_CAM++.onnx``, managers/diarization.rs:40-75): kaldi
fbank features in, one embedding out per ≤4 s chunk. Here all chunks run
batched on the device:

  FCM front-end: 2-D convs over (freq, time) — conv3x3 + two residual
    stages (first block stride (2,1)) + conv3x3 stride (2,1), so 80 mel
    bins fold to 10 and channels×freq flatten into a 320-d frame vector.
  D-TDNN backbone: an initial TDNN (k=5, stride 2), then three densely
    connected blocks of (12, 24, 16) layers with growth 32: each layer is
    BN-ReLU → 1x1 bottleneck (128) → BN-ReLU → CAM conv (k=3, dilation
    1/2/2), its output concatenated onto the running feature map; a transit
    layer (BN-ReLU → 1x1) halves the channels between blocks.
  CAM (context-aware mask): the conv output is gated by
    sigmoid(W2·relu(W1·(global mean + 100-frame segment means))), pooled
    over valid (unpadded) frames only.
  Head: BN-ReLU → masked statistics pooling (mean‖std) → linear + BN.

Batch norms are inference-folded (x·g + b). Chunks of different lengths
batch by zero-padding plus a per-chunk valid-frame count: every pooled
statistic masks the padding and every conv and BN stage re-zeroes the
tail, so a padded batched row equals the unpadded one.

The weights are the JAX package's flat dict (``param_spec`` names; from
``init_random``, the same NumPy draws, or ``from_initializers`` over an
ONNX export's initializer list) carried into the module by
``params_to_module``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..dsp.fbank import FRAME_LENGTH, FRAME_SHIFT, fbank
from .carry import load_params
from .segmentation import Affine, layer_list

MAX_CHUNK_SECONDS = 4.0  # diarization.rs:315 — chunks arrive ≤4 s
_SR = 16000
_MAX_SAMPLES = int(MAX_CHUNK_SECONDS * _SR)
_MAX_FRAMES = 1 + (_MAX_SAMPLES - FRAME_LENGTH) // FRAME_SHIFT  # 398
_SEG_LEN = 100  # CAM segment pooling window (frames after stride 2)
# Chunks a forward holds at once: rows are independent, and at the
# published widths each FCM activation of 256 rows is ~1 GB.
ROWS_PER_FORWARD = 256


@dataclass(frozen=True)
class CamPPlusConfig:
    feat_dim: int = 80
    m_channels: int = 32  # FCM width
    fcm_blocks: int = 2  # residual blocks per FCM stage
    init_channels: int = 128
    growth: int = 32
    bn_channels: int = 128  # dense-layer bottleneck
    blocks: Tuple[Tuple[int, int, int], ...] = ((12, 3, 1), (24, 3, 2), (16, 3, 2))
    embedding_size: int = 512  # voxceleb CAM++ export


CONFIGS = {
    "wespeaker-voxceleb": CamPPlusConfig(),
    "test-random": CamPPlusConfig(
        feat_dim=16, m_channels=8, fcm_blocks=1, init_channels=16, growth=8,
        bn_channels=16, blocks=((2, 3, 1), (2, 3, 2)), embedding_size=32),
}


# ---------------------------------------------------------------------------
# Parameter spec: single source of truth for init, import, and the module
# ---------------------------------------------------------------------------

def param_spec(cfg: CamPPlusConfig) -> List[Tuple[str, str, tuple]]:
    """Ordered (name, kind, shape) list in torch module order.

    kinds: conv2d [kh,kw,I,O] · conv1d [k,I,O] (bias-free, BN follows) ·
    conv1d_b (with bias, the CAM gate MLP) · bn (folded scale/shift).
    """
    m = cfg.m_channels
    s: List[Tuple[str, str, tuple]] = [
        ("fcm.conv1", "conv2d", (3, 3, 1, m)), ("fcm.bn1", "bn", (m,)),
    ]
    for stage in (1, 2):
        for blk in range(cfg.fcm_blocks):
            pre = f"fcm.layer{stage}.{blk}"
            s += [(f"{pre}.conv1", "conv2d", (3, 3, m, m)), (f"{pre}.bn1", "bn", (m,)),
                  (f"{pre}.conv2", "conv2d", (3, 3, m, m)), (f"{pre}.bn2", "bn", (m,))]
            if blk == 0:  # stride-(2,1) entry block needs a projected shortcut
                s += [(f"{pre}.sc", "conv2d", (1, 1, m, m)), (f"{pre}.scbn", "bn", (m,))]
    s += [("fcm.conv2", "conv2d", (3, 3, m, m)), ("fcm.bn2", "bn", (m,))]

    c0 = m * (cfg.feat_dim // 8)  # three (2,1)-stride stages: 80 → 10
    s += [("tdnn.conv", "conv1d", (5, c0, cfg.init_channels)),
          ("tdnn.bn", "bn", (cfg.init_channels,))]
    ch = cfg.init_channels
    for bi, (n_layers, k, _d) in enumerate(cfg.blocks):
        for li in range(n_layers):
            pre = f"block{bi}.{li}"
            s += [(f"{pre}.bn1", "bn", (ch,)),
                  (f"{pre}.fc", "conv1d", (1, ch, cfg.bn_channels)),
                  (f"{pre}.bn2", "bn", (cfg.bn_channels,)),
                  (f"{pre}.cam.conv", "conv1d", (k, cfg.bn_channels, cfg.growth)),
                  (f"{pre}.cam.fc1", "conv1d_b", (1, cfg.bn_channels, cfg.bn_channels // 2)),
                  (f"{pre}.cam.fc2", "conv1d_b", (1, cfg.bn_channels // 2, cfg.growth))]
            ch += cfg.growth
        s += [(f"transit{bi}.bn", "bn", (ch,)),
              (f"transit{bi}.fc", "conv1d", (1, ch, ch // 2))]
        ch //= 2
    s += [("out.bn", "bn", (ch,)),
          ("emb.fc", "conv1d", (1, 2 * ch, cfg.embedding_size)),
          ("emb.bn", "bn", (cfg.embedding_size,))]
    return s


def init_random(cfg: CamPPlusConfig = CamPPlusConfig(), seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX package's flat dict from the same NumPy draws."""
    rng = np.random.default_rng(seed)
    params: Dict[str, np.ndarray] = {}
    for name, kind, shape in param_spec(cfg):
        if kind == "bn":
            params[f"{name}.g"] = np.ones(shape, np.float32)
            params[f"{name}.b"] = np.zeros(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[:-1]))
            params[f"{name}.w"] = (
                rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
            if kind == "conv1d_b":
                params[f"{name}.b"] = np.zeros(shape[-1], np.float32)
    return params


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------

def _weights(kind: str, shape: tuple) -> nn.Module:
    """An empty layer for one param_spec entry (the carry fills it)."""
    if kind == "bn":
        return Affine(shape[0])
    if kind == "conv2d":
        kh, kw, cin, cout = shape
        return nn.Conv2d(cin, cout, (kh, kw), bias=False)
    k, cin, cout = shape
    return nn.Conv1d(cin, cout, k, bias=kind == "conv1d_b")


def _conv1d(x, conv: nn.Conv1d, stride: int = 1, dilation: int = 1):
    """[B, C, T], SAME-length torch padding d·(k−1)/2."""
    pad = dilation * (conv.kernel_size[0] - 1) // 2
    return F.conv1d(x, conv.weight, conv.bias, stride, pad, dilation)


def _masked_mean(x, mask):
    """[B, C, T] mean over valid frames → [B, C]."""
    denom = torch.clamp(mask.sum(1, keepdim=True), min=1.0)
    return (x * mask[:, None, :]).sum(2) / denom


def _seg_mean(x, mask):
    """CAM segment pooling: per-100-frame masked means, broadcast to [B, C, T]."""
    B, C, T = x.shape
    S = -(-T // _SEG_LEN)
    pad = S * _SEG_LEN - T
    xs = F.pad(x * mask[:, None, :], (0, pad))
    ms = F.pad(mask, (0, pad))
    num = xs.reshape(B, C, S, _SEG_LEN).sum(3)
    den = torch.clamp(ms.reshape(B, S, _SEG_LEN).sum(2), min=1.0)
    seg = num / den[:, None, :]  # [B, C, S]
    return seg.repeat_interleave(_SEG_LEN, dim=2)[:, :, :T]


class CamPPlusModel(nn.Module):
    """Chunks of 16 kHz audio (≤4 s each) → [N, E] speaker embeddings."""

    def __init__(self, cfg: CamPPlusConfig = CamPPlusConfig(), name: str = "campplus"):
        super().__init__()
        self.cfg, self.name = cfg, name
        groups: Dict[str, dict] = {}
        for full, kind, shape in param_spec(cfg):
            *path, leaf = full.split(".")
            node = groups
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = _weights(kind, shape)
        for key, sub in groups.items():
            self.add_module(key, _tree(sub))

    @property
    def device(self) -> torch.device:
        return self.emb.fc.weight.device

    def forward(self, feats: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
        """[B, T, feat_dim] fbank + valid-frame counts → [B, embedding_size]."""
        cfg = self.cfg
        B, T, _F = feats.shape
        mask = (torch.arange(T, device=feats.device)[None, :] < n_valid[:, None]).float()
        # CMN over valid frames, then zero the padding so the FCM convs see
        # silence. Every FCM stage re-applies the time mask: the convs smear
        # the boundary one frame into the tail and the folded BN bias makes
        # padding nonzero.
        mu = _masked_mean(feats.transpose(1, 2), mask)
        x = (feats - mu[:, None, :]) * mask[..., None]
        tm = mask[:, None, None, :]
        fcm = self.fcm
        h = x.transpose(1, 2)[:, None]  # [B, 1, freq, T]
        h = F.relu(fcm.bn1(F.conv2d(h, fcm.conv1.weight, padding=1))) * tm
        for stage in (fcm.layer1, fcm.layer2):
            for blk, layer in enumerate(stage.layers):
                st = (2, 1) if blk == 0 else (1, 1)
                r = F.relu(layer.bn1(F.conv2d(h, layer.conv1.weight, stride=st,
                                              padding=1))) * tm
                r = layer.bn2(F.conv2d(r, layer.conv2.weight, padding=1))
                sc = layer.scbn(F.conv2d(h, layer.sc.weight, stride=st)) if blk == 0 else h
                h = F.relu(r + sc) * tm
        h = F.relu(fcm.bn2(F.conv2d(h, fcm.conv2.weight, stride=(2, 1), padding=1))) * tm
        h = h.reshape(B, -1, T)  # [B, C·F', T], channel-major

        h = F.relu(self.tdnn.bn(_conv1d(h, self.tdnn.conv, stride=2)))
        n2 = torch.clamp((n_valid - 1) // 2 + 1, min=1)
        mask2 = (torch.arange(h.shape[2], device=h.device)[None, :] < n2[:, None]).float()
        m2 = mask2[:, None, :]
        h = h * m2
        for bi, (_n, _k, d) in enumerate(cfg.blocks):
            for layer in getattr(self, f"block{bi}").layers:
                b = F.relu(layer.bn1(h)) * m2  # the BN bias un-zeroes the tail
                b = F.relu(layer.bn2(_conv1d(b, layer.fc))) * m2
                cam = layer.cam
                y = _conv1d(b, cam.conv, dilation=d)
                ctx = _masked_mean(b, mask2)[:, :, None] + _seg_mean(b, mask2)
                gate = torch.sigmoid(_conv1d(F.relu(_conv1d(ctx, cam.fc1)), cam.fc2))
                h = torch.cat([h, y * gate * m2], dim=1)
            transit = getattr(self, f"transit{bi}")
            h = _conv1d(F.relu(transit.bn(h)) * m2, transit.fc)
        h = F.relu(self.out.bn(h))

        # masked statistics pooling → embedding
        mean = _masked_mean(h, mask2)
        sq = _masked_mean(h * h, mask2)
        std = torch.sqrt(torch.clamp(sq - mean * mean, min=1e-10))
        stats = torch.cat([mean, std], dim=-1)
        return self.emb.bn(F.linear(stats, self.emb.fc.weight[:, :, 0]))

    def _embed(self, audio: torch.Tensor, n_valid: torch.Tensor) -> np.ndarray:
        """[N, _MAX_SAMPLES] audio rows → [N, E] embeddings, ROWS_PER_FORWARD
        rows a forward."""
        out = []
        for s in range(0, audio.shape[0], ROWS_PER_FORWARD):
            feats = fbank(audio[s:s + ROWS_PER_FORWARD], self.cfg.feat_dim)[:, :_MAX_FRAMES]
            out.append(self.forward(feats, n_valid[s:s + ROWS_PER_FORWARD]))
        return torch.cat(out).cpu().numpy()

    @torch.no_grad()
    def __call__(self, segments: Sequence[np.ndarray]) -> np.ndarray:
        """A list of chunks (host arrays) → [N, E], as ``diarize``'s
        ``embedding_fn``."""
        if not len(segments):
            return np.zeros((0, self.cfg.embedding_size), np.float32)
        audio, n_valid = chunk_rows(segments)
        return self._embed(torch.from_numpy(audio).to(self.device),
                           torch.from_numpy(n_valid).to(self.device))

    @torch.no_grad()
    def from_device(self, dev_i16: torch.Tensor, ranges) -> np.ndarray:
        """The one-upload route: [(sample_start, sample_end)] chunk ranges over
        the flat int16 recording on the device → [N, E], the chunks sliced
        there. Frames past a chunk's end read the audio after it instead of
        zeros; every stage masks them."""
        n = len(ranges)
        if n == 0:
            return np.zeros((0, self.cfg.embedding_size), np.float32)
        x = dev_i16.to(self.device)
        starts = np.array([a for a, _ in ranges], np.int64)
        lens = np.minimum([b - a for a, b in ranges], _MAX_SAMPLES)
        n_valid = np.maximum(0, 1 + (lens - FRAME_LENGTH) // FRAME_SHIFT)
        # a slice that would run past the end starts earlier (dynamic_slice's rule)
        starts = np.clip(starts, 0, x.shape[0] - _MAX_SAMPLES)
        idx = (torch.from_numpy(starts).to(x.device)[:, None]
               + torch.arange(_MAX_SAMPLES, device=x.device)[None, :])
        audio = x[idx].float().mul_(1.0 / 32768.0)
        return self._embed(audio, torch.from_numpy(n_valid).to(x.device))


def chunk_rows(segments: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Chunks → zero-padded [N, 64000] f32 rows (4 s; longer chunks are cut)
    and each row's valid fbank frame count."""
    audio = np.zeros((len(segments), _MAX_SAMPLES), np.float32)
    n_valid = np.zeros(len(segments), np.int64)
    for i, seg in enumerate(segments):
        s = np.asarray(seg, np.float32)[:_MAX_SAMPLES]
        audio[i, :len(s)] = s
        n_valid[i] = max(0, 1 + (len(s) - FRAME_LENGTH) // FRAME_SHIFT)
    return audio, n_valid


def _tree(node: dict) -> nn.Module:
    """Nested {name: layer or dict} → modules; an all-digit level becomes a
    ``layers`` list (the carry's ``name.layers.i``)."""
    subs = {k: v if isinstance(v, nn.Module) else _tree(v) for k, v in node.items()}
    if all(k.isdigit() for k in subs):
        return layer_list([subs[str(i)] for i in range(len(subs))])
    m = nn.Module()
    for k, v in subs.items():
        m.add_module(k, v)
    return m


def params_to_module(params: Dict[str, np.ndarray],
                     cfg: CamPPlusConfig = CamPPlusConfig(),
                     device=None, name: str = "campplus") -> CamPPlusModel:
    """The JAX package's flat params carried into a ``CamPPlusModel`` on
    ``device`` (default: the card)."""
    return load_params(lambda: CamPPlusModel(cfg, name), params, device)


# ---------------------------------------------------------------------------
# Weight import (ONNX initializer walk, torch module order)
# ---------------------------------------------------------------------------

def from_initializers(inits: List[np.ndarray],
                      cfg: CamPPlusConfig = CamPPlusConfig()) -> Dict[str, np.ndarray]:
    """Fold a torch-export-ordered initializer list into folded-BN params.

    Expects, per param_spec order: conv2d [O,I,kh,kw]; conv1d [O,I,k];
    conv1d_b weight then bias [O]; bn as the (gamma, beta, mean, var)
    quartet. Shape-checked at every step; raises with the first mismatch so
    a real export's divergence is diagnosable.
    """
    params: Dict[str, np.ndarray] = {}
    i = 0

    def take(expect_shape, what):
        nonlocal i
        if i >= len(inits):
            raise ValueError(f"initializers exhausted at {what}")
        a = np.asarray(inits[i], np.float32)
        if tuple(a.shape) != tuple(expect_shape):
            raise ValueError(f"{what}: expected shape {tuple(expect_shape)}, "
                             f"got {a.shape} at initializer {i}")
        i += 1
        return a

    for name, kind, shape in param_spec(cfg):
        if kind == "bn":
            c = shape[0]
            gamma = take((c,), f"{name}.gamma")
            beta = take((c,), f"{name}.beta")
            mean = take((c,), f"{name}.mean")
            var = take((c,), f"{name}.var")
            scale = gamma / np.sqrt(var + 1e-5)
            params[f"{name}.g"] = scale
            params[f"{name}.b"] = beta - mean * scale
        elif kind == "conv2d":
            kh, kw, cin, cout = shape
            w = take((cout, cin, kh, kw), f"{name}.weight")
            params[f"{name}.w"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
        else:  # conv1d / conv1d_b
            k, cin, cout = shape
            w = take((cout, cin, k), f"{name}.weight")
            params[f"{name}.w"] = np.ascontiguousarray(w.transpose(2, 1, 0))
            if kind == "conv1d_b":
                params[f"{name}.b"] = take((cout,), f"{name}.bias")
    if i != len(inits):
        raise ValueError(f"{len(inits) - i} trailing initializers unmapped "
                         f"(consumed {i})")
    return params


def from_onnx(path, cfg: CamPPlusConfig = CamPPlusConfig(), device=None) -> CamPPlusModel:
    """Load the distributed CAM++ ONNX via models.onnx_import."""
    from .onnx_import import load_onnx_weights

    weights = load_onnx_weights(path)
    params = from_initializers(list(weights.values()), cfg)
    return params_to_module(params, cfg, device, name="campplus-onnx")
