"""SenseVoice-Small (SAN-M encoder + non-autoregressive CTC) in PyTorch.

The port of ``crispy_tpu/models/sensevoice.py``. The reference catalogs
sense-voice-int8 (managers/model.rs). The public SenseVoice-Small recipe
(FunASR family):

  frontend: 80-mel kaldi fbank → LFR stacking (m=7 frames concatenated
            every n=6) → per-dim CMVN → ×sqrt(d) scaling, with 4 prompt
            embeddings prepended (language, event, emotion, text-norm
            query tokens).
  encoder:  SAN-M blocks — self-attention whose value path carries an FSMN
            memory branch (depthwise conv over the value projections, added
            to the attention output) — the first block maps the 560-d LFR
            input into the model width, then pre-LN blocks + final LN.
  head:     CTC over the multilingual SentencePiece vocabulary; decoding is
            a single non-autoregressive pass (argmax → collapse → deblank),
            dropping the prompt positions.

The weights live in a ``SenseVoice`` module (``params_to_module``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..dsp.asr_frontend import lfr
from .carry import load_params


@dataclass(frozen=True)
class SenseVoiceConfig:
    feat_dim: int = 80
    lfr_m: int = 7  # stacked frames
    lfr_n: int = 6  # stacking stride
    hidden: int = 512
    heads: int = 4
    ffn: int = 2048
    layers: int = 50
    fsmn_kernel: int = 11
    vocab_size: int = 25055
    n_prompt: int = 4  # language / event / emotion / textnorm queries
    blank_id: int = 0

    @property
    def input_dim(self) -> int:
        return self.feat_dim * self.lfr_m


CONFIGS = {
    "sense-voice-small": SenseVoiceConfig(),
    "test-random": SenseVoiceConfig(feat_dim=16, hidden=32, heads=2, ffn=64,
                                    layers=2, vocab_size=64),
}


def sinusoidal_pe(T: int, depth: int) -> np.ndarray:
    """FunASR SinusoidalPositionEncoder: positions are 1-indexed;
    pe = [sin(pos*inv_ts) ‖ cos(pos*inv_ts)] at the INPUT width (560)."""
    positions = np.arange(1, T + 1, dtype=np.float64)[:, None]
    half = depth // 2
    log_inc = np.log(10000.0) / (half - 1)
    inv_ts = np.exp(np.arange(half, dtype=np.float64) * -log_inc)[None, :]
    scaled = positions * inv_ts
    pe = np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1)
    if pe.shape[1] < depth:  # odd depth: zero-pad the tail column
        pe = np.pad(pe, ((0, 0), (0, depth - pe.shape[1])))
    return pe.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _pe_on(T: int, depth: int, device: torch.device) -> torch.Tensor:
    """sinusoidal_pe on device, made once per length: an upload per call
    would stall the host on the card."""
    return torch.from_numpy(sinusoidal_pe(T, depth)).to(device)


class SanmAttention(nn.Module):
    """Self-attention + FSMN memory on the value path: q, k, v from one fused
    projection; the memory is a depthwise conv over the (pre-head) values
    with a residual, added AFTER the output projection (FunASR
    MultiHeadedAttentionSANM: att_outs + fsmn_memory)."""

    def __init__(self, cfg: SenseVoiceConfig, in_d: int):
        super().__init__()
        d, k = cfg.hidden, cfg.fsmn_kernel
        self.d, self.heads = d, cfg.heads
        self.qkv = nn.Linear(in_d, 3 * d)
        self.fsmn = nn.Conv1d(d, d, k, padding=(k - 1) // 2, groups=d, bias=False)
        self.out = nn.Linear(d, d)

    def forward(self, x):
        B, T, _ = x.shape
        d, H = self.d, self.heads
        q, k, v = self.qkv(x).split(d, dim=-1)
        fsmn = v + self.fsmn(v.transpose(1, 2)).transpose(1, 2)
        hd = d // H

        def heads(t):
            return t.reshape(B, T, H, hd).transpose(1, 2)

        att = torch.matmul(heads(q), heads(k).transpose(-1, -2)) / float(np.sqrt(hd))
        att = torch.matmul(torch.softmax(att, dim=-1), heads(v))
        return self.out(att.transpose(1, 2).reshape(B, T, d)) + fsmn


class Block(nn.Module):
    def __init__(self, cfg: SenseVoiceConfig, first: bool):
        super().__init__()
        d = cfg.hidden
        in_d = cfg.input_dim if first else d
        self.ln1 = nn.LayerNorm(in_d, eps=1e-12)
        self.attn = SanmAttention(cfg, in_d)
        self.ln2 = nn.LayerNorm(d, eps=1e-12)
        self.fc1 = nn.Linear(d, cfg.ffn)
        self.fc2 = nn.Linear(cfg.ffn, d)
        self.residual_attn = not first  # the first block changes width: no skip

    def forward(self, x):
        a = self.attn(self.ln1(x))
        x = x + a if self.residual_attn else a
        return x + self.fc2(F.relu(self.fc1(self.ln2(x))))


class Cmvn(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.mean = nn.Parameter(torch.empty(dim))
        self.istd = nn.Parameter(torch.empty(dim))


class Encoder(nn.Module):
    def __init__(self, cfg: SenseVoiceConfig):
        super().__init__()
        self.layers = nn.ModuleList(Block(cfg, first=i == 0) for i in range(cfg.layers))
        self.ln = nn.LayerNorm(cfg.hidden, eps=1e-12)


class SenseVoice(nn.Module):
    def __init__(self, cfg: SenseVoiceConfig):
        super().__init__()
        self.cfg = cfg
        self.cmvn = Cmvn(cfg.input_dim)
        # query-embedding table at the INPUT width (FunASR: nn.Embedding to
        # input_size=560; prompts pass through the first block like speech)
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.input_dim))
        self.enc = Encoder(cfg)
        self.ctc = nn.Linear(cfg.hidden, cfg.vocab_size)


def params_to_module(params: Dict[str, np.ndarray], cfg: SenseVoiceConfig,
                     device=None) -> SenseVoice:
    """The JAX package's flat params carried into a ``SenseVoice`` on
    ``device`` (default: the card)."""
    return load_params(lambda: SenseVoice(cfg), params, device)


@torch.no_grad()
def encode(model: SenseVoice, feats: torch.Tensor, prompt_ids: torch.Tensor) -> torch.Tensor:
    """fbank [B, T, feat_dim] + prompt ids [n_prompt] → [B, P+T', d].

    FunASR SenseVoiceSmall order: LFR → CMVN → concat the INPUT-width
    (560-d) query embeddings BEFORE the encoder → ×sqrt(d) scale →
    sinusoidal PE (1-indexed positions, input width) → encoders0 (560→d,
    no attention residual) → pre-LN SAN-M blocks → after-norm."""
    cfg = model.cfg
    x = lfr(feats, cfg.lfr_m, cfg.lfr_n)
    x = (x - model.cmvn.mean) * model.cmvn.istd
    prompt = model.embed[prompt_ids][None].expand(x.shape[0], -1, -1)
    x = torch.cat([prompt, x], dim=1)  # the queries ride through the first block
    x = x * float(np.float32(np.sqrt(cfg.hidden)))
    x = x + _pe_on(x.shape[1], cfg.input_dim, x.device)
    for blk in model.enc.layers:
        x = blk(x)
    return model.enc.ln(x)


@torch.no_grad()
def ctc_logits(model: SenseVoice, feats: torch.Tensor, prompt_ids: torch.Tensor) -> torch.Tensor:
    return model.ctc(encode(model, feats, prompt_ids))


def ctc_greedy(logits, cfg: SenseVoiceConfig) -> List[List[int]]:
    """argmax → drop prompt positions → collapse repeats → deblank. logits:
    a tensor on any device or an array, [B, P+T', V]."""
    if isinstance(logits, torch.Tensor):
        ids = logits.argmax(-1).cpu().numpy()
    else:
        ids = np.asarray(logits).argmax(-1)
    out = []
    for row in ids[:, cfg.n_prompt:]:
        toks, prev = [], -1
        for t in row:
            if t != prev and t != cfg.blank_id:
                toks.append(int(t))
            prev = t
        out.append(toks)
    return out


def init_random(cfg: SenseVoiceConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(max(shape[0], 1))).astype(np.float32)

    d = cfg.hidden
    p: Dict[str, np.ndarray] = {
        "cmvn.mean": np.zeros(cfg.input_dim, np.float32),
        "cmvn.istd": np.ones(cfg.input_dim, np.float32),
        # query-embedding table at the INPUT width (FunASR: nn.Embedding
        # to input_size=560; prompts pass through encoders0 like speech)
        "embed": (rng.standard_normal((cfg.vocab_size, cfg.input_dim)) * 0.02
                  ).astype(np.float32),
        "enc.ln.g": np.ones(d, np.float32), "enc.ln.b": np.zeros(d, np.float32),
        "ctc.w": w(d, cfg.vocab_size), "ctc.b": np.zeros(cfg.vocab_size, np.float32),
    }
    for i in range(cfg.layers):
        pre = f"enc.{i}"
        in_d = cfg.input_dim if i == 0 else d
        p[f"{pre}.attn.qkv.w"] = w(in_d, 3 * d)
        p[f"{pre}.attn.qkv.b"] = np.zeros(3 * d, np.float32)
        p[f"{pre}.attn.fsmn.w"] = w(cfg.fsmn_kernel, 1, d)
        p[f"{pre}.attn.out.w"] = w(d, d)
        p[f"{pre}.attn.out.b"] = np.zeros(d, np.float32)
        p[f"{pre}.ln1.g"] = np.ones(in_d, np.float32)
        p[f"{pre}.ln1.b"] = np.zeros(in_d, np.float32)
        p[f"{pre}.ln2.g"] = np.ones(d, np.float32)
        p[f"{pre}.ln2.b"] = np.zeros(d, np.float32)
        p[f"{pre}.fc1.w"] = w(d, cfg.ffn)
        p[f"{pre}.fc1.b"] = np.zeros(cfg.ffn, np.float32)
        p[f"{pre}.fc2.w"] = w(cfg.ffn, d)
        p[f"{pre}.fc2.b"] = np.zeros(d, np.float32)
    return p
