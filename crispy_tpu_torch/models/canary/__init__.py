"""Canary ASR (FastConformer encoder + Transformer AED decoder) in PyTorch.

The port of ``crispy_tpu/models/canary/__init__.py``. The reference
catalogs canary-180m-flash and canary-1b-v2 (managers/model.rs:253-290).
NVIDIA's published Canary recipe: the FastConformer encoder of
``models.parakeet`` (an ``enc_proj`` linear where its width differs from
the decoder's) with a pre-LN Transformer decoder over sinusoidal positions
and cross-attention, prompted with task/language tokens and decoded
greedily over an f32 KV cache.

The weights live in a ``Canary`` module (``params_to_module``); the decode
loop is a plain function that issues no host sync per step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..carry import load_params, module_name
from ..parakeet import Parakeet, ParakeetConfig
from ..parakeet import init_random as conformer_init
from ..whisper.model import _lengths, _merge


@dataclass(frozen=True)
class CanaryConfig:
    encoder: ParakeetConfig = ParakeetConfig()
    vocab_size: int = 5248
    dec_layers: int = 6
    dec_heads: int = 8
    dec_hidden: int = 1024
    dec_ffn: int = 4096
    max_len: int = 512
    bos: int = 1
    eos: int = 2


CONFIGS = {
    "canary-180m-flash": CanaryConfig(
        encoder=ParakeetConfig(hidden_size=512, layers=17, heads=8,
                               intermediate_size=2048, vocab_size=5248),
        vocab_size=5248, dec_layers=4, dec_heads=8, dec_hidden=512, dec_ffn=2048),
    "test-random": CanaryConfig(
        encoder=ParakeetConfig(hidden_size=64, layers=2, heads=2, kv_heads=2,
                               intermediate_size=128, sub_channels=32, vocab_size=64),
        vocab_size=64, dec_layers=2, dec_heads=2, dec_hidden=64, dec_ffn=128,
        bos=62, eos=63),
}


def _sinusoids(length: int, d: int) -> np.ndarray:
    pos = np.arange(length)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000.0 ** (2 * i / d))
    out = np.zeros((length, d), np.float64)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out.astype(np.float32)


def _attn(q, k, v, mask=None):
    logits = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if mask is not None:
        logits = logits + mask
    return torch.matmul(torch.softmax(logits, dim=-1), v)


class Attention(nn.Module):
    def __init__(self, d: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.o = nn.Linear(d, d)

    def heads(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, D] -> [B, H, T, hd]
        B, T, D = x.shape
        return x.view(B, T, self.n_head, D // self.n_head).transpose(1, 2)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: CanaryConfig):
        super().__init__()
        d = cfg.dec_hidden
        self.ln1 = nn.LayerNorm(d, eps=1e-5)
        self.attn = Attention(d, cfg.dec_heads)
        self.lnx = nn.LayerNorm(d, eps=1e-5)
        self.cross = Attention(d, cfg.dec_heads)
        self.ln2 = nn.LayerNorm(d, eps=1e-5)
        self.fc1 = nn.Linear(d, cfg.dec_ffn)
        self.fc2 = nn.Linear(cfg.dec_ffn, d)

    def mlp(self, x):
        return self.fc2(F.relu(self.fc1(self.ln2(x))))


class Decoder(nn.Module):
    def __init__(self, cfg: CanaryConfig):
        super().__init__()
        d = cfg.dec_hidden
        self.emb = nn.Parameter(torch.empty(cfg.vocab_size, d))
        self.pos = nn.Parameter(torch.empty(cfg.max_len, d))
        self.layers = nn.ModuleList(DecoderLayer(cfg) for _ in range(cfg.dec_layers))
        self.ln = nn.LayerNorm(d, eps=1e-5)

    def embed(self, tokens: torch.Tensor, start: int = 0) -> torch.Tensor:
        x = self.emb[tokens] * float(np.sqrt(self.emb.shape[1]))
        return x + self.pos[start: start + tokens.shape[1]]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.ln(x), self.emb)


class Canary(nn.Module):
    def __init__(self, cfg: CanaryConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Parakeet(cfg.encoder, ctc=False, tdt=False)
        if cfg.encoder.hidden_size != cfg.dec_hidden:
            self.enc_proj = nn.Linear(cfg.encoder.hidden_size, cfg.dec_hidden)
        self.dec = Decoder(cfg)


def _module_name(flat: str) -> str:
    """The encoder's flat names under ``encoder.``; the rest as they are."""
    if flat.startswith(("sub.", "enc.")):
        return "encoder." + module_name(flat)
    return module_name(flat)


def params_to_module(params: Dict[str, np.ndarray], cfg: CanaryConfig, device=None) -> Canary:
    """The JAX package's flat params carried into a ``Canary`` on ``device``
    (default: the card). The conformer's own CTC and TDT heads, which the
    flat dict carries from ``init_random``, are left out: Canary never
    reads them."""
    keep = {k: v for k, v in params.items()
            if k.startswith(("sub.", "enc.", "dec.", "enc_proj."))}
    return load_params(lambda: Canary(cfg), keep, device, _module_name)


@torch.no_grad()
def encode(model: Canary, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, T, n_mels] → [B, T/8, dec_hidden]."""
    feats = model.encoder(mel)
    if hasattr(model, "enc_proj"):
        feats = model.enc_proj(feats)
    return feats


@torch.no_grad()
def decode_logits(model: Canary, tokens: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """Teacher-forced logits: tokens [B, T], feats [B, S, d] → [B, T, V]."""
    dec = model.dec
    T = tokens.shape[1]
    x = dec.embed(tokens)
    mask = torch.full((T, T), float("-inf"), device=x.device).triu(1)
    for lyr in dec.layers:
        a, c = lyr.attn, lyr.cross
        h = lyr.ln1(x)
        x = x + a.o(_merge(_attn(a.heads(a.q(h)), a.heads(a.k(h)), a.heads(a.v(h)), mask)))
        h = lyr.lnx(x)
        x = x + c.o(_merge(_attn(c.heads(c.q(h)), c.heads(c.k(feats)), c.heads(c.v(feats)))))
        x = x + lyr.mlp(x)
    return dec.logits(x)


def _decode_step(model: Canary, tok, pos: int, self_k, self_v, cross_k, cross_v, max_len: int):
    """One cached decoder step. tok [B], pos a Python int → logits [B, V];
    the step's K/V are written into the caches in place."""
    dec = model.dec
    x = dec.embed(tok[:, None], pos)
    pos_mask = torch.arange(max_len, device=x.device) <= pos
    for i, lyr in enumerate(dec.layers):
        a, c = lyr.attn, lyr.cross
        h = lyr.ln1(x)
        self_k[i, :, :, pos] = a.heads(a.k(h))[:, :, 0]
        self_v[i, :, :, pos] = a.heads(a.v(h))[:, :, 0]
        q = a.heads(a.q(h))
        logits = torch.matmul(q, self_k[i].transpose(-1, -2)) * q.shape[-1] ** -0.5
        logits = torch.where(pos_mask, logits, -1e30)
        x = x + a.o(_merge(torch.matmul(torch.softmax(logits, dim=-1), self_v[i])))
        x = x + c.o(_merge(_attn(c.heads(c.q(lyr.lnx(x))), cross_k[i], cross_v[i])))
        x = x + lyr.mlp(x)
    return dec.logits(x)[:, 0]


@torch.no_grad()
def greedy_decode(model: Canary, mel: torch.Tensor, max_new: int = 128,
                  prompt: Optional[torch.Tensor] = None):
    """Greedy AED decode; ``prompt`` [B, P] (NeMo canary's task prompt:
    bos, source lang, task, target lang, pnc) defaults to [bos]. The prompt
    is prefilled one token at a time, then max_new - 1 cached steps run with
    eos freezing: finished rows keep emitting eos. Returns (tokens
    [B, max_new], lengths [B])."""
    cfg = model.cfg
    feats = encode(model, mel)
    B = feats.shape[0]
    H = cfg.dec_heads
    hd = cfg.dec_hidden // H
    if prompt is None:
        prompt = torch.full((B, 1), cfg.bos, dtype=torch.long, device=feats.device)
    P = prompt.shape[1]
    max_len = P + max_new
    self_k = feats.new_zeros((cfg.dec_layers, B, H, max_len, hd))
    self_v = torch.zeros_like(self_k)
    layers = model.dec.layers
    cross_k = torch.stack([lyr.cross.heads(lyr.cross.k(feats)) for lyr in layers])
    cross_v = torch.stack([lyr.cross.heads(lyr.cross.v(feats)) for lyr in layers])
    for p_i in range(P):  # prefill (P is small)
        logits = _decode_step(model, prompt[:, p_i], p_i, self_k, self_v, cross_k, cross_v,
                              max_len)
    tok = logits.argmax(-1)
    done = tok == cfg.eos
    toks = [tok]
    for i in range(max_new - 1):
        logits = _decode_step(model, tok, P + i, self_k, self_v, cross_k, cross_v, max_len)
        tok = torch.where(done, cfg.eos, logits.argmax(-1))
        done = done | (tok == cfg.eos)
        toks.append(tok)
    tokens = torch.stack(toks, dim=1)
    return tokens, _lengths(tokens, cfg.eos, max_new)


def init_random(cfg: CanaryConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(max(shape[0], 1))).astype(np.float32)

    p = conformer_init(cfg.encoder, seed)
    d = cfg.dec_hidden
    p["dec.emb"] = (rng.standard_normal((cfg.vocab_size, d)) * 0.02).astype(np.float32)
    p["dec.pos"] = _sinusoids(cfg.max_len, d)
    p["dec.ln.g"] = np.ones(d, np.float32)
    p["dec.ln.b"] = np.zeros(d, np.float32)
    if cfg.encoder.hidden_size != d:
        p["enc_proj.w"] = w(cfg.encoder.hidden_size, d)
        p["enc_proj.b"] = np.zeros(d, np.float32)
    for i in range(cfg.dec_layers):
        pre = f"dec.{i}"
        for blk in ("attn", "cross"):
            for proj in ("q", "k", "v", "o"):
                p[f"{pre}.{blk}.{proj}.w"] = w(d, d)
                p[f"{pre}.{blk}.{proj}.b"] = np.zeros(d, np.float32)
        p[f"{pre}.fc1.w"] = w(d, cfg.dec_ffn)
        p[f"{pre}.fc1.b"] = np.zeros(cfg.dec_ffn, np.float32)
        p[f"{pre}.fc2.w"] = w(cfg.dec_ffn, d)
        p[f"{pre}.fc2.b"] = np.zeros(d, np.float32)
        for ln in ("ln1", "lnx", "ln2"):
            p[f"{pre}.{ln}.g"] = np.ones(d, np.float32)
            p[f"{pre}.{ln}.b"] = np.zeros(d, np.float32)
    return p
