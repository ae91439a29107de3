"""Whisper encoder-decoder in PyTorch with KV-cached decoding.

The port of ``crispy_tpu/models/whisper/model.py``, the public Whisper
architecture:

  encoder: conv1(k3,s1) → gelu → conv2(k3,s2) → gelu → +sinusoid positions
           → pre-LN transformer blocks → ln_post          (mel [80,3000] → [1500,d])
  decoder: token emb + learned positions → pre-LN blocks with causal
           self-attn + cross-attn → ln → logits = x @ emb.T

The weights live in ``nn.Module``s (``Whisper`` = ``AudioEncoder`` +
``TextDecoder``; ``weights.params_to_module`` carries the JAX package's flat
``[in, out]`` params into them); the decode loops are plain functions over a
preallocated KV cache ``[L, B, H, max_len, hd]``. The loops issue no host
sync per step: every step's token stays on the device. While a profiler
session records, ``encode`` records the span (``utils.tracing``)
``whisper.encode``, and each of ``greedy_decode`` and ``sample_decode``
records ``whisper.decode`` around ``whisper.init_cache``,
``whisper.prefill`` and one ``whisper.step`` a cached step.

Numerics follow the JAX package: q and k each scaled by hd^-0.25, exact
GELU, LayerNorm with the biased variance and eps 1e-5, symmetric padding 1
on both convs. K and V are rounded to the cache dtype (bf16 by default,
``CRISPY_WHISPER_KV=f32`` opts out) where the JAX package rounds them: the
cross K/V once, the prefill's self K/V before its own attention, and every
step's self K/V as they enter the cache; the scaled K is formed in the cache
dtype, and its product with the f32 q is promoted to f32.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...utils.tracing import span


@dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    n_vocab: int = 51865
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4
    # special tokens (multilingual layout by default)
    eot: int = 50257
    sot: int = 50258

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head


CONFIGS: Dict[str, WhisperConfig] = {
    "tiny": WhisperConfig(80, 51865, 1500, 384, 6, 4, 448, 384, 6, 4),
    "tiny.en": WhisperConfig(80, 51864, 1500, 384, 6, 4, 448, 384, 6, 4, 50256, 50257),
    "base": WhisperConfig(80, 51865, 1500, 512, 8, 6, 448, 512, 8, 6),
    "base.en": WhisperConfig(80, 51864, 1500, 512, 8, 6, 448, 512, 8, 6, 50256, 50257),
    "small": WhisperConfig(80, 51865, 1500, 768, 12, 12, 448, 768, 12, 12),
    "small.en": WhisperConfig(80, 51864, 1500, 768, 12, 12, 448, 768, 12, 12, 50256, 50257),
    "medium": WhisperConfig(80, 51865, 1500, 1024, 16, 24, 448, 1024, 16, 24),
    "large-v2": WhisperConfig(80, 51865, 1500, 1280, 20, 32, 448, 1280, 20, 32),
    "large-v3": WhisperConfig(128, 51866, 1500, 1280, 20, 32, 448, 1280, 20, 32),
    "test-random": WhisperConfig(80, 1000, 1500, 64, 2, 2, 448, 64, 2, 2, 999, 998),
}


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's encoder positional encoding."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def _merge(x: torch.Tensor) -> torch.Tensor:  # [B, H, T, hd] -> [B, T, D]
    B, H, T, hd = x.shape
    return x.transpose(1, 2).reshape(B, T, H * hd)


def _scaled(k: torch.Tensor, scale: float) -> torch.Tensor:
    """k * scale in k's own dtype, the scale rounded to it first (the JAX
    package multiplies a bf16 cache by a weakly typed Python scalar). The
    rounded scale goes in as a Python float: a tensor made on the device
    here would cost a host sync per call."""
    return k * float(torch.tensor(scale, dtype=k.dtype))


def _attn(q, k, v, mask=None):
    """q [B, H, Tq, hd] f32; k, v [B, H, Tk, hd] f32 or the cache dtype.
    Whisper scales q and k by hd^-0.25 each; products run in f32."""
    scale = q.shape[-1] ** -0.25
    logits = torch.matmul(q * scale, _scaled(k, scale).float().transpose(-1, -2))
    if mask is not None:
        logits = logits + mask
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w, v.float())


class Attention(nn.Module):
    """Multi-head attention; k has no bias (Whisper).

    Once sharded (``shard_module``), ``tp`` holds the tensor-parallel
    pieces: each computes its own heads on its device, and ``reduce`` adds
    their row-parallel partial products back on the input's device."""

    def __init__(self, d: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d, bias=False)
        self.v = nn.Linear(d, d)
        self.out = nn.Linear(d, d)
        self.tp: Optional[List["_AttnPiece"]] = None

    def heads(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, D] -> [B, H, T, hd]
        B, T, D = x.shape
        return x.view(B, T, self.n_head, D // self.n_head).transpose(1, 2)

    def parts(self) -> list:
        """The attention's parts: itself unsharded, else its TP pieces."""
        return [_Whole(self)] if self.tp is None else self.tp

    def reduce(self, partials: List[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        return _reduce(partials, x, None if self.tp is None else self.out.bias)

    def forward(self, x, xa=None, mask=None):
        """Block attention without a cache; xa is the cross-attention memory."""
        src = x if xa is None else xa
        return self.reduce([p.out(_attn(p.q(x), p.k(src), p.v(src), _to(mask, p.device)))
                            for p in self.parts()], x)


class _Whole:
    """An unsharded attention as its one part: q, k and v as heads
    [B, H, T, hd], and the output projection with its bias."""

    def __init__(self, a: Attention):
        self.a = a
        self.device = a.q.weight.device

    def q(self, x):
        return self.a.heads(self.a.q(x))

    def k(self, x):
        return self.a.heads(self.a.k(x))

    def v(self, x):
        return self.a.heads(self.a.v(x))

    def out(self, o):
        return self.a.out(_merge(o))


class _AttnPiece:
    """Heads [j·H/tp, (j+1)·H/tp) of an attention on ``device``: the
    column-parallel rows of q, k and v and the row-parallel columns of out
    (views of the module's weights where the device is theirs)."""

    def __init__(self, a: Attention, j: int, tp: int, device: torch.device):
        c = a.q.weight.shape[0] // tp
        cols = slice(j * c, (j + 1) * c)
        self.device, self.n_head = device, a.n_head // tp
        self.wq = a.q.weight.detach()[cols].to(device)
        self.bq = a.q.bias.detach()[cols].to(device)
        self.wk = a.k.weight.detach()[cols].to(device)
        self.wv = a.v.weight.detach()[cols].to(device)
        self.bv = a.v.bias.detach()[cols].to(device)
        self.wo = a.out.weight.detach()[:, cols].to(device)

    def _heads(self, x):
        B, T, D = x.shape
        return x.view(B, T, self.n_head, D // self.n_head).transpose(1, 2)

    def q(self, x):
        return self._heads(F.linear(x.to(self.device), self.wq, self.bq))

    def k(self, x):
        return self._heads(F.linear(x.to(self.device), self.wk))

    def v(self, x):
        return self._heads(F.linear(x.to(self.device), self.wv, self.bv))

    def out(self, o):
        return F.linear(_merge(o), self.wo)


def _to(t: Optional[torch.Tensor], device: torch.device) -> Optional[torch.Tensor]:
    return None if t is None else t.to(device)


def _reduce(partials: List[torch.Tensor], x: torch.Tensor,
            bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Row-parallel partial products added in piece order on x's device,
    then the bias; an unsharded layer's one output (its bias included)
    passes through."""
    if bias is None:
        return partials[0]
    acc = partials[0].to(x.device)
    for p in partials[1:]:
        acc = acc + p.to(x.device)
    return acc + bias


class MLP(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.fc1 = nn.Linear(d, 4 * d)
        self.fc2 = nn.Linear(4 * d, d)
        # once sharded: (device, fc1 rows, fc1 bias, fc2 columns) per piece
        self.tp: Optional[list] = None

    def forward(self, x):
        if self.tp is None:
            return self.fc2(F.gelu(self.fc1(x), approximate="none"))
        return _reduce([F.linear(F.gelu(F.linear(x.to(d), w1, b1), approximate="none"), w2)
                        for d, w1, b1, w2 in self.tp], x, self.fc2.bias)


class Block(nn.Module):
    """Pre-LN transformer block; the decoder's adds cross-attention."""

    def __init__(self, d: int, n_head: int, cross: bool = False):
        super().__init__()
        self.ln1 = nn.LayerNorm(d, eps=1e-5)
        self.attn = Attention(d, n_head)
        if cross:
            self.lnx = nn.LayerNorm(d, eps=1e-5)
            self.cross = Attention(d, n_head)
        self.ln2 = nn.LayerNorm(d, eps=1e-5)
        self.mlp = MLP(d)

    def forward(self, x, xa=None, mask=None):
        x = x + self.attn(self.ln1(x), mask=mask)
        if xa is not None:
            x = x + self.cross(self.lnx(x), xa)
        return x + self.mlp(self.ln2(x))


class AudioEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.n_audio_state
        # torch-style symmetric padding 1 on both convs
        self.conv1 = nn.Conv1d(cfg.n_mels, d, 3, stride=1, padding=1)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
        self.pos = nn.Parameter(torch.empty(cfg.n_audio_ctx, d))
        self.blocks = nn.ModuleList(Block(d, cfg.n_audio_head) for _ in range(cfg.n_audio_layer))
        self.ln_post = nn.LayerNorm(d, eps=1e-5)

    def forward(self, mel):  # [B, n_mels, 3000] -> [B, 1500, d]
        x = F.gelu(self.conv1(mel), approximate="none")
        x = F.gelu(self.conv2(x), approximate="none")
        x = x.transpose(1, 2) + self.pos
        for blk in self.blocks:
            x = blk(x)
        return self.ln_post(x)


class TextDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.n_text_state
        self.emb = nn.Embedding(cfg.n_vocab, d)
        self.pos = nn.Parameter(torch.empty(cfg.n_text_ctx, d))
        self.blocks = nn.ModuleList(
            Block(d, cfg.n_text_head, cross=True) for _ in range(cfg.n_text_layer))
        self.ln = nn.LayerNorm(d, eps=1e-5)

    def embed(self, tokens: torch.Tensor, start: int = 0) -> torch.Tensor:
        """Token plus position embeddings of tokens [B, T] at positions
        start.. . Ids outside the vocabulary clamp to its ends, as the JAX
        package's gather does (a test-random ggml file carries the
        multilingual special ids of its header beyond its 1000 rows)."""
        ids = tokens.clamp(0, self.emb.num_embeddings - 1)
        return self.emb(ids) + self.pos[start: start + tokens.shape[1]]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.ln(x), self.emb.weight)

    def forward(self, tokens, audio):
        T = tokens.shape[1]
        mask = torch.full((T, T), float("-inf"), device=audio.device).triu(1)
        x = self.embed(tokens)
        for blk in self.blocks:
            x = blk(x, audio, mask)
        return self.logits(x)


class Whisper(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = AudioEncoder(cfg)
        self.decoder = TextDecoder(cfg)


# ---------------------------------------------------------------------------
# Encoder and teacher-forced decoder
# ---------------------------------------------------------------------------

@torch.no_grad()
def encode(model: Whisper, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, n_mels, 3000] → audio features [B, 1500, d]."""
    with span("whisper.encode"):
        return model.encoder(mel)


@torch.no_grad()
def decode_logits(model: Whisper, tokens: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
    """Teacher-forced logits: tokens [B, T], audio [B, 1500, d] → [B, T, V]."""
    return model.decoder(tokens, audio)


# ---------------------------------------------------------------------------
# KV cache, prefill and the cached step
# ---------------------------------------------------------------------------

def _kv_dtype() -> torch.dtype:
    """KV cache storage dtype. Default bfloat16: the decode step reads the
    cross KV every step, and the reference serves whisper.cpp with an f16
    KV cache — bf16 storage stays inside its precision envelope.
    CRISPY_WHISPER_KV=f32 opts out (goldens under tests/ pin the bf16
    default's tokens)."""
    return (torch.float32 if os.environ.get("CRISPY_WHISPER_KV", "bf16") == "f32"
            else torch.bfloat16)


def _init_cache(model: Whisper, audio: torch.Tensor, max_len: int):
    """Preallocate self-attn KV [L, B, H, max_len, hd]; precompute cross KV.
    Sharded, each is a list with one cache per TP piece, holding that
    piece's heads on its device (``_each`` reads both forms)."""
    cfg = model.cfg
    B = audio.shape[0]
    hd = cfg.n_text_state // cfg.n_text_head
    dt = _kv_dtype()
    blocks = model.decoder.blocks
    self_k, self_v, cross_k, cross_v = [], [], [], []
    for j, part in enumerate(blocks[0].attn.parts()):
        H = part.n_head if isinstance(part, _AttnPiece) else cfg.n_text_head
        self_k.append(torch.zeros((cfg.n_text_layer, B, H, max_len, hd), dtype=dt,
                                  device=part.device))
        self_v.append(torch.zeros_like(self_k[-1]))
        cross_k.append(torch.stack([b.cross.parts()[j].k(audio) for b in blocks]).to(dt))
        cross_v.append(torch.stack([b.cross.parts()[j].v(audio) for b in blocks]).to(dt))
    if blocks[0].attn.tp is None:
        return self_k[0], self_v[0], cross_k[0], cross_v[0]
    return self_k, self_v, cross_k, cross_v


def _each(cache) -> list:
    """A KV cache's per-part tensors: the one tensor unsharded, the list of
    TP pieces sharded."""
    return cache if isinstance(cache, list) else [cache]


def _map_cache(fn, cache):
    return [fn(t) for t in cache] if isinstance(cache, list) else fn(cache)


def _cross(blk, x, cross_k, cross_v, i: int) -> torch.Tensor:
    """The block's cross-attention over the cached cross K/V of layer i."""
    c = blk.cross
    h = blk.lnx(x)
    return c.reduce([p.out(_attn(p.q(h), ck[i], cv[i]))
                     for p, ck, cv in zip(c.parts(), _each(cross_k), _each(cross_v))], x)


def _prefill(model: Whisper, prompt, self_k, self_v, cross_k, cross_v):
    """Teacher-forced prompt prefill: one batched pass fills the KV cache at
    positions [0, P) in place and returns logits for every prompt position
    [B, P, V] with the caches."""
    dec = model.decoder
    P = prompt.shape[1]
    x = dec.embed(prompt)
    mask = torch.full((P, P), float("-inf"), device=x.device).triu(1)
    for i, blk in enumerate(dec.blocks):
        a = blk.attn
        h = blk.ln1(x)
        partials = []
        for p, sk, sv in zip(a.parts(), _each(self_k), _each(self_v)):
            kh = p.k(h).to(sk.dtype)  # rounded before its own use
            vh = p.v(h).to(sv.dtype)
            sk[i, :, :, :P] = kh
            sv[i, :, :, :P] = vh
            partials.append(p.out(_attn(p.q(h), kh, vh, mask.to(p.device))))
        x = x + a.reduce(partials, x)
        x = x + _cross(blk, x, cross_k, cross_v, i)
        x = x + blk.mlp(blk.ln2(x))
    return dec.logits(x), self_k, self_v


def _clamp_max_new(cfg: WhisperConfig, P: int, max_new: int) -> int:
    """prompt + generated tokens must fit n_text_ctx (dec.pos is [448, d];
    out-of-range positions would read wrong embeddings)."""
    if P >= cfg.n_text_ctx:
        raise ValueError(f"prompt length {P} >= n_text_ctx {cfg.n_text_ctx}")
    return max(1, min(max_new, cfg.n_text_ctx - P))


def _decode_step(model: Whisper, tok, pos: int, self_k, self_v, cross_k, cross_v, max_len: int):
    """One cached decoder step. tok [B], pos a Python int → logits [B, V];
    the step's K/V are written into the caches in place."""
    dec = model.decoder
    x = dec.embed(tok[:, None], pos)
    pos_mask = {sk.device: torch.arange(max_len, device=sk.device) <= pos
                for sk in _each(self_k)}
    for i, blk in enumerate(dec.blocks):
        a = blk.attn
        h = blk.ln1(x)
        partials = []
        for p, sk, sv in zip(a.parts(), _each(self_k), _each(self_v)):
            sk[i, :, :, pos] = p.k(h)[:, :, 0].to(sk.dtype)
            sv[i, :, :, pos] = p.v(h)[:, :, 0].to(sv.dtype)
            q = p.q(h)  # [B, H', 1, hd]
            scale = q.shape[-1] ** -0.25
            logits = torch.matmul(q * scale, _scaled(sk[i], scale).float().transpose(-1, -2))
            logits = torch.where(pos_mask[sk.device], logits, -1e30)
            partials.append(p.out(torch.matmul(torch.softmax(logits, dim=-1), sv[i].float())))
        x = x + a.reduce(partials, x)
        x = x + _cross(blk, x, cross_k, cross_v, i)
        x = x + blk.mlp(blk.ln2(x))
    return dec.logits(x)[:, 0, :], self_k, self_v


# ---------------------------------------------------------------------------
# Decode loops
# ---------------------------------------------------------------------------

def _audio(model: Whisper, mel_or_audio: torch.Tensor) -> torch.Tensor:
    if mel_or_audio.shape[-2] == model.cfg.n_mels:  # raw mel given
        return model.encoder(mel_or_audio)
    return mel_or_audio


def _lengths(tokens: torch.Tensor, eot_id: int, max_new: int) -> torch.Tensor:
    """Index of the first eot along the last axis, max_new where none."""
    hit = tokens == eot_id
    return torch.where(hit.any(-1), hit.int().argmax(-1), max_new)


@torch.no_grad()
def greedy_decode(
    model: Whisper,
    mel_or_audio: torch.Tensor,
    prompt: torch.Tensor,
    max_new: int = 224,
    eot: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy decode.

    prompt [B, P] (the SOT sequence); returns (tokens [B, max_new], lengths
    [B]). Runs max_new − 1 cached steps with EOS freezing: finished rows
    keep emitting eot.
    """
    with span("whisper.decode"):
        cfg = model.cfg
        audio = _audio(model, mel_or_audio)
        P = prompt.shape[1]
        eot_id = cfg.eot if eot is None else eot
        max_new = _clamp_max_new(cfg, P, max_new)
        max_len = P + max_new
        with span("whisper.init_cache"):
            self_k, self_v, cross_k, cross_v = _init_cache(model, audio, max_len)
        with span("whisper.prefill"):
            logits_all, self_k, self_v = _prefill(model, prompt, self_k, self_v, cross_k, cross_v)
        tok = logits_all[:, -1].argmax(-1)
        done = tok == eot_id
        toks = [tok]
        for i in range(max_new - 1):
            with span("whisper.step"):
                logits, self_k, self_v = _decode_step(
                    model, tok, P + i, self_k, self_v, cross_k, cross_v, max_len)
                tok = torch.where(done, eot_id, logits.argmax(-1))
                done = done | (tok == eot_id)
                toks.append(tok)
        tokens = torch.stack(toks, dim=1)
        return tokens, _lengths(tokens, eot_id, max_new)


@torch.no_grad()
def sample_decode(
    model: Whisper,
    mel_or_audio: torch.Tensor,
    prompt: torch.Tensor,
    temperature: float,
    generator: Optional[torch.Generator],
    no_speech_id: int,
    sot_index: int = 0,
    max_new: int = 224,
    eot: Optional[int] = None,
    noise_rows: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode at a temperature, with the quality metrics of the fallback
    ladder.

    temperature 0 → argmax (equal to greedy_decode); > 0 → a draw from
    softmax(logits / temperature) by the Gumbel-max trick on ``generator``
    (on its device; the JAX package's ``jax.random`` draws differ).
    ``noise_rows=(start, total)`` makes a shard of a batch draw as the whole
    batch does: each step draws the noise of all ``total`` rows from the
    generator and keeps rows start.. (rows past the batch, its padding, take
    the last row's), so a sharded decode samples what the unsharded one does.
    Returns (tokens [B, max_new], lengths [B], sum_logprob [B] — log-probs
    of the emitted tokens incl. the closing eot, the whisper avg_logprob
    numerator — and no_speech_prob [B], the probability mass on
    no_speech_id at the SOT prefill position; sot_index points at SOT, which
    is not position 0 when an initial_prompt prepends <|startofprev|>
    context).
    """
    with span("whisper.decode"):
        cfg = model.cfg
        audio = _audio(model, mel_or_audio)
        P = prompt.shape[1]
        eot_id = cfg.eot if eot is None else eot
        max_new = _clamp_max_new(cfg, P, max_new)
        max_len = P + max_new
        with span("whisper.init_cache"):
            self_k, self_v, cross_k, cross_v = _init_cache(model, audio, max_len)
        with span("whisper.prefill"):
            logits_all, self_k, self_v = _prefill(model, prompt, self_k, self_v, cross_k, cross_v)
        no_speech_prob = torch.softmax(logits_all[:, sot_index], dim=-1)[:, no_speech_id]

        def pick(logits):
            if temperature > 0:
                gumbel = -torch.log(_exponential(logits, generator, noise_rows))
                tok = (logits / temperature + gumbel).argmax(-1)
            else:
                tok = logits.argmax(-1)
            lp = torch.log_softmax(logits, dim=-1).gather(-1, tok[:, None])[:, 0]
            return tok, lp

        tok, lp_sum = pick(logits_all[:, -1])
        done = tok == eot_id
        toks = [tok]
        for i in range(max_new - 1):
            with span("whisper.step"):
                logits, self_k, self_v = _decode_step(
                    model, tok, P + i, self_k, self_v, cross_k, cross_v, max_len)
                nxt, lp = pick(logits)
                lp_sum = lp_sum + torch.where(done, 0.0, lp)  # frozen rows stop scoring
                tok = torch.where(done, eot_id, nxt)
                done = done | (tok == eot_id)
                toks.append(tok)
        tokens = torch.stack(toks, dim=1)
        return tokens, _lengths(tokens, eot_id, max_new), lp_sum, no_speech_prob


def _exponential(logits: torch.Tensor, generator, noise_rows) -> torch.Tensor:
    """Exp(1) noise shaped like logits [B, V] (see sample_decode)."""
    if noise_rows is None:
        return torch.empty_like(logits).exponential_(generator=generator)
    start, total = noise_rows
    full = torch.empty((total, logits.shape[1]), dtype=logits.dtype,
                       device=generator.device).exponential_(generator=generator)
    idx = torch.clamp(torch.arange(start, start + logits.shape[0], device=full.device),
                      max=total - 1)
    return full[idx].to(logits.device)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, equal values in index order (the
    order of ``lax.top_k``; ``torch.topk`` promises none among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def beam_decode(
    model: Whisper,
    mel_or_audio: torch.Tensor,
    prompt: torch.Tensor,
    beam: int = 5,
    max_new: int = 224,
    eot: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched beam search (beams ride the batch dimension: B·beam rows).

    Finished hypotheses are frozen (they keep emitting eot at logprob 0);
    the final pick maximizes length-normalized cumulative logprob, the
    standard whisper ranking. beam=1 reproduces greedy_decode exactly.
    Returns (tokens [B, max_new], lengths [B], best sum_logprob [B]).
    """
    cfg = model.cfg
    audio = _audio(model, mel_or_audio)
    B, P = prompt.shape
    eot_id = cfg.eot if eot is None else eot
    max_new = _clamp_max_new(cfg, P, max_new)
    max_len = P + max_new
    V = cfg.n_vocab
    dev = audio.device

    # Row b*beam + j is beam j of batch item b. Cross K/V are computed once
    # per batch row and the head tensors repeated.
    self_k, self_v, cross_k, cross_v = (
        _map_cache(lambda t: t.repeat_interleave(beam, dim=1), c)
        for c in _init_cache(model, audio, max_len))
    logits_all, self_k, self_v = _prefill(
        model, prompt.repeat_interleave(beam, dim=0), self_k, self_v, cross_k, cross_v)
    lp = torch.log_softmax(logits_all[:, -1], dim=-1).reshape(B, beam, V)[:, 0]
    # first expansion: top-beam tokens of beam 0 (all beams are identical)
    cum, tok = _top_k(lp, beam)  # [B, beam]
    done = tok == eot_id
    base = (torch.arange(B, device=dev) * beam)[:, None]
    hist = torch.full((B, beam, max_new), eot_id, dtype=torch.long, device=dev)
    hist[:, :, 0] = tok
    # frozen beams: only eot continues, at no cost (an eot beyond the
    # vocabulary is never emitted, and the JAX package's scatter drops it)
    frozen = torch.full((V,), float("-inf"), device=dev)
    if -V <= eot_id < V:
        frozen[eot_id] = 0.0
    for i in range(max_new - 1):
        logits, self_k, self_v = _decode_step(
            model, tok.reshape(B * beam), P + i, self_k, self_v, cross_k, cross_v, max_len)
        lp = torch.log_softmax(logits, dim=-1).reshape(B, beam, V)
        lp = torch.where(done[..., None], frozen, lp)
        cum, idx = _top_k((cum[..., None] + lp).reshape(B, beam * V), beam)
        parent = idx // V
        tok = idx % V
        rows = (base + parent).reshape(-1)
        self_k = _map_cache(lambda t: t.index_select(1, rows.to(t.device)), self_k)
        self_v = _map_cache(lambda t: t.index_select(1, rows.to(t.device)), self_v)
        hist = hist.gather(1, parent[..., None].expand(B, beam, max_new))
        hist[:, :, i + 1] = tok
        done = done.gather(1, parent) | (tok == eot_id)
    lengths_all = _lengths(hist, eot_id, max_new)
    norm = cum / torch.clamp(lengths_all + 1, min=1)
    best = norm.argmax(1)
    rows = torch.arange(B, device=dev)
    return hist[rows, best], lengths_all[rows, best], cum[rows, best]


# ---------------------------------------------------------------------------
# Tensor-parallel placement
# ---------------------------------------------------------------------------

def shard_module(model: Whisper, devices: Sequence[torch.device]) -> Whisper:
    """The model for one data row of a mesh, whose model-axis devices are
    ``devices``: a ``Whisper`` on devices[0] that shares the weights'
    storage where they already lie there, with each attention and MLP split
    into len(devices) pieces where ``parallel.asr.whisper_param_spec``
    splits its weights (column-parallel q, k, v and fc1, row-parallel out and
    fc2), piece j on devices[j]."""
    from ...parallel.asr import whisper_param_spec

    tp = len(devices)
    with torch.device("meta"):
        rep = Whisper(model.cfg)
    rep.load_state_dict({k: v.to(devices[0]) for k, v in model.state_dict().items()},
                        assign=True)

    def split(name: str, shape) -> bool:
        spec = whisper_param_spec(name, np.broadcast_to(np.float32(0), shape), tp)
        return spec == (None, "model")

    for side, blocks in (("enc", rep.encoder.blocks), ("dec", rep.decoder.blocks)):
        for i, blk in enumerate(blocks):
            attns = [("attn", blk.attn)] + ([("cross", blk.cross)] if side == "dec" else [])
            for nm, a in attns:
                d = a.q.weight.shape[0]
                if split(f"{side}.{i}.{nm}.q.w", (d, d)):
                    if a.n_head % tp:
                        raise ValueError(f"{a.n_head} heads do not split over {tp} devices")
                    a.tp = [_AttnPiece(a, j, tp, dev) for j, dev in enumerate(devices)]
            m = blk.mlp
            d4, d = m.fc1.weight.shape
            if split(f"{side}.{i}.mlp.fc1.w", (d, d4)):
                c = d4 // tp
                m.tp = [(dev, m.fc1.weight.detach()[j * c:(j + 1) * c].to(dev),
                         m.fc1.bias.detach()[j * c:(j + 1) * c].to(dev),
                         m.fc2.weight.detach()[:, j * c:(j + 1) * c].to(dev))
                        for j, dev in enumerate(devices)]
    return rep
