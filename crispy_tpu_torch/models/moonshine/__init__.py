"""Moonshine ASR in PyTorch (raw-waveform encoder-decoder).

The port of ``crispy_tpu/models/moonshine/__init__.py``; the reference
serves Moonshine through transcribe-rs (managers/transcription.rs:137:
MoonshineModel(Base)). The public architecture:

  encoder: raw 16 kHz audio → conv(127, s64, no bias)+tanh → groupnorm →
           conv(7, s3)+gelu → conv(3, s2)+gelu → pre-LN transformer with
           partial interleaved RoPE (rotary_dim = 0.9 * head_dim, pairs
           (2i, 2i+1) rotated by freq i), bias-free LayerNorms.
  decoder: token embedding → pre-LN blocks: causal RoPE self-attn,
           cross-attn, SwiGLU-style MLP (fc1 → chunk → silu(gate)*h → fc2),
           untied proj_out head. eos = 2, decoder_start = 1.

The weights live in a ``Moonshine`` module (``params_to_module``; the RoPE
tables ride in the params and are carried, not recomputed); greedy decoding
runs over a preallocated f32 KV cache with no host sync per step.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...device import resolve_device
from ..carry import hf_tokenizer, load_hf_state_dict, load_params
from ..whisper.model import _lengths, _merge


@dataclass(frozen=True)
class MoonshineConfig:
    vocab_size: int = 32768
    hidden_size: int = 288
    intermediate_size: int = 1152
    enc_layers: int = 6
    dec_layers: int = 6
    heads: int = 8
    partial_rotary_factor: float = 0.9
    rope_theta: float = 10000.0
    decoder_start: int = 1
    eos: int = 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.heads

    @property
    def rotary_dim(self) -> int:
        # default rope init: dim = head_dim * partial factor, floored even
        d = int(self.head_dim * self.partial_rotary_factor)
        return d - d % 2


CONFIGS = {
    "moonshine-tiny": MoonshineConfig(hidden_size=288, intermediate_size=1152,
                                      enc_layers=6, dec_layers=6, heads=8),
    "moonshine-base": MoonshineConfig(hidden_size=416, intermediate_size=1664,
                                      enc_layers=8, dec_layers=8, heads=8),
    "test-random": MoonshineConfig(vocab_size=207, hidden_size=64,
                                   intermediate_size=256, enc_layers=2,
                                   dec_layers=2, heads=2, decoder_start=205, eos=206),
}


def _rope_tables(cfg: MoonshineConfig, max_pos: int) -> Tuple[np.ndarray, np.ndarray]:
    """Interleaved partial-RoPE cos/sin: [max_pos, rotary_dim] with the
    repeat_interleave(2) layout (angle i on dims 2i, 2i+1)."""
    rd = cfg.rotary_dim
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, rd, 2, dtype=np.float64) / rd))
    freqs = np.arange(max_pos, dtype=np.float64)[:, None] * inv[None, :]  # [P, rd/2]
    # transformers builds cat(freqs, freqs) then takes the first half and
    # repeat_interleaves — net effect: angle i drives dims (2i, 2i+1).
    half = freqs[:, : rd // 2]
    cos = np.repeat(np.cos(half), 2, axis=1)
    sin = np.repeat(np.sin(half), 2, axis=1)
    return cos.astype(np.float32), sin.astype(np.float32)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., T, head_dim]; cos/sin [T, rotary_dim] (broadcast over heads):
    the first rotary_dim dims rotated in interleaved pairs, the rest as they are."""
    rd = cos.shape[-1]
    xr, xp = x[..., :rd], x[..., rd:]
    rot = torch.stack([-xr[..., 1::2], xr[..., 0::2]], dim=-1).reshape(xr.shape)
    return torch.cat([xr * cos + rot * sin, xp], dim=-1)


def _attn(q, k, v, scale, mask=None):
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask
    return torch.matmul(torch.softmax(logits, dim=-1), v)


def _ln(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=1e-5, bias=False)


class Attention(nn.Module):
    def __init__(self, d: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.q = nn.Linear(d, d, bias=False)
        self.k = nn.Linear(d, d, bias=False)
        self.v = nn.Linear(d, d, bias=False)
        self.o = nn.Linear(d, d, bias=False)

    def heads(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, D] -> [B, H, T, hd]
        B, T, D = x.shape
        return x.view(B, T, self.n_head, D // self.n_head).transpose(1, 2)


class Layer(nn.Module):
    """A pre-LN block: self-attention, cross-attention (decoder only), MLP."""

    def __init__(self, cfg: MoonshineConfig, decoder: bool):
        super().__init__()
        d, it = cfg.hidden_size, cfg.intermediate_size
        self.ln1 = _ln(d)
        self.attn = Attention(d, cfg.heads)
        self.ln2 = _ln(d)
        if decoder:
            self.cross = Attention(d, cfg.heads)
            self.ln3 = _ln(d)
        self.mlp = nn.ModuleDict({"fc1": nn.Linear(d, it * (2 if decoder else 1)),
                                  "fc2": nn.Linear(it, d)})

    def self_attn(self, h, cos, sin):
        """q, k (RoPE'd) and v of h [B, T, d]: [B, H, T, hd] each."""
        a = self.attn
        return (_apply_rope(a.heads(a.q(h)), cos, sin), _apply_rope(a.heads(a.k(h)), cos, sin),
                a.heads(a.v(h)))

    def encoder_mlp(self, x):
        return self.mlp["fc2"](F.gelu(self.mlp["fc1"](self.ln2(x)), approximate="none"))

    def decoder_mlp(self, x):
        hidden, gate = self.mlp["fc1"](self.ln3(x)).chunk(2, dim=-1)
        return self.mlp["fc2"](F.silu(gate) * hidden)


class Encoder(nn.Module):
    def __init__(self, cfg: MoonshineConfig):
        super().__init__()
        d = cfg.hidden_size
        self.conv1 = nn.Conv1d(1, d, 127, stride=64, bias=False)
        self.gn = nn.GroupNorm(1, d, eps=1e-5)
        self.conv2 = nn.Conv1d(d, 2 * d, 7, stride=3)
        self.conv3 = nn.Conv1d(2 * d, d, 3, stride=2)
        self.layers = nn.ModuleList(Layer(cfg, decoder=False) for _ in range(cfg.enc_layers))
        self.ln = _ln(d)


class Decoder(nn.Module):
    def __init__(self, cfg: MoonshineConfig):
        super().__init__()
        d = cfg.hidden_size
        self.emb = nn.Parameter(torch.empty(cfg.vocab_size, d))
        self.layers = nn.ModuleList(Layer(cfg, decoder=True) for _ in range(cfg.dec_layers))
        self.ln = _ln(d)


class Moonshine(nn.Module):
    def __init__(self, cfg: MoonshineConfig, max_pos: int = 2048):
        super().__init__()
        self.cfg = cfg
        self.enc = Encoder(cfg)
        self.dec = Decoder(cfg)
        self.proj_out = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        self.register_buffer("rope_cos", torch.empty(max_pos, cfg.rotary_dim))
        self.register_buffer("rope_sin", torch.empty(max_pos, cfg.rotary_dim))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj_out(self.dec.ln(x))


def params_to_module(params: Dict[str, np.ndarray], cfg: MoonshineConfig,
                     device=None) -> Moonshine:
    """The JAX package's flat params carried into a ``Moonshine`` on
    ``device`` (default: the card). ``proj_out.w`` is [vocab, d] there
    (contracted as ``btd,vd``), the other matrices [in, out]."""
    flat = dict(params)
    flat["proj_out.w"] = np.asarray(params["proj_out.w"]).T
    max_pos = flat["rope_cos"].shape[0]
    return load_params(lambda: Moonshine(cfg, max_pos), flat, device)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

@torch.no_grad()
def encode(model: Moonshine, audio: torch.Tensor) -> torch.Tensor:
    """audio [B, T] raw 16 kHz in [-1, 1] → features [B, T', d]."""
    cfg, enc = model.cfg, model.enc
    x = torch.tanh(enc.conv1(audio[:, None]))
    x = enc.gn(x)  # GroupNorm(1 group) over (C, L) jointly per sample
    x = F.gelu(enc.conv2(x), approximate="none")
    x = F.gelu(enc.conv3(x), approximate="none").transpose(1, 2)
    T = x.shape[1]
    if T > model.rope_cos.shape[0]:
        raise ValueError(
            f"audio too long: {T} encoder frames exceed the {model.rope_cos.shape[0]}"
            "-position RoPE table (~64 s) — chunk the input (the pipeline "
            "transcribes 30 s chunks)")
    cos, sin = model.rope_cos[:T], model.rope_sin[:T]
    scale = cfg.head_dim ** -0.5
    for lyr in enc.layers:
        q, k, v = lyr.self_attn(lyr.ln1(x), cos, sin)
        x = x + lyr.attn.o(_merge(_attn(q, k, v, scale)))
        x = x + lyr.encoder_mlp(x)
    return enc.ln(x)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

@torch.no_grad()
def decode_logits(model: Moonshine, tokens: torch.Tensor, audio_feats: torch.Tensor):
    """Teacher-forced logits [B, T, V]."""
    cfg = model.cfg
    T = tokens.shape[1]
    x = model.dec.emb[tokens]
    cos, sin = model.rope_cos[:T], model.rope_sin[:T]
    scale = cfg.head_dim ** -0.5
    mask = torch.full((T, T), float("-inf"), device=x.device).triu(1)
    for lyr in model.dec.layers:
        q, k, v = lyr.self_attn(lyr.ln1(x), cos, sin)
        x = x + lyr.attn.o(_merge(_attn(q, k, v, scale, mask)))
        c = lyr.cross
        x = x + c.o(_merge(_attn(c.heads(c.q(lyr.ln2(x))), c.heads(c.k(audio_feats)),
                                 c.heads(c.v(audio_feats)), scale)))
        x = x + lyr.decoder_mlp(x)
    return model.logits(x)


def _decode_step(model: Moonshine, tok, pos: int, self_k, self_v, cross_k, cross_v,
                 max_len: int):
    """One cached decoder step. tok [B], pos a Python int → logits [B, V];
    the step's K/V are written into the caches in place."""
    cfg = model.cfg
    x = model.dec.emb[tok][:, None, :]
    cos, sin = model.rope_cos[pos: pos + 1], model.rope_sin[pos: pos + 1]
    scale = cfg.head_dim ** -0.5
    pos_mask = torch.arange(max_len, device=x.device) <= pos
    for i, lyr in enumerate(model.dec.layers):
        q, k, v = lyr.self_attn(lyr.ln1(x), cos, sin)
        self_k[i, :, :, pos] = k[:, :, 0]
        self_v[i, :, :, pos] = v[:, :, 0]
        logits = torch.matmul(q, self_k[i].transpose(-1, -2)) * scale
        logits = torch.where(pos_mask, logits, -1e30)
        x = x + lyr.attn.o(_merge(torch.matmul(torch.softmax(logits, dim=-1), self_v[i])))
        c = lyr.cross
        x = x + c.o(_merge(_attn(c.heads(c.q(lyr.ln2(x))), cross_k[i], cross_v[i], scale)))
        x = x + lyr.decoder_mlp(x)
    return model.logits(x)[:, 0, :]


@torch.no_grad()
def greedy_decode(model: Moonshine, audio: torch.Tensor, max_new: int = 64):
    """audio [B, T] raw 16 kHz → (tokens [B, max_new], lengths [B]): the
    start token, then max_new - 1 cached steps with eos freezing."""
    cfg = model.cfg
    feats = encode(model, audio)
    B = feats.shape[0]
    max_len = 1 + max_new
    self_k = feats.new_zeros((cfg.dec_layers, B, cfg.heads, max_len, cfg.head_dim))
    self_v = torch.zeros_like(self_k)
    layers = model.dec.layers
    cross_k = torch.stack([lyr.cross.heads(lyr.cross.k(feats)) for lyr in layers])
    cross_v = torch.stack([lyr.cross.heads(lyr.cross.v(feats)) for lyr in layers])
    start = torch.full((B,), cfg.decoder_start, dtype=torch.long, device=feats.device)
    tok = _decode_step(model, start, 0, self_k, self_v, cross_k, cross_v, max_len).argmax(-1)
    done = tok == cfg.eos
    toks = [tok]
    for i in range(max_new - 1):
        logits = _decode_step(model, tok, i + 1, self_k, self_v, cross_k, cross_v, max_len)
        tok = torch.where(done, cfg.eos, logits.argmax(-1))
        done = done | (tok == cfg.eos)
        toks.append(tok)
    tokens = torch.stack(toks, dim=1)
    return tokens, _lengths(tokens, cfg.eos, max_new)


# ---------------------------------------------------------------------------
# Weights (numpy; the same dicts as the JAX package's)
# ---------------------------------------------------------------------------

def from_hf_state_dict(sd: Dict[str, np.ndarray]) -> Tuple[Dict[str, np.ndarray], MoonshineConfig]:
    def get(name):
        for k in (name, f"model.{name}"):
            if k in sd:
                return np.asarray(sd[k]).astype(np.float32)
        raise KeyError(name)

    emb = get("decoder.embed_tokens.weight")
    d = emb.shape[1]
    n_enc = sum(1 for k in sd if k.endswith(".self_attn.q_proj.weight") and "encoder" in k)
    n_dec = sum(1 for k in sd if k.endswith(".self_attn.q_proj.weight") and "decoder" in k)
    # production checkpoints use 8 heads (head_dim 36/52); fall back to ~32-dim heads
    heads = {288: 8, 416: 8}.get(d, max(1, d // 32))
    cfg = MoonshineConfig(vocab_size=emb.shape[0], hidden_size=d,
                          intermediate_size=get("decoder.layers.0.mlp.fc2.weight").shape[1],
                          enc_layers=n_enc, dec_layers=n_dec, heads=heads)

    p: Dict[str, np.ndarray] = {
        # torch conv1d [out, in, k] → [k, in, out]
        "enc.conv1.w": get("encoder.conv1.weight").transpose(2, 1, 0),
        "enc.conv2.w": get("encoder.conv2.weight").transpose(2, 1, 0),
        "enc.conv2.b": get("encoder.conv2.bias"),
        "enc.conv3.w": get("encoder.conv3.weight").transpose(2, 1, 0),
        "enc.conv3.b": get("encoder.conv3.bias"),
        "enc.gn.g": get("encoder.groupnorm.weight"),
        "enc.gn.b": get("encoder.groupnorm.bias"),
        "enc.ln.g": get("encoder.layer_norm.weight"),
        "dec.emb": emb,
        "dec.ln.g": get("decoder.norm.weight"),
        "proj_out.w": np.asarray(sd["proj_out.weight"]).astype(np.float32),
    }
    for side, n, t_side in (("enc", n_enc, "encoder"), ("dec", n_dec, "decoder")):
        for i in range(n):
            t = f"{t_side}.layers.{i}"
            for ours, theirs in (("attn", "self_attn"),) + ((("cross", "encoder_attn"),) if side == "dec" else ()):
                for proj in ("q", "k", "v", "o"):
                    p[f"{side}.{i}.{ours}.{proj}.w"] = get(f"{t}.{theirs}.{proj}_proj.weight").T
            p[f"{side}.{i}.mlp.fc1.w"] = get(f"{t}.mlp.fc1.weight").T
            p[f"{side}.{i}.mlp.fc1.b"] = get(f"{t}.mlp.fc1.bias")
            p[f"{side}.{i}.mlp.fc2.w"] = get(f"{t}.mlp.fc2.weight").T
            p[f"{side}.{i}.mlp.fc2.b"] = get(f"{t}.mlp.fc2.bias")
            p[f"{side}.{i}.ln1.g"] = get(f"{t}.input_layernorm.weight")
            p[f"{side}.{i}.ln2.g"] = get(f"{t}.post_attention_layernorm.weight")
            if side == "dec":
                p[f"{side}.{i}.ln3.g"] = get(f"{t}.final_layernorm.weight")
    cos, sin = _rope_tables(cfg, 2048)
    p["rope_cos"], p["rope_sin"] = cos, sin
    return p, cfg


def init_random(cfg: MoonshineConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)

    d, it = cfg.hidden_size, cfg.intermediate_size
    p = {
        "enc.conv1.w": w(127, 1, d), "enc.conv2.w": w(7, d, 2 * d),
        "enc.conv2.b": np.zeros(2 * d, np.float32),
        "enc.conv3.w": w(3, 2 * d, d), "enc.conv3.b": np.zeros(d, np.float32),
        "enc.gn.g": np.ones(d, np.float32), "enc.gn.b": np.zeros(d, np.float32),
        "enc.ln.g": np.ones(d, np.float32),
        "dec.emb": (rng.standard_normal((cfg.vocab_size, d)) * 0.02).astype(np.float32),
        "dec.ln.g": np.ones(d, np.float32),
        "proj_out.w": (rng.standard_normal((cfg.vocab_size, d)) * 0.02).astype(np.float32),
    }
    for side, n in (("enc", cfg.enc_layers), ("dec", cfg.dec_layers)):
        for i in range(n):
            for blk in ("attn",) + (("cross",) if side == "dec" else ()):
                for proj in ("q", "k", "v", "o"):
                    p[f"{side}.{i}.{blk}.{proj}.w"] = w(d, d)
            p[f"{side}.{i}.mlp.fc1.w"] = w(d, it * (2 if side == "dec" else 1))
            p[f"{side}.{i}.mlp.fc1.b"] = np.zeros(it * (2 if side == "dec" else 1), np.float32)
            p[f"{side}.{i}.mlp.fc2.w"] = w(it, d)
            p[f"{side}.{i}.mlp.fc2.b"] = np.zeros(d, np.float32)
            p[f"{side}.{i}.ln1.g"] = np.ones(d, np.float32)
            p[f"{side}.{i}.ln2.g"] = np.ones(d, np.float32)
            if side == "dec":
                p[f"{side}.{i}.ln3.g"] = np.ones(d, np.float32)
    cos, sin = _rope_tables(cfg, 2048)
    p["rope_cos"], p["rope_sin"] = cos, sin
    return p


class MoonshineModel:
    """Bundled Moonshine on one device (default: the card) with the batched
    transcribe surface."""

    def __init__(self, params, cfg: MoonshineConfig, tokenizer=None, name="moonshine",
                 device=None):
        self.device = resolve_device(device)
        self.model = params_to_module(params, cfg, self.device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.name = name

    @staticmethod
    def from_hf(path, name: Optional[str] = None, device=None) -> "MoonshineModel":
        path = Path(path)
        params, cfg = from_hf_state_dict(load_hf_state_dict(path))
        return MoonshineModel(params, cfg, hf_tokenizer(path), name or path.name, device)

    def transcribe_chunks(self, audio_16k, language: str = "en",
                          max_new: int = 224) -> List[str]:
        """[B, T] chunks, a numpy array or a tensor (one on the model's
        device is never round-tripped through the host) → texts."""
        if not isinstance(audio_16k, torch.Tensor):
            audio_16k = torch.from_numpy(np.asarray(audio_16k, np.float32))
        a = torch.atleast_2d(audio_16k).to(self.device, torch.float32)
        tokens, lengths = greedy_decode(self.model, a, max_new=max_new)
        tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
        out = []
        for b in range(a.shape[0]):
            ids = tokens[b, : lengths[b]].tolist()
            if self.tokenizer is not None:
                out.append(self.tokenizer.decode(ids))
            else:
                out.append(" ".join(map(str, ids)))
        return out
