"""Parakeet (FastConformer) ASR in PyTorch.

The port of ``crispy_tpu/models/parakeet/__init__.py``, the reference's
recommended-first model family (parakeet-tdt-0.6b-v2/v3,
managers/model.rs:153-190), on the public architecture:

  encoder (FastConformer): mel [B, T, 80] → 8x conv2d subsampling (relu,
      depthwise-separable) → linear → x sqrt(d) → conformer blocks
      (half-step FFN · Transformer-XL relative-position attention with
      global content/position biases · GLU-depthwise-BN-silu conv module ·
      half-step FFN · LayerNorm), interleaved sin/cos relative encodings.
  CTC head: 1x1 conv to vocab+blank; greedy collapse decode.
  TDT head (token-and-duration transducer): LSTM prediction network +
      additive joint with separate token/duration logits; greedy decode
      advances time by the predicted duration (Xu et al., 2023).

The weights live in a ``Parakeet`` module (``params_to_module`` carries the
JAX package's flat params into it); the decoders are plain functions. The
TDT loop runs on the device with no host sync but one check every
``TDT_SYNC_EVERY`` iterations.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..carry import load_params


@dataclass(frozen=True)
class ParakeetConfig:
    n_mels: int = 80
    hidden_size: int = 1024
    layers: int = 24
    heads: int = 8
    kv_heads: int = 8
    intermediate_size: int = 4096
    conv_kernel: int = 9
    sub_channels: int = 256
    sub_factor: int = 8
    vocab_size: int = 1025  # incl. blank (last id)
    # TDT decoder
    pred_hidden: int = 640
    joint_hidden: int = 640
    durations: Tuple[int, ...] = (0, 1, 2, 3, 4)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.heads

    @property
    def blank_id(self) -> int:
        return self.vocab_size - 1


CONFIGS = {
    "parakeet-tdt-0.6b": ParakeetConfig(hidden_size=1024, layers=24, heads=8,
                                        intermediate_size=4096, vocab_size=1025),
    "test-random": ParakeetConfig(hidden_size=64, layers=2, heads=2, kv_heads=2,
                                  intermediate_size=128, sub_channels=32,
                                  vocab_size=128, pred_hidden=32, joint_hidden=32),
}

#: Iterations of the TDT loop between two host checks of its end.
TDT_SYNC_EVERY = 32


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

class SepConv(nn.Module):
    """A depthwise stride-2 3x3 conv, then a pointwise one (relu after)."""

    def __init__(self, c: int):
        super().__init__()
        self.dw = nn.Conv2d(c, c, 3, stride=2, padding=1, groups=c)
        self.pw = nn.Conv2d(c, c, 1)

    def forward(self, x):
        return F.relu(self.pw(self.dw(x)))


class Subsampling(nn.Module):
    """mel [B, T, n_mels] → [B, T/8, d] via log2(sub_factor) stride-2 stages."""

    def __init__(self, cfg: ParakeetConfig):
        super().__init__()
        C = cfg.sub_channels
        n_stages = int(np.log2(cfg.sub_factor))
        self.layers = nn.ModuleList(
            [nn.Conv2d(1, C, 3, stride=2, padding=1)] + [SepConv(C) for _ in range(n_stages - 1)])
        self.linear = nn.Linear(C * (cfg.n_mels // cfg.sub_factor), cfg.hidden_size)

    def forward(self, mel):
        x = F.relu(self.layers[0](mel[:, None]))  # NCHW: [B, C, T', M']
        for stage in self.layers[1:]:
            x = stage(x)
        B, C, T, M = x.shape
        # torch flattens channel-major: [B, T', C, M'] → [B, T', C*M']
        return self.linear(x.permute(0, 2, 1, 3).reshape(B, T, C * M))


def _rel_pos_embed(cfg: ParakeetConfig, T: int) -> np.ndarray:
    """Interleaved sin/cos over positions T-1 .. -(T-1): [2T-1, d]."""
    d = cfg.hidden_size
    inv = 1.0 / (10000.0 ** (np.arange(0, d, 2, dtype=np.float64) / d))
    pos = np.arange(T - 1, -T, -1, dtype=np.float64)
    fr = pos[:, None] * inv[None, :]
    emb = np.stack([np.sin(fr), np.cos(fr)], axis=-1).reshape(2 * T - 1, d)
    return emb.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _rel_pos_on(d: int, T: int, device: torch.device) -> torch.Tensor:
    """_rel_pos_embed at width d on device, made once per length: an upload
    per call would stall the host on the card."""
    return torch.from_numpy(_rel_pos_embed(ParakeetConfig(hidden_size=d), T)).to(device)


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL relative shift: [B, H, T, P] with P = 2T-1."""
    B, H, T, P = x.shape
    x = F.pad(x, (1, 0))
    x = x.reshape(B, H, P + 1, T)[:, :, 1:, :]
    return x.reshape(B, H, T, P)


class RelPosAttention(nn.Module):
    def __init__(self, cfg: ParakeetConfig):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.head_dim
        self.heads, self.kv_heads, self.hd = cfg.heads, cfg.kv_heads, hd
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, cfg.kv_heads * hd)
        self.v = nn.Linear(d, cfg.kv_heads * hd)
        self.o = nn.Linear(d, d)
        self.rel_k = nn.Linear(d, d, bias=False)
        self.bias_u = nn.Parameter(torch.empty(cfg.heads, hd))
        self.bias_v = nn.Parameter(torch.empty(cfg.heads, hd))

    def forward(self, x, pos_embed):
        B, T, _ = x.shape
        H, hd = self.heads, self.hd
        scale = hd ** -0.5

        def heads(t, n):
            return t.reshape(B, T, n, hd).transpose(1, 2)

        q = heads(self.q(x), H)
        k = heads(self.k(x), self.kv_heads)
        v = heads(self.v(x), self.kv_heads)
        if self.kv_heads != H:
            k = k.repeat_interleave(H // self.kv_heads, dim=1)
            v = v.repeat_interleave(H // self.kv_heads, dim=1)
        rel_k = self.rel_k(pos_embed).reshape(-1, H, hd).permute(1, 2, 0)  # [H, hd, 2T-1]
        qu = q + self.bias_u[None, :, None, :]
        qv = q + self.bias_v[None, :, None, :]
        ac = torch.matmul(qu, k.transpose(-1, -2)) * scale
        bd = _rel_shift(torch.matmul(qv, rel_k))[..., :T] * scale
        w = torch.softmax(ac + bd, dim=-1)
        o = torch.matmul(w, v).transpose(1, 2).reshape(B, T, H * hd)
        return self.o(o)


class BatchNormInference(nn.Module):
    """BatchNorm over channels with running statistics (inference mode)."""

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d))
        self.bias = nn.Parameter(torch.empty(d))
        self.mean = nn.Parameter(torch.empty(d))
        self.var = nn.Parameter(torch.empty(d))

    def forward(self, h):
        return (h - self.mean) * torch.rsqrt(self.var + 1e-5) * self.weight + self.bias


class ConvModule(nn.Module):
    def __init__(self, cfg: ParakeetConfig):
        super().__init__()
        d, k = cfg.hidden_size, cfg.conv_kernel
        self.pw1 = nn.Linear(d, 2 * d)
        self.dw = nn.Conv1d(d, d, k, padding=(k - 1) // 2, groups=d)
        self.bn = BatchNormInference(d)
        self.pw2 = nn.Linear(d, d)

    def forward(self, x):
        h = F.glu(self.pw1(x), dim=-1)  # a * sigmoid(b) over the channel halves
        h = self.dw(h.transpose(1, 2)).transpose(1, 2)
        return self.pw2(F.silu(self.bn(h)))


class FeedForward(nn.Module):
    def __init__(self, d: int, it: int):
        super().__init__()
        self.fc1 = nn.Linear(d, it)
        self.fc2 = nn.Linear(it, d)

    def forward(self, x):
        return self.fc2(F.silu(self.fc1(x)))


class ConformerBlock(nn.Module):
    def __init__(self, cfg: ParakeetConfig):
        super().__init__()
        d = cfg.hidden_size
        self.ff1 = FeedForward(d, cfg.intermediate_size)
        self.attn = RelPosAttention(cfg)
        self.conv = ConvModule(cfg)
        self.ff2 = FeedForward(d, cfg.intermediate_size)
        for ln in ("ln_ff1", "ln_att", "ln_conv", "ln_ff2", "ln_out"):
            setattr(self, ln, nn.LayerNorm(d, eps=1e-5))

    def forward(self, x, pos):
        x = x + 0.5 * self.ff1(self.ln_ff1(x))
        x = x + self.attn(self.ln_att(x), pos)
        x = x + self.conv(self.ln_conv(x))
        x = x + 0.5 * self.ff2(self.ln_ff2(x))
        return self.ln_out(x)


class Encoder(nn.Module):
    def __init__(self, cfg: ParakeetConfig):
        super().__init__()
        self.layers = nn.ModuleList(ConformerBlock(cfg) for _ in range(cfg.layers))


class PredictionNet(nn.Module):
    """The TDT prediction network: token embedding + one LSTM cell."""

    def __init__(self, cfg: ParakeetConfig):
        super().__init__()
        P = cfg.pred_hidden
        self.emb = nn.Parameter(torch.empty(cfg.vocab_size, P))
        self.lstm = nn.ModuleDict({"ih": nn.Linear(P, 4 * P), "hh": nn.Linear(P, 4 * P)})

    def step(self, x, h, c):
        gates = self.lstm["ih"](x) + self.lstm["hh"](h)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c


class Joint(nn.Module):
    def __init__(self, cfg: ParakeetConfig):
        super().__init__()
        d, J = cfg.hidden_size, cfg.joint_hidden
        self.enc = nn.Linear(d, J)
        self.pred = nn.Linear(cfg.pred_hidden, J)
        self.out = nn.Linear(J, cfg.vocab_size + len(cfg.durations))


class Parakeet(nn.Module):
    """The encoder, with the CTC head and the TDT heads where the params
    hold them (init_random: both; an HF CTC checkpoint: CTC only)."""

    def __init__(self, cfg: ParakeetConfig, ctc: bool = True, tdt: bool = True):
        super().__init__()
        self.cfg = cfg
        self.sub = Subsampling(cfg)
        self.enc = Encoder(cfg)
        if ctc:
            self.ctc = nn.Linear(cfg.hidden_size, cfg.vocab_size)
        if tdt:
            self.pred = PredictionNet(cfg)
            self.joint = Joint(cfg)

    def forward(self, mel):
        """mel [B, T, n_mels] → [B, T/8, d]."""
        x = self.sub(mel) * float(np.float32(np.sqrt(self.cfg.hidden_size)))
        pos = _rel_pos_on(self.cfg.hidden_size, x.shape[1], x.device)
        for blk in self.enc.layers:
            x = blk(x, pos)
        return x


def params_to_module(params: Dict[str, np.ndarray], cfg: ParakeetConfig,
                     device=None) -> Parakeet:
    """The JAX package's flat params (what ``params.npz`` holds) carried into
    a ``Parakeet`` on ``device`` (default: the card), with the heads the
    params hold."""
    ctc, tdt = "ctc.w" in params, "joint.out.w" in params
    return load_params(lambda: Parakeet(cfg, ctc=ctc, tdt=tdt), params, device)


@torch.no_grad()
def encode(model: Parakeet, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, T, n_mels] → [B, T/8, d]."""
    return model(mel)


# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------

@torch.no_grad()
def ctc_logits(model: Parakeet, mel: torch.Tensor) -> torch.Tensor:
    return model.ctc(model(mel))


def ctc_greedy(logits, blank_id: int) -> List[List[int]]:
    """argmax → collapse repeats → drop blanks. logits: a tensor on any
    device or an array, [B, T, V] or [T, V]."""
    if isinstance(logits, torch.Tensor):
        ids = logits.argmax(-1).cpu().numpy()
    else:
        ids = np.asarray(logits).argmax(-1)
    out = []
    for row in np.atleast_2d(ids):
        toks, prev = [], -1
        for t in row:
            if t != prev and t != blank_id:
                toks.append(int(t))
            prev = t
        out.append(toks)
    return out


# ---------------------------------------------------------------------------
# TDT transducer (prediction LSTM + additive joint + duration head)
# ---------------------------------------------------------------------------

def tdt_init(model: Parakeet, enc: torch.Tensor, max_symbols: int) -> dict:
    """The TDT loop's state for enc [B, T, d]: the joint's encoder half of
    every frame (computed once), frame pointers, LSTM state, token slots
    (all blank) and their counts."""
    cfg = model.cfg
    B = enc.shape[0]
    dev = enc.device
    zeros = enc.new_zeros((B, cfg.pred_hidden))
    return {"enc_j": model.joint.enc(enc), "T": enc.shape[1], "max_symbols": max_symbols,
            "rows": torch.arange(B, device=dev),
            "durs": torch.tensor(cfg.durations, dtype=torch.long, device=dev),
            "t": torch.zeros(B, dtype=torch.long, device=dev), "h": zeros, "c": zeros.clone(),
            "toks": torch.full((B, max_symbols), cfg.blank_id, dtype=torch.long, device=dev),
            "n": torch.zeros(B, dtype=torch.long, device=dev),
            "iters": torch.zeros((), dtype=torch.long, device=dev)}


def tdt_step(model: Parakeet, s: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """One iteration of the JAX package's ``lax.while_loop`` body, updating
    the state ``s`` in place; returns the token and duration logits.

    The whole update is gated by the loop's condition taken on the device at
    the top of the iteration, ``any(t < T)`` (the caller's Python loop
    bounds the count at T + max_symbols): an iteration after the end
    changes nothing. Without the gate it would write blank into the last
    slot of a row that already holds max_symbols tokens."""
    cfg = model.cfg
    T, blank, ms = s["T"], cfg.blank_id, s["max_symbols"]
    t, h, c, toks, n, rows = s["t"], s["h"], s["c"], s["toks"], s["n"], s["rows"]
    go = (t < T).any()
    enc_t = s["enc_j"][rows, t.clamp(max=T - 1)]
    out = model.joint.out(F.relu(enc_t + model.joint.pred(h)))
    tok_logits, dur_logits = out[:, : cfg.vocab_size], out[:, cfg.vocab_size:]
    tok = tok_logits.argmax(-1)
    dur = s["durs"][dur_logits.argmax(-1)]
    active = (t < T) & go
    emit = active & (tok != blank)
    # the prediction network advances on emission
    h2, c2 = model.pred.step(model.pred.emb[torch.where(emit, tok, 0)], h, c)
    s["h"] = torch.where(emit[:, None], h2, h)
    s["c"] = torch.where(emit[:, None], c2, c)
    slot = n.clamp(max=ms - 1)[:, None]
    toks.scatter_(1, slot, torch.where(go, torch.where(emit, tok, blank)[:, None],
                                       toks.gather(1, slot)))
    s["n"] = (n + emit.long()).clamp(max=ms)
    # time advances by the duration (>= 1 forced on blank-with-0 to progress)
    s["t"] = t + torch.where(active, torch.maximum(dur, (~emit).long()), 0)
    s["iters"] = s["iters"] + go.long()
    return tok_logits, dur_logits


@torch.no_grad()
def tdt_decode(model: Parakeet, enc: torch.Tensor, max_symbols: int = 256):
    """Batched greedy TDT decode of encoder output enc [B, T, d]: time
    advances by the predicted duration; the prediction LSTM advances only
    on non-blank emissions. Returns (tokens [B, max_symbols], counts [B],
    iterations run) as tensors on enc's device.

    Every frame may emit up to about max_symbols tokens plus one advancing
    blank, so the loop runs at most T + max_symbols iterations. The host
    reads whether any row is still active once every ``TDT_SYNC_EVERY``
    iterations: at most (T + max_symbols) / TDT_SYNC_EVERY syncs a batch,
    and up to TDT_SYNC_EVERY - 1 gated iterations past the end."""
    s = tdt_init(model, enc, max_symbols)
    T = s["T"]
    for it in range(T + max_symbols):
        tdt_step(model, s)
        if it % TDT_SYNC_EVERY == TDT_SYNC_EVERY - 1 and not bool((s["t"] < T).any()):
            break
    return s["toks"], s["n"], s["iters"]


@torch.no_grad()
def tdt_greedy_decode(model: Parakeet, mel: torch.Tensor, max_symbols: int = 256):
    """mel [B, T, n_mels] → (tokens [B, max_symbols], counts [B])."""
    toks, n, _ = tdt_decode(model, model(mel), max_symbols)
    return toks, n


# ---------------------------------------------------------------------------
# Weights (numpy; the same dicts as the JAX package's)
# ---------------------------------------------------------------------------

def from_hf_ctc_state_dict(sd: Dict[str, np.ndarray]) -> Tuple[Dict[str, np.ndarray], ParakeetConfig]:
    """Map transformers ParakeetForCTC weights to our schema."""
    def get(name):
        for k in (name, f"model.{name}"):
            if k in sd:
                return np.asarray(sd[k]).astype(np.float32)
        raise KeyError(name)

    sub0 = get("encoder.subsampling.layers.0.weight")  # [C, 1, k, k]
    C = sub0.shape[0]
    lin = get("encoder.subsampling.linear.weight")
    d = lin.shape[0]
    n_layers = sum(1 for k in sd if k.endswith(".self_attn.q_proj.weight"))
    heads_bias = get("encoder.layers.0.self_attn.bias_u")
    H, hd = heads_bias.shape
    kv = get("encoder.layers.0.self_attn.k_proj.weight").shape[0] // hd
    ctc_w = get("ctc_head.weight")  # [V, d, 1]
    cfg = ParakeetConfig(
        hidden_size=d, layers=n_layers, heads=H, kv_heads=kv,
        intermediate_size=get("encoder.layers.0.feed_forward1.linear1.weight").shape[0],
        conv_kernel=get("encoder.layers.0.conv.depthwise_conv.weight").shape[-1],
        sub_channels=C, vocab_size=ctc_w.shape[0],
    )

    p: Dict[str, np.ndarray] = {
        # torch conv2d [out, in, kh, kw] → HWIO
        "sub.0.w": sub0.transpose(2, 3, 1, 0), "sub.0.b": get("encoder.subsampling.layers.0.bias"),
        "sub.linear.w": lin.T, "sub.linear.b": get("encoder.subsampling.linear.bias"),
        "ctc.w": ctc_w[:, :, 0].T, "ctc.b": get("ctc_head.bias"),
    }
    # remaining subsampling stages at module indices 2,3 / 5,6 (relu between)
    n_stages = int(np.log2(cfg.sub_factor))
    for i in range(1, n_stages):
        base = 3 * i - 1
        p[f"sub.{i}.dw.w"] = get(f"encoder.subsampling.layers.{base}.weight").transpose(2, 3, 1, 0)
        p[f"sub.{i}.dw.b"] = get(f"encoder.subsampling.layers.{base}.bias")
        p[f"sub.{i}.pw.w"] = get(f"encoder.subsampling.layers.{base + 1}.weight").transpose(2, 3, 1, 0)
        p[f"sub.{i}.pw.b"] = get(f"encoder.subsampling.layers.{base + 1}.bias")

    for i in range(n_layers):
        t = f"encoder.layers.{i}"
        o = f"enc.{i}"
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "o_proj")):
            p[f"{o}.attn.{ours}.w"] = get(f"{t}.self_attn.{theirs}.weight").T
            p[f"{o}.attn.{ours}.b"] = get(f"{t}.self_attn.{theirs}.bias")
        p[f"{o}.attn.rel_k.w"] = get(f"{t}.self_attn.relative_k_proj.weight").T
        p[f"{o}.attn.bias_u"] = get(f"{t}.self_attn.bias_u")
        p[f"{o}.attn.bias_v"] = get(f"{t}.self_attn.bias_v")
        for ff, tff in (("ff1", "feed_forward1"), ("ff2", "feed_forward2")):
            p[f"{o}.{ff}.fc1.w"] = get(f"{t}.{tff}.linear1.weight").T
            p[f"{o}.{ff}.fc1.b"] = get(f"{t}.{tff}.linear1.bias")
            p[f"{o}.{ff}.fc2.w"] = get(f"{t}.{tff}.linear2.weight").T
            p[f"{o}.{ff}.fc2.b"] = get(f"{t}.{tff}.linear2.bias")
        p[f"{o}.conv.pw1.w"] = get(f"{t}.conv.pointwise_conv1.weight")[:, :, 0].T
        p[f"{o}.conv.pw1.b"] = get(f"{t}.conv.pointwise_conv1.bias")
        # torch depthwise conv1d [C, 1, k] → HIO [k, 1, C]
        p[f"{o}.conv.dw.w"] = get(f"{t}.conv.depthwise_conv.weight").transpose(2, 1, 0)
        p[f"{o}.conv.dw.b"] = get(f"{t}.conv.depthwise_conv.bias")
        p[f"{o}.conv.bn.g"] = get(f"{t}.conv.norm.weight")
        p[f"{o}.conv.bn.b"] = get(f"{t}.conv.norm.bias")
        p[f"{o}.conv.bn.mean"] = get(f"{t}.conv.norm.running_mean")
        p[f"{o}.conv.bn.var"] = get(f"{t}.conv.norm.running_var")
        p[f"{o}.conv.pw2.w"] = get(f"{t}.conv.pointwise_conv2.weight")[:, :, 0].T
        p[f"{o}.conv.pw2.b"] = get(f"{t}.conv.pointwise_conv2.bias")
        for ln, tln in (("ln_ff1", "norm_feed_forward1"), ("ln_att", "norm_self_att"),
                        ("ln_conv", "norm_conv"), ("ln_ff2", "norm_feed_forward2"),
                        ("ln_out", "norm_out")):
            p[f"{o}.{ln}.g"] = get(f"{t}.{tln}.weight")
            p[f"{o}.{ln}.b"] = get(f"{t}.{tln}.bias")
    return p, cfg


def init_random(cfg: ParakeetConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random params for tests: encoder + CTC + TDT heads."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(max(shape[0], 1))).astype(np.float32)

    d, C, it = cfg.hidden_size, cfg.sub_channels, cfg.intermediate_size
    mel_out = cfg.n_mels // cfg.sub_factor
    p = {
        "sub.0.w": w(3, 3, 1, C), "sub.0.b": np.zeros(C, np.float32),
        "sub.linear.w": w(C * mel_out, d), "sub.linear.b": np.zeros(d, np.float32),
        "ctc.w": w(d, cfg.vocab_size), "ctc.b": np.zeros(cfg.vocab_size, np.float32),
        "pred.emb": w(cfg.vocab_size, cfg.pred_hidden),
        "pred.lstm.ih.w": w(cfg.pred_hidden, 4 * cfg.pred_hidden),
        "pred.lstm.ih.b": np.zeros(4 * cfg.pred_hidden, np.float32),
        "pred.lstm.hh.w": w(cfg.pred_hidden, 4 * cfg.pred_hidden),
        "pred.lstm.hh.b": np.zeros(4 * cfg.pred_hidden, np.float32),
        "joint.enc.w": w(d, cfg.joint_hidden), "joint.enc.b": np.zeros(cfg.joint_hidden, np.float32),
        "joint.pred.w": w(cfg.pred_hidden, cfg.joint_hidden),
        "joint.pred.b": np.zeros(cfg.joint_hidden, np.float32),
        "joint.out.w": w(cfg.joint_hidden, cfg.vocab_size + len(cfg.durations)),
        "joint.out.b": np.zeros(cfg.vocab_size + len(cfg.durations), np.float32),
    }
    for i in range(1, int(np.log2(cfg.sub_factor))):
        p[f"sub.{i}.dw.w"] = w(3, 3, 1, C)
        p[f"sub.{i}.dw.b"] = np.zeros(C, np.float32)
        p[f"sub.{i}.pw.w"] = w(1, 1, C, C)
        p[f"sub.{i}.pw.b"] = np.zeros(C, np.float32)
    for i in range(cfg.layers):
        o = f"enc.{i}"
        for proj in ("q", "o"):
            p[f"{o}.attn.{proj}.w"] = w(d, d)
            p[f"{o}.attn.{proj}.b"] = np.zeros(d, np.float32)
        for proj in ("k", "v"):
            p[f"{o}.attn.{proj}.w"] = w(d, cfg.kv_heads * cfg.head_dim)
            p[f"{o}.attn.{proj}.b"] = np.zeros(cfg.kv_heads * cfg.head_dim, np.float32)
        p[f"{o}.attn.rel_k.w"] = w(d, d)
        p[f"{o}.attn.bias_u"] = np.zeros((cfg.heads, cfg.head_dim), np.float32)
        p[f"{o}.attn.bias_v"] = np.zeros((cfg.heads, cfg.head_dim), np.float32)
        for ff in ("ff1", "ff2"):
            p[f"{o}.{ff}.fc1.w"] = w(d, it)
            p[f"{o}.{ff}.fc1.b"] = np.zeros(it, np.float32)
            p[f"{o}.{ff}.fc2.w"] = w(it, d)
            p[f"{o}.{ff}.fc2.b"] = np.zeros(d, np.float32)
        p[f"{o}.conv.pw1.w"] = w(d, 2 * d)
        p[f"{o}.conv.pw1.b"] = np.zeros(2 * d, np.float32)
        p[f"{o}.conv.dw.w"] = w(cfg.conv_kernel, 1, d)
        p[f"{o}.conv.dw.b"] = np.zeros(d, np.float32)
        p[f"{o}.conv.bn.g"] = np.ones(d, np.float32)
        p[f"{o}.conv.bn.b"] = np.zeros(d, np.float32)
        p[f"{o}.conv.bn.mean"] = np.zeros(d, np.float32)
        p[f"{o}.conv.bn.var"] = np.ones(d, np.float32)
        p[f"{o}.conv.pw2.w"] = w(d, d)
        p[f"{o}.conv.pw2.b"] = np.zeros(d, np.float32)
        for ln in ("ln_ff1", "ln_att", "ln_conv", "ln_ff2", "ln_out"):
            p[f"{o}.{ln}.g"] = np.ones(d, np.float32)
            p[f"{o}.{ln}.b"] = np.zeros(d, np.float32)
    return p
