"""Plain PyTorch Canary: the canary cell's reference.

NVIDIA's Canary-1B-v2 (arXiv:2509.14128; the model card at
https://huggingface.co/nvidia/canary-1b-v2): a FastConformer encoder and a
Transformer decoder with cross-attention (attention encoder-decoder),
written from the published equations as a teacher-forced forward in
float32 with TF32 off, with no cache, no batching tricks and nothing of the
program:

    log-mel (NeMo's preprocessor): pre-emphasis 0.97; a reflect-padded
        512-point STFT of a 400-sample Hann window centred in the 512, hop
        160; |.|^2; slaney mel filters; log(x + 2^-24); each feature less
        its mean over the chunk's frames, over its unbiased standard
        deviation plus 1e-5
    encoder (FastConformer): conv2d(3x3, s2) → relu → (log2(factor) - 1) ×
        [depthwise conv2d(3x3, s2) → pointwise conv2d → relu] → channels and
        mel bins flattened channel-major → linear → × sqrt(d), then blocks
            x + ½ FFN(LN x); x + RelAttention(LN x); x + Conv(LN x);
            x + ½ FFN(LN x); LN
        FFN: linear → SiLU → linear. RelAttention (Transformer-XL, Dai et
        al. 2019): score(i, j) = ((q_i + u)·k_j + (q_i + v)·W_pos r_{i-j})
        / sqrt(hd), r the interleaved sin/cos of the relative position i - j
        (here gathered at i - j directly; no shift trick). Conv: pointwise
        d → 2d → GLU → depthwise conv1d (k, same padding) → BatchNorm with
        running statistics → SiLU → pointwise.
    decoder: token embedding × sqrt(d) + a position table → pre-LN blocks
        (causal self-attention, cross-attention over the encoder output,
        FFN with relu; attention logits over sqrt(hd)) → LN → x @ emb^T

Where the configuration departs from NeMo's published Canary (this file
follows the configuration; ``configs/canary-1b-v2.json`` lists the same):
the decoder scales the token embedding by sqrt(d) and has no LayerNorm
after the embedding sum (NeMo adds the token embedding to sinusoids over
sqrt(d) and normalises the sum); the output head is the embedding with no
bias (NeMo's classifier has a bias); the log-mel's Hann window is periodic
and the STFT reflect-padded (NeMo: a symmetric window, zero padding); the
encoder takes no padding mask (every chunk here is a whole 30 s).

``tf32=True`` rounds every operand of a product (convolutions, linear
layers, attention, the mel filters) to TensorFloat-32's 10-bit mantissa:
the control.

Weights are a dict of tensors named as in ``layout``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 512
WIN = 400
HOP = 160
PREEMPH = 0.97
LOG_GUARD = 2.0 ** -24
NORM_EPS = 1e-5
LN_EPS = 1e-5
BN_EPS = 1e-5


@dataclass(frozen=True)
class Shape:
    n_mels: int
    d_model: int
    enc_layers: int
    enc_heads: int
    enc_ffn: int
    conv_kernel: int
    sub_channels: int
    sub_factor: int
    dec_layers: int
    dec_heads: int
    dec_ffn: int
    n_vocab: int
    max_len: int

    @property
    def sub_stages(self) -> int:
        return int(round(math.log2(self.sub_factor)))


def shape_of(c: dict) -> Shape:
    """The widths of a configuration file (``configs/canary-1b-v2.json``)."""
    e, d = c["encoder"], c["decoder"]
    if e["d_model"] != d["hidden_size"]:
        raise ValueError("the encoder and decoder widths differ: an enc_proj is not modelled here")
    return Shape(n_mels=e["n_mels"], d_model=e["d_model"], enc_layers=e["n_layers"],
                 enc_heads=e["n_heads"], enc_ffn=e["ff_dim"], conv_kernel=e["conv_kernel_size"],
                 sub_channels=e["subsampling_conv_channels"], sub_factor=e["subsampling_factor"],
                 dec_layers=d["n_layers"], dec_heads=d["n_heads"], dec_ffn=d["inner_size"],
                 n_vocab=c["vocab_size"], max_len=d["max_sequence_length"])


def layout(s: Shape) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every weight as (name, shape, kind), in a fixed order. Kinds: "w" a
    matrix or kernel drawn with std 1/sqrt(fan in), "b" a bias (std 0.02),
    "g" a LayerNorm or BatchNorm gain (1 + std 0.02), "emb" std 0.02, "mean"
    a BatchNorm running mean (std 0.1), "var" its running variance
    (exp(N(0, 0.5^2))), "sin" the decoder's position table (not drawn)."""
    d, C, out = s.d_model, s.sub_channels, []

    def lin(name, din, dout, bias=True):
        out.append((f"{name}.weight", (dout, din), "w"))
        if bias:
            out.append((f"{name}.bias", (dout,), "b"))

    def ln(name):
        out.append((f"{name}.weight", (d,), "g"))
        out.append((f"{name}.bias", (d,), "b"))

    sub = "encoder.sub"
    out.append((f"{sub}.layers.0.weight", (C, 1, 3, 3), "w"))
    out.append((f"{sub}.layers.0.bias", (C,), "b"))
    for i in range(1, s.sub_stages):
        out.append((f"{sub}.layers.{i}.dw.weight", (C, 1, 3, 3), "w"))
        out.append((f"{sub}.layers.{i}.dw.bias", (C,), "b"))
        out.append((f"{sub}.layers.{i}.pw.weight", (C, C, 1, 1), "w"))
        out.append((f"{sub}.layers.{i}.pw.bias", (C,), "b"))
    lin(f"{sub}.linear", C * (s.n_mels // s.sub_factor), d)
    hd = d // s.enc_heads
    for i in range(s.enc_layers):
        p = f"encoder.enc.layers.{i}"
        for ff in ("ff1", "ff2"):
            lin(f"{p}.{ff}.fc1", d, s.enc_ffn)
            lin(f"{p}.{ff}.fc2", s.enc_ffn, d)
        for proj in ("q", "k", "v", "o"):
            lin(f"{p}.attn.{proj}", d, d)
        lin(f"{p}.attn.rel_k", d, d, bias=False)
        out.append((f"{p}.attn.bias_u", (s.enc_heads, hd), "b"))
        out.append((f"{p}.attn.bias_v", (s.enc_heads, hd), "b"))
        lin(f"{p}.conv.pw1", d, 2 * d)
        out.append((f"{p}.conv.dw.weight", (d, 1, s.conv_kernel), "w"))
        out.append((f"{p}.conv.dw.bias", (d,), "b"))
        out.append((f"{p}.conv.bn.weight", (d,), "g"))
        out.append((f"{p}.conv.bn.bias", (d,), "b"))
        out.append((f"{p}.conv.bn.mean", (d,), "mean"))
        out.append((f"{p}.conv.bn.var", (d,), "var"))
        lin(f"{p}.conv.pw2", d, d)
        for name in ("ln_ff1", "ln_att", "ln_conv", "ln_ff2", "ln_out"):
            ln(f"{p}.{name}")
    out.append(("dec.emb", (s.n_vocab, d), "emb"))
    out.append(("dec.pos", (s.max_len, d), "sin"))
    for i in range(s.dec_layers):
        p = f"dec.layers.{i}"
        ln(f"{p}.ln1")
        for proj in ("q", "k", "v", "o"):
            lin(f"{p}.attn.{proj}", d, d)
        ln(f"{p}.lnx")
        for proj in ("q", "k", "v", "o"):
            lin(f"{p}.cross.{proj}", d, d)
        ln(f"{p}.ln2")
        lin(f"{p}.fc1", d, s.dec_ffn)
        lin(f"{p}.fc2", s.dec_ffn, d)
    ln("dec.ln")
    return out


def n_params(s: Shape) -> int:
    """Drawn parameters (the position table is not one)."""
    return sum(math.prod(sh) for _, sh, kind in layout(s) if kind != "sin")


def sinusoids(length: int, d: int, device=None) -> torch.Tensor:
    """[length, d]: sin(t w_i) at even columns, cos(t w_i) at odd ones, with
    w_i = 10000^(-2i/d); t runs over ``length`` positions from 0."""
    return _interleaved(torch.arange(length, dtype=torch.float64, device=device), d)


def _interleaved(t: torch.Tensor, d: int) -> torch.Tensor:
    w = torch.exp(-math.log(10000.0) * torch.arange(0, d, 2, dtype=torch.float64,
                                                    device=t.device) / d)
    a = t[:, None] * w[None, :]
    return torch.stack([torch.sin(a), torch.cos(a)], dim=-1).reshape(t.shape[0], d).float()


def draw_weights(s: Shape, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``layout`` from ``seed``: one normal draw on the
    device for all of them, cut into views and scaled per kind."""
    entries = layout(s)
    total = sum(math.prod(sh) for _, sh, k in entries if k != "sin")
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, o = {}, 0
    for name, shape, kind in entries:
        if kind == "sin":
            out[name] = sinusoids(shape[0], shape[1], device)
            continue
        n = math.prod(shape)
        t = flat[o: o + n].view(shape)
        o += n
        if kind == "w":
            t.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
        elif kind == "g":
            t.mul_(0.02).add_(1.0)
        elif kind == "mean":
            t.mul_(0.1)
        elif kind == "var":
            t.mul_(0.5).exp_()
        else:  # "b", "emb"
            t.mul_(0.02)
        out[name] = t
    return out


# ---------------------------------------------------------------------------
# Log-mel frontend
# ---------------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-30) / 1000.0) / (np.log(6.4) / 27.0),
                    f / (200.0 / 3))


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), m * (200.0 / 3))


def mel_filters(n_mels: int, n_fft: int = N_FFT) -> np.ndarray:
    """[n_mels, n_fft/2 + 1] slaney-normalised triangles on the slaney mel
    scale from 0 to 8 kHz (librosa's ``filters.mel(sr=16000, n_fft,
    htk=False)``)."""
    freqs = np.linspace(0, SAMPLE_RATE / 2, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    fb = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    return (fb * (2.0 / (hz[2:] - hz[:-2]))[:, None]).astype(np.float32)


class Reference:
    """The teacher-forced forward over ``weights`` (see ``layout``)."""

    def __init__(self, s: Shape, weights: Dict[str, torch.Tensor], tf32: bool = False):
        # full float32 products on the card; the control rounds its operands itself
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.s, self.w, self.tf32 = s, weights, tf32
        dev = weights["dec.emb"].device
        n = torch.arange(WIN, dtype=torch.float64, device=dev)
        hann = 0.5 - 0.5 * torch.cos(2 * math.pi * n / WIN)  # periodic
        off = (N_FFT - WIN) // 2
        self.window = F.pad(hann, (off, N_FFT - WIN - off)).float()
        self.filters = torch.from_numpy(mel_filters(s.n_mels)).to(dev)

    # -- products ---------------------------------------------------------------
    def _r(self, x: torch.Tensor) -> torch.Tensor:
        if not self.tf32:
            return x
        b = x.float().contiguous().view(torch.int32)
        b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
        return b.view(torch.float32)

    def mm(self, a, b):
        return torch.matmul(self._r(a), self._r(b))

    def lin(self, x, name, bias=True):
        y = self.mm(x, self.w[f"{name}.weight"].t())
        return y + self.w[f"{name}.bias"] if bias else y

    def ln(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.w[f"{name}.weight"], self.w[f"{name}.bias"],
                            LN_EPS)

    def conv2d(self, x, name, stride, padding, groups=1):
        return F.conv2d(self._r(x), self._r(self.w[f"{name}.weight"]), self.w[f"{name}.bias"],
                        stride=stride, padding=padding, groups=groups)

    @staticmethod
    def split(x, n_head):  # [B, T, D] -> [B, H, T, hd]
        B, T, D = x.shape
        return x.view(B, T, n_head, D // n_head).transpose(1, 2)

    @staticmethod
    def merge(o):  # [B, H, T, hd] -> [B, T, D]
        B, H, T, hd = o.shape
        return o.transpose(1, 2).reshape(B, T, H * hd)

    # -- the frontend -------------------------------------------------------------
    def log_mel(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, samples] 16 kHz → [B, samples // 160 + 1, n_mels]."""
        x = audio.float()
        x = torch.cat([x[:, :1], x[:, 1:] - PREEMPH * x[:, :-1]], dim=1)
        xp = F.pad(x[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
        frames = xp.unfold(-1, N_FFT, HOP)
        spec = torch.fft.rfft(frames * self.window, dim=-1).abs() ** 2
        logmel = torch.log(self.mm(spec, self.filters.t()) + LOG_GUARD)
        mean = logmel.mean(dim=1, keepdim=True)
        std = logmel.std(dim=1, keepdim=True, unbiased=True)
        return (logmel - mean) / (std + NORM_EPS)

    # -- the encoder ----------------------------------------------------------------
    def subsample(self, feats: torch.Tensor) -> torch.Tensor:
        """[B, frames, n_mels] → [B, T, d]."""
        x = F.relu(self.conv2d(feats[:, None], "encoder.sub.layers.0", 2, 1))
        C = self.s.sub_channels
        for i in range(1, self.s.sub_stages):
            p = f"encoder.sub.layers.{i}"
            x = self.conv2d(x, f"{p}.dw", 2, 1, groups=C)
            x = F.relu(self.conv2d(x, f"{p}.pw", 1, 0))
        B, C, T, M = x.shape
        return self.lin(x.permute(0, 2, 1, 3).reshape(B, T, C * M), "encoder.sub.linear")

    def rel_attention(self, x, p):
        s = self.s
        B, T, d = x.shape
        H = s.enc_heads
        hd = d // H
        q = self.split(self.lin(x, f"{p}.q"), H)
        k = self.split(self.lin(x, f"{p}.k"), H)
        v = self.split(self.lin(x, f"{p}.v"), H)
        # relative positions T-1, ..., -(T-1): column m holds distance T-1-m
        dist = torch.arange(T - 1, -T, -1, dtype=torch.float64, device=x.device)
        r = self.lin(_interleaved(dist, d), f"{p}.rel_k", bias=False)
        r = r.view(2 * T - 1, H, hd).permute(1, 2, 0)  # [H, hd, 2T-1]
        u = self.w[f"{p}.bias_u"][None, :, None, :]
        vb = self.w[f"{p}.bias_v"][None, :, None, :]
        content = self.mm(q + u, k.transpose(-1, -2))
        by_dist = self.mm(q + vb, r)  # [B, H, T, 2T-1]
        i = torch.arange(T, device=x.device)
        col = (T - 1) - (i[:, None] - i[None, :])  # the column of distance i - j
        position = by_dist.gather(-1, col.expand(B, H, T, T))
        w = torch.softmax((content + position) / math.sqrt(hd), dim=-1)
        return self.lin(self.merge(self.mm(w, v)), f"{p}.o")

    def conv_module(self, x, p):
        h = self.lin(x, f"{p}.pw1")
        h = h[..., : h.shape[-1] // 2] * torch.sigmoid(h[..., h.shape[-1] // 2:])
        k = self.s.conv_kernel
        h = F.conv1d(self._r(h.transpose(1, 2)), self._r(self.w[f"{p}.dw.weight"]),
                     self.w[f"{p}.dw.bias"], padding=(k - 1) // 2, groups=h.shape[-1])
        mean, var = self.w[f"{p}.bn.mean"][:, None], self.w[f"{p}.bn.var"][:, None]
        h = (h - mean) / torch.sqrt(var + BN_EPS) * self.w[f"{p}.bn.weight"][:, None] \
            + self.w[f"{p}.bn.bias"][:, None]
        return self.lin(F.silu(h).transpose(1, 2), f"{p}.pw2")

    def ffn(self, x, p):
        return self.lin(F.silu(self.lin(x, f"{p}.fc1")), f"{p}.fc2")

    def encode(self, feats: torch.Tensor) -> torch.Tensor:
        """[B, frames, n_mels] → [B, T, d]."""
        x = self.subsample(feats) * math.sqrt(self.s.d_model)
        for i in range(self.s.enc_layers):
            p = f"encoder.enc.layers.{i}"
            x = x + 0.5 * self.ffn(self.ln(x, f"{p}.ln_ff1"), f"{p}.ff1")
            x = x + self.rel_attention(self.ln(x, f"{p}.ln_att"), f"{p}.attn")
            x = x + self.conv_module(self.ln(x, f"{p}.ln_conv"), f"{p}.conv")
            x = x + 0.5 * self.ffn(self.ln(x, f"{p}.ln_ff2"), f"{p}.ff2")
            x = self.ln(x, f"{p}.ln_out")
        return x

    # -- the decoder ----------------------------------------------------------------
    def attend(self, q, k, v, mask=None):
        logits = self.mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        if mask is not None:
            logits = logits + mask
        return self.merge(self.mm(torch.softmax(logits, dim=-1), v))

    def decode(self, tokens: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits [B, T, V] of tokens [B, T] over encoder
        output audio [B, S, d]."""
        s = self.s
        T, H = tokens.shape[1], s.dec_heads
        emb = self.w["dec.emb"]
        x = emb[tokens] * math.sqrt(s.d_model) + self.w["dec.pos"][:T]
        mask = torch.full((T, T), float("-inf"), device=x.device).triu(1)
        for i in range(s.dec_layers):
            p = f"dec.layers.{i}"
            h = self.ln(x, f"{p}.ln1")
            a = f"{p}.attn"
            x = x + self.lin(self.attend(self.split(self.lin(h, f"{a}.q"), H),
                                         self.split(self.lin(h, f"{a}.k"), H),
                                         self.split(self.lin(h, f"{a}.v"), H), mask), f"{a}.o")
            h = self.ln(x, f"{p}.lnx")
            c = f"{p}.cross"
            x = x + self.lin(self.attend(self.split(self.lin(h, f"{c}.q"), H),
                                         self.split(self.lin(audio, f"{c}.k"), H),
                                         self.split(self.lin(audio, f"{c}.v"), H)), f"{c}.o")
            h = self.ln(x, f"{p}.ln2")
            x = x + self.lin(F.relu(self.lin(h, f"{p}.fc1")), f"{p}.fc2")
        return self.mm(self.ln(x, "dec.ln"), emb.t())

    @torch.no_grad()
    def logits(self, audio_16k: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """[B, V] logits at every position of tokens [B, T] for audio
        [B, samples]: the logits that pick each next token."""
        return self.decode(tokens, self.encode(self.log_mel(audio_16k)))
