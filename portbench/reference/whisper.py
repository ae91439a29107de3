"""Plain PyTorch Whisper: the transcription cells' reference.

The public Whisper architecture (Radford et al., arXiv:2212.04356) as a
teacher-forced forward in float32 with TF32 off, written from the paper and
the published checkpoints' layout, with no cache, no batching tricks and
nothing of the program:

    log-mel: reflect-padded 400-point periodic-Hann STFT, hop 160, |.|^2,
             slaney mel filters, log10 clamped at 1e-10, floor at max - 8,
             then (x + 4) / 4
    encoder: conv(k3, s1) → gelu → conv(k3, s2) → gelu → + sinusoids
             → pre-LN blocks (attention, MLP) → LayerNorm
    decoder: token + learned positions → pre-LN blocks (causal
             self-attention, cross-attention, MLP) → LayerNorm → x @ emb^T

Attention scales q and k by hd^-0.25 each. The configuration serves the
decoder's keys and values from a bfloat16 cache, so they are rounded to
bfloat16 where a cache would hold them: the cross-attention's keys and
values once, every self-attention key and value before it is read, and
the key's scale applied in bfloat16 with the scale rounded to it.

``tf32=True`` rounds every operand of a product (convolutions, linear
layers, attention) to TensorFloat-32's 10-bit mantissa: the control.

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
N_FFT = 400
HOP = 160
CHUNK = 30 * SAMPLE_RATE


@dataclass(frozen=True)
class Shape:
    n_mels: int
    n_vocab: int
    n_audio_ctx: int
    d_model: int
    n_head: int
    encoder_layers: int
    n_text_ctx: int
    decoder_layers: int

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head


def layout(s: Shape) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every weight as (name, shape, kind), in a fixed order. Kinds: "w"
    a matrix drawn with std 1/sqrt(fan in), "emb" and "pos" std 0.02, "b" a
    bias (std 0.02), "g" a LayerNorm gain (1 + std 0.02), "sin" the
    encoder's sinusoid table (not drawn)."""
    d, out = s.d_model, []

    def lin(name, din, dout, bias=True):
        out.append((f"{name}.weight", (dout, din), "w"))
        if bias:
            out.append((f"{name}.bias", (dout,), "b"))

    def ln(name):
        out.append((f"{name}.weight", (d,), "g"))
        out.append((f"{name}.bias", (d,), "b"))

    def attn(name):
        lin(f"{name}.q", d, d)
        lin(f"{name}.k", d, d, bias=False)
        lin(f"{name}.v", d, d)
        lin(f"{name}.out", d, d)

    out.append(("encoder.conv1.weight", (d, s.n_mels, 3), "w"))
    out.append(("encoder.conv1.bias", (d,), "b"))
    out.append(("encoder.conv2.weight", (d, d, 3), "w"))
    out.append(("encoder.conv2.bias", (d,), "b"))
    out.append(("encoder.pos", (s.n_audio_ctx, d), "sin"))
    for i in range(s.encoder_layers):
        p = f"encoder.blocks.{i}"
        attn(f"{p}.attn")
        ln(f"{p}.ln1")
        ln(f"{p}.ln2")
        lin(f"{p}.mlp.fc1", d, 4 * d)
        lin(f"{p}.mlp.fc2", 4 * d, d)
    ln("encoder.ln_post")
    out.append(("decoder.emb.weight", (s.n_vocab, d), "emb"))
    out.append(("decoder.pos", (s.n_text_ctx, d), "pos"))
    for i in range(s.decoder_layers):
        p = f"decoder.blocks.{i}"
        attn(f"{p}.attn")
        attn(f"{p}.cross")
        ln(f"{p}.ln1")
        ln(f"{p}.lnx")
        ln(f"{p}.ln2")
        lin(f"{p}.mlp.fc1", d, 4 * d)
        lin(f"{p}.mlp.fc2", 4 * d, d)
    ln("decoder.ln")
    return out


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper's encoder position table: sin | cos of log-spaced timescales."""
    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64, device=device))
    t = torch.arange(length, dtype=torch.float64, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1).float()


def draw_weights(s: Shape, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``layout`` from ``seed``: one normal draw on the
    device for all of them, cut into views and scaled per kind."""
    entries = layout(s)
    drawn = [(n, sh, k) for n, sh, k in entries if k != "sin"]
    total = sum(math.prod(sh) for _, sh, _ in drawn)
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
        else:  # "b", "emb", "pos"
            t.mul_(0.02)
        out[name] = t
    return out


# ---------------------------------------------------------------------------
# Log-mel frontend
# ---------------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1e-30) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), m * (200.0 / 3))


def mel_filters(n_mels: int) -> np.ndarray:
    """[n_mels, 201] slaney-normalised triangles on the slaney mel scale
    (librosa's ``filters.mel(sr=16000, n_fft=400, htk=False)``)."""
    freqs = np.linspace(0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    fb = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    return (fb * (2.0 / (hz[2:] - hz[:-2]))[:, None]).astype(np.float32)


class Reference:
    """The teacher-forced forward over ``weights`` (see ``layout``)."""

    def __init__(self, s: Shape, weights: Dict[str, torch.Tensor], tf32: bool = False):
        self.s, self.w, self.tf32 = s, weights, tf32
        dev = weights["decoder.ln.weight"].device
        self.window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64, device=dev).float()
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
        return F.layer_norm(x, (x.shape[-1],), self.w[f"{name}.weight"], self.w[f"{name}.bias"], 1e-5)

    def conv(self, x, name, stride):
        return F.conv1d(self._r(x), self._r(self.w[f"{name}.weight"]), self.w[f"{name}.bias"],
                        stride=stride, padding=1)

    def heads(self, x):  # [B, T, D] -> [B, H, T, hd]
        B, T, D = x.shape
        return x.view(B, T, self.s.n_head, D // self.s.n_head).transpose(1, 2)

    def attend(self, q, k, v, mask=None):
        """q f32 [B, H, Tq, hd]; k, v f32 or bf16. q and k are scaled by
        hd^-0.25 each, k in its own dtype with the scale rounded to it."""
        scale = q.shape[-1] ** -0.25
        ks = k * float(torch.tensor(scale, dtype=k.dtype))
        logits = self.mm(q * scale, ks.float().transpose(-1, -2))
        if mask is not None:
            logits = logits + mask
        o = self.mm(torch.softmax(logits, dim=-1), v.float())
        B, H, T, hd = o.shape
        return o.transpose(1, 2).reshape(B, T, H * hd)

    def mlp(self, x, name):
        return self.lin(F.gelu(self.lin(x, f"{name}.fc1"), approximate="none"), f"{name}.fc2")

    # -- the model ----------------------------------------------------------------
    def log_mel(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, 480000] → [B, n_mels, 3000]."""
        x = audio.float()
        T = x.shape[-1]
        xp = F.pad(x[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
        frames = xp.unfold(-1, N_FFT, HOP)[:, : T // HOP]
        spec = torch.fft.rfft(self._r(frames * self.window), n=N_FFT, dim=-1).abs() ** 2
        mel = torch.log10(torch.clamp(self.mm(spec, self.filters.t()), min=1e-10))
        mel = torch.maximum(mel, mel.amax(dim=(1, 2), keepdim=True) - 8.0)
        return ((mel + 4.0) / 4.0).transpose(1, 2)

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.conv(mel, "encoder.conv1", 1), approximate="none")
        x = F.gelu(self.conv(x, "encoder.conv2", 2), approximate="none")
        x = x.transpose(1, 2) + self.w["encoder.pos"]
        for i in range(self.s.encoder_layers):
            p = f"encoder.blocks.{i}"
            h = self.ln(x, f"{p}.ln1")
            a = f"{p}.attn"
            x = x + self.lin(self.attend(self.heads(self.lin(h, f"{a}.q")),
                                         self.heads(self.lin(h, f"{a}.k", bias=False)),
                                         self.heads(self.lin(h, f"{a}.v"))), f"{a}.out")
            x = x + self.mlp(self.ln(x, f"{p}.ln2"), f"{p}.mlp")
        return self.ln(x, "encoder.ln_post")

    def decode(self, tokens: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits [B, T, V] of tokens [B, T] over encoder
        output audio [B, 1500, d]."""
        T = tokens.shape[1]
        kv = torch.bfloat16
        x = self.w["decoder.emb.weight"][tokens] + self.w["decoder.pos"][:T]
        mask = torch.full((T, T), float("-inf"), device=x.device).triu(1)
        for i in range(self.s.decoder_layers):
            p = f"decoder.blocks.{i}"
            h = self.ln(x, f"{p}.ln1")
            a = f"{p}.attn"
            k = self.heads(self.lin(h, f"{a}.k", bias=False)).to(kv)
            v = self.heads(self.lin(h, f"{a}.v")).to(kv)
            x = x + self.lin(self.attend(self.heads(self.lin(h, f"{a}.q")), k, v, mask), f"{a}.out")
            c = f"{p}.cross"
            ck = self.heads(self.lin(audio, f"{c}.k", bias=False)).to(kv)
            cv = self.heads(self.lin(audio, f"{c}.v")).to(kv)
            h = self.ln(x, f"{p}.lnx")
            x = x + self.lin(self.attend(self.heads(self.lin(h, f"{c}.q")), ck, cv), f"{c}.out")
            x = x + self.mlp(self.ln(x, f"{p}.ln2"), f"{p}.mlp")
        return self.mm(self.ln(x, "decoder.ln"), self.w["decoder.emb.weight"].t())

    @torch.no_grad()
    def logits(self, audio_16k: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        return self.decode(tokens, self.encode(self.log_mel(audio_16k)))
