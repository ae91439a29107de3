"""Speech-like test audio, made on the device from a seed.

Each stream is a voiced tone: ``harmonics`` partials of a fundamental with
a slow vibrato, at 1/k amplitude with a fixed phase ramp, shaped by a
syllable-rate envelope with pauses, plus white noise. The fundamental,
vibrato, syllable rate, level and noise level are drawn per stream from the
ranges a traffic file gives; every stream of every seed has the same length.
One ``torch.Generator`` on the device draws everything, in a fixed order.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _uniform(g: torch.Generator, n: int, lo_hi, device) -> torch.Tensor:
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device, dtype=torch.float64)


def speechlike(seed: int, streams: int, samples: int, rate: int, p: Dict,
               device, rows_per_pass: int = 16) -> torch.Tensor:
    """[streams, samples] float32 audio in [-1, 1] on ``device``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    f0 = _uniform(g, streams, p["f0_hz"], device)
    vib = _uniform(g, streams, p["vibrato_depth"], device)
    vib_hz = _uniform(g, streams, p["vibrato_hz"], device)
    syl_hz = _uniform(g, streams, p["syllable_hz"], device)
    phase = _uniform(g, streams, (0.0, 2 * math.pi), device)
    level = _uniform(g, streams, p["level"], device)
    noise = _uniform(g, streams, p["noise_level"], device)
    out = torch.empty((streams, samples), dtype=torch.float32, device=device)
    t = torch.arange(samples, dtype=torch.float64, device=device) / rate
    for r0 in range(0, streams, rows_per_pass):
        r = slice(r0, min(streams, r0 + rows_per_pass))
        tt = t[None, :]
        # cycles of the fundamental: f0 t + vibrato (its phase integral)
        cyc = f0[r, None] * (tt + vib[r, None] / (2 * math.pi * vib_hz[r, None])
                             * (1.0 - torch.cos(2 * math.pi * vib_hz[r, None] * tt)))
        sig = torch.zeros((r.stop - r.start, samples), dtype=torch.float32, device=device)
        for k in range(1, p["harmonics"] + 1):
            frac = torch.remainder(k * cyc, 1.0)  # keeps the phase exact in float64
            sig += ((0.5 / k) * torch.sin(2 * math.pi * frac + 0.13 * k)).float()
        env = torch.sin(math.pi * syl_hz[r, None] * tt + phase[r, None]) ** 2
        gate = (torch.sin(2 * math.pi * p["pause_hz"] * tt + phase[r, None]) > p["pause_below"])
        sig = sig * (env * gate).float()
        sig = sig / sig.abs().amax(dim=1, keepdim=True).clamp_min(1e-6)
        sig = level[r, None].float() * sig
        sig += noise[r, None].float() * torch.randn(sig.shape, generator=g, device=device)
        out[r] = sig.clamp_(-1.0, 1.0)
    return out


def to_int16(audio: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float → int16 PCM (×32767, rounded to nearest)."""
    return torch.round(audio * 32767.0).to(torch.int16)
