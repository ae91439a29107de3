"""Operations of the canary cell's work, counted from shapes: what the
algorithm needs for a batch of 30 s chunks through Canary, whatever the
program executes (``mfu.canary`` divides them by the window's wall). Products count
2 operations a multiply-add; normalisations, activations, softmax and the
mel frontend are left out, as ``counts.py`` leaves them out of Whisper.
"""

from __future__ import annotations

from typing import Dict

from .reference.canary import HOP, Shape


def _halve(n: int) -> int:
    """Length after a 3-tap, stride-2 convolution padded by 1 on each side."""
    return (n - 1) // 2 + 1


def encoder_frames(samples: int) -> int:
    """Frames of the log-mel features of ``samples`` (a centred STFT)."""
    return samples // HOP + 1


def subsampled(s: Shape, samples: int) -> int:
    """Encoder positions of a chunk of ``samples``."""
    t = encoder_frames(samples)
    for _ in range(s.sub_stages):
        t = _halve(t)
    return t


def subsampler_flops(s: Shape, samples: int) -> float:
    """The first 3x3 convolution (one input channel), then per further stage
    a depthwise 3x3 and a pointwise C x C convolution, then the linear layer
    from the flattened channels and mel bins to d."""
    C = s.sub_channels
    t, m = _halve(encoder_frames(samples)), _halve(s.n_mels)
    flops = 2.0 * 9 * C * t * m
    for _ in range(1, s.sub_stages):
        t, m = _halve(t), _halve(m)
        flops += 2.0 * 9 * C * t * m + 2.0 * C * C * t * m
    return flops + 2.0 * t * (C * m) * s.d_model


def encoder_layer_flops(s: Shape, T: int) -> float:
    """One FastConformer block over a chunk's T positions: two FFNs (8 T d
    f); q, k, v and out (8 T d^2); the content (2 T^2 d) and position (2 T
    (2T - 1) d) scores and the weighted values (2 T^2 d); the conv module's
    pointwise d → 2d and d → d (6 T d^2) and its depthwise kernel (2 T d k).
    The projection of the relative positions is the batch's, not the
    chunk's (``position_flops``)."""
    d, P = s.d_model, 2 * T - 1
    return (8.0 * T * d * s.enc_ffn + 8.0 * T * d * d + 4.0 * T * T * d + 2.0 * T * P * d
            + 6.0 * T * d * d + 2.0 * T * d * s.conv_kernel)


def position_flops(s: Shape, T: int) -> float:
    """One block's projection of the 2T - 1 relative positions, which every
    chunk of a batch shares (2 (2T - 1) d^2)."""
    return 2.0 * (2 * T - 1) * s.d_model * s.d_model


def encoder_flops(s: Shape, samples: int, batch: int = 1) -> float:
    """A batch of chunks of ``samples`` through the subsampler and every
    encoder block."""
    T = subsampled(s, samples)
    return (batch * (subsampler_flops(s, samples) + s.enc_layers * encoder_layer_flops(s, T))
            + s.enc_layers * position_flops(s, T))


def decode_flops(s: Shape, S: int, prompt: int, steps: int) -> Dict[str, float]:
    """One chunk's decode over S encoder positions: the cross keys and
    values (4 S d^2 a layer), the prompt's ``prompt`` tokens with the logits
    of its last position, and ``steps`` cached steps with their logits, step
    i attending over prompt + i + 1 keys. A token through a layer: self q,
    k, v, out (8 d^2), its attention over ``keys`` (4 keys d), cross q and
    out (4 d^2), the cross attention (4 S d) and the FFN (4 d f)."""
    d = s.d_model

    def token(keys: int) -> float:
        return s.dec_layers * (12.0 * d * d + 4.0 * keys * d + 4.0 * S * d + 4.0 * d * s.dec_ffn)

    head = 2.0 * d * s.n_vocab
    return {"cross_kv": s.dec_layers * 4.0 * S * d * d,
            "prefill": sum(token(k + 1) for k in range(prompt)) + head,
            "steps": sum(token(prompt + i + 1) + head for i in range(steps))}


def call_flops(s: Shape, batch: int, samples: int, prompt: int, steps: int) -> float:
    """A call's whole work on the timed path, ``batch`` chunks: the
    encoder, the cross keys and values, the prefill and the cached steps."""
    dec = decode_flops(s, subsampled(s, samples), prompt, steps)
    return encoder_flops(s, samples, batch) + batch * sum(dec.values())
