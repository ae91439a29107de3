"""ggml container *writer* — the inverse of weights.load_ggml.

The port's copy of ``crispy_tpu/models/whisper/ggml_io.py``. Lets the smoke
run and tests exercise the real file-load path end-to-end without network
access: synthesize a whisper.cpp-format model file (f32 / f16 / q8_0
tensors) from a params dict, then load it back through
`WhisperModel.from_ggml`. The reference ships these exact containers
(managers/model.rs:100-160: ggml-small.bin, whisper-medium-q4_1.bin,
ggml-large-v3-q5_0.bin).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from .weights import _GGML_MAGIC, _GGML_STATIC, _QK, _map_ggml_name
from .model import WhisperConfig


def quantize_q8_0(x: np.ndarray) -> bytes:
    """Vectorized ggml quantize_row_q8_0: per-32 block f16 d + int8 q,
    d = amax/127, q = round(x/d)."""
    blk = np.ascontiguousarray(x, np.float32).reshape(-1, _QK)
    amax = np.abs(blk).max(axis=1, keepdims=True)
    d = amax / 127.0
    idv = np.where(d == 0, 0.0, 1.0 / np.where(d == 0, 1.0, d))
    q = np.round(blk * idv).astype(np.int8)
    out = np.empty((blk.shape[0], 2 + _QK), np.uint8)
    out[:, :2] = d.astype("<f2").view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.tobytes()


def _ggml_names(cfg: WhisperConfig):
    """Every ggml tensor name a whisper.cpp file of this config carries."""
    names = list(_GGML_STATIC)
    per_block = [
        "attn.query.weight", "attn.query.bias", "attn.key.weight",
        "attn.value.weight", "attn.value.bias", "attn.out.weight",
        "attn.out.bias", "attn_ln.weight", "attn_ln.bias",
        "mlp.0.weight", "mlp.0.bias", "mlp.2.weight", "mlp.2.bias",
        "mlp_ln.weight", "mlp_ln.bias",
    ]
    cross = [
        "cross_attn.query.weight", "cross_attn.query.bias",
        "cross_attn.key.weight", "cross_attn.value.weight",
        "cross_attn.value.bias", "cross_attn.out.weight",
        "cross_attn.out.bias", "cross_attn_ln.weight", "cross_attn_ln.bias",
    ]
    for i in range(cfg.n_audio_layer):
        names += [f"encoder.blocks.{i}.{r}" for r in per_block]
    for i in range(cfg.n_text_layer):
        names += [f"decoder.blocks.{i}.{r}" for r in per_block + cross]
    return names


def write_ggml(path, params: Dict[str, np.ndarray], cfg: WhisperConfig,
               vocab: Optional[list] = None, ttype: int = 1) -> Path:
    """Serialize params (our naming) into a whisper.cpp ggml container.

    ttype: 0=f32, 1=f16, 8=q8_0. Like whisper.cpp's quantizer, 1-D
    tensors (biases, layernorms, positional embeddings) stay f32 and only
    matmul weights whose size is a multiple of the 32-wide block get
    quantized.
    """
    if ttype not in (0, 1, 8):
        raise ValueError(f"unsupported write ttype {ttype}")
    path = Path(path)
    ftype = ttype if ttype in (0, 1) else ttype + 1000  # qnt_version tag
    with open(path, "wb") as f:
        f.write(struct.pack("<I", _GGML_MAGIC))
        f.write(struct.pack(
            "<11i", cfg.n_vocab, cfg.n_audio_ctx, cfg.n_audio_state,
            cfg.n_audio_head, cfg.n_audio_layer, cfg.n_text_ctx,
            cfg.n_text_state, cfg.n_text_head, cfg.n_text_layer,
            cfg.n_mels, ftype))
        # mel filters (zeros are fine: dsp/mel.py computes its own)
        f.write(struct.pack("<2i", cfg.n_mels, 2))
        f.write(np.zeros(cfg.n_mels * 2, np.float32).tobytes())
        toks = vocab if vocab is not None else [
            f"tok{i}".encode() for i in range(cfg.n_vocab)]
        f.write(struct.pack("<i", len(toks)))
        for tok in toks:
            b = tok if isinstance(tok, bytes) else str(tok).encode()
            f.write(struct.pack("<i", len(b)))
            f.write(b)
        for gname in _ggml_names(cfg):
            mapped = _map_ggml_name(gname)
            if mapped is None:
                continue
            ours, transpose = mapped
            if ours not in params:
                continue
            arr = np.asarray(params[ours], np.float32)
            if transpose:
                arr = arr.T  # back to ggml's [out, in]
            if ours.endswith("conv1.w") or ours.endswith("conv2.w"):
                # real whisper.cpp files store conv weights in torch's
                # [out, in, k] layout; ours is [k, in, out]
                arr = arr.transpose(2, 1, 0)
            flat = np.ascontiguousarray(arr).reshape(-1)
            t = ttype
            if arr.ndim < 2 or (t == 8 and flat.size % _QK != 0):
                t = 0  # whisper.cpp keeps 1-D tensors f32
            dims = tuple(reversed(arr.shape))  # ggml dims innermost-first
            f.write(struct.pack("<3i", len(dims), len(gname.encode()), t))
            f.write(struct.pack(f"<{len(dims)}i", *dims))
            f.write(gname.encode())
            if t == 0:
                f.write(flat.astype("<f4").tobytes())
            elif t == 1:
                f.write(flat.astype("<f2").tobytes())
            else:
                f.write(quantize_q8_0(flat))
    return path
