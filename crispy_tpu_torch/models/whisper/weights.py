"""Whisper weight import: HF transformers checkpoints and whisper.cpp ggml.

The port's copy of ``crispy_tpu/models/whisper/weights.py`` (bit-equal
params from the same file or seed), plus the carry of those params into the
port's modules (``params_to_module``) and back (``module_to_params``).

The reference's model catalog distributes whisper.cpp ggml files
(src-tauri/src/managers/model.rs:74-160: ggml-{tiny,base,small,large-v3-
turbo}.bin); `load_ggml` parses that container directly — hparams, mel
filters, the embedded BPE vocab, and f32/f16/quantized tensors.
`from_hf_state_dict` maps HuggingFace WhisperForConditionalGeneration
checkpoints (safetensors or torch .bin).

Flat parameter naming, shared with the JAX package (matmul-ready [in, out]
matrices):
    enc.conv{1,2}.{w,b}          w: [k, in, out]
    enc.pos                      [1500, d]
    enc.N.attn.{q,k,v,out}.{w,b} (k has no bias)
    enc.N.{ln1,ln2}.{g,b}, enc.ln_post.{g,b}
    dec.emb [V, d], dec.pos [448, d]
    dec.N.{attn,cross}.{q,k,v,out}.{w,b}, dec.N.{ln1,lnx,ln2}.{g,b}
    dec.ln.{g,b}
In the modules, linear weights are [out, in] and conv weights [out, in, k].
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..carry import flat_layout, load_hf_state_dict, load_params
from .model import Whisper, WhisperConfig, sinusoids


def init_random(cfg: WhisperConfig, seed: int = 0, dtype=np.float32) -> Dict[str, np.ndarray]:
    """Tiny-magnitude random params with the exact production structure."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=None):
        scale = scale or (1.0 / np.sqrt(shape[0]))
        return (rng.standard_normal(shape) * scale).astype(dtype)

    d, dk = cfg.n_audio_state, cfg.n_text_state
    p: Dict[str, np.ndarray] = {
        "enc.conv1.w": w(3, cfg.n_mels, d), "enc.conv1.b": np.zeros(d, dtype),
        "enc.conv2.w": w(3, d, d), "enc.conv2.b": np.zeros(d, dtype),
        "enc.pos": sinusoids(cfg.n_audio_ctx, d).astype(dtype),
        "enc.ln_post.g": np.ones(d, dtype), "enc.ln_post.b": np.zeros(d, dtype),
        "dec.emb": w(cfg.n_vocab, dk, scale=0.02),
        "dec.pos": w(cfg.n_text_ctx, dk, scale=0.02),
        "dec.ln.g": np.ones(dk, dtype), "dec.ln.b": np.zeros(dk, dtype),
    }

    def attn(prefix, dim):
        p[f"{prefix}.q.w"] = w(dim, dim)
        p[f"{prefix}.q.b"] = np.zeros(dim, dtype)
        p[f"{prefix}.k.w"] = w(dim, dim)
        p[f"{prefix}.v.w"] = w(dim, dim)
        p[f"{prefix}.v.b"] = np.zeros(dim, dtype)
        p[f"{prefix}.out.w"] = w(dim, dim)
        p[f"{prefix}.out.b"] = np.zeros(dim, dtype)

    def lnorm(prefix, dim):
        p[f"{prefix}.g"] = np.ones(dim, dtype)
        p[f"{prefix}.b"] = np.zeros(dim, dtype)

    for i in range(cfg.n_audio_layer):
        attn(f"enc.{i}.attn", d)
        lnorm(f"enc.{i}.ln1", d)
        lnorm(f"enc.{i}.ln2", d)
        p[f"enc.{i}.mlp.fc1.w"] = w(d, 4 * d)
        p[f"enc.{i}.mlp.fc1.b"] = np.zeros(4 * d, dtype)
        p[f"enc.{i}.mlp.fc2.w"] = w(4 * d, d)
        p[f"enc.{i}.mlp.fc2.b"] = np.zeros(d, dtype)
    for i in range(cfg.n_text_layer):
        attn(f"dec.{i}.attn", dk)
        attn(f"dec.{i}.cross", dk)
        lnorm(f"dec.{i}.ln1", dk)
        lnorm(f"dec.{i}.lnx", dk)
        lnorm(f"dec.{i}.ln2", dk)
        p[f"dec.{i}.mlp.fc1.w"] = w(dk, 4 * dk)
        p[f"dec.{i}.mlp.fc1.b"] = np.zeros(4 * dk, dtype)
        p[f"dec.{i}.mlp.fc2.w"] = w(4 * dk, dk)
        p[f"dec.{i}.mlp.fc2.b"] = np.zeros(dk, dtype)
    return p


# ---------------------------------------------------------------------------
# HuggingFace checkpoint mapping
# ---------------------------------------------------------------------------

_HF_ATTN = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "out": "out_proj"}


def from_hf_state_dict(sd: Dict[str, np.ndarray]) -> Tuple[Dict[str, np.ndarray], WhisperConfig]:
    """Map a WhisperForConditionalGeneration state dict to our params."""
    def get(name):
        for k in (name, f"model.{name}"):
            if k in sd:
                return np.asarray(sd[k])
        raise KeyError(name)

    def linw(name):
        return get(name).T.astype(np.float32)  # torch [out,in] → [in,out]

    emb = get("decoder.embed_tokens.weight").astype(np.float32)
    enc_pos = get("encoder.embed_positions.weight").astype(np.float32)
    n_layers_enc = 0
    while any(k.endswith(f"encoder.layers.{n_layers_enc}.fc1.weight") for k in sd):
        n_layers_enc += 1
    n_layers_dec = 0
    while any(k.endswith(f"decoder.layers.{n_layers_dec}.fc1.weight") for k in sd):
        n_layers_dec += 1
    conv1 = get("encoder.conv1.weight")  # [d, n_mels, 3]
    d = conv1.shape[0]
    n_mels = conv1.shape[1]
    n_heads = {384: 6, 512: 8, 768: 12, 1024: 16, 1280: 20}.get(d, max(1, d // 64))
    cfg = WhisperConfig(
        n_mels=n_mels, n_vocab=emb.shape[0], n_audio_ctx=enc_pos.shape[0],
        n_audio_state=d, n_audio_head=n_heads, n_audio_layer=n_layers_enc,
        n_text_ctx=get("decoder.embed_positions.weight").shape[0],
        n_text_state=emb.shape[1], n_text_head=n_heads, n_text_layer=n_layers_dec,
        eot=50256 if emb.shape[0] == 51864 else 50257,
        sot=50257 if emb.shape[0] == 51864 else 50258,
    )

    p: Dict[str, np.ndarray] = {
        "enc.conv1.w": conv1.transpose(2, 1, 0).astype(np.float32),
        "enc.conv1.b": get("encoder.conv1.bias").astype(np.float32),
        "enc.conv2.w": get("encoder.conv2.weight").transpose(2, 1, 0).astype(np.float32),
        "enc.conv2.b": get("encoder.conv2.bias").astype(np.float32),
        "enc.pos": enc_pos,
        "enc.ln_post.g": get("encoder.layer_norm.weight").astype(np.float32),
        "enc.ln_post.b": get("encoder.layer_norm.bias").astype(np.float32),
        "dec.emb": emb,
        "dec.pos": get("decoder.embed_positions.weight").astype(np.float32),
        "dec.ln.g": get("decoder.layer_norm.weight").astype(np.float32),
        "dec.ln.b": get("decoder.layer_norm.bias").astype(np.float32),
    }

    def map_attn(ours, theirs):
        for o, t in _HF_ATTN.items():
            p[f"{ours}.{o}.w"] = linw(f"{theirs}.{t}.weight")
            if o != "k":
                p[f"{ours}.{o}.b"] = get(f"{theirs}.{t}.bias").astype(np.float32)

    for i in range(cfg.n_audio_layer):
        t = f"encoder.layers.{i}"
        map_attn(f"enc.{i}.attn", f"{t}.self_attn")
        p[f"enc.{i}.ln1.g"] = get(f"{t}.self_attn_layer_norm.weight").astype(np.float32)
        p[f"enc.{i}.ln1.b"] = get(f"{t}.self_attn_layer_norm.bias").astype(np.float32)
        p[f"enc.{i}.ln2.g"] = get(f"{t}.final_layer_norm.weight").astype(np.float32)
        p[f"enc.{i}.ln2.b"] = get(f"{t}.final_layer_norm.bias").astype(np.float32)
        p[f"enc.{i}.mlp.fc1.w"] = linw(f"{t}.fc1.weight")
        p[f"enc.{i}.mlp.fc1.b"] = get(f"{t}.fc1.bias").astype(np.float32)
        p[f"enc.{i}.mlp.fc2.w"] = linw(f"{t}.fc2.weight")
        p[f"enc.{i}.mlp.fc2.b"] = get(f"{t}.fc2.bias").astype(np.float32)
    for i in range(cfg.n_text_layer):
        t = f"decoder.layers.{i}"
        map_attn(f"dec.{i}.attn", f"{t}.self_attn")
        map_attn(f"dec.{i}.cross", f"{t}.encoder_attn")
        p[f"dec.{i}.ln1.g"] = get(f"{t}.self_attn_layer_norm.weight").astype(np.float32)
        p[f"dec.{i}.ln1.b"] = get(f"{t}.self_attn_layer_norm.bias").astype(np.float32)
        p[f"dec.{i}.lnx.g"] = get(f"{t}.encoder_attn_layer_norm.weight").astype(np.float32)
        p[f"dec.{i}.lnx.b"] = get(f"{t}.encoder_attn_layer_norm.bias").astype(np.float32)
        p[f"dec.{i}.ln2.g"] = get(f"{t}.final_layer_norm.weight").astype(np.float32)
        p[f"dec.{i}.ln2.b"] = get(f"{t}.final_layer_norm.bias").astype(np.float32)
        p[f"dec.{i}.mlp.fc1.w"] = linw(f"{t}.fc1.weight")
        p[f"dec.{i}.mlp.fc1.b"] = get(f"{t}.fc1.bias").astype(np.float32)
        p[f"dec.{i}.mlp.fc2.w"] = linw(f"{t}.fc2.weight")
        p[f"dec.{i}.mlp.fc2.b"] = get(f"{t}.fc2.bias").astype(np.float32)
    return p, cfg


def load_hf(model_dir) -> Tuple[Dict[str, np.ndarray], WhisperConfig]:
    """Load from a HF checkpoint directory (model.safetensors or .bin)."""
    return from_hf_state_dict(load_hf_state_dict(Path(model_dir)))


# ---------------------------------------------------------------------------
# whisper.cpp ggml container
# ---------------------------------------------------------------------------

_GGML_MAGIC = 0x67676D6C

# ggml quantization block formats (public ggml layout; QK = 32 weights/block).
# whisper.cpp's catalog ships q4_1 (whisper-medium-q4_1.bin) and q5_0
# (ggml-large-v3-q5_0.bin) — reference managers/model.rs:100-160.
_QK = 32
# ggml_type value → (bytes per block, dequant fn)


def _deq_q4_0(blocks: np.ndarray) -> np.ndarray:
    """block: f16 d + 16B nibbles; x = (q - 8) * d."""
    n = blocks.shape[0]
    d = blocks[:, :2].copy().view("<f2").astype(np.float32)  # [n,1]
    qs = blocks[:, 2:18]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)  # [n,32]
    return q * d


def _deq_q4_1(blocks: np.ndarray) -> np.ndarray:
    """block: f16 d + f16 m + 16B nibbles; x = q * d + m."""
    d = blocks[:, :2].copy().view("<f2").astype(np.float32)
    m = blocks[:, 2:4].copy().view("<f2").astype(np.float32)
    qs = blocks[:, 4:20]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    return np.concatenate([lo, hi], axis=1) * d + m


def _q5_high_bits(qh_bytes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """qh: [n,4] bytes = 32 high bits; returns ([n,16], [n,16]) for lo/hi halves."""
    qh = qh_bytes.copy().view("<u4").astype(np.uint64)  # [n,1]
    j = np.arange(16, dtype=np.uint64)
    bit_lo = ((qh >> j) & 1).astype(np.uint8) << 4        # weights 0..15
    bit_hi = ((qh >> (j + 16)) & 1).astype(np.uint8) << 4  # weights 16..31
    return bit_lo, bit_hi


def _deq_q5_0(blocks: np.ndarray) -> np.ndarray:
    """block: f16 d + 4B qh + 16B nibbles; x = ((q | bit<<4) - 16) * d."""
    d = blocks[:, :2].copy().view("<f2").astype(np.float32)
    bit_lo, bit_hi = _q5_high_bits(blocks[:, 2:6])
    qs = blocks[:, 6:22]
    lo = ((qs & 0x0F) | bit_lo).astype(np.int16) - 16
    hi = ((qs >> 4) | bit_hi).astype(np.int16) - 16
    return np.concatenate([lo, hi], axis=1).astype(np.float32) * d


def _deq_q5_1(blocks: np.ndarray) -> np.ndarray:
    """block: f16 d + f16 m + 4B qh + 16B nibbles; x = (q | bit<<4) * d + m."""
    d = blocks[:, :2].copy().view("<f2").astype(np.float32)
    m = blocks[:, 2:4].copy().view("<f2").astype(np.float32)
    bit_lo, bit_hi = _q5_high_bits(blocks[:, 4:8])
    qs = blocks[:, 8:24]
    lo = ((qs & 0x0F) | bit_lo).astype(np.float32)
    hi = ((qs >> 4) | bit_hi).astype(np.float32)
    return np.concatenate([lo, hi], axis=1) * d + m


def _deq_q8_0(blocks: np.ndarray) -> np.ndarray:
    """block: f16 d + 32 int8; x = q * d."""
    d = blocks[:, :2].copy().view("<f2").astype(np.float32)
    q = blocks[:, 2:34].view(np.int8).astype(np.float32)
    return q * d


# ggml_type enum values as stored per-tensor in whisper.cpp model files.
_GGML_QUANT = {
    2: (18, _deq_q4_0),
    3: (20, _deq_q4_1),
    6: (22, _deq_q5_0),
    7: (24, _deq_q5_1),
    8: (34, _deq_q8_0),
}


def dequantize_ggml(data: bytes, ttype: int, count: int) -> np.ndarray:
    """Dequantize a ggml-quantized tensor payload to float32 [count]."""
    block_bytes, fn = _GGML_QUANT[ttype]
    n_blocks = count // _QK
    blocks = np.frombuffer(data, np.uint8).reshape(n_blocks, block_bytes)
    return fn(blocks).reshape(-1)[:count]

# OpenAI-style tensor names (as stored in ggml files) → our naming.
_GGML_STATIC = {
    "encoder.positional_embedding": "enc.pos",
    "encoder.conv1.weight": "enc.conv1.w",
    "encoder.conv1.bias": "enc.conv1.b",
    "encoder.conv2.weight": "enc.conv2.w",
    "encoder.conv2.bias": "enc.conv2.b",
    "encoder.ln_post.weight": "enc.ln_post.g",
    "encoder.ln_post.bias": "enc.ln_post.b",
    "decoder.token_embedding.weight": "dec.emb",
    "decoder.positional_embedding": "dec.pos",
    "decoder.ln.weight": "dec.ln.g",
    "decoder.ln.bias": "dec.ln.b",
}


def _map_ggml_name(name: str) -> Optional[Tuple[str, bool]]:
    """→ (our_name, needs_transpose). Linear weights in ggml are [out, in]."""
    if name in _GGML_STATIC:
        return _GGML_STATIC[name], False
    parts = name.split(".")
    if parts[0] in ("encoder", "decoder") and parts[1] == "blocks":
        side = "enc" if parts[0] == "encoder" else "dec"
        i = parts[2]
        rest = ".".join(parts[3:])
        m = {
            "attn.query.weight": (f"{side}.{i}.attn.q.w", True),
            "attn.query.bias": (f"{side}.{i}.attn.q.b", False),
            "attn.key.weight": (f"{side}.{i}.attn.k.w", True),
            "attn.value.weight": (f"{side}.{i}.attn.v.w", True),
            "attn.value.bias": (f"{side}.{i}.attn.v.b", False),
            "attn.out.weight": (f"{side}.{i}.attn.out.w", True),
            "attn.out.bias": (f"{side}.{i}.attn.out.b", False),
            "attn_ln.weight": (f"{side}.{i}.ln1.g", False),
            "attn_ln.bias": (f"{side}.{i}.ln1.b", False),
            "cross_attn.query.weight": (f"{side}.{i}.cross.q.w", True),
            "cross_attn.query.bias": (f"{side}.{i}.cross.q.b", False),
            "cross_attn.key.weight": (f"{side}.{i}.cross.k.w", True),
            "cross_attn.value.weight": (f"{side}.{i}.cross.v.w", True),
            "cross_attn.value.bias": (f"{side}.{i}.cross.v.b", False),
            "cross_attn.out.weight": (f"{side}.{i}.cross.out.w", True),
            "cross_attn.out.bias": (f"{side}.{i}.cross.out.b", False),
            "cross_attn_ln.weight": (f"{side}.{i}.lnx.g", False),
            "cross_attn_ln.bias": (f"{side}.{i}.lnx.b", False),
            "mlp.0.weight": (f"{side}.{i}.mlp.fc1.w", True),
            "mlp.0.bias": (f"{side}.{i}.mlp.fc1.b", False),
            "mlp.2.weight": (f"{side}.{i}.mlp.fc2.w", True),
            "mlp.2.bias": (f"{side}.{i}.mlp.fc2.b", False),
            "mlp_ln.weight": (f"{side}.{i}.ln2.g", False),
            "mlp_ln.bias": (f"{side}.{i}.ln2.b", False),
        }.get(rest)
        return m
    return None


def load_ggml(path) -> Tuple[Dict[str, np.ndarray], WhisperConfig, List[bytes], np.ndarray]:
    """Parse a whisper.cpp ggml model file.

    Returns (params, config, vocab_tokens, mel_filters). Supports f32/f16
    tensors plus the ggml quantized formats the reference catalog ships
    (q4_0/q4_1/q5_0/q5_1/q8_0 — whisper-medium-q4_1.bin and
    ggml-large-v3-q5_0.bin, managers/model.rs:100-160), dequantized to f32.
    """
    with open(path, "rb") as f:
        (magic,) = struct.unpack("<I", f.read(4))
        if magic != _GGML_MAGIC:
            raise ValueError(f"not a ggml file (magic {magic:#x})")
        hp = struct.unpack("<11i", f.read(44))
        (n_vocab, n_audio_ctx, n_audio_state, n_audio_head, n_audio_layer,
         n_text_ctx, n_text_state, n_text_head, n_text_layer, n_mels, ftype) = hp
        cfg = WhisperConfig(
            n_mels=n_mels, n_vocab=n_vocab, n_audio_ctx=n_audio_ctx,
            n_audio_state=n_audio_state, n_audio_head=n_audio_head,
            n_audio_layer=n_audio_layer, n_text_ctx=n_text_ctx,
            n_text_state=n_text_state, n_text_head=n_text_head,
            n_text_layer=n_text_layer,
            eot=50256 if n_vocab == 51864 else 50257,
            sot=50257 if n_vocab == 51864 else 50258,
        )
        # mel filters
        n_mel, n_fft_bins = struct.unpack("<2i", f.read(8))
        filters = np.frombuffer(f.read(4 * n_mel * n_fft_bins), "<f4").reshape(n_mel, n_fft_bins)
        # vocab
        (nv,) = struct.unpack("<i", f.read(4))
        vocab: List[bytes] = []
        for _ in range(nv):
            (ln,) = struct.unpack("<i", f.read(4))
            vocab.append(f.read(ln))
        # tensors
        raw: Dict[str, np.ndarray] = {}
        while True:
            head = f.read(12)
            if len(head) < 12:
                break
            n_dims, name_len, t_ftype = struct.unpack("<3i", head)
            dims = struct.unpack(f"<{n_dims}i", f.read(4 * n_dims))
            name = f.read(name_len).decode("utf-8")
            count = int(np.prod(dims))
            if t_ftype == 0:
                data = np.frombuffer(f.read(4 * count), "<f4").astype(np.float32)
            elif t_ftype == 1:
                data = np.frombuffer(f.read(2 * count), "<f2").astype(np.float32)
            elif t_ftype in _GGML_QUANT:
                block_bytes, _ = _GGML_QUANT[t_ftype]
                nbytes = (count // _QK) * block_bytes
                data = dequantize_ggml(f.read(nbytes), t_ftype, count)
            else:
                raise ValueError(f"ggml tensor {name}: unsupported type {t_ftype}")
            # ggml dims are innermost-first; numpy shape is the reverse.
            raw[name] = data.reshape(tuple(reversed(dims)))

    params: Dict[str, np.ndarray] = {}
    for name, arr in raw.items():
        mapped = _map_ggml_name(name)
        if mapped is None:
            continue
        ours, transpose = mapped
        if transpose:
            arr = arr.T
        if ours.endswith("conv1.w") or ours.endswith("conv2.w"):
            # whisper.cpp's converter stores conv1d weights with torch's
            # [out, in, k] layout (dims written innermost-first = (k, in,
            # out), so our reversed-dims reshape reconstructs [out, in,
            # k]); the model's "HIO" conv consumes [k, in, out].
            arr = arr.transpose(2, 1, 0)
        elif ours.endswith(".b") or ours.endswith(".g"):
            # conv/ln biases may arrive 2-D ({1, d} in ggml ne order);
            # flatten so the broadcast adds stay [d]-shaped
            arr = arr.reshape(-1)
        params[ours] = np.ascontiguousarray(arr, dtype=np.float32)
    return params, cfg, vocab, filters


# ---------------------------------------------------------------------------
# The carry between flat params and the port's modules
# ---------------------------------------------------------------------------

def _module_name(ours: str) -> str:
    """Flat name → module state-dict name: enc.0.attn.q.w →
    encoder.blocks.0.attn.q.weight, dec.emb → decoder.emb.weight."""
    side, *rest = ours.split(".")
    mod = ["encoder" if side == "enc" else "decoder"]
    if rest[0].isdigit():
        mod += ["blocks", rest.pop(0)]
    if rest == ["pos"]:
        return ".".join(mod + rest)
    if rest == ["emb"]:
        return ".".join(mod + ["emb", "weight"])
    *path, leaf = rest
    return ".".join(mod + path + ["bias" if leaf == "b" else "weight"])


def _flat_name(name: str) -> str:
    """The inverse of _module_name."""
    side, *rest = name.split(".")
    out = ["enc" if side == "encoder" else "dec"]
    if rest[0] == "blocks":
        out.append(rest[1])
        rest = rest[2:]
    if rest in (["pos"], ["emb", "weight"]):
        return ".".join(out + rest[:1])
    *path, leaf = rest
    if leaf == "bias":
        return ".".join(out + path + ["b"])
    return ".".join(out + path + ["g" if path[-1].startswith("ln") else "w"])


def params_to_module(params: Dict[str, np.ndarray], cfg: WhisperConfig,
                     device=None) -> Whisper:
    """Carry flat params (the JAX package's layout) into a ``Whisper`` on
    ``device`` (default: the card), by ``carry.load_params``."""
    return load_params(lambda: Whisper(cfg), params, device, _module_name)


def module_to_params(model: Whisper) -> Dict[str, np.ndarray]:
    """The inverse carry: a ``Whisper``'s weights as flat [in, out] params."""
    out = {}
    for name, t in model.state_dict().items():
        k = _flat_name(name)
        out[k] = np.ascontiguousarray(flat_layout(k, t.detach().cpu().numpy()))
    return out
