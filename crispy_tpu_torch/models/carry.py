"""The carry of the JAX package's flat parameter dicts into the port's modules.

The JAX package keeps each ASR family's and each diarization net's weights
as one flat dict of numpy arrays (what a prepared bundle's ``params.npz``
holds): names such as ``enc.3.attn.q.w``, matmul-ready ``[in, out]``
matrices (LSTM gate kernels too), ``HIO`` and ``HWIO`` convolution kernels,
norms folded to a gain and a bias. The port's modules name the same tensors
``enc.layers.3.attn.q.weight`` in torch's layouts. ``load_params`` builds a
module on the meta device and assigns the carried tensors to it, so the
module and the JAX package compute the same thing from the same dict.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from ..device import resolve_device

_INDEX = re.compile(r"\.(\d+)(?=\.|$)")
_LEAVES = {"w": "weight", "g": "weight", "b": "bias"}
_LSTM = re.compile(r"^(.*)\.(\d+)\.([fb])\.(ih|hh)\.([wb])$")


def module_name(flat: str) -> str:
    """enc.3.attn.q.w → enc.layers.3.attn.q.weight: every layer index sits
    under a ``layers`` list; the leaves w and g (a norm's gain) become
    weight, b becomes bias; any other name is kept. A layer of a
    bidirectional LSTM, lstm.2.b.ih.w (layer 2, backward direction, [D, 4H]
    input kernel), becomes nn.LSTM's lstm.weight_ih_l2_reverse."""
    m = _LSTM.match(flat)
    if m:
        path, layer, direction, kind, leaf = m.groups()
        suffix = "_reverse" if direction == "b" else ""
        return f"{path}.{_LEAVES[leaf]}_{kind}_l{layer}{suffix}"
    name = _INDEX.sub(r".layers.\1", flat)
    path, _, leaf = name.rpartition(".")
    if path and leaf in _LEAVES:
        return f"{path}.{_LEAVES[leaf]}"
    return name


def torch_layout(flat: str, a: np.ndarray) -> np.ndarray:
    """A ``.w`` kernel in torch's layout: [in, out] → [out, in] (nn.Linear),
    HIO [k, in, out] → [out, in, k] (conv1d, grouped and depthwise too),
    HWIO [kh, kw, in, out] → OIHW (conv2d); anything else as it is."""
    if flat.endswith(".w"):
        if a.ndim == 2:
            return a.T
        if a.ndim == 3:
            return a.transpose(2, 1, 0)
        if a.ndim == 4:
            return a.transpose(3, 2, 0, 1)
    return a


def flat_layout(flat: str, a: np.ndarray) -> np.ndarray:
    """The inverse of ``torch_layout``: a module's kernel back in the flat
    dict's layout."""
    if flat.endswith(".w") and a.ndim == 4:
        return a.transpose(2, 3, 1, 0)
    return torch_layout(flat, a)  # the 2-D and 3-D transposes are their own inverse


def load_hf_state_dict(path: Path) -> Dict[str, np.ndarray]:
    """An HF checkpoint directory's weights as numpy arrays
    (``model.safetensors``, else ``pytorch_model.bin``)."""
    st = path / "model.safetensors"
    if st.exists():
        from safetensors.numpy import load_file  # not on every machine: only here

        return load_file(st)
    pt = path / "pytorch_model.bin"
    if not pt.exists():
        raise FileNotFoundError(f"no checkpoint in {path}")
    sd = torch.load(pt, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in sd.items()}


def hf_tokenizer(path: Path):
    """The directory's ``tokenizer.json`` as a ``tokenizers.Tokenizer``, or None."""
    if not (path / "tokenizer.json").exists():
        return None
    from tokenizers import Tokenizer  # not on every machine: only here

    return Tokenizer.from_file(str(path / "tokenizer.json"))


def load_params(make: Callable[[], nn.Module], params: Dict[str, np.ndarray],
                device=None, rename: Callable[[str], str] = module_name) -> nn.Module:
    """``make()`` built on the meta device, then every flat param carried
    into it on ``device`` (default: the card); strict, so a missing or extra
    name raises. The module is for inference: its weights take no gradient."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = make()
    state = {}
    for k, v in params.items():
        a = torch_layout(k, np.asarray(v, np.float32))
        # a copy only where the array is strided or read-only (an ONNX file's buffers)
        state[rename(k)] = torch.from_numpy(np.require(a, requirements="CW")).to(dev)
    model.load_state_dict(state, strict=True, assign=True)
    return model.eval().requires_grad_(False)
