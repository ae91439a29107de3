"""RNNoise model weights: container, canonical .npz format, and importers.

The network (public RNNoise architecture, consumed by the reference through
nnnoiseless — src-tauri/src/audio.rs:268):

    input_dense    42 -> 24   tanh
    vad_gru        24 -> 24   GRU (relu candidate)
    vad_output     24 -> 1    sigmoid
    noise_gru      90 -> 48   GRU (relu candidate)   in = [dense, vad_state, feats]
    denoise_gru   114 -> 96   GRU (relu candidate)   in = [vad_state, noise_state, feats]
    denoise_output 96 -> 22   sigmoid (per-band gains)

Weight conventions in this package: every matrix is stored as float32
``[in_dim, out_dim]`` so that ``y = x @ W + b``. GRU matrices hold the three
gates **concatenated on the output axis in (update z, reset r, candidate h)
order**: ``W: [in, 3N]``, ``U: [N, 3N]``, ``b: [3N]``.

The C/nnnoiseless weights are int8 quantized with scale 1/256 and laid out
column-major with gate-major stride 3N; ``from_c_layout`` converts that exact
layout (use it to import a dump of rnn_data.c / a model file) into this
container. Without network access this repo cannot ship the original trained
weights; ``deterministic_test_model`` builds a seeded stand-in with the same
shapes/quantization so every numerical-parity test and benchmark exercises the
true compute path. Drop a real ``rnnoise.npz`` into the models dir to get true
denoising quality.

The PyTorch port's own copy of ``crispy_tpu/dsp/rnnoise/weights.py`` (the port
imports nothing of the JAX package), plus ``params_from_numpy``, which carries
a parameter dict built by the JAX package across to the port.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Mapping, Union

import numpy as np

from .constants import (
    DENOISE_GRU_SIZE,
    INPUT_DENSE_SIZE,
    NB_BANDS,
    NB_FEATURES,
    NOISE_GRU_SIZE,
    VAD_GRU_SIZE,
    WEIGHTS_SCALE,
)

PathLike = Union[str, Path]

NOISE_INPUT_SIZE = INPUT_DENSE_SIZE + VAD_GRU_SIZE + NB_FEATURES  # 90
DENOISE_INPUT_SIZE = VAD_GRU_SIZE + NOISE_GRU_SIZE + NB_FEATURES  # 114


@dataclass
class Dense:
    w: np.ndarray  # [in, out]
    b: np.ndarray  # [out]
    activation: str  # "tanh" | "sigmoid" | "relu"


@dataclass
class GRU:
    w: np.ndarray  # [in, 3N] gates (z, r, h)
    u: np.ndarray  # [N, 3N]
    b: np.ndarray  # [3N]
    activation: str = "relu"  # candidate activation

    @property
    def n(self) -> int:
        return self.u.shape[0]


@dataclass
class RNNoiseModel:
    input_dense: Dense
    vad_gru: GRU
    noise_gru: GRU
    denoise_gru: GRU
    denoise_output: Dense
    vad_output: Dense
    name: str = "unnamed"

    def state_sizes(self) -> Dict[str, int]:
        return {
            "vad": self.vad_gru.n,
            "noise": self.noise_gru.n,
            "denoise": self.denoise_gru.n,
        }

    # -- canonical npz round-trip -------------------------------------------
    def save(self, path: PathLike) -> Path:
        arrs: Dict[str, np.ndarray] = {}
        for lname in ("input_dense", "denoise_output", "vad_output"):
            layer: Dense = getattr(self, lname)
            arrs[f"{lname}.w"] = layer.w
            arrs[f"{lname}.b"] = layer.b
            arrs[f"{lname}.act"] = np.array(layer.activation)
        for lname in ("vad_gru", "noise_gru", "denoise_gru"):
            gru: GRU = getattr(self, lname)
            arrs[f"{lname}.w"] = gru.w
            arrs[f"{lname}.u"] = gru.u
            arrs[f"{lname}.b"] = gru.b
            arrs[f"{lname}.act"] = np.array(gru.activation)
        arrs["name"] = np.array(self.name)
        path = Path(path)
        np.savez(path, **arrs)
        return path

    @staticmethod
    def load(path: PathLike) -> "RNNoiseModel":
        z = np.load(path, allow_pickle=False)

        def dense(lname: str) -> Dense:
            return Dense(z[f"{lname}.w"], z[f"{lname}.b"], str(z[f"{lname}.act"]))

        def gru(lname: str) -> GRU:
            return GRU(z[f"{lname}.w"], z[f"{lname}.u"], z[f"{lname}.b"], str(z[f"{lname}.act"]))

        return RNNoiseModel(
            input_dense=dense("input_dense"),
            vad_gru=gru("vad_gru"),
            noise_gru=gru("noise_gru"),
            denoise_gru=gru("denoise_gru"),
            denoise_output=dense("denoise_output"),
            vad_output=dense("vad_output"),
            name=str(z["name"]) if "name" in z else "unnamed",
        )


def _dense_from_c(flat_w: np.ndarray, flat_b: np.ndarray, nb_in: int, nb_out: int, act: str) -> Dense:
    """C layout: input_weights[j*N + i] (j = input, i = neuron) already equals
    row-major [in, out]; both weights and bias carry the 1/256 scale."""
    w = np.asarray(flat_w, dtype=np.float32).reshape(nb_in, nb_out) * WEIGHTS_SCALE
    b = np.asarray(flat_b, dtype=np.float32) * WEIGHTS_SCALE
    return Dense(w, b, act)


def _gru_from_c(
    flat_w: np.ndarray, flat_u: np.ndarray, flat_b: np.ndarray, nb_in: int, n: int, act: str
) -> GRU:
    """C layout: stride 3N; gate g's weight for input j, neuron i sits at
    [g*N + j*3N + i]. Reshaping [in, 3, N] then flattening the last two axes
    gives our [in, 3N] (z|r|h) convention."""
    w = np.asarray(flat_w, dtype=np.float32).reshape(nb_in, 3, n).reshape(nb_in, 3 * n)
    u = np.asarray(flat_u, dtype=np.float32).reshape(n, 3, n).reshape(n, 3 * n)
    b = np.asarray(flat_b, dtype=np.float32).reshape(3 * n)
    return GRU(w * WEIGHTS_SCALE, u * WEIGHTS_SCALE, b * WEIGHTS_SCALE, act)


def from_c_layout(arrays: Dict[str, np.ndarray], name: str = "imported") -> RNNoiseModel:
    """Build a model from flat int arrays in the C rnn_data layout.

    Expected keys: ``{layer}_weights`` / ``{layer}_recurrent_weights`` /
    ``{layer}_bias`` for input_dense, vad_gru, noise_gru, denoise_gru,
    denoise_output, vad_output (recurrent only for GRUs).
    """
    return RNNoiseModel(
        input_dense=_dense_from_c(
            arrays["input_dense_weights"], arrays["input_dense_bias"], NB_FEATURES, INPUT_DENSE_SIZE, "tanh"
        ),
        vad_gru=_gru_from_c(
            arrays["vad_gru_weights"], arrays["vad_gru_recurrent_weights"], arrays["vad_gru_bias"],
            INPUT_DENSE_SIZE, VAD_GRU_SIZE, "relu",
        ),
        noise_gru=_gru_from_c(
            arrays["noise_gru_weights"], arrays["noise_gru_recurrent_weights"], arrays["noise_gru_bias"],
            NOISE_INPUT_SIZE, NOISE_GRU_SIZE, "relu",
        ),
        denoise_gru=_gru_from_c(
            arrays["denoise_gru_weights"], arrays["denoise_gru_recurrent_weights"], arrays["denoise_gru_bias"],
            DENOISE_INPUT_SIZE, DENOISE_GRU_SIZE, "relu",
        ),
        denoise_output=_dense_from_c(
            arrays["denoise_output_weights"], arrays["denoise_output_bias"], DENOISE_GRU_SIZE, NB_BANDS, "sigmoid"
        ),
        vad_output=_dense_from_c(
            arrays["vad_output_weights"], arrays["vad_output_bias"], VAD_GRU_SIZE, 1, "sigmoid"
        ),
        name=name,
    )


def deterministic_test_model(seed: int = 1234) -> RNNoiseModel:
    """Seeded int8-quantized stand-in model with the production shapes.

    Weight magnitudes are kept small so GRU dynamics stay stable and gains
    land strictly inside (0, 1), exercising every numerical path (including
    the tansig table approximation) identically to a trained model.
    """
    rng = np.random.default_rng(seed)

    def q(shape, scale=24):
        return rng.integers(-scale, scale + 1, size=shape).astype(np.float32)

    arrays = {
        "input_dense_weights": q(NB_FEATURES * INPUT_DENSE_SIZE),
        "input_dense_bias": q(INPUT_DENSE_SIZE, 64),
        "vad_gru_weights": q(INPUT_DENSE_SIZE * 3 * VAD_GRU_SIZE),
        "vad_gru_recurrent_weights": q(VAD_GRU_SIZE * 3 * VAD_GRU_SIZE),
        "vad_gru_bias": q(3 * VAD_GRU_SIZE, 64),
        "noise_gru_weights": q(NOISE_INPUT_SIZE * 3 * NOISE_GRU_SIZE, 12),
        "noise_gru_recurrent_weights": q(NOISE_GRU_SIZE * 3 * NOISE_GRU_SIZE, 12),
        "noise_gru_bias": q(3 * NOISE_GRU_SIZE, 64),
        "denoise_gru_weights": q(DENOISE_INPUT_SIZE * 3 * DENOISE_GRU_SIZE, 8),
        "denoise_gru_recurrent_weights": q(DENOISE_GRU_SIZE * 3 * DENOISE_GRU_SIZE, 8),
        "denoise_gru_bias": q(3 * DENOISE_GRU_SIZE, 64),
        "denoise_output_weights": q(DENOISE_GRU_SIZE * NB_BANDS, 48),
        "denoise_output_bias": q(NB_BANDS, 127),
        "vad_output_weights": q(VAD_GRU_SIZE * 1, 48),
        "vad_output_bias": q(1, 64),
    }
    return from_c_layout(arrays, name=f"test-seed{seed}")


def _models_dir() -> Path:
    """User model directory: ``$CRISPY_DATA_DIR/Models``, else
    ``~/Documents/Crispy/Models`` (the JAX package's ``utils.paths``)."""
    root = os.environ.get("CRISPY_DATA_DIR")
    if root:
        return Path(root) / "Models"
    return Path(os.environ.get("HOME", "~")).expanduser() / "Documents" / "Crispy" / "Models"


_BUILTIN: RNNoiseModel | None = None


def builtin_model() -> RNNoiseModel:
    """The model used when none is configured.

    Priority: ``rnnoise.npz`` in the user models dir (drop-in for the
    original trained weights) → the packaged model trained in-repo on
    synthetic mixtures (byte-identical to the JAX package's) → the
    deterministic test model.
    """
    global _BUILTIN
    if _BUILTIN is None:
        cand = _models_dir() / "rnnoise.npz"
        packaged = Path(__file__).with_name("builtin_weights.npz")
        if cand.exists():
            _BUILTIN = RNNoiseModel.load(cand)
        elif packaged.exists():
            _BUILTIN = RNNoiseModel.load(packaged)
        else:
            _BUILTIN = deterministic_test_model()
    return _BUILTIN


def params_from_numpy(np_params: Mapping[str, np.ndarray], device=None) -> Dict[str, "torch.Tensor"]:
    """The port's parameter dict from a parameter dict of NumPy arrays with
    the JAX package's keys (its ``make_params`` output, each value passed
    through ``np.asarray``). Keys the port's pipeline does not read (the
    TPU-only matmul-DFT, radix and fused-frontend tables) are dropped;
    the values are copied unchanged, f32 stays f32 and int32 stays int32."""
    import torch

    from ...device import resolve_device
    from .pipeline import PARAM_KEYS

    dev = resolve_device(device)
    missing = [k for k in PARAM_KEYS if k not in np_params]
    if missing:
        raise KeyError(f"parameter dict lacks {missing}")
    return {k: torch.as_tensor(np.array(np_params[k])).to(dev) for k in PARAM_KEYS}
