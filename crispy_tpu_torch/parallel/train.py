"""RNNoise training net and step (the port of ``crispy_tpu/parallel/train.py``).

The gain/VAD network trained with smooth activations (the tansig table is
an inference-time approximation), MSE on per-band gains + BCE on VAD: the
public RNNoise training objective family. The GRU is the JAX package's:
gates z|r|h on the output axis, the candidate ``relu(pre_h + (h*r) @ u[:, 2N:])``.

The backward is autograd through plain PyTorch: K1 (``rnn_kernels.nn_scan``)
is forward-only on the int8-grid tansig tables, and the JAX package trains
through a plain scan as well. The forward hoists every product that does not
depend on the recurrence out of the frame loop (the input dense layer, the
VAD GRU's input and the feature parts of the noise and denoise GRUs' inputs);
the loop keeps only the recurrent products.

The JAX package shards the step DP x TP over a mesh; here it runs on one
device (multi-GPU is ROADMAP item 12c).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..dsp.rnnoise import constants as C
from ..dsp.rnnoise.weights import RNNoiseModel, deterministic_test_model

DENSE_LAYERS = ("input_dense", "denoise_output", "vad_output")
GRU_LAYERS = ("vad_gru", "noise_gru", "denoise_gru")
# The JAX dict's key order: train_model draws its random init in this order.
PARAM_KEYS = tuple(f"{n}.{p}" for n in DENSE_LAYERS for p in ("w", "b")) + tuple(
    f"{n}.{p}" for n in GRU_LAYERS for p in ("w", "u", "b"))


def init_train_params(model: RNNoiseModel | None = None, seed: int = 0) -> Dict[str, np.ndarray]:
    """Float training parameters (optionally warm-started from a model), as
    NumPy arrays under the JAX package's keys and in its order."""
    model = model or deterministic_test_model(seed)
    out: Dict[str, np.ndarray] = {}
    for lname in DENSE_LAYERS:
        layer = getattr(model, lname)
        out[f"{lname}.w"] = np.asarray(layer.w, np.float32)
        out[f"{lname}.b"] = np.asarray(layer.b, np.float32)
    for lname in GRU_LAYERS:
        g = getattr(model, lname)
        out[f"{lname}.w"] = np.asarray(g.w, np.float32)
        out[f"{lname}.u"] = np.asarray(g.u, np.float32)
        out[f"{lname}.b"] = np.asarray(g.b, np.float32)
    return out


class _Layer(nn.Module):
    def __init__(self, arrays: Mapping[str, np.ndarray], device: torch.device):
        super().__init__()
        for name, a in arrays.items():
            self.register_parameter(name, nn.Parameter(
                torch.as_tensor(np.array(a, np.float32)).to(device)))


class RNNoiseTrainNet(nn.Module):
    """The training net, built from a JAX training-params dict of NumPy
    arrays on ``device``; ``named_parameters()`` gives the dict's keys
    (``input_dense.w``, ..., ``denoise_gru.u``) and ``params_to_numpy`` the
    dict back."""

    def __init__(self, params: Mapping[str, np.ndarray], device=None):
        super().__init__()
        dev = resolve_device(device)
        missing = [k for k in PARAM_KEYS if k not in params]
        if missing:
            raise KeyError(f"training params lack {missing}")
        for lname in DENSE_LAYERS + GRU_LAYERS:
            parts = {k.split(".")[1]: params[k] for k in PARAM_KEYS if k.startswith(lname + ".")}
            self.add_module(lname, _Layer(parts, dev))

    def params_to_numpy(self) -> Dict[str, np.ndarray]:
        """The parameters as a JAX training-params dict of NumPy arrays."""
        named = dict(self.named_parameters())
        return {k: named[k].detach().cpu().numpy() for k in PARAM_KEYS}

    def forward(self, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """feats [B, T, 42] -> (gains [B, T, 22], vad [B, T])."""
        vg, ng, dg = self.vad_gru, self.noise_gru, self.denoise_gru
        B, T, _ = feats.shape
        na, nv, nn_ = C.INPUT_DENSE_SIZE, C.VAD_GRU_SIZE, C.NOISE_GRU_SIZE
        dense = torch.tanh(feats @ self.input_dense.w + self.input_dense.b)
        # Input pre-activations, split by source: the parts that do not
        # depend on the recurrence for all frames at once.
        pre_v = dense @ vg.w + vg.b
        pre_n = dense @ ng.w[:na] + feats @ ng.w[na + nv:] + ng.b
        pre_d = feats @ dg.w[nv + nn_:] + dg.b
        vs = feats.new_zeros(B, nv)
        ns = feats.new_zeros(B, nn_)
        ds = feats.new_zeros(B, C.DENOISE_GRU_SIZE)
        v_states, d_states = [], []
        for t in range(T):
            vs = _gru(vg.u, vs, pre_v[:, t])
            ns = _gru(ng.u, ns, pre_n[:, t] + vs @ ng.w[na: na + nv])
            ds = _gru(dg.u, ds, pre_d[:, t] + vs @ dg.w[:nv] + ns @ dg.w[nv: nv + nn_])
            v_states.append(vs)
            d_states.append(ds)
        vad = torch.sigmoid(torch.stack(v_states, 1) @ self.vad_output.w + self.vad_output.b)
        gains = torch.sigmoid(torch.stack(d_states, 1) @ self.denoise_output.w
                              + self.denoise_output.b)
        return gains, vad[..., 0]


def _gru(u: torch.Tensor, h: torch.Tensor, pre: torch.Tensor) -> torch.Tensor:
    """One GRU step from the input pre-activation ``pre`` = x @ w + b."""
    n = u.shape[0]
    rec = h @ u[:, : 2 * n]  # the candidate block is recomputed on h*r below
    z = torch.sigmoid(pre[:, :n] + rec[:, :n])
    r = torch.sigmoid(pre[:, n: 2 * n] + rec[:, n:])
    cand = torch.relu(pre[:, 2 * n:] + (h * r) @ u[:, 2 * n:])
    return z * h + (1 - z) * cand


def forward(net: RNNoiseTrainNet, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats [B, T, 42] -> (gains [B, T, 22], vad [B, T]) with smooth acts."""
    return net(feats)


def loss_fn(net: RNNoiseTrainNet, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Perceptually-weighted gain loss (sqrt compression) + VAD BCE. With a
    ``mask`` [B, T] in the batch, the frames where it is 0 (silence) are
    left out: the masked loss of ``dsp.rnnoise.training.train_model``."""
    gains, vad = net(batch["features"])
    g_err = (torch.sqrt(gains + 1e-8) - torch.sqrt(batch["gains"] + 1e-8)) ** 2
    v = torch.clamp(vad, 1e-6, 1 - 1e-6)
    v_err = -(batch["vad"] * torch.log(v) + (1 - batch["vad"]) * torch.log(1 - v))
    mask = batch.get("mask")
    if mask is None:
        return torch.mean(g_err) + 0.5 * torch.mean(v_err)
    m = mask[..., None]
    g_loss = torch.sum(m * g_err) / torch.clamp(torch.sum(m) * C.NB_BANDS, min=1.0) * C.NB_BANDS
    v_loss = torch.sum(mask * v_err) / torch.clamp(torch.sum(mask), min=1.0)
    return g_loss + 0.5 * v_loss


def adam(net: nn.Module, learning_rate) -> torch.optim.Adam:
    """optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0)."""
    return torch.optim.Adam(net.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def make_train_step(device=None, learning_rate: float = 1e-3):
    """The training step on ``device`` (default the card).

    Returns (step_fn, to_device_params, to_device_batch, optimizer):
    ``to_device_params(params)`` makes the net from a training-params dict,
    ``optimizer(net)`` its Adam state (optax's ``opt.init``), and
    step_fn: (net, opt, batch) -> (net, opt, loss), the loss a device scalar.
    """
    dev = resolve_device(device)

    def to_device_params(params: Mapping[str, np.ndarray]) -> RNNoiseTrainNet:
        return RNNoiseTrainNet(params, dev)

    def to_device_batch(batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in batch.items()}

    def optimizer(net: RNNoiseTrainNet) -> torch.optim.Adam:
        return adam(net, learning_rate)

    def step(net: RNNoiseTrainNet, opt: torch.optim.Adam, batch):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(net, batch)
        loss.backward()
        opt.step()
        return net, opt, loss.detach()

    return step, to_device_params, to_device_batch, optimizer


def synthetic_batch(batch_size: int, n_frames: int, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "features": rng.standard_normal((batch_size, n_frames, C.NB_FEATURES)).astype(np.float32),
        "gains": rng.uniform(0, 1, (batch_size, n_frames, C.NB_BANDS)).astype(np.float32),
        "vad": (rng.uniform(0, 1, (batch_size, n_frames)) > 0.5).astype(np.float32),
    }

