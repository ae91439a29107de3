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

``make_train_step(mesh=...)`` is the JAX package's DP x TP step: the batch
over the mesh's data rows (within a process, and across processes over a
``multihost.ProcessMesh``), each GRU's and dense layer's matrices column-wise
over a row's model devices (``param_spec``). JAX's ``P(None, "model")`` cuts
a GRU's whole z|r|h gate axis into tp ranges, not each gate block, so a
product over a gate range runs on the pieces the range overlaps (``_lin``).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..dsp.rnnoise import constants as C
from ..dsp.rnnoise.weights import RNNoiseModel, deterministic_test_model
from . import Mesh, check_device
from .multihost import as_process_mesh

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


def param_spec(name: str, shape, tp: int) -> Tuple:
    """How the JAX step shards one training tensor over ``tp`` model
    devices (``crispy_tpu/parallel/train.py``'s ``param_spec``), as the
    PartitionSpec's tuple: ``.w``/``.u`` column-wise ``(None, "model")`` and
    ``.b`` ``("model",)`` where the last axis divides by tp, else ``()``
    (replicated)."""
    shape = tuple(shape)
    dim = shape[-1] if shape else 0
    if tp == 1 or dim % tp:
        return ()
    if name.endswith((".w", ".u")):
        return (None, "model")
    if name.endswith(".b"):
        return ("model",)
    return ()


class _Layer(nn.Module):
    """One layer's tensors on a data row's model devices ``row``: a tensor
    that ``param_spec`` splits is a ``ParameterList`` of column pieces,
    piece j on row[j], any other a ``Parameter`` on row[0]. Every tensor
    owns its storage, also where devices repeat."""

    def __init__(self, lname: str, arrays: Mapping[str, np.ndarray], row):
        super().__init__()
        for name, a in arrays.items():
            a = np.asarray(a, np.float32)
            if param_spec(f"{lname}.{name}", a.shape, len(row)):
                setattr(self, name, nn.ParameterList(
                    nn.Parameter(torch.tensor(p).to(d))
                    for p, d in zip(np.split(a, len(row), axis=-1), row)))
            else:
                self.register_parameter(name, nn.Parameter(torch.tensor(a).to(row[0])))


def _pieces(t) -> list:
    return list(t) if isinstance(t, nn.ParameterList) else [t]


ALL = slice(None)


def _lin(terms, b=None, lo: int = 0, hi=None) -> torch.Tensor:
    """The sum of x @ w[rows, lo:hi] over ``terms`` [(x, w, rows)], plus
    b[lo:hi]: w and b whole, or all in column pieces split alike. A
    piece's share runs on the piece's device and the shares are joined on
    the device of the first term's x; a product over a column range runs on
    the pieces that range overlaps."""
    x0, w0, _ = terms[0]
    if not isinstance(w0, nn.ParameterList):
        acc = None
        for x, w, rows in terms:
            y = x @ w[rows, lo:hi]
            acc = y if acc is None else acc + y
        return acc if b is None else acc + b[lo:hi]
    outs, c0 = [], 0
    for j, piece in enumerate(w0):
        c1 = c0 + piece.shape[-1]
        a, e = max(lo, c0), min(c1 if hi is None else hi, c1)
        if a < e:
            acc = None
            for x, w, rows in terms:
                y = x.to(w[j].device) @ w[j][rows, a - c0:e - c0]
                acc = y if acc is None else acc + y
            if b is not None:
                acc = acc + b[j][a - c0:e - c0]
            outs.append(acc.to(x0.device))
        c0 = c1
    return outs[0] if len(outs) == 1 else torch.cat(outs, -1)


class RNNoiseTrainNet(nn.Module):
    """The training net, built from a JAX training-params dict of NumPy
    arrays on ``device``; ``named_parameters()`` gives the dict's keys
    (``input_dense.w``, ..., ``denoise_gru.u``) and ``params_to_numpy`` the
    dict back.

    ``row`` (a mesh's data row of model devices, in place of ``device``)
    splits the net tensor-parallel as the JAX step does (``param_spec``):
    a split tensor's pieces are ``name.0``, ``name.1``, ... and each
    product runs piece by piece on the pieces' devices, joined on row[0]."""

    def __init__(self, params: Mapping[str, np.ndarray], device=None, row=None):
        super().__init__()
        if row is None:
            row = (resolve_device(device),)
        elif device is not None:
            raise ValueError("pass device or row, not both")
        missing = [k for k in PARAM_KEYS if k not in params]
        if missing:
            raise KeyError(f"training params lack {missing}")
        for lname in DENSE_LAYERS + GRU_LAYERS:
            parts = {k.split(".")[1]: params[k] for k in PARAM_KEYS if k.startswith(lname + ".")}
            self.add_module(lname, _Layer(lname, parts, tuple(row)))

    def params_to_numpy(self) -> Dict[str, np.ndarray]:
        """The parameters as a JAX training-params dict of NumPy arrays,
        split tensors joined from their pieces."""
        out = {}
        for k in PARAM_KEYS:
            lname, f = k.split(".")
            out[k] = np.concatenate([p.detach().cpu().numpy()
                                     for p in _pieces(getattr(getattr(self, lname), f))], -1)
        return out

    def forward(self, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """feats [B, T, 42] -> (gains [B, T, 22], vad [B, T])."""
        vg, ng, dg = self.vad_gru, self.noise_gru, self.denoise_gru
        B, T, _ = feats.shape
        na, nv, nn_ = C.INPUT_DENSE_SIZE, C.VAD_GRU_SIZE, C.NOISE_GRU_SIZE
        dense = torch.tanh(_lin([(feats, self.input_dense.w, ALL)], self.input_dense.b))
        # Input pre-activations, split by source: the parts that do not
        # depend on the recurrence for all frames at once.
        pre_v = _lin([(dense, vg.w, ALL)], vg.b)
        pre_n = _lin([(dense, ng.w, slice(None, na)), (feats, ng.w, slice(na + nv, None))], ng.b)
        pre_d = _lin([(feats, dg.w, slice(nv + nn_, None))], dg.b)
        vs = feats.new_zeros(B, nv)
        ns = feats.new_zeros(B, nn_)
        ds = feats.new_zeros(B, C.DENOISE_GRU_SIZE)
        v_states, d_states = [], []
        for t in range(T):
            vs = _gru(vg.u, vs, pre_v[:, t])
            ns = _gru(ng.u, ns, pre_n[:, t] + _lin([(vs, ng.w, slice(na, na + nv))]))
            ds = _gru(dg.u, ds, pre_d[:, t] + _lin([(vs, dg.w, slice(None, nv)),
                                                    (ns, dg.w, slice(nv, nv + nn_))]))
            v_states.append(vs)
            d_states.append(ds)
        vad = torch.sigmoid(_lin([(torch.stack(v_states, 1), self.vad_output.w, ALL)],
                                 self.vad_output.b))
        gains = torch.sigmoid(_lin([(torch.stack(d_states, 1), self.denoise_output.w, ALL)],
                                   self.denoise_output.b))
        return gains, vad[..., 0]


class ReplicatedTrainNet(nn.Module):
    """One ``RNNoiseTrainNet`` per data row of a mesh (``replicas``), each
    on its row's devices with tensors of its own. The mesh's step keeps the
    replicas equal; ``params_to_numpy`` gives the first one's dict."""

    def __init__(self, params: Mapping[str, np.ndarray], mesh: Mesh):
        super().__init__()
        self.replicas = nn.ModuleList(RNNoiseTrainNet(params, row=row) for row in mesh.grid)

    def params_to_numpy(self) -> Dict[str, np.ndarray]:
        return self.replicas[0].params_to_numpy()


def _gru(u, h: torch.Tensor, pre: torch.Tensor) -> torch.Tensor:
    """One GRU step from the input pre-activation ``pre`` = x @ w + b."""
    n = h.shape[-1]
    rec = _lin([(h, u, ALL)], hi=2 * n)  # the candidate block is recomputed on h*r below
    z = torch.sigmoid(pre[:, :n] + rec[:, :n])
    r = torch.sigmoid(pre[:, n: 2 * n] + rec[:, n:])
    cand = torch.relu(pre[:, 2 * n:] + _lin([(h * r, u, ALL)], lo=2 * n))
    return z * h + (1 - z) * cand


def forward(net: RNNoiseTrainNet, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats [B, T, 42] -> (gains [B, T, 22], vad [B, T]) with smooth acts."""
    return net(feats)


def loss_fn(net: RNNoiseTrainNet, batch: Mapping[str, torch.Tensor], total=None) -> torch.Tensor:
    """Perceptually-weighted gain loss (sqrt compression) + VAD BCE. With a
    ``mask`` [B, T] in the batch, the frames where it is 0 (silence) are
    left out: the masked loss of ``dsp.rnnoise.training.train_model``.

    ``total``, when ``batch`` is one shard of a batch, is what the whole
    batch's loss divides by: its frame count (B x T) unmasked, the sum of its
    mask (a tensor) masked. The shard's sums over the whole batch's counts
    add up over the shards to the batch's loss."""
    gains, vad = net(batch["features"])
    g_err = (torch.sqrt(gains + 1e-8) - torch.sqrt(batch["gains"] + 1e-8)) ** 2
    v = torch.clamp(vad, 1e-6, 1 - 1e-6)
    v_err = -(batch["vad"] * torch.log(v) + (1 - batch["vad"]) * torch.log(1 - v))
    mask = batch.get("mask")
    if mask is None:
        n = vad.numel() if total is None else total
        return torch.sum(g_err) / (n * C.NB_BANDS) + 0.5 * torch.sum(v_err) / n
    m = mask[..., None]
    count = torch.sum(mask) if total is None else total.to(mask.device)
    g_loss = torch.sum(m * g_err) / torch.clamp(count * C.NB_BANDS, min=1.0) * C.NB_BANDS
    v_loss = torch.sum(mask * v_err) / torch.clamp(count, min=1.0)
    return g_loss + 0.5 * v_loss


def adam(net: nn.Module, learning_rate) -> torch.optim.Adam:
    """optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0)."""
    return torch.optim.Adam(net.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def data_rows(mesh, batch_size: int) -> List[Tuple[slice, torch.device]]:
    """This process's share of a global batch of ``batch_size`` rows over
    a ``Mesh`` or ``ProcessMesh``: one (rows of the batch, device) per local
    data row. The batch must split evenly over the job's data rows, as the
    JAX step's ``P("data")`` requires."""
    pm = as_process_mesh(mesh)
    if batch_size % pm.global_dp:
        raise ValueError(f"a batch of {batch_size} rows does not split evenly over "
                         f"{pm.global_dp} data rows")
    b = batch_size // pm.global_dp
    return [(slice((pm.row_offset + i) * b, (pm.row_offset + i + 1) * b), d)
            for i, d in enumerate(pm.local.data_devices())]


def make_train_step(device=None, learning_rate: float = 1e-3, mesh=None):
    """The training step on ``device`` (default the card), or DP x TP over
    ``mesh``: a ``parallel.Mesh`` or a ``multihost.ProcessMesh``, ``device``
    then None or the mesh's first device.

    Returns (step_fn, to_device_params, to_device_batch, optimizer):
    ``to_device_params(params)`` makes the net from a training-params dict,
    ``optimizer(net)`` its Adam state (optax's ``opt.init``), and
    step_fn: (net, opt, batch) -> (net, opt, loss), the loss a device scalar.

    Over a mesh, the net is one replica per local data row (tensor-parallel
    over the row's model devices where ``param_spec`` splits), and
    ``to_device_batch`` takes the global batch (the same in every process)
    and keeps this process's rows, one dict per local data row
    (``data_rows``); step_fn takes that list. Each shard's loss divides by
    the whole batch's counts (the mask's sum is all-reduced across
    processes first), the shards' gradients are summed onto the first
    device and, with the loss, all-reduced across processes in one flat
    buffer, and every replica takes the same Adam step, so the replicas
    stay bit-equal. The returned loss is the whole batch's.
    """
    if mesh is None:
        dev = resolve_device(device)

        def to_device_params(params: Mapping[str, np.ndarray]) -> RNNoiseTrainNet:
            return RNNoiseTrainNet(params, dev)

        def to_device_batch(batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
            return {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in batch.items()}

        def step(net: RNNoiseTrainNet, opt: torch.optim.Adam, batch):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(net, batch)
            loss.backward()
            opt.step()
            return net, opt, loss.detach()

        return step, to_device_params, to_device_batch, lambda net: adam(net, learning_rate)

    pm = as_process_mesh(mesh)
    check_device(pm.local, device)
    dev0 = resolve_device(pm.local.first)

    def to_device_params(params: Mapping[str, np.ndarray]) -> ReplicatedTrainNet:
        return ReplicatedTrainNet(params, pm.local)

    def to_device_batch(batch: Mapping[str, np.ndarray]) -> List[Dict[str, torch.Tensor]]:
        arrays = {k: np.asarray(v) for k, v in batch.items()}
        rows = data_rows(pm, len(next(iter(arrays.values()))))
        return [{k: torch.from_numpy(np.ascontiguousarray(v[s])).to(d)
                 for k, v in arrays.items()} for s, d in rows]

    def all_reduce(t: torch.Tensor) -> torch.Tensor:
        if pm.process_count > 1:
            import torch.distributed as dist

            dist.all_reduce(t)
        return t

    def step(net: ReplicatedTrainNet, opt: torch.optim.Adam, batch):
        if len(batch) != len(net.replicas):
            raise ValueError(f"{len(batch)} shards for {len(net.replicas)} replicas")
        opt.zero_grad(set_to_none=True)
        if "mask" in batch[0]:
            total = all_reduce(sum(torch.sum(p["mask"]).to(dev0) for p in batch))
        else:
            total = pm.global_dp * batch[0]["vad"].numel()
        loss = sum(loss_fn(rep, part, total).to(dev0) for rep, part in zip(net.replicas, batch))
        loss.backward()
        params = [list(rep.parameters()) for rep in net.replicas]
        grads = None
        for ps in params:
            g = torch.cat([p.grad.reshape(-1).to(dev0) for p in ps])
            grads = g if grads is None else grads + g
        flat = all_reduce(torch.cat([grads, loss.detach().reshape(1)]))
        for ps in params:
            off = 0
            for p in ps:
                p.grad.copy_(flat[off: off + p.numel()].view_as(p))
                off += p.numel()
        opt.step()
        return net, opt, flat[-1]

    return step, to_device_params, to_device_batch, lambda net: adam(net, learning_rate)


def synthetic_batch(batch_size: int, n_frames: int, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "features": rng.standard_normal((batch_size, n_frames, C.NB_FEATURES)).astype(np.float32),
        "gains": rng.uniform(0, 1, (batch_size, n_frames, C.NB_BANDS)).astype(np.float32),
        "vad": (rng.uniform(0, 1, (batch_size, n_frames)) > 0.5).astype(np.float32),
    }

