"""The pipeline's two frame recurrences: K1, the GRU network scan, and K2,
the remove_doubling continuation scan (the port of ``pallas_rnn.py``).

Each wrapper takes its plain PyTorch version for tensors on the CPU and
launches its CUDA kernel (``csrc/nn_scan.cu``, ``csrc/rd_scan.cu``) for
tensors on the card, or raises; it never falls back. ``<wrapper>.launches``
counts the kernel launches, so a run can show it went through the kernel.

K1 has two variants, chosen from the weights, not on failure: the resident
one (weights in shared memory as fp16, counted in ``nn_scan.launches``) when
every weight is exact in fp16, as on the int8/256 grid of every RNNoise
model, and the f32 one (``nn_scan.launches_f32``) for any other weights.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ... import _build
from . import constants as C

NB = C.NB_BANDS
_VAD, _NOI, _DEN = C.VAD_GRU_SIZE, C.NOISE_GRU_SIZE, C.DENOISE_GRU_SIZE
_STATE = _VAD + _NOI + _DEN + NB  # 190
_RD_W = 74  # packed remove_doubling row (see pipeline._pitch_index)

_NN_WEIGHTS = (
    "input_dense.w", "input_dense.b",
    "vad_gru.w", "vad_gru.u", "vad_gru.b",
    "noise_gru.w", "noise_gru.u", "noise_gru.b",
    "denoise_gru.w", "denoise_gru.u", "denoise_gru.b",
    "denoise_output.w", "denoise_output.b",
    "vad_output.w", "vad_output.b",
    "tansig_table",
)


# The resident K1's packed weights: (key, input rows, output columns, G lanes
# per column), in the order of the W_* offsets in csrc/nn_scan.cu.
_SEGMENTS = (
    ("input_dense.w", (0, 42), (0, 24), 2),
    ("vad_gru.u", (0, 24), (0, 48), 1),
    ("denoise_output.w", (0, 96), (0, 22), 4),
    ("noise_gru.u", (0, 48), (0, 96), 2),
    ("denoise_gru.w", (72, 114), (0, 96), 2),
    ("vad_gru.w", (0, 24), (0, 72), 1),
    ("noise_gru.w", (0, 24), (0, 144), 1),
    ("noise_gru.w", (48, 90), (0, 144), 2),
    ("vad_gru.u", (0, 24), (48, 72), 1),
    ("denoise_gru.u", (0, 96), (0, 96), 4),
    ("denoise_gru.w", (72, 114), (96, 192), 2),
    ("noise_gru.w", (24, 48), (0, 144), 1),
    ("vad_output.w", (0, 24), (0, 1), 1),
    ("denoise_gru.w", (0, 24), (0, 288), 1),
    ("noise_gru.u", (0, 48), (96, 144), 2),
    ("denoise_gru.u", (0, 96), (96, 192), 4),
    ("denoise_gru.w", (72, 114), (192, 288), 2),
    ("denoise_gru.w", (24, 72), (0, 288), 2),
    ("denoise_gru.u", (0, 96), (192, 288), 4),
)
_STEPS = 12  # (even, odd) row pairs a lane multiplies per tile
_RUNS = 3  # runs of 4 pairs, one 16-byte word each
_MATRICES = tuple(k for k in _NN_WEIGHTS if k.endswith((".w", ".u")))
_BIASES = tuple(k for k in _NN_WEIGHTS if k.endswith(".b"))


def _on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the card, False when all lie on the
    CPU; a mix raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors on mixed or unsupported devices: {sorted(kinds)}")


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Tuple[int, ...]) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} {shape}, got "
                         f"{'contiguous' if t.is_contiguous() else 'strided'} "
                         f"{t.dtype} {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# tansig / sigmoid (the table branch of jax_pipeline._tansig)
# ---------------------------------------------------------------------------

def _tansig(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """tansig_approx: table-interpolated tanh, matching the oracle exactly."""
    sign = torch.where(x < 0, -1.0, 1.0).to(torch.float32)
    ax = torch.abs(x)
    fi = torch.clamp(torch.floor(0.5 + 25.0 * torch.nan_to_num(ax)), 0.0, 200.0)
    dx = ax - 0.04 * fi
    y = table[fi.to(torch.int64)]
    dy = 1.0 - y * y
    y = y + dx * dy * (1.0 - y * dx)
    out = sign * y
    out = torch.where(x >= 8.0, 1.0, torch.where(x <= -8.0, -1.0, out))
    return torch.where(torch.isnan(x), 0.0, out).to(torch.float32)


def _sigmoid(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return 0.5 + 0.5 * _tansig(table, 0.5 * x)


# ---------------------------------------------------------------------------
# K1: the GRU network scan
# ---------------------------------------------------------------------------

def _gru_step(params, table, prefix: str, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    w, u, b = params[f"{prefix}.w"], params[f"{prefix}.u"], params[f"{prefix}.b"]
    n = u.shape[0]
    pre_in = x @ w + b
    rec_zr = h @ u[:, : 2 * n]
    z = _sigmoid(table, pre_in[:, :n] + rec_zr[:, :n])
    r = _sigmoid(table, pre_in[:, n: 2 * n] + rec_zr[:, n:])
    hcand = pre_in[:, 2 * n:] + (h * r) @ u[:, 2 * n:]
    hcand = torch.clamp_min(hcand, 0.0)  # relu candidate
    return z * h + (1.0 - z) * hcand


def nn_scan_reference(params, state, feats: torch.Tensor, silence: torch.Tensor):
    """Plain version of K1: feats [S, F, 42], silence [S, F] bool →
    ((graw [S, F, 22], gsmooth [S, F, 22], vad [S, F]), new GRU/lastg state)."""
    table = params["tansig_table"]
    vad_s, noi_s, den_s, lastg = (state["gru_vad"], state["gru_noise"],
                                  state["gru_denoise"], state["lastg"])
    alpha = float(np.float32(C.ALPHA_LASTG))
    graws, gss, vads = [], [], []
    for f in range(feats.shape[1]):
        x, sil = feats[:, f], silence[:, f]
        keep = sil[:, None]
        dense = _tansig(table, x @ params["input_dense.w"] + params["input_dense.b"])
        vad_s = torch.where(keep, vad_s, _gru_step(params, table, "vad_gru", vad_s, dense))
        vad_p = _sigmoid(table, vad_s @ params["vad_output.w"] + params["vad_output.b"])[:, 0]
        noise_in = torch.cat([dense, vad_s, x], dim=-1)
        noi_s = torch.where(keep, noi_s, _gru_step(params, table, "noise_gru", noi_s, noise_in))
        den_in = torch.cat([vad_s, noi_s, x], dim=-1)
        den_s = torch.where(keep, den_s, _gru_step(params, table, "denoise_gru", den_s, den_in))
        graw = _sigmoid(table, den_s @ params["denoise_output.w"] + params["denoise_output.b"])
        gs = torch.maximum(graw, alpha * lastg)
        lastg = torch.where(keep, lastg, gs)
        graws.append(graw)
        gss.append(gs)
        vads.append(torch.where(sil, 0.0, vad_p))
    outs = (torch.stack(graws, 1), torch.stack(gss, 1), torch.stack(vads, 1))
    return outs, {"gru_vad": vad_s, "gru_noise": noi_s, "gru_denoise": den_s, "lastg": lastg}


def exact_in_half(params) -> bool:
    """True when every weight matrix of K1 holds only values that fp16
    represents exactly (``w.to(float16).float() == w`` everywhere)."""
    return all(bool((params[k].to(torch.float16).float() == params[k]).all())
               for k in _MATRICES)


def pack_half_weights(params) -> torch.Tensor:
    """The resident K1's weights as one fp16 vector of (even, odd) input-row
    pairs, segment by segment (``_SEGMENTS``), each warp tile in the order its
    lanes read it: a tile is 3 runs x 32 lanes of 16-byte words; the word of
    (run, lane), lane = cg * G + g, holds the pairs p = (run * G + g) * 4 + i,
    i < 4 (rows 2p, 2p + 1), of column tile * (32 / G) + cg. Pairs and
    columns past the segment's edge are 0. Only for weights that
    ``exact_in_half`` accepts: the cast is exact."""
    parts = []
    for key, (r0, r1), (c0, c1), G in _SEGMENTS:
        m = params[key][r0:r1, c0:c1]
        cpt = 32 // G
        ntiles = -(-(c1 - c0) // cpt)
        if (r1 - r0) > 2 * _STEPS * G:
            raise ValueError(f"segment {key}[{r0}:{r1}] needs more than {_STEPS} pairs a lane")
        pad = torch.zeros((2 * _STEPS * G, ntiles * cpt), dtype=m.dtype, device=m.device)
        pad[: r1 - r0, : c1 - c0] = m
        # rows (run, g, pair in run, half), columns (tile, cg)
        # -> (tile, run, cg, g, pair in run, half)
        tiles = pad.reshape(_RUNS, G, 4, 2, ntiles, cpt).permute(4, 0, 5, 1, 2, 3)
        parts.append(tiles.reshape(-1))
    return torch.cat(parts).to(torch.float16).contiguous()


_HALF_WEIGHTS = {}  # (device, (id, version) of each matrix) -> (matrices, packed or None)


def _half_weights(params):
    """pack_half_weights(params), or None when the weights are not exact in
    fp16; computed once per parameter set and device."""
    mats = [params[k] for k in _MATRICES]
    key = (mats[0].device, tuple((id(m), m._version) for m in mats))
    if key not in _HALF_WEIGHTS:
        for k in [k for k in _HALF_WEIGHTS if k[0] == key[0]]:
            del _HALF_WEIGHTS[k]  # one parameter set per device at a time
        _HALF_WEIGHTS[key] = (mats, pack_half_weights(params) if exact_in_half(params) else None)
    return _HALF_WEIGHTS[key][1]


def nn_scan(params, state, feats: torch.Tensor, silence: torch.Tensor):
    """K1, the counterpart of ``pallas_rnn.nn_scan_pallas``: same inputs and
    outputs as ``nn_scan_reference``. On the card it launches the resident
    variant when the weights are exact in fp16, else the f32 variant."""
    st_keys = ("gru_vad", "gru_noise", "gru_denoise", "lastg")
    weights = [params[k] for k in _NN_WEIGHTS]
    if not _on_card(feats, silence, *[state[k] for k in st_keys], *weights):
        return nn_scan_reference(params, state, feats, silence)
    S, F = silence.shape
    if S == 0:
        raise ValueError("nn_scan needs at least one stream")
    _require(feats, "feats", torch.float32, (S, F, C.NB_FEATURES))
    _require(silence, "silence", torch.bool, (S, F))
    for k in _NN_WEIGHTS:
        if params[k].dtype != torch.float32 or not params[k].is_contiguous():
            raise ValueError(f"{k}: want contiguous float32")
    st_in = torch.cat([state[k] for k in st_keys], dim=-1).contiguous()
    _require(st_in, "state", torch.float32, (S, _STATE))
    dev = feats.device
    graw = torch.empty((S, F, NB), dtype=torch.float32, device=dev)
    gs = torch.empty((S, F, NB), dtype=torch.float32, device=dev)
    vad = torch.empty((S, F), dtype=torch.float32, device=dev)
    st_out = torch.empty((S, _STATE), dtype=torch.float32, device=dev)
    lib = _build.load()
    outs = (feats.data_ptr(), silence.data_ptr(), st_in.data_ptr(), graw.data_ptr(),
            gs.data_ptr(), vad.data_ptr(), st_out.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    packed = _half_weights(params)
    if packed is not None:
        rc = lib.crispy_nn_scan_resident(
            *outs, packed.data_ptr(), *[params[k].data_ptr() for k in _BIASES],
            params["tansig_table"].data_ptr(), packed.numel() // 2, S, F, dev.index, stream)
        _build.check(rc, "nn_scan (resident)")
        nn_scan.launches += 1
    else:
        rc = lib.crispy_nn_scan_f32(*outs, *[w.data_ptr() for w in weights], S, F,
                                    dev.index, stream)
        _build.check(rc, "nn_scan (f32)")
        nn_scan.launches_f32 += 1
    splits = torch.split(st_out, [_VAD, _NOI, _DEN, NB], dim=-1)
    return (graw, gs, vad), dict(zip(st_keys, splits))


nn_scan.launches = 0  # the resident variant
nn_scan.launches_f32 = 0


# ---------------------------------------------------------------------------
# K2: the remove_doubling continuation scan
# ---------------------------------------------------------------------------

def rd_scan_reference(packed: torch.Tensor, last_period: torch.Tensor,
                      last_gain: torch.Tensor):
    """Plain version of K2: packed [S, F, 74] f32, carries [S] f32 →
    (pitch [S, F] f32, last_period [S] f32, last_gain [S] f32)."""
    ksf = torch.arange(2, 16, dtype=torch.float32, device=packed.device)
    kpos = torch.arange(14, device=packed.device)
    prev_T, prev_g = last_period, last_gain
    pitch = []
    for f in range(packed.shape[1]):
        inp = packed[:, f]
        T1, g1 = inp[:, 0:14], inp[:, 14:28]
        valid = inp[:, 28:42] > 0.5
        g0, T0 = inp[:, 42:43], inp[:, 43:44]
        Tout, pg = inp[:, 44:59], inp[:, 59:74]
        pph = torch.floor(prev_T * 0.5)[:, None]
        dT = torch.abs(T1 - pph)
        prev_g1 = prev_g[:, None]
        cont = torch.where(
            dT <= 1, prev_g1,
            torch.where((dT <= 2) & (5.0 * ksf * ksf < T0), 0.5 * prev_g1, 0.0))
        thresh = torch.clamp_min(0.7 * g0 - cont, 0.3)
        thresh = torch.where(
            T1 < 90.0, torch.clamp_min(0.85 * g0 - cont, 0.4),
            torch.where(T1 < 60.0, torch.clamp_min(0.9 * g0 - cont, 0.5), thresh))
        choose = valid & (g1 > thresh)
        kidx = torch.where(choose, kpos, -1).amax(dim=-1)  # last winner
        sel = (kidx + 1)[:, None]
        prev_T = torch.gather(Tout, 1, sel)[:, 0]
        prev_g = torch.gather(pg, 1, sel)[:, 0]
        pitch.append(prev_T)
    return torch.stack(pitch, 1), prev_T, prev_g


def rd_scan(packed: torch.Tensor, last_period: torch.Tensor, last_gain: torch.Tensor):
    """K2, the counterpart of ``pallas_rnn.rd_scan_pallas``: same inputs and
    outputs as ``rd_scan_reference``."""
    if not _on_card(packed, last_period, last_gain):
        return rd_scan_reference(packed, last_period, last_gain)
    S, F, _ = packed.shape
    if S == 0:
        raise ValueError("rd_scan needs at least one stream")
    _require(packed, "packed", torch.float32, (S, F, _RD_W))
    _require(last_period, "last_period", torch.float32, (S,))
    _require(last_gain, "last_gain", torch.float32, (S,))
    dev = packed.device
    pitch = torch.empty((S, F), dtype=torch.float32, device=dev)
    lp = torch.empty((S,), dtype=torch.float32, device=dev)
    lg = torch.empty((S,), dtype=torch.float32, device=dev)
    lib = _build.load()
    rc = lib.crispy_rd_scan(
        packed.data_ptr(), last_period.data_ptr(), last_gain.data_ptr(), pitch.data_ptr(),
        lp.data_ptr(), lg.data_ptr(), S, F,
        dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rd_scan")
    rd_scan.launches += 1
    return pitch, lp, lg


rd_scan.launches = 0
