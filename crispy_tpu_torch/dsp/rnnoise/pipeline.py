"""Batched RNNoise pipeline in PyTorch (the port of ``jax_pipeline.py``).

The per-sample streaming chain of the reference runs here as a frame-parallel,
stream-batched program over [streams, frames, ...] tensors, the same shape of
solution as the JAX package's non-TPU branch: spectra and pitch
cross-correlations are FFTs (``torch.fft``), the per-frame independent work is
one big batch, and the genuinely sequential recurrences are isolated:

  * the HP-biquad cross-frame carry: a local Toeplitz product per 120-sample
    sub-frame plus a log-depth scan of the complex modal amplitude;
  * remove_doubling's previous-pitch continuation: K2 (``rnn_kernels.rd_scan``);
  * the intra-frame log-energy follower (22 steps);
  * the GRU network and lastg gain smoothing: K1 (``rnn_kernels.nn_scan``).

The pitch-delayed windows come from K3 (``ops_kernels.pitch_window_gather``).

With ``CRISPY_FUSED_SPECTRA=on`` (read at each block step, as the JAX package
reads it) the spectra go through the fused-spectra path instead of
``torch.fft``: K4 (``frontend_kernels.fwd_spectrum_bands``) forms the analysis
windows from the HP signal and returns their spectra and band energies, K5
(``win_spectrum_bands``) does the same for K3's pitch-delayed windows, the
pitch filter runs on the padded [.., 1024] spectrum layout, and K6
(``inv_spectrum_ola``) synthesises with the overlap-add folded in. The default
is the FFT path.

On tensors on the card these kernel sites launch the CUDA kernels; on tensors
on the CPU they take their plain PyTorch versions.

Layout and parameter keys match the JAX package at the public functions:
``denoise_block(params, state, block[S, F*480])`` steps a carried state dict,
``denoise_batch`` drives it over whole signals. Numerical contract: the NumPy
oracle to ≲1e-4 per sample on [-1, 1]-scaled audio, with f32 arithmetic
throughout (TF32 is off, see ``device.py``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ...device import resolve_device
from . import constants as C
from .frontend_kernels import IM0, YPAD, fwd_spectrum_bands, inv_spectrum_ola, win_spectrum_bands
from .frontend_kernels import pad_band_e, pad_dft_fwd, pad_dft_inv
from .ops_kernels import pitch_window_gather, rd_candidate_gather
from .rnn_kernels import nn_scan, rd_scan
from .weights import RNNoiseModel, builtin_model

FRAME = C.FRAME_SIZE  # 480
WIN = C.WINDOW_SIZE  # 960
NFREQ = C.FREQ_SIZE  # 481
PBUF = C.PITCH_BUF_SIZE  # 1728
PMAX = C.PITCH_MAX_PERIOD  # 768
PMIN = C.PITCH_MIN_PERIOD  # 60
PFRAME = C.PITCH_FRAME_SIZE  # 960
HIST = PBUF - FRAME  # 1248 raw carry samples (+1 for the decimator edge)
NB = C.NB_BANDS

_COARSE_LAGS = (PMAX - 3 * PMIN) >> 2  # 147
_FINE_LAGS = (PMAX - 3 * PMIN) >> 1  # 294
_RD_MAXP = PMAX // 2  # 384: remove_doubling half-rate max period
_RD_N = PFRAME // 2  # 480
_RD_MINP = PMIN // 2  # 30

_BIQ_BS = 120  # biquad sub-frame: 480 = 4 x 120
_MAX_BLOCK_FRAMES = 4096  # the carry-power table covers 4 x 4096 sub-frames

_LAYER_KEYS = tuple(
    [f"{n}.{p}" for n in ("input_dense", "denoise_output", "vad_output") for p in "wb"]
    + [f"{n}.{p}" for n in ("vad_gru", "noise_gru", "denoise_gru") for p in "wub"])

# The keys of the port's parameter dict: a subset of the JAX package's
# make_params keys (its TPU-only radix and split matmul-DFT tables, and the
# 512-row halves of dft_fwd_pad that the TPU's K4 takes, are not needed here);
# the fused-spectra path reads the last six.
PARAM_KEYS = (
    "biq_pows_re", "biq_pows_im", "biq_toeplitz", "biq_kinj_re", "biq_kinj_im",
    "biq_pvec_re", "biq_pvec_im", "esw_4", "esw_fine", "half_window", "band_e",
    "band_interp", "dct", "tansig_table", "second_check",
) + _LAYER_KEYS + (
    "dft_fwd_pad", "band_e_pad", "band_e_1024", "band_interp_1024", "dft_inv_a", "dft_inv_b",
)


# ---------------------------------------------------------------------------
# Parameter and table preparation (host-side, float64 → float32)
# ---------------------------------------------------------------------------

def _biquad_tables() -> Dict[str, np.ndarray]:
    """Modal decomposition of the HP biquad's IIR part.

    y_n = x'_n - A1 y_{n-1} - A2 y_{n-2}, poles p, conj(p); impulse response
    h[m] = 2 Re(c p^m) with c = p / (p - conj(p)). The within-sub-frame
    response is a lower-triangular Toeplitz product at sub-frame size 120;
    cross-sub-frame state is a single complex modal amplitude (bounded
    basis, so f32 stays accurate — carrying (y[-1], y[-2]) instead would
    amplify rounding ~150x via the near-degenerate pole pair).
    """
    bs = _BIQ_BS
    a1, a2 = np.float64(C.BIQUAD_A_HP[0]), np.float64(C.BIQUAD_A_HP[1])
    p = (-a1 + np.sqrt(complex(a1 * a1 - 4 * a2))) / 2.0
    c = p / (p - np.conj(p))
    n = np.arange(bs, dtype=np.float64)
    pn = p ** n
    h = 2.0 * np.real(c * pn)
    toe = np.zeros((bs, bs), dtype=np.float64)
    i, j = np.indices((bs, bs))
    mask = i >= j
    toe[mask] = h[(i - j)[mask]]
    kinj = c * p ** (bs - n)  # injection weights: a_inj = sum_j (c p^(bs-j)) x'_j
    # p^(120 (g+1)) for the carry propagation (4096 frames = 16384 sub-frames)
    pows = (p ** bs) ** np.arange(1, 4 * _MAX_BLOCK_FRAMES + 1, dtype=np.float64)
    return {
        "biq_pows_re": np.real(pows).astype(np.float32),
        "biq_pows_im": np.imag(pows).astype(np.float32),
        "biq_toeplitz": toe.T.astype(np.float32),  # used as x' @ T^T
        "biq_kinj_re": np.real(kinj).astype(np.float32),
        "biq_kinj_im": np.imag(kinj).astype(np.float32),
        "biq_pvec_re": np.real(pn).astype(np.float32),
        "biq_pvec_im": np.imag(pn).astype(np.float32),
    }


def _esw_tables() -> Dict[str, np.ndarray]:
    """Sliding-window energies as banded 0/1 matrices over the squared
    signal (exact summation order per window)."""
    w4 = np.zeros((387, _COARSE_LAGS), np.float32)
    for i in range(_COARSE_LAGS):
        w4[i: i + 240, i] = 1.0
    # columns 0..293: syy2 windows [i, i+480); columns 294..678: yyl windows
    # [384-T, 864-T) for T = 0..384.
    wf = np.zeros((PBUF // 2, _FINE_LAGS + _RD_MAXP + 1), np.float32)
    for i in range(_FINE_LAGS):
        wf[i: i + _RD_N, i] = 1.0
    for T in range(_RD_MAXP + 1):
        wf[_RD_MAXP - T: _RD_MAXP - T + _RD_N, _FINE_LAGS + T] = 1.0
    return {"esw_4": w4, "esw_fine": wf}


def _fused_spectra_tables(band_e: np.ndarray, band_interp: np.ndarray) -> Dict[str, np.ndarray]:
    """The fused-spectra path's tables on the padded [.., 1024] layout (re
    0..480, im 512..992), as the JAX package builds them: the windowed
    960-point real DFT in float64, cast to f32, with the Vorbis window and
    RNNoise's 1/N forward scaling folded in; the band and interpolation
    tables duplicated across both halves so they act on that layout."""
    n = np.arange(WIN, dtype=np.float64)[:, None]
    k = np.arange(NFREQ, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / WIN
    w = C.full_window().astype(np.float64)[:, None]
    fwd_re = ((w * np.cos(ang)) / WIN).astype(np.float32)  # [960, 481]
    fwd_im = ((-w * np.sin(ang)) / WIN).astype(np.float32)
    ck = np.full(NFREQ, 2.0)
    ck[0] = ck[-1] = 1.0
    # inverse (x WIN) with the synthesis window folded in: [481, 960]
    inv_re = ((ck[:, None] * np.cos(ang.T)) * w.T).astype(np.float32)
    inv_im = ((-ck[:, None] * np.sin(ang.T)) * w.T).astype(np.float32)
    t: Dict[str, np.ndarray] = {}
    t["dft_fwd_pad"] = pad_dft_fwd(np.concatenate([fwd_re, fwd_im], axis=1))
    t["band_e_pad"] = pad_band_e(band_e)  # [512, 22]
    be = np.zeros((YPAD, NB), np.float32)
    be[:NFREQ] = band_e
    be[IM0: IM0 + NFREQ] = band_e
    t["band_e_1024"] = be
    bi = np.zeros((NB, YPAD), np.float32)
    bi[:, :NFREQ] = band_interp
    bi[:, IM0: IM0 + NFREQ] = band_interp
    t["band_interp_1024"] = bi
    inv_pad = pad_dft_inv(inv_re, inv_im)  # [1024, 960]
    t["dft_inv_a"] = inv_pad[:, :FRAME].copy()
    t["dft_inv_b"] = inv_pad[:, FRAME:].copy()
    return t


def make_params(model: Optional[RNNoiseModel] = None, device=None) -> Dict[str, torch.Tensor]:
    """Tables and weights on ``device`` (default the card), keyed as the JAX
    package's ``make_params`` keys them."""
    dev = resolve_device(device)
    model = model or builtin_model()
    t: Dict[str, np.ndarray] = {}
    t.update(_biquad_tables())
    t.update(_esw_tables())
    t["half_window"] = C.half_window()
    t["band_e"] = C.band_energy_matrix().T  # [481, 22] for e @ W
    t["band_interp"] = C.band_interp_matrix().T  # [22, 481] for g @ W
    t.update(_fused_spectra_tables(t["band_e"], t["band_interp"]))
    t["dct"] = C.dct_matrix().T  # [22, 22] for x @ D
    t["tansig_table"] = C.tansig_table()
    t["second_check"] = C.SECOND_CHECK.astype(np.int32)
    for lname in ("input_dense", "denoise_output", "vad_output"):
        layer = getattr(model, lname)
        t[f"{lname}.w"] = layer.w
        t[f"{lname}.b"] = layer.b
    for lname in ("vad_gru", "noise_gru", "denoise_gru"):
        g = getattr(model, lname)
        t[f"{lname}.w"] = g.w
        t[f"{lname}.u"] = g.u
        t[f"{lname}.b"] = g.b
    return {k: torch.as_tensor(np.ascontiguousarray(t[k])).to(dev) for k in PARAM_KEYS}


def init_state(n_streams: int, device=None) -> Dict[str, torch.Tensor]:
    """Zero state for ``n_streams`` independent streams (= fresh DenoiseState)."""
    dev = resolve_device(device)
    S = n_streams

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {
        "x_prev": z(S, 2),  # raw scaled input history (x_{-2}, x_{-1})
        "biq_a_re": z(S),  # modal IIR amplitude
        "biq_a_im": z(S),
        "hp_tail": z(S, HIST + 1),  # last 1249 HP samples
        "last_period": z(S, dtype=torch.int32),
        "last_gain": z(S),
        "ceps_hist": z(S, C.CEPS_MEM, NB),  # oldest → newest
        "gru_vad": z(S, C.VAD_GRU_SIZE),
        "gru_noise": z(S, C.NOISE_GRU_SIZE),
        "gru_denoise": z(S, C.DENOISE_GRU_SIZE),
        "lastg": z(S, NB),
        "syn_mem": z(S, FRAME),
    }


# ---------------------------------------------------------------------------
# Small numerical helpers
# ---------------------------------------------------------------------------

def _windows(x: torch.Tensor, stride: int, size: int, num: int) -> torch.Tensor:
    """[S, L] → [S, num, size] sliding windows (a strided view; zero-padded
    on the right where x is too short)."""
    need = (num - 1) * stride + size
    if x.shape[1] < need:
        x = torch.nn.functional.pad(x, (0, need - x.shape[1]))
    return x[:, :need].unfold(1, size, stride)


def _xcorr_fft(x: torch.Tensor, y: torch.Tensor, nfft: int, nlags: int) -> torch.Tensor:
    """corr[..., i] = sum_j x[..., j] * y[..., j+i] via rfft of size nfft."""
    X = torch.fft.rfft(x, n=nfft)
    Y = torch.fft.rfft(y, n=nfft)
    return torch.fft.irfft(torch.conj(X) * Y, n=nfft)[..., :nlags]


def _top2(ratio: torch.Tensor, valid: torch.Tensor):
    """C find_best_pitch selection: top-2 lags of ratio among valid entries,
    first-index tie-break, with the C defaults (0, 1) / (i, 0) on <2 valid."""
    neg = float("-inf")
    r = torch.where(valid, ratio, neg)
    best = torch.argmax(r, dim=-1)
    r2 = r.scatter(-1, best[..., None], neg)
    second = torch.argmax(r2, dim=-1)
    nvalid = valid.sum(dim=-1)
    best = torch.where(nvalid > 0, best, 0)
    second = torch.where(nvalid > 1, second, torch.where(nvalid == 1, 0, 1))
    return best, second


def _full_window(params) -> torch.Tensor:
    hw = params["half_window"]
    return torch.cat([hw, hw.flip(0)])


# ---------------------------------------------------------------------------
# Stage 1: HP biquad (Toeplitz local + modal carry scan)
# ---------------------------------------------------------------------------

def _hp_biquad(params, state, x: torch.Tensor):
    """x: [S, F, 480] scaled raw frames → (new_state, HP-filtered frames)."""
    S, F, _ = x.shape
    if F > _MAX_BLOCK_FRAMES:
        raise ValueError(f"a block holds at most {_MAX_BLOCK_FRAMES} frames, got {F}")
    G = F * (FRAME // _BIQ_BS)  # sub-frame count
    flat = x.reshape(S, F * FRAME)
    hist = torch.cat([state["x_prev"], flat], dim=-1)
    xm1 = hist[:, 1:-1].reshape(S, G, _BIQ_BS)
    xm2 = hist[:, :-2].reshape(S, G, _BIQ_BS)
    b0, b1 = float(C.BIQUAD_B_HP[0]), float(C.BIQUAD_B_HP[1])
    xp = flat.reshape(S, G, _BIQ_BS) + xm1 * b0 + xm2 * b1

    y_local = xp @ params["biq_toeplitz"]
    acc_re = xp @ params["biq_kinj_re"]  # [S, G] injections
    acc_im = xp @ params["biq_kinj_im"]
    pk_re, pk_im = params["biq_pows_re"], params["biq_pows_im"]  # p^(120 (g+1))

    # Linear complex recurrence a_g = p^120 a_{g-1} + inj_g as a log-depth
    # (Hillis-Steele) scan: after the step of distance d, each entry holds the
    # sum over the last 2d injections, older ones weighted by p^(120 d).
    d = 1
    while d < G:
        pr, pi = pk_re[d - 1], pk_im[d - 1]
        sr, si = acc_re[:, :-d], acc_im[:, :-d]
        acc_re = torch.cat([acc_re[:, :d], (pr * sr - pi * si) + acc_re[:, d:]], dim=1)
        acc_im = torch.cat([acc_im[:, :d], (pr * si + pi * sr) + acc_im[:, d:]], dim=1)
        d *= 2
    # acc_g = amplitude AFTER sub-frame g given zero initial state; add the
    # carried initial amplitude propagated by p^(120 (g+1)).
    a0r = state["biq_a_re"][:, None]
    a0i = state["biq_a_im"][:, None]
    tot_re = acc_re + a0r * pk_re[:G] - a0i * pk_im[:G]
    tot_im = acc_im + a0r * pk_im[:G] + a0i * pk_re[:G]
    # Amplitude at sub-frame START = previous total (sub-frame 0: the carry).
    amps_re = torch.cat([a0r, tot_re[:, :-1]], dim=1)[..., None]
    amps_im = torch.cat([a0i, tot_im[:, :-1]], dim=1)[..., None]
    y = y_local + 2.0 * (amps_re * params["biq_pvec_re"] - amps_im * params["biq_pvec_im"])

    new_state = dict(state)
    new_state["x_prev"] = flat[:, -2:].clone()
    new_state["biq_a_re"] = tot_re[:, -1].clone()
    new_state["biq_a_im"] = tot_im[:, -1].clone()
    return new_state, y.reshape(S, F, FRAME)


# ---------------------------------------------------------------------------
# Stage 2: pitch analysis (frame-parallel search + continuation scan)
# ---------------------------------------------------------------------------

def _pitch_index(params, state, ext: torch.Tensor, F: int):
    """ext: [S, 1+HIST+F*480] HP samples (ext[0] is the decimator edge).

    Returns (pitch_index [S, F] int32, new last_period [S] int32, last_gain [S]).
    """
    S = ext.shape[0]
    dev = ext.device
    # Global 2x decimation with the 3-tap smoother over sample pairs:
    # D[j] = .5*(.5*(ext[2j] + ext[2j+2]) + ext[2j+1]).
    nD = (ext.shape[1] - 1) // 2
    pairs = ext[:, : 2 * nD].reshape(S, nD, 2)
    nxt = torch.cat([pairs[:, 1:, 0], ext[:, 2 * nD: 2 * nD + 1]], dim=1)
    D = 0.5 * (0.5 * (pairs[:, :, 0] + nxt) + pairs[:, :, 1])  # [S, nD]
    # Quarter-rate stream D2[m] = D[2m], built the same way from quads.
    nD2 = (ext.shape[1] - 3) // 4
    quads = ext[:, : 4 * nD2].reshape(S, nD2, 4)
    D2 = 0.5 * (0.5 * (quads[:, :, 0] + quads[:, :, 2]) + quads[:, :, 1])

    # Per-frame 864-sample decimated pitch buffers (stride 240). Index 0 of
    # each uses only its own first two samples (buffer f starts at
    # ext[1 + f*480]; b_ds[0] = .5*(.5*buf[1] + buf[0])).
    bds = _windows(D, 240, PBUF // 2, F).clone(memory_format=torch.contiguous_format)
    starts = torch.arange(F, device=dev) * FRAME
    b0 = 0.5 * (0.5 * ext[:, starts + 2] + ext[:, starts + 1])
    bds[:, :, 0] = b0

    # --- pitch_search: coarse at /4 of full rate --------------------------
    x4 = _windows(D2[:, (PMAX >> 2):], 120, PFRAME >> 2, F)  # [S, F, 240]
    y4 = _windows(D2, 120, (PFRAME + (PMAX - 3 * PMIN)) >> 2, F).clone(
        memory_format=torch.contiguous_format)  # [S, F, 387]
    y4[:, :, 0] = b0  # y4[0] = bds[0] (per-frame edge fix)
    xc4 = _xcorr_fft(x4, y4, 512, _COARSE_LAGS)
    e4 = (y4 * y4) @ params["esw_4"]
    syy4 = torch.clamp_min(1.0 + e4, 1.0)
    neg = -1e30
    ratio4 = torch.where(xc4 > 0, (xc4 * xc4) / syy4, neg)
    best4, second4 = _top2(ratio4, xc4 > 0)

    # --- fine stage + remove_doubling share one cross-correlation ----------
    x2 = bds[..., PMAX // 2:]  # [S, F, 480]
    cc = _xcorr_fft(x2, bds, 1024, _RD_MAXP + 1)  # [S, F, 385]
    energies = (bds * bds) @ params["esw_fine"]
    xc2_raw = cc[..., :_FINE_LAGS]
    lags2 = torch.arange(_FINE_LAGS, device=dev)
    near = ((torch.abs(lags2 - 2 * best4[..., None]) <= 2)
            | (torch.abs(lags2 - 2 * second4[..., None]) <= 2))
    xc2 = torch.where(near, torch.clamp_min(xc2_raw, -1.0), 0.0)
    syy2 = torch.clamp_min(1.0 + energies[..., :_FINE_LAGS], 1.0)
    ratio2 = torch.where(xc2 > 0, (xc2 * xc2) / syy2, neg)
    best2, _ = _top2(ratio2, xc2 > 0)

    # Pseudo-interpolation around the fine winner.
    def at(idx):
        return torch.gather(xc2, -1, idx[..., None])[..., 0]

    bm1 = at(torch.clamp_min(best2 - 1, 0))
    b0v = at(best2)
    bp1 = at(torch.clamp_max(best2 + 1, _FINE_LAGS - 1))
    offs = torch.where(bp1 - bm1 > 0.7 * (b0v - bm1), 1,
                       torch.where(bm1 - bp1 > 0.7 * (b0v - bp1), -1, 0))
    offs = torch.where((best2 > 0) & (best2 < _FINE_LAGS - 1), offs, 0)
    pitch0 = 2 * best2 - offs  # full-rate period from pitch_search
    T0 = torch.clamp_max((PMAX - pitch0) // 2, _RD_MAXP - 1)  # half-rate, clamped

    # --- remove_doubling: everything per-candidate, frame-parallel ---------
    xx = torch.sum(x2 * x2, dim=-1)
    corr = torch.flip(cc, dims=(-1,))  # corr[T] = cc[384 - T], T in 0..384
    yyl = torch.clamp_min(energies[..., _FINE_LAGS:], 0.0)  # already T-indexed
    ks = torch.arange(2, 16, device=dev)
    T0k = T0[..., None]
    T1 = (2 * T0k + ks) // (2 * ks)  # [S, F, 14]
    xy_t, xc_m1, xc_p1, yy_t, xy_tb, yy_tb = rd_candidate_gather(
        corr, yyl, T0, params["second_check"])
    # Candidate axis: index 0 = "keep T0", 1.. = subharmonics k=2..15.
    T_cand = torch.cat([T0k, T1], dim=-1)  # [S, F, 15]
    xy_cand = 0.5 * (xy_t + xy_tb)
    yy_cand = 0.5 * (yy_t + yy_tb)
    g_cand = xy_cand / torch.sqrt(1.0 + xx[..., None] * yy_cand)
    g0 = g_cand[..., 0]
    valid = torch.cumprod((T1 >= _RD_MINP).to(torch.int32), dim=-1) > 0

    # Per-candidate refinement (offset interpolation + gain), all parallel.
    off = torch.where(xc_p1 - xc_m1 > 0.7 * (xy_t - xc_m1), 1,
                      torch.where(xc_m1 - xc_p1 > 0.7 * (xy_t - xc_p1), -1, 0))
    best_xy = torch.clamp_min(xy_cand, 0.0)
    pg_cand = torch.where(yy_cand <= best_xy, 1.0, best_xy / (yy_cand + 1.0))
    pg_cand = torch.minimum(pg_cand, g_cand)
    Tout_cand = torch.clamp_min(2 * T_cand + off, PMIN)  # [S, F, 15]

    # --- sequential continuation scan: K2 over one packed array ------------
    packed = torch.cat(
        [
            T1.to(torch.float32),  # [..., 0:14]   (ints <= 384: exact in f32)
            g_cand[..., 1:],  # [..., 14:28]
            valid.to(torch.float32),  # [..., 28:42]
            g0[..., None],  # [..., 42]
            T0.to(torch.float32)[..., None],  # [..., 43]
            Tout_cand.to(torch.float32),  # [..., 44:59]
            pg_cand,  # [..., 59:74]
        ],
        dim=-1,
    ).contiguous()  # [S, F, 74]
    pitch_f, lp_f, lg = rd_scan(packed, state["last_period"].to(torch.float32),
                                state["last_gain"].contiguous())
    return pitch_f.to(torch.int32), lp_f.to(torch.int32), lg


# ---------------------------------------------------------------------------
# Stage 3: spectra, band energies, features
# ---------------------------------------------------------------------------

def _use_fused_spectra() -> bool:
    """The fused-spectra path (K4-K6) instead of the FFT path, with
    ``CRISPY_FUSED_SPECTRA=on``, the JAX package's own switch; read at each
    call. Off by default: on the H100 the dense 960-point DFT products are
    slower than the FFTs (``PERF.md``)."""
    return os.environ.get("CRISPY_FUSED_SPECTRA", "off") == "on"


def _spectrum(params, frames: torch.Tensor):
    """frames [.., 960] → windowed DFT (re, im) [.., 481], RNNoise 1/N scaling."""
    X = torch.fft.rfft(frames * _full_window(params), n=WIN, dim=-1) / WIN
    return X.real, X.imag


def _inv_spectrum(params, re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """(re, im) [.., 481] → windowed time frame [.., 960] (x WIN scaling folded)."""
    return torch.fft.irfft(torch.complex(re, im), n=WIN, dim=-1) * WIN * _full_window(params)


def _band_energy(params, Xr: torch.Tensor, Xi: torch.Tensor) -> torch.Tensor:
    return (Xr * Xr + Xi * Xi) @ params["band_e"]


def _band_corr(params, Xr, Xi, Pr, Pi) -> torch.Tensor:
    return (Xr * Pr + Xi * Pi) @ params["band_e"]


def _interp_gain(params, g: torch.Tensor) -> torch.Tensor:
    return g @ params["band_interp"]


def _log_band_energies(Ex: torch.Tensor) -> torch.Tensor:
    """Intra-frame max-follow smoothing over the 22 bands (22-step scan)."""
    v = torch.log10(1e-2 + Ex)  # [S, F, 22]
    log_max = torch.full(v.shape[:-1], -2.0, dtype=v.dtype, device=v.device)
    follow = log_max.clone()
    out = []
    for i in range(v.shape[-1]):
        val = torch.maximum(log_max - 7.0, torch.maximum(follow - 1.5, v[..., i]))
        log_max = torch.maximum(log_max, val)
        follow = torch.maximum(follow - 1.5, val)
        out.append(val)
    return torch.stack(out, dim=-1)


def _cepstral_features(params, state, ceps0: torch.Tensor, silence: torch.Tensor):
    """Silence-aware cepstral delta + variability features, frame-parallel.

    The reference's ring buffer only advances on non-silent frames, so
    "previous" means previous *non-silent*: non-silent frames are ranked
    with a cumsum, their cepstra scattered into rank order behind the
    carried 8-deep history, and deltas/variability windows gathered by rank.
    """
    S, F, _ = ceps0.shape
    dev = ceps0.device
    nonsil = ~silence
    rank = torch.cumsum(nonsil.to(torch.int64), dim=1)  # inclusive [S, F]
    pos = torch.where(nonsil, rank - 1, F)  # silent → dustbin
    rows = torch.arange(S, device=dev)
    ordered = torch.zeros((S, F + 1, NB), dtype=torch.float32, device=dev)
    ordered[rows[:, None], pos] = ceps0
    padded = torch.cat([state["ceps_hist"], ordered[:, :F]], dim=1)  # [S, 8+F, 22]
    top = C.CEPS_MEM - 1 + F

    def gather(idx):  # idx [S, F] → [S, F, 22]
        return torch.gather(padded, 1, idx.clamp(0, top)[..., None].expand(-1, -1, NB))

    c1 = gather(C.CEPS_MEM + rank - 2)
    c2 = gather(C.CEPS_MEM + rank - 3)

    # Variability: the 8-slot window ending at the current frame's rank.
    slots = torch.arange(C.CEPS_MEM, device=dev)
    widx = rank[..., None] + slots  # [S, F, 8] into padded
    mem = padded[rows[:, None, None], widx.clamp(0, top)]  # [S, F, 8, 22]
    diff = mem[:, :, :, None, :] - mem[:, :, None, :, :]
    dist = torch.sum(diff * diff, dim=-1)  # [S, F, 8, 8]
    eye = torch.eye(C.CEPS_MEM, dtype=torch.bool, device=dev)
    dist = dist.masked_fill(eye, float("inf"))
    spec_var = torch.sum(torch.amin(dist, dim=-1), dim=-1) / C.CEPS_MEM  # [S, F]

    # Updated history: last 8 non-silent cepstra at block end.
    hidx = rank[:, -1:] + slots
    new_hist = padded[rows[:, None], hidx]
    return c1, c2, spec_var, new_hist


# ---------------------------------------------------------------------------
# The block step
# ---------------------------------------------------------------------------

def frontend_block(params, state, block: torch.Tensor):
    """The analysis frontend: block [S, F*480] in [-1, 1] → (new_state,
    dict of spectra, energies and features)."""
    S, L = block.shape
    if L % FRAME:
        raise ValueError(f"block length must be a multiple of {FRAME}, got {L}")
    F = L // FRAME
    dev = block.device

    x = (block.to(torch.float32) * 32768.0).reshape(S, F, FRAME)
    state, hp = _hp_biquad(params, state, x)
    ext = torch.cat([state["hp_tail"], hp.reshape(S, F * FRAME)], dim=-1)  # [S, 1+1248+L]
    state["hp_tail"] = ext[:, -(HIST + 1):].clone()

    # Analysis spectra: window f covers ext[769 + f*480 : +960].
    fused = _use_fused_spectra()
    if fused:  # K4 reads the windows in place; Y keeps the padded layout
        Y, Ex = fwd_spectrum_bands(ext[:, 1 + HIST - FRAME:], params["dft_fwd_pad"],
                                   params["band_e_pad"], F)
        Xr, Xi = Y[..., :NFREQ], Y[..., IM0: IM0 + NFREQ]
    else:
        Y = None
        awin = _windows(ext[:, 1 + HIST - FRAME:], FRAME, WIN, F)  # [S, F, 960]
        Xr, Xi = _spectrum(params, awin)
        Ex = _band_energy(params, Xr, Xi)

    pitch_idx, lp, lg = _pitch_index(params, state, ext, F)
    state["last_period"], state["last_gain"] = lp, lg

    # Pitch-delayed window: ext[1 + f*480 + 1728 - 960 - idx : +960] (K3).
    frame_off = torch.arange(F, dtype=torch.int32, device=dev)[None, :] * FRAME
    starts = (1 + frame_off + (PBUF - WIN) - pitch_idx).to(torch.int32).contiguous()
    pwin = pitch_window_gather(ext, starts)  # [S, F, 960]
    if fused:  # K5; banded Xr*Pr + Xi*Pi straight on the padded layout
        P, Ep = win_spectrum_bands(pwin, params["dft_fwd_pad"], params["band_e_pad"])
        Pr, Pi = P[..., :NFREQ], P[..., IM0: IM0 + NFREQ]
        Exp = ((Y * P) @ params["band_e_1024"]) / torch.sqrt(0.001 + Ex * Ep)
    else:
        P = None
        Pr, Pi = _spectrum(params, pwin)
        Ep = _band_energy(params, Pr, Pi)
        Exp = _band_corr(params, Xr, Xi, Pr, Pi) / torch.sqrt(0.001 + Ex * Ep)

    # Features.
    E = torch.sum(Ex, dim=-1)
    silence = E < C.SILENCE_ENERGY  # [S, F]
    Ly = _log_band_energies(Ex)
    ceps0 = Ly @ params["dct"]
    ceps0[:, :, 0] += -12.0
    ceps0[:, :, 1] += -4.0
    c1, c2, spec_var, new_hist = _cepstral_features(params, state, ceps0, silence)
    state["ceps_hist"] = new_hist

    nd = C.NB_DELTA_CEPS
    exp_dct = (Exp @ params["dct"])[..., :nd].clone()
    exp_dct[..., 0] += -1.3
    exp_dct[..., 1] += -0.9
    feats = torch.cat(
        [
            torch.cat([(ceps0 + c1 + c2)[..., :nd], ceps0[..., nd:]], dim=-1),
            (ceps0 - c2)[..., :nd],
            (ceps0 - 2.0 * c1 + c2)[..., :nd],
            exp_dct,
            (0.01 * (pitch_idx.to(torch.float32) - 300.0))[..., None],
            (spec_var - 2.1)[..., None],
        ],
        dim=-1,
    )  # [S, F, 42]
    feats = torch.where(silence[..., None], 0.0, feats)
    return state, {
        "Xr": Xr, "Xi": Xi, "Ex": Ex, "Pr": Pr, "Pi": Pi, "Ep": Ep,
        "Exp": Exp, "feats": feats, "silence": silence, "pitch_idx": pitch_idx,
        "Y": Y, "P": P,  # padded-layout spectra (fused path only; None otherwise)
    }


def denoise_block(params, state, block: torch.Tensor):
    """One block step: block [S, F*480] in [-1, 1] → (new_state, out same
    shape, vad [S, F])."""
    S, L = block.shape
    state, fr = frontend_block(params, state, block)
    Xr, Xi, Ex = fr["Xr"], fr["Xi"], fr["Ex"]
    Pr, Pi, Ep, Exp = fr["Pr"], fr["Pi"], fr["Ep"], fr["Exp"]
    silence = fr["silence"]

    (graw, gsmooth, vad), nn_state = nn_scan(params, state, fr["feats"].contiguous(), silence)
    state.update(nn_state)

    # Pitch filter (raw gains), then smoothed-gain application.
    g2 = graw * graw
    exp2 = Exp * Exp
    r = torch.where(Exp > graw, 1.0, exp2 * (1.0 - g2) / (0.001 + g2 * (1.0 - exp2)))
    r = torch.sqrt(torch.clamp(r, 0.0, 1.0)) * torch.sqrt(Ex / (1e-8 + Ep))
    keep = silence[..., None]
    if fr["Y"] is not None:
        # Padded-layout mid-section: the interpolation and band tables are
        # duplicated across the re and im halves, so the same per-frequency
        # gains apply without repacking; K6 synthesises with the overlap-add.
        Y, P = fr["Y"], fr["P"]
        bi = params["band_interp_1024"]
        Xp = Y + (r @ bi) * P
        norm = torch.sqrt(Ex / (1e-8 + (Xp * Xp) @ params["band_e_1024"]))
        Xo = torch.where(keep, Y, Xp * ((norm @ bi) * (gsmooth @ bi)))
        out, state["syn_mem"] = inv_spectrum_ola(Xo, params["dft_inv_a"], params["dft_inv_b"],
                                                 state["syn_mem"])
        return state, (out / 32768.0).reshape(S, L), vad

    rf = _interp_gain(params, r)
    Xpr, Xpi = Xr + rf * Pr, Xi + rf * Pi
    newE = _band_energy(params, Xpr, Xpi)
    norm = torch.sqrt(Ex / (1e-8 + newE))
    gain_all = _interp_gain(params, norm) * _interp_gain(params, gsmooth)
    Xor = torch.where(keep, Xr, Xpr * gain_all)
    Xoi = torch.where(keep, Xi, Xpi * gain_all)

    # Synthesis: inverse windowed DFT, overlap-add with the carried tail.
    xt = _inv_spectrum(params, Xor, Xoi)  # [S, F, 960], window folded in
    tails = torch.cat([state["syn_mem"][:, None, :], xt[:, :-1, FRAME:]], dim=1)
    out = (xt[..., :FRAME] + tails) / 32768.0
    state["syn_mem"] = xt[:, -1, FRAME:].clone()
    return state, out.reshape(S, L), vad


def _denoise_block_i16(params, state, block_i16: torch.Tensor):
    """Int16-wire block step: PCM in, PCM out.

    The input scaling is exact (int16/32768 is a power-of-two divide) and
    the output quantization reproduces io.wav.write_wav's float path bit
    for bit (clip → ×32767 → round-toward-zero cast)."""
    blockf = block_i16.to(torch.float32) / 32768.0
    state, out, vad = denoise_block(params, state, blockf)
    o16 = torch.trunc(torch.clamp(out, -1.0, 1.0) * 32767.0).to(torch.int16)
    return state, o16, vad


# ---------------------------------------------------------------------------
# Host loop
# ---------------------------------------------------------------------------

def denoise_batch(
    audio: np.ndarray,
    model: Optional[RNNoiseModel] = None,
    block_frames: int = 500,
    params=None,
    return_vad: bool = False,
    wire: str = "f32",
    device=None,
):
    """Denoise [S, T] (or [T]) mono audio in [-1, 1]; returns the same shape.

    Runs fixed-size blocks of ``block_frames`` frames through
    ``denoise_block`` on ``device`` (default the card; with no card it
    raises). Trailing samples that don't fill a frame pass through
    unchanged (reference behaviour: partial frames are never emitted).

    ``wire="i16"`` takes int16 PCM input and returns int16 PCM output,
    halving host↔device transfer both ways. Exact: input scaling is a
    power-of-two divide and the output quantization is bit-identical to
    io.wav.write_wav's.
    """
    dev = resolve_device(device)
    audio = np.asarray(audio)
    squeeze = audio.ndim == 1
    if wire == "i16":
        a = np.atleast_2d(audio)
        if a.dtype != np.int16:
            raise TypeError("wire='i16' requires int16 PCM input")
        step = _denoise_block_i16
    elif wire == "f32":
        a = np.atleast_2d(audio.astype(np.float32, copy=False))
        step = denoise_block
    else:
        raise ValueError(f"unknown wire {wire!r}")
    if not 0 < block_frames <= _MAX_BLOCK_FRAMES:
        raise ValueError(f"block_frames must be in 1..{_MAX_BLOCK_FRAMES}")
    S, T = a.shape
    if params is None:
        params = make_params(model, dev)
    n_frames = T // FRAME
    out = np.array(a, copy=True)
    vads = []
    state = init_state(S, dev)
    blk = block_frames * FRAME
    # Results copy back without blocking the host, so the next blocks are
    # queued while earlier ones compute; the host waits once per flush.
    pending: list = []  # (sample offset, length, out block, vad block)
    pending_bytes = 0
    flush_bytes = 512 << 20  # bound the device- and pinned-host-resident output

    def to_host(t: torch.Tensor) -> torch.Tensor:
        if dev.type != "cuda":
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        return h

    def flush():
        nonlocal pending_bytes
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        for d, td, o, v in pending:
            out[:, d: d + td] = o.numpy()
            if return_vad:
                vads.append(v.numpy())
        pending.clear()
        pending_bytes = 0

    done = 0
    with torch.no_grad():
        while done < n_frames * FRAME:
            todo = min(blk, n_frames * FRAME - done)
            chunk = torch.from_numpy(np.ascontiguousarray(a[:, done: done + todo])).to(dev)
            state, o, v = step(params, state, chunk)
            pending.append((done, todo, to_host(o), to_host(v) if return_vad else None))
            pending_bytes += o.numel() * o.element_size()
            if pending_bytes >= flush_bytes:
                flush()
            done += todo
        flush()
    if return_vad:
        v = np.concatenate(vads, axis=1) if vads else np.zeros((S, 0), np.float32)
        return (out[0] if squeeze else out), (v[0] if squeeze else v)
    return out[0] if squeeze else out
