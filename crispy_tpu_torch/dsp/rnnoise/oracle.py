"""Faithful NumPy oracle of the RNNoise frame chain.

The PyTorch port's own copy of ``crispy_tpu/dsp/rnnoise/oracle.py`` (the port
imports nothing of the JAX package; ``tests/test_torch_oracle.py`` holds the
two bit-equal). It needs only NumPy (and SciPy's ``lfilter``), so the card's
output can be held against it where the JAX package is absent.

This is the executable spec for the device pipeline: a direct, sequential
re-implementation of the public RNNoise algorithm (as consumed by the
reference through the nnnoiseless crate at src-tauri/src/audio.rs:268),
processing one 480-sample frame at a time exactly like the C/Rust code:

    rnnoise_process_frame(state, out, in):
        x = hp_biquad(in)                         # input high-pass
        X, Ex        = frame_analysis(x)          # window + rfft + band energy
        pitch_index  = pitch_search + remove_doubling over the pitch buffer
        P, Ep, Exp   = pitch-delayed spectrum + band energy/correlation
        features[42] = band cepstra + deltas + pitch features + variability
        if not silence:
            gains, vad = GRU network(features)
            X = pitch_filter(X, P, ...); X *= interp(max(g, .6*lastg))
        out = frame_synthesis(X)                  # irfft + window + overlap-add

Inputs/outputs are ±32768-scaled float samples (the reference multiplies by
32768 before process_frame and divides after — audio.rs:260-271).

Known, documented deviations from bit-exact C behavior (all far below the
1e-4 parity budget; see tests/test_rnnoise_oracle.py):
  * FFTs use numpy's rfft/irfft with RNNoise's 1/WINDOW_SIZE forward scaling
    instead of kiss_fft (same math, different rounding order).
  * Band-energy accumulation uses vectorized dot products (pairwise
    summation) rather than C's sequential loop order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from . import constants as C
from .weights import Dense, GRU, RNNoiseModel, builtin_model

_HALF_WINDOW = C.half_window()
_DCT = C.dct_matrix()
_BAND_E = C.band_energy_matrix()
_BAND_INTERP = C.band_interp_matrix()


# --------------------------------------------------------------------------
# Elementary blocks
# --------------------------------------------------------------------------

def biquad(x: np.ndarray, mem: np.ndarray, b: np.ndarray, a: np.ndarray,
           dtype=np.float64) -> np.ndarray:
    """Transposed direct-form-II biquad, updating `mem` in place.

    Defaults to float64 accumulation: the filter's poles sit at |z|≈0.998
    (a ~19 Hz resonance), which amplifies f32 rounding noise to ~3e-4 of full
    scale over 10 s — *any* two differently-ordered f32 implementations
    (including the reference's own) diverge by that much through this filter.
    The spec here is therefore the exact filter; pass dtype=np.float32 to
    model the reference's per-sample f32 arithmetic instead.
    """
    if dtype is np.float64:
        # scipy's transposed-DF2 lfilter is the identical recurrence in f64.
        from scipy.signal import lfilter

        bb = np.array([1.0, b[0], b[1]], dtype=np.float64)
        aa = np.array([1.0, a[0], a[1]], dtype=np.float64)
        y, zf = lfilter(bb, aa, x.astype(np.float64), zi=np.asarray(mem, np.float64))
        mem[0], mem[1] = zf[0], zf[1]
        return y.astype(np.float32)
    y = np.empty_like(x, dtype=np.float32)
    m0, m1 = dtype(mem[0]), dtype(mem[1])
    b0, b1 = dtype(b[0]), dtype(b[1])
    a0, a1 = dtype(a[0]), dtype(a[1])
    for i in range(x.shape[0]):
        xi = dtype(x[i])
        yi = dtype(xi + m0)
        m0 = dtype(m1 + (b0 * xi - a0 * yi))
        m1 = dtype(b1 * xi - a1 * yi)
        y[i] = np.float32(yi)
    mem[0], mem[1] = m0, m1  # mem keeps the accumulation dtype across frames
    return y


def apply_window(x: np.ndarray) -> np.ndarray:
    out = np.array(x, dtype=np.float32)
    out[: C.FRAME_SIZE] *= _HALF_WINDOW
    out[C.FRAME_SIZE:] *= _HALF_WINDOW[::-1]
    return out


def forward_transform(x: np.ndarray) -> np.ndarray:
    """rfft with RNNoise's 1/WINDOW_SIZE forward scaling; FREQ_SIZE bins."""
    return (np.fft.rfft(x.astype(np.float64)) / C.WINDOW_SIZE).astype(np.complex64)


def inverse_transform(X: np.ndarray) -> np.ndarray:
    """Inverse of forward_transform: irfft scaled back up by WINDOW_SIZE."""
    return (np.fft.irfft(X.astype(np.complex128), n=C.WINDOW_SIZE) * C.WINDOW_SIZE).astype(np.float32)


def compute_band_energy(X: np.ndarray) -> np.ndarray:
    e = (X.real.astype(np.float32) ** 2 + X.imag.astype(np.float32) ** 2)
    return (_BAND_E @ e).astype(np.float32)


def compute_band_corr(X: np.ndarray, P: np.ndarray) -> np.ndarray:
    c = (X.real.astype(np.float32) * P.real.astype(np.float32)
         + X.imag.astype(np.float32) * P.imag.astype(np.float32))
    return (_BAND_E @ c).astype(np.float32)


def interp_band_gain(band: np.ndarray) -> np.ndarray:
    return (_BAND_INTERP @ band.astype(np.float32)).astype(np.float32)


def dct(x: np.ndarray) -> np.ndarray:
    return (_DCT @ x.astype(np.float32)).astype(np.float32)


# --------------------------------------------------------------------------
# Pitch analysis (port of the public celt pitch code used by RNNoise)
# --------------------------------------------------------------------------

def pitch_downsample(x: np.ndarray) -> np.ndarray:
    """2x decimation with a [.25, .5, .25] smoother; output len = len(x)//2."""
    n = x.shape[0] // 2
    out = np.empty(n, dtype=np.float32)
    out[0] = 0.5 * (0.5 * x[1] + x[0])
    i = np.arange(1, n)
    out[1:] = 0.5 * (0.5 * (x[2 * i - 1] + x[2 * i + 1]) + x[2 * i])
    return out


def _xcorr(x: np.ndarray, y: np.ndarray, max_pitch: int) -> np.ndarray:
    """xcorr[i] = sum_j x[j] * y[j + i] for i in [0, max_pitch)."""
    n = x.shape[0]
    windows = np.lib.stride_tricks.sliding_window_view(y, n)[:max_pitch]
    return (windows @ x).astype(np.float32)


def find_best_pitch(xcorr: np.ndarray, y: np.ndarray, length: int, max_pitch: int) -> Tuple[int, int]:
    """Track the top-2 lags by normalized correlation xcorr^2 / Syy.

    Syy is the running window energy 1 + sum(y[i:i+len]^2), clamped >= 1,
    updated incrementally exactly like the C code.
    """
    sq = y.astype(np.float32) ** 2
    csum = np.concatenate([[np.float32(0.0)], np.cumsum(sq, dtype=np.float32)])
    syy_all = np.maximum(
        np.float32(1.0),
        np.float32(1.0) + csum[length: length + max_pitch] - csum[:max_pitch],
    )
    best_num = [np.float32(-1.0), np.float32(-1.0)]
    best_den = [np.float32(0.0), np.float32(0.0)]
    best_pitch = [0, 1]
    for i in range(max_pitch):
        xc = xcorr[i]
        if xc > 0:
            num = np.float32(xc * xc)
            Syy = syy_all[i]
            if num * best_den[1] > best_num[1] * Syy:
                if num * best_den[0] > best_num[0] * Syy:
                    best_num[1], best_den[1], best_pitch[1] = best_num[0], best_den[0], best_pitch[0]
                    best_num[0], best_den[0], best_pitch[0] = num, Syy, i
                else:
                    best_num[1], best_den[1], best_pitch[1] = num, Syy, i
    return best_pitch[0], best_pitch[1]


def pitch_search(x_lp: np.ndarray, y: np.ndarray, length: int, max_pitch: int) -> int:
    """Coarse (4x) then fine (2x) normalized-correlation search.

    `length`/`max_pitch` are given in full-rate units; x_lp and y are already
    2x-decimated, so the fine stage works at len>>1 and the coarse stage
    decimates once more to len>>2.
    """
    # Coarse stage at quarter resolution (plain decimation: x_lp4[j] = x_lp[2j]).
    x_lp4 = x_lp[0: 2 * (length >> 2): 2]
    y_lp4 = y[0: 2 * ((length + max_pitch) >> 2): 2]
    xcorr4 = _xcorr(x_lp4, y_lp4, max_pitch >> 2)
    best4, second4 = find_best_pitch(xcorr4, y_lp4, length >> 2, max_pitch >> 2)

    # Fine stage at half resolution, only near the two coarse candidates.
    xcorr2 = np.zeros(max_pitch >> 1, dtype=np.float32)
    for i in range(max_pitch >> 1):
        if abs(i - 2 * best4) > 2 and abs(i - 2 * second4) > 2:
            continue
        s = np.float32(np.dot(x_lp[: length >> 1], y[i: i + (length >> 1)]))
        xcorr2[i] = max(np.float32(-1.0), s)
    best2, _ = find_best_pitch(xcorr2, y, length >> 1, max_pitch >> 1)

    # Pseudo-interpolation around the winner.
    offset = 0
    if 0 < best2 < (max_pitch >> 1) - 1:
        a, b_, c_ = xcorr2[best2 - 1], xcorr2[best2], xcorr2[best2 + 1]
        if c_ - a > 0.7 * (b_ - a):
            offset = 1
        elif a - c_ > 0.7 * (b_ - c_):
            offset = -1
    return 2 * best2 - offset


def compute_pitch_gain(xy: np.float32, xx: np.float32, yy: np.float32) -> np.float32:
    return np.float32(xy / np.sqrt(1.0 + np.float64(xx) * np.float64(yy)))


def remove_doubling(
    x: np.ndarray, maxperiod: int, minperiod: int, N: int, T0: int,
    prev_period: int, prev_gain: float,
) -> Tuple[int, np.float32]:
    """Subharmonic check: prefer T/k if the correlation there is strong enough.

    Returns (refined full-rate period, pitch gain). All work happens at the
    2x-decimated rate; x is the decimated pitch buffer.
    """
    minperiod0 = minperiod
    maxperiod //= 2
    minperiod //= 2
    T0 //= 2
    prev_period //= 2
    N //= 2
    off = maxperiod  # x origin
    if T0 >= maxperiod:
        T0 = maxperiod - 1

    T = T0
    xs = x[off: off + N]
    xx = np.float32(np.dot(xs, xs))
    xy = np.float32(np.dot(xs, x[off - T0: off - T0 + N]))
    # yy_lookup[i] = energy of the window starting i samples earlier
    # (clamped >= 0), vectorized form of the C running update.
    sq = (x.astype(np.float32) ** 2)
    csum = np.concatenate([[np.float32(0.0)], np.cumsum(sq, dtype=np.float32)])
    starts = off - np.arange(maxperiod + 1)
    yy_lookup = np.maximum(0.0, csum[starts + N] - csum[starts]).astype(np.float32)
    yy = yy_lookup[T0]
    best_xy, best_yy = xy, yy
    g = g0 = compute_pitch_gain(xy, xx, yy)

    for k in range(2, 16):
        T1 = (2 * T0 + k) // (2 * k)
        if T1 < minperiod:
            break
        if k == 2:
            T1b = T0 + T1 if T0 + T1 <= maxperiod else T0
        else:
            T1b = (2 * int(C.SECOND_CHECK[k]) * T0 + k) // (2 * k)
        xy1 = np.float32(np.dot(xs, x[off - T1: off - T1 + N]))
        xy2 = np.float32(np.dot(xs, x[off - T1b: off - T1b + N]))
        xy_avg = np.float32(0.5 * (xy1 + xy2))
        yy_avg = np.float32(0.5 * (yy_lookup[T1] + yy_lookup[T1b]))
        g1 = compute_pitch_gain(xy_avg, xx, yy_avg)
        if abs(T1 - prev_period) <= 1:
            cont = np.float32(prev_gain)
        elif abs(T1 - prev_period) <= 2 and 5 * k * k < T0:
            cont = np.float32(0.5 * prev_gain)
        else:
            cont = np.float32(0.0)
        thresh = max(np.float32(0.3), np.float32(0.7 * g0 - cont))
        # Bias against very short periods (short-term correlation).
        if T1 < 3 * minperiod:
            thresh = max(np.float32(0.4), np.float32(0.85 * g0 - cont))
        elif T1 < 2 * minperiod:
            thresh = max(np.float32(0.5), np.float32(0.9 * g0 - cont))
        if g1 > thresh:
            best_xy, best_yy = xy_avg, yy_avg
            T = T1
            g = g1

    best_xy = max(np.float32(0.0), best_xy)
    pg = np.float32(1.0) if best_yy <= best_xy else np.float32(best_xy / (best_yy + 1.0))

    xcorr3 = np.empty(3, dtype=np.float32)
    for kk in range(3):
        xcorr3[kk] = np.float32(np.dot(xs, x[off - (T + kk - 1): off - (T + kk - 1) + N]))
    if xcorr3[2] - xcorr3[0] > 0.7 * (xcorr3[1] - xcorr3[0]):
        offset = 1
    elif xcorr3[0] - xcorr3[2] > 0.7 * (xcorr3[1] - xcorr3[2]):
        offset = -1
    else:
        offset = 0
    if pg > g:
        pg = g
    T0_out = 2 * T + offset
    if T0_out < minperiod0:
        T0_out = minperiod0
    return T0_out, pg


# --------------------------------------------------------------------------
# Network inference
# --------------------------------------------------------------------------

def _activate(x: np.ndarray, activation: str) -> np.ndarray:
    if activation == "tanh":
        return C.tansig_approx(x)
    if activation == "sigmoid":
        return C.sigmoid_approx(x)
    if activation == "relu":
        return np.maximum(x, np.float32(0.0)).astype(np.float32)
    raise ValueError(activation)


def compute_dense(layer: Dense, x: np.ndarray) -> np.ndarray:
    return _activate((x @ layer.w + layer.b).astype(np.float32), layer.activation)


def compute_gru(gru: GRU, state: np.ndarray, x: np.ndarray) -> np.ndarray:
    n = gru.n
    pre_in = (x @ gru.w).astype(np.float32)
    pre_z = pre_in[:n] + state @ gru.u[:, :n] + gru.b[:n]
    pre_r = pre_in[n:2 * n] + state @ gru.u[:, n:2 * n] + gru.b[n:2 * n]
    z = C.sigmoid_approx(pre_z)
    r = C.sigmoid_approx(pre_r)
    pre_h = pre_in[2 * n:] + (state * r) @ gru.u[:, 2 * n:] + gru.b[2 * n:]
    h = _activate(pre_h.astype(np.float32), gru.activation)
    return (z * state + (np.float32(1.0) - z) * h).astype(np.float32)


@dataclass
class RNNState:
    vad: np.ndarray
    noise: np.ndarray
    denoise: np.ndarray

    @staticmethod
    def zeros(model: RNNoiseModel) -> "RNNState":
        s = model.state_sizes()
        return RNNState(
            np.zeros(s["vad"], np.float32),
            np.zeros(s["noise"], np.float32),
            np.zeros(s["denoise"], np.float32),
        )


def compute_rnn(model: RNNoiseModel, state: RNNState, features: np.ndarray) -> Tuple[np.ndarray, np.float32]:
    dense_out = compute_dense(model.input_dense, features)
    state.vad = compute_gru(model.vad_gru, state.vad, dense_out)
    vad = compute_dense(model.vad_output, state.vad)[0]
    noise_in = np.concatenate([dense_out, state.vad, features]).astype(np.float32)
    state.noise = compute_gru(model.noise_gru, state.noise, noise_in)
    denoise_in = np.concatenate([state.vad, state.noise, features]).astype(np.float32)
    state.denoise = compute_gru(model.denoise_gru, state.denoise, denoise_in)
    gains = compute_dense(model.denoise_output, state.denoise)
    return gains, vad


# --------------------------------------------------------------------------
# Pitch filter
# --------------------------------------------------------------------------

def pitch_filter(
    X: np.ndarray, P: np.ndarray, Ex: np.ndarray, Ep: np.ndarray, Exp: np.ndarray, g: np.ndarray
) -> np.ndarray:
    r = np.where(
        Exp > g,
        np.float32(1.0),
        (Exp ** 2) * (1.0 - g ** 2) / (np.float32(0.001) + (g ** 2) * (1.0 - Exp ** 2)),
    ).astype(np.float32)
    r = np.sqrt(np.clip(r, 0.0, 1.0)).astype(np.float32)
    r = (r * np.sqrt(Ex / (1e-8 + Ep))).astype(np.float32)
    rf = interp_band_gain(r)
    Xp = (X + rf * P).astype(np.complex64)
    newE = compute_band_energy(Xp)
    norm = np.sqrt(Ex / (1e-8 + newE)).astype(np.float32)
    normf = interp_band_gain(norm)
    return (Xp * normf).astype(np.complex64)


# --------------------------------------------------------------------------
# DenoiseState — the streaming per-frame oracle
# --------------------------------------------------------------------------

@dataclass
class DenoiseState:
    """Sequential RNNoise state, one 480-sample frame per call.

    API mirrors nnnoiseless's DenoiseState::process_frame as driven by the
    reference (audio.rs:260-271): input/output are ±32768-scaled floats.
    """

    model: RNNoiseModel = field(default_factory=builtin_model)

    def __post_init__(self):
        self.analysis_mem = np.zeros(C.FRAME_SIZE, np.float32)
        self.synthesis_mem = np.zeros(C.FRAME_SIZE, np.float32)
        self.pitch_buf = np.zeros(C.PITCH_BUF_SIZE, np.float32)
        self.cepstral_mem = np.zeros((C.CEPS_MEM, C.NB_BANDS), np.float32)
        self.memid = 0
        self.mem_hp_x = np.zeros(2, np.float64)
        self.lastg = np.zeros(C.NB_BANDS, np.float32)
        self.last_gain = np.float32(0.0)
        self.last_period = 0
        self.rnn = RNNState.zeros(self.model)

    # -- analysis pieces ------------------------------------------------------
    def _frame_analysis(self, frame: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        x = np.concatenate([self.analysis_mem, frame]).astype(np.float32)
        self.analysis_mem = frame.astype(np.float32).copy()
        xw = apply_window(x)
        X = forward_transform(xw)
        return X, compute_band_energy(X)

    def _compute_frame_features(self, frame: np.ndarray):
        X, Ex = self._frame_analysis(frame)

        # Slide pitch buffer and append the (HP-filtered) frame.
        self.pitch_buf[:-C.FRAME_SIZE] = self.pitch_buf[C.FRAME_SIZE:]
        self.pitch_buf[-C.FRAME_SIZE:] = frame
        pb_ds = pitch_downsample(self.pitch_buf)

        pitch_raw = pitch_search(
            pb_ds[C.PITCH_MAX_PERIOD >> 1:], pb_ds,
            C.PITCH_FRAME_SIZE, C.PITCH_MAX_PERIOD - 3 * C.PITCH_MIN_PERIOD,
        )
        pitch_index = C.PITCH_MAX_PERIOD - pitch_raw
        pitch_index, gain = remove_doubling(
            pb_ds, C.PITCH_MAX_PERIOD, C.PITCH_MIN_PERIOD, C.PITCH_FRAME_SIZE,
            pitch_index, self.last_period, float(self.last_gain),
        )
        self.last_period = pitch_index
        self.last_gain = gain

        p = self.pitch_buf[
            C.PITCH_BUF_SIZE - C.WINDOW_SIZE - pitch_index:
            C.PITCH_BUF_SIZE - pitch_index
        ]
        pw = apply_window(p)
        P = forward_transform(pw)
        Ep = compute_band_energy(P)
        Exp_raw = compute_band_corr(X, P)
        Exp = (Exp_raw / np.sqrt(np.float32(0.001) + Ex * Ep)).astype(np.float32)

        features = np.zeros(C.NB_FEATURES, np.float32)
        tmp = dct(Exp)
        base = C.NB_BANDS + 2 * C.NB_DELTA_CEPS
        features[base: base + C.NB_DELTA_CEPS] = tmp[: C.NB_DELTA_CEPS]
        features[base] -= 1.3
        features[base + 1] -= 0.9
        features[C.NB_BANDS + 3 * C.NB_DELTA_CEPS] = np.float32(0.01 * (pitch_index - 300))

        # Log band energies with intra-frame max-follow smoothing.
        Ly = np.empty(C.NB_BANDS, np.float32)
        log_max = np.float32(-2.0)
        follow = np.float32(-2.0)
        E = np.float32(0.0)
        for i in range(C.NB_BANDS):
            v = np.float32(np.log10(1e-2 + Ex[i]))
            v = max(np.float32(log_max - 7.0), max(np.float32(follow - 1.5), v))
            log_max = max(log_max, v)
            follow = max(np.float32(follow - 1.5), v)
            Ly[i] = v
            E = np.float32(E + Ex[i])

        if E < C.SILENCE_ENERGY:
            # Silence: don't corrupt state, return zero features.
            return True, X, P, Ex, Ep, Exp, np.zeros(C.NB_FEATURES, np.float32)

        ceps = dct(Ly)
        features[: C.NB_BANDS] = ceps
        features[0] -= 12.0
        features[1] -= 4.0
        ceps_1 = self.cepstral_mem[(self.memid - 1) % C.CEPS_MEM]
        ceps_2 = self.cepstral_mem[(self.memid - 2) % C.CEPS_MEM]
        self.cepstral_mem[self.memid] = features[: C.NB_BANDS]
        ceps_0 = self.cepstral_mem[self.memid]
        self.memid = (self.memid + 1) % C.CEPS_MEM
        for i in range(C.NB_DELTA_CEPS):
            features[i] = ceps_0[i] + ceps_1[i] + ceps_2[i]
            features[C.NB_BANDS + i] = ceps_0[i] - ceps_2[i]
            features[C.NB_BANDS + C.NB_DELTA_CEPS + i] = ceps_0[i] - 2 * ceps_1[i] + ceps_2[i]

        # Spectral variability over the cepstral memory.
        spec_variability = np.float32(0.0)
        for i in range(C.CEPS_MEM):
            dists = np.sum((self.cepstral_mem[i] - self.cepstral_mem) ** 2, axis=1)
            dists[i] = np.inf
            spec_variability = np.float32(spec_variability + dists.min())
        features[C.NB_BANDS + 3 * C.NB_DELTA_CEPS + 1] = np.float32(
            spec_variability / C.CEPS_MEM - 2.1
        )
        return False, X, P, Ex, Ep, Exp, features

    def _frame_synthesis(self, X: np.ndarray) -> np.ndarray:
        x = inverse_transform(X)
        xw = apply_window(x)
        out = (xw[: C.FRAME_SIZE] + self.synthesis_mem).astype(np.float32)
        self.synthesis_mem = xw[C.FRAME_SIZE:].copy()
        return out

    # -- the public per-frame entry point -------------------------------------
    def process_frame(self, frame: np.ndarray) -> Tuple[np.ndarray, float]:
        """Denoise one 480-sample ±32768-scaled frame. Returns (out, vad)."""
        frame = np.asarray(frame, dtype=np.float32)
        if frame.shape != (C.FRAME_SIZE,):
            raise ValueError(f"expected ({C.FRAME_SIZE},) frame, got {frame.shape}")
        x = biquad(frame, self.mem_hp_x, C.BIQUAD_B_HP, C.BIQUAD_A_HP)
        silence, X, P, Ex, Ep, Exp, features = self._compute_frame_features(x)
        vad = np.float32(0.0)
        if not silence:
            g, vad = compute_rnn(self.model, self.rnn, features)
            X = pitch_filter(X, P, Ex, Ep, Exp, g)
            g = np.maximum(g, np.float32(C.ALPHA_LASTG) * self.lastg).astype(np.float32)
            self.lastg = g.copy()
            gf = interp_band_gain(g)
            X = (X * gf).astype(np.complex64)
        out = self._frame_synthesis(X)
        return out, float(vad)


def denoise_stream(audio: np.ndarray, model: Optional[RNNoiseModel] = None) -> np.ndarray:
    """Denoise a mono [-1, 1] stream frame-by-frame; returns same length.

    Handles the ±32768 scaling and trailing-partial-frame passthrough. The
    first frame of output is windowing warm-up (the reference drops it:
    audio.rs:275-278); callers that need that behavior drop it themselves.
    """
    model = model or builtin_model()
    st = DenoiseState(model=model)
    audio = np.asarray(audio, dtype=np.float32)
    n_frames = audio.shape[0] // C.FRAME_SIZE
    out = np.array(audio, copy=True)
    for f in range(n_frames):
        seg = audio[f * C.FRAME_SIZE: (f + 1) * C.FRAME_SIZE]
        den, _ = st.process_frame(seg * np.float32(32768.0))
        out[f * C.FRAME_SIZE: (f + 1) * C.FRAME_SIZE] = den / np.float32(32768.0)
    return out
