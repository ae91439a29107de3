"""Plain NumPy RNNoise over a batch of streams: the denoise cells' reference.

The public RNNoise frame chain (Valin, arXiv:1709.08243, as nnnoiseless runs
it), one 480-sample frame after another for every stream of a batch:

    x = hp_biquad(in)                         input high-pass (float64)
    X, Ex  = window + rfft + band energies    of the last two HP frames
    pitch  = pitch_search, then remove_doubling with the carried period/gain
    P, Ep, Exp = the pitch-delayed window's spectrum, energies, correlation
    feats  = cepstra (silence-gated history), deltas, pitch, variability
    if not silence: gains, vad = GRU network(feats); pitch filter; gains
    out    = irfft + window + overlap-add

It imports nothing of the program. Work that no carried state feeds (the
spectra, the pitch search, the subharmonic candidates) is done for a whole
block of frames at once; what the state feeds (remove_doubling's
continuation, the cepstral history, the network, the smoothed gains) runs
frame by frame over the streams.

``tf32=True`` computes the same chain with every operand of a product
(the filter's input, the transforms' inputs, every matrix product) rounded
to TensorFloat-32's 10-bit mantissa: the control of the denoise cells.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict

import numpy as np

FRAME = 480
WIN = 960
NFREQ = 481
PBUF = 1728
PMAX = 768
PMIN = 60
PFRAME = 960
NB = 22
CEPS_MEM = 8
NDELTA = 6
NFEAT = NB + 3 * NDELTA + 2  # 42
EBAND = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 34, 40, 48, 60, 78, 100])
BIQ_A = np.array([-1.99599, 0.99600], dtype=np.float32)
BIQ_B = np.array([-2.0, 1.0], dtype=np.float32)
ALPHA_LASTG = np.float32(0.6)
SILENCE_ENERGY = 0.04
SECOND_CHECK = np.array([0, 0, 3, 2, 3, 2, 5, 2, 3, 2, 3, 2, 5, 2, 3, 2])

_F32 = np.float32


def _half_window() -> np.ndarray:
    i = np.arange(FRAME, dtype=np.float64)
    t = np.sin(0.5 * np.pi * (i + 0.5) / FRAME)
    return np.sin(0.5 * np.pi * t * t).astype(np.float32)


def _dct() -> np.ndarray:
    i = np.arange(NB)[:, None].astype(np.float64)
    j = np.arange(NB)[None, :].astype(np.float64)
    d = np.cos((j + 0.5) * i * np.pi / NB)
    d[0, :] *= np.sqrt(0.5)
    return (d * np.sqrt(2.0 / NB)).astype(np.float32)  # out = D @ in


def _band_tables():
    """(energy [NB, NFREQ], interpolation [NFREQ, NB]): triangles between
    band edges, the first and last energy bands doubled."""
    e = np.zeros((NB, NFREQ))
    g = np.zeros((NFREQ, NB))
    for i in range(NB - 1):
        size, base = (EBAND[i + 1] - EBAND[i]) * 4, EBAND[i] * 4
        for j in range(size):
            frac = j / size
            e[i, base + j] += 1.0 - frac
            e[i + 1, base + j] += frac
            g[base + j, i] = 1.0 - frac
            g[base + j, i + 1] = frac
    e[0] *= 2.0
    e[NB - 1] *= 2.0
    return e.astype(np.float32), g.astype(np.float32)


WINDOW = np.concatenate([_half_window(), _half_window()[::-1]])
DCT = _dct()
BAND_E, BAND_INTERP = _band_tables()
TANSIG = np.tanh(0.04 * np.arange(201, dtype=np.float64)).astype(np.float32)


def tf32(x: np.ndarray) -> np.ndarray:
    """float32 rounded to the nearest TensorFloat-32 value (10-bit mantissa,
    ties to even)."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    r = (b + np.uint32(0xFFF) + ((b >> np.uint32(13)) & np.uint32(1))) & np.uint32(0xFFFFE000)
    return r.view(np.float32)


def tansig(x: np.ndarray) -> np.ndarray:
    """RNNoise's table tanh: the table at 0.04 steps with its correction
    term, ±1 from |x| >= 8."""
    x = np.asarray(x, dtype=np.float32)
    ax = np.abs(x)
    i = np.minimum((25.0 * ax + 0.5).astype(np.int32), 200)
    dx = ax - _F32(0.04) * i.astype(np.float32)
    y = TANSIG[i]
    y = y + dx * (_F32(1) - y * y) * (_F32(1) - y * dx)
    y = np.where(ax >= 8, _F32(1), y)
    return np.copysign(y, x).astype(np.float32)


def sigmoid(x: np.ndarray) -> np.ndarray:
    return (_F32(0.5) + _F32(0.5) * tansig(_F32(0.5) * np.asarray(x, np.float32))).astype(np.float32)


def _act(x: np.ndarray, kind: str) -> np.ndarray:
    if kind == "tanh":
        return tansig(x)
    if kind == "sigmoid":
        return sigmoid(x)
    if kind == "relu":
        return np.maximum(x, _F32(0)).astype(np.float32)
    raise ValueError(kind)


@dataclass
class Layer:
    w: np.ndarray  # [in, out] (a GRU's gates z | r | h on the out axis)
    b: np.ndarray
    act: str
    u: np.ndarray = None  # GRU only: [n, 3n]


def load_weights(path) -> Dict[str, Layer]:
    """The six layers of an RNNoise ``.npz`` (float32 ``[in, out]``)."""
    z = np.load(Path(path), allow_pickle=False)
    out = {}
    for name in ("input_dense", "vad_gru", "vad_output", "noise_gru", "denoise_gru",
                 "denoise_output"):
        out[name] = Layer(z[f"{name}.w"].astype(np.float32), z[f"{name}.b"].astype(np.float32),
                          str(z[f"{name}.act"]),
                          z[f"{name}.u"].astype(np.float32) if f"{name}.u" in z else None)
    return out


class Denoiser:
    """RNNoise state for S streams; ``block`` steps it over [S, F*480]
    int16-scaled samples (±32768 full scale) and returns the same."""

    def __init__(self, weights: Dict[str, Layer], n_streams: int, tf32: bool = False):
        S = n_streams
        self.w = weights
        self.tf32 = tf32
        self.hp_mem = np.zeros((S, 2), np.float64)
        self.pitch_buf = np.zeros((S, PBUF), np.float32)
        self.last_period = np.zeros(S, np.int64)
        self.last_gain = np.zeros(S, np.float32)
        self.ceps_mem = np.zeros((S, CEPS_MEM, NB), np.float32)
        self.memid = np.zeros(S, np.int64)
        self.gru = {k: np.zeros((S, weights[k].u.shape[0]), np.float32)
                    for k in ("vad_gru", "noise_gru", "denoise_gru")}
        self.lastg = np.zeros((S, NB), np.float32)
        self.syn_mem = np.zeros((S, FRAME), np.float32)

    # -- products, in the chosen precision -------------------------------------
    def _r(self, x):
        return tf32(x) if self.tf32 else np.asarray(x, np.float32)

    def mm(self, a, b):
        if self.tf32:
            return tf32(a) @ tf32(b)
        return np.asarray(a, np.float32) @ np.asarray(b, np.float32)

    def rfft(self, frames):
        """Windowed frames [.., 960] → spectrum with RNNoise's 1/960 scaling."""
        x = self._r(frames * WINDOW).astype(np.float64)
        return (np.fft.rfft(x, axis=-1) / WIN).astype(np.complex64)

    def band_energy(self, X):
        return self.mm(X.real * X.real + X.imag * X.imag, BAND_E.T)

    # -- pitch ----------------------------------------------------------------
    @staticmethod
    def _best_two(xc, y, length, nlags):
        """celt find_best_pitch over lags [0, nlags) of xc [N, nlags], with
        the window energies of y [N, *] over ``length`` samples; the two best
        lags by xc^2 / Syy, compared by cross-multiplication as the C code."""
        sq = (y[:, : length + nlags] * y[:, : length + nlags]).astype(np.float32)
        cs = np.concatenate([np.zeros((y.shape[0], 1), np.float32),
                             np.cumsum(sq, axis=1, dtype=np.float32)], axis=1)
        syy = np.maximum(_F32(1), _F32(1) + cs[:, length: length + nlags] - cs[:, :nlags])
        n = xc.shape[0]
        bn = [np.full(n, -1.0, np.float32), np.full(n, -1.0, np.float32)]
        bd = [np.zeros(n, np.float32), np.zeros(n, np.float32)]
        bp = [np.zeros(n, np.int64), np.ones(n, np.int64)]
        for i in range(nlags):
            c = xc[:, i]
            num = (c * c).astype(np.float32)
            s = syy[:, i]
            b1 = (c > 0) & (num * bd[1] > bn[1] * s)
            b0 = b1 & (num * bd[0] > bn[0] * s)
            bn[1] = np.where(b0, bn[0], np.where(b1, num, bn[1]))
            bd[1] = np.where(b0, bd[0], np.where(b1, s, bd[1]))
            bp[1] = np.where(b0, bp[0], np.where(b1, i, bp[1]))
            bn[0] = np.where(b0, num, bn[0])
            bd[0] = np.where(b0, s, bd[0])
            bp[0] = np.where(b0, i, bp[0])
        return bp[0], bp[1]

    def _xcorr(self, x, y, nlags):
        """xc[n, i] = sum_j x[n, j] * y[n, j + i], i < nlags, by a float64
        FFT long enough that nothing wraps. Where x or y's window is all
        zeros the sum is exactly 0, as a direct sum gives it (the transform
        leaves rounding there, and the pitch search's ``xc > 0`` tests would
        read it)."""
        x, y = self._r(x).astype(np.float64), self._r(y).astype(np.float64)
        n = x.shape[1]
        nfft = 1 << int(np.ceil(np.log2(y.shape[1])))
        xc = np.fft.irfft(np.conj(np.fft.rfft(x, n=nfft, axis=1)) * np.fft.rfft(y, n=nfft, axis=1),
                          n=nfft, axis=1)[:, :nlags]
        cs = np.concatenate([np.zeros((y.shape[0], 1)), np.cumsum(y * y, axis=1)], axis=1)
        silent = (cs[:, n: n + nlags] == cs[:, :nlags]) | ~np.any(x != 0, axis=1, keepdims=True)
        return np.where(silent, 0.0, xc).astype(np.float32)

    def _pitch_search(self, pb):
        """pb [N, 864] decimated pitch buffers → full-rate pitch period [N]."""
        length, maxp = PFRAME, PMAX - 3 * PMIN  # 960, 588
        x_lp, y = pb[:, PMAX >> 1:], pb
        x4 = x_lp[:, 0: 2 * (length >> 2): 2]
        y4 = y[:, 0: 2 * ((length + maxp) >> 2): 2]
        best4, second4 = self._best_two(self._xcorr(x4, y4, maxp >> 2), y4, length >> 2, maxp >> 2)
        full = self._xcorr(x_lp[:, : length >> 1], y, maxp >> 1)  # [N, 294]
        lags = np.arange(maxp >> 1)
        near = ((np.abs(lags - 2 * best4[:, None]) <= 2) | (np.abs(lags - 2 * second4[:, None]) <= 2))
        xc2 = np.where(near, np.maximum(_F32(-1), full), _F32(0)).astype(np.float32)
        best2, _ = self._best_two(xc2, y, length >> 1, maxp >> 1)
        rows = np.arange(xc2.shape[0])
        a = xc2[rows, np.maximum(best2 - 1, 0)]
        b = xc2[rows, best2]
        c = xc2[rows, np.minimum(best2 + 1, (maxp >> 1) - 1)]
        off = np.where(c - a > 0.7 * (b - a), 1, np.where(a - c > 0.7 * (b - c), -1, 0))
        off = np.where((best2 > 0) & (best2 < (maxp >> 1) - 1), off, 0)
        return 2 * best2 - off

    def _doubling_candidates(self, pb, T0):
        """remove_doubling's work that the carried period and gain do not
        feed, for every frame: pb [N, 864], T0 [N] full rate."""
        maxp, minp, n, off = PMAX // 2, PMIN // 2, PFRAME // 2, PMAX // 2
        T0 = np.minimum(T0 // 2, maxp - 1)
        xs = pb[:, off: off + n]
        xx = np.sum(xs.astype(np.float32) * xs, axis=1, dtype=np.float32)
        # corr[:, T] = dot(xs, pb[off - T: off - T + n]), T = 0..maxp
        corr = self._xcorr(xs, pb[:, : off + n], maxp + 1)[:, ::-1]
        sq = (pb * pb).astype(np.float32)
        cs = np.concatenate([np.zeros((pb.shape[0], 1), np.float32),
                             np.cumsum(sq, axis=1, dtype=np.float32)], axis=1)
        starts = off - np.arange(maxp + 1)
        yy = np.maximum(_F32(0), cs[:, starts + n] - cs[:, starts]).astype(np.float32)
        rows = np.arange(pb.shape[0])[:, None]
        ks = np.arange(2, 16)
        T1 = (2 * T0[:, None] + ks) // (2 * ks)
        T1b = np.where(ks == 2, np.where(T0[:, None] + T1 <= maxp, T0[:, None] + T1, T0[:, None]),
                       (2 * SECOND_CHECK[ks] * T0[:, None] + ks) // (2 * ks))
        valid = np.cumprod(T1 >= minp, axis=1).astype(bool)
        T1c, T1bc = np.clip(T1, 0, maxp), np.clip(T1b, 0, maxp)
        xy_avg = (_F32(0.5) * (corr[rows, T1c] + corr[rows, T1bc])).astype(np.float32)
        yy_avg = (_F32(0.5) * (yy[rows, T1c] + yy[rows, T1bc])).astype(np.float32)
        g1 = self._gain(xy_avg, xx[:, None], yy_avg)
        xy0, yy0 = corr[rows[:, 0], T0], yy[rows[:, 0], T0]
        return dict(T0=T0, xx=xx, corr=corr, T1=T1, valid=valid, xy_avg=xy_avg, yy_avg=yy_avg,
                    g1=g1, xy0=xy0, yy0=yy0, g0=self._gain(xy0, xx, yy0))

    @staticmethod
    def _gain(xy, xx, yy):
        return (xy / np.sqrt(1.0 + xx.astype(np.float64) * yy.astype(np.float64))).astype(np.float32)

    def _doubling_step(self, c, f):
        """The continuation for frame f of every stream: reads and updates
        last_period / last_gain; returns the pitch index [S]."""
        minp = PMIN // 2
        T0, T1, g0 = c["T0"][:, f], c["T1"][:, f], c["g0"][:, f]
        pp = (self.last_period // 2)[:, None]
        d = np.abs(T1 - pp)
        k2 = (np.arange(2, 16) ** 2)[None, :]
        pg = self.last_gain[:, None]
        cont = np.where(d <= 1, pg, np.where((d <= 2) & (5 * k2 < T0[:, None]),
                                             (_F32(0.5) * pg).astype(np.float32), _F32(0)))
        g0c = g0[:, None]
        thresh = np.maximum(_F32(0.3), (_F32(0.7) * g0c - cont).astype(np.float32))
        thresh = np.where(T1 < 3 * minp, np.maximum(_F32(0.4), (_F32(0.85) * g0c - cont).astype(np.float32)),
                          np.where(T1 < 2 * minp,
                                   np.maximum(_F32(0.5), (_F32(0.9) * g0c - cont).astype(np.float32)),
                                   thresh))
        take = c["valid"][:, f] & (c["g1"][:, f] > thresh)
        any_k = take.any(axis=1)
        last = 13 - np.argmax(take[:, ::-1], axis=1)
        rows = np.arange(T0.shape[0])
        T = np.where(any_k, T1[rows, last], T0)
        g = np.where(any_k, c["g1"][:, f][rows, last], g0)
        bxy = np.where(any_k, c["xy_avg"][:, f][rows, last], c["xy0"][:, f])
        byy = np.where(any_k, c["yy_avg"][:, f][rows, last], c["yy0"][:, f])
        bxy = np.maximum(_F32(0), bxy)
        pgain = np.where(byy <= bxy, _F32(1), (bxy / (byy + _F32(1))).astype(np.float32))
        corr = c["corr"][:, f]
        x0, x1, x2 = corr[rows, T - 1], corr[rows, T], corr[rows, T + 1]
        off = np.where(x2 - x0 > 0.7 * (x1 - x0), 1, np.where(x0 - x2 > 0.7 * (x1 - x2), -1, 0))
        pgain = np.minimum(pgain, g).astype(np.float32)
        period = np.maximum(PMIN, 2 * T + off)
        self.last_period, self.last_gain = period, pgain
        return period

    # -- network ----------------------------------------------------------------
    def _dense(self, name, x):
        L = self.w[name]
        return _act(self.mm(x, L.w) + L.b, L.act)

    def _gru(self, name, x):
        L, h = self.w[name], self.gru[name]
        n = L.u.shape[0]
        pre = self.mm(x, L.w) + L.b
        zr = sigmoid(pre[:, :2 * n] + self.mm(h, L.u[:, :2 * n]))
        z, r = zr[:, :n], zr[:, n:]
        cand = _act(pre[:, 2 * n:] + self.mm(h * r, L.u[:, 2 * n:]), L.act)
        return (z * h + (_F32(1) - z) * cand).astype(np.float32)

    # -- the block step ---------------------------------------------------------
    def block(self, pcm: np.ndarray) -> np.ndarray:
        from scipy.signal import lfilter

        S, L = pcm.shape
        F = L // FRAME
        x = self._r(np.asarray(pcm, np.float32)).astype(np.float64)
        y, self.hp_mem = lfilter(np.array([1.0, BIQ_B[0], BIQ_B[1]], np.float64),
                                 np.array([1.0, BIQ_A[0], BIQ_A[1]], np.float64),
                                 x, axis=1, zi=self.hp_mem)
        y = y.astype(np.float32)

        ext = np.concatenate([self.pitch_buf, y], axis=1)  # [S, 1728 + F*480]
        self.pitch_buf = ext[:, -PBUF:].copy()
        # analysis window f: HP samples [f*480 - 480, f*480 + 480) of the block
        awin = np.lib.stride_tricks.sliding_window_view(ext[:, PBUF - FRAME:], WIN, axis=1)[:, ::FRAME][:, :F]
        X = self.rfft(awin)
        Ex = self.band_energy(X)

        # pitch buffer after frame f: ext[(f+1)*480 : (f+1)*480 + 1728], decimated by 2
        bufs = np.lib.stride_tricks.sliding_window_view(ext[:, FRAME:], PBUF, axis=1)[:, ::FRAME][:, :F]
        bufs = bufs.reshape(S * F, PBUF)
        pb = np.empty((S * F, PBUF // 2), np.float32)
        pb[:, 0] = _F32(0.5) * (_F32(0.5) * bufs[:, 1] + bufs[:, 0])
        i = np.arange(1, PBUF // 2)
        pb[:, 1:] = _F32(0.5) * (_F32(0.5) * (bufs[:, 2 * i - 1] + bufs[:, 2 * i + 1]) + bufs[:, 2 * i])
        T0 = PMAX - self._pitch_search(pb)
        cand = {k: v.reshape((S, F) + v.shape[1:])
                for k, v in self._doubling_candidates(pb, T0).items()}
        pitch = np.stack([self._doubling_step(cand, f) for f in range(F)], axis=1)  # [S, F]

        starts = (np.arange(1, F + 1) * FRAME)[None, :] + (PBUF - WIN) - pitch
        P = self.rfft(ext[np.arange(S)[:, None, None], starts[..., None] + np.arange(WIN)])
        Ep = self.band_energy(P)
        Exp = (self.mm(X.real * P.real + X.imag * P.imag, BAND_E.T)
               / np.sqrt(_F32(0.001) + Ex * Ep)).astype(np.float32)

        # Frame-parallel features: the Exp cepstrum, the pitch, the log band
        # energies with their intra-frame max-follow, the silence gate.
        feats = np.zeros((S, F, NFEAT), np.float32)
        base = NB + 2 * NDELTA
        feats[..., base: base + NDELTA] = self.mm(Exp, DCT.T)[..., :NDELTA]
        feats[..., base] -= 1.3
        feats[..., base + 1] -= 0.9
        feats[..., NB + 3 * NDELTA] = (0.01 * (pitch - 300)).astype(np.float32)
        Ly = np.empty((S, F, NB), np.float32)
        log_max = np.full((S, F), -2.0, np.float32)
        follow = np.full((S, F), -2.0, np.float32)
        E = np.zeros((S, F), np.float32)
        for b in range(NB):
            v = np.log10(_F32(1e-2) + Ex[..., b]).astype(np.float32)
            v = np.maximum(log_max - _F32(7), np.maximum(follow - _F32(1.5), v))
            log_max = np.maximum(log_max, v)
            follow = np.maximum(follow - _F32(1.5), v)
            Ly[..., b] = v
            E = (E + Ex[..., b]).astype(np.float32)
        silence = E < SILENCE_ENERGY
        ceps0 = self.mm(Ly, DCT.T)
        ceps0[..., 0] -= 12.0
        ceps0[..., 1] -= 4.0

        g_raw = np.zeros((S, F, NB), np.float32)
        g_app = np.zeros((S, F, NB), np.float32)
        rows = np.arange(S)
        eye = np.eye(CEPS_MEM, dtype=bool)
        for f in range(F):
            live = ~silence[:, f]
            mem = self.ceps_mem
            c1 = mem[rows, (self.memid - 1) % CEPS_MEM]
            c2 = mem[rows, (self.memid - 2) % CEPS_MEM]
            c0 = ceps0[:, f]
            mem = np.where(live[:, None, None] & (np.arange(CEPS_MEM)[None, :, None]
                                                  == self.memid[:, None, None]),
                           c0[:, None, :], mem)
            ft = feats[:, f].copy()
            ft[:, :NB] = c0
            ft[:, :NDELTA] = c0[:, :NDELTA] + c1[:, :NDELTA] + c2[:, :NDELTA]
            ft[:, NB: NB + NDELTA] = c0[:, :NDELTA] - c2[:, :NDELTA]
            ft[:, NB + NDELTA: NB + 2 * NDELTA] = c0[:, :NDELTA] - 2 * c1[:, :NDELTA] + c2[:, :NDELTA]
            dist = np.sum((mem[:, :, None, :] - mem[:, None, :, :]) ** 2, axis=-1, dtype=np.float32)
            spec_var = np.where(eye, np.inf, dist).min(axis=2).sum(axis=1, dtype=np.float32)
            ft[:, NB + 3 * NDELTA + 1] = spec_var / CEPS_MEM - _F32(2.1)
            self.ceps_mem = mem
            self.memid = np.where(live, (self.memid + 1) % CEPS_MEM, self.memid)

            d = self._dense("input_dense", ft)
            hv = self._gru("vad_gru", d)
            hn = self._gru("noise_gru", np.concatenate([d, hv, ft], axis=1))
            hd = self._gru("denoise_gru", np.concatenate([hv, hn, ft], axis=1))
            g = self._dense("denoise_output", hd)
            for k, h in (("vad_gru", hv), ("noise_gru", hn), ("denoise_gru", hd)):
                self.gru[k] = np.where(live[:, None], h, self.gru[k])
            gs = np.maximum(g, ALPHA_LASTG * self.lastg).astype(np.float32)
            self.lastg = np.where(live[:, None], gs, self.lastg)
            g_raw[:, f], g_app[:, f] = g, gs

        # Pitch filter with the raw gains, then the smoothed gains; a silent
        # frame passes its spectrum through.
        g2 = g_raw * g_raw
        e2 = Exp * Exp
        r = np.where(Exp > g_raw, _F32(1),
                     e2 * (_F32(1) - g2) / (_F32(0.001) + g2 * (_F32(1) - e2))).astype(np.float32)
        r = (np.sqrt(np.clip(r, 0.0, 1.0)) * np.sqrt(Ex / (_F32(1e-8) + Ep))).astype(np.float32)
        Xp = (X + self.mm(r, BAND_INTERP.T) * P).astype(np.complex64)
        norm = np.sqrt(Ex / (_F32(1e-8) + self.band_energy(Xp))).astype(np.float32)
        Xo = (Xp * self.mm(norm, BAND_INTERP.T) * self.mm(g_app, BAND_INTERP.T)).astype(np.complex64)
        Xo = np.where(silence[..., None], X, Xo)

        xt = (np.fft.irfft(self._spec_r(Xo).astype(np.complex128), n=WIN, axis=-1) * WIN).astype(np.float32)
        xt = xt * WINDOW
        tails = np.concatenate([self.syn_mem[:, None], xt[:, :-1, FRAME:]], axis=1)
        out = (xt[..., :FRAME] + tails).astype(np.float32)
        self.syn_mem = xt[:, -1, FRAME:].copy()
        return out.reshape(S, F * FRAME)

    def _spec_r(self, X):
        if not self.tf32:
            return X
        return (tf32(X.real) + 1j * tf32(X.imag)).astype(np.complex64)


def to_int16(out_scaled: np.ndarray) -> np.ndarray:
    """±32768-scaled float output → int16 PCM as a 16-bit WAV writer stores
    float audio: clip to [-1, 1], scale by 32767, round toward zero."""
    x = np.clip(out_scaled.astype(np.float32) / _F32(32768), -1.0, 1.0)
    return np.trunc(x * _F32(32767)).astype(np.int16)


def denoise(weights, audio: np.ndarray, block_frames: int = 500, tf32: bool = False) -> np.ndarray:
    """Denoise [S, T] streams in blocks of ``block_frames`` frames: int16 PCM
    in gives int16 PCM out (``to_int16``), float audio in [-1, 1] gives float
    out. Samples after the last whole frame pass through."""
    audio = np.atleast_2d(audio)
    pcm = audio.dtype == np.int16
    S, T = audio.shape
    n = (T // FRAME) * FRAME
    d = Denoiser(weights, S, tf32=tf32)
    out = audio.copy()
    step = block_frames * FRAME
    for s in range(0, n, step):
        e = min(n, s + step)
        x = audio[:, s:e].astype(np.float32)
        y = d.block(x if pcm else x * _F32(32768))
        out[:, s:e] = to_int16(y) if pcm else y / _F32(32768)
    return out
