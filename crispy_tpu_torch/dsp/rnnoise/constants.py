"""RNNoise constants and precomputed linear operators (NumPy only).

The PyTorch port's own copy of ``crispy_tpu/dsp/rnnoise/constants.py``: the
port imports nothing of the JAX package, so the tables it shares with it are
duplicated here verbatim. Every constant table the frame chain needs is
re-derived from the public RNNoise algorithm spec, and the band energy / band
interpolation / DCT operations are expressed as dense matrices so they run as
matrix products.
"""

from __future__ import annotations

import numpy as np

# --- Frame geometry -------------------------------------------------------
FRAME_SIZE_SHIFT = 2
FRAME_SIZE = 120 << FRAME_SIZE_SHIFT  # 480 samples = 10 ms @ 48 kHz
WINDOW_SIZE = 2 * FRAME_SIZE  # 960
FREQ_SIZE = FRAME_SIZE + 1  # 481 rfft bins

# --- Pitch analysis geometry ----------------------------------------------
PITCH_MIN_PERIOD = 60
PITCH_MAX_PERIOD = 768
PITCH_FRAME_SIZE = 960
PITCH_BUF_SIZE = PITCH_MAX_PERIOD + PITCH_FRAME_SIZE  # 1728

# --- Feature geometry ------------------------------------------------------
NB_BANDS = 22
CEPS_MEM = 8
NB_DELTA_CEPS = 6
NB_FEATURES = NB_BANDS + 3 * NB_DELTA_CEPS + 2  # 42

# Bark-ish band edges in units of 4 FFT bins (5 ms @ 48 kHz scale).
EBAND_5MS = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 34, 40, 48, 60, 78, 100],
    dtype=np.int32,
)

# Input high-pass biquad (applied to ±32768-scaled samples).
BIQUAD_A_HP = np.array([-1.99599, 0.99600], dtype=np.float32)
BIQUAD_B_HP = np.array([-2.0, 1.0], dtype=np.float32)

# Gain smoothing across frames: g[i] = max(g[i], ALPHA_LASTG * lastg[i]).
ALPHA_LASTG = 0.6

# Silence gate on the sum of band energies (±32768-sample scale).
SILENCE_ENERGY = 0.04

# Scale applied to quantized int8 network weights.
WEIGHTS_SCALE = np.float32(1.0 / 256.0)

# --- Network geometry -------------------------------------------------------
INPUT_DENSE_SIZE = 24
VAD_GRU_SIZE = 24
NOISE_GRU_SIZE = 48
DENOISE_GRU_SIZE = 96


def half_window() -> np.ndarray:
    """Vorbis power-complementary half window over FRAME_SIZE samples.

    w[i] = sin(pi/2 * sin^2(pi/2 * (i + 0.5) / FRAME_SIZE)); the full analysis/
    synthesis window is [w, reversed(w)] and satisfies the Princen-Bradley
    condition so analysis+synthesis windowing with 50% overlap-add is exact.
    """
    i = np.arange(FRAME_SIZE, dtype=np.float64)
    t = np.sin(0.5 * np.pi * (i + 0.5) / FRAME_SIZE)
    return np.sin(0.5 * np.pi * t * t).astype(np.float32)


def full_window() -> np.ndarray:
    hw = half_window()
    return np.concatenate([hw, hw[::-1]]).astype(np.float32)


def dct_matrix() -> np.ndarray:
    """Orthonormal DCT-II over NB_BANDS as out = D @ in.

    D[i, j] = sqrt(2/NB) * c_i * cos((j + 0.5) * i * pi / NB), c_0 = sqrt(.5).
    """
    nb = NB_BANDS
    i = np.arange(nb)[:, None].astype(np.float64)
    j = np.arange(nb)[None, :].astype(np.float64)
    d = np.cos((j + 0.5) * i * np.pi / nb)
    d[0, :] *= np.sqrt(0.5)
    d *= np.sqrt(2.0 / nb)
    return d.astype(np.float32)


def band_energy_matrix() -> np.ndarray:
    """[NB_BANDS, FREQ_SIZE] matrix: bandE = W @ per_bin_energy.

    Triangular interpolation between adjacent band edges; first and last bands
    doubled (they only receive one triangle's worth of mass).
    """
    w = np.zeros((NB_BANDS, FREQ_SIZE), dtype=np.float64)
    for i in range(NB_BANDS - 1):
        band_size = int(EBAND_5MS[i + 1] - EBAND_5MS[i]) << FRAME_SIZE_SHIFT
        base = int(EBAND_5MS[i]) << FRAME_SIZE_SHIFT
        for j in range(band_size):
            frac = j / band_size
            w[i, base + j] += 1.0 - frac
            w[i + 1, base + j] += frac
    w[0] *= 2.0
    w[NB_BANDS - 1] *= 2.0
    return w.astype(np.float32)


def band_interp_matrix() -> np.ndarray:
    """[FREQ_SIZE, NB_BANDS] matrix: per_bin_gain = W @ band_gain.

    Linear interpolation of per-band values across their bin span. Bins above
    the last band edge (400..480) stay zero, matching interp_band_gain's
    zero-initialised output.
    """
    w = np.zeros((FREQ_SIZE, NB_BANDS), dtype=np.float64)
    for i in range(NB_BANDS - 1):
        band_size = int(EBAND_5MS[i + 1] - EBAND_5MS[i]) << FRAME_SIZE_SHIFT
        base = int(EBAND_5MS[i]) << FRAME_SIZE_SHIFT
        for j in range(band_size):
            frac = j / band_size
            w[base + j, i] = 1.0 - frac
            w[base + j, i + 1] = frac
    return w.astype(np.float32)


def tansig_table() -> np.ndarray:
    """201-entry tanh lookup table (tanh(0.04 * i), i = 0..200), float32."""
    return np.tanh(0.04 * np.arange(201, dtype=np.float64)).astype(np.float32)


_TANSIG_TABLE = tansig_table()


def tansig_approx(x: np.ndarray) -> np.ndarray:
    """Table-interpolated tanh approximation used by the RNNoise inference code.

    Faithful to the opus/rnnoise `tansig_approx`: clamp at |x| >= 8, table
    lookup at 0.04 resolution with a cubic-ish correction term.
    """
    x = np.asarray(x, dtype=np.float32)
    sign = np.where(x < 0, np.float32(-1), np.float32(1))
    ax = np.abs(x)
    out_sat = np.where(x >= 8, np.float32(1), np.float32(-1))
    sat = (x >= 8) | (x <= -8)
    i = np.floor(0.5 + 25.0 * np.nan_to_num(ax)).astype(np.int32)
    i = np.clip(i, 0, 200)
    dx = (ax - 0.04 * i.astype(np.float32)).astype(np.float32)
    y = _TANSIG_TABLE[i]
    dy = 1.0 - y * y
    y = y + dx * dy * (1.0 - y * dx)
    out = sign * y
    out = np.where(sat, out_sat, out)
    return np.where(np.isnan(x), np.float32(0), out).astype(np.float32)


def sigmoid_approx(x: np.ndarray) -> np.ndarray:
    return (np.float32(0.5) + np.float32(0.5) * tansig_approx(np.float32(0.5) * np.asarray(x, np.float32))).astype(
        np.float32
    )


# second_check table used by remove_doubling's subharmonic verification.
SECOND_CHECK = np.array([0, 0, 3, 2, 3, 2, 5, 2, 3, 2, 3, 2, 5, 2, 3, 2], dtype=np.int32)
