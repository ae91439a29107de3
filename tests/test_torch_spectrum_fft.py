"""The identity the FFT-structured K4/K5 kernel (csrc/spectrum_fwd.cu) rests on,
shown on the CPU.

The kernel reads only column 0 of ``dft_fwd_pad``, takes it as the window
over 960, multiplies it into the samples and computes the DFT as an FFT. So:
column 0 of the port's table and of the JAX package's is exactly
f32(w / 960); ``torch.fft.rfft`` of the windowed frames, in the padded
layout, agrees with the plain versions (dense products against the whole
table); and the kernel's factorisation (480 complex points as 15 x 32, the
15-point DFT as 3 x 5, the split into real-input bins), run here in float64
with the port's twiddle table as the kernel indexes it, gives the DFT.
"""

import numpy as np
import pytest
import torch

from crispy_tpu_torch.dsp.rnnoise import constants as tc
from crispy_tpu_torch.dsp.rnnoise import frontend_kernels as fk
from crispy_tpu_torch.dsp.rnnoise import pipeline as tp
from crispy_tpu_torch.dsp.rnnoise import weights as tw

try:  # the JAX package's table; the card's machine has no JAX
    from crispy_tpu.dsp.rnnoise import jax_pipeline as jp
    from crispy_tpu.dsp.rnnoise.weights import deterministic_test_model
except ImportError:
    jp = None

FRAME, WIN, NFREQ, HIST = tp.FRAME, tp.WIN, tp.NFREQ, tp.HIST
SCALE = 9000.0  # the input scale of tests/test_pallas_frontend.py
SPEC_TOL = 1e-5  # x max|Y|: f32 sums of 960 terms in another order
EX_RTOL = 1e-4


@pytest.fixture(scope="module")
def tparams():
    return tp.make_params(tw.deterministic_test_model(), "cpu")


def window_over_960() -> np.ndarray:
    return (tc.full_window().astype(np.float64) / WIN).astype(np.float32)


def rfft_padded(frames: torch.Tensor, dft_pad: torch.Tensor) -> torch.Tensor:
    """torch.fft.rfft of frames x column 0 of the table, in Y's padded layout."""
    X = torch.fft.rfft(frames * dft_pad[:, 0], dim=-1)
    Y = torch.zeros(frames.shape[:-1] + (fk.YPAD,), dtype=torch.float32)
    Y[..., :NFREQ] = X.real
    Y[..., fk.IM0: fk.IM0 + NFREQ] = X.imag
    return Y


def assert_spectra_agree(Y, Ex, rY, rEx):
    assert Y.shape == rY.shape and Ex.shape == rEx.shape
    assert float((Y - rY).abs().max()) <= SPEC_TOL * float(rY.abs().max())
    torch.testing.assert_close(Ex, rEx, rtol=EX_RTOL, atol=0.0)


@pytest.mark.parametrize("source", ["port", "jax"])
def test_dft_table_column0_is_window_over_960(source):
    """cos 0 = 1: column 0 of make_params' windowed DFT table is exactly
    f32(w[n] / 960), for the port's table and the JAX package's."""
    if source == "jax":
        if jp is None:
            pytest.skip("the JAX reference is not installed")
        col = np.asarray(jp.make_params(deterministic_test_model())["dft_fwd_pad"])[:, 0]
    else:
        col = tp.make_params(tw.deterministic_test_model(), "cpu")["dft_fwd_pad"][:, 0].numpy()
    np.testing.assert_array_equal(col, window_over_960())


@pytest.mark.parametrize("S,F", [(1, 1), (3, 1), (5, 7), (7, 17)])
def test_rfft_matches_fwd_reference(tparams, S, F):
    """K4's windows, read in place from a strided slice as the pipeline
    passes it."""
    rng = np.random.default_rng(10 + S + F)
    ext = torch.from_numpy((rng.standard_normal((S, HIST + 1 + F * FRAME)) * SCALE)
                           .astype(np.float32))
    ext_a = ext[:, 1 + HIST - FRAME:]
    dft, band = tparams["dft_fwd_pad"], tparams["band_e_pad"]
    Y = rfft_padded(ext_a[:, : (F + 1) * FRAME].unfold(1, WIN, FRAME), dft)
    rY, rEx = fk.fwd_spectrum_bands_reference(ext_a, dft, band, F)
    assert_spectra_agree(Y, fk._band_energies(Y, band), rY, rEx)


@pytest.mark.parametrize("S,F", [(1, 1), (3, 1), (5, 7), (7, 17)])
def test_rfft_matches_win_reference(tparams, S, F):
    rng = np.random.default_rng(20 + S + F)
    wins = torch.from_numpy((rng.standard_normal((S, F, WIN)) * SCALE).astype(np.float32))
    dft, band = tparams["dft_fwd_pad"], tparams["band_e_pad"]
    Y = rfft_padded(wins, dft)
    rY, rEx = fk.win_spectrum_bands_reference(wins, dft, band)
    assert_spectra_agree(Y, fk._band_energies(Y, band), rY, rEx)


def test_fft_twiddles_table():
    """Rows k1 * 32 + l hold W480^(l k1), rows 480 + m hold W960^m, each the
    f32 rounding of the float64 value."""
    t = fk.fft_twiddles()
    assert t.shape == (480 + NFREQ, 2) and t.dtype == np.float32
    w480 = np.exp(-2j * np.pi * 7 * 11 / 480.0)
    np.testing.assert_array_equal(t[11 * 32 + 7], np.float32([w480.real, w480.imag]))
    w960 = np.exp(-2j * np.pi * 123 / 960.0)
    np.testing.assert_array_equal(t[480 + 123], np.float32([w960.real, w960.imag]))
    np.testing.assert_array_equal(t[480], np.float32([1.0, 0.0]))


def _brev5(v: int) -> int:
    return int(f"{v:05b}"[::-1], 2)


def kernel_factorisation(frames: np.ndarray, tw_table: np.ndarray) -> np.ndarray:
    """The kernel's transform in float64, lane by lane: frames [M, 960]
    (already windowed) → X [M, 481] complex."""
    tw_c = tw_table[:, 0].astype(np.float64) + 1j * tw_table[:, 1].astype(np.float64)
    lanes = np.arange(32)
    z = frames[:, 0::2] + 1j * frames[:, 1::2]  # [M, 480]
    a = [z[:, lanes + 32 * j] for j in range(15)]  # a[j][:, l] = z[l + 32 j]
    # 15-point DFT over j as prime factor 3 x 5.
    w5 = np.exp(-2j * np.pi * np.outer(np.arange(5), np.arange(5)) / 5)
    w3 = np.exp(-2j * np.pi * np.outer(np.arange(3), np.arange(3)) / 3)
    b = [[sum(w5[k2, n2] * a[(5 * n1 + 3 * n2) % 15] for n2 in range(5)) for k2 in range(5)]
         for n1 in range(3)]
    A = [None] * 15
    for k2 in range(5):
        for k1 in range(3):
            A[(10 * k1 + 6 * k2) % 15] = sum(w3[k1, n1] * b[n1][k2] for n1 in range(3))
    A = [A[q] * tw_c[q * 32 + lanes] for q in range(15)]  # W480^(l k1)
    # Five radix-2 decimation-in-frequency stages across the lanes.
    for h in (16, 8, 4, 2, 1):
        up = (lanes & h) != 0
        w = np.where(up, tw_c[480 + (lanes & (h - 1)) * (480 // h)], 1.0)
        A = [(np.where(up, -1.0, 1.0) * v + v[:, lanes ^ h]) * w for v in A]
    Z = np.zeros((frames.shape[0], 480), complex)
    for q in range(15):
        for lane in range(32):
            Z[:, q + 15 * _brev5(lane)] = A[q][:, lane]
    k = np.arange(NFREQ)
    za, zb = Z[:, k % 480], np.conj(Z[:, (480 - k) % 480])
    return 0.5 * (za + zb) - 0.5j * tw_c[480 + k] * (za - zb)


def test_kernel_factorisation_is_the_dft():
    rng = np.random.default_rng(30)
    frames = rng.standard_normal((6, WIN)) * window_over_960()
    got = kernel_factorisation(frames, fk.fft_twiddles())
    want = np.fft.rfft(frames, axis=-1)
    # the twiddles are f32: ~1e-7 of the spectrum's scale
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
