"""The identities the FFT-structured spectra kernels rest on, shown on the CPU.

K4/K5 (csrc/spectrum_fwd.cu) read only column 0 of ``dft_fwd_pad``, take it
as the window over 960, multiply it into the samples and compute the DFT as
an FFT. So: column 0 of the port's table and of the JAX package's is exactly
f32(w / 960); ``torch.fft.rfft`` of the windowed frames, in the padded
layout, agrees with the plain versions (dense products against the whole
table); and the kernel's factorisation (480 complex points as 15 x 32, the
15-point DFT as 3 x 5, the split into real-input bins), run here in float64
with the port's twiddle table as the kernel indexes it, gives the DFT.

K6 (csrc/spectrum_inv.cu) reads only row 0 of ``dft_inv_a``/``dft_inv_b``
as the window and computes the inverse as an inverse real FFT. So: that row
is the window, the rows the kernel skips are zero, ``torch.fft.irfft`` with
the window and the overlap-add agrees with the plain version, and the
kernel's factorisation (the merge into 480 complex points, the same forward
FFT between two conjugations) gives the inverse DFT.
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


def _twiddles_c(tw_table: np.ndarray) -> np.ndarray:
    return tw_table[:, 0].astype(np.float64) + 1j * tw_table[:, 1].astype(np.float64)


def exact_twiddles() -> np.ndarray:
    """fft_twiddles()'s layout in float64, not cast."""
    k1, lane = np.meshgrid(np.arange(15), np.arange(32), indexing="ij")
    w = np.concatenate([np.exp(-2j * np.pi * (lane * k1).ravel() / 480.0),
                        np.exp(-2j * np.pi * np.arange(NFREQ) / 960.0)])
    return np.stack([w.real, w.imag], axis=1)


def fft480_lanes(z: np.ndarray, tw_table: np.ndarray) -> np.ndarray:
    """The kernels' forward 480-point complex FFT in float64, lane by lane
    (csrc/fft480.cuh): z [M, 480] → Z [M, 480] in natural order."""
    tw_c = _twiddles_c(tw_table)
    lanes = np.arange(32)
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
    Z = np.zeros((z.shape[0], 480), complex)
    for q in range(15):
        for lane in range(32):
            Z[:, q + 15 * _brev5(lane)] = A[q][:, lane]
    return Z


def kernel_factorisation(frames: np.ndarray, tw_table: np.ndarray) -> np.ndarray:
    """K4/K5's transform in float64: frames [M, 960] (already windowed) →
    X [M, 481] complex."""
    tw_c = _twiddles_c(tw_table)
    Z = fft480_lanes(frames[:, 0::2] + 1j * frames[:, 1::2], tw_table)
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


# ---------------------------------------------------------------------------
# K6 (csrc/spectrum_inv.cu): an inverse real FFT with the window and the
# overlap-add. Row 0 of dft_inv_a / dft_inv_b is the window (c_0 = 1,
# cos 0 = 1); the rows of Im X_0 and Im X_480 and the pad rows are zero (or
# ~1e-13), so the dense product is 960 irfft(X) w with the overlap-add.
# ---------------------------------------------------------------------------

def inv_tables(source: str):
    if source == "jax":
        if jp is None:
            pytest.skip("the JAX reference is not installed")
        p = jp.make_params(deterministic_test_model())
        return np.asarray(p["dft_inv_a"]), np.asarray(p["dft_inv_b"])
    p = tp.make_params(tw.deterministic_test_model(), "cpu")
    return p["dft_inv_a"].numpy(), p["dft_inv_b"].numpy()


def irfft_ola(Y, inva, invb, syn_mem):
    """K6's function as the kernel computes it, with torch.fft.irfft for the
    transform: reads Y's columns 0..480 (re) and 513..991 (im) only and the
    window from row 0 of the tables."""
    S, F, _ = Y.shape
    X = torch.complex(Y[..., :NFREQ], Y[..., fk.IM0: fk.IM0 + NFREQ])  # Im X_0, X_480 ignored
    x = torch.fft.irfft(X, n=WIN, dim=-1) * WIN * torch.cat([inva[0], invb[0]])
    tails = torch.cat([syn_mem[:, None, :], x[:, :-1, FRAME:]], dim=1)
    return (x[..., :FRAME] + tails).reshape(S, F * FRAME), x[:, -1, FRAME:]


def inverse_factorisation(Y: np.ndarray, tw_table: np.ndarray) -> np.ndarray:
    """K6's transform in float64, as the kernel factors it: Y [M, 1024] →
    x [M, 960] = 960 irfft(X), before the window. The 481 bins merge into
    480 complex values Z'[k] = (X[k] + X*[480-k]) + i W960^-k (X[k] -
    X*[480-k]), whose unnormalised inverse 480-point DFT is z[m] = x[2m] +
    i x[2m+1]; the inverse is taken as conj(FFT(conj Z'))."""
    tw_c = _twiddles_c(tw_table)
    k = np.arange(480)
    re = Y[:, :NFREQ].astype(np.float64)
    im = Y[:, fk.IM0: fk.IM0 + NFREQ].astype(np.float64)
    im[:, 0] = im[:, 480] = 0.0  # the table ignores Im X_0 and Im X_480
    X = re[:, k] + 1j * im[:, k]
    Xc = re[:, 480 - k] - 1j * im[:, 480 - k]  # X*[480 - k]
    Zp = (X + Xc) + 1j * np.conj(tw_c[480 + k]) * (X - Xc)
    z = np.conj(fft480_lanes(np.conj(Zp), tw_table))
    x = np.empty((Y.shape[0], WIN))
    x[:, 0::2], x[:, 1::2] = z.real, z.imag
    return x


def random_spectra(S, F, seed, pad=0.0):
    rng = np.random.default_rng(seed)
    Y = np.full((S, F, fk.YPAD), pad, np.float32)
    Y[..., :NFREQ] = rng.standard_normal((S, F, NFREQ)) * SCALE
    Y[..., fk.IM0: fk.IM0 + NFREQ] = rng.standard_normal((S, F, NFREQ)) * SCALE
    return Y, (rng.standard_normal((S, FRAME)) * SCALE).astype(np.float32)


@pytest.mark.parametrize("source", ["port", "jax"])
def test_dft_inv_table_row0_is_window(source):
    inva, invb = inv_tables(source)
    w = tc.full_window()
    np.testing.assert_array_equal(inva[0], w[:FRAME])
    np.testing.assert_array_equal(invb[0], w[FRAME:])


@pytest.mark.parametrize("source", ["port", "jax"])
def test_dft_inv_table_rows_kernel_skips(source):
    """Im X_0 (row 512) and the pad rows 481..511, 993..1023 are exactly
    zero; Im X_480 (row 992) is sin(pi n) in float64, below 1e-12."""
    inv = np.concatenate(inv_tables(source), axis=1)
    for rows in (slice(NFREQ, fk.IM0), slice(fk.IM0, fk.IM0 + 1), slice(fk.IM0 + NFREQ, None)):
        assert not inv[rows].any()
    assert np.abs(inv[fk.IM0 + 480]).max() < 1e-12


@pytest.mark.parametrize("S,F", [(1, 1), (3, 5), (3, 16), (3, 17), (5, 33)])
def test_irfft_matches_inv_reference(tparams, S, F):
    Y, mem = random_spectra(S, F, seed=40 + S + F)
    Y, mem = torch.from_numpy(Y), torch.from_numpy(mem)
    inva, invb = tparams["dft_inv_a"], tparams["dft_inv_b"]
    out, new_mem = irfft_ola(Y, inva, invb, mem)
    rout, rmem = fk.inv_spectrum_ola_reference(Y, inva, invb, mem)
    assert out.shape == rout.shape and new_mem.shape == rmem.shape
    assert float((out - rout).abs().max()) <= SPEC_TOL * float(rout.abs().max())
    assert float((new_mem - rmem).abs().max()) <= SPEC_TOL * float(rmem.abs().max())


@pytest.mark.parametrize("twiddles", ["float64", "float32"])
def test_inverse_kernel_factorisation_is_the_irfft(twiddles):
    """Exact in float64 with float64 twiddles; ~1e-7 with the f32 table the
    kernel reads."""
    Y, _ = random_spectra(1, 6, seed=50)
    Y = Y[0]
    table = exact_twiddles() if twiddles == "float64" else fk.fft_twiddles()
    np.testing.assert_array_equal(exact_twiddles().astype(np.float32), fk.fft_twiddles())
    got = inverse_factorisation(Y, table)
    X = Y[:, :NFREQ].astype(np.float64) + 1j * Y[:, fk.IM0: fk.IM0 + NFREQ]
    want = WIN * np.fft.irfft(X, n=WIN, axis=-1)
    tol = 1e-12 if twiddles == "float64" else 1e-6
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_inv_pad_columns_do_not_matter(tparams):
    Y, mem = random_spectra(3, 17, seed=60)
    Yg, _ = random_spectra(3, 17, seed=60, pad=1e30)
    inva, invb = tparams["dft_inv_a"], tparams["dft_inv_b"]
    a = irfft_ola(torch.from_numpy(Y), inva, invb, torch.from_numpy(mem))
    b = irfft_ola(torch.from_numpy(Yg), inva, invb, torch.from_numpy(mem))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
