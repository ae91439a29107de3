"""The fused spectra kernels (the port of ``pallas_frontend.py``).

  fwd_spectrum_bands  — K4: the 50%-overlapped analysis windows read in place
                        from the HP signal, their windowed DFT and 22 band
                        energies;
  win_spectrum_bands  — K5: the same on windows already gathered (K3's output);
  inv_spectrum_ola    — K6: the inverse windowed DFT with the overlap-add and
                        the carried synthesis tail folded in.

Spectra keep the JAX package's padded layout, Y [.., 1024] with the re part of
frequency k at column k and the im part at 512 + k, zeros elsewhere, and the
tables are its ``make_params`` tables. K4 and K5 share the CUDA kernel of
``csrc/spectrum_fwd.cu``, a real FFT (one warp per window) with the window
taken from the table's column 0 and the band energies fused; K6 is
``csrc/spectrum_inv.cu``, a dense tile product. Each wrapper takes its plain
PyTorch version (``*_reference``: dense products) for tensors on the CPU and
launches its kernel for tensors on the card, or raises; it never falls back.
``<wrapper>.launches`` counts the kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import _build
from .constants import FRAME_SIZE as FRAME, FREQ_SIZE as NFREQ, NB_BANDS as NB
from .constants import WINDOW_SIZE as WIN
from .rnn_kernels import _on_card, _require

YPAD = 1024  # padded (re ‖ im) spectrum width: re 0..480, im 512..992
IM0 = 512


# ---------------------------------------------------------------------------
# Tables (numpy, as pallas_frontend builds them)
# ---------------------------------------------------------------------------

def pad_dft_fwd(dft_fwd: np.ndarray) -> np.ndarray:
    """[960, 962] (re‖im) → [960, 1024] with re at 0..480, im at 512..992."""
    t = np.zeros((WIN, YPAD), np.float32)
    t[:, :NFREQ] = dft_fwd[:, :NFREQ]
    t[:, IM0: IM0 + NFREQ] = dft_fwd[:, NFREQ:]
    return t


def pad_band_e(band_e: np.ndarray) -> np.ndarray:
    """[481, 22] → [512, 22] zero-padded (energy rows 481..511 are zero)."""
    t = np.zeros((IM0, band_e.shape[1]), np.float32)
    t[:NFREQ] = band_e
    return t


def pad_dft_inv(inv_re: np.ndarray, inv_im: np.ndarray) -> np.ndarray:
    """([481, 960], [481, 960]) → [1024, 960] matching the padded Y layout."""
    t = np.zeros((YPAD, WIN), np.float32)
    t[:NFREQ] = inv_re
    t[IM0: IM0 + NFREQ] = inv_im
    return t


def fft_twiddles() -> np.ndarray:
    """The FFT kernel's twiddles, [961, 2] f32 (re, im), computed in float64
    and cast as the DFT table is: rows k1 * 32 + l (k1 < 15, l < 32) hold
    W480^(l k1), rows 480 + m hold W960^m for m = 0..480, W_N = e^(-2 pi i / N)."""
    k1, lane = np.meshgrid(np.arange(15), np.arange(32), indexing="ij")
    w = np.concatenate([np.exp(-2j * np.pi * (lane * k1).ravel() / 480.0),
                        np.exp(-2j * np.pi * np.arange(NFREQ) / 960.0)])
    return np.stack([w.real, w.imag], axis=1).astype(np.float32)


_TWIDDLES = {}  # device -> fft_twiddles() on it


def _twiddles_on(dev: torch.device) -> torch.Tensor:
    if dev not in _TWIDDLES:
        _TWIDDLES[dev] = torch.from_numpy(fft_twiddles()).to(dev)
    return _TWIDDLES[dev]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _band_energies(Y: torch.Tensor, band_pad: torch.Tensor) -> torch.Tensor:
    re, im = Y[..., :IM0], Y[..., IM0:]
    return (re * re + im * im) @ band_pad


def fwd_spectrum_bands_reference(ext_a, dft_pad, band_pad, F: int):
    """Plain version of K4: ext_a [S, >= (F+1)*480] → (Y [S, F, 1024],
    Ex [S, F, 22]); window f is ext_a[:, f*480 : f*480 + 960]."""
    wins = ext_a[:, : (F + 1) * FRAME].unfold(1, WIN, FRAME)  # [S, F, 960]
    Y = wins @ dft_pad
    return Y, _band_energies(Y, band_pad)


def win_spectrum_bands_reference(wins, dft_pad, band_pad):
    """Plain version of K5: wins [S, F, 960] → (Y [S, F, 1024], Ex [S, F, 22])."""
    Y = wins @ dft_pad
    return Y, _band_energies(Y, band_pad)


def inv_spectrum_ola_reference(Y, inva, invb, syn_mem):
    """Plain version of K6: Y [S, F, 1024], syn_mem [S, 480] → (out
    [S, F*480], new_mem [S, 480]) with out[:, f] = Y[f] @ invA + (Y[f-1] @
    invB, or syn_mem for f = 0) and new_mem = Y[F-1] @ invB."""
    S, F, _ = Y.shape
    xt = Y @ torch.cat([inva, invb], dim=1)  # [S, F, 960]
    tails = torch.cat([syn_mem[:, None, :], xt[:, :-1, FRAME:]], dim=1)
    return (xt[..., :FRAME] + tails).reshape(S, F * FRAME), xt[:, -1, FRAME:].clone()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _spectrum_bands(x, ld_s: int, hop: int, S: int, F: int, dft_pad, band_pad, name: str):
    """Launch csrc/spectrum_fwd.cu on windows x + s*ld_s + f*hop (floats)."""
    _require(dft_pad, "dft_pad", torch.float32, (WIN, YPAD))
    _require(band_pad, "band_pad", torch.float32, (IM0, NB))
    dev = x.device
    Y = torch.empty((S, F, YPAD), dtype=torch.float32, device=dev)
    Ex = torch.empty((S, F, NB), dtype=torch.float32, device=dev)
    rc = _build.load().crispy_spectrum_bands(
        x.data_ptr(), ld_s, hop, S, F, dft_pad.data_ptr(), band_pad.data_ptr(),
        _twiddles_on(dev).data_ptr(), Y.data_ptr(), Ex.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, name)
    return Y, Ex


def fwd_spectrum_bands(ext_a, dft_pad, band_pad, F: int):
    """K4, the counterpart of ``pallas_frontend.fwd_spectrum_bands``: same
    inputs and outputs as ``fwd_spectrum_bands_reference``. It takes the
    whole [960, 1024] table where the TPU kernel takes its two 512-row
    halves. On the card ext_a may be a row-strided view (unit stride along a
    row): the kernel reads the windows in place.

    The kernel computes the DFT as an FFT and reads only column 0 of
    dft_pad, which for ``make_params``' windowed DFT table is the window
    over 960, f32(w[n] / 960); it assumes the rest of the table is that
    DFT. The plain version uses the whole table."""
    if not _on_card(ext_a, dft_pad, band_pad):
        return fwd_spectrum_bands_reference(ext_a, dft_pad, band_pad, F)
    S = ext_a.shape[0]
    if (ext_a.dim() != 2 or ext_a.dtype != torch.float32 or ext_a.stride(1) != 1
            or S == 0 or F <= 0 or ext_a.shape[1] < (F + 1) * FRAME):
        raise ValueError(f"fwd_spectrum_bands: want float32 [S>0, >=(F+1)*{FRAME}] with unit "
                         f"row stride and F > 0, got {ext_a.dtype} {tuple(ext_a.shape)} "
                         f"strides {ext_a.stride()} F={F}")
    out = _spectrum_bands(ext_a, ext_a.stride(0), FRAME, S, F, dft_pad, band_pad,
                          "fwd_spectrum_bands")
    fwd_spectrum_bands.launches += 1
    return out


fwd_spectrum_bands.launches = 0


def win_spectrum_bands(wins, dft_pad, band_pad):
    """K5, the counterpart of ``pallas_frontend.win_spectrum_bands``: same
    inputs and outputs as ``win_spectrum_bands_reference``. On the card wins
    must be contiguous and 16-byte aligned, and dft_pad is taken as
    ``fwd_spectrum_bands`` takes it (column 0 is the window over 960)."""
    if not _on_card(wins, dft_pad, band_pad):
        return win_spectrum_bands_reference(wins, dft_pad, band_pad)
    S, F = wins.shape[:2]
    if S == 0 or F == 0:
        raise ValueError(f"win_spectrum_bands: need S, F > 0, got {tuple(wins.shape)}")
    _require(wins, "wins", torch.float32, (S, F, WIN))
    if wins.data_ptr() % 16:
        raise ValueError("win_spectrum_bands: wins must be 16-byte aligned")
    out = _spectrum_bands(wins, F * WIN, WIN, S, F, dft_pad, band_pad, "win_spectrum_bands")
    win_spectrum_bands.launches += 1
    return out


win_spectrum_bands.launches = 0


def inv_spectrum_ola(Y, inva, invb, syn_mem):
    """K6, the counterpart of ``pallas_frontend.inv_spectrum_ola``: same
    inputs and outputs as ``inv_spectrum_ola_reference``."""
    if not _on_card(Y, inva, invb, syn_mem):
        return inv_spectrum_ola_reference(Y, inva, invb, syn_mem)
    S, F = Y.shape[:2]
    if S == 0 or F == 0:
        raise ValueError(f"inv_spectrum_ola: need S, F > 0, got {tuple(Y.shape)}")
    _require(Y, "Y", torch.float32, (S, F, YPAD))
    _require(inva, "inva", torch.float32, (YPAD, FRAME))
    _require(invb, "invb", torch.float32, (YPAD, FRAME))
    _require(syn_mem, "syn_mem", torch.float32, (S, FRAME))
    dev = Y.device
    out = torch.empty((S, F * FRAME), dtype=torch.float32, device=dev)
    new_mem = torch.empty((S, FRAME), dtype=torch.float32, device=dev)
    rc = _build.load().crispy_inv_spectrum_ola(
        Y.data_ptr(), inva.data_ptr(), invb.data_ptr(), syn_mem.data_ptr(), out.data_ptr(),
        new_mem.data_ptr(), S, F, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "inv_spectrum_ola")
    inv_spectrum_ola.launches += 1
    return out, new_mem


inv_spectrum_ola.launches = 0
