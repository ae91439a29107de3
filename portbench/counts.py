"""Operations and bytes of the work the benchmark's cells do, counted from
shapes: the least a kernel, a block step or a Whisper batch needs, whatever
the program executes. The roofline shares and the ``mfu`` metrics divide
these by measured time.

A kernel's bound is the larger of its bytes over the card's bandwidth and
its operations over the card's float32 rate (``peaks.json``); every input
byte is counted read once and every output byte written once. The spectra's
transforms count as FFTs (2.5 n log2 n operations a real transform of n).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Tuple

from .reference.rnnoise import BAND_E

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())

FRAME, WIN, NFREQ, NB = 480, 960, 481, 22
HIST = 1248  # the HP samples a block step carries ahead of its block
NFEAT = 42
STATE = 24 + 48 + 96 + NB  # the network's carried state, 190 floats a stream
# nonzero entries of RNNoise's band-energy matrix [22, 481] (its triangles
# overlap over bins 0..399; bins 400..480 belong to no band)
BAND_NNZ = int((BAND_E != 0).sum())  # 779


def rfft_flops(n: int) -> float:
    """A real FFT (or its inverse) of n points, by the usual nominal count."""
    return 2.5 * n * math.log2(n)


def bound_s(nbytes: float, flops: float, peaks: Dict = PEAKS) -> Tuple[float, str]:
    """The least time on the card and what bounds it."""
    tb = nbytes / peaks["bytes_per_s"]
    tf = flops / peaks["f32_flops_per_s"]
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------------------
# RNNoise
# ---------------------------------------------------------------------------

def rnnoise_macs(layers: Dict[str, Tuple[int, int]]) -> int:
    """Multiply-adds of one network step: layers maps each layer to (in,
    out) with a GRU's out its 3 gates' width; a GRU adds its state product
    [n, 3n]."""
    macs = 0
    for name, (din, dout) in layers.items():
        macs += din * dout
        if name.endswith("_gru"):
            macs += (dout // 3) * dout
    return macs


def k1_counts(S: int, F: int, macs: int, weight_floats: int) -> Tuple[float, float]:
    """K1, the network over F frames of S streams: (bytes, operations).
    Reads the features, the silence flags, the state and the float32
    weights; writes the raw and smoothed gains, the vad and the state."""
    nbytes = (S * F * NFEAT * 4 + S * F + 2 * S * STATE * 4 + weight_floats * 4
              + S * F * (2 * NB + 1) * 4)
    return float(nbytes), 2.0 * macs * S * F


def k2_counts(S: int, F: int) -> Tuple[float, float]:
    """K2, remove_doubling's continuation: the packed candidate rows
    [S, F, 74] and the carried period and gain in; the pitch [S, F] and the
    new period and gain out; ~12 operations per candidate and frame."""
    return float(S * F * 74 * 4 + 2 * S * 4 + (S * F + 2 * S) * 4), 14.0 * 12 * S * F


def k3_counts(S: int, F: int) -> Tuple[float, float]:
    """K3, the pitch-window gather: the HP signal with its carried history
    and the starts in, the [S, F, 960] windows out; no arithmetic."""
    ext = S * (HIST + 1 + F * FRAME)
    return float(ext * 4 + S * F * 4 + S * F * WIN * 4), 0.0


def k45_counts(S: int, F: int, windows_in_place: bool) -> Tuple[float, float]:
    """K4 (analysis windows read in place from the HP signal) or K5 (the
    gathered pitch windows): the window, its FFT, |X|^2 and the band sums;
    the padded spectrum [.., 1024] and the band energies written. The
    tables are read once."""
    flops = S * F * (WIN + rfft_flops(WIN) + 3.0 * NFREQ + 2.0 * BAND_NNZ)
    tables = (WIN * 1024 + 512 * NB) * 4
    inp = S * (F + 1) * FRAME * 4 if windows_in_place else S * F * WIN * 4
    return float(inp + tables + S * F * (1024 + NB) * 4), flops


def k6_counts(S: int, F: int) -> Tuple[float, float]:
    """K6, the inverse FFT with the window and the overlap-add: the padded
    spectra, the two window tables and the carried tail in; the frames and
    the new tail out."""
    nbytes = (S * F * 1024 + 2 * 1024 * FRAME + 2 * S * FRAME + S * F * FRAME) * 4
    return float(nbytes), S * F * (rfft_flops(WIN) + WIN + FRAME)


def rnnoise_kernel_counts(S: int, F: int, macs: int, weight_floats: int) -> Dict[str, Tuple[float, float]]:
    """(bytes, operations) of each kernel's launch in one block step of F
    frames of S streams, by the kernel's name in a device trace."""
    return {
        "nn_scan": k1_counts(S, F, macs, weight_floats),
        "rd_scan": k2_counts(S, F),
        "pitch_gather": k3_counts(S, F),
        "spectrum_bands.fwd": k45_counts(S, F, True),
        "spectrum_bands.win": k45_counts(S, F, False),
        "inv_ola": k6_counts(S, F),
    }


def rnnoise_frame_flops(macs: int) -> float:
    """The operations the RNNoise algorithm needs for one frame of one
    stream, as the C code does them: the HP biquad (8 a sample); two
    windowed analysis FFTs with |X|^2 and band sums; the pitch decimation,
    the coarse search (147 lags of 240) and the fine search (5 lags around
    each of 2 candidates, 480 each) with their window energies;
    remove_doubling's 33 correlations of 480 with its energies; the
    features (two 22-point DCTs, the 8x8 cepstral distances); the network;
    the pitch filter (band correlation, the filtered energies, three
    interpolations of 22 bands to 481 bins, the complex updates); the
    synthesis FFT, window and overlap-add."""
    analysis = WIN + rfft_flops(WIN) + 3 * NFREQ + 2 * BAND_NNZ
    pitch = 3 * 864 + 2 * 147 * 240 + 2 * 387 + 2 * 10 * 480 + 2 * 864
    doubling = 2 * 33 * 480 + 2 * 864
    features = 2 * 2 * NB * NB + 8 * 8 * NB * 3 + 4 * NB
    filt = 2 * 2 * BAND_NNZ + 3 * 4 * NFREQ + 8 * NFREQ
    synthesis = rfft_flops(WIN) + WIN + FRAME
    return 8 * FRAME + 2 * analysis + pitch + doubling + features + 2 * macs + filt + synthesis


# ---------------------------------------------------------------------------
# Whisper
# ---------------------------------------------------------------------------

def whisper_encoder_flops(n_mels: int, d: int, layers: int, T: int = 1500) -> float:
    """One 30 s chunk through the encoder: the two convolutions over 3000
    and 1500 frames, then per block q, k, v and out (8 T d^2), the two
    attention products (4 T^2 d) and the MLP (16 T d^2)."""
    conv = 2.0 * (2 * T) * n_mels * 3 * d + 2.0 * T * d * 3 * d
    return conv + layers * (24.0 * T * d * d + 4.0 * T * T * d)


def whisper_decode_flops(d: int, layers: int, vocab: int, prompt: int, steps: int,
                         T_audio: int = 1500) -> Dict[str, float]:
    """One chunk's decode: the cross keys and values (4 T d^2 a layer), the
    prefill of ``prompt`` tokens with logits at every prompt position, and
    ``steps`` cached steps, step i attending over prompt + i + 1 keys, each
    with its logits."""
    def token(keys: int) -> float:  # one token through the decoder, with its logits
        per_layer = 28.0 * d * d + 4.0 * keys * d + 4.0 * T_audio * d
        return layers * per_layer + 2.0 * d * vocab

    cross = layers * 4.0 * T_audio * d * d
    prefill = sum(token(k + 1) for k in range(prompt))
    cached = sum(token(prompt + i + 1) for i in range(steps))
    return {"cross_kv": cross, "prefill": prefill, "steps": cached}


def whisper_chunk_flops(n_mels: int, d: int, enc_layers: int, dec_layers: int, vocab: int,
                        prompt: int, steps: int) -> float:
    """A chunk's whole work on the timed path: encoder, cross K/V, prefill
    and the cached steps with logits."""
    dec = whisper_decode_flops(d, dec_layers, vocab, prompt, steps)
    return whisper_encoder_flops(n_mels, d, enc_layers) + sum(dec.values())
