"""The yardstick's arithmetic against shapes worked by hand."""

import math

import pytest

from portbench import counts

PEAK_F, PEAK_B = 67e12, 3.35e12
RNNOISE_LAYERS = {"input_dense": (42, 24), "vad_gru": (24, 72), "vad_output": (24, 1),
                  "noise_gru": (90, 144), "denoise_gru": (114, 288), "denoise_output": (96, 22)}


def test_peaks_table():
    assert counts.PEAKS["f32_flops_per_s"] == PEAK_F
    assert counts.PEAKS["bytes_per_s"] == PEAK_B


def test_bound_takes_the_larger_side():
    assert counts.bound_s(3.35e9, 1.0) == (pytest.approx(1e-3), "bytes")
    assert counts.bound_s(1.0, 67e9) == (pytest.approx(1e-3), "operations")


def test_rfft_flops():
    assert counts.rfft_flops(1024) == 2.5 * 1024 * 10


def test_rnnoise_network_macs():
    # 42*24 + (24*72 + 24*72) + 24 + (90*144 + 48*144) + (114*288 + 96*288) + 96*22
    assert counts.rnnoise_macs(RNNOISE_LAYERS) == 86952


def test_band_matrix_nonzeros():
    # bands 0..20 span 4 * (edge[i+1] - edge[i]) bins, 400 bins in all, each
    # bin in two triangles except bin 0, which only the first band covers
    assert counts.BAND_NNZ == 2 * 400 - 21


def test_kernel_bounds_at_the_cell_shape():
    """S=128 streams x F=500 frames a block, as chip_smoke.py counts them."""
    c = counts.rnnoise_kernel_counts(128, 500, 86952, 87503)
    b = {k: counts.bound_s(*v) for k, v in c.items()}
    assert c["nn_scan"][1] == 2 * 86952 * 128 * 500
    assert b["nn_scan"][1] == "operations" and b["nn_scan"][0] * 1e3 == pytest.approx(0.1661, abs=1e-4)
    assert b["rd_scan"][1] == "bytes" and b["rd_scan"][0] * 1e3 == pytest.approx(0.00573, abs=1e-5)
    ext = 128 * (1248 + 1 + 500 * 480)
    assert c["pitch_gather"][0] == (ext + 128 * 500 + 128 * 500 * 960) * 4
    assert b["pitch_gather"][0] * 1e3 == pytest.approx(0.1103, abs=1e-4)
    assert b["spectrum_bands.fwd"][0] * 1e3 == pytest.approx(0.1179, abs=1e-4)
    assert b["spectrum_bands.win"][0] * 1e3 == pytest.approx(0.1545, abs=1e-4)
    assert b["inv_ola"][0] * 1e3 == pytest.approx(0.1163, abs=1e-4)


def test_rnnoise_frame_flops_are_mostly_the_network_and_the_searches():
    f = counts.rnnoise_frame_flops(86952)
    assert 3.5e5 < f < 4.5e5
    assert 2 * 86952 + 2 * 147 * 240 < f


def test_turbo_encoder_per_chunk():
    """whisper-large-v3-turbo: d 1280, 32 layers, 128 mels, 1500 positions.
    Convs 2*3000*128*3*1280 + 2*1500*1280*3*1280; a layer 24*T*d^2 + 4*T^2*d."""
    conv = 2 * 3000 * 128 * 3 * 1280 + 2 * 1500 * 1280 * 3 * 1280
    layer = 24 * 1500 * 1280 ** 2 + 4 * 1500 ** 2 * 1280
    got = counts.whisper_encoder_flops(128, 1280, 32)
    assert got == conv + 32 * layer
    assert got / 1e12 == pytest.approx(2.274, abs=1e-3)


def test_turbo_decode_per_chunk():
    d = counts.whisper_decode_flops(1280, 4, 51866, 4, 223)
    assert d["cross_kv"] == 4 * 4 * 1500 * 1280 ** 2
    # a token: 4 layers of 28 d^2 + attention over its keys and the 1500
    # audio positions, and the logits 2 d V
    first = 4 * (28 * 1280 ** 2 + 4 * 1 * 1280 + 4 * 1500 * 1280) + 2 * 1280 * 51866
    assert d["prefill"] == pytest.approx(4 * first + 4 * 4 * (0 + 1 + 2 + 3) * 1280)
    assert d["steps"] / 223 == pytest.approx(3.44e8, rel=0.02)
    total = counts.whisper_chunk_flops(128, 1280, 32, 4, 51866, 4, 223)
    assert total == pytest.approx(counts.whisper_encoder_flops(128, 1280, 32) + sum(d.values()))
    assert math.isclose(total / 1e12, 2.39, abs_tol=0.01)
