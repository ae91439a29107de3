"""The port's one-upload diarization frontend (crispy_tpu_torch.engine.
diar_device) against the JAX package's on the same recording, on the CPU:
padding, int16 quantization, energy-VAD margins and per-chunk log-mel
statistics. The ``gpu`` tests hold the card against the CPU path.
"""

import numpy as np
import pytest
import torch

from crispy_tpu_torch.engine import diar_device as tdd
from crispy_tpu_torch.engine import diarization as td
from test_torch_diarization import make_audio
from torch_audio import one_torch_thread  # noqa: F401 (autouse fixture)

try:  # the reference; the card's machine has no JAX and runs only the gpu tests
    import jax

    from crispy_tpu.engine import diar_device as jdd
    from crispy_tpu.engine import diarization as jd
except ImportError:
    jdd = None
needs_jax = pytest.mark.skipif(jdd is None, reason="the JAX reference is not installed")

SR = 16000


@pytest.fixture(scope="module")
def audio():
    return make_audio()


@pytest.fixture(scope="module")
def ranges(audio):
    chunks = td.chunk_segments(td.segment_speech(audio, 1.0))
    return [(c.offset, c.offset + len(c.samples)) for c in chunks]


def test_pad_length():
    for n in (1, SR, 123 * SR, 3541 * SR, 3600 * SR, 57_600_000):
        p = tdd.pad_length(n)
        assert p % (60 * SR) == 0 and p % tdd.WINDOW_SAMPLES == 0
        assert p >= n + tdd.WINDOW_SAMPLES
        if jdd is not None:
            assert p == jdd.pad_length(n)
    assert tdd.pad_length(57_600_000) == 58_560_000  # an hour: 366 windows


@pytest.mark.parametrize("n", [0, 1000, 160_000, 160_001])
def test_quantize_i16(n):
    rng = np.random.default_rng(n)
    x = rng.uniform(-1.2, 1.2, n).astype(np.float32)
    x[: min(n, 6)] = [0.5 / 32768, 1.5 / 32768, -0.5 / 32768, 1.0, -1.0, 2.5 / 32768][: min(n, 6)]
    pad_to = tdd.pad_length(n)
    q = tdd.quantize_i16(torch.from_numpy(x), pad_to).numpy()
    assert q.dtype == np.int16 and q.shape == (pad_to,) and not q[n:].any()
    assert q[: min(n, 6)].tolist() == [0, 2, 0, 32767, -32768, 2][: min(n, 6)]  # half to even
    if jdd is not None:
        np.testing.assert_array_equal(q, jdd.quantize_i16(x, pad_to))


@needs_jax
def test_segmentation_margins_match_jax(audio):
    pad_to = tdd.pad_length(audio.shape[0])
    q = tdd.quantize_i16(torch.from_numpy(audio), pad_to)
    got = tdd.segmentation_margins(q, pad_to)
    want = jdd.segmentation_margins(jax.device_put(q.numpy()), pad_to)
    assert got.shape == want.shape == (pad_to // tdd.WINDOW_SAMPLES, td.N_SEG_FRAMES)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # against the host VAD on the same windows (the device batch adds only
    # silent bucket windows)
    host_pad = -(-audio.shape[0] // tdd.WINDOW_SAMPLES) * tdd.WINDOW_SAMPLES + tdd.WINDOW_SAMPLES
    padded = np.zeros(host_pad, np.float32)
    padded[: audio.shape[0]] = audio
    logits = td.energy_vad_logits(padded.reshape(-1, tdd.WINDOW_SAMPLES))
    np.testing.assert_allclose(got[: logits.shape[0]], logits[..., 1], atol=2e-4)
    assert np.all(got[logits.shape[0]:] < 0)


def chunk_stats_f64(q, pad_to, ranges):
    """The statistics' formula in float64 NumPy: the reference both
    packages' f32 results are measured against."""
    from crispy_tpu_torch.dsp.mel import mel_filterbank

    x = np.pad(q.astype(np.float64) / 32768.0, 200, mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(x, 400)[::160][: pad_to // 160]
    mag = np.abs(np.fft.rfft(frames * np.hanning(401)[:-1], axis=-1)) ** 2
    lg = np.log10(np.maximum(mag @ mel_filterbank(80).T.astype(np.float64), 1e-10))
    ids = tdd.frame_chunk_ids(pad_to, ranges)
    out = []
    for i in range(len(ranges)):
        v = lg[ids == i]
        v = (np.maximum(v, v.max() - 8.0) + 4.0) / 4.0
        out.append(np.concatenate([v.mean(0), v.std(0)]))
    out = np.stack(out)
    return out - out.mean(1, keepdims=True)


def test_chunk_stats_match_f64_formula_and_jax(audio, ranges):
    """The port's statistics within 1e-5 of the formula in float64. The JAX
    package takes the variance as E[v²] − E[v]² in f32: on a bin that is
    constant over its chunk (clamped at the chunk's max − 8) that leaves
    ~1e-7 of rounding, ~3e-4 after the square root, so it is held to the
    port at 1e-4 wherever it is itself within 1e-5 of the formula, and its
    other elements must be such std entries."""
    pad_to = tdd.pad_length(audio.shape[0])
    q = tdd.quantize_i16(torch.from_numpy(audio), pad_to)
    got = tdd.chunk_stats(q, pad_to, ranges)
    ref = chunk_stats_f64(q.numpy(), pad_to, ranges)
    assert got.shape == ref.shape == (len(ranges), 160)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    if jdd is None:
        return
    want = jdd.chunk_stats(jax.device_put(q.numpy()), pad_to, ranges)
    jax_ok = np.abs(want - ref) <= 1e-5
    np.testing.assert_allclose(got[jax_ok], want[jax_ok], rtol=0, atol=1e-4)
    # where the JAX package's rounding shows beyond 1e-4, it is a std entry
    rows, cols = np.nonzero(np.abs(want - ref) > 1e-4)
    assert (cols >= 80).all()
    assert np.abs(want - got).max() < 1e-3
    # against the per-chunk stand-in embedding: ~1% of frames differ
    host = jd.melstats_embedding([audio[a:b] for a, b in ranges])
    cos = np.sum(got * host, 1) / np.linalg.norm(got, axis=1) / np.linalg.norm(host, axis=1)
    assert cos.min() > 0.995


def test_frame_chunk_ids():
    ids = tdd.frame_chunk_ids(60 * SR, [(0, 1000), (1000, 2000), (2050, 2400)])
    assert ids[:6].tolist() == [0, 0, 0, 0, 0, 0] and ids[6:12].tolist() == [1] * 6
    assert ids[12:15].tolist() == [3, 2, 2] and (ids[15:] == 3).all()


@pytest.mark.gpu
def test_card_matches_cpu(audio, ranges):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pad_to = tdd.pad_length(audio.shape[0])
    q = tdd.quantize_i16(torch.from_numpy(audio), pad_to)
    qd = tdd.quantize_i16(torch.from_numpy(audio).cuda(), pad_to)
    assert torch.equal(qd.cpu(), q)
    np.testing.assert_allclose(tdd.segmentation_margins(qd, pad_to),
                               tdd.segmentation_margins(q, pad_to), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tdd.chunk_stats(qd, pad_to, ranges),
                               tdd.chunk_stats(q, pad_to, ranges), rtol=0, atol=1e-4)
