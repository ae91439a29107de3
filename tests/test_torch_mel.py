"""The port's Whisper log-mel frontend (crispy_tpu_torch.dsp.mel) held against
``crispy_tpu.dsp.mel`` on the CPU, on the same numpy audio.

Tolerance: 1e-4 absolute on the normalized log-mel ((log10 + 4) / 4, values
in about [-1, 2]) for noise, 2e-4 for pure tones, whose bins far down the
window's sidelobes sit near the f32 FFT's rounding floor, where pocketfft
in torch and the JAX package's FFT round differently. The filterbank is a
numpy copy and must be bit-equal.
"""

import numpy as np
import pytest
import torch

from crispy_tpu_torch.dsp import mel as tmel
from torch_audio import one_torch_thread, speechlike  # noqa: F401 (fixture)

try:  # the reference; the card's machine has no JAX and runs only the gpu tests
    import jax.numpy as jnp

    from crispy_tpu.dsp import mel as jmel
except ImportError:
    jmel = None
needs_jax = pytest.mark.skipif(jmel is None, reason="the JAX reference is not installed")


def noise(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)


@needs_jax
@pytest.mark.parametrize("n_mels", [80, 128])
def test_filterbank_bit_equal(n_mels):
    np.testing.assert_array_equal(tmel.mel_filterbank(n_mels), jmel.mel_filterbank(n_mels))


@needs_jax
@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("pad_to_chunk", [False, True])
@pytest.mark.parametrize("batched", [False, True])
def test_log_mel_matches_jax(n_mels, pad_to_chunk, batched):
    x = noise((3, 24_000) if batched else (24_000,), seed=n_mels + batched)
    want = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(x), n_mels, pad_to_chunk))
    got = tmel.log_mel_spectrogram(torch.from_numpy(x), n_mels, pad_to_chunk).numpy()
    frames = 3000 if pad_to_chunk else 24_000 // 160
    assert got.shape == want.shape == ((3,) if batched else ()) + (n_mels, frames)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@needs_jax
def test_log_mel_tones_and_long_input_match_jax():
    """Speech-like tones, per-item clamp on items of different loudness, and
    input longer than a chunk (truncated to 30 s when padding to a chunk)."""
    x = np.stack([speechlike(500_000, seed=1, sr=16000),
                  0.01 * speechlike(500_000, seed=2, f0=190.0, sr=16000)])
    for pad in (False, True):
        want = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(x), 80, pad))
        got = tmel.log_mel_spectrogram(torch.from_numpy(x), 80, pad).numpy()
        assert got.shape == want.shape == (2, 80, 3000 if pad else 3125)
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


@pytest.mark.gpu
def test_log_mel_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.from_numpy(np.stack([speechlike(480_000, seed=3, sr=16000), noise(480_000)]))
    cpu = tmel.log_mel_spectrogram(x, 80, True)
    card = tmel.log_mel_spectrogram(x.cuda(), 80, True)
    assert card.device.type == "cuda"
    assert float((card.cpu() - cpu).abs().max()) <= 1e-4
