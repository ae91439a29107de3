"""The port's copy of the NumPy oracle (crispy_tpu_torch.dsp.rnnoise.oracle)
held bit-equal to the JAX package's on the CPU, and the card's denoised
output held against the copy.

The card's machine has no JAX package, so the copy is what the card is held
against there (the ``gpu`` tests, and ``chip_smoke.py`` phases 3 and 4).
"""

import numpy as np
import pytest
import torch

from crispy_tpu_torch.dsp.rnnoise import oracle as toracle
from crispy_tpu_torch.dsp.rnnoise import weights as tw

from torch_audio import speechlike

try:  # the reference; the card's machine has no JAX package
    from crispy_tpu.dsp.rnnoise import oracle as joracle
    from crispy_tpu.dsp.rnnoise import weights as jw
except ImportError:
    joracle = None
needs_jax = pytest.mark.skipif(joracle is None, reason="the JAX reference is not installed")

FRAME = 480
ORACLE_ATOL = 1.5e-4  # the JAX package's own oracle tolerance


@needs_jax
@pytest.mark.parametrize("seed,f0,frames", [(1, 110.0, 40), (2, 185.0, 33), (3, 97.0, 25)])
def test_copy_denoise_stream_bit_equal(seed, f0, frames):
    """The copy's denoise_stream gives the JAX package's bits, on the
    deterministic test model and on the builtin weights."""
    audio = speechlike(frames * FRAME + 77, seed=seed, f0=f0)
    for jmodel, tmodel in ((jw.deterministic_test_model(), tw.deterministic_test_model()),
                           (jw.builtin_model(), tw.builtin_model())):
        want = joracle.denoise_stream(audio, jmodel)
        got = toracle.denoise_stream(audio, tmodel)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@needs_jax
def test_copy_frame_state_bit_equal():
    """Frame by frame: output, VAD and the GRU state of process_frame."""
    audio = speechlike(12 * FRAME, seed=4, f0=130.0) * 32768.0
    js = joracle.DenoiseState(model=jw.deterministic_test_model())
    ts = toracle.DenoiseState(model=tw.deterministic_test_model())
    for f in range(12):
        x = audio[f * FRAME: (f + 1) * FRAME]
        (jo, jv), (to, tv) = js.process_frame(x), ts.process_frame(x)
        np.testing.assert_array_equal(to, jo)
        assert tv == jv
    for k in ("vad", "noise", "denoise"):
        np.testing.assert_array_equal(getattr(ts.rnn, k), getattr(js.rnn, k))


@pytest.mark.gpu
@pytest.mark.parametrize("spectra", ["off", "on"])
def test_card_denoise_array_matches_oracle_copy(spectra, monkeypatch):
    """denoise_array on the card within the oracle tolerance of the copy, on
    both spectra paths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from crispy_tpu_torch.engine import denoiser

    monkeypatch.setenv("CRISPY_FUSED_SPECTRA", spectra)
    model = tw.builtin_model()
    audio = np.stack([speechlike(3 * 48000, seed=5, f0=120.0),
                      speechlike(3 * 48000, seed=6, f0=210.0)])
    got = denoiser.denoise_array(audio, model=model)
    want = np.stack([toracle.denoise_stream(a, model) for a in audio])
    np.testing.assert_allclose(got, want, atol=ORACLE_ATOL)
