"""The port's PyanNet segmentation net (crispy_tpu_torch.models.segmentation)
against the JAX package's on the same NumPy weights and windows, on the
CPU, at segmentation-3.0's published widths (1.49 M weights). The ``gpu``
test holds the card against the CPU path.
"""

import numpy as np
import pytest
import torch

import onnx_builder as ob
from crispy_tpu_torch.engine import diarization as td
from crispy_tpu_torch.models import carry
from crispy_tpu_torch.models import segmentation as ts
from torch_audio import one_torch_thread  # noqa: F401 (autouse fixture)

try:  # the reference; the card's machine has no JAX and runs only the gpu tests
    from crispy_tpu.models import segmentation as js
except ImportError:
    js = None
needs_jax = pytest.mark.skipif(js is None, reason="the JAX reference is not installed")

CFG = ts.SegmentationConfig()


@pytest.fixture(scope="module")
def params():
    return ts.init_random(CFG, seed=0)


@pytest.fixture(scope="module")
def model(params):
    return ts.params_to_module(params, CFG, device="cpu")


def windows(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(ts.WINDOW_SAMPLES) / 16000
    tone = 0.3 * np.sin(2 * np.pi * (150 + 400 * np.arange(n))[:, None] * t)
    return (tone + 0.05 * rng.standard_normal((n, ts.WINDOW_SAMPLES))).astype(np.float32)


def test_published_widths_and_carry(params, model):
    assert sum(v.size for v in params.values()) == 1_493_265
    assert sum(p.numel() for p in model.parameters()) == 1_493_265
    assert carry.module_name("lstm.2.b.ih.w") == "lstm.weight_ih_l2_reverse"
    assert carry.module_name("lstm.0.f.hh.b") == "lstm.bias_hh_l0"
    np.testing.assert_array_equal(model.lstm.weight_ih_l3_reverse.numpy(),
                                  params["lstm.3.b.ih.w"].T)
    np.testing.assert_array_equal(model.sinc.weight.numpy()[:, 0, :],
                                  params["sinc.filters"][:, 0, :].T)


@needs_jax
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_init_random_bit_equal(seed):
    got, want = ts.init_random(CFG, seed), js.init_random(CFG, seed)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@needs_jax
def test_logits_match_jax_at_published_widths(params, model):
    x = windows(2)
    got = model(x)
    want = js.SegmentationModel(params, CFG)(x)
    assert got.shape == want.shape == (2, td.N_SEG_FRAMES, CFG.n_classes)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_from_device_equals_call(model):
    rng = np.random.default_rng(11)
    q = (rng.standard_normal(3 * ts.WINDOW_SAMPLES) * 3000).astype(np.int16)
    host = model(q.astype(np.float32).reshape(3, -1) / 32768.0)
    np.testing.assert_array_equal(model.from_device(torch.from_numpy(q)), host)


def test_plugs_into_segment_speech(model):
    t = np.arange(3 * 16000) / 16000
    a = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    for s in td.segment_speech(a, 1.0, segmentation_fn=model):
        assert 0.0 <= s.start <= s.end <= 3.0 + 1e-6


def sinc_onnx(path, seed=4):
    """A file with segmentation-3.0's sinc parameters and conv kernels
    (what ``from_onnx`` maps) under an arbitrary graph."""
    rng = np.random.default_rng(seed)
    inits = {"low": rng.uniform(30, 4000, (80, 1)).astype(np.float32),
             "band": rng.uniform(50, 2000, (80, 1)).astype(np.float32),
             "c0": (0.1 * rng.standard_normal((60, 80, 5))).astype(np.float32),
             "c1": (0.1 * rng.standard_normal((60, 60, 5))).astype(np.float32)}
    return ob.write_model(path, [ob.node("Identity", ["waveform"], ["logits"])],
                          [("waveform", 1, [None, 1, 160000])],
                          [("logits", 1, [None, 589, 7])], inits)


@needs_jax
def test_from_onnx_matches_jax(tmp_path):
    from test_diarization_onnx import make_segmentation_onnx

    # the mapped file: the same filters and kernels, the same logits
    p = sinc_onnx(tmp_path / "sinc.onnx")
    got = ts.from_onnx(p, device="cpu")
    want = js.from_onnx(p)
    assert got.name == want.name == "segmentation-3.0"
    x = windows(1, seed=3)
    np.testing.assert_allclose(got(x), want(x), rtol=0, atol=1e-4 * np.abs(want(x)).max())
    # the test_diarization_onnx graph has no sinc parameters: both refuse it alike
    bad = make_segmentation_onnx(tmp_path / "seg.onnx")
    with pytest.raises(ValueError) as e_t:
        ts.from_onnx(bad, device="cpu")
    with pytest.raises(ValueError) as e_j:
        js.from_onnx(bad)
    assert str(e_t.value) == str(e_j.value) and "expected 2 tensor(s)" in str(e_t.value)


@pytest.mark.gpu
def test_card_matches_cpu(params, model):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = ts.params_to_module(params, CFG)
    x = windows(2)
    want = model(x)
    np.testing.assert_allclose(card(x), want, rtol=0, atol=1e-4 * np.abs(want).max())
    q = torch.from_numpy((x.reshape(-1) * 32768).astype(np.int16))
    np.testing.assert_allclose(card.from_device(q.cuda()), model.from_device(q), rtol=0,
                               atol=1e-4 * np.abs(want).max())
