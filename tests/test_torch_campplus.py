"""The port's CAM++ speaker-embedding net (crispy_tpu_torch.models.campplus)
against the JAX package's on the same NumPy weights and chunks, on the CPU:
the test-random widths, WeSpeaker-VoxCeleb's published widths (7.18 M
weights), padding and batching invariance, the initializer walk and the
one-upload route. The ``gpu`` test holds the card against the CPU path.
"""

import numpy as np
import pytest
import torch

import onnx_builder as ob
from crispy_tpu_torch.dsp.fbank import fbank
from crispy_tpu_torch.models import campplus as tc
from torch_audio import one_torch_thread  # noqa: F401 (autouse fixture)

try:  # the reference; the card's machine has no JAX and runs only the gpu tests
    import jax.numpy as jnp

    from crispy_tpu.models import campplus as jc
except ImportError:
    jc = None
needs_jax = pytest.mark.skipif(jc is None, reason="the JAX reference is not installed")

CFG = tc.CONFIGS["test-random"]
SR = 16000


@pytest.fixture(scope="module")
def params():
    return tc.init_random(CFG, seed=0)


@pytest.fixture(scope="module")
def model(params):
    return tc.params_to_module(params, CFG, device="cpu")


def tone(freqs, secs, seed=0):
    t = np.arange(int(secs * SR)) / SR
    rng = np.random.default_rng(seed)
    x = sum(0.2 * np.sin(2 * np.pi * f * t + rng.uniform(0, 6)) for f in freqs)
    return (x + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)


def chunks():
    return [tone([220, 440], 2.0), tone([300, 900], 1.3, seed=1),
            tone([500, 1500], 4.0, seed=2), tone([440], 6.0, seed=3), tone([800], 0.02)]


@needs_jax
@pytest.mark.parametrize("cname", ["test-random", "wespeaker-voxceleb"])
def test_init_random_bit_equal(cname):
    got, want = tc.init_random(tc.CONFIGS[cname], 1), jc.init_random(jc.CONFIGS[cname], 1)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@needs_jax
def test_embeddings_match_jax(params, model):
    c = chunks()
    want = jc.CamPPlusModel(params, jc.CONFIGS["test-random"])(c)
    got = model(c)
    assert got.shape == want.shape == (len(c), CFG.embedding_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@needs_jax
def test_published_widths_match_jax():
    cfg = tc.CONFIGS["wespeaker-voxceleb"]
    p = tc.init_random(cfg, seed=0)
    assert sum(v.size for v in p.values()) == 7_177_248
    m = tc.params_to_module(p, cfg, device="cpu")
    assert sum(t.numel() for t in m.parameters()) == 7_177_248
    c = chunks()[:2]
    want = jc.CamPPlusModel(p, jc.CONFIGS["wespeaker-voxceleb"])(c)
    np.testing.assert_allclose(m(c), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_padding_invariance_and_batching(model):
    a = tone([330, 660], 1.5)
    feats = fbank(torch.from_numpy(a[None]), CFG.feat_dim)
    n = torch.tensor([feats.shape[1]])
    with torch.no_grad():
        short = model.forward(feats, n)
        longer = model.forward(torch.nn.functional.pad(feats, (0, 0, 0, 64)), n)
    np.testing.assert_allclose(short.numpy(), longer.numpy(), rtol=0, atol=2e-5)
    b = tone([500, 1500], 3.5, seed=2)
    together = model([a, b])
    np.testing.assert_allclose(model([a])[0], together[0], rtol=0, atol=2e-5)
    np.testing.assert_allclose(model([b])[0], together[1], rtol=0, atol=2e-5)
    assert np.linalg.norm(together[0] - together[1]) > 1e-3
    assert model([]).shape == (0, CFG.embedding_size)


def test_forward_slices_rows(model, monkeypatch):
    c = chunks() * 2
    whole = model(c)
    monkeypatch.setattr(tc, "ROWS_PER_FORWARD", 3)
    np.testing.assert_allclose(model(c), whole, rtol=0, atol=2e-5)


def simulated_export(cfg, seed=7):
    """Initializers as a torch ONNX export orders them, and the flat params
    they fold to."""
    rng = np.random.default_rng(seed)
    inits, expected = [], {}
    for name, kind, shape in tc.param_spec(cfg):
        if kind == "bn":
            c = shape[0]
            gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
            beta = rng.standard_normal(c).astype(np.float32)
            mean = rng.standard_normal(c).astype(np.float32)
            var = rng.uniform(0.2, 2.0, c).astype(np.float32)
            inits += [gamma, beta, mean, var]
            scale = gamma / np.sqrt(var + 1e-5)
            expected[f"{name}.g"] = scale
            expected[f"{name}.b"] = beta - mean * scale
        elif kind == "conv2d":
            kh, kw, cin, cout = shape
            w = rng.standard_normal((cout, cin, kh, kw)).astype(np.float32)
            inits.append(w)
            expected[f"{name}.w"] = w.transpose(2, 3, 1, 0)
        else:
            k, cin, cout = shape
            w = rng.standard_normal((cout, cin, k)).astype(np.float32)
            inits.append(w)
            expected[f"{name}.w"] = w.transpose(2, 1, 0)
            if kind == "conv1d_b":
                b = rng.standard_normal(cout).astype(np.float32)
                inits.append(b)
                expected[f"{name}.b"] = b
    return inits, expected


def test_from_initializers_round_trip_and_rejection():
    inits, expected = simulated_export(CFG)
    params = tc.from_initializers(inits, CFG)
    assert set(params) == set(expected)
    for k in expected:
        np.testing.assert_allclose(params[k], expected[k], rtol=1e-6, atol=1e-6)
    out = tc.params_to_module(params, CFG, device="cpu")([tone([440], 1.0)])
    assert out.shape == (1, CFG.embedding_size) and np.isfinite(out).all()
    with pytest.raises(ValueError, match="expected shape"):
        tc.from_initializers([inits[0][:, :, :1, :]] + inits[1:], CFG)
    with pytest.raises(ValueError, match="trailing"):
        tc.from_initializers(inits + [np.zeros(3, np.float32)], CFG)
    with pytest.raises(ValueError, match="exhausted"):
        tc.from_initializers(inits[:-1], CFG)


@needs_jax
def test_from_onnx_matches_jax(tmp_path):
    inits, _ = simulated_export(CFG, seed=9)
    p = ob.write_model(tmp_path / "campp.onnx", [ob.node("Identity", ["feats"], ["embs"])],
                       [("feats", 1, [None, None, 80])], [("embs", 1, [None, 32])],
                       {f"t{i:03d}": a for i, a in enumerate(inits)})
    got = tc.from_onnx(p, CFG, device="cpu")
    want = jc.from_onnx(p, jc.CONFIGS["test-random"])
    assert got.name == want.name == "campplus-onnx"
    c = chunks()[:3]
    np.testing.assert_allclose(got(c), want(c), rtol=0, atol=1e-4 * np.abs(want(c)).max())


def test_from_device_equals_call(model):
    audio = np.concatenate([tone([220, 1200], 3.0, seed=1), tone([500, 2400], 2.5, seed=2),
                            tone([300, 900], 4.0, seed=3)])
    q = np.zeros(len(audio) + SR, np.int16)  # slack: a 4 s slice never runs past the end
    q[: len(audio)] = np.clip(np.round(audio * 32768.0), -32768, 32767)
    deq = q.astype(np.float32) / 32768.0
    ranges = [(0, 3 * SR), (3 * SR, int(5.5 * SR)), (int(5.5 * SR), len(audio))]
    host = model([deq[a:b] for a, b in ranges])
    dev = model.from_device(torch.from_numpy(q), ranges)
    np.testing.assert_allclose(dev, host, rtol=0, atol=2e-5)
    if jc is not None:
        want = jc.CamPPlusModel(tc.init_random(CFG, 0), jc.CONFIGS["test-random"]).from_device(
            jnp.asarray(q), ranges)
        np.testing.assert_allclose(dev, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.gpu
def test_card_matches_cpu_at_published_widths():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = tc.CONFIGS["wespeaker-voxceleb"]
    p = tc.init_random(cfg, seed=0)
    cpu = tc.params_to_module(p, cfg, device="cpu")
    card = tc.params_to_module(p, cfg)
    c = chunks()
    want = cpu(c)
    np.testing.assert_allclose(card(c), want, rtol=0, atol=1e-4 * np.abs(want).max())
