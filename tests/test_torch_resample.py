"""The port's device resampler (crispy_tpu_torch.dsp.resample.make_resampler,
one polyphase conv1d) held against the JAX package's ``make_resampler_jax``
run on the CPU and against the scipy path, at 48k→16k, 44.1k→16k and
44.1k→48k.

Tolerances: 5e-6 absolute against ``make_resampler_jax`` (the same f32
products summed in another order, over 67-73 taps per output); 2e-4 against
the scipy path, the JAX package's own bound between its conv and scipy
paths (scipy filters in float64 and its length may differ by one sample).
The int16 wire is exact: it gives the f32 wire's output bit for bit.
"""

import numpy as np
import pytest
import torch

from crispy_tpu_torch.dsp import resample as trs
from torch_audio import one_torch_thread, speechlike  # noqa: F401 (fixture)

try:  # the reference; the card's machine has no JAX and runs only the gpu tests
    import jax
    import jax.numpy as jnp

    from crispy_tpu.dsp import resample as jrs
except ImportError:
    jrs = None
needs_jax = pytest.mark.skipif(jrs is None, reason="the JAX reference is not installed")

PAIRS = [(48000, 16000), (44100, 16000), (44100, 48000)]


def signal(n, sr, seed=0):
    rng = np.random.default_rng(seed)
    return (speechlike(n, seed=seed, sr=sr) + 0.05 * rng.standard_normal(n)).astype(np.float32)


@needs_jax
@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("n", [4410, 50_001])
def test_conv_matches_jax_conv_and_scipy(pair, n):
    fr, to = pair
    x = signal(n, fr, seed=n % 7)
    got = trs.make_resampler(fr, to, device="cpu")(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jrs.make_resampler_jax(fr, to, n))(jnp.asarray(x)))
    assert got.shape == want.shape == (int(np.ceil(n * to / fr)),)
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)
    host = jrs.resample_poly(x, fr, to, use_jax=False)
    m = min(host.size, got.size)
    assert abs(host.size - got.size) <= 1
    np.testing.assert_allclose(got[:m], host[:m], atol=2e-4, rtol=0)


@pytest.mark.parametrize("pair", PAIRS)
def test_device_out_and_i16_wire_exact(pair):
    """resample_poly(device_out=True) returns a tensor on the device; a
    signal on the int16 grid gives the same samples through either wire."""
    fr, to = pair
    pcm = (signal(9_000, fr, seed=2) * 32767).astype(np.int16)
    x = pcm.astype(np.float32) / 32768.0
    f32 = trs.resample_poly(x, fr, to, device_out=True, device="cpu")
    i16 = trs.resample_poly(x, fr, to, wire="i16", device_out=True, device="cpu")
    assert isinstance(f32, torch.Tensor) and f32.dtype == torch.float32
    assert torch.equal(f32, i16)
    direct = trs.make_resampler(fr, to, device="cpu")(torch.from_numpy(x))
    assert torch.equal(f32, direct)
    # an explicit device alone takes the conv path too, never the scipy one
    assert torch.equal(trs.resample_poly(x, fr, to, device="cpu"), direct)


def test_same_rate_and_empty_stay_exact():
    x = signal(1000, 16000)
    same = trs.resample_poly(x, 16000, 16000, device_out=True, device="cpu")
    np.testing.assert_array_equal(same.numpy(), x)
    empty = trs.resample_poly(np.zeros(0, np.float32), 48000, 16000, device_out=True,
                              device="cpu")
    assert empty.shape == (0,)
    np.testing.assert_array_equal(trs.resample_poly(x, 16000, 16000), x)


def test_device_path_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trs.resample_poly(signal(100, 48000), 48000, 16000, device_out=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trs.resample_poly(signal(100, 48000), 48000, 16000, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("pair", PAIRS)
def test_card_matches_cpu(pair):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fr, to = pair
    x = signal(5 * fr, fr, seed=4)
    card = trs.resample_poly(x, fr, to, wire="i16", device_out=True)
    cpu = trs.resample_poly(x, fr, to, wire="i16", device_out=True, device="cpu")
    assert card.device.type == "cuda"
    assert float((card.cpu() - cpu).abs().max()) <= 5e-6
