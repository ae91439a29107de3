"""The port's ASR frontends (crispy_tpu_torch.dsp.asr_frontend, dsp.fbank)
held against the JAX package's on the CPU, on the same seeded inputs.

Tolerance: within 1e-5 of the JAX output's largest magnitude (the port takes
the spectrum by torch.fft.rfft, the JAX package by products with DFT tables
for the NeMo and GigaAM features; f32 sums in another order). LFR stacking
is a copy: equal. The tests marked ``gpu`` hold the card against the port's
CPU path; here they skip.

NeMo's features are held on three inputs (the valid-frame mask's cases):
speech-like audio, a chunk whose tail is zero padding, and a row of digital
silence. On the silent row every frame sits at the log floor and falls back
to all-frame statistics, so each feature is (x - mean) / (std + 1e-5) of a
constant: the f32 rounding error of the mean, which depends on the order of
the sum, multiplied by ~1e5 (the JAX package itself gives 0.1601 on 2 s and
0.2761 on 30 s of silence). There the test holds what is defined: the log
mel energies and the valid mask equal to the JAX package's, and every
feature constant over the frames and below 1 in magnitude.
"""

import numpy as np
import pytest
import torch

from crispy_tpu_torch.dsp import asr_frontend as ta
from crispy_tpu_torch.dsp import fbank as tf
from torch_audio import one_torch_thread, speechlike  # noqa: F401 (autouse fixture)

try:  # the reference; the card's machine has no JAX and runs only the gpu tests
    import jax.numpy as jnp

    from crispy_tpu.dsp import asr_frontend as ja
    from crispy_tpu.dsp import fbank as jf
except ImportError:
    ja = None
needs_jax = pytest.mark.skipif(ja is None, reason="the JAX reference is not installed")

TOL = 1e-5
N = 32000  # 2 s at 16 kHz


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def inputs():
    """Speech-like audio, the same with its last 0.75 s zero-padded, silence."""
    sp = speechlike(N, seed=1, sr=16000)
    pad = sp.copy()
    pad[20000:] = 0.0
    return np.stack([sp, pad, np.zeros(N, np.float32)])


@needs_jax
@pytest.mark.parametrize("row", ["speech", "padded_tail"])
def test_nemo_log_mel_matches_jax(row):
    """Each row in the batch of all three inputs (rows are independent)."""
    x = inputs()
    i = ["speech", "padded_tail"].index(row)
    want = np.asarray(ja.nemo_log_mel(jnp.asarray(x)))
    got = ta.nemo_log_mel(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 80, N // 160 + 1)
    assert rel(got[i], want[i]) <= TOL


@needs_jax
def test_nemo_valid_mask_matches_jax():
    """The discrete mask: padded-tail frames out, the silent row's fallback
    to all frames."""
    x = inputs()
    power = ja._power_stft(jnp.asarray(
        np.concatenate([x[:, :1], x[:, 1:] - np.float32(0.97) * x[:, :-1]], axis=1)),
        512, 400, 160)
    jlog = np.log(np.asarray(jnp.einsum("bfk,km->bfm", power, ja._nemo_fb(80))) + 2.0 ** -24)
    floor = np.float32(np.log(2.0 ** -24))
    jvalid = np.any(jlog > floor + np.float32(1e-3), axis=-1, keepdims=True)
    jvalid = jvalid | ~np.any(jvalid, axis=1, keepdims=True)
    tlog = ta.nemo_raw_log_mel(torch.from_numpy(x))
    tvalid = ta.valid_frames(tlog).numpy()
    assert np.array_equal(tvalid, jvalid)
    assert tvalid[0].all() and not tvalid[1].all() and tvalid[1, :100].all() and tvalid[2].all()
    assert rel(tlog.numpy(), jlog) <= TOL


@needs_jax
def test_nemo_silent_row_is_defined_where_the_reference_is():
    x = inputs()
    want = np.asarray(ja.nemo_log_mel(jnp.asarray(x)))[2]
    got = ta.nemo_log_mel(torch.from_numpy(x)).numpy()[2]
    raw = ta.nemo_raw_log_mel(torch.from_numpy(x[2:])).numpy()
    assert np.all(raw == np.float32(np.log(np.float32(2.0 ** -24))))
    for out in (got, want):
        assert np.isfinite(out).all() and np.abs(out).max() < 1.0
        assert np.all(out == out[:, :1])  # constant over the frames


@needs_jax
def test_gigaam_log_mel_matches_jax():
    x = inputs()
    want = np.asarray(ja.gigaam_log_mel(jnp.asarray(x)))
    got = ta.gigaam_log_mel(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 64, N // 160 + 1)
    assert rel(got, want) <= TOL


@needs_jax
@pytest.mark.parametrize("n_mels", [80, 64])
def test_fbank_matches_jax(n_mels):
    x = inputs()
    want = np.asarray(jf.fbank(jnp.asarray(x), n_mels))
    got = tf.fbank(torch.from_numpy(x), n_mels).numpy()
    assert got.shape == want.shape == (3, 1 + (N - 400) // 160, n_mels)
    assert rel(got, want) <= TOL
    one = tf.fbank(torch.from_numpy(x[0]), n_mels).numpy()  # [T] → [frames, n_mels]
    assert np.array_equal(one, got[0])


@needs_jax
@pytest.mark.parametrize("T", [399, 400, 560])
def test_fbank_snip_edges_frames(T):
    x = speechlike(T, seed=2, sr=16000)
    want = np.asarray(jf.fbank(jnp.asarray(x)))
    got = tf.fbank(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    if want.size:
        assert rel(got, want) <= TOL


@needs_jax
@pytest.mark.parametrize("m,n,T", [(7, 6, 97), (3, 2, 12), (5, 1, 9), (7, 6, 1)])
def test_lfr_equals_jax(m, n, T):
    f = np.random.default_rng(T).standard_normal((2, T, 16)).astype(np.float32)
    assert np.array_equal(ta.lfr(torch.from_numpy(f), m, n).numpy(),
                          np.asarray(ja.lfr(jnp.asarray(f), m, n)))


@needs_jax
def test_filterbanks_are_the_jax_packages_copies():
    assert np.array_equal(ta._htk_mel_filterbank(64, 16000, 400),
                          ja._htk_mel_filterbank(64, 16000, 400))
    assert np.array_equal(tf.mel_banks(80), jf.mel_banks(80))
    assert np.array_equal(tf.povey_window(), jf.povey_window())


@pytest.mark.gpu
def test_card_matches_cpu():
    """The frontends on the card within 1e-4 of the CPU path's largest
    magnitude (cuFFT against pocketfft), the valid mask equal, on 30 s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sp = speechlike(480000, seed=3, sr=16000)
    pad = sp.copy()
    pad[300000:] = 0.0
    x = torch.from_numpy(np.stack([sp, pad]))
    for fn in (ta.nemo_log_mel, ta.gigaam_log_mel, tf.fbank):
        assert rel(fn(x.cuda()).cpu(), fn(x)) <= 1e-4
    assert torch.equal(ta.valid_frames(ta.nemo_raw_log_mel(x.cuda())).cpu(),
                       ta.valid_frames(ta.nemo_raw_log_mel(x)))
