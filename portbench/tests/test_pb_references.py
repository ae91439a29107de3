"""The plain references against the port, on the CPU at small sizes. The
tests import the port; the references do not."""

import numpy as np
import pytest
import torch

from portbench.audio import speechlike, to_int16
from portbench.cells import HERE, load_cell, sub_seed
from portbench.reference import rnnoise as R
from portbench.reference import whisper as RW

WEIGHTS = HERE / "configs" / "rnnoise-builtin.npz"


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pcm(seed, streams, seconds, rate=48000):
    audio = load_cell("denoise-batch-s128").traffic["audio"]
    return to_int16(speechlike(sub_seed(seed, "test"), streams, seconds * rate, rate, audio, "cpu")).numpy()


def test_tf32_rounding():
    x = np.array([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -12, -3.0],
                 np.float32)
    assert R.tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, 1.0, -3.0]
    ref = RW.Reference.__new__(RW.Reference)
    ref.tf32 = True
    assert ref._r(torch.from_numpy(x)).tolist() == R.tf32(x).tolist()


def test_rnnoise_tables_match_the_ports():
    from crispy_tpu_torch.dsp.rnnoise import constants as C

    np.testing.assert_array_equal(R.WINDOW, C.full_window())
    np.testing.assert_array_equal(R.DCT, C.dct_matrix())
    np.testing.assert_array_equal(R.BAND_E, C.band_energy_matrix())
    np.testing.assert_array_equal(R.BAND_INTERP, C.band_interp_matrix())
    x = np.linspace(-9, 9, 1001, dtype=np.float32)
    np.testing.assert_array_equal(R.tansig(x), C.tansig_approx(x))


def test_rnnoise_reference_follows_the_ports_oracle():
    """Frame by frame against the port's own NumPy oracle, the C chain's
    sequential copy: within one int16 step on most samples."""
    from crispy_tpu_torch.dsp.rnnoise import oracle
    from crispy_tpu_torch.dsp.rnnoise.weights import RNNoiseModel

    pcm = _pcm(3, 2, 1)
    ref = R.denoise(R.load_weights(WEIGHTS), pcm, block_frames=30)
    model = RNNoiseModel.load(WEIGHTS)
    for s in range(2):
        o = oracle.denoise_stream(pcm[s].astype(np.float32) / 32768, model)
        o16 = np.trunc(np.clip(o, -1, 1) * 32767).astype(np.int16)
        d = np.abs(o16.astype(int) - ref[s].astype(int))
        assert d.max() <= 2 and np.mean(d > 1) < 1e-3


def test_rnnoise_blocks_carry_state():
    """Blocks of 7 frames give what blocks of 100 give, to the rounding of
    a sum taken over a different batch."""
    pcm = _pcm(4, 2, 1)
    w = R.load_weights(WEIGHTS)
    d = np.abs(R.denoise(w, pcm, block_frames=100).astype(int) - R.denoise(w, pcm, block_frames=7))
    assert d.max() <= 1 and np.mean(d > 0) < 1e-3


def test_the_ports_cpu_path_against_the_reference():
    """The port's ``denoise_batch`` on the int16 wire at 4 streams x 2 s:
    the frames off by more than 2 steps stay under the cell's limit."""
    from crispy_tpu_torch.dsp.rnnoise import pipeline
    from crispy_tpu_torch.dsp.rnnoise.weights import RNNoiseModel

    pcm = _pcm(5, 4, 2)
    params = pipeline.make_params(RNNoiseModel.load(WEIGHTS), "cpu")
    got = pipeline.denoise_batch(pcm, block_frames=50, params=params, wire="i16", device="cpu")
    want = R.denoise(R.load_weights(WEIGHTS), pcm, block_frames=50)
    frames = np.abs(got.astype(int) - want.astype(int)).reshape(4, -1, 480).max(axis=2)
    limit = load_cell("denoise-batch-s128").traffic["check"]["limits"]["frames_off_pct"]
    assert 100 * np.mean(frames > 2) < limit
    assert np.median(frames) <= 1


def _tiny_whisper(seed=7):
    import crispy_tpu_torch.models.whisper as W
    from portbench.drivers.transcribe import _module_from

    s = RW.Shape(n_mels=80, n_vocab=600, n_audio_ctx=1500, d_model=64, n_head=2,
                 encoder_layers=2, n_text_ctx=448, decoder_layers=2)
    cfg = W.WhisperConfig(80, 600, 1500, 64, 2, 2, 448, 64, 2, 2, 599, 598)
    w = RW.draw_weights(s, seed, "cpu")
    with _module_from(W, w):
        wm = W.WhisperModel(w, cfg, W.WhisperTokenizer.dummy(600), device="cpu")
    return W, s, w, wm


def test_whisper_layout_is_the_ports_module():
    W, s, w, wm = _tiny_whisper()
    sd = wm.model.state_dict()
    assert set(sd) == set(w)
    for k, v in w.items():
        assert sd[k].shape == v.shape and sd[k].data_ptr() == v.data_ptr()
    again = RW.draw_weights(s, 7, "cpu")
    assert all(torch.equal(again[k], w[k]) for k in w)


def test_whisper_frontend_and_encoder():
    from crispy_tpu_torch.dsp.mel import log_mel_spectrogram

    W, s, w, wm = _tiny_whisper()
    audio = speechlike(11, 2, 480000, 16000, load_cell("transcribe-turbo-b16").traffic["audio"], "cpu")
    ref = RW.Reference(s, w)
    mel = ref.log_mel(audio)
    torch.testing.assert_close(mel, log_mel_spectrogram(audio, n_mels=80, pad_to_chunk=True),
                               rtol=0, atol=2e-5)
    torch.testing.assert_close(ref.encode(mel), W.encode(wm.model, mel), rtol=1e-4, atol=1e-4)


def test_whisper_served_tokens_and_logprob():
    """The port's temperature-0 ``sample_decode``: every token the
    reference's first choice, the sum of log-probabilities equal."""
    W, s, w, wm = _tiny_whisper()
    audio = speechlike(12, 2, 480000, 16000, load_cell("transcribe-turbo-b16").traffic["audio"], "cpu")
    ref = RW.Reference(s, w)
    mel = ref.log_mel(audio)
    prompt = torch.tensor([[598, 597], [598, 597]])
    gen = torch.Generator().manual_seed(0)
    tokens, lengths, lp_sum, _ = W.sample_decode(wm.model, mel, prompt, 0.0, gen, 596, max_new=20,
                                                 eot=599)
    for b in range(2):
        n = min(int(lengths[b]) + 1, 20)
        inp = torch.cat([prompt[b], tokens[b, : n - 1]])[None]
        lg = ref.logits(audio[b: b + 1], inp)[0, 1:]
        assert torch.equal(lg.argmax(-1), tokens[b, :n])
        lp = torch.log_softmax(lg.double(), -1).gather(-1, tokens[b, :n, None]).sum()
        assert abs(float(lp) - float(lp_sum[b])) / n < 1e-4
