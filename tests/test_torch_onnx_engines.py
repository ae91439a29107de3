"""The port's ONNX-bundle ASR engines (crispy_tpu_torch.engine.onnx_engines)
against the JAX package's, on the CPU.

The JAX package's CTC and TDT engine cases (test_onnx_engines: the gigaam
and sensevoice layouts, the language id per call, the loud unknown int
input, TDT batch invariance; test_realistic_bundle: the int8/LSTM parakeet
bundle, through the engine and through load_engine) run with the engine
classes swapped for ``dual_engine`` pairs: each bundle loads in both
packages and every transcription call must give equal texts, and equal
word segments with times within 1e-6 s, before the case's own checks see
the JAX package's. Then the catalog ids through the port's ``load_engine``
(each loads the JAX package's engine type and transcribes as it does; the
enc-dec cases in full are tests/test_torch_onnx_encdec.py), and
``run_transcription`` with each TDT and CTC engine, a padded bucket included.
"""

import numpy as np
import pytest

pytest.importorskip("jax", reason="the JAX reference is not installed")
import test_onnx_engines as jcases  # noqa: E402
import test_realistic_bundle as jreal
from crispy_tpu.api.events import EventBus as JEventBus
from crispy_tpu.engine import onnx_engines as jeng
from crispy_tpu.engine import transcription as jtr
from crispy_tpu.models import registry as jreg
from crispy_tpu_torch.api.events import EventBus
from crispy_tpu_torch.engine import onnx_engines as teng
from crispy_tpu_torch.engine import transcription as tr
from crispy_tpu_torch.io import wav as wavio
from crispy_tpu_torch.models.registry import ModelManager
from test_catalog_engines import BUNDLE_MAKERS
from torch_audio import one_torch_thread, speechlike  # noqa: F401 (autouse fixture)

TIME_TOL = 1e-6  # word times, seconds
ENC_DEC = ("canary-180m-flash", "canary-1b-v2", "cohere-int8", "moonshine-base")
JCtc, JTdt = jeng.OnnxCtcEngine, jeng.OnnxTdtEngine


def _run(fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs), None
    except (ValueError, FileNotFoundError, NotImplementedError) as e:
        return None, e


def assert_same_segments(want, got):
    assert len(got) == len(want)
    for w_row, g_row in zip(want, got):
        assert [s[2] for s in g_row] == [s[2] for s in w_row]
        np.testing.assert_allclose(np.array([s[:2] for s in g_row], np.float64).reshape(-1, 2),
                                   np.array([s[:2] for s in w_row], np.float64).reshape(-1, 2),
                                   rtol=0, atol=TIME_TOL)


def dual_engine(jcls, tcls):
    """An engine class that loads a bundle in both packages and holds every
    transcription of the port's to the JAX package's."""

    class Dual:
        def __init__(self, model_dir, model_id="dual", **kwargs):
            self.j, jerr = _run(jcls, model_dir, model_id, **kwargs)
            kwargs.pop("mesh", None)
            self.t, terr = _run(tcls, model_dir, model_id, device="cpu", **kwargs)
            assert type(terr) is type(jerr), (jerr, terr)
            if jerr is not None:
                raise jerr

        def __getattr__(self, name):
            return getattr(self.j, name)

        def _both(self, method, *args):
            want, jerr = _run(getattr(self.j, method), *args)
            got, terr = _run(getattr(self.t, method), *args)
            assert type(terr) is type(jerr), (jerr, terr)
            if jerr is not None:
                raise jerr
            return want, got

        def transcribe_batch(self, chunks, language="en"):
            want, got = self._both("transcribe_batch", chunks, language)
            assert got == want
            return want

        def transcribe_batch_with_timestamps(self, chunks, offsets, language="en"):
            want, got = self._both("transcribe_batch_with_timestamps", chunks, offsets, language)
            assert_same_segments(want, got)
            return want

        def transcribe_with_timestamps(self, chunk, offset, language="en"):
            want, got = self._both("transcribe_with_timestamps", chunk, offset, language)
            assert_same_segments([want], [got])
            return want

    return Dual


JAX_CASES = [(jcases, "test_ctc_engine_gigaam_layout"),
             (jcases, "test_ctc_engine_sensevoice_layout"),
             (jcases, "test_ctc_language_id_plumbed_per_call"),
             (jcases, "test_ctc_unknown_int_input_is_loud"),
             (jcases, "test_tdt_engine_batch_invariant"),
             (jreal, "test_realistic_parakeet_bundle_end_to_end"),
             (jreal, "test_realistic_bundle_via_load_engine")]


@pytest.mark.parametrize("module,name", JAX_CASES, ids=[n for _, n in JAX_CASES])
def test_jax_engine_case_through_both_packages(module, name, tmp_path, data_root,
                                               monkeypatch):
    monkeypatch.setattr(jeng, "OnnxCtcEngine", dual_engine(JCtc, teng.OnnxCtcEngine))
    monkeypatch.setattr(jeng, "OnnxTdtEngine", dual_engine(JTdt, teng.OnnxTdtEngine))
    fn = getattr(module, name)
    fn(**{k: v for k, v in (("tmp_path", tmp_path), ("data_root", data_root))
          if k in fn.__code__.co_varnames[:fn.__code__.co_argcount]})


@pytest.mark.parametrize("name", ["test_energy_quantile_times_track_two_speaker_bursts",
                                  "test_energy_quantile_times_degenerate_inputs"])
def test_energy_quantile_times_agree(name, monkeypatch):
    """The enc-dec engine's token-time helper (ported ahead of its engine):
    the JAX package's cases with both packages' helper, equal times."""
    jtimes = jeng._energy_quantile_times

    def dual(row, dur, n_tokens, *args):
        want = jtimes(row, dur, n_tokens, *args)
        got = teng._energy_quantile_times(row, dur, n_tokens, *args)
        np.testing.assert_allclose(got, want, rtol=0, atol=TIME_TOL)
        assert teng._active_span(row, dur) == jeng._active_span(row, dur)
        return want

    monkeypatch.setattr(jeng, "_energy_quantile_times", dual)
    getattr(jcases, name)()


def test_tdt_with_a_preprocess_graph(tmp_path):
    """A bundle's preprocess graph (waveform → features) is the TDT
    engine's frontend in both packages: equal texts and word segments."""
    import onnx_builder as ob

    jcases.make_parakeet_bundle(tmp_path)
    w = (np.random.default_rng(9).standard_normal((80, 1, 400)) * 0.05).astype(np.float32)
    ob.write_model(tmp_path / "preprocess.onnx", [
        ob.node("Conv", ["waveform", "w"], ["features"], strides=[160], kernel_shape=[400]),
    ], [("waveform", 1, [None, 1, None])], [("features", 1, [None, 80, None])], {"w": w})
    eng = dual_engine(JTdt, teng.OnnxTdtEngine)(tmp_path, "pre")
    assert eng.kind == "waveform" and eng.t.kind == "waveform"
    x = _chunks(2, 24000)
    assert eng.transcribe_batch(x)
    eng.transcribe_batch_with_timestamps(x, [0.0, 30.0])


def _chunks(B=2, n=16000):
    return np.stack([speechlike(n, seed=b, sr=16000, f0=120.0 + 30.0 * b) * 0.5
                     for b in range(B)])


@pytest.mark.parametrize("model_id", sorted(BUNDLE_MAKERS))
def test_catalog_bundles_through_the_ports_load_engine(model_id, tmp_path):
    models = tmp_path / "Models"
    mm = ModelManager(models_dir=models)
    path = mm.model_path(model_id)
    path.mkdir(parents=True)
    BUNDLE_MAKERS[model_id](path)
    eng = tr.load_engine(model_id, mm, device="cpu")
    want_cls = (teng.OnnxEncDecEngine if model_id in ENC_DEC
                else teng.OnnxTdtEngine if "parakeet" in model_id else teng.OnnxCtcEngine)
    assert type(eng) is want_cls
    jeng_ = jtr.load_engine(model_id, jreg.ModelManager(models_dir=models, bus=JEventBus()))
    x = _chunks()
    texts = eng.transcribe_batch(x)
    assert texts == jeng_.transcribe_batch(x) and len(texts) == 2
    assert_same_segments([jeng_.transcribe_with_timestamps(x[0], 30.0)],
                         [eng.transcribe_with_timestamps(x[0], 30.0)])


def test_cohere_single_graph_bundle_is_ctc(tmp_path):
    """cohere pinned by inventory: a single graph is CTC in both packages."""
    models = tmp_path / "Models"
    path = ModelManager(models_dir=models).model_path("cohere-int8")
    path.mkdir(parents=True)
    jcases.make_gigaam_bundle(path)
    eng = tr.load_engine("cohere-int8", ModelManager(models_dir=models), device="cpu")
    assert type(eng) is teng.OnnxCtcEngine
    jeng_ = jtr.load_engine("cohere-int8", jreg.ModelManager(models_dir=models, bus=JEventBus()))
    assert eng.transcribe_batch(_chunks()) == jeng_.transcribe_batch(_chunks())


RUNS = {  # model id: (bundle, WAV seconds, sample rate, batch_chunks)
    "gigaam-v3-e2e-ctc": (jcases.make_gigaam_bundle, 65, 48000, 2),
    "sense-voice-int8": (jcases.make_sensevoice_bundle, 65, 16000, 2),
    "parakeet-tdt-0.6b-v2": (jcases.make_parakeet_bundle, 65, 16000, 2),
    "parakeet-tdt-0.6b-v3": (jreal.make_realistic_parakeet_bundle, 35, 16000, 8),
}


@pytest.mark.parametrize("model_id", list(RUNS))
def test_run_transcription_equals_jax(model_id, tmp_path, data_root):
    """A recording through run_transcription in both packages: equal text.
    With batch_chunks 2 the CTC engines' last batch is padded (3 chunks: a
    2-bucket, then 1 live row and 1 pad row) and the float TDT engine takes
    one 16-bucket with 13 pad rows (its decode_batch_bucket); the 48 kHz WAV
    resamples on the device (chunks arrive as tensors). The int8 bundle
    runs unpadded: its activation scales span the whole batch, and a pad
    row's NeMo features of digital silence are f32 rounding noise that no
    two implementations share."""
    make, seconds, sr, batch = RUNS[model_id]
    models = tmp_path / "Models"
    path = ModelManager(models_dir=models).model_path(model_id)
    path.mkdir(parents=True)
    make(path)
    pcm = (speechlike(seconds * sr, seed=7, sr=sr) * 32767).astype(np.int16)
    wav = wavio.write_wav(tmp_path / "rec.wav", pcm, sr)
    jbus = JEventBus()
    jtm = jtr.TranscriptionManager(jreg.ModelManager(models_dir=models, bus=jbus), bus=jbus)
    bus = EventBus()
    bus.keep_history = True
    ttm = tr.TranscriptionManager(ModelManager(models_dir=models), bus=bus, device="cpu")
    want = jtr.run_transcription(str(wav), jtm, model_id, batch_chunks=batch)
    tr.clear_transcription_progress(str(wav))
    got = tr.run_transcription(str(wav), ttm, model_id, batch_chunks=batch)
    assert got and got == want
    assert ttm.get_state(str(wav)).status == "completed"
    live = [p["chunks"] for e, p in bus.history
            if e == "stage-timing" and p["stage"] == "transcribe-batch"]
    assert sum(live) == -(-seconds // 30)
