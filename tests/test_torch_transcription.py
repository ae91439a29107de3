"""The port's transcription pipeline (crispy_tpu_torch.engine.transcription):
the cases of tests/test_transcription.py against the port (chunking, tail
padding, the bucket schedule, ETA, cancel, resume, checkpoints, empty and
48 kHz input), and its run_transcription held against the JAX package's on
the same WAV and the same test-random ggml file through temperature-0
engines (texts equal), load_engine's whisper engine, and the CLI.
"""

import json

import numpy as np
import pytest
import torch

from crispy_tpu_torch import cli
from crispy_tpu_torch.api.events import EventBus
from crispy_tpu_torch.dsp.resample import resample_poly
from crispy_tpu_torch.engine import transcription as tr
from crispy_tpu_torch.io import wav as wavio
from crispy_tpu_torch.models.registry import CATALOG, ModelManager
from crispy_tpu_torch.models.whisper import WhisperModel
from crispy_tpu_torch.models.whisper import ggml_io as tg
from crispy_tpu_torch.models.whisper import model as tm
from crispy_tpu_torch.models.whisper.weights import init_random
from torch_audio import one_torch_thread  # noqa: F401 (autouse fixture)

try:  # the reference; the card's machine has no JAX and runs only the gpu tests
    from crispy_tpu.api.events import EventBus as JEventBus
    from crispy_tpu.engine import transcription as jtr
    from crispy_tpu.models import registry as jreg
    from crispy_tpu.models.whisper import WhisperModel as JWhisperModel
except ImportError:
    jtr = None
needs_jax = pytest.mark.skipif(jtr is None, reason="the JAX reference is not installed")


class FakeEngine(tr.EngineProtocol):
    """Deterministic engine: text encodes chunk index + RMS presence."""

    name = "fake"

    def __init__(self, delay=0.0, texts=None):
        self.delay = delay
        self.calls = []
        self.kinds = []
        self.texts = texts

    def transcribe_batch(self, chunks, language="en"):
        self.kinds.append(type(chunks))
        chunks = np.asarray(chunks)
        self.calls.append(chunks.shape)
        if self.delay:
            import time

            time.sleep(self.delay)
        out = []
        for i, c in enumerate(np.atleast_2d(chunks)):
            if self.texts is not None:
                out.append(self.texts.pop(0) if self.texts else "")
            else:
                out.append(f"chunk{len(self.calls)}-{i}" if np.abs(c).max() > 0 else "")
        return out


@pytest.fixture
def setup(tmp_path, data_root):
    bus = EventBus()
    bus.keep_history = True
    mm = ModelManager(models_dir=tmp_path / "Models")
    engine = FakeEngine()
    tm_ = tr.TranscriptionManager(mm, bus=bus, engine_loader=lambda mid, m: engine,
                                  device="cpu")
    return tm_, bus, engine, tmp_path


def make_wav(path, seconds, sr=48000, channels=1):
    t = np.arange(int(seconds * sr)) / sr
    sig = (0.3 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)
    return wavio.write_wav(path, np.tile(sig[:, None], (1, channels)), sr)


class TestPersistence:
    @needs_jax
    def test_stems_match_jax(self):
        for p in ("/a/b.wav", "/a/c.wav", "rel/ü.wav"):
            assert tr.transcription_file_stem(p) == jtr.transcription_file_stem(p)
        assert len(tr.transcription_file_stem("/a/b.wav")) == 16

    def test_sidecar_roundtrip(self, data_root):
        tr.save_transcription_result("/r/x.wav", "hello")
        tr.save_transcription_metadata("/r/x.wav", "small")
        tr.save_transcription_chat_history("/r/x.wav", [{"role": "user", "content": "hi"}])
        assert tr.load_transcription_result("/r/x.wav") == "hello"
        assert tr.load_transcription_metadata("/r/x.wav") == "small"
        assert tr.load_transcription_chat_history("/r/x.wav")[0]["content"] == "hi"
        assert tr.load_transcription_result("/r/other.wav") is None
        assert tr.load_transcription_metadata("/r/other.wav") is None
        assert tr.load_transcription_chat_history("/r/other.wav") == []
        assert tr.transcription_result_path("/r/x.wav").parent == data_root / "Transcriptions"


class TestPipeline:
    def test_short_file_single_chunk(self, setup):
        tm_, bus, engine, tmp = setup
        wav = make_wav(tmp / "rec.wav", seconds=2.0, sr=16000)
        text = tr.run_transcription(str(wav), tm_, "fake-model")
        assert text.startswith("chunk1-0")
        assert engine.calls == [(1, tr.CHUNK_SAMPLES)]
        assert engine.kinds == [np.ndarray]  # 16 kHz audio stays on the host
        statuses = [p["status"] for e, p in bus.history if e == "transcription-status"]
        assert statuses == ["started", "completed"]
        phases = [p["phase"] for e, p in bus.history if e == "transcription-phase"]
        assert phases == ["preparing-audio", "loading-model", "transcribing"]
        assert tr.load_transcription_result(str(wav)) == text
        assert tr.load_transcription_metadata(str(wav)) == "fake-model"

    def test_long_file_batched_chunks_and_progress(self, setup):
        tm_, bus, engine, tmp = setup
        wav = make_wav(tmp / "long.wav", seconds=95.0, sr=16000)  # 4 chunks
        tr.run_transcription(str(wav), tm_, "fake-model", batch_chunks=2)
        assert engine.calls == [(2, tr.CHUNK_SAMPLES), (2, tr.CHUNK_SAMPLES)]
        progs = [p["progress"] for e, p in bus.history if e == "transcription-progress"]
        assert progs == sorted(progs) and progs[-1] == 1.0
        st = tm_.get_state(str(wav))
        assert st.status == "completed" and st.progress == 1.0
        assert tm_.get_all_states()[str(wav)]["status"] == "completed"

    def test_tail_batch_padded_to_fixed_shape(self, setup):
        tm_, bus, engine, tmp = setup
        wav = make_wav(tmp / "tail.wav", seconds=65.0, sr=16000)  # 3 chunks
        text = tr.run_transcription(str(wav), tm_, "fake-model", batch_chunks=2)
        assert engine.calls == [(2, tr.CHUNK_SAMPLES), (2, tr.CHUNK_SAMPLES)]
        assert len([w for w in text.split() if w.startswith("chunk")]) == 3

    def test_large_bucket_schedule(self, setup):
        tm_, bus, engine, tmp = setup
        engine.decode_batch_bucket = 4
        wav = make_wav(tmp / "big.wav", seconds=10 * 30.0 - 5, sr=16000)  # 10 chunks
        text = tr.run_transcription(str(wav), tm_, "fake-model", batch_chunks=2)
        assert engine.calls == [(4, tr.CHUNK_SAMPLES), (4, tr.CHUNK_SAMPLES),
                                (2, tr.CHUNK_SAMPLES)]
        assert len([w for w in text.split() if w.startswith("chunk")]) == 10
        engine.calls.clear()
        wav2 = make_wav(tmp / "big2.wav", seconds=7 * 30.0 - 5, sr=16000)  # 7 chunks
        text2 = tr.run_transcription(str(wav2), tm_, "fake-model", batch_chunks=2)
        assert engine.calls == [(4, tr.CHUNK_SAMPLES), (4, tr.CHUNK_SAMPLES)]
        assert len([w for w in text2.split() if w.startswith("chunk")]) == 7

    def test_eta_emitted(self, setup):
        tm_, bus, engine, tmp = setup
        engine.delay = 0.05
        wav = make_wav(tmp / "eta.wav", seconds=65.0, sr=16000)
        tr.run_transcription(str(wav), tm_, "fake-model", batch_chunks=1)
        etas = [p["eta_seconds"] for e, p in bus.history if e == "transcription-progress"]
        assert any(v is not None for v in etas)
        stages = [p for e, p in bus.history if e == "stage-timing"]
        assert [p["stage"] for p in stages] == ["transcribe-batch"] * 3

    def test_cancel_between_batches(self, setup):
        tm_, bus, engine, tmp = setup
        wav = make_wav(tmp / "c.wav", seconds=65.0, sr=16000)
        orig = engine.transcribe_batch

        def canceling(chunks, language="en"):
            tm_.cancel(str(wav))
            return orig(chunks, language)

        engine.transcribe_batch = canceling
        assert tr.run_transcription(str(wav), tm_, "fake-model", batch_chunks=1) is None
        statuses = [p["status"] for e, p in bus.history if e == "transcription-status"]
        assert statuses[-1] == "cancelled"
        assert not tm_.cancel(str(wav))  # the flag is gone once the run ends

    def test_error_sets_error_state(self, setup):
        tm_, bus, engine, tmp = setup

        def boom(chunks, language="en"):
            raise RuntimeError("engine exploded")

        engine.transcribe_batch = boom
        wav = make_wav(tmp / "e.wav", seconds=2.0)
        with pytest.raises(RuntimeError):
            tr.run_transcription(str(wav), tm_, "fake-model")
        assert tm_.get_state(str(wav)).status == "error"
        errs = [p["error"] for e, p in bus.history if e == "transcription-status" and p["error"]]
        assert "engine exploded" in errs[0]

    def test_empty_file_completes_with_empty_result(self, setup):
        tm_, bus, engine, tmp = setup
        wav = wavio.write_wav(tmp / "empty.wav", np.zeros((0, 1), np.float32), 48000)
        assert tr.run_transcription(str(wav), tm_, "fake-model") == ""
        assert tm_.get_state(str(wav)).status == "completed"
        assert engine.calls == []

    def test_resampling_48k_input_stays_on_the_device(self, setup):
        """48 kHz input resamples to 16 kHz on the manager's device before
        chunking; the chunk batches reach the engine as tensors there and
        give the transcript of the same audio resampled on the host."""
        tm_, bus, engine, tmp = setup
        wav = make_wav(tmp / "r48.wav", seconds=95.0, sr=48000)  # 4 chunks, ragged tail
        dev_text = tr.run_transcription(str(wav), tm_, "fake-model", batch_chunks=3)
        assert engine.kinds and all(k is torch.Tensor for k in engine.kinds)
        dev_calls = list(engine.calls)
        assert dev_calls[0][0] == 3 and len(dev_calls) == 2
        audio, _ = wavio.read_wav_mono(wav)
        host16 = resample_poly(audio, 48000, 16000)  # scipy, on the host
        wav16 = wavio.write_wav(tmp / "r16.wav", host16, 16000, dtype="f32")
        engine.calls.clear()
        assert tr.run_transcription(str(wav16), tm_, "fake-model", batch_chunks=3) == dev_text
        assert engine.calls == dev_calls

    def test_start_transcription_runs_in_thread(self, setup):
        tm_, bus, engine, tmp = setup
        wav = make_wav(tmp / "t.wav", seconds=2.0)
        th = tr.start_transcription(str(wav), tm_, "fake-model")
        th.join(timeout=30)
        assert not th.is_alive()
        assert tm_.get_state(str(wav)).status == "completed"

    def test_manager_model_caching(self, setup):
        tm_, bus, engine, tmp = setup
        loads = []
        tm_._loader = lambda mid, m: loads.append(mid) or engine
        tm_.load_model("a")
        tm_.load_model("a")
        tm_.load_model("b")
        assert loads == ["a", "b"]
        assert tm_.get_current_model() == "b"

    def test_diarization_is_not_ported(self, setup):
        """A downloaded net that neither route can run: the ONNX executor
        refuses its unsupported op (NotImplementedError), the native loader
        is tried next (it cannot map this graph), and the transcript is
        diarized by the stand-in nets, with one diarization-fallback event
        that carries both errors."""
        import onnx_builder as ob

        tm_, bus, engine, tmp = setup
        seg = tm_.model_manager.model_path("diarize-segmentation")
        seg.parent.mkdir(parents=True, exist_ok=True)
        ob.write_model(seg, [ob.node("CustomOp", ["waveform"], ["logits"])],
                       [("waveform", 1, [None, 1, 160000])], [("logits", 1, [None, 589, 7])])
        wav = make_wav(tmp / "d.wav", seconds=2.0)
        text = tr.run_transcription(str(wav), tm_, "fake-model", diarization={"enabled": True})
        assert text == "[Speaker 1|0.0]\nchunk1-0"
        assert engine.calls == [(1, tr.CHUNK_SAMPLES)]
        evs = [p for e, p in bus.history if e == "diarization-fallback"]
        assert [e["net"] for e in evs] == ["segmentation"]
        assert evs[0]["error"].startswith("unsupported ONNX ops: CustomOp")
        assert "native port: expected 2 tensor(s)" in evs[0]["error"]
        assert tm_.get_state(str(wav)).status == "completed"


class TestCheckpointResume:
    def test_resume_skips_completed_batches(self, setup):
        tm_, bus, engine, tmp_path = setup
        wav = tmp_path / "long.wav"
        make_wav(wav, 90)  # 3 chunks

        class FlakyEngine(FakeEngine):
            def transcribe_batch(self, chunks, language="en"):
                if len(self.calls) == 1:  # first batch already committed
                    raise RuntimeError("injected failure on second batch")
                return super().transcribe_batch(chunks, language)

        flaky = FlakyEngine()
        tm_._loader = lambda mid, m: flaky
        tm_._engine = None
        with pytest.raises(RuntimeError):
            tr.run_transcription(str(wav), tm_, "fake-model", batch_chunks=1)
        assert tr.transcription_progress_path(str(wav)).exists()

        good = FakeEngine()
        tm_._loader = lambda mid, m: good
        tm_._engine = None
        text = tr.run_transcription(str(wav), tm_, "fake-model", batch_chunks=1)
        assert text is not None and text.strip()
        assert len(good.calls) == 2  # only the remaining 2 chunks
        assert not tr.transcription_progress_path(str(wav)).exists()

    def test_checkpoint_ignored_on_model_change(self, setup):
        tm_, bus, engine, tmp_path = setup
        wav = tmp_path / "m.wav"
        make_wav(wav, 60)  # 2 chunks
        tr._save_progress(str(wav), {"model_id": "other-model", "language": "en",
                                     "n_chunks": 2, "done_chunks": 1,
                                     "diarization": False,
                                     "parts": [[0.0, 30.0, "stale"]]})
        text = tr.run_transcription(str(wav), tm_, "fake-model", batch_chunks=2)
        assert "stale" not in text
        assert len(engine.calls) == 1  # full re-run in one batch

    def test_corrupt_checkpoint_restarts_clean(self, setup):
        tm_, bus, engine, tmp_path = setup
        wav = tmp_path / "c.wav"
        make_wav(wav, 30)
        tr.transcription_progress_path(str(wav)).write_text("{not json")
        text = tr.run_transcription(str(wav), tm_, "fake-model")
        assert text and not tr.transcription_progress_path(str(wav)).exists()


# ---------------------------------------------------------------------------
# The whisper engine, against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ggml_file(tmp_path_factory):
    cfg = tm.CONFIGS["test-random"]
    return tg.write_ggml(tmp_path_factory.mktemp("models") / "m.bin", init_random(cfg, 0), cfg)


def speech_wav(path, seconds, sr=48000):
    t = np.arange(int(sr * seconds)) / sr
    sig = (0.3 * np.sin(2 * np.pi * 220 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 0.7 * t))
           + 0.02 * np.random.default_rng(0).standard_normal(t.size))
    return wavio.write_wav(path, np.clip(sig, -1, 1).astype(np.float32), sr)


@needs_jax
def test_run_transcription_text_equals_jax(tmp_path, data_root, ggml_file):
    """Temperature-0 engines over the same ggml file (with random weights the
    fallback ladder would end on its sampled T=1.0 rung, whose draws differ
    by design), on a 65 s 48 kHz 16-bit WAV: 3 chunks, a padded tail batch."""
    wav = speech_wav(tmp_path / "rec.wav", 65.0)
    jwm = JWhisperModel.from_ggml(ggml_file)
    twm = WhisperModel.from_ggml(ggml_file, device="cpu")

    class JEngine(jtr.EngineProtocol):
        def transcribe_batch(self, chunks, language="en"):
            return jwm.transcribe_chunks_robust(np.atleast_2d(chunks), language=language,
                                                temperatures=(0.0,))

    class TEngine(tr.EngineProtocol):
        def transcribe_batch(self, chunks, language="en"):
            return twm.transcribe_chunks_robust(chunks, language=language, temperatures=(0.0,))

    jbus = JEventBus()
    jtm = jtr.TranscriptionManager(jreg.ModelManager(models_dir=tmp_path / "M", bus=jbus),
                                   bus=jbus, engine_loader=lambda mid, m: JEngine())
    ttm = tr.TranscriptionManager(ModelManager(models_dir=tmp_path / "M"), bus=EventBus(),
                                  engine_loader=lambda mid, m: TEngine(), device="cpu")
    want = jtr.run_transcription(str(wav), jtm, "w", batch_chunks=2)
    tr.clear_transcription_progress(str(wav))
    got = tr.run_transcription(str(wav), ttm, "w", batch_chunks=2)
    assert got and got == want


def install_model(models_dir, ggml_file, model_id="small"):
    info = ModelManager.find(model_id)
    models_dir.mkdir(parents=True, exist_ok=True)
    (models_dir / info.filename).write_bytes(ggml_file.read_bytes())


def test_load_engine_transcribes(tmp_path, data_root, ggml_file):
    """load_engine's whisper engine (the full fallback ladder) on the ggml
    file under a catalog id; a model not downloaded raises, and so does a
    bundle directory that holds no .onnx file for the ONNX executor (the
    native families are held in tests/test_torch_asr_engines.py)."""
    mm = ModelManager(models_dir=tmp_path / "Models")
    with pytest.raises(FileNotFoundError):
        tr.load_engine("small", mm, device="cpu")
    install_model(tmp_path / "Models", ggml_file)
    assert [m["is_downloaded"] for m in mm.get_available_models()][:2] == [True, False]
    bus = EventBus()
    bus.keep_history = True
    ttm = tr.TranscriptionManager(mm, bus=bus, device="cpu")
    wav = speech_wav(tmp_path / "rec.wav", 5.0)
    text = tr.run_transcription(str(wav), ttm, "small")
    assert ttm.get_state(str(wav)).status == "completed"
    assert tr.load_transcription_result(str(wav)) == text and text.startswith("tok")
    assert ttm.engine.decode_batch_bucket == 16 and ttm.engine.model.device.type == "cpu"
    with pytest.raises(ValueError, match="unknown model"):
        tr.load_engine("nope", mm, device="cpu")
    with pytest.raises(FileNotFoundError, match="not downloaded"):
        tr.load_engine("moonshine-base", mm, device="cpu")
    (tmp_path / "Models" / ModelManager.find("moonshine-base").filename).mkdir()
    with pytest.raises(FileNotFoundError, match="no .onnx files"):
        tr.load_engine("moonshine-base", mm, device="cpu")


@needs_jax
def test_catalog_matches_jax():
    assert [m.to_dict(False) for m in CATALOG] == [m.to_dict(False) for m in jreg.CATALOG]


def test_cli_transcribe_writes_output(tmp_path, data_root, ggml_file, capsys):
    install_model(data_root / "Models", ggml_file)
    wav = speech_wav(tmp_path / "rec.wav", 3.0, sr=16000)
    out = tmp_path / "out.txt"
    rc = cli.main(["transcribe", str(wav), "--model", "small", "--device", "cpu",
                   "--output", str(out)])
    assert rc == 0
    assert out.read_text(encoding="utf-8") == tr.load_transcription_result(str(wav))
    assert out.read_text(encoding="utf-8").startswith("tok")
    assert json.loads(capsys.readouterr().err.strip().splitlines()[-1])["status"] == "completed"
    rc = cli.main(["transcribe", str(wav), "--model", "parakeet-tdt-0.6b-v2", "--device", "cpu"])
    assert rc == 1


def test_cli_transcribe_diarize(tmp_path, data_root, ggml_file, capsys):
    """--diarize: whisper's timestamped decode, the speakers tagged."""
    install_model(data_root / "Models", ggml_file)
    wav = speech_wav(tmp_path / "rec.wav", 3.0, sr=16000)
    rc = cli.main(["transcribe", str(wav), "--model", "small", "--device", "cpu",
                   "--diarize"])
    out = capsys.readouterr()
    assert rc == 0 and out.out.startswith("[Speaker 1|")
    assert out.out.strip() == tr.load_transcription_result(str(wav))


@needs_jax
def test_whisper_diarized_transcription_matches_jax(tmp_path, data_root, ggml_file):
    """run_transcription with diarization through load_engine's whisper
    engine: one batched timestamped decode (the model's own method), then
    the JAX package's run_diarization of the same segments and audio gives
    the same tagged text."""
    from crispy_tpu.engine import diarization as jd

    install_model(data_root / "Models", ggml_file)
    wav = speech_wav(tmp_path / "talk.wav", 40.0, sr=16000)  # 2 chunks, one batch
    tm_ = tr.TranscriptionManager(ModelManager(models_dir=data_root / "Models"),
                                  bus=EventBus(), device="cpu")
    got = tr.run_transcription(str(wav), tm_, "small", diarization={"enabled": True})
    audio, _ = wavio.read_wav_mono(wav)
    chunks = np.zeros((2, tr.CHUNK_SAMPLES), np.float32)
    chunks.reshape(-1)[: audio.size] = audio
    segs = tm_.engine.transcribe_batch_with_timestamps(chunks, [0, 30])
    assert segs == tm_.engine.model.transcribe_chunks_with_timestamps(chunks, [0, 30])
    parts = [(s, min(e, audio.size / 16000), t) for chunk in segs for s, e, t in chunk
             if t.strip()]
    assert parts and got == jd.run_diarization(audio, 16000, parts)
    assert got.startswith("[Speaker 1|")


def test_manager_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.TranscriptionManager(ModelManager(models_dir=tmp_path))
