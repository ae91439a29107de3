"""The port's command surface (crispy_tpu_torch.api.commands.CrispyApp) held
against the JAX package's CrispyApp: the same public commands, the cases of
tests/test_api_commands.py on the port (engines on the CPU), the same
results and bus events for the same model and settings calls on the same
kind of data directory, and the device rule: commands that need no engine
run without a card; a command that reaches an engine raises there."""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

from crispy_tpu.api.commands import CrispyApp as JApp
from crispy_tpu.api.events import EventBus as JBus
from crispy_tpu_torch.api.commands import CrispyApp
from crispy_tpu_torch.api.events import EventBus
from crispy_tpu_torch.engine import transcription as tr
from crispy_tpu_torch.io import wav as wavio
from crispy_tpu_torch.utils import updater
from test_api_commands import REFERENCE_COMMANDS


def public(cls):
    return {n for n in dir(cls) if not n.startswith("_") and callable(getattr(cls, n))}


@pytest.fixture
def app(data_root):
    bus = EventBus()
    bus.keep_history = True
    return CrispyApp(bus=bus, device="cpu")


def test_full_command_surface_exists(app):
    assert len(REFERENCE_COMMANDS) == 52
    missing = [c for c in REFERENCE_COMMANDS if not callable(getattr(app, c, None))]
    assert missing == [], f"missing commands: {missing}"


def test_public_commands_equal_jax():
    """resolved_mesh included: both apps resolve their lazy "auto" mesh."""
    assert public(CrispyApp) == public(JApp)


def test_signatures_equal_jax():
    import inspect

    for name in REFERENCE_COMMANDS:
        j = inspect.signature(getattr(JApp, name))
        t = inspect.signature(getattr(CrispyApp, name))
        assert list(t.parameters) == list(j.parameters), name
        assert [p.default for p in t.parameters.values()] == \
            [p.default for p in j.parameters.values()], name


def drive(app):
    """Model, settings and chat-history commands; returns their results."""
    out = [app.get_available_models(), app.get_available_ns_models(),
           app.get_model_info("small"), app.get_recommended_first_model(),
           app.get_current_model(), app.get_app_settings(), app.get_llm_settings()]
    app.set_active_model("small")
    out.append(app.get_current_model())
    app.model_manager.models_dir.mkdir(parents=True, exist_ok=True)
    (app.model_manager.models_dir / "ggml-small.bin").write_bytes(b"x")
    out += [app.get_model_info("small"), app.delete_model("small"), app.get_current_model(),
            app.delete_model("medium")]
    app.set_active_model("canary-180m-flash")
    app.set_app_setting("diarization_enabled", "true")
    app.set_llm_settings("http://localhost:9/v1", "secret", "gpt-x")
    app.set_autostart(True)
    app.set_transcription_chat_history("/r/x.wav", [
        {"role": "user", "content": "q"}, {"role": "system", "content": "drop me"},
        {"role": "assistant", "content": "a"}])
    out += [app.get_app_settings(), app.get_llm_settings(),
            app.get_transcription_chat_history("/r/x.wav"), app.check_permissions(),
            app.request_permission("microphone"), app.get_recordable_apps(),
            app.get_platform(), app.get_transcription_result("/r/none.wav"),
            app.has_transcription_result("/r/none.wav"), app.get_recordings()]
    app.set_system_input_volume(3.0)
    out.append(app.get_system_input_volume())
    return out


def test_same_calls_same_results_and_events(tmp_path, monkeypatch):
    runs = []
    for app_cls, bus_cls, tag in ((JApp, JBus, "j"), (CrispyApp, EventBus, "t")):
        monkeypatch.setenv("CRISPY_DATA_DIR", str(tmp_path / tag))
        bus = bus_cls()
        bus.keep_history = True
        app = app_cls(bus=bus)
        res = drive(app)
        again = app_cls(bus=bus)  # the persisted selection is restored
        res.append(again.get_current_model())
        runs.append((res, bus.history))
    assert runs[0] == runs[1]
    assert (tmp_path / "t" / "settings.json").read_bytes() == \
        (tmp_path / "j" / "settings.json").read_bytes()


class TestNoCard:
    """CrispyApp() on a host without a card: device=None means the card."""

    @pytest.fixture
    def nocard(self, data_root, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setattr(updater, "INDEX_URL", "http://127.0.0.1:1/json")  # a closed port
        return CrispyApp(bus=EventBus())

    def test_device_free_commands_run(self, nocard):
        app = nocard
        assert len(app.get_available_models()) == 14
        app.set_active_model("small")
        assert app.get_current_model() == "small"
        assert app.delete_model("small") is False and app.get_current_model() is None
        assert app.get_input_devices() and app.get_output_devices() == ["Default"]
        assert app.get_recordings() == [] and not app.is_recording()
        assert app.check_for_updates()["status"] == "offline"
        assert app.get_transcription_state("/r/x.wav") is None
        assert app.get_all_transcription_states() == {}
        assert app.cancel_transcription("/r/x.wav") is False
        app.stop_monitoring()
        app.quit_app()
        assert app._transcription_manager is None and app._monitoring is None

    def test_engine_commands_raise(self, nocard, tmp_path):
        app = nocard
        with pytest.raises(RuntimeError, match="no CUDA device"):
            app.start_monitoring(model_name="dummy")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            app.get_blackhole_status()
        app.set_active_model("small")
        wav = wavio.write_wav(tmp_path / "r.wav", np.zeros((480, 1), np.float32), 48000)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            app.start_transcription(str(wav))
        assert app.get_transcription_state(str(wav)) is None  # nothing ran


class TestAudioCommands:
    def test_devices(self, app):
        ins = app.get_input_devices()
        assert len(ins) >= 1
        assert app.get_default_devices()["default_input"] == ins[0]
        assert app.get_output_devices() == ["Default"]
        assert app.get_platform() in ("macos", "windows", "linux")
        assert app.get_blackhole_status() == {"installed": False, "paths": []}

    def test_monitoring_lifecycle_and_level_events(self, app):
        app.monitoring.realtime = False
        assert app.monitoring.device.type == "cpu"
        app.start_monitoring(model_name="dummy", volume=0.5)
        assert app.monitoring.active
        app.start_monitoring(model_name="dummy", volume=0.7)  # idempotent restart
        time.sleep(0.1)
        app.set_monitoring_model("noisy")
        app.set_monitoring_volume(0.9)
        app.stop_monitoring()
        assert not app.monitoring.active
        levels = [p for e, p in app.bus.history if e == "microphone-level"]
        assert levels and all(isinstance(p, float) and 0 <= p <= 1.0 for p in levels)

    def test_monitoring_feeds_recording_mic(self, app):
        app.monitoring.realtime = False
        app.start_monitoring(model_name="dummy", volume=1.0)
        path = app.start_recording("")
        time.sleep(0.4)
        out = app.stop_recording()
        app.stop_monitoring()
        assert out == path
        audio, sr = wavio.read_wav(path)
        assert sr == 48000 and audio.shape[0] > 0 and audio.shape[1] == 2
        assert float(np.sqrt(np.mean(audio[:, 0] ** 2))) > 0.05  # the 440 Hz mic
        assert wavio.get_wav_duration(path) > 0
        assert [r["path"] for r in app.get_recordings()] == [path]


class TestModelCommands:
    def test_catalog_and_selection(self, app):
        assert len(app.get_available_models()) == 14
        assert [m["id"] for m in app.get_available_ns_models()] == ["dummy", "noisy", "rnnoise"]
        assert app.get_recommended_first_model() == "parakeet-tdt-0.6b-v3"
        assert app.get_current_model() is None
        app.set_active_model("small")
        assert CrispyApp(bus=EventBus()).get_current_model() == "small"
        assert JApp(bus=JBus()).get_current_model() == "small"  # the JAX app reads it too

    def test_download_error_event(self, app, monkeypatch):
        monkeypatch.setattr(app.model_manager.find("diarize-segmentation"), "url",
                            "http://127.0.0.1:1/segmentation-3.0.onnx")  # a closed port
        t = app.download_model("diarize-segmentation")
        t.join(timeout=30)
        assert not t.is_alive()
        states = [p for e, p in app.bus.history if e == "model-state-changed"]
        assert any(p.get("event_type") == "error" for p in states)


class TestTranscriptionCommands:
    def test_requires_selected_model(self, app):
        with pytest.raises(ValueError, match="No transcription model"):
            app.start_transcription("/tmp/x.wav")

    def test_end_to_end_with_fake_engine(self, app, tmp_path):
        app.set_active_model("small")
        eng = type("E", (tr.EngineProtocol,), {
            "transcribe_batch": lambda self, c, language="en": ["hello"] * len(c)})()
        app.transcription_manager._loader = lambda mid, mm: eng
        wav = wavio.write_wav(tmp_path / "r.wav", 0.2 * np.ones((48000, 1), np.float32), 48000)
        th = app.start_transcription(str(wav))
        th.join(timeout=60)
        assert not th.is_alive()
        assert app.has_transcription_result(str(wav))
        assert app.get_transcription_result(str(wav)) == "hello"
        assert app.get_transcription_model(str(wav)) == "small"
        assert app.get_transcription_state(str(wav))["status"] == "completed"
        assert str(wav) in app.get_all_transcription_states()
        assert app.cancel_transcription(str(wav)) is False  # nothing in flight
        app.open_transcription_window(str(wav))
        assert ("transcription-open", {"recording_path": str(wav)}) in app.bus.history

    def test_diarization_settings_reach_the_run(self, app, tmp_path, monkeypatch):
        seen = {}
        monkeypatch.setattr(tr, "start_transcription",
                            lambda path, tm, mid, **kw: seen.update(kw) or threading.Thread())
        app.set_active_model("small")
        app.set_app_setting("diarization_enabled", "true")
        app.set_app_setting("diarization_max_speakers", "3")
        app.start_transcription("/r/x.wav", language="de")
        assert seen == {"language": "de", "diarization": {
            "enabled": True, "max_speakers": 3, "merge_gap": 2.5}}


class TestChatStreaming:
    def test_sse_deltas_and_done(self, app):
        """Full SSE round trip against a loopback OpenAI-compatible server."""

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers["Content-Length"])
                body = json.loads(self.rfile.read(n))
                assert body["stream"] is True
                assert body["messages"][0]["role"] == "system"
                assert "the transcript text" in body["messages"][0]["content"]
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.end_headers()
                for delta in ("Hel", "lo"):
                    chunk = json.dumps({"choices": [{"delta": {"content": delta}}]})
                    self.wfile.write(f"data: {chunk}\n\n".encode())
                self.wfile.write(b"data: [DONE]\n\n")

        srv = HTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            app.set_llm_settings(f"http://127.0.0.1:{srv.server_port}/v1", "key", "gpt")
            tr.save_transcription_result("/r/chat.wav", "the transcript text")
            th = app.stream_transcription_chat("/r/chat.wav",
                                               [{"role": "user", "content": "hi"}], "c1")
            th.join(timeout=30)
            deltas = [p["delta"] for e, p in app.bus.history if e == "transcription-chat-stream"]
            assert "".join(deltas) == "Hello"
            assert ("transcription-chat-done", {"chat_id": "c1"}) in app.bus.history
        finally:
            srv.shutdown()

    def test_missing_api_key_errors(self, app):
        th = app.stream_transcription_chat("/r/none.wav", [], "c2")
        th.join(timeout=10)
        errs = [p for e, p in app.bus.history if e == "transcription-chat-error"]
        assert errs and "API key" in errs[0]["delta"]


def fake_ffmpeg(tmp_path) -> Path:
    """A stand-in ffmpeg that writes a valid WAV to its last argument."""
    helper = tmp_path / "fake_ffmpeg.py"
    helper.write_text(
        "import sys\n"
        "import numpy as np\n"
        "from crispy_tpu_torch.io import wav\n"
        "wav.write_wav(sys.argv[-1], np.zeros((48, 2), np.float32), 48000)\n")
    repo_root = Path(__file__).resolve().parent.parent
    fake = tmp_path / "ffmpeg"
    fake.write_text(f'#!/bin/sh\nexec env PYTHONPATH="{repo_root}" python3 "{helper}" "$@"\n')
    fake.chmod(0o755)
    return fake


class TestConvert:
    def test_convert_with_fake_ffmpeg(self, app, tmp_path):
        from crispy_tpu_torch.engine import convert as cv

        fake = fake_ffmpeg(tmp_path)
        src = tmp_path / "video.mp4"
        src.write_bytes(b"fake media")
        out = cv.convert_to_wav(src, ffmpeg=str(fake))
        assert out.exists() and out.suffix == ".wav"
        assert wavio.read_format(out).sample_rate == 48000
        out2 = cv.convert_to_wav(src, ffmpeg=str(fake))
        assert out2 != out and out2.name == "video_1.wav"
        with pytest.raises(FileNotFoundError):
            cv.convert_to_wav(tmp_path / "absent.mp4", ffmpeg=str(fake))

    def test_permissions_always_granted(self, app):
        perms = app.check_permissions()
        assert perms["microphone"] == "granted"
        assert perms["screen_recording"] is True
        assert app.request_permission("microphone") is True


def test_set_autostart_persists_setting(app):
    app.set_autostart(True)
    assert app.get_app_settings()["autostart_enabled"] == "true"
    app.set_autostart(False)
    assert app.get_app_settings()["autostart_enabled"] == "false"
