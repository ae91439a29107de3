"""The port's CLI (crispy_tpu_torch.cli) held against the JAX package's:
``models list|set|delete|inspect|download|validate``, ``convert``, ``update``,
``recordings`` and ``transcribe``'s selected-model fallback print what the JAX
package's CLI prints on the same data directory; the device-free commands
run without a card. Downloads and the index come from local servers."""

import json
import threading
from functools import partial
from http.server import HTTPServer, SimpleHTTPRequestHandler

import numpy as np
import pytest
import torch

from crispy_tpu import cli as jcli
from crispy_tpu.models import registry as jreg
from crispy_tpu.utils import updater as jup
from crispy_tpu_torch import cli
from crispy_tpu_torch.api.events import EventBus
from crispy_tpu_torch.io import wav as wavio
from crispy_tpu_torch.models import registry as reg
from crispy_tpu_torch.utils import paths, updater
from crispy_tpu_torch.utils import tracing
from crispy_tpu_torch.utils.tracing import stage


def both(capsys, argv, port_extra=()):
    """(rc, stdout) of the JAX CLI, then of the port's, on the same data root."""
    out = []
    for main, extra in ((jcli.main, ()), (cli.main, port_extra)):
        rc = main([*argv, *extra])
        out.append((rc, capsys.readouterr().out))
    return out


@pytest.fixture
def nocard(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_models_list_same_lines(capsys, data_root, nocard):
    j, t = both(capsys, ["models", "list"])
    assert t == j and t[0] == 0
    assert "parakeet-tdt-0.6b-v3" in t[1] and "recommended" in t[1]


def test_models_set_delete_inspect_same_output(capsys, data_root, nocard):
    assert both(capsys, ["models", "set", "small"])[0] == (0, '{"active": "small"}\n')
    j, t = both(capsys, ["models", "list"])
    assert t == j and "active: small" in t[1]
    mdir = paths.models_dir()
    mdir.mkdir(parents=True, exist_ok=True)
    (mdir / "ggml-small.bin").write_bytes(b"x")
    j, t = both(capsys, ["models", "inspect", "small"])
    assert t == j and json.loads(t[1])["files"] == ["ggml-small.bin"]
    rc, out = cli.main(["models", "delete", "small"]), capsys.readouterr().out
    assert rc == 0 and json.loads(out) == {"deleted": True}
    j, t = both(capsys, ["models", "list"])  # the deletion cleared the selection
    assert t == j and "active: (none)" in t[1]


def test_models_inspect_onnx_bundle(capsys, data_root, nocard):
    from test_onnx_engines import make_canary_bundle

    bundle = reg.ModelManager().model_path("canary-180m-flash")
    bundle.mkdir(parents=True)
    make_canary_bundle(bundle)
    j, t = both(capsys, ["models", "inspect", "canary-180m-flash"])
    assert t == j
    info = json.loads(t[1])
    assert info["downloaded"] and info["graphs"] and all(g["ops"] for g in info["graphs"].values())


def test_models_validate_cli(capsys, data_root, tmp_path):
    """`models validate <id> --pin` on a synthetic catalog bundle: the port's
    golden record on the CPU equals the JAX package's."""
    from test_onnx_engines import make_canary_bundle

    bundle = reg.ModelManager().model_path("canary-180m-flash")
    bundle.mkdir(parents=True)
    make_canary_bundle(bundle)
    pins = [tmp_path / "jax.json", tmp_path / "port.json"]
    assert jcli.main(["models", "validate", "canary-180m-flash", "--pin", str(pins[0])]) == 0
    assert cli.main(["models", "validate", "canary-180m-flash", "--pin", str(pins[1]),
                     "--device", "cpu"]) == 0
    capsys.readouterr()
    j, t = (json.loads(p.read_text()) for p in pins)
    assert t == j and t["model_id"] == "canary-180m-flash"
    j, t = both(capsys, ["models", "validate", "cohere-int8"], ("--device", "cpu"))
    assert t == j and t[0] == 1  # not downloaded


def test_validation_utterance_is_the_jax_packages():
    from crispy_tpu.models import validate as jval
    from crispy_tpu_torch.models import validate as val

    assert val.UTTERANCE.read_bytes() == jval.UTTERANCE.read_bytes()
    assert np.array_equal(val.validation_utterance(), jval.validation_utterance())


def test_models_download_from_local_server(capsys, data_root, nocard, tmp_path, monkeypatch):
    docroot = tmp_path / "srv"
    docroot.mkdir()
    (docroot / "seg.onnx").write_bytes(b"S" * 70000)

    class Quiet(SimpleHTTPRequestHandler):
        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), partial(Quiet, directory=str(docroot)))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_port}/seg.onnx"
        for mod in (jreg, reg):
            monkeypatch.setattr(mod.ModelManager.find("diarize-segmentation"), "url", url)
        rc = cli.main(["models", "download", "diarize-segmentation"])
        info = json.loads(capsys.readouterr().out)
        assert rc == 0 and info["is_downloaded"]
        assert (paths.models_dir() / "segmentation-3.0.onnx").read_bytes() == b"S" * 70000
        j, t = both(capsys, ["models", "list"])
        assert t == j and "* diarize-segmentation" in t[1]
    finally:
        srv.shutdown()


def test_update_offline_same_output(capsys, nocard, monkeypatch):
    for mod in (jup, updater):
        monkeypatch.setattr(mod, "INDEX_URL", "http://127.0.0.1:1/json")  # a closed port
    j, t = both(capsys, ["update"])
    assert t == j and json.loads(t[1])["status"] == "offline"


def test_convert(capsys, data_root, nocard, tmp_path, monkeypatch):
    from test_torch_commands import fake_ffmpeg

    src = tmp_path / "clip.mp4"
    src.write_bytes(b"media")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr("crispy_tpu_torch.engine.convert._EXTRA_CANDIDATES", [])
    monkeypatch.setattr("crispy_tpu.engine.convert._EXTRA_CANDIDATES", [])
    j, t = both(capsys, ["convert", str(src)])
    assert t == j == (1, '{"error": "ffmpeg not found"}\n')
    monkeypatch.setenv("PATH", f"{fake_ffmpeg(tmp_path).parent}:/usr/bin:/bin")
    rc, out = cli.main(["convert", str(src)]), capsys.readouterr().out
    dst = json.loads(out)["output"]
    assert rc == 0 and dst == str(paths.recordings_dir() / "clip.wav")
    assert wavio.read_format(dst).sample_rate == 48000


def test_recordings_list_and_delete(capsys, data_root):
    d = paths.ensure_dir(paths.recordings_dir())
    p = wavio.write_wav(d / "x.wav", np.zeros((480, 1), np.float32), 48000)
    j, t = both(capsys, ["recordings", "list"])
    assert t == j and "x.wav" in t[1]
    assert cli.main(["recordings", "delete", str(p)]) == 0
    assert not p.exists()


def test_transcribe_requires_model(capsys, data_root, tmp_path):
    wav = wavio.write_wav(tmp_path / "r.wav", np.zeros((480, 1), np.float32), 48000)
    j, t = both(capsys, ["transcribe", str(wav)], ("--device", "cpu"))
    # the port has no `crispy` entry point: its message names the subcommand
    assert t == (j[0], j[1].replace("`crispy models", "`models")) and t[0] == 1


def test_transcribe_falls_back_to_the_selected_model(capsys, data_root, tmp_path, monkeypatch):
    """Without --model the selected model runs; --diarize goes through the
    app setting (the settings' speaker count and merge gap reach the run)."""
    from crispy_tpu_torch.engine import transcription as tr

    seen = []
    eng = type("E", (tr.EngineProtocol,), {
        "transcribe_batch": lambda self, c, language="en": ["hi"] * len(c)})()
    monkeypatch.setattr(tr, "load_engine", lambda mid, mm, device=None, mesh=None: seen.append(
        (mid, device.type, tr.resolve_mesh(mesh, device))) or eng)
    wav = wavio.write_wav(tmp_path / "r.wav", 0.1 * np.ones((48000, 1), np.float32), 48000)
    assert cli.main(["models", "set", "moonshine-base"]) == 0
    calls = []
    real_run = tr.run_transcription
    monkeypatch.setattr(tr, "run_transcription",
                        lambda *a, **kw: calls.append(kw) or real_run(*a, **kw))
    capsys.readouterr()
    assert cli.main(["transcribe", str(wav), "--device", "cpu", "--diarize"]) == 0
    assert seen == [("moonshine-base", "cpu", None)]  # the lazy "auto": no mesh on the CPU
    assert calls[0]["diarization"] == {"enabled": True, "max_speakers": 6, "merge_gap": 2.5}
    from crispy_tpu_torch.utils import settings

    assert settings.load_app_settings().diarization_enabled == "true"


def test_stage_timing_events():
    """``stage`` emits its ``stage-timing`` event (what the web UI reads)
    with or without a profiler session, and records a span only inside
    one, carrying the event's extra fields."""
    bus = EventBus()
    bus.keep_history = True
    seen = {s.id for s in tracing.spans()}
    with stage("unit", bus, {"n": 3}):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with stage("unit", bus):
            with stage("inner", bus, {"chunks": 2}):
                pass
    events = [p for e, p in bus.history if e == "stage-timing"]
    assert [p["stage"] for p in events] == ["unit", "inner", "unit"]
    assert events[0]["n"] == 3 and events[1]["chunks"] == 2
    assert all(p["seconds"] >= 0 for p in events)
    new = [s for s in tracing.spans() if s.id not in seen]
    assert [(s.name, s.attrs) for s in new] == [("inner", {"chunks": 2}), ("unit", {})]
    assert new[0].parent == new[1].id and new[1].parent is None
