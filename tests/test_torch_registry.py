"""The port's model registry (crispy_tpu_torch.models.registry) held against
the JAX package's: downloads, resume, restart on 200, cancel, archive
extraction and deletion from a local HTTP server (no network), each run
through both packages into model directories of their own, give the same
files and the same bus events in the same order."""

import io
import tarfile
import threading
from functools import partial
from http.server import HTTPServer, SimpleHTTPRequestHandler

import pytest

from crispy_tpu.api.events import EventBus as JBus
from crispy_tpu.models import registry as jreg
from crispy_tpu_torch.api.events import EventBus
from crispy_tpu_torch.models import registry as reg


@pytest.fixture
def served_dir(tmp_path):
    """Local HTTP server with Range support over a temp dir."""
    docroot = tmp_path / "srv"
    docroot.mkdir()

    class Handler(SimpleHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def send_head(self):  # add Range support (SimpleHTTP lacks it)
            path = self.translate_path(self.path)
            try:
                f = open(path, "rb")
            except OSError:
                self.send_error(404)
                return None
            size = f.seek(0, 2)
            f.seek(0)
            rng = self.headers.get("Range")
            if rng and rng.startswith("bytes=") and not path.endswith("norange"):
                start = int(rng[6:].split("-")[0])
                f.seek(start)
                self.send_response(206)
                self.send_header("Content-Length", str(size - start))
                self.send_header("Content-Range", f"bytes {start}-{size-1}/{size}")
            else:
                self.send_response(200)
                self.send_header("Content-Length", str(size))
            self.end_headers()
            return f

    srv = HTTPServer(("127.0.0.1", 0), partial(Handler, directory=str(docroot)))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield docroot, f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()


@pytest.fixture
def managers(tmp_path):
    """(JAX manager, port manager), each with its own models dir and bus."""
    out = []
    for mod, bus_cls, tag in ((jreg, JBus, "j"), (reg, EventBus, "t")):
        bus = bus_cls()
        bus.keep_history = True
        out.append(mod.ModelManager(models_dir=tmp_path / tag / "Models", bus=bus))
    return out


def patch_both(monkeypatch, model_id, **fields):
    for mod in (jreg, reg):
        m = mod.ModelManager.find(model_id)
        for k, v in fields.items():
            monkeypatch.setattr(m, k, v)


def run_both(managers, fn):
    """fn(manager, module) on both; returns [(result or exception type, history)]."""
    out = []
    for mm, mod in zip(managers, (jreg, reg)):
        try:
            res = fn(mm, mod)
        except Exception as e:  # the comparison is the point: both must raise alike
            res = type(e).__name__
        out.append((res, mm.bus.history))
    return out


def test_catalog_and_constants_match_jax():
    assert [m.to_dict(False) for m in reg.CATALOG] == [m.to_dict(False) for m in jreg.CATALOG]
    assert reg.NS_MODEL_CATALOG == jreg.NS_MODEL_CATALOG
    assert reg.RECOMMENDED_FIRST_MODEL == jreg.RECOMMENDED_FIRST_MODEL == "parakeet-tdt-0.6b-v3"


def test_queries_match_jax(managers):
    j, t = managers
    assert t.get_available_models() == j.get_available_models()
    assert t.get_model_info("parakeet-tdt-0.6b-v2") == j.get_model_info("parakeet-tdt-0.6b-v2")
    assert t.get_model_info("nope") is None and j.get_model_info("nope") is None


def test_plain_download_with_progress(served_dir, managers, monkeypatch):
    docroot, base = served_dir
    payload = bytes(range(256)) * 1000
    (docroot / "ggml-small.bin").write_bytes(payload)
    patch_both(monkeypatch, "small", url=f"{base}/ggml-small.bin")
    runs = run_both(managers, lambda mm, mod: mm.download_model(
        "small", chunk_size=65536, progress_every=0.0).read_bytes())
    assert runs[0] == runs[1]
    assert runs[1][0] == payload
    assert ("model-state-changed", {"event_type": "downloaded", "model_id": "small",
                                    "model_name": None, "error": None}) in runs[1][1]


def test_resume_from_partial(served_dir, managers, monkeypatch):
    docroot, base = served_dir
    payload = b"A" * 50000 + b"B" * 50000
    (docroot / "ggml-small.bin").write_bytes(payload)
    patch_both(monkeypatch, "small", url=f"{base}/ggml-small.bin")
    for mm in managers:
        mm.models_dir.mkdir(parents=True, exist_ok=True)
        (mm.models_dir / "ggml-small.bin.partial").write_bytes(payload[:50000])
    runs = run_both(managers, lambda mm, mod: mm.download_model(
        "small", progress_every=0.0).read_bytes())
    assert runs[0] == runs[1] and runs[1][0] == payload


def test_resume_restart_on_200(served_dir, managers, monkeypatch):
    docroot, base = served_dir
    payload = b"C" * 30000
    (docroot / "norange").write_bytes(payload)
    patch_both(monkeypatch, "small", url=f"{base}/norange", filename="norange-model.bin")
    for mm in managers:
        mm.models_dir.mkdir(parents=True, exist_ok=True)
        (mm.models_dir / "norange.partial").write_bytes(b"GARBAGE")
    runs = run_both(managers, lambda mm, mod: mm.download_model(
        "small", progress_every=0.0).read_bytes())
    assert runs[0] == runs[1] and runs[1][0] == payload


def test_cancel_mid_download(served_dir, managers, monkeypatch):
    docroot, base = served_dir
    (docroot / "ggml-small.bin").write_bytes(b"D" * 500000)
    patch_both(monkeypatch, "small", url=f"{base}/ggml-small.bin")

    def cancelled(mm, mod):
        unlisten = mm.bus.listen("model-download-progress",
                                 lambda p: mm.cancel_download(p["model_id"]))
        try:
            with pytest.raises(mod.DownloadCancelled):
                mm.download_model("small", chunk_size=1024, progress_every=0.0)
        finally:
            unlisten()
        return mm.is_downloaded("small")

    runs = run_both(managers, cancelled)
    assert runs[0] == runs[1] and runs[1][0] is False
    assert ("model-state-changed", {"event_type": "cancelled", "model_id": "small",
                                    "model_name": None, "error": None}) in runs[1][1]


def test_stale_cancel_does_not_kill_next_download(served_dir, managers, monkeypatch):
    docroot, base = served_dir
    (docroot / "ggml-small.bin").write_bytes(b"W" * 4096)
    patch_both(monkeypatch, "small", url=f"{base}/ggml-small.bin")

    def stale(mm, mod):
        mm.cancel_download("small")  # nothing in flight
        return mm.download_model("small").read_bytes()

    runs = run_both(managers, stale)
    assert runs[0] == runs[1] and runs[1][0] == b"W" * 4096


@pytest.mark.parametrize("top_dir", ["moonshine-base", "", "other-name"])
def test_archive_extraction(served_dir, managers, monkeypatch, top_dir):
    docroot, base = served_dir
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for name, data in (("encoder.onnx", b"model-weights"), ("tokens.txt", b"a b")):
            info = tarfile.TarInfo(f"{top_dir}/{name}" if top_dir else name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    (docroot / "moonshine-base.tar.gz").write_bytes(buf.getvalue())
    patch_both(monkeypatch, "moonshine-base", url=f"{base}/moonshine-base.tar.gz")
    runs = run_both(managers, lambda mm, mod: sorted(
        (p.name, p.read_bytes()) for p in mm.download_model("moonshine-base").iterdir()))
    assert runs[0] == runs[1]
    assert runs[1][0] == [("encoder.onnx", b"model-weights"), ("tokens.txt", b"a b")]
    events = dict(runs[1][1])
    assert events["model-extraction-started"] == "moonshine-base"
    assert events["model-extraction-completed"] == "moonshine-base"
    assert events["model-download-complete"] == "moonshine-base"
    t = managers[1]
    assert not list(t.models_dir.glob("*.partial")) and not list(t.models_dir.glob("*.extracting"))


def test_corrupt_archive_fails_with_event(served_dir, managers, monkeypatch):
    docroot, base = served_dir
    (docroot / "moonshine-base.tar.gz").write_bytes(b"not a tar.gz")
    patch_both(monkeypatch, "moonshine-base", url=f"{base}/moonshine-base.tar.gz")
    runs = run_both(managers, lambda mm, mod: mm.download_model("moonshine-base"))
    assert runs[0] == runs[1] and runs[1][0] == "ReadError"
    assert "model-extraction-failed" in [e for e, _ in runs[1][1]]
    assert not list(managers[1].models_dir.glob("*.extracting"))


def test_unknown_and_undownloadable(managers):
    runs = run_both(managers, lambda mm, mod: mm.download_model("nope"))
    assert runs[0] == runs[1] and runs[1][0] == "ValueError"


def test_delete_model(managers):
    def delete(mm, mod):
        mm.models_dir.mkdir(parents=True, exist_ok=True)
        (mm.models_dir / "ggml-small.bin").write_bytes(b"x")
        (mm.models_dir / "moonshine-base").mkdir()
        return [mm.is_downloaded("small"), mm.delete_model("small"), mm.is_downloaded("small"),
                mm.delete_model("moonshine-base"), mm.delete_model("small"),
                mm.delete_model("nope")]

    runs = run_both(managers, delete)
    assert runs[0] == runs[1] and runs[1][0] == [True, True, False, True, False, False]


def test_stale_extracting_cleanup_and_migration(tmp_path):
    d = tmp_path / "Models"
    (d / "foo.extracting").mkdir(parents=True)
    mm = reg.ModelManager(models_dir=d, bus=EventBus())
    assert not (d / "foo.extracting").exists()
    res = tmp_path / "res" / "models"
    res.mkdir(parents=True)
    (res / "ggml-small.bin").write_bytes(b"bundled")
    (d / "ggml-medium.bin").write_bytes(b"mine")
    (res / "ggml-medium.bin").write_bytes(b"bundled")
    mm.migrate_bundled(tmp_path / "res")
    assert (d / "ggml-small.bin").read_bytes() == b"bundled"
    assert (d / "ggml-medium.bin").read_bytes() == b"mine"  # never overwritten
    mm.migrate_bundled(tmp_path / "absent")  # no resources: nothing happens


def test_selected_model_state_matches_jax():
    runs = []
    for mod, bus_cls in ((jreg, JBus), (reg, EventBus)):
        bus = bus_cls()
        bus.keep_history = True
        st = mod.SelectedModelState(bus=bus)
        got = [st.get()]
        st.set("small", model_name="Whisper Small")
        got.append(st.get())
        st.set("none")
        got.append(st.get())
        st.set("canary-180m-flash")
        st.set(None)
        got.append(st.get())
        runs.append((got, bus.history))
    assert runs[0] == runs[1]
    assert runs[1][0] == [None, "small", None, None]
