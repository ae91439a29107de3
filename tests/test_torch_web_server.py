"""The port's web surface (crispy_tpu_torch.api.web_server over the port's
CrispyApp) held against the JAX package's: the cases of
tests/test_web_server.py on the port, the same command whitelist, event
catalog and page files, and the same replies (statuses, JSON bodies and
Range headers) to one request sequence from a JAX WebServer over the JAX
CrispyApp and the port's over CrispyApp(device="cpu"), each on its own data
root. Also: the kernel library is built and bound once under concurrent
first uses, and ``cli serve`` answers from its own process without a card,
where a command that needs the card is a 500 naming it."""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from crispy_tpu.api import web_server as jws
from crispy_tpu.api.commands import CrispyApp as JApp
from crispy_tpu.api.events import EventBus as JBus
from crispy_tpu_torch import _build
from crispy_tpu_torch.api.commands import CrispyApp
from crispy_tpu_torch.api.events import EventBus
from crispy_tpu_torch.api.web_server import COMMANDS, SSE_EVENTS, WEBUI_DIR, WebServer
from crispy_tpu_torch.io import wav as wavio
from crispy_tpu_torch.utils import paths

ROOT = Path(__file__).resolve().parent.parent
PAGES = ("index.html", "tray.html", "result.html", "shared.js")


@pytest.fixture
def served(data_root):
    app = CrispyApp(bus=EventBus(), device="cpu")
    srv = WebServer(app, port=0).start()
    yield app, srv
    srv.stop()


def _get(srv, path, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}", headers=headers or {})
    return urllib.request.urlopen(req, timeout=10)


def _api(srv, name, body=None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/api/{name}",
        data=json.dumps(body or {}).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def _status(fn, *a, **kw) -> int:
    with pytest.raises(urllib.error.HTTPError) as e:
        fn(*a, **kw)
    return e.value.code


# -- the contract: the same whitelist, events and pages as the JAX package -------

def test_catalogs_equal_jax():
    assert len(COMMANDS) == 54 and len(set(COMMANDS)) == 54
    assert len(SSE_EVENTS) == 17
    assert COMMANDS == jws.COMMANDS
    assert SSE_EVENTS == jws.SSE_EVENTS


@pytest.mark.parametrize("name", PAGES)
def test_webui_files_equal_jax(name):
    assert (WEBUI_DIR / name).read_bytes() == (jws.WEBUI_DIR / name).read_bytes()
    assert WEBUI_DIR.parent.parent.name == "crispy_tpu_torch"


def test_webui_is_package_data():
    text = (ROOT / "pyproject.toml").read_text()
    entry = re.search(r'^"crispy_tpu_torch" = \[(.*)\]$', text, re.M)
    assert entry and '"api/webui/*"' in entry.group(1)


def test_whitelist_matches_app_surface():
    missing = [c for c in COMMANDS if not hasattr(CrispyApp, c)]
    assert not missing, f"whitelisted commands without methods: {missing}"


@pytest.mark.parametrize("name", ["index.html", "tray.html", "result.html"])
def test_pages_contract_matches_server(name):
    """Commands called and bus events listened to by every served page exist
    in the whitelist and the event catalog."""
    page = (WEBUI_DIR / name).read_text(encoding="utf-8")
    for cmd in set(re.findall(r'api\("([a-z_]+)"', page)):
        assert cmd in COMMANDS, f"{name} calls unknown command {cmd}"
    # index.html adds listeners only to its EventSource; the other pages
    # also to window events
    pattern = r'addEventListener\("([a-z-]+)"' if name == "index.html" else \
        r'es\.addEventListener\("([a-z-]+)"'
    for ev in set(re.findall(pattern, page)):
        assert ev in SSE_EVENTS, f"{name} listens to unbridged event {ev}"


def test_ui_page_reads_emitted_fields():
    page = (WEBUI_DIR / "index.html").read_text(encoding="utf-8")
    assert '"level"' in page or "p.level" in page or ".level" in page
    assert "p.downloaded" in page and "p.percentage" in page
    assert "p.recording_path" in page and "p.progress" in page


def test_ui_surfaces_device_autostart_permissions():
    page = (WEBUI_DIR / "index.html").read_text(encoding="utf-8")
    assert 'id="out-device"' in page
    assert "output_device_name" in page
    assert 'api("get_output_devices")' in page
    assert 'id="autostart"' in page
    assert 'api("set_autostart"' in page
    assert "autostart_enabled" in page
    assert 'api("check_permissions")' in page
    assert 'api("request_permission"' in page


# -- the cases of tests/test_web_server.py on the port -----------------------------

def test_static_page_and_api_dispatch(served):
    app, srv = served
    with _get(srv, "/") as r:
        page = r.read().decode()
    assert "Crispy" in page and "/events" in page and "/shared.js" in page
    with _get(srv, "/shared.js") as r:
        assert "/api/" in r.read().decode()
    models = _api(srv, "get_available_models")
    assert isinstance(models, list) and len(models) >= 13
    assert _api(srv, "get_platform") in ("linux", "macos", "windows")
    _api(srv, "set_app_setting", {"key": "diarization_enabled", "value": "true"})
    assert _api(srv, "get_app_settings")["diarization_enabled"] == "true"


def test_cross_site_requests_refused(served):
    _app, srv = served
    url = f"http://127.0.0.1:{srv.port}"
    req = urllib.request.Request(f"{url}/api/get_platform", data=b"{}", method="POST",
                                 headers={"Content-Type": "application/json",
                                          "Host": "evil.example:80"})
    assert _status(urllib.request.urlopen, req, timeout=10) == 403
    assert _status(_api, srv, "get_platform", headers={"Origin": "http://evil.example"}) == 403
    req = urllib.request.Request(f"{url}/api/stop_recording", data=b"{}", method="POST",
                                 headers={"Content-Type": "text/plain"})
    assert _status(urllib.request.urlopen, req, timeout=10) == 415
    assert _status(_get, srv, "/api/get_platform") == 404
    assert _api(srv, "get_platform", headers={"Origin": f"http://127.0.0.1:{srv.port}"})


def test_api_unknown_and_bad_args(served):
    _app, srv = served
    assert _status(_api, srv, "quit_app") == 404
    assert _status(_api, srv, "set_active_model", {"bogus_kw": 1}) == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _api(srv, "start_transcription", {"recording_path": "/nope.wav"})
    assert e.value.code == 500
    assert "error" in json.loads(e.value.read())


def test_stream_range_confinement(served):
    _app, srv = served
    rec_dir = paths.ensure_dir(paths.recordings_dir())
    p = rec_dir / "clip.wav"
    wavio.write_wav(p, np.zeros(4800, np.float32), 48000)
    size = p.stat().st_size
    with _get(srv, f"/stream?path={p}") as r:
        assert r.status == 200 and len(r.read()) == size
    with _get(srv, f"/stream?path={p}", {"Range": "bytes=4-19"}) as r:
        assert r.status == 206
        assert r.headers["Content-Range"] == f"bytes 4-19/{size}"
        assert r.read() == p.read_bytes()[4:20]
    assert _status(_get, srv, "/stream?path=/etc/hostname") in (403, 404)


def sse_reader(port, got, until):
    """Read /events into ``got`` (event -> payload) until ``until`` arrives."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}/events")
    with urllib.request.urlopen(req, timeout=10) as r:
        event = None
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("event:"):
                event = line[6:].strip()
            elif line.startswith("data:") and event:
                got[event] = json.loads(line[5:])
                if event == until:
                    return


def wait_subscribed(bus, event="microphone-level", timeout=10.0):
    deadline = time.time() + timeout
    while not bus._listeners.get(event) and time.time() < deadline:
        time.sleep(0.01)
    assert bus._listeners.get(event), "the SSE client did not subscribe"


def test_sse_bridge_delivers_bus_events(served):
    app, srv = served
    got = {}
    t = threading.Thread(target=sse_reader, args=(srv.port, got, "transcription-progress"),
                         daemon=True)
    t.start()
    wait_subscribed(app.bus)
    app.bus.emit("microphone-level", 0.5)
    app.bus.emit("transcription-progress",
                 {"recording_path": "/r.wav", "progress": 0.25, "eta_seconds": 9})
    t.join(timeout=10)
    assert got.get("microphone-level") == 0.5
    assert got.get("transcription-progress", {}).get("progress") == 0.25


def test_sse_never_blocks_the_emitter(served, monkeypatch):
    """A client whose handler takes nothing off its queue (a slow client):
    the queue fills to its bound, later events are dropped, and every emit
    returns at once (the monitoring loop is the emitter of levels)."""
    import queue

    app, srv = served
    made, release = [], threading.Event()

    class Stalled(queue.Queue):
        def __init__(self, maxsize=0):
            super().__init__(maxsize)
            made.append(self)

        def get(self, block=True, timeout=None):
            release.wait(30)
            return super().get(block, timeout)

    monkeypatch.setattr(queue, "Queue", Stalled)
    conn = urllib.request.urlopen(
        urllib.request.Request(f"http://127.0.0.1:{srv.port}/events"), timeout=10)
    try:
        wait_subscribed(app.bus)
        q = made[0]
        t0 = time.perf_counter()
        for i in range(q.maxsize + 500):
            app.bus.emit("microphone-level", float(i))
        dt = time.perf_counter() - t0
        assert q.maxsize == 1024 and q.qsize() == q.maxsize
        assert dt < 5.0
    finally:
        release.set()
        conn.close()


def test_window_router_pages(served):
    _app, srv = served
    with _get(srv, "/tray") as r:
        tray = r.read().decode()
    assert "start_recording" in tray and "notify_tray_popup_shown" in tray
    with _get(srv, "/result?path=/tmp/x.wav") as r:
        res = r.read().decode()
    assert "get_transcription_result" in res and "stream_transcription_chat" in res
    with _get(srv, "/shared.js") as r:
        assert "Speaker" in r.read().decode()


def test_window_state_commands(served):
    app, srv = served
    _api(srv, "notify_tray_popup_shown")
    assert _api(srv, "get_window_state")["tray_popup_visible"] is True
    assert _api(srv, "notify_tray_popup_blurred") is False
    assert _api(srv, "get_window_state")["tray_popup_visible"] is True
    app.windows._tray_shown_at -= 1.0  # age past the grace window
    assert _api(srv, "notify_tray_popup_blurred") is True
    assert _api(srv, "get_window_state")["tray_popup_visible"] is False


def _upload(port, name, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/upload?name={urllib.parse.quote(name)}",
        data=body, method="POST", headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def test_upload_saves_confined_and_unique(served):
    _app, srv = served
    data = b"RIFFfakebytes" * 100
    p1 = Path(_upload(srv.port, "clip.mp4", data)["path"])
    assert p1.parent == paths.crispy_root() / "Uploads"
    assert p1.read_bytes() == data
    p2 = Path(_upload(srv.port, "clip.mp4", data)["path"])
    assert p2 != p1 and p2.exists()
    p3 = Path(_upload(srv.port, "../../../evil.mp4", data)["path"])
    assert p3.parent == paths.crispy_root() / "Uploads" and p3.name.startswith("evil")
    assert _status(_upload, srv.port, "x.mp4", b"") == 413


def test_stop_releases_the_port(data_root):
    srv = WebServer(CrispyApp(bus=EventBus(), device="cpu")).start()
    port = srv.port
    srv.stop()
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=5)


# -- one request sequence, JAX server against the port's -------------------------

def request(port, method, path, body=None, headers=None):
    """(status, reply) of one request: JSON bodies parsed, other bodies as
    bytes, and the Content-Type, Content-Range and Content-Length headers."""
    hdrs = dict(headers or {})
    if method == "POST" and "Content-Type" not in hdrs:
        hdrs["Content-Type"] = "application/json"
    data = json.dumps(body).encode() if isinstance(body, (dict, list)) else body
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers=hdrs)
    try:
        r = urllib.request.urlopen(req, timeout=10)
    except urllib.error.HTTPError as e:
        r = e
    with r:
        raw = r.read()
        ctype = r.headers.get("Content-Type") or ""
        reply = json.loads(raw) if ctype.startswith("application/json") else raw
        return (r.status if hasattr(r, "status") else r.code,
                {k: r.headers.get(k) for k in ("Content-Type", "Content-Range",
                                               "Content-Length")},
                reply)


def normalised(obj, root: Path, port: int):
    s = json.dumps(obj, default=lambda b: b.decode("latin-1"), sort_keys=True)
    return json.loads(s.replace(str(root), "<root>").replace(str(port), "<port>"))


def session(port, app, root: Path) -> list:
    """The sequence: pages, boundary refusals, settings and model selection,
    window state, recordings and Range reads (a 416 among them), uploads with
    name collisions, and one bridged bus event."""
    out = []

    def r(method, path, body=None, headers=None):
        out.append((method, path, request(port, method, path, body, headers)))

    for page in ("/", "/index.html", "/tray", "/result?path=/tmp/x.wav", "/shared.js",
                 "/nope", "/api/get_platform"):
        r("GET", page)
    r("POST", "/api/get_platform", {}, {"Host": "evil.example:80"})
    r("POST", "/api/get_platform", {}, {"Origin": "http://evil.example"})
    r("POST", "/api/get_platform", {}, {"Origin": f"http://localhost:{port}"})
    r("POST", "/api/stop_recording", b"{}", {"Content-Type": "text/plain"})
    r("POST", "/api/quit_app", {})
    r("POST", "/api/set_active_model", {"bogus_kw": 1})
    r("POST", "/api/get_app_settings", b"{not json")
    r("POST", "/api/get_app_settings", [1, 2])
    r("POST", "/other", {})
    r("POST", "/api/start_transcription", {"recording_path": "/nope.wav"})
    for cmd, body in (("get_app_settings", {}),
                      ("set_app_setting", {"key": "diarization_enabled", "value": "true"}),
                      ("set_app_setting", {"key": "no_such_key", "value": "1"}),
                      ("get_app_settings", {}), ("get_available_models", {}),
                      ("get_available_ns_models", {}), ("get_model_info", {"model_id": "small"}),
                      ("set_active_model", {"model_id": "small"}), ("get_current_model", {}),
                      ("set_llm_settings", {"endpoint": "http://localhost:9/v1", "api_key": "k",
                                            "model": "m"}),
                      ("get_llm_settings", {}), ("get_recordings_dir_path", {}),
                      ("is_recording", {}), ("check_permissions", {}),
                      ("get_recordable_apps", {}),
                      ("notify_tray_popup_shown", {}), ("get_window_state", {}),
                      ("notify_tray_popup_blurred", {}), ("get_window_state", {}),
                      ("show_main_window_cmd", {}), ("get_window_state", {}),
                      ("get_all_transcription_states", {})):
        r("POST", f"/api/{cmd}", body)

    rec = paths.ensure_dir(root / "Recordings")
    pcm = (np.random.default_rng(0).uniform(-0.5, 0.5, (4800, 2)) * 32767).astype(np.int16)
    clip = wavio.write_wav(rec / "clip.wav", pcm, 48000)
    os.utime(clip, (1_700_000_000, 1_700_000_000))
    r("POST", "/api/get_recordings", {})
    q = urllib.parse.quote(str(clip))
    for rng in (None, "bytes=4-19", "bytes=-10", "bytes=100-", "bytes=0-99999999",
                "bytes=999999-", "bytes=a-b"):
        r("GET", f"/stream?path={q}", headers={"Range": rng} if rng else None)
    for bad in ("/stream?path=/etc/hostname", "/stream", f"/stream?path={q}.missing"):
        r("GET", bad)
    renamed = str(rec / "renamed.wav")
    r("POST", "/api/rename_recording", {"path": str(clip), "new_name": "renamed"})
    r("POST", "/api/delete_recording", {"path": renamed})
    r("POST", "/api/get_recordings", {})

    data = b"RIFFfakebytes" * 100
    for name, body in (("clip.mp4", data), ("clip.mp4", data), ("clip (1).mp4", data),
                       ("../../../evil.mp4", data), ("x.mp4", b"")):
        r("POST", f"/upload?name={urllib.parse.quote(name)}", body,
          {"Content-Type": "application/octet-stream"})
    out.append(("uploads", sorted(p.name for p in (root / "Uploads").iterdir())))

    got = {}
    t = threading.Thread(target=sse_reader, args=(port, got, "transcription-progress"),
                         daemon=True)
    t.start()
    wait_subscribed(app.bus)
    app.bus.emit("microphone-level", 0.5)
    app.bus.emit("transcription-progress",
                 {"recording_path": "/r.wav", "progress": 0.25, "eta_seconds": 9})
    t.join(timeout=10)
    out.append(("sse", got))
    return out


def test_same_replies_as_jax(tmp_path, monkeypatch):
    runs = []
    for name, make in (("jax", lambda: JApp(bus=JBus())),
                       ("port", lambda: CrispyApp(bus=EventBus(), device="cpu"))):
        root = tmp_path / f"{name:4}".replace(" ", "_") / "Crispy"  # equal lengths
        monkeypatch.setenv("CRISPY_DATA_DIR", str(root))
        app = make()
        srv = (jws.WebServer if name == "jax" else WebServer)(app, port=0).start()
        try:
            runs.append(normalised(session(srv.port, app, root), root, srv.port))
        finally:
            srv.stop()
    jax_run, port_run = runs
    assert len(port_run) == len(jax_run)
    for want, got in zip(jax_run, port_run):
        assert got == want
    statuses = [step[2][0] for step in port_run if len(step) == 3]
    for code in (200, 206, 400, 403, 404, 413, 415, 416, 500):
        assert code in statuses
    assert port_run[-1] == ["sse", {"microphone-level": 0.5, "transcription-progress": {
        "recording_path": "/r.wav", "progress": 0.25, "eta_seconds": 9}}]


# -- the kernel library under concurrent first uses -----------------------------

def test_load_builds_and_binds_once(monkeypatch, tmp_path):
    calls = {"build": 0, "cdll": 0}
    gate = threading.Barrier(8)

    def build():
        calls["build"] += 1
        time.sleep(0.05)  # a slow build: the other threads arrive meanwhile
        return tmp_path / "lib.so"

    class FakeLib:
        def __init__(self, path):
            calls["cdll"] += 1

        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            self.__dict__[name] = fn
            return fn

    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    libs = []

    def first_use():
        gate.wait()
        libs.append(_build.load())

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert calls == {"build": 1, "cdll": 1}
    assert len(libs) == 8 and all(lib is libs[0] for lib in libs)
    assert set(_build._SIGNATURES) <= set(vars(libs[0]))


# -- cli serve in its own process --------------------------------------------------

def test_cli_serve_without_a_card(tmp_path):
    env = {**os.environ, "CRISPY_DATA_DIR": str(tmp_path / "Crispy"), "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen([sys.executable, "-m", "crispy_tpu_torch.cli", "serve", "--port", "0"],
                            cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = []
        reader = threading.Thread(target=lambda: line.append(proc.stdout.readline()),
                                  daemon=True)
        reader.start()
        reader.join(timeout=120)
        assert line and line[0], f"no JSON line from serve: {proc.poll()}"
        info = json.loads(line[0])
        assert info["recordings"] == str(tmp_path / "Crispy" / "Recordings")
        port = int(urllib.parse.urlparse(info["url"]).port)
        assert info["url"] == f"http://127.0.0.1:{port}/"
        status, _, page = request(port, "GET", "/")
        assert status == 200 and page == (WEBUI_DIR / "index.html").read_bytes()
        status, _, models = request(port, "POST", "/api/get_available_models", {})
        assert status == 200 and len(models) >= 13
        status, _, err = request(port, "POST", "/api/start_monitoring", {"model_name": "rnnoise"})
        assert status == 500 and "no CUDA device" in err["error"]
        proc.send_signal(signal.SIGINT)  # Ctrl-C, as a user stops the server
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
