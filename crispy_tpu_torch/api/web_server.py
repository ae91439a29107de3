"""Web UI server: the product surface over the command API + event bus.

The port's copy of ``crispy_tpu/api/web_server.py``, over the port's
``CrispyApp``, event bus and data root.

The reference's UI is a Tauri webview (src/App.tsx, src/components/*)
talking to the backend over `invoke` + `listen` + the stream:// asset
protocol. Here the same three channels are HTTP on loopback:

  GET  /                 the main window (webui/index.html)
  GET  /tray             the tray-popup window (webui/tray.html)
  GET  /result?path=...  the transcription-result window (webui/result.html)
  GET  /shared.js        helpers shared by every window (api/esc/grammar)
  POST /api/<command>    invoke: JSON body = kwargs, JSON reply
  GET  /events           listen: Server-Sent Events bridge of the bus
  GET  /stream?path=...  stream://: Range-capable WAV serving (206)

The three GET pages are the window router (src/main.tsx:10-31 routes by
Tauri window label → App / TrayPopupView / TranscriptionResultView; here
the URL path is the label).

``python -m crispy_tpu_torch.cli serve`` starts this; the command names are
the reference's invoke_handler names (main.rs:372-425) as carried by
CrispyApp. A command runs in its request's thread: the first one that needs
an engine builds it on the card there (and raises, as a 500, without one).
A bus callback runs in the emitter's thread, for ``microphone-level`` the
monitoring loop's, so the SSE bridge only ever does a non-blocking put.
"""

from __future__ import annotations

import inspect
import json
import queue
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

from .stream_server import parse_range
from ..utils import paths

WEBUI_DIR = Path(__file__).resolve().parent / "webui"

# Commands exposed over /api — the CrispyApp surface minus process control
# (quit_app) and desktop shell-opens.
COMMANDS = [
    "get_platform", "get_input_devices", "get_output_devices",
    "get_default_devices", "start_monitoring", "stop_monitoring",
    "set_monitoring_volume", "set_monitoring_model",
    "get_system_input_volume", "set_system_input_volume",
    "get_blackhole_status", "get_recordable_apps", "start_recording",
    "stop_recording", "is_recording", "get_recordings_dir_path",
    "get_recordings", "rename_recording", "delete_recording",
    "get_available_models", "get_available_ns_models", "get_model_info",
    "download_model", "delete_model", "set_active_model",
    "get_current_model", "cancel_download", "get_recommended_first_model",
    "start_transcription", "get_transcription_result",
    "has_transcription_result", "get_transcription_model",
    "get_transcription_state", "get_all_transcription_states",
    "cancel_transcription", "stream_transcription_chat",
    "get_transcription_chat_history", "set_transcription_chat_history",
    "get_llm_settings", "set_llm_settings", "get_app_settings",
    "set_app_setting", "set_autostart", "convert_to_wav", "check_ffmpeg",
    "check_permissions", "request_permission",
    "show_main_window_cmd", "open_transcription_window", "get_window_state",
    "notify_tray_popup_shown", "notify_tray_popup_blurred",
    "get_app_version", "check_for_updates",
]

# Every event the backend emits (SURVEY §5 observability catalog).
SSE_EVENTS = [
    "microphone-level", "stage-timing", "model-download-progress",
    "model-download-complete", "model-extraction-started",
    "model-extraction-completed", "model-extraction-failed",
    "model-state-changed",
    "transcription-status", "transcription-phase", "transcription-progress",
    "transcription-open", "transcription-chat-stream",
    "transcription-chat-done", "transcription-chat-error",
    "diarization-fallback", "window-state",
]


class _Handler(BaseHTTPRequestHandler):
    server_ref: "WebServer"
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):  # quiet
        pass

    # -- helpers ---------------------------------------------------------
    def _json(self, obj, status: int = 200):
        body = json.dumps(obj, ensure_ascii=False, default=_jsonable).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # -- request authentication (loopback hardening) ---------------------
    def _check_browser_boundaries(self, api: bool = False) -> bool:
        """Reject cross-site requests: a malicious web page can make the
        browser POST to 127.0.0.1 (CSRF) and DNS rebinding lets it read
        responses. Host must be our own loopback origin; an Origin header,
        when a browser sends one, must match; /api additionally requires
        Content-Type: application/json (no-cors requests can't set it)."""
        port = self.server_ref.port
        host = (self.headers.get("Host") or "").strip().lower()
        allowed = {f"127.0.0.1:{port}", f"localhost:{port}",
                   f"[::1]:{port}"}
        if host not in allowed:
            self.send_error(403, "bad Host")
            return False
        origin = self.headers.get("Origin")
        if origin and origin.rstrip("/").lower() not in {
                f"http://{h}" for h in allowed}:
            self.send_error(403, "cross-origin request refused")
            return False
        if api:
            ctype = (self.headers.get("Content-Type") or "").split(";")[0]
            if ctype.strip().lower() != "application/json":
                self._json({"error": "Content-Type must be application/json"},
                           415)
                return False
        return True

    # -- routes ----------------------------------------------------------
    def do_GET(self):
        if not self._check_browser_boundaries():
            return
        parsed = urllib.parse.urlparse(self.path)
        route = parsed.path
        if route in ("/", "/index.html"):
            return self._static("index.html", "text/html; charset=utf-8")
        if route == "/tray":
            return self._static("tray.html", "text/html; charset=utf-8")
        if route == "/result":
            return self._static("result.html", "text/html; charset=utf-8")
        if route == "/shared.js":
            return self._static("shared.js", "application/javascript; charset=utf-8")
        if route == "/events":
            return self._sse()
        if route == "/stream":
            q = urllib.parse.parse_qs(parsed.query)
            return self._stream((q.get("path") or [""])[0])
        # /api is POST-only: GET side effects would be one <img src> away
        self.send_error(404)

    MAX_UPLOAD = 2 << 30  # 2 GiB: above the largest catalog media plausibly dropped

    def do_POST(self):
        parsed = urllib.parse.urlparse(self.path)
        if parsed.path == "/upload":
            # drag-drop convert (F10, ConvertView.tsx drag handler): the
            # browser holds bytes, not a path, so the served UI uploads the
            # dropped media here and then invokes convert_to_wav on the
            # saved path. Octet-stream body; name comes from the query and
            # is reduced to a safe basename (no traversal).
            if not self._check_browser_boundaries():
                return
            n = int(self.headers.get("Content-Length") or 0)
            if n <= 0 or n > self.MAX_UPLOAD:
                return self._json({"error": "bad upload size"}, 413)
            q = urllib.parse.parse_qs(parsed.query)
            raw_name = (q.get("name") or ["upload.bin"])[0]
            name = Path(raw_name).name.replace("\x00", "") or "upload.bin"
            updir = paths.crispy_root() / "Uploads"
            paths.ensure_dir(updir)
            target = updir / name
            i = 1
            while target.exists():
                target = updir / f"{target.stem.split(' (')[0]} ({i}){target.suffix}"
                i += 1
            remaining = n
            with open(target, "wb") as f:
                while remaining:
                    chunk = self.rfile.read(min(1 << 20, remaining))
                    if not chunk:
                        break
                    f.write(chunk)
                    remaining -= len(chunk)
            if remaining:
                target.unlink(missing_ok=True)
                return self._json({"error": "truncated upload"}, 400)
            return self._json({"path": str(target)})
        if not self._check_browser_boundaries(api=True):
            return
        if parsed.path.startswith("/api/"):
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n else b""
            try:
                kwargs = json.loads(raw) if raw else {}
            except ValueError:
                return self._json({"error": "invalid JSON body"}, 400)
            if not isinstance(kwargs, dict):
                return self._json({"error": "body must be a JSON object"}, 400)
            return self._api(parsed.path[5:], kwargs)
        self.send_error(404)

    def _static(self, name: str, ctype: str):
        f = WEBUI_DIR / name
        if not f.is_file():
            self.send_error(404)
            return
        body = f.read_bytes()
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _api(self, name: str, kwargs: dict):
        app = self.server_ref.app
        if name not in COMMANDS:
            return self._json({"error": f"unknown command '{name}'"}, 404)
        method = getattr(app, name)
        try:
            # Bind first so only genuinely bad kwargs map to 400; a
            # TypeError raised *inside* a command is an internal error.
            inspect.signature(method).bind(**kwargs)
        except TypeError as e:
            return self._json({"error": str(e)}, 400)
        try:
            result = method(**kwargs)
        except Exception as e:  # command errors come back as the reference's
            return self._json({"error": str(e)}, 500)  # Result<_, String>
        if isinstance(result, threading.Thread):
            result = {"started": True}
        elif result is None:
            result = {"ok": True}
        return self._json(result)

    def _stream(self, path_str: str):
        """Range-capable file serving confined to the recordings dir (the
        stream:// protocol, main.rs:47-218)."""
        root = paths.recordings_dir().resolve()
        target = Path(path_str).resolve() if path_str else None
        if (target is None or not target.is_file()
                or (root != target and root not in target.parents)):
            self.send_error(404 if target and target.is_file() is False else 403)
            return
        size = target.stat().st_size
        ctype = "audio/wav" if target.suffix == ".wav" else "application/octet-stream"
        rng_header = self.headers.get("Range")
        if rng_header:
            rng = parse_range(rng_header, size)
            if rng is None:
                self.send_response(416)
                self.send_header("Content-Range", f"bytes */{size}")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            start, end = rng
            self.send_response(206)
            self.send_header("Content-Type", ctype)
            self.send_header("Accept-Ranges", "bytes")
            self.send_header("Content-Range", f"bytes {start}-{end}/{size}")
            self.send_header("Content-Length", str(end - start + 1))
            self.end_headers()
            self._copy_range(target, start, end - start + 1)
        else:
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Accept-Ranges", "bytes")
            self.send_header("Content-Length", str(size))
            self.end_headers()
            self._copy_range(target, 0, size)

    def _copy_range(self, target: Path, start: int, count: int,
                    chunk: int = 1 << 20) -> None:
        """Stream file bytes in fixed-size chunks (a multi-GB WAV must not
        be materialized as one bytes object per request)."""
        with open(target, "rb") as f:
            f.seek(start)
            remaining = count
            while remaining > 0:
                buf = f.read(min(chunk, remaining))
                if not buf:
                    break
                self.wfile.write(buf)
                remaining -= len(buf)

    def _sse(self):
        """Event-bus → Server-Sent Events bridge; one queue per client."""
        bus = self.server_ref.app.bus
        q: "queue.Queue" = queue.Queue(maxsize=1024)
        unlisteners = []

        def subscribe(name):
            def cb(payload):
                try:
                    q.put_nowait((name, payload))
                except queue.Full:
                    pass  # slow client: drop rather than block the emitter
            unlisteners.append(bus.listen(name, cb))

        for name in SSE_EVENTS:
            subscribe(name)
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-store")
        self.send_header("Connection", "close")
        self.end_headers()
        try:
            self.wfile.write(b"retry: 2000\n\n")
            self.wfile.flush()
            while not self.server_ref.closed:
                try:
                    name, payload = q.get(timeout=10.0)
                except queue.Empty:
                    self.wfile.write(b": keepalive\n\n")
                    self.wfile.flush()
                    continue
                data = json.dumps(payload, ensure_ascii=False,
                                  default=_jsonable)
                msg = f"event: {name}\ndata: {data}\n\n".encode()
                self.wfile.write(msg)
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            for un in unlisteners:
                un()


def _jsonable(o):
    try:
        return dict(o)
    except Exception:
        return str(o)


class WebServer:
    """Loopback product surface: UI + /api + /events + /stream."""

    def __init__(self, app, port: int = 0, host: str = "127.0.0.1"):
        self.app = app
        self.closed = False
        handler = type("Bound", (_Handler,), {"server_ref": self})
        self._srv = ThreadingHTTPServer((host, port), handler)
        self._srv.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._srv.server_port

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/"

    def start(self) -> "WebServer":
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.closed = True
        self._srv.shutdown()
        self._srv.server_close()
