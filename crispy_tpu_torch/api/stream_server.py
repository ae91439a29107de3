"""Media streaming endpoint: the `stream://` asset protocol as HTTP.

The port's copy of ``crispy_tpu/api/stream_server.py``.

The reference registers a custom `stream://localhost/<path>` URI scheme
serving WAV files with HTTP Range (206) support for its audio player
(src-tauri/src/main.rs:47-218). On a server the same surface is a loopback
HTTP endpoint confined to the recordings directory, with the identical
Range grammar (standard, open-ended, suffix, clamped, rejects).
"""

from __future__ import annotations

import threading
import urllib.parse
from functools import partial
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional, Tuple

from ..utils import paths


def parse_range(header: str, file_size: int) -> Optional[Tuple[int, int]]:
    """The reference's Range grammar, byte for byte (main.rs:47-78)."""
    header = header.strip()
    if not header.startswith("bytes="):
        return None
    spec = header[6:]
    parts = spec.split("-", 1)
    if len(parts) != 2:
        return None
    start_str, end_str = parts[0].strip(), parts[1].strip()
    if file_size == 0:
        return None
    if start_str == "":
        try:
            suffix = int(end_str)
        except ValueError:
            return None
        if suffix < 0:
            return None
        return max(file_size - suffix, 0), file_size - 1
    try:
        start = int(start_str)
    except ValueError:
        return None
    if start < 0 or start >= file_size:
        return None
    if end_str == "":
        end = file_size - 1
    else:
        try:
            end = int(end_str)
        except ValueError:
            return None
    return start, min(end, file_size - 1)


class _Handler(BaseHTTPRequestHandler):
    root: Path

    def log_message(self, *a):  # quiet
        pass

    def do_GET(self):
        rel = urllib.parse.unquote(self.path.lstrip("/"))
        target = (self.root / rel).resolve()
        root = self.root.resolve()
        if root != target and root not in target.parents:
            self.send_error(403)
            return
        if not target.is_file():
            self.send_error(404)
            return
        size = target.stat().st_size
        rng_header = self.headers.get("Range")
        ctype = "audio/wav" if target.suffix == ".wav" else "application/octet-stream"
        if rng_header:
            rng = parse_range(rng_header, size)
            if rng is None:
                self.send_response(416)
                self.send_header("Content-Range", f"bytes */{size}")
                self.end_headers()
                return
            start, end = rng
            self.send_response(206)
            self.send_header("Content-Type", ctype)
            self.send_header("Accept-Ranges", "bytes")
            self.send_header("Content-Range", f"bytes {start}-{end}/{size}")
            self.send_header("Content-Length", str(end - start + 1))
            self.end_headers()
            with open(target, "rb") as f:
                f.seek(start)
                self.wfile.write(f.read(end - start + 1))
        else:
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Accept-Ranges", "bytes")
            self.send_header("Content-Length", str(size))
            self.end_headers()
            with open(target, "rb") as f:
                self.wfile.write(f.read())


class StreamServer:
    """Loopback range-capable file server over the recordings dir."""

    def __init__(self, root: Optional[Path] = None, port: int = 0):
        self.root = Path(root) if root else paths.recordings_dir()
        handler = type("Bound", (_Handler,), {"root": self.root})
        self._srv = ThreadingHTTPServer(("127.0.0.1", port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._srv.server_port

    def url_for(self, path) -> str:
        rel = Path(path).resolve().relative_to(self.root.resolve())
        return f"http://127.0.0.1:{self.port}/{urllib.parse.quote(str(rel))}"

    def start(self) -> "StreamServer":
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
