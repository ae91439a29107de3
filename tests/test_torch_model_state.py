"""The port's model-state tracker (crispy_tpu_torch.api.model_state) held
against the JAX package's: the same event streams give the same snapshots,
including the download-speed EMA, and the port's downloader drives it."""

import http.server
import threading

import numpy as np
import pytest

from crispy_tpu.api.events import EventBus as JBus
from crispy_tpu.api.model_state import ModelStateTracker as JTracker
from crispy_tpu_torch.api.events import EventBus
from crispy_tpu_torch.api.model_state import EVENTS, ModelStateTracker


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


MB = 1 << 20


def prog(mid, d, total=100 * MB):
    return ("model-download-progress",
            {"model_id": mid, "downloaded": d, "total": total, "percentage": 100.0 * d / total})


def state(et, mid, err=None):
    return ("model-state-changed", {"event_type": et, "model_id": mid, "model_name": None,
                                    "error": err})


SCRIPTS = {
    "ema": [prog("m", 0), ("tick", 0.3), prog("m", 10 * MB), ("tick", 1.0), prog("m", 10 * MB),
            ("tick", 1.0), prog("m", 30 * MB), ("tick", 0.7), prog("m", 31 * MB)],
    "extract": [prog("m", 5, 10), ("model-extraction-started", {"model_id": "m"}),
                ("model-extraction-completed", {"model_id": "m"})],
    "extract-bare-ids": [prog("m", 5, 10), ("model-extraction-started", "m"),
                         ("model-extraction-failed", {"model_id": "m", "error": "corrupt tar"})],
    "error-clears": [prog("m", 1, 10), state("error", "m", "network gone")],
    "select-delete": [state("loading_started", "small"), state("loading_completed", "small"),
                      state("deleted", "small"), state("unloaded", None)],
    "two-downloads": [prog("a", MB, 4 * MB), prog("b", MB, 4 * MB),
                      ("model-download-complete", {"model_id": "a"}),
                      ("model-download-complete", "b")],
}


def test_same_events_tracked():
    from crispy_tpu.api import model_state as jms

    assert EVENTS == jms.EVENTS


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_same_events_same_snapshots(name):
    snaps = []
    for tracker_cls, bus_cls in ((JTracker, JBus), (ModelStateTracker, EventBus)):
        bus, clock = bus_cls(), Clock()
        tr = tracker_cls(bus=bus, clock=clock)
        seen = []
        for ev, payload in SCRIPTS[name]:
            if ev == "tick":
                clock.t += payload
                continue
            bus.emit(ev, payload)
            seen.append(tr.snapshot())
        tr.close()
        bus.emit(*prog("m", 99))  # detached: no change
        seen.append(tr.snapshot())
        snaps.append(seen)
    assert snaps[0] == snaps[1]


def test_download_speed_ema_smoothing():
    bus, clock = EventBus(), Clock()
    tr = ModelStateTracker(bus=bus, clock=clock)
    bus.emit(*prog("m", 0))
    clock.t += 1.3
    bus.emit(*prog("m", 10 * MB))
    s1 = tr.snapshot()["models"]["m"]["speed_mbps"]
    assert abs(s1 - 10 / 1.3) < 0.01
    clock.t += 1.0
    bus.emit(*prog("m", 30 * MB))
    assert abs(tr.snapshot()["models"]["m"]["speed_mbps"] - (0.8 * s1 + 0.2 * 20.0)) < 0.01


def test_real_downloader_drives_tracker(data_root):
    """The port's ModelManager event stream over loopback HTTP."""
    from crispy_tpu_torch.models.registry import ModelManager

    payload = np.random.default_rng(0).bytes(1 << 16)

    class H(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

    srv = http.server.HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        bus = EventBus()
        tr = ModelStateTracker(bus=bus)
        mm = ModelManager(bus=bus)
        info = mm.find("small")
        old_url = info.url
        info.url = f"http://127.0.0.1:{srv.server_address[1]}/f.bin"
        try:
            mm.download_model("small")
        finally:
            info.url = old_url
        snap = tr.snapshot()
        assert mm.is_downloaded("small")
        assert snap["status"] in ("unloaded", "ready")  # transient state drained
        assert snap["models"] == {}
    finally:
        srv.shutdown()
