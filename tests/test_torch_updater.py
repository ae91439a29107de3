"""The port's updater analog (crispy_tpu_torch.utils.updater) held against
the JAX package's, against a local stand-in for the package index (no
network): the same version ordering and the same status dicts, through the
module, the app command and ``cli update``."""

import http.server
import json
import threading

import pytest

import crispy_tpu_torch
from crispy_tpu.utils import updater as jup
from crispy_tpu_torch.utils import updater

VERSIONS = ["0.1.0", "0.2.0", "0.10.0", "0.9.9", "1.0.0", "0.99.1", "0.1.0rc1", "0.1.0.dev2",
            "0.1.0a1", "0.1.0b3", "0.1.0.post1", "v0.2", "0.2.0-rc.2", "0.1.0+local", "junk"]


def test_version_key_matches_jax():
    for a in VERSIONS:
        assert updater._version_key(a) == jup._version_key(a), a
    assert sorted(VERSIONS, key=updater._version_key) == sorted(VERSIONS, key=jup._version_key)
    assert updater._version_key("0.1.0rc1") < updater._version_key("0.1.0")


def test_current_version_is_the_ports():
    assert updater.current_version() == crispy_tpu_torch.__version__ == jup.current_version()
    assert updater.UPDATE_COMMAND == jup.UPDATE_COMMAND


def test_offline_reports_offline():
    url = "http://127.0.0.1:1/nope"  # a closed local port
    out = updater.check_for_updates(timeout=0.5, index_url=url)
    assert out == jup.check_for_updates(timeout=0.5, index_url=url)
    assert out["status"] == "offline"
    assert out["update_command"] == "pip install --upgrade crispy-tpu"


@pytest.fixture
def index_server(monkeypatch):
    """Local stand-in for the package index JSON endpoint; both packages'
    default index URL points at it."""
    state = {"version": "0.1.0"}

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps({"info": {"version": state["version"]}}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/json"
    monkeypatch.setattr(updater, "INDEX_URL", url)
    monkeypatch.setattr(jup, "INDEX_URL", url)
    yield state
    srv.shutdown()


@pytest.mark.parametrize("latest,status", [("0.1.0", "up-to-date"), ("99.0.0", "update-available"),
                                           ("0.0.9", "up-to-date")])
def test_index_answers_match_jax(index_server, latest, status):
    index_server["version"] = latest
    out = updater.check_for_updates()
    assert out == jup.check_for_updates()
    assert out["status"] == status and out["latest_version"] == latest


def test_command_and_cli_surface(data_root, index_server, capsys):
    from crispy_tpu_torch.api.commands import CrispyApp
    from crispy_tpu_torch.api.events import EventBus
    from crispy_tpu_torch.cli import main

    index_server["version"] = "99.0.0"
    app = CrispyApp(bus=EventBus())  # no card needed
    assert app.get_app_version() == updater.current_version()
    assert app.check_for_updates()["status"] == "update-available"
    assert main(["update"]) == 0
    parsed = json.loads(capsys.readouterr().out.strip())
    assert parsed == jup.check_for_updates()
