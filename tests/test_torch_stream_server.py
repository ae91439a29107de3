"""The port's stream:// analog (crispy_tpu_torch.api.stream_server) held
against the JAX package's: the reference's Range grammar cases, parse_range
equal to JAX's over a grid of headers and sizes (malformed ones included),
and the serving endpoint, whose replies equal the JAX server's on the same
files."""

import urllib.error
import urllib.request

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from crispy_tpu.api import stream_server as jss
from crispy_tpu_torch.api.stream_server import StreamServer, parse_range
from crispy_tpu_torch.io import wav as wavio

GRAMMAR = [
    ("bytes=0-1023", 10000, (0, 1023)),        # standard
    ("bytes=0-9999", 10000, (0, 9999)),        # from start to end
    ("bytes=500-", 10000, (500, 9999)),        # open-ended
    ("bytes=-500", 10000, (9500, 9999)),       # suffix
    ("bytes=-99999", 100, (0, 99)),            # suffix larger than the file
    ("bytes=0-99999", 100, (0, 99)),           # end clamped to the file
    ("bytes=0-10", 0, None),                   # empty file
    ("bytes=10000-20000", 100, None),          # start beyond the file
    ("chars=0-100", 10000, None),              # invalid prefix
    ("  bytes=0-1023  ", 10000, (0, 1023)),    # whitespace trimmed
    ("bytes=a-b", 100, None),                  # garbage
    ("bytes=", 100, None),
]


@pytest.mark.parametrize("header,size,want", GRAMMAR)
def test_parse_range_grammar(header, size, want):
    assert parse_range(header, size) == want
    assert jss.parse_range(header, size) == want


_int = st.integers(-50, 20000).map(str)
_num = st.one_of(_int, st.sampled_from(["", " ", "x", "1.5", "+3", "0x10", "٣", "1_0"]))
_pad = st.sampled_from(["", " ", "\t"])
_header = st.one_of(
    # well-formed: start-end, start- (open-ended), -suffix
    st.builds(lambda a, b, pad: f"{pad}bytes={a}-{b}{pad}", _int, _int, _pad),
    st.builds(lambda a, pad: f"{pad}bytes={a}-{pad}", _int, _pad),
    st.builds(lambda b, pad: f"{pad}bytes=-{b}{pad}", _int, _pad),
    # malformed: other units, separators and numbers
    st.builds(lambda p, a, b, sep, pad: f"{pad}{p}{a}{sep}{b}{pad}",
              st.sampled_from(["bytes=", "Bytes=", "bytes =", "chars=", ""]), _num, _num,
              st.sampled_from(["-", "--", ",", "-0-"]), _pad),
    st.text(max_size=24))


@settings(max_examples=400, deadline=None)
@given(header=_header, size=st.integers(0, 12000))
def test_parse_range_equals_jax(header, size):
    assert parse_range(header, size) == jss.parse_range(header, size)


@pytest.fixture
def server(data_root):
    from crispy_tpu_torch.utils import paths

    d = paths.ensure_dir(paths.recordings_dir())
    wavio.write_wav(d / "clip.wav", 0.1 * np.ones((480, 2), np.float32), 48000)
    srv = StreamServer().start()
    jsrv = jss.StreamServer().start()
    yield srv, d, jsrv
    srv.stop()
    jsrv.stop()


def fetch(url, headers=None):
    """(status, body, the headers a player reads) of one GET."""
    try:
        with urllib.request.urlopen(urllib.request.Request(url, headers=headers or {})) as r:
            return (r.status, r.read(),
                    {k: r.headers[k] for k in ("Content-Type", "Accept-Ranges", "Content-Range",
                                               "Content-Length")})
    except urllib.error.HTTPError as e:
        return e.code, None, {"Content-Range": e.headers["Content-Range"]}


def test_full_get(server):
    srv, d, _ = server
    status, body, h = fetch(srv.url_for(d / "clip.wav"))
    assert status == 200 and h["Content-Type"] == "audio/wav" and h["Accept-Ranges"] == "bytes"
    assert body[:4] == b"RIFF"
    assert body == (d / "clip.wav").read_bytes()


def test_range_request_206(server):
    srv, d, _ = server
    status, body, h = fetch(srv.url_for(d / "clip.wav"), {"Range": "bytes=4-7"})
    assert status == 206
    assert body == (d / "clip.wav").read_bytes()[4:8]
    assert h["Content-Range"].startswith("bytes 4-7/")


def test_suffix_range(server):
    srv, d, _ = server
    size = (d / "clip.wav").stat().st_size
    _, _, h = fetch(srv.url_for(d / "clip.wav"), {"Range": "bytes=-10"})
    assert h["Content-Range"] == f"bytes {size - 10}-{size - 1}/{size}"


def test_unsatisfiable_range_416(server):
    srv, d, _ = server
    status, _, h = fetch(srv.url_for(d / "clip.wav"), {"Range": "bytes=999999-"})
    assert status == 416
    assert h["Content-Range"] == f"bytes */{(d / 'clip.wav').stat().st_size}"


def test_missing_404_and_escape_403(server):
    srv, _, _ = server
    assert fetch(f"http://127.0.0.1:{srv.port}/nope.wav")[0] == 404
    assert fetch(f"http://127.0.0.1:{srv.port}/%2e%2e/%2e%2e/etc/passwd")[0] in (403, 404)


@pytest.mark.parametrize("rel,rng", [
    ("clip.wav", None), ("clip.wav", "bytes=4-7"), ("clip.wav", "bytes=-10"),
    ("clip.wav", "bytes=100-"), ("clip.wav", "bytes=0-99999"), ("clip.wav", "bytes=999999-"),
    ("clip.wav", "bytes=a-b"), ("clip.wav", "chars=0-3"), ("nope.wav", None),
    ("%2e%2e/%2e%2e/etc/passwd", None), ("notes.txt", "bytes=1-2"),
])
def test_replies_equal_jax(server, rel, rng):
    srv, d, jsrv = server
    (d / "notes.txt").write_bytes(b"0123456789")
    headers = {"Range": rng} if rng else {}
    got = fetch(f"http://127.0.0.1:{srv.port}/{rel}", headers)
    want = fetch(f"http://127.0.0.1:{jsrv.port}/{rel}", headers)
    assert got == want
