"""The port's recording engine and the CLI's resample and recordings commands
(crispy_tpu_torch), held against the JAX package on the same sources.

The mixer worker runs on rings filled before it starts, so what it writes
does not depend on thread timing: the port's WAV must have the JAX engine's
bytes. The lifecycle, registry and CRUD follow the JAX package's own tests.
"""

import json
import time
import wave

import numpy as np
import pytest

from crispy_tpu_torch import cli
from crispy_tpu_torch.dsp.resample import resample_poly
from crispy_tpu_torch.engine import recording as rec
from crispy_tpu_torch.engine import transcription as ttr
from crispy_tpu_torch.io import wav as twav
from crispy_tpu_torch.utils import paths
from torch_audio import speechlike

try:  # the reference; the card's machine has no JAX and runs only the gpu tests
    from crispy_tpu import cli as jcli
    from crispy_tpu.dsp import resample as jres
    from crispy_tpu.engine import recording as jrec
except ImportError:
    jrec = None
needs_jax = pytest.mark.skipif(jrec is None, reason="the JAX reference is not installed")

F = rec.MIX_FRAME


@pytest.fixture
def data_root(tmp_path, monkeypatch):
    """The Crispy data root in a temp dir."""
    monkeypatch.setenv("CRISPY_DATA_DIR", str(tmp_path / "Crispy"))
    return tmp_path / "Crispy"


def mix_offline(mod, path, mic, app):
    """The mixer worker of ``mod`` over rings filled before it starts, into
    a writer at ``path``; returns the finalized path."""
    state = mod.RecordingState()
    state.writer = mod._make_writer(path)
    state.mic_ring.push(mic)
    state.app_ring.push(app)
    w = mod.start_recording_worker(state)  # not active: drains whole frames, then ends
    w.join(timeout=30)
    assert not w.is_alive()
    return state.writer.finalize()


MIX_CASES = {
    "app_short": (3 * F + 100, F // 2),  # zero fill, a partial mic frame left over
    "mic_ahead": (8 * F, F),  # mic trimmed to 50 ms ahead of the app
    "app_ahead": (2 * F, 6 * F),  # app trimmed
    "equal": (4 * F, 4 * F),
    "mic_only": (2 * F, 0),
}


class TestRingBuffer:
    def test_bounded_and_trim(self):
        r = rec.RingBuffer(capacity=10)
        r.push(np.arange(15, dtype=np.float32))
        assert len(r) == 10
        assert r.pop(3).tolist() == [5.0, 6.0, 7.0]
        r.trim_front(2)
        assert r.pop(1).tolist() == [10.0]
        assert r.pop(99).tolist() == [11.0, 12.0, 13.0, 14.0]
        r.push(np.ones(3, np.float32))
        r.clear()
        assert len(r) == 0 and r.pop(2).size == 0

    @needs_jax
    def test_same_as_jax_ring(self):
        rng = np.random.default_rng(5)
        a, b = rec.RingBuffer(capacity=500), jrec.RingBuffer(capacity=500)
        for _ in range(40):
            x = rng.standard_normal(int(rng.integers(0, 300))).astype(np.float32)
            a.push(x)
            b.push(x)
            n, m = int(rng.integers(0, 200)), int(rng.integers(0, 50))
            np.testing.assert_array_equal(a.pop(n), b.pop(n))
            a.trim_front(m)
            b.trim_front(m)
            assert len(a) == len(b)


class TestMixer:
    @needs_jax
    @pytest.mark.parametrize("case", sorted(MIX_CASES))
    def test_wav_bytes_equal_jax_engine(self, tmp_path, case):
        n_mic, n_app = MIX_CASES[case]
        mic = speechlike(n_mic, seed=51)
        app = speechlike(n_app, seed=52, f0=230.0) if n_app else np.zeros(0, np.float32)
        port = mix_offline(rec, tmp_path / "port.wav", mic, app)
        ref = mix_offline(jrec, tmp_path / "jax.wav", mic, app)
        assert port.read_bytes() == ref.read_bytes()
        audio, sr = twav.read_wav(port)
        assert sr == rec.SAMPLE_RATE and audio.shape[1] == 2 and audio.shape[0] % F == 0
        np.testing.assert_array_equal(audio[:, 0], audio[:, 1])  # dual mono

    def test_dual_mono_sum_and_zero_fill(self, tmp_path):
        mic = 0.25 * np.ones(2 * F, np.float32)
        app = 0.25 * np.ones(F // 2, np.float32)
        audio, _ = twav.read_wav(mix_offline(rec, tmp_path / "m.wav", mic, app))
        assert audio.shape == (2 * F, 2)
        np.testing.assert_allclose(audio[: F // 2, 0], 0.5, atol=1e-3)
        np.testing.assert_allclose(audio[F // 2:, 0], 0.25, atol=1e-3)

    def test_desync_trim(self, tmp_path):
        """The mic 8 frames ahead of a 1-frame app: its head is trimmed to
        50 ms ahead, so the first mixed frame holds the mic from there."""
        mic = np.arange(8 * F, dtype=np.float32) / (8 * F)
        app = np.zeros(F, np.float32)
        audio, _ = twav.read_wav(mix_offline(rec, tmp_path / "d.wav", mic, app))
        skip = 8 * F - F - rec.MAX_DESYNC
        want = np.trunc(np.clip(mic[skip: skip + F], -1, 1) * 32767) / 32768.0
        np.testing.assert_array_equal(audio[:F, 0], want.astype(np.float32))


class TestLifecycle:
    def test_start_stop_and_is_recording(self, data_root):
        state = rec.RecordingState()
        assert not rec.is_recording(state)
        p = rec.do_start_recording(state)
        assert rec.is_recording(state) and p.parent == paths.recordings_dir()
        assert p.name.startswith("recording_") and p.suffix == ".wav"
        with pytest.raises(RuntimeError):
            rec.do_start_recording(state)
        state.mic_ring.push(speechlike(3 * F, seed=53))
        out = rec.do_stop_recording(state)
        assert not rec.is_recording(state)
        with wave.open(out, "rb") as w:  # stdlib wave reads the finalized file
            assert w.getnchannels() == 2 and w.getframerate() == 48000
            assert w.getsampwidth() == 2 and w.getnframes() == 3 * F
        with pytest.raises(RuntimeError):
            rec.do_stop_recording(state)

    def test_file_source_feeds_app_ring(self, data_root, tmp_path):
        """A 44.1 kHz app file is brought to 48 kHz by resample_block."""
        tone = 0.1 * np.ones(22050, np.float32)
        src = twav.write_wav(tmp_path / "app.wav", tone, 44100)
        state = rec.RecordingState()
        rec.do_start_recording(state, app_source=rec.FileSource(src))
        deadline = time.time() + 5
        while len(state.app_ring) < 24000 and time.time() < deadline:
            time.sleep(0.01)
        state.mic_ring.push(np.zeros(24000, np.float32))
        deadline = time.time() + 5
        while len(state.mic_ring) >= F and time.time() < deadline:
            time.sleep(0.02)
        audio, _ = twav.read_wav(rec.do_stop_recording(state))
        assert audio.shape[0] == (24000 // F) * F
        assert np.abs(audio[:, 0] - 0.1).max() < 1e-2  # the app audio is present

    def test_registry(self):
        assert rec.get_recordable_apps()[-1].name == "None (Mic only)"
        rec.register_recordable_app("tone", "Tone", lambda: rec.FileSource("x.wav"))
        try:
            apps = rec.get_recordable_apps()
            assert [(a.id, a.bundle_id) for a in apps] == [("tone", "tone"), ("", "")]
            assert isinstance(rec.resolve_app_source("tone"), rec.FileSource)
            assert rec.resolve_app_source("") is None
        finally:
            rec.unregister_recordable_app("tone")
        assert [a.id for a in rec.get_recordable_apps()] == [""]


@needs_jax
class TestCapture:
    @pytest.mark.parametrize("n,dur", [(480, 0.01), (441, 0.01), (1000, None), (700, 0.0166)])
    def test_detect_sample_rate_equals_jax(self, n, dur):
        assert rec.detect_sample_rate(n, dur) == jrec.detect_sample_rate(n, dur)

    def test_downmix_and_handler_equal_jax(self):
        rng = np.random.default_rng(54)
        l, r = rng.standard_normal(900).astype(np.float32), rng.standard_normal(880).astype(np.float32)
        inter = rng.standard_normal((500, 2)).astype(np.float32)
        for x in ((l, r), inter, l):
            np.testing.assert_array_equal(rec.downmix_mono(x), jrec.downmix_mono(x))
        got, want = [], []
        a, b = rec.AppCaptureHandler(got.append), jrec.AppCaptureHandler(want.append)
        for h in (a, b):
            h.deliver((l[:441], r[:441]), 0.01)  # detected as 44.1 kHz, resampled to 48
            h.deliver(inter)
            h.deliver_silence(0.005)
        assert a.detected_sample_rate == b.detected_sample_rate == 44100
        assert len(got) == len(want) == 3
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)


class TestCrud:
    @staticmethod
    def make(name, seconds=1.0):
        d = paths.ensure_dir(paths.recordings_dir())
        return twav.write_wav(d / name, np.zeros((int(48000 * seconds), 2), np.float32), 48000)

    def test_list_sorted_and_metadata(self, data_root):
        a = self.make("a.wav", 1.0)
        time.sleep(0.02)
        self.make("b.wav", 2.0)
        (a.parent / "notes.txt").write_text("x")  # not a wav: ignored
        recs = rec.get_recordings()
        assert [r["name"] for r in recs] == ["b.wav", "a.wav"]
        assert recs[0]["duration_seconds"] == pytest.approx(2.0)
        assert recs[1]["size"] == a.stat().st_size

    def test_active_recording_hidden(self, data_root):
        self.make("done.wav")
        state = rec.RecordingState()
        active = rec.do_start_recording(state)
        names = [r["name"] for r in rec.get_recordings(state)]
        assert "done.wav" in names and active.name not in names
        rec.do_stop_recording(state)

    def test_rename_moves_sidecars(self, data_root):
        p = self.make("orig.wav")
        ttr.save_transcription_result(str(p), "transcript")
        ttr.save_transcription_metadata(str(p), "small")
        newp = rec.rename_recording(str(p), "renamed")
        assert newp.endswith("renamed.wav")
        assert ttr.load_transcription_result(newp) == "transcript"
        assert ttr.load_transcription_metadata(newp) == "small"
        assert ttr.load_transcription_result(str(p)) is None

    def test_rename_validation(self, data_root):
        p = self.make("v.wav")
        with pytest.raises(ValueError):
            rec.rename_recording(str(p), "   ")
        with pytest.raises(ValueError):
            rec.rename_recording(str(p), "a/b")
        self.make("taken.wav")
        with pytest.raises(FileExistsError):
            rec.rename_recording(str(p), "taken")
        with pytest.raises(FileNotFoundError):
            rec.rename_recording(str(p.parent / "ghost.wav"), "x")
        assert rec.rename_recording(str(p), "v") == str(p)

    def test_delete_confinement(self, data_root, tmp_path):
        p = self.make("del.wav")
        rec.delete_recording(str(p))
        assert not p.exists()
        outside = tmp_path / "outside.wav"
        outside.write_bytes(b"RIFF")
        with pytest.raises(PermissionError):
            rec.delete_recording(str(outside))
        with pytest.raises(PermissionError):
            rec.delete_recording(str(p.parent / ".." / "escape.wav"))


class TestCli:
    @needs_jax
    def test_recordings_list_lines_equal_jax_cli(self, data_root, capsys):
        TestCrud.make("one.wav", 1.5)
        time.sleep(0.02)
        TestCrud.make("two.wav", 0.5)
        (paths.recordings_dir() / "bad.wav").write_bytes(b"RIFF")  # no duration: "?"
        assert cli.main(["recordings", "list"]) == 0
        port = capsys.readouterr().out
        assert jcli.main(["recordings", "list"]) == 0
        assert port == capsys.readouterr().out
        assert len(port.splitlines()) == 3

    def test_recordings_rename_and_delete(self, data_root, capsys):
        p = TestCrud.make("old.wav")
        assert cli.main(["recordings", "rename", str(p), "new"]) == 0
        newp = capsys.readouterr().out.strip()
        assert newp.endswith("new.wav")
        assert cli.main(["recordings", "delete", newp]) == 0
        assert rec.get_recordings() == []

    @needs_jax
    @pytest.mark.parametrize("rates", [(44100, 48000), (48000, 16000)])
    def test_resample_cpu_agrees_with_jax_cli(self, tmp_path, capsys, rates):
        """The port's conv on the CPU against the JAX CLI's resampler (scipy
        off the TPU): the samples within 1e-5, the 16-bit WAVs within 1 LSB
        (a sample that close to a quantisation step may round either way)."""
        sr, to = rates
        src = tmp_path / "in.wav"
        stereo = np.stack([speechlike(sr // 2, seed=55, sr=sr),
                           speechlike(sr // 2, seed=56, f0=190.0, sr=sr)], axis=1)
        twav.write_wav(src, stereo, sr)
        port, ref = tmp_path / "port.wav", tmp_path / "jax.wav"
        assert cli.main(["resample", str(src), str(port), "--rate", str(to),
                         "--device", "cpu"]) == 0
        assert jcli.main(["resample", str(src), str(ref), "--rate", str(to)]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        assert json.loads(lines[0]) == {"output": str(port), "from_rate": sr, "to_rate": to}
        assert json.loads(lines[1])["to_rate"] == to
        audio, _ = twav.read_wav(src)
        for c in range(2):
            got = resample_poly(audio[:, c], sr, to, device="cpu").numpy()
            want = jres.resample_poly(audio[:, c], sr, to, use_jax=False)
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        a, _ = twav.read_wav(port)
        b, _ = twav.read_wav(ref)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1.0 / 32768.0
