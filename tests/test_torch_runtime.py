"""The port's ctypes binding of the C++ host tier (crispy_tpu_torch.runtime).

Built with g++ into the port's own build directory, it must give the JAX
package's binding's results (the same source, built twice) and agree with
the port's pure-Python fallback, which the recording engine takes when g++
is missing. Skipped where the library cannot be built, as
tests/test_native_runtime.py is.
"""

import numpy as np
import pytest

from crispy_tpu_torch import runtime as rt
from crispy_tpu_torch.dsp.resample import LinearResampler
from crispy_tpu_torch.engine import recording as rec
from crispy_tpu_torch.io import wav as twav

try:  # the reference; the card's machine has no JAX and runs only the gpu tests
    from crispy_tpu import runtime as jrt
except ImportError:
    jrt = None
needs_jax = pytest.mark.skipif(jrt is None, reason="the JAX reference is not installed")

MF = rec.MIX_FRAME


@pytest.fixture
def native():
    if not rt.available():
        pytest.skip("g++ or the native source is unavailable")
    return rt


@pytest.fixture
def jnative():
    if not jrt.available():
        pytest.skip("the JAX package's native build is unavailable")
    return jrt


def ring_script(ring, seed=61):
    """A fixed mix of pushes past capacity, pops, trims and clears; returns
    what it read."""
    rng = np.random.default_rng(seed)
    seen = []
    for i in range(60):
        ring.push(rng.standard_normal(int(rng.integers(0, 700))).astype(np.float32))
        seen.append(ring.pop(int(rng.integers(0, 400))))
        ring.trim_front(int(rng.integers(0, 60)))
        seen.append(np.array([len(ring)], np.float32))
        if i % 17 == 16:
            ring.clear()
    return np.concatenate(seen)


def python_mixer_step(mic, app, frame, max_desync):
    """One frame of the recording worker's loop body on Python rings."""
    mic_len, app_len = len(mic), len(app)
    if mic_len < frame:
        return None
    if mic_len > app_len + max_desync and app_len > 0:
        mic.trim_front(mic_len - app_len - max_desync)
    elif app_len > mic_len + max_desync:
        app.trim_front(app_len - mic_len - max_desync)
    m, a = mic.pop(frame), app.pop(frame)
    return np.pad(m, (0, frame - m.size)) + np.pad(a, (0, frame - a.size))


class TestAgainstPythonFallback:
    def test_builds_into_the_ports_build_dir(self, native):
        so = native.build_library()
        assert so.parent == rt.BUILD_DIR and so.parent.parent.name == "crispy_tpu_torch"

    def test_ring(self, native):
        np.testing.assert_array_equal(ring_script(native.NativeRing(1000)),
                                      ring_script(rec.RingBuffer(1000)))

    @pytest.mark.parametrize("sizes", [(3000, 500), (MF, 0), (8 * MF, MF), (2 * MF, 7 * MF),
                                       (MF - 1, MF)])
    def test_mixer_step(self, native, sizes):
        rng = np.random.default_rng(sum(sizes))
        mic, app = (rng.standard_normal(n).astype(np.float32) for n in sizes)
        rings = []
        for make in (lambda: native.NativeRing(rec.RING_CAPACITY), rec.RingBuffer):
            m, a = make(), make()
            m.push(mic)
            a.push(app)
            rings.append((m, a))
        (nm, na), (pm, pa) = rings
        for _ in range(12):
            got = native.mixer_step(nm, na, rec.MIX_FRAME, rec.MAX_DESYNC)
            want = python_mixer_step(pm, pa, rec.MIX_FRAME, rec.MAX_DESYNC)
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, want)
            assert (len(nm), len(na)) == (len(pm), len(pa))

    @pytest.mark.parametrize("rates", [(44100, 48000), (48000, 16000), (22050, 48000)])
    def test_resampler(self, native, rates):
        """The tolerance of tests/test_native_runtime.py: the C++ resampler
        rounds its interpolation in another order."""
        x = np.random.default_rng(62).standard_normal(5000).astype(np.float32)
        py, nat = LinearResampler(*rates), native.NativeLinearResampler(*rates)
        a = np.concatenate([py.process(x[:1234]), py.process(x[1234:])])
        b = np.concatenate([nat.process(x[:1234]), nat.process(x[1234:])])
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
        nat.set_rates(48000, 48000.5)  # bypass
        np.testing.assert_array_equal(nat.process(x[:100]), x[:100])

    def test_wav_writer_bytes(self, native, tmp_path):
        rng = np.random.default_rng(63)
        l, r = (rng.uniform(-1.2, 1.2, 3000).astype(np.float32) for _ in range(2))
        for name, w in (("py.wav", twav.WavWriter(tmp_path / "py.wav")),
                        ("nat.wav", native.NativeWavWriter(tmp_path / "nat.wav"))):
            w.write_samples(l, r)
            w.write_samples(r[:17], l[:17])
            assert w.finalize() == tmp_path / name
        assert (tmp_path / "py.wav").read_bytes() == (tmp_path / "nat.wav").read_bytes()
        with pytest.raises(ValueError):
            native.NativeWavWriter(tmp_path / "x.wav").write_samples(l, r[:5])

    def test_rms(self, native, monkeypatch):
        x = np.random.default_rng(64).standard_normal(4801).astype(np.float32)
        nat = native.rms(x)
        assert native.rms(np.zeros(0, np.float32)) == 0.0
        monkeypatch.setattr(rt, "_LIB", None)
        monkeypatch.setattr(rt, "_BUILD_FAILED", True)
        assert rt.rms(x) == pytest.approx(nat, rel=1e-6)


@needs_jax
class TestAgainstJaxBinding:
    def test_ring_and_mixer(self, native, jnative):
        np.testing.assert_array_equal(ring_script(native.NativeRing(1000)),
                                      ring_script(jnative.NativeRing(1000)))
        x = np.random.default_rng(65).standard_normal(9 * rec.MIX_FRAME).astype(np.float32)
        outs = []
        for mod in (native, jnative):
            m, a = mod.NativeRing(rec.RING_CAPACITY), mod.NativeRing(rec.RING_CAPACITY)
            m.push(x)
            a.push(x[:rec.MIX_FRAME])
            outs.append([mod.mixer_step(m, a, rec.MIX_FRAME, rec.MAX_DESYNC) for _ in range(4)])
        for p, j in zip(*outs):
            assert (p is None) == (j is None)
            if p is not None:
                np.testing.assert_array_equal(p, j)

    @pytest.mark.parametrize("rates", [(44100, 48000), (48000, 16000)])
    def test_resampler_and_rms(self, native, jnative, rates):
        x = np.random.default_rng(66).standard_normal(4000).astype(np.float32)
        a, b = native.NativeLinearResampler(*rates), jnative.NativeLinearResampler(*rates)
        for blk in (x[:999], x[999:]):
            np.testing.assert_array_equal(a.process(blk), b.process(blk))
        assert native.rms(x) == jnative.rms(x)

    def test_wav_writer_bytes(self, native, jnative, tmp_path):
        rng = np.random.default_rng(67)
        l, r = (rng.uniform(-1.1, 1.1, 2000).astype(np.float32) for _ in range(2))
        for mod, name in ((native, "port.wav"), (jnative, "jax.wav")):
            w = mod.NativeWavWriter(tmp_path / name)
            w.write_samples(l, r)
            w.finalize()
        assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()


def test_recording_takes_the_python_fallback_without_the_library(monkeypatch, tmp_path):
    """With no library (as without g++) the rings and writer are the Python
    ones, and the mix is written all the same."""
    monkeypatch.setattr(rt, "_LIB", None)
    monkeypatch.setattr(rt, "_BUILD_FAILED", True)
    assert not rt.available()
    state = rec.RecordingState()
    assert isinstance(state.mic_ring, rec.RingBuffer)
    writer = rec._make_writer(tmp_path / "fb.wav")
    assert isinstance(writer, twav.WavWriter)
    state.writer = writer
    state.mic_ring.push(np.full(2 * rec.MIX_FRAME, 0.25, np.float32))
    rec.start_recording_worker(state).join(timeout=30)
    audio, _ = twav.read_wav(writer.finalize())
    assert audio.shape == (2 * rec.MIX_FRAME, 2)
    np.testing.assert_allclose(audio, 0.25, atol=1e-4)
