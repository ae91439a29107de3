"""The port's denoise engine, CLI and packaging rules (crispy_tpu_torch).

``denoise_file`` is held against the JAX package's ``denoise_file`` on the
same WAVs on the CPU; the port's sources are checked to import neither JAX
nor the JAX package; an entry point called without a device raises when no
card is present. The ``gpu`` test runs the file path on the card.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from crispy_tpu_torch import cli
from crispy_tpu_torch.dsp import resample as tresample
from crispy_tpu_torch.dsp.rnnoise import pipeline as tp
from crispy_tpu_torch.dsp.rnnoise import weights as tw
from crispy_tpu_torch.engine import denoiser as tden
from crispy_tpu_torch.io import wav as twav
from torch_audio import speechlike

try:  # the reference; the card's machine has no JAX and runs only the gpu tests
    from crispy_tpu.dsp import resample as jresample
    from crispy_tpu.dsp.rnnoise.weights import deterministic_test_model
    from crispy_tpu.engine import denoiser as jden
except ImportError:
    jden = None
needs_jax = pytest.mark.skipif(jden is None, reason="the JAX reference is not installed")

ROOT = Path(__file__).resolve().parents[1]
FRAME = 480


def stereo_pcm(n, sr):
    a = np.stack([speechlike(n, seed=31, f0=120.0, sr=sr),
                  speechlike(n, seed=32, f0=205.0, sr=sr)], axis=1)
    return (a * 32767).astype(np.int16)  # [frames, 2]


@pytest.fixture(scope="module")
def jmodel():
    return deterministic_test_model()


@pytest.fixture(scope="module")
def tmodel():
    return tw.deterministic_test_model()


def pcm_of(path):
    audio, sr = twav.read_wav(path)
    return np.round(audio * 32768.0).astype(np.int32), sr


class TestDenoiseFile:
    @needs_jax
    @pytest.mark.parametrize("sr", [48000, 44100])
    def test_matches_jax_denoise_file(self, tmp_path, jmodel, tmodel, sr):
        """48 kHz 16-bit takes the int16 wire; 44.1 kHz is resampled on the
        host and takes the f32 path. Both write 16-bit WAVs within 1 LSB of
        the JAX package's."""
        jm, tm = jmodel, tmodel
        src = tmp_path / "in.wav"
        twav.write_wav(src, stereo_pcm(13 * FRAME + 50, sr), sr)
        info_t = tden.denoise_file(src, tmp_path / "port.wav", model=tm, block_frames=8,
                                   device="cpu")
        info_j = jden.denoise_file(src, tmp_path / "jax.wav", model=jm, block_frames=8)
        assert info_t == info_j
        got, rate = pcm_of(tmp_path / "port.wav")
        want, _ = pcm_of(tmp_path / "jax.wav")
        assert rate == 48000 and got.shape == want.shape
        assert int(np.abs(got - want).max()) <= 1

    def test_denoise_array_clips_and_drops_first_frame(self, tmodel):
        audio = speechlike(4 * FRAME, seed=33)
        out = tden.denoise_array(audio, model=tmodel, drop_first_frame=True, device="cpu")
        assert out.shape == audio.shape
        assert np.all(out[:FRAME] == 0.0) and np.abs(out).max() <= 1.0

    @needs_jax
    def test_resample_matches_jax_host_branch(self):
        x = speechlike(4410, seed=34, sr=44100)
        np.testing.assert_array_equal(tresample.resample_poly(x, 44100, 48000),
                                      jresample.resample_poly(x, 44100, 48000, use_jax=False))

    @pytest.mark.gpu
    def test_denoise_file_on_card_matches_cpu(self, tmp_path, tmodel):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
        tm = tmodel
        src = tmp_path / "in.wav"
        twav.write_wav(src, stereo_pcm(20 * FRAME, 48000), 48000)
        tden.denoise_file(src, tmp_path / "card.wav", model=tm, block_frames=8)
        tden.denoise_file(src, tmp_path / "cpu.wav", model=tm, block_frames=8, device="cpu")
        assert int(np.abs(pcm_of(tmp_path / "card.wav")[0]
                          - pcm_of(tmp_path / "cpu.wav")[0]).max()) <= 1


class TestNoFallback:
    def test_entry_points_raise_without_a_card(self, monkeypatch, tmp_path):
        """device=None means the card: with none present the entry points
        raise instead of carrying on on the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        audio = np.zeros((1, 2 * FRAME), np.float32)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.denoise_batch(audio)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tden.denoise_array(audio)
        src = tmp_path / "in.wav"
        twav.write_wav(src, audio[0], 48000)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tden.denoise_file(src, tmp_path / "out.wav")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.make_params()

    def test_streaming_entry_points_raise_without_a_card(self, monkeypatch, tmp_path,
                                                         capsys):
        """The monitoring path's entry points and the resample command also
        mean the card by default; device="cpu" (or --device cpu) runs them
        on the CPU."""
        from crispy_tpu_torch.dsp.rnnoise.graphed import GraphedBlockStep
        from crispy_tpu_torch.engine.monitoring import MonitoringEngine

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tden.RnnNoiseProcessor(48000, 48000, 1.0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tden.NsState("rnnoise", 48000, 48000, 1.0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MonitoringEngine()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GraphedBlockStep(tp.make_params(tw.deterministic_test_model(), "cpu"))
        src, dst = tmp_path / "in.wav", tmp_path / "out.wav"
        twav.write_wav(src, speechlike(4410, seed=36, sr=44100), 44100)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["resample", str(src), str(dst), "--rate", "48000"])
        assert cli.main(["resample", str(src), str(dst), "--rate", "48000",
                         "--device", "cpu"]) == 0
        assert json.loads(capsys.readouterr().out.splitlines()[-1])["to_rate"] == 48000
        assert tden.NsState("rnnoise", 48000, 48000, 1.0, device="cpu").device.type == "cpu"


class TestCli:
    def test_denoise_and_bench_on_cpu(self, tmp_path, capsys, monkeypatch):
        src, dst = tmp_path / "in.wav", tmp_path / "out.wav"
        twav.write_wav(src, speechlike(3 * FRAME, seed=35), 48000)
        assert cli.main(["denoise", str(src), str(dst), "--device", "cpu"]) == 0
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec["samples"] == 3 * FRAME and dst.exists()
        monkeypatch.setattr(cli, "BENCH_FRAMES", 3)
        monkeypatch.setattr(cli, "BENCH_STEPS", 1)
        assert cli.main(["bench", "--streams", "2", "--device", "cpu"]) == 0
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec["device"] == "cpu" and rec["value"] > 0

    @needs_jax
    @pytest.mark.parametrize("ns_model", ["dummy", "noisy"])
    def test_legacy_ns_model_bytes_equal_jax_cli(self, tmp_path, capsys, ns_model):
        """--ns-model dummy|noisy writes the same bytes as the JAX package's
        CLI on one WAV (both run on the host)."""
        from crispy_tpu import cli as jcli

        src = tmp_path / "in.wav"
        twav.write_wav(src, stereo_pcm(5 * FRAME + 31, 48000), 48000)
        port, ref = tmp_path / "port.wav", tmp_path / "jax.wav"
        assert cli.main(["denoise", str(src), str(port), "--ns-model", ns_model]) == 0
        assert jcli.main(["denoise", str(src), str(ref), "--ns-model", ns_model]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        assert json.loads(lines[-2]) == {"output": str(port), "ns_model": ns_model}
        assert port.read_bytes() == ref.read_bytes()
        if ns_model == "noisy":
            assert port.read_bytes() != src.read_bytes()

    def test_lcg_block_equals_sequential_draws(self):
        """The port's copy of _Lcg: next_block(n) gives the bits of n
        next_noise() calls and leaves the same state."""
        a, b = tden._Lcg(), tden._Lcg()
        seq = np.array([a.next_noise() for _ in range(257)])
        np.testing.assert_array_equal(b.next_block(257), seq)
        assert a.state == b.state


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "crispy_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "crispy_tpu", "flax", "optax")]
    assert not bad, bad
