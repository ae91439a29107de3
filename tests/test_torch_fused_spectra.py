"""The port's fused-spectra path (crispy_tpu_torch frontend_kernels and the
``CRISPY_FUSED_SPECTRA=on`` branch of its pipeline) held against the JAX
package's ``pallas_frontend`` and fused block step on the CPU, and the CUDA
kernels K4-K6 held against their plain versions on the card.

On the CPU the wrappers take their plain PyTorch versions (dense products;
tests/test_torch_spectrum_fft.py shows there the identities the FFTs of K4,
K5 and K6 rest on); the JAX kernels run in interpret mode, as
tests/test_pallas_frontend.py runs them. The JAX block step is forced onto its fused path the way that test
forces it, by patching the JAX module inside the test. The tests marked
``gpu`` launch the CUDA kernels; here, without a card, they skip.
"""

import numpy as np
import pytest
import torch

from crispy_tpu_torch import cli
from crispy_tpu_torch.dsp.rnnoise import frontend_kernels as fk
from crispy_tpu_torch.dsp.rnnoise import pipeline as tp
from crispy_tpu_torch.dsp.rnnoise import weights as tw
from crispy_tpu_torch.engine import denoiser as tden
from crispy_tpu_torch.io import wav as twav
from torch_audio import speechlike

try:  # the reference; the card's machine has no JAX and runs only the gpu tests
    import jax.numpy as jnp

    from crispy_tpu.dsp.rnnoise import jax_pipeline as jp
    from crispy_tpu.dsp.rnnoise import oracle
    from crispy_tpu.dsp.rnnoise import pallas_frontend as pf
    from crispy_tpu.dsp.rnnoise.weights import deterministic_test_model
except ImportError:
    jp = None
needs_jax = pytest.mark.skipif(jp is None, reason="the JAX reference is not installed")

FRAME, WIN, NFREQ, HIST = tp.FRAME, tp.WIN, tp.NFREQ, tp.HIST
SCALE = 9000.0  # the input scale of tests/test_pallas_frontend.py
# Port vs the JAX package over whole blocks: the two sides' f32 HP biquads
# round differently (see tests/test_torch_rnnoise_pipeline.py).
JAX_ATOL = 5e-5
ORACLE_ATOL = 1.5e-4  # tests/test_rnnoise_jax.py's tolerance


@pytest.fixture(scope="module")
def jparams():
    return jp.make_params(deterministic_test_model())


@pytest.fixture(scope="module")
def tparams():
    return tp.make_params(tw.deterministic_test_model(), "cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setenv("CRISPY_FUSED_SPECTRA", "on")


def t(x):
    return torch.from_numpy(np.array(x))


def assert_pad_zero(Y):
    assert float(Y[..., NFREQ: fk.IM0].abs().max()) == 0.0
    assert float(Y[..., fk.IM0 + NFREQ:].abs().max()) == 0.0


def inv_inputs(S, F, seed=2):
    rng = np.random.default_rng(seed)
    Y = np.zeros((S, F, fk.YPAD), np.float32)
    Y[..., :NFREQ] = rng.standard_normal((S, F, NFREQ))
    Y[..., fk.IM0: fk.IM0 + NFREQ] = rng.standard_normal((S, F, NFREQ))
    return Y, rng.standard_normal((S, FRAME)).astype(np.float32)


# ---------------------------------------------------------------------------
# K4-K6 against pallas_frontend (interpret mode)
# ---------------------------------------------------------------------------

@needs_jax
class TestAgainstPallasFrontend:
    @pytest.mark.parametrize("S,F", [(3, 5), (8, 16), (9, 20)])
    def test_fwd_spectrum_bands(self, jparams, tparams, S, F):
        """The TPU kernel takes dft_fwd_pad's two 512-row halves, the port the
        whole table."""
        rng = np.random.default_rng(0)
        ext_a = (rng.standard_normal((S, (F + 1) * FRAME)) * SCALE).astype(np.float32)
        jY, jEx = pf.fwd_spectrum_bands(
            jnp.asarray(ext_a), jparams["dft_fwd_a512"], jparams["dft_fwd_b512"],
            jparams["band_e_pad"], F, interpret=True)
        Y, Ex = fk.fwd_spectrum_bands(t(ext_a), tparams["dft_fwd_pad"], tparams["band_e_pad"], F)
        assert Y.shape == (S, F, fk.YPAD) and Ex.shape == (S, F, tp.NB)
        np.testing.assert_allclose(Y.numpy(), np.asarray(jY), rtol=1e-5, atol=1e-2)
        assert_pad_zero(Y)
        np.testing.assert_allclose(Ex.numpy(), np.asarray(jEx), rtol=1e-4, atol=30.0)

    @pytest.mark.parametrize("S,F", [(3, 5), (8, 16), (9, 20)])
    def test_win_spectrum_bands(self, jparams, tparams, S, F):
        rng = np.random.default_rng(1)
        wins = (rng.standard_normal((S, F, WIN)) * SCALE).astype(np.float32)
        jY, jEx = pf.win_spectrum_bands(jnp.asarray(wins), jparams["dft_fwd_pad"],
                                        jparams["band_e_pad"], interpret=True)
        Y, Ex = fk.win_spectrum_bands(t(wins), tparams["dft_fwd_pad"], tparams["band_e_pad"])
        np.testing.assert_allclose(Y.numpy(), np.asarray(jY), rtol=1e-5, atol=1e-2)
        assert_pad_zero(Y)
        np.testing.assert_allclose(Ex.numpy(), np.asarray(jEx), rtol=1e-4, atol=30.0)

    @pytest.mark.parametrize("S,F", [(3, 5), (8, 16), (5, 33)])
    def test_inv_spectrum_ola(self, jparams, tparams, S, F):
        """F = 5 and 33 take the JAX carry branch for F % 16 != 0."""
        Y, mem = inv_inputs(S, F)
        jout, jmem = pf.inv_spectrum_ola(jnp.asarray(Y), jparams["dft_inv_a"],
                                         jparams["dft_inv_b"], jnp.asarray(mem), F,
                                         interpret=True)
        out, new_mem = fk.inv_spectrum_ola(t(Y), tparams["dft_inv_a"], tparams["dft_inv_b"],
                                           t(mem))
        assert out.shape == (S, F * FRAME) and new_mem.shape == (S, FRAME)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(new_mem.numpy(), np.asarray(jmem), rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# The fused block step
# ---------------------------------------------------------------------------

def _two_blocks():
    n = 12 * FRAME
    return np.stack([speechlike(n, seed=41, f0=115.0), speechlike(n, seed=42, f0=190.0)]), 6


@needs_jax
class TestFusedBlock:
    def test_denoise_batch_matches_jax_fused_block_and_oracle(self, jparams, fused,
                                                              monkeypatch):
        """Two consecutive blocks, so syn_mem and the other carries cross a
        block boundary: the port's fused CPU path against the JAX package's
        fused denoise_block (K4-K6 in interpret mode) and the oracle."""
        monkeypatch.setattr(jp, "_use_fused_spectra", lambda: True)
        monkeypatch.setattr(jp, "_use_matmul_dft", lambda: False)
        audio, F = _two_blocks()
        tparams = tw.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
        got = tp.denoise_batch(audio, params=tparams, block_frames=F, device="cpu")
        state = jp.init_state(audio.shape[0])
        want, blk = [], F * FRAME
        for b in range(2):
            state, o, _ = jp.denoise_block(jparams, state,
                                           jnp.asarray(audio[:, b * blk: (b + 1) * blk]))
            want.append(np.asarray(o))
        np.testing.assert_allclose(got, np.concatenate(want, axis=1), atol=JAX_ATOL)
        model = deterministic_test_model()
        ref = np.stack([oracle.denoise_stream(a, model) for a in audio])
        np.testing.assert_allclose(got, ref, atol=ORACLE_ATOL)


def test_fused_pitch_index_equals_default(tparams, monkeypatch):
    """The pitch search reads ext, not the spectra: the fused branch's pitch
    indices equal the default branch's exactly, and its spectra agree."""
    audio = torch.from_numpy(speechlike(16 * FRAME, seed=43, f0=140.0)[None, :])
    _, fft = tp.frontend_block(tparams, tp.init_state(1, "cpu"), audio)
    monkeypatch.setenv("CRISPY_FUSED_SPECTRA", "on")
    _, fused = tp.frontend_block(tparams, tp.init_state(1, "cpu"), audio)
    assert fft["Y"] is None and fused["Y"].shape == (1, 16, fk.YPAD)
    assert torch.equal(fused["pitch_idx"], fft["pitch_idx"])
    for k in ("Xr", "Xi", "Pr", "Pi"):
        torch.testing.assert_close(fused[k], fft[k], rtol=0, atol=1e-2, msg=k)
    torch.testing.assert_close(fused["Ex"], fft["Ex"], rtol=1e-4, atol=1.0)


class TestEntryPointsTakeTheSwitch:
    """The switch reaches K4-K6 through every entry point, and only when on."""

    @pytest.fixture
    def calls(self, monkeypatch):
        counts = {"fwd": 0, "win": 0, "inv": 0}

        def spy(name, fn):
            def wrapped(*a):
                counts[name] += 1
                return fn(*a)
            return wrapped

        monkeypatch.setattr(tp, "fwd_spectrum_bands", spy("fwd", fk.fwd_spectrum_bands))
        monkeypatch.setattr(tp, "win_spectrum_bands", spy("win", fk.win_spectrum_bands))
        monkeypatch.setattr(tp, "inv_spectrum_ola", spy("inv", fk.inv_spectrum_ola))
        return counts

    @pytest.mark.parametrize("wire", ["f32", "i16"])
    def test_denoise_batch(self, tparams, calls, monkeypatch, wire):
        audio = speechlike(6 * FRAME, seed=44)[None, :]
        if wire == "i16":
            audio = (audio * 32767).astype(np.int16)
        tp.denoise_batch(audio, params=tparams, block_frames=3, wire=wire, device="cpu")
        assert calls == {"fwd": 0, "win": 0, "inv": 0}
        monkeypatch.setenv("CRISPY_FUSED_SPECTRA", "on")
        tp.denoise_batch(audio, params=tparams, block_frames=3, wire=wire, device="cpu")
        assert calls == {"fwd": 2, "win": 2, "inv": 2}

    def test_denoise_file_and_cli_bench(self, calls, fused, tmp_path, monkeypatch, capsys):
        src = tmp_path / "in.wav"
        twav.write_wav(src, speechlike(3 * FRAME, seed=45), 48000)
        tden.denoise_file(src, tmp_path / "out.wav", device="cpu")
        assert calls == {"fwd": 1, "win": 1, "inv": 1}
        monkeypatch.setattr(cli, "BENCH_FRAMES", 3)
        monkeypatch.setattr(cli, "BENCH_STEPS", 1)
        assert cli.main(["bench", "--streams", "2", "--device", "cpu"]) == 0
        assert calls == {"fwd": 3, "win": 3, "inv": 3}  # a warm-up step and one timed
        assert '"spectra": "fused"' in capsys.readouterr().out


def test_mixed_devices_raise(tparams):
    """A wrapper given CPU tensors beside a non-CPU one raises instead of
    picking a path."""
    Y, mem = inv_inputs(1, 2)
    with pytest.raises(ValueError, match="mixed"):
        fk.inv_spectrum_ola(t(Y), tparams["dft_inv_a"], tparams["dft_inv_b"],
                            t(mem).to("meta"))


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------

def fwd_inputs(S, F, dev, seed=5):
    """ext and the strided slice ext[:, 769:] the pipeline passes to K4."""
    rng = np.random.default_rng(seed)
    ext = torch.from_numpy(
        (rng.standard_normal((S, HIST + 1 + F * FRAME)) * SCALE).astype(np.float32)).to(dev)
    return ext[:, 1 + HIST - FRAME:]


def win_inputs(S, F, dev, seed=6):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((S, F, WIN)) * SCALE).astype(np.float32)).to(dev)


# The kernel takes runs of 16 frames of one stream: F = 1, runs cut short
# (F = 13, 20, 500) and S from 1 stream to the main path's 128.
CARD_SHAPES = [(3, 1), (3, 5), (5, 13), (9, 20), (128, 7), (128, 500)]


@pytest.mark.gpu
class TestKernelsOnCard:
    @pytest.mark.parametrize("S,F", CARD_SHAPES)
    def test_fwd_spectrum_bands(self, cuda, S, F):
        """In place on a strided slice, as the pipeline passes ext[:, 769:]."""
        p = tp.make_params(tw.deterministic_test_model(), cuda)
        ext_a = fwd_inputs(S, F, cuda)
        before = fk.fwd_spectrum_bands.launches
        Y, Ex = fk.fwd_spectrum_bands(ext_a, p["dft_fwd_pad"], p["band_e_pad"], F)
        rY, rEx = fk.fwd_spectrum_bands_reference(ext_a, p["dft_fwd_pad"], p["band_e_pad"], F)
        torch.cuda.synchronize()
        assert fk.fwd_spectrum_bands.launches == before + 1
        assert float((Y - rY).abs().max()) <= 1e-5 * float(rY.abs().max())
        assert_pad_zero(Y)
        torch.testing.assert_close(Ex, rEx, rtol=1e-4, atol=0.0)

    @pytest.mark.parametrize("S,F", CARD_SHAPES)
    def test_win_spectrum_bands(self, cuda, S, F):
        p = tp.make_params(tw.deterministic_test_model(), cuda)
        wins = win_inputs(S, F, cuda)
        before = fk.win_spectrum_bands.launches
        Y, Ex = fk.win_spectrum_bands(wins, p["dft_fwd_pad"], p["band_e_pad"])
        rY, rEx = fk.win_spectrum_bands_reference(wins, p["dft_fwd_pad"], p["band_e_pad"])
        torch.cuda.synchronize()
        assert fk.win_spectrum_bands.launches == before + 1
        assert float((Y - rY).abs().max()) <= 1e-5 * float(rY.abs().max())
        assert_pad_zero(Y)
        torch.testing.assert_close(Ex, rEx, rtol=1e-4, atol=0.0)

    @pytest.mark.parametrize("kernel", ["fwd", "win", "inv"])
    def test_repeat_launch_is_bit_equal(self, cuda, kernel):
        """The band sums and the overlap-add run in a fixed order, without
        atomics."""
        p = tp.make_params(tw.deterministic_test_model(), cuda)
        if kernel == "fwd":
            ext_a = fwd_inputs(128, 500, cuda)
            run = lambda: fk.fwd_spectrum_bands(ext_a, p["dft_fwd_pad"], p["band_e_pad"], 500)
        elif kernel == "win":
            wins = win_inputs(128, 500, cuda)
            run = lambda: fk.win_spectrum_bands(wins, p["dft_fwd_pad"], p["band_e_pad"])
        else:
            Y, mem = (t(a).to(cuda) for a in inv_inputs(128, 500, seed=8))
            run = lambda: fk.inv_spectrum_ola(Y, p["dft_inv_a"], p["dft_inv_b"], mem)
        a1, b1 = run()
        a2, b2 = run()
        assert torch.equal(a1, a2) and torch.equal(b1, b2)

    # K6 takes runs of 15 output frames: F = 15, 16, 17 and 33 cross run ends.
    @pytest.mark.parametrize("S,F", CARD_SHAPES + [(3, 15), (3, 16), (3, 17), (5, 33)])
    def test_inv_spectrum_ola(self, cuda, S, F):
        p = tp.make_params(tw.deterministic_test_model(), cuda)
        Y, mem = inv_inputs(S, F, seed=7)
        Y, mem = t(Y).to(cuda), t(mem).to(cuda)
        before = fk.inv_spectrum_ola.launches
        out, new_mem = fk.inv_spectrum_ola(Y, p["dft_inv_a"], p["dft_inv_b"], mem)
        rout, rmem = fk.inv_spectrum_ola_reference(Y, p["dft_inv_a"], p["dft_inv_b"], mem)
        torch.cuda.synchronize()
        assert fk.inv_spectrum_ola.launches == before + 1
        assert float((out - rout).abs().max()) <= 1e-5 * float(rout.abs().max())
        assert float((new_mem - rmem).abs().max()) <= 1e-5 * float(rmem.abs().max())

    def test_inv_spectrum_ola_ignores_pad_columns(self, cuda):
        """The kernel never reads Y's pad columns 481..511 and 993..1023."""
        p = tp.make_params(tw.deterministic_test_model(), cuda)
        Y, mem = (t(a).to(cuda) for a in inv_inputs(9, 20, seed=9))
        Yg = Y.clone()
        Yg[..., NFREQ: fk.IM0] = float("nan")
        Yg[..., fk.IM0 + NFREQ:] = -3e38
        a = fk.inv_spectrum_ola(Y, p["dft_inv_a"], p["dft_inv_b"], mem)
        b = fk.inv_spectrum_ola(Yg, p["dft_inv_a"], p["dft_inv_b"], mem)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    def test_wrappers_reject_bad_input(self, cuda):
        p = tp.make_params(tw.deterministic_test_model(), cuda)
        wins = torch.zeros((2, 3, WIN), dtype=torch.float64, device=cuda)
        with pytest.raises(ValueError, match="wins"):
            fk.win_spectrum_bands(wins, p["dft_fwd_pad"], p["band_e_pad"])
        flat = torch.zeros(2 * 3 * WIN + 1, device=cuda)
        with pytest.raises(ValueError, match="aligned"):  # contiguous, 4 bytes off
            fk.win_spectrum_bands(flat[1:].view(2, 3, WIN), p["dft_fwd_pad"], p["band_e_pad"])
        ext = torch.zeros((2, 4 * FRAME), device=cuda)
        with pytest.raises(ValueError, match="fwd_spectrum_bands"):
            fk.fwd_spectrum_bands(ext, p["dft_fwd_pad"], p["band_e_pad"], 4)
        with pytest.raises(ValueError, match="Y"):
            fk.inv_spectrum_ola(torch.zeros((2, 3, 962), device=cuda), p["dft_inv_a"],
                                p["dft_inv_b"], torch.zeros((2, FRAME), device=cuda))
        flat = torch.zeros(2 * 3 * fk.YPAD + 1, device=cuda)
        with pytest.raises(ValueError, match="aligned"):
            fk.inv_spectrum_ola(flat[1:].view(2, 3, fk.YPAD), p["dft_inv_a"], p["dft_inv_b"],
                                torch.zeros((2, FRAME), device=cuda))

    def test_fused_denoise_on_card_matches_cpu(self, cuda, monkeypatch):
        monkeypatch.setenv("CRISPY_FUSED_SPECTRA", "on")
        audio, F = _two_blocks()
        model = tw.deterministic_test_model()
        got = tp.denoise_batch(audio, model=model, block_frames=F)
        want = tp.denoise_batch(audio, model=model, block_frames=F, device="cpu")
        np.testing.assert_allclose(got, want, atol=ORACLE_ATOL)
