"""The port's live-monitoring path (crispy_tpu_torch): the streaming
resamplers, the legacy and RNNoise processors, NsState, MonitoringEngine and
the graphed single-frame step.

On the CPU the same numpy inputs go through the JAX package's classes and
the port's: the host code (resamplers, legacy models) must give the same
bits, the RNNoise stream agree within 5e-5 (the JAX package's CPU path) and
1.5e-4 (the NumPy oracle). The ``gpu`` tests hold K1-K6 to their plain
versions at the monitoring shapes (one stream, one frame a step, and three
streams of two frames), and the graphed step to the eager step bit for bit.
"""

import numpy as np
import pytest
import torch

from crispy_tpu_torch.api.events import EventBus
from crispy_tpu_torch.dsp import resample as tres
from crispy_tpu_torch.dsp.rnnoise import frontend_kernels as fk
from crispy_tpu_torch.dsp.rnnoise import ops_kernels as ok
from crispy_tpu_torch.dsp.rnnoise import oracle as toracle
from crispy_tpu_torch.dsp.rnnoise import pipeline as tp
from crispy_tpu_torch.dsp.rnnoise import rd_rows
from crispy_tpu_torch.dsp.rnnoise import rnn_kernels as rk
from crispy_tpu_torch.dsp.rnnoise import weights as tw
from crispy_tpu_torch.dsp.rnnoise.graphed import GraphedBlockStep
from crispy_tpu_torch.engine import denoiser as tden
from crispy_tpu_torch.engine import monitoring as tmon
from torch_audio import one_torch_thread, speechlike  # noqa: F401

try:  # the reference; the card's machine has no JAX and runs only the gpu tests
    from crispy_tpu.api.events import EventBus as JEventBus
    from crispy_tpu.dsp import resample as jres
    from crispy_tpu.dsp.rnnoise.weights import deterministic_test_model
    from crispy_tpu.engine import denoiser as jden
    from crispy_tpu.engine import monitoring as jmon
except ImportError:
    jden = None
needs_jax = pytest.mark.skipif(jden is None, reason="the JAX reference is not installed")

FRAME = 480
JAX_ATOL = 5e-5  # tests/test_torch_rnnoise_pipeline.py: the port vs the JAX package
ORACLE_ATOL = 1.5e-4  # tests/test_rnnoise_jax.py's tolerance
RATE_CASES = [(44100, 48000), (48000, 44100), (48000, 16000), (16000, 48000), (22050, 48000)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def push_all(proc, x, blk):
    """x pushed in blocks of blk samples (``push_block``, or a resampler's
    ``process``); the concatenated outputs."""
    push = getattr(proc, "push_block", None) or proc.process
    outs = [push(x[i: i + blk]) for i in range(0, len(x), blk)]
    outs = [o for o in outs if o is not None]
    return np.concatenate(outs) if outs else np.zeros(0, np.float32)


# ---------------------------------------------------------------------------
# Streaming resamplers (host NumPy): bit-equal to the JAX package's
# ---------------------------------------------------------------------------

@needs_jax
class TestResamplers:
    @pytest.mark.parametrize("rates", RATE_CASES)
    @pytest.mark.parametrize("blk", [1, 37, 441, 4096])
    def test_linear_resampler_bit_equal(self, rates, blk):
        x = np.random.default_rng(blk).standard_normal(9000).astype(np.float32)
        a, b = tres.LinearResampler(*rates), jres.LinearResampler(*rates)
        np.testing.assert_array_equal(push_all(a, x, blk), push_all(b, x, blk))
        assert (a.input_pos, a.next_output_pos) == (b.input_pos, b.next_output_pos)

    def test_linear_resampler_bypass_and_rate_swap(self):
        x = np.random.default_rng(3).standard_normal(3000).astype(np.float32)
        a, b = tres.LinearResampler(48000, 48000.5), jres.LinearResampler(48000, 48000.5)
        assert a.bypass and b.bypass
        np.testing.assert_array_equal(a.process(x), x)
        for r in (a, b):
            r.process(x[:700])
            r.set_rates(44100, 48000)  # a swap resets the whole state
        np.testing.assert_array_equal(push_all(a, x, 333), push_all(b, x, 333))

    @pytest.mark.parametrize("rates", RATE_CASES + [(48000, 48000)])
    def test_pull_resampler_bit_equal(self, rates):
        rng = np.random.default_rng(sum(rates))
        a = tres.PullResampler(rates[0], rates[1], max_len=2000)
        b = jres.PullResampler(rates[0], rates[1], max_len=2000)
        assert a.next_sample_opt() is None and b.next_sample_opt() is None
        for _ in range(6):
            x = rng.standard_normal(int(rng.integers(1, 900))).astype(np.float32)
            a.push(x)
            b.push(x)
            n = int(rng.integers(1, 1200))  # pulls past the buffer: the 0.0 paths
            assert [a.next_sample() for _ in range(n)] == [b.next_sample() for _ in range(n)]
        assert a.resample_pos == b.resample_pos

    def test_pull_resampler_full_buffer_drops_oldest(self):
        """Pushed past max_len with nothing pulled (the monitoring engine's
        case: no output device reads it), the buffer keeps the newest
        max_len samples, as the JAX package's does."""
        x = np.random.default_rng(8).standard_normal(7 * FRAME).astype(np.float32)
        a = tres.PullResampler(48000, 44100, max_len=1000)
        b = jres.PullResampler(48000, 44100, max_len=1000)
        for i in range(7):
            a.push(x[i * FRAME: (i + 1) * FRAME])
            b.push(x[i * FRAME: (i + 1) * FRAME])
        assert len(a._buf) == len(b._buf) == 1000
        assert [a.next_sample() for _ in range(1200)] == [b.next_sample() for _ in range(1200)]

    @pytest.mark.parametrize("rates", RATE_CASES + [(48000, 48000)])
    def test_resample_block_bit_equal(self, rates):
        x = np.random.default_rng(7).standard_normal(4411).astype(np.float32)
        np.testing.assert_array_equal(tres.resample_block(x, *rates),
                                      jres.resample_block(x, *rates))
        assert tres.resample_block(x[:0], *rates).size == 0


# ---------------------------------------------------------------------------
# Processors and NsState on the CPU
# ---------------------------------------------------------------------------

@needs_jax
class TestLegacyProcessor:
    @pytest.mark.parametrize("kind", ["dummy", "noisy"])
    @pytest.mark.parametrize("rates", [(48000, 48000), (44100, 48000)])
    def test_bit_equal_per_sample_and_per_block(self, kind, rates):
        x = speechlike(2000, seed=21, sr=rates[0])
        a = tden.LegacyProcessor(*rates, kind, 0.7)
        b = jden.LegacyProcessor(*rates, kind, 0.7)
        assert [a.push_sample(float(s)) for s in x[:300]] == \
            [b.push_sample(float(s)) for s in x[:300]]
        np.testing.assert_array_equal(push_all(a, x[300:], 480), push_all(b, x[300:], 480))
        assert [a.next_sample() for _ in range(2500)] == [b.next_sample() for _ in range(2500)]
        assert a.output_block_rate_hz == b.output_block_rate_hz == rates[0]
        assert a.produced_rate_hz == b.produced_rate_hz


class TestRnnNoiseProcessor:
    @needs_jax
    @pytest.mark.parametrize("sr,blk", [(48000, 480), (48000, 1000), (44100, 441)])
    def test_matches_jax_processor(self, sr, blk):
        """>= 40 frames through the JAX processor and the port's on the CPU
        (the port's step takes the plain versions of the kernels)."""
        x = speechlike(int(sr * 0.45), seed=23, sr=sr)
        a = tden.RnnNoiseProcessor(sr, 48000, 0.9, model=tw.deterministic_test_model(),
                                   device="cpu")
        b = jden.RnnNoiseProcessor(sr, 48000, 0.9, model=deterministic_test_model())
        got, want = push_all(a, x, blk), push_all(b, x, blk)
        assert got.shape == want.shape and got.size >= 40 * FRAME
        np.testing.assert_allclose(got, want, atol=JAX_ATOL, rtol=0)
        assert [a.next_sample() for _ in range(700)] == pytest.approx(
            [b.next_sample() for _ in range(700)], abs=JAX_ATOL)
        assert a.output_block_rate_hz == b.output_block_rate_hz == 48000.0
        assert a.produced_rate_hz == b.produced_rate_hz

    def test_matches_oracle_and_own_batch_after_first_frame_drop(self):
        model = tw.deterministic_test_model()
        x = speechlike(42 * FRAME, seed=24)
        p = tden.RnnNoiseProcessor(48000, 48000, 1.0, model=model, device="cpu")
        assert p.push_block(x[:FRAME]) is None  # the first frame is dropped
        got = push_all(p, x[FRAME:], 960)
        assert got.size == 41 * FRAME
        want = np.clip(toracle.denoise_stream(x, model), -1.0, 1.0)[FRAME:]
        np.testing.assert_allclose(got, want, atol=ORACLE_ATOL, rtol=0)
        batch = tden.denoise_array(x, model=model, device="cpu")[FRAME:]
        np.testing.assert_allclose(got, batch, atol=JAX_ATOL, rtol=0)

    def test_volume_and_clip(self):
        model = tw.deterministic_test_model()
        x = speechlike(6 * FRAME, seed=25)
        full = tden.RnnNoiseProcessor(48000, 48000, 1.0, model=model, device="cpu")
        half = tden.RnnNoiseProcessor(48000, 48000, 0.5, model=model, device="cpu")
        np.testing.assert_array_equal(push_all(half, x, FRAME),
                                      push_all(full, x, FRAME) * np.float32(0.5))
        assert tden.RnnNoiseProcessor(48000, 48000, 3.0, model=model, device="cpu").volume == 1.0


@needs_jax
def test_single_frame_stream_matches_jax_at_a_pitch_near_tie():
    """chip_smoke.py [9a]'s 400 frames through the port's single-frame step
    on the CPU and through the JAX package's (``_denoise_block_jit``, its
    streaming step): the same pitch index on every frame and outputs within
    5e-5. Both are held to the oracle at 1.5e-4 as [9a] holds the card: on
    every frame but one whose pitch index departs from the oracle's at a
    near-tie (one apart) and the frame after it."""
    import importlib.util
    from pathlib import Path

    from crispy_tpu.dsp.rnnoise import jax_pipeline as jp
    from crispy_tpu.dsp.rnnoise.weights import builtin_model

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    n = cs.MON_FRAMES
    x = cs.speechlike(n * FRAME, np.random.default_rng(cs.SEED + 4), 130.0)
    frames = x.reshape(n, FRAME)
    ost = toracle.DenoiseState(model=tw.builtin_model())
    want, p_oracle = [], []
    for f in frames:
        want.append(ost.process_frame(f * np.float32(32768.0))[0] / np.float32(32768.0))
        p_oracle.append(ost.last_period)
    params = tp.make_params(tw.builtin_model(), "cpu")
    jparams = jp.make_params(builtin_model())
    state, jstate = tp.init_state(1, "cpu"), jp.init_state(1)
    got, jgot, p_port, p_jax = [], [], [], []
    with torch.no_grad():
        for f in frames:
            state, o, _ = tp.denoise_block(params, state, torch.from_numpy(f[None]))
            jstate, jo, _ = jp._denoise_block_jit(jparams, jstate, f[None])
            got.append(o.numpy()[0])
            jgot.append(np.asarray(jo)[0])
            p_port.append(int(state["last_period"][0]))
            p_jax.append(int(np.asarray(jstate["last_period"])[0]))
    got, jgot, want = np.stack(got), np.stack(jgot), np.stack(want)
    assert p_port == p_jax
    np.testing.assert_allclose(got, jgot, atol=JAX_ATOL, rtol=0)
    flips = np.nonzero(np.array(p_port) != np.array(p_oracle))[0]
    assert flips.size <= n // 100
    assert all(abs(p_port[f] - p_oracle[f]) <= 2 for f in flips)
    near = np.zeros(n, bool)
    near[flips] = True
    near[np.minimum(flips + 1, n - 1)] = True
    for out in (got, jgot):
        assert np.abs(out - want).max(axis=1)[~near].max() <= ORACLE_ATOL


class TestNsState:
    def test_hot_swap_and_volume(self):
        st = tden.NsState("dummy", 48000, 48000, volume=0.8,
                          rnn_model=tw.deterministic_test_model(), device="cpu")
        assert st.push_sample(1.0) == [pytest.approx(0.8)]
        st.volume = 2.0  # clamped to 1.0 (audio.rs:344)
        assert st.volume == 1.0
        st.set_model("noisy")
        assert st.model_name == "noisy" and isinstance(st._proc, tden.LegacyProcessor)
        st.volume = 0.3
        st.set_model("rnnoise")  # keeps the volume, warms up before the swap
        assert isinstance(st._proc, tden.RnnNoiseProcessor)
        assert st.volume == pytest.approx(0.3) and st.produced_rate_hz == 48000.0
        assert not st._proc.first_frame  # the warm-up frame took the drop

    def test_accepts_reference_rnnnoise_id(self):
        st = tden.NsState("rnnnoise", 48000, 48000, volume=1.0,
                          rnn_model=tw.deterministic_test_model(), device="cpu")
        assert isinstance(st._proc, tden.RnnNoiseProcessor)

    @needs_jax
    def test_hot_swap_stream_matches_jax(self):
        """A swap from noisy to rnnoise mid-stream: the same samples as the
        JAX NsState, the warm-up frame included."""
        x = speechlike(20 * FRAME, seed=26)
        a = tden.NsState("noisy", 48000, 48000, 0.8, rnn_model=tw.deterministic_test_model(),
                         device="cpu")
        b = jden.NsState("noisy", 48000, 48000, 0.8, rnn_model=deterministic_test_model())
        for st in (a, b):
            for s in x[:100]:
                st.push_sample(float(s))
            st.set_model("rnnoise")
        got = push_all(a._proc, x[100:], FRAME)
        want = push_all(b._proc, x[100:], FRAME)
        assert got.shape == want.shape and got.size > 0
        np.testing.assert_allclose(got, want, atol=JAX_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# MonitoringEngine on the CPU
# ---------------------------------------------------------------------------

def finite_device(mod, n_blocks, blk=FRAME, rate=48000.0):
    """An input device of n_blocks speech-like blocks, then end of input."""
    x = speechlike(n_blocks * blk, seed=27, sr=int(rate))
    pos = {"i": 0}

    def fn(n):
        i = pos["i"]
        pos["i"] += n
        return x[i: i + n]

    return mod.InputDevice("finite", fn, rate)


def run_engine(mod, bus, n_blocks, **kw):
    taps = []
    reg = mod.DeviceRegistry()
    reg.register(finite_device(mod, n_blocks))
    eng = mod.MonitoringEngine(registry=reg, bus=bus, mic_tap=taps.append, **kw)
    eng.realtime = False
    eng.start_monitoring("finite", model_name="rnnoise")
    eng._thread.join(timeout=120)
    assert not eng.active, "the monitor loop did not reach the end of its input"
    eng.stop_monitoring()
    return np.concatenate(taps) if taps else np.zeros(0, np.float32)


class TestMonitoringEngine:
    @needs_jax
    def test_mic_tap_matches_jax_engine_and_emits_events(self):
        """Both engines over the same finite 48 kHz device (realtime off):
        the recording tap's stream agrees, and the port emits level and
        stage-timing events. No latency is asserted on the CPU."""
        bus = EventBus()
        bus.keep_history = True
        got = run_engine(tmon, bus, 45, device="cpu")
        want = run_engine(jmon, JEventBus(), 45)
        assert got.shape == want.shape and got.size == 45 * FRAME  # the warm-up took the drop
        np.testing.assert_allclose(got, want, atol=JAX_ATOL, rtol=0)
        levels = [p for e, p in bus.history if e == "microphone-level"]
        timing = [p for e, p in bus.history if e == "stage-timing"]
        assert levels and all(isinstance(v, float) and v > 0 for v in levels)
        assert timing and timing[0]["stage"] == "ns-block"
        assert timing[0]["budget_ms"] == 10.0 and timing[0]["max_ms"] > 0.0

    def test_restart_setters_and_legacy_path(self):
        bus = EventBus()
        eng = tmon.MonitoringEngine(bus=bus, device="cpu")
        eng.realtime = False
        eng.start_monitoring(model_name="dummy", volume=0.5)
        first = eng._thread
        eng.start_monitoring(model_name="dummy", volume=0.25)  # idempotent: retunes
        assert eng._thread is first and eng._ns.volume == 0.25
        eng.set_monitoring_volume(0.75)
        assert eng._ns.volume == 0.75
        eng.set_monitoring_model("noisy")
        assert eng._ns.model_name == "noisy"
        eng.stop_monitoring()
        assert not eng.active
        assert eng.get_blackhole_status() == {"installed": False, "paths": []}
        assert eng.registry.get_output_devices() == ["Default"]
        assert eng.registry.get_default_devices()["default_input"] == "Synthetic 440Hz"


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

MONITOR_SHAPES = [(1, 1), (3, 2)]


def k1_inputs(S, F, dev, seed=31):
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.standard_normal((S, F, 42)).astype(np.float32)).to(dev)
    sil = torch.from_numpy(rng.random((S, F)) < 0.3).to(dev)
    state = tp.init_state(S, dev)
    for k in ("gru_vad", "gru_noise", "gru_denoise", "lastg"):
        state[k] = torch.from_numpy(rng.random(tuple(state[k].shape)).astype(np.float32)).to(dev)
    return feats, sil, state


def k3_inputs(S, F, dev, seed=32):
    rng = np.random.default_rng(seed)
    L = tp.HIST + 1 + F * FRAME
    ext = torch.from_numpy(rng.standard_normal((S, L)).astype(np.float32) * 1e3).to(dev)
    pidx = rng.integers(60, 768, (S, F))
    starts = 1 + np.arange(F)[None, :] * FRAME + (tp.PBUF - tp.WIN) - pidx
    return ext, torch.from_numpy(starts.astype(np.int32)).to(dev)


@pytest.mark.gpu
class TestKernelsAtMonitoringShapes:
    """Each kernel against its plain version at one stream, one frame (the
    monitoring step) and at three streams of two frames: at F=1 there is no
    frame to prefetch and at S=1 three of K2's four warps are idle."""

    @pytest.mark.parametrize("S,F", MONITOR_SHAPES)
    def test_k1_resident(self, cuda, S, F):
        params = tp.make_params(tw.builtin_model(), cuda)
        feats, sil, state = k1_inputs(S, F, cuda)
        before = rk.nn_scan.launches
        a, st_a = rk.nn_scan(params, state, feats, sil)
        assert rk.nn_scan.launches == before + 1  # the resident variant
        b, st_b = rk.nn_scan_reference(params, state, feats, sil)
        for x, y in list(zip(a, b)) + [(st_a[k], st_b[k]) for k in st_a]:
            torch.testing.assert_close(x, y, atol=1e-5, rtol=0)

    @pytest.mark.parametrize("S,F", MONITOR_SHAPES)
    @pytest.mark.parametrize("kind", ["random", "continuation"])
    def test_k2(self, cuda, S, F, kind):
        rng = np.random.default_rng(S * 10 + F)
        rows = getattr(rd_rows, f"{kind}_rows")(rng, S, F)
        args = tuple(torch.from_numpy(x).to(cuda) for x in rows)
        for x, y in zip(rk.rd_scan(*args), rk.rd_scan_reference(*args)):
            assert torch.equal(x, y)

    @pytest.mark.parametrize("S,F", MONITOR_SHAPES)
    def test_k3(self, cuda, S, F):
        ext, starts = k3_inputs(S, F, cuda)
        assert torch.equal(ok.pitch_window_gather(ext, starts),
                           ok.pitch_window_gather_reference(ext, starts))

    @pytest.mark.parametrize("S,F", MONITOR_SHAPES)
    def test_k4_k5_k6(self, cuda, S, F):
        p = tp.make_params(tw.builtin_model(), cuda)
        ext, _ = k3_inputs(S, F, cuda)
        ext_a = ext[:, 1 + tp.HIST - FRAME:] * 9.0
        wins = torch.from_numpy(np.random.default_rng(33).standard_normal(
            (S, F, tp.WIN)).astype(np.float32) * 9000.0).to(cuda)
        for kern, plain in ((lambda: fk.fwd_spectrum_bands(ext_a, p["dft_fwd_pad"],
                                                            p["band_e_pad"], F),
                             lambda: fk.fwd_spectrum_bands_reference(
                                 ext_a, p["dft_fwd_pad"], p["band_e_pad"], F)),
                            (lambda: fk.win_spectrum_bands(wins, p["dft_fwd_pad"], p["band_e_pad"]),
                             lambda: fk.win_spectrum_bands_reference(
                                 wins, p["dft_fwd_pad"], p["band_e_pad"]))):
            (Y, Ex), (rY, rEx) = kern(), plain()
            assert float((Y - rY).abs().max()) <= 1e-5 * float(rY.abs().max())
            torch.testing.assert_close(Ex, rEx, rtol=1e-4, atol=0.0)
        Y = fk.fwd_spectrum_bands_reference(ext_a, p["dft_fwd_pad"], p["band_e_pad"], F)[0]
        mem = torch.from_numpy(np.random.default_rng(34).standard_normal(
            (S, FRAME)).astype(np.float32) * 9000.0).to(cuda)
        out, new = fk.inv_spectrum_ola(Y.contiguous(), p["dft_inv_a"], p["dft_inv_b"], mem)
        rout, rnew = fk.inv_spectrum_ola_reference(Y, p["dft_inv_a"], p["dft_inv_b"], mem)
        assert float((out - rout).abs().max()) <= 1e-5 * float(rout.abs().max())
        assert float((new - rnew).abs().max()) <= 1e-5 * float(rnew.abs().max())


def eager_stream(params, frames, dev):
    state = tp.init_state(1, dev)
    outs = []
    with torch.no_grad():
        for f in frames:
            state, o, _ = tp.denoise_block(params, state, torch.from_numpy(f[None]).to(dev))
            outs.append(o.cpu())
    return torch.cat(outs, dim=1)


@pytest.mark.gpu
class TestGraphedStep:
    @pytest.mark.parametrize("fused", ["off", "on"])
    def test_graph_bit_equal_to_eager(self, cuda, fused, monkeypatch):
        """200 frames through the graph and through eager denoise_block on
        the card: the same bits, and each replay counts its launches."""
        monkeypatch.setenv("CRISPY_FUSED_SPECTRA", fused)
        params = tp.make_params(tw.builtin_model(), cuda)
        x = speechlike(200 * FRAME, seed=41)
        frames = x.reshape(200, FRAME)
        step = GraphedBlockStep(params, 1, 1, cuda)
        before = (rk.nn_scan.launches, rk.rd_scan.launches, ok.pitch_window_gather.launches,
                  fk.inv_spectrum_ola.launches)
        got = torch.cat([step.step(f[None]) for f in frames], dim=1)
        ran = (rk.nn_scan.launches - before[0], rk.rd_scan.launches - before[1],
               ok.pitch_window_gather.launches - before[2],
               fk.inv_spectrum_ola.launches - before[3])
        assert ran == (200, 200, 200, 200 if fused == "on" else 0)
        want = eager_stream(params, frames, cuda)
        assert torch.equal(got, want)
        want_oracle = toracle.denoise_stream(x, tw.builtin_model())
        np.testing.assert_allclose(got.numpy()[0], want_oracle, atol=ORACLE_ATOL, rtol=0)

    def test_hot_swap_to_rnnoise_while_monitoring(self, cuda):
        """The model swapped to rnnoise from another thread while the
        monitor loop runs (paced): the new processor captures its graph
        beside the running loop, which then goes on through it to the end
        of the device with one 480-sample output a block."""
        import time

        taps = []
        reg = tmon.DeviceRegistry()
        reg.register(finite_device(tmon, 300))
        eng = tmon.MonitoringEngine(registry=reg, bus=EventBus(), mic_tap=taps.append)
        eng.start_monitoring("finite", model_name="noisy")
        time.sleep(0.5)
        eng.set_monitoring_model("rnnoise")
        assert isinstance(eng._ns._proc, tden.RnnNoiseProcessor)
        eng._thread.join(timeout=60)
        assert not eng.active
        eng.stop_monitoring()
        out = np.concatenate(taps)
        assert out.size == 300 * FRAME and np.isfinite(out).all()

    def test_graph_survives_k1_weight_eviction(self, cuda):
        """A denoise_array with other weights on the same card evicts the
        graph's packed K1 weights from the wrapper's cache; the graph holds
        its own reference, so the stream goes on equal to the eager one."""
        params = tp.make_params(tw.builtin_model(), cuda)
        x = speechlike(60 * FRAME, seed=42)
        frames = x.reshape(60, FRAME)
        proc = tden.RnnNoiseProcessor(48000, 48000, 1.0, params=params, device=cuda)
        first = push_all(proc, x[: 30 * FRAME], FRAME)
        other = tp.make_params(tw.deterministic_test_model(), cuda)
        tden.denoise_array(speechlike(4 * FRAME, seed=43), params=other, device=cuda)
        assert all(k[1][0][0] != id(params[rk._MATRICES[0]]) for k in rk._HALF_WEIGHTS)
        torch.cuda.empty_cache()
        junk = torch.full((1 << 22,), 7.0, device=cuda)  # reuse any freed memory
        rest = push_all(proc, x[30 * FRAME:], FRAME)
        del junk
        want = np.clip(eager_stream(params, frames, cuda).numpy()[0], -1.0, 1.0)[FRAME:]
        np.testing.assert_array_equal(np.concatenate([first, rest]), want)

