"""The port's diarization nets from .onnx files (crispy_tpu_torch.models.
onnx_nets) and ``run_diarization``'s executor route, against the JAX
package's, on the CPU.

The JAX package's cases (test_diarization_onnx: the runner shapes, the
embedding buckets, the executor route with no fallback event, the fallback
event, the device frontend against the host path) run with its runners
swapped for pairs that compute the port's output beside every JAX call:
segmentation logits within 1e-5 of their largest magnitude. The fixture's
embedding net is the time mean of CMN'd features, which is zero up to f32
rounding (|e| ~ 1e-5), so its embeddings are held at 1e-4 absolute; a
CAM++-scale graph (tools/bench_bundles, C=32) holds them at 1e-4 of their
largest magnitude, on the host and the one-upload routes. Then the port's
own ``run_diarization`` and ``diarize`` on the same files: equal text,
speaker segments and events.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the JAX reference is not installed")
import jax.numpy as jnp  # noqa: E402
import test_diarization_onnx as jcases
from crispy_tpu.api.events import EventBus as JEventBus
from crispy_tpu.engine import diarization as jd
from crispy_tpu.models import onnx_nets as jn
from crispy_tpu_torch.api.events import EventBus
from crispy_tpu_torch.engine import diarization as td
from crispy_tpu_torch.models import onnx_nets as tn
from torch_audio import one_torch_thread  # noqa: F401 (autouse fixture)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import bench_bundles  # noqa: E402

SEG_RTOL = 1e-5  # segmentation logits, x their largest magnitude
EMB_RTOL = 1e-4  # embeddings, x their largest magnitude
NOISE_ATOL = 1e-4  # the fixture's embeddings (f32 rounding of a zero mean)
JSeg, JEmb = jn.segmentation_runner, jn.embedding_runner


def close(got, want, rtol: float, atol: float = 0.0) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max(initial=0.0)) <= rtol * float(
        np.abs(want).max(initial=0.0)) + atol


def dual_runner(jmake, tmake, rtol: float, atol: float = 0.0):
    """A runner factory whose runners compute the port's output beside each
    JAX call (host windows or chunks, and ``from_device`` on the same int16
    recording) and return the JAX package's."""

    def make(path, *args, **kwargs):
        j = jmake(path, *args, **kwargs)
        t = tmake(path, *args, device="cpu", **kwargs)

        def call(x):
            want = j(x)
            close(t(x), want, rtol, atol)
            return want

        def from_device(dev, *args, mesh=None):
            want = j.from_device(dev, *args, mesh=mesh)
            close(t.from_device(torch.from_numpy(np.array(dev)), *args), want, rtol, atol)
            return want

        call.from_device = from_device
        return call

    return make


JAX_CASES = ["test_segmentation_runner_shapes", "test_embedding_runner_buckets",
             "test_run_diarization_uses_onnx_no_fallback_event",
             "test_run_diarization_fallback_emits_event",
             "test_device_net_frontend_matches_host_path"]


@pytest.mark.parametrize("name", JAX_CASES)
def test_jax_case_through_both_packages(name, tmp_path, monkeypatch):
    monkeypatch.setattr(jn, "segmentation_runner",
                        dual_runner(JSeg, tn.segmentation_runner, SEG_RTOL))
    monkeypatch.setattr(jn, "embedding_runner",
                        dual_runner(JEmb, tn.embedding_runner, 0.0, NOISE_ATOL))
    fn = getattr(jcases, name)
    fn(**{k: v for k, v in (("tmp_path", tmp_path), ("monkeypatch", monkeypatch))
          if k in fn.__code__.co_varnames[:fn.__code__.co_argcount]})


def test_campplus_scale_embeddings(tmp_path):
    """A CAM++-scale graph (TDNN stack, stats pooling): the host route's
    buckets and the one-upload route's slices, a slice past the end
    included, within EMB_RTOL of the JAX package's."""
    p = bench_bundles.make_campplus_scale_embedding(tmp_path / "cam.onnx", C=32, emb_dim=16)
    j, t = JEmb(p), tn.embedding_runner(p, device="cpu")
    segs = [np.random.default_rng(i).standard_normal(16000 * s).astype(np.float32) * 0.3
            for i, s in enumerate([2, 3, 2, 1])]
    want = j(segs)
    assert want.shape == (4, 16) and np.abs(want).max() > 1e-4
    close(t(segs), want, EMB_RTOL)
    q = (np.random.default_rng(5).standard_normal(160000 * 2) * 3000).astype(np.int16)
    ranges = [(0, 32000), (100, 32100), (300000, 330000), (5, 20005), (310000, 320000)]
    want = j.from_device(jnp.asarray(q), ranges)
    close(t.from_device(torch.from_numpy(q), ranges), want, EMB_RTOL)
    assert t([]).shape == (0, 0) and t.from_device(torch.from_numpy(q), []).shape == (0, 0)


def test_single_window_and_rank2_exports(tmp_path):
    """A [B, T] waveform input and a [F, C] output: the rank is read from
    the graph and the batch axis is added, as in the JAX package."""
    import onnx_builder as ob

    w = np.random.default_rng(2).standard_normal((5, 3)).astype(np.float32)
    p = tmp_path / "seg2.onnx"
    ob.write_model(p, [
        ob.node("Reshape", ["waveform", "shp"], ["fr"]),  # [1, 160000] → [F, 5] frames
        ob.node("Slice", ["fr", "z", "five", "one"], ["fr5"]),
        ob.node("MatMul", ["fr5", "w"], ["logits"]),
    ], [("waveform", 1, [1, 160000])], [("logits", 1, [None, 3])],
        {"shp": np.array([-1, 5], np.int64), "w": w, "z": np.array([0], np.int64),
         "five": np.array([5], np.int64), "one": np.array([1], np.int64)})
    x = np.random.default_rng(3).standard_normal((1, 160000)).astype(np.float32)
    want = JSeg(p)(x)
    got = tn.segmentation_runner(p, device="cpu")(x)
    assert got.shape == want.shape == (1, 32000, 3)
    close(got, want, SEG_RTOL)


def run_both(mm, audio, words):
    tbus, jbus = EventBus(), JEventBus()
    tbus.keep_history = jbus.keep_history = True
    got = td.run_diarization(audio, 16000, words, model_manager=mm, bus=tbus, device="cpu")
    want = jd.run_diarization(audio, 16000, words, model_manager=mm, bus=jbus)
    return got, want, tbus.history, jbus.history


def test_run_diarization_executor_route(tmp_path, monkeypatch):
    """The port's run_diarization builds both onnx_nets runners and emits
    no event; its text equals the JAX package's."""
    mm = jcases.StubManager(jcases.make_segmentation_onnx(tmp_path / "seg.onnx"),
                            bench_bundles.make_campplus_scale_embedding(
                                tmp_path / "cam.onnx", C=32, emb_dim=16))
    built = []
    for name in ("segmentation_runner", "embedding_runner"):
        fn = getattr(tn, name)
        monkeypatch.setattr(tn, name,
                            lambda *a, fn=fn, **k: built.append(fn.__name__) or fn(*a, **k))
    got, want, tev, jev = run_both(mm, jcases.speech_audio(8),
                                   [(0.0, 4.0, "hello"), (4.0, 8.0, "world")])
    assert got == want and "hello" in got and "world" in got
    assert built == ["segmentation_runner", "embedding_runner"]
    assert not tev and not jev


def test_run_diarization_fallback_event(tmp_path):
    """An unsupported graph: one diarization-fallback event for that net in
    both packages; the port's text names the executor's error first (the
    JAX package's text), then the native port's."""
    import onnx_builder as ob

    bad = tmp_path / "bad.onnx"
    ob.write_model(bad, [ob.node("TotallyCustomOp", ["waveform"], ["logits"])],
                   [("waveform", 1, [None, 1, 160000])], [("logits", 1, [None, 589, 7])])
    got, want, tev, jev = run_both(jcases.StubManager(seg_path=bad),
                                   jcases.speech_audio(4), [(0.0, 4.0, "hi")])
    assert got == want and "hi" in got
    assert [e for e, _ in tev] == [e for e, _ in jev] == ["diarization-fallback"]
    (_, t), (_, j) = tev[0], jev[0]
    assert t["net"] == j["net"] == "segmentation"
    assert t["error"].startswith(j["error"]) and "TotallyCustomOp" in j["error"]
    assert "native port:" in t["error"]


def test_device_route_equals_host_route_and_jax(tmp_path, monkeypatch):
    """150 s (the one-upload route) with the executor nets: the port's
    device route equals its host route and the JAX package's device route,
    speaker segment for speaker segment."""
    seg_p = jcases.make_segmentation_onnx(tmp_path / "seg.onnx")
    emb_p = bench_bundles.make_campplus_scale_embedding(tmp_path / "cam.onnx", C=32,
                                                        emb_dim=16)
    sr = 16000
    rng = np.random.default_rng(7)
    audio = np.zeros(sr * 150, np.float32)
    for a, b, f in [(5, 40, 150), (50, 85, 1300), (95, 145, 150)]:
        t = np.arange((b - a) * sr) / sr
        seg = 0.4 * np.sin(2 * np.pi * f * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
        audio[a * sr: b * sr] = seg + 0.01 * rng.standard_normal(len(t))
    audio = (np.round(audio * 32768.0).clip(-32768, 32767) / 32768.0).astype(np.float32)
    nets = dict(segmentation_fn=tn.segmentation_runner(seg_p, device="cpu"),
                embedding_fn=tn.embedding_runner(emb_p, device="cpu"))
    calls = []
    real = td._diarize_device_nets
    monkeypatch.setattr(td, "_diarize_device_nets",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    dev = td.diarize(audio, 16000, max_speakers=4, device="cpu", **nets)
    assert calls, "the one-upload route was not taken"
    monkeypatch.setenv("CRISPY_DIAR_FUSED", "off")
    host = td.diarize(audio, 16000, max_speakers=4, device="cpu", **nets)
    monkeypatch.setenv("CRISPY_DIAR_FUSED", "on")
    want = jd.diarize(audio, 16000, max_speakers=4, segmentation_fn=JSeg(seg_p),
                      embedding_fn=JEmb(emb_p))
    segs = [[(s.start, s.end, s.speaker) for s in r] for r in (dev, host, want)]
    assert segs[0] == segs[1] == segs[2] and segs[0]


def test_runners_need_a_card(tmp_path, monkeypatch):
    p = jcases.make_segmentation_onnx(tmp_path / "seg.onnx")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tn.segmentation_runner(p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tn.embedding_runner(jcases.make_embedding_onnx(tmp_path / "emb.onnx"))
