"""The ten cases of tests/test_mesh_production.py against the port: its
product paths (run_transcription, denoise_batch, the ONNX engines, the app's
mesh, resolve_mesh, NME-SC, diarization and its two one-upload frontends)
sharded over ``make_mesh(devices=["cpu"] * 8)``, which is (4, 2), or with
``model_parallel=1`` where the JAX case uses it.

Each case holds the port sharded to the port unsharded (denoise at
JAX_ATOL, texts, labels and segments equal, margins bit-equal) and to the
JAX package's sharded run on its 8 virtual CPU devices (tests/conftest.py)
at the JAX case's own tolerance.

On the CPU no card is visible, so ``"auto"`` resolves to no mesh here; the
app cases also pretend eight cards (``torch.cuda`` patched, nothing runs on
them) to show the mesh ``"auto"`` makes then, beside the JAX package's.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the JAX reference is not installed")
from crispy_tpu import parallel as jparallel  # noqa: E402
from crispy_tpu.api.events import EventBus as JEventBus  # noqa: E402
from crispy_tpu_torch import parallel  # noqa: E402
from crispy_tpu_torch.api.events import EventBus  # noqa: E402
from crispy_tpu_torch.engine import transcription as ttr  # noqa: E402
from crispy_tpu_torch.io import wav as wavio  # noqa: E402
from crispy_tpu_torch.models.registry import ModelManager  # noqa: E402
from torch_audio import one_torch_thread  # noqa: E402,F401 (autouse fixture)

sys.path.insert(0, str(Path(__file__).parent))
import test_mesh_production as jcases  # noqa: E402

JAX_ATOL = 5e-5  # tests/test_torch_fused_spectra.py: the port against the JAX package
CPU = torch.device("cpu")


def mesh8(**kw):
    return parallel.make_mesh(devices=["cpu"] * 8, **kw)


def spans(segs):
    return [(s.start, s.end, s.speaker) for s in segs]


def same_partition(a, b) -> bool:
    """Labels equal up to relabelling (eigenvector signs differ between
    LAPACK, XLA and cuSOLVER)."""
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and len(set(zip(a.tolist(), b.tolist()))) == len(set(a.tolist())) \
        == len(set(b.tolist()))


def test_run_transcription_sharded_end_to_end(data_root, tmp_path):
    """load_engine(ggml) → run_transcription over a (4, 2) DP×TP mesh equals
    the unsharded run (random weights reach the sampled T = 1.0 rung, whose
    draws the sharded decode takes from the whole batch's); with
    temperature-0 engines the port sharded equals the JAX package sharded."""
    from crispy_tpu.engine import transcription as jtr
    from crispy_tpu.models.whisper import WhisperModel as JWhisperModel

    from crispy_tpu_torch.models.whisper import WhisperModel

    mm = ModelManager()
    mm.models_dir.mkdir(parents=True, exist_ok=True)
    jcases.write_tiny_ggml(mm.model_path("small"))
    wav = wavio.write_wav(tmp_path / "r.wav",
                          (0.1 * np.sin(np.arange(16000 * 3) / 30))[:, None].astype(np.float32),
                          16000)
    mesh = mesh8()
    assert mesh.devices.shape == (4, 2)
    tm_sharded = ttr.TranscriptionManager(mm, bus=EventBus(), mesh=mesh)
    text_sharded = ttr.run_transcription(str(wav), tm_sharded, "small")
    assert tm_sharded.engine is not None and tm_sharded.engine.model.mesh is mesh
    ttr.clear_transcription_progress(str(wav))
    tm_plain = ttr.TranscriptionManager(mm, bus=EventBus(), device="cpu")
    assert ttr.run_transcription(str(wav), tm_plain, "small") == text_sharded

    def t0(wm):
        class Engine(ttr.EngineProtocol):
            def transcribe_batch(self, chunks, language="en"):
                return wm.transcribe_chunks_robust(chunks, language=language,
                                                   temperatures=(0.0,))
        return Engine()

    path = mm.model_path("small")
    twm = WhisperModel.from_ggml(path, device="cpu").shard_to(mesh)
    jwm = JWhisperModel.from_ggml(path).shard_to(jparallel.make_mesh(8))
    ttr.clear_transcription_progress(str(wav))
    got = ttr.run_transcription(str(wav), ttr.TranscriptionManager(
        mm, bus=EventBus(), engine_loader=lambda mid, m: t0(twm), device="cpu"), "small")
    jtr.clear_transcription_progress(str(wav))
    want = jtr.run_transcription(str(wav), jtr.TranscriptionManager(
        mm, bus=JEventBus(), engine_loader=lambda mid, m: t0(jwm)), "small")
    assert got and got == want


def test_denoise_batch_sharded_matches_unsharded():
    from crispy_tpu.dsp.rnnoise import jax_pipeline as jp
    from crispy_tpu.dsp.rnnoise.weights import deterministic_test_model as jmodel

    from crispy_tpu_torch.dsp.rnnoise import pipeline as tp
    from crispy_tpu_torch.dsp.rnnoise.weights import deterministic_test_model

    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((3, 480 * 20)) * 0.3).astype(np.float32)  # S=3: pads to 4
    model = deterministic_test_model()
    want = tp.denoise_batch(audio, model, device="cpu")
    got = tp.denoise_batch(audio, model, mesh=mesh8())
    np.testing.assert_allclose(got, want, atol=JAX_ATOL, rtol=0)
    # Against the JAX package sharded, at its case's tolerance, outside the
    # frames where the two packages already part unsharded: on this white
    # noise stream 1 takes a different branch at a near-tie in frames 6-7
    # (0.089 unsharded as sharded); sharding adds no difference of its own.
    jgot = jp.denoise_batch(audio, jmodel(), mesh=jparallel.make_mesh(8))
    jwant = jp.denoise_batch(audio, jmodel())
    frames = lambda x: x.reshape(3, -1, 480)  # noqa: E731
    apart = np.abs(frames(want) - frames(jwant)).max(-1) > 1e-3  # [S, F]
    assert apart.mean() <= 0.05
    keep = ~apart[..., None].repeat(480, -1)
    np.testing.assert_allclose(frames(got)[keep], frames(jgot)[keep], atol=1e-3)
    assert np.corrcoef(frames(got)[keep], frames(jgot)[keep])[0, 1] > 0.99999
    assert np.abs(got - jgot).max() <= np.abs(want - jwant).max() + 1e-3


def test_onnx_ctc_engine_sharded_matches_unsharded(tmp_path):
    from test_onnx_engines import make_gigaam_bundle

    from crispy_tpu.engine.onnx_engines import OnnxCtcEngine as JCtc

    from crispy_tpu_torch.engine.onnx_engines import OnnxCtcEngine

    d = make_gigaam_bundle(tmp_path)
    chunks = (np.random.default_rng(2).standard_normal((3, 16000)) * 0.3
              ).astype(np.float32)  # B=3 pads to dp
    plain = OnnxCtcEngine(d, "g", device="cpu").transcribe_batch(chunks)
    sharded = OnnxCtcEngine(d, "g", mesh=mesh8()).transcribe_batch(chunks)
    assert sharded == plain
    assert sharded == JCtc(d, "g", mesh=jparallel.make_mesh(8)).transcribe_batch(chunks)


@pytest.fixture
def eight_cards(monkeypatch):
    """torch.cuda reporting eight cards; nothing is run on them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)


def test_app_auto_mesh(data_root, monkeypatch, eight_cards):
    from crispy_tpu.api.commands import CrispyApp as JApp

    from crispy_tpu_torch.api.commands import CrispyApp

    monkeypatch.setenv("CRISPY_MESH", "auto")
    app = CrispyApp(bus=EventBus())
    m = app.resolved_mesh()
    assert m is not None
    assert app.transcription_manager.mesh is m
    jm = JApp(bus=JEventBus()).resolved_mesh()
    assert m.devices.shape == jm.devices.shape == (8, 1)
    assert m.flat() == [torch.device("cuda", i) for i in range(8)]
    # an explicit mesh is kept as given
    mesh = mesh8()
    assert CrispyApp(bus=EventBus(), mesh=mesh).resolved_mesh() is mesh


def test_app_mesh_default_on_with_off_switch(data_root, monkeypatch):
    """The default is the lazy "auto": building the app and a device-free
    command never look at the cards; CRISPY_MESH=off (0, none, false) opts
    out. On one card or none "auto" resolves to no mesh."""
    from crispy_tpu.api.commands import CrispyApp as JApp

    from crispy_tpu_torch.api.commands import CrispyApp

    monkeypatch.delenv("CRISPY_MESH", raising=False)

    def no_card_query():
        raise AssertionError("a device-free path looked at the cards")

    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", no_card_query)
        mp.setattr(torch.cuda, "device_count", no_card_query)
        app = CrispyApp(bus=EventBus())
        assert app.mesh == "auto"  # lazy until something needs a device
        app.get_available_models()
    assert JApp(bus=JEventBus()).mesh == "auto"
    if not torch.cuda.is_available():
        assert app.resolved_mesh() is None  # no card: no mesh
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: True)
        mp.setattr(torch.cuda, "device_count", lambda: 8)
        assert CrispyApp(bus=EventBus()).resolved_mesh() is not None
        mp.setattr(torch.cuda, "device_count", lambda: 1)
        assert CrispyApp(bus=EventBus()).resolved_mesh() is None  # one card
    for flag in ("off", "0", "none", "false"):
        monkeypatch.setenv("CRISPY_MESH", flag)
        assert CrispyApp(bus=EventBus()).resolved_mesh() is None
    monkeypatch.setenv("CRISPY_MESH", "off")
    assert JApp(bus=JEventBus()).resolved_mesh() is None


def test_load_engine_resolves_auto_sentinel(data_root, monkeypatch):
    """load_engine(mesh="auto") shards as an explicit mesh does."""
    from crispy_tpu.engine.transcription import resolve_mesh as jresolve

    m = mesh8()
    assert ttr.resolve_mesh(None) is None
    assert ttr.resolve_mesh(m) is m
    assert ttr.resolve_mesh("auto", "cpu") is None  # the CPU asked for: no card mesh
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: True)
        mp.setattr(torch.cuda, "device_count", lambda: 8)
        auto = ttr.resolve_mesh("auto")
    jm = jresolve("auto")
    assert auto is not None and len(auto.devices.flatten()) == len(jm.devices.flatten()) == 8
    assert auto.devices.shape == jm.devices.shape
    if not torch.cuda.is_available():
        assert ttr.resolve_mesh("auto") is None


def test_nme_sc_sharded_matches_unsharded():
    """The NME-SC p-sweep split over every device of the mesh reproduces the
    single-device labels exactly: the sweep pads to a device multiple and the
    dynamic p_max bound masks the padding."""
    from crispy_tpu.engine.nme_device import nme_sc_device as jnme

    from crispy_tpu_torch.engine.nme_device import nme_sc_device

    rng = np.random.default_rng(5)
    centers = rng.standard_normal((4, 24))
    emb = np.concatenate(
        [c + 0.04 * rng.standard_normal((9, 24)) for c in centers]
    ).astype(np.float32)
    base = nme_sc_device(emb, 8, device="cpu")
    sharded = nme_sc_device(emb, 8, mesh=mesh8(model_parallel=1))
    np.testing.assert_array_equal(base, sharded)
    assert len(set(base.tolist())) >= 2  # a real multi-cluster problem
    assert same_partition(sharded, jnme(emb, 8, mesh=jparallel.make_mesh(model_parallel=1)))


def test_run_diarization_mesh_plumbed(data_root):
    """diarize/nme_sc take the mesh and match the unsharded run on the
    built-in stand-in path, and the JAX package's sharded run."""
    from crispy_tpu.engine import diarization as jdz

    from crispy_tpu_torch.engine import diarization as dz

    sr = 16000
    t = np.arange(sr * 4) / sr
    a = np.concatenate([
        (0.4 * np.sin(2 * np.pi * 200 * t[: sr * 2])).astype(np.float32),
        np.zeros(sr // 2, np.float32),
        (0.4 * np.sin(2 * np.pi * 1200 * t[: sr * 2])).astype(np.float32),
    ])
    mesh = mesh8(model_parallel=1)
    segs_m = dz.diarize(a, max_speakers=4, merge_gap=0.2, mesh=mesh)
    segs_0 = dz.diarize(a, max_speakers=4, merge_gap=0.2, device="cpu")
    assert segs_m and spans(segs_m) == spans(segs_0)
    jsegs = jdz.diarize(a, max_speakers=4, merge_gap=0.2,
                        mesh=jparallel.make_mesh(model_parallel=1))
    assert spans(segs_m) == spans(jsegs)


def test_fused_diar_frontend_sharded(data_root):
    """The one-upload frontend over the mesh: window-split energy-VAD margins
    and block-split mel statistics bit-equal to the single device's, the
    statistics within the JAX case's 5e-4 of the JAX package's sharded
    ones."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from crispy_tpu.engine import diar_device as jdd
    from crispy_tpu.engine import diarization as jdz

    from crispy_tpu_torch.engine import diar_device as dd
    from crispy_tpu_torch.engine import diarization as dz

    rng = np.random.default_rng(3)
    sr = 16000
    pieces = []
    for i in range(24):  # ≥120 s so the fused path engages for diarize()
        t = np.arange(sr * 4) / sr
        f = [200.0, 1200.0][i % 2]
        tone = 0.4 * np.sin(2 * np.pi * f * t) + 0.01 * rng.standard_normal(t.size)
        pieces += [tone.astype(np.float32), np.zeros(sr, np.float32)]
    audio = np.concatenate(pieces)
    mesh = mesh8(model_parallel=1)

    n = audio.shape[0]
    pad_to = dd.pad_length(n)
    q = dd.quantize_i16(torch.from_numpy(audio), pad_to)
    m0 = dd.segmentation_margins(q, pad_to)
    mm = dd.segmentation_margins(q, pad_to, mesh)
    np.testing.assert_array_equal(m0, mm)

    jmesh = jparallel.make_mesh(model_parallel=1)
    jq = jdd.quantize_i16(audio, pad_to).copy()
    np.testing.assert_array_equal(q.numpy(), jq)
    jdev = jax.device_put(jq, NamedSharding(jmesh, PartitionSpec()))
    np.testing.assert_allclose(mm, jdd.segmentation_margins(jdev, pad_to, jmesh), atol=JAX_ATOL)

    logits = np.stack([-m0, m0], axis=-1)
    merged = dz._runs_from_logits(logits, n, 0.5)
    segments = dz._segments_from_runs(merged, audio)
    chunks = dz.chunk_segments(segments)
    ranges = [(c.offset, c.offset + len(c.samples)) for c in chunks]
    e0 = dd.chunk_stats(q, pad_to, ranges)
    em = dd.chunk_stats(q, pad_to, ranges, mesh)
    np.testing.assert_array_equal(e0, em)  # whole log-mel blocks to each row
    assert np.abs(em - jdd.chunk_stats(jdev, pad_to, ranges, jmesh)).max() < 5e-4

    # identical embeddings → identical labels through the sharded sweep
    np.testing.assert_array_equal(dz.nme_sc(e0, 4, device="cpu"), dz.nme_sc(e0, 4, mesh=mesh))

    # and the full sharded product call completes with the unsharded result
    segs = dz.diarize(audio, max_speakers=4, merge_gap=0.5, mesh=mesh)
    assert len(segs) > 10
    assert 1 <= len({s.speaker for s in segs}) <= 4
    assert spans(segs) == spans(dz.diarize(audio, max_speakers=4, merge_gap=0.5, device="cpu"))
    jsegs = jdz.diarize(audio, max_speakers=4, merge_gap=0.5, mesh=jmesh)
    assert [(s.start, s.end) for s in segs] == [(s.start, s.end) for s in jsegs]
    assert same_partition([s.speaker for s in segs], [s.speaker for s in jsegs])


def test_device_net_diarization_sharded_matches_unsharded(tmp_path, monkeypatch):
    """The one-upload route with ONNX-executor nets under a (4, 2) mesh:
    windows and chunk batches split over 'data', the same speakers as the
    unsharded run and as the JAX package's sharded run."""
    from test_diarization_onnx import make_embedding_onnx, make_segmentation_onnx

    from crispy_tpu.models import onnx_nets as jnets

    from crispy_tpu_torch.engine import diarization as dz
    from crispy_tpu_torch.models.onnx_nets import embedding_runner, segmentation_runner

    seg_p = make_segmentation_onnx(tmp_path / "seg.onnx")
    emb_p = make_embedding_onnx(tmp_path / "emb.onnx")
    seg_fn = segmentation_runner(seg_p, device="cpu")
    emb_fn = embedding_runner(emb_p, device="cpu")

    sr = 16000
    rng = np.random.default_rng(3)
    audio = np.zeros(sr * 150, np.float32)
    for a, b, f in [(4, 42, 170), (52, 88, 300), (96, 146, 170)]:
        t = np.arange((b - a) * sr) / sr
        audio[a * sr: b * sr] = (0.4 * np.sin(2 * np.pi * f * t)
                                 + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
    audio = (np.round(audio * 32768.0).clip(-32768, 32767) / 32768.0).astype(np.float32)

    calls = []
    real = dz._diarize_device_nets

    def spy(*a, **k):
        calls.append(a[-1] if not k else k.get("mesh"))
        return real(*a, **k)

    monkeypatch.setattr(dz, "_diarize_device_nets", spy)
    base = dz.diarize(audio, sr, max_speakers=4, merge_gap=1.0,
                      segmentation_fn=seg_fn, embedding_fn=emb_fn, device="cpu")
    mesh = mesh8()
    sharded = dz.diarize(audio, sr, max_speakers=4, merge_gap=1.0,
                         segmentation_fn=seg_fn, embedding_fn=emb_fn, mesh=mesh)
    assert len(calls) == 2 and calls[0] is None and calls[1] is mesh
    assert base and spans(sharded) == spans(base)
    # Against the JAX package's sharded nets: the same window logits and
    # chunk embeddings (this fixture's embeddings are the f32 rounding of a
    # zero mean, compared at 1e-4 absolute; its speakers are not comparable
    # across implementations).
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from crispy_tpu.engine import diar_device as jdd

    from crispy_tpu_torch.engine import diar_device as dd

    pad_to = dd.pad_length(audio.shape[0])
    q = dd.quantize_i16(torch.from_numpy(audio), pad_to)
    jmesh = jparallel.make_mesh(8)
    jq = jax.device_put(jdd.quantize_i16(audio, pad_to).copy(),
                        NamedSharding(jmesh, PartitionSpec()))
    jseg, jemb = jnets.segmentation_runner(seg_p), jnets.embedding_runner(emb_p)
    np.testing.assert_allclose(seg_fn.from_device(q, mesh=mesh),
                               jseg.from_device(jq, mesh=jmesh), atol=1e-4)
    ranges = [(a * sr, b * sr) for a, b in [(4, 8), (52, 55), (96, 100)]]
    np.testing.assert_allclose(emb_fn.from_device(q, ranges, mesh=mesh),
                               jemb.from_device(jq, ranges, mesh=jmesh), atol=1e-4)
