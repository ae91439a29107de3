"""The port's spans (crispy_tpu_torch.utils.tracing) on the CPU: recorded
exactly while a ``torch.profiler`` session records, with their nesting,
roots, threads and clock; and the spans of ``denoise_batch`` and the
Whisper loops, which change nothing the calls return."""

import threading
import time
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crispy_tpu_torch.dsp.mel import log_mel_spectrogram
from crispy_tpu_torch.dsp.rnnoise import pipeline
from crispy_tpu_torch.dsp.rnnoise.weights import builtin_model
from crispy_tpu_torch.models import whisper as W
from crispy_tpu_torch.models.whisper import model as wm
from crispy_tpu_torch.models.whisper import weights as ww
from crispy_tpu_torch.utils import tracing
from torch_audio import one_torch_thread, speechlike  # noqa: F401 (autouse fixture)

FRAME = 480


def session():
    return profile(activities=[ProfilerActivity.CPU])


def recorded(work):
    """(what ``work()`` returns, the spans it recorded) inside a session."""
    seen = {s.id for s in tracing.spans()}
    with session():
        out = work()
    return out, [s for s in tracing.spans() if s.id not in seen]


def names(spans):
    return [s.name for s in spans]


def test_profiling_follows_a_session():
    assert isinstance(torch.autograd.profiler._is_profiler_enabled, bool)
    assert not tracing.profiling()
    with session():
        assert tracing.profiling()
    assert not tracing.profiling()


def test_no_span_outside_a_session():
    before = tracing.spans()
    assert tracing.span("a") is tracing.span("b")  # the shared no-op
    with tracing.span("a", n=1):
        with tracing.span("a.b"):
            pass
    assert tracing.spans() == before


def test_nesting_parent_root_and_clock():
    def work():
        t = [time.perf_counter_ns()]
        with tracing.span("root", n=3):
            with tracing.span("a"):
                with tracing.span("a.b"):
                    t.append(time.perf_counter_ns())
            with tracing.span("c"):
                pass
        t.append(time.perf_counter_ns())
        return t

    (t0, t_in, t1), got = recorded(work)
    assert names(got) == ["a.b", "a", "c", "root"]  # in the order they closed
    by = {s.name: s for s in got}
    root = by["root"]
    assert root.parent is None and root.root == root.id and root.attrs == {"n": 3}
    assert by["a"].parent == root.id and by["c"].parent == root.id
    assert by["a.b"].parent == by["a"].id
    assert {s.root for s in got} == {root.id}
    assert {s.thread for s in got} == {threading.get_ident()}
    for s in got:
        assert t0 <= s.start_ns <= s.end_ns <= t1
        assert root.start_ns <= s.start_ns and s.end_ns <= root.end_ns
    assert by["a.b"].start_ns <= t_in <= by["a.b"].end_ns
    assert by["a"].end_ns <= by["c"].start_ns


def test_two_threads_keep_their_own_stacks():
    barrier = threading.Barrier(2, timeout=10)

    def worker(tag):
        with tracing.span(f"{tag}.root"):
            barrier.wait()  # both roots open at once
            with tracing.span(f"{tag}.child"):
                barrier.wait()

    def work():
        threads = [threading.Thread(target=worker, args=(t,)) for t in ("x", "y")]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=10)
        assert not any(th.is_alive() for th in threads)

    _, got = recorded(work)
    by = {s.name: s for s in got}
    assert set(by) == {"x.root", "x.child", "y.root", "y.child"}
    for tag in ("x", "y"):
        root, child = by[f"{tag}.root"], by[f"{tag}.child"]
        assert root.parent is None and child.parent == root.id and child.root == root.id
        assert child.thread == root.thread
    assert by["x.root"].thread != by["y.root"].thread
    assert by["x.root"].id != by["y.root"].id


def test_buffer_drops_the_oldest_beyond_its_length(monkeypatch):
    assert tracing.MAX_SPANS >= 1_000_000 and tracing._SPANS.maxlen == tracing.MAX_SPANS
    monkeypatch.setattr(tracing, "_SPANS", deque(maxlen=3))
    with session():
        for i in range(5):
            with tracing.span(f"s{i}"):
                pass
    assert names(tracing.spans()) == ["s2", "s3", "s4"]


@pytest.fixture(scope="module")
def params():
    return pipeline.make_params(builtin_model(), "cpu")


@pytest.mark.parametrize("wire", ["f32", "i16"])
def test_denoise_batch_spans(params, monkeypatch, wire):
    """S=3, blocks of 4 frames over 10 frames and a partial frame: two full
    blocks and a short one. One ``denoise.step`` a block, the phases beside
    it (a write-back ``denoise.flush`` a block too, one ``denoise.alloc`` a
    call), every span inside the
    root, the CPU route's uploads unstaged, and the same samples as a run
    outside a session; the block step is still looked up where the benchmark
    swaps it."""
    n = 10 * FRAME + 123
    audio = np.stack([speechlike(n, seed=s, f0=f) for s, f in ((1, 110.0), (2, 180.0), (3, 95.0))])
    x = (audio * 32767).astype(np.int16) if wire == "i16" else audio
    name = "_denoise_block_i16" if wire == "i16" else "denoise_block"
    calls = []
    real = getattr(pipeline, name)
    monkeypatch.setattr(pipeline, name, lambda *a: calls.append(1) or real(*a))

    def run():
        return pipeline.denoise_batch(x, block_frames=4, params=params, wire=wire, device="cpu")

    plain = run()
    got, spans = recorded(run)
    np.testing.assert_array_equal(got, plain)
    count = {k: names(spans).count(k) for k in set(names(spans))}
    assert count == {"denoise_batch": 1, "denoise.alloc": 1, "denoise.slice": 3, "denoise.upload": 3,
                     "denoise.step": 3, "denoise.readback": 3, "denoise.flush": 3,
                     "denoise.flush.wait": 3, "denoise.flush.concat": 3}
    assert [s.attrs for s in spans if s.name == "denoise.upload"] == [{"staged": False}] * 3
    assert len(calls) == 2 * 3  # both runs went through the swapped name
    root = next(s for s in spans if s.name == "denoise_batch")
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.root == root.id and root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        want = {"denoise_batch": None, "denoise.flush.wait": "denoise.flush",
                "denoise.flush.concat": "denoise.flush"}.get(s.name, "denoise_batch")
        assert (by_id[s.parent].name if s.parent else None) == want, s.name


@pytest.fixture(scope="module")
def whisper():
    cfg = wm.CONFIGS["test-random"]
    model = ww.params_to_module(ww.init_random(cfg, 3), cfg, device="cpu")
    rng = np.random.default_rng(5)
    audio = torch.from_numpy(rng.standard_normal((2, 16000)).astype(np.float32) * 0.1)
    mel = log_mel_spectrogram(audio, n_mels=cfg.n_mels, pad_to_chunk=True)
    prompt = torch.tensor([[cfg.sot, 5, 17]] * 2)
    return model, wm.encode(model, mel), prompt


@pytest.mark.parametrize("loop", ["greedy", "sample"])
def test_decode_loop_spans(whisper, loop):
    model, enc, prompt = whisper
    max_new = 7

    def run():
        if loop == "greedy":
            return wm.greedy_decode(model, enc, prompt, max_new=max_new)
        return wm.sample_decode(model, enc, prompt, 0.0, None, 3, 0, max_new=max_new)

    plain = run()
    got, spans = recorded(run)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert names(spans) == (["whisper.init_cache", "whisper.prefill"]
                            + ["whisper.step"] * (max_new - 1) + ["whisper.decode"])
    root = spans[-1]
    assert all(s.parent == root.id for s in spans[:-1])


def test_transcribe_spans_and_the_names_it_calls(monkeypatch):
    """The root ``whisper.transcribe`` holds the mel, the encoder, the decode
    loop, the read-back and the selection; ``encode`` and ``sample_decode``
    are still looked up in the package, where the benchmark swaps them."""
    wmodel = W.WhisperModel.random("test-random", seed=3, device="cpu")
    calls = []
    for name in ("encode", "sample_decode"):
        real = getattr(W, name)
        monkeypatch.setattr(W, name, lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    chunks = torch.from_numpy(np.stack([speechlike(16000, seed=7, sr=16000)] * 2))

    def run():
        return wmodel.transcribe_chunks_robust(chunks, max_new=5, temperatures=(0.0,))

    plain = run()
    got, spans = recorded(run)
    assert got == plain
    assert calls == ["encode", "sample_decode"] * 2
    root = spans[-1]
    assert root.name == "whisper.transcribe" and root.parent is None
    by_id = {s.id: s for s in spans}
    top = [s.name for s in spans if s.parent == root.id]
    assert top == ["whisper.mel", "whisper.encode", "whisper.decode", "whisper.readback",
                   "whisper.select"]
    assert names(spans).count("whisper.step") == 4
    assert all(by_id[s.parent].name == "whisper.decode" for s in spans if s.name == "whisper.step")
