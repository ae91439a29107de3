"""The port's diarization (crispy_tpu_torch.engine.diarization, nme_device):
the host helpers, NME-SC on the device, ``diarize`` on both routes,
``run_diarization`` and ``run_transcription`` with diarization, each held
against the JAX package on the same inputs on the CPU. NME-SC partitions
are compared up to relabelling: eigenvector signs and the basis inside a
repeated eigenvalue differ between LAPACK, XLA and cuSOLVER. The ``gpu``
tests hold the card against the CPU path.
"""

import numpy as np
import pytest
import torch

from crispy_tpu_torch.api.events import EventBus
from crispy_tpu_torch.engine import diar_device as tdd
from crispy_tpu_torch.engine import diarization as td
from crispy_tpu_torch.engine import nme_device as tn
from crispy_tpu_torch.engine import transcription as ttr
from crispy_tpu_torch.io import wav as wavio
from crispy_tpu_torch.models.registry import ModelManager
from torch_audio import one_torch_thread  # noqa: F401 (autouse fixture)

try:  # the reference; the card's machine has no JAX and runs only the gpu tests
    import jax.numpy as jnp

    from crispy_tpu.api.events import EventBus as JEventBus
    from crispy_tpu.engine import diarization as jd
    from crispy_tpu.engine import nme_device as jn
    from crispy_tpu.engine import transcription as jtr
    from crispy_tpu.models import registry as jreg
except ImportError:
    jd = None
needs_jax = pytest.mark.skipif(jd is None, reason="the JAX reference is not installed")

SR = 16000


def canonical(labels):
    """Relabel by first appearance so partitions compare directly."""
    seen = {}
    return [seen.setdefault(v, len(seen)) for v in np.asarray(labels).tolist()]


def cluster_emb(centers, per, dim=6):
    """The reference's fixture (diarization.rs:735-746): each cluster on its
    own axis, with a small deterministic jitter in the last dimension."""
    out = []
    for ci, c in enumerate(centers):
        for p in range(per):
            v = np.zeros(dim, np.float32)
            v[c] = 1.0
            v[dim - 1] += 0.01 * (ci + 1) + 0.001 * p
            out.append(v)
    return np.stack(out)


def gaussian_clusters(seed, n=None, k=None, dim=24, spread=0.1):
    rng = np.random.default_rng(seed)
    k = k or int(rng.integers(2, 5))
    centers = rng.standard_normal((k, dim)).astype(np.float32) * 3.0
    if n is not None:
        return (centers[rng.integers(0, k, n)]
                + spread * rng.standard_normal((n, dim))).astype(np.float32)
    return np.concatenate([c[None] + spread * rng.standard_normal(
        (int(rng.integers(6, 12)), dim)).astype(np.float32) for c in centers])


def _q16(audio):
    return (np.round(np.clip(audio, -1, 1) * 32768.0).clip(-32768, 32767)
            / 32768.0).astype(np.float32)


def make_audio(minutes=2.6, freqs=(150.0, 500.0, 1400.0), seed=0):
    """tests/test_diar_fused.make_audio: 5 s tone bouts, 1.2 s pauses, on the
    int16 grid (the one-upload routes quantize)."""
    rng = np.random.default_rng(seed)
    gap = np.zeros(int(1.2 * SR), np.float32)
    pieces, total, i = [], 0, 0
    target = int(minutes * 60 * SR)
    while total < target:
        t = np.arange(int(5.0 * SR)) / SR
        tone = 0.4 * np.sin(2 * np.pi * freqs[i % len(freqs)] * t)
        tone += 0.005 * rng.standard_normal(t.size)
        pieces += [tone.astype(np.float32), gap]
        total += t.size + gap.size
        i += 1
    return _q16(np.concatenate(pieces)[:target])


@pytest.fixture(scope="module")
def audio():
    return make_audio()


def segs(result):
    return [(s.start, s.end, s.speaker) for s in result]


# ---------------------------------------------------------------------------
# Host helpers
# ---------------------------------------------------------------------------

@needs_jax
class TestHostHelpers:
    def test_merge_lookup_format(self):
        words = [(0.1, 0.5, "hello"), (0.6, 1.0, "there"), (2.5, 3.0, "hi"),
                 (3.1, 3.5, "  "), (3.6, 3.9, "back"), (7.0, 7.5, "late")]
        spans = [(0.0, 1.0, "Speaker 1"), (1.2, 2.0, "Speaker 1"), (3.5, 4.0, "Speaker 1"),
                 (4.0, 5.0, "Speaker 2"), (1.5, 3.0, "Speaker 1")]
        for gap in (0.0, 0.5, 2.0):
            t = td.merge_consecutive_segments([td.SpeakerSegment(*s) for s in spans], gap)
            j = jd.merge_consecutive_segments([jd.SpeakerSegment(*s) for s in spans], gap)
            assert segs(t) == segs(j)
            for time in (0.5, 1.1, 1.4, 1.9, 3.7, 9.0, -1.0):
                assert td.find_speaker_at_time(time, t) == jd.find_speaker_at_time(time, j)
            assert td.format_diarized_text(words, t) == jd.format_diarized_text(words, j)
        assert td.format_diarized_text(words, []) == jd.format_diarized_text(words, [])
        assert td.format_diarized_text([], []) == ""

    def test_numeric_helpers(self):
        rng = np.random.default_rng(3)
        for a, b in [([1, 0], [1, 0]), ([0, 0], [1, 0]), ([1, 0], [-1, 0]),
                     (rng.standard_normal(8), rng.standard_normal(8))]:
            assert td.cosine_distance(a, b) == jd.cosine_distance(a, b)
            assert td.cosine_similarity(a, b) == jd.cosine_similarity(a, b)
        x = np.array([0.0, 1.0, -1.0, 2.0, 0.5, -0.49999], np.float32)
        np.testing.assert_array_equal(td.f32_to_i16(x), jd.f32_to_i16(x))
        ev = np.sort(rng.uniform(0, 2, 12))
        for kmax in (1, 3, 8, 20):
            assert td.max_eigengap(ev, kmax) == jd.max_eigengap(ev, kmax)
        pts = gaussian_clusters(4, dim=5)
        for k in (1, 2, 3, 4, len(pts)):
            np.testing.assert_array_equal(td.kmeans(pts, k), jd.kmeans(pts, k))

    @pytest.mark.parametrize("seed", [0, 1])
    def test_nme_sc_host_oracle(self, seed):
        emb = gaussian_clusters(seed)
        aff = np.clip(np.corrcoef(emb), 0, 1).astype(np.float32)
        np.testing.assert_array_equal(td.pruned_normalized_laplacian(aff, 4),
                                      jd.pruned_normalized_laplacian(aff, 4))
        np.testing.assert_array_equal(td.nme_sc_host(emb, 8), jd.nme_sc_host(emb, 8))

    def test_energy_vad_logits(self):
        rng = np.random.default_rng(5)
        w = (rng.standard_normal((3, td.WINDOW_SAMPLES)) * [[0.0], [1e-3], [0.3]])
        for windows in (w.astype(np.float32), w[:, :100000].astype(np.float32)):
            np.testing.assert_array_equal(td.energy_vad_logits(windows),
                                          jd.energy_vad_logits(windows))

    @pytest.mark.parametrize("case", ["split", "blip", "empty", "silence", "tail", "clip20"])
    def test_segment_speech_and_chunks(self, case, audio):
        t = np.arange(3 * SR) / SR
        tone = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
        x, gap = {
            "split": (np.concatenate([tone, np.zeros(3 * SR, np.float32), tone]), 1.0),
            "blip": (np.concatenate([np.zeros(2 * SR, np.float32), tone[: int(0.8 * SR)],
                                     np.zeros(4 * SR, np.float32)]), 0.2),
            "empty": (np.zeros(0, np.float32), 1.0),
            "silence": (np.zeros(SR, np.float32), 1.0),
            "tail": (np.concatenate([np.zeros(SR, np.float32), np.tile(tone, 4)]), 0.5),
            "clip20": (audio[: 20 * SR], 1.0),
        }[case]
        tv = td.segment_speech(x, gap)
        jv = jd.segment_speech(x, gap)
        key = [(s.start, s.end, s.offset, len(s.samples)) for s in tv]
        assert key == [(s.start, s.end, s.offset, len(s.samples)) for s in jv]
        tc, jc = td.chunk_segments(tv), jd.chunk_segments(jv)
        assert [(c.start, c.end, c.offset) for c in tc] == [(c.start, c.end, c.offset) for c in jc]
        for a, b in zip(tc, jc):
            np.testing.assert_array_equal(a.samples, b.samples)

    def test_chunking_long_segment(self):
        for seg_t, seg_j in [(td.VadSegment(0.0, 10.0, np.zeros(10 * SR, np.float32)),
                              jd.VadSegment(0.0, 10.0, np.zeros(10 * SR, np.float32))),
                             (td.VadSegment(2.0, 11.3, np.zeros(int(9.3 * SR)), offset=32000),
                              jd.VadSegment(2.0, 11.3, np.zeros(int(9.3 * SR)), offset=32000))]:
            tc, jc = td.chunk_segments([seg_t]), jd.chunk_segments([seg_j])
            assert [(c.start, c.end, c.offset) for c in tc] == [
                (c.start, c.end, c.offset) for c in jc]

    def test_melstats_embedding(self):
        rng = np.random.default_rng(2)
        chunks = [(0.3 * rng.standard_normal(n)).astype(np.float32)
                  for n in (SR, 2 * SR, SR, 3 * SR // 2)]
        np.testing.assert_allclose(td.melstats_embedding(chunks, device="cpu"),
                                   jd.melstats_embedding(chunks), atol=1e-4)


# ---------------------------------------------------------------------------
# NME-SC on the device
# ---------------------------------------------------------------------------

NME_CASES = {
    "axis-k2": (lambda: cluster_emb(range(2), per=5), 8),
    "axis-k3": (lambda: cluster_emb(range(3), per=5), 8),
    "axis-k4": (lambda: cluster_emb(range(4), per=5), 8),
    "single-chain": (lambda: cluster_emb([0], per=6), 8),
    "single-blob": (lambda: np.eye(1, 16, dtype=np.float32).repeat(8, 0) + 0.05 * np.random.
                    default_rng(0).standard_normal((8, 16)).astype(np.float32), 8),
    "max-speakers-2": (lambda: cluster_emb(range(3), per=5), 2),
    "gauss-1": (lambda: gaussian_clusters(1), 8),
    "gauss-2": (lambda: gaussian_clusters(2), 8),
    "gauss-3": (lambda: gaussian_clusters(3), 8),
    "zero-norm": (lambda: cluster_emb(range(2), per=4) * (np.arange(8) != 3)[:, None], 4),
    "bucket-16": (lambda: cluster_emb(range(2), per=8), 8),
    "bucket-17": (lambda: np.concatenate([cluster_emb(range(2), per=8),
                                          cluster_emb(range(2), per=8)[-1:] + 0.001]), 8),
    "subspace-n300": (lambda: gaussian_clusters(11, n=300, k=5, spread=0.12), 8),
}


@needs_jax
@pytest.mark.parametrize("case", list(NME_CASES))
def test_nme_sc_device_matches_jax(case):
    make, max_speakers = NME_CASES[case]
    emb = make().astype(np.float32)
    got = tn.nme_sc_device(emb, max_speakers, device="cpu")
    want = jn.nme_sc_device(emb, max_speakers)
    assert got.dtype == np.int64 and got.shape == (emb.shape[0],)
    assert canonical(got) == canonical(want)
    assert canonical(got) == canonical(jd.nme_sc_host(emb, max_speakers))
    if case.startswith("single"):
        assert set(got.tolist()) == {0}
    if case == "max-speakers-2":
        assert len(set(got.tolist())) <= 2


def test_nme_sc_small_inputs_and_host_optout(monkeypatch):
    assert td.nme_sc(np.zeros((0, 4)), 4, device="cpu").tolist() == []
    assert td.nme_sc(np.ones((2, 4)), 4, device="cpu").tolist() == [0, 0]
    assert tn.nme_sc_device(np.ones((1, 4)), 4, device="cpu").tolist() == [0]
    monkeypatch.setenv("CRISPY_NME", "host")
    monkeypatch.setattr(tn, "nme_sc_device", lambda *a, **k: pytest.fail("device path used"))
    assert len(set(td.nme_sc(cluster_emb(range(2), per=5), 4).tolist())) == 2


def test_buckets_and_sweep_bounds():
    assert [tn._bucket(n) for n in (3, 8, 9, 200, 256, 257, 300, 900)] == [
        8, 8, 16, 256, 256, 512, 512, 1024]
    assert tn._p_cap(1024) == 64 and tn._p_cap(512) == 44
    if jd is not None:
        for n in range(3, 1300, 7):
            assert tn._bucket(n) == jn._bucket(n) and tn._p_cap(n) == jn._p_cap(n)


def _pruned_laplacian(emb, N, p):
    """The core's padded Laplacian at one p, in NumPy."""
    n = emb.shape[0]
    norms = np.sqrt((emb ** 2).sum(1))
    normed = emb / np.maximum(norms, 1e-12)[:, None]
    aff = np.clip(normed @ normed.T, 0, 1)
    np.fill_diagonal(aff, 0.0)
    rank = np.argsort(np.argsort(-aff, axis=1, kind="stable"), axis=1)
    a = np.where(rank < p, aff, 0.0)
    a = np.maximum(a, a.T)
    apad = np.zeros((N, N), np.float32)
    apad[:n, :n] = a
    dinv = 1.0 / np.sqrt(np.maximum(apad.sum(1), 1e-9))
    lap = np.eye(N, dtype=np.float32) - dinv[:, None] * apad * dinv[None, :]
    lap[np.arange(n, N), np.arange(n, N)] = 3.0
    return lap.astype(np.float32)


@needs_jax
@pytest.mark.parametrize("s_sub,iters", [(16, tn._SUBSPACE_ITERS),
                                         (tn._FINAL_SUB, tn._FINAL_ITERS)])
def test_subspace_bottom_ritz_values_match_jax(s_sub, iters):
    lap = _pruned_laplacian(gaussian_clusters(5, n=300, k=4, dim=16), 512, 10)
    got = tn.subspace_bottom(torch.from_numpy(lap), s_sub, iters)[0].numpy()
    want = np.asarray(jn.subspace_bottom(jnp.asarray(lap), s_sub, iters)[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    truth = np.linalg.eigvalsh(lap.astype(np.float64))[:10]
    assert (got[:10] - truth).min() > -1e-3  # Ritz values bound the truth from above


# The no-flip cases of tests/test_nme_eigengap.py, on the port's subspace
# iteration: Laplacians with a controlled margin between the two largest
# eigengaps, against f64 LAPACK truth, at the margins stated there.
KMAX = 8


def eigengap_k(ev, kmax=KMAX):
    idx = np.arange(1, kmax + 1)
    return max(int(idx[np.argmax(ev[idx] - ev[idx - 1])]), 1)


def make_spectrum(N, k1, k2, g1, margin, seed, filler="tight"):
    rng = np.random.default_rng(seed)
    ev = np.zeros(N)
    ev[:k1] = np.sort(rng.uniform(0, 0.004, k1))
    ev[k1] = ev[k1 - 1] + g1
    for i in range(k1 + 1, k2):
        ev[i] = ev[i - 1] + rng.uniform(0.001, 0.004)
    ev[k2] = ev[k2 - 1] + (g1 - margin)
    for i in range(k2 + 1, KMAX + 1):
        ev[i] = ev[i - 1] + rng.uniform(0.001, 0.004)
    lo = ev[KMAX] + (0.01 if filler == "tight" else 0.3)
    ev[KMAX + 1:] = np.sort(rng.uniform(lo, 2.0, N - KMAX - 1))
    return ev


def laplacian_with_spectrum(ev, seed):
    rng = np.random.default_rng(1000 + seed)
    Q, _ = np.linalg.qr(rng.standard_normal((ev.size, ev.size)))
    L = (Q * ev) @ Q.T
    return (L + L.T) / 2.0


def _ritz(L64, s_sub, iters):
    return tn.subspace_bottom(torch.from_numpy(L64.astype(np.float32)), s_sub, iters)[0].numpy()


@pytest.mark.parametrize("filler", ["tight", "kind"])
@pytest.mark.parametrize("margin", [0.002, 0.005, 0.01, 0.03])
def test_final_tier_no_flips_at_stated_margins(margin, filler):
    for seed in range(6):
        L64 = laplacian_with_spectrum(make_spectrum(512, 3, 6, 0.4, margin, seed, filler), seed)
        truth = np.linalg.eigvalsh(L64)[:KMAX + 1]
        lam = _ritz(L64, tn._FINAL_SUB, tn._FINAL_ITERS)[:KMAX + 1]
        assert eigengap_k(lam) == eigengap_k(truth), (margin, filler, seed)


def test_final_tier_ritz_error_bound():
    worst = 0.0
    for seed in range(6):
        L64 = laplacian_with_spectrum(make_spectrum(512, 3, 6, 0.4, 0.002, seed), seed)
        err = (_ritz(L64, tn._FINAL_SUB, tn._FINAL_ITERS)[:KMAX + 1]
               - np.linalg.eigvalsh(L64)[:KMAX + 1])
        assert err.min() > -2e-4
        worst = max(worst, np.abs(err).max())
    assert worst < 3e-3


@pytest.mark.parametrize("margin", [0.015, 0.05])
def test_sweep_tier_no_flips_above_its_margin(margin):
    for seed in range(6):
        L64 = laplacian_with_spectrum(make_spectrum(512, 3, 6, 0.4, margin, seed), seed)
        truth = np.linalg.eigvalsh(L64)[:KMAX + 1]
        assert eigengap_k(_ritz(L64, 16, tn._SUBSPACE_ITERS)[:KMAX + 1]) == eigengap_k(truth)


# ---------------------------------------------------------------------------
# diarize end to end
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("route", ["fused", "host-20s", "fused-off"])
def test_diarize_matches_jax(route, audio, monkeypatch):
    calls = []
    real = td._diarize_fused_frontend
    monkeypatch.setattr(td, "_diarize_fused_frontend",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = audio[: 20 * SR] if route == "host-20s" else audio
    if route == "fused-off":
        monkeypatch.setenv("CRISPY_DIAR_FUSED", "off")
    got = td.diarize(x, max_speakers=4, merge_gap=1.0, device="cpu")
    want = jd.diarize(x, max_speakers=4, merge_gap=1.0)
    assert segs(got) == segs(want) and len(got) > 2
    assert bool(calls) == (route == "fused")


@needs_jax
def test_fused_frontend_segments_offsets_and_embeddings(audio):
    s_t, c_t, e_t = td._diarize_fused_frontend(audio, 1.0, "cpu")
    s_j, c_j, e_j = jd._diarize_fused_frontend(audio, 1.0)
    assert [(s.start, s.end) for s in s_t] == [(s.start, s.end) for s in s_j]
    assert [(c.start, c.end, c.offset) for c in c_t] == [(c.start, c.end, c.offset) for c in c_j]
    for c in c_t:
        np.testing.assert_array_equal(c.samples, audio[c.offset: c.offset + len(c.samples)])
    # the means within 1e-4; the stds within the JAX package's own f32
    # rounding of a constant bin's variance (tests/test_torch_diar_device.py
    # holds both to the formula in float64)
    np.testing.assert_allclose(e_t[:, :80], e_j[:, :80], rtol=0, atol=1e-4)
    np.testing.assert_allclose(e_t, e_j, rtol=0, atol=1e-3)


def test_diarize_takes_device_audio(audio):
    """A tensor (run_transcription's 16 kHz audio on the manager's device)
    gives what the same samples as an array give, on both routes."""
    for x in (audio, audio[: 20 * SR]):
        a = td.diarize(x, max_speakers=4, device="cpu")
        b = td.diarize(torch.from_numpy(x), max_speakers=4, device="cpu")
        assert segs(a) == segs(b)


def test_device_failures_raise_without_host_fallback(audio, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("device failure")

    with monkeypatch.context() as m:
        m.setattr(tn, "nme_sc_device", boom)
        with pytest.raises(RuntimeError, match="device failure"):
            td.diarize(audio[: 20 * SR], max_speakers=4, device="cpu")
    with monkeypatch.context() as m:
        m.setattr(tdd, "segmentation_margins", boom)
        with pytest.raises(RuntimeError, match="device failure"):
            td.diarize(audio, max_speakers=4, device="cpu")
    with monkeypatch.context() as m:
        m.setattr(tdd, "chunk_stats", boom)
        with pytest.raises(RuntimeError, match="device failure"):
            td.diarize(audio, max_speakers=4, device="cpu")
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            td.diarize(audio[: 20 * SR])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tn.nme_sc_device(cluster_emb(range(2), per=5), 4)


def test_diarize_edges():
    assert td.diarize(np.zeros(td.FUSED_MIN_SAMPLES + SR, np.float32), device="cpu") == []
    assert td.diarize(np.zeros(0, np.float32), device="cpu") == []
    with pytest.raises(ValueError, match="16 kHz"):
        td.diarize(np.zeros(100, np.float32), sample_rate=48000, device="cpu")


# ---------------------------------------------------------------------------
# run_diarization and run_transcription
# ---------------------------------------------------------------------------

def speech_audio(seconds=8):
    rng = np.random.default_rng(0)
    t = np.arange(seconds * SR) / SR
    x = 0.4 * np.sin(2 * np.pi * 150 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
    return (x + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


class StubManager:
    def __init__(self, seg_path=None, emb_path=None):
        self.paths = {"diarize-segmentation": seg_path, "diarize-embedding": emb_path}

    def is_downloaded(self, mid):
        return self.paths.get(mid) is not None

    def model_path(self, mid):
        return self.paths[mid]


@needs_jax
def test_run_diarization_with_downloaded_nets_matches_jax(tmp_path, monkeypatch):
    """The test_diarization_onnx files: the executor route is not ported
    (raises, naming item 10b), and the native loaders cannot map these
    graphs, so both nets fall back to the stand-ins with an event each. The
    JAX side's executor runners are made to raise the same error, so both
    packages take the same route."""
    from crispy_tpu.models import onnx_nets
    from test_diarization_onnx import make_embedding_onnx, make_segmentation_onnx

    mm = StubManager(make_segmentation_onnx(tmp_path / "seg.onnx"),
                     make_embedding_onnx(tmp_path / "emb.onnx"))

    def runner(net):
        return lambda path: td.onnx_runner(net, path)

    monkeypatch.setattr(onnx_nets, "segmentation_runner", runner("segmentation"))
    monkeypatch.setattr(onnx_nets, "embedding_runner", runner("embedding"))
    words = [(0.0, 4.0, "hello"), (4.0, 8.0, "world")]
    tbus, jbus = EventBus(), JEventBus()
    tbus.keep_history = jbus.keep_history = True
    got = td.run_diarization(speech_audio(), SR, words, model_manager=mm, bus=tbus,
                             device="cpu")
    want = jd.run_diarization(speech_audio(), SR, words, model_manager=mm, bus=jbus)
    assert got == want and "[Speaker 1|0.0]" in got
    tev = [p for e, p in tbus.history if e == "diarization-fallback"]
    jev = [p for e, p in jbus.history if e == "diarization-fallback"]
    assert [e["net"] for e in tev] == [e["net"] for e in jev] == ["segmentation", "embedding"]
    for t, j in zip(tev, jev):
        assert t["error"].startswith(j["error"]) and "queue 1, item 10b" in t["error"]
        assert "native port:" in t["error"]


def test_run_diarization_without_nets_emits_nothing():
    bus = EventBus()
    bus.keep_history = True
    text = td.run_diarization(speech_audio(2), SR, [(0.2, 0.8, "hello world")],
                              model_manager=StubManager(), bus=bus, device="cpu")
    assert text == "[Speaker 1|0.2]\nhello world"
    assert not bus.history


class StubEngine(ttr.EngineProtocol):
    """Text from each chunk's level and index; whole-chunk timestamps."""

    name = "stub"

    def transcribe_batch(self, chunks, language="en"):
        x = np.asarray(chunks.cpu() if isinstance(chunks, torch.Tensor) else chunks)
        return [f"words{i} level{int(np.abs(c).max() * 100)}" if np.abs(c).max() > 0 else ""
                for i, c in enumerate(x)]


class WordEngine(StubEngine):
    """Overrides the single-chunk method only: two words a chunk."""

    def transcribe_with_timestamps(self, chunk_16k, offset_seconds):
        return [(offset_seconds + 1.0, offset_seconds + 2.0, "first"),
                (offset_seconds + 20.0, offset_seconds + 21.0, "second")]


def two_speaker_wav(path, sr):
    """2.5 min of two alternating tone speakers at sr, 16-bit."""
    a = make_audio(2.5, freqs=(150.0, 1400.0), seed=3)
    if sr != SR:
        from scipy.signal import resample_poly

        a = resample_poly(a, sr // 1000, SR // 1000).astype(np.float32)
    return wavio.write_wav(path, np.clip(a, -1, 1), sr)


@needs_jax
@pytest.mark.parametrize("sr,engine", [(16000, StubEngine), (48000, StubEngine),
                                       (16000, WordEngine)])
def test_run_transcription_with_diarization_matches_jax(tmp_path, data_root, sr, engine):
    wav = two_speaker_wav(tmp_path / "talk.wav", sr)
    tbus, jbus = EventBus(), JEventBus()
    tbus.keep_history = jbus.keep_history = True
    tm_ = ttr.TranscriptionManager(ModelManager(models_dir=tmp_path / "Models"), bus=tbus,
                                   engine_loader=lambda mid, m: engine(), device="cpu")
    jtm = jtr.TranscriptionManager(jreg.ModelManager(models_dir=tmp_path / "Models"),
                                   bus=jbus, engine_loader=lambda mid, m: engine())
    opts = {"enabled": True, "max_speakers": 4, "merge_gap": 1.0}
    got = ttr.run_transcription(str(wav), tm_, "stub", diarization=opts, batch_chunks=2)
    want = jtr.run_transcription(str(wav), jtm, "stub", diarization=opts, batch_chunks=2)
    assert got == want and got.count("[Speaker ") >= 2
    for bus in (tbus, jbus):
        assert not [e for e, _ in bus.history if e == "diarization-fallback"]
    phases = [p["phase"] for e, p in tbus.history if e == "transcription-phase"]
    assert phases[-1] == "diarizing"
    assert ttr.load_transcription_result(str(wav)) == got


def test_transcription_keeps_plain_text_when_diarization_fails(tmp_path, data_root,
                                                               monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("diarization failed on the device")

    monkeypatch.setattr(td, "diarize", boom)
    bus = EventBus()
    bus.keep_history = True
    tm_ = ttr.TranscriptionManager(ModelManager(models_dir=tmp_path / "Models"), bus=bus,
                                   engine_loader=lambda mid, m: StubEngine(), device="cpu")
    wav = wavio.write_wav(tmp_path / "a.wav", speech_audio(4), SR)
    plain = ttr.run_transcription(str(wav), tm_, "stub")
    text = ttr.run_transcription(str(wav), tm_, "stub", diarization={"enabled": True})
    assert text == plain == "words0 level55"
    evs = [p for e, p in bus.history if e == "diarization-fallback"]
    assert evs == [{"recording_path": str(wav), "net": "pipeline",
                    "error": "diarization failed on the device"}]
    assert tm_.get_state(str(wav)).status == "completed"


def test_checkpoint_resumes_only_with_the_same_diarization_flag(tmp_path, data_root):
    tm_ = ttr.TranscriptionManager(ModelManager(models_dir=tmp_path / "Models"),
                                   bus=EventBus(), device="cpu",
                                   engine_loader=lambda mid, m: StubEngine())
    wav = wavio.write_wav(tmp_path / "b.wav", np.tile(speech_audio(4), 16), SR)  # 64 s
    for flag, resumed in ((False, False), (True, True)):
        ttr._save_progress(str(wav), {"model_id": "stub", "language": "en", "n_chunks": 3,
                                      "done_chunks": 2, "diarization": True,
                                      "parts": [[0.0, 30.0, "from the checkpoint"]]})
        text = ttr.run_transcription(str(wav), tm_, "stub", diarization={"enabled": flag})
        assert ("from the checkpoint" in text) == resumed


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(NME_CASES))
def test_nme_sc_card_matches_cpu(card, case):
    make, max_speakers = NME_CASES[case]
    emb = make().astype(np.float32)
    assert canonical(tn.nme_sc_device(emb, max_speakers)) == canonical(
        tn.nme_sc_device(emb, max_speakers, device="cpu"))


@pytest.mark.gpu
def test_diarize_card_matches_cpu(card, audio):
    for x in (audio, audio[: 20 * SR]):
        assert segs(td.diarize(x)) == segs(td.diarize(x, device="cpu"))
        assert segs(td.diarize(torch.from_numpy(x).to(card))) == segs(
            td.diarize(x, device="cpu"))
