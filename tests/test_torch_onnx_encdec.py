"""The port's ONNX encoder-decoder engine
(crispy_tpu_torch.engine.onnx_engines.OnnxEncDecEngine) against the JAX
package's, on the CPU.

The JAX package's enc-dec cases (test_onnx_engines: the moonshine
preprocess layout, the language prompt, the canary prompt and decode,
bucket escalation against a single bucket, the merged decoder's uncached
branch, beam 1 against greedy and beam 3, the word times;
test_catalog_engines: the enc-dec catalog ids through load_engine) run with
the JAX engine class swapped for a ``DualEncDec``: each bundle loads in both
packages, and every transcription call must give equal texts, and equal
word segments with times within 1e-6 s, before the case's own checks see
the JAX package's. Then beam 4 with equal tokens and final beam scores
within 1e-5, a host read of ``done`` every step against every 32 steps
(equal token arrays), and run_transcription with a canary bundle.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="the JAX reference is not installed")
import test_catalog_engines as jcat  # noqa: E402
import test_onnx_engines as jcases
from crispy_tpu.api.events import EventBus as JEventBus
from crispy_tpu.engine import onnx_engines as jeng
from crispy_tpu.engine import transcription as jtr
from crispy_tpu.models import registry as jreg
from crispy_tpu_torch.api.events import EventBus
from crispy_tpu_torch.engine import onnx_engines as teng
from crispy_tpu_torch.engine import transcription as tr
from crispy_tpu_torch.io import wav as wavio
from crispy_tpu_torch.models.registry import ModelManager
from test_torch_onnx_engines import ENC_DEC, _chunks, _run, assert_same_segments
from torch_audio import one_torch_thread, speechlike  # noqa: F401 (autouse fixture)

SCORE_TOL = 1e-5  # final beam scores (sums of f32 log-probs)
JEncDec = jeng.OnnxEncDecEngine


class DualEncDec:
    """An enc-dec engine that loads a bundle in both packages and holds every
    transcription and prompt of the port's to the JAX package's; attribute
    reads go to the JAX engine, attribute writes to both."""

    def __init__(self, model_dir, model_id="dual", **kwargs):
        j, jerr = _run(JEncDec, model_dir, model_id, **kwargs)
        kwargs.pop("mesh", None)
        t, terr = _run(teng.OnnxEncDecEngine, model_dir, model_id, device="cpu", **kwargs)
        assert type(terr) is type(jerr), (jerr, terr)
        if jerr is not None:
            raise jerr
        object.__setattr__(self, "j", j)
        object.__setattr__(self, "t", t)
        assert (t.prompt_ids, t.eos_id, t.kind) == (j.prompt_ids, j.eos_id, j.kind)
        assert t.dec_tok == j.dec_tok and t.dec_states == j.dec_states
        assert t.dec_bools == j.dec_bools

    def __getattr__(self, name):
        return getattr(self.j, name)

    def __setattr__(self, name, value):
        setattr(self.j, name, value)
        setattr(self.t, name, value)

    def prompt_for_language(self, language):
        want = self.j.prompt_for_language(language)
        assert self.t.prompt_for_language(language) == want
        return want

    def transcribe_batch(self, chunks, language="en"):
        want = self.j.transcribe_batch(chunks, language)
        assert self.t.transcribe_batch(chunks, language) == want
        return want

    def transcribe_batch_with_timestamps(self, chunks, offsets, language="en"):
        want = self.j.transcribe_batch_with_timestamps(chunks, offsets, language)
        assert_same_segments(want, self.t.transcribe_batch_with_timestamps(
            chunks, offsets, language))
        return want

    def transcribe_with_timestamps(self, chunk, offset, language="en"):
        want = self.j.transcribe_with_timestamps(chunk, offset, language)
        assert_same_segments([want], [self.t.transcribe_with_timestamps(chunk, offset, language)])
        return want


JAX_CASES = ["test_encdec_engine_moonshine_preprocess_layout",
             "test_encdec_language_prompt_substitution",
             "test_encdec_engine_canary_prompt_and_decode",
             "test_encdec_bucket_escalation_matches_single_bucket",
             "test_merged_decoder_uncached_branch",
             "test_encdec_beam_one_matches_greedy_and_beam_runs",
             "test_encdec_word_times_track_active_span"]


@pytest.mark.parametrize("name", JAX_CASES)
def test_jax_encdec_case_through_both_packages(name, tmp_path, monkeypatch):
    made = []

    class Recorded(DualEncDec):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(jeng, "OnnxEncDecEngine", Recorded)
    getattr(jcases, name)(tmp_path)
    assert made


@pytest.mark.parametrize("model_id", ENC_DEC)
def test_jax_catalog_case_through_both_packages(model_id, tmp_path, data_root, monkeypatch):
    """test_catalog_engines' case for the enc-dec ids: the JAX package's
    load_engine builds the dual engine, and the port's load_engine gives
    its own OnnxEncDecEngine for the same bundle."""
    monkeypatch.setattr(jeng, "OnnxEncDecEngine", DualEncDec)
    jcat.test_catalog_onnx_bundle_loads_and_transcribes(model_id, data_root, tmp_path)
    eng = tr.load_engine(model_id, ModelManager(), device="cpu")
    assert type(eng) is teng.OnnxEncDecEngine


def test_beam4_tokens_and_scores(tmp_path):
    """Beam 4 on the canary and merged-decoder layouts: equal texts, equal
    best token rows, final beam scores within SCORE_TOL."""
    for make in (jcases.make_canary_bundle, jcases.make_merged_decoder_bundle):
        d = tmp_path / make.__name__
        d.mkdir()
        make(d)
        j = JEncDec(d, "b", max_new=20, beam=4)
        t = teng.OnnxEncDecEngine(d, "b", max_new=20, beam=4, device="cpu")
        jcum, tcum = [], []
        jfn = j._beam_loop_fn

        def jloop(*key):
            fn = jfn(*key)
            return lambda *a: jcum.append(fn(*a)) or jcum[-1]

        j._beam_loop_fn = jloop
        tfn = t._beam_bucket
        t._beam_bucket = lambda *a: tcum.append(tfn(*a)) or tcum[-1]
        x = _chunks(3)
        assert t.transcribe_batch(x) == j.transcribe_batch(x)
        assert len(tcum) == len(jcum) >= 1
        np.testing.assert_allclose(tcum[-1][2].numpy(), np.asarray(jcum[-1][2]),
                                   rtol=SCORE_TOL, atol=SCORE_TOL)
        assert np.array_equal(tcum[-1][0].numpy(), np.asarray(jcum[-1][0]))


@pytest.mark.parametrize("beam", [1, 3])
def test_host_reads_do_not_change_tokens(tmp_path, beam):
    """The host's read of ``done`` every step against every 32 steps: the
    same token arrays, the steps after every row is done changing nothing;
    and both equal to the JAX package's, whose loop stops there."""
    jcases.make_canary_bundle(tmp_path)
    eng = teng.OnnxEncDecEngine(tmp_path, "s", max_new=40, beam=beam, device="cpu")
    eng.BUCKET_SIZES = (6,)
    enc = eng.encoder_output(_chunks(3))
    out = {}
    for every in (1, 32):
        eng.SYNC_EVERY = every
        out[every] = eng._decode_tokens(enc, 3, eng.prompt_ids, beam)
    assert np.array_equal(out[1], out[32])
    j = JEncDec(tmp_path, "s", max_new=40, beam=beam)
    j.BUCKET_SIZES = (6,)
    want = np.asarray(j._decode_tokens(enc.numpy(), 3, j.prompt_ids, beam))
    assert np.array_equal(out[1], want)


def test_guard_cuts_a_stuck_row(tmp_path):
    """A decoder that repeats one token forever: the degenerate-loop guard
    cuts each row in both packages, greedy and beam."""
    import onnx_builder as ob

    jcases.make_canary_bundle(tmp_path)
    V, E = 16, 5
    out_w = np.zeros((E, V), np.float32)
    bias = np.zeros(V, np.float32)
    bias[9] = 5.0  # token 9 always wins
    (tmp_path / "decoder-model.onnx").unlink()
    ob.write_model(tmp_path / "decoder-model.onnx", [
        ob.node("Gather", ["emb", "input_ids"], ["te"], axis=0),
        ob.node("MatMul", ["te", "out_w"], ["lg0"]),
        ob.node("Add", ["lg0", "bias"], ["logits"]),
    ], [("input_ids", 6, [None, None]), ("encoder_states", 1, [None, None, 6])],
        [("logits", 1, [None, None, V])],
        {"emb": np.ones((V, E), np.float32), "out_w": out_w, "bias": bias})
    for beam in (1, 2):
        j = JEncDec(tmp_path, "g", max_new=30, beam=beam)
        t = teng.OnnxEncDecEngine(tmp_path, "g", max_new=30, beam=beam, device="cpu")
        x = _chunks(2)
        want = j.transcribe_batch(x)
        assert t.transcribe_batch(x) == want
        # token 9 from the first step: at s - P = 8 the 8 trailing tokens
        # are equal and the row is cut at s - 6, leaving 2 tokens
        assert want == ["c2 c2"] * 2


def test_run_transcription_equals_jax(tmp_path, data_root):
    """A 65 s recording through run_transcription with a canary ONNX bundle
    in both packages: equal text. batch_chunks 2 pads the last batch (a
    float graph: pad rows do not touch the live rows)."""
    mid = "canary-180m-flash"
    models = tmp_path / "Models"
    path = ModelManager(models_dir=models).model_path(mid)
    path.mkdir(parents=True)
    jcases.make_canary_bundle(path)
    pcm = (speechlike(65 * 16000, seed=7, sr=16000) * 32767).astype(np.int16)
    wav = wavio.write_wav(tmp_path / "rec.wav", pcm, 16000)
    jbus = JEventBus()
    jtm = jtr.TranscriptionManager(jreg.ModelManager(models_dir=models, bus=jbus), bus=jbus)
    ttm = tr.TranscriptionManager(ModelManager(models_dir=models), bus=EventBus(), device="cpu")
    want = jtr.run_transcription(str(wav), jtm, mid, batch_chunks=2)
    tr.clear_transcription_progress(str(wav))
    got = tr.run_transcription(str(wav), ttm, mid, batch_chunks=2)
    assert got and got == want
    assert type(ttm.engine) is teng.OnnxEncDecEngine


def test_empty_graph_raises_as_jax(tmp_path):
    """canary and moonshine without params.npz reach the enc-dec engine in
    both packages; an empty graph then raises the same error."""
    for mid in ("canary-180m-flash", "moonshine-base"):
        models = tmp_path / mid / "Models"
        path = ModelManager(models_dir=models).model_path(mid)
        path.mkdir(parents=True)
        (path / "encoder-model.onnx").write_bytes(b"")
        (path / "decoder-model.onnx").write_bytes(b"")
        _, jerr = _run(jtr.load_engine, mid, jreg.ModelManager(models_dir=models,
                                                               bus=JEventBus()))
        _, terr = _run(tr.load_engine, mid, ModelManager(models_dir=models), device="cpu")
        assert type(terr) is type(jerr) and str(terr) == str(jerr), (jerr, terr)


def test_card_engine_needs_a_card(tmp_path, monkeypatch):
    jcases.make_canary_bundle(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.OnnxEncDecEngine(tmp_path, "c")


def test_canary_shaped_int8_bundle(tmp_path):
    """chip_smoke.py's canary bundle (the tools/bench_bundles encoder and an
    int8 pre-LN decoder with sinusoidal positions, causal self-attention
    and cross-attention) at the canary config of the port's test widths:
    equal texts, greedy and beam 3, in both packages."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    from crispy_tpu_torch.models.canary import CONFIGS

    chip_smoke.canary_bundle(tmp_path, CONFIGS["test-random"])
    x = _chunks(2, 24000)
    for beam in (1, 3):
        j = JEncDec(tmp_path, "int8", max_new=16, beam=beam)
        t = teng.OnnxEncDecEngine(tmp_path, "int8", max_new=16, beam=beam, device="cpu")
        assert t.prompt_ids == j.prompt_ids == [3, 4, 5, 4, 6] and t.eos_id == j.eos_id == 2
        want = j.transcribe_batch(x)
        assert t.transcribe_batch(x) == want and all(want)
