"""The port's Canary held against the plain reference of the benchmark
(``portbench/reference/canary.py``, one copy), on the CPU at a small size
on seeded random weights: the NeMo log-mel, the FastConformer encoder, the
teacher-forced decoder and the logits of every cached greedy step against
the reference's full forward over the prompt and the served tokens. A
fault planted in the port (the relative shift, the BatchNorm, a half-step)
fails the encoder's comparison. Then the ``canary.*`` spans of one
``transcribe_batch``, and ``load_engine`` over a prepared bundle against
the engine built from the same weights as a module.

Tolerances, each from float32 rounding: the port and the reference compute
the same equations in other orders (an FFT against a padded window, fused
against explicit attention, a shift against a gather), which leave ~1e-6 on
values of order 1 after two blocks; every bound below is ~100x that, and
each planted fault moves the encoder's output by more than 1e-2."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crispy_tpu_torch.dsp.asr_frontend import nemo_log_mel
from crispy_tpu_torch.engine import transcription as tr
from crispy_tpu_torch.models import canary as cn
from crispy_tpu_torch.models import parakeet as pk
from crispy_tpu_torch.models.carry import flat_layout
from crispy_tpu_torch.models.registry import ModelManager
from crispy_tpu_torch.models.spm import CONTROL, NORMAL, UNKNOWN, SentencePieceVocab, build_model_bytes
from crispy_tpu_torch.utils import tracing
from torch_audio import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from portbench.reference import canary as reference  # noqa: E402

SHAPE = reference.Shape(n_mels=128, d_model=64, enc_layers=2, enc_heads=2, enc_ffn=128,
                        conv_kernel=9, sub_channels=32, sub_factor=8, dec_layers=2, dec_heads=2,
                        dec_ffn=128, n_vocab=96, max_len=160)
CFG = cn.CanaryConfig(
    encoder=pk.ParakeetConfig(n_mels=128, hidden_size=64, layers=2, heads=2, kv_heads=2,
                              intermediate_size=128, conv_kernel=9, sub_channels=32, sub_factor=8,
                              vocab_size=96),
    vocab_size=96, dec_layers=2, dec_heads=2, dec_hidden=64, dec_ffn=128, max_len=160,
    bos=4, eos=3)
PROMPT = [7, 4, 16, 64, 64, 5, 9, 11, 13]  # canary2's 9-token layout at the cell's ids
SEED = 2**31 + 17

MEL_TOL = 1e-4  # features of order 1; FFT and mel sums in other orders
ENC_TOL = 1e-4  # the encoder's output after two post-LN blocks, of order 1-4
LOGIT_TOL = 1e-5  # teacher-forced logits of order 0.5 on the same encoder output
STEP_TOL = 1e-4  # each cached step against the full forward from the audio


def _weights():
    return reference.draw_weights(SHAPE, SEED, "cpu")


def _module(weights):
    with torch.device("meta"):
        net = cn.Canary(CFG)
    net.load_state_dict(weights, strict=True, assign=True)
    return net.eval().requires_grad_(False)


def _audio(B=2, n=32000):
    g = torch.Generator().manual_seed(5)
    t = torch.arange(n) / 16000.0
    tone = torch.sin(2 * torch.pi * (120.0 + 40.0 * torch.arange(B)[:, None]) * t)
    return 0.3 * tone * torch.sin(torch.pi * 3.0 * t) ** 2 + 0.01 * torch.randn(B, n, generator=g)


@pytest.fixture(scope="module")
def pair():
    w = _weights()
    return _module(w), reference.Reference(SHAPE, w)


def test_the_module_holds_every_reference_weight():
    with torch.device("meta"):
        sd = cn.Canary(CFG).state_dict()
    want = {n: sh for n, sh, _ in reference.layout(SHAPE)}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want


def test_log_mel_matches(pair):
    _, ref = pair
    a = _audio()
    port = nemo_log_mel(a, 128).transpose(1, 2)
    want = ref.log_mel(a)
    assert port.shape == want.shape == (2, 201, 128)
    assert float((port - want).abs().max()) < MEL_TOL


def _encoder_gap(net, ref):
    feats = ref.log_mel(_audio())
    with torch.no_grad():
        return float((cn.encode(net, feats) - ref.encode(feats)).abs().max())


def test_encoder_matches(pair):
    assert _encoder_gap(*pair) < ENC_TOL


def _no_shift(monkeypatch):
    monkeypatch.setattr(pk, "_rel_shift", lambda x: x)


def _no_batchnorm(monkeypatch):
    monkeypatch.setattr(pk.BatchNormInference, "forward", lambda self, h: h)


def _whole_first_step(monkeypatch):
    def forward(self, x, pos):
        x = x + self.ff1(self.ln_ff1(x))
        x = x + self.attn(self.ln_att(x), pos)
        x = x + self.conv(self.ln_conv(x))
        x = x + 0.5 * self.ff2(self.ln_ff2(x))
        return self.ln_out(x)

    monkeypatch.setattr(pk.ConformerBlock, "forward", forward)


@pytest.mark.parametrize("fault", [_no_shift, _no_batchnorm, _whole_first_step],
                         ids=["no-rel-shift", "no-batchnorm", "whole-first-half-step"])
def test_a_planted_fault_fails_the_encoder_comparison(pair, monkeypatch, fault):
    fault(monkeypatch)
    assert _encoder_gap(*pair) > 100 * ENC_TOL


def test_teacher_forced_logits_match(pair):
    net, ref = pair
    feats = ref.encode(ref.log_mel(_audio()))
    tokens = torch.randint(0, SHAPE.n_vocab, (2, 24), generator=torch.Generator().manual_seed(3))
    port = cn.decode_logits(net, tokens, feats)
    assert float((port - ref.decode(tokens, feats)).abs().max()) < LOGIT_TOL


def test_every_cached_step_matches_the_full_forward(pair, monkeypatch):
    """The logits each cached step returned (the prompt's last position,
    then max_new - 1 steps) against the reference's one pass over the
    prompt and the served tokens, from the audio."""
    net, ref = pair
    step, seen = cn._decode_step, []

    def _decode_step(*a, **k):
        seen.append(step(*a, **k))
        return seen[-1]

    monkeypatch.setattr(cn, "_decode_step", _decode_step)
    a = _audio()
    feats = nemo_log_mel(a, 128).transpose(1, 2)
    prompt = torch.tensor(PROMPT).expand(2, -1)
    max_new = 24
    tokens, lengths = cn.greedy_decode(net, feats, max_new=max_new, prompt=prompt)
    assert len(seen) == len(PROMPT) + max_new - 1
    port = torch.stack(seen[len(PROMPT) - 1:], dim=1)  # [B, max_new, V]
    want = ref.logits(a, torch.cat([prompt, tokens[:, :-1]], dim=1))[:, len(PROMPT) - 1:]
    for b in range(2):
        n = min(int(lengths[b]) + 1, max_new)  # through the first eos; frozen after it
        assert float((port[b, :n] - want[b, :n]).abs().max()) < STEP_TOL
        assert torch.equal(tokens[b, :n], port[b, :n].argmax(-1))


@pytest.mark.gpu
def test_the_graphed_steps_on_the_card_match_the_eager_steps(pair, monkeypatch):
    """On the card each step replays one CUDA graph of the whole step: the
    logits each step returned (copied, as the next replay overwrites the
    graph's output buffer) lie within STEP_TOL of the eager steps' on the
    CPU, the tokens are the same, and a second decode, which captures
    afresh, serves them again. Here, without a card, it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    net, _ = pair
    card = _module({k: v.cuda() for k, v in _weights().items()})
    seen, replays = {"cpu": [], "cuda": []}, []
    call, replay = cn.DecodeStep.__call__, torch.cuda.CUDAGraph.replay

    def __call__(self_, tok, pos):
        out = call(self_, tok, pos)
        seen[out.device.type].append(out.clone())
        return out

    def counted(self_):
        replays.append(1)
        return replay(self_)

    monkeypatch.setattr(cn.DecodeStep, "__call__", __call__)
    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", counted)
    feats = nemo_log_mel(_audio(), 128).transpose(1, 2)
    prompt = torch.tensor(PROMPT).expand(2, -1)
    max_new = 24
    tokens, lengths = cn.greedy_decode(net, feats, max_new=max_new, prompt=prompt)
    on_card = cn.greedy_decode(card, feats.cuda(), max_new=max_new, prompt=prompt.cuda())
    again = cn.greedy_decode(card, feats.cuda(), max_new=max_new, prompt=prompt.cuda())
    steps = len(PROMPT) + max_new - 1
    assert len(replays) == 2 * steps and len(seen["cuda"]) == 2 * steps
    for t, n in (on_card, again):
        assert torch.equal(t.cpu(), tokens) and torch.equal(n.cpu(), lengths)
    for host, dev in zip(seen["cpu"], seen["cuda"][:steps]):
        assert float((dev.cpu() - host).abs().max()) < STEP_TOL


def _vocab():
    pieces = [f"▁w{i}" for i in range(SHAPE.n_vocab)]
    types = [NORMAL] * SHAPE.n_vocab
    specials = {"<unk>": 0, "<|endoftext|>": 3, "<|startoftranscript|>": 4, "<|pnc|>": 5,
                "<|startofcontext|>": 7, "<|noitn|>": 9, "<|notimestamp|>": 11,
                "<|nodiarize|>": 13, "<|emo:undefined|>": 16, "<|en|>": 64, "<|de|>": 65}
    for p, i in specials.items():
        pieces[i], types[i] = p, UNKNOWN if p == "<unk>" else CONTROL
    return pieces, types


def test_the_spans_of_one_call(pair):
    """Root ``canary.transcribe`` over ``canary.mel``, ``canary.encode``,
    ``canary.decode``, ``canary.readback`` and ``canary.detok``, in that
    order; ``canary.decode`` over ``canary.init_cache``, ``canary.prefill``
    (the whole prompt) and one ``canary.step`` a cached step: max_new - 1 =
    127 at the engine's 128 tokens, whatever the prompt's length. Nothing
    is recorded outside a profiler session."""
    net, _ = pair
    eng = tr.CanaryEngine("canary-test", net, SentencePieceVocab(*_vocab()), PROMPT, "cpu")
    before = len(tracing.spans())
    eng.transcribe_batch(_audio())
    assert len(tracing.spans()) == before
    with profile(activities=[ProfilerActivity.CPU]):
        texts = eng.transcribe_batch(_audio())
    assert len(texts) == 2
    spans = tracing.spans()[before:]
    by_id = {s.id: s for s in spans}
    root = [s for s in spans if s.parent is None]
    assert [s.name for s in root] == ["canary.transcribe"]

    def children(s):
        return [c.name for c in sorted(spans, key=lambda c: c.start_ns) if c.parent == s.id]

    assert children(root[0]) == ["canary.mel", "canary.encode", "canary.decode",
                                 "canary.readback", "canary.detok"]
    decode = next(s for s in spans if s.name == "canary.decode")
    assert children(decode) == ["canary.init_cache", "canary.prefill"] + ["canary.step"] * 127
    assert all(by_id[s.parent].name == "canary.decode" for s in spans if s.name == "canary.step")


def test_load_engine_equals_the_engine_over_the_module(tmp_path, monkeypatch):
    """A prepared bundle (the module's weights in the flat layout as
    ``params.npz``, the widths and prompt in ``config.json``, a
    ``tokenizer.model``) through ``load_engine``, against ``CanaryEngine``
    built from the module itself: the same tokens and texts, in English
    and with the German language slot."""
    w = _weights()
    net = _module(w)
    sd = net.state_dict()
    flat = {name: flat_layout(name, sd[cn._module_name(name)].numpy())  # the module's weights,
            for name in cn.init_random(CFG) if cn._module_name(name) in sd}  # flat names and layouts
    assert len(flat) == len(sd)
    mm = ModelManager(models_dir=tmp_path / "Models")
    path = mm.model_path("canary-1b-v2")
    path.mkdir(parents=True)
    np.savez(path / "params.npz", **flat)
    enc = CFG.encoder
    raw = {"encoder": {"n_mels": enc.n_mels, "hidden_size": enc.hidden_size, "layers": enc.layers,
                       "heads": enc.heads, "kv_heads": enc.kv_heads,
                       "intermediate_size": enc.intermediate_size, "conv_kernel": enc.conv_kernel,
                       "sub_channels": enc.sub_channels, "vocab_size": enc.vocab_size},
           "vocab_size": CFG.vocab_size, "dec_layers": CFG.dec_layers,
           "dec_heads": CFG.dec_heads, "dec_hidden": CFG.dec_hidden, "dec_ffn": CFG.dec_ffn,
           "max_len": CFG.max_len, "bos": CFG.bos, "eos": CFG.eos, "prompt_ids": PROMPT}
    (path / "config.json").write_text(json.dumps(raw))
    pieces, types = _vocab()
    (path / "tokenizer.model").write_bytes(build_model_bytes(pieces, types))
    bundled = tr.load_engine("canary-1b-v2", mm, device="cpu")
    built = tr.CanaryEngine("canary-1b-v2", net, SentencePieceVocab(pieces, types), PROMPT, "cpu")
    assert type(bundled) is tr.CanaryEngine
    decode, served = cn.greedy_decode, []

    def greedy_decode(*a, **k):
        served.append(decode(*a, **k))
        return served[-1]

    monkeypatch.setattr(cn, "greedy_decode", greedy_decode)
    a = _audio()
    for lang in ("en", "de"):
        assert bundled.prompt_for_language(lang) == built.prompt_for_language(lang)
        assert bundled.transcribe_batch(a, language=lang) == built.transcribe_batch(a, language=lang)
        (t1, n1), (t2, n2) = served[-2:]
        assert torch.equal(t1, t2) and torch.equal(n1, n2)
    assert built.prompt_for_language("de") == [65 if t == 64 else t for t in PROMPT]
