"""The port's Whisper (crispy_tpu_torch.models.whisper) held against the JAX
package on the CPU, at test-random widths (d=64, 2+2 layers, V=1000), on the
same numpy weights and inputs.

Tolerances: encoder output, teacher-forced logits, and prefill/step logits
with an f32 KV cache within 1e-4 of the JAX values relative to their max
(f32 products summed in another order); with the bf16 KV cache within 1e-3
(both round K and V at the same points, so the cache agrees; an element
whose f32 value lands on the other side of a bf16 rounding boundary would
move by 2^-8 relative); tokens and lengths exactly; sum logprob within 1e-4
relative and no-speech probability within 1e-4. The tests marked ``gpu``
hold the card against the port's CPU path; here they skip.
"""

import numpy as np
import pytest
import torch

from crispy_tpu_torch.dsp.mel import log_mel_spectrogram as tmel
from crispy_tpu_torch.models import whisper as tpkg
from crispy_tpu_torch.models.whisper import ggml_io as tg
from crispy_tpu_torch.models.whisper import model as tm
from crispy_tpu_torch.models.whisper import weights as tw
from crispy_tpu_torch.models.whisper.tokenizer import WhisperTokenizer as TTok
from test_golden_decode import GOLDEN_BEAM3, GOLDEN_GREEDY
from torch_audio import one_torch_thread  # noqa: F401 (autouse fixture)

try:  # the reference; the card's machine has no JAX and runs only the gpu tests
    import jax
    import jax.numpy as jnp

    from crispy_tpu.dsp.mel import log_mel_spectrogram as jmel
    from crispy_tpu.models import whisper as jpkg
    from crispy_tpu.models.whisper import ggml_io as jg
    from crispy_tpu.models.whisper import model as jm
    from crispy_tpu.models.whisper import weights as jwts
    from crispy_tpu.models.whisper.tokenizer import WhisperTokenizer as JTok
except ImportError:
    jm = None
needs_jax = pytest.mark.skipif(jm is None, reason="the JAX reference is not installed")

CFG = tm.CONFIGS["test-random"]
SEED = 3
MAX_NEW = 12


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def lt(x):
    return torch.from_numpy(np.asarray(x, np.int64))


@pytest.fixture(scope="module")
def params():
    return tw.init_random(CFG, SEED)


@pytest.fixture(scope="module")
def tmodel(params):
    return tw.params_to_module(params, CFG, device="cpu")


@pytest.fixture(scope="module")
def jparams(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def mel():
    """JAX log-mel of two 1 s noise chunks padded to 30 s: [2, 80, 3000]."""
    rng = np.random.default_rng(5)
    audio = rng.standard_normal((2, 16000)).astype(np.float32) * 0.1
    return np.array(jmel(jnp.asarray(audio), n_mels=80, pad_to_chunk=True))


@pytest.fixture(scope="module")
def audio_feats(mel, jparams):
    """JAX encoder output of ``mel``, fed to both decoders."""
    return np.array(jm.encode(jparams, CFG, jnp.asarray(mel)))


# ---------------------------------------------------------------------------
# Weights, containers, carry
# ---------------------------------------------------------------------------

@needs_jax
class TestWeights:
    @pytest.mark.parametrize("size", ["test-random", "tiny"])
    def test_init_random_bit_equal(self, size):
        a = tw.init_random(tm.CONFIGS[size], 11)
        b = jwts.init_random(jm.CONFIGS[size], 11)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    def test_carry_round_trips_and_layout(self, params, tmodel):
        back = tw.module_to_params(tmodel)
        assert back.keys() == params.keys()
        for k in params:
            np.testing.assert_array_equal(back[k], params[k], err_msg=k)
        blk = tmodel.encoder.blocks[0]
        np.testing.assert_array_equal(blk.mlp.fc1.weight.numpy(), params["enc.0.mlp.fc1.w"].T)
        np.testing.assert_array_equal(tmodel.encoder.conv1.weight.numpy(),
                                      params["enc.conv1.w"].transpose(2, 1, 0))
        assert tmodel.encoder.conv2.weight.shape == (64, 64, 3)
        assert not any(p.requires_grad for p in tmodel.parameters())

    @pytest.mark.parametrize("ttype", [0, 1, 8])
    def test_ggml_write_and_load_bit_equal(self, tmp_path, params, ttype):
        """write_ggml writes the JAX package's bytes; load_ggml gives its
        params (f32, f16 and q8_0 dequantized), config, vocab and filters."""
        a = tg.write_ggml(tmp_path / "port.bin", params, CFG, ttype=ttype)
        b = jg.write_ggml(tmp_path / "jax.bin", params, jm.CONFIGS["test-random"], ttype=ttype)
        assert a.read_bytes() == b.read_bytes()
        tp, tcfg, tvocab, tfil = tw.load_ggml(a)
        jp_, jcfg, jvocab, jfil = jwts.load_ggml(a)
        assert tcfg.__dict__ == jcfg.__dict__ and tvocab == jvocab
        np.testing.assert_array_equal(tfil, jfil)
        assert tp.keys() == jp_.keys() == params.keys()
        for k in tp:
            np.testing.assert_array_equal(tp[k], jp_[k], err_msg=k)

    def test_quantizers_bit_equal(self):
        rng = np.random.default_rng(2)
        x = rng.standard_normal(32 * 40).astype(np.float32)
        x[:32] = 0.0  # an all-zero block
        q = tg.quantize_q8_0(x)
        assert q == jg.quantize_q8_0(x)
        blocks = np.frombuffer(rng.bytes(24 * 40), np.uint8).reshape(40, 24).copy()
        blocks[:, :4] = np.frombuffer(np.float16([0.01, -0.02]).tobytes() * 40,
                                      np.uint8).reshape(40, 4)
        for ttype, nbytes in ((2, 18), (3, 20), (6, 22), (7, 24), (8, 34)):
            data = np.frombuffer(rng.bytes(nbytes * 40), np.uint8).reshape(40, nbytes).copy()
            data[:, :2] = blocks[:, :2]
            if ttype in (3, 7):
                data[:, 2:4] = blocks[:, 2:4]
            np.testing.assert_array_equal(
                tw.dequantize_ggml(data.tobytes(), ttype, 32 * 40),
                jwts.dequantize_ggml(data.tobytes(), ttype, 32 * 40), err_msg=str(ttype))

    def test_hf_checkpoint_loads_as_jax_does(self, tmp_path, params):
        """from_hf_state_dict and load_hf's pytorch_model.bin branch give the
        JAX package's params and config."""
        sd = hf_state_dict(params, CFG)
        a, acfg = tw.from_hf_state_dict(sd)
        b, bcfg = jwts.from_hf_state_dict(sd)
        assert acfg == tm.WhisperConfig(**bcfg.__dict__)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "pytorch_model.bin")
        c, _ = tw.load_hf(tmp_path)
        for k in b:
            np.testing.assert_array_equal(c[k], b[k], err_msg=k)
        with pytest.raises(FileNotFoundError):
            tw.load_hf(tmp_path / "missing")


def hf_state_dict(params, cfg):
    """WhisperForConditionalGeneration names for flat params."""
    hf = {"model.encoder.conv1.weight": params["enc.conv1.w"].transpose(2, 1, 0),
          "model.encoder.conv1.bias": params["enc.conv1.b"],
          "model.encoder.conv2.weight": params["enc.conv2.w"].transpose(2, 1, 0),
          "model.encoder.conv2.bias": params["enc.conv2.b"],
          "model.encoder.embed_positions.weight": params["enc.pos"],
          "model.encoder.layer_norm.weight": params["enc.ln_post.g"],
          "model.encoder.layer_norm.bias": params["enc.ln_post.b"],
          "model.decoder.embed_tokens.weight": params["dec.emb"],
          "model.decoder.embed_positions.weight": params["dec.pos"],
          "model.decoder.layer_norm.weight": params["dec.ln.g"],
          "model.decoder.layer_norm.bias": params["dec.ln.b"]}
    proj = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "out": "out_proj"}
    lns = {"ln1": "self_attn_layer_norm", "lnx": "encoder_attn_layer_norm",
           "ln2": "final_layer_norm"}
    for side, n in (("enc", cfg.n_audio_layer), ("dec", cfg.n_text_layer)):
        for i in range(n):
            t = f"model.{'encoder' if side == 'enc' else 'decoder'}.layers.{i}"
            for ours, theirs in (("attn", "self_attn"), ("cross", "encoder_attn")):
                if side == "enc" and ours == "cross":
                    continue
                for o, h in proj.items():
                    hf[f"{t}.{theirs}.{h}.weight"] = params[f"{side}.{i}.{ours}.{o}.w"].T
                    if o != "k":
                        hf[f"{t}.{theirs}.{h}.bias"] = params[f"{side}.{i}.{ours}.{o}.b"]
            for ln, h in lns.items():
                if side == "enc" and ln == "lnx":
                    continue
                hf[f"{t}.{h}.weight"] = params[f"{side}.{i}.{ln}.g"]
                hf[f"{t}.{h}.bias"] = params[f"{side}.{i}.{ln}.b"]
            for fc in ("fc1", "fc2"):
                hf[f"{t}.{fc}.weight"] = params[f"{side}.{i}.mlp.{fc}.w"].T
                hf[f"{t}.{fc}.bias"] = params[f"{side}.{i}.mlp.{fc}.b"]
    return {k: np.ascontiguousarray(v) for k, v in hf.items()}


# ---------------------------------------------------------------------------
# Encoder, teacher forcing, prefill and the cached step
# ---------------------------------------------------------------------------

@needs_jax
class TestModel:
    def test_encode_matches_jax(self, tmodel, mel, audio_feats):
        got = tm.encode(tmodel, torch.from_numpy(mel)).numpy()
        assert got.shape == (2, 1500, 64)
        assert rel(got, audio_feats) <= 1e-4

    def test_decode_logits_matches_jax(self, tmodel, jparams, audio_feats):
        toks = np.random.default_rng(6).integers(0, 1000, (2, 9)).astype(np.int32)
        want = np.array(jm.decode_logits(jparams, CFG, jnp.asarray(toks), jnp.asarray(audio_feats)))
        got = tm.decode_logits(tmodel, lt(toks), torch.from_numpy(audio_feats)).numpy()
        assert got.shape == (2, 9, 1000)
        assert rel(got, want) <= 1e-4

    @pytest.mark.parametrize("kv,tol", [("f32", 1e-4), ("bf16", 1e-3)])
    def test_prefill_and_steps_match_jax(self, tmodel, jparams, audio_feats, monkeypatch,
                                         kv, tol):
        monkeypatch.setenv("CRISPY_WHISPER_KV", kv)
        rng = np.random.default_rng(7)
        prompt = rng.integers(0, 990, (2, 5)).astype(np.int32)
        max_len = 9
        ja = jnp.asarray(audio_feats)
        jc = jm._init_cache(jparams, CFG, ja, max_len)
        jl, jsk, jsv = jm._prefill(jparams, CFG, jnp.asarray(prompt), *jc)
        tc = tm._init_cache(tmodel, torch.from_numpy(audio_feats), max_len)
        assert all(t.dtype == (torch.float32 if kv == "f32" else torch.bfloat16) for t in tc)
        tl, tsk, tsv = tm._prefill(tmodel, lt(prompt), *tc)
        assert rel(tl, np.array(jl)) <= tol
        tok = rng.integers(0, 990, 2).astype(np.int32)
        for i in range(4):
            jlog, jsk, jsv = jm._decode_step(jparams, CFG, jnp.asarray(tok), 5 + i, jsk, jsv,
                                             jc[2], jc[3], max_len)
            tlog, tsk, tsv = tm._decode_step(tmodel, lt(tok), 5 + i, tsk, tsv, tc[2], tc[3],
                                             max_len)
            assert rel(tlog, np.array(jlog)) <= tol, i
            tok = np.array(jlog).argmax(-1).astype(np.int32)
        if kv == "bf16":
            # the rounded caches agree but where an f32 value straddles a
            # bf16 rounding boundary: there they differ by one bf16 ulp
            for t, j in ((tsk, jsk), (tsv, jsv), (tc[2], jc[2]), (tc[3], jc[3])):
                a, b = t.float().numpy(), np.array(j.astype(jnp.float32))
                off = a != b
                assert off.mean() <= 0.01
                assert np.all(np.abs(a - b)[off] <= 2.0 ** -7 * np.abs(b)[off])

    def test_kv_dtype_defaults_to_bf16(self, tmodel, monkeypatch):
        audio = torch.zeros((1, 8, 64))
        monkeypatch.delenv("CRISPY_WHISPER_KV", raising=False)
        assert all(t.dtype == torch.bfloat16 for t in tm._init_cache(tmodel, audio, 16))
        monkeypatch.setenv("CRISPY_WHISPER_KV", "f32")
        assert all(t.dtype == torch.float32 for t in tm._init_cache(tmodel, audio, 16))

    def test_prefill_first_token_and_context_clamp(self, tmodel, audio_feats):
        rng = np.random.default_rng(1)
        feats = torch.from_numpy(audio_feats)
        prompt = lt(rng.integers(0, 900, (2, 37)))
        want = tm.decode_logits(tmodel, prompt, feats)[:, -1].argmax(-1)
        toks, _ = tm.greedy_decode(tmodel, feats, prompt, max_new=8, eot=999)
        assert torch.equal(toks[:, 0], want)
        long_prompt = lt(rng.integers(0, 900, (1, CFG.n_text_ctx - 2)))
        toks2, _ = tm.greedy_decode(tmodel, feats[:1], long_prompt, max_new=224, eot=999)
        assert toks2.shape[1] == 2
        with pytest.raises(ValueError):
            tm._clamp_max_new(CFG, CFG.n_text_ctx, 4)


# ---------------------------------------------------------------------------
# Decode loops
# ---------------------------------------------------------------------------

def _eot_inside(tokens) -> int:
    """A token the first row emits at position 3: as eot it freezes that row."""
    return int(np.asarray(tokens)[0, 3])


@needs_jax
class TestDecode:
    @pytest.fixture(scope="class")
    def prompt(self):
        return np.tile(np.array([[CFG.sot, 5, 17]], np.int32), (2, 1))

    @pytest.fixture(scope="class")
    def eot(self, jparams, mel, prompt):
        toks, _ = jm.greedy_decode(jparams, CFG, jnp.asarray(mel), jnp.asarray(prompt),
                                   max_new=MAX_NEW, eot=CFG.eot)
        return _eot_inside(toks)

    def test_greedy_matches_jax(self, tmodel, jparams, mel, prompt, eot):
        jt, jl = jm.greedy_decode(jparams, CFG, jnp.asarray(mel), jnp.asarray(prompt),
                                  max_new=MAX_NEW, eot=eot)
        tt, tl = tm.greedy_decode(tmodel, torch.from_numpy(mel), lt(prompt), max_new=MAX_NEW,
                                  eot=eot)
        np.testing.assert_array_equal(tt.numpy(), np.array(jt))
        np.testing.assert_array_equal(tl.numpy(), np.array(jl))
        assert int(tl[0]) <= 3  # row 0 met eot and froze

    @pytest.mark.parametrize("beam,beyond", [(1, False), (3, False), (3, True)])
    def test_beam_matches_jax(self, tmodel, jparams, mel, prompt, eot, beam, beyond):
        """beyond: an eot past the vocabulary, as a test-random ggml file's
        header gives it (50257 of 1000 rows)."""
        if beyond:
            eot = 50257
        jt, jl, js = jm.beam_decode(jparams, CFG, jnp.asarray(mel), jnp.asarray(prompt),
                                    beam=beam, max_new=MAX_NEW, eot=eot)
        tt, tl, ts = tm.beam_decode(tmodel, torch.from_numpy(mel), lt(prompt), beam=beam,
                                    max_new=MAX_NEW, eot=eot)
        np.testing.assert_array_equal(tt.numpy(), np.array(jt))
        np.testing.assert_array_equal(tl.numpy(), np.array(jl))
        np.testing.assert_allclose(ts.numpy(), np.array(js), rtol=1e-4)
        if beam == 1:
            gt, _ = tm.greedy_decode(tmodel, torch.from_numpy(mel), lt(prompt),
                                     max_new=MAX_NEW, eot=eot)
            assert torch.equal(tt, gt)

    def test_sample_t0_matches_jax(self, tmodel, jparams, mel, prompt, eot):
        jt, jl, jlp, jns = jm.sample_decode(
            jparams, CFG, jnp.asarray(mel), jnp.asarray(prompt), jnp.float32(0.0),
            jax.random.PRNGKey(0), jnp.int32(CFG.eot - 3), jnp.int32(0), max_new=MAX_NEW, eot=eot)
        tt, tl, tlp, tns = tm.sample_decode(tmodel, torch.from_numpy(mel), lt(prompt), 0.0, None,
                                            CFG.eot - 3, 0, max_new=MAX_NEW, eot=eot)
        np.testing.assert_array_equal(tt.numpy(), np.array(jt))
        np.testing.assert_array_equal(tl.numpy(), np.array(jl))
        np.testing.assert_allclose(tlp.numpy(), np.array(jlp), rtol=1e-4)
        np.testing.assert_allclose(tns.numpy(), np.array(jns), atol=1e-4)
        gt, gl = tm.greedy_decode(tmodel, torch.from_numpy(mel), lt(prompt), max_new=MAX_NEW,
                                  eot=eot)
        assert torch.equal(tt, gt) and torch.equal(tl, gl)

    def test_top_k_orders_ties_as_lax(self):
        rng = np.random.default_rng(8)
        x = rng.integers(0, 4, (3, 40)).astype(np.float32)
        x[1, ::3] = -np.inf
        x[2, :] = -np.inf
        x[2, 7] = 0.0
        for k in (1, 3, 5):
            tv, ti = tm._top_k(torch.from_numpy(x), k)
            jv, ji = jax.lax.top_k(jnp.asarray(x), k)
            np.testing.assert_array_equal(tv.numpy(), np.array(jv))
            np.testing.assert_array_equal(ti.numpy(), np.array(ji))


class TestGoldens:
    """The port's own log-mel and decode reproduce the pinned tokens of
    tests/test_golden_decode.py (bf16 KV, the default)."""

    @pytest.fixture(scope="class")
    def fixture(self):
        m = tpkg.WhisperModel.random("test-random", seed=42, device="cpu")
        t = np.arange(32000) / 16000.0
        audio = np.stack([
            (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * np.sin(2 * np.pi * 3 * t)).astype(np.float32),
            (0.2 * np.sin(2 * np.pi * 440 * t) * np.exp(-t / 1.5)).astype(np.float32),
        ])
        mel = tmel(torch.from_numpy(audio), n_mels=80, pad_to_chunk=True)
        return m, mel, torch.full((2, 1), m.cfg.sot, dtype=torch.long)

    def test_greedy_golden(self, fixture, monkeypatch):
        monkeypatch.delenv("CRISPY_WHISPER_KV", raising=False)
        m, mel, prompt = fixture
        toks, _ = tm.greedy_decode(m.model, mel, prompt, max_new=24, eot=m.cfg.eot)
        np.testing.assert_array_equal(toks[:, :12].numpy(), GOLDEN_GREEDY)

    def test_beam_golden(self, fixture, monkeypatch):
        monkeypatch.delenv("CRISPY_WHISPER_KV", raising=False)
        m, mel, prompt = fixture
        toks, _, _ = tm.beam_decode(m.model, mel, prompt, beam=3, max_new=24, eot=m.cfg.eot)
        np.testing.assert_array_equal(toks[:, :12].numpy(), GOLDEN_BEAM3)

    def test_sample_t0_golden(self, fixture, monkeypatch):
        monkeypatch.delenv("CRISPY_WHISPER_KV", raising=False)
        m, mel, prompt = fixture
        toks, *_ = tm.sample_decode(m.model, mel, prompt, 0.0, None, 0, max_new=24,
                                    eot=m.cfg.eot)
        np.testing.assert_array_equal(toks[:, :12].numpy(), GOLDEN_GREEDY)


def test_sampling_deterministic_per_seed(tmodel):
    """T > 0 draws from a torch.Generator: the same seed gives the same
    tokens, another seed others."""
    mel = tmel(torch.from_numpy((0.1 * np.sin(np.arange(16000) / 20)).astype(np.float32)[None]),
               pad_to_chunk=True)
    prompt = torch.tensor([[CFG.sot]])

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return tm.sample_decode(tmodel, mel, prompt, 1.0, gen, 0, max_new=16, eot=CFG.eot)

    a, b, c = draw(7), draw(7), draw(8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    assert not torch.equal(a[0], c[0])
    assert float(a[2][0]) <= 0.0 and 0.0 <= float(a[3][0]) <= 1.0


# ---------------------------------------------------------------------------
# WhisperModel, tokenizer, segments
# ---------------------------------------------------------------------------

@needs_jax
class TestWhisperModel:
    @pytest.fixture(scope="class")
    def pair(self):
        return (jpkg.WhisperModel.random("test-random", seed=0),
                tpkg.WhisperModel.random("test-random", seed=0, device="cpu"))

    @pytest.fixture(scope="class")
    def audio(self):
        return (np.random.default_rng(1).standard_normal((2, 16000)) * 0.1).astype(np.float32)

    def test_transcribe_chunks_matches_jax(self, pair, audio):
        jwm, twm = pair
        assert twm.transcribe_chunks(audio, max_new=MAX_NEW) == jwm.transcribe_chunks(
            audio, max_new=MAX_NEW)
        assert twm.transcribe_chunks(audio[:1], max_new=MAX_NEW, initial_prompt="<3><7>") == \
            jwm.transcribe_chunks(audio[:1], max_new=MAX_NEW, initial_prompt="<3><7>")

    def test_robust_at_t0_and_gates_match_jax(self, pair, audio):
        jwm, twm = pair
        for kw in ({"temperatures": (0.0,)},
                   {"temperatures": (0.0,), "logprob_threshold": float("inf"),
                    "no_speech_threshold": -1.0},
                   {"temperatures": (0.0, 1.0), "compression_ratio_threshold": 1e9,
                    "logprob_threshold": -1e9}):
            assert twm.transcribe_chunks_robust(audio, max_new=MAX_NEW, **kw) == \
                jwm.transcribe_chunks_robust(audio, max_new=MAX_NEW, **kw), kw
        # the silence gate empties every chunk
        assert twm.transcribe_chunks_robust(
            audio, max_new=MAX_NEW, temperatures=(0.0,), logprob_threshold=float("inf"),
            no_speech_threshold=-1.0) == ["", ""]

    def test_timestamps_match_jax(self, pair, audio):
        jwm, twm = pair
        assert twm.transcribe_chunks_with_timestamps(audio, [0.0, 30.0], max_new=MAX_NEW) == \
            jwm.transcribe_chunks_with_timestamps(audio, [0.0, 30.0], max_new=MAX_NEW)
        assert twm.transcribe_chunk_with_timestamps(audio[0], 30.0, max_new=MAX_NEW) == \
            jwm.transcribe_chunk_with_timestamps(audio[0], 30.0, max_new=MAX_NEW)

    def test_prompt_ids_match_jax(self, pair):
        jwm, twm = pair
        for args in (("en", None), ("en", "hello there"), ("de", "x"), ("en", None, True)):
            assert twm._prompt_ids(*args) == jwm._prompt_ids(*args)

    def test_tokenizer_matches_jax(self):
        for n in (51864, 51865, 51866):
            vocab = [b"hel", b"lo", b" wor", b"ld", b"ab", b"a"] + [b""] * (n - 6)
            t, j = TTok.from_ggml_vocab(vocab, n), JTok.from_ggml_vocab(vocab, n)
            for lang in ("en", "de", "yue", "xx"):
                for ts in (False, True):
                    assert t.sot_sequence(lang, timestamps=ts) == j.sot_sequence(lang, timestamps=ts)
            ids = [t.sot, 0, 1, 2, 3, t.timestamp_begin + 50, t.eot, 4, 5]
            for wt in (False, True):
                assert t.decode(ids, with_timestamps=wt) == j.decode(ids, with_timestamps=wt)
            assert t.encode("hello world aba") == j.encode("hello world aba")
            assert [t.timestamp_seconds(i) for i in (0, t.timestamp_begin + 7)] == \
                [j.timestamp_seconds(i) for i in (0, j.timestamp_begin + 7)]
        assert TTok.dummy(1000).__dict__ == JTok.dummy(1000).__dict__

    def test_segments_and_compression_ratio_match_jax(self):
        tok = TTok(vocab=[b"hi", b" there", b" yo", b"tail"] + [b""] * 60000)
        jtok = JTok(vocab=tok.vocab)
        tb = tok.timestamp_begin
        for ids in ([50258, tb, 0, 1, tb + 50, tb + 75, 2, tb + 100, 50257],
                    [50258, 0, 50257], [tb + 100, 3], [tb, tb + 10], []):
            for off, dur in ((10.0, 30.0), (0.0, 1.5)):
                assert tpkg.parse_timestamp_segments(ids, tok, off, dur) == \
                    jpkg.parse_timestamp_segments(ids, jtok, off, dur)
        for s in ("", "the quick brown fox", "again again again " * 40, "ünïcödé"):
            assert tpkg.compression_ratio(s) == jpkg.compression_ratio(s)
        assert tpkg.compression_ratio("again again again " * 40) > 2.4


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpkg.WhisperModel.random("test-random")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw.params_to_module(tw.init_random(CFG, 0), CFG)


# ---------------------------------------------------------------------------
# The card against the port's CPU path (chip_smoke.py phase 6 at small width)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
class TestCard:
    @pytest.fixture(scope="class")
    def models(self, tmp_path_factory):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        path = tg.write_ggml(tmp_path_factory.mktemp("w") / "m.bin", tw.init_random(CFG, 0), CFG)
        return (tpkg.WhisperModel.from_ggml(path, device="cuda"),
                tpkg.WhisperModel.from_ggml(path, device="cpu"))

    @pytest.fixture(scope="class")
    def audio(self):
        t = np.arange(2 * 160000) / 16000.0
        sig = np.sin(2 * np.pi * 180 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 1.3 * t))
        sig += 0.03 * np.random.default_rng(0).standard_normal(t.size)
        return torch.from_numpy((0.4 * sig / np.abs(sig).max()).astype(np.float32).reshape(2, -1))

    def test_mel_and_encoder_match_cpu(self, models, audio):
        card, cpu = models
        mc = tmel(audio.cuda(), pad_to_chunk=True)
        mh = tmel(audio, pad_to_chunk=True)
        assert float((mc.cpu() - mh).abs().max()) <= 1e-4
        ec = tm.encode(card.model, mc).cpu()
        eh = tm.encode(cpu.model, mh)
        assert rel(ec, eh) <= 1e-4

    def test_decode_loops_issue_no_host_sync(self, models, audio):
        """No .item(), .cpu() or blocking copy anywhere in the decode calls:
        CUDA's sync debug mode raises on the first."""
        card, _ = models
        feats = tm.encode(card.model, tmel(audio.cuda(), pad_to_chunk=True))
        prompt = torch.tensor([[CFG.sot, 3]] * 2, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            tm.greedy_decode(card.model, feats, prompt, max_new=8)
            tm.sample_decode(card.model, feats, prompt, 1.0, gen, 5, max_new=8)
            tm.beam_decode(card.model, feats, prompt, beam=3, max_new=8)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def test_logits_and_cached_greedy(self, models, audio, monkeypatch):
        monkeypatch.setenv("CRISPY_WHISPER_KV", "f32")
        card, cpu = models
        mel = tmel(audio, pad_to_chunk=True)
        prompt = torch.tensor([[CFG.sot, 3, 5, 7]] * 2)
        seq = torch.cat([prompt, lt(np.random.default_rng(0).integers(0, 990, (2, 20)))], 1)
        fc = tm.encode(card.model, mel.cuda())
        fh = tm.encode(cpu.model, mel)
        assert rel(tm.decode_logits(card.model, seq.cuda(), fc).cpu(),
                   tm.decode_logits(cpu.model, seq, fh)) <= 1e-4
        cache = tm._init_cache(card.model, fc, seq.shape[1])
        pc = tm._prefill(card.model, seq.cuda(), *cache)[0].cpu()
        ph = tm._prefill(cpu.model, seq, *tm._init_cache(cpu.model, fh, seq.shape[1]))[0]
        assert rel(pc, ph) <= 1e-4
        toks, lens = tm.greedy_decode(card.model, fc, prompt.cuda(), max_new=24, eot=CFG.eot)
        full = torch.cat([prompt.cuda(), toks], 1)
        tf = tm.decode_logits(card.model, full[:, :-1], fc)[:, prompt.shape[1] - 1:]
        picked = tf.gather(-1, toks[..., None])[..., 0]
        # each cached token is the teacher-forced argmax, up to a near-tie
        assert bool((picked >= tf.amax(-1) - 1e-4 * float(tf.abs().max())).all())

    def test_sample_decode_t0_matches_cpu(self, models, audio):
        """The engine's first rung on the card: equal tokens and lengths,
        lp_sum within 1e-4 relative, no_speech_prob within 1e-4."""
        card, cpu = models
        prompt = [CFG.sot, 3, 5]
        runs = []
        for m, d in ((card, "cuda"), (cpu, "cpu")):
            gen = torch.Generator(device=d).manual_seed(0)
            out = tm.sample_decode(m.model, tmel(audio.to(d), pad_to_chunk=True),
                                   torch.tensor([prompt] * 2, device=d), 0.0, gen, 7, 0,
                                   max_new=24, eot=CFG.eot)
            runs.append([t.cpu() for t in out])
        (ct, cl, clp, cns), (ht, hl, hlp, hns) = runs
        assert torch.equal(ct, ht) and torch.equal(cl, hl)
        assert float(((clp - hlp).abs() / hlp.abs()).max()) <= 1e-4
        assert float((cns - hns).abs().max()) <= 1e-4
