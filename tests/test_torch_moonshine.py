"""The port's Moonshine (crispy_tpu_torch.models.moonshine) held against the
JAX package on the CPU at test-random widths (d=64, 2+2 layers, V=207), on
the same numpy weights and audio.

Tolerances: encoder features and teacher-forced logits within 1e-4 of the
JAX output's largest magnitude (f32 products summed in another order);
greedy tokens and lengths exactly; ``init_random`` (the RoPE tables
included) and ``from_hf_state_dict`` bit-equal; ``transcribe_chunks`` texts
equal. The test marked ``gpu`` holds the card against the port's CPU path;
here it skips.
"""

from dataclasses import asdict

import numpy as np
import pytest
import torch

from crispy_tpu_torch.models import moonshine as tms
from torch_audio import one_torch_thread, speechlike  # noqa: F401 (autouse fixture)

try:  # the reference; the card's machine has no JAX and runs only the gpu tests
    import jax.numpy as jnp

    from crispy_tpu.models import moonshine as jms
except ImportError:
    jms = None
needs_jax = pytest.mark.skipif(jms is None, reason="the JAX reference is not installed")

CFG = tms.CONFIGS["test-random"]
TOL = 1e-4


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def audio(B=2, n=16000, seed=0):
    return np.stack([speechlike(n, seed=seed + b, sr=16000, f0=120.0 + 40 * b)
                     for b in range(B)])


@pytest.fixture(scope="module")
def pair():
    p = tms.init_random(CFG, 0)
    return p, {k: jnp.asarray(v) for k, v in p.items()}, tms.params_to_module(p, CFG, "cpu")


@needs_jax
@pytest.mark.parametrize("size", ["test-random", "moonshine-tiny"])
def test_init_random_bit_equal(size):
    want = jms.init_random(jms.CONFIGS[size], 4)
    got = tms.init_random(tms.CONFIGS[size], 4)
    assert asdict(tms.CONFIGS[size]) == asdict(jms.CONFIGS[size])
    assert list(got) == list(want)
    assert all(got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) for k in want)


@needs_jax
def test_encode_and_logits_match_jax(pair):
    p, jp, model = pair
    a = audio()
    jf = np.asarray(jms.encode(jp, jms.CONFIGS["test-random"], jnp.asarray(a)))
    tf = tms.encode(model, torch.from_numpy(a))
    assert tf.shape == jf.shape and rel(tf.numpy(), jf) <= TOL
    toks = np.random.default_rng(1).integers(0, CFG.vocab_size, (2, 11))
    jl = np.asarray(jms.decode_logits(jp, jms.CONFIGS["test-random"], jnp.asarray(toks),
                                      jnp.asarray(jf)))
    assert rel(tms.decode_logits(model, torch.from_numpy(toks), tf).numpy(), jl) <= TOL


@needs_jax
@pytest.mark.parametrize("seed", [0, 7])
def test_greedy_decode_matches_jax(pair, seed):
    p, jp, model = pair
    a = audio(seed=seed)
    jt, jn = jms.greedy_decode(jp, jms.CONFIGS["test-random"], jnp.asarray(a), max_new=20)
    tt, tn = tms.greedy_decode(model, torch.from_numpy(a), max_new=20)
    assert tt.shape == (2, 20)
    assert np.array_equal(tt.numpy(), np.asarray(jt)) and np.array_equal(tn.numpy(),
                                                                         np.asarray(jn))


@needs_jax
def test_rope_tables_are_carried_not_recomputed():
    p = tms.init_random(CFG, 0)
    p["rope_cos"] = p["rope_cos"][:300] * 0.5  # a shorter, scaled table
    p["rope_sin"] = p["rope_sin"][:300] * 0.5
    model = tms.params_to_module(p, CFG, "cpu")
    assert torch.equal(model.rope_cos, torch.from_numpy(p["rope_cos"]))
    a = audio(B=1)
    jf = np.asarray(jms.encode({k: jnp.asarray(v) for k, v in p.items()},
                               jms.CONFIGS["test-random"], jnp.asarray(a)))
    assert rel(tms.encode(model, torch.from_numpy(a)).numpy(), jf) <= TOL
    with pytest.raises(ValueError, match="RoPE table"):
        tms.encode(model, torch.zeros(1, 16000 * 10))  # ~415 frames


def hf_state_dict(seed=0, d=64, layers=2, it=256, V=207):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"encoder.conv1.weight": r(d, 1, 127), "encoder.conv2.weight": r(2 * d, d, 7),
          "encoder.conv2.bias": r(2 * d), "encoder.conv3.weight": r(d, 2 * d, 3),
          "encoder.conv3.bias": r(d), "encoder.groupnorm.weight": r(d),
          "encoder.groupnorm.bias": r(d), "model.encoder.layer_norm.weight": r(d),
          "decoder.embed_tokens.weight": r(V, d), "decoder.norm.weight": r(d),
          "proj_out.weight": r(V, d)}
    for side in ("encoder", "decoder"):
        for i in range(layers):
            t = f"{side}.layers.{i}"
            for attn in ("self_attn",) + (("encoder_attn",) if side == "decoder" else ()):
                for proj in ("q", "k", "v", "o"):
                    sd[f"{t}.{attn}.{proj}_proj.weight"] = r(d, d)
            fc1 = it * (2 if side == "decoder" else 1)
            sd[f"{t}.mlp.fc1.weight"], sd[f"{t}.mlp.fc1.bias"] = r(fc1, d), r(fc1)
            sd[f"{t}.mlp.fc2.weight"], sd[f"{t}.mlp.fc2.bias"] = r(d, it), r(d)
            sd[f"{t}.input_layernorm.weight"] = r(d)
            sd[f"{t}.post_attention_layernorm.weight"] = r(d)
            if side == "decoder":
                sd[f"{t}.final_layernorm.weight"] = r(d)
    return sd


@needs_jax
def test_from_hf_state_dict_equal():
    sd = hf_state_dict()
    (want, wcfg), (got, gcfg) = jms.from_hf_state_dict(sd), tms.from_hf_state_dict(sd)
    assert asdict(gcfg) == asdict(wcfg)
    assert list(got) == list(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


@needs_jax
def test_transcribe_chunks_equal(pair):
    p, _, _ = pair
    jm = jms.MoonshineModel(p, jms.CONFIGS["test-random"])
    tm = tms.MoonshineModel(p, CFG, device="cpu")
    a = audio()
    assert tm.transcribe_chunks(a, max_new=12) == jm.transcribe_chunks(a, max_new=12)
    assert tm.transcribe_chunks(torch.from_numpy(a), max_new=12) == \
        jm.transcribe_chunks(a, max_new=12)


@pytest.mark.gpu
def test_card_matches_cpu(pair):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p, _, cpu = pair
    card = tms.params_to_module(p, CFG, "cuda")
    a = torch.from_numpy(audio())
    assert rel(tms.encode(card, a.cuda()).cpu(), tms.encode(cpu, a)) <= TOL
    ct, cl = tms.greedy_decode(card, a.cuda(), max_new=20)
    ht, hl = tms.greedy_decode(cpu, a, max_new=20)
    assert torch.equal(ct.cpu(), ht) and torch.equal(cl.cpu(), hl)
    # no .item(), .cpu() or blocking copy in the decode: CUDA's sync debug
    # mode raises on the first
    ac = a.cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tms.greedy_decode(card, ac, max_new=8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
