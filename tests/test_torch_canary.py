"""The port's Canary (crispy_tpu_torch.models.canary) held against the JAX
package on the CPU at test-random widths (encoder d=64, 2+2 layers, V=64),
on the same numpy weights and inputs.

Tolerances: encoder features and teacher-forced logits within 1e-4 of the
JAX output's largest magnitude (f32 products summed in another order);
greedy tokens and lengths exactly, with the default [bos] prompt and with a
4-token task prompt prefilled one token at a time; ``init_random``
bit-equal, with and without ``enc_proj``. The test marked ``gpu`` holds the
card against the port's CPU path; here it skips.
"""

from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

from crispy_tpu_torch.models import canary as tcn
from crispy_tpu_torch.models import parakeet as tpk
from torch_audio import one_torch_thread  # noqa: F401 (autouse fixture)

try:  # the reference; the card's machine has no JAX and runs only the gpu tests
    import jax.numpy as jnp

    from crispy_tpu.models import canary as jcn
    from crispy_tpu.models import parakeet as jpk
except ImportError:
    jcn = None
needs_jax = pytest.mark.skipif(jcn is None, reason="the JAX reference is not installed")

CFG = tcn.CONFIGS["test-random"]
# the decoder narrower than the encoder: Canary's enc_proj
PROJ = replace(CFG, dec_hidden=32, dec_ffn=64)
TOL = 1e-4


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def jcfg(cfg):
    raw = asdict(cfg)
    return jcn.CanaryConfig(encoder=jpk.ParakeetConfig(**raw.pop("encoder")), **raw)


def mel(B=2, T=64, seed=0):
    return np.random.default_rng(seed).standard_normal((B, T, 80)).astype(np.float32)


@needs_jax
@pytest.mark.parametrize("cfg", [CFG, PROJ], ids=["test-random", "enc_proj"])
def test_init_random_bit_equal(cfg):
    want, got = jcn.init_random(jcfg(cfg), 2), tcn.init_random(cfg, 2)
    assert list(got) == list(want)
    assert ("enc_proj.w" in got) == (cfg is PROJ)
    assert all(got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) for k in want)


@needs_jax
@pytest.mark.parametrize("cfg", [CFG, PROJ], ids=["test-random", "enc_proj"])
def test_encode_and_logits_match_jax(cfg):
    p = tcn.init_random(cfg, 0)
    model = tcn.params_to_module(p, cfg, device="cpu")
    x = mel()
    jf = np.asarray(jcn.encode(p, jcfg(cfg), x))
    tf = tcn.encode(model, torch.from_numpy(x))
    assert tf.shape == jf.shape and rel(tf.numpy(), jf) <= TOL
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9))
    jl = np.asarray(jcn.decode_logits(p, jcfg(cfg), jnp.asarray(toks), jnp.asarray(jf)))
    tl = tcn.decode_logits(model, torch.from_numpy(toks), tf).numpy()
    assert rel(tl, jl) <= TOL


@pytest.fixture(scope="module")
def pair():
    p = tcn.init_random(CFG, 0)
    return p, tcn.params_to_module(p, CFG, device="cpu")


@needs_jax
@pytest.mark.parametrize("prompt", [None, [62, 1, 3, 1]], ids=["bos", "task_prompt"])
@pytest.mark.parametrize("seed", [0, 5])
def test_greedy_decode_matches_jax(pair, prompt, seed):
    p, model = pair
    x = mel(seed=seed)
    jp = None if prompt is None else jnp.asarray([prompt] * 2, jnp.int32)
    tp = None if prompt is None else torch.tensor([prompt] * 2)
    jt, jn = jcn.greedy_decode(p, jcfg(CFG), x, max_new=16, prompt=jp)
    tt, tn = tcn.greedy_decode(model, torch.from_numpy(x), max_new=16, prompt=tp)
    assert tt.shape == (2, 16)
    assert np.array_equal(tt.numpy(), np.asarray(jt)) and np.array_equal(tn.numpy(),
                                                                         np.asarray(jn))


@needs_jax
def test_eos_freeze_matches_jax():
    """A bias on eos ends every row at once; the lengths and the frozen eos
    tail equal the JAX package's."""
    p = tcn.init_random(CFG, 1)
    p["dec.emb"] = p["dec.emb"].copy()
    p["dec.emb"][CFG.eos] *= 40.0
    x = mel(seed=3)
    jt, jn = jcn.greedy_decode(p, jcfg(CFG), x, max_new=8)
    tt, tn = tcn.greedy_decode(tcn.params_to_module(p, CFG, device="cpu"),
                               torch.from_numpy(x), max_new=8)
    assert np.array_equal(tt.numpy(), np.asarray(jt)) and np.array_equal(tn.numpy(),
                                                                         np.asarray(jn))
    assert (np.asarray(jt) == CFG.eos).any()


def test_conformer_heads_are_left_out(pair):
    _, model = pair
    assert not hasattr(model.encoder, "ctc") and not hasattr(model.encoder, "joint")
    assert isinstance(model.encoder, tpk.Parakeet)


@pytest.mark.gpu
def test_card_matches_cpu(pair):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p, cpu = pair
    card = tcn.params_to_module(p, CFG, device="cuda")
    x = torch.from_numpy(mel())
    assert rel(tcn.encode(card, x.cuda()).cpu(), tcn.encode(cpu, x)) <= TOL
    prompt = torch.tensor([[62, 1, 3, 1]] * 2)
    ct, cl = tcn.greedy_decode(card, x.cuda(), max_new=16, prompt=prompt.cuda())
    ht, hl = tcn.greedy_decode(cpu, x, max_new=16, prompt=prompt)
    assert torch.equal(ct.cpu(), ht) and torch.equal(cl.cpu(), hl)
    # no .item(), .cpu() or blocking copy in the decode: CUDA's sync debug
    # mode raises on the first (the warm-up call above made the encoder's
    # position table)
    xc, pc = x.cuda(), prompt.cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tcn.greedy_decode(card, xc, max_new=8, prompt=pc)
    finally:
        torch.cuda.set_sync_debug_mode(0)
