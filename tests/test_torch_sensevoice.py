"""The port's SenseVoice (crispy_tpu_torch.models.sensevoice) held against the
JAX package on the CPU at test-random widths (16 fbank bins, d=32, 2
layers, V=64), on the same numpy weights and features.

Tolerances: CTC logits within 1e-4 of the JAX output's largest magnitude
(f32 products summed in another order); CTC tokens exactly (prompt
positions dropped); ``init_random`` and ``sinusoidal_pe`` bit-equal. The
test marked ``gpu`` holds the card against the port's CPU path; here it
skips.
"""

from dataclasses import asdict

import numpy as np
import pytest
import torch

from crispy_tpu_torch.models import sensevoice as tsv
from torch_audio import one_torch_thread  # noqa: F401 (autouse fixture)

try:  # the reference; the card's machine has no JAX and runs only the gpu tests
    import jax.numpy as jnp

    from crispy_tpu.models import sensevoice as jsv
except ImportError:
    jsv = None
needs_jax = pytest.mark.skipif(jsv is None, reason="the JAX reference is not installed")

CFG = tsv.CONFIGS["test-random"]
TOL = 1e-4


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def feats(B=2, T=97, seed=0):
    return np.random.default_rng(seed).standard_normal((B, T, CFG.feat_dim)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    p = tsv.init_random(CFG, 0)
    p["cmvn.mean"] = np.linspace(-0.5, 0.5, CFG.input_dim).astype(np.float32)
    p["cmvn.istd"] = np.linspace(0.8, 1.2, CFG.input_dim).astype(np.float32)
    return p, {k: jnp.asarray(v) for k, v in p.items()}, tsv.params_to_module(p, CFG, "cpu")


@needs_jax
@pytest.mark.parametrize("size", ["test-random", "sense-voice-small"])
def test_config_and_pe_equal(size):
    assert asdict(tsv.CONFIGS[size]) == asdict(jsv.CONFIGS[size])
    for T, depth in ((37, 112), (504, 560), (5, 7)):
        assert np.array_equal(tsv.sinusoidal_pe(T, depth), jsv.sinusoidal_pe(T, depth))


@needs_jax
def test_init_random_bit_equal():
    want, got = jsv.init_random(jsv.CONFIGS["test-random"], 6), tsv.init_random(CFG, 6)
    assert list(got) == list(want)
    assert all(got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) for k in want)


@needs_jax
@pytest.mark.parametrize("prompt", [[1, 2, 3, 4], [5, 6, 7, 8]])
@pytest.mark.parametrize("T", [97, 6])
def test_ctc_logits_and_greedy_match_jax(pair, prompt, T):
    p, jp, model = pair
    f = feats(T=T)
    jl = np.asarray(jsv.ctc_logits(jp, jsv.CONFIGS["test-random"], jnp.asarray(f),
                                   jnp.asarray(prompt, jnp.int32)))
    tl = tsv.ctc_logits(model, torch.from_numpy(f), torch.tensor(prompt))
    assert tl.shape == jl.shape == (2, CFG.n_prompt + -(-T // CFG.lfr_n), CFG.vocab_size)
    assert rel(tl.numpy(), jl) <= TOL
    assert tsv.ctc_greedy(tl, CFG) == jsv.ctc_greedy(jl, jsv.CONFIGS["test-random"])


@pytest.mark.gpu
def test_card_matches_cpu(pair):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p, _, cpu = pair
    card = tsv.params_to_module(p, CFG, "cuda")
    f, prompt = torch.from_numpy(feats()), torch.tensor([1, 2, 3, 4])
    cl = tsv.ctc_logits(card, f.cuda(), prompt.cuda())
    hl = tsv.ctc_logits(cpu, f, prompt)
    assert rel(cl.cpu(), hl) <= TOL
    assert tsv.ctc_greedy(cl, CFG) == tsv.ctc_greedy(hl, CFG)
