"""The port's Parakeet (crispy_tpu_torch.models.parakeet) held against the
JAX package on the CPU at test-random widths (d=64, 2 layers, V=128), on the
same numpy weights and inputs.

Tolerances: encoder output and CTC logits within 1e-4 of the JAX output's
largest magnitude (f32 products summed in another order); CTC and TDT
tokens and counts exactly; ``init_random`` and ``from_hf_ctc_state_dict``
bit-equal. The TDT cases include max_symbols=3, where rows fill up and the
JAX loop then writes blank into their last slot on every further iteration
while another row is active; the port's loop is run with a host check of
its end after every iteration, every 32 and never. The tests marked ``gpu``
hold the card against the port's CPU path; here they skip.
"""

from dataclasses import asdict

import numpy as np
import pytest
import torch

from crispy_tpu_torch.models import parakeet as tpk
from crispy_tpu_torch.models.carry import flat_layout, module_name
from torch_audio import one_torch_thread  # noqa: F401 (autouse fixture)

try:  # the reference; the card's machine has no JAX and runs only the gpu tests
    from crispy_tpu.models import parakeet as jpk
except ImportError:
    jpk = None
needs_jax = pytest.mark.skipif(jpk is None, reason="the JAX reference is not installed")

CFG = tpk.CONFIGS["test-random"]
# the GigaAM bundle's widths (tests/test_spm.py): 64 mels, 4x subsampling
GIGA = tpk.ParakeetConfig(n_mels=64, hidden_size=64, layers=2, heads=2, kv_heads=2,
                          intermediate_size=128, sub_channels=32, sub_factor=4,
                          vocab_size=34)
TOL = 1e-4


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def jcfg(cfg):
    return jpk.ParakeetConfig(**asdict(cfg))


def mel(B, T, n_mels, seed):
    return np.random.default_rng(seed).standard_normal((B, T, n_mels)).astype(np.float32)


@needs_jax
@pytest.mark.parametrize("cfg", [CFG, GIGA], ids=["test-random", "gigaam"])
def test_init_random_bit_equal(cfg):
    want, got = jpk.init_random(jcfg(cfg), 3), tpk.init_random(cfg, 3)
    assert list(got) == list(want)
    assert all(got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) for k in want)


@needs_jax
@pytest.mark.parametrize("cfg", [CFG, GIGA], ids=["test-random", "gigaam"])
def test_encode_and_ctc_logits_match_jax(cfg):
    p = tpk.init_random(cfg, 1)
    model = tpk.params_to_module(p, cfg, device="cpu")
    x = mel(2, 64, cfg.n_mels, 0)
    want = np.asarray(jpk.encode(p, jcfg(cfg), x))
    got = tpk.encode(model, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and rel(got, want) <= TOL
    jl = np.asarray(jpk.ctc_logits(p, jcfg(cfg), x))
    tl = tpk.ctc_logits(model, torch.from_numpy(x))
    assert rel(tl.numpy(), jl) <= TOL
    assert tpk.ctc_greedy(tl, cfg.blank_id) == jpk.ctc_greedy(jl, cfg.blank_id)


@needs_jax
def test_ctc_greedy_collapse_equal():
    V, blank = 5, 4
    ids = [0, 0, blank, 1, 1, 1, blank, blank, 0]
    logits = np.full((2, len(ids), V), -10.0, np.float32)
    for t, i in enumerate(ids):
        logits[0, t, i] = 10.0
        logits[1, t, (i + 1) % V] = 10.0
    want = jpk.ctc_greedy(logits, blank)
    assert tpk.ctc_greedy(logits, blank) == want == [[0, 1, 0], [1, 0, 2, 0, 1]]
    assert tpk.ctc_greedy(torch.from_numpy(logits), blank) == want
    assert tpk.ctc_greedy(logits[0], blank) == want[:1]


@pytest.fixture(scope="module")
def tdt_model():
    p = tpk.init_random(CFG, 0)
    return p, tpk.params_to_module(p, CFG, device="cpu")


@needs_jax
@pytest.mark.parametrize("sync_every", [1, 32, 10_000])
@pytest.mark.parametrize("max_symbols", [3, 32])
def test_tdt_greedy_decode_matches_jax(tdt_model, monkeypatch, max_symbols, sync_every):
    p, model = tdt_model
    monkeypatch.setattr(tpk, "TDT_SYNC_EVERY", sync_every)
    x = mel(3, 64, CFG.n_mels, 0)
    jt, jn = (np.asarray(a) for a in jpk.tdt_greedy_decode(p, jcfg(CFG), x,
                                                           max_symbols=max_symbols))
    tt, tn = tpk.tdt_greedy_decode(model, torch.from_numpy(x), max_symbols=max_symbols)
    assert tt.shape == (3, max_symbols)
    assert np.array_equal(tt.numpy(), jt) and np.array_equal(tn.numpy(), jn)
    if max_symbols == 3:  # the full-row case ran: a full row ends in blank
        full = jn == max_symbols
        assert np.any(jt[full, -1] == CFG.blank_id)


@needs_jax
def test_tdt_iterations_match_the_while_loop(tdt_model):
    """The gated iterations counted on the device are the JAX loop's: the
    count at which its condition first fails, replayed on the JAX side."""
    p, model = tdt_model
    x = mel(2, 64, CFG.n_mels, 4)
    enc = tpk.encode(model, torch.from_numpy(x))
    toks, n, iters = tpk.tdt_decode(model, enc, max_symbols=16)
    T = enc.shape[1]
    s = tpk.tdt_init(model, enc, 16)
    steps = 0
    while bool((s["t"] < T).any()) and steps < T + 16:
        tpk.tdt_step(model, s)
        steps += 1
    assert int(iters) == steps and torch.equal(s["toks"], toks) and torch.equal(s["n"], n)
    jt, jn = jpk.tdt_greedy_decode(p, jcfg(CFG), x, max_symbols=16)
    assert np.array_equal(toks.numpy(), np.asarray(jt)) and np.array_equal(n.numpy(),
                                                                           np.asarray(jn))


@needs_jax
def test_tdt_time_always_advances():
    """A degenerate joint preferring blank and duration 0 still ends."""
    p = tpk.init_random(CFG, 2)
    p["joint.out.b"] = p["joint.out.b"].copy()
    p["joint.out.b"][CFG.blank_id] = 50.0
    p["joint.out.b"][CFG.vocab_size] = 50.0
    x = mel(1, 32, CFG.n_mels, 1)
    tt, tn = tpk.tdt_greedy_decode(tpk.params_to_module(p, CFG, device="cpu"),
                                   torch.from_numpy(x), max_symbols=16)
    jt, jn = jpk.tdt_greedy_decode(p, jcfg(CFG), x, max_symbols=16)
    assert int(tn[0]) == int(np.asarray(jn)[0]) == 0
    assert np.array_equal(tt.numpy(), np.asarray(jt))


def hf_ctc_state_dict(seed=0, d=64, layers=2, H=2, ff=128, C=32, V=128, k=9, n_mels=80):
    """A random ParakeetForCTC-style state dict (transformers' names and
    layouts), some names under the ``model.`` prefix."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"encoder.subsampling.layers.0.weight": r(C, 1, 3, 3),
          "encoder.subsampling.layers.0.bias": r(C),
          "model.encoder.subsampling.linear.weight": r(d, C * (n_mels // 8)),
          "encoder.subsampling.linear.bias": r(d),
          "ctc_head.weight": r(V, d, 1), "ctc_head.bias": r(V)}
    for base in (2, 5):
        sd[f"encoder.subsampling.layers.{base}.weight"] = r(C, 1, 3, 3)
        sd[f"encoder.subsampling.layers.{base}.bias"] = r(C)
        sd[f"encoder.subsampling.layers.{base + 1}.weight"] = r(C, C, 1, 1)
        sd[f"encoder.subsampling.layers.{base + 1}.bias"] = r(C)
    for i in range(layers):
        t = f"encoder.layers.{i}"
        for proj in ("q", "k", "v", "o"):
            sd[f"{t}.self_attn.{proj}_proj.weight"] = r(d, d)
            sd[f"{t}.self_attn.{proj}_proj.bias"] = r(d)
        sd[f"{t}.self_attn.relative_k_proj.weight"] = r(d, d)
        sd[f"{t}.self_attn.bias_u"] = r(H, d // H)
        sd[f"{t}.self_attn.bias_v"] = r(H, d // H)
        for f in ("feed_forward1", "feed_forward2"):
            sd[f"{t}.{f}.linear1.weight"], sd[f"{t}.{f}.linear1.bias"] = r(ff, d), r(ff)
            sd[f"{t}.{f}.linear2.weight"], sd[f"{t}.{f}.linear2.bias"] = r(d, ff), r(d)
        sd[f"{t}.conv.pointwise_conv1.weight"] = r(2 * d, d, 1)
        sd[f"{t}.conv.pointwise_conv1.bias"] = r(2 * d)
        sd[f"{t}.conv.depthwise_conv.weight"] = r(d, 1, k)
        sd[f"{t}.conv.depthwise_conv.bias"] = r(d)
        sd[f"{t}.conv.norm.weight"], sd[f"{t}.conv.norm.bias"] = r(d), r(d)
        sd[f"{t}.conv.norm.running_mean"] = r(d)
        sd[f"{t}.conv.norm.running_var"] = np.abs(r(d)) + 0.5
        sd[f"{t}.conv.pointwise_conv2.weight"] = r(d, d, 1)
        sd[f"{t}.conv.pointwise_conv2.bias"] = r(d)
        for ln in ("norm_feed_forward1", "norm_self_att", "norm_conv", "norm_feed_forward2",
                   "norm_out"):
            sd[f"{t}.{ln}.weight"], sd[f"{t}.{ln}.bias"] = r(d), r(d)
    return sd


@needs_jax
def test_from_hf_ctc_state_dict_equal():
    sd = hf_ctc_state_dict()
    (want, wcfg), (got, gcfg) = jpk.from_hf_ctc_state_dict(sd), tpk.from_hf_ctc_state_dict(sd)
    assert asdict(gcfg) == asdict(wcfg)
    assert gcfg.hidden_size == 64 and gcfg.layers == 2 and gcfg.vocab_size == 128
    assert list(got) == list(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    model = tpk.params_to_module(got, gcfg, device="cpu")
    assert not hasattr(model, "joint")  # a CTC checkpoint carries no TDT heads
    x = mel(1, 48, 80, 2) * 0.1
    assert rel(tpk.ctc_logits(model, torch.from_numpy(x)).numpy(),
               np.asarray(jpk.ctc_logits(want, wcfg, x))) <= TOL


def test_params_to_module_is_strict():
    p = tpk.init_random(CFG, 0)
    del p["enc.1.conv.bn.var"]
    with pytest.raises(RuntimeError, match="bn.var"):
        tpk.params_to_module(p, CFG, device="cpu")


def test_carry_layout_round_trips():
    """Every module tensor, put back by ``carry.flat_layout``, is the flat
    param it came from: the [in, out], HIO and HWIO kernels included."""
    p = tpk.init_random(CFG, 0)
    state = tpk.params_to_module(p, CFG, device="cpu").state_dict()
    assert {a.ndim for k, a in p.items() if k.endswith(".w")} == {2, 3, 4}
    for k, a in p.items():
        np.testing.assert_array_equal(flat_layout(k, state[module_name(k)].numpy()), a,
                                      err_msg=k)


@pytest.mark.gpu
def test_card_matches_cpu(tdt_model):
    """Encoder within 1e-4 of the CPU path's largest magnitude, TDT tokens
    and counts equal, at test-random widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p, cpu = tdt_model
    card = tpk.params_to_module(p, CFG, device="cuda")
    x = torch.from_numpy(mel(3, 64, CFG.n_mels, 0))
    assert rel(tpk.encode(card, x.cuda()).cpu(), tpk.encode(cpu, x)) <= TOL
    for ms in (3, 32):
        ct, cn = tpk.tdt_greedy_decode(card, x.cuda(), max_symbols=ms)
        ht, hn = tpk.tdt_greedy_decode(cpu, x, max_symbols=ms)
        assert torch.equal(ct.cpu(), ht) and torch.equal(cn.cpu(), hn)
    # an iteration of the loop issues no host sync (CUDA's sync debug mode
    # raises on the first): the end is read only at the checks
    s = tpk.tdt_init(card, tpk.encode(card, x.cuda()), 32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(tpk.TDT_SYNC_EVERY):
            tpk.tdt_step(card, s)
    finally:
        torch.cuda.set_sync_debug_mode(0)
