"""The check that decides ``correct``, driven through a whole run on the CPU
(``run.run`` without the look for a card) at sizes a test can hold: a sound
run passes; the control (the reference in TensorFloat-32 in the program's
place) and each fault the cells can have, planted in the program beneath
the timed path, fail."""

import json

import numpy as np
import pytest
import torch

from portbench.cells import load_cell
from portbench.run import run

SEED = 2**31 + 101


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _denoise_cell():
    cell = load_cell("denoise-batch-s128")
    cell.traffic = json.loads(json.dumps(cell.traffic))
    cell.traffic.update(streams=8, seconds_per_stream=8, block_frames=100, pool=1)
    cell.traffic["check"]["kept_per_call"] = 8  # one call keeps a stream of every slice
    return cell


def _whisper_cell(d=64, layers=2):
    cell = load_cell("transcribe-turbo-b16")
    cell.config = dict(cell.config, d_model=d, encoder_layers=layers, decoder_layers=layers,
                       encoder_attention_heads=d // 64, decoder_attention_heads=d // 64)
    cell.traffic = json.loads(json.dumps(cell.traffic))
    cell.traffic.update(batch=4, pool=1, max_new=16)
    cell.traffic["check"]["samples"] = 4
    return cell


def _check(cell, control=False):
    out = run(cell, SEED, 0.001, False, "cpu", control=control)
    assert out["attempted"] == cell.traffic.get("streams", cell.traffic.get("batch"))
    return out


def test_denoise_sound_run_is_correct():
    out = _check(_denoise_cell())
    assert out["correct"], out["check"]


def test_denoise_control_is_not_correct():
    out = _check(_denoise_cell(), control=True)
    c = out["check"]["control.frames_off_pct"]
    assert c["value"] > c["limit"]


def _state_unchanged(monkeypatch):
    from crispy_tpu_torch.dsp.rnnoise import pipeline

    step = pipeline.denoise_block

    def denoise_block(params, state, block):
        _, out, vad = step(params, state, block)
        return state, out, vad

    monkeypatch.setattr(pipeline, "denoise_block", denoise_block)


def _half_batch(monkeypatch):
    from crispy_tpu_torch.dsp.rnnoise import pipeline

    step = pipeline._denoise_block_i16

    def half(params, state, block):
        state, out, vad = step(params, state, block)
        h = out.shape[0] // 2
        return state, torch.cat([out[:h], out[:h]]), vad

    monkeypatch.setattr(pipeline, "_denoise_block_i16", half)


def _answer_altered(monkeypatch):
    from crispy_tpu_torch.dsp.rnnoise import pipeline

    step = pipeline._denoise_block_i16
    calls = []

    def altered(params, state, block):
        state, out, vad = step(params, state, block)
        calls.append(1)
        return state, (block.clone() if len(calls) % 4 == 1 else out), vad

    monkeypatch.setattr(pipeline, "_denoise_block_i16", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered],
                         ids=["state-unchanged", "half-batch", "answer-altered"])
def test_denoise_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = _check(_denoise_cell())
    assert not out["correct"], out["check"]


def test_whisper_sound_run_is_correct():
    out = _check(_whisper_cell())
    assert out["correct"], out["check"]


def test_whisper_control_is_not_correct():
    """At the model's own width, two layers each side."""
    out = _check(_whisper_cell(d=1280, layers=2), control=True)
    c = out["check"]["control.logprob_gap"]
    assert c["value"] > c["limit"]


def _cache_unchanged(monkeypatch):
    from crispy_tpu_torch.models.whisper import model

    step = model._decode_step

    def _decode_step(m, tok, pos, self_k, self_v, cross_k, cross_v, max_len):
        logits, _, _ = step(m, tok, pos, self_k.clone(), self_v.clone(), cross_k, cross_v, max_len)
        return logits, self_k, self_v

    monkeypatch.setattr(model, "_decode_step", _decode_step)


def _half_chunks(monkeypatch):
    import crispy_tpu_torch.models.whisper as W

    enc = W.encode

    def encode(m, mel):
        out = enc(m, mel)
        h = out.shape[0] // 2
        return torch.cat([out[:h], out[:h]])

    monkeypatch.setattr(W, "encode", encode)


def _token_altered(monkeypatch):
    from crispy_tpu_torch.models.whisper import model

    step = model._decode_step

    def _decode_step(m, tok, pos, *caches):
        logits, sk, sv = step(m, tok, pos, *caches)
        if pos == 7:
            logits = logits.clone()
            logits[:, 11] += 1e3
        return logits, sk, sv

    monkeypatch.setattr(model, "_decode_step", _decode_step)


def _second_best_picked(monkeypatch):
    """The pick after one decode step takes one row's second-best token (the
    row whose first choice leads most) from logits left as they are, so that
    its log-probability is the one the reference gives (a pick read from a
    stale buffer)."""
    from crispy_tpu_torch.models.whisper import model

    step, argmax = model._decode_step, torch.Tensor.argmax
    armed = []

    def _decode_step(m, tok, pos, *caches):
        out = step(m, tok, pos, *caches)
        if pos == 7:
            armed.append(out[0])
        return out

    def pick(self, *a, **k):
        idx = argmax(self, *a, **k)
        if armed and self is armed[-1]:
            armed.clear()
            top = self.topk(2, dim=-1)
            row = (top.values[:, 0] - top.values[:, 1]).argmax()
            idx = idx.clone()
            idx[row] = top.indices[row, 1]
        return idx

    monkeypatch.setattr(model, "_decode_step", _decode_step)
    monkeypatch.setattr(torch.Tensor, "argmax", pick)


@pytest.mark.parametrize("fault", [_cache_unchanged, _half_chunks, _token_altered, _second_best_picked],
                         ids=["state-unchanged", "half-batch", "token-altered", "second-best-picked"])
def test_whisper_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = _check(_whisper_cell())
    assert not out["correct"], out["check"]
    if fault is _second_best_picked:
        c = out["check"]
        assert c["logprob_gap"]["value"] <= c["logprob_gap"]["limit"], c
        assert c["wrong_picks"]["value"] > c["wrong_picks"]["limit"], c


def test_denoise_sample_spans_the_batch():
    """One kept stream from each slice of the batch: a fault on half the
    streams cannot go unseen."""
    from portbench.drivers.denoise import Driver

    cell = load_cell("denoise-batch-s128")
    drv = Driver(cell, SEED, "cpu")
    drv.kept = [(i, drv._row(i, j), np.zeros(1)) for i in range(20) for j in range(2)]
    rows = [r for _, r, _ in drv._sample()]
    assert sorted(r // 16 for r in rows) == list(range(8))
