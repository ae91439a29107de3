"""The canary cell on the CPU at sizes a test can hold: the driver sets up,
calls and checks through a whole run (``run.run`` without the look for a
card); the control (the reference in TensorFloat-32) and faults planted
beneath the timed path fail the check; the readers of the program's spans
read a made-up trace and give None without spans; the operation counts
hold against a hand count and an independent counter; the cell loads."""

import dataclasses
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

import crispy_tpu_torch.models.canary as cn
from crispy_tpu_torch.models.parakeet import ParakeetConfig
from crispy_tpu_torch.utils import tracing
from portbench import counts_canary
from portbench.cells import load_cell, metric_reader
from portbench.reference import canary as reference
from portbench.run import run
from portbench.trace import DeviceOp, Reading

SEED = 2**31 + 211
CELL = "canary-encdec-b16"
NEW = ["encoder_device_ms.canary", "decode_step_device_ms.canary", "decode_host_ms.canary",
       "launches_per_step.canary"]
GENERIC = ["device_idle_pct.canary", "mfu.canary", "idle_traced_pct.canary"]
SPAN_READERS = NEW + ["idle_traced_pct.canary"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cell(monkeypatch, d=64, layers=2, vocab=96, seconds=2):
    """The cell at width d, ``layers`` blocks each side and ``seconds``-long
    chunks, 4 a batch, with a ``CONFIGS`` entry of the same widths."""
    cell = load_cell(CELL)
    c = json.loads(json.dumps(cell.config))
    c["config"] = "bench-test"
    c["encoder"].update(d_model=d, n_layers=layers, n_heads=d // 32, ff_dim=2 * d,
                        subsampling_conv_channels=32)
    c["decoder"].update(hidden_size=d, n_layers=layers, n_heads=d // 32, inner_size=2 * d,
                        max_sequence_length=160)
    c["vocab_size"] = vocab
    cell.config = c
    cell.traffic = json.loads(json.dumps(cell.traffic))
    cell.traffic.update(batch=4, pool=1, chunk_seconds=seconds)
    cell.traffic["check"]["samples"] = 4
    s = reference.shape_of(c)
    cfg = cn.CanaryConfig(
        encoder=ParakeetConfig(n_mels=s.n_mels, hidden_size=d, layers=layers, heads=s.enc_heads,
                               kv_heads=s.enc_heads, intermediate_size=s.enc_ffn,
                               conv_kernel=s.conv_kernel, sub_channels=s.sub_channels,
                               sub_factor=s.sub_factor, vocab_size=vocab),
        vocab_size=vocab, dec_layers=layers, dec_heads=s.dec_heads, dec_hidden=d,
        dec_ffn=s.dec_ffn, max_len=s.max_len, bos=c["bos_token_id"], eos=c["eos_token_id"])
    monkeypatch.setitem(cn.CONFIGS, "bench-test", cfg)
    return cell


def _run(cell, control=False):
    out = run(cell, SEED, 0.001, False, "cpu", control=control)
    assert out["attempted"] == cell.traffic["batch"]
    return out


def test_sound_run_is_correct(monkeypatch):
    out = _run(_cell(monkeypatch))
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == {"transcribe_x_realtime", "setup_s"}
    assert out["check"]["wrong_picks"]["value"] == 0


def test_the_widths_must_match_the_program(monkeypatch):
    cell = _cell(monkeypatch)
    cell.config["decoder"]["n_layers"] = 3
    with pytest.raises(ValueError, match="differs"):
        _run(cell)


def test_control_is_not_correct(monkeypatch):
    """At the model's own width, two blocks each side, its whole vocabulary."""
    out = _run(_cell(monkeypatch, d=1024, vocab=16384), control=True)
    c = out["check"]
    assert out["correct"], c
    assert (c["control.logprob_gap"]["value"] > c["control.logprob_gap"]["limit"]
            or c["control.wrong_picks"]["value"] > c["control.wrong_picks"]["limit"]), c


def _cache_unchanged(monkeypatch):
    step = cn._decode_step

    def _decode_step(m, tok, pos, self_k, self_v, *rest):
        return step(m, tok, pos, self_k.clone(), self_v.clone(), *rest)

    monkeypatch.setattr(cn, "_decode_step", _decode_step)


def _half_chunks(monkeypatch):
    enc = cn.encode

    def encode(m, mel):
        out = enc(m, mel)
        h = out.shape[0] // 2
        return torch.cat([out[:h], out[:h]])

    monkeypatch.setattr(cn, "encode", encode)


def _token_altered(monkeypatch):
    step = cn._decode_step

    def _decode_step(m, tok, pos, *rest):
        logits = step(m, tok, pos, *rest)
        if pos == 12:
            logits = logits.clone()
            logits[:, 20] += 1e3
        return logits

    monkeypatch.setattr(cn, "_decode_step", _decode_step)


@pytest.mark.parametrize("fault", [_cache_unchanged, _half_chunks, _token_altered],
                         ids=["cache-unchanged", "half-batch", "token-altered"])
def test_fault_is_not_correct(monkeypatch, fault):
    cell = _cell(monkeypatch)
    fault(monkeypatch)
    out = _run(cell)
    assert not out["correct"], out["check"]


def test_the_wrappers_are_undone(monkeypatch):
    keep = (cn.greedy_decode, cn.DecodeStep.__call__)
    _run(_cell(monkeypatch))
    assert (cn.greedy_decode, cn.DecodeStep.__call__) == keep


@pytest.fixture
def canary_reading(monkeypatch):
    """Two calls of the small cell in a CPU profiler session, with one
    made-up kernel of 1 µs launched in the middle of each ``canary.encode``
    and ``canary.step`` span."""
    from portbench.drivers.canary import Driver

    cell = _cell(monkeypatch)
    drv = Driver(cell, SEED, "cpu")
    with torch.no_grad():
        drv.setup()
    calls = 2
    with profile(activities=[ProfilerActivity.CPU]):
        w0 = time.perf_counter_ns()
        with torch.no_grad():
            for i in range(calls):
                drv.call(i)
        w1 = time.perf_counter_ns()
    drv.release()
    spans = [s for s in tracing.spans() if w0 <= s.start_ns and s.end_ns <= w1]
    ops = [DeviceOp("kernel", (s.start_ns + s.end_ns) // 2, 1000, (s.start_ns + s.end_ns) // 2)
           for s in spans if s.name in ("canary.encode", "canary.step")]
    return Reading(window=(w0, w1), calls=calls, units=drv.units(calls),
                   flops_done=drv.flops_done(calls), peaks={"f32_flops_per_s": 1.0}, ops=ops), spans


def test_the_spans_of_a_call(canary_reading):
    _, spans = canary_reading
    names = [s.name for s in spans]
    assert names.count("canary.transcribe") == 2
    assert names.count("canary.encode") == 2
    assert names.count("canary.step") == 2 * 127


def test_readers_on_a_trace_with_spans(canary_reading):
    r, spans = canary_reading
    read = {name: metric_reader(name)(r) for name in NEW + GENERIC}
    steps = [s for s in spans if s.name == "canary.step"]
    assert read["launches_per_step.canary"] == 1
    assert read["decode_step_device_ms.canary"] == pytest.approx(1e-3)
    assert read["encoder_device_ms.canary"] == pytest.approx(1e-3)
    assert read["decode_host_ms.canary"] == pytest.approx(
        sum(s.end_ns - s.start_ns for s in steps) / 1e6 / len(steps))
    assert 0.0 <= read["idle_traced_pct.canary"] <= 100.0
    assert 0.0 <= read["device_idle_pct.canary"] <= 100.0
    assert read["mfu.canary"] > 0


def _with_kernels(r, span, n):
    """The reading with ``n`` more made-up kernels launched inside ``span``."""
    extra = [DeviceOp("kernel", span.start_ns + 1 + i, 1000, span.start_ns + 1 + i)
             for i in range(n)]
    return dataclasses.replace(r, ops=sorted(r.ops + extra, key=lambda op: op.start_ns))


@pytest.mark.parametrize("name,extra", [("canary.encode", 1), ("canary.step", 2)],
                         ids=["an-encode-one-more", "a-step-two-more"])
def test_kernel_readers_refuse_spans_that_scatter(canary_reading, name, extra):
    """A trace that sets kernels under the wrong spans gives nothing: one
    encode span of two with one kernel more (half the spans off the most
    common count), one step with two more (beyond a launch at a span's
    edge)."""
    r, spans = canary_reading
    moved = _with_kernels(r, next(s for s in spans if s.name == name), extra)
    names = ["encoder_device_ms.canary"] if name == "canary.encode" else [
        "decode_step_device_ms.canary", "launches_per_step.canary"]
    for metric in names:
        assert metric_reader(metric)(moved) is None, metric


def test_a_kernel_across_a_step_edge_is_read(canary_reading):
    """One step of the 254 with one kernel more (a launch at a span's edge,
    which the markers' clock places a few microseconds off) is read: the
    count most steps launched, and the device time of all over the steps."""
    r, spans = canary_reading
    moved = _with_kernels(r, next(s for s in spans if s.name == "canary.step"), 1)
    assert metric_reader("launches_per_step.canary")(moved) == 1
    assert metric_reader("decode_step_device_ms.canary")(moved) == pytest.approx(1e-3 * 255 / 254)


def test_readers_without_spans_give_nothing(monkeypatch, canary_reading):
    r, _ = canary_reading
    monkeypatch.delattr(tracing, "spans")
    for name in SPAN_READERS:
        assert metric_reader(name)(r) is None, name
    w0, _ = r.window
    before = Reading(window=(w0 - 10**7, w0 - 10**6), calls=0, units={}, flops_done=0.0,
                     peaks={}, ops=r.ops)
    for name in SPAN_READERS:
        assert metric_reader(name)(before) is None, name


SMALL = reference.Shape(n_mels=16, d_model=8, enc_layers=2, enc_heads=2, enc_ffn=16, conv_kernel=3,
                        sub_channels=4, sub_factor=8, dec_layers=1, dec_heads=2, dec_ffn=16,
                        n_vocab=10, max_len=16)


def test_encoder_counts_by_hand():
    """3,200 samples: 21 frames → 11 → 6 → 3 positions, 16 mel bins → 8 →
    4 → 2. Subsampler: 2·9·4·11·8 + (2·9·4·6·4 + 2·4·4·6·4) + (2·9·4·3·2 +
    2·4·4·3·2) + 2·3·8·8 = 6336 + 2496 + 624 + 384 = 9840. A block's chunk at
    T = 3, d = 8, f = 16, k = 3: 8·3·8·16 + 14·3·64 + 4·9·8 + 2·3·5·8 +
    2·3·8·3 = 3072 + 2688 + 288 + 240 + 144 = 6432; the block's projection
    of the 5 relative positions, once a batch: 2·5·64 = 640."""
    assert counts_canary.subsampled(SMALL, 3200) == 3
    assert counts_canary.subsampler_flops(SMALL, 3200) == 9840
    assert counts_canary.encoder_layer_flops(SMALL, 3) == 6432
    assert counts_canary.position_flops(SMALL, 3) == 640
    assert counts_canary.encoder_flops(SMALL, 3200) == 9840 + 2 * 6432 + 2 * 640
    assert counts_canary.encoder_flops(SMALL, 3200, batch=3) == 3 * (9840 + 2 * 6432) + 2 * 640


def test_encoder_counts_match_an_operation_counter():
    """torch's FlopCounterMode over the reference's encoder (products and
    convolutions) at a wider shape, a batch of three chunks of a second."""
    s = reference.Shape(n_mels=128, d_model=64, enc_layers=2, enc_heads=2, enc_ffn=128,
                        conv_kernel=9, sub_channels=32, sub_factor=8, dec_layers=1, dec_heads=2,
                        dec_ffn=128, n_vocab=96, max_len=64)
    ref = reference.Reference(s, reference.draw_weights(s, 5, "cpu"))
    feats = ref.log_mel(torch.randn(3, 16000))
    with FlopCounterMode(display=False) as fc:
        ref.encode(feats)
    assert fc.get_total_flops() == counts_canary.encoder_flops(s, 16000, batch=3)


def test_decode_counts_by_hand():
    """S = 3, d = 8, f = 16, V = 10, one layer: a token over k keys costs
    12·64 + 4·k·8 + 4·3·8 + 4·8·16 = 1376 + 32 k; the head 160. Prompt of 2
    (k = 1, 2) and 2 steps (k = 3, 4)."""
    dec = counts_canary.decode_flops(SMALL, 3, 2, 2)
    assert dec["cross_kv"] == 4 * 3 * 64
    assert dec["prefill"] == (1376 + 32) + (1376 + 64) + 160
    assert dec["steps"] == (1376 + 96 + 160) + (1376 + 128 + 160)
    assert counts_canary.call_flops(SMALL, 4, 3200, 2, 2) == (
        counts_canary.encoder_flops(SMALL, 3200, batch=4) + 4 * sum(dec.values()))


def test_the_configuration_at_its_published_widths():
    c = load_cell(CELL).config
    s = reference.shape_of(c)
    assert reference.n_params(s) == c["parameters_drawn"]
    assert c["reduced"] == [] and len(c["prompt"]) == 9
    assert [c["special_tokens"][p] for p in c["prompt_pieces"]] == c["prompt"]


def test_the_cell_loads():
    cell = load_cell(CELL)
    assert cell.chips == 1 and cell.traffic["driver"] == "canary"
    assert [m["name"] for m in cell.end_to_end] == ["transcribe_x_realtime", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == NEW + GENERIC
    for m in cell.per_layer:
        assert m["workloads"] == [CELL] and callable(metric_reader(m["name"]))
