"""The readers of the program's spans: on a program without spans (its
``spans`` hidden) every one finds nothing; around a small ``denoise_batch``
run in a CPU profiler session they read what the spans give; and the idle
share the spans explain, on made-up spans and device operations."""

import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crispy_tpu_torch.utils import tracing
from portbench.cells import load_benchmark, load_cell, metric_reader
from portbench.drivers.denoise import Driver
from portbench.program_spans import program_spans
from portbench.trace import DeviceOp, Reading

SEED = 2**31 + 7
MS = 1_000_000
NEW = ["upload_ms.denoise", "readback_ms.denoise", "flush_ms.denoise", "decode_host_ms.transcribe",
       "idle_traced_pct.denoise", "idle_traced_pct.transcribe"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def denoise_reading():
    """Two calls of a small denoise cell (8 streams × 8 s, blocks of 100
    frames) in a CPU session, with two made-up device operations, so that
    the device readers have a trace to read."""
    cell = load_cell("denoise-batch-s128")
    cell.traffic = json.loads(json.dumps(cell.traffic))
    cell.traffic.update(streams=8, seconds_per_stream=8, block_frames=100, pool=1)
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
    ops = [DeviceOp("kernel", w0 + k * (w1 - w0) // 4, 1000, None) for k in (1, 3)]
    return Reading(window=(w0, w1), calls=calls, units=drv.units(calls),
                   flops_done=drv.flops_done(calls), peaks={"f32_flops_per_s": 1.0}, ops=ops)


def test_the_new_metrics_are_in_the_benchmark():
    per_layer = {m["name"]: m for m in load_benchmark()["per_layer"]}
    for name in NEW:
        cell = "denoise-batch-s128" if name.endswith(".denoise") else "transcribe-turbo-b16"
        assert per_layer[name]["workloads"] == [cell]
        assert name in [m["name"] for m in load_cell(cell).per_layer]


def test_a_program_without_spans_gives_nothing(monkeypatch, denoise_reading):
    assert program_spans(denoise_reading) is not None
    monkeypatch.delattr(tracing, "spans")
    assert program_spans(denoise_reading) is None
    for name in NEW:
        assert metric_reader(name)(denoise_reading) is None, name


def test_a_window_without_spans_gives_nothing(denoise_reading):
    w0, _ = denoise_reading.window
    before = Reading(window=(w0 - 10 * MS, w0 - MS), calls=0, units={}, flops_done=0.0,
                     peaks={}, ops=denoise_reading.ops)
    assert program_spans(before) is None
    for name in NEW:
        assert metric_reader(name)(before) is None, name


def test_readers_on_a_denoise_run(denoise_reading):
    r = denoise_reading
    spans = program_spans(r)
    w0, w1 = r.window
    own = [s for s in tracing.spans() if w0 <= s.start_ns and s.end_ns <= w1]
    assert spans == own
    steps = sum(s.name == "denoise.step" for s in own)
    assert steps == r.units["blocks"] == 2 * 8

    def ms(*names):
        return sum(s.end_ns - s.start_ns for s in own if s.name in names) / 1e6 / steps

    read = {name: metric_reader(name)(r) for name in NEW}
    assert read["upload_ms.denoise"] == pytest.approx(ms("denoise.slice", "denoise.upload"))
    assert read["readback_ms.denoise"] == pytest.approx(ms("denoise.readback"))
    assert read["flush_ms.denoise"] == pytest.approx(ms("denoise.flush"))
    assert read["upload_ms.denoise"] > 0 and read["flush_ms.denoise"] > 0
    assert read["decode_host_ms.transcribe"] is None  # no whisper.step to count by
    assert 0.0 <= read["idle_traced_pct.denoise"] <= 100.0


def _span(id_, name, a, b, parent=None):
    return tracing.Span(id_, name, a * MS, b * MS, parent, 1, 0, {})


def test_idle_traced_share_on_made_up_gaps(monkeypatch):
    """Window 0..100 ms; the root 10..90 with a phase 20..40 and two cached
    steps 60..64 and 64..70 in it. The card is busy 0..12, 18..30, 36..62,
    66..67, 85..88 and 92..100, so it idles 12..18 (its middle in the root
    only), 30..36 (in the phase), 62..66 (in the second step), 67..85 (the
    root only) and 88..92 (outside every span): 10 of 38 ms explained."""
    made = [_span(2, "denoise.flush", 20, 40, 1), _span(3, "whisper.step", 60, 64, 1),
            _span(4, "whisper.step", 64, 70, 1), _span(1, "denoise_batch", 10, 90)]
    monkeypatch.setattr(tracing, "spans", lambda: list(made))
    busy = [(0, 12), (18, 30), (36, 62), (66, 67), (85, 88), (92, 100)]
    ops = [DeviceOp("k", a * MS, (b - a) * MS, None) for a, b in busy]
    r = Reading(window=(0, 100 * MS), calls=1, units={}, flops_done=0.0, peaks={}, ops=ops)
    for name in ("idle_traced_pct.denoise", "idle_traced_pct.transcribe"):
        assert metric_reader(name)(r) == pytest.approx(100.0 * 10 / 38)
    assert metric_reader("decode_host_ms.transcribe")(r) == pytest.approx(5.0)
    assert metric_reader("flush_ms.denoise")(r) is None  # no denoise.step to count by
    no_trace = Reading(window=r.window, calls=1, units={}, flops_done=0.0, peaks={}, ops=[])
    assert metric_reader("idle_traced_pct.denoise")(no_trace) is None
