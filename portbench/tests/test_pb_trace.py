"""The traced run's reduction, on a made-up trace: the union of device
time, kernels inside spans, idle time by span, and the per-layer readers."""

import pytest

from portbench.cells import load_benchmark, metric_reader
from portbench.trace import DeviceOp, Reading, Span

MS = 1_000_000


def _reading(**kw):
    ops = [DeviceOp("Memcpy HtoD (Pageable -> Device)", 0 * MS, 2 * MS, 0),
           DeviceOp("nn_scan_resident_kernel", 1 * MS, 2 * MS, MS // 2),  # overlaps the copy
           DeviceOp("rd_scan_kernel", 5 * MS, 1 * MS, 4 * MS),
           DeviceOp("elementwise_kernel", 20 * MS, 5 * MS, 39 * MS // 2),
           DeviceOp("elementwise_kernel", 90 * MS, 20 * MS, 80 * MS)]  # runs past the window's end
    spans = [Span("denoise_batch", 0, 50 * MS), Span("block step", 0, 9 * MS // 2),
             Span("decode loop", 19 * MS, 26 * MS)]
    base = dict(window=(0, 100 * MS), calls=1, units={"blocks": 2, "decode_steps": 4},
                flops_done=67e9, peaks={"f32_flops_per_s": 67e12, "bytes_per_s": 3.35e12},
                ops=ops, spans=spans, kernel_bounds={"nn_scan": 0.5e-3, "rd_scan": 0.1e-3})
    base.update(kw)
    return Reading(**base)


def test_busy_union_clips_to_the_window():
    r = _reading()
    assert r.busy_intervals() == [(0, 3 * MS), (5 * MS, 6 * MS), (20 * MS, 25 * MS), (90 * MS, 100 * MS)]
    assert r.busy_s() == pytest.approx(0.019)


def test_kernels_in_spans_and_idle_by_span():
    r = _reading()
    assert r.kernels_in("decode loop") == [1]
    idle = r.idle_by_span()
    # gaps 3..5 ms (its middle in the block step), 6..20 (in denoise_batch), 25..90
    assert idle == {"block step": pytest.approx(0.002), "denoise_batch": pytest.approx(0.014),
                    "harness": pytest.approx(0.065)}
    assert sum(idle.values()) == pytest.approx(0.1 - r.busy_s())
    b = r.breakdown()
    assert b["device_ops"][0] == ["elementwise_kernel", pytest.approx(0.025)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_launches_and_walls_in_spans_by_the_host_calls():
    """A span that opens while earlier work still runs on the card counts
    the kernels its host calls launched, and its wall from the moment that
    work is done."""
    r = _reading(spans=[Span("decode loop", 2 * MS, 8 * MS), Span("decode loop", 19 * MS, 26 * MS)])
    assert r.kernels_in("decode loop") == [1, 1]
    assert r.span_walls("decode loop") == [5 * MS, 7 * MS]
    bare = _reading(ops=[DeviceOp(op.name, op.start_ns, op.dur_ns) for op in r.ops], spans=r.spans)
    assert bare.kernels_in("decode loop") == [] and bare.span_walls("decode loop") == []
    assert metric_reader("launches_per_step.transcribe")(bare) is None
    assert metric_reader("decode_step_ms.transcribe")(bare) is None


def test_readers():
    r = _reading()
    read = {m["name"]: metric_reader(m["name"])(r) for m in load_benchmark()["per_layer"]}
    assert read["host_gap_ms.denoise"] == pytest.approx((100 - 19) / 2)
    assert read["block_step_ms.denoise"] == pytest.approx(19 / 2)
    assert read["device_idle_pct.denoise"] == pytest.approx(81.0)
    assert read["mfu.denoise"] == pytest.approx(1.0)
    assert read["nn_scan_roofline"] == pytest.approx(25.0)
    assert read["denoise_kernels_roofline"] == pytest.approx(100 * 0.6 / 3)
    assert read["decode_step_ms.transcribe"] == pytest.approx(7 / 4)
    assert read["launches_per_step.transcribe"] == pytest.approx(1 / 4)
    assert read["encoder_ms.transcribe"] is None


def test_readers_find_nothing_without_a_trace():
    r = _reading(ops=[])
    for m in load_benchmark()["per_layer"]:
        if m["source"] == "device_trace":
            assert metric_reader(m["name"])(r) is None, m["name"]
