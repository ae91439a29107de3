"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 -m portbench --workload NAME --seed N --seconds S --trace 0|1

A run loads the cell (its configuration, traffic and metrics files), checks
for the cards the cell asks for, builds the program's objects and the
inputs from the seed and warms up (``setup_s``, from process start to the
first timed call), then calls the program in a closed loop for ``--seconds``
(one caller, the next call when the last returns) and takes the cell's rate
over all the work and all the time of the window. With ``--trace 1`` the
window runs under ``torch.profiler`` with the benchmark's spans, and the
cell's per-layer metrics are reported instead. After the window the
program's state is freed and its outputs are held against the plain
reference (``correct``); the numbers compared, each beside its limit, end
standard error and the result line. The last line of standard output is
the result, one JSON object.

It imports the PyTorch port and never the JAX package: a run that finds
``jax``, ``jaxlib``, ``flax`` or ``crispy_tpu`` among its modules once the
window has closed prints no result and fails.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from typing import Optional

from . import counts
from .cells import HERE, ROOT, Cell, load_cell, metric_reader

FORBIDDEN = {"jax", "jaxlib", "flax", "crispy_tpu"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of the JAX side's."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = HERE / ".cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: Optional[float] = None, control: bool = False) -> dict:
    """One run of ``cell``; returns the result object. ``t_start`` is the
    process's start on ``perf_counter`` (default: now)."""
    t_start = time.perf_counter() if t_start is None else t_start
    stages = {}
    import torch

    from .trace import DeviceTrace, Reading, Spans

    device = torch.device(device)
    stages["start and import torch"] = time.perf_counter() - t_start
    t = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
    stages["CUDA context"] = time.perf_counter() - t
    t = time.perf_counter()
    drv = cell.driver().Driver(cell, seed, device)
    stages["driver import"] = time.perf_counter() - t
    with torch.no_grad():
        drv.setup()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    stages.update(drv.stages)

    spans = Spans()
    dtrace = None
    if trace:
        drv.instrument(spans)
        if device.type == "cuda":
            dtrace = DeviceTrace(spans)
            dtrace.start()
    calls, work = 0, 0.0
    _sync(device)
    w0 = time.perf_counter_ns()
    deadline = w0 + int(seconds * 1e9)
    with torch.no_grad():
        while True:
            if trace:
                with spans.span(drv.call_name):
                    work += drv.call(calls)
            else:
                work += drv.call(calls)
            calls += 1
            if time.perf_counter_ns() >= deadline:
                break
    _sync(device)
    w1 = time.perf_counter_ns()
    ops = dtrace.stop() if dtrace is not None else []
    spans.restore()
    window_s = (w1 - w0) / 1e9

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    drv.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checked = drv.check(calls, control=control)
    stages["check (after the window)"] = time.perf_counter() - t
    correct = all(v["limit"] is not None and v["value"] <= v["limit"]
                  for k, v in checked.items() if "." not in k)

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": calls * drv.items_per_call, "failed": 0}
    if trace:
        reading = Reading(window=(w0, w1), calls=calls, units=drv.units(calls),
                          flops_done=drv.flops_done(calls), peaks=counts.PEAKS, ops=ops,
                          spans=spans.spans,
                          kernel_bounds=drv.kernel_bounds(), span_device_ms=drv.span_device_ms)
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = reading.busy_s() / cell.chips
        dev["window_s"] = window_s
        out["metrics"] = metrics
        out["device"] = dev
        if ops:
            out["breakdown"] = reading.breakdown()
    else:
        rates = {drv.rate_metric: work / window_s, "setup_s": setup_s}
        out["metrics"] = {m["name"]: {"value": rates[m["name"]], "unit": m["unit"]}
                          for m in cell.end_to_end}
        out["device"] = dev
    out["check"] = checked
    for k, v in stages.items():
        print(f"stage {k} {v:.3f} s", file=sys.stderr)
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cache_dirs()
    os.chdir(ROOT)
    cell = load_cell(a.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {a.workload} needs {cell.chips} CUDA device(s), found {n}", file=sys.stderr)
        return 2
    out = run(cell, a.seed, a.seconds, bool(a.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the JAX side was imported: {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
