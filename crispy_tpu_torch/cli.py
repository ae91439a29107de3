"""Command line of the PyTorch/CUDA port.

  python -m crispy_tpu_torch.cli denoise IN.wav OUT.wav   RNNoise on the card
  python -m crispy_tpu_torch.cli bench [--streams N]      denoise throughput

``CRISPY_FUSED_SPECTRA=on`` runs either through the fused-spectra kernels
(K4-K6) in place of the FFTs.

Both run on the CUDA card by default and fail without one; ``--device cpu``
runs the plain PyTorch path instead.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def _cmd_denoise(args) -> int:
    from .dsp.rnnoise.weights import RNNoiseModel
    from .engine.denoiser import denoise_file

    model = RNNoiseModel.load(args.weights) if args.weights else None
    t0 = time.perf_counter()
    info = denoise_file(args.input, args.output, model=model, device=args.device)
    dt = time.perf_counter() - t0
    audio_s = info["samples"] / info["sample_rate"]
    print(json.dumps({
        "output": str(args.output), "ns_model": "rnnoise", **info,
        "seconds_audio": audio_s, "seconds_wall": dt,
        "realtime_factor": audio_s * info["channels"] / max(dt, 1e-9),
    }))
    return 0


BENCH_FRAMES = 500  # denoise_batch's default block
BENCH_STEPS = 5


def _cmd_bench(args) -> int:
    """Denoise block-step throughput on the device (one JSON line): S
    streams of random audio, BENCH_FRAMES frames per block, BENCH_STEPS
    block steps timed after a warm-up step. ``spectra`` says which spectra
    path ran: "fused" (K4-K6, ``CRISPY_FUSED_SPECTRA=on``) or "fft"."""
    import numpy as np
    import torch

    from .device import resolve_device
    from .dsp.rnnoise import pipeline
    from .dsp.rnnoise.weights import builtin_model

    dev = resolve_device(args.device)
    S, F = args.streams, BENCH_FRAMES
    params = pipeline.make_params(builtin_model(), dev)
    rng = np.random.default_rng(0)
    block = torch.from_numpy(rng.standard_normal((S, F * 480), dtype=np.float32) * 0.3).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.no_grad():
        state = pipeline.init_state(S, dev)
        state, out, _ = pipeline.denoise_block(params, state, block)
        sync()
        t0 = time.perf_counter()
        for _ in range(BENCH_STEPS):
            state, out, _ = pipeline.denoise_block(params, state, block)
        sync()
    dt = (time.perf_counter() - t0) / BENCH_STEPS
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rec = {"metric": "rnnoise_denoise_realtime_factor",
           "value": S * F * 480 / 48000 / dt, "unit": "x_realtime_48khz",
           "streams": S, "frames_per_block": F, "block_ms": dt * 1e3, "device": device,
           "spectra": "fused" if pipeline._use_fused_spectra() else "fft"}
    if args.profile:
        rec["profile"] = _profile(params, state, block, BENCH_STEPS, dev)
    print(json.dumps(rec))
    return 0


def _profile(params, state, block, steps: int, dev) -> dict:
    """Device time per block step by kernel (torch.profiler), the top 15,
    and the share of the steps' wall time the device was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .dsp.rnnoise import pipeline

    if dev.type != "cuda":
        raise RuntimeError("--profile reads device time and needs the card")
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _, _ = pipeline.denoise_block(params, state, block)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    return {
        "wall_ms_per_step": wall_ms / steps,
        "device_ms_per_step": total_us / 1e3 / steps,
        "device_busy_share": total_us / 1e3 / wall_ms,
        "top": [{"kernel": e.key[:80], "ms_per_step": e.self_device_time_total / 1e3 / steps,
                 "share": e.self_device_time_total / total_us, "calls_per_step": e.count / steps}
                for e in top],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="crispy_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("denoise", help="RNNoise noise suppression on a WAV file")
    d.add_argument("input", type=Path)
    d.add_argument("output", type=Path)
    d.add_argument("--weights", type=Path, default=None, help="rnnoise .npz weights")
    d.add_argument("--device", default=None, help="default: cuda")
    d.set_defaults(fn=_cmd_denoise)

    b = sub.add_parser("bench", help="denoise throughput on the device")
    b.add_argument("--streams", type=int, default=128)
    b.add_argument("--device", default=None, help="default: cuda")
    b.add_argument("--profile", action="store_true",
                   help="add device time by kernel (torch.profiler; card only)")
    b.set_defaults(fn=_cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
