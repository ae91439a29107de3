"""Command line of the PyTorch/CUDA port.

  python -m crispy_tpu_torch.cli denoise IN.wav OUT.wav [--ns-model rnnoise]
                                                          RNNoise on the card
  python -m crispy_tpu_torch.cli bench [--streams N]      denoise throughput
  python -m crispy_tpu_torch.cli resample IN.wav OUT.wav --rate R
                                                          polyphase rate conversion
  python -m crispy_tpu_torch.cli recordings list|rename|delete [PATH] [NAME]
                                                          recordings CRUD (host)
  python -m crispy_tpu_torch.cli transcribe IN.wav --model ID [--language L]
                                  [--output F] [--diarize]
                                                          speech-to-text, with
                                                          speaker tags on --diarize

``CRISPY_FUSED_SPECTRA=on`` runs denoise and bench through the
fused-spectra kernels (K4-K6) in place of the FFTs. ``transcribe`` loads
the model from ``<data root>/Models`` (``CRISPY_DATA_DIR``, else
``~/Documents/Crispy``) under its catalog file name; ``recordings`` works on
``<data root>/Recordings``. ``--diarize`` diarizes the recording on the
card and tags the text (``[Speaker N|start]``); downloaded diarization nets
(``diarize-segmentation``, ``diarize-embedding``) load from the same
directory, else the built-in stand-in nets run.

denoise, bench, resample and transcribe run on the CUDA card by default and
fail without one; ``--device cpu`` runs the plain PyTorch path instead.
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

    if args.ns_model != "rnnoise":
        return _legacy_denoise(args)
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


def _legacy_denoise(args) -> int:
    """The legacy models on the host, as the JAX package's CLI runs them on
    files: ``dummy`` copies the input, ``noisy`` adds the LCG noise x 0.05."""
    import numpy as np

    from .engine.denoiser import _Lcg
    from .io import wav as wavio

    audio, sr = wavio.read_wav(args.input)
    if args.ns_model == "noisy":
        noise = _Lcg().next_block(audio.shape[0]).astype(np.float32)
        audio = audio + noise[:, None] * 0.05
    wavio.write_wav(args.output, audio, sr)
    print(json.dumps({"output": str(args.output), "ns_model": args.ns_model}))
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


def _cmd_resample(args) -> int:
    """Each channel through the polyphase conv on the device, fetched back and
    written as 16-bit PCM (the JAX CLI's output and JSON line)."""
    import numpy as np

    from .device import resolve_device
    from .dsp.resample import resample_poly
    from .io import wav as wavio

    dev = resolve_device(args.device)
    audio, sr = wavio.read_wav(args.input)
    out = np.stack([resample_poly(audio[:, c], sr, args.rate, device=dev).cpu().numpy()
                    for c in range(audio.shape[1])], axis=1)
    wavio.write_wav(args.output, out, args.rate)
    print(json.dumps({"output": str(args.output), "from_rate": sr, "to_rate": args.rate}))
    return 0


def _cmd_recordings(args) -> int:
    from .engine import recording as rec

    if args.action == "list":
        for r in rec.get_recordings():
            dur = f"{r['duration_seconds']:.1f}s" if r["duration_seconds"] else "?"
            print(f"{r['name']:40s} {dur:>8} {r['size']:>10} B  {r['path']}")
    elif args.action == "rename":
        print(rec.rename_recording(args.path, args.new_name))
    elif args.action == "delete":
        rec.delete_recording(args.path)
    return 0


def _cmd_transcribe(args) -> int:
    from .api.events import EventBus
    from .engine import transcription as tr
    from .models.registry import ModelManager

    tm = tr.TranscriptionManager(ModelManager(), bus=EventBus(), device=args.device)
    t0 = time.perf_counter()
    rec = str(args.input)
    try:
        text = tr.run_transcription(rec, tm, args.model, language=args.language,
                                    diarization={"enabled": True} if args.diarize else None)
    except (ValueError, FileNotFoundError, NotImplementedError) as e:
        print(json.dumps({"error": str(e)}))
        return 1
    if args.output:
        Path(args.output).write_text(text or "", encoding="utf-8")
    else:
        print(text or "")
    st = tm.get_state(rec)
    print(json.dumps({"status": st.status if st else None,
                      "seconds_wall": round(time.perf_counter() - t0, 2)}), file=sys.stderr)
    return 0 if st is not None and st.status == "completed" else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="crispy_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("denoise", help="RNNoise noise suppression on a WAV file")
    d.add_argument("input", type=Path)
    d.add_argument("output", type=Path)
    d.add_argument("--ns-model", default="rnnoise", choices=["dummy", "noisy", "rnnoise"],
                   help="dummy: copy; noisy: add LCG noise (both on the host)")
    d.add_argument("--weights", type=Path, default=None, help="rnnoise .npz weights")
    d.add_argument("--device", default=None, help="default: cuda")
    d.set_defaults(fn=_cmd_denoise)

    b = sub.add_parser("bench", help="denoise throughput on the device")
    b.add_argument("--streams", type=int, default=128)
    b.add_argument("--device", default=None, help="default: cuda")
    b.add_argument("--profile", action="store_true",
                   help="add device time by kernel (torch.profiler; card only)")
    b.set_defaults(fn=_cmd_bench)

    r = sub.add_parser("resample", help="high-quality sample rate conversion")
    r.add_argument("input", type=Path)
    r.add_argument("output", type=Path)
    r.add_argument("--rate", type=int, required=True)
    r.add_argument("--device", default=None, help="default: cuda")
    r.set_defaults(fn=_cmd_resample)

    rec = sub.add_parser("recordings", help="recordings CRUD")
    rec.add_argument("action", choices=["list", "rename", "delete"])
    rec.add_argument("path", nargs="?")
    rec.add_argument("new_name", nargs="?")
    rec.set_defaults(fn=_cmd_recordings)

    t = sub.add_parser("transcribe", help="speech-to-text on a recording")
    t.add_argument("input", type=Path)
    t.add_argument("--model", required=True, help="catalog model id")
    t.add_argument("--language", default="en", help="spoken language code (e.g. de, ru)")
    t.add_argument("--output", type=Path, default=None, help="default: print the text")
    t.add_argument("--diarize", action="store_true",
                   help="tag the text with speakers ([Speaker N|start])")
    t.add_argument("--device", default=None, help="default: cuda")
    t.set_defaults(fn=_cmd_transcribe)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
