"""Hour-scale end-to-end drill of the port, the counterpart of
tests/test_hour_scale.py.

The product's main use: a 60-minute two-speaker meeting WAV through the
port's ``run_transcription`` — 30 s chunk batches through an ONNX
enc-dec engine (``OnnxEncDecEngine`` over test_onnx_engines'
``make_canary_bundle``, max_new=8), word timestamps, a cancel past 10%
progress that must leave a resumable chunk checkpoint, the resume to
completion without re-decoding the finished chunks, diarization over the
full hour, and persistence — within the JAX test's wall and memory bounds.
The cancel comes from a ``transcription-progress`` listener, so it lands
past 10% however fast the device decodes. A ``cpu`` case and a ``gpu``
case; ``chip_smoke.py`` runs ``hour_drill`` on the card in a process of
its own.

Marked ``slow`` and deselected by default; run with ``pytest -m slow``.
Imports nothing of JAX (the card's machine runs it with ``--noconftest``).
"""

import re
import resource
import threading
import time
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.slow

MINUTES = 60
SR = 16000
WALL_LIMIT = 1800  # seconds, the JAX test's bound
RSS_LIMIT_GB = 12.0


def peak_rss_gb() -> float:
    """This process's peak resident set in GB: the kernel's VmHWM where
    /proc has it, else ru_maxrss. (ru_maxrss of a process that a larger one
    started by vfork and exec also counts the parent's pages, which
    ``chip_smoke.py``'s drill process would otherwise report as its own.)"""
    try:
        for line in Path("/proc/self/status").read_text().splitlines():
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) / 1e6  # kB
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def synth_hour_wav(path: Path) -> Path:
    """Two alternating tone 'speakers' with 0.8 s pauses, one hour, 16 kHz
    mono: the JAX test's parameters."""
    from crispy_tpu_torch.io import wav as wavio
    from crispy_tpu_torch.utils.synth import synth_speaker_hour

    audio = synth_speaker_hour(MINUTES, SR, durs=(3.0, 5.0, 4.0, 8.0), freqs=(160.0, 1100.0),
                               level=0.35, noise=0.01)
    wavio.write_wav(path, audio[:, None], SR)
    return path


def hour_drill(tmp: Path, device: str) -> dict:
    """The drill under ``tmp`` on ``device`` (user data under
    ``$CRISPY_DATA_DIR``); raises AssertionError on a failed check, returns
    its numbers."""
    from test_onnx_engines import make_canary_bundle

    from crispy_tpu_torch.api.events import EventBus
    from crispy_tpu_torch.engine import transcription as tr
    from crispy_tpu_torch.engine.onnx_engines import OnnxEncDecEngine
    from crispy_tpu_torch.models.registry import ModelManager

    t_start = time.monotonic()
    wav = str(synth_hour_wav(tmp / "meeting.wav"))
    bus = EventBus()
    bus.keep_history = True
    bundle = tmp / "bundle"
    bundle.mkdir()
    make_canary_bundle(bundle)
    tm = tr.TranscriptionManager(
        ModelManager(models_dir=tmp / "Models"), bus=bus, device=device,
        engine_loader=lambda mid, m: OnnxEncDecEngine(bundle, "c", max_new=8, device=device))
    diar = {"enabled": True, "max_speakers": 4, "merge_gap": 1.0}
    torch.zeros(1, device=device)  # the device's runtime up before the first reading
    rss_start_gb = peak_rss_gb()
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()

    # -- run, cancel past 10% --------------------------------------------------
    cancelled_at = []

    def cancel_past_10(p):
        if p["progress"] > 0.1 and not cancelled_at:
            cancelled_at.append(p["progress"])
            tm.cancel(wav)

    unlisten = bus.listen("transcription-progress", cancel_past_10)
    th = threading.Thread(target=tr._guarded, args=(tr.run_transcription, wav, tm, "canary"),
                          kwargs={"diarization": diar}, daemon=True)
    th.start()
    th.join(timeout=900)
    unlisten()
    assert not th.is_alive(), "the first run did not end within 15 min"
    assert tm.get_state(wav).status == "cancelled" and cancelled_at
    ckpt = tr._load_progress(wav)
    assert ckpt is not None and ckpt["done_chunks"] > 0, "no resumable checkpoint"
    done_before = ckpt["done_chunks"]
    assert ckpt["n_chunks"] == MINUTES * 2  # 30 s chunks
    t_cancel = time.monotonic() - t_start

    # -- resume to completion ----------------------------------------------------
    events_before = len(bus.history)
    text = tr.run_transcription(wav, tm, "canary", diarization=diar)
    assert tm.get_state(wav).status == "completed"
    assert text is not None and text.strip()
    progress = [p for e, p in bus.history[events_before:] if e == "transcription-progress"]
    # the resumed run's first progress event starts past the checkpoint:
    # the finished chunks were not decoded again
    assert progress and progress[0]["progress"] >= done_before / (MINUTES * 2) - 1e-6
    assert tr._load_progress(wav) is None  # checkpoint consumed
    assert tr.load_transcription_result(wav) == text
    assert "[Speaker 1|" in text
    falls = [p for e, p in bus.history if e == "diarization-fallback"]
    assert not falls, falls

    wall = time.monotonic() - t_start
    rss_gb = peak_rss_gb()
    assert wall < WALL_LIMIT, f"hour-scale run took {wall:.0f}s"
    assert rss_gb < RSS_LIMIT_GB, f"peak RSS {rss_gb:.1f} GB"
    return {"device": device, "wall_s": wall, "to_cancel_s": t_cancel,
            "cancelled_at": cancelled_at[0], "done_before": done_before,
            "resumed_batches": len(progress), "characters": len(text),
            "speakers": sorted(set(re.findall(r"\[(Speaker \d+)\|", text))),
            "peak_rss_gb": rss_gb, "rss_before_run_gb": rss_start_gb,
            "peak_device_gb": (torch.cuda.max_memory_allocated() / 1e9
                               if device != "cpu" else None)}


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_hour_scale_transcribe_diarize_cancel_resume(tmp_path, monkeypatch, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setenv("CRISPY_DATA_DIR", str(tmp_path / "Crispy"))
    hour_drill(tmp_path, device)
