"""Turnkey real-artifact validation: the port of ``crispy_tpu/models/validate.py``.

The reference proves its engines by running the actual downloaded bundles
through whisper.cpp / ONNX Runtime (managers/transcription.rs:119-172).
This module is the rebuild's equivalent moment-of-truth: load a catalog
model's *real* files through the normal `load_engine` path, decode the
committed 10 s utterance (the port's own copy,
`crispy_tpu_torch/assets/validate_utterance.wav`),
and emit a golden record that pins the decode. `crispy models validate
<id> --pin` writes the golden; `tests/test_real_artifacts.py` replays
every pinned golden for every model that is actually downloaded (skipped
otherwise — this environment has no egress, so goldens land the moment
artifacts become reachable, with zero code changes).
"""

from __future__ import annotations

import json
import wave
from pathlib import Path
from typing import Optional

import numpy as np

UTTERANCE = Path(__file__).resolve().parent.parent / "assets" / "validate_utterance.wav"


def validation_utterance() -> np.ndarray:
    """The committed 10 s 16 kHz mono utterance as float32 in [-1, 1]."""
    with wave.open(str(UTTERANCE), "rb") as w:
        assert w.getframerate() == 16000 and w.getnchannels() == 1
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    return (pcm / 32768.0).astype(np.float32)


def validate_model(model_id: str, model_manager, device=None,
                   language: str = "en", engine=None, mesh=None) -> dict:
    """Load the model's real bundle on ``device`` (default the card), or over
    ``mesh`` (``load_engine``'s), and decode the committed utterance.

    Returns a JSON-able golden record: the decoded text, word segments,
    and the bundle's file inventory hash (so a re-downloaded bundle that
    changed is detected rather than silently compared)."""
    from ..engine.transcription import load_engine

    if engine is None:
        engine = load_engine(model_id, model_manager, device=device, mesh=mesh)
    audio = validation_utterance()
    # 30 s chunk contract: pad the 10 s utterance like the pipeline does
    chunk = np.zeros(30 * 16000, np.float32)
    chunk[: len(audio)] = audio
    text = engine.transcribe_batch(chunk[None, :], language=language)[0]
    words = engine.transcribe_batch_with_timestamps(
        chunk[None, :], [0.0], language=language)[0]
    path = model_manager.model_path(model_id)
    return {
        "model_id": model_id,
        "engine": type(engine).__name__,
        "language": language,
        "text": text,
        "words": [[round(s, 3), round(e, 3), w] for s, e, w in words],
        "bundle_inventory": _inventory(path),
    }


def _inventory(path: Optional[Path]) -> list:
    if path is None or not path.exists():
        return []
    if path.is_file():
        return [[path.name, path.stat().st_size]]
    return sorted([str(f.relative_to(path)), f.stat().st_size]
                  for f in path.rglob("*") if f.is_file())


def golden_path(repo_root, model_id: str) -> Path:
    return Path(repo_root) / "tests" / "goldens" / "real_artifacts" / f"{model_id}.json"


def pin_golden(result: dict, path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=2, ensure_ascii=False) + "\n",
                    encoding="utf-8")
    return path
