"""Filesystem layout for user data.

The port's copy of ``crispy_tpu/utils/paths.py``, which mirrors the
reference's paths module (src-tauri/src/paths.rs:22-46):
``~/Documents/Crispy/{Recordings,Transcriptions,Models}`` with an environment
fallback. ``CRISPY_DATA_DIR`` overrides the root (for tests, and for hosts
without a Documents directory).
"""

from __future__ import annotations

import os
from pathlib import Path

_ENV_ROOT = "CRISPY_DATA_DIR"


def documents_dir() -> Path:
    """Best-effort Documents dir (paths.rs:5-27)."""
    if os.name == "nt":  # pragma: no cover - windows fallback kept for parity
        base = os.environ.get("USERPROFILE")
    else:
        base = os.environ.get("HOME")
    if base is None:
        raise RuntimeError("Cannot resolve Documents directory")
    return Path(base) / "Documents"


def crispy_root() -> Path:
    """``~/Documents/Crispy`` or ``$CRISPY_DATA_DIR`` (paths.rs:30-33)."""
    env = os.environ.get(_ENV_ROOT)
    if env:
        return Path(env)
    return documents_dir() / "Crispy"


def recordings_dir() -> Path:
    return crispy_root() / "Recordings"


def transcriptions_dir() -> Path:
    return crispy_root() / "Transcriptions"


def models_dir() -> Path:
    """Where downloaded model weights live (managers/model.rs app-data dir)."""
    return crispy_root() / "Models"


def ensure_dir(path: Path) -> Path:
    """Create ``path`` (and parents) if missing; returns it (paths.rs:43-46)."""
    path.mkdir(parents=True, exist_ok=True)
    return path
