"""Media → WAV conversion via ffmpeg (reference: commands/convert.rs).

The port's copy of ``crispy_tpu/engine/convert.py`` (host only).

Discovers ffmpeg across PATH plus the reference's usual install
locations, converts any media file to 48 kHz stereo pcm_s16le WAV in the
recordings dir (convert.rs:24-165).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

from ..utils import paths

# The Linux candidates of the JAX package's list: the port runs on a Linux
# host with a CUDA card, where Homebrew's Apple-silicon prefix does not exist.
_EXTRA_CANDIDATES = [
    "/usr/local/bin/ffmpeg",
    "/usr/bin/ffmpeg",
]


def find_ffmpeg(extra_paths: Optional[List[str]] = None) -> Optional[str]:
    found = shutil.which("ffmpeg")
    if found:
        return found
    for cand in (extra_paths or []) + _EXTRA_CANDIDATES:
        if os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    return None


def check_ffmpeg() -> bool:
    return find_ffmpeg() is not None


def convert_to_wav(
    input_path,
    output_name: Optional[str] = None,
    recordings_dir: Optional[Path] = None,
    ffmpeg: Optional[str] = None,
) -> Path:
    """Convert to 48 kHz stereo s16 WAV in the recordings dir (convert.rs:24-120)."""
    src = Path(input_path)
    if not src.exists():
        raise FileNotFoundError(str(src))
    ffmpeg = ffmpeg or find_ffmpeg()
    if not ffmpeg:
        raise RuntimeError("ffmpeg not found")
    out_dir = paths.ensure_dir(Path(recordings_dir) if recordings_dir else paths.recordings_dir())
    name = output_name or (src.stem + ".wav")
    if not name.endswith(".wav"):
        name += ".wav"
    dst = out_dir / name
    i = 1
    while dst.exists():  # don't clobber existing recordings
        dst = out_dir / f"{Path(name).stem}_{i}.wav"
        i += 1
    cmd = [
        ffmpeg, "-y", "-i", str(src),
        "-ar", "48000", "-ac", "2", "-c:a", "pcm_s16le",
        str(dst),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"ffmpeg failed: {proc.stderr[-500:]}")
    return dst
