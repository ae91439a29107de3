"""UI-side consumers rebuilt as library state machines (frontend rows
F4/F6/F7 of SURVEY §2.7): the mic level-meter curve, the transcription
progress hook, and the diarized-transcript parser. These are the exact
semantics of the reference's React hooks, minus the React.

The port's copy of ``crispy_tpu/api/ui_state.py``."""

from __future__ import annotations

import random
import re
import threading
from typing import Dict, List, Optional

from .events import BUS, EventBus

# ---------------------------------------------------------------------------
# F4: level meter curve (MicrophoneVolume.tsx:47-60)
# ---------------------------------------------------------------------------

NOISE_FLOOR = 0.01
METER_GAIN = 5.2
METER_EXPONENT = 0.3


def level_meter(raw: float, model_name: Optional[str] = None,
                rng: Optional[random.Random] = None) -> float:
    """RMS level → visual meter value in [0, 1]: noise-floor removal, ×5.2
    gain, 0.3-power curve ("macOS-like feel: ignore noise floor + faster
    peak"); the 'noisy' model adds a 0.08 base + ±0.03 jitter."""
    normalized = max(0.0, float(raw) - NOISE_FLOOR) / (1.0 - NOISE_FLOOR)
    visual = min(min(normalized * METER_GAIN, 1.0) ** METER_EXPONENT, 1.0)
    if model_name == "noisy":
        jitter = ((rng or random).random() - 0.5) * 0.06
        visual = min(max(visual + 0.08 + jitter, 0.0), 1.0)
    return visual


# ---------------------------------------------------------------------------
# F6: transcription progress hook (useTranscriptionProgress.ts)
# ---------------------------------------------------------------------------

class TranscriptionProgressTracker:
    """Module-level-map analog: per-recording progress state fed by the
    three transcription event streams, restorable from the backend state
    map so it survives consumer remounts (:64-88)."""

    def __init__(self, bus: EventBus = BUS, app=None):
        self.bus = bus
        self._lock = threading.Lock()
        self.states: Dict[str, dict] = {}
        if app is not None:
            self.restore(app.get_all_transcription_states())
        self._unlisten = [
            bus.listen("transcription-status", self._on_status),
            bus.listen("transcription-progress", self._on_progress),
            bus.listen("transcription-phase", self._on_phase),
        ]

    def close(self) -> None:
        for u in self._unlisten:
            u()
        self._unlisten = []

    def restore(self, backend_states: Dict[str, dict]) -> None:
        """Only in-flight jobs restore (:74-81)."""
        with self._lock:
            for path, st in backend_states.items():
                if st.get("status") in ("started", "transcribing"):
                    self.states[path] = {
                        "status": "transcribing",
                        "progress": st.get("progress", 0.0),
                        "eta_seconds": st.get("eta_seconds"),
                        "phase": st.get("phase"),
                        "error": None,
                    }

    def _update(self, path: str, **partial) -> None:
        with self._lock:
            cur = self.states.get(path, {
                "status": "idle", "progress": 0.0, "eta_seconds": None,
                "phase": None, "error": None})
            cur.update(partial)
            self.states[path] = cur

    def _on_status(self, p) -> None:
        path, status = p.get("recording_path"), p.get("status")
        if status == "started":
            self._update(path, status="transcribing", progress=0.0,
                         eta_seconds=None, phase="preparing-audio", error=None)
        elif status == "completed":
            self._update(path, status="completed", progress=1.0,
                         eta_seconds=0, phase=None, has_result=True)
        elif status == "error":
            self._update(path, status="error", phase=None,
                         error=p.get("error") or "Transcription failed")
        elif status == "cancelled":
            self._update(path, status="cancelled", progress=0.0,
                         eta_seconds=None, phase=None, error=None)

    def _on_progress(self, p) -> None:
        path = p.get("recording_path")
        with self._lock:
            cur = self.states.get(path)
        prog = p.get("progress", (cur or {}).get("progress", 0.0))
        self._update(path, progress=prog, eta_seconds=p.get("eta_seconds"))

    def _on_phase(self, p) -> None:
        self._update(p.get("recording_path"), phase=p.get("phase"))

    def get(self, path: str) -> Optional[dict]:
        with self._lock:
            st = self.states.get(path)
            return dict(st) if st else None

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self.states.items()}


# ---------------------------------------------------------------------------
# F7: diarized transcript parser (TranscriptionResultView.tsx:55-91)
# ---------------------------------------------------------------------------

_SPEAKER_RE = re.compile(r"^\[(.+?)(?:\|(\d+(?:\.\d+)?))?\]\s*$")

SPEAKER_PALETTE = 8  # distinct speaker colors in the reference view


def parse_transcript_segments(content: str) -> List[dict]:
    """`[Speaker N|secs]`-headed blocks → [{speaker, timestamp, text}];
    leading un-headed text becomes a speakerless segment."""
    segments: List[dict] = []
    speaker: Optional[str] = None
    timestamp: Optional[float] = None
    block: List[str] = []

    def flush():
        text = " ".join(block).strip()
        if text and speaker:
            segments.append({"speaker": speaker, "timestamp": timestamp, "text": text})
        elif text:
            segments.append({"speaker": "", "timestamp": None, "text": text})
        block.clear()

    for line in content.split("\n"):
        m = _SPEAKER_RE.match(line)
        if m:
            flush()
            speaker = m.group(1)
            timestamp = float(m.group(2)) if m.group(2) else None
        elif line.strip():
            block.append(line.strip())
    flush()
    return segments


def speaker_color_index(speaker: str) -> int:
    """Stable palette slot for a speaker label ('Speaker N' → (N-1) mod 8,
    the reference's color cycling)."""
    m = re.search(r"(\d+)", speaker)
    if m:
        return (int(m.group(1)) - 1) % SPEAKER_PALETTE
    return sum(speaker.encode()) % SPEAKER_PALETTE
