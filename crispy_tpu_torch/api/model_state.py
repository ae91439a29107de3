"""Model-state machine: the F5 consumer (useTranscriptionModels.ts)

The port's copy of ``crispy_tpu/api/model_state.py``.
rebuilt as a bus subscriber.

Tracks the six model event streams — model-state-changed,
model-download-progress, model-download-complete, model-extraction-
started/-completed/-failed — into a queryable snapshot with the frontend's
exact download-speed smoothing: per-model MB/s sampled at ≥0.5 s spacing,
EMA 0.8·prev + 0.2·current (useTranscriptionModels.ts:154-176), aggregate
speed as the sum over active downloads (:357).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from .events import BUS, EventBus

EVENTS = (
    "model-state-changed", "model-download-progress", "model-download-complete",
    "model-extraction-started", "model-extraction-completed",
    "model-extraction-failed",
)


def _model_id(payload: Any) -> Optional[str]:
    if isinstance(payload, str):
        return payload  # the reference emits bare ids for extraction events
    if isinstance(payload, dict):
        return payload.get("model_id")
    return None


class ModelStateTracker:
    """Subscribes on construction; `snapshot()` is the UI-facing view.
    `close()` detaches the listeners."""

    def __init__(self, bus: EventBus = BUS, clock: Callable[[], float] = time.monotonic):
        self.bus = bus
        self.clock = clock
        self._lock = threading.Lock()
        self.status = "unloaded"  # unloaded|loading|ready|downloading|extracting|error
        self.error: Optional[str] = None
        self.current_model_id = "none"
        self.progress: Dict[str, dict] = {}
        self.stats: Dict[str, dict] = {}
        self.extracting: Dict[str, bool] = {}
        self._unlisten = [
            bus.listen("model-state-changed", self._on_state),
            bus.listen("model-download-progress", self._on_progress),
            bus.listen("model-download-complete", self._on_complete),
            bus.listen("model-extraction-started", self._on_extract_start),
            bus.listen("model-extraction-completed", self._on_extract_done),
            bus.listen("model-extraction-failed", self._on_extract_failed),
        ]

    def close(self) -> None:
        for u in self._unlisten:
            u()
        self._unlisten = []

    # -- handlers ---------------------------------------------------------------
    def _on_state(self, payload) -> None:
        # reference schema: {event_type, model_id, model_name, error}
        # (commands/models.rs:8-13); "state" accepted as a legacy alias
        state = (payload.get("event_type") or payload.get("state")
                 ) if isinstance(payload, dict) else None
        mid = _model_id(payload)
        with self._lock:
            if state in ("loading", "loading_started"):
                self.status, self.error = "loading", None
            elif state in ("loaded", "loading_completed", "selected"):
                self.status, self.error = "ready", None
                if mid:
                    self.current_model_id = mid
            elif state in ("error", "loading_failed"):
                self.status = "error"
                self.error = (payload.get("error")
                              if isinstance(payload, dict) else None) or "model error"
                self._clear_transient(mid)
            elif state in ("downloaded",):
                self._clear_transient(mid)
                self.status = "unloaded" if self.current_model_id == "none" else "ready"
            elif state in ("cancelled", "deleted", "unloaded"):
                self._clear_transient(mid)
                if state == "deleted" and mid == self.current_model_id:
                    self.current_model_id = "none"
                if state == "unloaded":
                    self.status, self.error = "unloaded", None
                    self.current_model_id = "none"

    def _on_progress(self, payload) -> None:
        mid = _model_id(payload)
        if mid is None:
            return
        now = self.clock()
        with self._lock:
            self.progress[mid] = dict(payload)
            self.status = "downloading"
            cur = self.stats.get(mid)
            downloaded = float(payload.get("downloaded", 0))
            if cur is None:
                self.stats[mid] = {"start": now, "last": now,
                                   "downloaded": downloaded, "speed": 0.0}
                return
            dt = now - cur["last"]
            if dt <= 0.5:  # sample spacing gate (:159-161)
                return
            speed = max(0.0, (downloaded - cur["downloaded"]) / (1024 * 1024) / dt)
            smoothed = cur["speed"] * 0.8 + speed * 0.2 if cur["speed"] > 0 else speed
            self.stats[mid] = {"start": cur["start"], "last": now,
                               "downloaded": downloaded, "speed": max(0.0, smoothed)}

    def _on_complete(self, payload) -> None:
        mid = _model_id(payload)
        with self._lock:
            if mid:  # clear only THIS model; concurrent downloads keep
                self.progress.pop(mid, None)  # their progress + speed EMA
                self.stats.pop(mid, None)
            else:
                self.progress.clear()
                self.stats.clear()
            if self.progress or self.stats:
                self.status = "downloading"  # others still in flight
            else:
                self.status = ("unloaded" if self.current_model_id == "none"
                               else "ready")

    def _on_extract_start(self, payload) -> None:
        mid = _model_id(payload)
        with self._lock:
            self._clear_transient(mid)
            if mid:
                self.extracting[mid] = True
            self.status = "extracting"

    def _on_extract_done(self, payload) -> None:
        mid = _model_id(payload)
        with self._lock:
            self.extracting.pop(mid, None)
            self.status = "unloaded" if self.current_model_id == "none" else "ready"

    def _on_extract_failed(self, payload) -> None:
        mid = _model_id(payload)
        err = payload.get("error") if isinstance(payload, dict) else None
        with self._lock:
            self.extracting.pop(mid, None)
            self.status = "error"
            self.error = f"Failed to extract model: {err}"

    def _clear_transient(self, mid: Optional[str]) -> None:
        """Clear ALL transient state for a model (the frontend comment:
        partial clearing wedges a model in 'extracting' with no way out)."""
        if mid is None:
            self.progress.clear()
            self.stats.clear()
            self.extracting.clear()
        else:
            self.progress.pop(mid, None)
            self.stats.pop(mid, None)
            self.extracting.pop(mid, None)

    # -- view -------------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            models = {}
            for mid, p in self.progress.items():
                models[mid] = {
                    "downloaded": p.get("downloaded"), "total": p.get("total"),
                    "percentage": p.get("percentage"),
                    "speed_mbps": round(self.stats.get(mid, {}).get("speed", 0.0), 3),
                    "extracting": False,
                }
            for mid in self.extracting:
                models.setdefault(mid, {})["extracting"] = True
            return {
                "status": self.status,
                "error": self.error,
                "current_model_id": self.current_model_id,
                "models": models,
                "total_speed_mbps": round(
                    sum(s["speed"] for s in self.stats.values()), 3),
            }
