"""Event bus: the Tauri `app.emit` / `listen` channel, in-process.

The port's copy of ``crispy_tpu/api/events.py``.

The reference streams all observability through events (SURVEY.md §5):
microphone-level, model-download-progress, model-extraction-*,
model-state-changed, transcription-status/-phase/-progress,
transcription-chat-stream/-done/-error. Consumers subscribe by name;
emission is synchronous and exception-isolated per listener.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional


class EventBus:
    def __init__(self):
        self._listeners: Dict[str, List[Callable[[Any], None]]] = defaultdict(list)
        self._lock = threading.Lock()
        self.history: List[tuple] = []  # (event, payload), for tests/debugging
        self.keep_history = False

    def listen(self, event: str, callback: Callable[[Any], None]) -> Callable[[], None]:
        """Subscribe; returns an unlisten function (Tauri's listen contract)."""
        with self._lock:
            self._listeners[event].append(callback)

        def unlisten():
            with self._lock:
                try:
                    self._listeners[event].remove(callback)
                except ValueError:
                    pass

        return unlisten

    def emit(self, event: str, payload: Any = None) -> None:
        with self._lock:
            cbs = list(self._listeners[event])
            if self.keep_history:
                self.history.append((event, payload))
        for cb in cbs:
            try:
                cb(payload)
            except Exception:  # listener errors never break the emitter
                pass

    def clear(self) -> None:
        with self._lock:
            self._listeners.clear()
            self.history.clear()


# Process-wide default bus (the app handle analog).
BUS = EventBus()
