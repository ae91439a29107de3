"""Window/tray state machine (X7, window.rs + main.rs:267-371).

The port's copy of ``crispy_tpu/api/window.py``.

A server host has no compositor; what IS portable is the reference's window
*logic*: main-window close requests hide instead of closing (switching the
app to accessory/background policy), and the tray popup ignores blur
events within a 600 ms grace window of being shown (the Finder-activation
workaround — spurious focus loss would otherwise immediately hide it)."""

from __future__ import annotations

import time
from typing import Callable, Dict

from .events import BUS, EventBus

TRAY_BLUR_GRACE_MS = 600  # main.rs:361-366


class WindowManager:
    def __init__(self, bus: EventBus = BUS, clock: Callable[[], float] = time.monotonic):
        self.bus = bus
        self.clock = clock
        self.main_visible = True
        self.accessory_policy = False  # macOS ActivationPolicy::Accessory analog
        self.tray_popup_visible = False
        self._tray_shown_at = 0.0

    # -- main window (main.rs:342-354) -----------------------------------------
    def request_close_main(self) -> bool:
        """A close request on the main window hides it (prevent_close) and
        flips to accessory policy; returns False = not actually closed."""
        self.main_visible = False
        self.accessory_policy = True
        self.bus.emit("window-state", {"window": "main", "visible": False})
        return False

    def show_main(self) -> None:
        self.main_visible = True
        self.accessory_policy = False
        self.bus.emit("window-state", {"window": "main", "visible": True})

    # -- tray popup (window.rs:7-99, main.rs:355-368) ---------------------------
    def show_tray_popup(self) -> None:
        self.tray_popup_visible = True
        self._tray_shown_at = self.clock()
        self.bus.emit("window-state", {"window": "tray-popup", "visible": True})

    def tray_popup_blurred(self) -> bool:
        """Focus-lost on the popup. Within the grace period of showing, the
        blur is ignored (returns False); after it, the popup hides."""
        if not self.tray_popup_visible:
            return False
        elapsed_ms = (self.clock() - self._tray_shown_at) * 1000.0
        if elapsed_ms < TRAY_BLUR_GRACE_MS:
            return False
        self.tray_popup_visible = False
        self.bus.emit("window-state", {"window": "tray-popup", "visible": False})
        return True

    def toggle_tray_popup(self) -> None:
        """Tray icon click: toggle (window.rs behavior)."""
        if self.tray_popup_visible:
            self.tray_popup_visible = False
            self.bus.emit("window-state", {"window": "tray-popup", "visible": False})
        else:
            self.show_tray_popup()

    def snapshot(self) -> Dict[str, bool]:
        return {
            "main_visible": self.main_visible,
            "accessory_policy": self.accessory_policy,
            "tray_popup_visible": self.tray_popup_visible,
        }
