"""The port's window/tray logic (crispy_tpu_torch.api.window) held against
the JAX package's: the same calls on both give the same snapshots and the
same window-state events."""

import pytest

from crispy_tpu.api.events import EventBus as JBus
from crispy_tpu.api.window import WindowManager as JWindows
from crispy_tpu_torch.api.events import EventBus
from crispy_tpu_torch.api.window import TRAY_BLUR_GRACE_MS, WindowManager


class Clock:
    def __init__(self):
        self.t = 50.0

    def __call__(self):
        return self.t


def pair():
    out = []
    for wm_cls, bus_cls in ((JWindows, JBus), (WindowManager, EventBus)):
        bus = bus_cls()
        bus.keep_history = True
        clock = Clock()
        out.append((wm_cls(bus=bus, clock=clock), bus, clock))
    return out


def test_grace_constant():
    from crispy_tpu.api import window as jw

    assert TRAY_BLUR_GRACE_MS == jw.TRAY_BLUR_GRACE_MS == 600


@pytest.mark.parametrize("script", [
    [("request_close_main",), ("show_main",)],
    [("show_tray_popup",), ("tick", 0.3), ("tray_popup_blurred",), ("tick", 0.5),
     ("tray_popup_blurred",), ("tray_popup_blurred",)],
    [("toggle_tray_popup",), ("toggle_tray_popup",), ("toggle_tray_popup",),
     ("tick", 0.7), ("tray_popup_blurred",)],
], ids=["close-hides", "blur-grace", "toggle"])
def test_same_calls_same_state_and_events(script):
    runs = []
    for wm, bus, clock in pair():
        results = []
        for cmd, *a in script:
            if cmd == "tick":
                clock.t += a[0]
            else:
                results.append(getattr(wm, cmd)())
                results.append(wm.snapshot())
        runs.append((results, bus.history))
    assert runs[0] == runs[1]
    assert runs[1][1]  # events were emitted


def test_main_close_hides_and_flips_policy():
    wm = WindowManager(bus=EventBus(), clock=Clock())
    assert wm.request_close_main() is False  # prevent_close
    assert not wm.main_visible and wm.accessory_policy
    wm.show_main()
    assert wm.main_visible and not wm.accessory_policy


def test_app_wires_window_manager(data_root):
    from crispy_tpu_torch.api.commands import CrispyApp

    app = CrispyApp(bus=EventBus())  # no engine is built: no card needed
    app.windows.request_close_main()
    assert not app.windows.main_visible
    app.show_main_window_cmd()
    assert app.windows.main_visible
    app.notify_tray_popup_shown()
    assert app.notify_tray_popup_blurred() is False  # inside the grace window
    assert app.get_window_state()["tray_popup_visible"]
