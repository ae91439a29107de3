"""Real-time monitoring: the reference's start/stop_monitoring surface (the
port of ``crispy_tpu/engine/monitoring.py``).

Rebuild of src-tauri/src/audio.rs:441-1034 for hosts without OS audio:
devices are pluggable block sources (synthetic tones, WAV files, or live
feeders); the monitor loop pushes input blocks through the NS processor
(dummy/noisy on the host; rnnoise one frame at a time through the block
step's CUDA graph on the card), emits `microphone-level` RMS events
throttled to one per 16 ms (audio.rs:779-786) and a once-a-second
`stage-timing` event with the slowest block against its budget, and delivers
denoised output to a sink callback and, at 48 kHz, to the recording tap.
Idempotent restart when parameters are unchanged (audio.rs:447-470), live
model/volume setters (audio.rs:923-967). ``device=None`` means the card.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..api.events import BUS, EventBus
from ..device import resolve_device
from ..dsp.resample import resample_block
from .denoiser import NsState, RnnNoiseProcessor

LEVEL_EVENT_INTERVAL = 0.016  # ≥16 ms between microphone-level events


class InputDevice:
    """A named 48 kHz mono block source."""

    def __init__(self, name: str, fn: Callable[[int], np.ndarray], rate: float = 48000.0):
        self.name = name
        self.fn = fn  # n_samples -> block
        self.rate = rate


def synthetic_device(name: str = "Synthetic 440Hz", freq: float = 440.0,
                     rate: float = 48000.0) -> InputDevice:
    state = {"phase": 0.0}

    def fn(n: int) -> np.ndarray:
        t = (state["phase"] + np.arange(n)) / rate
        state["phase"] += n
        return (0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32)

    return InputDevice(name, fn, rate)


class DeviceRegistry:
    """Virtual device catalog (the cpal host enumeration analog)."""

    def __init__(self):
        self._inputs: Dict[str, InputDevice] = {}
        self.register(synthetic_device())

    def register(self, dev: InputDevice) -> None:
        self._inputs[dev.name] = dev

    def get_input_devices(self) -> List[str]:
        return sorted(self._inputs)

    def get_output_devices(self) -> List[str]:
        return ["Default"]

    def get_default_devices(self) -> Dict[str, Optional[str]]:
        # reference shape (audio.rs:407-409): {default_input,
        # blackhole_output}; this host has no BlackHole loopback device
        names = self.get_input_devices()
        return {"default_input": names[0] if names else None,
                "blackhole_output": None}

    def resolve(self, name: str) -> InputDevice:
        if name in ("", "Default", None):
            names = self.get_input_devices()
            if not names:
                raise ValueError("no input devices")
            return self._inputs[names[0]]
        if name not in self._inputs:
            raise ValueError(f"unknown input device: {name}")
        return self._inputs[name]


class MonitoringEngine:
    """One active monitoring run (AudioMonitorState analog)."""

    def __init__(self, registry: Optional[DeviceRegistry] = None, bus: EventBus = BUS,
                 output_sink: Optional[Callable[[np.ndarray], None]] = None,
                 block_samples: int = 480,
                 mic_tap: Optional[Callable[[np.ndarray], None]] = None,
                 device=None):
        self.device = resolve_device(device)  # the card unless told otherwise
        self.registry = registry or DeviceRegistry()
        self.bus = bus
        self.output_sink = output_sink
        # The recording feed (push_mono_to_buffers, audio.rs:682-730): the
        # NS output, resampled to 48 kHz, goes to the recording mic ring
        # whenever monitoring runs. Recordings capture the DENOISED mic.
        self.mic_tap = mic_tap
        self.block_samples = block_samples
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._ns: Optional[NsState] = None
        self._params: Optional[tuple] = None
        self._lock = threading.Lock()
        self._start_lock = threading.Lock()  # serializes start sequences
        self.realtime = True  # tests disable pacing

    @property
    def active(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start_monitoring(self, device_name: str = "Default",
                         output_device_name: str = "Default",
                         model_name: str = "rnnoise", volume: float = 1.0) -> None:
        params = (device_name, output_device_name, model_name)
        # the whole check-stop-spawn sequence holds the start lock: two
        # concurrent calls must not each spawn a monitor loop sharing one
        # stop event (doubled audio into the sink)
        with self._start_lock:
            with self._lock:
                if self.active and self._params == params:
                    if self._ns is not None:  # idempotent restart: retune
                        self._ns.volume = volume
                    return
            self.stop_monitoring()
            self._start_locked(device_name, model_name, volume, params)

    def _start_locked(self, device_name: str, model_name: str,
                      volume: float, params) -> None:
        dev = self.registry.resolve(device_name)
        ns = NsState(model_name, dev.rate, 48000.0, volume, device=self.device)
        self._ns = ns
        self._params = params
        self._stop.clear()

        def run():
            last_level = 0.0
            last_latency = 0.0
            lat_max_ms = 0.0
            budget_s = self.block_samples / dev.rate  # 10 ms at 480/48k
            # Warm-up outside the real-time loop, as the JAX package does:
            # a silent block, whose output is dropped (the reference drops
            # the first frame anyway, audio.rs:275-278). It is a real frame:
            # it advances the state, so the output sequence matches the JAX
            # package's. (The graph was captured when NsState was built.)
            proc0 = ns._proc
            if isinstance(proc0, RnnNoiseProcessor):
                proc0.push_block(np.zeros(self.block_samples, np.float32))
            t_start = time.monotonic()
            n_done = 0
            while not self._stop.is_set():
                block = dev.fn(self.block_samples)
                if block is None or len(block) == 0:
                    break
                # per-block NS processing (rnnoise: one graph replay per 480
                # samples; legacy: vectorized numpy)
                t0 = time.monotonic()
                proc = ns._proc
                if hasattr(proc, "push_block"):
                    out = proc.push_block(block)
                else:
                    outs = [proc.push_sample(float(s)) for s in block]
                    flat = [x for o in outs if o for x in o]
                    out = np.asarray(flat, np.float32) if flat else None
                lat_max_ms = max(lat_max_ms, (time.monotonic() - t0) * 1e3)
                if out is not None and self.output_sink is not None:
                    self.output_sink(out)
                if out is not None and self.mic_tap is not None:
                    # recording feed at 48 kHz (push_mono_to_buffers): the
                    # tap target (mic ring) is capped at 10 s, so this never
                    # grows unbounded when no recording is active
                    rate = getattr(proc, "output_block_rate_hz", 48000.0)
                    tap = out
                    if abs(rate - 48000.0) >= 1.0:
                        tap = resample_block(tap, rate, 48000.0)
                    self.mic_tap(tap)
                now = time.monotonic()
                if now - last_level >= LEVEL_EVENT_INTERVAL:
                    last_level = now
                    rms = float(np.sqrt(np.mean(block.astype(np.float64) ** 2)))
                    # bare float: the reference's payload shape
                    # (audio.rs:784 emits the raw RMS number)
                    self.bus.emit("microphone-level", rms)
                if now - last_latency >= 1.0:
                    # real-time-budget evidence (audio.rs:260-268: the frame
                    # must process inside its own duration)
                    last_latency = now
                    self.bus.emit("stage-timing", {
                        "stage": "ns-block", "max_ms": round(lat_max_ms, 3),
                        "budget_ms": round(budget_s * 1e3, 3)})
                    lat_max_ms = 0.0
                if self.realtime:
                    # pace to an absolute deadline: block n is due at
                    # t_start + n × budget. A late block does not sleep and
                    # the deadline is not reset, so the loop keeps
                    # realtime on average; pacing each block from its own
                    # start ran slower than realtime and grew a live
                    # feeder's backlog without bound
                    n_done += 1
                    wait = t_start + n_done * budget_s - time.monotonic()
                    if wait > 0:
                        time.sleep(wait)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop_monitoring(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._params = None

    def set_monitoring_volume(self, volume: float) -> None:
        if self._ns is not None:
            self._ns.volume = volume

    def set_monitoring_model(self, model_name: str) -> None:
        """Live model hot-swap (audio.rs:942-967)."""
        if self._ns is not None:
            self._ns.set_model(model_name)

    def get_blackhole_status(self) -> Dict[str, object]:
        """No loopback devices on this host (audio.rs:1003-1034 analog).
        Reference shape (audio.rs:998-1001): {installed: bool, paths: [str]}."""
        return {"installed": False, "paths": []}
