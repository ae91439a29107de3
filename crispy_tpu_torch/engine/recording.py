"""Recording engine: dual-source capture, mixing, WAV lifecycle, CRUD (the
port of ``crispy_tpu/engine/recording.py``).

Rebuild of the reference's recording stack (SURVEY §2.2):
  * RecordingState (src-tauri/src/recording.rs:8-76): writer slot, 10 s
    mic/app ring buffers, worker handle, active flag.
  * Mixer worker (commands/recording.rs:188-291): 1152-sample frames, trims
    whichever ring runs >50 ms ahead, zero-fills missing app audio, sums
    mic+app into BOTH channels (dual-mono) and writes s16 stereo.
  * Lifecycle (commands/recording.rs:43-186): timestamped
    recording_%Y%m%d_%H%M%S.wav, capture start/stop, worker join, finalize.
  * CRUD (commands/recording.rs:470-602): list (hides the active file,
    newest first, header-parsed durations), rename with sidecar moves and
    name validation, delete — all under a recordings-dir confinement guard.

OS audio capture (cpal/ScreenCaptureKit/WASAPI) has no analog on a server;
sources are pluggable ``AudioSource``s (files, synthetic tones, or a live
feeder such as the monitoring engine's ``mic_tap``) delivering 48 kHz mono
float blocks into the same ring buffers. The rings and the writer are the
native runtime's (``crispy_tpu_torch.runtime``) where ``g++`` built it, else
the Python ones here; both give the same samples and bytes. All host code.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .. import runtime as rt
from ..dsp.resample import resample_block
from ..io import wav as wavio
from ..utils import paths

SAMPLE_RATE = 48000  # recording.rs:8
CHANNELS = 2  # recording.rs:9
RING_CAPACITY = SAMPLE_RATE * 10  # 10 s (recording.rs:65-66)
MIX_FRAME = 1152  # commands/recording.rs:196
MAX_DESYNC = SAMPLE_RATE // 20  # 50 ms (commands/recording.rs:198)


class RingBuffer:
    """Bounded mono sample ring (the Arc<Mutex<VecDeque<f32>>> analog)."""

    def __init__(self, capacity: int = RING_CAPACITY):
        self.capacity = capacity
        self._buf: deque = deque()
        self._lock = threading.Lock()

    def push(self, samples: np.ndarray) -> None:
        with self._lock:
            self._buf.extend(np.asarray(samples, np.float32).ravel().tolist())
            while len(self._buf) > self.capacity:
                self._buf.popleft()

    def pop(self, n: int) -> np.ndarray:
        with self._lock:
            n = min(n, len(self._buf))
            out = np.array([self._buf.popleft() for _ in range(n)], np.float32)
        return out

    def trim_front(self, n: int) -> None:
        with self._lock:
            for _ in range(min(n, len(self._buf))):
                self._buf.popleft()

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)


class AudioSource:
    """Pluggable capture source: start() begins delivering 48 kHz mono
    float32 blocks to the sink callback; stop() halts delivery."""

    def start(self, sink: Callable[[np.ndarray], None]) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        raise NotImplementedError


class FileSource(AudioSource):
    """Plays a WAV file into the sink in real-time-ish blocks (for tests
    and offline mixing, the stand-in for app-audio capture)."""

    def __init__(self, path, realtime: bool = False, block: int = 4800):
        self.path = path
        self.realtime = realtime
        self.block = block
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self, sink):
        def run():
            audio, sr = wavio.read_wav_mono(self.path)
            if sr != SAMPLE_RATE:
                audio = resample_block(audio, sr, SAMPLE_RATE)
            for i in range(0, len(audio), self.block):
                if self._stop.is_set():
                    return
                sink(audio[i: i + self.block])
                if self.realtime:
                    time.sleep(self.block / SAMPLE_RATE)

        self._stop.clear()
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)


@dataclass
class RecordableApp:
    id: str
    name: str
    bundle_id: str = ""  # reference shape (recording.rs:42-46); virtual
    # sources use their registry id as the bundle id


def detect_sample_rate(num_samples: int, duration_secs: Optional[float]) -> int:
    """The reference's one-shot capture-rate detection (recording.rs:324-352):
    rate = round(samples / buffer duration), snapped to 48 k or 44.1 k within
    ±200 Hz; anything else (or a missing duration) falls back to 44.1 k."""
    if not duration_secs or duration_secs <= 0:
        return 44100
    computed = int(round(num_samples / duration_secs))
    if abs(computed - 48000) < 200:
        return 48000
    if abs(computed - 44100) < 200:
        return 44100
    return 44100


def downmix_mono(samples) -> np.ndarray:
    """CMSampleBuffer downmix semantics (recording.rs:258-318): a (L, R)
    pair averages channel-wise over the common length; an interleaved
    [T, C] block averages across channels; mono passes through."""
    if isinstance(samples, (tuple, list)) and len(samples) == 2:
        l = np.asarray(samples[0], np.float32).ravel()
        r = np.asarray(samples[1], np.float32).ravel()
        n = min(l.size, r.size)
        return ((l[:n] + r[:n]) * 0.5).astype(np.float32)
    x = np.asarray(samples, np.float32)
    if x.ndim == 2:
        return x.mean(axis=1).astype(np.float32)
    return x.ravel()


class AppCaptureHandler:
    """R5's AudioHandler analog for pluggable sources: per-delivery downmix,
    one-shot rate detection from the first buffer's duration, snap, and
    block resample to 48 kHz before pushing to the sink."""

    def __init__(self, sink: Callable[[np.ndarray], None]):
        self.sink = sink
        self.detected_sample_rate: Optional[int] = None

    def deliver(self, samples, duration_secs: Optional[float] = None) -> None:
        mono = downmix_mono(samples)
        if mono.size == 0:
            return
        if self.detected_sample_rate is None:
            self.detected_sample_rate = detect_sample_rate(mono.size, duration_secs)
        if self.detected_sample_rate != SAMPLE_RATE:
            mono = resample_block(mono, self.detected_sample_rate, SAMPLE_RATE)
        self.sink(mono)

    def deliver_silence(self, duration_secs: float) -> None:
        """WASAPI silent-packet zero-fill (windows_audio.rs capture loop:
        AUDCLNT_BUFFERFLAGS_SILENT packets still advance the timeline)."""
        n = int(round(duration_secs * SAMPLE_RATE))
        if n > 0:
            self.sink(np.zeros(n, np.float32))


def _make_ring():
    """Native C++ ring when the runtime builds; Python deque otherwise."""
    if rt.available():
        return rt.NativeRing(RING_CAPACITY)
    return RingBuffer()


def _make_writer(path):
    """Native C++ writer when the runtime builds; Python writer otherwise."""
    if rt.available():
        return rt.NativeWavWriter(path, SAMPLE_RATE, CHANNELS)
    return wavio.WavWriter(path, SAMPLE_RATE, CHANNELS)


class RecordingState:
    """Writer slot + rings + worker handle (recording.rs:8-76)."""

    def __init__(self):
        self.writer = None
        self.writer_path: Optional[Path] = None
        self.mic_ring = _make_ring()
        self.app_ring = _make_ring()
        self.worker: Optional[threading.Thread] = None
        self.active = threading.Event()  # RECORDING_ACTIVE (commands/recording.rs:15)
        self.app_source: Optional[AudioSource] = None
        self._lock = threading.Lock()


def start_recording_worker(state: RecordingState, idle_sleep: float = 0.01) -> threading.Thread:
    """The mixer worker (commands/recording.rs:188-291)."""

    def run():
        while state.active.is_set() or len(state.mic_ring) >= MIX_FRAME:
            mic_len, app_len = len(state.mic_ring), len(state.app_ring)
            if mic_len < MIX_FRAME:
                if not state.active.is_set():
                    break
                time.sleep(idle_sleep)
                continue
            # Desync trim: drop the head of whichever ring runs >50 ms ahead.
            if mic_len > app_len + MAX_DESYNC and app_len > 0:
                state.mic_ring.trim_front(mic_len - app_len - MAX_DESYNC)
            elif app_len > mic_len + MAX_DESYNC:
                state.app_ring.trim_front(app_len - mic_len - MAX_DESYNC)

            mic = state.mic_ring.pop(MIX_FRAME)
            if mic.size < MIX_FRAME:
                mic = np.pad(mic, (0, MIX_FRAME - mic.size))
            app = state.app_ring.pop(MIX_FRAME)
            if app.size < MIX_FRAME:  # zero-fill missing app audio
                app = np.pad(app, (0, MIX_FRAME - app.size))
            mixed = mic + app  # dual-mono: same signal on L and R
            with state._lock:
                if state.writer is not None:
                    state.writer.write_samples(mixed, mixed)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def do_start_recording(state: RecordingState, app_source: Optional[AudioSource] = None,
                       recordings_dir: Optional[Path] = None) -> Path:
    """Start capture + mixer; returns the output path (commands/recording.rs:43-126)."""
    with state._lock:
        if state.writer is not None:
            raise RuntimeError("recording already in progress")
        out_dir = paths.ensure_dir(Path(recordings_dir) if recordings_dir else paths.recordings_dir())
        name = datetime.now().strftime("recording_%Y%m%d_%H%M%S.wav")
        path = out_dir / name
        state.writer = _make_writer(path)
        state.writer_path = path
    state.mic_ring.clear()
    state.app_ring.clear()
    state.active.set()
    if app_source is not None:
        try:
            app_source.start(state.app_ring.push)
            state.app_source = app_source
        except Exception:
            state.app_source = None  # degrade to mic-only (:90-93)
    state.worker = start_recording_worker(state)
    return path


def do_stop_recording(state: RecordingState) -> str:
    """Stop capture, drain, finalize; returns the path (commands/recording.rs:128-186)."""
    if state.app_source is not None:
        state.app_source.stop()
        state.app_source = None
    state.app_ring.clear()
    state.active.clear()
    if state.worker is not None:
        state.worker.join(timeout=10)
        state.worker = None
    with state._lock:
        if state.writer is None:
            raise RuntimeError("no recording in progress")
        path = state.writer.finalize()
        state.writer = None
        state.writer_path = None
    return str(path)


def is_recording(state: RecordingState) -> bool:
    with state._lock:
        return state.writer is not None


# R7 analog: app-audio sources are pluggable on a server (no
# ScreenCaptureKit/WASAPI); registered virtual apps enumerate exactly like
# the reference's SCShareableContent/Toolhelp32 lists, with the mic-only
# fallback entry always present (recording.rs:136-192).
_RECORDABLE_SOURCES: Dict[str, Tuple[str, Callable[[], AudioSource]]] = {}


def register_recordable_app(app_id: str, name: str,
                            factory: Callable[[], AudioSource]) -> None:
    """Register a virtual recordable app (id → AudioSource factory)."""
    _RECORDABLE_SOURCES[app_id] = (name, factory)


def unregister_recordable_app(app_id: str) -> None:
    _RECORDABLE_SOURCES.pop(app_id, None)


def get_recordable_apps() -> List[RecordableApp]:
    apps = [RecordableApp(id=aid, name=name, bundle_id=aid)
            for aid, (name, _f) in sorted(_RECORDABLE_SOURCES.items())]
    return apps + [RecordableApp(id="", name="None (Mic only)", bundle_id="")]


def resolve_app_source(app_id: str) -> Optional[AudioSource]:
    """app_id → a fresh AudioSource (the bundle_id→PID resolution analog,
    commands/recording.rs:52-63); unknown/empty ids mean mic-only."""
    entry = _RECORDABLE_SOURCES.get(app_id)
    return entry[1]() if entry else None


# ---------------------------------------------------------------------------
# CRUD (commands/recording.rs:470-602)
# ---------------------------------------------------------------------------

def ensure_in_recordings_dir(path, recordings_dir: Optional[Path] = None) -> Path:
    base = (Path(recordings_dir) if recordings_dir else paths.recordings_dir()).resolve()
    p = Path(path).resolve()
    if base != p and base not in p.parents:
        raise PermissionError(f"path escapes recordings dir: {path}")
    return p


def get_recordings(state: Optional[RecordingState] = None,
                   recordings_dir: Optional[Path] = None) -> List[dict]:
    out_dir = Path(recordings_dir) if recordings_dir else paths.recordings_dir()
    if not out_dir.exists():
        return []
    active = str(state.writer_path) if state and state.writer_path else None
    out = []
    for p in out_dir.iterdir():
        if p.suffix != ".wav":
            continue
        if active and str(p) == active:
            continue  # hide the in-progress file
        st = p.stat()
        out.append({
            "name": p.name,
            "path": str(p),
            "size": st.st_size,
            # mtime, not ctime: Linux ctime is inode-change time, which a
            # rename bumps — a renamed old recording must not jump to the
            # top of the newest-first list
            "created": int(st.st_mtime),
            "duration_seconds": wavio.get_wav_duration(p),
        })
    out.sort(key=lambda r: r["created"], reverse=True)
    return out


def rename_recording(path: str, new_name: str,
                     recordings_dir: Optional[Path] = None) -> str:
    from . import transcription as tr

    p = Path(path)
    if not p.exists():
        raise FileNotFoundError("Recording not found")
    ensure_in_recordings_dir(p, recordings_dir)
    new_name = new_name.strip()
    if not new_name:
        raise ValueError("Name cannot be empty")
    if "/" in new_name or "\\" in new_name or os.sep in new_name:
        raise ValueError("Name cannot contain path separators")
    base = Path(new_name).stem or new_name
    new_path = p.parent / f"{base}.wav"
    if new_path == p:
        return str(p)
    if new_path.exists():
        raise FileExistsError("A file with this name already exists")
    p.rename(new_path)
    # Move sidecars to the new hash key (rename_recording, :568-597).
    for pathfn in (tr.transcription_result_path, tr.transcription_metadata_path,
                   tr.transcription_chat_history_path):
        old_side = pathfn(str(p))
        new_side = pathfn(str(new_path))
        if old_side.exists() and old_side != new_side:
            old_side.rename(new_side)
    return str(new_path)


def delete_recording(path: str, recordings_dir: Optional[Path] = None) -> None:
    p = ensure_in_recordings_dir(Path(path), recordings_dir)
    p.unlink()
