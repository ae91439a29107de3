"""The C++ host tier, bound with ctypes (the port's copy of
``crispy_tpu/runtime/__init__.py``).

``native/crispy_runtime.cpp`` holds the reference's real-time host runtime:
bounded audio rings, the dual-mono mixer step, the streaming linear
resampler, an incremental WAV writer and the RMS meter. This module compiles
it with ``g++`` at first use into ``crispy_tpu_torch/_build/`` (listed in
``.gitignore``), under a name that hashes the source, and loads it. Where
``g++`` or the source is missing, ``available()`` is False and the recording
engine takes its pure-Python ring and writer instead; ``rms`` computes in
NumPy. This is host code: no device path depends on it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "native" / "crispy_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_BUILD_FAILED = False

_F32P = ctypes.POINTER(ctypes.c_float)


def build_library() -> Optional[Path]:
    """Compile the runtime library unless one of this source exists; returns
    its path, or None without the source. A failed ``g++`` raises."""
    if not _SRC.exists():
        return None
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libcrispy_runtime_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix="runtime-", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                               "-o", tmp, str(_SRC)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed: {proc.stderr[-800:]}")
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> Optional[ctypes.CDLL]:
    """The runtime library, built on first use; None when ``g++`` or the
    source is unavailable (callers then take the Python versions)."""
    global _LIB, _BUILD_FAILED
    with _LOCK:
        if _LIB is not None or _BUILD_FAILED:
            return _LIB
        if shutil.which("g++") is None:
            _BUILD_FAILED = True
            return None
        try:
            so = build_library()
            lib = ctypes.CDLL(str(so)) if so is not None else None
        except (OSError, RuntimeError):
            lib = None
        if lib is None:
            _BUILD_FAILED = True
            return None
        lib.ring_new.restype = ctypes.c_void_p
        lib.ring_new.argtypes = [ctypes.c_size_t]
        lib.ring_free.argtypes = [ctypes.c_void_p]
        lib.ring_len.restype = ctypes.c_size_t
        lib.ring_len.argtypes = [ctypes.c_void_p]
        lib.ring_clear.argtypes = [ctypes.c_void_p]
        lib.ring_push.argtypes = [ctypes.c_void_p, _F32P, ctypes.c_size_t]
        lib.ring_pop.restype = ctypes.c_size_t
        lib.ring_pop.argtypes = [ctypes.c_void_p, _F32P, ctypes.c_size_t]
        lib.ring_trim_front.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        lib.mixer_step.restype = ctypes.c_int
        lib.mixer_step.argtypes = [ctypes.c_void_p, ctypes.c_void_p, _F32P,
                                   ctypes.c_size_t, ctypes.c_size_t]
        lib.resampler_new.restype = ctypes.c_void_p
        lib.resampler_new.argtypes = [ctypes.c_float, ctypes.c_float]
        lib.resampler_free.argtypes = [ctypes.c_void_p]
        lib.resampler_set_rates.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_float]
        lib.resampler_process.restype = ctypes.c_size_t
        lib.resampler_process.argtypes = [ctypes.c_void_p, _F32P, ctypes.c_size_t,
                                          _F32P, ctypes.c_size_t]
        lib.wav_open.restype = ctypes.c_void_p
        lib.wav_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint16]
        lib.wav_write_stereo.restype = ctypes.c_int
        lib.wav_write_stereo.argtypes = [ctypes.c_void_p, _F32P, _F32P, ctypes.c_size_t]
        lib.wav_finalize.restype = ctypes.c_int
        lib.wav_finalize.argtypes = [ctypes.c_void_p]
        lib.rms_level.restype = ctypes.c_float
        lib.rms_level.argtypes = [_F32P, ctypes.c_size_t]
        _LIB = lib
        return _LIB


def available() -> bool:
    return load() is not None


def _as_f32p(a: np.ndarray):
    """A float pointer into ``a``, which must already be contiguous float32:
    the caller keeps ``a`` alive across the native call."""
    return a.ctypes.data_as(_F32P)


def _f32(samples) -> np.ndarray:
    return np.ascontiguousarray(samples, np.float32).ravel()


class NativeRing:
    """Bounded mono sample ring (drop-oldest), the twin of
    ``engine.recording.RingBuffer``."""

    def __init__(self, capacity: int):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        self._h = self._lib.ring_new(capacity)

    def push(self, samples: np.ndarray) -> None:
        s = _f32(samples)
        self._lib.ring_push(self._h, _as_f32p(s), s.size)

    def pop(self, n: int) -> np.ndarray:
        out = np.empty(n, np.float32)
        got = self._lib.ring_pop(self._h, _as_f32p(out), n)
        return out[:got]

    def trim_front(self, n: int) -> None:
        self._lib.ring_trim_front(self._h, n)

    def clear(self) -> None:
        self._lib.ring_clear(self._h)

    def __len__(self) -> int:
        return self._lib.ring_len(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ring_free(self._h)
            self._h = None


class NativeLinearResampler:
    """ctypes twin of ``dsp.resample.LinearResampler`` (same emission pattern)."""

    def __init__(self, input_rate: float, output_rate: float):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        self._h = self._lib.resampler_new(input_rate, output_rate)
        self._ratio = max(output_rate / max(input_rate, 1e-9), 1.0)

    def set_rates(self, input_rate: float, output_rate: float) -> None:
        self._lib.resampler_set_rates(self._h, input_rate, output_rate)
        self._ratio = max(output_rate / max(input_rate, 1e-9), 1.0)

    def process(self, samples: np.ndarray) -> np.ndarray:
        x = _f32(samples)
        cap = int(x.size * self._ratio) + 8
        out = np.empty(cap, np.float32)
        got = self._lib.resampler_process(self._h, _as_f32p(x), x.size, _as_f32p(out), cap)
        return out[:got]

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.resampler_free(self._h)
            self._h = None


def mixer_step(mic: NativeRing, app: NativeRing, frame_len: int, max_desync: int):
    """One mixer frame from the two rings (desync trim, zero fill, mic + app),
    or None while the mic ring holds less than a frame."""
    lib = load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    out = np.empty(frame_len, np.float32)
    ok = lib.mixer_step(mic._h, app._h, _as_f32p(out), frame_len, max_desync)
    return out if ok else None


class NativeWavWriter:
    """ctypes twin of ``io.wav.WavWriter`` (the same bytes)."""

    def __init__(self, path, sample_rate: int = 48000, channels: int = 2):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        self.output_path = Path(path)
        self._h = self._lib.wav_open(str(path).encode(), sample_rate, channels)
        if not self._h:
            raise IOError(f"cannot open {path}")

    def write_samples(self, left: np.ndarray, right: np.ndarray) -> None:
        l, r = _f32(left), _f32(right)
        if l.size != r.size:
            raise ValueError("Left and right channel length mismatch")
        self._lib.wav_write_stereo(self._h, _as_f32p(l), _as_f32p(r), l.size)

    def finalize(self) -> Path:
        if self._h:
            self._lib.wav_finalize(self._h)
            self._h = None
        return self.output_path


def rms(samples: np.ndarray) -> float:
    """Root mean square of a block (native, or NumPy in float64 without it)."""
    lib = load()
    x = _f32(samples)
    if lib is None:
        return float(np.sqrt(np.mean(x.astype(np.float64) ** 2))) if x.size else 0.0
    return float(lib.rms_level(_as_f32p(x), x.size))
