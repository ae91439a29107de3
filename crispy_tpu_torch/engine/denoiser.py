"""Noise suppression: the streaming processors and the batch surface (the
port of ``crispy_tpu/engine/denoiser.py``).

Streaming, the push/pull contracts of src-tauri/src/audio.rs:
  * ``LegacyProcessor`` (the "dummy"/"noisy" models, audio.rs:47-200):
    volume, LCG noise on push and pull, pull-side linear resampling.
  * ``RnnNoiseProcessor`` (audio.rs:202-315): input resampling to 48 kHz,
    480-sample frames, each one step of ``GraphedBlockStep`` (the block step
    replayed from a CUDA graph on the card), first-frame drop, clip and
    volume, pull-side resampling.
  * ``NsState`` (audio.rs:317-358): model dispatch, hot swap, volume.

Batch: ``denoise_file`` and ``denoise_array`` run whole files, or batches of
streams, through ``pipeline.denoise_batch`` in fixed blocks.

Every entry point takes ``device=None``, which means the CUDA card; with no
card it raises. ``device="cpu"`` runs the plain PyTorch path.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..device import resolve_device
from ..dsp.resample import LinearResampler, PullResampler
from ..dsp.rnnoise import pipeline
from ..dsp.rnnoise.constants import FRAME_SIZE as FRAME
from ..dsp.rnnoise.graphed import GraphedBlockStep
from ..dsp.rnnoise.weights import RNNoiseModel
from ..io import wav as wavio


class _Lcg:
    """The legacy models' 32-bit LCG noise source (audio.rs:157-163)."""

    A = 1_664_525
    C = 1_013_904_223
    M = 1 << 32

    def __init__(self, seed: int = 0x1234_ABCD):
        self.state = np.uint32(seed)
        self._jump_n = 0
        self._a_pow = None
        self._c_geo = None

    def next_noise(self) -> float:
        self.state = np.uint32(
            (np.uint64(self.state) * np.uint64(self.A) + np.uint64(self.C))
            & np.uint64(0xFFFFFFFF)
        )
        return (float(self.state) / float(0xFFFFFFFF)) * 2.0 - 1.0

    def next_block(self, n: int) -> np.ndarray:
        """n sequential draws, vectorized via the closed form
        state_j = a^j s0 + c (a^{j-1} + ... + 1)  (mod 2^32) — bit-identical
        to n next_noise() calls, no per-sample Python loop."""
        if n <= 0:
            return np.zeros(0, np.float32)
        if self._jump_n != n:
            a_pow = np.empty(n, np.uint64)
            c_geo = np.empty(n, np.uint64)
            ap, geo = 1, 0
            for j in range(n):
                geo = (geo * self.A + 1) % self.M  # a^j + .. + 1 after j+1 steps
                ap = (ap * self.A) % self.M
                a_pow[j] = ap
                c_geo[j] = geo
            self._jump_n, self._a_pow, self._c_geo = n, a_pow, c_geo
        s0 = np.uint64(self.state)
        states = (self._a_pow * s0 + np.uint64(self.C) * self._c_geo) & np.uint64(0xFFFFFFFF)
        self.state = np.uint32(states[-1])
        return states.astype(np.float64) / float(0xFFFFFFFF) * 2.0 - 1.0  # f64


class LegacyProcessor:
    """`dummy` passthrough / `noisy` LCG-noise models (audio.rs:47-200)."""

    def __init__(self, input_rate: float, output_rate: float, kind: str, volume: float):
        self.kind = "noisy" if kind == "noisy" else "dummy"
        self.input_rate = float(input_rate)
        self.volume = float(volume)
        self._rng = _Lcg()
        self._pull = PullResampler(input_rate, output_rate, max_len=int(input_rate))

    def push_sample(self, sample: float) -> Optional[List[float]]:
        self._pull.push([sample])
        out = float(sample) * self.volume
        if self.kind == "noisy":
            out += self._rng.next_noise() * 0.05
        return [out]

    def push_block(self, samples: np.ndarray) -> Optional[np.ndarray]:
        """Vectorized block path — bit-identical to per-sample pushes
        (the LCG advances once per sample via its closed form)."""
        x = np.asarray(samples, np.float32).ravel()
        if x.size == 0:
            return None
        self._pull.push(x)
        out = x.astype(np.float64) * self.volume  # f64: match per-sample math
        if self.kind == "noisy":
            out = out + self._rng.next_block(x.size) * 0.05
        return out.astype(np.float32)

    @property
    def output_block_rate_hz(self) -> float:
        """True rate of push_block's return value (legacy models pass the
        input through at its own rate)."""
        return self.input_rate

    def next_sample(self) -> float:
        s = self._pull.next_sample_opt()
        if s is None:  # under-buffered: the reference returns 0.0 with no
            return 0.0  # noise draw and no volume scale (audio.rs:168-179)
        if self.kind == "noisy":
            s += self._rng.next_noise() * 0.05
        return s * self.volume

    @property
    def produced_rate_hz(self) -> float:
        return self.input_rate


class RnnNoiseProcessor:
    """Streaming RNNoise (audio.rs:202-315) over the block step.

    Buffers pushed samples into 480-sample frames; each full frame runs one
    single-frame step of ``GraphedBlockStep`` (state carried on the device).
    The first output frame is dropped (windowing warm-up), matching
    audio.rs:275-278. Building the processor captures the step's graph.
    """

    def __init__(self, input_rate: float, output_rate: float, volume: float,
                 model: Optional[RNNoiseModel] = None, params=None, device=None):
        if abs(input_rate - 48000.0) >= 1.0:
            self.input_resampler: Optional[LinearResampler] = LinearResampler(input_rate, 48000.0)
            self.input_rate = 48000.0
        else:
            self.input_resampler = None
            self.input_rate = float(input_rate)
        self.volume = float(np.clip(volume, 0.0, 1.0))
        self.first_frame = True
        self._in_buf = np.empty(0, np.float32)
        self._pull = PullResampler(self.input_rate, output_rate, max_len=int(self.input_rate))
        dev = resolve_device(device)
        self._params = params if params is not None else pipeline.make_params(model, dev)
        self._step = GraphedBlockStep(self._params, 1, 1, dev)

    def push_block(self, samples: np.ndarray) -> Optional[np.ndarray]:
        """Push a block of samples; returns denoised output when frames fill."""
        x = np.asarray(samples, dtype=np.float32).ravel()
        if self.input_resampler is not None:
            x = self.input_resampler.process(x)
        self._in_buf = np.concatenate([self._in_buf, x])
        n_frames = self._in_buf.shape[0] // FRAME
        if n_frames == 0:
            return None
        frames, self._in_buf = (
            self._in_buf[: n_frames * FRAME],
            self._in_buf[n_frames * FRAME:],
        )
        # One frame per step, always [1, 480]: one captured graph serves
        # every frame, and a burst of input never changes the step's shape.
        outs = [self._step.step(frames[None, f * FRAME:(f + 1) * FRAME]).numpy()[0]
                for f in range(n_frames)]
        out = np.clip(np.concatenate(outs), -1.0, 1.0) * self.volume
        if self.first_frame:
            self.first_frame = False
            out = out[FRAME:]
            if out.size == 0:
                return None
        self._pull.push(out)
        return out

    def push_sample(self, sample: float) -> Optional[List[float]]:
        out = self.push_block(np.array([sample], np.float32))
        return None if out is None else list(out)

    def next_sample(self) -> float:
        return self._pull.next_sample()

    @property
    def produced_rate_hz(self) -> float:
        return self.input_rate

    @property
    def output_block_rate_hz(self) -> float:
        """True rate of push_block's return value: NS always processes at
        48 kHz (the input resampler feeds it). produced_rate_hz mirrors the
        reference's field (audio.rs:355, "effective 48k when resampling is
        enabled"); the recording tap needs the honest rate."""
        return 48000.0


class NsState:
    """Model dispatch + hot swap (audio.rs:317-358, swap at :942-967)."""

    def __init__(self, model_name: str, input_rate: float, output_rate: float,
                 volume: float, rnn_model: Optional[RNNoiseModel] = None, device=None):
        self.model_name = model_name
        self.input_rate = input_rate
        self.output_rate = output_rate
        self._rnn_model = rnn_model
        self.device = resolve_device(device)  # the card unless told otherwise
        self._proc = self._build(model_name, volume)

    def _build(self, name: str, volume: float):
        # the reference's shipped id is "rnnnoise" (triple n —
        # commands/ns_models.rs:28, audio.rs:548); accept it and the
        # canonical spelling so settings migrated from the desktop app
        # don't silently degrade to the dummy passthrough
        if name in ("rnnoise", "rnnnoise"):
            return RnnNoiseProcessor(self.input_rate, self.output_rate, volume,
                                     model=self._rnn_model, device=self.device)
        return LegacyProcessor(self.input_rate, self.output_rate, name, volume)

    def set_model(self, name: str) -> None:
        if name != self.model_name:
            vol = self.volume
            proc = self._build(name, vol)
            if isinstance(proc, RnnNoiseProcessor):
                # the JAX package warms up BEFORE swapping in with a
                # silent frame (it consumes the first-frame drop and
                # advances the state); the port pushes the same frame so
                # the output sequences match (its graph was captured when
                # the processor was built)
                proc.push_block(np.zeros(480, np.float32))
            self.model_name = name
            self._proc = proc

    def push_sample(self, sample: float):
        return self._proc.push_sample(sample)

    def next_sample(self) -> float:
        return self._proc.next_sample()

    @property
    def volume(self) -> float:
        return self._proc.volume

    @volume.setter
    def volume(self, v: float) -> None:
        self._proc.volume = float(np.clip(v, 0.0, 1.0))

    @property
    def produced_rate_hz(self) -> float:
        return self._proc.produced_rate_hz


def denoise_array(
    audio: np.ndarray,
    model: Optional[RNNoiseModel] = None,
    drop_first_frame: bool = False,
    block_frames: int = 500,
    params=None,
    device=None,
) -> np.ndarray:
    """Denoise [T] or [S, T] float32 audio in [-1, 1].

    With ``drop_first_frame`` the warm-up frame is replaced by silence, the
    way the reference's streaming path never emits it.
    """
    out = pipeline.denoise_batch(audio, model=model, block_frames=block_frames,
                                 params=params, device=device)
    out = np.clip(out, -1.0, 1.0)
    if drop_first_frame:
        out[..., :FRAME] = 0.0
    return out


def denoise_file(
    in_path,
    out_path,
    model: Optional[RNNoiseModel] = None,
    block_frames: int = 500,
    device=None,
) -> dict:
    """WAV → denoised WAV (every channel processed as one batched stream).

    16-bit 48 kHz sources take the int16-wire path: PCM crosses to and from
    the device as int16 with bit-identical output — the decode scale is an
    exact power-of-two divide and the device quantization matches
    write_wav's. Other rates are first resampled to 48 kHz on the host.
    """
    fmt = wavio.read_format(in_path)
    audio, sr = wavio.read_wav(in_path)  # [frames, channels]
    if sr == 48000 and fmt is not None and fmt.bits_per_sample == 16:
        pcm = (audio.T * 32768.0).astype(np.int16)  # exact round-trip
        out16 = pipeline.denoise_batch(pcm, model=model, block_frames=block_frames,
                                       wire="i16", device=device)
        wavio.write_wav(out_path, out16.T, 48000)
        return {"channels": int(pcm.shape[0]), "samples": int(pcm.shape[1]),
                "sample_rate": 48000}
    if sr != 48000:
        from ..dsp.resample import resample_poly

        audio = np.stack([resample_poly(audio[:, c], sr, 48000)
                          for c in range(audio.shape[1])], axis=1)
    streams = audio.T.astype(np.float32)  # [channels, T]
    out = denoise_array(streams, model=model, block_frames=block_frames, device=device)
    wavio.write_wav(out_path, out.T, 48000)
    return {"channels": int(streams.shape[0]), "samples": int(streams.shape[1]),
            "sample_rate": 48000}
