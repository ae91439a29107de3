"""WAV codec: RIFF chunk-walking reader and s16/f32 writer.

The PyTorch port's own copy of ``crispy_tpu/io/wav.py`` (``read_format``,
``get_wav_duration``, ``read_wav``, ``read_wav_mono``, the streaming reader
``iter_wav_blocks``, ``write_wav`` and the incremental stereo writer
``WavWriter``); the port imports nothing of the JAX package. The reader walks RIFF chunks tolerant of LIST/INFO chunks and
truncated files (src-tauri/src/commands/recording.rs:384-460); the writers
clamp and scale by 32767 like the reference's recording writer
(src-tauri/src/recording.rs:108-112). All host-side NumPy.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional, Tuple, Union

import numpy as np

PathLike = Union[str, Path]

SAMPLE_RATE = 48000  # recording.rs:8
CHANNELS = 2  # recording.rs:9


@dataclass
class WavFormat:
    num_channels: int
    sample_rate: int
    bits_per_sample: int
    audio_format: int  # 1 = PCM int, 3 = IEEE float
    data_offset: int
    data_size: int


def _walk_chunks(f: io.BufferedIOBase) -> Optional[WavFormat]:
    """Walk RIFF chunks looking for fmt + data (commands/recording.rs:406-440)."""
    header = f.read(12)
    if len(header) < 12 or header[0:4] != b"RIFF" or header[8:12] != b"WAVE":
        return None
    num_channels = sample_rate = bits = audio_format = 0
    while True:
        chunk_header = f.read(8)
        if len(chunk_header) < 8:
            return None
        chunk_id = chunk_header[0:4]
        (chunk_size,) = struct.unpack("<I", chunk_header[4:8])
        # RIFF: chunks are word-aligned — an odd-sized chunk is followed by
        # a pad byte NOT counted in chunk_size. (The reference's parser
        # skips only chunk_size, recording.rs:437; spec-conformant WAVs
        # with odd LIST/INFO chunks would misparse there — fixed here.)
        pad = chunk_size & 1
        if chunk_id == b"fmt ":
            fmt_data = f.read(chunk_size + pad)
            if len(fmt_data) < 16:
                return None
            audio_format, num_channels = struct.unpack("<HH", fmt_data[0:4])
            (sample_rate,) = struct.unpack("<I", fmt_data[4:8])
            (bits,) = struct.unpack("<H", fmt_data[14:16])
        elif chunk_id == b"data":
            if sample_rate == 0 or bits == 0 or num_channels == 0:
                return None
            return WavFormat(
                num_channels=num_channels,
                sample_rate=sample_rate,
                bits_per_sample=bits,
                audio_format=audio_format,
                data_offset=f.tell(),
                data_size=chunk_size,
            )
        else:
            # Skip unknown chunk (LIST, INFO, ...) including its pad byte.
            f.seek(chunk_size + pad, io.SEEK_CUR)


def read_format(path: PathLike) -> Optional[WavFormat]:
    try:
        with open(path, "rb") as f:
            return _walk_chunks(f)
    except OSError:
        return None


def get_wav_duration(path: PathLike) -> Optional[float]:
    """Duration in seconds from the header, or None if unparseable
    (commands/recording.rs:384-460)."""
    fmt = read_format(path)
    if fmt is None or fmt.data_size == 0:  # the reference's parser rejects
        return None                        # empty data chunks (recording.rs:427)
    bytes_per_sample = fmt.bits_per_sample // 8
    if bytes_per_sample == 0:
        return None
    num_frames = fmt.data_size // (bytes_per_sample * fmt.num_channels)
    return num_frames / fmt.sample_rate


def _decode(raw: bytes, fmt: WavFormat) -> np.ndarray:
    """Decode raw PCM bytes → float32 array shaped (frames, channels) in [-1, 1]."""
    width = max(fmt.bits_per_sample // 8, 1)
    if len(raw) % width:  # truncated mid-sample: decode the complete ones
        raw = raw[: len(raw) - (len(raw) % width)]
    if fmt.audio_format == 3 and fmt.bits_per_sample == 32:
        data = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    elif fmt.audio_format == 1 and fmt.bits_per_sample == 16:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif fmt.audio_format == 1 and fmt.bits_per_sample == 32:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif fmt.audio_format == 1 and fmt.bits_per_sample == 8:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(
            f"Unsupported WAV format: audio_format={fmt.audio_format}, "
            f"bits={fmt.bits_per_sample}"
        )
    frames = len(data) // fmt.num_channels
    return data[: frames * fmt.num_channels].reshape(frames, fmt.num_channels)


def read_wav(path: PathLike) -> Tuple[np.ndarray, int]:
    """Read a whole WAV → (float32 (frames, channels) in [-1,1], sample_rate)."""
    fmt = read_format(path)
    if fmt is None:
        raise ValueError(f"Not a valid WAV file: {path}")
    with open(path, "rb") as f:
        f.seek(fmt.data_offset)
        raw = f.read(fmt.data_size)
    return _decode(raw, fmt), fmt.sample_rate


def read_wav_mono(path: PathLike, channel: int = 0) -> Tuple[np.ndarray, int]:
    """Read one channel (reference reads channel 0 —
    commands/transcription.rs:308-312)."""
    data, rate = read_wav(path)
    return np.ascontiguousarray(data[:, min(channel, data.shape[1] - 1)]), rate


def iter_wav_blocks(
    path: PathLike, block_frames: int = 65536
) -> Iterator[Tuple[np.ndarray, int]]:
    """Stream (float32 (frames, channels), sample_rate) blocks without loading
    the whole file — the streaming-read analog of commands/transcription.rs:304-345."""
    fmt = read_format(path)
    if fmt is None:
        raise ValueError(f"Not a valid WAV file: {path}")
    bytes_per_frame = (fmt.bits_per_sample // 8) * fmt.num_channels
    remaining = fmt.data_size
    with open(path, "rb") as f:
        f.seek(fmt.data_offset)
        while remaining > 0:
            n = min(block_frames * bytes_per_frame, remaining)
            n -= n % bytes_per_frame
            if n == 0:
                break
            raw = f.read(n)
            if not raw:
                break
            remaining -= len(raw)
            yield _decode(raw, fmt), fmt.sample_rate


def write_wav(
    path: PathLike,
    data: np.ndarray,
    sample_rate: int = SAMPLE_RATE,
    *,
    dtype: str = "i16",
) -> Path:
    """Write float32 samples in [-1, 1] as PCM WAV.

    ``data`` may be (frames,) mono or (frames, channels). i16 conversion uses
    clamp + ×32767 to match the reference writer (recording.rs:108-112).
    """
    data = np.asarray(data)
    if data.dtype != np.int16:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = data[:, None]
    frames, channels = data.shape
    if dtype == "i16":
        if data.dtype == np.int16:
            pcm = data.astype("<i2")  # already-quantized PCM passthrough
        else:
            pcm = (np.clip(data, -1.0, 1.0) * 32767.0).astype("<i2")
        bits, audio_format = 16, 1
    elif dtype == "f32":
        if data.dtype == np.int16:
            data = data.astype(np.float32) / 32768.0
        pcm = data.astype("<f4")
        bits, audio_format = 32, 3
    else:
        raise ValueError(f"Unsupported dtype: {dtype}")
    payload = pcm.tobytes()
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(
            struct.pack(
                "<IHHIIHH", 16, audio_format, channels, sample_rate, byte_rate,
                block_align, bits,
            )
        )
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)
    return Path(path)


class WavWriter:
    """Incremental stereo s16 writer (recording.rs:78-134).

    ``write_samples(left, right)`` interleaves two equal-length float32 channel
    blocks; ``finalize()`` patches the RIFF sizes and closes the file.
    """

    def __init__(self, output_path: PathLike, sample_rate: int = SAMPLE_RATE,
                 channels: int = CHANNELS):
        self.output_path = Path(output_path)
        self.sample_rate = sample_rate
        self.channels = channels
        self._f = open(self.output_path, "wb")
        self._data_bytes = 0
        self._finalized = False
        # Placeholder header; sizes patched in finalize().
        self._f.write(b"RIFF" + struct.pack("<I", 36) + b"WAVE")
        self._f.write(b"fmt ")
        self._f.write(
            struct.pack(
                "<IHHIIHH", 16, 1, channels, sample_rate,
                sample_rate * channels * 2, channels * 2, 16,
            )
        )
        self._f.write(b"data" + struct.pack("<I", 0))

    def write_samples(self, left: np.ndarray, right: np.ndarray) -> None:
        left = np.asarray(left, dtype=np.float32)
        right = np.asarray(right, dtype=np.float32)
        if left.shape != right.shape or left.ndim != 1:
            raise ValueError("Left and right channel length mismatch")
        # recording.rs:108-112 conversion. NOTE: the reference casts with Rust
        # `as i16` (truncation toward zero); we match that exactly.
        interleaved = np.empty(left.size * 2, dtype=np.float32)
        interleaved[0::2] = left
        interleaved[1::2] = right
        pcm = np.trunc(np.clip(interleaved, -1.0, 1.0) * 32767.0).astype("<i2")
        payload = pcm.tobytes()
        self._f.write(payload)
        self._data_bytes += len(payload)

    def finalize(self) -> Path:
        if self._finalized:
            return self.output_path
        self._f.seek(4)
        self._f.write(struct.pack("<I", 36 + self._data_bytes))
        self._f.seek(40)
        self._f.write(struct.pack("<I", self._data_bytes))
        self._f.close()
        self._finalized = True
        return self.output_path

    def __enter__(self) -> "WavWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.finalize()
