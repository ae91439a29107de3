"""The port's WAV codec (crispy_tpu_torch.io.wav): the cases of
tests/test_wav.py run against the port, and every file they decode is
decoded by the JAX package's codec too, sample for sample equal.
"""

import struct

import numpy as np
import pytest

from crispy_tpu_torch.io import wav

try:  # the reference; the card's machine has no JAX and runs only the gpu tests
    from crispy_tpu.io import wav as jwav
except ImportError:
    jwav = None
needs_jax = pytest.mark.skipif(jwav is None, reason="the JAX reference is not installed")


def _write_fixture(path, sample_rate=48000, channels=2, bits=16, data_size=None,
                   extra_chunk=True, truncate=False):
    """Hand-built WAV bytes (commands/recording.rs:610-647)."""
    n_data = data_size if data_size is not None else sample_rate * channels * (bits // 8)
    body = b"WAVE"
    body += b"fmt " + struct.pack(
        "<IHHIIHH", 16, 1, channels, sample_rate,
        sample_rate * channels * bits // 8, channels * bits // 8, bits)
    if extra_chunk:
        body += b"LIST" + struct.pack("<I", 10) + b"INFOxxxxxx"
    if not truncate:
        body += b"data" + struct.pack("<I", n_data) + b"\x00" * n_data
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(body)) + body)
    return path


def _odd_list_chunk_wav(path):
    """An odd-sized LIST chunk followed by its pad byte, before fmt and data."""
    data = (np.sin(np.arange(480) / 10) * 0.5).astype(np.float32)
    pcm = (data * 32767).astype("<i2").tobytes()
    odd_payload = b"INFOx"  # 5 bytes: odd → pad byte follows
    chunks = b"LIST" + struct.pack("<I", len(odd_payload)) + odd_payload + b"\x00"
    fmt = struct.pack("<HHIIHH", 1, 1, 48000, 96000, 2, 16)
    body = (b"WAVE" + chunks
            + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(pcm)) + pcm)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


def assert_same_decode(path):
    """The port and the JAX package decode the file to the same samples."""
    got, rate = wav.read_wav(path)
    if jwav is not None:
        want, jrate = jwav.read_wav(path)
        assert rate == jrate
        np.testing.assert_array_equal(got, want)
    return got, rate


class TestDuration:
    @pytest.mark.parametrize("sample_rate", [48000, 44100])
    def test_extra_list_chunk_skipped(self, tmp_path, sample_rate):
        p = _write_fixture(tmp_path / "b.wav", sample_rate=sample_rate, extra_chunk=True)
        assert wav.get_wav_duration(p) == pytest.approx(1.0)
        data, rate = assert_same_decode(p)
        assert rate == sample_rate and data.shape == (sample_rate, 2)

    def test_truncated_header(self, tmp_path):
        p = _write_fixture(tmp_path / "c.wav", truncate=True)
        assert wav.get_wav_duration(p) is None
        assert wav.read_format(p) is None
        with pytest.raises(ValueError, match="Not a valid WAV"):
            list(wav.iter_wav_blocks(p))

    def test_not_riff_and_missing(self, tmp_path):
        p = tmp_path / "d.wav"
        p.write_bytes(b"JUNKJUNKJUNKJUNK")
        assert wav.get_wav_duration(p) is None
        assert wav.get_wav_duration(tmp_path / "nope.wav") is None

    def test_zero_data(self, tmp_path):
        p = _write_fixture(tmp_path / "e.wav", data_size=0)
        assert wav.get_wav_duration(p) is None


def test_odd_sized_list_chunk_with_pad_byte(tmp_path):
    p = _odd_list_chunk_wav(tmp_path / "odd.wav")
    audio, sr = assert_same_decode(p)
    assert sr == 48000 and audio.shape[0] == 480
    assert abs(wav.get_wav_duration(p) - 480 / 48000) < 1e-9


@pytest.mark.parametrize("cut", [1, 3])
def test_truncated_mid_sample_decodes_complete_frames(tmp_path, cut):
    data = (np.sin(np.arange(480) / 7) * 0.5).astype(np.float32)
    p = wav.write_wav(tmp_path / "t.wav", data, 48000)
    p.write_bytes(p.read_bytes()[:-cut])  # cut mid-sample
    audio, sr = assert_same_decode(p)
    assert sr == 48000 and audio.shape[0] == (2 * 480 - cut) // 2  # whole 16-bit frames
    blocks = [b for b, _ in wav.iter_wav_blocks(p, block_frames=100)]
    np.testing.assert_array_equal(np.concatenate(blocks), audio)


@pytest.mark.parametrize("dtype,channels", [("f32", 2), ("i16", 2), ("i16", 1)])
def test_streaming_blocks_match_full_read(tmp_path, rng, dtype, channels):
    data = rng.uniform(-1, 1, size=(10_000, channels)).astype(np.float32)
    p = wav.write_wav(tmp_path / "blk.wav", data, 48000, dtype=dtype)
    blocks = list(wav.iter_wav_blocks(p, block_frames=777))
    assert all(r == 48000 for _, r in blocks)
    assert [b.shape[0] for b, _ in blocks[:-1]] == [777] * (len(blocks) - 1)
    full, _ = assert_same_decode(p)
    np.testing.assert_array_equal(np.concatenate([b for b, _ in blocks]), full)
    if jwav is not None:
        for (got, _), (want, _) in zip(blocks, jwav.iter_wav_blocks(p, block_frames=777),
                                       strict=True):
            np.testing.assert_array_equal(got, want)


@needs_jax
@pytest.mark.parametrize("dtype", ["i16", "f32"])
def test_written_bytes_equal_the_jax_writer(tmp_path, rng, dtype):
    data = rng.uniform(-1.2, 1.2, size=(4800, 2)).astype(np.float32)
    a = wav.write_wav(tmp_path / "port.wav", data, 48000, dtype=dtype)
    b = jwav.write_wav(tmp_path / "jax.wav", data, 48000, dtype=dtype)
    assert a.read_bytes() == b.read_bytes()
    mono, _ = wav.read_wav_mono(a)
    jmono, _ = jwav.read_wav_mono(b)
    np.testing.assert_array_equal(mono, jmono)
