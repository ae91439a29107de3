"""The port's SentencePiece vocabulary (crispy_tpu_torch.models.spm) against
the JAX package's: byte-equal ``build_model_bytes``, and ``decode``,
``encode``, ``id`` and the parsed pieces equal on the cases of
tests/test_spm.py."""

import numpy as np
import pytest

from crispy_tpu_torch.models import spm as tspm

try:  # the reference
    from crispy_tpu.models import spm as jspm
except ImportError:
    jspm = None
needs_jax = pytest.mark.skipif(jspm is None, reason="the JAX reference is not installed")


def _vocab():
    pieces = ["<unk>", "<s>", "</s>", "▁hello", "▁wor", "ld", "▁", "a", "b"]
    types = [tspm.UNKNOWN, tspm.CONTROL, tspm.CONTROL] + [tspm.NORMAL] * 6
    for i in range(256):
        pieces.append(f"<0x{i:02X}>")
        types.append(tspm.BYTE)
    return pieces, types


def _pair():
    pieces, types = _vocab()
    data = tspm.build_model_bytes(pieces, types)
    return tspm.SentencePieceVocab.from_bytes(data), jspm.SentencePieceVocab.from_bytes(data)


@needs_jax
def test_model_bytes_are_byte_equal():
    pieces, types = _vocab()
    assert tspm.build_model_bytes(pieces, types) == jspm.build_model_bytes(pieces, types)
    long = ["▁" + "x" * 200, "€", "<0xE2>"]  # multi-byte varints and UTF-8
    assert tspm.build_model_bytes(long, [1, 4, 6]) == jspm.build_model_bytes(long, [1, 4, 6])


@needs_jax
def test_parsed_pieces_and_types_equal():
    t, j = _pair()
    assert t.pieces == j.pieces and t.types == j.types and len(t) == len(j)
    assert [t.is_control(i) for i in range(-1, 12)] == [j.is_control(i) for i in range(-1, 12)]


@needs_jax
@pytest.mark.parametrize("ids", [
    [1, 3, 4, 5, 2],  # <s> ▁hello ▁wor ld </s>
    [3] + [9 + b for b in "€".encode("utf-8")],  # byte pieces decoded as UTF-8
    [9 + 0xE2, 3, 9 + 0x82],  # an interrupted and a dangling byte run
    [0, 6, 7, 8, 999, -1],  # unknown, bare meta-space, out of range
    [],
])
def test_decode_equal(ids):
    t, j = _pair()
    assert t.decode(ids) == j.decode(ids)
    assert t.decode(np.asarray(ids, np.int64)) == j.decode(ids)


@needs_jax
@pytest.mark.parametrize("text", ["hello world", "hello é", "ab ba", "", "€ hello"])
def test_encode_equal(text):
    t, j = _pair()
    assert t.encode(text) == j.encode(text)
    assert t.decode(t.encode(text)) == j.decode(j.encode(text))


@needs_jax
def test_load_and_id_equal(tmp_path):
    pieces, types = _vocab()
    p = tmp_path / "tokenizer.model"
    p.write_bytes(tspm.build_model_bytes(pieces, types))
    t, j = tspm.SentencePieceVocab.load(p), jspm.SentencePieceVocab.load(p)
    for piece in ("▁hello", "ld", "<0x41>", "missing"):
        assert t.id(piece) == j.id(piece)
    assert t.decode([3, 4, 5]) == "hello world"


def test_rejects_non_spm():
    with pytest.raises(ValueError, match="no sentencepiece"):
        tspm.SentencePieceVocab.from_bytes(b"")
