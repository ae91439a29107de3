"""SentencePiece vocabulary loader (no sentencepiece dependency).

The port's copy of ``crispy_tpu/models/spm.py``; the protobuf field reader
(``_fields``) is ``models/onnx_import``'s.

The reference's NeMo-family bundles (parakeet-tdt, canary, gigaam — served
by transcribe-rs per managers/transcription.rs:119-172) tokenize with
SentencePiece `.model` files. Transcription only needs id→text decoding
plus greedy encoding for prompts, so this walks the protobuf wire format
directly instead of shipping the sentencepiece runtime.

Wire subset: ModelProto.pieces = field 1 (repeated SentencePiece);
SentencePiece: piece = 1 (string), score = 2 (float), type = 3 (enum:
1 NORMAL, 2 UNKNOWN, 3 CONTROL, 4 USER_DEFINED, 5 UNUSED, 6 BYTE).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from .onnx_import import _fields

NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
_WS = "▁"  # the SentencePiece meta-space


@dataclass
class SentencePieceVocab:
    pieces: List[str]
    types: List[int]

    def __post_init__(self):
        self._byte_ids: Dict[int, int] = {}
        for i, (p, t) in enumerate(zip(self.pieces, self.types)):
            if t == BYTE and len(p) == 6 and p.startswith("<0x"):
                self._byte_ids[i] = int(p[3:5], 16)
        self._encoder: Optional[Dict[str, int]] = None

    def __len__(self) -> int:
        return len(self.pieces)

    @staticmethod
    def load(path) -> "SentencePieceVocab":
        return SentencePieceVocab.from_bytes(Path(path).read_bytes())

    @staticmethod
    def from_bytes(data: bytes) -> "SentencePieceVocab":
        pieces: List[str] = []
        types: List[int] = []
        for field, wire, val in _fields(memoryview(data)):
            if field != 1 or wire != 2:
                continue
            piece, ptype = "", NORMAL
            for f2, w2, v2 in _fields(val):
                if f2 == 1 and w2 == 2:
                    piece = bytes(v2).decode("utf-8", errors="replace")
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            pieces.append(piece)
            types.append(ptype)
        if not pieces:
            raise ValueError("no sentencepiece pieces found (not a .model file?)")
        return SentencePieceVocab(pieces, types)

    # -- decode ---------------------------------------------------------------
    def is_control(self, tid: int) -> bool:
        return 0 <= tid < len(self.types) and self.types[tid] in (CONTROL, UNKNOWN)

    def decode(self, ids: Sequence[int]) -> str:
        out: List[str] = []
        pending: List[int] = []  # byte-piece run, decoded together as UTF-8

        def flush():
            if pending:
                out.append(bytes(pending).decode("utf-8", errors="replace"))
                pending.clear()

        for t in ids:
            t = int(t)
            if t in self._byte_ids:
                pending.append(self._byte_ids[t])
                continue
            flush()
            if self.is_control(t) or not (0 <= t < len(self.pieces)):
                continue
            out.append(self.pieces[t])
        flush()
        return "".join(out).replace(_WS, " ").lstrip(" ")

    # -- encode (greedy longest-match; prompts/round-trip tests only) ---------
    def encode(self, text: str) -> List[int]:
        if self._encoder is None:
            self._encoder = {p: i for i, p in enumerate(self.pieces)
                             if self.types[i] in (NORMAL, USER_DEFINED)}
        s = _WS + text.replace(" ", _WS)
        ids: List[int] = []
        i = 0
        max_len = max((len(p) for p in self._encoder), default=1)
        while i < len(s):
            for ln in range(min(max_len, len(s) - i), 0, -1):
                tid = self._encoder.get(s[i: i + ln])
                if tid is not None:
                    ids.append(tid)
                    i += ln
                    break
            else:  # unknown char: emit its UTF-8 bytes if byte fallback exists
                rev = {v: k for k, v in self._byte_ids.items()}
                for b in s[i].encode("utf-8"):
                    if b in rev:
                        ids.append(rev[b])
                i += 1
        return ids

    def id(self, piece: str) -> Optional[int]:
        try:
            return self.pieces.index(piece)
        except ValueError:
            return None


def build_model_bytes(pieces: Sequence[str], types: Sequence[int]) -> bytes:
    """Serialize a minimal SentencePiece ModelProto (tests / bundle prep)."""
    def varint(n: int) -> bytes:
        out = bytearray()
        while True:
            b = n & 0x7F
            n >>= 7
            out.append(b | (0x80 if n else 0))
            if not n:
                return bytes(out)

    body = bytearray()
    for p, t in zip(pieces, types):
        pb = p.encode("utf-8")
        sub = b"\x0a" + varint(len(pb)) + pb  # field 1, wire 2
        sub += b"\x15" + b"\x00\x00\x00\x00"  # field 2 (score), wire 5
        sub += b"\x18" + varint(t)  # field 3, wire 0
        body += b"\x0a" + varint(len(sub)) + sub  # ModelProto field 1
    return bytes(body)
