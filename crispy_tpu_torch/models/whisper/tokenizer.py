"""Whisper tokenizer: decoding + special-token layout, fully offline.

The port's copy of ``crispy_tpu/models/whisper/tokenizer.py``.

Transcription only needs to *decode* (ids → text) plus build the SOT
prompt; vocabularies come from either the whisper.cpp ggml container (raw
byte strings, embedded in the model file the reference already downloads)
or a HuggingFace vocab.json (GPT-2 byte-level representation). Encoding is
needed only for initial-prompt conditioning and is provided greedily.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

# The 99 Whisper language codes in token-id order (public model metadata).
LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln ha "
    "ba jw su"
).split()

# large-v3 (n_vocab 51866) appends Cantonese, shifting every post-language
# special token up by one (whisper.cpp handles both layouts; so must we).
LANGUAGES_V3 = LANGUAGES + ["yue"]


def _gpt2_byte_decoder() -> Dict[str, int]:
    """The standard GPT-2 printable-unicode ↔ byte mapping."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


@dataclass
class WhisperTokenizer:
    vocab: List[bytes]  # id → raw bytes
    multilingual: bool = True
    num_languages: Optional[int] = None  # 99 (≤v2) or 100 (v3 adds 'yue')

    def __post_init__(self):
        if self.num_languages is None:
            # v3 detection from total vocab size (51866 = v3 multilingual).
            self.num_languages = (
                100 if self.multilingual and len(self.vocab) >= 51866 else 99)
        base = 50257 if self.multilingual else 50256
        self.eot = base
        self.sot = base + 1
        self.lang_base = base + 2
        self.translate = base + 2 + self.num_languages
        self.transcribe = self.translate + 1
        self.sot_lm = self.transcribe + 1
        self.sot_prev = self.sot_lm + 1
        self.no_speech = self.sot_prev + 1
        self.no_timestamps = self.no_speech + 1
        self.timestamp_begin = self.no_timestamps + 1
        self._encoder: Optional[Dict[bytes, int]] = None

    @property
    def languages(self) -> List[str]:
        return LANGUAGES_V3 if self.num_languages == 100 else LANGUAGES

    # -- construction ---------------------------------------------------------
    @staticmethod
    def from_ggml_vocab(vocab: List[bytes], n_vocab: int) -> "WhisperTokenizer":
        return WhisperTokenizer(
            vocab=list(vocab), multilingual=n_vocab != 51864,
            num_languages=100 if n_vocab >= 51866 else 99)

    @staticmethod
    def from_hf_dir(path, n_vocab: Optional[int] = None) -> "WhisperTokenizer":
        """Load vocab.json (GPT-2 byte-level strings) from a HF checkpoint.

        n_vocab (from the model config/embedding) pins the v2-vs-v3 special
        layout; vocab.json alone carries only the text tokens.
        """
        path = Path(path)
        with open(path / "vocab.json", encoding="utf-8") as f:
            v = json.load(f)
        dec = _gpt2_byte_decoder()
        vocab: List[bytes] = [b""] * (max(v.values()) + 1)
        for tok, idx in v.items():
            vocab[idx] = bytes(dec.get(ch, ord("?")) for ch in tok)
        num_languages = None
        if n_vocab is not None:
            num_languages = 100 if n_vocab >= 51866 else 99
        # multilingual from the MODEL's vocab size when known: English (.en)
        # checkpoints carry n_vocab=51864 but their GPT-2 vocab.json alone
        # (50257 entries) would pass a text-vocab-size test and misplace
        # eot/sot by one (garbage prompts). English models: n_vocab 51864;
        # multilingual: 51865 (v2) / 51866 (v3).
        if n_vocab is not None:
            multilingual = n_vocab != 51864
        else:
            multilingual = len(vocab) > 50257
        return WhisperTokenizer(vocab=vocab, multilingual=multilingual,
                                num_languages=num_languages)

    @staticmethod
    def dummy(n_vocab: int) -> "WhisperTokenizer":
        """Placeholder for random test models: id → '<id> '."""
        t = WhisperTokenizer(vocab=[f"<{i}>".encode() for i in range(n_vocab)],
                             multilingual=False)
        t.eot = n_vocab - 1
        t.sot = n_vocab - 2
        t.no_timestamps = n_vocab - 3
        t.timestamp_begin = n_vocab + 1  # none
        return t

    # -- prompt / decode ------------------------------------------------------
    def sot_sequence(self, language: str = "en", task: str = "transcribe",
                     timestamps: bool = False) -> List[int]:
        seq = [self.sot]
        if self.multilingual:
            try:
                seq.append(self.lang_base + self.languages.index(language))
            except ValueError:
                seq.append(self.lang_base)  # default en
            seq.append(self.transcribe if task == "transcribe" else self.translate)
        if not timestamps:
            seq.append(self.no_timestamps)
        return seq

    def is_special(self, tid: int) -> bool:
        return tid >= self.eot

    def decode(self, ids: Sequence[int], with_timestamps: bool = False) -> str:
        out = bytearray()
        for t in ids:
            t = int(t)
            if t >= self.timestamp_begin and with_timestamps:
                secs = (t - self.timestamp_begin) * 0.02
                out += f"<|{secs:.2f}|>".encode()
            elif self.is_special(t):
                continue
            elif 0 <= t < len(self.vocab):
                out += self.vocab[t]
        return out.decode("utf-8", errors="replace")

    def timestamp_seconds(self, tid: int) -> Optional[float]:
        if tid >= self.timestamp_begin:
            return (tid - self.timestamp_begin) * 0.02
        return None

    # -- greedy byte-pair-free encoding (prompt conditioning only) -----------
    def encode(self, text: str) -> List[int]:
        """Greedy longest-match over the vocab (not true BPE; used only for
        optional prompt conditioning, where exact merges don't matter)."""
        if self._encoder is None:
            self._encoder = {tok: i for i, tok in enumerate(self.vocab) if tok}
        data = text.encode("utf-8")
        ids: List[int] = []
        i = 0
        max_len = max((len(t) for t in self._encoder), default=1)
        while i < len(data):
            for ln in range(min(max_len, len(data) - i), 0, -1):
                tid = self._encoder.get(data[i: i + ln])
                if tid is not None:
                    ids.append(tid)
                    i += ln
                    break
            else:
                i += 1  # unencodable byte: skip
        return ids
