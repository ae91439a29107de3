"""Whisper family in PyTorch: encoder-decoder + KV-cached decoding.

The port of ``crispy_tpu/models/whisper/__init__.py``; replaces the
reference's whisper.cpp engine (managers/transcription.rs:124).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ...dsp.mel import log_mel_spectrogram
from .model import (
    CONFIGS, WhisperConfig, beam_decode, decode_logits, encode, greedy_decode,
    sample_decode,
)
from .tokenizer import WhisperTokenizer
from .weights import from_hf_state_dict, init_random, load_ggml, load_hf, params_to_module


class WhisperModel:
    """Weights in a ``Whisper`` module on one device + config + tokenizer,
    with a batched transcribe API. ``device=None`` is the card."""

    def __init__(self, params, cfg: WhisperConfig, tokenizer: WhisperTokenizer,
                 name: str = "whisper", device=None):
        self.device = resolve_device(device)
        self.model = params_to_module(params, cfg, self.device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.name = name

    # -- constructors ---------------------------------------------------------
    @staticmethod
    def from_ggml(path, name: Optional[str] = None, device=None) -> "WhisperModel":
        params, cfg, vocab, _filters = load_ggml(path)
        tok = WhisperTokenizer.from_ggml_vocab(vocab, cfg.n_vocab)
        return WhisperModel(params, cfg, tok, name or Path(path).stem, device)

    @staticmethod
    def from_hf(path, name: Optional[str] = None, device=None) -> "WhisperModel":
        params, cfg = load_hf(path)
        tok = WhisperTokenizer.from_hf_dir(path, n_vocab=cfg.n_vocab)
        return WhisperModel(params, cfg, tok, name or Path(path).name, device)

    @staticmethod
    def random(size: str = "test-random", seed: int = 0, device=None) -> "WhisperModel":
        cfg = CONFIGS[size]
        return WhisperModel(init_random(cfg, seed), cfg,
                            WhisperTokenizer.dummy(cfg.n_vocab), f"random-{size}", device)

    # -- inference -------------------------------------------------------------
    def _prompt_ids(self, language: str, initial_prompt: Optional[str],
                    timestamps: bool = False) -> List[int]:
        """SOT sequence, optionally preceded by <|startofprev|> + prompt
        tokens (whisper's initial-prompt conditioning; the previous-context
        window is capped at n_text_ctx//2 − 1 tokens)."""
        tok = self.tokenizer
        seq = tok.sot_sequence(language=language, timestamps=timestamps)
        if initial_prompt:
            ids = tok.encode(" " + initial_prompt.strip())
            return [tok.sot_prev] + ids[-(self.cfg.n_text_ctx // 2 - 1):] + seq
        return seq

    def _chunks(self, audio_16k) -> torch.Tensor:
        """[B, T] or [T] chunks as f32 on the model's device. A tensor that
        already lies there (run_transcription's device pipeline) is never
        round-tripped through the host."""
        if not isinstance(audio_16k, torch.Tensor):
            audio_16k = torch.tensor(np.asarray(audio_16k, np.float32))
        return torch.atleast_2d(audio_16k).to(self.device, torch.float32)

    def _mel_prompt(self, audio_16k, prompt_ids: List[int]):
        a = self._chunks(audio_16k)
        mel = log_mel_spectrogram(a, n_mels=self.cfg.n_mels, pad_to_chunk=True)
        prompt = torch.tensor(prompt_ids, dtype=torch.long, device=self.device)
        return mel, prompt.expand(a.shape[0], -1).contiguous()

    def transcribe_chunks(
        self,
        audio_16k,
        language: str = "en",
        max_new: int = 224,
        initial_prompt: Optional[str] = None,
        beam: int = 1,
    ) -> List[str]:
        """audio [B, T<=480000] 16 kHz chunks → one text per chunk (batched).

        beam > 1 switches to beam search with length-normalized ranking."""
        tok = self.tokenizer
        mel, prompt = self._mel_prompt(audio_16k, self._prompt_ids(language, initial_prompt))
        if beam > 1:
            tokens, lengths, _ = beam_decode(self.model, mel, prompt, beam=beam,
                                             max_new=max_new, eot=tok.eot)
        else:
            tokens, lengths = greedy_decode(self.model, mel, prompt, max_new=max_new,
                                            eot=tok.eot)
        tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
        return [tok.decode(tokens[b, : lengths[b]]) for b in range(tokens.shape[0])]

    def transcribe_chunks_robust(
        self,
        audio_16k,
        language: str = "en",
        max_new: int = 224,
        temperatures: Tuple[float, ...] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
        compression_ratio_threshold: float = 2.4,
        logprob_threshold: float = -1.0,
        no_speech_threshold: float = 0.6,
        seed: int = 0,
        initial_prompt: Optional[str] = None,
    ) -> List[str]:
        """Quality-gated decoding with the Whisper temperature-fallback
        policy: greedy first; a chunk whose output is degenerate (zlib
        compression ratio > threshold → looping/repetition) or
        low-confidence (avg logprob < threshold) re-decodes at the next
        temperature. Chunks whose no_speech probability exceeds the
        threshold while confidence stays low are emitted as silence. Each
        retry re-decodes the full batch and keeps rows that already passed.
        Rung t_i samples from a generator seeded seed + t_i on the device.
        """
        tok = self.tokenizer
        prompt_ids = self._prompt_ids(language, initial_prompt)
        mel, prompt = self._mel_prompt(audio_16k, prompt_ids)
        B = prompt.shape[0]
        ns_id = min(tok.no_speech, self.cfg.n_vocab - 1)
        # no-speech prob is read at the SOT position (≠ 0 when an
        # initial_prompt prepends <|startofprev|> context)
        sot_index = prompt_ids.index(tok.sot) if tok.sot in prompt_ids else 0
        # encode once: the rungs differ only in sampling temperature
        enc = encode(self.model, mel)

        results: List[Optional[str]] = [None] * B
        for t_i, temp in enumerate(temperatures):
            gen = torch.Generator(device=self.device).manual_seed(seed + t_i)
            tokens, lengths, lp_sum, ns_prob = sample_decode(
                self.model, enc, prompt, float(temp), gen, ns_id, sot_index,
                max_new=max_new, eot=tok.eot)
            tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
            lp_sum, ns_prob = lp_sum.cpu().numpy(), ns_prob.cpu().numpy()
            last = t_i == len(temperatures) - 1
            for b in range(B):
                if results[b] is not None:
                    continue
                text = tok.decode(tokens[b, : lengths[b]])
                avg_lp = float(lp_sum[b]) / (int(lengths[b]) + 1)
                degenerate = compression_ratio(text) > compression_ratio_threshold
                low_conf = avg_lp < logprob_threshold
                if (degenerate or low_conf) and not last:
                    continue  # fall back to the next temperature
                if float(ns_prob[b]) > no_speech_threshold and low_conf:
                    text = ""  # confident silence (whisper no-speech gate)
                results[b] = text
            if all(r is not None for r in results):
                break
        return [r if r is not None else "" for r in results]

    def transcribe_chunks_with_timestamps(
        self, audio_16k, offsets_seconds: Optional[List[float]] = None,
        language: str = "en", max_new: int = 224,
        initial_prompt: Optional[str] = None,
    ) -> List[List[Tuple[float, float, str]]]:
        """[B, T] chunks → per-chunk [(start, end, text)] segments from
        Whisper's timestamp tokens, decoded in one batched greedy call."""
        tok = self.tokenizer
        a = self._chunks(audio_16k)
        mel, prompt = self._mel_prompt(a, self._prompt_ids(language, initial_prompt,
                                                           timestamps=True))
        B = prompt.shape[0]
        if offsets_seconds is None:
            offsets_seconds = [0.0] * B
        dur = a.shape[1] / 16000.0
        tokens, lengths = greedy_decode(self.model, mel, prompt, max_new=max_new, eot=tok.eot)
        tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
        return [
            parse_timestamp_segments(
                tokens[b, : int(lengths[b])].tolist(), tok,
                float(offsets_seconds[b]), dur)
            for b in range(B)
        ]

    def transcribe_chunk_with_timestamps(
        self, audio_16k, offset_seconds: float = 0.0,
        language: str = "en", max_new: int = 224,
        initial_prompt: Optional[str] = None,
    ) -> List[Tuple[float, float, str]]:
        """Single-chunk convenience wrapper over the batched path."""
        return self.transcribe_chunks_with_timestamps(
            self._chunks(audio_16k), [offset_seconds], language=language,
            max_new=max_new, initial_prompt=initial_prompt)[0]


def compression_ratio(text: str) -> float:
    """len(utf-8)/len(zlib): > ~2.4 flags degenerate looping output."""
    import zlib

    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def parse_timestamp_segments(ids, tok: WhisperTokenizer, offset: float,
                             chunk_dur: float) -> List[Tuple[float, float, str]]:
    """Token stream with <|t|> markers → [(start, end, text)]; robust to
    malformed sequences (missing close markers use the chunk end)."""
    segments: List[Tuple[float, float, str]] = []
    cur_start: Optional[float] = None
    cur: List[int] = []
    for t in ids:
        ts = tok.timestamp_seconds(t)
        if ts is None:
            if not tok.is_special(t):
                cur.append(t)
            continue
        if cur_start is None:
            cur_start = ts
        else:
            text = tok.decode(cur).strip()
            if text:
                segments.append((offset + cur_start, offset + min(ts, chunk_dur), text))
            cur, cur_start = [], ts
    if cur and cur_start is not None:
        text = tok.decode(cur).strip()
        if text:
            segments.append((offset + cur_start, offset + chunk_dur, text))
    elif cur:  # no timestamps at all: whole-chunk fallback
        text = tok.decode(cur).strip()
        if text:
            segments.append((offset, offset + chunk_dur, text))
    return segments


__all__ = [
    "CONFIGS", "WhisperConfig", "WhisperModel", "WhisperTokenizer", "beam_decode",
    "compression_ratio", "decode_logits", "encode", "from_hf_state_dict",
    "greedy_decode", "init_random", "load_ggml", "load_hf", "parse_timestamp_segments",
    "sample_decode",
]
