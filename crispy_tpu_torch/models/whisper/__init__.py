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
from ...parallel import check_device, gather, pad_rows
from ...utils.tracing import span
from .model import (
    CONFIGS, Whisper, WhisperConfig, beam_decode, decode_logits, encode, greedy_decode,
    sample_decode, shard_module,
)
from .tokenizer import WhisperTokenizer
from .weights import from_hf_state_dict, init_random, load_ggml, load_hf, params_to_module


class WhisperModel:
    """Weights in a ``Whisper`` module on one device + config + tokenizer,
    with a batched transcribe API. ``device=None`` is the card.

    ``shard_to(mesh)`` spreads it over a ``parallel.Mesh``: every transcribe
    path then splits its chunk batch over the data rows (padded by
    repeating the last chunk) and runs tensor-parallel over each row's model
    devices, the outputs gathered back in chunk order."""

    def __init__(self, params, cfg: WhisperConfig, tokenizer: WhisperTokenizer,
                 name: str = "whisper", device=None):
        self.device = resolve_device(device)
        self.model = params_to_module(params, cfg, self.device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.name = name
        self.mesh = None
        self.replicas: List[Whisper] = [self.model]  # one per data row

    # -- multi-device ---------------------------------------------------------
    def shard_to(self, mesh) -> "WhisperModel":
        """TP over the mesh's model axis (``parallel.asr.whisper_param_spec``),
        DP over its data axis. Rows with the same devices share one replica,
        and a replica shares the weights' storage on their own device."""
        check_device(mesh, self.device)
        built = {}
        for row in mesh.grid:
            if row not in built:
                built[row] = shard_module(self.model, row)
        self.replicas = [built[row] for row in mesh.grid]
        self.mesh = mesh
        return self

    def _shard_batch(self, *arrays) -> Tuple[List[tuple], int]:
        """Split arrays (leading batch axis) over the data rows, the batch
        padded to a multiple of dp by repeating its last row. Returns
        ([(replica, first row, *pieces)], B)."""
        B = arrays[0].shape[0]
        dp = len(self.replicas)
        b = -(-B // dp)
        pieces = [pad_rows(a, b * dp, "edge").chunk(dp) for a in arrays]
        return [(rep, i * b) + tuple(p[i].to(rep.decoder.ln.weight.device) for p in pieces)
                for i, rep in enumerate(self.replicas)], B

    def _gather(self, outs, B: int):
        """Per-shard output tuples → tuples of tensors on the first device,
        cut to the batch's B rows."""
        return tuple(gather(parts, self.device, B) for parts in zip(*outs))

    def decode_logits(self, audio_16k, tokens) -> torch.Tensor:
        """Teacher-forced logits [B, T, V] of tokens [B, T] on chunks [B, T']."""
        mel = log_mel_spectrogram(self._chunks(audio_16k), n_mels=self.cfg.n_mels,
                                  pad_to_chunk=True)
        shards, B = self._shard_batch(mel, tokens.to(self.device))
        return self._gather([(decode_logits(rep, t, encode(rep, m)),)
                             for rep, _, m, t in shards], B)[0]

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
        with span("whisper.mel"):
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
        shards, B = self._shard_batch(mel, prompt)
        if beam > 1:
            outs = [beam_decode(rep, m, p, beam=beam, max_new=max_new, eot=tok.eot)[:2]
                    for rep, _, m, p in shards]
        else:
            outs = [greedy_decode(rep, m, p, max_new=max_new, eot=tok.eot)
                    for rep, _, m, p in shards]
        tokens, lengths = (t.cpu().numpy() for t in self._gather(outs, B))
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
        While a profiler session records, the call records the span
        ``whisper.transcribe`` around ``whisper.mel``, the encoder's and the
        decode loops' spans, and each rung's ``whisper.readback`` and
        ``whisper.select`` (the host's pass over the rung's tokens).
        """
        with span("whisper.transcribe"):
            tok = self.tokenizer
            prompt_ids = self._prompt_ids(language, initial_prompt)
            mel, prompt = self._mel_prompt(audio_16k, prompt_ids)
            B = prompt.shape[0]
            ns_id = min(tok.no_speech, self.cfg.n_vocab - 1)
            # no-speech prob is read at the SOT position (≠ 0 when an
            # initial_prompt prepends <|startofprev|> context)
            sot_index = prompt_ids.index(tok.sot) if tok.sot in prompt_ids else 0
            shards, _ = self._shard_batch(mel, prompt)
            # encode once: the rungs differ only in sampling temperature
            encs = [encode(rep, m) for rep, _, m, _ in shards]
            # a shard draws each step's noise for the whole batch from its own
            # generator with the rung's seed, and keeps its rows (noise_rows)
            rows = None if self.mesh is None else B

            results: List[Optional[str]] = [None] * B
            for t_i, temp in enumerate(temperatures):
                outs = []
                for (rep, start, _, p), enc in zip(shards, encs):
                    gen = torch.Generator(device=self.device).manual_seed(seed + t_i)
                    outs.append(sample_decode(
                        rep, enc, p, float(temp), gen, ns_id, sot_index, max_new=max_new,
                        eot=tok.eot, noise_rows=None if rows is None else (start, rows)))
                with span("whisper.readback"):
                    tokens, lengths, lp_sum, ns_prob = (t.cpu().numpy() for t in self._gather(outs, B))
                last = t_i == len(temperatures) - 1
                with span("whisper.select"):
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
        shards, _ = self._shard_batch(mel, prompt)
        outs = [greedy_decode(rep, m, p, max_new=max_new, eot=tok.eot) for rep, _, m, p in shards]
        tokens, lengths = (t.cpu().numpy() for t in self._gather(outs, B))
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
