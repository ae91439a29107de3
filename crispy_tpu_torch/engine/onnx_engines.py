"""ASR engines that run the catalog's ONNX bundles through the port's ONNX
executor (``models/onnx_exec``), on the card.

The port of ``crispy_tpu/engine/onnx_engines.py``'s CTC and TDT engines.
The reference loads these artifacts through transcribe-rs 0.3 / ONNX
Runtime (managers/transcription.rs:119-172: ParakeetModel, GigaAMModel,
SenseVoiceModel, CohereModel — int8 variants picked when the filename
contains "int8"). Here the same .onnx graphs run eagerly on the engine's
device, inputs/outputs wired by introspection (names vary across
exporters), and the decode loops (CTC collapse, TDT greedy) batch the whole
30 s chunk dimension. The encoder-decoder engine (canary, moonshine-ONNX,
cohere's enc-dec layout) is not ported yet (ROADMAP queue 1, item 10b).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.onnx_exec import _TORCH_OF_ONNX, OnnxRunner
from ..models.onnx_import import _DTYPES
from ..models.parakeet import TDT_SYNC_EVERY
from .onnx_contracts import classify_inputs

_SPECIAL_RE = re.compile(r"^<\|.*\|>$|^<[a-z_/]+>$|^\[.*\]$")


# ---------------------------------------------------------------------------
# Bundle introspection helpers
# ---------------------------------------------------------------------------

def find_onnx(path, *keywords: str, exclude: Sequence[str] = ()) -> Optional[Path]:
    """Find an .onnx file whose name matches any keyword (or any .onnx when
    no keywords), preferring int8 variants like the reference
    (managers/transcription.rs:129-133)."""
    path = Path(path)
    if path.is_file() and path.suffix == ".onnx":
        return path
    cands = sorted(p for p in path.rglob("*.onnx") if ".extracting" not in str(p))
    if keywords:
        cands = [p for p in cands if any(k in p.name.lower() for k in keywords)]
    cands = [p for p in cands if not any(x in p.name.lower() for x in exclude)]
    if not cands:
        return None
    int8 = [p for p in cands if "int8" in p.name.lower()]
    return (int8 or cands)[0]


def load_vocab_file(path) -> Optional[List[str]]:
    """vocab.txt / tokens.txt: 'token' or 'token id' per line."""
    path = Path(path)
    for name in ("vocab.txt", "tokens.txt", "v2_vocab.txt", "v3_vocab.txt",
                 "labels.txt"):
        for p in [path / name, *sorted(path.rglob(name))]:
            if p.exists():
                toks: List[str] = []
                for line in p.read_text(encoding="utf-8").splitlines():
                    if not line.strip("\n"):
                        continue
                    parts = line.rsplit(" ", 1)
                    if len(parts) == 2 and parts[1].lstrip("-").isdigit():
                        idx = int(parts[1])
                        while len(toks) <= idx:
                            toks.append("")
                        toks[idx] = parts[0]
                    else:
                        toks.append(line.rstrip("\n"))
                return toks
    return None


def load_tokenizer(path):
    """Best tokenizer available in the bundle: SPM .model, vocab file, or
    tokenizers.json. Returns (decode_ids: Callable[[List[int]], str], vocab
    size or None)."""
    path = Path(path)
    spm = next(iter(sorted(path.rglob("*.model"))), None)
    if spm is not None:
        try:
            from ..models.spm import SentencePieceVocab

            v = SentencePieceVocab.load(spm)
            return (lambda ids: v.decode(ids)), len(v.pieces)
        except Exception:
            pass
    toks = load_vocab_file(path)
    if toks is not None:
        return (lambda ids: decode_pieces([toks[i] for i in ids
                                           if 0 <= i < len(toks)])), len(toks)
    tj = next(iter(sorted(path.rglob("tokenizer.json"))), None)
    if tj is not None:
        from tokenizers import Tokenizer

        t = Tokenizer.from_file(str(tj))
        return (lambda ids: t.decode(list(map(int, ids)))), t.get_vocab_size()
    vj = next(iter(sorted(path.rglob("vocab.json"))), None)
    if vj is not None:
        # GPT-2-style byte-level vocab (id → printable-unicode token)
        from ..models.whisper.tokenizer import _gpt2_byte_decoder

        v = json.loads(vj.read_text(encoding="utf-8"))
        dec = _gpt2_byte_decoder()
        table = [b""] * (max(v.values()) + 1)
        for tok, idx in v.items():
            table[idx] = bytes(dec.get(ch, ord("?")) for ch in tok)

        def decode(ids):
            data = b"".join(table[i] for i in ids if 0 <= i < len(table))
            return re.sub(r"\s+", " ", data.decode("utf-8", errors="replace")).strip()

        return decode, len(table)
    raise FileNotFoundError(f"no tokenizer/vocab found in {path}")


def decode_pieces(pieces: List[str]) -> str:
    """SPM-style piece join: ▁ marks a space; specials are dropped."""
    out = []
    for p in pieces:
        if not p or _SPECIAL_RE.match(p):
            continue
        out.append(p.replace("▁", " "))
    text = "".join(out)
    return re.sub(r"\s+", " ", text).strip()


def load_pieces(path) -> Optional[List[str]]:
    """Raw token-piece list (for word-boundary grouping), if available."""
    path = Path(path)
    spm = next(iter(sorted(path.rglob("*.model"))), None)
    if spm is not None:
        try:
            from ..models.spm import SentencePieceVocab

            return list(SentencePieceVocab.load(spm).pieces)
        except Exception:
            pass
    return load_vocab_file(path)


def group_word_segments(ids: List[int], times: List[float], pieces: Optional[List[str]],
                        end_time: float) -> List[Tuple[float, float, str]]:
    """Token emissions (id, time) → word segments [(start, end, text)].

    A new word starts at a ▁-prefixed SPM piece (or a leading-space BPE
    piece); char vocabs split on explicit spaces. The reference's engines
    return word segments the same way (managers/transcription.rs:196-249);
    these drive speaker alignment midpoints in diarization.
    """
    words: List[Tuple[float, float, str]] = []
    cur: List[str] = []
    cur_start = 0.0
    last_t = 0.0

    def flush(end):
        text = "".join(cur).replace("▁", "").replace("Ġ", "").strip()
        if text:
            words.append((cur_start, end, text))
        cur.clear()

    for tid, tm in zip(ids, times):
        piece = pieces[tid] if pieces and 0 <= tid < len(pieces) else f"<{tid}>"
        if not piece or _SPECIAL_RE.match(piece):
            continue
        boundary = (piece.startswith("▁") or piece.startswith(" ")
                    or piece.startswith("Ġ") or piece == " ")
        if boundary and cur:
            flush(tm)
        if not cur:
            cur_start = tm
        if piece.strip(" ▁") or not boundary:
            cur.append(piece)
        last_t = tm
    if cur:
        flush(min(end_time, last_t + 0.5))
    return words


def _active_span(row_16k: np.ndarray, dur: float,
                 frame: int = 160, rel: float = 0.05) -> Tuple[float, float]:
    """(t0, t1) of the energetic region of one 16 kHz chunk: first..last
    10 ms frame whose RMS exceeds rel x the chunk max (whole chunk when
    nothing clears the floor)."""
    n = (row_16k.size // frame) * frame
    if n == 0:
        return 0.0, dur
    rms = np.sqrt((row_16k[:n].reshape(-1, frame).astype(np.float64) ** 2
                   ).mean(axis=1))
    peak = rms.max()
    if peak <= 1e-6:
        return 0.0, dur
    active = np.flatnonzero(rms > rel * peak)
    t0 = float(active[0]) * frame / 16000.0
    t1 = min(dur, (float(active[-1]) + 1) * frame / 16000.0)
    return t0, max(t1, t0 + frame / 16000.0)


def _energy_quantile_times(row_16k: np.ndarray, dur: float, n_tokens: int,
                           frame: int = 160, rel: float = 0.05) -> List[float]:
    """Emission-aligned token times for a black-box AR decoder: token i is
    placed where the chunk's cumulative speech-energy mass reaches i/n (an
    enc-dec export without cross-attention outputs has no frame
    attribution; managers/transcription.rs:199,241-249 returns one
    whole-chunk segment for the same reason)."""
    t0, t1 = _active_span(row_16k, dur, frame, rel)
    if n_tokens <= 0:
        return []
    n = (row_16k.size // frame) * frame
    if n == 0 or t1 <= t0:
        return [t0 + (t1 - t0) * i / n_tokens for i in range(n_tokens)]
    e = (row_16k[:n].reshape(-1, frame).astype(np.float64) ** 2).mean(axis=1)
    lo, hi = int(t0 * 16000) // frame, int(np.ceil(t1 * 16000 / frame))
    e = e[lo:hi]
    # floor at rel² of peak so silence inside the span still advances time
    e = np.maximum(e, (rel ** 2) * e.max())
    cum = np.concatenate([[0.0], np.cumsum(e)])
    if e.size == 0 or cum[-1] <= 0.0:
        # digitally silent chunk: no energy mass to align to, so spread
        # uniformly over the span instead of dividing by zero into NaN times
        return [t0 + (t1 - t0) * i / n_tokens for i in range(n_tokens)]
    cum /= cum[-1]
    targets = (np.arange(n_tokens) + 0.5) / n_tokens
    # frame where the cumulative mass crosses the target, interpolated
    pos = np.interp(targets, cum, np.arange(cum.size))
    return [t0 + float(p) * frame / 16000.0 for p in pos]


def _chunks_2d(chunks_16k, device: torch.device) -> torch.Tensor:
    """Chunk batch → 2-D float32 on ``device``; a tensor that already lies
    there (run_transcription's device pipeline) is never round-tripped
    through the host."""
    if not isinstance(chunks_16k, torch.Tensor):
        chunks_16k = torch.from_numpy(np.asarray(chunks_16k, np.float32))
    return torch.atleast_2d(chunks_16k).to(device, torch.float32)


def _resolve_frontend(model_dir, feats_shape, device: torch.device):
    """The feature frontend for an encoder: a bundle's preprocess graph
    (raw waveform → features, the moonshine layout) when present, else the
    frontend picked from the feats input signature."""
    pre_p = find_onnx(model_dir, "preprocess")
    if pre_p is not None:
        pre_runner = OnnxRunner.load(pre_p).validate()
        pre_in = pre_runner.input_info()[0]
        pre_big = pre_runner.lift_big_params(device)

        def pre_fn(a):
            a = _chunks_2d(a, device)
            x = a if (pre_in[2] and len(pre_in[2]) == 2) else a[:, None, :]
            return pre_runner(pre_big, **{pre_in[0]: x})[pre_runner.output_names[0]]

        return pre_fn, "waveform"
    return _pick_frontend(feats_shape, device)


def _np_dtype(et: Optional[int]):
    return _DTYPES.get(et or 1, np.dtype(np.float32))


def _length_extra(ints, roles, B: int, n_frames: int, where: str) -> Dict[str, np.ndarray]:
    """Bind an encoder's int inputs: length-role inputs get the frame
    count; anything unrecognized raises (no silent zero-fill)."""
    extra = {}
    for name, et, _shape in ints:
        if roles.get(name) != "length":
            raise ValueError(
                f"cannot bind int input '{name}' of {where}: not a "
                "recognized length input — extend onnx_contracts with the "
                "exporter's contract")
        extra[name] = np.full(B, n_frames, _np_dtype(et))
    return extra


def _pick_frontend(shape: List[Optional[int]], device: torch.device):
    """Choose the feature frontend + layout from the feats input signature.

    Known contracts: NeMo [B, 80, T]; GigaAM [B, 64, T]; SenseVoice LFR
    [B, T, 560]; raw waveform [B, T] / [B, 1, T]. Each takes chunks (host
    or device) and returns features on ``device``.
    """
    from ..dsp import asr_frontend as fe

    def on(a):
        return _chunks_2d(a, device)

    dims = list(shape or [])
    if len(dims) <= 2 or (len(dims) == 3 and dims[1] == 1):
        # raw waveform input
        if len(dims) == 3:
            return lambda a: on(a)[:, None, :], "waveform"
        return on, "waveform"
    static = [d for d in dims[1:] if d]
    if 560 in static:
        def sv(a):
            from ..dsp.fbank import fbank

            return fe.lfr(fbank(on(a), 80))  # [B, T, 80] kaldi fbank → LFR

        return sv, "lfr560"
    if 64 in static:
        if dims[1] == 64:
            return lambda a: fe.gigaam_log_mel(on(a), 64), "mel64_ct"
        return lambda a: fe.gigaam_log_mel(on(a), 64).transpose(1, 2), "mel64_tc"
    n_mels = static[0] if static else 80
    if dims[1] == n_mels:
        return lambda a: fe.nemo_log_mel(on(a), n_mels), "nemo_ct"
    return lambda a: fe.nemo_log_mel(on(a), n_mels).transpose(1, 2), "nemo_tc"


def _frame_count(kind: str, n_samples: int) -> int:
    if kind == "waveform":
        return n_samples
    if kind.startswith("lfr"):
        # kaldi fbank (snip_edges): (T - 400)//160 + 1 frames, then LFR /6
        return -(-(((n_samples - 400) // 160) + 1) // 6)
    return n_samples // 160 + 1


def _first_rank3(runner: OnnxRunner, out: Dict[str, torch.Tensor]):
    for name in runner.output_names:
        v = out[name]
        if getattr(v, "ndim", 0) == 3:
            return v
    return None


# ---------------------------------------------------------------------------
# CTC engine (GigaAM, SenseVoice)
# ---------------------------------------------------------------------------

# FunASR SenseVoice prompt-id tables (model.py lid_dict / textnorm_dict of
# the FunASR SenseVoiceSmall export, the graph transcribe-rs's
# SenseVoiceModel consumes — managers/transcription.rs:153-156). A bundle
# can override them by shipping `sensevoice_ids.json` with the same keys.
SENSEVOICE_LID = {"auto": 0, "zh": 3, "en": 4, "yue": 7, "ja": 11, "ko": 12,
                  "nospeech": 13}
SENSEVOICE_TEXTNORM = {"withitn": 14, "woitn": 15}


def _load_id_tables(model_dir) -> Tuple[Dict[str, int], Dict[str, int]]:
    p = Path(model_dir) / "sensevoice_ids.json"
    if p.exists():
        raw = json.loads(p.read_text(encoding="utf-8"))
        return (dict(raw.get("lid", SENSEVOICE_LID)),
                dict(raw.get("textnorm", SENSEVOICE_TEXTNORM)))
    return dict(SENSEVOICE_LID), dict(SENSEVOICE_TEXTNORM)


class OnnxCtcEngine:
    """Single-graph CTC: features → log-probs [B, T', V] → greedy collapse,
    on ``device`` (default: the card)."""

    name = "onnx-ctc"

    def __init__(self, model_dir, model_id: str = "onnx-ctc",
                 blank_id: Optional[int] = None, language_id: Optional[int] = None,
                 textnorm: str = "woitn", device=None):
        self.name = model_id
        self.device = resolve_device(device)
        model_dir = Path(model_dir)
        p = find_onnx(model_dir, exclude=("decoder", "joint", "preprocess"))
        if p is None:
            raise FileNotFoundError(f"no .onnx in {model_dir}")
        self.runner = OnnxRunner.load(p).validate()
        self.decode_ids, self.vocab_size = load_tokenizer(model_dir)
        self.pieces = load_pieces(model_dir)
        cls = classify_inputs(self.runner)
        if not cls["float"]:
            raise ValueError("CTC graph has no float feature input")
        self.feats_name, _, feats_shape = cls["float"][0]
        self.frontend, self.kind = _pick_frontend(feats_shape, self.device)
        self.int_inputs = cls["int"]
        self.roles = cls["roles"]
        self.blank_id = blank_id
        self.lid_table, self.textnorm_table = _load_id_tables(model_dir)
        self.language_id = language_id  # fixed override; None = per-call table
        self.textnorm_id = self.textnorm_table.get(textnorm, 15)
        self._big = self.runner.lift_big_params(self.device)

    def _run(self, feats, extra, big):
        """The graph, then argmax and the CTC collapse on the device: only
        [B, T] ids and the emit mask leave it."""
        inputs = {self.feats_name: feats}
        inputs.update(extra)
        logits = _first_rank3(self.runner, self.runner(big, **inputs))
        if logits is None:
            raise ValueError("no rank-3 logits output")
        # orient to [B, T, V]: the vocab axis is the one sized like the
        # tokenizer vocab
        if self.vocab_size:
            d1 = abs(logits.shape[1] - self.vocab_size)
            d2 = abs(logits.shape[2] - self.vocab_size)
            if d1 < d2:
                logits = logits.transpose(1, 2)
        elif logits.shape[1] < logits.shape[2]:
            logits = logits.transpose(1, 2)
        V = logits.shape[-1]
        blank = self.blank_id
        if blank is None:
            # NeMo CTC puts blank last; FunASR puts it at 0.
            blank = V - 1 if self.vocab_size and self.vocab_size < V else 0
        ids = logits.argmax(dim=-1)  # [B, T]
        # emit where the id changes and isn't blank (prev-shift compare)
        prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
        emit = (ids != prev) & (ids != blank)
        return ids, emit

    def _lang_id(self, language: str) -> int:
        if self.language_id is not None:
            return self.language_id
        return self.lid_table.get(language, self.lid_table.get("auto", 0))

    def _extra_inputs(self, B: int, n_frames: int,
                      language: str = "en") -> Dict[str, np.ndarray]:
        extra = {}
        for name, et, shape in self.int_inputs:
            role = self.roles.get(name)
            dt = _np_dtype(et)
            if role == "length":
                v = np.full(B, n_frames, dt)
            elif role == "language":
                v = np.full(B, self._lang_id(language), dt)
            elif role == "textnorm":
                v = np.full(B, self.textnorm_id, dt)
            else:
                raise ValueError(
                    f"cannot bind int input '{name}' of {self.name}: not a "
                    "recognized length/language/textnorm input — refusing to "
                    "zero-fill silently (extend onnx_contracts with the "
                    "exporter's contract)")
            if shape and len(shape) == 2:
                v = v[:, None]
            extra[name] = v
        return extra

    def _emissions(self, chunks_16k, language: str = "en"):
        """Greedy CTC emissions with frame times: per row (ids, times)."""
        a = _chunks_2d(chunks_16k, self.device)
        B = a.shape[0]
        dur = a.shape[1] / 16000.0
        feats = self.frontend(a)
        n_frames = _frame_count(self.kind, a.shape[1])
        ids, emit = self._run(feats, self._extra_inputs(B, n_frames, language), self._big)
        ids, emit = ids.cpu().numpy(), emit.cpu().numpy()
        frame_dur = dur / max(ids.shape[1], 1)
        rows = []
        for b in range(B):
            idx = np.flatnonzero(emit[b])
            rows.append((ids[b, idx].astype(int).tolist(), (idx * frame_dur).tolist()))
        return rows, dur

    def transcribe_batch(self, chunks_16k, language: str = "en") -> List[str]:
        rows, _ = self._emissions(chunks_16k, language)
        return [self.decode_ids(seq) for seq, _times in rows]

    def transcribe_with_timestamps(self, chunk_16k, offset_seconds,
                                   language: str = "en"):
        return self.transcribe_batch_with_timestamps(
            _chunks_2d(chunk_16k, self.device), [offset_seconds], language)[0]

    def transcribe_batch_with_timestamps(self, chunks, offsets,
                                         language: str = "en"):
        """Word segments from CTC emission frame times, one batched device
        run (the reference consumes engine word segments the same way —
        managers/transcription.rs:196-249)."""
        rows, dur = self._emissions(chunks, language)
        out = []
        for (seq, times), off in zip(rows, offsets):
            words = group_word_segments(seq, times, self.pieces, dur)
            out.append([(s + off, e + off, w) for s, e, w in words])
        return out


def engine_from_onnx_dir(model_id: str, path, device=None, **kwargs):
    """Dispatch an ONNX bundle to the right engine by its file inventory:
    a *joint* decoder → transducer/TDT; encoder+decoder pair → AR enc-dec
    (not ported yet); a single graph → CTC. This is how unknown-architecture
    bundles (cohere, transcribe-rs's external crate) are pinned at load."""
    path = Path(path)
    joint = find_onnx(path, "joint")
    if joint is not None:
        return OnnxTdtEngine(path, model_id, device=device)
    enc = find_onnx(path, "encoder", "encode")
    dec = (find_onnx(path, "uncached") or find_onnx(path, "merged")
           or find_onnx(path, "decoder", "decode", exclude=("cached",)))
    if enc is not None and dec is not None and enc != dec:
        raise NotImplementedError(
            f"{model_id}: an encoder-decoder ONNX bundle needs the enc-dec engine, which "
            "is not ported yet (ROADMAP queue 1, item 10b)")
    if find_onnx(path) is not None:
        return OnnxCtcEngine(path, model_id, device=device, **kwargs)
    raise FileNotFoundError(f"no .onnx files in {path}")


# ---------------------------------------------------------------------------
# Transducer/TDT engine (Parakeet)
# ---------------------------------------------------------------------------

class OnnxTdtEngine:
    """encoder-model.onnx + decoder_joint-model.onnx greedy TDT/RNN-T, on
    ``device`` (default: the card).

    The NeMo export contract (istupakov/onnx-asr layout, which transcribe-rs
    consumes): encoder(audio_signal [B, 80, T], length) → (outputs
    [B, D, T'], encoded_lengths); decoder_joint(encoder_outputs frame,
    targets [B, 1], target_length, input_states_1/2) → (joint logits
    [B, 1, 1, V+1+n_dur], ..., output_states_1/2). Joint logits beyond
    V+1 are TDT duration heads (durations 0..n_dur-1).
    """

    name = "onnx-tdt"
    MAX_SYMBOLS_PER_FRAME = 10
    MAX_TOKENS = 512  # emission cap per chunk (≈4 tokens/s at 30 s is ~120)
    #: run_transcription schedules 16-chunk batches while >8 chunks remain:
    #: the sequential TDT loop amortizes over the bigger batch.
    decode_batch_bucket = 16

    def __init__(self, model_dir, model_id: str = "onnx-tdt", device=None):
        self.name = model_id
        self.device = resolve_device(device)
        model_dir = Path(model_dir)
        enc_p = find_onnx(model_dir, "encoder")
        dec_p = find_onnx(model_dir, "decoder", "joint")
        if enc_p is None or dec_p is None:
            raise FileNotFoundError(
                f"need encoder+decoder_joint .onnx in {model_dir}")
        self.enc = OnnxRunner.load(enc_p).validate()
        self.dec = OnnxRunner.load(dec_p).validate()
        self.decode_ids, self.vocab_size = load_tokenizer(model_dir)
        self.pieces = load_pieces(model_dir)

        ecls = classify_inputs(self.enc)
        self.enc_feats_name, _, efs = ecls["float"][0]
        self.frontend, self.kind = _resolve_frontend(model_dir, efs, self.device)
        self.enc_ints = ecls["int"]
        self.enc_roles = ecls["roles"]

        dcls = classify_inputs(self.dec)
        self.dec_enc_name, _, self.dec_enc_shape = dcls["float"][0]
        self.dec_ints = dcls["int"]
        self.dec_states = dcls["state"]
        self.dec_roles = dcls["roles"]
        for name, _et, _sh in self.dec_ints:
            if self.dec_roles.get(name) not in ("targets", "target_length", "length"):
                raise ValueError(
                    f"cannot bind int input '{name}' of the decoder_joint "
                    f"graph in {model_dir}: not a recognized targets/"
                    "target_length input — extend onnx_contracts with the "
                    "exporter's contract")
        self._enc_big = self.enc.lift_big_params(self.device)
        self._dec_big = self.dec.lift_big_params(self.device)

    def _encode(self, feats, extra, big):
        inputs = {self.enc_feats_name: feats}
        inputs.update(extra)
        return _first_rank3(self.enc, self.enc(big, **inputs))

    def _joint(self, frame, targets, states, extra, big):
        """One decoder_joint call: frame [B, D], targets [B, 1] →
        (logits [B, V+1+n_dur], new states)."""
        x = frame[:, :, None]  # [B, D, 1]
        d0 = self.dec_enc_shape
        if d0 and len(d0) == 3 and (d0[1] == 1):
            x = frame[:, None, :]  # [B, 1, D]
        inputs = {self.dec_enc_name: x}
        for (name, _, _), s in zip(self.dec_states, states):
            inputs[name] = s
        for name, et, shape in self.dec_ints:
            if self.dec_roles.get(name) == "targets":
                v = targets.to(_TORCH_OF_ONNX.get(et or 1, torch.float32))
                if not (shape and len(shape) == 2):
                    v = v[:, 0]
            else:  # target_length / length: one label per step
                v = np.ones(targets.shape[0], _np_dtype(et))
            inputs[name] = v
        out = self.dec(big, **inputs)
        logits = None
        new_states = []
        for name in self.dec.output_names:
            v = out[name]
            low = name.lower()
            if "state" in low or "cache" in low:
                new_states.append(v)
            elif getattr(v, "ndim", 0) >= 2 and logits is None:
                logits = v.reshape(v.shape[0], -1)
        return logits, new_states

    def _enc_time_last(self, shape) -> bool:
        """True when the encoder output is [B, D, T'] (time last). The
        graph's declared output shape decides when it has a static dim
        (NeMo exports declare D); otherwise assume the smaller trailing
        axis is D ([B, T', D])."""
        for _name, _et, osh in self.enc.graph.outputs_info:
            if osh and len(osh) == 3:
                if osh[1] and osh[1] == shape[1] and not osh[2]:
                    return True   # static middle dim = D → time last
                if osh[2] and osh[2] == shape[2] and not osh[1]:
                    return False  # static last dim = D → time middle
        return shape[1] < shape[2]

    def _init_states(self, B: int) -> List[torch.Tensor]:
        states = []
        for _name, et, shape in self.dec_states:
            # convention [num_layers, B, H]: the dynamic dim is batch
            dims = [d if d else (B if i == 1 else 1)
                    for i, d in enumerate(shape or [1, B, 640])]
            states.append(torch.zeros(dims, dtype=_TORCH_OF_ONNX.get(et or 1, torch.float32),
                                      device=self.device))
        return states

    def encoder_output(self, chunks_16k) -> torch.Tensor:
        """The encoder's output [B, T', D] for a chunk batch, on the device."""
        a = _chunks_2d(chunks_16k, self.device)
        feats = self.frontend(a)
        n_frames = _frame_count(self.kind, a.shape[1])
        extra = _length_extra(self.enc_ints, self.enc_roles, a.shape[0], n_frames,
                              f"{self.name} encoder")
        enc = self._encode(feats, extra, self._enc_big)
        if self._enc_time_last(enc.shape):  # [B, D, T'] → [B, T', D]
            enc = enc.transpose(1, 2)
        return enc

    def _greedy(self, chunks_16k):
        """TDT/RNN-T greedy over the chunk batch; returns (tokens, emission
        times, chunk duration). Emission time = the encoder frame pointer at
        emission mapped onto the chunk timeline."""
        a = _chunks_2d(chunks_16k, self.device)
        chunk_dur = a.shape[1] / 16000.0
        enc = self.encoder_output(a)
        B, Tq, D = enc.shape
        frame_dur = chunk_dur / max(Tq, 1)
        toks, times_idx, n, _iters = self.decode(enc)
        toks, times_idx, n = toks.cpu().numpy(), times_idx.cpu().numpy(), n.cpu().numpy()
        tokens = [toks[b, : n[b]].tolist() for b in range(B)]
        token_times = [(times_idx[b, : n[b]] * frame_dur).tolist() for b in range(B)]
        return tokens, token_times, chunk_dur

    def _pin_heads(self, B: int, D: int) -> Tuple[int, int, int]:
        """(V, blank, n_dur): one probe call pins the joint's duration-head
        count (NeMo: blank = vocab_size, the last of V+1 token logits)."""
        V = self.vocab_size or 1024
        if not hasattr(self, "_n_dur"):
            lg, _ = self._joint(torch.zeros((B, D), device=self.device),
                                torch.full((B, 1), V, dtype=torch.int32, device=self.device),
                                self._init_states(B), {}, self._dec_big)
            self._n_dur = max(int(lg.shape[1]) - (V + 1), 0)
        return V, V, self._n_dur

    @torch.no_grad()
    def decode(self, enc: torch.Tensor):
        """Greedy TDT over enc [B, T', D]: the JAX package's ``while_loop``
        as a Python loop of device steps (time advances by the predicted
        duration; the prediction net advances on emission). The host reads
        whether any row is still active once every ``TDT_SYNC_EVERY``
        iterations; an iteration after the end changes no output (every
        update is gated by its row's t < T'). Returns (tokens [B, U],
        frame index of each [B, U], counts [B], iterations run) on the
        device."""
        B, Tq, D = enc.shape
        V, blank, n_dur = self._pin_heads(B, D)
        U, MAXSYM = self.MAX_TOKENS, self.MAX_SYMBOLS_PER_FRAME
        dev = enc.device
        rows = torch.arange(B, device=dev)
        t = torch.zeros(B, dtype=torch.int32, device=dev)
        last = torch.full((B, 1), blank, dtype=torch.int32, device=dev)
        states = self._init_states(B)
        toks = torch.full((B, U), blank, dtype=torch.int32, device=dev)
        times = torch.zeros((B, U), dtype=torch.int32, device=dev)
        n = torch.zeros(B, dtype=torch.int32, device=dev)
        syms = torch.zeros(B, dtype=torch.int32, device=dev)
        iters = torch.zeros((), dtype=torch.int32, device=dev)
        one = torch.ones((), dtype=torch.int32, device=dev)
        for it in range(Tq * MAXSYM + U):
            active = t < Tq
            iters = iters + active.any().to(torch.int32)
            frames = enc[rows, t.clamp(max=Tq - 1)]
            logits, new_states = self._joint(frames, last, states, {}, self._dec_big)
            tok = logits[:, : V + 1].argmax(dim=-1).to(torch.int32)
            dur = (logits[:, V + 1:].argmax(dim=-1).to(torch.int32) if n_dur > 0
                   else torch.zeros_like(tok))
            emit = active & (tok != blank)
            states = [torch.where(self._state_mask(emit, s.shape), ns, s)
                      for s, ns in zip(states, new_states)]
            idx = n.clamp(max=U - 1)[:, None]
            toks = toks.scatter(1, idx, torch.where(emit[:, None], tok[:, None],
                                                    toks.gather(1, idx)))
            times = times.scatter(1, idx, torch.where(emit[:, None], t[:, None],
                                                      times.gather(1, idx)))
            n = (n + emit.to(torch.int32)).clamp(max=U)
            last = torch.where(emit[:, None], tok[:, None], last)
            syms = torch.where(emit, syms + 1, syms)
            if n_dur > 0:
                adv = torch.where(active, dur, 0)
                adv = torch.where((tok == blank) & (dur == 0), one, adv)  # no stall
            else:
                adv = torch.where(emit, 0, one)  # RNN-T: advance on blank only
            adv = torch.where(syms >= MAXSYM, torch.clamp_min(adv, 1), adv)
            syms = torch.where(adv > 0, 0, syms)
            t = t + torch.where(active, adv, 0)
            if it % TDT_SYNC_EVERY == TDT_SYNC_EVERY - 1 and not bool((t < Tq).any()):
                break
        return toks, times, n, iters

    @staticmethod
    def _state_mask(emit: torch.Tensor, shape) -> torch.Tensor:
        """Broadcast the per-row emit mask onto a state of given shape
        (batch axis = the axis whose length is B)."""
        B = emit.shape[0]
        mask_shape = [1] * len(shape)
        for i, d in enumerate(shape):
            if d == B:
                mask_shape[i] = B
                break
        return emit.reshape(mask_shape)

    def transcribe_batch(self, chunks_16k, language: str = "en") -> List[str]:
        tokens, _times, _dur = self._greedy(chunks_16k)
        return [self.decode_ids(seq) for seq in tokens]

    def transcribe_with_timestamps(self, chunk_16k, offset_seconds,
                                   language: str = "en"):
        return self.transcribe_batch_with_timestamps(
            _chunks_2d(chunk_16k, self.device), [offset_seconds], language)[0]

    def transcribe_batch_with_timestamps(self, chunks, offsets,
                                         language: str = "en"):
        """Word segments from transducer emission frame pointers (the NeMo
        transducer exports have no language input: accepted and unused)."""
        tokens, times, dur = self._greedy(chunks)
        out = []
        for seq, tms, off in zip(tokens, times, offsets):
            words = group_word_segments(seq, tms, self.pieces, dur)
            out.append([(s + off, e + off, w) for s, e, w in words])
        return out
