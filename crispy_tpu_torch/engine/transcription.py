"""File→text transcription pipeline.

The port of ``crispy_tpu/engine/transcription.py``, itself a rebuild of the
reference's transcription stack (SURVEY §2.3):
  * TranscriptionManager (managers/transcription.rs:26-249): one loaded
    engine, current model id, per-recording state map + cancel flags.
  * run_transcription (commands/transcription.rs:98-481): WAV → mono →
    16 kHz → 30 s chunks → text, with phase/progress/ETA events,
    cancellation, and result persistence.
  * Sidecar persistence (managers/transcription.rs:252-361): hash-keyed
    .txt / .meta / .chat.json under ~/Documents/Crispy/Transcriptions.

Chunks are batched and decoded together on the card; a recording that is
not at 16 kHz is resampled there (``resample_poly(device_out=True)``) and
its chunk batches never leave it. The engines: whisper, and the native
families (parakeet TDT and CTC, gigaam, canary, moonshine, sensevoice) from
prepared bundles, and the catalog's ONNX bundles (parakeet TDT, gigaam and
sensevoice CTC, cohere where its bundle is one of those layouts) through
the ONNX executor (``engine/onnx_engines``); the ONNX enc-dec layouts
(canary, moonshine, cohere's) wait for ROADMAP queue 1, item 10b. With
diarization on, the chunks are decoded with timestamps and the speaker
segments of ``engine/diarization`` tag the text.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..api.events import BUS, EventBus
from ..device import resolve_device
from ..io import wav as wavio
from ..models.registry import ModelManager
from ..utils import paths
from ..utils.tracing import stage

TARGET_SAMPLE_RATE = 16000  # commands/transcription.rs:173
TRANSCRIBE_CHUNK_SECONDS = 30  # :175
CHUNK_SAMPLES = TARGET_SAMPLE_RATE * TRANSCRIBE_CHUNK_SECONDS


# ---------------------------------------------------------------------------
# Persistence (hash-keyed sidecars)
# ---------------------------------------------------------------------------

def transcription_file_stem(recording_path: str) -> str:
    """Stable 16-hex stem from the recording path.

    The reference uses Rust's DefaultHasher (SipHash with an unspecified
    key); any stable 64-bit hash with the same format works — FNV-1a here.
    """
    h = np.uint64(0xCBF29CE484222325)
    for b in str(recording_path).encode("utf-8"):
        h = np.uint64((int(h) ^ b) * 0x100000001B3 & 0xFFFFFFFFFFFFFFFF)
    return f"{int(h):016x}"


def _tdir() -> Path:
    return paths.ensure_dir(paths.transcriptions_dir())


def transcription_result_path(recording_path: str) -> Path:
    return _tdir() / f"{transcription_file_stem(recording_path)}.txt"


def transcription_metadata_path(recording_path: str) -> Path:
    return _tdir() / f"{transcription_file_stem(recording_path)}.meta"


def transcription_chat_history_path(recording_path: str) -> Path:
    return _tdir() / f"{transcription_file_stem(recording_path)}.chat.json"


def save_transcription_result(recording_path: str, text: str) -> None:
    transcription_result_path(recording_path).write_text(text, encoding="utf-8")


def load_transcription_result(recording_path: str) -> Optional[str]:
    p = transcription_result_path(recording_path)
    return p.read_text(encoding="utf-8") if p.exists() else None


def save_transcription_metadata(recording_path: str, model_id: str) -> None:
    transcription_metadata_path(recording_path).write_text(
        json.dumps({"model_id": model_id}), encoding="utf-8"
    )


def load_transcription_metadata(recording_path: str) -> Optional[str]:
    p = transcription_metadata_path(recording_path)
    if not p.exists():
        return None
    return json.loads(p.read_text(encoding="utf-8")).get("model_id")


def transcription_progress_path(recording_path: str) -> Path:
    return _tdir() / f"{transcription_file_stem(recording_path)}.progress.json"


def _save_progress(recording_path: str, payload: dict) -> None:
    """Atomic temp+rename write (the settings-store discipline) so a crash
    mid-write can't corrupt the checkpoint."""
    p = transcription_progress_path(recording_path)
    tmp = p.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(payload), encoding="utf-8")
    tmp.replace(p)


def _load_progress(recording_path: str) -> Optional[dict]:
    p = transcription_progress_path(recording_path)
    if not p.exists():
        return None
    try:
        return json.loads(p.read_text(encoding="utf-8"))
    except (json.JSONDecodeError, OSError):
        return None  # unreadable checkpoint: restart from zero


def clear_transcription_progress(recording_path: str) -> None:
    transcription_progress_path(recording_path).unlink(missing_ok=True)


def save_transcription_chat_history(recording_path: str, messages: List[dict]) -> None:
    transcription_chat_history_path(recording_path).write_text(
        json.dumps(messages, indent=2), encoding="utf-8"
    )


def load_transcription_chat_history(recording_path: str) -> List[dict]:
    p = transcription_chat_history_path(recording_path)
    if not p.exists():
        return []
    return json.loads(p.read_text(encoding="utf-8"))


# ---------------------------------------------------------------------------
# Engine loading
# ---------------------------------------------------------------------------

class EngineProtocol:
    """A loaded speech model: batched 30 s chunk transcription. Chunks come
    as a [B, 480000] numpy array or a tensor on the engine's device."""

    name: str = "engine"

    #: Preferred large chunk-batch size, 0 = no preference. Engines whose
    #: decode cost is dominated by a sequential per-step loop (whisper's
    #: 224-step decode) amortize steps over bigger batches.
    #: run_transcription schedules batches of this size while more than
    #: `batch_chunks` chunks remain; engines left at 0 keep the fixed
    #: `batch_chunks` schedule.
    decode_batch_bucket: int = 0

    def transcribe_batch(self, chunks_16k, language: str = "en") -> List[str]:
        raise NotImplementedError

    def transcribe_with_timestamps(
        self, chunk_16k, offset_seconds: float, language: str = "en"
    ) -> List[Tuple[float, float, str]]:
        """Word segments (start, end, text); default: the whole chunk as one
        segment (managers/transcription.rs:196-249's fallback path)."""
        text = self.transcribe_batch(chunk_16k[None, :], language=language)[0]
        dur = chunk_16k.shape[-1] / TARGET_SAMPLE_RATE
        return [(offset_seconds, offset_seconds + dur, text)] if text.strip() else []

    def transcribe_batch_with_timestamps(
        self, chunks_16k, offsets_seconds: List[float], language: str = "en"
    ) -> List[List[Tuple[float, float, str]]]:
        """Timestamped segments for a batch of chunks. The default makes one
        ``transcribe_batch`` call and returns whole-chunk segments (the
        reference's fallback granularity), so a job with diarization keeps
        the batch. An engine that overrides only the single-chunk method
        keeps its word granularity: it is called chunk by chunk."""
        if (type(self).transcribe_with_timestamps
                is not EngineProtocol.transcribe_with_timestamps):
            import inspect

            takes_lang = "language" in inspect.signature(
                type(self).transcribe_with_timestamps).parameters
            return [self.transcribe_with_timestamps(
                        chunks_16k[j], offsets_seconds[j],
                        **({"language": language} if takes_lang else {}))
                    for j in range(len(chunks_16k))]
        texts = self.transcribe_batch(chunks_16k, language=language)
        dur = chunks_16k.shape[-1] / TARGET_SAMPLE_RATE
        return [[(off, off + dur, t)] if t.strip() else []
                for t, off in zip(texts, offsets_seconds)]


def _on_device(chunks, device: torch.device) -> torch.Tensor:
    """[B, T] chunks (an array, a list of equal-length arrays, or a tensor)
    as f32 on device; a tensor that already lies there (run_transcription's
    device pipeline) is never round-tripped through the host."""
    if not isinstance(chunks, torch.Tensor):
        chunks = torch.from_numpy(np.asarray(chunks, np.float32))
    return torch.atleast_2d(chunks).to(device, torch.float32)


def _onnx_only(model_id: str, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{model_id}: {what} runs through the ONNX encoder-decoder engine, which is not "
        "ported yet (ROADMAP queue 1, item 10b)")


def _has_hf_checkpoint(path: Path) -> bool:
    return (path / "model.safetensors").exists() or (path / "pytorch_model.bin").exists()


def load_engine(model_id: str, model_manager: ModelManager, device=None) -> EngineProtocol:
    """EngineType dispatch (managers/transcription.rs:119-172) onto ``device``
    (default: the card): whisper ggml files and HF checkpoint dirs; the
    native families from prepared bundles (``params.npz`` in the JAX
    package's flat layout, ``config.json``, the tokenizer) and, for
    moonshine and parakeet CTC, from HF checkpoints; else the catalog's
    ONNX bundle through the executor, with the JAX package's engines and
    arguments: parakeet TDT, gigaam and sensevoice (blank 0) CTC, cohere by
    its file inventory. Canary and moonshine without ``params.npz`` (and
    cohere's enc-dec layout) need the ONNX encoder-decoder engine, which is
    not ported: they raise ``NotImplementedError``."""
    info = model_manager.find(model_id)
    if info is None:
        raise ValueError(f"unknown model: {model_id}")
    path = model_manager.model_path(model_id)
    if not model_manager.is_downloaded(model_id):
        raise FileNotFoundError(f"model not downloaded: {model_id}")
    dev = resolve_device(device)
    kind = info.engine_type
    if kind == "whisper":
        return _whisper_engine(model_id, path, dev)
    if kind == "cohere":
        # transcribe-rs's CohereModel is an external ONNX crate: the bundle's
        # architecture is pinned at load time from its file inventory
        from .onnx_engines import engine_from_onnx_dir

        return engine_from_onnx_dir(model_id, path, device=dev)
    native = {"parakeet": _parakeet_tdt_engine, "gigaam": _gigaam_engine,
              "canary": _canary_engine, "moonshine": _moonshine_engine,
              "sensevoice": _sensevoice_engine}
    if kind not in native:
        raise ValueError(f"unknown engine type '{kind}'")
    if (path / "params.npz").exists():
        raw = json.loads((path / "config.json").read_text())
        return native[kind](model_id, path, raw, dict(np.load(path / "params.npz")), dev)
    if kind == "moonshine" and _has_hf_checkpoint(path):
        from ..models.moonshine import MoonshineModel

        return _moonshine(model_id, MoonshineModel.from_hf(path, name=model_id, device=dev))
    if kind == "parakeet" and _has_hf_checkpoint(path):
        return _parakeet_ctc_engine(model_id, path, dev)
    if kind in ("canary", "moonshine"):
        raise _onnx_only(model_id, "a bundle without params.npz")
    # the catalog bundle is the ONNX export (transcribe-rs ParakeetModel,
    # GigaAMModel, SenseVoiceModel; managers/transcription.rs:141-156)
    from .onnx_engines import OnnxCtcEngine, OnnxTdtEngine

    if kind == "parakeet":
        return OnnxTdtEngine(path, model_id, device=dev)
    return OnnxCtcEngine(path, model_id, blank_id=0 if kind == "sensevoice" else None,
                         device=dev)


def _whisper_engine(model_id: str, path: Path, dev: torch.device) -> EngineProtocol:
    from ..models.whisper import WhisperModel

    if path.is_dir():
        wm = WhisperModel.from_hf(path, name=model_id, device=dev)
    else:
        wm = WhisperModel.from_ggml(path, name=model_id, device=dev)

    class _WhisperEngine(EngineProtocol):
        name = model_id
        decode_batch_bucket = 16
        model = wm

        def transcribe_batch(self, chunks, language="en"):
            # whisper.cpp applies temperature fallback + the no-speech
            # gate internally (transcription.rs delegates); match it.
            return wm.transcribe_chunks_robust(chunks, language=language)

        def transcribe_with_timestamps(self, chunk_16k, offset_seconds, language="en"):
            return wm.transcribe_chunk_with_timestamps(chunk_16k, offset_seconds,
                                                       language=language)

        def transcribe_batch_with_timestamps(self, chunks, offsets, language="en"):
            return wm.transcribe_chunks_with_timestamps(chunks, offsets, language=language)

    return _WhisperEngine()


def _moonshine_engine(model_id, path, raw, params, dev) -> EngineProtocol:
    from ..models.carry import hf_tokenizer
    from ..models.moonshine import CONFIGS, MoonshineConfig, MoonshineModel

    cfg = CONFIGS[raw["config"]] if "config" in raw else MoonshineConfig(**raw)
    return _moonshine(model_id, MoonshineModel(params, cfg, hf_tokenizer(path),
                                               name=model_id, device=dev))


def _moonshine(model_id: str, mm) -> EngineProtocol:
    class _MoonshineEngine(EngineProtocol):
        name = model_id
        model = mm.model

        def transcribe_batch(self, chunks, language="en"):
            return mm.transcribe_chunks(chunks, language=language)

    return _MoonshineEngine()


def _parakeet_tdt_engine(model_id, path, raw, params, dev) -> EngineProtocol:
    """The prepared TDT bundle (the converter's output): NeMo mel features
    (preemphasis + slaney mel + per-feature norm, the frontend NeMo models
    train on), the TDT loop, SentencePiece."""
    from ..dsp.asr_frontend import nemo_log_mel
    from ..models import parakeet as pk
    from ..models.spm import SentencePieceVocab

    cfg = pk.ParakeetConfig(**raw.get("encoder", {}))
    net = pk.params_to_module(params, cfg, dev)
    vocab = SentencePieceVocab.load(path / "tokenizer.model")

    class _ParakeetTdtEngine(EngineProtocol):
        name = model_id
        model = net

        def transcribe_batch(self, chunks, language="en"):
            feats = nemo_log_mel(_on_device(chunks, dev), cfg.n_mels).transpose(1, 2)
            toks, n = pk.tdt_greedy_decode(net, feats)
            toks, n = toks.cpu().numpy(), n.cpu().numpy()
            return [vocab.decode(row[:k]) for row, k in zip(toks, n)]

    return _ParakeetTdtEngine()


def _parakeet_ctc_engine(model_id: str, path: Path, dev: torch.device) -> EngineProtocol:
    """An HF ParakeetForCTC checkpoint over the Whisper-style log-mel of the
    chunk padded to 30 s, as the JAX package feeds it."""
    from ..dsp.mel import log_mel_spectrogram
    from ..models import parakeet as pk
    from ..models.carry import hf_tokenizer, load_hf_state_dict

    params, cfg = pk.from_hf_ctc_state_dict(load_hf_state_dict(path))
    net = pk.params_to_module(params, cfg, dev)
    tok = hf_tokenizer(path)

    class _ParakeetCtcEngine(EngineProtocol):
        name = model_id
        model = net

        def transcribe_batch(self, chunks, language="en"):
            mel = log_mel_spectrogram(_on_device(chunks, dev), pad_to_chunk=True)
            seqs = pk.ctc_greedy(pk.ctc_logits(net, mel.transpose(1, 2)), cfg.blank_id)
            if tok is not None:
                return [tok.decode(s) for s in seqs]
            return [" ".join(map(str, s)) for s in seqs]

    return _ParakeetCtcEngine()


def _gigaam_engine(model_id, path, raw, params, dev) -> EngineProtocol:
    """GigaAM's conformer CTC over the Parakeet encoder, on the torchaudio
    MelSpectrogram recipe it trains on; ids map to text through the
    bundle's label list (blank is the last id)."""
    from ..dsp.asr_frontend import gigaam_log_mel
    from ..models import parakeet as pk

    cfg = pk.ParakeetConfig(**raw.get("encoder", {}))
    labels = raw["labels"]
    net = pk.params_to_module(params, cfg, dev)

    class _GigaamEngine(EngineProtocol):
        name = model_id
        model = net

        def transcribe_batch(self, chunks, language="ru"):
            feats = gigaam_log_mel(_on_device(chunks, dev), cfg.n_mels).transpose(1, 2)
            seqs = pk.ctc_greedy(pk.ctc_logits(net, feats), cfg.blank_id)
            return ["".join(labels[i] for i in s if i < len(labels)).strip() for s in seqs]

    return _GigaamEngine()


def _canary_engine(model_id, path, raw, params, dev) -> EngineProtocol:
    from ..dsp.asr_frontend import nemo_log_mel
    from ..models import canary as cn
    from ..models import parakeet as pk
    from ..models.spm import SentencePieceVocab

    raw = dict(raw)
    prompt_ids = raw.pop("prompt_ids", None)
    if "config" in raw:
        cfg = cn.CONFIGS[raw["config"]]
    else:
        cfg = cn.CanaryConfig(encoder=pk.ParakeetConfig(**raw.pop("encoder", {})), **raw)
    if prompt_ids is None:
        prompt_ids = [cfg.bos]
    net = cn.params_to_module(params, cfg, dev)
    vocab = SentencePieceVocab.load(path / "tokenizer.model")
    pieces = list(vocab.pieces)

    def _prompt_for_language(language: str):
        """Swap <|lang|> slots in the canary prompt when the vocab has the
        requested language token (the ONNX enc-dec engine's contract)."""
        if language == "en" or f"<|{language}|>" not in pieces:
            return prompt_ids
        en, lang = (pieces.index("<|en|>") if "<|en|>" in pieces else -1,
                    pieces.index(f"<|{language}|>"))
        if en < 0:
            return prompt_ids
        return [lang if t == en else t for t in prompt_ids]

    class _CanaryEngine(EngineProtocol):
        name = model_id
        model = net
        prompt_for_language = staticmethod(_prompt_for_language)

        def transcribe_batch(self, chunks, language="en"):
            a = _on_device(chunks, dev)
            feats = nemo_log_mel(a, cfg.encoder.n_mels).transpose(1, 2)
            prompt = torch.tensor(self.prompt_for_language(language), dtype=torch.long,
                                  device=dev).expand(a.shape[0], -1)
            tokens, lengths = cn.greedy_decode(net, feats, prompt=prompt)
            tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
            return [vocab.decode(row[:n]) for row, n in zip(tokens, lengths)]

    return _CanaryEngine()


def _sensevoice_engine(model_id, path, raw, params, dev) -> EngineProtocol:
    from ..dsp.fbank import fbank
    from ..models import sensevoice as sv
    from ..models.spm import SentencePieceVocab

    cfg = (sv.CONFIGS[raw["config"]] if "config" in raw
           else sv.SenseVoiceConfig(**{k: v for k, v in raw.items() if k != "prompt_ids"}))
    prompt_ids = torch.tensor(raw.get("prompt_ids", [0] * cfg.n_prompt), dtype=torch.long,
                              device=dev)
    net = sv.params_to_module(params, cfg, dev)
    vocab = SentencePieceVocab.load(path / "tokenizer.model")

    class _SenseVoiceEngine(EngineProtocol):
        name = model_id
        model = net

        def transcribe_batch(self, chunks, language="en"):
            logits = sv.ctc_logits(net, fbank(_on_device(chunks, dev), cfg.feat_dim),
                                   prompt_ids)
            return [vocab.decode(s) for s in sv.ctc_greedy(logits, cfg)]

    return _SenseVoiceEngine()


# ---------------------------------------------------------------------------
# Manager
# ---------------------------------------------------------------------------

@dataclass
class TranscriptionState:
    status: str
    progress: float = 0.0
    eta_seconds: Optional[int] = None
    phase: Optional[str] = None


class TranscriptionManager:
    """Loaded engine + per-recording state/cancel registry. ``device``
    (default: the card) is where engines load and recordings resample."""

    def __init__(self, model_manager: ModelManager, bus: EventBus = BUS,
                 engine_loader: Optional[Callable] = None, device=None):
        self.model_manager = model_manager
        self.bus = bus
        self.device = resolve_device(device)
        self._engine: Optional[EngineProtocol] = None
        self._current_model_id: Optional[str] = None
        self._states: Dict[str, TranscriptionState] = {}
        self._cancel: Dict[str, threading.Event] = {}
        self._lock = threading.Lock()
        self._loader = engine_loader or (
            lambda mid, mm: load_engine(mid, mm, device=self.device))

    # -- model ------------------------------------------------------------------
    def get_current_model(self) -> Optional[str]:
        return self._current_model_id

    def load_model(self, model_id: str) -> None:
        if self._current_model_id == model_id and self._engine is not None:
            return
        self._engine = self._loader(model_id, self.model_manager)
        self._current_model_id = model_id

    @property
    def engine(self) -> Optional[EngineProtocol]:
        return self._engine

    # -- state ------------------------------------------------------------------
    def set_state(self, recording_path: str, state: TranscriptionState) -> None:
        with self._lock:
            self._states[recording_path] = state

    def get_state(self, recording_path: str) -> Optional[TranscriptionState]:
        with self._lock:
            return self._states.get(recording_path)

    def get_all_states(self) -> Dict[str, dict]:
        with self._lock:
            return {k: asdict(v) for k, v in self._states.items()}

    def create_cancel_flag(self, recording_path: str) -> threading.Event:
        ev = threading.Event()
        with self._lock:
            self._cancel[recording_path] = ev
        return ev

    def cancel(self, recording_path: str) -> bool:
        with self._lock:
            ev = self._cancel.get(recording_path)
        if ev is not None:
            ev.set()
            return True
        return False

    def remove_cancel_flag(self, recording_path: str) -> None:
        with self._lock:
            self._cancel.pop(recording_path, None)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

def run_transcription(
    recording_path: str,
    tm: TranscriptionManager,
    model_id: str,
    language: str = "en",
    diarization: Optional[dict] = None,
    batch_chunks: int = 8,
) -> Optional[str]:
    """Blocking transcription of one recording. Returns the final text
    (None on cancel); raises on errors. Emits the reference's event stream.
    ``diarization={"enabled": True, "max_speakers": 4, "merge_gap": 1.0}``
    tags the text with speakers (diarized on the manager's device); if
    diarization fails, the plain transcript is kept and a
    ``diarization-fallback`` event carries the error."""
    diarize = bool(diarization and diarization.get("enabled"))
    bus = tm.bus
    cancel = tm.create_cancel_flag(recording_path)

    def set_phase(phase: str):
        tm.set_state(recording_path, TranscriptionState("transcribing", prog[0], None, phase))
        bus.emit("transcription-phase", {"recording_path": recording_path, "phase": phase})

    prog = [0.0]
    try:
        tm.set_state(recording_path, TranscriptionState("started", 0.0, None, "preparing-audio"))
        bus.emit("transcription-status",
                 {"recording_path": recording_path, "status": "started", "error": None})
        set_phase("preparing-audio")

        audio, sr = wavio.read_wav_mono(recording_path)  # channel 0
        if audio.size == 0:
            save_transcription_result(recording_path, "")
            save_transcription_metadata(recording_path, model_id)
            _finish(tm, bus, recording_path, "completed")
            return ""
        total_seconds = audio.size / sr

        set_phase("loading-model")
        tm.load_model(model_id)

        if sr != TARGET_SAMPLE_RATE:
            from ..dsp.resample import resample_poly

            # 16-bit sources upload as int16 PCM (exact: the decoded floats
            # sit on the int16 grid), half the bytes; the 16 kHz result stays
            # on the device, where the chunk batches are decoded.
            fmt = wavio.read_format(recording_path)
            wire = "i16" if fmt is not None and fmt.bits_per_sample == 16 else "f32"
            with stage("resample", bus, {"samples": int(audio.size)}):
                audio = resample_poly(audio, sr, TARGET_SAMPLE_RATE, wire=wire,
                                      device_out=True, device=tm.device)
        total_out = int(audio.shape[0])

        # 30 s chunks, final partial chunk zero-padded (tail flush,
        # commands/transcription.rs:347-400). Device audio chunks on the
        # device; host audio stays on the host (engines accept either).
        n_chunks = max(1, -(-total_out // CHUNK_SAMPLES))
        if isinstance(audio, torch.Tensor):
            chunks = F.pad(audio, (0, n_chunks * CHUNK_SAMPLES - total_out)).reshape(
                n_chunks, CHUNK_SAMPLES)
        else:
            chunks = np.zeros((n_chunks, CHUNK_SAMPLES), np.float32)
            chunks.reshape(-1)[:total_out] = audio

        set_phase("transcribing")
        # Chunk-level checkpoint/resume: a cancelled or crashed job restarts
        # from its last completed batch, not from zero.
        parts: List[Tuple[float, float, str]] = []
        resume_chunk = 0
        ckpt = _load_progress(recording_path)
        if (ckpt and ckpt.get("model_id") == model_id
                and ckpt.get("language") == language
                and ckpt.get("n_chunks") == n_chunks
                and bool(ckpt.get("diarization")) == diarize):
            parts = [(float(s), float(e), t) for s, e, t in ckpt.get("parts", [])]
            resume_chunk = min(int(ckpt.get("done_chunks", 0)), n_chunks)
        start_t = time.monotonic()
        # Batch schedule: the engine's preferred large bucket while more
        # than `batch_chunks` chunks remain, the `batch_chunks` bucket for
        # the tail, exact shape for short files.
        big = max(getattr(tm.engine, "decode_batch_bucket", 0) or 0, batch_chunks)
        b0 = resume_chunk
        while b0 < n_chunks:
            if cancel.is_set():
                _finish(tm, bus, recording_path, "cancelled")
                return None
            rem = n_chunks - b0
            if n_chunks <= batch_chunks:
                bsz = rem  # short file: one exact-shape batch
            elif rem > batch_chunks:
                bsz = big
            else:
                bsz = batch_chunks
            batch = chunks[b0: b0 + bsz]
            n_live = batch.shape[0]
            if n_live < bsz:
                # pad the tail batch to the bucket shape; pad rows are dropped
                if isinstance(batch, torch.Tensor):
                    batch = F.pad(batch, (0, 0, 0, bsz - n_live))
                else:
                    batch = np.concatenate(
                        [batch, np.zeros((bsz - n_live, CHUNK_SAMPLES), np.float32)])
            if diarize:
                # timestamped segments for speaker alignment (:272-280),
                # the whole batch in one call
                offsets = [(b0 + j) * TRANSCRIBE_CHUNK_SECONDS for j in range(bsz)]
                with stage("transcribe-batch-timestamps", bus, {"chunks": n_live}):
                    seg_lists = tm.engine.transcribe_batch_with_timestamps(
                        batch, offsets, language=language)[:n_live]
                n_done = len(seg_lists)
                for segs in seg_lists:
                    for s, e, text in segs:
                        if text.strip():
                            parts.append((s, min(e, total_seconds), text))
            else:
                with stage("transcribe-batch", bus, {"chunks": n_live}):
                    texts = tm.engine.transcribe_batch(batch, language=language)[:n_live]
                n_done = len(texts)
                for j, text in enumerate(texts):
                    cs = (b0 + j) * TRANSCRIBE_CHUNK_SECONDS
                    if text.strip():
                        parts.append((cs, min(cs + TRANSCRIBE_CHUNK_SECONDS, total_seconds),
                                      text))
            done_chunks = b0 + n_done
            _save_progress(recording_path, {
                "model_id": model_id, "language": language,
                "n_chunks": n_chunks, "done_chunks": done_chunks,
                "diarization": diarize,
                "parts": [[s, e, t] for s, e, t in parts],
            })
            done_samples = min(done_chunks * CHUNK_SAMPLES, total_out)
            progress = min(1.0, done_samples / max(total_out, 1))
            done_sec = done_samples / TARGET_SAMPLE_RATE
            # ETA from the rate realized in this run (:287-299); resumed
            # chunks took no wall time here.
            sess_sec = done_sec - resume_chunk * TRANSCRIBE_CHUNK_SECONDS
            eta = None
            if sess_sec > 0.5:
                rate = (time.monotonic() - start_t) / sess_sec
                eta = int(round(max(total_seconds - done_sec, 0.0) * rate))
            prog[0] = progress
            tm.set_state(recording_path,
                         TranscriptionState("transcribing", progress, eta, "transcribing"))
            bus.emit("transcription-progress",
                     {"recording_path": recording_path, "progress": progress,
                      "eta_seconds": eta})
            b0 += n_live

        text = " ".join(t for _, _, t in parts).strip()

        if diarize:
            set_phase("diarizing")
            from . import diarization as dz

            try:
                text = dz.run_diarization(
                    audio, TARGET_SAMPLE_RATE, parts, model_manager=tm.model_manager,
                    max_speakers=int(diarization.get("max_speakers", 4)),
                    merge_gap=float(diarization.get("merge_gap", 1.0)),
                    bus=bus, device=tm.device)
            except Exception as dz_err:
                # the product keeps the plain transcript when diarization
                # fails (commands/transcription.rs:456-465), and says so
                bus.emit("diarization-fallback",
                         {"recording_path": recording_path, "net": "pipeline",
                          "error": str(dz_err)})
        save_transcription_result(recording_path, text)
        save_transcription_metadata(recording_path, model_id)
        clear_transcription_progress(recording_path)  # checkpoint consumed
        _finish(tm, bus, recording_path, "completed")
        return text
    except Exception as e:
        tm.set_state(recording_path, TranscriptionState("error", prog[0]))
        bus.emit("transcription-status",
                 {"recording_path": recording_path, "status": "error", "error": str(e)})
        raise
    finally:
        tm.remove_cancel_flag(recording_path)


def _finish(tm, bus, recording_path, status):
    tm.set_state(recording_path, TranscriptionState(status, 1.0 if status == "completed" else 0.0))
    bus.emit("transcription-status",
             {"recording_path": recording_path, "status": status, "error": None})


def start_transcription(recording_path: str, tm: TranscriptionManager, model_id: str,
                        **kwargs) -> threading.Thread:
    """Spawn the worker thread (commands/transcription.rs:32-96)."""
    t = threading.Thread(
        target=lambda: _guarded(run_transcription, recording_path, tm, model_id, **kwargs),
        daemon=True,
    )
    t.start()
    return t


def _guarded(fn, *a, **kw):
    try:
        fn(*a, **kw)
    except Exception:
        pass  # state/events already record the error
