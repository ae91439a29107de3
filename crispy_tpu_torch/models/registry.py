"""Model catalog + download manager: the port's copy of
``crispy_tpu/models/registry.py`` (host only).

Rebuild of the reference's ModelManager (src-tauri/src/managers/model.rs):
the 13-model catalog with size/accuracy/speed metadata (model.rs:74-346),
streaming downloads to `.partial` with HTTP Range resume, 200-on-resume
restart, size verification, atomic cancel flags, progress events, tar.gz
extraction through an `.extracting` temp dir with terminal failure events
(model.rs:390-770), stale-dir cleanup (model.rs:401-403) and bundled-model
migration (model.rs:371-388). Engines load the downloaded files from
``<data root>/Models`` under their catalog file names.
"""

from __future__ import annotations

import shutil
import tarfile
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, asdict
from pathlib import Path
from typing import List, Optional, Set

from ..api.events import BUS, EventBus
from ..utils import paths


@dataclass
class ModelInfo:
    id: str
    name: str
    description: str
    filename: str  # file, or directory name for tar.gz bundles
    url: Optional[str]
    size_mb: int
    engine_type: str  # whisper | parakeet | moonshine | gigaam | sensevoice | canary | cohere | aux
    accuracy_score: float
    speed_score: float
    is_archive: bool = False  # tar.gz extracted into a directory

    def to_dict(self, downloaded: bool) -> dict:
        d = asdict(self)
        d["is_downloaded"] = downloaded
        return d


# Catalog parity with managers/model.rs:74-346 (ids, filenames, sizes,
# scores and the download host are the reference's published metadata).
CATALOG: List[ModelInfo] = [
    ModelInfo("small", "Whisper Small", "Fast with decent accuracy.",
              "ggml-small.bin", "https://s3.crispy.fyi/models/ggml-small.bin",
              487, "whisper", 0.60, 0.85),
    ModelInfo("medium", "Whisper Medium", "Good accuracy, medium speed.",
              "whisper-medium-q4_1.bin", "https://s3.crispy.fyi/models/whisper-medium-q4_1.bin",
              492, "whisper", 0.75, 0.60),
    ModelInfo("turbo", "Whisper Turbo", "Balanced accuracy and speed.",
              "ggml-large-v3-turbo.bin", "https://s3.crispy.fyi/models/ggml-large-v3-turbo.bin",
              1600, "whisper", 0.80, 0.40),
    ModelInfo("large", "Whisper Large", "Good accuracy, but slow.",
              "ggml-large-v3-q5_0.bin", "https://s3.crispy.fyi/models/ggml-large-v3-q5_0.bin",
              1100, "whisper", 0.85, 0.30),
    ModelInfo("parakeet-tdt-0.6b-v2", "Parakeet V2", "Fast and accurate (English).",
              "parakeet-tdt-0.6b-v2-int8", "https://s3.crispy.fyi/models/parakeet-v2-int8.tar.gz",
              473, "parakeet", 0.85, 0.85, is_archive=True),
    ModelInfo("parakeet-tdt-0.6b-v3", "Parakeet V3", "Fast and accurate (multilingual).",
              "parakeet-tdt-0.6b-v3-int8", "https://s3.crispy.fyi/models/parakeet-v3-int8.tar.gz",
              478, "parakeet", 0.80, 0.85, is_archive=True),
    ModelInfo("moonshine-base", "Moonshine Base", "Tiny and fast (English).",
              "moonshine-base", "https://s3.crispy.fyi/models/moonshine-base.tar.gz",
              58, "moonshine", 0.70, 0.90, is_archive=True),
    ModelInfo("gigaam-v3-e2e-ctc", "GigaAM v3", "Russian speech recognition.",
              "giga-am-v3-int8", "https://s3.crispy.fyi/models/giga-am-v3-int8.tar.gz",
              151, "gigaam", 0.85, 0.75, is_archive=True),
    ModelInfo("sense-voice-int8", "SenseVoice", "Fast multilingual recognition.",
              "sense-voice-int8", "https://s3.crispy.fyi/models/sense-voice-int8.tar.gz",
              152, "sensevoice", 0.65, 0.95, is_archive=True),
    ModelInfo("canary-180m-flash", "Canary 180M Flash", "Small multilingual model.",
              "canary-180m-flash", "https://s3.crispy.fyi/models/canary-180m-flash.tar.gz",
              146, "canary", 0.75, 0.85, is_archive=True),
    ModelInfo("canary-1b-v2", "Canary 1B v2", "Large multilingual model.",
              "canary-1b-v2", "https://s3.crispy.fyi/models/canary-1b-v2.tar.gz",
              691, "canary", 0.85, 0.70, is_archive=True),
    ModelInfo("cohere-int8", "Cohere", "Highest accuracy, slower.",
              "cohere-int8", "https://s3.crispy.fyi/models/cohere-int8.tar.gz",
              1708, "cohere", 0.90, 0.60, is_archive=True),
    ModelInfo("diarize-segmentation", "Diarization: Segmentation",
              "Speech segmentation for diarization.",
              "segmentation-3.0.onnx", "https://s3.crispy.fyi/models/segmentation-3.0.onnx",
              6, "aux", 0.0, 0.0),
    ModelInfo("diarize-embedding", "Diarization: Speaker Embedding",
              "Speaker embeddings for diarization.",
              "wespeaker_en_voxceleb_CAM++.onnx",
              "https://s3.crispy.fyi/models/wespeaker_en_voxceleb_CAM++.onnx",
              28, "aux", 0.0, 0.0),
]

NS_MODEL_CATALOG = [
    {"id": "dummy", "name": "Dummy (passthrough)", "description": "No processing."},
    {"id": "noisy", "name": "Noisy (test)", "description": "Adds synthetic noise."},
    {"id": "rnnoise", "name": "RNNoise", "description": "Neural noise suppression."},
]

RECOMMENDED_FIRST_MODEL = "parakeet-tdt-0.6b-v3"  # commands/models.rs:140-146


class DownloadCancelled(Exception):
    pass


class ModelManager:
    """Catalog queries + download lifecycle with resume/cancel/extract."""

    def __init__(self, models_dir: Optional[Path] = None, bus: EventBus = BUS):
        self.models_dir = Path(models_dir) if models_dir else paths.models_dir()
        self.bus = bus
        self._cancel: Set[str] = set()
        self._lock = threading.Lock()
        self.cleanup_stale()

    # -- catalog ---------------------------------------------------------------
    def get_available_models(self) -> List[dict]:
        return [m.to_dict(self.is_downloaded(m.id)) for m in CATALOG]

    def get_model_info(self, model_id: str) -> Optional[dict]:
        m = self.find(model_id)
        return m.to_dict(self.is_downloaded(model_id)) if m else None

    @staticmethod
    def find(model_id: str) -> Optional[ModelInfo]:
        return next((m for m in CATALOG if m.id == model_id), None)

    def model_path(self, model_id: str) -> Optional[Path]:
        m = self.find(model_id)
        return self.models_dir / m.filename if m else None

    def is_downloaded(self, model_id: str) -> bool:
        p = self.model_path(model_id)
        if p is None:
            return False
        m = self.find(model_id)
        return p.is_dir() if m.is_archive else p.is_file()

    # -- lifecycle ---------------------------------------------------------------
    def cleanup_stale(self) -> None:
        """Remove leftover .extracting dirs from crashed runs (model.rs:401-403)."""
        if self.models_dir.exists():
            for d in self.models_dir.glob("*.extracting"):
                shutil.rmtree(d, ignore_errors=True)

    def migrate_bundled(self, resources_dir: Path) -> None:
        """Copy bundled models into the user dir on first run (model.rs:371-388)."""
        src = Path(resources_dir) / "models"
        if not src.is_dir():
            return
        paths.ensure_dir(self.models_dir)
        for f in src.iterdir():
            dst = self.models_dir / f.name
            if f.is_file() and not dst.exists():
                shutil.copy2(f, dst)

    def cancel_download(self, model_id: str) -> None:
        with self._lock:
            self._cancel.add(model_id)

    def delete_model(self, model_id: str) -> bool:
        p = self.model_path(model_id)
        if p is None:
            return False
        if p.is_dir():
            shutil.rmtree(p, ignore_errors=True)
        elif p.is_file():
            p.unlink()
        else:
            return False
        self.bus.emit("model-state-changed",
                      {"event_type": "deleted", "model_id": model_id,
                       "model_name": None, "error": None})
        return True

    # -- download ---------------------------------------------------------------
    def download_model(self, model_id: str, chunk_size: int = 1 << 16,
                       progress_every: float = 0.1) -> Path:
        """Blocking streaming download with Range resume + tar.gz extraction.

        Events: model-download-progress {model_id, downloaded, total, percentage},
        model-extraction-started/-completed/-failed, model-state-changed.
        Resume: existing `.partial` continues via Range; a 200 (full) response
        on resume restarts from zero (model.rs:462-547).
        """
        m = self.find(model_id)
        if m is None or not m.url:
            raise ValueError(f"unknown or undownloadable model: {model_id}")
        with self._lock:
            # a cancel issued while nothing was in flight (or racing a
            # completed download) must not kill THIS download at chunk 1
            self._cancel.discard(model_id)
        paths.ensure_dir(self.models_dir)
        final = self.models_dir / m.filename
        dl_name = m.url.rsplit("/", 1)[-1]
        partial = self.models_dir / (dl_name + ".partial")

        offset = partial.stat().st_size if partial.exists() else 0
        req = urllib.request.Request(m.url)
        if offset:
            req.add_header("Range", f"bytes={offset}-")
        resp = urllib.request.urlopen(req)
        status = getattr(resp, "status", 200)
        if offset and status == 200:
            offset = 0  # server ignored Range: restart (model.rs:516-529)
        clen = resp.headers.get("Content-Length")
        # no Content-Length (chunked 206): total unknown — 0 disables the
        # size check instead of spuriously failing at total == offset
        total = offset + int(clen) if clen else 0

        mode = "ab" if offset else "wb"
        last_emit = 0.0
        downloaded = offset
        try:
            with open(partial, mode) as f:
                while True:
                    with self._lock:
                        if model_id in self._cancel:
                            self._cancel.discard(model_id)
                            raise DownloadCancelled(model_id)
                    chunk = resp.read(chunk_size)
                    if not chunk:
                        break
                    f.write(chunk)
                    downloaded += len(chunk)
                    now = time.monotonic()
                    if now - last_emit >= progress_every or downloaded == total:
                        last_emit = now
                        self.bus.emit("model-download-progress", {
                            "model_id": model_id, "downloaded": downloaded,
                            "total": total,
                            "percentage": 100.0 * downloaded / total if total else 0.0,
                        })
        except DownloadCancelled:
            self.bus.emit("model-state-changed",
                          {"event_type": "cancelled", "model_id": model_id,
                           "model_name": None, "error": None})
            raise
        finally:
            resp.close()

        if total and downloaded != total:
            raise IOError(f"size mismatch: got {downloaded}, expected {total}")

        if m.is_archive or dl_name.endswith(".tar.gz"):
            # bare id: the reference's payload shape (model.rs:620)
            self.bus.emit("model-extraction-started", model_id)
            tmp = self.models_dir / (m.filename + ".extracting")
            try:
                shutil.rmtree(tmp, ignore_errors=True)
                tmp.mkdir(parents=True)
                with tarfile.open(partial, "r:gz") as tar:
                    tar.extractall(tmp, filter="data")
                # archives may contain one top-level directory (whatever
                # its name — it need not match ModelInfo.filename) or bare
                # files at the root
                entries = [p for p in tmp.iterdir()]
                if len(entries) == 1 and entries[0].is_dir():
                    src = entries[0]
                else:
                    src = tmp
                if final.exists():
                    shutil.rmtree(final, ignore_errors=True)
                src.rename(final)
                if src != tmp:
                    shutil.rmtree(tmp, ignore_errors=True)
                partial.unlink(missing_ok=True)
            except Exception as e:
                shutil.rmtree(tmp, ignore_errors=True)
                self.bus.emit("model-extraction-failed",
                              {"model_id": model_id, "error": str(e)})
                raise
            # bare id: the reference's payload shape (model.rs:674)
            self.bus.emit("model-extraction-completed", model_id)
        else:
            partial.replace(final)

        # bare id, like the reference (model.rs:688); state-changed carries
        # the richer object for this framework's own consumers
        self.bus.emit("model-download-complete", model_id)
        self.bus.emit("model-state-changed",
                      {"event_type": "downloaded", "model_id": model_id,
                       "model_name": None, "error": None})
        return final


class SelectedModelState:
    """The app-wide active model slot (commands/models.rs:16-30)."""

    def __init__(self, bus: EventBus = BUS):
        self._id: Optional[str] = None
        self._lock = threading.Lock()
        self.bus = bus

    def set(self, model_id: Optional[str], model_name: Optional[str] = None) -> None:
        """Select a model, emitting the reference's ModelStateEvent shape
        (commands/models.rs:8-13,55-117): {event_type, model_id, model_name,
        error} with event_type unloaded | loading_started | loading_completed."""
        with self._lock:
            self._id = None if model_id in (None, "none") else model_id
            mid = self._id
        if mid is None:
            self.bus.emit("model-state-changed",
                          {"event_type": "unloaded", "model_id": None,
                           "model_name": None, "error": None})
            return
        for et in ("loading_started", "loading_completed"):
            self.bus.emit("model-state-changed",
                          {"event_type": et, "model_id": mid,
                           "model_name": model_name, "error": None})

    def get(self) -> Optional[str]:
        with self._lock:
            return self._id
