"""Model catalog: the port's copy of the catalog half of
``crispy_tpu/models/registry.py``.

The reference's ModelManager (src-tauri/src/managers/model.rs) lists 13
models with size/accuracy/speed metadata (model.rs:74-346) and downloads
them. The port keeps the catalog and the queries that find a model on disk
under ``<data root>/Models``; downloads come with the product surface
(ROADMAP queue 1, item 12).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from pathlib import Path
from typing import List, Optional

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


class ModelManager:
    """Catalog queries against the models directory."""

    def __init__(self, models_dir: Optional[Path] = None):
        self.models_dir = Path(models_dir) if models_dir else paths.models_dir()

    def get_available_models(self) -> List[dict]:
        return [m.to_dict(self.is_downloaded(m.id)) for m in CATALOG]

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
