"""Settings store.

The port's copy of ``crispy_tpu/utils/settings.py``: the same JSON on disk,
so a settings file written by either package loads in the other.

Rebuild of the reference settings subsystem (src-tauri/src/settings.rs):
a single ``settings.json`` under the Crispy root holding ``{llm, app}``,
with

  * a process-wide lock serializing read-modify-write cycles
    (settings.rs:11,203-206),
  * atomic temp+rename saves (settings.rs:176-185),
  * corrupt files preserved as ``settings.json.corrupt`` (settings.rs:166-173),
  * forward-compatible defaults for missing keys (settings.rs:37-46),
  * a key-routed ``update_app_setting`` with an explicit 11-key allowlist
    (settings.rs:202-222), and
  * ``api_key`` omitted from public LLM settings reads (settings.rs:86-90).
"""

from __future__ import annotations

import dataclasses
import json
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional

from . import paths

_SETTINGS_LOCK = threading.Lock()


@dataclass
class LlmSettings:
    endpoint: str = "https://api.openai.com/v1"
    api_key: str = ""
    model: str = "gpt-4"


@dataclass
class AppSettings:
    # All values are strings, mirroring the reference's string-typed store
    # (settings.rs:31-63) which the TS frontend reads verbatim.
    selected_microphone: str = ""
    selected_output_device: str = ""
    microphone_volume: str = "100"
    selected_model: str = "dummy"
    selected_transcription_model: str = "none"
    selected_recording_app: str = "none"
    autostart_enabled: str = "false"
    diarization_enabled: str = "false"
    diarization_max_speakers: str = "6"
    # persisted-but-unused, faithfully: the reference keeps the key for
    # settings compatibility but its NME-SC clustering ignores it
    # ("obsolete with spectral auto-count", diarization.rs:359)
    diarization_threshold: str = "0.50"
    diarization_merge_gap: str = "2.5"


#: The explicit allowlist of updatable app-setting keys (settings.rs:207-219).
APP_SETTING_KEYS = tuple(f.name for f in dataclasses.fields(AppSettings))


@dataclass
class SettingsFile:
    llm: LlmSettings = field(default_factory=LlmSettings)
    app: AppSettings = field(default_factory=AppSettings)

    def to_dict(self) -> Dict[str, Any]:
        return {"llm": dataclasses.asdict(self.llm), "app": dataclasses.asdict(self.app)}


def settings_file_path(root: Optional[Path] = None) -> Path:
    root = root or paths.crispy_root()
    paths.ensure_dir(root)
    return root / "settings.json"


def _from_known_fields(cls, data: Dict[str, Any]):
    """Build a dataclass from a dict, ignoring unknown keys, defaulting missing."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in data.items() if k in names and isinstance(v, str)})


def _parse(contents: str) -> Optional[SettingsFile]:
    """Parse full / llm-only / app-only layouts (settings.rs:151-164)."""
    try:
        data = json.loads(contents)
    except (json.JSONDecodeError, UnicodeDecodeError):
        return None
    if not isinstance(data, dict):
        return None
    if isinstance(data.get("llm"), dict) and isinstance(data.get("app"), dict):
        return SettingsFile(
            llm=_from_known_fields(LlmSettings, data["llm"]),
            app=_from_known_fields(AppSettings, data["app"]),
        )
    # Legacy llm-only file: {endpoint, api_key, model}
    if {"endpoint", "api_key", "model"} <= set(data):
        return SettingsFile(llm=_from_known_fields(LlmSettings, data))
    # Legacy app-only file: must contain the required (non-defaulted) keys.
    required = {
        "selected_microphone",
        "selected_output_device",
        "microphone_volume",
        "selected_model",
        "selected_transcription_model",
        "selected_recording_app",
    }
    if required <= set(data):
        return SettingsFile(app=_from_known_fields(AppSettings, data))
    return None


def load_settings_file(root: Optional[Path] = None) -> SettingsFile:
    path = settings_file_path(root)
    if not path.exists():
        return SettingsFile()
    contents = path.read_text()
    parsed = _parse(contents)
    if parsed is not None:
        return parsed
    # Preserve unparseable settings as a .corrupt backup rather than silently
    # overwriting them on the next save (settings.rs:166-173).
    backup = path.with_suffix(".json.corrupt")
    path.rename(backup)
    return SettingsFile()


def save_settings_file(settings: SettingsFile, root: Optional[Path] = None) -> None:
    path = settings_file_path(root)
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(settings.to_dict(), indent=2))
    tmp.rename(path)  # atomic on POSIX (settings.rs:176-185)


def load_llm_settings(root: Optional[Path] = None) -> LlmSettings:
    return load_settings_file(root).llm


def get_llm_settings_public(root: Optional[Path] = None) -> Dict[str, str]:
    """LLM settings with ``api_key`` omitted (settings.rs:86-90)."""
    llm = load_llm_settings(root)
    return {"endpoint": llm.endpoint, "model": llm.model}


def save_llm_settings(llm: LlmSettings, root: Optional[Path] = None) -> None:
    with _SETTINGS_LOCK:
        f = load_settings_file(root)
        f.llm = llm
        save_settings_file(f, root)


def load_app_settings(root: Optional[Path] = None) -> AppSettings:
    return load_settings_file(root).app


def update_app_setting(key: str, value: str, root: Optional[Path] = None) -> None:
    """Update one allowlisted app setting under the store lock (settings.rs:197-222)."""
    if key not in APP_SETTING_KEYS:
        raise KeyError(f"Unknown setting key: {key}")
    with _SETTINGS_LOCK:
        f = load_settings_file(root)
        setattr(f.app, key, value)
        save_settings_file(f, root)
