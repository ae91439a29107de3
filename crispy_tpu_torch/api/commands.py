"""The reference's full command surface (main.rs:372-425) as one app object:
the port of ``crispy_tpu/api/commands.py``.

Every `#[tauri::command]` in the reference's invoke_handler maps to a
method of the same name and signature shape. Desktop-only concerns
(windows, OS permissions, system mixer, loopback drivers) exist as honest
server-side analogs: permissions are always granted, window commands track
visibility flags, system input volume persists in settings.

``device`` None means the CUDA card. The engines that run on it, the
transcription manager and the monitoring engine, are built at their first
use, which resolves the device and raises there when there is no card;
commands that need no engine (the catalog, downloads, selection, settings,
recordings, conversion, the update check) run on a host without one.

``mesh`` is the JAX package's: a ``parallel.Mesh`` for transcription and
diarization, or by default the lazy ``"auto"`` (every visible card once
there are two or more, resolved at first engine use); ``CRISPY_MESH=off``
(or ``0``, ``none``, ``false``) opts out.

Usage:
    app = CrispyApp()
    app.start_monitoring(device_name="Default", model_name="rnnoise", volume=1.0)
    app.start_transcription(recording_path=...)
    app.bus.listen("transcription-progress", print)
"""

from __future__ import annotations

import os
import platform as _platform
import threading
from pathlib import Path
from typing import Dict, List, Optional

from ..api.events import BUS, EventBus
from ..engine import chat as chat_mod
from ..engine import convert as convert_mod
from ..engine import monitoring as mon_mod
from ..engine import recording as rec_mod
from ..engine import transcription as tr_mod
from ..models import registry as reg_mod
from ..parallel import check_device
from ..utils import paths, settings as settings_mod, updater as updater_mod
from .window import WindowManager


class CrispyApp:
    """Managed state bundle (the tauri::State singletons, main.rs:227-242)."""

    def __init__(self, bus: Optional[EventBus] = None, data_root: Optional[Path] = None,
                 device=None, mesh=None):
        self.bus = bus or BUS
        self._data_root = data_root
        self.device = device  # None: the card, resolved by the engines at first use
        if mesh is None:
            flag = os.environ.get("CRISPY_MESH", "auto").lower()
            mesh = None if flag in ("off", "0", "none", "false") else "auto"
        elif not isinstance(mesh, str):
            check_device(mesh, device)
        self.mesh = mesh  # Mesh | None | the lazy "auto"
        self.model_manager = reg_mod.ModelManager(bus=self.bus)
        self.selected_model = reg_mod.SelectedModelState(bus=self.bus)
        self.recording_state = rec_mod.RecordingState()
        self.device_registry = mon_mod.DeviceRegistry()
        self._transcription_manager: Optional[tr_mod.TranscriptionManager] = None
        self._monitoring: Optional[mon_mod.MonitoringEngine] = None
        self._engines_lock = threading.Lock()
        self.windows = WindowManager(bus=self.bus)
        self._main_window_visible = True
        self._quit_requested = False
        self._autostart = False
        self._system_input_volume = 1.0
        # Restore the persisted model selection (main.rs saved-model restore).
        st = settings_mod.load_app_settings(self._data_root)
        if st.selected_transcription_model and st.selected_transcription_model != "none":
            self.selected_model.set(st.selected_transcription_model)

    # -- engines, built at first use ---------------------------------------------
    @property
    def transcription_manager(self) -> tr_mod.TranscriptionManager:
        with self._engines_lock:
            if self._transcription_manager is None:
                self._transcription_manager = tr_mod.TranscriptionManager(
                    self.model_manager, bus=self.bus, device=self.device, mesh=self.mesh)
            return self._transcription_manager

    def resolved_mesh(self):
        """Resolve (and keep) the lazy "auto" mesh and hand it to the
        transcription manager (built later, it takes it then); the first
        call looks at the cards."""
        self.mesh = tr_mod.resolve_mesh(self.mesh, self.device)
        with self._engines_lock:
            if self._transcription_manager is not None:
                self._transcription_manager.mesh = self.mesh
        return self.mesh

    @property
    def monitoring(self) -> mon_mod.MonitoringEngine:
        # Monitoring feeds the recording mic ring (the reference's
        # push_mono_to_buffers, audio.rs:682-730): recordings capture the
        # denoised mic whenever monitoring runs; the ring's 10 s cap bounds
        # it between recordings and do_start_recording clears it.
        with self._engines_lock:
            if self._monitoring is None:
                self._monitoring = mon_mod.MonitoringEngine(
                    registry=self.device_registry, bus=self.bus,
                    mic_tap=self.recording_state.mic_ring.push, device=self.device)
            return self._monitoring

    # -- audio ----------------------------------------------------------------
    def get_platform(self) -> str:
        # platform.system() → Darwin/Windows/Linux (never sys.platform's
        # "win32"); only darwin needs renaming
        return {"darwin": "macos"}.get(_platform.system().lower(),
                                       _platform.system().lower())

    def get_input_devices(self) -> List[str]:
        return self.device_registry.get_input_devices()

    def get_output_devices(self) -> List[str]:
        return self.device_registry.get_output_devices()

    def get_default_devices(self) -> Dict[str, Optional[str]]:
        return self.device_registry.get_default_devices()

    def start_monitoring(self, device_name: str = "Default",
                         output_device_name: str = "Default",
                         model_name: str = "rnnoise", volume: float = 1.0) -> None:
        self.monitoring.start_monitoring(device_name, output_device_name, model_name, volume)

    def stop_monitoring(self) -> None:
        if self._monitoring is not None:  # nothing runs before the engine exists
            self._monitoring.stop_monitoring()

    def set_monitoring_volume(self, volume: float) -> None:
        self.monitoring.set_monitoring_volume(volume)

    def set_monitoring_model(self, model_name: str) -> None:
        self.monitoring.set_monitoring_model(model_name)

    def get_system_input_volume(self) -> float:
        # The reference sets the OS mixer (system_input_volume.rs:17-92);
        # servers have no mixer — the value is app-held.
        return self._system_input_volume

    def set_system_input_volume(self, volume: float) -> None:
        self._system_input_volume = float(min(max(volume, 0.0), 1.0))

    def get_blackhole_status(self) -> Dict[str, bool]:
        return self.monitoring.get_blackhole_status()

    # -- recording ---------------------------------------------------------------
    def get_recordable_apps(self) -> List[dict]:
        # reference RecordableApp shape: {id, name, bundle_id}
        # (recording.rs:42-46)
        return [{"id": a.id, "name": a.name, "bundle_id": a.bundle_id}
                for a in rec_mod.get_recordable_apps()]

    def start_recording(self, app_id: str = "") -> str:
        # registered virtual app sources resolve by id (the bundle_id→PID
        # analog); unknown/empty ids degrade to mic-only like the reference
        source = rec_mod.resolve_app_source(app_id)
        return str(rec_mod.do_start_recording(self.recording_state, app_source=source))

    def stop_recording(self) -> str:
        return rec_mod.do_stop_recording(self.recording_state)

    def is_recording(self) -> bool:
        return rec_mod.is_recording(self.recording_state)

    def get_recordings_dir_path(self) -> str:
        return str(paths.recordings_dir())

    def open_recordings_dir(self) -> None:  # desktop shell-open: no-op on servers
        paths.ensure_dir(paths.recordings_dir())

    def open_url(self, url: str) -> None:
        pass  # no desktop browser on a server host

    def get_recordings(self) -> List[dict]:
        return rec_mod.get_recordings(self.recording_state)

    def rename_recording(self, path: str, new_name: str) -> str:
        return rec_mod.rename_recording(path, new_name)

    def delete_recording(self, path: str) -> None:
        rec_mod.delete_recording(path)

    # -- window ------------------------------------------------------------------
    def show_main_window_cmd(self) -> None:
        self._main_window_visible = True
        self.windows.show_main()

    def get_window_state(self) -> Dict[str, bool]:
        """Window-state snapshot for the web window router (the reference
        reads this implicitly from the compositor; served pages ask)."""
        return self.windows.snapshot()

    def notify_tray_popup_shown(self) -> None:
        """The /tray page loaded — the analog of the tray-click showing the
        popup (main.rs:355-360); arms the 600 ms blur grace window."""
        self.windows.show_tray_popup()

    def notify_tray_popup_blurred(self) -> bool:
        """Focus left the /tray page; honored only after the grace window
        (window.rs blur handling). Returns whether the popup hid."""
        return self.windows.tray_popup_blurred()

    def quit_app(self) -> None:
        self._quit_requested = True
        self.stop_monitoring()

    # -- models ------------------------------------------------------------------
    def get_available_models(self) -> List[dict]:
        return self.model_manager.get_available_models()

    def get_available_ns_models(self) -> List[dict]:
        return list(reg_mod.NS_MODEL_CATALOG)

    def get_model_info(self, model_id: str) -> Optional[dict]:
        return self.model_manager.get_model_info(model_id)

    def download_model(self, model_id: str) -> threading.Thread:
        t = threading.Thread(
            target=lambda: self._guarded_download(model_id), daemon=True
        )
        t.start()
        return t

    def _guarded_download(self, model_id: str) -> None:
        try:
            self.model_manager.download_model(model_id)
        except Exception as e:
            self.bus.emit("model-state-changed",
                          {"event_type": "error", "model_id": model_id,
                           "model_name": None, "error": str(e)})

    def delete_model(self, model_id: str) -> bool:
        ok = self.model_manager.delete_model(model_id)
        if self.selected_model.get() == model_id:
            self.selected_model.set(None)  # delete clears selection...
            # ...including the PERSISTED one — otherwise a restart restores
            # the deleted model as active and transcription fails at load
            settings_mod.update_app_setting("selected_transcription_model",
                                            "none", self._data_root)
        return ok

    def set_active_model(self, model_id: str) -> None:
        info = self.model_manager.get_model_info(model_id)
        self.selected_model.set(model_id,
                                model_name=info["name"] if info else None)
        settings_mod.update_app_setting("selected_transcription_model", model_id,
                                        self._data_root)

    def get_current_model(self) -> Optional[str]:
        return self.selected_model.get()

    def cancel_download(self, model_id: str) -> None:
        self.model_manager.cancel_download(model_id)

    def get_recommended_first_model(self) -> str:
        return reg_mod.RECOMMENDED_FIRST_MODEL

    # -- transcription -------------------------------------------------------------
    def start_transcription(self, recording_path: str,
                            language: str = "en") -> threading.Thread:
        model_id = self.selected_model.get()
        if not model_id or model_id == "none":
            raise ValueError(
                "No transcription model selected. Choose a model in the bottom left corner."
            )
        st = settings_mod.load_app_settings(self._data_root)
        diar = {
            "enabled": str(getattr(st, "diarization_enabled", "false")).lower() == "true",
            "max_speakers": int(st.diarization_max_speakers or 6),
            "merge_gap": float(st.diarization_merge_gap or 2.5),
        }
        return tr_mod.start_transcription(
            recording_path, self.transcription_manager, model_id,
            language=language, diarization=diar
        )

    def get_transcription_result(self, recording_path: str) -> Optional[str]:
        return tr_mod.load_transcription_result(recording_path)

    def has_transcription_result(self, recording_path: str) -> bool:
        return tr_mod.load_transcription_result(recording_path) is not None

    def get_transcription_model(self, recording_path: str) -> Optional[str]:
        return tr_mod.load_transcription_metadata(recording_path)

    # The state queries read the manager only once it exists: before the
    # first transcription there is no state, and nothing to put on the card.
    def get_transcription_state(self, recording_path: str) -> Optional[dict]:
        tm = self._transcription_manager
        st = None if tm is None else tm.get_state(recording_path)
        return None if st is None else st.__dict__

    def get_all_transcription_states(self) -> Dict[str, dict]:
        tm = self._transcription_manager
        return {} if tm is None else tm.get_all_states()

    def cancel_transcription(self, recording_path: str) -> bool:
        tm = self._transcription_manager
        return False if tm is None else tm.cancel(recording_path)

    def open_transcription_window(self, recording_path: str) -> None:
        self.bus.emit("transcription-open", {"recording_path": recording_path})

    def stream_transcription_chat(self, recording_path: str,
                                  messages: List[dict], chat_id: str) -> threading.Thread:
        return chat_mod.stream_transcription_chat(
            recording_path, messages, chat_id, self.bus, self._data_root
        )

    def get_transcription_chat_history(self, recording_path: str) -> List[dict]:
        return tr_mod.load_transcription_chat_history(recording_path)

    def set_transcription_chat_history(self, recording_path: str,
                                       messages: List[dict]) -> None:
        clean = [m for m in messages if m.get("role") in ("user", "assistant")]
        tr_mod.save_transcription_chat_history(recording_path, clean)

    # -- settings ---------------------------------------------------------------
    def get_llm_settings(self) -> Dict[str, str]:
        return settings_mod.get_llm_settings_public(self._data_root)  # api_key omitted

    def set_llm_settings(self, endpoint: str, api_key: str, model: str) -> None:
        settings_mod.save_llm_settings(
            settings_mod.LlmSettings(endpoint=endpoint, api_key=api_key, model=model),
            self._data_root,
        )

    def get_app_settings(self) -> Dict[str, str]:
        st = settings_mod.load_app_settings(self._data_root)
        return {k: getattr(st, k) for k in settings_mod.APP_SETTING_KEYS}

    def set_app_setting(self, key: str, value: str) -> None:
        settings_mod.update_app_setting(key, value, self._data_root)

    def set_autostart(self, enabled: bool) -> None:
        # Reference persists the flag THEN applies it via the autostart
        # plugin (commands/settings.rs:16-29); the app-held bool is the
        # server analog of the plugin side.
        settings_mod.update_app_setting(
            "autostart_enabled", "true" if enabled else "false", self._data_root)
        self._autostart = bool(enabled)

    # -- updater (X9: tauri-plugin-updater analog) -------------------------------
    def get_app_version(self) -> str:
        return updater_mod.current_version()

    def check_for_updates(self) -> Dict[str, str]:
        """Package-index update check; "offline" on a host without network
        access (utils/updater.py; main.rs:221 wires the reference's plugin)."""
        return updater_mod.check_for_updates()

    # -- convert ----------------------------------------------------------------
    def convert_to_wav(self, input_path: str) -> str:
        return str(convert_mod.convert_to_wav(input_path))

    def check_ffmpeg(self) -> bool:
        return convert_mod.check_ffmpeg()

    # -- permissions ---------------------------------------------------------------
    def check_permissions(self) -> Dict[str, object]:
        # Server processes own their audio sources: nothing to grant.
        # Reference shape (permissions.rs:7-10): microphone is a status
        # string, screen_recording a bool.
        return {"microphone": "granted", "screen_recording": True}

    def request_permission(self, permission: str) -> bool:
        # bool, like the reference (permissions.rs:33)
        return True
