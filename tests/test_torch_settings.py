"""The port's settings store (crispy_tpu_torch.utils.settings) held against
the JAX package's: the cases of tests/test_settings.py run on both packages
on the same data directory, and a file written by either loads in the other."""

import json

import pytest

from crispy_tpu.utils import settings as jset
from crispy_tpu_torch.utils import settings as tset

PKGS = pytest.mark.parametrize("mod", [jset, tset], ids=["jax", "port"])


def test_same_keys_and_defaults():
    assert tset.APP_SETTING_KEYS == jset.APP_SETTING_KEYS
    assert tset.SettingsFile().to_dict() == jset.SettingsFile().to_dict()


@PKGS
def test_defaults(data_root, mod):
    f = mod.load_settings_file()
    assert f.llm.endpoint == "https://api.openai.com/v1"
    assert f.llm.model == "gpt-4"
    assert f.app.microphone_volume == "100"
    assert f.app.selected_model == "dummy"
    assert f.app.diarization_max_speakers == "6"


@pytest.mark.parametrize("writer,reader", [(jset, tset), (tset, jset), (tset, tset)],
                         ids=["jax-to-port", "port-to-jax", "port"])
def test_roundtrip_across_packages(data_root, writer, reader):
    f = writer.SettingsFile()
    f.llm.api_key = "sk-secret"
    f.app.selected_model = "rnnnoise"
    writer.save_settings_file(f)
    writer.update_app_setting("diarization_merge_gap", "1.5")
    back = reader.load_settings_file()
    assert back.llm.api_key == "sk-secret"
    assert back.app.selected_model == "rnnnoise"
    assert back.app.diarization_merge_gap == "1.5"
    assert back.to_dict() == writer.load_settings_file().to_dict()


def test_same_bytes_on_disk(data_root, tmp_path):
    for mod, root in ((jset, tmp_path / "j"), (tset, tmp_path / "t")):
        mod.update_app_setting("microphone_volume", "55", root)
        mod.save_llm_settings(mod.LlmSettings(api_key="k"), root)
    assert (tmp_path / "t" / "settings.json").read_bytes() == \
        (tmp_path / "j" / "settings.json").read_bytes()


@PKGS
def test_update_app_setting(data_root, mod):
    mod.update_app_setting("microphone_volume", "55")
    assert mod.load_app_settings().microphone_volume == "55"


@PKGS
def test_update_unknown_key_rejected(data_root, mod):
    with pytest.raises(KeyError):
        mod.update_app_setting("not_a_key", "x")


@PKGS
def test_api_key_omitted_from_public(data_root, mod):
    llm = mod.LlmSettings(api_key="sk-secret")
    mod.save_llm_settings(llm)
    pub = mod.get_llm_settings_public()
    assert "api_key" not in pub
    assert pub["endpoint"] == llm.endpoint


@PKGS
def test_missing_fields_defaulted(data_root, mod):
    path = mod.settings_file_path()
    path.write_text(json.dumps({
        "llm": {"endpoint": "e", "api_key": "k", "model": "m"},
        "app": {
            "selected_microphone": "mic",
            "selected_output_device": "out",
            "microphone_volume": "80",
            "selected_model": "dummy",
            "selected_transcription_model": "none",
            "selected_recording_app": "none",
        },
    }))
    f = mod.load_settings_file()
    assert f.app.selected_microphone == "mic"
    assert f.app.autostart_enabled == "false"
    assert f.app.diarization_merge_gap == "2.5"


@PKGS
def test_legacy_llm_only_file(data_root, mod):
    path = mod.settings_file_path()
    path.write_text(json.dumps({"endpoint": "e", "api_key": "k", "model": "m"}))
    f = mod.load_settings_file()
    assert f.llm.endpoint == "e"
    assert f.app.selected_model == "dummy"


@PKGS
def test_corrupt_file_backed_up(data_root, mod):
    path = mod.settings_file_path()
    path.write_text("{this is not json")
    f = mod.load_settings_file()
    assert f.app.selected_model == "dummy"  # defaults
    assert path.with_suffix(".json.corrupt").exists()
    assert not path.exists()
