"""load_engine's native ASR families in the port (crispy_tpu_torch.engine.
transcription) against the JAX package's engines, on the CPU.

Each family boots from a prepared bundle (``params.npz`` from the family's
``init_random``, ``config.json``, a ``tokenizer.model`` from
``build_model_bytes``), as tests/test_spm.py builds them, under its catalog
id; both packages load the same files and must give equal texts: parakeet
TDT, gigaam, canary (with its language-prompt substitution), moonshine and
sensevoice, plus parakeet CTC and moonshine from HF checkpoints. Then
run_transcription of a 35 s 48 kHz WAV through the Parakeet engine (two
chunks, the tail zero-padded, resampled on the device in the port) against
the JAX package's. A bundle without params.npz is the catalog's ONNX
export and reaches the ONNX executor's engines (tests/test_torch_onnx_*.py).
"""

import json

import numpy as np
import pytest
import torch

from crispy_tpu_torch.api.events import EventBus
from crispy_tpu_torch.engine import transcription as tr
from crispy_tpu_torch.io import wav as wavio
from crispy_tpu_torch.models import canary as tcn
from crispy_tpu_torch.models import moonshine as tms
from crispy_tpu_torch.models import parakeet as tpk
from crispy_tpu_torch.models import sensevoice as tsv
from crispy_tpu_torch.models.registry import ModelManager
from crispy_tpu_torch.models.spm import CONTROL, NORMAL, UNKNOWN, build_model_bytes
from test_torch_moonshine import hf_state_dict as moonshine_hf_state_dict
from test_torch_parakeet import hf_ctc_state_dict
from torch_audio import one_torch_thread, speechlike  # noqa: F401 (autouse fixture)

try:  # the reference
    from crispy_tpu.api.events import EventBus as JEventBus
    from crispy_tpu.engine import transcription as jtr
    from crispy_tpu.models import registry as jreg
except ImportError:
    jtr = None
needs_jax = pytest.mark.skipif(jtr is None, reason="the JAX reference is not installed")

PARAKEET = dict(n_mels=32, hidden_size=64, layers=2, heads=2, kv_heads=2, intermediate_size=128,
                sub_channels=32, vocab_size=32, pred_hidden=32, joint_hidden=32)
GIGAAM = dict(n_mels=64, hidden_size=64, layers=2, heads=2, kv_heads=2, intermediate_size=128,
              sub_channels=32, sub_factor=4, vocab_size=34)


def _bundle(mm, model_id, params, config, pieces=None, types=None):
    path = mm.model_path(model_id)
    path.mkdir(parents=True)
    np.savez(path / "params.npz", **params)
    (path / "config.json").write_text(json.dumps(config))
    if pieces is not None:
        (path / "tokenizer.model").write_bytes(build_model_bytes(pieces, types))
    return path


def parakeet_bundle(mm, model_id="parakeet-tdt-0.6b-v3"):
    cfg = tpk.ParakeetConfig(**PARAKEET)
    pieces = ["<unk>"] + [f"▁p{i}" for i in range(cfg.vocab_size - 1)]
    return _bundle(mm, model_id, tpk.init_random(cfg, 0), {"encoder": PARAKEET}, pieces,
                   [UNKNOWN] + [NORMAL] * (cfg.vocab_size - 1))


def gigaam_bundle(mm):
    labels = [" "] + [chr(0x430 + i) for i in range(32)] + ["ё"]
    return _bundle(mm, "gigaam-v3-e2e-ctc", tpk.init_random(tpk.ParakeetConfig(**GIGAAM), 0),
                   {"encoder": GIGAAM, "labels": labels})


def canary_bundle(mm):
    n = tcn.CONFIGS["test-random"].vocab_size
    pieces = (["<unk>", "<|en|>", "<|de|>", "<|transcribe|>"]
              + [f"▁w{i}" for i in range(n - 6)] + ["<s>", "</s>"])
    types = [UNKNOWN, CONTROL, CONTROL, CONTROL] + [NORMAL] * (n - 6) + [CONTROL, CONTROL]
    return _bundle(mm, "canary-180m-flash", tcn.init_random(tcn.CONFIGS["test-random"], 0),
                   {"config": "test-random", "prompt_ids": [n - 2, 1, 3, 1]}, pieces, types)


def moonshine_bundle(mm):
    return _bundle(mm, "moonshine-base", tms.init_random(tms.CONFIGS["test-random"], 0),
                   {"config": "test-random"})


def sensevoice_bundle(mm):
    cfg = tsv.CONFIGS["test-random"]
    pieces = ["<blank>"] + [f"▁s{i}" for i in range(cfg.vocab_size - 1)]
    return _bundle(mm, "sense-voice-int8", tsv.init_random(cfg, 0),
                   {"config": "test-random", "prompt_ids": [3, 4, 5, 6]}, pieces,
                   [CONTROL] + [NORMAL] * (cfg.vocab_size - 1))


BUNDLES = {"parakeet-tdt-0.6b-v3": parakeet_bundle, "gigaam-v3-e2e-ctc": gigaam_bundle,
           "canary-180m-flash": canary_bundle, "moonshine-base": moonshine_bundle,
           "sense-voice-int8": sensevoice_bundle}


def chunks(B=2, n=24000):
    return np.stack([speechlike(n, seed=b, sr=16000, f0=110.0 + 35.0 * b) for b in range(B)])


def engines(tmp_path, model_id, make=None):
    models = tmp_path / "Models"
    (make or BUNDLES[model_id])(ModelManager(models_dir=models))
    return (tr.load_engine(model_id, ModelManager(models_dir=models), device="cpu"),
            jtr.load_engine(model_id, jreg.ModelManager(models_dir=models, bus=JEventBus())))


@needs_jax
@pytest.mark.parametrize("model_id", list(BUNDLES))
def test_prepared_bundle_texts_equal_jax(tmp_path, model_id):
    teng, jeng = engines(tmp_path, model_id)
    a = chunks()
    want = jeng.transcribe_batch(a)
    assert len(want) == 2 and all(isinstance(s, str) for s in want)
    assert teng.transcribe_batch(a) == want
    assert teng.transcribe_batch(torch.from_numpy(a)) == want  # device-resident chunks
    assert teng.transcribe_batch(list(a)) == want  # a list of chunks, as the JAX tests pass
    assert next(teng.model.parameters()).device.type == "cpu"


@needs_jax
def test_canary_language_prompt_substitution(tmp_path):
    teng, jeng = engines(tmp_path, "canary-180m-flash")
    n = tcn.CONFIGS["test-random"].vocab_size
    for lang, want in (("en", [n - 2, 1, 3, 1]), ("de", [n - 2, 2, 3, 2]),
                       ("xx", [n - 2, 1, 3, 1])):
        assert teng.prompt_for_language(lang) == jeng.prompt_for_language(lang) == want
    a = chunks()
    assert teng.transcribe_batch(a, language="de") == jeng.transcribe_batch(a, language="de")


def _hf_checkpoint(sd):
    def make(mm, model_id):
        path = mm.model_path(model_id)
        path.mkdir(parents=True)
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path / "pytorch_model.bin")
    return make


@needs_jax
@pytest.mark.parametrize("model_id,sd", [
    ("parakeet-tdt-0.6b-v2", lambda: {k: v * 0.1 for k, v in hf_ctc_state_dict().items()}),
    ("moonshine-base", lambda: {k: v * 0.1 for k, v in moonshine_hf_state_dict().items()}),
], ids=["parakeet_ctc", "moonshine"])
def test_hf_checkpoint_texts_equal_jax(tmp_path, model_id, sd):
    make = _hf_checkpoint(sd())
    teng, jeng = engines(tmp_path, model_id, lambda mm: make(mm, model_id))
    a = chunks(n=16000)
    want = jeng.transcribe_batch(a)
    assert teng.transcribe_batch(a) == want and any(want)


@needs_jax
def test_run_transcription_text_equals_jax(tmp_path, data_root):
    """35 s of 48 kHz 16-bit speech-like audio: two chunks, the tail padded."""
    sr = 48000
    pcm = (speechlike(35 * sr, seed=4, sr=sr) * 32767).astype(np.int16)
    wav = wavio.write_wav(tmp_path / "rec.wav", pcm, sr)
    models = tmp_path / "Models"
    parakeet_bundle(ModelManager(models_dir=models), "parakeet-tdt-0.6b-v2")
    jbus = JEventBus()
    jtm = jtr.TranscriptionManager(jreg.ModelManager(models_dir=models, bus=jbus), bus=jbus)
    bus = EventBus()
    bus.keep_history = True
    ttm = tr.TranscriptionManager(ModelManager(models_dir=models), bus=bus, device="cpu")
    want = jtr.run_transcription(str(wav), jtm, "parakeet-tdt-0.6b-v2")
    tr.clear_transcription_progress(str(wav))
    got = tr.run_transcription(str(wav), ttm, "parakeet-tdt-0.6b-v2")
    assert got and got == want
    assert ttm.get_state(str(wav)).status == "completed"
    assert [p["stage"] for e, p in bus.history if e == "stage-timing"] == \
        ["resample", "transcribe-batch"]


# what an empty encoder-model.onnx without params.npz gives, as in the JAX
# package: canary reaches the ONNX enc-dec engine (no decoder beside the
# encoder), moonshine's file inventory is then one graph (CTC); the others
# reach the executor, which refuses the file (parakeet: no decoder_joint)
ONNX_ONLY = {"canary-180m-flash": (FileNotFoundError, "need encoder\\+decoder"),
             "moonshine-base": (ValueError, "no graph"),
             "parakeet-tdt-0.6b-v3": (FileNotFoundError, "decoder_joint"),
             "gigaam-v3-e2e-ctc": (ValueError, "no graph"),
             "sense-voice-int8": (ValueError, "no graph"),
             "cohere-int8": (ValueError, "no graph")}


@pytest.mark.parametrize("model_id", list(BUNDLES) + ["cohere-int8"])
def test_onnx_only_bundles_raise(tmp_path, model_id):
    """A catalog bundle without params.npz is the ONNX export: it loads
    through the ONNX executor or raises, nothing in its place."""
    mm = ModelManager(models_dir=tmp_path / "Models")
    path = mm.model_path(model_id)
    path.mkdir(parents=True)
    (path / "encoder-model.onnx").write_bytes(b"")
    err, match = ONNX_ONLY[model_id]
    with pytest.raises(err, match=match):
        tr.load_engine(model_id, mm, device="cpu")


def test_cohere_with_params_still_raises(tmp_path):
    """cohere's bundle is pinned by its .onnx inventory, as in the JAX
    package: a params.npz is not read, and with no .onnx it raises."""
    mm = ModelManager(models_dir=tmp_path / "Models")
    moonshine_bundle(mm)
    cohere = mm.model_path("cohere-int8")
    cohere.mkdir(parents=True)
    (cohere / "params.npz").write_bytes((mm.model_path("moonshine-base") / "params.npz")
                                        .read_bytes())
    with pytest.raises(FileNotFoundError, match="no .onnx"):
        tr.load_engine("cohere-int8", mm, device="cpu")


def test_not_downloaded_raises(tmp_path):
    mm = ModelManager(models_dir=tmp_path / "Models")
    with pytest.raises(FileNotFoundError, match="not downloaded"):
        tr.load_engine("canary-1b-v2", mm, device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("model_id", list(BUNDLES))
def test_card_texts_equal_cpu(tmp_path, model_id):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mm = ModelManager(models_dir=tmp_path / "Models")
    BUNDLES[model_id](mm)
    card = tr.load_engine(model_id, mm)  # default device: the card
    cpu = tr.load_engine(model_id, mm, device="cpu")
    a = chunks()
    assert next(card.model.parameters()).is_cuda
    assert card.transcribe_batch(torch.from_numpy(a).cuda()) == cpu.transcribe_batch(a)
