"""The port's mesh (crispy_tpu_torch.parallel, parallel/asr.py) and the
``mesh=``/``device=`` contract of its entry points, on the CPU: make_mesh's
shapes against the JAX package's, the placement helpers' order and padding
rules, the Whisper TP specs against the JAX package's for every parameter of
whisper test-random and base, the conflicts and refusals, and the int8
engines' DynamicQuantizeLinear scale over a sharded batch. The ``gpu`` cases
hold the card's sharded runs (``["cuda:0"]`` and ``["cuda:0"] * 2``) to its
unsharded ones.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from crispy_tpu_torch import parallel
from crispy_tpu_torch.dsp.rnnoise import pipeline as tp
from crispy_tpu_torch.dsp.rnnoise.weights import deterministic_test_model
from crispy_tpu_torch.engine import onnx_engines as teng
from crispy_tpu_torch.models import onnx_exec as texec
from crispy_tpu_torch.models.whisper import WhisperModel
from crispy_tpu_torch.models.whisper import model as tm
from crispy_tpu_torch.models.whisper import weights as tw
from crispy_tpu_torch.parallel import asr as tasr
from torch_audio import one_torch_thread  # noqa: F401 (autouse fixture)

try:  # the reference; the card's machine has no JAX and runs only the gpu tests
    from crispy_tpu import parallel as jparallel
    from crispy_tpu.engine import onnx_engines as jeng
    from crispy_tpu.models.whisper import model as jm
    from crispy_tpu.models.whisper.weights import init_random as j_init_random
    from crispy_tpu.parallel import asr as jasr
except ImportError:
    jparallel = None
needs_jax = pytest.mark.skipif(jparallel is None, reason="the JAX reference is not installed")

ROOT = Path(__file__).resolve().parent.parent
CPU8 = ["cpu"] * 8


def cpu_mesh(n=8, **kw):
    return parallel.make_mesh(devices=["cpu"] * n, **kw)


# ---------------------------------------------------------------------------
# make_mesh and the placement helpers
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("n,mp", [(1, None), (2, None), (3, None), (8, None), (8, 1), (2, 1)])
def test_make_mesh_shapes_match_jax(n, mp):
    m = parallel.make_mesh(n, model_parallel=mp, devices=CPU8)
    assert m.devices.shape == jparallel.make_mesh(n, model_parallel=mp).devices.shape
    assert m.axes == ("data", "model")
    assert m.devices.shape == (m.dp, m.tp)
    # the grid is the device list in order, row by row
    assert m.flat() == [torch.device("cpu")] * (m.dp * m.tp)


def test_mesh_is_hashable_and_explicit():
    a, b = cpu_mesh(), cpu_mesh()
    assert a == b and hash(a) == hash(b) and len({a, b}) == 1
    assert a.first == torch.device("cpu") and a.distinct() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="rectangular"):
        parallel.Mesh(((torch.device("cpu"),), ()))
    with pytest.raises(ValueError, match="exceeds"):
        parallel.make_mesh(devices=["cpu"] * 2, model_parallel=4)


def test_data_sharding_order_and_padding():
    m = cpu_mesh(6, model_parallel=2)  # dp = 3
    x = torch.arange(14.0).reshape(7, 2)
    edge = parallel.data_sharding(m, x, pad="edge")
    assert [p.shape[0] for p in edge] == [3, 3, 3]
    assert torch.equal(parallel.gather(edge, torch.device("cpu"), 7), x)
    assert torch.equal(edge[-1][-2:], x[-1:].expand(2, 2))  # the last row repeated
    zeros = parallel.data_sharding(m, x, pad="zeros")
    assert torch.equal(torch.cat(zeros)[7:], torch.zeros(2, 2))
    # no padding when dp divides the batch; a piece on its own device is a view
    even = parallel.data_sharding(m, x[:6])
    assert even[1].data_ptr() == x[2].data_ptr()
    with pytest.raises(ValueError, match="unknown padding"):
        parallel.pad_rows(x, 9, "reflect")


def test_model_sharding_and_replicated():
    m = cpu_mesh(4)  # (2, 2)
    w = torch.arange(24.0).reshape(3, 8)
    cols = parallel.model_sharding(m, w, axis=-1, row=1)
    assert [tuple(c.shape) for c in cols] == [(3, 4), (3, 4)]
    assert torch.equal(torch.cat(cols, dim=-1), w)
    rows = parallel.model_sharding(m, w, axis=0)
    assert torch.equal(torch.cat(rows), w)
    rep = parallel.replicated(m, w)
    assert list(rep) == [torch.device("cpu")] and rep[torch.device("cpu")] is w


# ---------------------------------------------------------------------------
# The Whisper TP specs
# ---------------------------------------------------------------------------

def _flat_shapes(size):
    """(flat name, flat [in, out] shape) of every parameter of a Whisper
    size, from the port's module built without storage."""
    with torch.device("meta"):
        model = tm.Whisper(tm.CONFIGS[size])
    out = []
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        out.append((tw._flat_name(name), shape[::-1] if t.dim() == 2 else shape))
    return out


@needs_jax
@pytest.mark.parametrize("size", ["test-random", "base"])
@pytest.mark.parametrize("tp", [1, 2, 3, 4])
def test_whisper_param_spec_matches_jax(size, tp):
    pairs = _flat_shapes(size)
    if size == "test-random":  # the JAX package's own names and shapes
        jp = j_init_random(jm.CONFIGS[size], seed=0)
        assert sorted(n for n, _ in pairs) == sorted(jp)
        pairs = [(n, v.shape) for n, v in jp.items()]
    sharded = 0
    for name, shape in pairs:
        x = np.broadcast_to(np.float32(0), shape)
        got = tasr.whisper_param_spec(name, x, tp)
        assert got == tuple(jasr.whisper_param_spec(name, x, tp)), name
        sharded += got != ()
    assert (sharded > 0) == (tp in (2, 4))  # an indivisible width replicates


def test_shard_module_shares_storage_and_splits_heads():
    wm = WhisperModel.random("test-random", seed=1, device="cpu")
    wm.shard_to(cpu_mesh())  # (4, 2): four rows on the same two devices
    assert len(wm.replicas) == 4 and all(r is wm.replicas[0] for r in wm.replicas)
    rep = wm.replicas[0]
    attn = rep.decoder.blocks[0].attn
    assert [p.n_head for p in attn.tp] == [1, 1]
    storage = wm.model.decoder.blocks[0].attn.q.weight.untyped_storage().data_ptr()
    assert attn.tp[1].wq.untyped_storage().data_ptr() == storage
    assert rep.decoder.emb.weight.untyped_storage().data_ptr() == \
        wm.model.decoder.emb.weight.untyped_storage().data_ptr()
    with pytest.raises(ValueError, match="heads"):
        tm.shard_module(wm.model, [torch.device("cpu")] * 4)  # 64 % 4 == 0, 2 heads


def test_whisper_tp_logits_and_texts_match_unsharded():
    plain = WhisperModel.random("test-random", seed=1, device="cpu")
    sharded = WhisperModel.random("test-random", seed=1, device="cpu").shard_to(cpu_mesh())
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((3, 16000)) * 0.1).astype(np.float32)
    tok = torch.from_numpy(rng.integers(0, 990, (3, 6)))
    a, b = plain.decode_logits(audio, tok), sharded.decode_logits(audio, tok)
    assert float((a - b).abs().max()) <= 1e-4 * float(a.abs().max())
    assert plain.transcribe_chunks(audio, max_new=10) == sharded.transcribe_chunks(audio, max_new=10)
    assert plain.transcribe_chunks(audio, max_new=6, beam=2) == \
        sharded.transcribe_chunks(audio, max_new=6, beam=2)
    # the sampled rungs draw each step's noise for the whole batch
    assert plain.transcribe_chunks_robust(audio, max_new=8) == \
        sharded.transcribe_chunks_robust(audio, max_new=8)
    assert plain.transcribe_chunks_with_timestamps(audio, max_new=6) == \
        sharded.transcribe_chunks_with_timestamps(audio, max_new=6)


# ---------------------------------------------------------------------------
# device= beside mesh=, and the refusals
# ---------------------------------------------------------------------------

def test_device_and_mesh_conflict_raises(tmp_path):
    import sys

    sys.path.insert(0, str(Path(__file__).parent))
    from test_onnx_engines import make_gigaam_bundle

    from crispy_tpu_torch.api.commands import CrispyApp
    from crispy_tpu_torch.engine import diarization as tdz
    from crispy_tpu_torch.engine import transcription as ttr
    from crispy_tpu_torch.models.registry import ModelManager

    m = cpu_mesh()
    audio = np.zeros((2, 4800), np.float32)
    calls = [
        lambda: tp.denoise_batch(audio, device="cuda:1", mesh=m),
        lambda: teng.OnnxCtcEngine(make_gigaam_bundle(tmp_path), "g", device="cuda:0", mesh=m),
        lambda: tdz.diarize(np.zeros(16000, np.float32), device="cuda:0", mesh=m),
        lambda: ttr.load_engine("small", ModelManager(models_dir=tmp_path), device="cuda:0",
                                mesh=m),
        lambda: ttr.TranscriptionManager(ModelManager(models_dir=tmp_path), device="cuda:0",
                                         mesh=m),
        lambda: CrispyApp(device="cuda:0", mesh=m),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="conflicts with the mesh"):
            call()
    # the mesh's first device is no conflict
    out = tp.denoise_batch(audio, deterministic_test_model(), device="cpu", mesh=m)
    assert out.shape == audio.shape


def test_i16_wire_with_a_mesh_raises():
    with pytest.raises(ValueError, match="i16"):
        tp.denoise_batch(np.zeros((2, 960), np.int16), wire="i16", mesh=cpu_mesh())


def test_cuda_mesh_without_a_card_raises_and_never_runs_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh(devices=["cuda:0"] * 2)
    with pytest.raises(ValueError, match="by index"):
        parallel.make_mesh(devices=["cuda"])


def test_denoise_batch_pads_streams_with_zeros(monkeypatch):
    """S=3 over dp=2: the fourth stream is zeros (the JAX package's pad),
    not a copy of the third."""
    seen = []
    real = tp.denoise_block

    def spy(params, state, block):
        seen.append(block.clone())
        return real(params, state, block)

    monkeypatch.setattr(tp, "denoise_block", spy)
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((3, 480 * 4)) * 0.3).astype(np.float32)
    tp.denoise_batch(audio, deterministic_test_model(), block_frames=4,
                     mesh=cpu_mesh(4, model_parallel=2))
    assert [b.shape[0] for b in seen] == [2, 2]
    assert torch.equal(seen[1][1], torch.zeros(480 * 4))


# ---------------------------------------------------------------------------
# The int8 engines' activation scale over a sharded batch
# ---------------------------------------------------------------------------

def _recording_scales(monkeypatch):
    scales = []
    real = texec._dql_codes

    def spy(x, lo, hi):
        out = real(x, lo, hi)
        scales.append(float(out[1]))
        return out

    monkeypatch.setattr(texec, "_dql_codes", spy)
    return scales


# The activations ahead of a quantization differ between batch sizes by f32
# rounding (oneDNN's and cuDNN's convolutions, and the GEMMs, pick their
# kernels by shape): measured 7e-8 relative on this bundle's first scale.
SCALE_RTOL = 1e-6


@needs_jax
def test_dynamic_quantize_scale_spans_the_sharded_batch(tmp_path, monkeypatch):
    """B=3 over dp=4: every shard quantizes with the whole batch's range, so
    its scales are the unsharded run's (to the activations' rounding), where
    a shard quantizing alone would take a range of its own rows."""
    from test_realistic_bundle import make_realistic_parakeet_bundle

    d = make_realistic_parakeet_bundle(tmp_path)
    chunks = (np.random.default_rng(1).standard_normal((3, 24000)) * 0.3).astype(np.float32)
    mesh = cpu_mesh(4, model_parallel=1)  # B=3 pads to dp=4
    plain = teng.OnnxTdtEngine(d, "r", device="cpu")
    sharded = teng.OnnxTdtEngine(d, "r", mesh=mesh)
    scales = _recording_scales(monkeypatch)
    plain.encoder_output(chunks)
    want = np.array(scales)
    scales.clear()
    sharded.encoder_output(chunks)
    got = np.array(scales).reshape(len(want), 4)  # one per shard of each node
    np.testing.assert_allclose(got, np.repeat(want[:, None], 4, 1), rtol=SCALE_RTOL, atol=0)
    # each shard alone: its own rows' range
    scales.clear()
    for i in range(3):
        plain.encoder_output(chunks[i:i + 1])
    alone = np.array(scales).reshape(3, len(want)).T
    assert np.abs(alone / want[:, None] - 1).max() > 100 * SCALE_RTOL
    texts = plain.transcribe_batch(chunks)
    assert sharded.transcribe_batch(chunks) == texts
    jtexts = jeng.OnnxTdtEngine(d, "r", mesh=jparallel.make_mesh(4, model_parallel=1)
                                ).transcribe_batch(chunks)
    assert texts == jtexts


def test_row_mixing_nodes_see_the_whole_batch(tmp_path):
    """A graph that reduces over the batch axis, runs a softmax along it and
    quantizes: sharded over four rows it gives the unsharded outputs."""
    import onnx_builder as ob

    path = tmp_path / "mix.onnx"
    nodes = [
        ob.node("ReduceMax", ["x"], ["m"], axes=[0], keepdims=1),
        ob.node("Sub", ["x", "m"], ["c"]),
        ob.node("Softmax", ["c"], ["s"], axis=0),
        ob.node("ReduceSum", ["x"], ["t"], keepdims=1),
        ob.node("Add", ["s", "t"], ["u"]),
        ob.node("DynamicQuantizeLinear", ["u"], ["q", "qs", "qz"]),
        ob.node("Cast", ["q"], ["y"], to=1),
    ]
    ob.write_model(path, nodes, [("x", 1, [None, 5])], [("y", 1, [None, 5]), ("qs", 1, [])], {})
    runner = texec.OnnxRunner.load(path).validate()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((8, 5)).astype(np.float32))
    want = runner(x=x)
    outs = runner.call_sharded([None] * 4, [{"x": p} for p in x.chunk(4)])
    assert torch.equal(torch.cat([o["y"] for o in outs]), want["y"])
    assert all(torch.equal(o["qs"], want["qs"]) for o in outs)


def test_native_diarization_nets_split_over_the_mesh():
    """PyanNet's windows and CAM++'s chunks over a (4, 2) mesh: the
    unsharded outputs (rows of one batch computed in smaller batches)."""
    from crispy_tpu_torch.models import campplus as tc
    from crispy_tpu_torch.models import segmentation as ts

    rng = np.random.default_rng(4)
    q = torch.from_numpy((rng.standard_normal(3 * ts.WINDOW_SAMPLES) * 3000).astype(np.int16))
    seg = ts.params_to_module(ts.init_random(seed=0), device="cpu")
    want = seg.from_device(q)
    got = seg.from_device(q, mesh=cpu_mesh())  # W=3 pads to 4 by its last window
    assert got.shape == want.shape == (3,) + want.shape[1:]
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
    cfg = tc.CONFIGS["test-random"]
    cam = tc.params_to_module(tc.init_random(cfg, seed=0), cfg, "cpu")
    ranges = [(0, 48000), (64000, 96000), (160000, 230000)]
    want = cam.from_device(q, ranges)
    got = cam.from_device(q, ranges, mesh=cpu_mesh())
    assert got.shape == want.shape == (3, cfg.embedding_size)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


JAX_SIDE = ("jax", "jaxlib", "crispy_tpu", "flax", "optax")


def rank_entry_imports(path: Path):
    """The modules imported by a test file's rank entry: everything in the
    file but its ``test_`` and ``jax_`` functions, which only the parent
    test process runs."""
    import ast

    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, ast.FunctionDef) and node.name.startswith(("test_", "jax_")):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Import):
                yield from (a.name for a in sub.names)
            elif isinstance(sub, ast.ImportFrom) and sub.level == 0 and sub.module:
                yield sub.module


def test_parallel_modules_import_neither_jax_nor_the_jax_package():
    from test_torch_denoiser import _imported_modules

    files = sorted((ROOT / "crispy_tpu_torch" / "parallel").glob("*.py"))
    assert {f.name for f in files} >= {"__init__.py", "asr.py", "multihost.py", "train.py"}
    bad = [(f.name, m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in JAX_SIDE]
    assert not bad, bad
    # the rank entry of the multi-process drill, and the modules it imports from tests/
    drill = Path(__file__).with_name("test_torch_multihost.py")
    mods = set(rank_entry_imports(drill))
    assert {"crispy_tpu_torch.parallel", "torch_audio"} <= mods
    assert not [m for m in mods if m.split(".")[0] in JAX_SIDE], mods
    local = [Path(__file__).with_name(m + ".py") for m in mods if "." not in m]
    bad = [(f.name, m) for f in local if f.exists() for m in _imported_modules(f)
           if m.split(".")[0] in JAX_SIDE]
    assert not bad, bad


# ---------------------------------------------------------------------------
# On the card: a mesh of the one card, once and repeated
# ---------------------------------------------------------------------------

CARD_MESHES = [["cuda:0"], ["cuda:0"] * 2]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("devices", CARD_MESHES)
def test_card_denoise_batch_sharded_matches_unsharded(cuda, devices):
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((3, 480 * 40)) * 0.3).astype(np.float32)
    model = deterministic_test_model()
    want = tp.denoise_batch(audio, model, block_frames=20, device=cuda)
    got = tp.denoise_batch(audio, model, block_frames=20,
                           mesh=parallel.make_mesh(devices=devices, model_parallel=1))
    np.testing.assert_allclose(got, want, atol=1.5e-4, rtol=0)
    assert torch.cuda.current_device() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("devices", CARD_MESHES)
def test_card_whisper_sharded_matches_unsharded(cuda, devices):
    mesh = parallel.make_mesh(devices=devices)
    plain = WhisperModel.random("test-random", seed=1, device=cuda)
    sharded = WhisperModel.random("test-random", seed=1, device=cuda).shard_to(mesh)
    audio = (np.random.default_rng(0).standard_normal((3, 16000)) * 0.1).astype(np.float32)
    assert plain.transcribe_chunks_robust(audio, max_new=12) == \
        sharded.transcribe_chunks_robust(audio, max_new=12)


@pytest.mark.gpu
@pytest.mark.parametrize("devices", CARD_MESHES)
def test_card_ctc_engine_sharded_matches_unsharded(cuda, devices, tmp_path):
    import sys

    sys.path.insert(0, str(Path(__file__).parent))
    from test_onnx_engines import make_gigaam_bundle

    d = make_gigaam_bundle(tmp_path)
    chunks = (np.random.default_rng(2).standard_normal((3, 16000)) * 0.3).astype(np.float32)
    mesh = parallel.make_mesh(devices=devices, model_parallel=1)
    assert teng.OnnxCtcEngine(d, "g", device=cuda).transcribe_batch(chunks) == \
        teng.OnnxCtcEngine(d, "g", mesh=mesh).transcribe_batch(chunks)
