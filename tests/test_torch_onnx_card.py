"""The port's ONNX executor and engines on the card against its CPU path
(``gpu`` tests: they skip without a CUDA card; the port's CPU path is held
to the JAX package by tests/test_torch_onnx_*.py).

MatMulInteger (cuBLASLt's s8xs8→s32 with padding) and DynamicQuantizeLinear
are bit-equal to the CPU's on identical inputs; ConvInteger and a Loop with
a condition computed on the card give equal outputs; the float layouts of
the JAX package's engine tests give equal texts; an int8 encoder call of
the bench bundle's op mix makes no host sync (CUDA's sync debug mode).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import onnx_builder as ob
import test_onnx_engines as layouts
from crispy_tpu_torch.engine import transcription as tr
from crispy_tpu_torch.models import onnx_exec as ox
from crispy_tpu_torch.models.registry import ModelManager

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import bench_bundles  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


class _Node:
    attrs: dict = {}


@pytest.mark.parametrize("M,K,N", [(8, 640, 1030), (3008, 1024, 4096), (5, 37, 11),
                                   (304, 64, 128), (250, 4096, 1024)])
def test_matmulinteger_bit_equal(card, M, K, N):
    g = np.random.default_rng(M)
    a = torch.from_numpy(g.integers(0, 256, (M, K), dtype=np.uint8))
    b = torch.from_numpy(g.integers(-128, 128, (K, N), dtype=np.int8))
    az, bz = torch.tensor(131, dtype=torch.uint8), torch.tensor(-3, dtype=torch.int8)
    want = ox._mmi(_Node(), a, b, az, bz)
    got = ox._mmi(_Node(), a.to(card), b.to(card), az.to(card), bz.to(card))
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_dynamic_quantize_bit_equal(card, scale):
    x = torch.from_numpy((np.random.default_rng(1).standard_normal((16, 375, 1024))
                          * scale).astype(np.float32))
    for got, want in zip(ox._dql(_Node(), x.to(card)), ox._dql(_Node(), x)):
        assert torch.equal(got.cpu(), want)


def test_convinteger_and_loop_equal(card, tmp_path):
    g = np.random.default_rng(2)
    x = g.integers(0, 256, (2, 6, 40), dtype=np.uint8)
    conv = ox.OnnxRunner.load(ob.write_model(tmp_path / "c.onnx", [
        ob.node("ConvInteger", ["x", "w", "xz", "wz"], ["y"], group=2, strides=[2],
                pads=[2, 1])], [("x", 2, [2, 6, 40])], [("y", 6, None)],
        {"w": g.integers(-128, 128, (8, 3, 5), dtype=np.int8), "xz": np.uint8(131),
         "wz": np.int8(-2)}))
    y = conv(x=torch.from_numpy(x).to(card))["y"]
    assert y.is_cuda and torch.equal(y.cpu(), conv(x=torch.from_numpy(x))["y"])
    body = ob.graph_proto(
        [ob.node("Mul", ["acc_in", "two"], ["acc_out"]),
         ob.node("ReduceMax", ["acc_out"], ["a0"], keepdims=0),
         ob.node("Less", ["a0", "limit"], ["cond_out"]),
         ob.node("Identity", ["acc_out"], ["snap"])],
        [("iter", 7, []), ("cond_in", 9, []), ("acc_in", 1, [3])],
        [("cond_out", 9, []), ("acc_out", 1, [3]), ("snap", 1, [3])],
        {"two": np.full(3, 2.0, np.float32)})
    loop = ox.OnnxRunner.load(ob.write_model(tmp_path / "l.onnx", [
        ob.node("Loop", ["M", "cond", "acc0"], ["acc", "snaps"], body=body)],
        [("acc0", 1, [3]), ("limit", 1, [])], [("acc", 1, [3]), ("snaps", 1, [None, 3])],
        {"M": np.int64(40), "cond": np.array(True)}))
    ins = {"acc0": torch.tensor([0.5, 1.0, 0.25]), "limit": torch.tensor(1000.0)}
    got = loop(**{k: v.to(card) for k, v in ins.items()})
    want = loop(**ins)
    assert got["snaps"].shape == (10, 3)
    assert all(torch.equal(got[k].cpu(), want[k]) for k in want)


@pytest.mark.parametrize("model_id,make", [
    ("gigaam-v3-e2e-ctc", layouts.make_gigaam_bundle),
    ("sense-voice-int8", layouts.make_sensevoice_bundle),
    ("parakeet-tdt-0.6b-v2", layouts.make_parakeet_bundle)])
def test_layout_texts_equal(card, tmp_path, model_id, make):
    mm = ModelManager(models_dir=tmp_path / "Models")
    mm.model_path(model_id).mkdir(parents=True)
    make(mm.model_path(model_id))
    x = (np.random.default_rng(3).standard_normal((3, 24000)) * 0.3).astype(np.float32)
    eng = tr.load_engine(model_id, mm)  # default device: the card
    assert eng.device.type == "cuda"
    assert eng.transcribe_batch(x) == tr.load_engine(model_id, mm, device="cpu").transcribe_batch(x)


def test_int8_encoder_call_makes_no_host_sync(card, tmp_path):
    mm = ModelManager(models_dir=tmp_path / "Models")
    mid = "parakeet-tdt-0.6b-v3"
    bench_bundles.make_parakeet_sized_bundle(mm.model_path(mid), D=64, L=2, FF=128, HEADS=2,
                                             H=32, V=64)
    eng = tr.load_engine(mid, mm)
    x = torch.from_numpy((np.random.default_rng(4).standard_normal((8, 48000)) * 0.3)
                         .astype(np.float32)).to(card)
    texts = eng.transcribe_batch(x)  # uploads the static initializers once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        enc = eng.encoder_output(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert enc.is_cuda and bool(torch.isfinite(enc).all())
    assert len(texts) == 8
