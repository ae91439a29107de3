"""The port's ONNX input contracts (crispy_tpu_torch.engine.onnx_contracts)
against the JAX package's, on the CPU: the cases of test_onnx_contracts run
with ``input_role`` and ``classify_inputs`` answering from both packages,
which must agree; the port's TDT engine refuses an unbindable decoder int
input as the JAX package's does."""

import numpy as np
import pytest

pytest.importorskip("jax", reason="the JAX reference is not installed")
import onnx_builder as ob  # noqa: E402
import test_onnx_contracts as jcases
from crispy_tpu.engine import onnx_contracts as jc
from crispy_tpu_torch.engine import onnx_contracts as tc

F32, I32 = 1, 6


def dual_input_role(name, elem_type):
    want = jc.input_role(name, elem_type)
    assert tc.input_role(name, elem_type) == want, (name, elem_type)
    return want


def dual_classify(runner):
    want = jc.classify_inputs(runner)
    assert tc.classify_inputs(runner) == want
    return want


@pytest.mark.parametrize("case", ["test_exact_contract_names_bind_exactly",
                                  "test_heuristic_fallback_and_loud_unknowns",
                                  "test_classify_orders_exact_feats_first"])
def test_contract_cases_agree(case, monkeypatch):
    monkeypatch.setattr(jcases, "input_role", dual_input_role)
    monkeypatch.setattr(jcases, "classify_inputs", dual_classify)
    getattr(jcases, case)()


def test_tables_equal():
    assert tc.EXACT_INPUT_ROLES == jc.EXACT_INPUT_ROLES
    assert tc.PREFIX_ROLES == jc.PREFIX_ROLES


@pytest.mark.parametrize("name,et", [
    ("x_lens", 7), ("enc_out", 1), ("memory", 1), ("use_cache_branch", 9), ("flag", 9),
    ("past_0", 1), ("hidden_state", 1), ("lang", 7), ("itn_norm", 6), ("decoder_input", 7),
    ("labels", 7), ("target_len", 6), ("whatever", None), ("mystery", 7)])
def test_heuristics_agree(name, et):
    assert tc.input_role(name, et) == jc.input_role(name, et)


def test_engines_raise_on_unbindable_decoder_int(tmp_path):
    """A TDT decoder_joint with an unclassifiable int input must refuse to
    load in the port too (the JAX case, on the port's engine)."""
    from crispy_tpu_torch.engine.onnx_engines import OnnxTdtEngine
    from test_onnx_engines import make_parakeet_bundle

    d = make_parakeet_bundle(tmp_path)
    V, D, H = 10, 8, 6
    emb = (np.random.default_rng(0).standard_normal((V + 1 + 5, H)) * 0.5).astype(np.float32)
    (d / "decoder_joint-model.int8.onnx").unlink()
    ob.write_model(d / "decoder_joint-model.int8.onnx", [
        ob.node("Gather", ["emb", "targets"], ["te"], axis=0),
        ob.node("ReduceSum", ["te", "ax1"], ["outputs"], keepdims=0),
    ], [("encoder_outputs", F32, [None, D, 1]), ("targets", I32, [None, 1]),
        ("mystery_knob", I32, [None]), ("input_states_1", F32, [1, None, H])],
        [("outputs", F32, [None, V + 6]), ("output_states_1", F32, [1, None, H])],
        {"emb": emb, "ax1": np.array([1], np.int64)})
    with pytest.raises(ValueError, match="mystery_knob"):
        OnnxTdtEngine(d, "tdt-mystery", device="cpu")
