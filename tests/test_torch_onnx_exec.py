"""The port's ONNX executor (crispy_tpu_torch.models.onnx_exec) against the
JAX package's, on the CPU.

Every case of the JAX package's executor tests (test_onnx_exec,
test_onnx_exec_controlflow, test_onnx_exec_transformer, test_onnx_import)
runs as a case here with its runner swapped for ``DualRunner``: each graph
the case builds is loaded by both executors, each call runs both on the
same inputs and the outputs must agree before the case's own checks see
the JAX package's. Numpy inputs (static in both packages) are also run as
device-style inputs (jax arrays against torch tensors), so both the host
partial evaluation and the tensor path are held. Under ``jax.jit`` the
port runs on the concrete values through ``jax.pure_callback``; a case
that JAX refuses must be refused by the port as well (the same exception
type), except a refusal that exists only under jit (the port has no jit).

Tolerances: floats within 1e-5 of the output's largest |value|; integers,
booleans and shapes exact (DynamicQuantizeLinear codes, MatMulInteger and
ConvInteger included).
"""

import importlib
import inspect
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="the JAX reference is not installed")
import jax.numpy as jnp  # noqa: E402

import onnx_builder as ob
from crispy_tpu.models import onnx_exec as jexec
from crispy_tpu.models import onnx_import as jimport
from crispy_tpu_torch.models import onnx_exec as texec
from crispy_tpu_torch.models import onnx_import as timport
from torch_audio import one_torch_thread  # noqa: F401 (autouse fixture)

F32, U8, I8, I64 = 1, 2, 3, 7
RTOL = 1e-5  # floats, x the output's largest |value|
MODULES = ("test_onnx_exec", "test_onnx_exec_controlflow", "test_onnx_exec_transformer",
           "test_onnx_import")
JRunner = jexec.OnnxRunner
_jmmi = jexec._mmi
_jload_graph = jexec.load_onnx_graph


def assert_same(want, got, what: str) -> None:
    """One output of the JAX package against the port's."""
    w = np.asarray(want)
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert w.shape == g.shape, f"{what}: shape {g.shape} != {w.shape}"
    if w.dtype.kind in "fc" or g.dtype.kind in "fc":
        w64, g64 = w.astype(np.float64), g.astype(np.float64)
        scale = float(np.nanmax(np.abs(w64))) if w.size and np.isfinite(w64).any() else 0.0
        np.testing.assert_allclose(g64, w64, rtol=0, atol=RTOL * max(scale, 1e-30),
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64), err_msg=what)


def _is_jax(v) -> bool:
    return isinstance(v, jax.Array)


def _run(fn, *args, **kwargs):
    """(outputs, None) or (None, the refusal)."""
    try:
        return fn(*args, **kwargs), None
    except (NotImplementedError, ValueError) as e:
        return None, e


class DualRunner:
    """Both packages' runners on one file; calls return the JAX package's
    outputs after holding the port's to them."""

    def __init__(self, j, t):
        self.j, self.t = j, t

    @staticmethod
    def load(path):
        # not JRunner.load: it reads the module's OnnxRunner, patched here
        return DualRunner(JRunner(_jload_graph(path)), texec.OnnxRunner.load(path))

    def __getattr__(self, name):
        return getattr(self.j, name)

    def validate(self):
        _, terr = _run(self.t.validate)
        _, jerr = _run(self.j.validate)
        assert type(terr) is type(jerr), (jerr, terr)
        if jerr is not None:
            assert str(terr) == str(jerr)
            raise jerr
        return self

    def big_params(self):
        want = self.j.big_params()
        assert set(self.t.big_params()) == set(want)
        return want

    def _port(self, params, inputs, dynamic: bool):
        """The port on the same values: static (numpy) or as tensors."""
        tin = {k: torch.from_numpy(np.array(v)) if dynamic else np.asarray(v)
               for k, v in inputs.items()}
        return _run(self.t, self.t.lift_big_params("cpu") if params else None, **tin)

    def _compare(self, want, got, where: str):
        assert list(got) == list(want), (list(got), list(want))
        for k in want:
            assert_same(want[k], got[k], f"{where} output {k!r}")

    def __call__(self, params=None, /, **inputs):
        args = () if params is None else (params,)
        traced = any(isinstance(v, jax.core.Tracer)
                     for v in list(inputs.values()) + list((params or {}).values()))
        dynamic = any(_is_jax(v) for v in inputs.values())
        want, jerr = _run(self.j, *args, **inputs)
        if jerr is not None:
            if traced and "under jit" in str(jerr):
                raise jerr  # a refusal of jit alone: the port has no jit
            probe = ({k: np.zeros(v.shape, v.dtype) for k, v in inputs.items()}
                     if traced else inputs)
            _, terr = self._port(params, probe, dynamic or traced)
            assert type(terr) is type(jerr), f"JAX refused ({jerr!r}), the port gave {terr!r}"
            raise jerr
        if traced:
            names = list(want)
            keys = list(inputs)

            def check(*flat):
                ins, outs = flat[:len(keys)], flat[len(keys):]
                got, terr = self._port(params, dict(zip(keys, ins)), True)
                assert terr is None, terr
                self._compare(dict(zip(names, outs)), got, "jit")
                return tuple(np.asarray(o) for o in outs)

            shapes = tuple(jax.ShapeDtypeStruct(want[n].shape, want[n].dtype) for n in names)
            outs = jax.pure_callback(check, shapes, *[inputs[k] for k in keys],
                                     *[want[n] for n in names])
            return dict(zip(names, outs))
        got, terr = self._port(params, inputs, dynamic)
        assert terr is None, terr
        self._compare(want, got, "dynamic" if dynamic else "static")
        if not dynamic:  # the same values as device-style inputs, both packages
            jin = {k: jnp.asarray(v) for k, v in inputs.items()}
            want_d, jerr_d = _run(self.j, *args, **jin)
            got_d, terr_d = self._port(params, inputs, True)
            assert type(terr_d) is type(jerr_d), (jerr_d, terr_d)
            if jerr_d is None:
                self._compare(want_d, got_d, "dynamic")
        return want


def dual_mmi(node, a, b, azp=None, bzp=None):
    want = _jmmi(node, a, b, azp, bzp)
    t = [None if v is None else torch.from_numpy(np.array(v)) for v in (a, b, azp, bzp)]
    got = texec._mmi(node, *t)
    assert got.dtype == torch.int32
    assert_same(want, got, "MatMulInteger")
    return want


def dual_load_graph(path):
    want = _jload_graph(path)
    got = texec.load_onnx_graph(path)
    assert [(n.op_type, n.inputs, n.outputs, n.name) for n in got.nodes] == \
        [(n.op_type, n.inputs, n.outputs, n.name) for n in want.nodes]
    for gn, wn in zip(got.nodes, want.nodes):
        assert set(gn.attrs) == set(wn.attrs)
        for k in wn.attrs:
            if isinstance(wn.attrs[k], np.ndarray):
                np.testing.assert_array_equal(gn.attrs[k], wn.attrs[k])
            elif not isinstance(wn.attrs[k], jexec.OnnxGraph):
                assert gn.attrs[k] == wn.attrs[k]
    assert set(got.initializers) == set(want.initializers)
    for k, v in want.initializers.items():
        np.testing.assert_array_equal(got.initializers[k], v)
    assert (got.inputs, got.outputs, got.outputs_info) == \
        (want.inputs, want.outputs, want.outputs_info)
    return want


def dual_load_weights(path):
    want = jimport.load_onnx_weights(path)
    got = timport.load_onnx_weights(path)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v)
    return want


def _expand(module: str, cls, name: str, fn):
    """The (module, class, function, parameters) cases of one JAX test."""
    cases = [{}]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        argnames, values = mark.args[0], mark.args[1]
        argnames = [a.strip() for a in argnames.split(",")] if isinstance(argnames, str) \
            else list(argnames)
        rows = [dict(zip(argnames, v if len(argnames) > 1 else (v,))) for v in values]
        cases = [{**c, **r} for c in cases for r in rows]
    out = []
    for c in cases:
        suffix = "-".join(str(v) for v in c.values())
        cid = f"{module}::{cls + '::' if cls else ''}{name}{f'[{suffix}]' if c else ''}"
        out.append(pytest.param(module, cls, name, c, id=cid))
    return out


def _cases():
    out = []
    for module in MODULES:
        mod = importlib.import_module(module)
        for name, obj in vars(mod).items():
            if name.startswith("test_") and inspect.isfunction(obj):
                out += _expand(module, None, name, obj)
            elif name.startswith("Test") and inspect.isclass(obj):
                for mname, m in vars(obj).items():
                    if mname.startswith("test_") and inspect.isfunction(m):
                        out += _expand(module, name, mname, m)
    return out


CASES = _cases()


def test_every_case_of_the_jax_executor_tests_is_here():
    counts = {m: sum(1 for c in CASES if c.values[0] == m) for m in MODULES}
    assert counts == {"test_onnx_exec": 25, "test_onnx_exec_controlflow": 23,
                      "test_onnx_exec_transformer": 2, "test_onnx_import": 3}


@pytest.mark.parametrize("module,cls,name,params", CASES)
def test_jax_case_through_both_executors(module, cls, name, params, request, monkeypatch):
    mod = importlib.import_module(module)
    for target in (mod, jexec):
        if hasattr(target, "OnnxRunner"):
            monkeypatch.setattr(target, "OnnxRunner", DualRunner)
    monkeypatch.setattr(jexec, "_mmi", dual_mmi)
    if hasattr(mod, "load_onnx_graph"):
        monkeypatch.setattr(mod, "load_onnx_graph", dual_load_graph)
    if hasattr(mod, "load_onnx_weights"):
        monkeypatch.setattr(mod, "load_onnx_weights", dual_load_weights)
    fn = getattr(getattr(mod, cls)(), name) if cls else getattr(mod, name)
    kwargs = dict(params)
    for arg in inspect.signature(fn).parameters:
        if arg not in kwargs:
            kwargs[arg] = request.getfixturevalue(arg)
    fn(**kwargs)


def test_op_names_equal_the_jax_table():
    assert set(texec._OPS) == set(jexec._OPS)
    assert texec.SUBGRAPH_OPS == jexec.SUBGRAPH_OPS


def _both(tmp_path, nodes, inputs, outputs, inits=None):
    p = tmp_path / "m.onnx"
    ob.write_model(p, nodes, inputs, outputs, inits)
    return DualRunner.load(p)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0, -5.0])
def test_dynamic_quantize_codes_exact(tmp_path, scale):
    """The uint8 codes, scale and zero point equal the JAX package's bit for
    bit (all-zero input: scale 1), and the s8 product on them is exact."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 5, 24)) * scale).astype(np.float32)
    if scale < 0:
        x = -np.abs(x)  # all negative: zero point at 255
    w = rng.integers(-127, 128, (24, 12), dtype=np.int8)
    r = _both(tmp_path, [
        ob.node("DynamicQuantizeLinear", ["x"], ["q", "s", "z"]),
        ob.node("MatMulInteger", ["q", "w", "z", "wz"], ["y"]),
    ], [("x", F32, [3, 5, 24])], [("q", U8, None), ("s", F32, None), ("z", U8, None),
                                   ("y", 6, None)],
        {"w": w, "wz": np.int8(3)})
    out = r(x=x)
    assert np.asarray(out["q"]).dtype == np.uint8


def test_convinteger_exact(tmp_path):
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (2, 6, 17), dtype=np.uint8)
    w = rng.integers(-128, 128, (4, 3, 5), dtype=np.int8)
    r = _both(tmp_path, [
        ob.node("ConvInteger", ["x", "w", "xz", "wz"], ["y"], group=2, strides=[2],
                pads=[2, 1], dilations=[1]),
    ], [("x", U8, [2, 6, 17])], [("y", 6, None)], {"w": w, "xz": np.uint8(131),
                                                   "wz": np.int8(-2)})
    y = np.asarray(r(x=x)["y"])

    def channel(b, co):  # group co // 2 reads input channels 3g .. 3g + 2
        g = co // 2
        return sum(np.correlate(np.pad(x[b, 3 * g + c].astype(np.int64) - 131, (2, 1)),
                                w[co, c].astype(np.int64) + 2, "valid")[::2]
                   for c in range(3))

    ref = np.array([[channel(b, co) for co in range(4)] for b in range(2)])
    np.testing.assert_array_equal(y, ref)


@pytest.mark.parametrize("M,K,N", [(8, 640, 1030), (1, 1, 1), (17, 24, 8), (3000, 1024, 64)])
def test_padded_int_mm_meets_the_card_rules(M, K, N):
    """The card's s8 product pads to cuBLASLt's rules (more than 16 rows, K
    and N multiples of 8; the right operand column-major) and crops back:
    checked here with a stand-in for torch._int_mm that asserts the rules
    and multiplies exactly."""
    rng = np.random.default_rng(M + K)
    a = torch.from_numpy(rng.integers(-128, 128, (M, K), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, (K, N), dtype=np.int8))

    def int_mm(x, y):
        assert x.dtype == y.dtype == torch.int8 and x.is_contiguous() and y.t().is_contiguous()
        assert x.shape[0] > 16 and x.shape[1] % 8 == 0 and y.shape[1] % 8 == 0
        return texec._int_matmul(x, y)

    got = texec._padded_int_mm(a, b, mm=int_mm)
    want = a.numpy().astype(np.int64) @ b.numpy().astype(np.int64)
    assert got.dtype == torch.int32 and got.shape == (M, N)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["reshape-shape-from-input", "nonzero", "unknown-op"])
def test_dynamic_shapes_and_unknown_ops_raise_in_both(tmp_path, case):
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    if case == "reshape-shape-from-input":
        r = _both(tmp_path, [ob.node("Reshape", ["x", "s"], ["y"])],
                  [("x", F32, [3, 4]), ("s", I64, [2])], [("y", F32, None)])
        with pytest.raises(NotImplementedError, match="Reshape shape"):
            r(x=jnp.asarray(x), s=jnp.asarray([4, 3]))
    elif case == "nonzero":
        r = _both(tmp_path, [ob.node("NonZero", ["x"], ["y"])],
                  [("x", F32, [3, 4])], [("y", I64, None)])
        with pytest.raises(NotImplementedError, match="NonZero"):
            r(x=jnp.asarray(x))
    else:
        r = _both(tmp_path, [ob.node("FancyOp", ["x"], ["y"])],
                  [("x", F32, [3, 4])], [("y", F32, None)])
        with pytest.raises(NotImplementedError, match=re.escape("FancyOp")):
            r.validate()


def test_static_nodes_stay_on_the_host_and_uploads_are_reused(tmp_path):
    """The shape chain of a device-style call runs on the host (numpy, no
    device value), and the second call uploads nothing new."""
    r = texec.OnnxRunner.load(ob.write_model(tmp_path / "m.onnx", [
        ob.node("Shape", ["x"], ["s"]),
        ob.node("Gather", ["s", "i0"], ["b"], axis=0),
        ob.node("Unsqueeze", ["b", "ax0"], ["bu"]),
        ob.node("Concat", ["bu", "m1"], ["tgt"], axis=0),
        ob.node("Reshape", ["x", "tgt"], ["y"]),
        ob.node("Mul", ["y", "g"], ["z"]),
    ], [("x", F32, [3, 4, 5])], [("z", F32, [3, 20])],
        {"i0": np.array(0, np.int64), "m1": np.array([-1], np.int64),
         "ax0": np.array([0], np.int64), "g": np.arange(20, dtype=np.float32)}))
    x = torch.arange(60, dtype=torch.float32).reshape(3, 4, 5)
    z = r(x=x)["z"]
    assert r.counts == {"device": 3, "host": 3}
    torch.testing.assert_close(z, x.reshape(3, 20) * torch.arange(20.0), rtol=0, atol=0)
    seen = {k: v[1] for k, v in r._uploaded.items()}
    r(x=x)
    assert {k: v[1] for k, v in r._uploaded.items()} == seen
    assert all(r._uploaded[k][1] is t for k, t in seen.items())
