"""Generic ONNX executor in PyTorch: load an .onnx graph and run it eagerly,
one node at a time, on the tensors' device.

The port of ``crispy_tpu/models/onnx_exec.py``. Every non-whisper artifact
in the reference catalog is an ONNX export consumed through ONNX Runtime
(transcribe-rs engines, managers/transcription.rs:119-172, and the
diarization nets); this executor runs those same files, the int8
dynamic-quantized bundles (DynamicQuantizeLinear / MatMulInteger graphs)
included. The op table has the JAX package's 122 op names, so ``validate``
refuses exactly the graphs it refuses.

Static partial evaluation, as in the JAX package: host numpy is static, a
torch tensor is dynamic. A node whose inputs are all static runs on the
host (torch on the CPU) and its outputs go back to numpy, so shape
arithmetic (Shape→Gather→Concat→Reshape chains, slice indices, pad amounts)
never reaches the device and needs no sync. A node with a dynamic input
runs on that input's device; its static inputs are uploaded once per value
name and device (``OnnxRunner._on``) and keep their numpy beside them
(``_static`` reads it), so the same initializer is never copied twice and a
shape read of a device tensor never syncs. ``_static`` of a tensor that has
no numpy raises, as the JAX package's does of a tracer.

Integer semantics follow the JAX package (x64 off), not ONNX Runtime:
float64 values compute in float32, integer Div floors, Mod without fmod
follows the divisor's sign. MatMulInteger is exact: s8xs8→s32 through
cuBLASLt (``torch._int_mm``) on the card, float64 on the CPU.
"""

from __future__ import annotations

import functools
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .onnx_import import _DTYPES, _fields, _parse_tensor, _read_varint

# ---------------------------------------------------------------------------
# Graph protobuf parsing (NodeProto / AttributeProto / ValueInfoProto)
# ---------------------------------------------------------------------------


def _to_i64(v: int) -> int:
    """Protobuf varints encode int64 as 2's complement in 64 bits."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_attr(buf) -> Tuple[str, Any]:
    name = ""
    atype = None
    f = i = s = t = g = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for fld, wire, val in _fields(buf):
        if fld == 1:
            name = bytes(val).decode()
        elif fld == 2 and wire == 5:
            f = struct.unpack("<f", val)[0]
        elif fld == 3 and wire == 0:
            i = _to_i64(val)
        elif fld == 4 and wire == 2:
            s = bytes(val)
        elif fld == 5 and wire == 2:
            t = _parse_tensor(val)[1]
        elif fld == 6 and wire == 2:
            g = _parse_graph(val)
        elif fld == 7:
            if wire == 5:
                floats.append(struct.unpack("<f", val)[0])
            elif wire == 2:  # packed
                floats.extend(np.frombuffer(bytes(val), "<f4").tolist())
        elif fld == 8:
            if wire == 0:
                ints.append(_to_i64(val))
            elif wire == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    ints.append(_to_i64(v))
        elif fld == 9 and wire == 2:
            strings.append(bytes(val))
        elif fld == 20 and wire == 0:
            atype = val
    # Pick the populated payload (type tag is advisory).
    for cand in (t, g):
        if cand is not None:
            return name, cand
    if floats:
        return name, floats
    if ints:
        return name, ints
    if strings:
        return name, strings
    if s is not None:
        return name, s.decode("utf-8", errors="replace")
    if f is not None and atype == 1:
        return name, f
    if i is not None and atype == 2:
        return name, i
    if f is not None:
        return name, f
    if i is not None:
        return name, i
    return name, None


@dataclass
class OnnxNode:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any]
    name: str = ""


@dataclass
class OnnxGraph:
    nodes: List[OnnxNode] = field(default_factory=list)
    initializers: Dict[str, np.ndarray] = field(default_factory=dict)
    inputs: List[Tuple[str, Optional[int], List[Optional[int]]]] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    outputs_info: List[Tuple[str, Optional[int], List[Optional[int]]]] = field(default_factory=list)
    name: str = ""


def _parse_value_info(buf) -> Tuple[str, Optional[int], List[Optional[int]]]:
    name = ""
    elem_type = None
    shape: List[Optional[int]] = []
    for fld, wire, val in _fields(buf):
        if fld == 1 and wire == 2:
            name = bytes(val).decode()
        elif fld == 2 and wire == 2:  # TypeProto
            for tf, tw, tv in _fields(val):
                if tf == 1 and tw == 2:  # tensor_type
                    for sf, sw, sv in _fields(tv):
                        if sf == 1 and sw == 0:
                            elem_type = sv
                        elif sf == 2 and sw == 2:  # TensorShapeProto
                            for df, dw, dv in _fields(sv):
                                if df == 1 and dw == 2:  # Dimension
                                    dim: Optional[int] = None
                                    for xf, xw, xv in _fields(dv):
                                        if xf == 1 and xw == 0:
                                            dim = _to_i64(xv)
                                    shape.append(dim)
    return name, elem_type, shape


def _parse_node(buf) -> OnnxNode:
    inputs: List[str] = []
    outputs: List[str] = []
    op_type = ""
    name = ""
    attrs: Dict[str, Any] = {}
    for fld, wire, val in _fields(buf):
        if fld == 1 and wire == 2:
            inputs.append(bytes(val).decode())
        elif fld == 2 and wire == 2:
            outputs.append(bytes(val).decode())
        elif fld == 3 and wire == 2:
            name = bytes(val).decode()
        elif fld == 4 and wire == 2:
            op_type = bytes(val).decode()
        elif fld == 5 and wire == 2:
            k, v = _parse_attr(val)
            attrs[k] = v
    return OnnxNode(op_type, inputs, outputs, attrs, name)


def _parse_graph(buf) -> OnnxGraph:
    g = OnnxGraph()
    for fld, wire, val in _fields(buf):
        if fld == 1 and wire == 2:
            g.nodes.append(_parse_node(val))
        elif fld == 2 and wire == 2:
            g.name = bytes(val).decode()
        elif fld == 5 and wire == 2:
            name, arr = _parse_tensor(val)
            if name is not None and arr is not None:
                g.initializers[name] = arr
        elif fld == 11 and wire == 2:
            g.inputs.append(_parse_value_info(val))
        elif fld == 12 and wire == 2:
            info = _parse_value_info(val)
            g.outputs.append(info[0])
            g.outputs_info.append(info)
    return g


def load_onnx_graph(path) -> OnnxGraph:
    """Parse ModelProto → OnnxGraph (nodes + attrs + initializers + I/O)."""
    data = memoryview(Path(path).read_bytes())
    for fld, wire, val in _fields(data):
        if fld == 7 and wire == 2:  # ModelProto.graph
            return _parse_graph(val)
    raise ValueError(f"no graph in {path}")


# ---------------------------------------------------------------------------
# Static (host numpy) and dynamic (tensor) values
# ---------------------------------------------------------------------------

def _is_static(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic, int, float, bool))


def _static(v, what: str) -> np.ndarray:
    """The host value of a static input: numpy as it is, or the numpy a
    tensor was made from. A tensor computed on a device has none: raise."""
    if isinstance(v, torch.Tensor):
        host = getattr(v, "_np", None)
        if host is None:
            raise NotImplementedError(f"dynamic (device) {what} is unsupported")
        return host
    if not (_is_static(v) or isinstance(v, (list, tuple))):  # a list: attribute form
        raise NotImplementedError(f"dynamic (traced) {what} is unsupported")
    return np.asarray(v)


def _host_tensor(a) -> torch.Tensor:
    """numpy → a CPU tensor that remembers its numpy (``_np``). float64
    computes as float32 and uint16 as int32, as the JAX package's values
    do without x64."""
    a = np.asarray(a)
    b = a
    if b.dtype == np.float64:
        b = b.astype(np.float32)
    elif b.dtype == np.uint16:
        b = b.astype(np.int32)
    elif not (b.flags.writeable and b.flags.c_contiguous):
        b = np.array(b)
    t = torch.from_numpy(b)
    t._np = a
    return t


def _to_host(o):
    return o.numpy() if isinstance(o, torch.Tensor) else o


# ONNX elem_type → torch dtype; DOUBLE casts to float32 (x64 off).
_TORCH_OF_ONNX = {
    1: torch.float32, 2: torch.uint8, 3: torch.int8, 4: torch.int32, 5: torch.int16,
    6: torch.int32, 7: torch.int64, 9: torch.bool, 10: torch.float16, 11: torch.float32,
}


def _pairs(pads: Sequence[int]) -> List[Tuple[int, int]]:
    """ONNX pads [b0, b1, .., e0, e1, ..] → [(b0, e0), (b1, e1), ..]."""
    n = len(pads) // 2
    return [(int(pads[i]), int(pads[i + n])) for i in range(n)]


def _auto_pads(auto_pad: str, in_spatial, kernel, strides, dilations):
    """SAME_UPPER/SAME_LOWER explicit pad pairs (NOTSET handled by caller)."""
    out = []
    for x, k, s, d in zip(in_spatial, kernel, strides, dilations):
        eff = (k - 1) * d + 1
        o = -(-x // s)
        total = max(0, (o - 1) * s + eff - x)
        if auto_pad == "SAME_LOWER":
            out.append((total - total // 2, total // 2))
        else:
            out.append((total // 2, total - total // 2))
    return out


def _flat_pad(pairs: Sequence[Tuple[int, int]]) -> List[int]:
    """[(b0, e0), (b1, e1), ..] per leading-first axis → F.pad's last-first list."""
    out: List[int] = []
    for lo, hi in reversed(list(pairs)):
        out += [lo, hi]
    return out


class OnnxRunner:
    """Executable wrapper: ``runner(x=..., y=...)`` → dict of outputs.

    Inputs given as numpy are static: with only static inputs the whole graph
    evaluates on the host and returns numpy. Tensor inputs run on their
    device. ``counts`` holds the nodes of the last call by where they ran."""

    # Initializers at/above this size are "weights": ``lift_big_params``
    # puts them on the device once, and the engines pass them back through
    # ``__call__``'s params as dynamic values, as the JAX package passes
    # them through its jits. Below it they stay numpy, static for the
    # partial evaluator and uploaded once where they meet the device.
    BIG_PARAM_BYTES = 16384

    def __init__(self, graph: OnnxGraph):
        self.graph = graph
        self.input_names = [n for n, _, _ in graph.inputs if n not in graph.initializers]
        self.output_names = list(graph.outputs)
        self._uploaded: Dict[Tuple[str, torch.device], Tuple[np.ndarray, torch.Tensor]] = {}
        self._free_plans: Dict[int, Tuple[Any, List[List[str]]]] = {}
        self.counts = {"device": 0, "host": 0}

    @staticmethod
    def load(path) -> "OnnxRunner":
        return OnnxRunner(load_onnx_graph(path))

    def input_info(self) -> List[Tuple[str, Optional[int], List[Optional[int]]]]:
        return [i for i in self.graph.inputs if i[0] not in self.graph.initializers]

    def validate(self) -> "OnnxRunner":
        """Raise NotImplementedError up front if any node op is unsupported
        (refuses the graph at load time, not mid-inference)."""
        def collect(nodes):
            for n in nodes:
                if n.op_type in SUBGRAPH_OPS:
                    for sub in n.attrs.values():
                        if isinstance(sub, OnnxGraph):
                            yield from collect(sub.nodes)
                    continue
                yield n.op_type

        missing = sorted({t for t in collect(self.graph.nodes) if t not in _OPS})
        if missing:
            raise NotImplementedError(f"unsupported ONNX ops: {', '.join(missing)}")
        return self

    def big_params(self) -> Dict[str, np.ndarray]:
        """The weight-class initializers (≥ BIG_PARAM_BYTES). Subgraph
        (If/Loop/Scan) initializers stay static: they are small in practice."""
        return {k: v for k, v in self.graph.initializers.items()
                if getattr(v, "nbytes", 0) >= self.BIG_PARAM_BYTES}

    def lift_big_params(self, device) -> Dict[str, torch.Tensor]:
        """big_params on ``device``, copied once (at engine load): pass them
        to every call as ``params``."""
        return {k: _host_tensor(v).to(device) for k, v in self.big_params().items()}

    @torch.no_grad()
    def __call__(self, params: Optional[Dict[str, Any]] = None, /,
                 **inputs) -> Dict[str, Any]:
        # `params` is positional-only so a graph input literally named
        # "params" still routes through **inputs.
        vals: Dict[str, Any] = dict(self.graph.initializers)
        vals[""] = None  # optional (absent) input slot
        for n in self.input_names:
            if n not in inputs:
                raise ValueError(f"missing graph input {n!r}")
        if params:
            vals.update(params)
        vals.update(inputs)
        self.counts = {"device": 0, "host": 0}
        self._run_nodes(self.graph.nodes, vals, self.output_names)
        return {n: vals[n] for n in self.output_names}

    def _free_plan(self, nodes, keep) -> List[List[str]]:
        """For each node, the values whose last use it is (none of ``keep``):
        an eager run frees each intermediate after its last reader, as XLA
        frees a buffer, or a call would hold every activation of the graph.
        A node with a subgraph uses every name its body reads."""
        hit = self._free_plans.get(id(nodes))
        if hit is not None and hit[0] is nodes:
            return hit[1]

        def uses(node):
            yield from node.inputs
            for sub in node.attrs.values():
                if isinstance(sub, OnnxGraph):
                    for inner in sub.nodes:
                        yield from uses(inner)

        last: Dict[str, int] = {}
        for i, node in enumerate(nodes):
            for name in list(uses(node)) + node.outputs:
                last[name] = i
        plan: List[List[str]] = [[] for _ in nodes]
        for name, i in last.items():
            if name and name not in keep:
                plan[i].append(name)
        self._free_plans[id(nodes)] = (nodes, plan)
        return plan

    def _on(self, device: torch.device, name: str, a) -> torch.Tensor:
        """The static value ``a`` of input ``name`` as a tensor on ``device``
        that keeps its numpy: uploaded the first time, then reused while the
        value stays the same (the same initializer object, or equal small
        scaffolding recomputed by the host each call)."""
        a = np.asarray(a)
        key = (name, device)
        hit = self._uploaded.get(key)
        if hit is not None:
            old, t = hit
            if old is a or (a.nbytes <= self.BIG_PARAM_BYTES and old.dtype == a.dtype
                            and old.shape == a.shape and np.array_equal(old, a)):
                return t
        t = _host_tensor(a)
        if t.device != device:
            # from pageable memory: CUDA stages the copy, no stream sync
            t = t.to(device, non_blocking=True)
            t._np = a
        self._uploaded[key] = (a, t)
        return t

    def _run_nodes(self, nodes, vals: Dict[str, Any], keep) -> None:
        for node, free in zip(nodes, self._free_plan(nodes, keep)):
            self._run_node(node, vals)
            for name in free:
                vals.pop(name, None)

    def _run_node(self, node: "OnnxNode", vals: Dict[str, Any]) -> None:
        if node.op_type == "If":
            # the condition must be static (e.g. a use_cache_branch flag fed
            # as a numpy bool); the chosen branch runs in this scope
            cond = bool(np.asarray(_static(vals[node.inputs[0]], "If condition")).item())
            sub: OnnxGraph = node.attrs["then_branch" if cond else "else_branch"]
            inner = dict(vals)
            inner.update(sub.initializers)
            self._run_nodes(sub.nodes, inner, sub.outputs)
            for name, out_name in zip(node.outputs, sub.outputs):
                vals[name] = inner[out_name]
            return
        if node.op_type == "Loop":
            self._run_loop(node, vals)
            return
        if node.op_type == "Scan":
            self._run_scan(node, vals)
            return
        handler = _OPS.get(node.op_type)
        if handler is None:
            raise NotImplementedError(f"ONNX op {node.op_type} (node {node.name!r})")
        raw = [vals[i] if i else None for i in node.inputs]
        dev = next((a.device for a in raw if isinstance(a, torch.Tensor)), None)
        if dev is None:  # all static: evaluate on the host, keep numpy
            out = handler(node, *[None if a is None else _host_tensor(a) for a in raw])
            out = tuple(_to_host(o) for o in (out if isinstance(out, tuple) else (out,)))
            self.counts["host"] += 1
        else:
            args = [self._on(dev, i, a) if a is not None and _is_static(a) else a
                    for i, a in zip(node.inputs, raw)]
            out = handler(node, *args)
            if not isinstance(out, tuple):
                out = (out,)
            self.counts["device"] += 1
        for name, o in zip(node.outputs, out):
            if name:
                vals[name] = o

    # -- subgraph control flow (Loop / Scan) --------------------------------

    def _body_runner(self, body: "OnnxGraph", outer_vals: Dict[str, Any]):
        """One body invocation: names→values in, ordered outputs out.
        Outer-scope captures stay visible (ONNX subgraph scoping)."""
        names = [n for n, _, _ in body.inputs]

        def run(bound: Dict[str, Any]):
            inner = dict(outer_vals)
            inner.update(body.initializers)
            inner.update(bound)
            self._run_nodes(body.nodes, inner, body.outputs)
            return [inner[o] for o in body.outputs]

        return names, run

    def _run_loop(self, node: "OnnxNode", vals: Dict[str, Any]) -> None:
        """ONNX Loop, the JAX package's two strategies as eager loops:

        1. Host unroll: trip count static and the condition static each
           iteration (shape-growing carries and scan outputs allowed).
        2. A dynamic condition: the host reads it after each iteration (one
           sync an iteration) and the loop stops at the max trip count,
           which must be static; scan outputs stack to the realized count.
        """
        body: OnnxGraph = node.attrs["body"]
        m_v = vals[node.inputs[0]] if node.inputs[0] else None
        cond0 = vals[node.inputs[1]] if len(node.inputs) > 1 and node.inputs[1] else None
        carried = [vals[i] for i in node.inputs[2:]]
        n_car = len(carried)
        n_scan = len(body.outputs) - 1 - n_car
        if n_scan < 0:
            raise NotImplementedError("Loop body outputs fewer than carried inputs")
        M = None if m_v is None else int(_static(m_v, "Loop trip count").item())
        names, run = self._body_runner(body, vals)

        def loop(read_cond):
            cond = True if cond0 is None else read_cond(cond0)
            cur = list(carried)
            scans: List[List[Any]] = [[] for _ in range(n_scan)]
            i = 0
            limit = M if M is not None else 10_000  # runaway guard
            while cond and i < limit:
                bound = {names[0]: np.int64(i)}
                if len(names) > 1:
                    bound[names[1]] = np.asarray(cond)
                for nm, v in zip(names[2:], cur):
                    bound[nm] = v
                outs = run(bound)
                cond = read_cond(outs[0])
                cur = outs[1:1 + n_car]
                for k in range(n_scan):
                    scans[k].append(outs[1 + n_car + k])
                i += 1
            if M is None and i >= limit and cond:
                raise NotImplementedError(f"Loop exceeded {limit} iterations")
            stacked = []
            for k in range(n_scan):
                if not scans[k]:
                    raise NotImplementedError(
                        "Loop executed zero iterations with scan outputs "
                        "(result shape would be data-dependent)")
                parts = scans[k]
                if all(_is_static(p) for p in parts):
                    stacked.append(np.stack(parts))
                else:
                    dev = next(p.device for p in parts if isinstance(p, torch.Tensor))
                    stacked.append(torch.stack([
                        p if isinstance(p, torch.Tensor) else _host_tensor(p).to(dev)
                        for p in parts]))
            return cur + stacked

        class _DynamicCond(Exception):
            pass

        def static_cond(c):
            if not _is_static(c):
                raise _DynamicCond()
            return bool(np.asarray(c).item())

        try:
            outs = loop(static_cond)
        except _DynamicCond:
            if M is None:
                raise NotImplementedError(
                    "Loop with traced condition and no max trip count")
            outs = loop(lambda c: bool(np.asarray(c).item()) if _is_static(c)
                        else bool(c.reshape(())))
        for name, o in zip(node.outputs, outs):
            if name:
                vals[name] = o

    def _run_scan(self, node: "OnnxNode", vals: Dict[str, Any]) -> None:
        """ONNX Scan: fixed-shape per-iteration slices along axis 0 (nonzero
        input/output axes are moved, reverse directions flipped); the scan
        length is the scanned input's leading dim."""
        body: OnnxGraph = node.attrs["body"]
        n_scan_in = int(node.attrs["num_scan_inputs"])
        n_states = len(node.inputs) - n_scan_in
        dev = next((v.device for v in (vals[i] for i in node.inputs)
                    if isinstance(v, torch.Tensor)), torch.device("cpu"))

        def tensor(v):
            return v if isinstance(v, torch.Tensor) else _host_tensor(v).to(dev)

        states = [tensor(vals[i]) for i in node.inputs[:n_states]]
        xs = [tensor(vals[i]) for i in node.inputs[n_states:]]
        in_axes = node.attrs.get("scan_input_axes") or [0] * n_scan_in
        in_dirs = node.attrs.get("scan_input_directions") or [0] * n_scan_in
        xs = [torch.movedim(x, int(ax), 0) if int(ax) else x for x, ax in zip(xs, in_axes)]
        xs = [torch.flip(x, (0,)) if int(d) else x for x, d in zip(xs, in_dirs)]
        n_scan_out = len(body.outputs) - n_states
        out_axes = node.attrs.get("scan_output_axes") or [0] * n_scan_out
        out_dirs = node.attrs.get("scan_output_directions") or [0] * n_scan_out
        names, run = self._body_runner(body, vals)
        carry = states
        ys: List[List[torch.Tensor]] = [[] for _ in range(n_scan_out)]
        for step in range(xs[0].shape[0] if xs else 0):
            outs = run(dict(zip(names, carry + [x[step] for x in xs])))
            carry = [tensor(o) for o in outs[:n_states]]
            for k, o in enumerate(outs[n_states:]):
                ys[k].append(tensor(o))
        y = [torch.stack(v) for v in ys]
        y = [torch.flip(v, (0,)) if int(d) else v for v, d in zip(y, out_dirs)]
        y = [torch.movedim(v, 0, int(ax)) if int(ax) else v for v, ax in zip(y, out_axes)]
        for name, o in zip(node.outputs, list(carry) + y):
            if name:
                vals[name] = o


# -- op handlers -------------------------------------------------------------
# Each handler takes tensors (the host's for a static node, the device's
# otherwise) and returns tensors, or numpy for values that are static by
# construction (Shape, Constant, Range, ...).

# Interpreter-handled control flow (subgraph bodies execute via _run_nodes,
# not a flat handler): If (static condition), Loop, Scan.
SUBGRAPH_OPS = {"If", "Loop", "Scan"}

_OPS: Dict[str, Callable] = {}


def op(*names):
    def deco(fn):
        for n in names:
            _OPS[n] = fn
        return fn

    return deco


def _promote(*xs):
    """Tensors cast to their common dtype (numpy's rule, which ignores
    whether a tensor is 0-d, as the JAX package's arrays do)."""
    dt = functools.reduce(torch.promote_types, [x.dtype for x in xs])
    return [x.to(dt) for x in xs]


def _is_int(t: torch.Tensor) -> bool:
    return not (t.dtype.is_floating_point or t.dtype.is_complex or t.dtype == torch.bool)


def _float(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype.is_floating_point else t.to(torch.float32)


def _binary(fn):
    return lambda node, a, b: fn(*_promote(a, b))


# elementwise ----------------------------------------------------------------

op("Add")(_binary(torch.add))
op("Sub")(_binary(torch.sub))
op("Mul")(_binary(torch.mul))


@op("Div")
def _div(node, a, b):
    a, b = _promote(a, b)
    if _is_int(a):
        return torch.div(a, b, rounding_mode="floor")
    return a / b


@op("Pow")
def _pow(node, a, b):
    if a.dtype.is_floating_point and not b.dtype.is_floating_point:
        return torch.pow(a, b.to(a.dtype))
    return torch.pow(*_promote(a, b))


def _unary(fn):
    return lambda node, a: fn(a)


op("Sqrt")(_unary(lambda a: torch.sqrt(_float(a))))
op("Exp")(_unary(lambda a: torch.exp(_float(a))))
op("Log")(_unary(lambda a: torch.log(_float(a))))
op("Neg")(_unary(torch.neg))
op("Abs")(_unary(torch.abs))
op("Floor")(_unary(lambda a: torch.floor(a) if a.dtype.is_floating_point else a))
op("Ceil")(_unary(lambda a: torch.ceil(a) if a.dtype.is_floating_point else a))
op("Round")(_unary(lambda a: torch.round(a) if a.dtype.is_floating_point else a))
op("Reciprocal")(_unary(lambda a: 1.0 / _float(a)))
op("Erf")(_unary(lambda a: torch.erf(_float(a))))
op("Sin")(_unary(lambda a: torch.sin(_float(a))))
op("Cos")(_unary(lambda a: torch.cos(_float(a))))
op("Atan")(_unary(lambda a: torch.atan(_float(a))))
op("Sign")(_unary(torch.sign))
op("Tanh")(_unary(lambda a: torch.tanh(_float(a))))
op("Sigmoid")(_unary(lambda a: torch.sigmoid(_float(a))))
op("Relu")(_unary(lambda a: torch.clamp_min(a, 0)))
op("IsNaN")(_unary(torch.isnan))


@op("Mod")
def _mod(node, a, b):
    a, b = _promote(a, b)
    if node.attrs.get("fmod", 0):
        return torch.fmod(a, b)
    return torch.remainder(a, b)


@op("Trilu")
def _trilu(node, x, k=None):
    kk = int(np.asarray(_static(k, "Trilu k")).item()) if k is not None else 0
    if node.attrs.get("upper", 1):
        return torch.triu(x, kk)
    return torch.tril(x, kk)


@op("GatherND")
def _gathernd(node, data, indices):
    if node.attrs.get("batch_dims", 0):
        raise NotImplementedError("GatherND batch_dims")
    idx = indices.long()
    k = idx.shape[-1]
    flat_idx = idx.reshape(-1, k)
    cols = []
    for i in range(k):  # the spec allows negative indices: wrap them
        ii = flat_idx[:, i]
        cols.append(torch.where(ii < 0, ii + data.shape[i], ii))
    out = data[tuple(cols)]
    return out.reshape(tuple(idx.shape[:-1]) + tuple(data.shape[k:]))


@op("LeakyRelu")
def _leaky(node, a):
    alpha = node.attrs.get("alpha", 0.01)
    return torch.where(a >= 0, a, alpha * a)


@op("PRelu")
def _prelu(node, a, slope):
    a, slope = _promote(a, slope)
    return torch.where(a >= 0, a, slope * a)


@op("Elu")
def _elu(node, a):
    alpha = node.attrs.get("alpha", 1.0)
    return torch.where(a >= 0, a, alpha * (torch.exp(a) - 1))


@op("Selu")
def _selu(node, a):
    alpha = node.attrs.get("alpha", 1.6732631921768188)
    gamma = node.attrs.get("gamma", 1.0507009873554805)
    return gamma * torch.where(a >= 0, a, alpha * (torch.exp(a) - 1))


@op("HardSigmoid")
def _hardsig(node, a):
    alpha = node.attrs.get("alpha", 0.2)
    beta = node.attrs.get("beta", 0.5)
    return torch.clamp(alpha * a + beta, 0, 1)


@op("HardSwish")
def _hardswish(node, a):
    return a * torch.clamp(a / 6.0 + 0.5, 0, 1)


@op("Softplus")
def _softplus(node, a):
    a = _float(a)
    return torch.logaddexp(a, torch.zeros((), dtype=a.dtype, device=a.device))


@op("Gelu")
def _gelu(node, a):
    approx = node.attrs.get("approximate", "none") == "tanh"
    return F.gelu(_float(a), approximate="tanh" if approx else "none")


@op("Clip")
def _clip(node, a, lo=None, hi=None):
    if lo is None and "min" in node.attrs:
        lo = node.attrs["min"]
    if hi is None and "max" in node.attrs:
        hi = node.attrs["max"]
    out = a
    if lo is not None:
        out = torch.maximum(*_promote(out, lo)) if isinstance(lo, torch.Tensor) \
            else torch.clamp_min(out, lo)
    if hi is not None:
        out = torch.minimum(*_promote(out, hi)) if isinstance(hi, torch.Tensor) \
            else torch.clamp_max(out, hi)
    return out


def _variadic(fn):
    return lambda node, *xs: functools.reduce(fn, _promote(*xs))


op("Min")(_variadic(torch.minimum))
op("Max")(_variadic(torch.maximum))
op("Sum")(_variadic(torch.add))


@op("Mean")
def _mean(node, *xs):
    return functools.reduce(torch.add, _promote(*xs)) / len(xs)


@op("Where")
def _where(node, c, a, b):
    return torch.where(c.bool(), *_promote(a, b))


def _compare(fn):
    return lambda node, a, b: fn(*_promote(a, b))


op("Equal")(_compare(torch.eq))
op("Greater")(_compare(torch.gt))
op("GreaterOrEqual")(_compare(torch.ge))
op("Less")(_compare(torch.lt))
op("LessOrEqual")(_compare(torch.le))
op("Not")(_unary(lambda a: torch.logical_not(a)))
op("And")(_compare(torch.logical_and))
op("Or")(_compare(torch.logical_or))
op("Xor")(_compare(torch.logical_xor))


@op("Cast")
def _cast(node, a):
    return a.to(_TORCH_OF_ONNX[node.attrs["to"]])


@op("CastLike")
def _castlike(node, a, b):
    return a.to(b.dtype)


@op("Identity", "Dropout")
def _identity(node, a, *rest):
    return a


# matmul / gemm --------------------------------------------------------------

def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An exact integer product: float64 holds every partial sum of 8- and
    16-bit operands exactly (below 2^53)."""
    return torch.matmul(a.double(), b.double()).round().to(torch.int32)


@op("MatMul")
def _matmul(node, a, b):
    a, b = _promote(a, b)
    if _is_int(a):
        return _int_matmul(a, b)
    return torch.matmul(a, b)


@op("Gemm")
def _gemm(node, a, b, c=None):
    alpha = node.attrs.get("alpha", 1.0)
    beta = node.attrs.get("beta", 1.0)
    if node.attrs.get("transA", 0):
        a = a.transpose(-1, -2)
    if node.attrs.get("transB", 0):
        b = b.transpose(-1, -2)
    y = alpha * _matmul(node, a, b)
    if c is not None:
        y = y + beta * c
    return y


@op("Einsum")
def _einsum(node, *xs):
    return torch.einsum(node.attrs["equation"], *_promote(*xs))


# quantization ---------------------------------------------------------------

@op("DynamicQuantizeLinear")
def _dql(node, x):
    """uint8 codes, scale and zero point over the whole tensor. The codes
    equal the JAX package's bit for bit: the same f32 operations in the
    same order (divide by the scale, round half to even, clip)."""
    x = x.to(torch.float32)
    mn = torch.clamp_max(torch.amin(x), 0.0)
    mx = torch.clamp_min(torch.amax(x), 0.0)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which rounds otherwise
    scale = (mx - mn) / torch.full_like(mx, 255.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    zp = torch.clamp(torch.round(0.0 - mn / scale), 0, 255).to(torch.uint8)
    q = torch.clamp(torch.round(x / scale) + zp.to(torch.float32), 0, 255).to(torch.uint8)
    return q, scale, zp


def _s8(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """An 8-bit operand as int8 and its offset: uint8 recentred by -128."""
    if t.dtype == torch.uint8:
        return (t.to(torch.int32) - 128).to(torch.int8), 128
    return t.to(torch.int8), 0


def _padded_int_mm(a_s: torch.Tensor, b_s: torch.Tensor, mm=None) -> torch.Tensor:
    """[M, K] int8 x [K, N] int8 → [M, N] int32 through cuBLASLt's
    s8xs8→s32 (``torch._int_mm``), which needs more than 16 rows and K, N
    multiples of 8: the operands are zero-padded to that (rows to a multiple
    of 8, at least 24) and the product cropped; zero rows and columns add
    nothing. The right operand goes in column-major order (cuBLASLt's TN
    layout for int8): row-major, cuBLASLt on the H100 finds no algorithm
    for some shapes (M=304, K=64, N=128). ``mm`` stands in for
    ``torch._int_mm`` in the CPU tests."""
    M, K = a_s.shape
    N = b_s.shape[1]
    Mp, Kp, Np = max(-(-M // 8) * 8, 24), -(-K // 8) * 8, -(-N // 8) * 8
    if (Mp, Kp) != (M, K):
        a_s = F.pad(a_s, (0, Kp - K, 0, Mp - M))
    if (Kp, Np) != (K, N):
        b_s = F.pad(b_s, (0, Np - N, 0, Kp - K))
    return (mm or torch._int_mm)(a_s.contiguous(), b_s.t().contiguous().t())[:M, :N]


def _s8_product(a_s: torch.Tensor, b_s: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 x [K, N] int8 → [M, N] int32, exact: on the card the
    integer tensor cores (``_padded_int_mm``), on the CPU float64 (exact
    below 2^53)."""
    if a_s.device.type == "cuda":
        return _padded_int_mm(a_s, b_s)
    return _int_matmul(a_s, b_s)


@op("MatMulInteger")
def _mmi(node, a, b, azp=None, bzp=None):
    """(a − azp)·(b − bzp) in exact int32, decomposed as the JAX package
    decomposes it so the 8-bit product runs on the integer tensor cores:

        (a − azp)(b − bzp) = a·b − azp·colsum(b) − bzp·rowsum(a) + K·azp·bzp

    with uint8 operands recentred to int8 (a = a_s + 128, 128·colsum(b)
    folded into the corrections). Every term is exact in int32 for
    K ≤ 2^23; the corrections take the unpadded sums."""
    if a.dim() < 2 or b.dim() != 2:
        # 1-D / stacked-b oddities: the widened product
        a32 = a.to(torch.int32) - (azp.to(torch.int32) if azp is not None else 0)
        b32 = b.to(torch.int32) - (bzp.to(torch.int32) if bzp is not None else 0)
        return _int_matmul(a32, b32)
    a_s, a_off = _s8(a)
    b_s, b_off = _s8(b)
    K = a.shape[-1]
    dot = _s8_product(a_s.reshape(-1, K), b_s).reshape(tuple(a.shape[:-1]) + (b.shape[1],))
    azp32 = azp.to(torch.int32) if azp is not None else torch.zeros((), dtype=torch.int32,
                                                                   device=a.device)
    bzp32 = bzp.to(torch.int32) if bzp is not None else torch.zeros((), dtype=torch.int32,
                                                                   device=a.device)
    if azp32.dim() >= 1:  # per-row a zero point: [M] → [M, 1]
        azp32 = azp32[..., :, None]
    # row/col sums of the ORIGINAL operands (undo the s8 recentring)
    colsum_b = b_s.sum(dim=0, dtype=torch.int32) + b_off * K     # [N]
    rowsum_a = a_s.sum(dim=-1, dtype=torch.int32) + a_off * K    # [.., M]
    ab = dot + a_off * colsum_b + b_off * rowsum_a[..., None] - a_off * b_off * K
    return (ab - azp32 * colsum_b - bzp32 * rowsum_a[..., None]
            + K * azp32 * bzp32).to(torch.int32)


@op("ConvInteger")
def _convinteger(node, x, w, xzp=None, wzp=None):
    x32 = x.to(torch.int32)
    w32 = w.to(torch.int32)
    if xzp is not None:
        x32 = x32 - xzp.to(torch.int32)
    if wzp is not None:
        w32 = w32 - wzp.to(torch.int32)
    return _conv_impl(node, x32, w32, None)


def _channel_shape(s: torch.Tensor, x: torch.Tensor, axis: int) -> torch.Tensor:
    if s.dim() == 1 and s.shape[0] > 1:
        shape = [1] * x.dim()
        shape[axis] = s.shape[0]
        return s.reshape(shape)
    return s


@op("QuantizeLinear")
def _ql(node, x, scale, zp=None):
    axis = node.attrs.get("axis", 1)
    y = torch.round(x / _channel_shape(scale, x, axis))
    if zp is not None:
        z = _channel_shape(zp, x, axis)
        y = y + z.to(y.dtype)
        lo, hi = (0, 255) if z.dtype == torch.uint8 else (-128, 127)
        return torch.clamp(y, lo, hi).to(z.dtype)
    return torch.clamp(y, -128, 127).to(torch.int8)


@op("DequantizeLinear")
def _dql2(node, x, scale, zp=None):
    axis = node.attrs.get("axis", 1)
    x = x.to(torch.float32)
    if zp is not None:
        x = x - _channel_shape(zp.to(torch.float32), x, axis)
    return x * _channel_shape(scale, x, axis)


# shape / structure ----------------------------------------------------------

@op("Shape")
def _shape(node, a):
    shape = tuple(a.shape)
    start = node.attrs.get("start", 0)
    end = node.attrs.get("end", len(shape))
    return np.array(shape[start:end], np.int64)


@op("Size")
def _size(node, a):
    return np.array(int(np.prod(tuple(a.shape))), np.int64)


@op("Reshape")
def _reshape(node, a, shape):
    tgt = [int(s) for s in _static(shape, "Reshape shape").reshape(-1)]
    src = list(a.shape)
    out = []
    for i, s in enumerate(tgt):
        if s == 0 and not node.attrs.get("allowzero", 0):
            out.append(src[i])
        else:
            out.append(s)
    return torch.reshape(a, out)


@op("Transpose")
def _transpose(node, a):
    perm = node.attrs.get("perm")
    if perm is None:
        return a.permute(*reversed(range(a.dim())))
    return a.permute(*[int(p) for p in perm])


@op("Concat")
def _concat(node, *xs):
    return torch.cat(_promote(*[x for x in xs if x is not None]), dim=int(node.attrs["axis"]))


@op("Split")
def _split(node, a, split=None):
    axis = int(node.attrs.get("axis", 0))
    if split is None and "split" in node.attrs:
        split = node.attrs["split"]
    if split is None:
        n = int(node.attrs.get("num_outputs", len(node.outputs)))
        L = a.shape[axis]
        if L % n:  # spec (opset 18): uneven split → last chunk smaller
            chunk = -(-L // n)
            return tuple(torch.tensor_split(a, [chunk * i for i in range(1, n)], dim=axis))
        return tuple(torch.tensor_split(a, n, dim=axis))
    sizes = [int(s) for s in np.asarray(_static(split, "Split sizes")).reshape(-1)]
    return tuple(torch.split(a, sizes, dim=axis))


def _slice_axis(x: torch.Tensor, ax: int, start, end, step: int) -> torch.Tensor:
    """numpy's x[start:end:step] along ax; a negative step slices the flipped
    axis forward (torch slices take positive steps only)."""
    n = x.shape[ax]
    s, e, st = slice(start, end, step).indices(n)
    if st > 0:
        return x[(slice(None),) * ax + (slice(s, e, st),)]
    count = len(range(s, e, st))
    if count == 0:
        return x.narrow(ax, 0, 0)
    s2 = n - 1 - s
    return torch.flip(x, (ax,))[(slice(None),) * ax + (slice(s2, s2 + (count - 1) * -st + 1,
                                                             -st),)]


@op("Slice")
def _slice(node, a, starts=None, ends=None, axes=None, steps=None):
    if starts is None:  # opset-1 style: attrs
        starts = node.attrs["starts"]
        ends = node.attrs["ends"]
        axes = node.attrs.get("axes")
    starts = [int(v) for v in np.asarray(_static(starts, "Slice starts")).reshape(-1)]
    ends = [int(v) for v in np.asarray(_static(ends, "Slice ends")).reshape(-1)]
    nd = a.dim()
    if axes is None:
        axes_l = list(range(len(starts)))
    else:
        axes_l = [int(v) % nd for v in np.asarray(_static(axes, "Slice axes")).reshape(-1)]
    steps_l = ([int(v) for v in np.asarray(_static(steps, "Slice steps")).reshape(-1)]
               if steps is not None else [1] * len(starts))
    x = a
    for ax, st, en, sp in zip(axes_l, starts, ends, steps_l):
        # INT64_MAX / INT64_MIN are the ONNX "to the end" sentinels for
        # forward / reversed slices respectively
        end = None if (en >= 2 ** 62 or (sp < 0 and en <= -2 ** 62)) else en
        start = None if (sp < 0 and st >= 2 ** 62) else st
        x = _slice_axis(x, ax, start, end, sp)
    return x


def _wrap_negative(ii: torch.Tensor, n: int) -> torch.Tensor:
    if ii.dtype in (torch.int8, torch.int16, torch.int32, torch.int64):
        return torch.where(ii < 0, ii + n, ii)
    return ii


@op("Gather")
def _gather(node, a, idx):
    axis = int(node.attrs.get("axis", 0)) % a.dim()
    ii = _wrap_negative(idx, a.shape[axis]).long()
    out = torch.index_select(a, axis, ii.reshape(-1))
    return out.reshape(tuple(a.shape[:axis]) + tuple(ii.shape) + tuple(a.shape[axis + 1:]))


@op("GatherElements")
def _gather_elems(node, a, idx):
    axis = int(node.attrs.get("axis", 0)) % a.dim()
    return torch.gather(a, axis, _wrap_negative(idx, a.shape[axis]).long())


@op("Squeeze")
def _squeeze(node, a, axes=None):
    if axes is None and "axes" in node.attrs:
        axes = node.attrs["axes"]
    if axes is None:
        return torch.squeeze(a)
    ax = [int(v) % a.dim() for v in np.asarray(_static(axes, "Squeeze axes")).reshape(-1)]
    return torch.squeeze(a, dim=tuple(ax))


@op("Unsqueeze")
def _unsqueeze(node, a, axes=None):
    if axes is None:
        axes = node.attrs["axes"]
    axv = np.asarray(_static(axes, "Unsqueeze axes")).reshape(-1)
    x = a
    for a_i in sorted(int(v) % (a.dim() + len(axv)) for v in axv):
        x = torch.unsqueeze(x, a_i)
    return x


@op("Expand")
def _expand(node, a, shape):
    tgt = [int(s) for s in np.asarray(_static(shape, "Expand shape")).reshape(-1)]
    # ONNX Expand: result dims = broadcast(x.shape, tgt) (tgt may be 1)
    nd = max(a.dim(), len(tgt))
    xs = [1] * (nd - a.dim()) + list(a.shape)
    ts = [1] * (nd - len(tgt)) + tgt
    out = [max(a_, b_) for a_, b_ in zip(xs, ts)]
    return torch.broadcast_to(a.reshape(xs), out)


@op("Tile")
def _tile(node, a, repeats):
    return torch.tile(a, [int(r) for r in np.asarray(_static(repeats, "Tile repeats"))
                          .reshape(-1)])


@op("Flatten")
def _flatten(node, a):
    axis = int(node.attrs.get("axis", 1))
    if axis < 0:  # spec: negative axis counts from the end
        axis += a.dim()
    lead = int(np.prod(tuple(a.shape[:axis]))) if axis > 0 else 1
    return a.reshape(lead, -1)


def _index_pad(x: torch.Tensor, width, mode: str) -> torch.Tensor:
    """Edge or reflect padding of any axes by index tables built on x's
    device (numpy's 'edge' and 'reflect')."""
    for ax, (lo, hi) in enumerate(width):
        if lo == 0 and hi == 0:
            continue
        n = x.shape[ax]
        idx = torch.arange(-lo, n + hi, device=x.device)
        if mode == "edge":
            idx = idx.clamp(0, n - 1)
        else:
            idx = idx.abs()
            idx = torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)
        x = torch.index_select(x, ax, idx)
    return x


@op("Pad")
def _pad(node, a, pads=None, value=None, axes=None):
    if pads is None:
        pads = node.attrs["pads"]
    p = [int(v) for v in np.asarray(_static(pads, "Pad pads")).reshape(-1)]
    if axes is not None:
        ax = [int(v) % a.dim() for v in np.asarray(_static(axes, "Pad axes")).reshape(-1)]
    else:
        ax = list(range(a.dim()))
    n = len(p) // 2
    width = [(0, 0)] * a.dim()
    for i, a_i in enumerate(ax):
        width[a_i] = (p[i], p[i + n])
    mode = node.attrs.get("mode", "constant")
    if mode == "constant":
        cv = 0 if value is None else np.asarray(_static(value, "Pad value")).item()
        return F.pad(a, _flat_pad(width), value=cv)
    return _index_pad(a, width, {"reflect": "reflect", "edge": "edge"}[mode])


@op("Constant")
def _constant(node):
    for k in ("value", "value_float", "value_int", "value_floats", "value_ints"):
        if k in node.attrs:
            return np.asarray(node.attrs[k])
    raise NotImplementedError("Constant without value")


@op("ConstantOfShape")
def _cos(node, shape):
    dims = [int(s) for s in np.asarray(_static(shape, "ConstantOfShape input")).reshape(-1)]
    v = node.attrs.get("value")
    if v is None:
        return np.zeros(dims, np.float32)
    return np.full(dims, np.asarray(v).reshape(-1)[0], np.asarray(v).dtype)


@op("Range")
def _range(node, start, limit, delta):
    s = np.asarray(_static(start, "Range start")).item()
    l = np.asarray(_static(limit, "Range limit")).item()
    d = np.asarray(_static(delta, "Range delta")).item()
    return np.arange(s, l, d)


@op("OneHot")
def _onehot(node, indices, depth, values):
    d = int(np.asarray(_static(depth, "OneHot depth")).item())
    off, on = [np.asarray(_static(values, "OneHot values")).reshape(-1)[i] for i in (0, 1)]
    axis = int(node.attrs.get("axis", -1))
    nd = indices.dim() + 1
    axis = axis % nd
    shape = [1] * nd
    shape[axis] = d
    iota = torch.arange(d, device=indices.device).reshape(shape)
    oh = (indices.unsqueeze(axis) == iota).to(torch.float32)
    return oh * float(on - off) + float(off)


@op("TopK")
def _topk(node, x, k):
    kk = int(np.asarray(_static(k, "TopK k")).item())
    axis = int(node.attrs.get("axis", -1)) % x.dim()
    largest = int(node.attrs.get("largest", 1))
    # a stable sort: ties keep the lower index first, as lax.top_k does
    vals, idx = torch.sort(x, dim=axis, descending=bool(largest), stable=True)
    return vals.narrow(axis, 0, kk), idx.narrow(axis, 0, kk).to(torch.int64)


def _arg(node, x, fn):
    axis = int(node.attrs.get("axis", 0))
    return fn(x, dim=axis, keepdim=bool(node.attrs.get("keepdims", 1))).to(torch.int64)


op("ArgMax")(lambda node, x: _arg(node, x, torch.argmax))
op("ArgMin")(lambda node, x: _arg(node, x, torch.argmin))


@op("CumSum")
def _cumsum(node, x, axis):
    ax = int(np.asarray(_static(axis, "CumSum axis")).item())
    if node.attrs.get("exclusive", 0) or node.attrs.get("reverse", 0):
        raise NotImplementedError("CumSum exclusive/reverse")
    return torch.cumsum(x, dim=ax).to(x.dtype)


# reductions -----------------------------------------------------------------

def _reduce(node, x, axes, fn):
    keep = bool(node.attrs.get("keepdims", 1))
    if axes is None and "axes" in node.attrs:
        axes = node.attrs["axes"]
    if axes is None:
        if node.attrs.get("noop_with_empty_axes", 0):
            return x
        ax = tuple(range(x.dim()))
    elif isinstance(axes, (list, tuple)):  # attr form (opset < 13 / 18)
        ax = tuple(int(v) % x.dim() for v in axes)
    else:
        ax = tuple(int(v) % x.dim()
                   for v in np.asarray(_static(axes, "Reduce axes")).reshape(-1))
    if not ax:
        return x
    return fn(x, ax, keep)


def _sum(x, ax, keep):
    return torch.sum(x, dim=ax, keepdim=keep).to(x.dtype)


op("ReduceMean")(lambda node, x, axes=None: _reduce(
    node, x, axes, lambda v, ax, k: torch.mean(_float(v), dim=ax, keepdim=k)))
op("ReduceSum")(lambda node, x, axes=None: _reduce(node, x, axes, _sum))
op("ReduceMax")(lambda node, x, axes=None: _reduce(
    node, x, axes, lambda v, ax, k: torch.amax(v, dim=ax, keepdim=k)))
op("ReduceMin")(lambda node, x, axes=None: _reduce(
    node, x, axes, lambda v, ax, k: torch.amin(v, dim=ax, keepdim=k)))


@op("ReduceProd")
def _rprod(node, x, axes=None):
    def prod(v, ax, keep):
        for a in sorted(ax, reverse=True):
            v = torch.prod(v, dim=a, keepdim=keep)
        return v.to(x.dtype)

    return _reduce(node, x, axes, prod)


op("ReduceL2")(lambda node, x, axes=None: torch.sqrt(_float(_reduce(node, x * x, axes, _sum))))
op("ReduceLogSumExp")(lambda node, x, axes=None: _reduce(
    node, x, axes, lambda v, ax, k: torch.logsumexp(_float(v), dim=ax, keepdim=k)))
op("ReduceL1")(lambda node, x, axes=None: _reduce(node, torch.abs(x), axes, _sum))
op("ReduceSumSquare")(lambda node, x, axes=None: _reduce(node, x * x, axes, _sum))
op("ReduceLogSum")(lambda node, x, axes=None: torch.log(_float(_reduce(node, x, axes, _sum))))


# nn -------------------------------------------------------------------------

op("Softmax")(lambda node, x: torch.softmax(_float(x), dim=int(node.attrs.get("axis", -1))))
op("LogSoftmax")(lambda node, x: torch.log_softmax(_float(x),
                                                   dim=int(node.attrs.get("axis", -1))))


def _mean_var(x: torch.Tensor, axes):
    """The JAX package's normalisation statistics: mean, then the mean of
    squared deviations (the biased variance)."""
    mu = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean(torch.square(torch.abs(x - mu)), dim=axes, keepdim=True)
    return mu, var


@op("LayerNormalization")
def _layernorm(node, x, scale, bias=None):
    axis = int(node.attrs.get("axis", -1))
    eps = node.attrs.get("epsilon", 1e-5)
    xx = x.to(torch.float32)
    mu, var = _mean_var(xx, tuple(range(axis % xx.dim(), xx.dim())))
    y = (xx - mu) / torch.sqrt(var + eps) * scale
    if bias is not None:
        y = y + bias
    return y


def _per_channel(v: torch.Tensor, nd: int) -> torch.Tensor:
    shape = [1] * nd
    shape[1] = -1
    return v.reshape(shape)


@op("BatchNormalization")
def _batchnorm(node, x, scale, bias, mean, var):
    eps = node.attrs.get("epsilon", 1e-5)
    nd = x.dim()
    return ((x - _per_channel(mean, nd)) / torch.sqrt(_per_channel(var, nd) + eps)
            * _per_channel(scale, nd) + _per_channel(bias, nd))


@op("InstanceNormalization")
def _instancenorm(node, x, scale, bias):
    eps = node.attrs.get("epsilon", 1e-5)
    mu, var = _mean_var(x, tuple(range(2, x.dim())))
    return ((x - mu) / torch.sqrt(var + eps) * _per_channel(scale, x.dim())
            + _per_channel(bias, x.dim()))


@op("GroupNormalization")
def _groupnorm(node, x, scale, bias):
    eps = node.attrs.get("epsilon", 1e-5)
    g = int(node.attrs["num_groups"])
    n, c = x.shape[0], x.shape[1]
    rest = tuple(x.shape[2:])
    xg = x.reshape(n, g, c // g, *rest)
    mu, var = _mean_var(xg, tuple(range(2, xg.dim())))
    y = ((xg - mu) / torch.sqrt(var + eps)).reshape(x.shape)
    shape = [1, c] + [1] * len(rest)
    return y * scale.reshape(shape) + bias.reshape(shape)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _conv_nd(x, w, strides, pads, dilations, group):
    """A convolution with explicit (begin, end) pads per spatial axis. An
    integer one runs in float64 with cuDNN off (an exact im2col product:
    every partial sum is an integer below 2^53) and returns int32."""
    if any(lo != hi for lo, hi in pads):
        x = F.pad(x, _flat_pad(pads))
        pads = [(0, 0)] * len(pads)
    conv = functools.partial(_CONV[x.dim() - 2], stride=strides,
                             padding=[lo for lo, _ in pads], dilation=dilations, groups=group)
    if not _is_int(x):
        return conv(*_promote(x, w))
    with torch.backends.cudnn.flags(enabled=False):
        return conv(x.double(), w.double()).round().to(torch.int32)


def _conv_impl(node, x, w, b):
    nsp = x.dim() - 2
    strides = [int(s) for s in node.attrs.get("strides", [1] * nsp)]
    dilations = [int(d) for d in node.attrs.get("dilations", [1] * nsp)]
    group = int(node.attrs.get("group", 1))
    kernel = [int(k) for k in node.attrs.get("kernel_shape", list(w.shape[2:]))]
    auto_pad = node.attrs.get("auto_pad", "NOTSET")
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        pads = _auto_pads(auto_pad, list(x.shape[2:]), kernel, strides, dilations)
    elif auto_pad == "VALID":
        pads = [(0, 0)] * nsp
    else:
        pads = _pairs([int(p) for p in node.attrs.get("pads", [0] * (2 * nsp))])
    out = _conv_nd(x, w, strides, pads, dilations, group)
    if b is not None:
        out = out + b.reshape((1, -1) + (1,) * nsp)
    return out


@op("Conv")
def _conv(node, x, w, b=None):
    return _conv_impl(node, x, w, b)


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


@op("ConvTranspose")
def _convtranspose(node, x, w, b=None):
    nsp = x.dim() - 2  # w: [C_in, C_out/group, *k]
    strides = [int(s) for s in node.attrs.get("strides", [1] * nsp)]
    dilations = [int(d) for d in node.attrs.get("dilations", [1] * nsp)]
    group = int(node.attrs.get("group", 1))
    if group != 1:
        raise NotImplementedError("grouped ConvTranspose")
    pads = _pairs([int(p) for p in node.attrs.get("pads", [0] * (2 * nsp))])
    out_pad = [int(p) for p in node.attrs.get("output_padding", [0] * nsp)]
    kernel = list(w.shape[2:])
    # output_shape / auto_pad (tf2onnx-style exporters): derive pads from
    # the requested output size (spec: total_padding = stride*(in-1) +
    # output_padding + ((k-1)*dil + 1) - output_shape).
    auto_pad = node.attrs.get("auto_pad", b"NOTSET")
    auto_pad = (auto_pad.decode() if isinstance(auto_pad, (bytes, bytearray))
                else str(auto_pad))
    out_shape_attr = node.attrs.get("output_shape")
    in_sp = list(x.shape[2:])
    if out_shape_attr is not None or auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        if out_shape_attr is not None:
            target = [int(v) for v in out_shape_attr]
            if len(target) == nsp + 2:  # some exporters include N, C
                target = target[2:]
        else:
            target = [in_sp[i] * strides[i] for i in range(nsp)]
        pads = []
        for i in range(nsp):
            total = max(0, strides[i] * (in_sp[i] - 1) + out_pad[i]
                        + (kernel[i] - 1) * dilations[i] + 1 - target[i])
            if auto_pad == "SAME_UPPER":
                end = total // 2
                beg = total - end
            else:
                beg = total // 2
                end = total - beg
            pads.append((beg, end))
    # the unpadded transpose, then each axis cropped by its pads and
    # extended by output_padding (positions no input reaches: zero)
    x, w = _promote(x, w)
    full = _CONV_T[nsp](x, w, stride=strides, dilation=dilations)
    full = F.pad(full, _flat_pad([(0, op_) for op_ in out_pad]))
    for i, (beg, end) in enumerate(pads):
        full = full.narrow(2 + i, beg, full.shape[2 + i] - beg - end)
    if b is not None:
        full = full + b.reshape((1, -1) + (1,) * nsp)
    return full


def _pool(node, x, avg: bool):
    nsp = x.dim() - 2
    kernel = [int(k) for k in node.attrs["kernel_shape"]]
    strides = [int(s) for s in node.attrs.get("strides", [1] * nsp)]
    auto_pad = node.attrs.get("auto_pad", "NOTSET")
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        pads = _auto_pads(auto_pad, list(x.shape[2:]), kernel, strides, [1] * nsp)
    else:
        pads = _pairs([int(p) for p in node.attrs.get("pads", [0] * (2 * nsp))])
    if node.attrs.get("ceil_mode", 0):
        new_pads = []
        for i in range(nsp):
            x_i = x.shape[2 + i] + pads[i][0] + pads[i][1]
            rem = (x_i - kernel[i]) % strides[i]
            extra = (strides[i] - rem) % strides[i] if rem else 0
            new_pads.append((pads[i][0], pads[i][1] + extra))
        pads = new_pads
    # the windows over the padded input, as lax.reduce_window takes them
    # (the pad value is the reduction's identity: -inf, or 0 for a sum)
    flat = _flat_pad(pads)
    # one more spatial axis of size 1 for the 1-D case (avg_pool1d takes no
    # divisor override)
    squeeze = nsp == 1
    if squeeze:
        x = x[..., None]
        kernel, strides, flat = kernel + [1], strides + [1], [0, 0] + flat
    nd = len(kernel)
    if avg:
        pool = {2: F.avg_pool2d, 3: F.avg_pool3d}[nd]
        total = pool(F.pad(x, flat, value=0.0), kernel, strides, divisor_override=1)
        if node.attrs.get("count_include_pad", 0):
            out = total / float(np.prod(kernel))
        else:
            ones = torch.ones_like(x)
            out = total / pool(F.pad(ones, flat, value=0.0), kernel, strides,
                               divisor_override=1)
    else:
        pool = {2: F.max_pool2d, 3: F.max_pool3d}[nd]
        out = pool(F.pad(x, flat, value=-float("inf")), kernel, strides)
    return out[..., 0] if squeeze else out


op("MaxPool")(lambda node, x: _pool(node, x, avg=False))
op("AveragePool")(lambda node, x: _pool(node, x, avg=True))
op("GlobalAveragePool")(lambda node, x: torch.mean(x, dim=tuple(range(2, x.dim())),
                                                   keepdim=True))
op("GlobalMaxPool")(lambda node, x: torch.amax(x, dim=tuple(range(2, x.dim())), keepdim=True))


# recurrent ------------------------------------------------------------------

_RNN_ACT = {"Sigmoid": torch.sigmoid, "Tanh": torch.tanh, "Relu": lambda v: torch.clamp_min(v, 0)}


def _rnn_activation(name):
    return _RNN_ACT[name if isinstance(name, str) else name.decode()]


def _full_length(node, x, seq_lens, what: str):
    """sequence_lens that cover every row's whole length are the same as
    none; anything else is refused, as the JAX package refuses it."""
    if seq_lens is None:
        return
    T_in = x.shape[1] if node.attrs.get("layout", 0) else x.shape[0]
    host = getattr(seq_lens, "_np", None)
    if host is None or not bool(np.all(np.asarray(host) == T_in)):
        raise NotImplementedError(f"{what} sequence_lens (non-full-length)")


@op("LSTM")
def _lstm(node, x, w, r, b=None, seq_lens=None, init_h=None, init_c=None, p=None):
    """ONNX LSTM: X [T, B, I] (layout 0); W [D, 4H, I]; R [D, 4H, H];
    B [D, 8H]. Gate order i, o, f, c. Returns (Y [T, D, B, H], Y_h, Y_c).
    A plain f32 loop over time."""
    _full_length(node, x, seq_lens, "LSTM")
    if p is not None:
        raise NotImplementedError("LSTM peepholes")
    if node.attrs.get("layout", 0):
        x = x.transpose(0, 1)
        # layout 1 also swaps initial states: [B, D, H] → [D, B, H]
        if init_h is not None:
            init_h = init_h.transpose(0, 1)
        if init_c is not None:
            init_c = init_c.transpose(0, 1)
    acts = node.attrs.get("activations")
    f_act, g_act, h_act = ((_rnn_activation(acts[0]), _rnn_activation(acts[1]),
                            _rnn_activation(acts[2])) if acts
                           else (torch.sigmoid, torch.tanh, torch.tanh))
    xx = x.to(torch.float32)
    T, B, _ = xx.shape
    ww, rr = w.to(torch.float32), r.to(torch.float32)
    D = ww.shape[0]
    H = rr.shape[2]
    bb = b.to(torch.float32) if b is not None else xx.new_zeros((D, 8 * H))
    h0 = init_h.to(torch.float32) if init_h is not None else xx.new_zeros((D, B, H))
    c0 = init_c.to(torch.float32) if init_c is not None else xx.new_zeros((D, B, H))
    direction = node.attrs.get("direction", "forward")

    def run_dir(d, reverse):
        xs = torch.matmul(xx, ww[d].T) + (bb[d, : 4 * H] + bb[d, 4 * H:])  # [T, B, 4H]
        h, c = h0[d], c0[d]
        ys = [None] * T
        for t in (reversed(range(T)) if reverse else range(T)):
            g = xs[t] + torch.matmul(h, rr[d].T)
            i_g = f_act(g[:, 0 * H:1 * H])
            o_g = f_act(g[:, 1 * H:2 * H])
            f_g = f_act(g[:, 2 * H:3 * H])
            c_t = g_act(g[:, 3 * H:4 * H])
            c = f_g * c + i_g * c_t
            h = o_g * h_act(c)
            ys[t] = h
        return torch.stack(ys), h, c

    if direction == "bidirectional":
        y_f, h_f, c_f = run_dir(0, False)
        y_b, h_b, c_b = run_dir(1, True)
        y = torch.stack([y_f, y_b], dim=1)  # [T, 2, B, H]
        yh = torch.stack([h_f, h_b])
        yc = torch.stack([c_f, c_b])
    else:
        ys, hf, cf = run_dir(0, direction == "reverse")
        y, yh, yc = ys[:, None], hf[None], cf[None]
    if node.attrs.get("layout", 0):
        y = y.permute(2, 0, 1, 3)
        yh, yc = yh.transpose(0, 1), yc.transpose(0, 1)
    return y, yh, yc


@op("GRU")
def _gru(node, x, w, r, b=None, seq_lens=None, init_h=None):
    """ONNX GRU: gate order z, r, h; torch exports use linear_before_reset=1."""
    _full_length(node, x, seq_lens, "GRU")
    if node.attrs.get("layout", 0):
        x = x.transpose(0, 1)
        if init_h is not None:  # layout 1 states arrive [B, D, H]
            init_h = init_h.transpose(0, 1)
    xx = x.to(torch.float32)
    T, B, _ = xx.shape
    ww, rr = w.to(torch.float32), r.to(torch.float32)
    D = ww.shape[0]
    H = rr.shape[2]
    bb = b.to(torch.float32) if b is not None else xx.new_zeros((D, 6 * H))
    h0 = init_h.to(torch.float32) if init_h is not None else xx.new_zeros((D, B, H))
    lbr = node.attrs.get("linear_before_reset", 0)
    direction = node.attrs.get("direction", "forward")

    def run_dir(d, reverse):
        xs = torch.matmul(xx, ww[d].T) + bb[d, : 3 * H]
        rb = bb[d, 3 * H:]
        h = h0[d]
        ys = [None] * T
        for t in (reversed(range(T)) if reverse else range(T)):
            xg = xs[t]
            hr = torch.matmul(h, rr[d].T)
            z = torch.sigmoid(xg[:, :H] + hr[:, :H] + rb[:H])
            r_g = torch.sigmoid(xg[:, H:2 * H] + hr[:, H:2 * H] + rb[H:2 * H])
            if lbr:
                hh = torch.tanh(xg[:, 2 * H:] + r_g * (hr[:, 2 * H:] + rb[2 * H:]))
            else:
                hh = torch.tanh(xg[:, 2 * H:] + rb[2 * H:]
                                + torch.matmul(r_g * h, rr[d, 2 * H:].T))
            h = (1 - z) * hh + z * h
            ys[t] = h
        return torch.stack(ys), h

    if direction == "bidirectional":
        y_f, h_f = run_dir(0, False)
        y_b, h_b = run_dir(1, True)
        y = torch.stack([y_f, y_b], dim=1)
        yh = torch.stack([h_f, h_b])
    else:
        ys, hf = run_dir(0, direction == "reverse")
        y, yh = ys[:, None], hf[None]
    if node.attrs.get("layout", 0):
        y = y.permute(2, 0, 1, 3)
        yh = yh.transpose(0, 1)
    return y, yh


# dynamic-shape / exporter-long-tail ops -------------------------------------
# The torch exporter's conventions: F.interpolate → Resize (nearest:
# asymmetric+floor; linear: half_pixel, or align_corners when requested);
# index_put → ScatterND; masked selects → NonZero+GatherND.


@op("NonZero")
def _nonzero(node, x):
    """Exact on static inputs ([rank, n] int64, row-major order like
    np.nonzero). A device input would need a data-dependent output shape
    (and a sync): refused loudly, as the JAX package refuses a traced one."""
    arr = _static(x, "NonZero input (output shape is data-dependent)")
    return np.stack(np.nonzero(arr)).astype(np.int64)


def _index_table(a: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if t.device == device else t.to(device, non_blocking=True)


def _resize_axis_linear(x, out_len, in_len, axis, mode):
    """Separable 1-axis linear resize with host-computed index/weight
    tables (exact per-spec coordinate transforms)."""
    scale = in_len / out_len
    i = np.arange(out_len, dtype=np.float64)
    if mode == "align_corners":
        src = i * ((in_len - 1) / max(out_len - 1, 1))
    elif mode == "asymmetric":
        src = i * scale
    else:  # half_pixel / pytorch_half_pixel (identical for out_len > 1)
        src = (i + 0.5) * scale - 0.5
        if mode == "pytorch_half_pixel" and out_len <= 1:
            src = np.zeros_like(src)
    src = np.clip(src, 0.0, in_len - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_len - 1)
    w = (src - lo).astype(np.float32)
    xl = torch.index_select(x, axis, _index_table(lo, x.device))
    xh = torch.index_select(x, axis, _index_table(hi, x.device))
    shape = [1] * xl.dim()
    shape[axis] = out_len
    w = _index_table(w, x.device).reshape(shape)
    return xl * (1.0 - w) + xh * w


def _resize_axis_nearest(x, out_len, in_len, axis, coord_mode, nearest_mode):
    scale = in_len / out_len
    i = np.arange(out_len, dtype=np.float64)
    if coord_mode == "align_corners":
        src = i * ((in_len - 1) / max(out_len - 1, 1))
    elif coord_mode == "asymmetric":
        src = i * scale
    else:
        src = (i + 0.5) * scale - 0.5
    if nearest_mode == "floor":
        idx = np.floor(src)
    elif nearest_mode == "ceil":
        idx = np.ceil(src)
    elif nearest_mode == "round_prefer_ceil":
        idx = np.floor(src + 0.5)
    else:  # round_prefer_floor (default)
        idx = np.ceil(src - 0.5)
    idx = np.clip(idx, 0, in_len - 1).astype(np.int64)
    return torch.index_select(x, axis, _index_table(idx, x.device))


@op("Resize")
def _resize(node, x, roi=None, scales=None, sizes=None):
    """ONNX Resize, the subset real exporters emit. Output dims must be
    static (scales or sizes as initializers, which is how exporters emit
    them)."""
    in_shape = list(x.shape)
    if sizes is not None and sizes.numel():
        out_shape = [int(v) for v in np.asarray(_static(sizes, "Resize sizes")).reshape(-1)]
    elif scales is not None and scales.numel():
        sc = np.asarray(_static(scales, "Resize scales")).reshape(-1).astype(np.float64)
        out_shape = [int(np.floor(d * s)) for d, s in zip(in_shape, sc)]
    else:
        raise NotImplementedError("Resize without scales or sizes")
    mode = node.attrs.get("mode", "nearest")
    coord = node.attrs.get("coordinate_transformation_mode", "half_pixel")
    nearest_mode = node.attrs.get("nearest_mode", "round_prefer_floor")
    if coord not in ("half_pixel", "pytorch_half_pixel", "asymmetric", "align_corners"):
        raise NotImplementedError(f"Resize coordinate mode {coord!r}")
    if mode not in ("nearest", "linear", "cubic"):
        raise NotImplementedError(f"Resize mode {mode!r}")
    if mode == "cubic":
        raise NotImplementedError("Resize mode 'cubic'")
    for axis, (din, dout) in enumerate(zip(in_shape, out_shape)):
        if din == dout:
            continue
        if mode == "nearest":
            x = _resize_axis_nearest(x, dout, din, axis, coord, nearest_mode)
        else:
            x = _resize_axis_linear(x, dout, din, axis, coord)
    return x


@op("ScatterND")
def _scatternd(node, data, indices, updates):
    """data with its rows at the index tuples set (or reduced) from updates:
    the index tuples become linear row indices of data flattened over the
    indexed axes."""
    idx = indices.long()
    k = idx.shape[-1]
    lead = tuple(data.shape[:k])
    strides = np.cumprod((lead[1:] + (1,))[::-1])[::-1].tolist()
    lin = sum(_wrap_negative(idx[..., i], lead[i]) * int(strides[i])
              for i in range(k)).reshape(-1)
    rows = data.reshape((-1,) + tuple(data.shape[k:])).clone()
    upd = updates.reshape((lin.shape[0],) + tuple(data.shape[k:])).to(data.dtype)
    reduction = node.attrs.get("reduction", "none")
    if reduction == "add":
        rows.index_add_(0, lin, upd)
    elif reduction in ("mul", "max", "min"):
        rows.index_reduce_(0, lin, upd, {"mul": "prod", "max": "amax", "min": "amin"}[reduction])
    else:
        rows.index_copy_(0, lin, upd)
    return rows.reshape(data.shape)


@op("ScatterElements", "Scatter")
def _scatter_elements(node, data, indices, updates):
    axis = int(node.attrs.get("axis", 0)) % data.dim()
    idx = _wrap_negative(indices, data.shape[axis]).long()
    upd = updates.to(data.dtype)
    reduction = node.attrs.get("reduction", "none")
    if reduction == "add":
        return torch.scatter_add(data, axis, idx, upd)
    if reduction == "mul":
        return torch.scatter_reduce(data, axis, idx, upd, "prod")
    return torch.scatter(data, axis, idx, upd)


@op("LpNormalization")
def _lpnorm(node, x):
    axis = int(node.attrs.get("axis", -1))
    if int(node.attrs.get("p", 2)) == 1:
        n = torch.sum(torch.abs(x), dim=axis, keepdim=True)
    else:
        n = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True))
    return x / torch.clamp_min(n, 1e-12)


op("Softsign")(lambda node, x: x / (1.0 + torch.abs(x)))
# x * tanh(softplus(x))
op("Mish")(lambda node, x: x * torch.tanh(_softplus(node, x)))


@op("Celu")
def _celu(node, x):
    a = float(node.attrs.get("alpha", 1.0))
    return torch.clamp_min(x, 0.0) + torch.clamp_max(a * (torch.exp(x / a) - 1.0), 0.0)


@op("ThresholdedRelu")
def _thresholded_relu(node, x):
    a = float(node.attrs.get("alpha", 1.0))
    return torch.where(x > a, x, torch.zeros((), dtype=x.dtype, device=x.device))


@op("Shrink")
def _shrink(node, x):
    lambd = float(node.attrs.get("lambd", 0.5))
    bias = float(node.attrs.get("bias", 0.0))
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(x < -lambd, x + bias, torch.where(x > lambd, x - bias, zero))


@op("IsInf")
def _isinf(node, x):
    out = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    if bool(node.attrs.get("detect_positive", 1)):
        out = out | (x == float("inf"))
    if bool(node.attrs.get("detect_negative", 1)):
        out = out | (x == -float("inf"))
    return out


@op("EyeLike")
def _eyelike(node, x):
    k = int(node.attrs.get("k", 0))
    dt = node.attrs.get("dtype")
    host = getattr(x, "_np", None)
    dtype = (_DTYPES[dt] if dt is not None
             else (host.dtype if host is not None else np.dtype(np.float32)))
    return np.eye(x.shape[0], x.shape[1], k=k, dtype=dtype)


@op("HardMax")
def _hardmax(node, x):
    axis = int(node.attrs.get("axis", -1)) % x.dim()
    am = torch.argmax(x, dim=axis, keepdim=True)
    iota = torch.arange(x.shape[axis], device=x.device).reshape(
        [-1 if d == axis else 1 for d in range(x.dim())])
    return (iota == am).to(x.dtype)


@op("DepthToSpace")
def _depth_to_space(node, x):
    b = int(node.attrs["blocksize"])
    N, C, H, W = x.shape
    if node.attrs.get("mode", "DCR") == "CRD":
        y = x.reshape(N, C // (b * b), b, b, H, W).permute(0, 1, 4, 2, 5, 3)
    else:  # DCR
        y = x.reshape(N, b, b, C // (b * b), H, W).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(N, C // (b * b), H * b, W * b)


@op("SpaceToDepth")
def _space_to_depth(node, x):
    b = int(node.attrs["blocksize"])
    N, C, H, W = x.shape
    y = x.reshape(N, C, H // b, b, W // b, b).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(N, C * b * b, H // b, W // b)
