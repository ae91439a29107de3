"""Minimal ONNX weight extraction (no onnx/protobuf dependency).

The port's copy of ``crispy_tpu/models/onnx_import.py``. Its protobuf
field reader (``_read_varint``, ``_fields``) also serves ``models/spm.py``.

The reference's model bundles ship ONNX graphs (transcribe-rs/ort engines,
pyannote segmentation-3.0, WeSpeaker CAM++ — managers/model.rs catalog);
the port consumes only their *weights*, re-running the math in PyTorch.
This module walks the protobuf wire format directly and returns the graph
initializers as numpy arrays keyed by tensor name.

Wire-format subset: ModelProto.graph = field 7; GraphProto.initializer =
field 5 (TensorProto); TensorProto: dims=1 (repeated varint), data_type=2,
float_data=4 (packed), int32_data=5, int64_data=7, name=8, raw_data=9,
double_data=10. Covers f32/f16/f64/i8/i32/i64 tensors (the formats the
catalog's int8/fp32 bundles use).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# ONNX TensorProto.DataType → numpy dtype
_DTYPES = {
    1: np.dtype("<f4"),  # FLOAT
    2: np.dtype("u1"),  # UINT8
    3: np.dtype("i1"),  # INT8
    4: np.dtype("<u2"),  # UINT16
    5: np.dtype("<i2"),  # INT16
    6: np.dtype("<i4"),  # INT32
    7: np.dtype("<i8"),  # INT64
    9: np.dtype("?"),  # BOOL
    10: np.dtype("<f2"),  # FLOAT16
    11: np.dtype("<f8"),  # DOUBLE
}


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _fields(buf: memoryview) -> Iterator[Tuple[int, int, object]]:
    """Iterate (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = bytes(buf[pos: pos + 8])
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos: pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = bytes(buf[pos: pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: memoryview) -> Tuple[Optional[str], Optional[np.ndarray]]:
    dims: List[int] = []
    dtype_code = 1
    name = None
    raw = None
    f32s: List[bytes] = []
    i32s: List[int] = []
    i64s: List[int] = []
    f64s: List[bytes] = []
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 0:
            dims.append(val)
        elif field == 1 and wire == 2:  # packed dims
            pos = 0
            while pos < len(val):
                d, pos = _read_varint(val, pos)
                dims.append(d)
        elif field == 2 and wire == 0:
            dtype_code = val
        elif field == 4:  # float_data
            if wire == 2:
                f32s.append(bytes(val))
            else:
                f32s.append(val)  # single fixed32
        elif field == 5 and wire == 2:
            pos = 0
            while pos < len(val):
                v, pos = _read_varint(val, pos)
                i32s.append(v)
        elif field == 5 and wire == 0:
            i32s.append(val)
        elif field == 7 and wire == 2:
            pos = 0
            while pos < len(val):
                v, pos = _read_varint(val, pos)
                i64s.append(v)
        elif field == 7 and wire == 0:
            i64s.append(val)
        elif field == 8 and wire == 2:
            name = bytes(val).decode("utf-8", errors="replace")
        elif field == 9 and wire == 2:
            raw = bytes(val)
        elif field == 10 and wire == 2:
            f64s.append(bytes(val))
    dt = _DTYPES.get(dtype_code)
    if dt is None:
        return name, None
    if raw is not None:
        arr = np.frombuffer(raw, dt)
    elif f32s:
        arr = np.frombuffer(b"".join(f32s), "<f4")
    elif f64s:
        arr = np.frombuffer(b"".join(f64s), "<f8")
    elif i64s:
        arr = np.array(i64s, np.int64)
        # protobuf varints are 2's-complement encoded in 64 bits
        arr = arr.astype(np.uint64).astype(np.int64)
    elif i32s:
        arr = np.array(i32s, np.uint32).astype(np.int32)
    else:
        arr = np.zeros(0, dt)
    try:
        # dims == [] means a scalar tensor (0-d), not "unknown shape"
        arr = arr.reshape(dims)
    except ValueError:
        return name, None
    return name, arr


def load_onnx_weights(path) -> Dict[str, np.ndarray]:
    """Extract {initializer_name: array} from an .onnx file."""
    data = memoryview(Path(path).read_bytes())
    out: Dict[str, np.ndarray] = {}
    for field, wire, val in _fields(data):
        if field == 7 and wire == 2:  # ModelProto.graph
            for gfield, gwire, gval in _fields(val):
                if gfield == 5 and gwire == 2:  # GraphProto.initializer
                    name, arr = _parse_tensor(gval)
                    if name is not None and arr is not None:
                        out[name] = arr
    return out
