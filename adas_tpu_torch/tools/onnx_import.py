"""ONNX weight ingestion without the ``onnx`` package (the port's copy of
``adas_tpu/tools/onnx_import.py``): a minimal protobuf wire-format reader
of a ModelProto's graph initializers.

Only the fields needed to recover the initializer tensors are read
(GraphProto.initializer; TensorProto name, dims, data_type, raw or typed
data).  Field numbers per the public onnx.proto3 schema:
  ModelProto.graph = 7; GraphProto.initializer = 5;
  TensorProto: dims=1, data_type=2, float_data=4, int32_data=5,
  string_data=6, int64_data=7, name=8, raw_data=9, double_data=10.

ultralytics and UFLD exports keep the torch parameter names
(``model.0.conv.weight``), so the importers of ``torch_import`` and
``yolo_import`` take the initializers as they come.  The graph itself
(its nodes) is not read here.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

# TensorProto.DataType -> numpy dtype
_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a message buffer (a
    ``memoryview``: the values are views, no tensor's bytes are copied)."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            value, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            value = buf[pos: pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            value = buf[pos: pos + length]
            pos += length
        elif wire == 5:  # 32-bit
            value = buf[pos: pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _parse_packed_varints(buf: bytes) -> List[int]:
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out


def _signed(v: int, bits: int = 64) -> int:
    # onnx dims and typed ints are plain (non-zigzag) varints; negative
    # values arrive as 2^64 complements
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    data_type = 1
    name = ""
    raw = b""
    float_data: List[float] = []
    int32_data: List[int] = []
    int64_data: List[int] = []
    double_data: List[float] = []
    for field, wire, value in _fields(buf):
        if field == 1:  # dims
            if wire == 0:
                dims.append(_signed(value))
            else:  # packed
                dims.extend(_signed(v) for v in _parse_packed_varints(value))
        elif field == 2 and wire == 0:
            data_type = value
        elif field == 4:  # float_data
            if wire == 5:
                float_data.append(np.frombuffer(value, "<f4")[0])
            else:
                float_data.extend(np.frombuffer(value, "<f4").tolist())
        elif field == 5:  # int32_data
            if wire == 0:
                int32_data.append(_signed(value, 32))
            else:
                int32_data.extend(_signed(v, 32) for v in _parse_packed_varints(value))
        elif field == 7:  # int64_data
            if wire == 0:
                int64_data.append(_signed(value))
            else:
                int64_data.extend(_signed(v) for v in _parse_packed_varints(value))
        elif field == 8 and wire == 2:
            name = bytes(value).decode("utf-8")
        elif field == 9 and wire == 2:
            raw = value
        elif field == 10:  # double_data
            if wire == 1:
                double_data.append(np.frombuffer(value, "<f8")[0])
            else:
                double_data.extend(np.frombuffer(value, "<f8").tolist())

    if data_type == 16:  # bfloat16: the upper halves of f32, in int32_data or raw
        if raw:
            bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        else:
            bits = (np.asarray(int32_data, np.uint32) & 0xFFFF) << 16
        arr = np.frombuffer(bits.astype("<u4").tobytes(), "<f4")
    else:
        dtype = _DTYPES.get(data_type)
        if dtype is None:
            raise ValueError(f"unsupported TensorProto data_type {data_type}")
        if raw:
            # a copy: the array owns its data, not the file's buffer
            arr = np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder("<")).copy()
        elif float_data:
            arr = np.asarray(float_data, dtype=np.float32).astype(dtype)
        elif double_data:
            arr = np.asarray(double_data, dtype=np.float64).astype(dtype)
        elif int64_data:
            arr = np.asarray(int64_data, dtype=np.int64).astype(dtype)
        elif int32_data:
            arr = np.asarray(int32_data, dtype=np.int64).astype(dtype)
        else:
            arr = np.zeros(0, dtype=dtype)
    # an absent dims field is a 0-d (scalar) tensor: reshape(()) applies
    return name, arr.reshape(dims)


def read_onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    """Every graph initializer of an ``.onnx`` file: {name: ndarray}."""
    with open(path, "rb") as f:
        model = memoryview(f.read())
    graph = None
    for field, wire, value in _fields(model):
        if field == 7 and wire == 2:  # ModelProto.graph
            graph = value
            break
    if graph is None:
        raise ValueError(f"{path}: no GraphProto found")
    out: Dict[str, np.ndarray] = {}
    for field, wire, value in _fields(graph):
        if field == 5 and wire == 2:  # GraphProto.initializer
            name, arr = _parse_tensor(value)
            out[name] = arr
    return out
