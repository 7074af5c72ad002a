"""Minimal ONNX ModelProto serializer in the protobuf wire format, with no
``onnx`` package (the port's copy of ``adas_tpu/tools/onnx_writer.py``).

Enough of the schema to write a model file whose graph holds nodes,
inputs, outputs and initializer tensors: the tests and ``chip_smoke.py``
write ``.onnx`` files of initializers with it (``onnx_import`` reads them
back), and it is the serializer an ONNX exporter of the port builds on.

Attribute values are encoded by python type: float -> f, int -> i,
str -> s, np.ndarray -> t, [float] -> floats, [int] -> ints,
[str] -> strings.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# numpy dtype -> TensorProto.DataType
NP_TO_ONNX = {
    np.dtype(np.float32): 1,
    np.dtype(np.uint8): 2,
    np.dtype(np.int8): 3,
    np.dtype(np.uint16): 4,
    np.dtype(np.int16): 5,
    np.dtype(np.int32): 6,
    np.dtype(np.int64): 7,
    np.dtype(np.bool_): 9,
    np.dtype(np.float16): 10,
    np.dtype(np.float64): 11,
    np.dtype(np.uint32): 12,
    np.dtype(np.uint64): 13,
}


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _int_field(field: int, v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    return _tag(field, 0) + _varint(v)


def _str_field(field: int, s: str) -> bytes:
    return _len_field(field, s.encode("utf-8"))


def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    dt = NP_TO_ONNX.get(arr.dtype)
    if dt is None:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    out = b""
    for d in arr.shape:
        out += _int_field(1, int(d))
    out += _int_field(2, dt)
    out += _str_field(8, name)
    le = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
    out += _len_field(9, le.tobytes())  # raw_data
    return out


def _attribute(name: str, value) -> bytes:
    out = _str_field(1, name)
    if isinstance(value, bool):
        out += _int_field(3, int(value)) + _int_field(20, 2)
    elif isinstance(value, (int, np.integer)):
        out += _int_field(3, int(value)) + _int_field(20, 2)
    elif isinstance(value, (float, np.floating)):
        out += _tag(2, 5) + struct.pack("<f", float(value))
        out += _int_field(20, 1)
    elif isinstance(value, str):
        out += _len_field(4, value.encode("utf-8")) + _int_field(20, 3)
    elif isinstance(value, np.ndarray):
        out += _len_field(5, tensor_proto("", value)) + _int_field(20, 4)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            for v in value:
                out += _int_field(8, int(v))
            out += _int_field(20, 7)
        elif all(isinstance(v, (float, np.floating)) for v in value):
            for v in value:
                out += _tag(7, 5) + struct.pack("<f", float(v))
            out += _int_field(20, 6)
        elif all(isinstance(v, str) for v in value):
            for v in value:
                out += _len_field(9, v.encode("utf-8"))
            out += _int_field(20, 8)
        else:
            raise ValueError(f"mixed attribute list for {name}")
    else:
        raise ValueError(f"unsupported attribute type for {name}: {value!r}")
    return out


def make_node(
    op_type: str,
    inputs: Sequence[str],
    outputs: Sequence[str],
    name: str = "",
    **attrs,
) -> bytes:
    out = b""
    for i in inputs:
        out += _str_field(1, i)
    for o in outputs:
        out += _str_field(2, o)
    if name:
        out += _str_field(3, name)
    out += _str_field(4, op_type)
    for k, v in attrs.items():
        if v is not None:
            out += _len_field(5, _attribute(k, v))
    return out


def value_info(
    name: str,
    dtype: Union[np.dtype, type] = np.float32,
    shape: Optional[Sequence[Optional[int]]] = None,
) -> bytes:
    elem = NP_TO_ONNX[np.dtype(dtype)]
    tensor = _int_field(1, elem)
    if shape is not None:
        dims = b""
        for d in shape:
            dims += _len_field(1, b"" if d is None else _int_field(1, int(d)))
        tensor += _len_field(2, dims)
    return _str_field(1, name) + _len_field(2, _len_field(1, tensor))


def make_graph(
    nodes: Sequence[bytes],
    name: str,
    inputs: Sequence[bytes],
    outputs: Sequence[bytes],
    initializers: Optional[Dict[str, np.ndarray]] = None,
) -> bytes:
    # one join: a graph of large initializers is built in linear time
    parts = [_len_field(1, n) for n in nodes]
    parts.append(_str_field(2, name))
    parts += [_len_field(5, tensor_proto(iname, arr))
              for iname, arr in (initializers or {}).items()]
    parts += [_len_field(11, i) for i in inputs]
    parts += [_len_field(12, o) for o in outputs]
    return b"".join(parts)


def make_model(graph: bytes, opset: int = 13, ir_version: int = 8) -> bytes:
    opset_id = _str_field(1, "") + _int_field(2, opset)
    return (
        _int_field(1, ir_version)
        + _str_field(2, "adas_tpu_torch")
        + _len_field(7, graph)
        + _len_field(8, opset_id)
    )


def save_model(path: str, model_bytes: bytes) -> None:
    with open(path, "wb") as f:
        f.write(model_bytes)


def simple_model(
    nodes: Sequence[bytes],
    inputs: Sequence[Tuple[str, object, Sequence[int]]],
    outputs: Sequence[Tuple[str, object, Optional[Sequence[int]]]],
    initializers: Optional[Dict[str, np.ndarray]] = None,
    opset: int = 13,
    name: str = "g",
) -> bytes:
    """One call for a small model: (name, dtype, shape) tuples for I/O."""
    return make_model(
        make_graph(
            nodes,
            name,
            [value_info(*i) for i in inputs],
            [value_info(*o) for o in outputs],
            initializers,
        ),
        opset=opset,
    )
