"""Full ONNX graph parsing (nodes, attributes, I/O, opset), no onnx package
(the port's copy of ``adas_tpu/tools/onnx_graph.py``).

Extends the initializer reader (``onnx_import.py``) to the whole
``ModelProto`` the graph executor (``engine/onnx_engine.py``) needs.
Field numbers per the public onnx.proto3 schema:
  ModelProto: ir_version=1, graph=7, opset_import=8
  OperatorSetIdProto: domain=1, version=2
  GraphProto: node=1, name=2, initializer=5, input=11, output=12
  NodeProto: input=1, output=2, name=3, op_type=4, attribute=5, domain=7
  AttributeProto: name=1, f=2, i=3, s=4, t=5, g=6, floats=7, ints=8,
                  strings=9, type=20
  ValueInfoProto: name=1, type=2
  TypeProto: tensor_type=1;  Tensor: elem_type=1, shape=2
  TensorShapeProto: dim=1;  Dimension: dim_value=1, dim_param=2
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .onnx_import import _DTYPES, _fields, _parse_packed_varints, _parse_tensor, _signed


@dataclass
class OnnxNode:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, object]
    name: str = ""


@dataclass
class OnnxValueInfo:
    name: str
    elem_type: int = 1  # TensorProto.DataType; 1 = float32
    #: dims; None entries are symbolic (dim_param / absent)
    shape: Optional[List[Optional[int]]] = None

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(_DTYPES.get(self.elem_type, np.float32))


@dataclass
class OnnxGraph:
    nodes: List[OnnxNode] = field(default_factory=list)
    initializers: Dict[str, np.ndarray] = field(default_factory=dict)
    inputs: List[OnnxValueInfo] = field(default_factory=list)
    outputs: List[OnnxValueInfo] = field(default_factory=list)
    name: str = ""

    @property
    def data_inputs(self) -> List[OnnxValueInfo]:
        """Graph inputs fed at run time (not initializers: exporters before
        IR 4 list the weights as inputs too)."""
        return [v for v in self.inputs if v.name not in self.initializers]


@dataclass
class OnnxModel:
    graph: OnnxGraph
    opset: int = 13  # default-domain opset version
    ir_version: int = 8


def _text(value) -> str:
    return bytes(value).decode("utf-8")


def _parse_attribute(buf) -> Tuple[str, object]:
    name, atype = "", 0
    f_val = i_val = s_val = t_val = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for fnum, wire, value in _fields(buf):
        if fnum == 1 and wire == 2:
            name = _text(value)
        elif fnum == 20 and wire == 0:
            atype = value
        elif fnum == 2 and wire == 5:
            f_val = float(np.frombuffer(value, "<f4")[0])
        elif fnum == 3 and wire == 0:
            i_val = _signed(value)
        elif fnum == 4 and wire == 2:
            s_val = bytes(value)
        elif fnum == 5 and wire == 2:
            t_val = _parse_tensor(value)[1]
        elif fnum == 7:
            if wire == 5:
                floats.append(float(np.frombuffer(value, "<f4")[0]))
            else:
                floats.extend(np.frombuffer(value, "<f4").tolist())
        elif fnum == 8:
            if wire == 0:
                ints.append(_signed(value))
            else:
                ints.extend(_signed(v) for v in _parse_packed_varints(value))
        elif fnum == 9 and wire == 2:
            strings.append(bytes(value))
        # fnum 6 (a subgraph) is not read: If/Loop bodies fail at execution
    # AttributeProto.type disambiguates empty lists; else by presence
    if atype == 1 or (atype == 0 and f_val is not None):
        return name, f_val
    if atype == 2 or (atype == 0 and i_val is not None):
        return name, i_val
    if atype == 3 or (atype == 0 and s_val is not None):
        return name, (s_val or b"").decode("utf-8", "replace")
    if atype == 4 or (atype == 0 and t_val is not None):
        return name, t_val
    if atype == 6 or floats:
        return name, list(floats)
    if atype == 7 or ints:
        return name, list(ints)
    if atype == 8 or strings:
        return name, [s.decode("utf-8", "replace") for s in strings]
    return name, None


def _parse_node(buf) -> OnnxNode:
    inputs: List[str] = []
    outputs: List[str] = []
    op_type = name = ""
    attrs: Dict[str, object] = {}
    for fnum, wire, value in _fields(buf):
        if fnum == 1 and wire == 2:
            inputs.append(_text(value))
        elif fnum == 2 and wire == 2:
            outputs.append(_text(value))
        elif fnum == 3 and wire == 2:
            name = _text(value)
        elif fnum == 4 and wire == 2:
            op_type = _text(value)
        elif fnum == 5 and wire == 2:
            k, v = _parse_attribute(value)
            attrs[k] = v
    return OnnxNode(op_type, inputs, outputs, attrs, name)


def _parse_value_info(buf) -> OnnxValueInfo:
    name, elem_type = "", 1
    shape: Optional[List[Optional[int]]] = None
    for fnum, wire, value in _fields(buf):
        if fnum == 1 and wire == 2:
            name = _text(value)
        elif fnum == 2 and wire == 2:  # TypeProto
            for f2, w2, v2 in _fields(value):
                if f2 == 1 and w2 == 2:  # tensor_type
                    for f3, w3, v3 in _fields(v2):
                        if f3 == 1 and w3 == 0:
                            elem_type = v3
                        elif f3 == 2 and w3 == 2:  # TensorShapeProto
                            shape = []
                            for f4, w4, v4 in _fields(v3):
                                if f4 == 1 and w4 == 2:  # Dimension
                                    dim: Optional[int] = None
                                    for f5, w5, v5 in _fields(v4):
                                        if f5 == 1 and w5 == 0:
                                            dim = _signed(v5)
                                    shape.append(dim)
    return OnnxValueInfo(name, elem_type, shape)


def _parse_graph(buf) -> OnnxGraph:
    g = OnnxGraph()
    for fnum, wire, value in _fields(buf):
        if fnum == 1 and wire == 2:
            g.nodes.append(_parse_node(value))
        elif fnum == 2 and wire == 2:
            g.name = _text(value)
        elif fnum == 5 and wire == 2:
            name, arr = _parse_tensor(value)
            g.initializers[name] = arr
        elif fnum == 11 and wire == 2:
            g.inputs.append(_parse_value_info(value))
        elif fnum == 12 and wire == 2:
            g.outputs.append(_parse_value_info(value))
    return g


def parse_onnx(path_or_bytes) -> OnnxModel:
    """Parse a ``.onnx`` file (or its bytes) into an :class:`OnnxModel`."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = memoryview(bytes(path_or_bytes))
    else:
        with open(path_or_bytes, "rb") as f:
            buf = memoryview(f.read())
    graph, opset, ir_version = None, 13, 8
    for fnum, wire, value in _fields(buf):
        if fnum == 1 and wire == 0:
            ir_version = value
        elif fnum == 7 and wire == 2:
            graph = _parse_graph(value)
        elif fnum == 8 and wire == 2:  # OperatorSetIdProto
            domain, version = "", None
            for f2, w2, v2 in _fields(value):
                if f2 == 1 and w2 == 2:
                    domain = _text(v2)
                elif f2 == 2 and w2 == 0:
                    version = v2
            if domain in ("", "ai.onnx") and version is not None:
                opset = version
    if graph is None:
        raise ValueError("no GraphProto found in model")
    return OnnxModel(graph=graph, opset=opset, ir_version=ir_version)


def toposort(graph: OnnxGraph) -> List[OnnxNode]:
    """Nodes in an order where each runs after its inputs' producers (the
    spec requires sorted graphs; some exporters break it)."""
    produced = set(graph.initializers)
    produced.update(v.name for v in graph.inputs)
    produced.add("")  # optional (absent) inputs
    remaining = list(graph.nodes)
    ordered: List[OnnxNode] = []
    while remaining:
        deferred = []
        for node in remaining:
            if all(i in produced for i in node.inputs):
                ordered.append(node)
                produced.update(node.outputs)
            else:
                deferred.append(node)
        if len(deferred) == len(remaining):
            missing = {i for node in deferred for i in node.inputs if i not in produced}
            raise ValueError(
                f"graph has unresolvable inputs (cycle or dangling): {sorted(missing)[:5]}"
            )
        remaining = deferred
    return ordered
