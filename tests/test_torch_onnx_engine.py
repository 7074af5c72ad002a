"""The port's ONNX graph executor (``adas_tpu_torch/engine/onnx_engine.py``)
and graph parser (``tools/onnx_graph.py``) against the JAX package's.

Every test of ``tests/test_onnx_executor.py`` runs again with its fixture
graphs written by the port's ``tools/onnx_writer`` and each engine it
builds replaced by a pair: JAX's ``OnnxGraphEngine`` and the port's (on
the CPU), both on the same bytes.  Each inference runs both and holds
them together (floating outputs within 1e-5, integer and boolean outputs,
``NonMaxSuppression``'s and ``NonZero``'s among them, exactly) and hands
the port's outputs to the test's own checks against its torch oracles; a
graph JAX's engine refuses, the port's refuses with the same exception
type.  Each pair also checks that both parsers read the same nodes,
attributes, initializers and I/O.
"""
import inspect

import numpy as np
import pytest
import torch

import test_onnx_executor as X
from adas_tpu.engine.onnx_engine import _OPS as JAX_OPS
from adas_tpu.engine.onnx_engine import OnnxGraphEngine as JaxEngine
from adas_tpu.tools.onnx_graph import parse_onnx as jax_parse
from adas_tpu_torch.engine.onnx_engine import _OPS, DYNAMIC_OPS, OnnxGraphEngine
from adas_tpu_torch.tools import onnx_writer as W
from adas_tpu_torch.tools.onnx_graph import parse_onnx, toposort


class _Bytes:
    """A model's bytes with the port's parse of them (what the JAX tests
    read from ``parse_onnx``)."""

    def __init__(self, raw: bytes):
        self.raw = bytes(raw)
        parsed = parse_onnx(self.raw)
        self.graph, self.opset, self.ir_version = parsed.graph, parsed.opset, parsed.ir_version


def _same_attr(a, b):
    if isinstance(b, np.ndarray):
        return isinstance(a, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(b, float):
        return a == pytest.approx(b, rel=0, abs=0)
    return a == b


def assert_same_parse(raw: bytes):
    """Both parsers read the same model."""
    want, got = jax_parse(raw), parse_onnx(raw)
    assert (got.opset, got.ir_version) == (want.opset, want.ir_version)
    gw, gg = want.graph, got.graph
    assert gg.name == gw.name
    assert [(n.op_type, n.inputs, n.outputs, n.name) for n in gg.nodes] == \
        [(n.op_type, n.inputs, n.outputs, n.name) for n in gw.nodes]
    for ng, nw in zip(gg.nodes, gw.nodes):
        assert sorted(ng.attrs) == sorted(nw.attrs)
        assert all(_same_attr(ng.attrs[k], nw.attrs[k]) for k in nw.attrs), ng.op_type
    assert sorted(gg.initializers) == sorted(gw.initializers)
    for k, v in gw.initializers.items():
        assert gg.initializers[k].dtype == v.dtype and gg.initializers[k].shape == v.shape
        assert np.array_equal(gg.initializers[k], v)
    for vg, vw in zip(gg.inputs + gg.outputs, gw.inputs + gw.outputs):
        assert (vg.name, vg.elem_type, vg.shape) == (vw.name, vw.elem_type, vw.shape)
    assert len(gg.inputs) == len(gw.inputs) and len(gg.outputs) == len(gw.outputs)
    assert [n.name for n in toposort(gg)] == [n.name for n in X.toposort(gw)]


def assert_outputs_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=0,
                                       atol=1e-5)
        else:
            np.testing.assert_array_equal(g, w)


class PairedEngine:
    """JAX's and the port's executor on one model; answers as the port's."""

    def __init__(self, model, batch_size: int = 1):
        raw = model.raw
        assert_same_parse(raw)
        try:
            self.jax = JaxEngine(jax_parse(raw), batch_size)
        except Exception as err:
            with pytest.raises(type(err)):
                OnnxGraphEngine(parse_onnx(raw), batch_size, device="cpu")
            raise
        self.port = OnnxGraphEngine(parse_onnx(raw), batch_size, device="cpu")
        self._params = self.port._params
        self._static_inits = self.port._static_inits
        self._tail, self._bridge = self.port._tail, self.port._bridge
        assert [n.op_type for n in self._tail] == [n.op_type for n in self.jax._tail]
        assert self._bridge == self.jax._bridge
        assert sorted(self._params) == sorted(self.jax._params)
        assert sorted(self._static_inits) == sorted(self.jax._static_inits)
        assert self.port.engine_dtype == self.jax.engine_dtype
        assert tuple(self.port.get_engine_input_shape()) == \
            tuple(self.jax.get_engine_input_shape())

    @property
    def engine_dtype(self):
        return self.port.engine_dtype

    def get_engine_input_shape(self):
        return self.port.get_engine_input_shape()

    def get_engine_output_shape(self):
        shapes, names = self.port.get_engine_output_shape()
        want_shapes, want_names = self.jax.get_engine_output_shape()
        assert names == want_names
        assert [tuple(s) for s in shapes] == [tuple(s) for s in want_shapes]
        return shapes, names

    def engine_inference(self, x):
        got = self.port.engine_inference(x)
        assert_outputs_close(got, self.jax.engine_inference(x))
        return got


@pytest.fixture
def paired(monkeypatch):
    """The JAX executor tests' module, its fixtures written by the port's
    writer and each engine a :class:`PairedEngine`."""
    monkeypatch.setattr(X, "W", W)
    monkeypatch.setattr(X, "parse_onnx", _Bytes)
    monkeypatch.setattr(X, "OnnxGraphEngine", PairedEngine)
    return X


def _jax_tests():
    cases = []
    for name, obj in inspect.getmembers(X):
        if inspect.isclass(obj) and name.startswith("Test"):
            cases += [pytest.param(obj, m, id=f"{name}.{m}") for m in dir(obj)
                      if m.startswith("test_")]
    return cases


@pytest.mark.parametrize("cls, method", _jax_tests())
def test_executor_fixture_matches_jax(paired, cls, method):
    fn = getattr(cls(), method)
    kwargs = {}
    if "rng" in inspect.signature(fn).parameters:
        kwargs["rng"] = np.random.default_rng(0)
    fn(**kwargs)


def test_op_table_is_jax():
    """One entry per ONNX op of JAX's table, and the same host tail."""
    from adas_tpu.engine.onnx_engine import DYNAMIC_OPS as JAX_DYNAMIC

    assert sorted(_OPS) == sorted(JAX_OPS)
    assert DYNAMIC_OPS == JAX_DYNAMIC


def test_device_prefix_and_host_tail():
    """The prefix values are torch tensors on the engine's device and the
    static shape chain numpy; a graph with a host tail refuses
    ``run_device``, one without serves device tensors."""
    nodes = [W.make_node("Shape", ["x"], ["s"]),
             W.make_node("Reshape", ["x", "s"], ["y0"]),
             W.make_node("Relu", ["y0"], ["y"])]
    eng = OnnxGraphEngine(parse_onnx(W.simple_model(
        nodes, [("x", np.float32, (1, 4))], [("y", np.float32, (1, 4))])), device="cpu")
    (out,) = eng.run_device(torch.tensor([[-1.0, 2.0, -3.0, 4.0]]))
    assert isinstance(out, torch.Tensor) and out.tolist() == [[0.0, 2.0, 0.0, 4.0]]
    nodes = [W.make_node("NonZero", ["x"], ["y"])]
    eng = OnnxGraphEngine(parse_onnx(W.simple_model(
        nodes, [("x", np.float32, (1, 4))], [("y", np.int64, None)])), device="cpu")
    with pytest.raises(ValueError, match="host tail"):
        eng.run_device(torch.zeros(1, 4))
    np.testing.assert_array_equal(eng.engine_inference(np.array([[0, 1, 0, 2]], np.float32))[0],
                                  [[0, 0], [1, 3]])
