"""The engine layer of the port (``adas_tpu/engine``): the executor
protocol (``base.EngineBase``), eager torch engines
(``torch_engine.TorchEngine``, ``FakeEngine``), the serialized ``.adas``
artifacts (``artifact``: ``build_*``, ``CompiledEngine``), the ONNX graph
executor (``onnx_engine.OnnxGraphEngine``) and the model registry
(``registry``)."""
from . import registry
from .base import EngineBase
from .torch_engine import FakeEngine, TorchEngine

__all__ = ["EngineBase", "TorchEngine", "FakeEngine", "registry"]
