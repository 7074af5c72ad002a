"""The engine layer of the port: for now the model registry only
(``registry.py``, the port's copy of ``adas_tpu/engine/registry.py``).
The graph executor and the serialized artifacts of the JAX package's
engine layer are not ported yet."""
from . import registry

__all__ = ["registry"]
