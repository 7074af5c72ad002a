"""Engine abstraction: the seam between model graphs and their executor
(port of ``adas_tpu/engine/base.py``).

``get_engine_input_shape`` / ``get_engine_output_shape`` /
``engine_inference``, so the detector facades are engine-agnostic and the
tests can inject fakes.  The port's engines run eager torch modules
(:class:`~adas_tpu_torch.engine.torch_engine.TorchEngine`), exported
programs (:class:`~adas_tpu_torch.engine.artifact.CompiledEngine`) and
ONNX graphs (:class:`~adas_tpu_torch.engine.onnx_engine.OnnxGraphEngine`).
"""
from __future__ import annotations

import abc
from typing import List, Sequence, Tuple

import numpy as np
import torch


class EngineBase(abc.ABC):
    """Executor interface: NCHW tensors in, list of numpy tensors out."""

    framework_type: str = "base"
    providers: str = ""

    @abc.abstractmethod
    def get_engine_input_shape(self) -> Sequence[int]:
        """Input shape, NCHW."""

    @abc.abstractmethod
    def get_engine_output_shape(self) -> Tuple[List[Sequence[int]], List[str]]:
        """(output shapes, output names)."""

    @abc.abstractmethod
    def engine_inference(self, input_tensor: np.ndarray) -> List[np.ndarray]:
        """Run the graph on one NCHW tensor; returns outputs in name order."""

    def device_inference(self, x: torch.Tensor) -> List[torch.Tensor]:
        """:meth:`engine_inference` on an NCHW tensor where the facade made
        it, the outputs as tensors on ``x``'s device.  This one goes
        through the host; the port's engines keep the blob on the device."""
        return [torch.from_numpy(np.ascontiguousarray(o)).to(x.device)
                for o in self.engine_inference(x.cpu().numpy())]

    @property
    def engine_dtype(self):
        return np.float32
