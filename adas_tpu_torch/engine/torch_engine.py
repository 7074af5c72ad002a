"""Torch engine: an eager model graph as an inference engine (port of
``XLAEngine`` and ``FakeEngine``, ``adas_tpu/engine/xla_engine.py:32-124``).

``TorchEngine`` wraps ``apply_fn(variables, nhwc_batch)`` (the port's nets
with their weights, typically ``lambda net, x: net(x.permute(0, 3, 1,
2))``) on an explicit device: ``engine_inference`` takes the reference's
NCHW numpy blob and returns numpy outputs, ``run_device`` keeps NHWC
device tensors in and out.  Nothing is compiled, so JAX's
``enable_persistent_cache`` has no counterpart: the port's kernels are
built once into ``_build/``.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .base import EngineBase

def torch_dtype(dtype) -> torch.dtype:
    """A numpy dtype, its name (``"bfloat16"`` too) or a torch dtype, as
    the torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A device tensor on the host as numpy (bf16 widened to f32, which
    numpy lacks)."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


class TorchEngine(EngineBase):
    """``apply_fn(variables, nhwc_batch) -> output(s)`` as an engine on
    ``device``; outputs are a tensor, a tuple/list of them, or a dict
    (taken in ``output_names`` order).  ``aot`` runs the graph once on
    zeros at construction to record the output shapes (JAX compiles
    there)."""

    framework_type = "torch"

    def __init__(
        self,
        apply_fn: Callable,
        variables,
        input_shape_nchw: Sequence[int],
        output_names: Sequence[str],
        dtype=np.float32,
        aot: bool = False,
        device="cuda",
    ):
        from ..perception.object_detector import resolve_device

        self._apply = apply_fn
        self.variables = variables
        self._input_shape = tuple(input_shape_nchw)
        self._output_names = list(output_names)
        self._dtype = dtype
        self.device = resolve_device(device)
        self.providers = self.device.type
        self._output_shapes: Optional[List[Tuple[int, ...]]] = None
        if aot:
            self._trace_output_shapes()

    def _trace_output_shapes(self) -> None:
        n, c, h, w = self._input_shape
        x = torch.zeros((n, h, w, c), dtype=torch_dtype(self._dtype), device=self.device)
        self._output_shapes = [tuple(o.shape) for o in self._as_list(self.run_device(x))]

    def _as_list(self, outs) -> List:
        if isinstance(outs, dict):
            return [outs[name] for name in self._output_names]
        if isinstance(outs, (list, tuple)):
            return list(outs)
        return [outs]

    def get_engine_input_shape(self) -> Sequence[int]:
        return self._input_shape

    def get_engine_output_shape(self):
        if self._output_shapes is None:
            self._trace_output_shapes()
        return self._output_shapes, list(self._output_names)

    @property
    def engine_dtype(self):
        return self._dtype

    def engine_inference(self, input_tensor: np.ndarray) -> List[np.ndarray]:
        x = torch.from_numpy(np.ascontiguousarray(np.transpose(input_tensor, (0, 2, 3, 1))))
        outs = self._as_list(self.run_device(x.to(self.device, torch_dtype(self._dtype))))
        return [to_numpy(o) for o in outs]

    @torch.inference_mode()
    def run_device(self, nhwc_batch: torch.Tensor):
        """Device-to-device execution (no host copies)."""
        return self._apply(self.variables, nhwc_batch)

    def device_inference(self, x: torch.Tensor) -> List[torch.Tensor]:
        nhwc = x.permute(0, 2, 3, 1).contiguous()
        return self._as_list(self.run_device(nhwc.to(self.device, torch_dtype(self._dtype))))


class FakeEngine(EngineBase):
    """Canned-tensor engine for tests."""

    framework_type = "fake"

    def __init__(self, input_shape_nchw, outputs: dict):
        self._input_shape = tuple(input_shape_nchw)
        self._outputs = outputs
        self.calls: List[np.ndarray] = []

    def get_engine_input_shape(self):
        return self._input_shape

    def get_engine_output_shape(self):
        return (
            [tuple(np.asarray(v).shape) for v in self._outputs.values()],
            list(self._outputs.keys()),
        )

    def engine_inference(self, input_tensor):
        self.calls.append(np.asarray(input_tensor))
        return [np.asarray(v) for v in self._outputs.values()]
