"""adas_tpu_torch: the PyTorch/CUDA port of ``adas_tpu``.

A second package beside the JAX one, with the same module layout and
names so each module's counterpart is easy to find.  It imports
``torch`` and never ``jax`` or ``flax``; the JAX package stays the
reference the port's tests hold it against.

What it serves today: the batched multi-stream step of
``adas_tpu.pipeline.multistream.MultiStreamADAS`` over I420 transport, on
``cuda`` or ``cpu``, with YOLOv8 (calibrated int8, bf16 or f32) or
EfficientDet D0-D7 (f32) on the object side and UFLDv2 on the lane side,
and EfficientDet's single-frame ``DetectFrame``.  Five hand-written
Hopper kernels carry it: the stems (``csrc/stem.cu``, ``ops/stem.py``),
the W8A8 convs (``csrc/int8_conv.cu``, ``ops/int8_conv.py``), the fused
residual bodies (``csrc/block.cu``, ``ops/block.py``), the pairwise-IoU
matrix (``csrc/iou.cu``, ``ops/iou.py``) and the greedy NMS scan
(``csrc/nms.cu``, ``ops/nms.py``); everything else is plain PyTorch.  The numpy-only host
code (``adas_tpu.tracking``, ``adas_tpu.utils``, ``adas_tpu.native``) is
imported, not copied.
"""

__version__ = "0.1.0"
