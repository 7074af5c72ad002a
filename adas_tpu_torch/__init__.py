"""adas_tpu_torch: the PyTorch/CUDA port of ``adas_tpu``.

A second package beside the JAX one, with the same module layout and
names so each module's counterpart is easy to find.  It imports
``torch`` and never ``jax``, ``flax``, ``cv2`` or anything of ``adas_tpu``; the JAX package stays the
reference the port's tests hold it against.

What it serves today: the batched multi-stream step of
``adas_tpu.pipeline.multistream.MultiStreamADAS`` (JAX's constructor; bgr
or I420 transport, an optional host downscale, the compute probe), on
``cuda`` or ``cpu``, with every YOLO family or EfficientDet D0-D7 on the
object side and UFLD v1/v2 (ResNet-18, 34 or 50) on the lane side, in
int8 (calibrated, or a dynamic scale per stream), bf16 or f32; the UFLDv2
configs (``utils/config.py``); and the single-frame path, ``pipeline/app.ADASPipeline.process_frame``
over the facades' ``DetectFrame`` and ``pipeline/fused.FusedADASStep``,
with the HUD drawn on the host by the cv2-free renderer (``render/``)
and the demo's video I/O in YUV4MPEG2 (``run_video``, ``run_synthetic``,
``python -m adas_tpu_torch.pipeline.app``).  Five hand-written Hopper kernels carry
both: the stems (``csrc/stem.cu``, ``ops/stem.py``), the W8A8 convs
(``csrc/int8_conv.cu``, ``ops/int8_conv.py``), the fused residual bodies
(``csrc/block.cu``, ``ops/block.py``), the pairwise IoU (``csrc/iou.cu``,
``ops/iou.py``) and the greedy NMS selection (``csrc/nms.cu``,
``ops/nms.py``); everything else is plain PyTorch.  The numpy-only host
code it needs (the tracker, the LAPJV solver, the value types, the
logger) is the port's own copy; its C++ (the LAPJV solver, the stroke
rasterizer) is built with g++ on first use.
"""

__version__ = "0.1.0"
