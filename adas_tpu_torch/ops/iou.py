"""Pairwise-IoU matrix of a box set, batched (port of
``adas_tpu/ops/pallas_iou.py``).

The TPU kernel there (``_iou_kernel``, entered through ``iou_matrix``)
becomes the Hopper kernel ``csrc/iou.cu``, built with nvcc for ``sm_90a``
and bound through ctypes; its source note says what bounds it on the card
and what its design does about it.  It feeds the greedy selection scan
(``ops/nms.py``), which reads one row of the matrix per step.

A CUDA tensor always launches the kernel (or raises); a CPU tensor takes
the plain version ``pairwise_iou(boxes, boxes)``.  The kernel rounds each
operation as the plain version does, so on the card the two agree to the
bit.  Unlike ``pallas_iou.iou_matrix`` there is no padding of N to a tile
multiple: the kernel masks the ragged edge itself.
"""
from __future__ import annotations

import ctypes

import torch

from .boxes import pairwise_iou
from .cuda_build import load_cuda_library

#: launches of the CUDA kernel since the last :func:`reset_launches`; the
#: plain CPU path does not count
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def iou_matrix_reference(boxes: torch.Tensor, plus_one: bool = False) -> torch.Tensor:
    """The plain PyTorch version: ``pairwise_iou(boxes, boxes)`` in f32."""
    boxes = boxes.float()
    return pairwise_iou(boxes, boxes, plus_one=plus_one)


def _entry():
    fn = load_cuda_library("iou").adas_iou_matrix
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def iou_matrix(boxes: torch.Tensor, plus_one: bool = False) -> torch.Tensor:
    """(B, N, 4) xyxy boxes -> (B, N, N) f32 IoU: the CUDA kernel for a
    CUDA tensor (f32, contiguous), :func:`iou_matrix_reference` for a CPU
    tensor."""
    global launches
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"iou_matrix takes (B, N, 4) boxes, got {tuple(boxes.shape)}")
    if boxes.device.type == "cpu":
        return iou_matrix_reference(boxes, plus_one)
    if boxes.device.type != "cuda":
        raise ValueError(f"iou_matrix runs on cuda or cpu, got {boxes.device}")
    if boxes.dtype != torch.float32 or not boxes.is_contiguous():
        raise ValueError(f"the IoU kernel takes contiguous f32 boxes, got {boxes.dtype}")
    bsz, n, _ = boxes.shape
    out = torch.empty((bsz, n, n), dtype=torch.float32, device=boxes.device)
    if out.numel() == 0:
        return out
    entry = _entry()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        rc = entry(boxes.data_ptr(), out.data_ptr(), bsz, n, int(plus_one), stream)
    if rc != 0:
        raise RuntimeError(f"iou kernel launch failed: cudaError_t {rc}")
    launches += 1
    return out
