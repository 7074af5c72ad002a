"""Box coordinate transforms and IoU on tensors (port of the parts of
``adas_tpu/ops/boxes.py`` the serving path uses).

The IoU functions evaluate the reference's expressions operand for
operand, each product and sum rounded on its own, so they give its f32
results to the bit.  Since max, min, products and sums are commutative,
``pairwise_iou(boxes, boxes)`` is symmetric to the bit and its row ``i``
equals ``iou_row(boxes, boxes[i])``.
"""
from __future__ import annotations

import torch


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) center boxes -> (x1, y1, x2, y2)."""
    c = boxes[..., 0:2]
    half = boxes[..., 2:4] * 0.5
    return torch.cat([c - half, c + half], dim=-1)


def box_area(boxes: torch.Tensor, plus_one: bool = False) -> torch.Tensor:
    off = 1.0 if plus_one else 0.0
    return (boxes[..., 2] - boxes[..., 0] + off) * (boxes[..., 3] - boxes[..., 1] + off)


def _iou(a: torch.Tensor, b: torch.Tensor, plus_one: bool) -> torch.Tensor:
    """IoU of broadcastable xyxy box tensors ``a`` and ``b`` (..., 4)."""
    off = 1.0 if plus_one else 0.0
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt + off, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a, plus_one) + box_area(b, plus_one) - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def pairwise_iou(a: torch.Tensor, b: torch.Tensor, plus_one: bool = False) -> torch.Tensor:
    """IoU matrix between two xyxy box sets: (..., N, 4) x (..., M, 4) ->
    (..., N, M) (``boxes.py:40``).  ``plus_one`` is the VOC-style ``+1``
    width/height of the reference soft-NMS."""
    return _iou(a[..., :, None, :], b[..., None, :, :], plus_one)


def iou_row(boxes: torch.Tensor, box: torch.Tensor, plus_one: bool = False) -> torch.Tensor:
    """IoU of one xyxy ``box`` (..., 4) against ``boxes`` (..., N, 4) ->
    (..., N) (``boxes.py:61``)."""
    return _iou(boxes, box[..., None, :], plus_one)
