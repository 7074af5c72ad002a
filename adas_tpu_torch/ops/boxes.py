"""Box coordinate transforms and IoU on tensors (port of the parts of
``adas_tpu/ops/boxes.py`` the serving path uses)."""
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


def pairwise_iou_rows(boxes: torch.Tensor, plus_one: bool = False) -> torch.Tensor:
    """(..., N, 4) xyxy -> (..., N, N) IoU, row ``i`` equal element for
    element to ``adas_tpu.ops.boxes.iou_row(boxes, boxes[i])`` (same
    operands in the same order, so the same f32 rounding)."""
    off = 1.0 if plus_one else 0.0
    a = boxes[..., None, :, :]  # the row's candidates (j)
    b = boxes[..., :, None, :]  # the selected box (i)
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt + off, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a, plus_one) + box_area(b, plus_one) - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))
