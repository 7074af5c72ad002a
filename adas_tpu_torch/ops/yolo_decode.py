"""YOLO head decode + candidate selection, batched over streams (port of
``adas_tpu/ops/yolo_decode.py``: the v8/v9/v10 and v5/v6/v7 output
contracts; v5-lite's grid decode waits with its family, ``ROADMAP.md`` §1).

raw -> per-anchor boxes/scores/classes -> score threshold ->
top-k pre-selection -> class-agnostic greedy hard NMS with VOC ``+1``
arithmetic (or gaussian soft-NMS) -> (B, max_det, 6) rows ``[x1, y1, x2, y2, score, class_id]``
padded with zeros -> letterbox inverse.  Shapes are fixed, so the
detections stay on the device until the tick's one packed copy.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.types import ObjectModelType
from .boxes import cxcywh_to_xyxy
from .nms import select_loop
from .preprocess import LetterboxGeometry


#: the families whose raw output is (B, 4+nc, N), the class probability
#: the confidence
_V8_LIKE = (ObjectModelType.YOLOV8, ObjectModelType.YOLOV9, ObjectModelType.YOLOV10)
#: the families whose raw output is (B, N, 5+nc), confidence = obj x cls
_V5_LIKE = (ObjectModelType.YOLOV5, ObjectModelType.YOLOV6, ObjectModelType.YOLOV7)


def decode_predictions(
    raw: torch.Tensor,
    model_type: ObjectModelType = ObjectModelType.YOLOV8,
    num_classes: Optional[int] = None,
    input_hw: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw output -> (boxes_xyxy (B, N, 4), scores (B, N), class_ids (B, N))
    (``yolo_decode.py:68``): v8/v9/v10 raw (B, 4+nc, N), the class
    probability the confidence; v5/v6/v7 raw (B, N, 5+nc), the confidence
    objectness x class probability.  ``num_classes`` and ``input_hw`` are
    the JAX signature's (v5-lite's grid decode reads ``input_hw``)."""
    if model_type in _V8_LIKE:
        preds = raw.transpose(1, 2)  # (B, N, 4+nc)
        scores, class_ids = preds[..., 4:].max(dim=-1)
    elif model_type in _V5_LIKE:
        preds = raw
        scores, class_ids = (preds[..., 5:] * preds[..., 4:5]).max(dim=-1)
    else:
        raise NotImplementedError(f"{model_type.name} decode is not ported (ROADMAP.md §1)")
    return cxcywh_to_xyxy(preds[..., :4]), scores, class_ids


def select_and_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    class_ids: torch.Tensor,
    box_score: float = 0.4,
    iou_threshold: float = 0.45,
    max_det: int = 100,
    pre_topk: int = 512,
    hard_only: bool = True,
) -> torch.Tensor:
    """Threshold + top-k preselect + class-agnostic NMS -> (B, max_det, 6)
    rows [x1, y1, x2, y2, score, class_id], padded with zeros
    (``yolo_decode.py:99``).  ``hard_only`` selects hard suppression (the
    reference's effective behaviour), else gaussian soft-NMS; both with
    VOC ``+1`` arithmetic.  On the GPU the selection is the IoU and scan
    kernels (``ops/nms.py``), one launch each per call.

    The top-k is a stable descending sort, so equal scores keep index
    order, as ``jax.lax.top_k`` does."""
    scores = torch.where(scores > box_score, scores, torch.zeros_like(scores))
    k = min(pre_topk, scores.shape[1])
    top_scores, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, idx = top_scores[:, :k], idx[:, :k]
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    top_ids = torch.gather(class_ids, 1, idx)
    keep = select_loop(
        top_boxes, top_scores, iou_threshold, max_det, method=0 if hard_only else 2,
        sigma=0.5, score_threshold=0.001, plus_one=True,
    )
    valid = keep >= 0
    gather = keep.clamp(0, k - 1)
    out = torch.cat(
        [
            torch.gather(top_boxes, 1, gather[..., None].expand(-1, -1, 4)),
            torch.gather(top_scores, 1, gather)[..., None],
            torch.gather(top_ids, 1, gather)[..., None].float(),
        ],
        dim=-1,
    )
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def detections_to_original(dets: torch.Tensor, geom: LetterboxGeometry) -> torch.Tensor:
    """Map padded (..., max_det, 6) detections from letterboxed to source
    coordinates (``yolo_decode.py:139``)."""
    return torch.cat([geom.boxes_to_original(dets[..., :4]), dets[..., 4:]], dim=-1)
