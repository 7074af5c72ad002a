"""YOLO head decode + candidate selection, batched over streams (port of
``adas_tpu/ops/yolo_decode.py``: the v8/v9/v10, v5/v6/v7 and v5-lite
output contracts).

raw -> per-anchor boxes/scores/classes -> score threshold ->
top-k pre-selection -> class-agnostic greedy hard NMS with VOC ``+1``
arithmetic (or gaussian soft-NMS) -> (B, max_det, 6) rows ``[x1, y1, x2, y2, score, class_id]``
padded with zeros -> letterbox inverse.  Shapes are fixed, so the
detections stay on the device until the tick's one packed copy.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.types import ObjectModelType
from .boxes import cxcywh_to_xyxy
from .nms import select_loop
from .preprocess import LetterboxGeometry


#: the families whose raw output is (B, 4+nc, N), the class probability
#: the confidence
_V8_LIKE = (ObjectModelType.YOLOV8, ObjectModelType.YOLOV9, ObjectModelType.YOLOV10)
#: the families whose raw output is (B, N, 5+nc), confidence = obj x cls
_V5_LIKE = (ObjectModelType.YOLOV5, ObjectModelType.YOLOV6, ObjectModelType.YOLOV7,
            ObjectModelType.YOLOV5_LITE)

V5LITE_ANCHORS = np.array(
    [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119], [116, 90, 156, 198, 373, 326]],
    np.float32,
).reshape(3, 3, 2)


@lru_cache(maxsize=16)
def _v5lite_grid(h_in: int, w_in: int, device: str):
    """Per level (row offset, rows, stride, grid (rows, 2), anchors (rows,
    2)) of the v5-lite decode: anchor-major rows, the grid tiled per anchor
    and each anchor repeated over the grid (``yolo_decode.py:42-66``); made
    once per input size and device."""
    levels, row = [], 0
    na = V5LITE_ANCHORS.shape[1]
    for level, stride in enumerate((8.0, 16.0, 32.0)):
        gh, gw = int(h_in / stride), int(w_in / stride)
        ys, xs = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
        grid = np.tile(np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32), (na, 1))
        anchors = np.repeat(V5LITE_ANCHORS[level], gh * gw, axis=0)
        levels.append((row, na * gh * gw, stride, torch.from_numpy(grid).to(device),
                       torch.from_numpy(anchors).to(device)))
        row += na * gh * gw
    return levels


def v5lite_grid_decode(output: torch.Tensor, input_hw: Tuple[int, int]) -> torch.Tensor:
    """The anchor/grid decode of a YOLOv5-lite export, whose graph stops
    before it (``yolo_decode.py:42``): (B, N, 5+nc) sigmoided rows ->
    the same rows with xy and wh in pixels."""
    pieces = []
    for row, n, stride, grid, anchors in _v5lite_grid(int(input_hw[0]), int(input_hw[1]),
                                                      str(output.device)):
        seg = output[:, row: row + n]
        xy = (seg[..., 0:2] * 2.0 - 0.5 + grid) * stride
        wh = (seg[..., 2:4] * 2.0) ** 2 * anchors
        pieces.append(torch.cat([xy, wh, seg[..., 4:]], dim=-1))
    return torch.cat(pieces, dim=1)


def decode_predictions(
    raw: torch.Tensor,
    model_type: ObjectModelType = ObjectModelType.YOLOV8,
    num_classes: Optional[int] = None,
    input_hw: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw output -> (boxes_xyxy (B, N, 4), scores (B, N), class_ids (B, N))
    (``yolo_decode.py:68``): v8/v9/v10 raw (B, 4+nc, N), the class
    probability the confidence; v5/v6/v7 raw (B, N, 5+nc), the confidence
    objectness x class probability, v5-lite's rows grid-decoded first
    (:func:`v5lite_grid_decode`, on ``input_hw``).  ``num_classes`` is the
    JAX signature's."""
    if model_type in _V8_LIKE:
        preds = raw.transpose(1, 2)  # (B, N, 4+nc)
        scores, class_ids = preds[..., 4:].max(dim=-1)
    elif model_type in _V5_LIKE:
        preds = raw
        if model_type is ObjectModelType.YOLOV5_LITE:
            if input_hw is None:
                raise ValueError("the YOLOv5-lite decode needs input_hw")
            preds = v5lite_grid_decode(preds, input_hw)
        scores, class_ids = (preds[..., 5:] * preds[..., 4:5]).max(dim=-1)
    else:
        raise ValueError(f"{model_type.name} has no YOLO output contract")
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
