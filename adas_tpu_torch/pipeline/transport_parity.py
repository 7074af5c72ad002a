"""Accuracy guardrail for the adaptive transport ladder (port of
``adas_tpu/pipeline/transport_parity.py``, without cv2).

The serving path may detect on a downscaled, I420-transported frame
(``MultiStreamADAS``'s ``host_downscale`` and ``transport="i420"``); this
module measures the decode drift a ladder rung introduces against the
native-resolution path ON THE SAME FRAMES:

- boxes: matched-IoU mean and missed-detection rate (a native detection
  with no rung-path match at IoU >= 0.5 counts as missed);
- lanes: mean row-anchor x-error in native pixels over points detected
  by both paths.

The rung path reproduces the transport's information loss exactly: the
host bilinear downscale to the rung (``render/draw.resize_linear``,
cv2's ``INTER_LINEAR``, bit-equal when downscaling) and the I420 chroma
round trip (``ops/preprocess.bgr_to_i420`` and
``native/draw.i420_to_bgr``, cv2's ``COLOR_BGR2YUV_I420`` /
``COLOR_YUV2BGR_I420`` to the bit), then the same letterbox, model and
decode of the facades' ``DetectFrame``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..native.draw import i420_to_bgr
from ..ops.preprocess import bgr_to_i420
from ..render.draw import resize_linear

#: IoU at which a native detection counts as recovered by the rung path
MATCH_IOU = 0.5
#: y-tolerance (native px) for pairing lane row-anchor points
LANE_Y_TOL = 8.0


def _i420_roundtrip(frame_bgr: np.ndarray) -> np.ndarray:
    """Apply the serving transport's chroma loss (BGR -> I420 -> BGR)."""
    h, w = frame_bgr.shape[:2]
    return i420_to_bgr(bgr_to_i420(frame_bgr), h, w)


def transport_view(
    frame_bgr: np.ndarray, rung_hw: Sequence[int]
) -> np.ndarray:
    """The frame as the fused step sees it at a ladder rung: bilinear
    host downscale + I420 chroma round trip."""
    rh, rw = rung_hw
    return _i420_roundtrip(resize_linear(frame_bgr, (rw, rh)))


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of two (N, 4)/(M, 4) xyxy box sets."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), axis=2)
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=1)
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=1)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def _boxes_xyxy(objs) -> np.ndarray:
    return np.asarray(
        [o.tolist(dtype=float, format_type="xyxy") for o in objs],
        np.float32,
    ).reshape(-1, 4)


def _match_boxes(native: np.ndarray, rung: np.ndarray) -> Tuple[float, int]:
    """Greedy best-IoU matching; returns (sum matched IoU, n matched)."""
    iou = _iou_matrix(native, rung)
    matched_iou, n_matched = 0.0, 0
    while iou.size and iou.max() >= MATCH_IOU:
        i, j = np.unravel_index(np.argmax(iou), iou.shape)
        matched_iou += float(iou[i, j])
        n_matched += 1
        iou[i, :] = -1.0
        iou[:, j] = -1.0
    return matched_iou, n_matched


def _lane_points(lane_info) -> list:
    """Per-lane (K, 2) float arrays from a LaneInfo holder."""
    out = []
    for pts in lane_info.lanes_points:
        arr = np.asarray(pts, np.float64).reshape(-1, 2)
        out.append(arr)
    return out


def measure_transport_drift(
    yolo,
    lane,
    frames: Sequence[np.ndarray],
    rung_hw: Sequence[int],
    lane_kwargs: Optional[dict] = None,
) -> Dict[str, float]:
    """Decode drift of a transport rung vs the native-resolution path.

    ``yolo`` / ``lane``: perception facades (YoloDetector-compatible /
    UltrafastLaneDetector-compatible).  ``frames``: native-resolution
    BGR uint8 frames.  Returns::

        {"rung": [h, w], "box_miss_rate": ..., "box_matched_iou": ...,
         "lane_x_err_px": ..., "native_dets": ..., "rung_dets": ...}

    ``box_miss_rate``: fraction of native detections with no rung match
    at IoU >= 0.5 (symmetric spurious detections show up as
    ``rung_dets`` exceeding ``native_dets``).  ``lane_x_err_px``: mean
    |x_native - x_rung| in native pixels over row-anchor points paired
    by y (within LANE_Y_TOL).  NaN-free: fields with no support are 0.
    """
    rh, rw = int(rung_hw[0]), int(rung_hw[1])
    tot_native = tot_rung = tot_matched = 0
    sum_iou = 0.0
    lane_err_sum, lane_err_n = 0.0, 0
    for frame in frames:
        fh, fw = frame.shape[:2]
        sy, sx = fh / rh, fw / rw
        small = transport_view(frame, (rh, rw))

        yolo.DetectFrame(frame)
        native_boxes = _boxes_xyxy(yolo.object_info)
        yolo.DetectFrame(small)
        rung_boxes = _boxes_xyxy(yolo.object_info)
        rung_boxes[:, [0, 2]] *= sx
        rung_boxes[:, [1, 3]] *= sy
        miou, nm = _match_boxes(native_boxes, rung_boxes)
        sum_iou += miou
        tot_matched += nm
        tot_native += len(native_boxes)
        tot_rung += len(rung_boxes)

        if lane is not None:
            kw = lane_kwargs or {}
            lane.DetectFrame(frame, **kw)
            native_lanes = _lane_points(lane.lane_info)
            lane.DetectFrame(small, **kw)
            rung_lanes = _lane_points(lane.lane_info)
            for nat, rng in zip(native_lanes, rung_lanes):
                if not len(nat) or not len(rng):
                    continue
                rng = rng * np.array([sx, sy])
                # pair points by row (y): anchors land on proportional
                # rows in both paths, so nearest-y within tolerance is
                # the same anchor
                for x_n, y_n in nat:
                    d = np.abs(rng[:, 1] - y_n)
                    j = int(np.argmin(d))
                    if d[j] <= LANE_Y_TOL:
                        lane_err_sum += abs(float(rng[j, 0]) - float(x_n))
                        lane_err_n += 1
    return {
        "rung": [rh, rw],
        "box_miss_rate": round(
            1.0 - tot_matched / tot_native if tot_native else 0.0, 4
        ),
        "box_matched_iou": round(
            sum_iou / tot_matched if tot_matched else 0.0, 4
        ),
        "lane_x_err_px": round(
            lane_err_sum / lane_err_n if lane_err_n else 0.0, 2
        ),
        "native_dets": tot_native,
        "rung_dets": tot_rung,
    }
