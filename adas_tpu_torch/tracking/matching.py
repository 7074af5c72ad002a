"""Association costs + exact LAP matching for the tracker.

Parity with reference ObjectTracker/byteTrack/matching.py: 1-IoU cost,
score-fused cost, and JV assignment with a cost limit — solved by the
port's C++ LAPJV (adas_tpu_torch/native/lapjv.cpp) instead of the external
``lap`` wheel.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..native.lapjv import lapjv


def linear_assignment(
    cost_matrix: np.ndarray, thresh: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact min-cost matching; pairs costing >= thresh stay unmatched.

    Returns (matches (M,2), unmatched_rows, unmatched_cols).
    """
    if cost_matrix.size == 0:
        return (
            np.empty((0, 2), dtype=int),
            np.arange(cost_matrix.shape[0]),
            np.arange(cost_matrix.shape[1]),
        )
    x, y = lapjv(cost_matrix, cost_limit=thresh)
    matches = np.array(
        [[i, j] for i, j in enumerate(x) if j >= 0], dtype=int
    ).reshape(-1, 2)
    return matches, np.where(x < 0)[0], np.where(y < 0)[0]


def box_ious(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xyxy boxes: (N, 4) x (M, 4) -> (N, M)."""
    a = a[:, None, :]
    b = b[None, :, :]
    lt = np.maximum(a[..., :2], b[..., :2])
    rb = np.minimum(a[..., 2:], b[..., 2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter)


def iou_distance(atracks: Sequence, btracks: Sequence) -> np.ndarray:
    """1 - IoU between two track/box lists (tracks expose .tlbr)."""
    if (atracks and isinstance(atracks[0], np.ndarray)) or (
        btracks and isinstance(btracks[0], np.ndarray)
    ):
        atlbrs, btlbrs = atracks, btracks
    else:
        atlbrs = [t.tlbr for t in atracks]
        btlbrs = [t.tlbr for t in btracks]
    if len(atlbrs) == 0 or len(btlbrs) == 0:
        return np.zeros((len(atlbrs), len(btlbrs)), dtype=np.float64)
    return 1.0 - box_ious(
        np.ascontiguousarray(atlbrs, dtype=np.float64),
        np.ascontiguousarray(btlbrs, dtype=np.float64),
    )


def fuse_score(cost_matrix: np.ndarray, detections: Sequence) -> np.ndarray:
    """Blend detection confidence into the IoU cost: 1 - iou_sim*score."""
    if cost_matrix.size == 0:
        return cost_matrix
    iou_sim = 1.0 - cost_matrix
    det_scores = np.asarray([d.score for d in detections])[None, :]
    return 1.0 - iou_sim * det_scores


def fuse_motion(
    kf,
    cost_matrix: np.ndarray,
    tracks: Sequence,
    detections: Sequence,
    only_position: bool = False,
    lambda_: float = 0.98,
) -> np.ndarray:
    """Mahalanobis-gated motion fusion (kept for API parity; unused by
    ByteTrack itself, reference matching.py:82-96)."""
    if cost_matrix.size == 0:
        return cost_matrix
    from .kalman import chi2inv95

    gating_dim = 2 if only_position else 4
    gating_threshold = chi2inv95[gating_dim]
    measurements = np.asarray(
        [STrack_xyah(d) for d in detections], dtype=np.float64
    )
    for row, track in enumerate(tracks):
        gating = kf.gating_distance(
            track.mean, track.covariance, measurements, only_position
        )
        cost_matrix[row, gating > gating_threshold] = np.inf
        cost_matrix[row] = (
            lambda_ * cost_matrix[row] + (1 - lambda_) * gating
        )
    return cost_matrix


def fuse_iou(
    cost_matrix: np.ndarray, tracks: Sequence, detections: Sequence
) -> np.ndarray:
    """Blend a ReID cost with IoU similarity (API parity with reference
    matching.py:98-106; unused by ByteTrack itself)."""
    if cost_matrix.size == 0:
        return cost_matrix
    reid_sim = 1.0 - cost_matrix
    iou_sim = 1.0 - iou_distance(tracks, detections)
    fuse_sim = reid_sim * (1 + iou_sim) / 2
    return 1.0 - fuse_sim


def STrack_xyah(det) -> np.ndarray:
    tlwh = det.tlwh
    ret = np.asarray(tlwh, dtype=np.float64).copy()
    ret[:2] += ret[2:] / 2
    ret[2] /= ret[3]
    return ret
