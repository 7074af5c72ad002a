"""Host-side homography helpers (numpy), the parts of
``adas_tpu/ops/warp.py`` the serving path's analytics call.

The device image warp (``warp_perspective``) is not ported yet; the
serving path never warps an image, it only projects lane points.
"""
from __future__ import annotations

import numpy as np


def get_perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """3x3 homography mapping 4 src points to 4 dst points: an 8x8 linear
    solve, same contract as ``cv2.getPerspectiveTransform``
    (``warp.py:24``)."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    if src.shape != (4, 2) or dst.shape != (4, 2):
        raise ValueError("need exactly 4 source and 4 destination points")
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i, ((x, y), (u, v)) in enumerate(zip(src, dst)):
        a[2 * i] = [x, y, 1, 0, 0, 0, -u * x, -u * y]
        a[2 * i + 1] = [0, 0, 0, x, y, 1, -v * x, -v * y]
        b[2 * i] = u
        b[2 * i + 1] = v
    h = np.linalg.solve(a, b)
    return np.append(h, 1.0).reshape(3, 3)


def transform_points(points: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """Apply a homography to (N, 2) points (``warp.py:99``)."""
    points = np.asarray(points, dtype=np.float64)
    if points.size == 0:
        return points.reshape(0, 2)
    homo = np.concatenate([points, np.ones((*points.shape[:-1], 1))], axis=-1)
    out = homo @ np.asarray(matrix, dtype=np.float64).T
    return out[..., :2] / out[..., 2:3]
