"""Homography helpers (host numpy) and the device image warp (port of
``adas_tpu/ops/warp.py``).

``warp_perspective`` is the bilinear homography warp of the bird-view
transform, in plain PyTorch on the image's device (the JAX one is a
jitted XLA gather, not a Pallas kernel): the inverse homography in f32
on the device, four clamped taps with a zero border, ``round``
half-to-even for integer images.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


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


def warp_perspective(img: torch.Tensor, matrix, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear homography warp of an (H, W, C) image: ``out[y, x] =
    img[M^-1 (x, y)]`` (``warp.py:45``).

    ``matrix`` (3x3, numpy or tensor) maps source to destination (the cv2
    convention); it is cast to f32 and inverted on the image's device
    (``inv_ex``: no error check, so no synchronization), then
    :func:`warp_inverse` samples.  Two f32 LU inverses (LAPACK's, cuSOLVER's,
    XLA's) differ in the last bits, and the bird-view homography carries
    that into its far source rows (``tests/test_torch_warp.py``)."""
    m = torch.as_tensor(matrix).to(img.device, torch.float32)
    return warp_inverse(img, torch.linalg.inv_ex(m)[0], out_hw)


def warp_inverse(img: torch.Tensor, m_inv: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Sample an (H, W, C) image at ``m_inv (x, y)`` for every output pixel,
    ``m_inv`` an f32 3x3 on the image's device: four clamped taps with a
    zero border (cv2's default BORDER_CONSTANT); an integer image's result
    is rounded half-to-even before the cast back.

    The source coordinates follow the reference's ``dst_pts @ m_inv.T``
    as XLA evaluates the three-term dot: ``fma(m[k, 2], 1, fma(m[k, 1], y,
    m[k, 0] * x))``, each fused step rounded once (:func:`_fma_f32`).
    """
    if img.dim() != 3:
        raise ValueError(f"expected an (H, W, C) image, got {tuple(img.shape)}")
    out_h, out_w = out_hw
    dev = img.device
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(out_h, dtype=torch.float64, device=dev)[:, None]
    m64 = m_inv.double()
    px, py, pz = (
        _fma_f32(m64[k, 1] * ys, (m_inv[k, 0] * xs).double()) + m_inv[k, 2] for k in range(3)
    )
    sx = px / pz
    sy = py / pz

    h, w = img.shape[:2]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    flat = img.reshape(h * w, -1)

    def sample(yi, xi):
        valid = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        # out-of-image (and non-finite) coordinates read pixel 0 and are
        # zeroed: every index stays in range
        yc = torch.where(valid, yi, torch.zeros_like(yi)).long()
        xc = torch.where(valid, xi, torch.zeros_like(xi)).long()
        vals = flat[yc * w + xc].float()
        return torch.where(valid[..., None], vals, torch.zeros_like(vals))

    v00 = sample(y0, x0)
    v01 = sample(y0, x0 + 1)
    v10 = sample(y0 + 1, x0)
    v11 = sample(y0 + 1, x0 + 1)
    out = (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )
    if not img.dtype.is_floating_point:
        out = torch.round(out)
    return out.to(img.dtype)


def _fma_f32(prod: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``prod + acc`` rounded once to f32, for an f64 ``prod`` that is an
    exact product of an f32 and a small integer and an f32 ``acc`` held in
    f64: a fused multiply-add.  The f64 sum ``s`` is exact but for its
    last bits; rounding it to f32 is the fused result unless ``s`` lies
    exactly halfway between two f32 values, where the sign of the f64
    sum's rounding error (TwoSum) decides, as it does for the exact sum."""
    s = prod + acc
    bp = s - prod
    err = (prod - (s - bp)) + (acc - bp)
    r = s.float()
    other = torch.nextafter(r, torch.where(r.double() < s, torch.inf, -torch.inf).float())
    # at a tie, r (rounded to even) and its neighbour across s are equally
    # near; the exact sum lies on the side of err
    tie = (err != 0) & ((s - r.double()).abs() == (other.double() - s).abs())
    toward_other = (other.double() - s) * err > 0
    return torch.where(tie & toward_other, other, r)


def transform_points(points: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """Apply a homography to (N, 2) points (``warp.py:99``)."""
    points = np.asarray(points, dtype=np.float64)
    if points.size == 0:
        return points.reshape(0, 2)
    homo = np.concatenate([points, np.ones((*points.shape[:-1], 1))], axis=-1)
    out = homo @ np.asarray(matrix, dtype=np.float64).T
    return out[..., :2] / out[..., 2:3]
