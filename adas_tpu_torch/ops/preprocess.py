"""Serving-path preprocessing: letterbox geometry, the numpy I420 encoder,
and the YUV-direct resize that turns an I420 batch into each net's NCHW
input; the BGR-plane chain of the EfficientDet path (I420 -> rounded BGR
planes -> resize -> normalize, :func:`i420_to_bgr_planar`,
:func:`imagenet_preprocess_planar`, :func:`ufld_v2_preprocess_planar`);
and the BGR preprocess that calibration and ``DetectFrame`` run on
(:func:`yolo_preprocess`, :func:`ufld_v2_preprocess`,
:func:`imagenet_preprocess`).

Port of the I420 branch of ``adas_tpu/ops/preprocess.py``.  Resize is two
matmuls with precomputed bilinear interpolation matrices
(``A_h @ img @ A_w^T``, the cv2.INTER_LINEAR half-pixel convention), and
the BT.601 colour conversion plus the model normalization fold into them
(``_phase_resize_planes_yuv``, ``preprocess.py:752``): Y resizes at full
resolution, U and V at their native half resolution through matrices
composed with the nearest-2x chroma upsample, and one 3-tap combine per
RGB channel runs at target resolution.  The TPU-only layouts
(``S2DPlanes`` polyphase planes, halo margins, 16-row padding) are not
ported: the output is the plain NCHW ``(B, 3, H, W)`` tensor the Hopper
stem kernel reads.

The resize matmuls run in f32; on the GPU PyTorch runs f32 matmuls in
full f32 unless ``torch.backends.cuda.matmul.allow_tf32`` is set, which
nothing in this package does.

Divergence from the reference (kept from the JAX YUV-direct path,
``preprocess.py:716-720``): the full-resolution ``round``/``clip`` that
mimicked cv2's uint8 decode is dropped (non-linear, cannot ride a
matrix).  For in-gamut video the difference is bounded by the resize of
+-0.5 rounding, i.e. <=0.5/255 of input scale.  The BGR-plane chain keeps
that ``round``/``clip`` (``torch.round`` is half-to-even, as
``jnp.round``), as the JAX EfficientDet path does.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
PAD_VALUE = 114.0

#: BT.601 studio-swing YUV->RGB (rows R,G,B; cols Y,U,V), as
#: ``adas_tpu.ops.preprocess._BT601_RGB``
_BT601_RGB = np.array(
    [
        [1.164, 0.0, 1.596],
        [1.164, -0.391, -0.813],
        [1.164, 2.018, 0.0],
    ],
    np.float32,
)
_I420_OFF = np.array([16.0, 128.0, 128.0], np.float32)


@dataclass(frozen=True)
class LetterboxGeometry:
    """Static letterbox geometry for a (source, target) shape pair
    (``preprocess.py:32``), including the ``+1`` on the scaled height when
    the image is wider than tall: 720x1280 into 640x640 gives a new shape
    of (361, 640) and a pad of 139 rows."""

    src_h: int
    src_w: int
    dst_h: int
    dst_w: int

    @property
    def new_shape(self) -> Tuple[int, int]:
        if self.src_h == self.src_w:
            return self.dst_h, self.dst_w
        hw_scale = self.src_h / self.src_w
        if hw_scale > 1:
            return self.dst_h, int(self.dst_w / hw_scale)
        return int(self.dst_h * hw_scale) + 1, self.dst_w

    @property
    def pad(self) -> Tuple[int, int]:
        newh, neww = self.new_shape
        return int((self.dst_h - newh) * 0.5), int((self.dst_w - neww) * 0.5)

    @property
    def scale_ratio(self) -> Tuple[float, float]:
        newh, neww = self.new_shape
        return self.src_h / newh, self.src_w / neww

    def boxes_to_original(self, boxes: torch.Tensor) -> torch.Tensor:
        """Map (..., 4) xyxy boxes from letterboxed to source coordinates
        (scalar arithmetic: no host-to-device copy per call)."""
        ratioh, ratiow = self.scale_ratio
        padh, padw = self.pad
        xs = (boxes[..., 0::2] - padw) * ratiow
        ys = (boxes[..., 1::2] - padh) * ratioh
        return torch.stack([xs[..., 0], ys[..., 0], xs[..., 1], ys[..., 1]], dim=-1)


def bgr_to_i420(frame: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 BGR -> (H*3/2, W) uint8 I420, as
    ``cv2.cvtColor(frame, cv2.COLOR_BGR2YUV_I420)`` computes it (the
    machine that serves the port has no cv2): BT.601 studio swing in
    20-bit fixed point, chroma sampled at the top-left pixel of each 2x2
    block.  H and W must be even."""
    h, w = frame.shape[:2]
    if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {frame.shape} {frame.dtype}")
    if h % 2 or w % 2:
        raise ValueError(f"I420 needs even frame dims, got {h}x{w}")
    f = frame.astype(np.int32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    shift, half = 20, 1 << 19
    y = (269484 * r + 528482 * g + 102760 * b + half + (16 << shift)) >> shift
    rs, gs, bs = r[0::2, 0::2], g[0::2, 0::2], b[0::2, 0::2]
    u = (-155188 * rs - 305135 * gs + 460324 * bs + half + (128 << shift)) >> shift
    v = (460324 * rs - 385875 * gs - 74448 * bs + half + (128 << shift)) >> shift
    out = np.empty((h * 3 // 2, w), np.uint8)
    out[:h] = y
    out[h:].reshape(-1)[: h * w // 4] = u.reshape(-1)
    out[h:].reshape(-1)[h * w // 4:] = v.reshape(-1)
    return out


@functools.lru_cache(maxsize=64)
def _interp_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) bilinear interpolation matrix, half-pixel centers with
    edge clamping (``preprocess.py:97``)."""
    m = np.zeros((dst, src), dtype=np.float32)
    scale = src / dst
    for d in range(dst):
        x = (d + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        frac = x - x0
        lo = min(max(x0, 0), src - 1)
        hi = min(max(x0 + 1, 0), src - 1)
        m[d, lo] += 1.0 - frac
        m[d, hi] += frac
    return m


@functools.lru_cache(maxsize=64)
def _pad_matrix(src: int, new: int, pad_before: int, total: int):
    """(total, src) interp matrix with zero rows outside the letterboxed
    image, and the (total,) mask that is 1.0 on those pad rows (the
    row-interleaved form of ``_phase_matrices``, ``preprocess.py:416``)."""
    m = np.zeros((total, src), dtype=np.float32)
    m[pad_before: pad_before + new] = _interp_matrix(src, new)
    mask = np.ones((total,), dtype=np.float32)
    mask[pad_before: pad_before + new] = 0.0
    return m, mask


@functools.lru_cache(maxsize=64)
def _crop_matrix(src: int, new: int, crop_top: int) -> np.ndarray:
    """Interp matrix keeping rows ``crop_top..new-1`` only (the UFLD
    bottom crop folded into the resize, ``_phase_crop_matrix``,
    ``preprocess.py:436``)."""
    return _interp_matrix(src, new)[crop_top:]


def _halve(m: np.ndarray) -> np.ndarray:
    """Compose an interp matrix with the nearest-2x chroma upsample
    (``_halve_phase``, ``preprocess.py:744``): sampling ``repeat(p, 2)``
    equals sampling ``p`` with adjacent weight pairs summed."""
    return (m[:, 0::2] + m[:, 1::2]).astype(np.float32)


def _to_device(ah, aw, mix, off, bias, device):
    """One resize's matrices as f32 tensors on ``device``: the Y chain's
    (ah, aw), the UV chain's halved pair, the 3x3 mix, the source
    offsets, and the letterbox pad bias (or None)."""
    mats = [ah, aw, _halve(ah), _halve(aw), mix, off]
    out = [torch.as_tensor(np.ascontiguousarray(m, np.float32), device=device) for m in mats]
    out.append(None if bias is None else torch.as_tensor(bias.astype(np.float32), device=device))
    return tuple(out)


@functools.lru_cache(maxsize=16)
def _yolo_mats(src_h: int, src_w: int, geom: LetterboxGeometry, device: str):
    """Letterbox resize + 1/255 + BGR->RGB (``yolo_preprocess_planes_yuv``):
    pad rows/cols are zero in the matrices and take ``PAD_VALUE/255`` from
    the bias."""
    newh, neww = geom.new_shape
    padh, padw = geom.pad
    ah, mh = _pad_matrix(src_h, newh, padh, geom.dst_h)
    aw, mw = _pad_matrix(src_w, neww, padw, geom.dst_w)
    mask = mh[:, None] + mw[None, :] - mh[:, None] * mw[None, :]
    bias = (PAD_VALUE / 255.0) * mask
    return _to_device(ah, aw, _BT601_RGB / 255.0, _I420_OFF, bias, device)


@functools.lru_cache(maxsize=16)
def _ufld_mats(src_h: int, src_w: int, input_h: int, input_w: int, crop_ratio: float,
               device: str):
    """Resize + bottom crop + ImageNet normalization
    (``ufld_v2_preprocess_planes_yuv``): the mean rides the source-side
    offset through the mix inverse (``M·(off - base) = mean255``), std
    scales the mix rows."""
    resize_h = int(input_h / crop_ratio)
    ah = _crop_matrix(src_h, resize_h, resize_h - input_h)
    aw = _crop_matrix(src_w, input_w, 0)
    mean255 = np.asarray(IMAGENET_MEAN, np.float32) * 255.0
    std255 = np.asarray(IMAGENET_STD, np.float32) * 255.0
    off = _I420_OFF + np.linalg.solve(
        _BT601_RGB.astype(np.float64), mean255.astype(np.float64)
    ).astype(np.float32)
    return _to_device(ah, aw, _BT601_RGB / std255[:, None], off, None, device)


def _resize_yuv(yuv: torch.Tensor, src_h: int, src_w: int, mats, dtype):
    """(B, H*3/2, W) uint8 I420 -> (B, 3, h, w) ``dtype``: offsets on the
    source planes, the two resize dots per chain (Y full-res, UV half-res),
    then the folded 3x3 mix (+ letterbox pad value) at target size."""
    ah, aw, ah2, aw2, mix, off, bias = mats
    b = yuv.shape[0]
    h, w = src_h, src_w
    y = yuv[:, :h].float() - off[0]
    uv = yuv[:, h:].reshape(b, 2, h // 2, w // 2).float() - off[1:].view(1, 2, 1, 1)
    oy = torch.matmul(torch.matmul(ah, y), aw.t())  # (B, h', w')
    ouv = torch.matmul(torch.matmul(ah2, uv), aw2.t())  # (B, 2, h', w')
    planes = torch.cat([oy[:, None], ouv], dim=1)  # (B, 3 [Y,U,V], h', w')
    out = torch.einsum("dk,bkhw->bdhw", mix, planes)
    if bias is not None:
        out = out + bias
    return out.to(dtype).contiguous()


def _check_yuv(yuv: torch.Tensor, src_h: int, src_w: int) -> None:
    if yuv.dtype != torch.uint8 or tuple(yuv.shape[1:]) != (src_h * 3 // 2, src_w):
        raise ValueError(
            f"expected (B, {src_h * 3 // 2}, {src_w}) uint8 I420, got "
            f"{tuple(yuv.shape)} {yuv.dtype}"
        )


def yolo_preprocess_yuv(
    yuv: torch.Tensor,
    src_h: int,
    src_w: int,
    geom: LetterboxGeometry,
    dtype=torch.float32,
) -> torch.Tensor:
    """I420 batch -> letterboxed RGB in [0, 1], NCHW (B, 3, dst_h, dst_w)
    (``yolo_preprocess_planes_yuv``, ``preprocess.py:805``)."""
    _check_yuv(yuv, src_h, src_w)
    mats = _yolo_mats(src_h, src_w, geom, str(yuv.device))
    return _resize_yuv(yuv, src_h, src_w, mats, dtype)


def ufld_v2_preprocess_yuv(
    yuv: torch.Tensor,
    src_h: int,
    src_w: int,
    input_h: int,
    input_w: int,
    crop_ratio: float,
    dtype=torch.float32,
) -> torch.Tensor:
    """I420 batch -> UFLDv2 input: resize to (input_w, input_h/crop_ratio),
    keep the bottom ``input_h`` rows, ImageNet-normalize; NCHW
    (``ufld_v2_preprocess_planes_yuv``, ``preprocess.py:830``)."""
    _check_yuv(yuv, src_h, src_w)
    mats = _ufld_mats(src_h, src_w, input_h, input_w, float(crop_ratio), str(yuv.device))
    return _resize_yuv(yuv, src_h, src_w, mats, dtype)


@functools.lru_cache(maxsize=64)
def _interp_on(src: int, dst: int, device: str) -> torch.Tensor:
    return torch.as_tensor(_interp_matrix(src, dst), device=device)


def resize_bilinear(img: torch.Tensor, dst_h: int, dst_w: int) -> torch.Tensor:
    """Exact bilinear resize of a (..., H, W, C) f32 image as two matmuls
    (``preprocess.py:117``)."""
    src_h, src_w = img.shape[-3], img.shape[-2]
    dev = str(img.device)
    ah = _interp_on(src_h, dst_h, dev)
    aw = _interp_on(src_w, dst_w, dev)
    out = torch.einsum("hs,...swc->...hwc", ah, img)
    return torch.einsum("wt,...htc->...hwc", aw, out)


def letterbox(frame: torch.Tensor, geom: LetterboxGeometry, pad_value: float = PAD_VALUE):
    """Resize keeping aspect, centre-pad to the target (``preprocess.py:143``):
    (..., H, W, 3) -> (..., dst_h, dst_w, 3) f32 in [0, 255]."""
    newh, neww = geom.new_shape
    padh, padw = geom.pad
    img = resize_bilinear(frame.float(), newh, neww)
    pads = (0, 0, padw, geom.dst_w - neww - padw, padh, geom.dst_h - newh - padh)
    return torch.nn.functional.pad(img, pads, value=pad_value)


def frame_to_device(frame: np.ndarray, device) -> torch.Tensor:
    """Upload one host frame (any layout, made contiguous) to ``device``."""
    return torch.from_numpy(np.ascontiguousarray(frame)).to(device)


def _bgr_frames(frame_bgr) -> torch.Tensor:
    """One (H, W, 3) or a batch (B, H, W, 3) of uint8 BGR frames as a
    batched tensor."""
    t = torch.as_tensor(frame_bgr)
    return t[None] if t.dim() == 3 else t


def yolo_preprocess(frame_bgr, geom: LetterboxGeometry, dtype=torch.float32, device="cuda"):
    """BGR uint8 frame(s) -> letterboxed RGB in [0, 1], NCHW
    (``preprocess.py:162``; the JAX one is NHWC)."""
    canvas = letterbox(_bgr_frames(frame_bgr).to(device), geom)
    rgb = canvas.flip(-1)
    return (rgb * (1.0 / 255.0)).to(dtype).permute(0, 3, 1, 2).contiguous()


def ufld_v2_preprocess(frame_bgr, input_h: int, input_w: int, crop_ratio: float,
                       dtype=torch.float32, device="cuda"):
    """BGR uint8 frame(s) -> UFLDv2 input: resize to (input_w,
    input_h/crop_ratio), keep the bottom ``input_h`` rows,
    ImageNet-normalize; NCHW (``preprocess.py:201``)."""
    resize_h = int(input_h / crop_ratio)
    img = resize_bilinear(_bgr_frames(frame_bgr).to(device).float(), resize_h, input_w)
    rgb = img[..., resize_h - input_h:, :, :].flip(-1)
    mean, std = _imagenet_stats(str(rgb.device))
    return ((rgb - mean.view(3)) / std.view(3)).to(dtype).permute(0, 3, 1, 2).contiguous()


def ufld_v1_preprocess(frame_bgr, input_h: int, input_w: int, dtype=torch.float32,
                       device="cuda"):
    """BGR uint8 frame(s) -> UFLD v1 input: plain resize to (input_w,
    input_h), ImageNet-normalize; NCHW (``preprocess.py:219``)."""
    img = resize_bilinear(_bgr_frames(frame_bgr).to(device).float(), input_h, input_w)
    mean, std = _imagenet_stats(str(img.device))
    return ((img.flip(-1) - mean.view(3)) / std.view(3)).to(dtype).permute(0, 3, 1, 2).contiguous()


def i420_to_bgr_planar(yuv: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, H*3/2, W) uint8 I420 -> (B, 3, H, W) f32 BGR planes in [0, 255]
    (``preprocess.py:297``): BT.601 studio swing with the nearest-2x
    chroma upsample, rounded half-to-even and clipped as cv2's uint8
    decode."""
    _check_yuv(yuv, height, width)
    b, h, w = yuv.shape[0], height, width
    y = yuv[:, :h].float()
    u = yuv[:, h: h + h // 4].reshape(b, h // 2, w // 2).float()
    v = yuv[:, h + h // 4:].reshape(b, h // 2, w // 2).float()

    def up2(p):
        return p.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)

    uu = up2(u) - 128.0
    vv = up2(v) - 128.0
    yy = 1.164 * (y - 16.0)
    r = yy + 1.596 * vv
    g = yy - 0.391 * uu - 0.813 * vv
    bl = yy + 2.018 * uu
    return torch.clamp(torch.round(torch.stack([bl, g, r], dim=1)), 0.0, 255.0)


def resize_bilinear_planar(img: torch.Tensor, dst_h: int, dst_w: int) -> torch.Tensor:
    """Bilinear resize of planar (..., C, H, W) f32 as two matmuls with the
    interpolation matrices (``preprocess.py:321``)."""
    dev = str(img.device)
    ah = _interp_on(img.shape[-2], dst_h, dev)
    aw = _interp_on(img.shape[-1], dst_w, dev)
    return torch.matmul(torch.matmul(ah, img), aw.t())


@functools.lru_cache(maxsize=16)
def _imagenet_stats(device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(3, 1, 1) RGB mean*255 and std*255, made once per device: the step
    copies nothing from the host."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device)[:, None, None]
    return mean * 255.0, std * 255.0


def _normalize(img: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) f32 BGR planes -> RGB, ImageNet-normalized
    ``(img - mean*255) / (std*255)`` per channel."""
    mean, std = _imagenet_stats(str(img.device))
    return ((img.flip(-3) - mean) / std).contiguous()


def imagenet_preprocess_planar(
    bgr_chw: torch.Tensor,
    geom: Optional[LetterboxGeometry],
) -> torch.Tensor:
    """(B, 3, H, W) BGR planes -> letterboxed (pad value 114, normalized
    with the image), RGB, ImageNet-normalized f32 NCHW (B, 3, dst_h, dst_w)
    (``preprocess.py:532``; the JAX one ends NHWC).  ``geom=None`` skips
    the letterbox."""
    img = bgr_chw.float()
    if geom is not None:
        newh, neww = geom.new_shape
        padh, padw = geom.pad
        img = resize_bilinear_planar(img, newh, neww)
        pads = (padw, geom.dst_w - neww - padw, padh, geom.dst_h - newh - padh)
        img = torch.nn.functional.pad(img, pads, value=PAD_VALUE)
    return _normalize(img)


def imagenet_preprocess(
    frame_bgr,
    geom: Optional[LetterboxGeometry] = None,
    device="cuda",
) -> torch.Tensor:
    """BGR uint8 frame(s) (H, W, 3) or (B, H, W, 3) -> (letterboxed) RGB,
    ImageNet-normalized f32 NCHW (``preprocess.py:176``; the JAX one is NHWC).
    It runs :func:`imagenet_preprocess_planar` on the frames' planes, so
    the single-frame and the batched I420 paths compute the same function
    in the same order."""
    planes = _bgr_frames(frame_bgr).to(device).permute(0, 3, 1, 2)
    return imagenet_preprocess_planar(planes, geom)


def yolo_preprocess_planar(bgr_chw: torch.Tensor, geom: LetterboxGeometry,
                           dtype=torch.float32) -> torch.Tensor:
    """(B, 3, H, W) BGR planes -> the YOLO input: letterboxed (pad 114/255),
    RGB, / 255, NCHW (``preprocess.py:500``, the non-s2d branch): the I420
    path of the YOLO nets without a planes stem."""
    newh, neww = geom.new_shape
    padh, padw = geom.pad
    img = resize_bilinear_planar(bgr_chw.float(), newh, neww).flip(-3)
    img = (img * (1.0 / 255.0)).to(dtype)
    pads = (padw, geom.dst_w - neww - padw, padh, geom.dst_h - newh - padh)
    return torch.nn.functional.pad(img, pads, value=PAD_VALUE / 255.0)


def ufld_v2_preprocess_planar(
    bgr_chw: torch.Tensor,
    input_h: int,
    input_w: int,
    crop_ratio: float,
    dtype=torch.float32,
) -> torch.Tensor:
    """(B, 3, H, W) BGR planes -> UFLDv2 input: resize to (input_w,
    input_h/crop_ratio), keep the bottom ``input_h`` rows, ImageNet-
    normalize; NCHW (``preprocess.py:585-593``, the non-s2d branch)."""
    resize_h = int(input_h / crop_ratio)
    img = resize_bilinear_planar(bgr_chw.float(), resize_h, input_w)
    return _normalize(img[..., resize_h - input_h:, :]).to(dtype)
