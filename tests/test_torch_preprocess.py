"""Port's serving preprocess (adas_tpu_torch/ops/preprocess.py) against
cv2, the JAX YUV-direct emission and the JAX BGR-plane chain of the
EfficientDet path.

The JAX side emits S2DPlanes (polyphase planes with halo margins); the
test strips the margins and undoes the polyphase layout, as
``tests/test_pallas_stem.py::_planes_from_nhwc`` builds it, and compares
with the port's NCHW tensor in f32 at atol 1e-4.
"""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adas_tpu.ops.pallas_stem import stem_margins
from adas_tpu.ops import preprocess as J
from adas_tpu.ops.preprocess import LetterboxGeometry as JaxGeometry
from adas_tpu.ops.preprocess import (
    ufld_v2_preprocess_planes_yuv,
    yolo_preprocess_planes_yuv,
)
from adas_tpu_torch.ops.preprocess import (
    LetterboxGeometry,
    bgr_to_i420,
    i420_to_bgr_planar,
    imagenet_preprocess,
    imagenet_preprocess_planar,
    ufld_v2_preprocess_planar,
    ufld_v2_preprocess_yuv,
    yolo_preprocess_yuv,
)


def _planes_to_nchw(planes):
    """S2DPlanes (1, hs+m, 12, ws+m) -> (3, 2hs, 2ws) NCHW."""
    (mt, _), (ml, _) = planes.margins
    _, h, w, c = planes.shape
    hs, ws = h // 2, w // 2
    core = np.asarray(planes.data)[0, mt: mt + hs, :, ml: ml + ws]  # (i, rtc, j)
    core = core.reshape(hs, 2, 2, c, ws)  # i r t c j
    return core.transpose(3, 0, 1, 4, 2).reshape(c, h, w)


def _frames(n, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("hw", [(36, 64), (180, 320), (720, 1280)])
def test_i420_encoder_matches_cv2(hw):
    for frame in _frames(2, *hw, seed=hw[0]):
        want = cv2.cvtColor(frame, cv2.COLOR_BGR2YUV_I420)
        got = bgr_to_i420(frame)
        assert got.shape == want.shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_letterbox_geometry_keeps_plus_one_quirk():
    g = LetterboxGeometry(720, 1280, 640, 640)
    assert g.new_shape == (361, 640) and g.pad == (139, 0)
    j = JaxGeometry(720, 1280, 640, 640)
    assert (g.new_shape, g.pad, g.scale_ratio) == (j.new_shape, j.pad, j.scale_ratio)
    boxes = np.array([[10.0, 150.0, 300.0, 400.0]], np.float32)
    np.testing.assert_allclose(
        g.boxes_to_original(torch.from_numpy(boxes)).numpy(),
        j.boxes_to_original(boxes), rtol=1e-6,
    )


@pytest.mark.parametrize(
    "src_hw,dst_hw", [((180, 320), (160, 160)), ((720, 1280), (640, 640))]
)
def test_yolo_yuv_matches_jax(src_hw, dst_hw):
    h, w = src_hw
    yuv = np.stack([bgr_to_i420(f) for f in _frames(2, h, w, seed=1)])
    got = yolo_preprocess_yuv(
        torch.from_numpy(yuv), h, w, LetterboxGeometry(h, w, *dst_hw)
    ).numpy()
    assert got.shape == (2, 3, *dst_hw)
    for i in range(2):
        planes = yolo_preprocess_planes_yuv(
            jnp.asarray(yuv[i]), h, w, JaxGeometry(h, w, *dst_hw),
            margins=stem_margins(3, 3, False),
        )
        np.testing.assert_allclose(got[i], _planes_to_nchw(planes), atol=1e-4)


@pytest.mark.parametrize(
    "src_hw,in_hw", [((180, 320), (64, 160)), ((720, 1280), (320, 1600))]
)
def test_ufld_yuv_matches_jax(src_hw, in_hw):
    h, w = src_hw
    yuv = np.stack([bgr_to_i420(f) for f in _frames(2, h, w, seed=2)])
    got = ufld_v2_preprocess_yuv(torch.from_numpy(yuv), h, w, *in_hw, 0.6).numpy()
    assert got.shape == (2, 3, *in_hw)
    for i in range(2):
        planes = ufld_v2_preprocess_planes_yuv(
            jnp.asarray(yuv[i]), h, w, *in_hw, 0.6,
            margins=stem_margins(7, 7, True),
        )
        np.testing.assert_allclose(got[i], _planes_to_nchw(planes), atol=1e-4)


def test_yuv_bf16_is_the_f32_result_rounded():
    h, w = 180, 320
    yuv = torch.from_numpy(np.stack([bgr_to_i420(f) for f in _frames(1, h, w, seed=3)]))
    geom = LetterboxGeometry(h, w, 160, 160)
    f32 = yolo_preprocess_yuv(yuv, h, w, geom)
    bf16 = yolo_preprocess_yuv(yuv, h, w, geom, dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))


def test_yuv_rejects_wrong_buffer():
    with pytest.raises(ValueError, match="I420"):
        yolo_preprocess_yuv(
            torch.zeros(1, 180, 320, dtype=torch.uint8), 180, 320,
            LetterboxGeometry(180, 320, 160, 160),
        )


def _bgr_planes(h, w, seed):
    """Two frames through the I420 transport: the uint8 buffers, and the
    port's and eager JAX's (2, 3, H, W) BGR planes."""
    yuv = np.stack([bgr_to_i420(f) for f in _frames(2, h, w, seed=seed)])
    want = np.stack([np.asarray(J.i420_to_bgr_planar(jnp.asarray(y), h, w)) for y in yuv])
    return yuv, want


@pytest.mark.parametrize("hw", [(180, 320), (720, 1280)])
def test_i420_to_bgr_planar_matches_jax_exactly(hw):
    """The rounded, clipped BT.601 decode equals eager JAX to the bit
    (``torch.round`` and ``jnp.round`` both round half to even)."""
    yuv, want = _bgr_planes(*hw, seed=4)
    got = i420_to_bgr_planar(torch.from_numpy(yuv), *hw)
    assert got.shape == (2, 3, *hw) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("src_hw,size", [((180, 320), 128), ((720, 1280), 512)])
def test_imagenet_planar_matches_jax(src_hw, size):
    """Letterbox (pad normalized with the image) + RGB ImageNet normalize,
    NCHW here and NHWC in JAX; the resize matmuls sum in another order."""
    _, planes = _bgr_planes(*src_hw, seed=5)
    geom = LetterboxGeometry(*src_hw, size, size)
    got = imagenet_preprocess_planar(torch.from_numpy(planes), geom)
    jgeom = JaxGeometry(*src_hw, size, size)
    want = np.asarray(J.imagenet_preprocess_planar(jnp.asarray(planes), jgeom))
    assert got.shape == (2, 3, size, size)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5)


def test_ufld_planar_matches_jax():
    _, planes = _bgr_planes(180, 320, seed=6)
    got = ufld_v2_preprocess_planar(torch.from_numpy(planes), 64, 160, 0.6)
    want = np.asarray(J.ufld_v2_preprocess_planar(jnp.asarray(planes), 64, 160, 0.6))
    assert got.shape == (2, 3, 64, 160)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5)


def test_imagenet_preprocess_of_frames_matches_jax():
    """The single-frame (``DetectFrame``) preprocess from BGR uint8."""
    frames = _frames(2, 180, 320, seed=7)
    got = imagenet_preprocess(frames, LetterboxGeometry(180, 320, 128, 128), device="cpu")
    want = np.asarray(J.imagenet_preprocess(jnp.asarray(frames), JaxGeometry(180, 320, 128, 128)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5)
