"""The port's YOLOv5-lite e/s/g (``adas_tpu_torch/models/yolov5lite.py``)
and its grid decode against the JAX package's, on the CPU: the nets in f32
(s, g; e shares s's blocks) and bf16 (s), the facade's ``DetectFrame``
and ``FusedADASStep`` on I420, in calibrated int8 (s: the 58/116-wide
ShuffleNet halves; g: the RepVGG trunk's tap emissions) the packer,
calibrator, weight bridge and net at 64x64
(``tests/test_torch_family_checks.py``), and ``v5lite_grid_decode`` on
the inputs of ``tests/test_yolo.py``'s oracle test."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adas_tpu.ops.yolo_decode import v5lite_grid_decode as jax_grid_decode
from adas_tpu_torch.ops.yolo_decode import v5lite_grid_decode
from test_torch_family_checks import (
    check_bf16,
    check_detect_frame,
    check_f32,
    check_fused_step,
    check_int8,
)


@pytest.mark.parametrize("scale", ["s", "g"])
def test_v5lite_matches_jax(scale):
    check_f32("v5lite", scale, (64, 64))


def test_v5lite_bf16_matches_jax():
    check_bf16("v5lite", "s", (64, 64))


@pytest.mark.parametrize("scale", ["s", "g"])
def test_v5lite_int8_matches_jax(scale, tmp_path):
    """Packer, calibrator, bridge and the net
    (``test_torch_family_checks.check_int8``), the calibrated scales within
    rtol 3e-2 (``test_torch_int8_weights``' bound for its most sensitive
    leaf): every ShuffleNet unit quantizes its bf16 input at a dynamic
    scale while calibrating, and the two frameworks' bf16 roundings
    compound along the trunk; the largest gap was 2.5%
    (``backbone.stage0_2.b2_pw1``'s input), the next 2.2% (on the CPU, jax 0.9.0, torch 2.13.0)."""
    assert check_int8("v5lite", scale, tmp_path, rtol=3e-2)[0] > 20


def test_v5lite_detect_frame_matches_jax(tmp_path):
    check_detect_frame("v5lite", "s", tmp_path)


def test_v5lite_fused_step_matches_jax(tmp_path, monkeypatch):
    """``FusedADASStep`` on I420: a YOLO without a planes stem (every family
    but v8 and v10) is fed from the decoded BGR planes, as JAX feeds it;
    the route is the same for v5, v6, v7 and v9."""
    check_fused_step("v5lite", "s", tmp_path, monkeypatch, "i420")


@pytest.mark.parametrize("hw", [(32, 32), (64, 96)])
def test_v5lite_grid_decode_matches_jax(hw):
    """``tests/test_yolo.py:80-90``'s inputs (32x32, uniform rows of 6),
    and a wider 64x96 batch of two with 85-wide rows; equal to JAX's."""
    n = sum(3 * (hw[0] // s) * (hw[1] // s) for s in (8, 16, 32))
    rng = np.random.default_rng(3)
    if hw == (32, 32):
        out = rng.uniform(0.0, 1.0, (1, n, 6)).astype(np.float32)
    else:
        out = rng.uniform(0.0, 1.0, (2, n, 85)).astype(np.float32)
    got = v5lite_grid_decode(torch.from_numpy(out), hw).numpy()
    for i in range(out.shape[0]):
        want = np.asarray(jax_grid_decode(jnp.asarray(out[i]), hw))
        np.testing.assert_allclose(got[i], want, rtol=1e-6, atol=1e-5)
