"""The port's YOLOv9 GELAN-C (``adas_tpu_torch/models/yolov9.py``) against
the JAX package's, on the CPU: the net in f32, the facade's
``DetectFrame``, and in calibrated int8 the packer, calibrator, weight
bridge and net at 64x64 (checks and bounds in
``tests/test_torch_family_checks.py``)."""
from test_torch_family_checks import check_detect_frame, check_f32, check_int8


def test_v9_matches_jax():
    check_f32("v9", "c", (64, 64))


def test_v9_int8_matches_jax(tmp_path):
    """Packer, calibrator, bridge and the net
    (``test_torch_family_checks.check_int8``):
    RepNCSP / RepNCSPELAN4 / SPPELAN groups, ADown's block-local group and
    its bf16 average pool, the neck groups A and B, RepConvN's two int8
    convs summed."""
    n, flat = check_int8("v9", "c", tmp_path)
    assert n > 100
    assert "act_scales::neck_a_xmax" in flat and "act_scales::down2::concat_xmax" in flat


def test_v9_detect_frame_matches_jax(tmp_path):
    check_detect_frame("v9", "c", tmp_path)
