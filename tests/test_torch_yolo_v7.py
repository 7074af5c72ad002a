"""The port's YOLOv7 base graph (``adas_tpu_torch/models/yolov7.py``)
against the JAX package's, on the CPU: the net in f32, the facade's
``DetectFrame``, and in calibrated int8 (every concat an s8 group) the
packer, calibrator, weight bridge and net at 64x64
(``tests/test_torch_family_checks.py``)."""
from adas_tpu_torch.models.yolov7 import GROUPS
from test_torch_family_checks import check_detect_frame, check_f32, check_int8


def test_v7_matches_jax():
    check_f32("v7", "n", (64, 64))


def test_v7_int8_matches_jax(tmp_path):
    """Packer, calibrator, bridge and the net: every concat an s8 group,
    the graph's 15 owned by the net, SPPCSPC's two by ``m51``; 92 convs
    (stem 4, ELAN 4 x 7, MP 5 x 3, SPPCSPC 7, laterals 4, ELAN-W 4 x 7,
    RepConv 3 x 2) int8 but the 3-channel stem."""
    n, flat = check_int8("v7", "n", tmp_path)
    assert n == 91
    names = {k.split("::")[-1] for k in flat if k.count("::") == 1 and k.startswith("act_scales")}
    assert names == set(GROUPS)
    assert "act_scales::m51::spp_xmax" in flat and "act_scales::m51::csp_xmax" in flat


def test_v7_detect_frame_matches_jax(tmp_path):
    check_detect_frame("v7", "n", tmp_path)
