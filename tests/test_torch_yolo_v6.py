"""The port's YOLOv6 n/s/m/l (``adas_tpu_torch/models/yolov6.py``) against
the JAX package's, on the CPU: the nets in f32 in the training form (m)
and in the deploy form (s), RepVGG's fuse at load against
``fuse_repvgg_variables`` (n, m), bf16 of the deploy form (n), the
facade's ``DetectFrame``, and in calibrated int8 the packer, calibrator,
weight bridge and net (n, m; ``tests/test_torch_family_checks.py``).

v6 m/l in calibrated int8: the JAX BottleRep multiplies an s8 ``QTensor``
by ``alpha`` and raises (``adas_tpu/models/yolov6.py:154-157``); the port
adds the bf16 view.  Its test shows the JAX error, then holds the port's
calibrated v6m to JAX's net with that one change patched in for the
test (``test_torch_family_checks._dequant_bottlerep``) at the int8
bound; the packer, the calibrator (JAX calibrates in bf16, with nothing
s8) and the bridge are held to JAX's as for n.

The calibrated scales are held within rtol 5e-2: v6 is a chain of ~45
(n) to ~90 (m) convs, each quantizing its input at its own dynamic scale
while calibrating, and the two frameworks' bf16 roundings compound along
it: the neck's last absmaxes of n came out up to 3.9% apart (a few bf16
steps), its trunk's within 1% (on the CPU, jax 0.9.0, torch 2.13.0).
"""
import pytest
import torch

from adas_tpu.models.yolov6 import fuse_repvgg_variables
from adas_tpu.tools.params_io import flatten_variables, unflatten_variables
from adas_tpu_torch.models.yolov6 import fuse_repvgg
from adas_tpu_torch.weights import load_flax_variables, state_dict_from_flax
from test_torch_family_checks import (
    check_bf16,
    check_detect_frame,
    check_f32,
    check_int8,
    nets,
    tree_for,
)


@pytest.mark.parametrize("scale,fused", [("m", False), ("s", True)])
def test_v6_matches_jax(scale, fused):
    check_f32("v6", scale, (64, 64), fused=fused)


@pytest.mark.parametrize("scale", ["n", "m"])
def test_v6_fuse_matches_jax(scale):
    """``fuse_repvgg`` (every RepVGG block, the identity branches and m's
    BottleRep ``alpha`` included) gives the state of JAX's fused tree to
    the bit, key for key."""
    jnet, net = nets("v6", scale, (64, 64))
    flat = tree_for(jnet, "v6", (64, 64), 4)
    load_flax_variables(net, flat)
    fuse_repvgg(net)
    want = state_dict_from_flax(flatten_variables(fuse_repvgg_variables(unflatten_variables(flat))))
    got = {k: v for k, v in net.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(got) == set(want) and any(".fused." in k for k in got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_v6_bf16_matches_jax():
    check_bf16("v6", "n", (64, 64))


def test_v6_int8_matches_jax(tmp_path):
    assert check_int8("v6", "n", tmp_path, rtol=5e-2)[0] > 20


def test_v6_m_int8_runs_where_jax_raises(tmp_path):
    """v6m calibrated: JAX raises (module docstring); the port serves, and
    gives the output of JAX's net with the bf16 view patched in."""
    assert check_int8("v6", "m", tmp_path, hw=(32, 32), rtol=5e-2, jax_serves=False)[0] > 50


def test_v6_detect_frame_matches_jax(tmp_path):
    check_detect_frame("v6", "n", tmp_path)
