"""The ResNet-34 and ResNet-50 trunks (``Bottleneck``, ``_CONFIGS``,
``stage_channels``) and the config system in the port, against the JAX
package on the CPU.

UFLDv2 on each trunk, on the reduced CULane spec of ``test_torch_models``
(64x160 input, a 64-wide MLP), through one flax variable tree made from a
numpy seed and carried across by the weight bridge:

* f32: every output at ``test_torch_models``'s bound, rtol 1e-3 with an
  atol of 1e-3 of the output's largest magnitude (the two frameworks'
  convolutions sum in other orders);
* calibrated int8 (JAX calibrates on two inputs, the port loads its
  scales): each output within 3e-2 relative L2 of JAX's jitted int8 net,
  the bound of the int8 nets with a stem (``test_torch_int8_models``: JAX's
  int8 stem is an XLA bf16 conv, the port's the stem kernel's plain
  version), and the port's error against the f32 net within 1.25x of
  JAX's (ResNet-18's UFLDv2 is held at 1.1x; these trunks have twice its
  blocks, each a place where an s8 value one LSB apart moves what
  follows: 0.94-1.13x here).  At this input no block passes the fusion
  gate (>= 80x80 pixels);
  the fused ResNet-34 ``layer1`` is held on the card (``chip_smoke.py``
  ``[lane-res34]``).

The configs: each of the port's seven ``configs/ufldv2`` files, read by the
port's ``Config.fromfile``, gives JAX's dict for the same file, and is the
same file byte for byte; the lane facade serves a config's ``backbone``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adas_tpu.models import resnet as jresnet
from adas_tpu.models.ufld import UFLDv2Net as JaxUFLDv2Net
from adas_tpu.models.ufld import UFLDv2Spec as JaxUFLDv2Spec
from adas_tpu.tools.params_io import unflatten_variables
from adas_tpu.utils.config import Config as JaxConfig
from adas_tpu_torch.models import resnet
from adas_tpu_torch.models import ufld as port_ufld
from adas_tpu_torch.models.ufld import UFLDv2Net, UFLDv2Spec
from adas_tpu_torch.perception.lane_detector import UltrafastLaneDetectorV2
from adas_tpu_torch.utils.config import CONFIG_DIR, Config
from adas_tpu_torch.weights import init_params, load_flax_variables
from test_torch_int8_models import _calibrated, _port, _serve_jax, rel_err
from test_torch_models import SPEC_ARGS, random_flax_weights

JAX_CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "adas_tpu", "configs", "ufldv2")
CONFIGS = sorted(n for n in os.listdir(JAX_CONFIG_DIR) if n.endswith(".py"))


def _inputs(seed):
    x = np.random.default_rng(seed).standard_normal((2, 64, 160, 3)).astype(np.float32)
    return x, torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


@pytest.mark.parametrize("depth", ["34", "50"])
def test_stage_channels_match_jax(depth):
    assert tuple(resnet.stage_channels(depth)) == tuple(jresnet.ResNetFeatures.stage_channels(depth))
    net = UFLDv2Net(UFLDv2Spec(**SPEC_ARGS, backbone=depth))
    assert net.pool.in_channels == resnet.stage_channels(depth)[-1]
    blocks = [m for m in net.backbone.modules()
              if isinstance(m, (resnet.BasicBlock, resnet.Bottleneck))]
    assert len(blocks) == 16 and all(
        isinstance(b, resnet.Bottleneck if depth == "50" else resnet.BasicBlock) for b in blocks)


@pytest.mark.parametrize("depth", ["34", "50"])
def test_ufld_v2_f32_matches_jax(depth):
    jnet = JaxUFLDv2Net(JaxUFLDv2Spec(**SPEC_ARGS, backbone=depth))
    flat = random_flax_weights(jnet, (1, 64, 160, 3), seed=int(depth))
    x, px = _inputs(int(depth))
    want = jax.jit(jnet.apply)(jax.tree_util.tree_map(jnp.asarray, unflatten_variables(flat)),
                               jnp.asarray(x))
    net = UFLDv2Net(UFLDv2Spec(**SPEC_ARGS, backbone=depth)).eval()
    load_flax_variables(net, flat)
    with torch.no_grad():
        got = net(px)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-3, atol=1e-3 * np.abs(w).max())


@pytest.mark.parametrize("depth", ["34", "50"])
def test_ufld_v2_int8_close_to_jax(depth):
    net = JaxUFLDv2Net(JaxUFLDv2Spec(**SPEC_ARGS, backbone=depth))
    x, px = _inputs(10 + int(depth))
    cal, flat = _calibrated(net, (1, 64, 160, 3), [jnp.asarray(x[:1]), jnp.asarray(x[1:])],
                            seed=20 + int(depth))
    want = _serve_jax(net, cal, jnp.asarray(x, jnp.bfloat16), jit=True)
    port = _port(UFLDv2Net(UFLDv2Spec(**SPEC_ARGS, backbone=depth), int8=True), flat)
    with torch.no_grad():
        got = port(px.to(torch.bfloat16))
    f32 = net.apply({k: cal[k] for k in ("params", "batch_stats")}, jnp.asarray(x))
    for k in want:
        assert rel_err(got[k], want[k]) < 3e-2
        assert rel_err(got[k], f32[k]) < 1.25 * rel_err(want[k], f32[k])


@pytest.mark.parametrize("name", CONFIGS)
def test_config_matches_jax(name):
    port_path = os.path.join(CONFIG_DIR, name)
    with open(port_path, "rb") as f, open(os.path.join(JAX_CONFIG_DIR, name), "rb") as g:
        assert f.read() == g.read()
    got = Config.fromfile(port_path)
    assert got.to_dict() == JaxConfig.fromfile(os.path.join(JAX_CONFIG_DIR, name)).to_dict()
    assert got.filename == port_path and "_base_" not in got
    if name.endswith("res34.py"):
        assert got.backbone == "34" and got.optimizer == "SGD"


def test_config_merge_and_delete_match_jax(tmp_path):
    (tmp_path / "base.py").write_text("model = dict(depth=18, head=dict(w=1, b=2))\nlr = 0.1\n")
    (tmp_path / "child.py").write_text(
        "_base_ = './base.py'\nmodel = dict(head=dict(_delete_=True, w=3))\nlr = 0.2\n")
    got, want = Config.fromfile(str(tmp_path / "child.py")), JaxConfig.fromfile(
        str(tmp_path / "child.py"))
    assert got.to_dict() == want.to_dict() == {"model": {"depth": 18, "head": {"w": 3}},
                                               "lr": 0.2}
    for cfg in (got, want):
        cfg.merge_from_dict({"model.depth": 34, "model.head.b": 4})
    assert got.to_dict() == want.to_dict() and got.model.head.b == 4


def test_facade_serves_a_config_backbone(monkeypatch):
    """``UltrafastLaneDetectorV2(backbone=...)`` takes a config's trunk on
    the model type's geometry (here the reduced CULane spec) and serves
    frames with it."""
    monkeypatch.setitem(port_ufld.UFLDV2_SPECS, port_ufld.LaneModelType.UFLDV2_CULANE,
                        UFLDv2Spec(**SPEC_ARGS))
    cfg = Config.fromfile(os.path.join(CONFIG_DIR, "culane_res34.py"))
    lane = UltrafastLaneDetectorV2(backbone=cfg.backbone, device="cpu", seed=3)
    assert lane.spec == UFLDv2Spec(**SPEC_ARGS, backbone="34")
    assert len([m for m in lane.net.modules() if isinstance(m, resnet.BasicBlock)]) == 16
    lane.DetectFrame(np.random.default_rng(3).integers(0, 256, (90, 160, 3), dtype=np.uint8))
    assert len(lane.lane_info.lanes_status) == 4


def test_stem_fold_follows_new_weights():
    """The stem's folded BN is cached on its module; a new seeded init
    drops it, so the stem runs on the new weights."""
    x = torch.from_numpy(_inputs(7)[1][:1].numpy())
    net = UFLDv2Net(UFLDv2Spec(**SPEC_ARGS, backbone="34")).eval()
    init_params(net, 1)
    net.backbone.bn1.running_var.uniform_(0.5, 2.0)  # a fold unlike the init's
    fresh = UFLDv2Net(UFLDv2Spec(**SPEC_ARGS, backbone="34")).eval()
    init_params(fresh, 2)
    with torch.no_grad():
        net(x)
        init_params(net, 2)
        got, want = net(x), fresh(x)
    for k in want:
        assert torch.equal(got[k], want[k])
