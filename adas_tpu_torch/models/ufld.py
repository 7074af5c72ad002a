"""Ultra-Fast-Lane-Detection v1 and v2 (port of ``UFLDv2Spec``,
``UFLDV2_SPECS``, ``UFLDv2Net``, ``UFLDv1Spec``, ``UFLDV1_SPECS`` and
``UFLDv1Net`` from ``adas_tpu/models/ufld.py:32-354``: v2 on CULane,
TuSimple and CurveLanes, v1 on TuSimple and CULane, and the 20-token
``UFLDv2CurveLanesNet`` (``ufld.py:224``, f32; reached through
``engine/registry.py`` only, as in JAX); the training-only aux
segmentation head ``SegHead`` (``use_aux``) and the 5-way shifted-feature
test-time augmentation (``forward(x, tta=True)``)).

The trunk is ``spec.backbone`` (ResNet-18, 34 or 50); the ``pool`` conv
takes its last stage's width (``stage_channels``, as flax infers it).
``int8=True``: the int8 ResNet trunk (NHWC), the ``pool`` 1x1 conv in f32
on its bf16 output, and ``cls_fc1``/``cls_fc2`` as W8A8 dense layers
(``Int8Dense`` through ``head_dense``, ``ufld.py:179-202``); v2 serves it
calibrated or not, v1 uncalibrated (dynamic scales, one per image:
``adas_tpu/perception/lane_detector.py:379-388``)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.types import LaneModelType

from .layers import BN_EPS, BatchNorm2d
from .quant import QLinear
from .resnet import ResNetFeatures, stage_channels


@dataclass(frozen=True)
class UFLDv2Spec:
    """Static geometry of a UFLDv2 variant (``ufld.py:32``)."""

    input_height: int
    input_width: int
    crop_ratio: float
    num_cell_row: int  # griding cells along x for row anchors
    num_row: int  # row anchors
    num_cell_col: int  # griding cells along y for column anchors
    num_col: int  # column anchors
    num_lanes: int = 4
    fc_norm: bool = True
    backbone: str = "18"
    mlp_mid: int = 2048
    img_w: int = 1600
    img_h: int = 320

    @property
    def row_anchor(self) -> np.ndarray:
        if self.num_row == 56:  # tusimple
            return np.linspace(160, 710, 56) / 720
        if self.input_height == 800:  # curvelanes
            return np.linspace(0.4, 1, 72)
        return np.linspace(0.42, 1, 72)  # culane

    @property
    def col_anchor(self) -> np.ndarray:
        return np.linspace(0, 1, self.num_col)

    @property
    def dims(self) -> Tuple[int, int, int, int]:
        d1 = self.num_cell_row * self.num_row * self.num_lanes
        d2 = self.num_cell_col * self.num_col * self.num_lanes
        d3 = 2 * self.num_row * self.num_lanes
        d4 = 2 * self.num_col * self.num_lanes
        return d1, d2, d3, d4

    @property
    def flat_features(self) -> int:
        return 8 * (self.input_height // 32) * (self.input_width // 32)


UFLDV2_SPECS: Dict[LaneModelType, UFLDv2Spec] = {
    LaneModelType.UFLDV2_CULANE: UFLDv2Spec(
        input_height=320, input_width=1600, crop_ratio=0.6,
        num_cell_row=200, num_row=72, num_cell_col=100, num_col=81,
        fc_norm=True, img_w=1600, img_h=320,
    ),
    LaneModelType.UFLDV2_TUSIMPLE: UFLDv2Spec(
        input_height=320, input_width=800, crop_ratio=0.8,
        num_cell_row=100, num_row=56, num_cell_col=100, num_col=41,
        fc_norm=False, img_w=800, img_h=320,
    ),
    LaneModelType.UFLDV2_CURVELANES: UFLDv2Spec(
        input_height=800, input_width=1600, crop_ratio=0.8,
        num_cell_row=200, num_row=72, num_cell_col=100, num_col=41,
        fc_norm=True, img_w=1600, img_h=800,
    ),
}


def pooled_map(fea: torch.Tensor, pool: nn.Conv2d, int8: bool) -> torch.Tensor:
    """The trunk's stride-32 map through the 1x1 ``pool`` conv, NCHW: the
    (c, h, w) element order the JAX nets reach by transposing their NHWC
    map before they flatten it (``ufld.py:191-194``).  Under int8 the map
    is NHWC bf16 and the conv f32 (flax promotes to its f32 params)."""
    if int8:
        w = pool.weight.reshape(pool.out_channels, -1)
        return F.linear(fea.float(), w, pool.bias).permute(0, 3, 1, 2)
    return pool(fea)


def tta_shifts(fea: torch.Tensor) -> torch.Tensor:
    """The 5-way test-time augmentation of an NCHW map (``ufld.py:182-190``,
    the reference's model_culane.py:65-96): the map, then shifted left,
    right, up and down, the vacated border column or row filled with the
    mean along that axis; stacked on the batch dim (5B)."""
    w_mean = fea.mean(dim=3, keepdim=True)
    h_mean = fea.mean(dim=2, keepdim=True)
    left = torch.cat([fea[..., 1:], w_mean], dim=3)
    right = torch.cat([w_mean, fea[..., :-1]], dim=3)
    up = torch.cat([fea[:, :, 1:], h_mean], dim=2)
    down = torch.cat([h_mean, fea[:, :, :-1]], dim=2)
    return torch.cat([fea, left, right, up, down], dim=0)


def head_mlp(net: nn.Module, fea: torch.Tensor) -> torch.Tensor:
    """The head's MLP, ``cls_fc2(relu(cls_fc1(fea)))``, or the module that
    ``net`` holds as ``mlp`` in place of the pair (a placement that splits
    the pair over devices sets one)."""
    mlp = net._modules.get("mlp")
    if mlp is not None:
        return mlp(fea)
    return net.cls_fc2(F.relu(net.cls_fc1(fea)))


class SegHead(nn.Module):
    """UFLDv2's training-only aux segmentation head (``ufld.py:91-134``,
    the reference's seg_model.py:16-55): conv3x3 + BN + ReLU stacks over
    the stride-8, 16 and 32 maps (4, 3 and 2 of 128 features), the last two
    upsampled bilinearly x2 and x4 to stride 8 (``jax.image.resize``'s
    half-pixel bilinear, which is ``F.interpolate``'s with
    ``align_corners=False`` when enlarging), concatenated, four dilated
    stacks (256, 128, 128, 128 features; dilation 2, 2, 2, 4) and the 1x1
    ``comb4`` with a bias to ``num_lanes + 1`` logits, NCHW.  Module names
    are the flax tree's (``aux2_0_conv``, ``aux2_0_bn``, ...)."""

    def __init__(self, num_lanes: int, channels: Tuple[int, int, int]):
        super().__init__()
        for tap, cin, n in (("aux2", channels[0], 4), ("aux3", channels[1], 3),
                            ("aux4", channels[2], 2)):
            for i in range(n):
                self._cbr(f"{tap}_{i}", cin, 128, 1)
                cin = 128
        cin = 3 * 128
        for i, (features, dilation) in enumerate(((256, 2), (128, 2), (128, 2), (128, 4))):
            self._cbr(f"comb{i}", cin, features, dilation)
            cin = features
        self.comb4 = nn.Conv2d(cin, num_lanes + 1, 1)

    def _cbr(self, name: str, cin: int, features: int, dilation: int) -> None:
        self.add_module(name + "_conv", nn.Conv2d(cin, features, 3, padding=dilation,
                                                  dilation=dilation, bias=False))
        self.add_module(name + "_bn", BatchNorm2d(features, eps=BN_EPS))

    def _stack(self, x: torch.Tensor, prefix: str, n: int) -> torch.Tensor:
        for i in range(n):
            name = f"{prefix}{i}"
            x = F.relu(getattr(self, name + "_bn")(getattr(self, name + "_conv")(x)))
        return x

    def forward(self, x2: torch.Tensor, x3: torch.Tensor, fea: torch.Tensor) -> torch.Tensor:
        h2 = self._stack(x2, "aux2_", 4)
        h3 = F.interpolate(self._stack(x3, "aux3_", 3), scale_factor=2, mode="bilinear",
                           align_corners=False)
        h4 = F.interpolate(self._stack(fea, "aux4_", 2), scale_factor=4, mode="bilinear",
                           align_corners=False)
        seg = self._stack(torch.cat([h2, h3, h4], dim=1), "comb", 4)
        return self.comb4(seg)


class UFLDv2Net(nn.Module):
    """ResNet trunk -> 1x1 conv to 8 channels -> flatten -> [LayerNorm] ->
    MLP -> loc_row/loc_col/exist_row/exist_col (``ufld.py:137``).
    ``use_aux`` adds :class:`SegHead` on the trunk's three maps, whose
    logits come out as ``seg_out`` (B, lanes + 1, H/8, W/8); it trains
    (``parallel/train.py``) and is not an int8 net's.  ``forward(x,
    tta=True)`` runs :func:`tta_shifts` on the pooled map: every head
    output then has 5B rows (``seg_out`` keeps B)."""

    def __init__(self, spec: UFLDv2Spec, int8: bool = False, use_aux: bool = False):
        super().__init__()
        if int8 and use_aux:
            raise ValueError("the aux head trains with the f32 net; an int8 net serves")
        self.spec = spec
        self.int8 = int8
        self.use_aux = use_aux
        self.backbone = ResNetFeatures(spec.backbone, int8=int8)
        if use_aux:
            self.seg_head = SegHead(spec.num_lanes, stage_channels(spec.backbone)[1:])
        self.pool = nn.Conv2d(stage_channels(spec.backbone)[-1], 8, 1)
        if spec.fc_norm:
            # flax nn.LayerNorm's epsilon
            self.cls_norm = nn.LayerNorm(spec.flat_features, eps=1e-6)
        dense = QLinear if int8 else nn.Linear
        self.cls_fc1 = dense(spec.flat_features, spec.mlp_mid)
        self.cls_fc2 = dense(spec.mlp_mid, sum(spec.dims))

    def forward(self, x: torch.Tensor, tta: bool = False) -> Dict[str, torch.Tensor]:
        s = self.spec
        x2, x3, fea = self.backbone(x)
        seg_out = self.seg_head(x2, x3, fea) if self.use_aux else None
        fea = pooled_map(fea, self.pool, self.int8)
        if tta:
            fea = tta_shifts(fea)
        fea = fea.flatten(1)
        if s.fc_norm:
            fea = self.cls_norm(fea)
        out = head_mlp(self, fea)
        b = out.shape[0]
        d1, d2, d3, _ = s.dims
        result = {
            "loc_row": out[:, :d1].reshape(b, s.num_cell_row, s.num_row, s.num_lanes),
            "loc_col": out[:, d1: d1 + d2].reshape(b, s.num_cell_col, s.num_col, s.num_lanes),
            "exist_row": out[:, d1 + d2: d1 + d2 + d3].reshape(b, 2, s.num_row, s.num_lanes),
            "exist_col": out[:, d1 + d2 + d3:].reshape(b, 2, s.num_col, s.num_lanes),
        }
        if seg_out is not None:
            result["seg_out"] = seg_out
        return result


class UFLDv2CurveLanesNet(nn.Module):
    """UFLDv2's CurveLanes head (``ufld.py:224``, the reference's
    model_curvelanes.py): ``cls_distribute`` (two 3x3 convs) makes 20
    lane-token maps; each token's map joins the 8-channel ``pool`` map, so
    each of the 20 rows is a 9 x (H/32) x (W/32) feature (torch's
    channel-major order) through the shared LayerNorm -> ``cls_fc1``; row
    tokens 0-9 feed ``cls_row``, column tokens 10-19 ``cls_col``.  The
    loc/exist outputs of :class:`UFLDv2Net` with 10 lanes each, plus the
    summed ``lane_token_row``/``lane_token_col`` maps.  f32 only."""

    def __init__(self, spec: UFLDv2Spec):
        super().__init__()
        self.spec = spec
        c = stage_channels(spec.backbone)[-1]
        self.backbone = ResNetFeatures(spec.backbone)
        self.cls_distribute0 = nn.Conv2d(c, 128, 3, padding=1)
        self.cls_distribute2 = nn.Conv2d(128, 20, 3, padding=1)
        self.pool = nn.Conv2d(c, 8, 1)
        flat = spec.flat_features // 8 * 9
        self.cls_norm = nn.LayerNorm(flat, eps=1e-6)  # flax nn.LayerNorm's epsilon
        self.cls_fc1 = nn.Linear(flat, spec.mlp_mid)
        self.cls_row = nn.Linear(spec.mlp_mid, spec.num_cell_row * spec.num_row + 2 * spec.num_row)
        self.cls_col = nn.Linear(spec.mlp_mid, spec.num_cell_col * spec.num_col + 2 * spec.num_col)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        s = self.spec
        fea = self.backbone(x)[2]
        tok = self.cls_distribute2(F.relu(self.cls_distribute0(fea)))  # (B, 20, h, w)
        pooled = self.pool(fea)  # (B, 8, h, w)
        b, _, hh, ww = pooled.shape
        fea9 = torch.cat([pooled[:, None].expand(b, 20, 8, hh, ww), tok[:, :, None]], dim=2)
        h1 = F.relu(self.cls_fc1(self.cls_norm(fea9.reshape(b * 20, 9 * hh * ww))))
        out = h1.reshape(b, 20, s.mlp_mid)
        d1, d3 = s.num_cell_row * s.num_row, s.num_cell_col * s.num_col
        out_row = self.cls_row(out[:, :10]).transpose(1, 2)
        out_col = self.cls_col(out[:, 10:]).transpose(1, 2)
        return {
            "loc_row": out_row[:, :d1].reshape(b, s.num_cell_row, s.num_row, 10),
            "loc_col": out_col[:, :d3].reshape(b, s.num_cell_col, s.num_col, 10),
            "exist_row": out_row[:, d1:].reshape(b, 2, s.num_row, 10),
            "exist_col": out_col[:, d3:].reshape(b, 2, s.num_col, 10),
            "lane_token_row": tok[:, :10].sum(dim=1),
            "lane_token_col": tok[:, 10:].sum(dim=1),
        }


@dataclass(frozen=True)
class UFLDv1Spec:
    """Static geometry of a UFLD v1 variant (``ufld.py:296``)."""

    input_height: int = 288
    input_width: int = 800
    griding_num: int = 100
    cls_num_per_lane: int = 56
    num_lanes: int = 4
    backbone: str = "18"
    mlp_mid: int = 2048
    img_w: int = 1280
    img_h: int = 720
    row_anchor: tuple = field(default_factory=lambda: tuple(np.linspace(64, 284, 56)))

    @property
    def flat_features(self) -> int:
        return 8 * (self.input_height // 32) * (self.input_width // 32)


UFLDV1_SPECS: Dict[LaneModelType, UFLDv1Spec] = {
    LaneModelType.UFLD_TUSIMPLE: UFLDv1Spec(
        griding_num=100, cls_num_per_lane=56, img_w=1280, img_h=720,
        row_anchor=tuple(np.linspace(64, 284, 56)),
    ),
    LaneModelType.UFLD_CULANE: UFLDv1Spec(
        griding_num=200, cls_num_per_lane=18, img_w=1640, img_h=590,
        row_anchor=tuple(round(v) for v in np.linspace(121, 287, 18)),
    ),
}


class UFLDv1Net(nn.Module):
    """ResNet trunk -> 1x1 conv to 8 channels -> flatten (NCHW order) ->
    MLP -> (B, griding+1, rows, lanes) logits (``ufld.py:327``)."""

    def __init__(self, spec: UFLDv1Spec, int8: bool = False):
        super().__init__()
        self.spec = spec
        self.int8 = int8
        self.backbone = ResNetFeatures(spec.backbone, int8=int8)
        self.pool = nn.Conv2d(stage_channels(spec.backbone)[-1], 8, 1)
        dense = QLinear if int8 else nn.Linear
        self.cls_fc1 = dense(spec.flat_features, spec.mlp_mid)
        self.cls_fc2 = dense(spec.mlp_mid,
                             (spec.griding_num + 1) * spec.cls_num_per_lane * spec.num_lanes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.spec
        fea = pooled_map(self.backbone(x)[2], self.pool, self.int8).flatten(1)
        out = head_mlp(self, fea)
        return out.reshape(-1, s.griding_num + 1, s.cls_num_per_lane, s.num_lanes)
