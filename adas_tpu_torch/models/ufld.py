"""Ultra-Fast-Lane-Detection v2 (port of ``UFLDv2Spec``, ``UFLDV2_SPECS``
and ``UFLDv2Net`` from ``adas_tpu/models/ufld.py:32-221``, the CULane and TuSimple variants; no aux
segmentation head, no test-time augmentation).

``int8=True``: the int8 ResNet trunk (NHWC), the ``pool`` 1x1 conv in f32
on its bf16 output, and ``cls_fc1``/``cls_fc2`` as W8A8 dense layers
(``Int8Dense`` through ``head_dense``, ``ufld.py:179-202``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.types import LaneModelType

from .quant import QLinear
from .resnet import ResNetFeatures


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
}


class UFLDv2Net(nn.Module):
    """ResNet trunk -> 1x1 conv to 8 channels -> flatten -> [LayerNorm] ->
    MLP -> loc_row/loc_col/exist_row/exist_col (``ufld.py:137``)."""

    def __init__(self, spec: UFLDv2Spec, int8: bool = False):
        super().__init__()
        self.spec = spec
        self.int8 = int8
        self.backbone = ResNetFeatures(spec.backbone, int8=int8)
        self.pool = nn.Conv2d(512, 8, 1)
        if spec.fc_norm:
            # flax nn.LayerNorm's epsilon
            self.cls_norm = nn.LayerNorm(spec.flat_features, eps=1e-6)
        dense = QLinear if int8 else nn.Linear
        self.cls_fc1 = dense(spec.flat_features, spec.mlp_mid)
        self.cls_fc2 = dense(spec.mlp_mid, sum(spec.dims))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        s = self.spec
        _, _, fea = self.backbone(x)
        if self.int8:
            # NHWC bf16 trunk output -> f32 1x1 conv (flax promotes to its
            # f32 params), then the NCHW element order of the flatten
            w = self.pool.weight.reshape(self.pool.out_channels, -1)
            fea = F.linear(fea.float(), w, self.pool.bias).permute(0, 3, 1, 2).flatten(1)
        else:
            # NCHW flatten: the (c, h, w) element order the JAX net reaches
            # by transposing its NHWC map (ufld.py:191-194)
            fea = self.pool(fea).flatten(1)
        if s.fc_norm:
            fea = self.cls_norm(fea)
        out = self.cls_fc2(F.relu(self.cls_fc1(fea)))
        b = out.shape[0]
        d1, d2, d3, _ = s.dims
        return {
            "loc_row": out[:, :d1].reshape(b, s.num_cell_row, s.num_row, s.num_lanes),
            "loc_col": out[:, d1: d1 + d2].reshape(b, s.num_cell_col, s.num_col, s.num_lanes),
            "exist_row": out[:, d1 + d2: d1 + d2 + d3].reshape(b, 2, s.num_row, s.num_lanes),
            "exist_col": out[:, d1 + d2 + d3:].reshape(b, 2, s.num_col, s.num_lanes),
        }
