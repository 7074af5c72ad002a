"""ResNet-18 trunk emitting the stride-8/16/32 features (port of the
non-int8 path of ``adas_tpu/models/resnet.py``).

Names follow the flax tree (``conv1``/``bn1``, ``layer{s}_{b}`` with
``conv1``/``bn1``/``conv2``/``bn2``/``downsample_conv``/``downsample_bn``).
The stem — conv1 7x7/2 + bn1 + relu + maxpool 3x3/2 — runs as ONE fused
stem kernel (``resnet.py:346-360``), so its full-resolution activation
never reaches device memory.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BN_EPS, consume_stem


def _conv_bn(cin: int, features: int, kernel: int, stride: int):
    conv = nn.Conv2d(cin, features, kernel, stride, kernel // 2, bias=False)
    return conv, nn.BatchNorm2d(features, eps=BN_EPS)


class BasicBlock(nn.Module):
    """conv3x3 -> conv3x3 + residual (``resnet.py:114``, non-int8 path)."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(cin, features, 3, stride)
        self.conv2, self.bn2 = _conv_bn(features, features, 3, 1)
        self.has_down = stride != 1 or cin != features
        if self.has_down:
            self.downsample_conv, self.downsample_bn = _conv_bn(cin, features, 1, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.has_down else x
        return F.relu(y + identity)


_STAGES = {"18": (2, 2, 2, 2)}


class ResNetFeatures(nn.Module):
    """ResNet trunk (``resnet.py:333``) -> (stride-8, stride-16, stride-32)."""

    def __init__(self, depth: str = "18"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=BN_EPS)
        self.blocks = []
        cin = 64
        for stage_idx, n_blocks in enumerate(_STAGES[depth]):
            width = 64 * 2 ** stage_idx
            for block_idx in range(n_blocks):
                stride = 2 if (stage_idx > 0 and block_idx == 0) else 1
                name = f"layer{stage_idx + 1}_{block_idx}"
                self.add_module(name, BasicBlock(cin, width, stride))
                self.blocks.append((stage_idx, name))
                cin = width

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = consume_stem(x, self.conv1, self.bn1, act="relu", pool=True)
        feats = [None] * 4
        for stage_idx, name in self.blocks:
            x = getattr(self, name)(x)
            feats[stage_idx] = x
        return feats[1], feats[2], feats[3]
