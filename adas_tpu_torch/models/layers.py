"""Shared building blocks (port of the f32/bf16 path of
``adas_tpu/models/layers.py``).

NCHW throughout.  Module and attribute names follow the flax tree
(``conv``/``bn`` under each ConvBN), so ``weights.py`` maps a flax
variable tree onto these modules by path.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stem import fused_stem

BN_EPS = 1e-5


def activation(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act == "silu":
        return F.silu(x)
    if act == "relu":
        return F.relu(x)
    if act is None:
        return x
    raise ValueError(f"unsupported activation: {act}")


def consume_stem(
    x: torch.Tensor, conv: nn.Conv2d, bn: nn.BatchNorm2d, *, act: Optional[str],
    pool: bool,
) -> torch.Tensor:
    """The stem seam shared by :class:`ConvBN` (``stem=True``) and
    ``resnet.ResNetFeatures``, the counterpart of
    ``layers.consume_planes_stem`` (``layers.py:804``): fold the BN to a
    per-channel f32 ``gain``/``bias`` (``BNFoldParams``,
    ``layers.py:236``) and run conv + affine + act (+ max pool) through
    ``ops.stem.fused_stem``."""
    gain = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    bias = bn.bias.float() - bn.running_mean.float() * gain
    w = conv.weight
    return fused_stem(x.to(w.dtype), w, gain, bias, act=act, pool=pool)


class ConvBN(nn.Module):
    """Conv2d (torch ``pad=k//2``, no bias) + BatchNorm + activation
    (``layers.py:828``).  ``stem=True`` marks a stride-2 3-channel stem,
    which runs through the fused stem kernel."""

    def __init__(
        self, cin: int, features: int, kernel: int = 3, stride: int = 1,
        act: Optional[str] = "silu", stem: bool = False,
    ):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel, stride, kernel // 2, bias=False)
        self.bn = nn.BatchNorm2d(features, eps=BN_EPS)
        self.act = act
        self.stem = stem
        if stem and (stride != 2 or cin != 3):
            raise ValueError("a fused stem is a stride-2 conv on 3 channels")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stem:
            return consume_stem(x, self.conv, self.bn, act=self.act, pool=False)
        return activation(self.bn(self.conv(x)), self.act)


def max_pool(x: torch.Tensor, window: int, stride: int, pad: int = 0) -> torch.Tensor:
    """Max pool with torch-style symmetric padding (-inf), ``layers.py:1078``."""
    return F.max_pool2d(x, window, stride, pad)


def resize_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (``layers.py:1106``)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
