"""Shared building blocks (port of ``adas_tpu/models/layers.py``).

The f32/bf16 path is NCHW.  Under int8 (``ConvBN(..., int8=True)``) a
ConvBN is a W8A8 conv with the folded-BN epilogue (``Int8Conv``,
``layers.py:328-512``) in the NHWC int8 domain of ``quant.py``, served by
the ``ops/int8_conv.py`` kernel.  Module and attribute names follow the
flax tree (``conv``/``bn`` under each ConvBN), so ``weights.py`` maps a
flax variable tree onto these modules by path.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8_conv import int8_conv
from ..ops.stem import fused_stem
from .quant import (
    Act,
    QConv2d,
    QTensor,
    bn_fold,
    dynamic_scale,
    int8_conv_eligible,
    quantize_to,
)

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
    pool: bool, dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The stem seam shared by :class:`ConvBN` (``stem=True``) and
    ``resnet.ResNetFeatures``, the counterpart of
    ``layers.consume_planes_stem`` (``layers.py:804``): fold the BN to a
    per-channel f32 ``gain``/``bias`` (``BNFoldParams``,
    ``layers.py:236``) and run conv + affine + act (+ max pool) through
    ``ops.stem.fused_stem``, in ``dtype`` (default: the weight's; an int8
    net's stem runs in bf16)."""
    gain, bias = bn_fold(bn)
    w = conv.weight if dtype is None else conv.weight.to(dtype)
    return fused_stem(x.to(w.dtype), w, gain, bias, act=act, pool=pool)


def int8_conv_bn(
    conv: QConv2d, bn: nn.BatchNorm2d, x: Act, *, act: Optional[str],
    emit_q: bool = False, emit_scale: Optional[torch.Tensor] = None,
) -> Act:
    """``Int8Conv.__call__`` with a folded BN (``layers.py:356-419``) on an
    NHWC activation.  The input scale is the QTensor's, else the
    calibrated ``xmax``'s, else dynamic; the output is s8 at
    ``emit_scale`` (a concat group's) or at this conv's ``ymax`` when
    ``emit_q``, else bf16.  Calibrating: dynamic input scales, bf16
    output, ``xmax`` (and ``ymax`` when ``emit_q``) recorded."""
    cal = conv.calibrating
    static = True
    if isinstance(x, QTensor):
        xq, xs = x.data, x.scale
    else:
        if cal:
            conv.record_max("xmax", [x])
            xs = None
        else:
            xs = conv.buffer_scale("xmax")
        if xs is None:
            xs, static = dynamic_scale(x), False
        xq = quantize_to(x, xs).data
    out_scale = None
    if not cal:
        out_scale = emit_scale if emit_scale is not None else (
            conv.buffer_scale("ymax") if emit_q else None
        )
    scale, bias = conv_epilogue(conv, bn, xs, static)
    y = int8_conv(xq, conv.qweight()[0], scale, bias, stride=conv.stride[0], act=act,
                  out_scale=out_scale)
    if cal and emit_q:
        conv.record_max("ymax", [y])
    return y if out_scale is None else QTensor(y, out_scale)


def conv_epilogue(conv: QConv2d, bn: nn.BatchNorm2d, xs: torch.Tensor, static: bool = True):
    """The epilogue (scale, bias) of ``conv`` on an input at scale ``xs``:
    ``wscale * xs * gain`` in that order (``layers.py:486-494``) and the
    folded BN bias.  Cached per static input-scale object."""
    gain, bias = conv.cached("fold", lambda: bn_fold(bn))
    wscale = conv.qweight()[1]
    if not static:
        return wscale * xs * gain, bias
    return conv.cached(("epilogue", id(xs)), lambda: (wscale * xs * gain, bias, xs))[:2]


def make_conv(cin: int, features: int, kernel: int, stride: int, int8: bool) -> nn.Conv2d:
    """The conv of a Conv+BN pair (torch ``pad=k//2``, no bias): a
    :class:`QConv2d` in an int8 net, which serves no bf16 conv but its
    stem."""
    if int8 and not int8_conv_eligible(1, cin):
        raise NotImplementedError(f"an int8 net's {cin}-channel conv would serve bf16")
    return (QConv2d if int8 else nn.Conv2d)(cin, features, kernel, stride, kernel // 2, bias=False)


class ConvBN(nn.Module):
    """Conv2d (torch ``pad=k//2``, no bias) + BatchNorm + activation
    (``layers.py:828``).  ``stem=True`` marks a stride-2 3-channel stem,
    which runs through the fused stem kernel (in bf16 in an int8 net).
    ``int8=True``: a W8A8 conv (:func:`int8_conv_bn`) on NHWC activations;
    the policy's bf16 convs other than the stem are not served."""

    def __init__(
        self, cin: int, features: int, kernel: int = 3, stride: int = 1,
        act: Optional[str] = "silu", stem: bool = False, int8: bool = False,
    ):
        super().__init__()
        self.int8 = int8 and not stem
        self.conv = make_conv(cin, features, kernel, stride, self.int8)
        self.bn = nn.BatchNorm2d(features, eps=BN_EPS)
        self.act = act
        self.stem = stem
        self.stem_dtype = torch.bfloat16 if int8 else None
        if stem and (stride != 2 or cin != 3):
            raise ValueError("a fused stem is a stride-2 conv on 3 channels")

    def forward(self, x: Act, emit_q: bool = False, emit_scale=None) -> Act:
        if self.stem:
            return consume_stem(x, self.conv, self.bn, act=self.act, pool=False,
                                dtype=self.stem_dtype)
        if self.int8:
            return int8_conv_bn(self.conv, self.bn, x, act=self.act, emit_q=emit_q,
                                emit_scale=emit_scale)
        return activation(self.bn(self.conv(x)), self.act)


def max_pool(x: torch.Tensor, window: int, stride: int, pad: int = 0) -> torch.Tensor:
    """Max pool with torch-style symmetric padding (-inf), ``layers.py:1078``."""
    return F.max_pool2d(x, window, stride, pad)


def resize_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (``layers.py:1106``)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
