"""Shared building blocks (port of ``adas_tpu/models/layers.py``).

The f32/bf16 path is NCHW.  Under int8 (``ConvBN(..., int8=True)``) a
ConvBN is a W8A8 conv with the folded-BN epilogue (``Int8Conv``,
``layers.py:328-512``) in the NHWC int8 domain of ``quant.py``, served by
the ``ops/int8_conv.py`` kernel, where the precision policy makes it int8
(``int8_conv_eligible``: dense, more than 4 input channels); the others
(depthwise convs, the YOLOv5 6x6 stem) run in bf16 on the NHWC domain's
values, as ``ConvBN.__call__`` serves them (``layers.py:960-967``).
Module and attribute names follow the flax tree (``conv``/``bn`` under
each ConvBN), so ``weights.py`` maps a flax variable tree onto these
modules by path.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8_conv import int8_conv, pad_channels
from ..ops.stem import fused_stem
from .quant import (
    Act,
    Int8State,
    QConv2d,
    QTensor,
    as_float,
    bn_fold,
    dynamic_scale,
    int8_conv_eligible,
    quantize_to,
)

BN_EPS = 1e-5
#: flax ``nn.BatchNorm``'s ``momentum``: ``ra = 0.9 * ra + 0.1 * batch``
BN_MOMENTUM = 0.9


#: the batch-statistics sum of this thread's BatchNorm2d layers in
#: training mode (:func:`batch_stats_across`)
_STATS_SUM = threading.local()


@contextlib.contextmanager
def batch_stats_across(fn: Callable):
    """Within the block, every :class:`BatchNorm2d` in training mode on this
    thread takes its batch statistics over a batch that other threads hold
    parts of: ``fn(sums, count)`` gets this part's per-channel (2, C)
    ``[sum x, sum x^2]`` and element count per channel and returns the
    whole batch's (the sharded trainer's sum across the data rows,
    ``parallel/train.py``)."""
    prev = getattr(_STATS_SUM, "fn", None)
    _STATS_SUM.fn = fn
    try:
        yield
    finally:
        _STATS_SUM.fn = prev


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training mode is flax's ``nn.BatchNorm(
    use_running_average=False, momentum=0.9)`` (the trainer's,
    ``parallel/train.py``): the batch mean and the biased variance
    ``E[x^2] - E[x]^2`` (flax's ``use_fast_variance``, clipped at 0)
    normalize, and both running statistics take the same biased values
    (``nn.BatchNorm2d`` puts the unbiased variance into ``running_var``).
    Under :func:`batch_stats_across` the mean and variance are those of
    the whole batch, from the summed ``sum x``, ``sum x^2`` and counts (as
    GSPMD takes flax's batch mean over a sharded batch axis).
    Eval mode is ``nn.BatchNorm2d``'s, on the running statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        across = getattr(_STATS_SUM, "fn", None)
        if across is None:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        else:
            sums, count = across(torch.stack([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3))]),
                                 x.numel() // x.shape[1])
            mean = sums[0] / count
            var = torch.clamp(sums[1] / count - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


def activation(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act == "silu":
        return F.silu(x)
    if act == "relu":
        return F.relu(x)
    if act is None:
        return x
    raise ValueError(f"unsupported activation: {act}")


def consume_stem(
    x: torch.Tensor, conv: nn.Conv2d, owner: Int8State, bn: nn.BatchNorm2d, *,
    act: Optional[str], pool: bool, dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The stem seam shared by :class:`ConvBN` (``stem=True``) and
    ``resnet.ResNetFeatures``, the counterpart of
    ``layers.consume_planes_stem`` (``layers.py:804``): the BN folded to a
    per-channel f32 ``gain``/``bias`` (``BNFoldParams``,
    ``layers.py:236``; :func:`bn_fold`, cached on ``owner``), then conv +
    affine + act (+ max pool) through ``ops.stem.fused_stem``, in ``dtype``
    (default: the weight's; an int8 net's stem runs in bf16)."""
    gain, bias = owner.cached("stem_fold", lambda: bn_fold(bn))
    w = conv.weight if dtype is None else conv.weight.to(dtype)
    return fused_stem(x.to(w.dtype), w, gain, bias, act=act, pool=pool)


def int8_conv_bn(
    conv: QConv2d, bn: Optional[nn.BatchNorm2d], x: Act, *, act: Optional[str],
    emit_q: bool = False, emit_scale: Optional[torch.Tensor] = None,
) -> Act:
    """``Int8Conv.__call__`` with a folded BN (``layers.py:356-419``) on an
    NHWC activation.  The input scale is the QTensor's, else the
    calibrated ``xmax``'s, else dynamic; the output is s8 at
    ``emit_scale`` (a concat group's) or at this conv's ``ymax`` when
    ``emit_q``, else bf16, or f32 for a conv with no BN to fold
    (``bn=None``: EfficientDet's head, ``layers.py:505-510``).
    Calibrating: dynamic input scales, no s8 output, ``xmax`` (and
    ``ymax`` when ``emit_q``) recorded."""
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
    y = int8_conv(xq, conv.kernel_weight(), scale, bias, stride=conv.stride[0], act=act,
                  out_scale=out_scale, out_f32=bn is None and out_scale is None,
                  cout=conv.out_channels)
    if cal and emit_q:
        conv.record_max("ymax", [y])
    return y if out_scale is None else QTensor(y, out_scale)


def conv_epilogue(conv: QConv2d, bn: Optional[nn.BatchNorm2d], xs: torch.Tensor,
                  static: bool = True):
    """The epilogue (scale, bias) of ``conv`` on an input at scale ``xs``:
    ``wscale * xs * gain`` in that order and the folded BN bias, a conv
    bias folded in (``layers.py:486-494``); with no BN, ``wscale * xs`` and
    the conv bias.  Both padded with zeros to the Cout of
    ``conv.kernel_weight()`` (``ops/int8_conv.pad_channels``).  Cached per
    static input-scale object.  A dynamic ``xs`` of one scale per batch
    element, (B,), gives a (B, Cout) scale table: each row the f32 values
    JAX's vmapped step computes for that stream."""
    def fold():
        if bn is None:
            return None, None if conv.bias is None else conv.bias.float()
        return bn_fold(bn, conv.bias)

    gain, bias = conv.cached("fold", fold)
    wscale = conv.qweight()[1]

    def make():
        s = wscale * xs if xs.dim() == 0 else wscale * xs[:, None]
        return pad_channels(s if gain is None else s * gain), pad_channels(bias), xs

    if not static:
        return make()[:2]
    return conv.cached(("epilogue", id(xs)), make)[:2]


def make_conv(cin: int, features: int, kernel: int, stride: int, int8: bool,
              groups: int = 1) -> nn.Conv2d:
    """The conv of a Conv+BN pair (symmetric ``pad=(k-1)//2``, the JAX
    ConvBN's, which is torch's ``k//2`` for odd k; no bias): a
    :class:`QConv2d` for an int8 conv (``int8`` only where the precision
    policy takes it)."""
    if int8 and not int8_conv_eligible(groups, cin):
        raise ValueError(f"a {cin}-channel conv of {groups} groups is not an int8 conv")
    return (QConv2d if int8 else nn.Conv2d)(cin, features, kernel, stride, (kernel - 1) // 2,
                                            groups=groups, bias=False)


class ConvBN(Int8State, nn.Module):
    """Conv2d (symmetric ``pad=(k-1)//2``, no bias, ``groups``) + BatchNorm
    + activation (``layers.py:828``).  ``stem=True`` marks a stride-2
    3-channel odd-k stem, which runs through the fused stem kernel (in
    bf16 in an int8 net).  ``int8=True`` (an int8 net): a W8A8 conv
    (:func:`int8_conv_bn`) on NHWC activations where the policy takes it,
    else a bf16 conv on the NHWC values (a QTensor input dequantized), its
    BN in f32, the result and the activation in bf16, as flax's bf16
    ``nn.Conv`` + ``nn.BatchNorm`` compute them."""

    def __init__(
        self, cin: int, features: int, kernel: int = 3, stride: int = 1,
        act: Optional[str] = "silu", stem: bool = False, int8: bool = False,
        groups: int = 1,
    ):
        super().__init__()
        self.int8 = int8 and not stem and int8_conv_eligible(groups, cin)
        self.bf16 = int8 and not stem and not self.int8
        self.conv = make_conv(cin, features, kernel, stride, self.int8, groups)
        self.bn = nn.BatchNorm2d(features, eps=BN_EPS)
        self.act = act
        self.stem = stem
        self.stem_dtype = torch.bfloat16 if int8 else None
        if stem and (stride != 2 or cin != 3 or kernel % 2 == 0 or groups != 1):
            raise ValueError("a fused stem is an odd-k stride-2 conv on 3 channels")

    def forward(self, x: Act, emit_q: bool = False, emit_scale=None) -> Act:
        if self.stem:
            return consume_stem(x, self.conv, self, self.bn, act=self.act, pool=False,
                                dtype=self.stem_dtype)
        if self.int8:
            return int8_conv_bn(self.conv, self.bn, x, act=self.act, emit_q=emit_q,
                                emit_scale=emit_scale)
        if self.bf16:
            # NHWC values through an NCHW view (no copy), the weight cast once
            w = self.cached("w_bf16", lambda: self.conv.weight.to(torch.bfloat16))
            y = F.conv2d(as_float(x).to(torch.bfloat16).permute(0, 3, 1, 2), w, None,
                         self.conv.stride, self.conv.padding, 1, self.conv.groups)
            return activation(self.bn(y.float()).to(torch.bfloat16), self.act).permute(0, 2, 3, 1)
        return activation(self.bn(self.conv(x)), self.act)


def max_pool(x: torch.Tensor, window: int, stride: int, pad: int = 0) -> torch.Tensor:
    """Max pool with torch-style symmetric padding (-inf), ``layers.py:1078``."""
    return F.max_pool2d(x, window, stride, pad)


def resize_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (``layers.py:1106``)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
