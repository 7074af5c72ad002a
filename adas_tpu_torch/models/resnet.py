"""ResNet-18/34/50 trunks emitting the stride-8/16/32 features (port of
``adas_tpu/models/resnet.py``: ``BasicBlock``, ``Bottleneck``, ``_CONFIGS``
and ``stage_channels``).

Names follow the flax tree (``conv1``/``bn1``, ``layer{s}_{b}`` with
``conv1``/``bn1``/``conv2``/``bn2`` (and ``conv3``/``bn3`` in a
Bottleneck)/``downsample_conv``/``downsample_bn``), so the weight bridge
(``weights.py``) maps every depth by path.
The stem — conv1 7x7/2 + bn1 + relu + maxpool 3x3/2 — runs as ONE fused
stem kernel (``resnet.py:346-360``), so its full-resolution activation
never reaches device memory.  In training mode (``module.train()``, JAX's
``train=True``) the stem is the plain conv -> BN on the batch statistics
-> ReLU -> max pool instead (``resnet.py:361-379``: JAX serves its Pallas
stem only when not training), and every BN (:class:`layers.BatchNorm2d`)
follows flax's training statistics; an int8 trunk does not train.

``int8=True`` builds the int8 trunk: the stem stays bf16, every other conv
is a W8A8 conv with its BN folded (``_conv_bn`` under
``quantized("int8")``, ``resnet.py:23-58``) in the NHWC int8 domain, and,
once calibrated, the stride-1 same-width BasicBlocks that pass the fusion
gate (``layer1``'s two of ResNet-18 and three of ResNet-34 at the served
sizes) run as one fused block kernel (``ops/block.py``).  Bottlenecks run
on the int8 conv alone, as in JAX.  The stage taps are NHWC bf16 then (a
fused block's s8 output is dequantized).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.block import fuse_gate, fused_block
from .layers import BN_EPS, BatchNorm2d, consume_stem, conv_epilogue, int8_conv_bn, make_conv
from .quant import Int8State, QTensor, as_float, quantize_to


def _conv_bn(cin: int, features: int, kernel: int, stride: int, int8: bool = False):
    return make_conv(cin, features, kernel, stride, int8), BatchNorm2d(features, eps=BN_EPS)


class BasicBlock(Int8State, nn.Module):
    """conv3x3 -> conv3x3 + residual (``resnet.py:114``).  Under int8 a
    stride-1 same-width block that passes the gate runs as one fused
    block with an s8 output at ``out_ymax``'s scale (``BasicBlock._fused``,
    ``resnet.py:194``); calibration records ``out_ymax`` on every stride-1
    block."""

    def __init__(self, cin: int, features: int, stride: int = 1, int8: bool = False):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(cin, features, 3, stride, int8)
        self.conv2, self.bn2 = _conv_bn(features, features, 3, 1, int8)
        self.has_down = stride != 1 or cin != features
        if self.has_down:
            self.downsample_conv, self.downsample_bn = _conv_bn(cin, features, 1, stride, int8)
        self.stride = stride
        self.int8 = int8
        if int8:
            self._init_int8_buffers("out_ymax")

    def forward(self, x):
        if not self.int8:
            y = F.relu(self.bn1(self.conv1(x)))
            y = self.bn2(self.conv2(y))
            identity = self.downsample_bn(self.downsample_conv(x)) if self.has_down else x
            return F.relu(y + identity)
        if self._fusable(x):
            return self._fused(x)
        y = int8_conv_bn(self.conv1, self.bn1, x, act="relu", emit_q=True)
        y = int8_conv_bn(self.conv2, self.bn2, y, act=None)
        identity = x
        if self.has_down:
            identity = int8_conv_bn(self.downsample_conv, self.downsample_bn, x, act=None)
        out = F.relu(y + as_float(identity))
        if self.calibrating and self.stride == 1:
            self.record_max("out_ymax", [out])
        return out

    def _fusable(self, x) -> bool:
        """Whether this block runs as the fused block kernel: only once
        calibrated (``out_ymax`` and the convs' scales; an uncalibrated
        net's dynamic scales never reach the kernel), at stride 1, same
        width, and past the gate."""
        if self.calibrating or self.stride != 1 or self.has_down or self.out_ymax is None:
            return False
        _, h, w, c = x.shape
        return fuse_gate(h, w, c)

    def _fused(self, x) -> QTensor:
        xs = x.scale if isinstance(x, QTensor) else self.conv1.buffer_scale("xmax")
        y1s = self.conv1.buffer_scale("ymax")
        if xs is None or y1s is None:
            raise ValueError(
                "inconsistent calibration: out_ymax is present but conv1's xmax/ymax is "
                "missing (recalibrate the model)"
            )
        if not isinstance(x, QTensor):
            x = quantize_to(x, xs)
        so = self.buffer_scale("out_ymax")
        s1, b1 = conv_epilogue(self.conv1, self.bn1, xs)
        s2, b2 = conv_epilogue(self.conv2, self.bn2, y1s)
        out = fused_block(
            x.data, xs, self.conv1.qweight()[0], s1, b1, y1s, self.conv2.qweight()[0], s2, b2,
            so, act1="relu", act2=None, act_post="relu", residual=True,
        )
        return QTensor(out, so)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (the stride) -> 1x1 to 4x the width, + residual
    (``resnet.py:292-323``).  Under int8 conv1 and conv2 emit s8 to their
    one consumer once calibrated (``emit_q``); there is no fused form."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1, int8: bool = False):
        super().__init__()
        out = features * self.expansion
        self.conv1, self.bn1 = _conv_bn(cin, features, 1, 1, int8)
        self.conv2, self.bn2 = _conv_bn(features, features, 3, stride, int8)
        self.conv3, self.bn3 = _conv_bn(features, out, 1, 1, int8)
        self.has_down = stride != 1 or cin != out
        if self.has_down:
            self.downsample_conv, self.downsample_bn = _conv_bn(cin, out, 1, stride, int8)
        self.int8 = int8

    def forward(self, x):
        if not self.int8:
            y = F.relu(self.bn1(self.conv1(x)))
            y = F.relu(self.bn2(self.conv2(y)))
            y = self.bn3(self.conv3(y))
            identity = self.downsample_bn(self.downsample_conv(x)) if self.has_down else x
            return F.relu(y + identity)
        y = int8_conv_bn(self.conv1, self.bn1, x, act="relu", emit_q=True)
        y = int8_conv_bn(self.conv2, self.bn2, y, act="relu", emit_q=True)
        y = int8_conv_bn(self.conv3, self.bn3, y, act=None)
        identity = x
        if self.has_down:
            identity = int8_conv_bn(self.downsample_conv, self.downsample_bn, x, act=None)
        return F.relu(y + as_float(identity))


#: (block, blocks per stage) by depth (``resnet.py:326-330``)
_CONFIGS = {
    "18": (BasicBlock, (2, 2, 2, 2)),
    "34": (BasicBlock, (3, 4, 6, 3)),
    "50": (Bottleneck, (3, 4, 6, 3)),
}


def stage_channels(depth: str) -> Tuple[int, int, int, int]:
    """The four stages' output widths (``resnet.py:422-426``): 64-512, x4
    for a Bottleneck trunk."""
    mult = 4 if _CONFIGS[depth][0] is Bottleneck else 1
    return tuple(64 * 2 ** i * mult for i in range(4))


class ResNetFeatures(Int8State, nn.Module):
    """ResNet trunk (``resnet.py:333``) of depth ``"18"``, ``"34"`` or
    ``"50"`` -> (stride-8, stride-16, stride-32): NCHW, or NHWC bf16 under
    int8."""

    def __init__(self, depth: str = "18", int8: bool = False):
        super().__init__()
        self.int8 = int8
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=BN_EPS)
        self.blocks = []
        block, stages = _CONFIGS[depth]
        cin = 64
        for stage_idx, n_blocks in enumerate(stages):
            width = 64 * 2 ** stage_idx
            for block_idx in range(n_blocks):
                stride = 2 if (stage_idx > 0 and block_idx == 0) else 1
                name = f"layer{stage_idx + 1}_{block_idx}"
                self.add_module(name, block(cin, width, stride, int8=int8))
                self.blocks.append((stage_idx, name))
                cin = stage_channels(depth)[stage_idx]

    def train(self, mode: bool = True):
        # the kernel stem's BN fold is cached from the statistics and
        # weights that training moves: fold again after any mode switch
        self.clear_int8_cache()
        return super().train(mode)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if self.training:
            if self.int8:
                raise ValueError("an int8 trunk serves only: train the f32 net")
            x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        elif self.int8:
            # the bf16 stem; its NCHW output enters the int8 domain as an
            # NHWC view (the first quantize writes it NHWC)
            x = consume_stem(x, self.conv1, self, self.bn1, act="relu", pool=True,
                             dtype=torch.bfloat16).permute(0, 2, 3, 1)
        else:
            x = consume_stem(x, self.conv1, self, self.bn1, act="relu", pool=True)
        feats = [None] * 4
        for stage_idx, name in self.blocks:
            x = getattr(self, name)(x)
            feats[stage_idx] = x
        return tuple(as_float(f) for f in feats[1:])
