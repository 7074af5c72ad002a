"""EfficientDet (D0-D7): EfficientNet trunk + BiFPN + anchor heads, NCHW
(port of ``adas_tpu/models/efficientdet.py``), f32 or calibrated int8.

The JAX graph mirrors zylo117's Yet-Another-EfficientDet-Pytorch, and so
does this one, quirk for quirk:

* TF-SAME padding everywhere: a stride-2 conv or pool pads bottom/right
  (``_same_pads``, ``efficientdet.py:59``), done here with an explicit
  ``F.pad`` because ``F.conv2d`` pads symmetrically;
* the SAME max pool pads with literal zeros, not -inf (``_same_pool``,
  ``efficientdet.py:156``);
* BatchNorm eps 1e-3; MBConv with squeeze-excite (``mean(H, W)`` -> biased
  1x1 -> SiLU -> biased 1x1 -> sigmoid gate);
* separable convs whose pointwise stage is always biased;
* a first BiFPN layer that owns the channel-reduction laterals, including
  the separate ``*_down_channel_2`` skip laterals; fast-attention fusion
  ``relu(w) / (sum(relu(w)) + 1e-4)`` then SiLU of the weighted sum (a
  plain sum for D6/D7);
* heads with shared separable convs and per-level BatchNorm lists
  (``bn_l{level}_c{conv}``);
* the trunk's feature taps chosen by the input size
  (``efficientdet.py:244``), and anchors built from the input's own size.

Module and attribute names follow the flax tree (``backbone.block3.dw_conv``,
``bifpn0.p5_down_channel_2.bn``, ``regressor.bn_l2_c1``, the fusion weights
``bifpn1.p4_w2``), so ``weights.py`` maps a flax variable tree onto these
modules by path.  Depthwise and pointwise convs are ``F.conv2d``: the JAX
package has no Pallas kernel for them.  ``EfficientDet`` returns
``(boxes_xyxy (B, N, 4), sigmoid class probs (B, N, num_classes))``.

``int8=True`` is JAX's ``quantized("int8")`` over the same graph
(``_conv_same`` / ``_conv_bn_act``, ``efficientdet.py:59-122``): every
int8-eligible conv (dense, more than 4 input channels) is a W8A8 conv on
``csrc/int8_conv.cu`` (``layers.int8_conv_bn``), its BN (and conv bias)
folded into the epilogue, emitting bf16, or f32 where no BN follows (the
head's separable pointwise convs); every one of them is a 1x1 at stride
1, whose TF-SAME padding is zero (checked at construction).  The
depthwise convs and the 3-channel stem run in bf16 with a bf16-rounded
BN; the squeeze-excite convs and the ``header`` projections (``quantize
=False``, ``efficientdet.py:253-285``) stay f32.  The layout stays NCHW:
an int8 conv reads its input through an NHWC view (its quantize writes
the NHWC s8 copy) and returns an NCHW view of its NHWC output.  Nothing
chains s8: each int8 conv quantizes its input at its calibrated scale.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import activation, int8_conv_bn
from .quant import Int8State, QConv2d, int8_conv_eligible

# (width_mult, depth_mult, input_size, fpn_channels, fpn_layers, head_layers)
# — the zylo117 compound table, rows d0..d7 (``efficientdet.py:34``)
_D_CONFIGS = {
    0: (1.0, 1.0, 512, 64, 3, 3),
    1: (1.0, 1.1, 640, 88, 4, 3),
    2: (1.1, 1.2, 768, 112, 5, 3),
    3: (1.2, 1.4, 896, 160, 6, 4),
    4: (1.4, 1.8, 1024, 224, 7, 4),
    5: (1.6, 2.2, 1280, 288, 7, 4),
    6: (1.8, 2.6, 1280, 384, 8, 5),
    7: (1.8, 2.6, 1536, 384, 8, 5),
}

# EfficientNet-B0 stage table: expand, kernel, stride, channels, repeats
_MBCONV_STAGES = [
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
]

BN_EPS = 1e-3


def _round_channels(c: float, width: float, divisor: int = 8) -> int:
    c *= width
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return int(new_c)


def _round_repeats(r: int, depth: float) -> int:
    return int(math.ceil(r * depth))


def mbconv_plan(width: float, depth: float) -> List[tuple]:
    """Flat (expand, kernel, stride, channels) list, one entry per MBConv
    block (``efficientdet.py:137``)."""
    plan = []
    for expand, k, s, c, r in _MBCONV_STAGES:
        c = _round_channels(c, width)
        for bi in range(_round_repeats(r, depth)):
            plan.append((expand, k, s if bi == 0 else 1, c))
    return plan


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF-SAME (before, after) padding of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0) -> torch.Tensor:
    (top, bottom), (left, right) = (_same_pads(s, kernel, stride) for s in x.shape[-2:])
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


class SameConv2d(Int8State, nn.Conv2d):
    """``nn.Conv(padding="SAME")``: bottom/right-heavy padding when the
    stride is 2, explicit before the (unpadded) conv.  :meth:`bf16` is the
    int8 net's bf16 conv (the weights cast once)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1,
                 bias: bool = False):
        super().__init__(cin, cout, kernel, stride, 0, groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(_pad_same(x, self.kernel_size[0], self.stride[0]))

    def bf16(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.cached("bf16", lambda: (
            self.weight.to(torch.bfloat16),
            None if self.bias is None else self.bias.to(torch.bfloat16)))
        return self._conv_forward(_pad_same(x.to(torch.bfloat16), self.kernel_size[0],
                                            self.stride[0]), w, b)


def _same_conv(cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1,
               bias: bool = False, int8: bool = False) -> nn.Conv2d:
    """The conv of ``_conv_same`` (``efficientdet.py:70``): a W8A8
    :class:`QConv2d` where the int8 policy takes it, else a
    :class:`SameConv2d`.  Every int8-eligible conv of the graph is a 1x1 at
    stride 1, whose TF-SAME padding is zero; anything else raises."""
    if not (int8 and int8_conv_eligible(groups, cin)):
        return SameConv2d(cin, cout, kernel, stride, groups, bias)
    if (kernel, stride) != (1, 1) or _same_pads(64, kernel, stride) != (0, 0):
        raise ValueError(f"an int8 EfficientDet conv is a 1x1 at stride 1, got k{kernel} s{stride}")
    return QConv2d(cin, cout, 1, 1, 0, bias=bias)


def _conv_bn_act(conv: nn.Conv2d, bn, x: torch.Tensor, act, int8: bool) -> torch.Tensor:
    """``_conv_bn_act`` / ``_conv_same`` (``efficientdet.py:70-122``) on an
    NCHW input: a :class:`QConv2d` as a W8A8 conv with ``bn`` folded
    (bf16 out; f32 when ``bn`` is None); in the int8 net the other convs
    in bf16 with flax's bf16 BN (:func:`_bn_bf16`) and SiLU; in the float
    net as written."""
    if isinstance(conv, QConv2d):
        return int8_conv_bn(conv, bn, x.permute(0, 2, 3, 1), act=act).permute(0, 3, 1, 2)
    if int8:
        y = conv.bf16(x)
        if bn is not None:
            y = _bn_bf16(bn, y)
        # jax.nn.silu on bf16: x * 1 / (1 + exp(-x)), every step rounded
        return y * (1 / (1 + torch.exp(-y))) if act == "silu" else activation(y, act)
    y = conv(x)
    return activation(y if bn is None else bn(y), act)


def _bn_bf16(bn: nn.BatchNorm2d, y: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.BatchNorm(dtype=bfloat16)`` at inference on an NCHW bf16
    ``y`` (``flax.linen.normalization._normalize``): ``(y - mean) *
    (rsqrt(var + eps) * scale) + bias`` in f32, in that order, rounded
    once to bf16."""
    mean, var, w, b = (t.float().view(1, -1, 1, 1)
                       for t in (bn.running_mean, bn.running_var, bn.weight, bn.bias))
    return ((y.float() - mean) * (torch.rsqrt(var + bn.eps) * w) + b).to(torch.bfloat16)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS)


def same_pool(x: torch.Tensor, window: int = 3, stride: int = 2) -> torch.Tensor:
    """TF-SAME max pool padded with literal zeros (zylo117's ZeroPad2d +
    MaxPool2d, ``efficientdet.py:156``)."""
    return F.max_pool2d(_pad_same(x, window, stride, 0.0), window, stride)


class MBConv(nn.Module):
    """MBConv block: [1x1 expand + BN + SiLU] -> depthwise kxk/s + BN + SiLU
    -> squeeze-excite -> 1x1 project + BN [+ residual] (``efficientdet.py:177``)."""

    def __init__(self, cin: int, features: int, expand: int, kernel: int, stride: int,
                 se_ratio: float = 0.25, int8: bool = False):
        super().__init__()
        mid = cin * expand
        if expand != 1:
            self.expand_conv, self.bn0 = _same_conv(cin, mid, 1, int8=int8), _bn(mid)
        self.dw_conv = SameConv2d(mid, mid, kernel, stride, groups=mid)
        self.bn1 = _bn(mid)
        squeezed = max(1, int(cin * se_ratio))
        # squeeze-excite: plain nn.Conv in JAX, f32 in every precision
        self.se_reduce = nn.Conv2d(mid, squeezed, 1)
        self.se_expand = nn.Conv2d(squeezed, mid, 1)
        self.project_conv, self.bn2 = _same_conv(mid, features, 1, int8=int8), _bn(features)
        self.expand = expand
        self.residual = stride == 1 and cin == features
        self.int8 = int8

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.expand != 1:
            h = _conv_bn_act(self.expand_conv, self.bn0, h, "silu", self.int8)
        h = _conv_bn_act(self.dw_conv, self.bn1, h, "silu", self.int8)
        s = h.mean(dim=(2, 3), keepdim=True)
        if self.int8:
            s = s.float()
        s = self.se_expand(F.silu(self.se_reduce(s)))
        h = h * torch.sigmoid(s)
        h = _conv_bn_act(self.project_conv, self.bn2, h, None, self.int8)
        return h + x if self.residual else h


class EfficientNetFeatures(nn.Module):
    """EfficientNet trunk returning (C3, C4, C5) at strides 8/16/32
    (``efficientdet.py:223``); blocks are named flat ``block{i}``."""

    def __init__(self, width: float = 1.0, depth: float = 1.0, int8: bool = False):
        super().__init__()
        stem = _round_channels(32, width)
        self.stem_conv, self.stem_bn = SameConv2d(3, stem, 3, 2), _bn(stem)
        self.plan = mbconv_plan(width, depth)
        cin = stem
        for i, (expand, k, s, c) in enumerate(self.plan):
            self.add_module(f"block{i}", MBConv(cin, c, expand, k, s, int8=int8))
            cin = c
        self.int8 = int8

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        h = _conv_bn_act(self.stem_conv, self.stem_bn, x, "silu", self.int8)
        feats = []
        for i, (_, _, s, _) in enumerate(self.plan):
            # a map is tapped before each stride-2 block from stride 8 on
            # (the last three taps are C3, C4, C5), literally as
            # efficientdet.py:244 decides it
            if s == 2 and h.shape[-2] * 2 <= x.shape[-2] // 4:
                feats.append(h)
            h = getattr(self, f"block{i}")(h)
        feats.append(h)
        return tuple(feats[-3:])


class SeparableConvBlock(nn.Module):
    """Depthwise 3x3 (no bias, SAME) + pointwise 1x1 (always biased) [+ BN]
    (``efficientdet.py:253``).  ``quantize=False`` (the ``header``
    projections) keeps the block f32 in the int8 net."""

    def __init__(self, cin: int, features: int, use_bn: bool = True, quantize: bool = True,
                 int8: bool = False):
        super().__init__()
        self.int8 = int8 and quantize
        self.dw = SameConv2d(cin, cin, 3, groups=cin)
        self.pw = _same_conv(cin, features, 1, bias=True, int8=self.int8)
        if use_bn:
            self.bn = _bn(features)
        self.use_bn = use_bn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _conv_bn_act(self.dw, None, x, None, self.int8)
        return _conv_bn_act(self.pw, self.bn if self.use_bn else None, h, None, self.int8)


class _DownChannel(nn.Module):
    """1x1 conv (biased) + BN lateral (``efficientdet.py:286``)."""

    def __init__(self, cin: int, features: int, int8: bool = False):
        super().__init__()
        self.conv = _same_conv(cin, features, 1, bias=True, int8=int8)
        self.bn = _bn(features)
        self.int8 = int8

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_bn_act(self.conv, self.bn, x, None, self.int8)


def _up(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample (``BiFPNLayer._up``)."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


#: (fusion weight, number of inputs) of a BiFPN layer, in the order of
#: ``BiFPNLayer.__call__``
_FUSIONS = (("p6_w1", 2), ("p5_w1", 2), ("p4_w1", 2), ("p3_w1", 2),
            ("p4_w2", 3), ("p5_w2", 3), ("p6_w2", 3), ("p7_w2", 2))
_SEPARABLE = ("conv6_up", "conv5_up", "conv4_up", "conv3_up",
              "conv4_down", "conv5_down", "conv6_down", "conv7_down")


class BiFPNLayer(nn.Module):
    """One BiFPN layer (``efficientdet.py:300``).  A ``first_time`` layer
    takes the trunk's (C3, C4, C5) with channels ``in_channels`` and owns
    the laterals; later layers take the five 64-channel (P3..P7) maps."""

    def __init__(self, channels: int, first_time: bool = False, attention: bool = True,
                 in_channels: Sequence[int] = (), int8: bool = False):
        super().__init__()
        ch = channels
        if first_time:
            c3, c4, c5 = in_channels
            self.p3_down_channel = _DownChannel(c3, ch, int8)
            self.p4_down_channel = _DownChannel(c4, ch, int8)
            self.p5_down_channel = _DownChannel(c5, ch, int8)
            self.p5_to_p6 = _DownChannel(c5, ch, int8)
            self.p4_down_channel_2 = _DownChannel(c4, ch, int8)
            self.p5_down_channel_2 = _DownChannel(c5, ch, int8)
        for name in _SEPARABLE:
            self.add_module(name, SeparableConvBlock(ch, ch, int8=int8))
        if attention:
            for name, n in _FUSIONS:
                self.register_parameter(name, nn.Parameter(torch.ones(n)))
        self.first_time = first_time
        self.attention = attention

    def _fuse(self, name: str, inputs: List[torch.Tensor]) -> torch.Tensor:
        if not self.attention:
            acc = inputs[0]
            for x in inputs[1:]:
                acc = acc + x
            return F.silu(acc)
        w = F.relu(getattr(self, name))
        w = w / (w.sum() + 1e-4)
        acc = w[0] * inputs[0]
        for wi, x in zip(w[1:], inputs[1:]):
            acc = acc + wi * x
        return F.silu(acc)

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        if self.first_time:
            c3, c4, c5 = feats
            p3_in = self.p3_down_channel(c3)
            p4_in = self.p4_down_channel(c4)
            p5_in = self.p5_down_channel(c5)
            p6_in = same_pool(self.p5_to_p6(c5))
            p7_in = same_pool(p6_in)
            p4_in_2 = self.p4_down_channel_2(c4)
            p5_in_2 = self.p5_down_channel_2(c5)
        else:
            p3_in, p4_in, p5_in, p6_in, p7_in = feats
            p4_in_2, p5_in_2 = p4_in, p5_in
        # top-down
        p6_td = self.conv6_up(self._fuse("p6_w1", [p6_in, _up(p7_in)]))
        p5_td = self.conv5_up(self._fuse("p5_w1", [p5_in, _up(p6_td)]))
        p4_td = self.conv4_up(self._fuse("p4_w1", [p4_in, _up(p5_td)]))
        p3_out = self.conv3_up(self._fuse("p3_w1", [p3_in, _up(p4_td)]))
        # bottom-up
        p4_out = self.conv4_down(self._fuse("p4_w2", [p4_in_2, p4_td, same_pool(p3_out)]))
        p5_out = self.conv5_down(self._fuse("p5_w2", [p5_in_2, p5_td, same_pool(p4_out)]))
        p6_out = self.conv6_down(self._fuse("p6_w2", [p6_in, p6_td, same_pool(p5_out)]))
        p7_out = self.conv7_down(self._fuse("p7_w2", [p7_in, same_pool(p6_out)]))
        return p3_out, p4_out, p5_out, p6_out, p7_out


class PredictionHead(nn.Module):
    """Shared separable convs (no BN inside), per-level BatchNorm
    ``bn_l{level}_c{conv}`` + SiLU, biased ``header`` projection
    (``efficientdet.py:398``)."""

    def __init__(self, channels: int, layers: int, out_features: int, levels: int = 5,
                 int8: bool = False):
        super().__init__()
        for i in range(layers):
            self.add_module(f"conv{i}", SeparableConvBlock(channels, channels, use_bn=False,
                                                           int8=int8))
        self.header = SeparableConvBlock(channels, out_features, use_bn=False, quantize=False)
        for li in range(levels):
            for ci in range(layers):
                self.add_module(f"bn_l{li}_c{ci}", _bn(channels))
        self.layers = layers

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        outs = []
        for li, h in enumerate(feats):
            for ci in range(self.layers):
                h = getattr(self, f"conv{ci}")(h)
                h = F.silu(getattr(self, f"bn_l{li}_c{ci}")(h))
            outs.append(self.header(h))
        return outs


@dataclass(frozen=True)
class EfficientDetSpec:
    """``efficientdet.py:432``: ``compound`` 0-7; ``input_size_override``
    serves a square size that is a multiple of 128 instead of the
    paper's."""

    compound: int = 0
    num_classes: int = 90
    input_size_override: object = None

    @property
    def config(self):
        return _D_CONFIGS[self.compound]

    @property
    def input_size(self) -> int:
        if self.input_size_override is not None:
            s = int(self.input_size_override)
            if s % 128:
                raise ValueError(f"input_size_override {s} not a multiple of 128 (P7 stride)")
            return s
        return self.config[2]

    @property
    def anchor_scale(self) -> float:
        """zylo117's default: 5.0 for D7, else 4.0."""
        return 5.0 if self.compound == 7 else 4.0


def build_anchors(input_size: int, anchor_scale: float = 4.0) -> np.ndarray:
    """Static (N, 4) anchors (y1, x1, y2, x2) over P3..P7, cell-major with
    9 anchors interleaved per cell (``efficientdet.py:467``)."""
    scales = [2 ** 0, 2 ** (1.0 / 3), 2 ** (2.0 / 3)]
    ratios = [(1.0, 1.0), (1.4, 0.7), (0.7, 1.4)]
    per_level = []
    for level in range(3, 8):
        stride = 2 ** level
        base = anchor_scale * stride
        fsize = input_size // stride
        cy, cx = np.meshgrid(
            (np.arange(fsize) + 0.5) * stride, (np.arange(fsize) + 0.5) * stride, indexing="ij"
        )
        boxes = []
        for scale in scales:
            for rw, rh in ratios:
                w = base * scale * rw / 2.0
                h = base * scale * rh / 2.0
                boxes.append(np.stack([cy - h, cx - w, cy + h, cx + w], axis=-1).reshape(-1, 4))
        per_level.append(np.stack(boxes, axis=1).reshape(-1, 4))
    return np.concatenate(per_level, axis=0)


@functools.lru_cache(maxsize=16)
def _anchors_on(input_size: int, anchor_scale: float, device: str) -> torch.Tensor:
    return torch.as_tensor(build_anchors(input_size, anchor_scale), dtype=torch.float32,
                           device=device)


def decode_boxes(regression: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) (dy, dx, dh, dw) regression against (N, 4) anchors ->
    xyxy boxes (zylo117 BBoxTransform, ``efficientdet.py:499``)."""
    ay = (anchors[:, 0] + anchors[:, 2]) / 2
    ax = (anchors[:, 1] + anchors[:, 3]) / 2
    ah = anchors[:, 2] - anchors[:, 0]
    aw = anchors[:, 3] - anchors[:, 1]
    dy, dx, dh, dw = regression.unbind(-1)
    cy = dy * ah + ay
    cx = dx * aw + ax
    h = torch.exp(dh) * ah
    w = torch.exp(dw) * aw
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


class EfficientDet(nn.Module):
    """The full detector (``efficientdet.py:520``): (B, 3, S, S) -> (boxes
    xyxy (B, N, 4), class probs (B, N, num_classes)), anchors decoded
    inside."""

    def __init__(self, spec: EfficientDetSpec, int8: bool = False):
        super().__init__()
        width, depth, _, fpn_ch, fpn_layers, head_layers = spec.config
        self.spec = spec
        self.backbone = EfficientNetFeatures(width, depth, int8=int8)
        plan = self.backbone.plan
        # C3, C4, C5 are the outputs of the blocks before the last two
        # stride-2 blocks and of the last block
        down = [i for i, (_, _, s, _) in enumerate(plan) if s == 2]
        taps = (plan[down[-2] - 1][3], plan[down[-1] - 1][3], plan[-1][3])
        for i in range(fpn_layers):
            self.add_module(f"bifpn{i}", BiFPNLayer(
                fpn_ch, first_time=i == 0, attention=spec.compound < 6,
                in_channels=taps if i == 0 else (), int8=int8,
            ))
        self.fpn_layers = fpn_layers
        self.regressor = PredictionHead(fpn_ch, head_layers, 9 * 4, int8=int8)
        self.classifier = PredictionHead(fpn_ch, head_layers, 9 * spec.num_classes, int8=int8)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = self.backbone(x)
        for i in range(self.fpn_layers):
            feats = getattr(self, f"bifpn{i}")(feats)
        b, nc = x.shape[0], self.spec.num_classes
        # NCHW -> the NHWC (cell, anchor, value) order of the reference
        box = torch.cat([o.permute(0, 2, 3, 1).reshape(b, -1, 4)
                         for o in self.regressor(feats)], dim=1)
        cls = torch.cat([o.permute(0, 2, 3, 1).reshape(b, -1, nc)
                         for o in self.classifier(feats)], dim=1)
        anchors = _anchors_on(x.shape[-2], self.spec.anchor_scale, str(x.device))
        return decode_boxes(box, anchors.to(box.dtype)), torch.sigmoid(cls)
