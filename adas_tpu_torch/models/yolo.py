"""YOLOv8 detector (port of the v8 branch of ``adas_tpu/models/yolo.py``):
C2f/SPPF CSP backbone + PAN neck, anchor-free DFL head, output
(B, 4+nc, N) like the official ONNX export.

Module names follow the flax tree (``net.stem``, ``net.stage1.m0.cv1``,
``head.box0_0`` ...), so ``weights.py`` maps a flax variable tree onto
these modules by path.  The 3x3/2 stem ConvBN runs through the fused stem
kernel.

``int8=True`` builds the calibrated int8 serving net (the v8 branch under
``quantized("int8")``): every ConvBN but the stem is a W8A8 conv in the
NHWC int8 domain (``quant.py``), activations chain as s8 through the
epilogues and the 13 s8 concat groups (one per C2f/SPPF, two unified neck
groups A/B), the stage-1 bottlenecks that pass the fusion gate run
through the fused block kernel (``ops/block.py``), and the head's 1x1
predictors run in f32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops.block import fuse_gate, fused_block
from .layers import ConvBN, conv_epilogue, max_pool, resize_nearest_2x
from .quant import (
    Int8State,
    QTensor,
    as_float,
    channels,
    max_pool_q,
    qconcat,
    quantize_to,
    upsample2x_nhwc,
)

# depth_multiple, width_multiple, max_channels (ultralytics model cards)
_V8_SCALES = {
    "n": (1 / 3, 0.25, 1024),
    "s": (1 / 3, 0.50, 1024),
    "m": (2 / 3, 0.75, 768),
    "l": (1.0, 1.00, 512),
    "x": (1.0, 1.25, 512),
}


def _make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(math.ceil(x / divisor) * divisor))


@dataclass(frozen=True)
class YoloSpec:
    """Static geometry of a YOLOv8 model (``yolo.py:69``, v8 family)."""

    scale: str = "n"
    num_classes: int = 80
    input_size: Tuple[int, int] = (640, 640)
    strides: Tuple[int, ...] = (8, 16, 32)
    reg_max: int = 16  # DFL bins

    @property
    def channels(self) -> Sequence[int]:
        _, w, mc = _V8_SCALES[self.scale]
        return [_make_divisible(min(c, mc) * w) for c in (64, 128, 256, 512, 1024)]

    @property
    def depths(self) -> Sequence[int]:
        d, _, _ = _V8_SCALES[self.scale]
        return [max(1, round(n * d)) for n in (3, 6, 6, 3)]

    @property
    def num_anchors(self) -> int:
        h, w = self.input_size
        return sum((h // s) * (w // s) for s in self.strides)


class Bottleneck(nn.Module):
    """3x3 -> 3x3 with optional shortcut (``yolo.py:98``).  Under int8, a
    body whose output belongs to a concat group (``emit_scale``) runs both
    convs, the shortcut and the group requantize as one fused block when
    :func:`fuse_gate` passes (``Bottleneck._fused``, ``yolo.py:151``)."""

    def __init__(self, cin: int, features: int, shortcut: bool = True, int8: bool = False):
        super().__init__()
        self.cv1 = ConvBN(cin, features, 3, int8=int8)
        self.cv2 = ConvBN(features, features, 3, int8=int8)
        self.use_shortcut = shortcut and cin == features
        self.int8 = int8

    def forward(self, x, emit_scale=None):
        if not self.int8:
            y = self.cv2(self.cv1(x))
            return x + y if self.use_shortcut else y
        if self._fusable(x, emit_scale):
            return self._fused(x, emit_scale)
        y = self.cv1(x, emit_q=True)
        if emit_scale is not None and not self.use_shortcut:
            # the group quantize rides cv2's epilogue
            return self.cv2(y, emit_scale=emit_scale)
        y = self.cv2(y)
        if self.use_shortcut:
            y = as_float(x) + y
        if emit_scale is not None:
            y = quantize_to(y, emit_scale)
        return y

    def _fusable(self, x, emit_scale) -> bool:
        """Decided before anything runs: calibrated serving (a group scale
        and a QTensor input), a 3x3 body of one width, and the gate."""
        if self.cv1.conv.calibrating or emit_scale is None or not isinstance(x, QTensor):
            return False
        _, h, w, c = x.shape
        return self.cv1.conv.out_channels == c and fuse_gate(h, w, c)

    def _fused(self, x: QTensor, emit_scale: torch.Tensor) -> QTensor:
        c1, c2 = self.cv1.conv, self.cv2.conv
        y1s = c1.buffer_scale("ymax")
        if y1s is None:
            raise ValueError(
                "inconsistent calibration: a concat group scale is present but cv1's ymax "
                "is missing (recalibrate the model)"
            )
        s1, b1 = conv_epilogue(c1, self.cv1.bn, x.scale)
        s2, b2 = conv_epilogue(c2, self.cv2.bn, y1s)
        out = fused_block(
            x.data, x.scale, c1.qweight()[0], s1, b1, y1s, c2.qweight()[0], s2, b2,
            emit_scale, act1="silu", act2="silu", act_post=None, residual=self.use_shortcut,
        )
        return QTensor(out, emit_scale)


class C2f(Int8State, nn.Module):
    """Split + cascaded bottlenecks, concat all (``yolo.py:275``).  Under
    int8 the parts form one s8 concat group at ``concat_xmax``'s scale:
    cv1 emits at it, the split halves are s8 channel views, each
    bottleneck exit emits at it, and cv2 reads the s8 concat."""

    def __init__(self, cin: int, features: int, n: int = 1, shortcut: bool = False,
                 int8: bool = False):
        super().__init__()
        self.hidden = features // 2
        self.cv1 = ConvBN(cin, 2 * self.hidden, 1, int8=int8)
        self.n = n
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(self.hidden, self.hidden, shortcut, int8=int8))
        self.cv2 = ConvBN((2 + n) * self.hidden, features, 1, int8=int8)
        self.int8 = int8
        if int8:
            self._init_int8_buffers("concat_xmax")

    def forward(self, x, emit_q: bool = False, emit_scale=None):
        if not self.int8:
            y = self.cv1(x)
            parts = [y[:, : self.hidden], y[:, self.hidden:]]
            for i in range(self.n):
                parts.append(getattr(self, f"m{i}")(parts[-1]))
            return self.cv2(torch.cat(parts, dim=1))
        gscale = None if self.calibrating else self.buffer_scale("concat_xmax")
        y = self.cv1(x, emit_scale=gscale)
        parts = [channels(y, 0, self.hidden), channels(y, self.hidden, 2 * self.hidden)]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1], emit_scale=gscale))
        cat = qconcat(parts)
        if self.calibrating:
            self.record_max("concat_xmax", [cat])
        return self.cv2(cat, emit_q=emit_q, emit_scale=emit_scale)


class SPPF(Int8State, nn.Module):
    """Spatial pyramid pooling (fast): 3 cascaded 5x5 max pools
    (``yolo.py:328``).  Under int8 the pools run on s8 data and the four
    members form one concat group."""

    def __init__(self, cin: int, features: int, int8: bool = False):
        super().__init__()
        hidden = cin // 2
        self.cv1 = ConvBN(cin, hidden, 1, int8=int8)
        self.cv2 = ConvBN(4 * hidden, features, 1, int8=int8)
        self.int8 = int8
        if int8:
            self._init_int8_buffers("concat_xmax")

    def forward(self, x, emit_q: bool = False, emit_scale=None):
        if not self.int8:
            y = self.cv1(x)
            p1 = max_pool(y, 5, 1, pad=2)
            p2 = max_pool(p1, 5, 1, pad=2)
            p3 = max_pool(p2, 5, 1, pad=2)
            return self.cv2(torch.cat([y, p1, p2, p3], dim=1))
        gscale = None if self.calibrating else self.buffer_scale("concat_xmax")
        y = self.cv1(x, emit_scale=gscale)
        pool = max_pool_q if isinstance(y, QTensor) else _max_pool_nhwc
        p1 = pool(y, 5, 1, 2)
        p2 = pool(p1, 5, 1, 2)
        p3 = pool(p2, 5, 1, 2)
        cat = qconcat([y, p1, p2, p3])
        if self.calibrating:
            self.record_max("concat_xmax", [cat])
        return self.cv2(cat, emit_q=emit_q, emit_scale=emit_scale)


def _max_pool_nhwc(x: torch.Tensor, window: int, stride: int, pad: int) -> torch.Tensor:
    return max_pool(x.permute(0, 3, 1, 2), window, stride, pad).permute(0, 2, 3, 1)


class YoloBackboneNeck(Int8State, nn.Module):
    """CSP backbone + PAN neck (``yolo.py:513``, the v8 branch).  Under
    int8 the four PAN concats pair into two unified s8 groups sharing
    producers: A = {fpn4, pan5} concats at ``neck_a_xmax``, B = {fpn3,
    pan4} at ``neck_b_xmax``."""

    def __init__(self, spec: YoloSpec, int8: bool = False):
        super().__init__()
        ch, d = spec.channels, spec.depths
        q = dict(int8=int8)
        self.stem = ConvBN(3, ch[0], 3, 2, stem=True, **q)
        self.down1 = ConvBN(ch[0], ch[1], 3, 2, **q)
        self.stage1 = C2f(ch[1], ch[1], d[0], True, **q)
        self.down2 = ConvBN(ch[1], ch[2], 3, 2, **q)
        self.stage2 = C2f(ch[2], ch[2], d[1], True, **q)
        self.down3 = ConvBN(ch[2], ch[3], 3, 2, **q)
        self.stage3 = C2f(ch[3], ch[3], d[2], True, **q)
        self.down4 = ConvBN(ch[3], ch[4], 3, 2, **q)
        self.stage4 = C2f(ch[4], ch[4], d[3], True, **q)
        self.sppf = SPPF(ch[4], ch[4], **q)
        self.fpn4 = C2f(ch[4] + ch[3], ch[3], d[0], False, **q)
        self.fpn3 = C2f(ch[3] + ch[2], ch[2], d[0], False, **q)
        self.pan3 = ConvBN(ch[2], ch[2], 3, 2, **q)
        self.pan4 = C2f(ch[2] + ch[3], ch[3], d[0], False, **q)
        self.pan5_down = ConvBN(ch[3], ch[3], 3, 2, **q)
        self.pan5 = C2f(ch[3] + ch[4], ch[4], d[0], False, **q)
        self.int8 = int8
        if int8:
            self._init_int8_buffers("neck_a_xmax", "neck_b_xmax")

    def forward(self, x: torch.Tensor):
        if self.int8:
            return self._forward_int8(x)
        x = self.stage1(self.down1(self.stem(x)))
        p3 = self.stage2(self.down2(x))
        p4 = self.stage3(self.down3(p3))
        p5 = self.sppf(self.stage4(self.down4(p4)))
        t1 = self.fpn4(torch.cat([resize_nearest_2x(p5), p4], dim=1))
        n3 = self.fpn3(torch.cat([resize_nearest_2x(t1), p3], dim=1))
        n4 = self.pan4(torch.cat([self.pan3(n3), t1], dim=1))
        n5 = self.pan5(torch.cat([self.pan5_down(n4), p5], dim=1))
        return n3, n4, n5

    def _forward_int8(self, x: torch.Tensor):
        """``yolo.py:548-691`` (v8): NCHW input -> NHWC (n3, n4, n5), s8
        QTensors when calibrated.  The bf16 stem output enters the int8
        domain as an NHWC view; down1's input quantize writes it NHWC."""
        cal = self.calibrating
        ga = None if cal else self.buffer_scale("neck_a_xmax")
        gb = None if cal else self.buffer_scale("neck_b_xmax")
        x = self.stem(x).permute(0, 2, 3, 1)
        x = self.down1(x, emit_q=True)
        x = self.stage1(x, emit_q=True)
        x = self.down2(x, emit_q=True)
        p3 = self.stage2(x, emit_scale=gb)
        x = self.down3(p3, emit_q=True)
        p4 = self.stage3(x, emit_scale=ga)
        x = self.down4(p4, emit_q=True)
        x = self.stage4(x, emit_q=True)
        p5 = self.sppf(x, emit_scale=ga)
        cat_a1 = qconcat([upsample2x_nhwc(p5), p4])
        t1 = self.fpn4(cat_a1, emit_scale=gb)
        cat_b1 = qconcat([upsample2x_nhwc(t1), p3])
        n3 = self.fpn3(cat_b1, emit_q=True)
        cat_b2 = qconcat([self.pan3(n3, emit_scale=gb), t1])
        n4 = self.pan4(cat_b2, emit_q=True)
        cat_a2 = qconcat([self.pan5_down(n4, emit_scale=ga), p5])
        n5 = self.pan5(cat_a2, emit_q=True)
        if cal:
            self.record_max("neck_a_xmax", [cat_a1, cat_a2])
            self.record_max("neck_b_xmax", [cat_b1, cat_b2])
        return n3, n4, n5


def _anchor_points(input_size, strides: Sequence[int], device):
    """Grid-cell centres (2, N) as (x, y) and per-anchor stride (N,),
    flattened over levels in row-major order (``yolo.py:703``)."""
    points, strides_out = [], []
    h, w = input_size
    for s in strides:
        gh, gw = h // s, w // s
        ys, xs = torch.meshgrid(
            torch.arange(gh, dtype=torch.float32, device=device) + 0.5,
            torch.arange(gw, dtype=torch.float32, device=device) + 0.5,
            indexing="ij",
        )
        points.append(torch.stack([xs.reshape(-1), ys.reshape(-1)]))
        strides_out.append(torch.full((gh * gw,), float(s), device=device))
    return torch.cat(points, dim=1), torch.cat(strides_out)


def _dfl_decode(box_logits: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Distribution-focal decode (``yolo.py:694``): (B, 4*reg_max, N) ->
    (B, 4, N) ltrb as the softmax expectation over the bins."""
    b, _, n = box_logits.shape
    probs = torch.softmax(box_logits.reshape(b, 4, reg_max, n), dim=2)
    bins = torch.arange(reg_max, dtype=probs.dtype, device=probs.device)
    return torch.sum(probs * bins.view(1, 1, -1, 1), dim=2)


def _predict_f32(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 predictor on an NHWC bf16 activation in f32 (flax promotes
    the bf16 input to its f32 params) -> (B, H*W, out)."""
    w = conv.weight.float().reshape(conv.out_channels, -1)
    y = torch.nn.functional.linear(x.float(), w, conv.bias.float())
    return y.reshape(y.shape[0], -1, y.shape[-1])


class DetectHeadV8(nn.Module):
    """Anchor-free decoupled head with DFL (``yolo.py:721``).  Under int8
    the 3x3 convs are W8A8 (``box*_0``/``cls*_0`` emit s8 to their
    successor) and the 1x1 predictors run in f32 on NHWC features."""

    def __init__(self, spec: YoloSpec, int8: bool = False):
        super().__init__()
        self.spec = spec
        self.int8 = int8
        ch, nc = spec.channels, spec.num_classes
        c2 = max(16, ch[2] // 4, spec.reg_max * 4)
        c3 = max(ch[2], min(nc, 100))
        for li, cin in enumerate((ch[2], ch[3], ch[4])):
            self.add_module(f"box{li}_0", ConvBN(cin, c2, 3, int8=int8))
            self.add_module(f"box{li}_1", ConvBN(c2, c2, 3, int8=int8))
            self.add_module(f"box{li}_2", nn.Conv2d(c2, 4 * spec.reg_max, 1))
            self.add_module(f"cls{li}_0", ConvBN(cin, c3, 3, int8=int8))
            self.add_module(f"cls{li}_1", ConvBN(c3, c3, 3, int8=int8))
            self.add_module(f"cls{li}_2", nn.Conv2d(c3, nc, 1))

    def forward(self, feats) -> torch.Tensor:
        s = self.spec
        boxes, clss = [], []
        for li, f in enumerate(feats):
            if self.int8:
                box = getattr(self, f"box{li}_1")(getattr(self, f"box{li}_0")(f, emit_q=True))
                cls = getattr(self, f"cls{li}_1")(getattr(self, f"cls{li}_0")(f, emit_q=True))
                boxes.append(_predict_f32(getattr(self, f"box{li}_2"), box).transpose(1, 2))
                clss.append(_predict_f32(getattr(self, f"cls{li}_2"), cls).transpose(1, 2))
                continue
            box, cls = f, f
            for j in range(3):
                box = getattr(self, f"box{li}_{j}")(box)
                cls = getattr(self, f"cls{li}_{j}")(cls)
            boxes.append(box.flatten(2))
            clss.append(cls.flatten(2))
        ltrb = _dfl_decode(torch.cat(boxes, dim=2), s.reg_max).float()
        anchors, strides = _anchor_points(s.input_size, s.strides, ltrb.device)
        x1y1 = anchors - ltrb[:, :2]
        x2y2 = anchors + ltrb[:, 2:]
        xywh = torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=1) * strides
        # boxes decode in f32 (the JAX head's f32 anchors promote them);
        # class scores are the net dtype's sigmoid, widened
        return torch.cat([xywh, torch.sigmoid(torch.cat(clss, dim=2)).float()], dim=1)


class YoloV8(nn.Module):
    """YOLOv8-contract detector: output (B, 4+nc, N) (``yolo.py:788``);
    NCHW input in every precision."""

    def __init__(self, spec: YoloSpec, int8: bool = False):
        super().__init__()
        self.spec = spec
        self.net = YoloBackboneNeck(spec, int8=int8)
        self.head = DetectHeadV8(spec, int8=int8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.net(x))
