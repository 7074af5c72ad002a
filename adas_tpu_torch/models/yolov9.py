"""YOLOv9 GELAN-C (port of ``adas_tpu/models/yolov9.py``): RepNCSPELAN4
stages over RepConvN bottlenecks, ADown downsamples, SPPELAN, a v8 PAN
neck and the v8 DFL head, output (B, 4+nc, N) (the v8 contract).

Module names follow the flax tree (``stage2.cv2_csp.m0.cv1.conv1``,
``pan5_down.cv2``, ``head.box0_0`` ...).  The float nets are NCHW; the int8
net (``int8=True``) is NHWC from its first conv on (``quant.py``): every
dense conv with more than 4 input channels is a W8A8 conv, the 3x3/2 stem
(3 channels) a bf16 conv, as in JAX (no Pallas stem: GELAN has no
``stem_s2d_ok``).  Under int8 the s8 concat groups are JAX's: one per
RepNCSP / RepNCSPELAN4 / SPPELAN, a block-local one for an ADown whose
consumer chains s8, and the two unified neck groups A = {fpn4, pan5} and
B = {fpn3, pan4} (``neck_a_xmax`` / ``neck_b_xmax``, owned by
:class:`YoloV9`).  ADown's average pool is outside the int8 policy: it
reads the bf16 view.  RepConvN keeps its training form, two int8 convs
(3x3 and 1x1, no activation) whose bf16 sum takes the SiLU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvBN
from .quant import QTensor, as_float, quantize_to
from .yolo import DetectHeadV8, YoloSpec, _Group, cat_, pool_, slice_, up2_, width


class RepConvN(nn.Module):
    """3x3 + 1x1 ConvBN branches (no activation) summed, then SiLU
    (``yolov9.py:28``)."""

    def __init__(self, cin: int, features: int, stride: int = 1, int8: bool = False):
        super().__init__()
        self.conv1 = ConvBN(cin, features, 3, stride, act=None, int8=int8)
        self.conv2 = ConvBN(cin, features, 1, stride, act=None, int8=int8)

    def forward(self, x):
        return F.silu(self.conv1(x) + self.conv2(x))


class RepNBottleneck(nn.Module):
    """RepConvN -> 3x3 ConvBN, + shortcut on the input's bf16 view
    (``yolov9.py:48``)."""

    def __init__(self, cin: int, features: int, shortcut: bool = True, expansion: float = 0.5,
                 int8: bool = False):
        super().__init__()
        hidden = int(features * expansion)
        self.cv1 = RepConvN(cin, hidden, int8=int8)
        self.cv2 = ConvBN(hidden, features, 3, int8=int8)
        self.add = shortcut and cin == features

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return as_float(x) + y if self.add else y


class RepNCSP(_Group):
    """CSP block over RepNBottlenecks (``yolov9.py:67``).  Under int8 the
    two branch exits form one s8 group: the bottleneck exit (a residual
    add) is quantized into it, cv2 emits at it."""

    def __init__(self, cin: int, features: int, n: int = 1, shortcut: bool = True,
                 int8: bool = False):
        super().__init__()
        hidden = int(features * 0.5)
        self.cv1 = ConvBN(cin, hidden, 1, int8=int8)
        self.n = n
        for i in range(n):
            self.add_module(f"m{i}", RepNBottleneck(hidden, hidden, shortcut, 1.0, int8=int8))
        self.cv2 = ConvBN(cin, hidden, 1, int8=int8)
        self.cv3 = ConvBN(2 * hidden, features, 1, int8=int8)
        self._init_group(int8)

    def forward(self, x, emit_q: bool = False, emit_scale=None):
        gscale = self.group_scale()
        a = self.cv1(x, emit_q=True)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a)
        if gscale is not None and not isinstance(a, QTensor):
            a = quantize_to(a, gscale)
        b = self.cv2(x, emit_scale=gscale)
        return self.cv3(self.group_concat([a, b]), emit_q=emit_q, emit_scale=emit_scale)


class RepNCSPELAN4(_Group):
    """GELAN aggregation (``yolov9.py:104``): cv1 split in halves, two
    RepNCSP -> 3x3 branches chained off the second half, all four parts
    concatenated (one s8 group under int8), cv4."""

    def __init__(self, cin: int, c2: int, c3: int, c4: int, n: int = 1, int8: bool = False):
        super().__init__()
        self.half = c3 // 2
        q = dict(int8=int8)
        self.cv1 = ConvBN(cin, c3, 1, **q)
        self.cv2_csp = RepNCSP(self.half, c4, n, **q)
        self.cv2_conv = ConvBN(c4, c4, 3, **q)
        self.cv3_csp = RepNCSP(c4, c4, n, **q)
        self.cv3_conv = ConvBN(c4, c4, 3, **q)
        self.cv4 = ConvBN(c3 + 2 * c4, c2, 1, **q)
        self._init_group(int8)

    def forward(self, x, emit_q: bool = False, emit_scale=None):
        gscale = self.group_scale()
        y = self.cv1(x, emit_scale=gscale)
        h, c3 = self.half, 2 * self.half
        parts = [slice_(y, 0, h, self.int8), slice_(y, h, c3, self.int8)]
        h = self.cv2_conv(self.cv2_csp(parts[-1], emit_q=True), emit_scale=gscale)
        parts.append(h)
        parts.append(self.cv3_conv(self.cv3_csp(h, emit_q=True), emit_scale=gscale))
        return self.cv4(self.group_concat(parts), emit_q=emit_q, emit_scale=emit_scale)


def _avg_pool2(x: torch.Tensor, int8: bool) -> torch.Tensor:
    """torch ``F.avg_pool2d(x, 2, 1, 0)``: unpadded, the map shrinks to
    (H-1, W-1) (``yolov9.py:162-168``)."""
    if int8:
        return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 1).permute(0, 2, 3, 1)
    return F.avg_pool2d(x, 2, 1)


class ADown(_Group):
    """Attentional downsample (``yolov9.py:147``): 2x2/1 average pool, then
    a 3x3/2 conv on one half and a 3x3/2 max pool + 1x1 on the other,
    concatenated.  Under int8 the pool reads the bf16 view, and both convs
    emit at the caller's group scale, or at the block's own group when the
    consumer chains s8 (``emit_q``)."""

    def __init__(self, cin: int, features: int, int8: bool = False):
        super().__init__()
        half = features // 2
        self.cv1 = ConvBN(cin // 2, half, 3, 2, int8=int8)
        self.cv2 = ConvBN(cin // 2, half, 1, int8=int8)
        self._init_group(int8)

    def forward(self, x, emit_q: bool = False, emit_scale=None):
        x = _avg_pool2(as_float(x), self.int8)
        c = width(x, self.int8) // 2
        gscale = emit_scale
        if gscale is None and emit_q:
            gscale = self.group_scale()
        x1 = self.cv1(slice_(x, 0, c, self.int8), emit_scale=gscale)
        x2 = pool_(slice_(x, c, 2 * c, self.int8), 3, 2, 1, self.int8)
        cat = cat_([x1, self.cv2(x2, emit_scale=gscale)], self.int8)
        if emit_q and emit_scale is None:
            self.group_record([cat])
        return cat


class SPPELAN(_Group):
    """1x1 in, three cascaded 5x5 max pools, concat (one s8 group), 1x1
    out (``yolov9.py:191``)."""

    def __init__(self, cin: int, c2: int, c3: int, int8: bool = False):
        super().__init__()
        self.cv1 = ConvBN(cin, c3, 1, int8=int8)
        self.cv5 = ConvBN(4 * c3, c2, 1, int8=int8)
        self._init_group(int8)

    def forward(self, x, emit_q: bool = False, emit_scale=None):
        y = self.cv1(x, emit_scale=self.group_scale())
        p1 = pool_(y, 5, 1, 2, self.int8)
        p2 = pool_(p1, 5, 1, 2, self.int8)
        p3 = pool_(p2, 5, 1, 2, self.int8)
        return self.cv5(self.group_concat([y, p1, p2, p3]), emit_q=emit_q,
                        emit_scale=emit_scale)


@dataclass(frozen=True)
class GelanConfig:
    """Channel plan of a GELAN scale (``yolov9.py:218``): (c2, c3, c4, n)
    per ELAN stage."""

    stem: Sequence[int]
    stages: Sequence[Tuple[int, int, int, int]]
    downs: Sequence[int]
    sppelan: Tuple[int, int]
    neck: Sequence[Tuple[int, int, int, int]]  # fpn4, fpn3, pan4, pan5
    neck_downs: Sequence[int]  # pan3, pan5_down


GELAN_CONFIGS = {
    "c": GelanConfig(
        stem=(64, 128),
        stages=((256, 128, 64, 1), (512, 256, 128, 1), (512, 512, 256, 1), (512, 512, 256, 1)),
        downs=(256, 512, 512),
        sppelan=(512, 256),
        neck=((512, 512, 256, 1), (256, 256, 128, 1), (512, 512, 256, 1), (512, 512, 256, 1)),
        neck_downs=(256, 512),
    ),
}


class YoloV9(_Group):
    """GELAN trunk + v8 DFL head (``yolov9.py:252``): NCHW input in every
    precision, output (B, 4+nc, N)."""

    def __init__(self, spec: YoloSpec, int8: bool = False):
        super().__init__()
        self.spec = spec
        cfg = GELAN_CONFIGS[spec.scale]
        q = dict(int8=int8)
        st, dn, nk = cfg.stages, cfg.downs, cfg.neck
        self.stem = ConvBN(3, cfg.stem[0], 3, 2, **q)
        self.down1 = ConvBN(cfg.stem[0], cfg.stem[1], 3, 2, **q)
        self.stage1 = RepNCSPELAN4(cfg.stem[1], *st[0], **q)
        self.down2 = ADown(st[0][0], dn[0], **q)
        self.stage2 = RepNCSPELAN4(dn[0], *st[1], **q)
        self.down3 = ADown(st[1][0], dn[1], **q)
        self.stage3 = RepNCSPELAN4(dn[1], *st[2], **q)
        self.down4 = ADown(st[2][0], dn[2], **q)
        self.stage4 = RepNCSPELAN4(dn[2], *st[3], **q)
        self.sppelan = SPPELAN(st[3][0], *cfg.sppelan, **q)
        p5 = cfg.sppelan[0]
        self.fpn4 = RepNCSPELAN4(p5 + st[2][0], *nk[0], **q)
        self.fpn3 = RepNCSPELAN4(nk[0][0] + st[1][0], *nk[1], **q)
        self.pan3 = ADown(nk[1][0], cfg.neck_downs[0], **q)
        self.pan4 = RepNCSPELAN4(cfg.neck_downs[0] + nk[0][0], *nk[2], **q)
        self.pan5_down = ADown(nk[2][0], cfg.neck_downs[1], **q)
        self.pan5 = RepNCSPELAN4(cfg.neck_downs[1] + p5, *nk[3], **q)
        self.head = DetectHeadV8(spec, **q)
        self._init_group(int8, "neck_a_xmax", "neck_b_xmax")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        i8 = self.int8
        if i8:
            x = x.permute(0, 2, 3, 1)  # the int8 domain is NHWC (a view)
        ga, gb = self.group_scale("neck_a_xmax"), self.group_scale("neck_b_xmax")
        h = self.down1(self.stem(x), emit_q=True)
        h = self.down2(self.stage1(h), emit_q=True)
        p3 = self.stage2(h, emit_scale=gb)
        p4 = self.stage3(self.down3(p3, emit_q=True), emit_scale=ga)
        h = self.stage4(self.down4(p4, emit_q=True), emit_q=True)
        p5 = self.sppelan(h, emit_scale=ga)
        rec_a = [cat_([up2_(p5, i8), p4], i8)]
        t1 = self.fpn4(rec_a[0], emit_scale=gb)
        rec_b = [cat_([up2_(t1, i8), p3], i8)]
        n3 = self.fpn3(rec_b[0], emit_q=True)
        rec_b.append(cat_([self.pan3(n3, emit_scale=gb), t1], i8))
        n4 = self.pan4(rec_b[1], emit_q=True)
        rec_a.append(cat_([self.pan5_down(n4, emit_scale=ga), p5], i8))
        n5 = self.pan5(rec_a[1], emit_q=True)
        self.group_record(rec_a, "neck_a_xmax")
        self.group_record(rec_b, "neck_b_xmax")
        return torch.cat(self.head((n3, n4, n5)), dim=1)
