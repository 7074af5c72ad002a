"""YOLOv5-lite e/s/g (port of ``adas_tpu/models/yolov5lite.py``): e/s on
a ShuffleNetV2 trunk (``StemBlock`` + three stages of ``ShuffleV2Block``),
g on a RepVGG trunk in deploy form (3x3 ConvBN + ReLU per block, SPP with
parallel 5/9/13 pools), both under a single-width v5 PAN of ``C3`` blocks
and a per-level 1x1 anchor head.  The output is the v5-lite export's:
sigmoided pre-grid (B, N, 5+nc) rows, anchor-major per level, which
``ops/yolo_decode.v5lite_grid_decode`` grid-decodes.

Module names follow the flax tree (``backbone.stage0_1.b2_pw1``,
``backbone.rep3_7``, ``neck.fpn4.m0.cv2`` ...).  The float nets are NCHW;
the int8 net NHWC from its first conv (3 input channels: bf16).  The
ShuffleNet blocks' 1x1 convs are W8A8 (on s's 58- and 116-wide halves
through the int8 conv's padded operands), their depthwise convs bf16,
and their outputs bf16 (a channel shuffle is no conv epilogue): each
1x1 quantizes its input at its calibrated scale.  The s8 groups are
JAX's: one per C3 and SPP, and the two unified neck groups A = {fpn4,
pan5} and B = {fpn3, pan4} (owned by :class:`YoloV5Lite`), into which the
ShuffleNet taps are quantized explicitly and the g trunk's tap stages
emit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvBN
from .quant import QTensor, quantize_to
from .yolo import (
    C3,
    V5_ANCHORS,
    YoloSpec,
    _Group,
    cat_,
    pool_,
    predict_nhwc,
    slice_,
    up2_,
    width,
)

#: scale -> (stem width, stage widths, stride-1 repeats per stage, neck
#: width) (``yolov5lite.py:45``)
V5LITE_PLANS = {
    "e": (24, (48, 96, 192), (3, 7, 3), 64),
    "s": (32, (116, 232, 464), (3, 7, 3), 96),
}
#: the g trunk: RepVGG stage widths and blocks, neck width (``yolov5lite.py:64``)
V5LITE_G_PLAN = {"widths": (48, 48, 96, 192, 384), "blocks": (1, 2, 4, 14, 1), "neck": 128}
SCALES = (*V5LITE_PLANS, "g")


def channel_shuffle2(x: torch.Tensor, int8: bool) -> torch.Tensor:
    """ShuffleNetV2's shuffle of two groups (``yolov5lite.py:77``): the two
    concatenated halves interleaved channel by channel."""
    if int8:
        b, h, w, c = x.shape
        return x.reshape(b, h, w, 2, c // 2).transpose(3, 4).reshape(b, h, w, c)
    b, c, h, w = x.shape
    return x.reshape(b, 2, c // 2, h, w).transpose(1, 2).reshape(b, c, h, w)


class StemBlock(nn.Module):
    """3x3/2 conv, then (1x1 -> 3x3/2) || 2x2/2 ceil-mode max pool,
    concatenated, 1x1 (``yolov5lite.py:88``): stride 4."""

    def __init__(self, features: int, int8: bool = False):
        super().__init__()
        c = features
        self.stem_1 = ConvBN(3, c, 3, 2, int8=int8)
        self.stem_2a = ConvBN(c, c // 2, 1, int8=int8)
        self.stem_2b = ConvBN(c // 2, c, 3, 2, int8=int8)
        self.stem_3 = ConvBN(2 * c, c, 1, int8=int8)
        self.int8 = int8

    def forward(self, x):
        s1 = self.stem_1(x)
        y = self.stem_2b(self.stem_2a(s1))
        # torch MaxPool2d(2, 2, ceil_mode=True): -inf past an odd edge
        if self.int8:
            p = F.max_pool2d(s1.permute(0, 3, 1, 2), 2, 2, ceil_mode=True).permute(0, 2, 3, 1)
        else:
            p = F.max_pool2d(s1, 2, 2, ceil_mode=True)
        return self.stem_3(cat_([y, p], self.int8))


class ShuffleV2Block(nn.Module):
    """The ShuffleNetV2 unit (``yolov5lite.py:112``): stride 1 splits the
    channels and transforms the second half (1x1 ReLU, 3x3 depthwise, 1x1
    ReLU); stride 2 transforms both branches (depthwise 3x3/2 + 1x1 ReLU on
    the first); concat, shuffle."""

    def __init__(self, cin: int, features: int, stride: int = 1, int8: bool = False):
        super().__init__()
        bf = features // 2
        self.down = stride != 1
        q = dict(int8=int8)
        if self.down:
            self.b1_dw = ConvBN(cin, cin, 3, stride, act=None, groups=cin, **q)
            self.b1_pw = ConvBN(cin, bf, 1, act="relu", **q)
        b2_in = cin if self.down else cin // 2
        self.b2_pw1 = ConvBN(b2_in, bf, 1, act="relu", **q)
        self.b2_dw = ConvBN(bf, bf, 3, stride, act=None, groups=bf, **q)
        self.b2_pw2 = ConvBN(bf, bf, 1, act="relu", **q)
        self.int8 = int8

    def forward(self, x):
        if self.down:
            b1, b2 = self.b1_pw(self.b1_dw(x)), x
        else:
            c = width(x, self.int8)
            b1, b2 = slice_(x, 0, c // 2, self.int8), slice_(x, c // 2, c, self.int8)
        y = self.b2_pw2(self.b2_dw(self.b2_pw1(b2)))
        return channel_shuffle2(cat_([b1, y], self.int8), self.int8)


class SPPv5(_Group):
    """v5's SPP (``yolov5lite.py:141``): 1x1 to half width, three parallel
    5/9/13 max pools (s8 under int8), concat (one s8 group), 1x1."""

    def __init__(self, cin: int, features: int, int8: bool = False):
        super().__init__()
        hidden = cin // 2
        self.cv1 = ConvBN(cin, hidden, 1, int8=int8)
        self.cv2 = ConvBN(4 * hidden, features, 1, int8=int8)
        self._init_group(int8)

    def forward(self, x, emit_q: bool = False, emit_scale=None):
        y = self.cv1(x, emit_scale=self.group_scale())
        pools = [pool_(y, k, 1, k // 2, self.int8) for k in (5, 9, 13)]
        return self.cv2(self.group_concat([y, *pools]), emit_q=emit_q, emit_scale=emit_scale)


class RepBackbone(nn.Module):
    """The g trunk in deploy form (``yolov5lite.py:171``): per stage a
    3x3/2 ConvBN + ReLU and 3x3 ones, P3/P4 from stages 2 and 3, SPP on
    stage 4.  Under int8 every edge chains s8; a tap stage's last block
    emits at its neck group's scale."""

    def __init__(self, int8: bool = False):
        super().__init__()
        cin = 3
        for si, (w, n) in enumerate(zip(V5LITE_G_PLAN["widths"], V5LITE_G_PLAN["blocks"])):
            for bi in range(n):
                self.add_module(f"rep{si}_{bi}", ConvBN(cin if bi == 0 else w, w, 3,
                                                        2 if bi == 0 else 1, act="relu",
                                                        int8=int8))
            cin = w
        self.spp = SPPv5(cin, cin, int8=int8)

    def forward(self, x, emit_p3=None, emit_p4=None):
        feats = []
        for si, n in enumerate(V5LITE_G_PLAN["blocks"]):
            tap = si in (2, 3)
            for bi in range(n):
                exit_ = tap and bi == n - 1
                x = getattr(self, f"rep{si}_{bi}")(
                    x, emit_q=not exit_,
                    emit_scale=(emit_p3 if si == 2 else emit_p4) if exit_ else None)
            if tap:
                feats.append(x)
        feats.append(self.spp(x, emit_q=True))
        return tuple(feats)


class LiteBackbone(nn.Module):
    """StemBlock + three ShuffleNetV2 stages -> (P3, P4, P5) at strides 8,
    16, 32 (``yolov5lite.py:231``)."""

    def __init__(self, scale: str, int8: bool = False):
        super().__init__()
        stem, stages, repeats, _ = V5LITE_PLANS[scale]
        self.stem = StemBlock(stem, int8=int8)
        cin = stem
        for si, (ch, reps) in enumerate(zip(stages, repeats)):
            self.add_module(f"stage{si}_down", ShuffleV2Block(cin, ch, 2, int8=int8))
            for ri in range(reps):
                self.add_module(f"stage{si}_{ri}", ShuffleV2Block(ch, ch, int8=int8))
            cin = ch
        self.repeats = repeats

    def forward(self, x, emit_p3=None, emit_p4=None):
        x = self.stem(x)
        feats = []
        for si, reps in enumerate(self.repeats):
            x = getattr(self, f"stage{si}_down")(x)
            for ri in range(reps):
                x = getattr(self, f"stage{si}_{ri}")(x)
            feats.append(x)
        return tuple(feats)


class LitePAN(nn.Module):
    """The single-width v5 PAN (``yolov5lite.py:252``): lateral 1x1s,
    nearest 2x, C3 fusions, stride-2 down path.  Under int8 the concats
    belong to the neck groups A (``ga``) and B (``gb``); the trunk's taps,
    when not already s8, are quantized into them."""

    def __init__(self, scale: str, tap_widths, int8: bool = False):
        super().__init__()
        w = V5LITE_G_PLAN["neck"] if scale == "g" else V5LITE_PLANS[scale][3]
        c3, c4, c5 = tap_widths
        q = dict(int8=int8)
        self.lat5 = ConvBN(c5, w, 1, **q)
        self.fpn4 = C3(w + c4, w, 1, False, **q)
        self.lat4 = ConvBN(w, w, 1, **q)
        self.fpn3 = C3(w + c3, w, 1, False, **q)
        self.pan3 = ConvBN(w, w, 3, 2, **q)
        self.pan4 = C3(2 * w, w, 1, False, **q)
        self.pan5_down = ConvBN(w, w, 3, 2, **q)
        self.pan5 = C3(2 * w, w, 1, False, **q)
        self.width = w
        self.int8 = int8

    def forward(self, feats, ga, gb, record):
        p3, p4, p5 = feats
        i8 = self.int8

        def gq(y, s):
            return quantize_to(y, s) if s is not None and not isinstance(y, QTensor) else y

        def cat(parts, key):
            y = cat_(parts, i8)
            record[key].append(y)
            return y

        l5 = self.lat5(p5, emit_scale=ga)
        t4 = self.fpn4(cat([up2_(l5, i8), gq(p4, ga)], "a"), emit_q=True)
        l4 = self.lat4(t4, emit_scale=gb)
        n3 = self.fpn3(cat([up2_(l4, i8), gq(p3, gb)], "b"))
        n4 = self.pan4(cat([self.pan3(n3, emit_scale=gb), l4], "b"))
        n5 = self.pan5(cat([self.pan5_down(n4, emit_scale=ga), l5], "a"))
        return n3, n4, n5


class YoloV5Lite(_Group):
    """YOLOv5-lite (``yolov5lite.py:306``): NCHW input in every precision,
    output sigmoided pre-grid (B, N, 5+nc) rows, anchor-major per level."""

    def __init__(self, spec: YoloSpec, int8: bool = False):
        super().__init__()
        self.spec = spec
        if spec.scale == "g":
            self.backbone = RepBackbone(int8=int8)
            w = V5LITE_G_PLAN["widths"]
            taps = (w[2], w[3], w[4])
        else:
            self.backbone = LiteBackbone(spec.scale, int8=int8)
            taps = V5LITE_PLANS[spec.scale][1]
        self.neck = LitePAN(spec.scale, taps, int8=int8)
        no = len(V5_ANCHORS[0]) * (5 + spec.num_classes)
        for li in range(3):
            self.add_module(f"head{li}", nn.Conv2d(self.neck.width, no, 1))
        self._init_group(int8, "neck_a_xmax", "neck_b_xmax")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.int8:
            x = x.permute(0, 2, 3, 1)  # the int8 domain is NHWC (a view)
        ga, gb = self.group_scale("neck_a_xmax"), self.group_scale("neck_b_xmax")
        record = {"a": [], "b": []}
        feats = self.backbone(x, emit_p3=gb, emit_p4=ga)
        feats = self.neck(feats, ga, gb, record)
        self.group_record(record["a"], "neck_a_xmax")
        self.group_record(record["b"], "neck_b_xmax")
        na, no = len(V5_ANCHORS[0]), 5 + self.spec.num_classes
        outs = []
        for li, f in enumerate(feats):
            p = torch.sigmoid(predict_nhwc(getattr(self, f"head{li}"), f, self.int8))
            b, h, w, _ = p.shape
            # anchor-major rows (the reference's np.tile(grid, (na, 1)))
            outs.append(p.reshape(b, h, w, na, no).permute(0, 3, 1, 2, 4).reshape(b, -1, no))
        return torch.cat(outs, dim=1)
