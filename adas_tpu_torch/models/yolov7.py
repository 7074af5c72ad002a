"""YOLOv7, the base "yolov7" graph (port of ``adas_tpu/models/yolov7.py``;
tiny/x/d6/e6 are not modelled there either, ``yolov7.py:17``): E-ELAN
blocks, MP downsamples (max pool || strided conv), SPPCSPC, ELAN-W head
blocks, RepConv pre-heads (training form: 3x3 and 1x1 ConvBN summed,
SiLU) and the IDetect head (implicit add -> 1x1 -> implicit multiply ->
the v5 anchor-grid decode), output (B, N, 5+nc).

Modules are named by the yaml layer index (``m{i}``), the implicit
parameters ``ia{l}_implicit`` / ``im{l}_implicit`` and the predictors
``head{l}``, as in the flax tree.  The float nets are NCHW; the int8 net
NHWC from its first conv (3 input channels: bf16), every other conv
W8A8.  Under int8 every concat is an s8 group owned by :class:`YoloV7`,
named by its yaml index (``elan4_xmax``, ``mp12_xmax``, ``cat55_xmax``,
SPPCSPC's ``spp_xmax``/``csp_xmax`` on ``m51``) and every other edge chains
s8 per producer, as in JAX; the groups ``mp76``/``mp89`` are also where
``m63`` and ``m51`` emit, since those feed the head's MP concats.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvBN
from .yolo import YoloSpec, _Group, anchor_grid_decode, pool_, predict_nhwc, up2_

V7_ANCHORS = (
    ((12, 16), (19, 36), (40, 28)),
    ((36, 75), (76, 55), (72, 146)),
    ((142, 110), (192, 243), (459, 401)),
)


class RepConv(nn.Module):
    """3x3 + 1x1 ConvBN branches summed, SiLU (``yolov7.py:38``)."""

    def __init__(self, cin: int, features: int, int8: bool = False):
        super().__init__()
        self.rbr_dense = ConvBN(cin, features, 3, act=None, int8=int8)
        self.rbr_1x1 = ConvBN(cin, features, 1, act=None, int8=int8)

    def forward(self, x):
        return F.silu(self.rbr_dense(x) + self.rbr_1x1(x))


class SPPCSPC(_Group):
    """CSP-wrapped SPP with 5/9/13 max pools (``yolov7.py:55``); under int8
    two s8 groups, the pyramid (``spp_xmax``) and the CSP merge
    (``csp_xmax``)."""

    def __init__(self, cin: int, features: int, int8: bool = False):
        super().__init__()
        c = features
        q = dict(int8=int8)
        self.cv1 = ConvBN(cin, c, 1, **q)
        self.cv3 = ConvBN(c, c, 3, **q)
        self.cv4 = ConvBN(c, c, 1, **q)
        self.cv5 = ConvBN(4 * c, c, 1, **q)
        self.cv6 = ConvBN(c, c, 3, **q)
        self.cv2 = ConvBN(cin, c, 1, **q)
        self.cv7 = ConvBN(2 * c, features, 1, **q)
        self._init_group(int8, "spp_xmax", "csp_xmax")

    def forward(self, x, emit_q: bool = False, emit_scale=None):
        g_spp, g_csp = self.group_scale("spp_xmax"), self.group_scale("csp_xmax")
        x1 = self.cv4(self.cv3(self.cv1(x, emit_q=True), emit_q=True), emit_scale=g_spp)
        pools = [pool_(x1, k, 1, k // 2, self.int8) for k in (5, 9, 13)]
        cat = self.group_concat([x1, *pools], "spp_xmax")
        y1 = self.cv6(self.cv5(cat, emit_q=True), emit_scale=g_csp)
        cat = self.group_concat([y1, self.cv2(x, emit_scale=g_csp)], "csp_xmax")
        return self.cv7(cat, emit_q=emit_q, emit_scale=emit_scale)


# the graph as (yaml index, kind, arguments): "conv" (cin, cout, k, stride),
# "elan" (cin, branch width, cout: indices i..i+7), "elan_w" (cin, a width,
# b width, cout), "mp" (cin, c: indices i..i+4, the head's with a route)
_ELANS = ((4, 128, 64, 256), (17, 256, 128, 512), (30, 512, 256, 1024), (43, 1024, 256, 1024))
_MPS = ((12, 256, 128), (25, 512, 256), (38, 1024, 512))
_ELAN_WS = ((56, 512, 256, 128, 256), (68, 256, 128, 64, 128), (81, 512, 256, 128, 256),
            (94, 1024, 512, 256, 512))
_HEAD_MPS = ((76, 128, 128), (89, 256, 256))
#: every s8 group of the graph (``yolov7.py:96-223``)
GROUPS = tuple(
    [f"elan{i}_xmax" for i, *_ in _ELANS] + [f"mp{i}_xmax" for i, *_ in _MPS + _HEAD_MPS]
    + ["cat55_xmax", "cat67_xmax"] + [f"elan{i}_xmax" for i, *_ in _ELAN_WS]
)


class YoloV7(_Group):
    """The base yolov7 graph (``yolov7.py:89``): NCHW input in every
    precision, output (B, N, 5+nc) with the anchor-grid decode baked in."""

    def __init__(self, spec: YoloSpec, int8: bool = False):
        super().__init__()
        self.spec = spec
        q = dict(int8=int8)

        def conv(i, cin, cout, k, stride=1):
            self.add_module(f"m{i}", ConvBN(cin, cout, k, stride, **q))

        conv(0, 3, 32, 3)
        conv(1, 32, 64, 3, 2)
        conv(2, 64, 64, 3)
        conv(3, 64, 128, 3, 2)
        for i, cin, cb, cout in _ELANS:
            conv(i, cin, cb, 1)
            conv(i + 1, cin, cb, 1)
            for j in range(2, 6):
                conv(i + j, cb, cb, 3)
            conv(i + 7, 4 * cb, cout, 1)
        for i, cin, c in _MPS + _HEAD_MPS:
            conv(i + 1, cin, c, 1)
            conv(i + 2, cin, c, 1)
            conv(i + 3, c, c, 3, 2)
        self.m51 = SPPCSPC(1024, 512, **q)
        conv(52, 512, 256, 1)
        conv(54, 1024, 256, 1)
        conv(64, 256, 128, 1)
        conv(66, 512, 128, 1)
        for i, cin, ca, cb, cout in _ELAN_WS:
            conv(i, cin, ca, 1)
            conv(i + 1, cin, ca, 1)
            conv(i + 2, ca, cb, 3)
            for j in range(3, 6):
                conv(i + j, cb, cb, 3)
            conv(i + 7, 4 * cb + 2 * ca, cout, 1)
        self.m102 = RepConv(128, 256, **q)
        self.m103 = RepConv(256, 512, **q)
        self.m104 = RepConv(512, 1024, **q)
        no = len(V7_ANCHORS[0]) * (5 + spec.num_classes)
        for li, cin in enumerate((256, 512, 1024)):
            self.add_module(f"head{li}", nn.Conv2d(cin, no, 1))
            self.register_parameter(f"ia{li}_implicit", nn.Parameter(torch.zeros(1, 1, 1, cin)))
            self.register_parameter(f"im{li}_implicit", nn.Parameter(torch.ones(1, 1, 1, no)))
        self._init_group(int8, *GROUPS)

    def _conv(self, i, x, emit_q=False, emit_scale=None):
        return getattr(self, f"m{i}")(x, emit_q=emit_q, emit_scale=emit_scale)

    def _elan(self, i, x, wide: bool, emit_q=False, emit_scale=None):
        """ELAN (indices i..i+7): two 1x1 entries and four chained 3x3s;
        the concat takes the last, the second, the 1x1s' (ELAN) or every
        one (ELAN-W, ``wide``), members at the group scale."""
        g = self.group_scale(f"elan{i}_xmax")
        a = self._conv(i, x, emit_scale=g)
        b = self._conv(i + 1, x, emit_scale=g)
        outs = [b]
        for j in range(2, 6):
            own = not wide and j in (2, 4)  # ELAN: b1/b3 feed one conv only
            outs.append(self._conv(i + j, outs[-1], emit_q=own, emit_scale=None if own else g))
        members = outs[:0:-1] if wide else [outs[4], outs[2]]
        cat = self.group_concat(members + [b, a], f"elan{i}_xmax")
        return self._conv(i + 7, cat, emit_q=emit_q, emit_scale=emit_scale)

    def _mp(self, i, x, route=None):
        """MP (indices i..i+4): 2x2 max pool -> 1x1 || 1x1 -> 3x3/2, both
        at the group scale, concatenated (the head's MPs with a route)."""
        g = self.group_scale(f"mp{i}_xmax")
        a = self._conv(i + 1, pool_(x, 2, 2, 0, self.int8), emit_scale=g)
        b = self._conv(i + 3, self._conv(i + 2, x, emit_q=True), emit_scale=g)
        return self.group_concat([b, a] + ([] if route is None else [route]), f"mp{i}_xmax")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        i8 = self.int8
        if i8:
            x = x.permute(0, 2, 3, 1)  # the int8 domain is NHWC (a view)
        t = self._conv(3, self._conv(2, self._conv(1, self._conv(0, x), emit_q=True),
                                     emit_q=True), emit_q=True)
        t11 = self._elan(4, t, False, emit_q=True)
        t24 = self._elan(17, self._mp(12, t11), False, emit_q=True)
        t37 = self._elan(30, self._mp(25, t24), False, emit_q=True)
        t50 = self._elan(43, self._mp(38, t37), False, emit_q=True)
        t51 = self.m51(t50, emit_scale=self.group_scale("mp89_xmax"))
        g55 = self.group_scale("cat55_xmax")
        t52 = self._conv(52, t51, emit_scale=g55)
        t55 = self.group_concat([self._conv(54, t37, emit_scale=g55), up2_(t52, i8)],
                                "cat55_xmax")
        t63 = self._elan(56, t55, True, emit_scale=self.group_scale("mp76_xmax"))
        g67 = self.group_scale("cat67_xmax")
        t64 = self._conv(64, t63, emit_scale=g67)
        t67 = self.group_concat([self._conv(66, t24, emit_scale=g67), up2_(t64, i8)],
                                "cat67_xmax")
        t75 = self._elan(68, t67, True, emit_q=True)
        t88 = self._elan(81, self._mp(76, t75, t63), True, emit_q=True)
        t101 = self._elan(94, self._mp(89, t88, t51), True, emit_q=True)
        outs = []
        for li, f in enumerate((self.m102(t75), self.m103(t88), self.m104(t101))):
            ia = getattr(self, f"ia{li}_implicit")
            im = getattr(self, f"im{li}_implicit")
            f = f.float() + ia if i8 else f + ia.permute(0, 3, 1, 2)
            p = predict_nhwc(getattr(self, f"head{li}"), f, i8) * im
            outs.append(anchor_grid_decode(p, V7_ANCHORS[li], self.spec.strides[li]))
        return torch.cat(outs, dim=1)
