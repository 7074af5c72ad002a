"""The YOLO families of ``adas_tpu/models/yolo.py``: YOLOv5 (C3/SPPF CSP
net, anchor-grid head, output (B, N, 5+nc)), YOLOv8 (C2f/SPPF CSP net,
anchor-free DFL head, output (B, 4+nc, N) like the official ONNX export)
and YOLOv10 (the v8 trunk with SCDown/PSA/C2fCIB, one-to-many and
one-to-one heads; the one-to-one head + top-k is the NMS-free path).
:func:`build_yolo` also builds the families of their own modules:
YOLOv5-lite (``yolov5lite.py``), v6 (``yolov6.py``), v7 (``yolov7.py``)
and v9 (``yolov9.py``), with JAX's scale fallbacks (``yolo.py:927-960``).

Module names follow the flax tree (``net.stem``, ``net.stage1.m0.cv1``,
``head.box0_0``, ``head_o2o.clso0_0a`` ...), so ``weights.py`` maps a flax
variable tree onto these modules by path.  The 3x3/2 stem ConvBN of v8
and v10 runs through the fused stem kernel; v5's 6x6/2 stem is a plain
conv, as in JAX (``yolo.py:803-812``: it has no Pallas stem).

``int8=True`` builds the calibrated int8 serving net (``quantized("int8")``
over the same graph): every dense ConvBN with more than 4 input channels
is a W8A8 conv in the NHWC int8 domain (``quant.py``), the depthwise
convs and v5's stem run in bf16, activations chain as s8 through the
epilogues and the s8 concat groups (one per C3/C2f/C2fCIB/SPPF, two
unified neck groups A/B), the C2f bottlenecks that pass the fusion gate
run through the fused block kernel (``ops/block.py``), and the heads' 1x1
predictors run in f32.  PSA's two attention products are
``torch.matmul`` (XLA einsums in JAX, no Pallas kernel).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.block import fuse_gate, fused_block
from .layers import ConvBN, conv_epilogue, max_pool, resize_nearest_2x
from .quant import (
    Int8State,
    QTensor,
    as_float,
    channels,
    max_pool_nhwc,
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
_V5_SCALES = {
    "n": (1 / 3, 0.25, 1024),
    "s": (1 / 3, 0.50, 1024),
    "m": (2 / 3, 0.75, 1024),
    "l": (1.0, 1.00, 1024),
    "x": (4 / 3, 1.25, 1024),
}
V5_ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)
# "c" serves the GELAN-C (yolov9c) head: P3/P4/P5 widths 256/512/512
_V8_SCALES["c"] = (1.0, 1.0, 512)
#: the families (``YoloSpec.family``)
FAMILIES = ("v5", "v5lite", "v6", "v7", "v8", "v9", "v10")
#: (stage4, pan4, pan5) large-kernel (RepVGGDW) flags per v10 scale, the
#: THU-MIG yolov10 yaml family (``yolo.py:461-473``)
V10_LK = {
    "n": (False, False, True),
    "s": (True, False, True),
    "m": (False, False, False),
    "l": (False, False, False),
    "x": (False, False, False),
}


def _make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(math.ceil(x / divisor) * divisor))


@dataclass(frozen=True)
class YoloSpec:
    """Static geometry of a YOLO model (``yolo.py:69``); ``family`` is one
    of :data:`FAMILIES`."""

    scale: str = "n"
    num_classes: int = 80
    input_size: Tuple[int, int] = (640, 640)
    strides: Tuple[int, ...] = (8, 16, 32)
    reg_max: int = 16  # DFL bins (v8/v10)
    family: str = "v8"

    def _table(self):
        return (_V5_SCALES if self.family == "v5" else _V8_SCALES)[self.scale]

    @property
    def channels(self) -> Sequence[int]:
        _, w, mc = self._table()
        return [_make_divisible(min(c, mc) * w) for c in (64, 128, 256, 512, 1024)]

    @property
    def depths(self) -> Sequence[int]:
        d = self._table()[0]
        base = (3, 6, 9, 3) if self.family == "v5" else (3, 6, 6, 3)
        return [max(1, round(n * d)) for n in base]

    @property
    def num_anchors(self) -> int:
        h, w = self.input_size
        return sum((h // s) * (w // s) for s in self.strides)

    @property
    def lk(self) -> Tuple[bool, bool, bool]:
        """v10's (stage4, pan4, pan5) RepVGGDW flags (``v10_lk_flags``)."""
        return V10_LK[self.scale]


class Bottleneck(nn.Module):
    """k1 -> k2 conv with optional shortcut (``yolo.py:98``; C2f's is 3x3 ->
    3x3, C3's 1x1 -> 3x3).  Under int8, a 3x3 -> 3x3 body whose output
    belongs to a concat group (``emit_scale``) runs both convs, the
    shortcut and the group requantize as one fused block when
    :func:`fuse_gate` passes (``Bottleneck._fused``, ``yolo.py:151``)."""

    def __init__(self, cin: int, features: int, shortcut: bool = True, int8: bool = False,
                 kernels: Tuple[int, int] = (3, 3)):
        super().__init__()
        self.cv1 = ConvBN(cin, features, kernels[0], int8=int8)
        self.cv2 = ConvBN(features, features, kernels[1], int8=int8)
        self.use_shortcut = shortcut and cin == features
        self.kernels = tuple(kernels)
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
        if (self.cv1.conv.calibrating or emit_scale is None or not isinstance(x, QTensor)
                or self.kernels != (3, 3)):
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


def cat_(parts, int8: bool):
    """The channel concat of the net's layout: s8 group concat (or bf16,
    :func:`qconcat`) in the int8 net's NHWC, ``torch.cat`` on NCHW else."""
    return qconcat(parts) if int8 else torch.cat(parts, dim=1)


def slice_(x, start: int, stop: int, int8: bool):
    """Channels [start, stop) of an NHWC (int8 net) or NCHW activation."""
    return channels(x, start, stop) if int8 else x[:, start:stop]


def width(x, int8: bool) -> int:
    return x.shape[-1] if int8 else x.shape[1]


def up2_(x, int8: bool):
    return upsample2x_nhwc(x) if int8 else resize_nearest_2x(x)


def pool_(x, window: int, stride: int, pad: int, int8: bool):
    """``layers.max_pool``: s8 for a QTensor (the int8 net), -inf padding."""
    return max_pool_nhwc(x, window, stride, pad) if int8 else max_pool(x, window, stride, pad)


class _Group(Int8State, nn.Module):
    """A block that owns s8 concat groups under int8 (``concat_xmax``, or
    the named groups of ``names``); outside int8 its concats are plain."""

    def _init_group(self, int8: bool, *names: str) -> None:
        self.int8 = int8
        if int8:
            self._init_int8_buffers(*(names or ("concat_xmax",)))

    def group_scale(self, name: str = "concat_xmax"):
        """The group's calibrated s8 scale, or None (calibrating, not
        calibrated, or not an int8 net: ``s8_group_scale``)."""
        return None if self.calibrating or not self.int8 else self.buffer_scale(name)

    def group_record(self, xs, name: str = "concat_xmax") -> None:
        """Calibration: the group's absmax over ``xs`` (``s8_group_record``)."""
        if self.int8 and self.calibrating:
            self.record_max(name, xs)

    def group_concat(self, parts, name: str = "concat_xmax"):
        cat = cat_(parts, self.int8)
        self.group_record([cat], name)
        return cat


class C3(_Group):
    """YOLOv5 CSP block with three convs (``yolo.py:243``).  Under int8 the
    two branch exits (the last bottleneck, or cv1 with no bottleneck, and
    cv2) emit at the group's one scale, so the concat stays s8."""

    def __init__(self, cin: int, features: int, n: int = 1, shortcut: bool = True,
                 int8: bool = False):
        super().__init__()
        hidden = features // 2
        self.cv1 = ConvBN(cin, hidden, 1, int8=int8)
        self.n = n
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(hidden, hidden, shortcut, int8=int8,
                                                kernels=(1, 3)))
        self.cv2 = ConvBN(cin, hidden, 1, int8=int8)
        self.cv3 = ConvBN(2 * hidden, features, 1, int8=int8)
        self._init_group(int8)

    def forward(self, x, emit_q: bool = False, emit_scale=None):
        if not self.int8:
            a = self.cv1(x)
            for i in range(self.n):
                a = getattr(self, f"m{i}")(a)
            return self.cv3(torch.cat([a, self.cv2(x)], dim=1))
        gscale = self.group_scale()
        a = self.cv1(x, emit_scale=gscale if self.n == 0 else None)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a, emit_scale=gscale if i == self.n - 1 else None)
        cat = self.group_concat([a, self.cv2(x, emit_scale=gscale)])
        return self.cv3(cat, emit_q=emit_q, emit_scale=emit_scale)


class C2f(_Group):
    """Split + cascaded bottlenecks, concat all (``yolo.py:275``).  Under
    int8 the parts form one s8 concat group: cv1 emits at its scale, the
    split halves are s8 channel views, each bottleneck exit emits at it,
    and cv2 reads the s8 concat."""

    def __init__(self, cin: int, features: int, n: int = 1, shortcut: bool = False,
                 int8: bool = False):
        super().__init__()
        self.hidden = features // 2
        self.cv1 = ConvBN(cin, 2 * self.hidden, 1, int8=int8)
        self.n = n
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(self.hidden, self.hidden, shortcut, int8=int8))
        self.cv2 = ConvBN((2 + n) * self.hidden, features, 1, int8=int8)
        self._init_group(int8)

    def forward(self, x, emit_q: bool = False, emit_scale=None):
        if not self.int8:
            y = self.cv1(x)
            parts = [y[:, : self.hidden], y[:, self.hidden:]]
            for i in range(self.n):
                parts.append(getattr(self, f"m{i}")(parts[-1]))
            return self.cv2(torch.cat(parts, dim=1))
        gscale = self.group_scale()
        y = self.cv1(x, emit_scale=gscale)
        parts = [channels(y, 0, self.hidden), channels(y, self.hidden, 2 * self.hidden)]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1], emit_scale=gscale))
        return self.cv2(self.group_concat(parts), emit_q=emit_q, emit_scale=emit_scale)


class SPPF(_Group):
    """Spatial pyramid pooling (fast): 3 cascaded 5x5 max pools
    (``yolo.py:328``).  Under int8 the pools run on s8 data and the four
    members form one concat group."""

    def __init__(self, cin: int, features: int, int8: bool = False):
        super().__init__()
        hidden = cin // 2
        self.cv1 = ConvBN(cin, hidden, 1, int8=int8)
        self.cv2 = ConvBN(4 * hidden, features, 1, int8=int8)
        self._init_group(int8)

    def forward(self, x, emit_q: bool = False, emit_scale=None):
        if not self.int8:
            y = self.cv1(x)
            p1 = max_pool(y, 5, 1, pad=2)
            p2 = max_pool(p1, 5, 1, pad=2)
            p3 = max_pool(p2, 5, 1, pad=2)
            return self.cv2(torch.cat([y, p1, p2, p3], dim=1))
        y = self.cv1(x, emit_scale=self.group_scale())
        p1 = max_pool_nhwc(y, 5, 1, 2)
        p2 = max_pool_nhwc(p1, 5, 1, 2)
        p3 = max_pool_nhwc(p2, 5, 1, 2)
        return self.cv2(self.group_concat([y, p1, p2, p3]), emit_q=emit_q, emit_scale=emit_scale)


class SCDown(nn.Module):
    """YOLOv10 spatial-channel decoupled downsample (``yolo.py:353``): 1x1,
    then a depthwise 3x3/2 without activation (bf16 under int8)."""

    def __init__(self, cin: int, features: int, int8: bool = False):
        super().__init__()
        self.cv1 = ConvBN(cin, features, 1, int8=int8)
        self.cv2 = ConvBN(features, features, 3, 2, act=None, groups=features, int8=int8)

    def forward(self, x):
        return self.cv2(self.cv1(x))


class RepVGGDW(nn.Module):
    """Depthwise 7x7 + depthwise 3x3 branches (BN, no act) summed, SiLU
    (``yolo.py:367``): the large-kernel slot of a CIB."""

    def __init__(self, features: int, int8: bool = False):
        super().__init__()
        q = dict(act=None, groups=features, int8=int8)
        self.conv = ConvBN(features, features, 7, **q)
        self.conv1 = ConvBN(features, features, 3, **q)

    def forward(self, x):
        return F.silu(self.conv(x) + self.conv1(x))


class CIB(nn.Module):
    """Compact inverted block (``yolo.py:388``): dw 3x3, 1x1, dw 3x3 (or
    :class:`RepVGGDW` when ``lk``), 1x1, dw 3x3, + shortcut."""

    def __init__(self, cin: int, features: int, shortcut: bool = True, lk: bool = False,
                 int8: bool = False):
        super().__init__()
        q = dict(int8=int8)
        self.cv0 = ConvBN(cin, cin, 3, groups=cin, **q)
        self.cv1 = ConvBN(cin, 2 * features, 1, **q)
        self.cv2 = (RepVGGDW(2 * features, **q) if lk else
                    ConvBN(2 * features, 2 * features, 3, groups=2 * features, **q))
        self.cv3 = ConvBN(2 * features, features, 1, **q)
        self.cv4 = ConvBN(features, features, 3, groups=features, **q)
        self.add = shortcut and cin == features

    def forward(self, x):
        y = self.cv4(self.cv3(self.cv2(self.cv1(self.cv0(x)))))
        return as_float(x) + y if self.add else y


class C2fCIB(_Group):
    """C2f with CIB bodies (``yolo.py:424``).  Under int8 the CIB exits end
    in a depthwise conv, so they cannot emit from a conv epilogue: each is
    quantized into the group explicitly; cv2 emits bf16."""

    def __init__(self, cin: int, features: int, n: int = 1, shortcut: bool = True,
                 lk: bool = False, int8: bool = False):
        super().__init__()
        self.hidden = features // 2
        self.cv1 = ConvBN(cin, 2 * self.hidden, 1, int8=int8)
        self.n = n
        for i in range(n):
            self.add_module(f"m{i}", CIB(self.hidden, self.hidden, shortcut, lk, int8=int8))
        self.cv2 = ConvBN((2 + n) * self.hidden, features, 1, int8=int8)
        self._init_group(int8)

    def forward(self, x):
        if not self.int8:
            y = self.cv1(x)
            parts = [y[:, : self.hidden], y[:, self.hidden:]]
            for i in range(self.n):
                parts.append(getattr(self, f"m{i}")(parts[-1]))
            return self.cv2(torch.cat(parts, dim=1))
        gscale = self.group_scale()
        y = self.cv1(x, emit_scale=gscale)
        parts = [channels(y, 0, self.hidden), channels(y, self.hidden, 2 * self.hidden)]
        for i in range(self.n):
            p = getattr(self, f"m{i}")(parts[-1])
            if gscale is not None and not isinstance(p, QTensor):
                p = quantize_to(p, gscale)
            parts.append(p)
        return self.cv2(self.group_concat(parts))


class PSA(nn.Module):
    """Partial self-attention over half the channels of the stride-32 map
    (``yolo.py:479``): heads of 64 channels (at least one), keys of half a
    head.  The attention runs on (B, H*W, heads, dim) tensors in the
    channel order of the JAX NHWC reshape; under int8 its convs follow the
    policy and its products run in bf16; the exit ``cv2`` emits at
    ``emit_scale`` (the neck's group A)."""

    def __init__(self, features: int, int8: bool = False):
        super().__init__()
        self.hidden = c = features // 2
        self.heads = max(1, c // 64)
        self.head_dim = c // self.heads
        self.key_dim = self.head_dim // 2
        q = dict(int8=int8)
        self.cv1 = ConvBN(features, features, 1, **q)
        self.attn_qkv = ConvBN(c, self.heads * (2 * self.key_dim + self.head_dim), 1, act=None,
                               **q)
        self.attn_pe = ConvBN(c, c, 3, act=None, groups=c, **q)
        self.attn_proj = ConvBN(c, c, 1, act=None, **q)
        self.ffn1 = ConvBN(c, 2 * c, 1, **q)
        self.ffn2 = ConvBN(2 * c, c, 1, act=None, **q)
        self.cv2 = ConvBN(features, features, 1, **q)
        self.int8 = int8

    def _attention(self, qkv: torch.Tensor):
        """(B, H, W, heads * (2 kd + hd)) NHWC -> (attention output, v), each
        (B, H, W, C) NHWC."""
        b, h, w, _ = qkv.shape
        kd, hd = self.key_dim, self.head_dim
        t = qkv.reshape(b, h * w, self.heads, 2 * kd + hd).transpose(1, 2)
        q, k, v = t.split([kd, kd, hd], dim=-1)
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(kd), dim=-1)
        out = torch.matmul(attn, v)
        c = self.heads * hd
        return (out.transpose(1, 2).reshape(b, h, w, c),
                v.transpose(1, 2).reshape(b, h, w, c))

    def forward(self, x, emit_scale=None):
        y = self.cv1(x)
        c = self.hidden
        if self.int8:
            a, bb = y[..., :c], y[..., c:]
            out, v = self._attention(self.attn_qkv(bb))
            bb = bb + self.attn_proj(out + self.attn_pe(v))
            bb = bb + self.ffn2(self.ffn1(bb))
            return self.cv2(torch.cat([a, bb], dim=-1), emit_scale=emit_scale)
        a, bb = y[:, :c], y[:, c:]
        out, v = self._attention(self.attn_qkv(bb).permute(0, 2, 3, 1))
        out, v = out.permute(0, 3, 1, 2), v.permute(0, 3, 1, 2)
        bb = bb + self.attn_proj(out + self.attn_pe(v))
        bb = bb + self.ffn2(self.ffn1(bb))
        return self.cv2(torch.cat([a, bb], dim=1))


class YoloBackboneNeck(Int8State, nn.Module):
    """CSP backbone + PAN neck, its blocks by family (``yolo.py:513``).
    Under int8 the four PAN concats pair into two unified s8 groups sharing
    producers: A = {fpn4, pan5} concats at ``neck_a_xmax``, B = {fpn3,
    pan4} at ``neck_b_xmax``."""

    def __init__(self, spec: YoloSpec, int8: bool = False):
        super().__init__()
        if spec.family not in ("v5", "v8", "v10"):
            raise ValueError(f"the {spec.family} family has its own trunk (build_yolo)")
        ch, d = spec.channels, spec.depths
        self.family = fam = spec.family
        v10 = fam == "v10"
        lk = spec.lk if v10 else (False, False, False)
        q = dict(int8=int8)
        block = C3 if fam == "v5" else C2f
        if fam == "v5":
            self.stem = ConvBN(3, ch[0], 6, 2, **q)
        else:
            self.stem = ConvBN(3, ch[0], 3, 2, stem=True, **q)
        self.down1 = ConvBN(ch[0], ch[1], 3, 2, **q)
        self.stage1 = block(ch[1], ch[1], d[0], True, **q)
        self.down2 = ConvBN(ch[1], ch[2], 3, 2, **q)
        self.stage2 = block(ch[2], ch[2], d[1], True, **q)
        self.down3 = SCDown(ch[2], ch[3], **q) if v10 else ConvBN(ch[2], ch[3], 3, 2, **q)
        self.stage3 = block(ch[3], ch[3], d[2], True, **q)
        self.down4 = SCDown(ch[3], ch[4], **q) if v10 else ConvBN(ch[3], ch[4], 3, 2, **q)
        # v10n keeps a plain C2f at stride 32; s and up use C2fCIB
        self.stage4 = (C2fCIB(ch[4], ch[4], d[3], True, lk[0], **q)
                       if v10 and spec.scale != "n" else block(ch[4], ch[4], d[3], True, **q))
        self.sppf = SPPF(ch[4], ch[4], **q)
        if v10:
            self.psa = PSA(ch[4], **q)
        if fam == "v5":
            # v5 reduces channels before the upsample
            self.lat5 = ConvBN(ch[4], ch[3], 1, **q)
            self.fpn4 = C3(2 * ch[3], ch[3], d[0], False, **q)
            self.lat4 = ConvBN(ch[3], ch[2], 1, **q)
            self.fpn3 = C3(2 * ch[2], ch[2], d[0], False, **q)
            self.pan3 = ConvBN(ch[2], ch[2], 3, 2, **q)
            self.pan4 = C3(2 * ch[2], ch[3], d[0], False, **q)
            self.pan5_down = ConvBN(ch[3], ch[3], 3, 2, **q)
            self.pan5 = C3(2 * ch[3], ch[4], d[0], False, **q)
        else:
            self.fpn4 = C2f(ch[4] + ch[3], ch[3], d[0], False, **q)
            self.fpn3 = C2f(ch[3] + ch[2], ch[2], d[0], False, **q)
            self.pan3 = ConvBN(ch[2], ch[2], 3, 2, **q)
            self.pan4 = (C2fCIB(ch[2] + ch[3], ch[3], d[0], True, lk[1], **q)
                         if v10 and spec.scale not in ("n", "s")
                         else C2f(ch[2] + ch[3], ch[3], d[0], v10, **q))
            if v10:
                self.pan5_down = SCDown(ch[3], ch[3], **q)
                self.pan5 = C2fCIB(ch[3] + ch[4], ch[4], d[0], True, lk[2], **q)
            else:
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
        if self.family == "v10":
            p5 = self.psa(p5)
        cat = lambda parts: torch.cat(parts, dim=1)  # noqa: E731
        if self.family == "v5":
            p5r = self.lat5(p5)
            t1r = self.lat4(self.fpn4(cat([resize_nearest_2x(p5r), p4])))
            n3 = self.fpn3(cat([resize_nearest_2x(t1r), p3]))
            n4 = self.pan4(cat([self.pan3(n3), t1r]))
            return n3, n4, self.pan5(cat([self.pan5_down(n4), p5r]))
        t1 = self.fpn4(cat([resize_nearest_2x(p5), p4]))
        n3 = self.fpn3(cat([resize_nearest_2x(t1), p3]))
        n4 = self.pan4(cat([self.pan3(n3), t1]))
        return n3, n4, self.pan5(cat([self.pan5_down(n4), p5]))

    def _forward_int8(self, x: torch.Tensor):
        """``yolo.py:548-691``: NCHW input -> NHWC (n3, n4, n5), s8
        QTensors where the family's neck exits emit (v8) and bf16 else.
        The stem's NCHW output enters the int8 domain as an NHWC view
        (v5's bf16 stem conv reads its NCHW input through one); down1's
        input quantize writes it NHWC."""
        cal, fam = self.calibrating, self.family
        v10 = fam == "v10"
        ga = None if cal else self.buffer_scale("neck_a_xmax")
        gb = None if cal else self.buffer_scale("neck_b_xmax")
        if fam == "v5":
            x = self.stem(x.permute(0, 2, 3, 1))
        else:
            x = self.stem(x).permute(0, 2, 3, 1)
        x = self.down1(x, emit_q=True)
        x = self.stage1(x, emit_q=True)
        x = self.down2(x, emit_q=True)
        p3 = self.stage2(x, emit_scale=gb)
        x = self.down3(p3) if v10 else self.down3(p3, emit_q=True)
        p4 = self.stage3(x, emit_scale=ga)
        x = self.down4(p4) if v10 else self.down4(p4, emit_q=True)
        x = self.stage4(x) if isinstance(self.stage4, C2fCIB) else self.stage4(x, emit_q=True)
        if v10:
            # sppf -> psa.cv1 chains s8; the PSA exit emits at group A
            p5 = self.psa(self.sppf(x, emit_q=True), emit_scale=ga)
        elif fam == "v5":
            p5 = self.sppf(x, emit_q=True)
        else:
            p5 = self.sppf(x, emit_scale=ga)
        if fam == "v5":
            p5 = self.lat5(p5, emit_scale=ga)  # p5r: a member of both A concats
            cat_a1 = qconcat([upsample2x_nhwc(p5), p4])
            t1 = self.lat4(self.fpn4(cat_a1, emit_q=True), emit_scale=gb)  # t1r
            cat_b1 = qconcat([upsample2x_nhwc(t1), p3])
            n3 = self.fpn3(cat_b1)
            cat_b2 = qconcat([self.pan3(n3, emit_scale=gb), t1])
            n4 = self.pan4(cat_b2)
            cat_a2 = qconcat([self.pan5_down(n4, emit_scale=ga), p5])
            n5 = self.pan5(cat_a2)
        else:
            # v8's neck exits emit s8 for their dense consumers; v10's head
            # opens with a depthwise cls conv, so its exits stay bf16
            emit = not v10
            cat_a1 = qconcat([upsample2x_nhwc(p5), p4])
            t1 = self.fpn4(cat_a1, emit_scale=gb)
            cat_b1 = qconcat([upsample2x_nhwc(t1), p3])
            n3 = self.fpn3(cat_b1, emit_q=emit)
            cat_b2 = qconcat([self.pan3(n3, emit_scale=gb), t1])
            n4 = self.pan4(cat_b2) if isinstance(self.pan4, C2fCIB) else self.pan4(cat_b2,
                                                                                     emit_q=emit)
            if v10:
                # SCDown ends in a depthwise conv: quantized into group A
                y = self.pan5_down(n4)
                if ga is not None:
                    y = quantize_to(y, ga)
            else:
                y = self.pan5_down(n4, emit_scale=ga)
            cat_a2 = qconcat([y, p5])
            n5 = self.pan5(cat_a2) if v10 else self.pan5(cat_a2, emit_q=True)
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
    y = F.linear(x.float(), w, conv.bias.float())
    return y.reshape(y.shape[0], -1, y.shape[-1])


class DetectHeadV8(nn.Module):
    """Anchor-free decoupled head with DFL (``yolo.py:721``): returns
    (xywh (B, 4, N) f32, class probabilities (B, nc, N) f32).  ``suffix``
    names v10's two heads (``box{suffix}{li}_*``); ``lightweight_cls`` is
    v10's depthwise cls branch (dw 3x3, 1x1, dw 3x3, 1x1).  Under int8 the
    dense 3x3 convs are W8A8 (``box*_0``/``cls*_0`` emit s8 to their
    successor), the depthwise convs bf16, and the 1x1 predictors run in
    f32 on NHWC features."""

    def __init__(self, spec: YoloSpec, int8: bool = False, suffix: str = "",
                 lightweight_cls: bool = False):
        super().__init__()
        self.spec = spec
        self.int8 = int8
        self.suffix = suffix
        self.lightweight_cls = lightweight_cls
        ch, nc = spec.channels, spec.num_classes
        c2 = max(16, ch[2] // 4, spec.reg_max * 4)
        c3 = max(ch[2], min(nc, 100))
        q = dict(int8=int8)
        for li, cin in enumerate((ch[2], ch[3], ch[4])):
            box, cls = f"box{suffix}{li}", f"cls{suffix}{li}"
            self.add_module(f"{box}_0", ConvBN(cin, c2, 3, **q))
            self.add_module(f"{box}_1", ConvBN(c2, c2, 3, **q))
            self.add_module(f"{box}_2", nn.Conv2d(c2, 4 * spec.reg_max, 1))
            if lightweight_cls:
                self.add_module(f"{cls}_0a", ConvBN(cin, cin, 3, groups=cin, **q))
                self.add_module(f"{cls}_0b", ConvBN(cin, c3, 1, **q))
                self.add_module(f"{cls}_1a", ConvBN(c3, c3, 3, groups=c3, **q))
                self.add_module(f"{cls}_1b", ConvBN(c3, c3, 1, **q))
            else:
                self.add_module(f"{cls}_0", ConvBN(cin, c3, 3, **q))
                self.add_module(f"{cls}_1", ConvBN(c3, c3, 3, **q))
            self.add_module(f"{cls}_2", nn.Conv2d(c3, nc, 1))

    def _branches(self, li: int, f):
        """The box and cls features of level ``li`` before their 1x1
        predictors, and the two predictors."""
        def part(branch: str, step: str):  # e.g. ("cls", "0a") -> self.clsm0_0a
            return getattr(self, f"{branch}{self.suffix}{li}_{step}")

        q = dict(emit_q=True) if self.int8 else {}
        box = part("box", "1")(part("box", "0")(f, **q))
        if self.lightweight_cls:
            cls = part("cls", "1b")(part("cls", "1a")(part("cls", "0b")(part("cls", "0a")(f))))
        else:
            cls = part("cls", "1")(part("cls", "0")(f, **q))
        return box, cls, part("box", "2"), part("cls", "2")

    def forward(self, feats):
        s = self.spec
        boxes, clss = [], []
        for li, f in enumerate(feats):
            box, cls, box_2, cls_2 = self._branches(li, f)
            if self.int8:
                boxes.append(_predict_f32(box_2, box).transpose(1, 2))
                clss.append(_predict_f32(cls_2, cls).transpose(1, 2))
            else:
                boxes.append(box_2(box).flatten(2))
                clss.append(cls_2(cls).flatten(2))
        ltrb = _dfl_decode(torch.cat(boxes, dim=2), s.reg_max).float()
        anchors, strides = _anchor_points(s.input_size, s.strides, ltrb.device)
        x1y1 = anchors - ltrb[:, :2]
        x2y2 = anchors + ltrb[:, 2:]
        xywh = torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=1) * strides
        # boxes decode in f32 (the JAX head's f32 anchors promote them);
        # class scores are the net dtype's sigmoid, widened
        return xywh, torch.sigmoid(torch.cat(clss, dim=2)).float()


class YoloV8(nn.Module):
    """YOLOv8-contract detector: output (B, 4+nc, N) (``yolo.py:788``);
    NCHW input in every precision."""

    #: the I420 step feeds this net the YUV-direct preprocess, whose planes
    #: JAX's stem takes (``stem_s2d_ok``, ``yolo.py:795``)
    stem_takes_planes = True

    def __init__(self, spec: YoloSpec, int8: bool = False):
        super().__init__()
        self.spec = spec
        self.net = YoloBackboneNeck(spec, int8=int8)
        self.head = DetectHeadV8(spec, int8=int8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat(self.head(self.net(x)), dim=1)


class YoloV5(nn.Module):
    """YOLOv5-contract detector (``yolo.py:820``): output (B, N, 5+nc) with
    objectness, the anchor-grid decode of the official export baked in;
    N runs over levels, then rows, columns and the 3 anchors.  The
    ``head{li}`` predictors are plain 1x1 convs (f32 on the int8 net's
    NHWC features)."""

    def __init__(self, spec: YoloSpec, int8: bool = False):
        super().__init__()
        self.spec = spec
        self.int8 = int8
        self.net = YoloBackboneNeck(spec, int8=int8)
        ch, na = spec.channels, len(V5_ANCHORS[0])
        for li, cin in enumerate((ch[2], ch[3], ch[4])):
            self.add_module(f"head{li}", nn.Conv2d(cin, na * (5 + spec.num_classes), 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for li, f in enumerate(self.net(x)):
            p = predict_nhwc(getattr(self, f"head{li}"), f, self.int8)
            outs.append(anchor_grid_decode(p, V5_ANCHORS[li], self.spec.strides[li]))
        return torch.cat(outs, dim=1)


def predict_nhwc(conv: nn.Conv2d, f, int8: bool) -> torch.Tensor:
    """A plain 1x1 predictor -> (B, H, W, out) NHWC: f32 on the int8 net's
    NHWC features (flax promotes them to its f32 params), the net's dtype
    on NCHW features else."""
    if int8:
        b, h, w, _ = f.shape
        return _predict_f32(conv, f).reshape(b, h, w, -1)
    return conv(f).permute(0, 2, 3, 1)


@lru_cache(maxsize=32)
def _anchors_on(anchors, device: str) -> torch.Tensor:
    """One level's (na, 2) anchor sizes on ``device``, uploaded once: a
    pageable host copy in the step would synchronize the stream."""
    return torch.tensor(anchors, dtype=torch.float32).to(device)


def anchor_grid_decode(p: torch.Tensor, anchors, stride: int) -> torch.Tensor:
    """The anchor-grid decode the v5/v7 exports bake in (``yolo.py:841-855``,
    ``yolov7.py:246-267``): (B, H, W, na*no) predictions -> sigmoid ->
    (B, H*W*na, no) rows of (xy, wh in pixels, objectness, classes), in
    row, column, anchor order."""
    b, h, w, _ = p.shape
    na = len(anchors)
    p = torch.sigmoid(p.reshape(b, h, w, na, -1))
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=p.device),
                            torch.arange(w, dtype=torch.float32, device=p.device), indexing="ij")
    grid = torch.stack([xs, ys], dim=-1)[None, :, :, None, :]
    anchors = _anchors_on(tuple(map(tuple, anchors)), str(p.device))
    xy = (p[..., :2] * 2 - 0.5 + grid) * stride
    wh = (p[..., 2:4] * 2) ** 2 * anchors
    out = torch.cat([xy, wh, p[..., 4:].float()], dim=-1)
    return out.reshape(b, h * w * na, -1)


class YoloV10(nn.Module):
    """YOLOv10 (``yolo.py:856``): :meth:`forward` emits the one-to-many head's
    raw output in the v8 contract (what the NMS route decodes),
    :meth:`one2one` the one-to-one head's top-``max_det`` detections (B,
    k, 6) = (x1, y1, x2, y2, score, class) with no NMS, :meth:`both` the
    two (the calibration pass: it runs every conv).  Both heads take v10's
    depthwise cls branch."""

    #: as YOLOv8's (``stem_s2d_ok``, ``yolo.py:866``)
    stem_takes_planes = True

    def __init__(self, spec: YoloSpec, int8: bool = False, max_det: int = 300):
        super().__init__()
        self.spec = spec
        self.max_det = max_det
        self.net = YoloBackboneNeck(spec, int8=int8)
        self.head_o2m = DetectHeadV8(spec, int8=int8, suffix="m", lightweight_cls=True)
        self.head_o2o = DetectHeadV8(spec, int8=int8, suffix="o", lightweight_cls=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat(self.head_o2m(self.net(x)), dim=1)

    def both(self, x: torch.Tensor):
        feats = self.net(x)
        return torch.cat(self.head_o2m(feats), dim=1), self._o2o(feats)

    def one2one(self, x: torch.Tensor) -> torch.Tensor:
        return self._o2o(self.net(x))

    def _o2o(self, feats) -> torch.Tensor:
        """Top-k of the one-to-one head by class max (``_o2o_from_feats``,
        ``yolo.py:903``).  A stable descending sort keeps equal scores in
        index order, as ``lax.top_k`` does."""
        xywh, cls = self.head_o2o(feats)
        scores, class_ids = cls.max(dim=1)
        k = min(self.max_det, scores.shape[1])
        top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
        top, idx = top[:, :k], idx[:, :k]
        box = torch.gather(xywh, 2, idx[:, None].expand(-1, 4, -1)).transpose(1, 2)
        cid = torch.gather(class_ids, 1, idx)
        half = box[..., 2:] / 2
        return torch.cat([box[..., :2] - half, box[..., :2] + half, top[..., None],
                          cid[..., None].float()], dim=-1)


def resolve_spec(spec: YoloSpec) -> YoloSpec:
    """JAX's scale fallbacks (``yolo.py:927-957``): YOLOv5-lite takes e/s/g
    (else s), v6 n/s/m/l (else s), v9 its GELAN variant c (else c); v7
    models one graph whatever the scale."""
    from . import yolov5lite, yolov6, yolov9

    known = {"v5lite": (yolov5lite.SCALES, "s"), "v6": (yolov6.SCALES, "s"),
             "v9": (tuple(yolov9.GELAN_CONFIGS), "c")}
    if spec.family in known and spec.scale not in known[spec.family][0]:
        return dataclasses.replace(spec, scale=known[spec.family][1])
    return spec


def build_yolo(spec: YoloSpec, int8: bool = False) -> nn.Module:
    """The net of ``spec.family`` (``build_yolo``, ``yolo.py:927``), its
    scale resolved as JAX resolves it (:func:`resolve_spec`)."""
    from .yolov5lite import YoloV5Lite
    from .yolov6 import YoloV6
    from .yolov7 import YoloV7
    from .yolov9 import YoloV9

    nets = {"v5": YoloV5, "v5lite": YoloV5Lite, "v6": YoloV6, "v7": YoloV7, "v8": YoloV8,
            "v9": YoloV9, "v10": YoloV10}
    if spec.family not in nets:
        raise ValueError(f"unknown yolo family {spec.family}")
    return nets[spec.family](resolve_spec(spec), int8=int8)
