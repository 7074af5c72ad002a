"""YOLOv8 detector (port of the v8 branch of ``adas_tpu/models/yolo.py``):
C2f/SPPF CSP backbone + PAN neck, anchor-free DFL head, output
(B, 4+nc, N) like the official ONNX export.

Module names follow the flax tree (``net.stem``, ``net.stage1.m0.cv1``,
``head.box0_0`` ...), so ``weights.py`` maps a flax variable tree onto
these modules by path.  The 3x3/2 stem ConvBN runs through the fused stem
kernel.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
from torch import nn

from .layers import ConvBN, max_pool, resize_nearest_2x

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
    """3x3 -> 3x3 with optional shortcut (``yolo.py:98``)."""

    def __init__(self, cin: int, features: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBN(cin, features, 3)
        self.cv2 = ConvBN(features, features, 3)
        self.use_shortcut = shortcut and cin == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.use_shortcut else y


class C2f(nn.Module):
    """Split + cascaded bottlenecks, concat all (``yolo.py:275``)."""

    def __init__(self, cin: int, features: int, n: int = 1, shortcut: bool = False):
        super().__init__()
        self.hidden = features // 2
        self.cv1 = ConvBN(cin, 2 * self.hidden, 1)
        self.n = n
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(self.hidden, self.hidden, shortcut))
        self.cv2 = ConvBN((2 + n) * self.hidden, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        parts = [y[:, : self.hidden], y[:, self.hidden:]]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 cascaded 5x5 max pools
    (``yolo.py:328``)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        hidden = cin // 2
        self.cv1 = ConvBN(cin, hidden, 1)
        self.cv2 = ConvBN(4 * hidden, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        p1 = max_pool(y, 5, 1, pad=2)
        p2 = max_pool(p1, 5, 1, pad=2)
        p3 = max_pool(p2, 5, 1, pad=2)
        return self.cv2(torch.cat([y, p1, p2, p3], dim=1))


class YoloBackboneNeck(nn.Module):
    """CSP backbone + PAN neck (``yolo.py:513``, v8 without s8 groups)."""

    def __init__(self, spec: YoloSpec):
        super().__init__()
        ch, d = spec.channels, spec.depths
        self.stem = ConvBN(3, ch[0], 3, 2, stem=True)
        self.down1 = ConvBN(ch[0], ch[1], 3, 2)
        self.stage1 = C2f(ch[1], ch[1], d[0], True)
        self.down2 = ConvBN(ch[1], ch[2], 3, 2)
        self.stage2 = C2f(ch[2], ch[2], d[1], True)
        self.down3 = ConvBN(ch[2], ch[3], 3, 2)
        self.stage3 = C2f(ch[3], ch[3], d[2], True)
        self.down4 = ConvBN(ch[3], ch[4], 3, 2)
        self.stage4 = C2f(ch[4], ch[4], d[3], True)
        self.sppf = SPPF(ch[4], ch[4])
        self.fpn4 = C2f(ch[4] + ch[3], ch[3], d[0], False)
        self.fpn3 = C2f(ch[3] + ch[2], ch[2], d[0], False)
        self.pan3 = ConvBN(ch[2], ch[2], 3, 2)
        self.pan4 = C2f(ch[2] + ch[3], ch[3], d[0], False)
        self.pan5_down = ConvBN(ch[3], ch[3], 3, 2)
        self.pan5 = C2f(ch[3] + ch[4], ch[4], d[0], False)

    def forward(self, x: torch.Tensor):
        x = self.stage1(self.down1(self.stem(x)))
        p3 = self.stage2(self.down2(x))
        p4 = self.stage3(self.down3(p3))
        p5 = self.sppf(self.stage4(self.down4(p4)))
        t1 = self.fpn4(torch.cat([resize_nearest_2x(p5), p4], dim=1))
        n3 = self.fpn3(torch.cat([resize_nearest_2x(t1), p3], dim=1))
        n4 = self.pan4(torch.cat([self.pan3(n3), t1], dim=1))
        n5 = self.pan5(torch.cat([self.pan5_down(n4), p5], dim=1))
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


class DetectHeadV8(nn.Module):
    """Anchor-free decoupled head with DFL (``yolo.py:721``)."""

    def __init__(self, spec: YoloSpec):
        super().__init__()
        self.spec = spec
        ch, nc = spec.channels, spec.num_classes
        c2 = max(16, ch[2] // 4, spec.reg_max * 4)
        c3 = max(ch[2], min(nc, 100))
        for li, cin in enumerate((ch[2], ch[3], ch[4])):
            self.add_module(f"box{li}_0", ConvBN(cin, c2, 3))
            self.add_module(f"box{li}_1", ConvBN(c2, c2, 3))
            self.add_module(f"box{li}_2", nn.Conv2d(c2, 4 * spec.reg_max, 1))
            self.add_module(f"cls{li}_0", ConvBN(cin, c3, 3))
            self.add_module(f"cls{li}_1", ConvBN(c3, c3, 3))
            self.add_module(f"cls{li}_2", nn.Conv2d(c3, nc, 1))

    def forward(self, feats) -> torch.Tensor:
        s = self.spec
        boxes, clss = [], []
        for li, f in enumerate(feats):
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
    """YOLOv8-contract detector: output (B, 4+nc, N) (``yolo.py:788``)."""

    def __init__(self, spec: YoloSpec):
        super().__init__()
        self.spec = spec
        self.net = YoloBackboneNeck(spec)
        self.head = DetectHeadV8(spec)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.net(x))
