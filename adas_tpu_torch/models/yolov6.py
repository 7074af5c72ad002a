"""YOLOv6 n/s/m/l (port of ``adas_tpu/models/yolov6.py``): the EfficientRep
trunk (n/s: RepBlock stages; m/l: CSPBep, BepC3 over BottleRep), the
RepPAN neck with ConvTranspose 2x upsampling, the EffiDeHead (anchor-free
distances; a 17-bin DFL at m/l), output (B, N, 5+nc) with objectness 1.

``RepVGGBlock`` keeps the training form's parameters (3x3 + 1x1 ConvBN
branches and an identity BN, summed, ReLU) so a training checkpoint maps
by path; :func:`fuse_repvgg` is RepVGG's ``switch_to_deploy`` in place
(``fuse_repvgg_variables``, ``yolov6.py:504``): each block becomes one
3x3 ConvBN (``fused``) whose BN carries the summed branch biases on
identity statistics, as the JAX facade serves v6 (``object_detector.py:
266-273``).  The fused convs are dense 3x3s the int8 policy serves W8A8
(the stem, 3 input channels, in bf16).  Under int8 the float layout is
NHWC from the stem on; ``TransposeUp`` is outside the int8 policy (it
reads the bf16 view and computes in f32, flax's promotion of bf16 input
and f32 params) and the head's 1x1 predictors stay f32.  The s8 groups
are JAX's: one per BepC3 and SimSPPF, and the four PAN concats
(``neck_p4_xmax``, ``neck_p3_xmax``, ``neck_n3_xmax``, ``neck_n4_xmax``,
owned by :class:`YoloV6`).

One divergence: BottleRep's weighted residual adds ``alpha`` times the
input's bf16 view.  The JAX block multiplies the raw input, which under
calibrated int8 is an s8 ``QTensor`` (BepC3's cv1 emits one), and raises
there (``yolov6.py:154-157``), so JAX's calibrated int8 v6 m/l does not
run; the port's does (``ROADMAP.md`` §3).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvBN
from .quant import QTensor, as_float, quantize_to
from .yolo import YoloSpec, _Group, _anchor_points, _make_divisible, _predict_f32, cat_, pool_

#: base channel plan (backbone 0-4, neck 5-10) and repeats (meituan
#: configs/yolov6n.py, ``yolov6.py:41-42``)
_V6_CHANNELS = (64, 128, 256, 512, 1024, 256, 128, 128, 256, 256, 512)
_V6_REPEATS = (1, 6, 12, 18, 6, 12, 12, 12, 12)
_V6_SCALES = {"n": (1 / 3, 0.25), "s": (1 / 3, 0.50)}
#: m/l (CSPBep trunk): depth, width, CSP hidden ratio
_V6_CSP_SCALES = {"m": (0.60, 0.75, 2.0 / 3.0), "l": (1.0, 1.0, 0.5)}
SCALES = tuple(_V6_SCALES) + tuple(_V6_CSP_SCALES)
BN_EPS = 1e-5


def v6_plan(scale: str):
    """(channels, repeats) of a scale (``yolov6.py:51``)."""
    depth, width = _V6_SCALES[scale] if scale in _V6_SCALES else _V6_CSP_SCALES[scale][:2]
    chans = [_make_divisible(min(c, 10_000) * width) for c in _V6_CHANNELS]
    reps = [r if r == 1 else max(1, round(r * depth)) for r in _V6_REPEATS]
    return chans, reps


def _relu_conv(cin, features, k=1, stride=1, int8=False):
    """meituan's SimConv: conv + BN + ReLU."""
    return ConvBN(cin, features, k, stride, act="relu", int8=int8)


class RepVGGBlock(nn.Module):
    """3x3 + 1x1 ConvBN branches (+ an identity BN at stride 1 when the
    width stays) summed, ReLU (``yolov6.py:64``); after :meth:`fuse` one
    3x3 ConvBN with ReLU, whose epilogue takes the caller's s8 emission."""

    def __init__(self, cin: int, features: int, stride: int = 1, int8: bool = False):
        super().__init__()
        self.rbr_dense = ConvBN(cin, features, 3, stride, act=None, int8=int8)
        self.rbr_1x1 = ConvBN(cin, features, 1, stride, act=None, int8=int8)
        if stride == 1 and cin == features:
            self.rbr_identity = nn.BatchNorm2d(features, eps=BN_EPS)
        self.cin, self.features, self.stride, self.int8 = cin, features, stride, int8

    def forward(self, x, emit_q: bool = False, emit_scale=None):
        if hasattr(self, "fused"):
            return self.fused(x, emit_q=emit_q, emit_scale=emit_scale)
        out = self.rbr_dense(x) + self.rbr_1x1(x)
        if hasattr(self, "rbr_identity"):
            xf = as_float(x)
            if self.int8:
                xf = xf.float().permute(0, 3, 1, 2)
                out = out + self.rbr_identity(xf).permute(0, 2, 3, 1)
            else:
                out = out + self.rbr_identity(xf)
        return F.relu(out)

    @torch.no_grad()
    def fuse(self) -> None:
        """``switch_to_deploy`` on the host in f32 numpy, the arithmetic of
        ``fuse_repvgg_variables`` (``yolov6.py:522-571``): each branch's BN
        folded into its kernel (``t = scale / sqrt(var + eps)``), the 1x1
        kernel padded to 3x3, the identity as a centre-tap kernel, kernels
        and biases summed in that order; the fused BN has scale 1, mean 0,
        var 1 - eps."""
        if hasattr(self, "fused"):
            return

        def host(t):
            return t.detach().float().cpu().numpy()

        def fold(kernel, bn):  # kernel OIHW
            t = host(bn.weight) / np.sqrt(host(bn.running_var) + BN_EPS)
            return kernel * t[:, None, None, None], host(bn.bias) - host(bn.running_mean) * t

        dense, one = self.rbr_dense, self.rbr_1x1
        k, b = fold(host(dense.conv.weight), dense.bn)
        ka, ba = fold(np.pad(host(one.conv.weight), ((0, 0), (0, 0), (1, 1), (1, 1))), one.bn)
        k, b = k + ka, b + ba
        if hasattr(self, "rbr_identity"):
            kid = np.zeros(k.shape, np.float32)
            kid[np.arange(self.cin), np.arange(self.cin), 1, 1] = 1.0
            ki, bi = fold(kid, self.rbr_identity)
            k, b = k + ki, b + bi
            del self.rbr_identity
        dev = dense.conv.weight.device
        with torch.device(dev):
            fused = ConvBN(self.cin, self.features, 3, self.stride, act="relu", int8=self.int8)
        fused.conv.weight.copy_(torch.from_numpy(k))
        fused.bn.weight.fill_(1.0)
        fused.bn.bias.copy_(torch.from_numpy(b))
        fused.bn.running_mean.zero_()
        fused.bn.running_var.fill_(1.0 - BN_EPS)
        fused.to(dense.conv.weight.dtype)
        self.fused = fused.train(dense.training)
        del self.rbr_dense, self.rbr_1x1


def fuse_repvgg(module: nn.Module) -> nn.Module:
    """Every RepVGG block of ``module`` in its deploy form, in place
    (``fuse_repvgg_variables``); fused blocks stay as they are."""
    for m in list(module.modules()):
        if isinstance(m, RepVGGBlock):
            m.fuse()
    return module


class RepBlock(nn.Module):
    """``conv1`` RepVGG (in -> out) + (n-1) RepVGG (out -> out), chained s8
    in deploy form (``yolov6.py:115``)."""

    def __init__(self, cin: int, features: int, n: int = 1, int8: bool = False):
        super().__init__()
        self.conv1 = RepVGGBlock(cin, features, int8=int8)
        self.n = n
        for i in range(n - 1):
            self.add_module(f"block{i}", RepVGGBlock(features, features, int8=int8))

    def forward(self, x, emit_q: bool = False, emit_scale=None):
        last = self.n - 1
        x = self.conv1(x, emit_q=last > 0 or emit_q, emit_scale=None if last > 0 else emit_scale)
        for i in range(last):
            inner = i < last - 1
            x = getattr(self, f"block{i}")(x, emit_q=inner or emit_q,
                                           emit_scale=None if inner else emit_scale)
        return x


class BottleRep(nn.Module):
    """Two RepVGG blocks with an ``alpha``-weighted residual when the width
    stays (``yolov6.py:142``; the residual on the bf16 view: module
    docstring)."""

    def __init__(self, cin: int, features: int, int8: bool = False):
        super().__init__()
        self.conv1 = RepVGGBlock(cin, features, int8=int8)
        self.conv2 = RepVGGBlock(features, features, int8=int8)
        self.add = cin == features
        if self.add:
            self.alpha = nn.Parameter(torch.ones(1))

    def forward(self, x):
        y = self.conv2(self.conv1(x, emit_q=True))
        return y + self.alpha * as_float(x) if self.add else y


class BepC3(_Group):
    """CSP over a BottleRep chain (``yolov6.py:164``): cv1/cv2 1x1 ReLU
    branches, n//2 BottleReps on cv1's, cv3 merge; one s8 group."""

    def __init__(self, cin: int, features: int, n: int = 1, e: float = 0.5, int8: bool = False):
        super().__init__()
        c = int(features * e)
        self.cv1 = _relu_conv(cin, c, int8=int8)
        self.cv2 = _relu_conv(cin, c, int8=int8)
        self.m_conv1 = BottleRep(c, c, int8=int8)
        self.n_inner = n // 2 - 1
        for i in range(self.n_inner):
            self.add_module(f"m_block{i}", BottleRep(c, c, int8=int8))
        self.cv3 = _relu_conv(2 * c, features, int8=int8)
        self._init_group(int8)

    def forward(self, x, emit_q: bool = False, emit_scale=None):
        gscale = self.group_scale()
        a = self.cv1(x, emit_q=True)
        b = self.cv2(x, emit_scale=gscale)
        a = self.m_conv1(a)
        for i in range(self.n_inner):
            a = getattr(self, f"m_block{i}")(a)
        if gscale is not None and not isinstance(a, QTensor):
            a = quantize_to(a, gscale)
        return self.cv3(self.group_concat([a, b]), emit_q=emit_q, emit_scale=emit_scale)


class SimSPPF(_Group):
    """SPPF with ReLU convs (``yolov6.py:213``); one s8 group."""

    def __init__(self, cin: int, features: int, int8: bool = False):
        super().__init__()
        hidden = cin // 2
        self.cv1 = _relu_conv(cin, hidden, int8=int8)
        self.cv2 = _relu_conv(4 * hidden, features, int8=int8)
        self._init_group(int8)

    def forward(self, x, emit_q: bool = False, emit_scale=None):
        y = self.cv1(x, emit_scale=self.group_scale())
        p1 = pool_(y, 5, 1, 2, self.int8)
        p2 = pool_(p1, 5, 1, 2, self.int8)
        p3 = pool_(p2, 5, 1, 2, self.int8)
        return self.cv2(self.group_concat([y, p1, p2, p3]), emit_q=emit_q,
                        emit_scale=emit_scale)


class TransposeUp(nn.Module):
    """meituan ``Transpose``: ConvTranspose2d(k=2, s=2, bias) (``yolov6.py:237``);
    under int8 on the bf16 view, in f32, NHWC in and out."""

    def __init__(self, cin: int, features: int, int8: bool = False):
        super().__init__()
        self.upsample_transpose = nn.ConvTranspose2d(cin, features, 2, 2)
        self.int8 = int8

    def forward(self, x):
        if not self.int8:
            return self.upsample_transpose(x)
        y = F.conv_transpose2d(as_float(x).float().permute(0, 3, 1, 2),
                               self.upsample_transpose.weight.float(),
                               self.upsample_transpose.bias.float(), 2)
        return y.permute(0, 2, 3, 1)


def _stage(cin, c, n, csp_e, int8):
    return BepC3(cin, c, n, csp_e, int8=int8) if csp_e else RepBlock(cin, c, n, int8=int8)


class EfficientRep(nn.Module):
    """The trunk (``yolov6.py:264``); ``csp_e`` set: CSPBepBackbone (m/l)."""

    def __init__(self, chans, reps, csp_e: float = 0.0, int8: bool = False):
        super().__init__()
        c, r = chans, reps
        self.stem = RepVGGBlock(3, c[0], 2, int8=int8)
        cin = c[0]
        for si in range(2, 6):
            self.add_module(f"ERBlock_{si}_0", RepVGGBlock(cin, c[si - 1], 2, int8=int8))
            self.add_module(f"ERBlock_{si}_1", _stage(c[si - 1], c[si - 1], r[si - 1], csp_e, int8))
            cin = c[si - 1]
        self.ERBlock_5_2 = SimSPPF(c[4], c[4], int8=int8)

    def forward(self, x, emit_p3=None, emit_p4=None):
        x = self.ERBlock_2_0(self.stem(x), emit_q=True)
        x = self.ERBlock_2_1(x, emit_q=True)
        p3 = self.ERBlock_3_1(self.ERBlock_3_0(x, emit_q=True), emit_scale=emit_p3)
        p4 = self.ERBlock_4_1(self.ERBlock_4_0(p3, emit_q=True), emit_scale=emit_p4)
        x = self.ERBlock_5_1(self.ERBlock_5_0(p4, emit_q=True), emit_q=True)
        return p3, p4, self.ERBlock_5_2(x, emit_q=True)


class RepPANNeck(nn.Module):
    """The neck (``yolov6.py:312``); ``csp_e`` set: CSPRepPANNeck (m/l)."""

    def __init__(self, chans, reps, csp_e: float = 0.0, int8: bool = False):
        super().__init__()
        c, r = chans, reps
        q = dict(int8=int8)
        self.reduce_layer0 = _relu_conv(c[4], c[5], **q)
        self.upsample0 = TransposeUp(c[5], c[5], **q)
        self.Rep_p4 = _stage(c[5] + c[3], c[5], r[5], csp_e, int8)
        self.reduce_layer1 = _relu_conv(c[5], c[6], **q)
        self.upsample1 = TransposeUp(c[6], c[6], **q)
        self.Rep_p3 = _stage(c[6] + c[2], c[6], r[6], csp_e, int8)
        self.downsample2 = _relu_conv(c[6], c[7], 3, 2, **q)
        self.Rep_n3 = _stage(c[7] + c[6], c[8], r[7], csp_e, int8)
        self.downsample1 = _relu_conv(c[8], c[9], 3, 2, **q)
        self.Rep_n4 = _stage(c[9] + c[5], c[10], r[8], csp_e, int8)
        self.int8 = int8

    def forward(self, feats, gs, record):
        """``gs``: the four PAN group scales (None outside calibrated int8);
        ``record``: the calibration list per group, filled here and
        recorded by the owner."""
        p3, p4, p5 = feats
        i8 = self.int8

        def gq(y, name):
            # a member not produced by a conv epilogue: quantized into its group
            s = gs[name]
            return quantize_to(y, s) if s is not None and not isinstance(y, QTensor) else y

        def cat(parts, name):
            y = cat_(parts, i8)
            record[name].append(y)
            return y

        f0 = self.reduce_layer0(p5, emit_scale=gs["neck_n4_xmax"])
        up0 = gq(self.upsample0(f0), "neck_p4_xmax")
        x = self.Rep_p4(cat([up0, gq(p4, "neck_p4_xmax")], "neck_p4_xmax"), emit_q=True)
        f1 = self.reduce_layer1(x, emit_scale=gs["neck_n3_xmax"])
        up1 = gq(self.upsample1(f1), "neck_p3_xmax")
        out_p3 = self.Rep_p3(cat([up1, gq(p3, "neck_p3_xmax")], "neck_p3_xmax"), emit_q=True)
        d2 = self.downsample2(out_p3, emit_scale=gs["neck_n3_xmax"])
        out_n3 = self.Rep_n3(cat([d2, f1], "neck_n3_xmax"), emit_q=True)
        d1 = self.downsample1(out_n3, emit_scale=gs["neck_n4_xmax"])
        out_n4 = self.Rep_n4(cat([d1, f0], "neck_n4_xmax"), emit_q=True)
        return out_p3, out_n3, out_n4


class EffiDeHead(nn.Module):
    """Decoupled anchor-free head (``yolov6.py:388``): per level a 1x1 stem
    (emitting s8 for its two 3x3 consumers under int8), cls and reg 3x3
    convs and their plain 1x1 predictors; ltrb distances (a 17-bin DFL
    expectation at m/l), output (B, N, 5+nc) with objectness 1."""

    def __init__(self, spec: YoloSpec, head_chans, use_dfl: bool = False, int8: bool = False):
        super().__init__()
        self.spec, self.use_dfl, self.int8 = spec, use_dfl, int8
        nc = spec.num_classes
        q = dict(act="silu", int8=int8)
        for li, ch in enumerate(head_chans):
            self.add_module(f"stem{li}", ConvBN(ch, ch, 1, **q))
            self.add_module(f"cls_conv{li}", ConvBN(ch, ch, 3, **q))
            self.add_module(f"cls_pred{li}", nn.Conv2d(ch, nc, 1))
            self.add_module(f"reg_conv{li}", ConvBN(ch, ch, 3, **q))
            self.add_module(f"reg_pred{li}", nn.Conv2d(ch, 4 * 17 if use_dfl else 4, 1))

    def _predict(self, conv, f):
        """-> (B, H*W, out): f32 on the int8 net's NHWC features."""
        if self.int8:
            return _predict_f32(conv, f)
        return conv(f).flatten(2).transpose(1, 2)

    def forward(self, feats):
        s = self.spec
        regs, clss = [], []
        for li, f in enumerate(feats):
            stem = getattr(self, f"stem{li}")(f, emit_q=True)
            cls = self._predict(getattr(self, f"cls_pred{li}"),
                                getattr(self, f"cls_conv{li}")(stem))
            reg = self._predict(getattr(self, f"reg_pred{li}"),
                                getattr(self, f"reg_conv{li}")(stem))
            if self.use_dfl:
                b, n, _ = reg.shape
                r = torch.softmax(reg.reshape(b, n, 4, 17), dim=-1)
                reg = torch.sum(r * torch.arange(17, dtype=torch.float32, device=r.device), dim=-1)
            regs.append(reg)
            clss.append(torch.sigmoid(cls))
        reg, cls = torch.cat(regs, dim=1), torch.cat(clss, dim=1)
        anchors, strides = _anchor_points(s.input_size, s.strides, reg.device)
        anchors = anchors.t()
        x1y1 = anchors - reg[..., :2]
        x2y2 = anchors + reg[..., 2:]
        xywh = torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=-1) * strides[None, :, None]
        return torch.cat([xywh, torch.ones_like(cls[..., :1]), cls], dim=-1)


#: the PAN concat groups, owned by :class:`YoloV6`
NECK_GROUPS = ("neck_p4_xmax", "neck_p3_xmax", "neck_n3_xmax", "neck_n4_xmax")


class YoloV6(_Group):
    """YOLOv6 (``yolov6.py:457``): NCHW input in every precision, output
    (B, N, 5+nc)."""

    def __init__(self, spec: YoloSpec, int8: bool = False):
        super().__init__()
        self.spec = spec
        chans, reps = v6_plan(spec.scale)
        csp_e = _V6_CSP_SCALES[spec.scale][2] if spec.scale in _V6_CSP_SCALES else 0.0
        self.backbone = EfficientRep(chans, reps, csp_e, int8=int8)
        self.neck = RepPANNeck(chans, reps, csp_e, int8=int8)
        self.detect = EffiDeHead(spec, (chans[6], chans[8], chans[10]), use_dfl=bool(csp_e),
                                 int8=int8)
        self._init_group(int8, *NECK_GROUPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.int8:
            x = x.permute(0, 2, 3, 1)  # the int8 domain is NHWC (a view)
        gs = {n: self.group_scale(n) for n in NECK_GROUPS}
        record = {n: [] for n in NECK_GROUPS}
        feats = self.backbone(x, emit_p3=gs["neck_p3_xmax"], emit_p4=gs["neck_p4_xmax"])
        feats = self.neck(feats, gs, record)
        for n in NECK_GROUPS:
            self.group_record(record[n], n)
        return self.detect(feats)
