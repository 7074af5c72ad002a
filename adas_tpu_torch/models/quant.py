"""The int8 quant core (port of ``adas_tpu/models/layers.py:81-325``).

The int8 domain is NHWC: a :class:`QTensor` is an s8 ``(N, H, W, C)``
tensor (channels contiguous) with one f32 scale, ``value = data * scale``.
Activations chain as QTensors between the fused epilogues of int8 convs
(s8 chaining) and through s8 concat groups whose members all emit at the
group owner's one scale.  Float activations in the int8 domain are NHWC
too; the bf16 NCHW stem output enters it as a permuted view, and the first
quantize writes the NHWC s8 copy (the transpose rides that pass).

Precision is a constructor argument of the nets (``int8=True``), not a
process-wide switch.  Calibration is a mode of the module tree for the
duration of :func:`calibrating`: int8 convs quantize their inputs with
the dynamic absmax, emit bf16 between layers, and record absmaxes into
registered buffers whose names follow the flax ``act_scales`` tree
(``xmax``/``ymax`` on a conv, ``concat_xmax`` on a C2f/SPPF,
``neck_a_xmax``/``neck_b_xmax`` on the neck, ``out_ymax`` on a ResNet
block).  Packed weights are buffers too (``wq`` s8 (Cout, kh, kw, Cin),
``wscale`` f32 (Cout,)), under the flax ``wscales``/``params`` paths;
the kernel's copy of ``wq``, padded to widths of multiples of 8, is
derived from them (:meth:`QConv2d.kernel_weight`).

Tensors derived from those buffers (scales ``max(x, 1e-12) / 127``, the
folded BN affine of an int8 conv or a stem, the per-conv epilogue scale
vector) are computed once and cached on the module; :func:`reset_int8_cache`
drops the caches after the buffers change (packing, calibration, loading,
the seeded init), and moving a module (``.to``) drops its own.
"""
from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8_conv import int_mm, pad_weight, requantize

class _QuantBufferNames:
    """The names of the buffers an int8 module may hold (absent, None,
    until packing/calibration): the packed weights ``wq``/``wscale`` and
    every activation absmax, whose names end in ``xmax`` or ``ymax`` as
    the flax ``act_scales`` leaves do (``xmax``, ``ymax``, ``concat_xmax``,
    ``neck_a_xmax``, ``out_ymax``, YOLOv7's ``elan4_xmax`` ...)."""

    def __contains__(self, name) -> bool:
        return isinstance(name, str) and (name in ("wq", "wscale")
                                          or name.endswith(("xmax", "ymax")))


QUANT_BUFFERS = _QuantBufferNames()


def per_row(scale: torch.Tensor, ndim: int) -> torch.Tensor:
    """``scale`` shaped to broadcast over an ``ndim``-d activation: a 0-d
    per-tensor scale as it is, a (B,) per-batch-element scale (a dynamic
    one, :func:`dynamic_scale`) as (B, 1, ...)."""
    return scale.view(-1, *(1,) * (ndim - 1)) if scale.dim() == 1 else scale


class QTensor(NamedTuple):
    """An s8 NHWC activation and its f32 scale (``layers.py:81``): one per
    tensor, or one per batch element for a dynamic quantize."""

    data: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.data.shape

    def dequant(self) -> torch.Tensor:
        """bf16 value view: ``(data * scale)`` in f32, cast once."""
        return (self.data.float() * per_row(self.scale, self.data.dim())).to(torch.bfloat16)

    def channels(self, start: int, stop: int) -> "QTensor":
        """A channel slice, still s8 (the scale is slice-invariant); a view,
        not a copy (``QTensor.__getitem__``, ``layers.py:107``)."""
        return QTensor(self.data[..., start:stop], self.scale)


Act = Union[QTensor, torch.Tensor]


def channels(x: Act, start: int, stop: int) -> Act:
    if isinstance(x, QTensor):
        return x.channels(start, stop)
    return x[..., start:stop]


def as_float(x: Act) -> torch.Tensor:
    return x.dequant() if isinstance(x, QTensor) else x


def div127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` rounded once, on every device.  PyTorch's CUDA kernels
    turn a division by a Python number into a product with its reciprocal,
    which can be one ulp off the quotient the CPU (and JAX) computes; a
    127 on the device (a fill, no copy from the host) keeps the true
    division."""
    return t / t.new_full((), 127.0)


def scale_from_max(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-12) / 127`` in f32 (``layers.py:295``)."""
    return div127(torch.clamp_min(amax.float(), 1e-12))


def absmax(x: torch.Tensor) -> torch.Tensor:
    return x.float().abs().amax()


def dynamic_scale(x: torch.Tensor) -> torch.Tensor:
    """The dynamic scale of an uncalibrated quantize, one per batch
    element: (B,), from the absmax over every dimension but the first.
    JAX vmaps its multi-stream step over streams, so each stream's
    absmax is its own (``layers.py:461-463`` under ``vmap``); at batch 1
    it is the per-tensor scale."""
    return scale_from_max(x.float().abs().amax(dim=tuple(range(1, x.dim()))))


def quantize_to(x: Act, scale: torch.Tensor) -> QTensor:
    """s8 quantize at ``scale`` (per tensor, or (B,) per batch element)
    into a new contiguous NHWC tensor (``layers.py:114``).  ``x`` is
    logically NHWC with any strides (a permuted NCHW view is transposed by
    the final cast-copy, not by a pass of its own)."""
    x = as_float(x)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    q.copy_(requantize(x, per_row(scale, x.dim())))
    return QTensor(q, scale)


def qconcat(parts: Sequence[Act]) -> Act:
    """Channel concat of an s8 group (``layers.py:172``): all-QTensor parts
    concatenate as s8 and must carry the SAME scale object (the group
    contract; a membership mistake would dequantize members wrong).  Any
    float member makes it a bf16 concat."""
    if parts and all(isinstance(p, QTensor) for p in parts):
        for p in parts[1:]:
            if p.scale is not parts[0].scale:
                raise ValueError(
                    "qconcat parts carry different scale objects: a concat-group "
                    "membership bug (every member must emit at the group owner's scale)"
                )
        return QTensor(torch.cat([p.data for p in parts], dim=-1), parts[0].scale)
    return torch.cat([as_float(p) for p in parts], dim=-1)


def int8_conv_eligible(groups: int, in_channels: int) -> bool:
    """Precision policy (``layers.py:227``): dense convs with more than 4
    input channels go int8; grouped convs and tiny-C_in stems stay bf16."""
    return groups == 1 and in_channels > 4


def quantize_weight(w: torch.Tensor):
    """Per-output-channel symmetric s8 of a weight whose dim 0 is the
    output channel (``layers.py:316-324``, ``tools/quantize.py:161-166``):
    ``wscale = max(absmax, 1e-8) / 127``, ``wq = clip(round(w / wscale))``,
    all in f32 -> bit-equal to the JAX packer."""
    w = w.float()
    amax = w.abs().amax(dim=tuple(range(1, w.dim())))
    wscale = div127(torch.clamp_min(amax, 1e-8))
    shape = (-1,) + (1,) * (w.dim() - 1)
    wq = torch.round(w / wscale.view(shape)).clamp_(-127, 127).to(torch.int8)
    return wq, wscale


def bn_fold(bn: nn.BatchNorm2d, conv_bias: Optional[torch.Tensor] = None):
    """``BNFoldParams`` (``layers.py:236``): gain = scale * rsqrt(var + eps),
    bias' = bias - mean * gain, f32; a conv bias folds in as ``bias' +
    gain * conv_bias`` (``int8_conv_apply``, ``layers.py:486-494``).
    Folded on the host and moved to the BN's device, so that a net folds to
    the same bits on every device: CUDA's ``rsqrt`` is not the CPU's in
    the last bit, and one ulp of a gain flips s8 values that a deep int8
    trunk spreads.  Its callers cache the fold on their module."""
    def host(t):
        return t.detach().float().cpu()

    gain = host(bn.weight) * torch.rsqrt(host(bn.running_var) + bn.eps)
    bias = host(bn.bias) - host(bn.running_mean) * gain
    if conv_bias is not None:
        bias = bias + gain * host(conv_bias)
    return gain.to(bn.weight.device), bias.to(bn.weight.device)


class Int8State:
    """Mixin for modules with int8 buffers: ``None``-valued buffer slots
    (``QUANT_BUFFERS``), a cache of tensors derived from them, and the
    calibration flag."""

    calibrating = False

    def _init_int8_buffers(self, *names: str) -> None:
        for name in names:
            self.register_buffer(name, None)

    def cached(self, key, make):
        cache = self.__dict__.setdefault("_int8_cache", {})
        if key not in cache:
            cache[key] = make()
        return cache[key]

    def clear_int8_cache(self) -> None:
        self.__dict__["_int8_cache"] = {}

    def _apply(self, fn, recurse=True):
        self.clear_int8_cache()
        return super()._apply(fn, recurse)

    def buffer_scale(self, name: str) -> Optional[torch.Tensor]:
        """``max(buf, 1e-12) / 127`` of a calibrated buffer, cached (one
        tensor object per buffer: the identity a concat group checks), or
        None while the buffer is absent."""
        if getattr(self, name) is None:
            return None
        return self.cached(name, lambda: scale_from_max(getattr(self, name)))

    def record_max(self, name: str, xs: Sequence[torch.Tensor]) -> None:
        """Calibration: running absmax of ``xs`` into buffer ``name`` (a
        missing buffer starts at the first value: the structural union of
        ``_union_max``, ``tools/quantize.py:219``)."""
        m = getattr(self, name)
        for x in xs:
            a = absmax(as_float(x))
            m = a if m is None else torch.maximum(m, a)
        setattr(self, name, m)


class QConv2d(Int8State, nn.Conv2d):
    """``nn.Conv2d`` (the f32 ``weight`` stays, for the flax ``kernel``) plus
    the int8 slots of ``Int8Conv``: packed ``wq``/``wscale`` and the
    calibrated ``xmax``/``ymax``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_int8_buffers("wq", "wscale", "xmax", "ymax")

    def _quantize(self):
        wq, wscale = quantize_weight(self.weight)
        return wq.permute(0, 2, 3, 1).contiguous(), wscale

    def pack(self) -> None:
        """Quantize ``weight`` into ``wq`` (OHWI) / ``wscale``; already
        packed convs keep theirs (a loaded packed tree)."""
        if self.wq is None:
            self.wq, self.wscale = self._quantize()

    def qweight(self):
        """(wq OHWI s8, wscale f32): the packed buffers, or the same
        quantize of ``weight`` computed once (``int8_weight_qparams``'s
        in-graph path)."""
        if self.wq is not None:
            return self.wq, self.wscale
        return self.cached("qweight", self._quantize)

    def kernel_weight(self) -> torch.Tensor:
        """``qweight``'s wq as the CUDA kernel takes it: zero channels
        appended to multiples of 8 in Cout and Cin (``pad_weight``; wq
        itself where they are), made once per packing."""
        return self.cached("kernel_weight", lambda: pad_weight(self.qweight()[0]))


class QLinear(Int8State, nn.Linear):
    """``nn.Linear`` plus the int8 slots of ``Int8Dense`` (``layers.py:720``):
    W8A8 ``x @ W^T`` with an exact s32 product, f32 out.  ``wq`` is (out,
    in) s8."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_int8_buffers("wq", "wscale", "xmax")

    def pack(self) -> None:
        if self.wq is None:
            self.wq, self.wscale = quantize_weight(self.weight)

    def qweight(self):
        if self.wq is not None:
            return self.wq, self.wscale
        return self.cached("qweight", lambda: quantize_weight(self.weight))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``Int8Dense.__call__``: quantize the input (calibrated static
        scale, else dynamic, one per batch element; calibration records
        ``xmax``), s8 x s8 -> s32, then ``acc * (wscale * xscale) + bias``,
        each batch element's rows at its own ``xscale``."""
        if self.calibrating:
            self.record_max("xmax", [x])
            xs = dynamic_scale(x)
        else:
            xs = self.buffer_scale("xmax")
            if xs is None:
                xs = dynamic_scale(x)
        wq, wscale = self.qweight()
        xq = requantize(x, per_row(xs, x.dim()))
        acc = int_mm(xq.reshape(-1, xq.shape[-1]), wq).float()
        # each batch element's rows of the product at its own scale
        y = acc.view(x.shape[0], -1, acc.shape[-1]) * (wscale * per_row(xs, 3))
        if self.bias is not None:
            y = y + self.bias
        return y.reshape(*x.shape[:-1], -1)


def reset_int8_cache(module: nn.Module) -> None:
    """Drop every derived-tensor cache under ``module`` (after its buffers
    changed)."""
    for m in module.modules():
        if isinstance(m, Int8State):
            m.clear_int8_cache()


def pack_int8_weights(module: nn.Module) -> int:
    """The port's weight packer (``tools/quantize.py:117``): quantize every
    int8 conv and dense kernel of ``module`` — the ``QConv2d``/``QLinear``
    the module tree built for the int8 policy — into its ``wq``/``wscale``
    buffers.  Returns how many it holds packed."""
    n = 0
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (QConv2d, QLinear)):
                m.pack()
                n += 1
    reset_int8_cache(module)
    return n


@contextlib.contextmanager
def calibrating(module: nn.Module):
    """Calibration mode of ``module``'s tree for the duration of the
    block (``quantized("int8_calib")``, over these modules only)."""
    mods: List[nn.Module] = list(module.modules())
    for m in mods:
        m.calibrating = True
    try:
        yield
    finally:
        for m in mods:
            m.calibrating = False
        reset_int8_cache(module)


def max_pool_q(x: QTensor, window: int, stride: int, pad: int) -> QTensor:
    """Max pool in the s8 domain (``layers.py:1090``): max commutes with
    the positive dequant scale.  Pooled through a bf16 view (s8 values are
    exact in bf16; torch has no int8 max pool on every device), padding
    -inf as the s8 domain's -128 never wins a window that holds data."""
    xb = x.data.permute(0, 3, 1, 2).to(torch.bfloat16)
    y = F.max_pool2d(xb, window, stride, pad)
    return QTensor(y.permute(0, 2, 3, 1).to(torch.int8).contiguous(), x.scale)


def max_pool_nhwc(x: Act, window: int, stride: int, pad: int = 0) -> Act:
    """Max pool of an NHWC activation: s8 for a QTensor (:func:`max_pool_q`),
    else through an NCHW view, padding -inf (``layers.max_pool``,
    ``layers.py:1078``)."""
    if isinstance(x, QTensor):
        return max_pool_q(x, window, stride, pad)
    return F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, pad).permute(0, 2, 3, 1)


def upsample2x_nhwc(x: Act) -> Act:
    """Nearest 2x upsample in NHWC (``layers.py:1106``); a QTensor stays
    s8 (replication commutes with the quantize)."""
    if isinstance(x, QTensor):
        return QTensor(upsample2x_nhwc(x.data), x.scale)
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)
