"""W8A8 convolution with the fused int8 epilogue (the generic int8 conv).

Port of ``adas_tpu/ops/pallas_conv.py`` (the TPU kernel ``_conv_kernel``,
entry ``int8_conv3x3``) grown to every int8 conv of the serving path —
on the TPU the others were XLA convs inside
``adas_tpu/models/layers.py::int8_conv_apply``.  The kernel is
``csrc/int8_conv.cu`` (CUDA C++ for ``sm_90a``, bound through ctypes and
registered as the operator ``adas_tpu_torch::int8_conv``: wgmma
fed by TMA, the activations by the TMA's im2col mode or a cp.async
gather, a persistent grid); its source note says what bounds it on the
card and what its design does.  :func:`tile_config` picks the tile per
shape class and :func:`_plan` the activation path; the weights' TMA map
is encoded once per layer and cached, the activations' by address.

    y   = act(conv_s8(xq, wq) * scale + bias)      (s32 exact, f32 epilogue)
    out = y as bf16 (or f32 with ``out_f32``), or
          clip(round(y / out_scale), -127, 127) as s8

``scale`` is the full per-channel epilogue scale (weight scale x input
scale x folded BN gain, multiplied in that order by the caller) and
``bias`` the folded BN bias.  An uncalibrated int8 net quantizes each
image at its own dynamic input scale (JAX vmaps its step over streams),
so its ``scale`` is an (N, Cout) table, one row per image of the batch:
``scale[n]`` applies to image n's outputs (the kernel's per-image mode,
``rows_per_image`` = Ho * Wo).  k is 1 or 3, stride 1 or 2, padding k // 2.

Layouts: ``xq`` (N, H, W, C) s8, NHWC with the channels contiguous; it may
be a channel slice of a wider tensor (the kernel reads it in place through
its channel pitch).  ``wq`` (Cout, k, k, Cin) s8 with each output
channel's K = k*k*Cin bytes contiguous (a row; rows may be spaced wider).
The output is a new contiguous (N, Ho, Wo, Cout) tensor.  The CUDA
kernel takes Cin, the channel pitch, the input's base address and Cout
in multiples of 8, and rows spaced by multiples of 16 bytes (the TMA's
stride); the plain version takes any widths.  The module tree gives it
weights, scale and bias padded once, when packed (:func:`pad_weight`,
:func:`pad_channels`, ``models/quant.QConv2d.kernel_weight``): zero
channels up to multiples of 8, rows padded to 16 bytes; a conv whose
own widths are not multiples of 8 (YOLOv5-lite-s's 58- and 116-wide
ShuffleNet branches, read at an offset of 58 or 116 channels) names its
``cout``.  Per call, the wrapper copies such an input into a new NHWC
tensor of the padded Cin and the output's first ``cout`` channels out.
The zero channels add nothing to the s32 sums, so the result is the
plain version's to the bit.  Weights whose rows are not spaced by 16
bytes get a padded copy per call.

A CUDA tensor always launches the kernel (or raises); a CPU tensor takes
the plain version :func:`int8_conv_reference`.  There is no compile probe
and no switch to the plain version on the GPU (the JAX side's
``conv_compile_ok`` / ``ADAS_PALLAS_CONV`` have no counterpart).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional

import torch
import torch.nn.functional as F

from .cuda_build import load_cuda_library, num_sms
from .library import define

#: launches of the CUDA kernel since the last :func:`reset_launches`; the
#: plain CPU path does not count
launches = 0

ACT_CODES = {None: 0, "relu": 1, "silu": 2}


def reset_launches() -> None:
    global launches
    launches = 0


def activation(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act == "relu":
        return F.relu(y)
    if act == "silu":
        return F.silu(y)
    if act is None:
        return y
    raise ValueError(f"unsupported activation: {act}")


def requantize(y: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(y / scale), -127, 127)`` as s8 (round half to even, as
    ``jnp.round``), in ``y``'s memory layout."""
    return torch.round(y.float() / scale).clamp_(-127, 127).to(torch.int8)


def int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """Exact s8 x s8 -> s32 product ``a @ b_t.T`` (``a`` (M, K), ``b_t``
    (N, K), both s8).  On a GPU ``torch._int_mm`` takes only M > 16 and K,
    N multiples of 8: short ``a`` is padded to 32 rows (8 streams of a
    dense layer), K and N with zeros to multiples of 8 (YOLOv5-lite's
    58-wide convs), and the product sliced back."""
    if a.device.type == "cuda":
        m, k = a.shape
        n = b_t.shape[0]
        kp, np_ = -k % 8, -n % 8
        if kp or np_:
            a, b_t = F.pad(a, (0, kp)), F.pad(b_t, (0, kp, 0, np_))
        if m <= 16:
            a = F.pad(a, (0, 0, 0, 32 - m))
        return torch._int_mm(a, b_t.t())[:m, :n]
    return torch._int_mm(a, b_t.t())


def conv_out_hw(h: int, w: int, k: int, stride: int):
    pad = k // 2
    return (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1


def im2col(xq: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """The implicit GEMM's A operand made explicit: (N*Ho*Wo, k*k*C) s8
    rows, the taps in (dy, dx, c) order (zero outside the image)."""
    n, h, w, cin = xq.shape
    ho, wo = conv_out_hw(h, w, k, stride)
    if k == 1:
        cols = xq[:, ::stride, ::stride, :]
    else:
        pad = k // 2
        xp = F.pad(xq, (0, 0, pad, pad, pad, pad))
        span_h, span_w = stride * (ho - 1) + 1, stride * (wo - 1) + 1
        cols = torch.stack(
            [xp[:, dy: dy + span_h: stride, dx: dx + span_w: stride, :]
             for dy in range(k) for dx in range(k)],
            dim=3,
        )
    return cols.reshape(n * ho * wo, k * k * cin)


def int8_conv_accumulate(xq: torch.Tensor, wq: torch.Tensor, stride: int) -> torch.Tensor:
    """The exact s32 accumulator (N, Ho, Wo, Cout): :func:`im2col`, then
    one integer matmul."""
    n, h, w, _ = xq.shape
    cout, k = wq.shape[0], wq.shape[1]
    ho, wo = conv_out_hw(h, w, k, stride)
    acc = int_mm(im2col(xq, k, stride), wq.reshape(cout, -1))
    return acc.reshape(n, ho, wo, cout)


def epilogue(
    acc: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor],
    act: Optional[str],
    out_scale: Optional[torch.Tensor],
    out_f32: bool = False,
) -> torch.Tensor:
    """``layers.py:485-511`` on an s32 NHWC accumulator: ``acc * scale``
    (per channel, or an (N, Cout) table of a row per image) then ``+ bias``
    (two roundings), the activation, then s8 at ``out_scale``, else f32
    with ``out_f32`` (a conv with no folded BN, ``layers.py:505-510``) or
    bf16."""
    if scale.dim() == 2:
        scale = scale[:, None, None, :]
    y = acc.float() * scale
    if bias is not None:
        y = y + bias
    y = activation(y, act)
    if out_scale is not None:
        return requantize(y, out_scale)
    return y if out_f32 else y.to(torch.bfloat16)


def int8_conv_reference(
    xq: torch.Tensor,
    wq: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor],
    *,
    stride: int,
    act: Optional[str],
    out_scale: Optional[torch.Tensor] = None,
    out_f32: bool = False,
    cout: Optional[int] = None,
) -> torch.Tensor:
    """The plain PyTorch W8A8 conv: exact s32 accumulator
    (:func:`int8_conv_accumulate`) and :func:`epilogue`, on the first
    ``cout`` output and ``xq``'s input channels of padded operands."""
    cout = wq.shape[0] if cout is None else cout
    wq = wq[:cout, ..., :xq.shape[3]]
    scale = scale[..., :cout]
    bias = None if bias is None else bias[:cout]
    return epilogue(int8_conv_accumulate(xq, wq, stride), scale, bias, act, out_scale, out_f32)


def pad_weight(wq: torch.Tensor) -> torch.Tensor:
    """``wq`` (Cout, k, k, Cin) as the CUDA kernel takes it: zero output
    and input channels appended up to multiples of 8, and each output
    channel's row of K = k*k*Cin bytes padded to a multiple of 16 (the TMA
    strides rows by multiples of 16 bytes), returned as the (Cout, k, k,
    Cin) view of those rows; ``wq`` itself where nothing needs padding."""
    cout, k, _, cin = wq.shape
    cout8, cin8 = cout + -cout % 8, cin + -cin % 8
    kk = k * k * cin8
    if (cout8, cin8) == (cout, cin) and kk % 16 == 0 and wq.is_contiguous():
        return wq
    rows = wq.new_zeros((cout8, kk + -kk % 16))
    view = rows[:, :kk].view(cout8, k, k, cin8)
    view[:cout, ..., :cin] = wq
    return view


def pad_channels(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A per-output-channel vector (scale, bias), or a table of them (a
    row per image), with zeros appended up to :func:`pad_weight`'s Cout;
    None stays None."""
    if t is None or t.shape[-1] % 8 == 0:
        return t
    return F.pad(t, (0, -t.shape[-1] % 8))


def channel_pitch(x: torch.Tensor) -> int:
    """The channel pitch of an NHWC tensor whose channels are contiguous
    and whose pixels are evenly spaced (a channel slice of a contiguous
    NHWC tensor qualifies); raises otherwise."""
    n, h, w, c = x.shape
    sn, sh, sw, sc = x.stride()
    if sc != 1 or (w > 1 and sh != w * sw) or (h > 1 and sn != h * sh) or sw < c:
        raise ValueError(
            f"expected NHWC with contiguous channels and a channel pitch, got "
            f"shape {tuple(x.shape)} strides {x.stride()}"
        )
    return sw


def _padded(c: int):
    """The widths an operand of ``c`` channels may have: ``c``, or ``c``
    rounded up to 8 (:func:`pad_weight`)."""
    return (c, c + -c % 8)


def _check(xq, wq, scale, bias, stride, act, out_scale, out_f32=False, cout=None):
    if xq.dtype != torch.int8 or xq.dim() != 4:
        raise ValueError(f"int8 conv input must be (N, H, W, C) s8, got {tuple(xq.shape)} {xq.dtype}")
    wcout, k, k2, cin = wq.shape
    if wq.dtype != torch.int8 or k != k2 or k not in (1, 3) or cin not in _padded(xq.shape[3]):
        raise ValueError(
            f"int8 conv weight must be (Cout, k, k, {xq.shape[3]}) s8 with k in (1, 3) "
            f"(Cin may be padded to a multiple of 8), got {tuple(wq.shape)} {wq.dtype}"
        )
    if cout is not None and wcout not in _padded(cout):
        raise ValueError(f"int8 conv weight of {wcout} output channels for cout {cout}")
    cout = wcout
    if stride not in (1, 2):
        raise ValueError(f"int8 conv stride must be 1 or 2, got {stride}")
    if act not in ACT_CODES:
        raise ValueError(f"unsupported activation: {act}")
    if scale.dtype != torch.float32 or tuple(scale.shape) not in ((cout,), (xq.shape[0], cout)):
        raise ValueError(f"int8 conv scale must be f32 ({cout},) or ({xq.shape[0]}, {cout}) "
                         f"(a row per image), got {scale.dtype} {tuple(scale.shape)}")
    if bias is not None and (bias.dtype != torch.float32 or tuple(bias.shape) != (cout,)):
        raise ValueError(f"int8 conv bias must be f32 ({cout},), got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    if out_scale is not None and (out_scale.dtype != torch.float32 or out_scale.numel() != 1):
        raise ValueError("int8 conv out_scale must be one f32 value")
    if out_scale is not None and out_f32:
        raise ValueError("int8 conv output is s8 (out_scale) or f32 (out_f32), not both")


#: (BM, BN) tiles the kernel is built for (``csrc/int8_conv.cu``
#: ``dispatch``): BM output pixels x BN output channels per tile
TILES = ((128, 256), (128, 128), (128, 64), (64, 128), (64, 64))


def tile_config(m: int, cout: int, num_sms: int):
    """The tile for an (M, Cout) conv: the fewest tile-rounds of the
    persistent grid, each tile weighted by the shared-memory traffic per
    MAC it costs (``BM*BN / min(1, intensity / 85)``, intensity =
    ``BM*BN / (BM+BN)`` MACs per operand byte; 85 is the 128 x 256 tile's).
    Big maps take 128 x 256 (Cout >= 256), 128 x 128 or 128 x 64; the
    20x20 and 10x50 maps, which have fewer 128-row tiles than SMs, take
    smaller ones."""
    def cost(tile):
        bm, bn = tile
        tiles = -(-m // bm) * -(-cout // bn)
        rounds = -(-tiles // num_sms)
        return rounds * bm * bn / min(1.0, bm * bn / (bm + bn) / 85.0)
    return min(TILES, key=cost)


@lru_cache(maxsize=None)
def _lib():
    lib = load_cuda_library("int8_conv")
    fn = lib.adas_int8_conv_forward
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    enc = lib.adas_int8_conv_encode_weights
    enc.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    enc.restype = ctypes.c_int
    enc = lib.adas_int8_conv_encode_input
    enc.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    enc.restype = ctypes.c_int
    return lib


#: launch plans by (input shape, strides and base alignment, weight
#: address, shape and row spacing, stride); see :func:`_plan`.  A plan's
#: weight TMA map holds only the weights' address, extents and row
#: spacing, so it stays valid for any weights at that address with that
#: shape; bounded as :data:`_INPUT_MAPS`.
_PLANS: dict = {}


def _plan(xq: torch.Tensor, wq: torch.Tensor, stride: int):
    """What a CUDA launch on these operands needs: the activation path
    (``vec`` 0: the im2col TMA, for 1x1 convs and Cin % 128 == 0 with the
    pitch and base 16-byte aligned; else the cp.async gather, 16 or 8
    bytes a copy), the tile, the weights' TMA map (of a zero-padded copy
    when the rows are not spaced by a multiple of 16 bytes: that plan is
    not cached) and the output shape.
    ``xq`` and ``wq`` are operands the kernel takes as they are (widths,
    pitch and base address multiples of 8)."""
    n, h, w, cin = xq.shape
    cout, k = wq.shape[0], wq.shape[1]
    pitch = channel_pitch(xq)
    vec = 16 if cin % 16 == 0 and pitch % 16 == 0 and xq.data_ptr() % 16 == 0 else 8
    if (k == 1 or cin % 128 == 0) and pitch % 16 == 0 and xq.data_ptr() % 16 == 0:
        vec = 0
    ho, wo = conv_out_hw(h, w, k, stride)
    index = xq.device.index if xq.device.index is not None else torch.cuda.current_device()
    sms = num_sms(index)
    bm, bn = tile_config(n * ho * wo, cout, sms)
    kk = k * k * cin
    w_copy, row = None, wq.stride(0)
    if row % 16:  # the TMA strides rows by multiples of 16 bytes
        w_copy = F.pad(wq.reshape(cout, kk), (0, -kk % 16))
        row = w_copy.shape[1]
    wmap = ctypes.create_string_buffer(128)
    rc = _lib().adas_int8_conv_encode_weights(
        (wq if w_copy is None else w_copy).data_ptr(), cout, kk, row, bn, ctypes.addressof(wmap)
    )
    if rc != 0:
        raise RuntimeError(f"int8 conv weight TMA map encode failed: code {rc}")
    # the C entry's integer arguments before and after the activation code
    plan = (w_copy, wmap, (n, h, w, cin, pitch, cout, k, stride), (vec, bm, bn, sms),
            (n, ho, wo, cout))
    if w_copy is None:
        if len(_PLANS) >= 4096:  # bounded as _INPUT_MAPS
            _PLANS.clear()
        _PLANS[(xq.shape, xq.stride(), xq.data_ptr() % 16, xq.device, wq.data_ptr(), wq.shape,
                wq.stride(0), stride)] = plan
    return plan


#: activations' im2col TMA maps by (address, extents, pitch, k, stride,
#: BM): the serving path's activations come back at the same addresses
#: tick after tick; bounded so that a stream of new addresses cannot grow it
_INPUT_MAPS: dict = {}


def _input_map(xq: torch.Tensor, pitch: int, k: int, stride: int, bm: int):
    n, h, w, cin = xq.shape
    key = (xq.data_ptr(), n, h, w, cin, pitch, k, stride, bm)
    xmap = _INPUT_MAPS.get(key)
    if xmap is None:
        xmap = ctypes.create_string_buffer(128)
        rc = _lib().adas_int8_conv_encode_input(
            xq.data_ptr(), n, h, w, cin, pitch, k, stride, bm, ctypes.addressof(xmap)
        )
        if rc != 0:
            raise RuntimeError(f"int8 conv activation TMA map encode failed: code {rc}")
        if len(_INPUT_MAPS) >= 4096:
            _INPUT_MAPS.clear()
        _INPUT_MAPS[key] = xmap
    return xmap


def _kernel_input(xq: torch.Tensor, cin: int) -> torch.Tensor:
    """``xq`` as the kernel reads it: in place where its width is ``cin``
    (the weights') and its pitch and base address are multiples of 8,
    else copied into a new NHWC tensor of ``cin`` channels, zero past its
    own."""
    if xq.shape[3] == cin and channel_pitch(xq) % 8 == 0 and xq.data_ptr() % 8 == 0:
        return xq
    xp = xq.new_zeros((*xq.shape[:3], cin))
    xp[..., :xq.shape[3]] = xq
    return xp


def _out(xq: torch.Tensor, wq: torch.Tensor, stride: int, out_scale, out_f32: bool,
         cout: Optional[int]) -> torch.Tensor:
    """The new (N, Ho, Wo, cout) output tensor."""
    n, h, w, _ = xq.shape
    ho, wo = conv_out_hw(h, w, wq.shape[1], stride)
    dtype = torch.int8 if out_scale is not None else torch.float32 if out_f32 else torch.bfloat16
    return torch.empty((n, ho, wo, wq.shape[0] if cout is None else cout), dtype=dtype,
                       device=xq.device)


def _int8_conv_cuda(xq, wq, scale, bias, stride, act, out_scale, out_f32, cout):
    """The operator's CUDA implementation: the kernel's launch.  The launch
    plans, TMA maps and the SM count stay in here: an exported graph holds
    none of them."""
    global launches
    for t in (wq, scale, bias, out_scale):
        if t is not None and t.device != xq.device:
            raise ValueError(f"int8 conv operands on {t.device} and {xq.device}")
    wcout, k, _, wcin = wq.shape
    if not wq[0].is_contiguous() or wq.stride(0) < k * k * wcin:
        raise ValueError("int8 conv weight rows (one per output channel) must be contiguous")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"int8 conv {name} must be contiguous")
    if wcout % 8 or wcin % 8:
        raise ValueError(
            f"the int8 conv kernel takes Cin and Cout in multiples of 8, got weights "
            f"{tuple(wq.shape)}: pad them, the scale and the bias (pad_weight, pad_channels)"
        )
    if scale.dim() == 2 and scale.shape[0] == 1:
        scale = scale[0]
    xq = _kernel_input(xq, wcin)
    key = (xq.shape, xq.stride(), xq.data_ptr() % 16, xq.device, wq.data_ptr(), wq.shape,
           wq.stride(0), stride)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _plan(xq, wq, stride)
    w_copy, wmap, shape_args, tile_args, out_shape = plan  # w_copy: padded rows, kept alive
    vec, bm = tile_args[:2]
    xmap = _input_map(xq, shape_args[4], shape_args[6], stride, bm) if vec == 0 else None
    out = _out(xq, wq, stride, out_scale, out_f32, None)
    rows_per_image = out_shape[1] * out_shape[2] if scale.dim() == 2 else 0
    args = (
        xq.data_ptr(), ctypes.addressof(wmap), None if xmap is None else ctypes.addressof(xmap),
        scale.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if out_scale is None else out_scale.data_ptr(), out.data_ptr(),
        *shape_args, ACT_CODES[act], int(out_f32), rows_per_image, *tile_args,
    )
    if xq.device.index == torch.cuda.current_device():
        rc = _lib().adas_int8_conv_forward(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(xq.device):
            rc = _lib().adas_int8_conv_forward(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: cudaError_t {rc}")
    launches += 1
    if cout is not None and cout != wcout:
        return out[..., :cout].contiguous()
    return out


_OP = define(
    "int8_conv(Tensor xq, Tensor wq, Tensor scale, Tensor? bias, int stride, str? act, "
    "Tensor? out_scale, bool out_f32, int? cout) -> Tensor",
    cpu=lambda xq, wq, scale, bias, stride, act, out_scale, out_f32, cout: int8_conv_reference(
        xq, wq, scale, bias, stride=stride, act=act, out_scale=out_scale, out_f32=out_f32,
        cout=cout),
    cuda=_int8_conv_cuda,
    fake=lambda xq, wq, scale, bias, stride, act, out_scale, out_f32, cout: _out(
        xq, wq, stride, out_scale, out_f32, cout))


def int8_conv(
    xq: torch.Tensor,
    wq: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor],
    *,
    stride: int,
    act: Optional[str],
    out_scale: Optional[torch.Tensor] = None,
    out_f32: bool = False,
    cout: Optional[int] = None,
) -> torch.Tensor:
    """W8A8 conv + fused epilogue — the CUDA kernel for a CUDA ``xq``,
    :func:`int8_conv_reference` for a CPU ``xq``.  Returns NHWC s8 when
    ``out_scale`` is given, else NHWC f32 with ``out_f32``, else bf16, of
    ``cout`` channels (by default all of ``wq``'s; fewer where the
    weights, scale and bias carry padding: module docstring).  ``scale``
    is per channel, or an (N, Cout) table of a row per image (the kernel's
    per-image mode; a batch of one takes the per-channel mode)."""
    _check(xq, wq, scale, bias, stride, act, out_scale, out_f32, cout)
    if xq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8 conv runs on cuda or cpu, got {xq.device}")
    return _OP(xq, wq, scale, bias, int(stride), act, out_scale, bool(out_f32),
               None if cout is None else int(cout))
