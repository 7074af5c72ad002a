"""W8A8 convolution with the fused int8 epilogue (the generic int8 conv).

Port of ``adas_tpu/ops/pallas_conv.py`` (the TPU kernel ``_conv_kernel``,
entry ``int8_conv3x3``) grown to every int8 conv of the serving path —
on the TPU the others were XLA convs inside
``adas_tpu/models/layers.py::int8_conv_apply``.  The kernel is
``csrc/int8_conv.cu`` (CUDA C++ for ``sm_90a``, bound through ctypes: wgmma
fed by TMA, the activations by the TMA's im2col mode or a cp.async
gather, a persistent grid); its source note says what bounds it on the
card and what its design does.  :func:`tile_config` picks the tile per
shape class and :func:`_plan` the activation path; the weights' TMA map
is encoded once per layer and cached, the activations' by address.

    y   = act(conv_s8(xq, wq) * scale + bias)      (s32 exact, f32 epilogue)
    out = y as bf16, or clip(round(y / out_scale), -127, 127) as s8

``scale`` is the full per-channel epilogue scale (weight scale x input
scale x folded BN gain, multiplied in that order by the caller) and
``bias`` the folded BN bias.  k is 1 or 3, stride 1 or 2, padding k // 2.

Layouts: ``xq`` (N, H, W, C) s8, NHWC with the channels contiguous; it may
be a channel slice of a wider tensor (the kernel reads it in place through
its channel pitch).  ``wq`` (Cout, k, k, Cin) s8 contiguous, so K =
k*k*Cin is contiguous per output channel.  The output is a new
contiguous (N, Ho, Wo, Cout) tensor.  The CUDA kernel takes Cin, the
channel pitch and Cout in multiples of 8 (every int8 conv of the served
nets at the COCO class count); the plain version takes any widths.  When
K = k*k*Cin is not a multiple of 16 (Cin % 16 == 8 at k = 3, or 1x1 at
Cin % 16 == 8) the TMA cannot stride the packed weights, and the wrapper
hands the kernel a zero-padded copy.

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

from .cuda_build import load_cuda_library

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
    dense layer), other shapes raise."""
    if a.device.type == "cuda":
        m, k = a.shape
        if k % 8 or b_t.shape[0] % 8:
            raise ValueError(f"int8 matmul on the GPU needs K and N % 8 == 0, got {k}, {b_t.shape[0]}")
        if m <= 16:
            return torch._int_mm(F.pad(a, (0, 0, 0, 32 - m)), b_t.t())[:m]
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
) -> torch.Tensor:
    """``layers.py:485-511`` on an s32 NHWC accumulator: ``acc * scale``
    then ``+ bias`` (two roundings), the activation, then s8 at
    ``out_scale`` or bf16."""
    y = acc.float() * scale
    if bias is not None:
        y = y + bias
    y = activation(y, act)
    if out_scale is not None:
        return requantize(y, out_scale)
    return y.to(torch.bfloat16)


def int8_conv_reference(
    xq: torch.Tensor,
    wq: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor],
    *,
    stride: int,
    act: Optional[str],
    out_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch W8A8 conv: exact s32 accumulator
    (:func:`int8_conv_accumulate`) and :func:`epilogue`."""
    return epilogue(int8_conv_accumulate(xq, wq, stride), scale, bias, act, out_scale)


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


def _check(xq, wq, scale, bias, stride, act, out_scale):
    if xq.dtype != torch.int8 or xq.dim() != 4:
        raise ValueError(f"int8 conv input must be (N, H, W, C) s8, got {tuple(xq.shape)} {xq.dtype}")
    cout, k, k2, cin = wq.shape
    if wq.dtype != torch.int8 or k != k2 or k not in (1, 3) or cin != xq.shape[3]:
        raise ValueError(
            f"int8 conv weight must be (Cout, k, k, {xq.shape[3]}) s8 with k in (1, 3), "
            f"got {tuple(wq.shape)} {wq.dtype}"
        )
    if stride not in (1, 2):
        raise ValueError(f"int8 conv stride must be 1 or 2, got {stride}")
    if act not in ACT_CODES:
        raise ValueError(f"unsupported activation: {act}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (cout,)):
            raise ValueError(f"int8 conv {name} must be f32 ({cout},), got {t.dtype} {tuple(t.shape)}")
    if out_scale is not None and (out_scale.dtype != torch.float32 or out_scale.numel() != 1):
        raise ValueError("int8 conv out_scale must be one f32 value")


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
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    enc = lib.adas_int8_conv_encode_weights
    enc.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    enc.restype = ctypes.c_int
    enc = lib.adas_int8_conv_encode_input
    enc.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    enc.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


#: launch plans by (input shape, strides and base alignment, weight
#: address and shape, stride); see :func:`_plan`.  A plan's weight TMA map
#: holds only the weights' address and extents, so it stays valid for any
#: weights at that address with that shape.
_PLANS: dict = {}


def _plan(xq: torch.Tensor, wq: torch.Tensor, stride: int):
    """What a CUDA launch on these operands needs: the activation path
    (``vec`` 0: the im2col TMA, for 1x1 convs and Cin % 128 == 0 with the
    pitch and base 16-byte aligned; else the cp.async gather, 16 or 8
    bytes a copy), the tile, the weights' TMA map (a zero-padded weight
    copy when K % 16 != 0, whose plan is not cached) and the output shape.
    Raises on what the kernel does not take."""
    n, h, w, cin = xq.shape
    cout, k = wq.shape[0], wq.shape[1]
    pitch = channel_pitch(xq)
    vec = next((v for v in (16, 8) if cin % v == 0 and pitch % v == 0 and xq.data_ptr() % v == 0), 0)
    if vec == 0 or cout % 8:
        raise ValueError(
            f"the int8 conv kernel takes Cin, the channel pitch and the base address "
            f"in multiples of 8 and Cout % 8 == 0, got Cin {cin} pitch {pitch} Cout {cout}"
        )
    if (k == 1 or cin % 128 == 0) and pitch % 16 == 0 and xq.data_ptr() % 16 == 0:
        vec = 0
    ho, wo = conv_out_hw(h, w, k, stride)
    index = xq.device.index if xq.device.index is not None else torch.cuda.current_device()
    num_sms = _num_sms(index)
    bm, bn = tile_config(n * ho * wo, cout, num_sms)
    kk = k * k * cin
    w2d = wq.view(cout, kk)
    padded = kk % 16 != 0
    if padded:  # the TMA strides rows by multiples of 16 bytes
        w2d = F.pad(w2d, (0, 16 - kk % 16))
    wmap = ctypes.create_string_buffer(128)
    rc = _lib().adas_int8_conv_encode_weights(
        w2d.data_ptr(), cout, kk, w2d.shape[1], bn, ctypes.addressof(wmap)
    )
    if rc != 0:
        raise RuntimeError(f"int8 conv weight TMA map encode failed: code {rc}")
    # the C entry's integer arguments before and after the activation code
    plan = (w2d if padded else None, wmap, (n, h, w, cin, pitch, cout, k, stride),
            (vec, bm, bn, num_sms), (n, ho, wo, cout))
    if not padded:
        _PLANS[(xq.shape, xq.stride(), xq.data_ptr() % 16, xq.device, wq.data_ptr(), wq.shape,
                stride)] = plan
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


def int8_conv(
    xq: torch.Tensor,
    wq: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor],
    *,
    stride: int,
    act: Optional[str],
    out_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """W8A8 conv + fused epilogue — the CUDA kernel for a CUDA ``xq``,
    :func:`int8_conv_reference` for a CPU ``xq``.  Returns NHWC s8 when
    ``out_scale`` is given, else NHWC bf16."""
    global launches
    _check(xq, wq, scale, bias, stride, act, out_scale)
    if xq.device.type == "cpu":
        return int8_conv_reference(xq, wq, scale, bias, stride=stride, act=act, out_scale=out_scale)
    if xq.device.type != "cuda":
        raise ValueError(f"int8 conv runs on cuda or cpu, got {xq.device}")
    for t in (wq, scale, bias, out_scale):
        if t is not None and t.device != xq.device:
            raise ValueError(f"int8 conv operands on {t.device} and {xq.device}")
    for name, t in (("weight", wq), ("scale", scale), ("bias", bias)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"int8 conv {name} must be contiguous")
    key = (xq.shape, xq.stride(), xq.data_ptr() % 16, xq.device, wq.data_ptr(), wq.shape, stride)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _plan(xq, wq, stride)
    w_keep, wmap, shape_args, tile_args, out_shape = plan  # w_keep: padded weights, kept alive
    vec, bm = tile_args[:2]
    xmap = _input_map(xq, shape_args[4], shape_args[6], stride, bm) if vec == 0 else None
    dtype = torch.bfloat16 if out_scale is None else torch.int8
    out = torch.empty(out_shape, dtype=dtype, device=xq.device)
    args = (
        xq.data_ptr(), ctypes.addressof(wmap), None if xmap is None else ctypes.addressof(xmap),
        scale.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if out_scale is None else out_scale.data_ptr(), out.data_ptr(),
        *shape_args, ACT_CODES[act], *tile_args,
    )
    if xq.device.index == torch.cuda.current_device():
        rc = _lib().adas_int8_conv_forward(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(xq.device):
            rc = _lib().adas_int8_conv_forward(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: cudaError_t {rc}")
    launches += 1
    return out
