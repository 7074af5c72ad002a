"""Fused W8A8 residual body: conv3x3 -> requantized s8 mid -> conv3x3
[+ residual] -> act_post -> s8, NHWC in and out.

Port of ``adas_tpu/ops/pallas_block.py``: the TPU kernels ``_block_kernel``
(entry ``fused_block``, padded planar I/O) and ``_block_kernel_nhwc``
(entry ``fused_block_nhwc``) compute one function, which here is the one
Hopper kernel ``csrc/block.cu`` (CUDA C++ for ``sm_90a``, bound through
ctypes and registered as the operator ``adas_tpu_torch::fused_block``:
wgmma from shared memory, the input halo by TMA, a persistent grid).  The
planar domain (``PlanarQ``, ``to_planar``/``from_planar``) was a TPU lane-layout device and is not ported: consecutive fused blocks
chain NHWC s8 tensors.  The kernel's source note says what bounds it on
the card, what its design does and how it tiles the output; the input's
TMA map is encoded once per address and shape and cached.

    mid = clip(round(act1(conv_s8(x, w1) * scale1 + bias1) / mid_scale))
    y   = act2(conv_s8(mid, w2) * scale2 + bias2)
    y   = act_post(y + x * x_scale)            (residual)
    out = clip(round(y / out_scale))

``scale1 = w1_scale * x_scale * bn1_gain`` and ``scale2 = w2_scale *
mid_scale * bn2_gain`` (multiplied in that order by the caller, as
``resnet.py:265-266`` / ``yolo.py:220-221``).  ``x_scale``, ``mid_scale``
and ``out_scale`` are one-element f32 tensors on the input's device; the
kernel reads them there (no host round trip).

Layouts: ``xq`` (N, H, W, C) s8 with contiguous channels, possibly a
channel slice of a wider tensor; ``w1q``/``w2q`` (C, 3, 3, C) s8
contiguous.  The CUDA kernel takes C = Cin = Cmid = Cout in {16, 32, 48,
64} (every fusion site of the served nets); the plain version takes any
widths.

A CUDA tensor always launches the kernel (or raises); a CPU tensor takes
the plain version :func:`block_reference`.  No compile probe and no
switch to the plain version on the GPU (``block_compile_ok`` /
``ADAS_PALLAS_BLOCK`` have no counterpart).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .cuda_build import load_cuda_library, num_sms
from .library import define
from .int8_conv import (
    ACT_CODES,
    activation,
    channel_pitch,
    int8_conv_accumulate,
    int8_conv_reference,
    requantize,
)

#: launches of the CUDA kernel since the last :func:`reset_launches`; the
#: plain CPU path does not count
launches = 0

KERNEL_WIDTHS = (16, 32, 48, 64)

#: the fusion gate of the served nets (``pallas_block.py:719-728``,
#: ``block_shape_wins``): a stride-1 same-width body with at most
#: ``FUSE_MAX_C`` channels on at least ``FUSE_MIN_HW`` pixels.  A
#: placeholder carried over from the TPU: the H100's own gate is to be set
#: by measurement.
FUSE_MIN_HW = 80 * 80
FUSE_MAX_C = 64


def fuse_gate(h: int, w: int, c: int) -> bool:
    return c <= FUSE_MAX_C and h * w >= FUSE_MIN_HW and h >= 8


def reset_launches() -> None:
    global launches
    launches = 0


def block_reference(
    xq: torch.Tensor,
    x_scale: torch.Tensor,
    w1q: torch.Tensor,
    scale1: torch.Tensor,
    bias1: Optional[torch.Tensor],
    mid_scale: torch.Tensor,
    w2q: torch.Tensor,
    scale2: torch.Tensor,
    bias2: Optional[torch.Tensor],
    out_scale: torch.Tensor,
    *,
    act1: Optional[str],
    act2: Optional[str],
    act_post: Optional[str],
    residual: bool,
) -> torch.Tensor:
    """The plain block: two exact int8 convs with the kernel's epilogues
    (``xla_block_ref`` of ``tests/test_pallas_block.py``)."""
    mid = int8_conv_reference(xq, w1q, scale1, bias1, stride=1, act=act1, out_scale=mid_scale)
    y = int8_conv_accumulate(mid, w2q, 1).float() * scale2
    if bias2 is not None:
        y = y + bias2
    y = activation(y, act2)
    if residual:
        y = y + xq.float() * x_scale
    return requantize(activation(y, act_post), out_scale).contiguous()


def _check(xq, w1q, scale1, bias1, w2q, scale2, bias2, scalars, acts, residual):
    if xq.dtype != torch.int8 or xq.dim() != 4:
        raise ValueError(f"block input must be (N, H, W, C) s8, got {tuple(xq.shape)} {xq.dtype}")
    cin = xq.shape[3]
    cmid, cout = w1q.shape[0], w2q.shape[0]
    for name, wt, ci in (("w1", w1q, cin), ("w2", w2q, cmid)):
        if wt.dtype != torch.int8 or wt.dim() != 4 or tuple(wt.shape[1:]) != (3, 3, ci):
            raise ValueError(f"block {name} must be (C', 3, 3, {ci}) s8, got {tuple(wt.shape)}")
    if residual and cout != cin:
        raise ValueError("a residual block needs cout == cin")
    for name, t, c in (("scale1", scale1, cmid), ("bias1", bias1, cmid),
                       ("scale2", scale2, cout), ("bias2", bias2, cout)):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (c,)):
            raise ValueError(f"block {name} must be f32 ({c},), got {t.dtype} {tuple(t.shape)}")
    for t in scalars:
        if t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError("block scales must be one f32 value each")
    for a in acts:
        if a not in ACT_CODES:
            raise ValueError(f"unsupported activation: {a}")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_cuda_library("block")
    fn = lib.adas_block_forward
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    enc = lib.adas_block_encode_input
    enc.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    enc.restype = ctypes.c_int
    return lib


#: the input's TMA maps by (address, extents, pitch): the
#: serving path's activations come back at the same addresses tick after
#: tick; bounded so that a stream of new addresses cannot grow it
_INPUT_MAPS: dict = {}


def _input_map(xq: torch.Tensor, pitch: int):
    n, h, w, c = xq.shape
    key = (xq.data_ptr(), n, h, w, c, pitch)
    xmap = _INPUT_MAPS.get(key)
    if xmap is None:
        xmap = ctypes.create_string_buffer(128)
        rc = _lib().adas_block_encode_input(xq.data_ptr(), n, h, w, c, pitch,
                                            ctypes.addressof(xmap))
        if rc != 0:
            raise RuntimeError(f"fused block input TMA map encode failed: code {rc}")
        if len(_INPUT_MAPS) >= 4096:
            _INPUT_MAPS.clear()
        _INPUT_MAPS[key] = xmap
    return xmap


def _out(xq: torch.Tensor) -> torch.Tensor:
    return torch.empty(xq.shape, dtype=torch.int8, device=xq.device)


def _block_cuda(xq, x_scale, w1q, scale1, bias1, mid_scale, w2q, scale2, bias2, out_scale, act1,
                act2, act_post, residual):
    """The operator's CUDA implementation: the kernel's launch."""
    global launches
    for t in (x_scale, w1q, scale1, bias1, mid_scale, w2q, scale2, bias2, out_scale):
        if t is not None and t.device != xq.device:
            raise ValueError(f"fused block operands on {t.device} and {xq.device}")
    for t in (w1q, scale1, bias1, w2q, scale2, bias2):
        if t is not None and not t.is_contiguous():
            raise ValueError("fused block weights and epilogue vectors must be contiguous")
    n, h, w, c = xq.shape
    pitch = channel_pitch(xq)
    if not (c in KERNEL_WIDTHS and w1q.shape[0] == c and w2q.shape[0] == c
            and pitch % 16 == 0 and xq.data_ptr() % 16 == 0
            and w1q.data_ptr() % 16 == 0 and w2q.data_ptr() % 16 == 0):
        raise ValueError(
            f"the block kernel takes Cin = Cmid = Cout in {KERNEL_WIDTHS}, 16-byte aligned "
            f"input and weights and a pitch % 16 == 0, got {c} -> {w1q.shape[0]} -> "
            f"{w2q.shape[0]}, pitch {pitch}"
        )
    xmap = _input_map(xq, pitch)
    out = _out(xq)
    index = xq.device.index if xq.device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(xq.device):
        rc = _lib().adas_block_forward(
            ctypes.addressof(xmap), w1q.data_ptr(), scale1.data_ptr(),
            None if bias1 is None else bias1.data_ptr(), mid_scale.data_ptr(),
            w2q.data_ptr(), scale2.data_ptr(),
            None if bias2 is None else bias2.data_ptr(), x_scale.data_ptr(),
            out_scale.data_ptr(), out.data_ptr(), n, h, w, c,
            ACT_CODES[act1], ACT_CODES[act2], ACT_CODES[act_post], int(residual),
            num_sms(index), torch.cuda.current_stream(xq.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused block kernel launch failed: cudaError_t {rc}")
    launches += 1
    return out


_OP = define(
    "fused_block(Tensor xq, Tensor x_scale, Tensor w1q, Tensor scale1, Tensor? bias1, "
    "Tensor mid_scale, Tensor w2q, Tensor scale2, Tensor? bias2, Tensor out_scale, str? act1, "
    "str? act2, str? act_post, bool residual) -> Tensor",
    cpu=lambda xq, x_scale, w1q, scale1, bias1, mid_scale, w2q, scale2, bias2, out_scale, act1,
    act2, act_post, residual: block_reference(
        xq, x_scale, w1q, scale1, bias1, mid_scale, w2q, scale2, bias2, out_scale, act1=act1,
        act2=act2, act_post=act_post, residual=residual),
    cuda=_block_cuda,
    fake=lambda xq, *_: _out(xq))


def fused_block(
    xq: torch.Tensor,
    x_scale: torch.Tensor,
    w1q: torch.Tensor,
    scale1: torch.Tensor,
    bias1: Optional[torch.Tensor],
    mid_scale: torch.Tensor,
    w2q: torch.Tensor,
    scale2: torch.Tensor,
    bias2: Optional[torch.Tensor],
    out_scale: torch.Tensor,
    *,
    act1: Optional[str],
    act2: Optional[str],
    act_post: Optional[str],
    residual: bool,
) -> torch.Tensor:
    """One fused two-conv block, s8 NHWC in -> s8 NHWC out at
    ``out_scale`` — the CUDA kernel for a CUDA ``xq``,
    :func:`block_reference` for a CPU ``xq``."""
    _check(xq, w1q, scale1, bias1, w2q, scale2, bias2, (x_scale, mid_scale, out_scale),
           (act1, act2, act_post), residual)
    if xq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused block runs on cuda or cpu, got {xq.device}")
    return _OP(xq, x_scale, w1q, scale1, bias1, mid_scale, w2q, scale2, bias2, out_scale, act1,
               act2, act_post, bool(residual))
