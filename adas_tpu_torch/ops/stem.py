"""Fused stride-2 stem: conv + folded BN + activation (+ 3x3/2 max pool).

Port of ``adas_tpu/ops/pallas_stem.py``.  The TPU kernel there
(``_stem_kernel``, entered through ``fused_stem``) becomes the Hopper
kernel ``csrc/stem.cu``, built with nvcc for ``sm_90a`` and bound through
ctypes.  It serves the two stems of the main path: the YOLOv8 3x3/2 stem
(SiLU) and the ResNet 7x7/2 stem (ReLU, then the max pool, whose
full-resolution input never reaches device memory).  The kernel's source
note says what bounds it on the card and what its design does about it.

A CUDA tensor always launches the kernel (or raises); a CPU tensor takes
the plain version :func:`stem_reference`.  There is no compile probe and
no switch to the plain version on the GPU: the JAX side's
``_stem_compile_ok`` / ``ADAS_DISABLE_PALLAS_STEM`` have no counterpart.
Unlike the Pallas kernel, which realizes the pool's -inf padding as zeros
and so is routed away from odd sizes and non-ReLU pools
(``pallas_stem.py:471-476``), this kernel pads with real -inf and covers
every case itself.

Layouts are NCHW: ``x`` (N, 3, H, W), ``weight`` OIHW (64, 3, k, k) in
``x``'s dtype (f32 or bf16), ``gain``/``bias`` f32 (64,); the output is
(N, 64, Ho, Wo) in ``x``'s dtype.  Accumulation and the epilogue run in
f32, the result is cast once after the activation (and pooled after the
cast, as the JAX chain does: the cast is monotone, so the order does not
change the pooled value).  A bf16 input runs its products on the tensor
cores (bf16 x bf16 products are exact in f32: only the order of the sum
differs from the plain version); an f32 input stays on the CUDA cores.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .cuda_build import load_cuda_library, num_sms

#: launches of the CUDA kernel since the last :func:`reset_launches`; the
#: plain CPU path does not count
launches = 0

_ACT_CODES = {None: 0, "relu": 1, "silu": 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FEATURES = 64
_KERNEL_SIZES = (3, 7)


def reset_launches() -> None:
    global launches
    launches = 0


def _act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act == "relu":
        return F.relu(y)
    if act == "silu":
        return F.silu(y)
    return y


def stem_reference(
    x: torch.Tensor,
    weight: torch.Tensor,
    gain: torch.Tensor,
    bias: torch.Tensor,
    *,
    act: Optional[str],
    pool: bool,
) -> torch.Tensor:
    """The plain PyTorch stem: ``conv2d`` (stride 2, pad k//2) in f32 →
    ``*gain + bias`` → act → cast to ``x``'s dtype → ``max_pool2d(3, 2,
    1)``.  A bf16 input is widened first (exactly), so the conv sums in
    f32 as the kernel does and the result is rounded once; on a GPU the
    f32 conv is exact only with ``torch.backends.cudnn.allow_tf32`` off."""
    k = weight.shape[-1]
    y = F.conv2d(x.float(), weight.float(), stride=2, padding=k // 2)
    y = y * gain.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
    y = _act(y, act).to(x.dtype)
    if pool:
        y = F.max_pool2d(y, 3, 2, 1)
    return y


def stem_out_hw(h: int, w: int, pool: bool):
    """Output spatial size: ceil(/2) for the conv, again for the pool."""
    hc, wc = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    if pool:
        return (hc - 1) // 2 + 1, (wc - 1) // 2 + 1
    return hc, wc


def _check(x, weight, gain, bias, act):
    """What both paths take: (N, 3, H, W) input, (F, 3, k, k) odd-k
    weights of the same f32/bf16 dtype, f32 (F,) gain/bias."""
    if x.dim() != 4 or x.shape[1] != 3:
        raise ValueError(f"stem input must be (N, 3, H, W), got {tuple(x.shape)}")
    feat, k = weight.shape[0], weight.shape[-1]
    if weight.dim() != 4 or tuple(weight.shape[1:]) != (3, k, k) or k % 2 == 0:
        raise ValueError(f"stem weight must be (F, 3, k, k), k odd, got {tuple(weight.shape)}")
    if x.dtype not in _DTYPE_CODES or weight.dtype != x.dtype:
        raise TypeError(
            f"stem takes f32 or bf16 input with weights of the same dtype, "
            f"got {x.dtype} / {weight.dtype}"
        )
    for name, t in (("gain", gain), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (feat,):
            raise ValueError(f"stem {name} must be f32 ({feat},), got {t.dtype} {tuple(t.shape)}")
    if act not in _ACT_CODES:
        raise ValueError(f"unsupported stem activation: {act}")


def _check_cuda(x, weight, gain, bias):
    """What the CUDA kernel takes beyond :func:`_check`."""
    k = weight.shape[-1]
    if weight.shape[0] != _FEATURES or k not in _KERNEL_SIZES:
        raise ValueError(
            f"the stem kernel takes 64 features and k in {_KERNEL_SIZES}, "
            f"got weight {tuple(weight.shape)}"
        )
    for t in (weight, gain, bias):
        if t.device != x.device:
            raise ValueError(f"stem operands on {t.device} and {x.device}")
    for name, t in (("x", x), ("weight", weight), ("gain", gain), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"stem {name} must be contiguous")


def _entry():
    """The kernel's C entry, with its ctypes signature (pointers and the
    stream as c_void_p, so they are not cut to 32 bits)."""
    fn = load_cuda_library("stem").adas_stem_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_stem(
    x: torch.Tensor,
    weight: torch.Tensor,
    gain: torch.Tensor,
    bias: torch.Tensor,
    *,
    act: Optional[str],
    pool: bool,
) -> torch.Tensor:
    """``act(conv_s2(x) * gain + bias)`` (+ max pool) — the CUDA kernel for
    a CUDA ``x``, :func:`stem_reference` for a CPU ``x``."""
    global launches
    _check(x, weight, gain, bias, act)
    if x.device.type == "cpu":
        return stem_reference(x, weight, gain, bias, act=act, pool=pool)
    if x.device.type != "cuda":
        raise ValueError(f"stem runs on cuda or cpu, got {x.device}")
    _check_cuda(x, weight, gain, bias)
    n, _, h, w = x.shape
    ho, wo = stem_out_hw(h, w, pool)
    out = torch.empty((n, _FEATURES, ho, wo), dtype=x.dtype, device=x.device)
    entry = _entry()
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = entry(
            x.data_ptr(), weight.data_ptr(), gain.data_ptr(), bias.data_ptr(),
            out.data_ptr(), n, h, w, weight.shape[-1], int(pool),
            _ACT_CODES[act], _DTYPE_CODES[x.dtype], num_sms(index), stream,
        )
    if rc != 0:
        raise RuntimeError(f"stem kernel launch failed: cudaError_t {rc}")
    launches += 1
    return out
