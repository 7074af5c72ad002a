"""Pairwise IoU of a box set, batched, in two output modes (port of
``adas_tpu/ops/pallas_iou.py``).

The TPU kernel there (``_iou_kernel``, entered through ``iou_matrix``)
becomes the Hopper kernel ``csrc/iou.cu``, built with nvcc for ``sm_90a``,
bound through ctypes and registered as the operators
``adas_tpu_torch::iou_matrix`` / ``adas_tpu_torch::iou_mask``; its source note says what bounds it on the card
and what its design does about it.  One kernel body serves two modes:

* :func:`iou_matrix`, the (B, N, N) f32 matrix, which the rescoring scan
  (``ops/nms.py`` ``nms_scan``: the soft methods) reads one row of per
  step;
* :func:`iou_mask`, the same values compared with the IoU threshold and
  packed 32 to an int32 word, (B, N, ceil(N/32)), which is all that hard
  suppression (``ops/nms.py`` ``nms_walk``, the serving path) reads.

A CUDA tensor always launches the kernel (or raises); a CPU tensor takes
the plain version (:func:`iou_matrix_reference`,
:func:`iou_mask_reference`).  The kernel rounds each operation as the plain
version does, so on the card the two agree to the bit.  Unlike
``pallas_iou.iou_matrix`` there is no padding of N to a tile multiple: the
kernel masks the ragged edge itself.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .boxes import pairwise_iou
from .cuda_build import load_cuda_library
from .library import define

#: launches of the CUDA kernel, both modes, since the last
#: :func:`reset_launches`; the plain CPU path does not count
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def mask_words(n: int) -> int:
    """int32 words of one mask row: ceil(N / 32)."""
    return (n + 31) // 32


def iou_matrix_reference(boxes: torch.Tensor, plus_one: bool = False) -> torch.Tensor:
    """The plain PyTorch version: ``pairwise_iou(boxes, boxes)`` in f32."""
    boxes = boxes.float()
    return pairwise_iou(boxes, boxes, plus_one=plus_one)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., N) bool -> (..., ceil(N/32)) int32: bit k of word w (the value
    ``1 << k``, bit 31 the sign bit) is element 32 w + k; bits past N are
    zero."""
    n = bits.shape[-1]
    words = mask_words(n)
    padded = torch.nn.functional.pad(bits.long(), (0, 32 * words - n))
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    packed = (padded.unflatten(-1, (words, 32)) << shifts).sum(dim=-1)
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32)


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: (..., W) int32 -> (..., n) bool."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    return ((words.long()[..., None] >> shifts) & 1).bool().flatten(-2)[..., :n]


def iou_mask_reference(boxes: torch.Tensor, iou_threshold: float,
                       plus_one: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the mask mode: the bits of
    ``pairwise_iou(boxes, boxes) > iou_threshold`` (the threshold rounded
    to f32 by the comparison), packed by :func:`pack_bits`: bit k of
    ``mask[b, i, w]`` is set when IoU(i, 32 w + k) > ``iou_threshold``."""
    return pack_bits(iou_matrix_reference(boxes, plus_one) > iou_threshold)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_cuda_library("iou")
    lib.adas_iou_matrix.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.adas_iou_mask.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                                  + [ctypes.c_float, ctypes.c_void_p])
    for fn in (lib.adas_iou_matrix, lib.adas_iou_mask):
        fn.restype = ctypes.c_int
    return lib


def _check(boxes: torch.Tensor, name: str) -> None:
    """Validates (B, N, 4) boxes."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"{name} takes (B, N, 4) boxes, got {tuple(boxes.shape)}")
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, got {boxes.device}")


def _check_cuda(boxes: torch.Tensor) -> None:
    """What the CUDA kernel takes: contiguous f32 boxes."""
    if boxes.dtype != torch.float32 or not boxes.is_contiguous():
        raise ValueError(f"the IoU kernel takes contiguous f32 boxes, got {boxes.dtype}")


def _launch(entry, boxes: torch.Tensor, out: torch.Tensor, plus_one: bool, *threshold):
    global launches
    _check_cuda(boxes)
    if out.numel() == 0:
        return out
    bsz, n, _ = boxes.shape
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        rc = entry(boxes.data_ptr(), out.data_ptr(), bsz, n, int(plus_one), *threshold, stream)
    if rc != 0:
        raise RuntimeError(f"iou kernel launch failed: cudaError_t {rc}")
    launches += 1
    return out


def _matrix_out(boxes: torch.Tensor) -> torch.Tensor:
    bsz, n, _ = boxes.shape
    return torch.empty((bsz, n, n), dtype=torch.float32, device=boxes.device)


def _mask_out(boxes: torch.Tensor) -> torch.Tensor:
    bsz, n, _ = boxes.shape
    return torch.empty((bsz, n, mask_words(n)), dtype=torch.int32, device=boxes.device)


def _matrix_cuda(boxes, plus_one):
    return _launch(_lib().adas_iou_matrix, boxes, _matrix_out(boxes), plus_one)


def _mask_cuda(boxes, iou_threshold, plus_one):
    return _launch(_lib().adas_iou_mask, boxes, _mask_out(boxes), plus_one, iou_threshold)


# The kernel's two entries as operators (``ops/library.py``); the CPU
# implementations look the plain versions up at each call.
_MATRIX_OP = define("iou_matrix(Tensor boxes, bool plus_one) -> Tensor",
                    cpu=lambda *args: iou_matrix_reference(*args), cuda=_matrix_cuda,
                    fake=lambda boxes, plus_one: _matrix_out(boxes))
_MASK_OP = define("iou_mask(Tensor boxes, float iou_threshold, bool plus_one) -> Tensor",
                  cpu=lambda *args: iou_mask_reference(*args), cuda=_mask_cuda,
                  fake=lambda boxes, iou_threshold, plus_one: _mask_out(boxes))


def iou_matrix(boxes: torch.Tensor, plus_one: bool = False) -> torch.Tensor:
    """(B, N, 4) xyxy boxes -> (B, N, N) f32 IoU: the CUDA kernel for a
    CUDA tensor (f32, contiguous), :func:`iou_matrix_reference` for a CPU
    tensor."""
    _check(boxes, "iou_matrix")
    return _MATRIX_OP(boxes, bool(plus_one))


def iou_mask(boxes: torch.Tensor, iou_threshold: float, plus_one: bool = False) -> torch.Tensor:
    """(B, N, 4) xyxy boxes -> (B, N, ceil(N/32)) int32 packed bits of
    IoU > ``iou_threshold`` (see :func:`iou_mask_reference`): the CUDA
    kernel for a CUDA tensor (f32, contiguous), the plain version for a
    CPU tensor."""
    _check(boxes, "iou_mask")
    return _MASK_OP(boxes, float(iou_threshold), bool(plus_one))
