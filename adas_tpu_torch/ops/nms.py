"""Fixed-shape greedy NMS and soft-NMS, batched over streams (port of
``adas_tpu/ops/nms.py``: ``_select_loop``, ``nms_padded``,
``soft_nms_padded``).

The JAX loop runs per frame under ``vmap``; here the stream batch is a
tensor dimension.  On the GPU a selection is two kernels: the pairwise-IoU
matrix (``ops/iou.py``, ``csrc/iou.cu``) and the scan that reads one row
of it per step (:func:`nms_scan`, ``csrc/nms.cu``, one block per stream,
one launch per tick).  A CPU tensor takes the plain versions:
``pairwise_iou`` and :func:`nms_scan_reference`, the same loop in
PyTorch.  A CUDA tensor never reaches a plain version: it launches the
kernels or raises.

Semantics kept from the reference (see the docstring of
``adas_tpu/ops/nms.py``): methods hard (0), linear (1) and gaussian (2);
each step picks the first maximum of the live scores (ties to the lowest
index, as ``jnp.argmax``); the boxes still in play are rescored
(``live = where(active, live * weight, live)``), the picked box leaves the
pool, and once the best live score is at or below ``score_threshold`` the
stream selects nothing more (``active &= ok``); ``min(max_out, N)`` steps,
indices padded with -1.  Indices are int64 (the reference's are int32).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from .boxes import iou_row
from .cuda_build import load_cuda_library
from .iou import iou_matrix

NEG_INF = -1e30
METHODS = {"hard": 0, "linear": 1, "gaussian": 2}
#: the scan kernel keeps one candidate per thread of one block
MAX_CANDIDATES = 1024

#: launches of the scan kernel since the last :func:`reset_launches`; the
#: plain CPU path does not count
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _weight(ious: torch.Tensor, method: int, iou_threshold: float, sigma: float) -> torch.Tensor:
    """The rescoring weight of one step (``nms.py:123-129``)."""
    if method == 1:
        return torch.where(ious > iou_threshold, 1.0 - ious, torch.ones_like(ious))
    if method == 2:
        # a tensor divisor: PyTorch turns division by a Python scalar on
        # the GPU into a product with its reciprocal, which rounds otherwise
        return torch.exp(-(ious * ious) / torch.full((), sigma, device=ious.device))
    return torch.where(ious > iou_threshold, torch.zeros_like(ious), torch.ones_like(ious))


def _scan(
    row: Callable[[torch.Tensor], torch.Tensor],
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    method: int,
    sigma: float,
    score_threshold: float,
) -> torch.Tensor:
    """The plain loop of ``_select_loop`` over (B, N) scores; ``row(i)``
    gives the (B, N) IoU rows of the picked boxes ``i`` (B,)."""
    bsz, n = scores.shape
    live = scores.float()
    active = live > score_threshold
    cols = torch.arange(n, device=scores.device)
    neg = torch.full_like(live, NEG_INF)
    idxs, oks = [], []
    for _ in range(min(max_out, n)):
        # max over dim returns the first maximal index, as jnp.argmax
        best, i = torch.where(active, live, neg).max(dim=1)
        ok = best > score_threshold
        idxs.append(i)
        oks.append(ok)
        weight = _weight(row(i), method, iou_threshold, sigma)
        live = torch.where(active, live * weight, live)
        active = active & (cols != i[:, None]) & ok[:, None]
    out = torch.where(torch.stack(oks, dim=1), torch.stack(idxs, dim=1), -1)
    if out.shape[1] < max_out:
        pad = torch.full((bsz, max_out - out.shape[1]), -1, dtype=out.dtype, device=out.device)
        out = torch.cat([out, pad], dim=1)
    return out


def nms_scan_reference(
    iou: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    method: int = 0,
    sigma: float = 0.5,
    score_threshold: float = 0.0,
) -> torch.Tensor:
    """The plain PyTorch scan: ``iou`` (B, N, N), ``scores`` (B, N) ->
    picked indices (B, max_out) int64, padded with -1."""
    rows = torch.arange(iou.shape[0], device=iou.device)
    return _scan(lambda i: iou[rows, i], scores, iou_threshold, max_out, method, sigma,
                 score_threshold)


def _entry():
    fn = load_cuda_library("nms").adas_nms_scan
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(per_box, trailing, scores, max_out, method):
    """(B, N) ``scores`` beside a (B, N, *trailing) ``per_box`` tensor, and
    the scan's options."""
    if scores.dim() != 2 or tuple(per_box.shape) != (*scores.shape, *trailing):
        raise ValueError(
            f"expected (B, N) scores and (B, N, {', '.join(map(str, trailing))}) operand, got "
            f"{tuple(scores.shape)} and {tuple(per_box.shape)}"
        )
    if method not in (0, 1, 2):
        raise ValueError(f"method must be 0 (hard), 1 (linear) or 2 (gaussian), got {method}")
    if max_out <= 0:
        raise ValueError(f"max_out must be positive, got {max_out}")


def nms_scan(
    iou: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    method: int = 0,
    sigma: float = 0.5,
    score_threshold: float = 0.0,
) -> torch.Tensor:
    """The selection scan over a precomputed IoU matrix: the CUDA kernel
    for CUDA tensors (contiguous f32, N <= 1024), :func:`nms_scan_reference`
    for CPU tensors."""
    global launches
    _check(iou, (scores.shape[-1],), scores, max_out, method)
    if scores.device.type == "cpu" and iou.device.type == "cpu":
        return nms_scan_reference(iou, scores, iou_threshold, max_out, method, sigma,
                                  score_threshold)
    if scores.device.type != "cuda" or iou.device != scores.device:
        raise ValueError(f"nms_scan runs on one cuda device or the cpu, got {iou.device} "
                         f"and {scores.device}")
    for name, t in (("iou", iou), ("scores", scores)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"the scan kernel takes contiguous f32 {name}, got {t.dtype}")
    bsz, n = scores.shape
    if n > MAX_CANDIDATES:
        raise ValueError(f"the scan kernel takes at most {MAX_CANDIDATES} candidates, got {n}")
    out = torch.empty((bsz, max_out), dtype=torch.int64, device=scores.device)
    entry = _entry()
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        rc = entry(iou.data_ptr(), scores.data_ptr(), out.data_ptr(), bsz, n, max_out,
                   method, iou_threshold, sigma, score_threshold, stream)
    if rc != 0:
        raise RuntimeError(f"nms scan kernel launch failed: cudaError_t {rc}")
    launches += 1
    return out


def select_loop(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    method: int = 0,
    sigma: float = 0.5,
    score_threshold: float = 0.0,
    plus_one: bool = False,
    use_iou_matrix: bool = True,
) -> torch.Tensor:
    """``_select_loop`` batched: ``boxes`` (B, N, 4) xyxy, ``scores`` (B, N)
    -> picked indices (B, max_out) int64 in selection order, padded with
    -1.  With ``use_iou_matrix`` the IoU matrix is computed once and the
    scan reads its rows (the only route on the GPU); without it, each step
    computes its row with ``iou_row`` (CPU only; the rows are the same to
    the bit, so the picks are too)."""
    boxes = boxes.float().contiguous()
    scores = scores.float().contiguous()
    if use_iou_matrix:
        return nms_scan(iou_matrix(boxes, plus_one=plus_one), scores, iou_threshold, max_out,
                        method, sigma, score_threshold)
    if boxes.device.type != "cpu":
        raise ValueError("on the GPU the scan reads the IoU matrix: use_iou_matrix=True")
    _check(boxes, (4,), scores, max_out, method)
    rows = torch.arange(boxes.shape[0])
    return _scan(lambda i: iou_row(boxes, boxes[rows, i], plus_one=plus_one), scores,
                 iou_threshold, max_out, method, sigma, score_threshold)


def nms_padded(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, max_out: int = 100
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy hard NMS over padded inputs (``nms.py:38``): (B, N, 4) boxes,
    (B, N) scores (padding entries <= 0) -> (indices (B, max_out) padded
    with -1, counts (B,))."""
    picked = select_loop(boxes, scores, iou_threshold, max_out, method=0, sigma=0.5,
                         score_threshold=0.0, plus_one=False)
    return picked, (picked >= 0).sum(dim=1)


def soft_nms_padded(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float = 0.3,
    sigma: float = 0.5,
    score_threshold: float = 0.001,
    max_out: int = 100,
    method: str = "hard",
    plus_one: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft-NMS (linear / gaussian) or hard NMS with rescoring semantics
    (``nms.py:66``) -> (indices (B, max_out) padded with -1, counts (B,))."""
    picked = select_loop(boxes, scores, iou_threshold, max_out, method=METHODS[method],
                         sigma=sigma, score_threshold=score_threshold, plus_one=plus_one)
    return picked, (picked >= 0).sum(dim=1)
