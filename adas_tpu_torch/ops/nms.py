"""Fixed-shape greedy NMS and soft-NMS, batched over streams (port of
``adas_tpu/ops/nms.py``: ``_select_loop``, ``nms_padded``,
``soft_nms_padded``).

The JAX loop runs per frame under ``vmap``; here the stream batch is a
tensor dimension.  On the GPU a selection is two kernels, one launch each
per tick, by route (:func:`select_loop`):

* hard suppression with ``score_threshold >= 0`` (the serving path): the
  IoU kernel's mask mode (``ops/iou.py`` ``iou_mask``, ``csrc/iou.cu``),
  then the walk (:func:`nms_walk`, ``csrc/nms.cu``), which picks the first
  unsuppressed candidate in score order by walking the packed bits;
* everything else (linear, gaussian, hard with a negative threshold): the
  IoU matrix (``iou_matrix``), then the rescoring scan (:func:`nms_scan`,
  ``csrc/nms.cu``), which reads one row of it per step.

Both kernels run one block per stream.  A CPU tensor takes the plain
versions: ``iou_mask_reference`` + :func:`nms_walk_reference`, or
``pairwise_iou`` + :func:`nms_scan_reference`, the same loops in PyTorch.
A CUDA tensor never reaches a plain version: it launches the kernels or
raises.  Each kernel is a registered operator (``adas_tpu_torch::nms_scan``,
``adas_tpu_torch::nms_walk``), so an exported graph keeps it as one node.  ``csrc/nms.cu``'s source note says why the walk picks what the
scan picks.

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
import functools
from typing import Callable, Tuple

import torch

from .boxes import iou_row
from .cuda_build import load_cuda_library
from .library import define
from .iou import iou_mask, iou_matrix, mask_words, unpack_bits

NEG_INF = -1e30
METHODS = {"hard": 0, "linear": 1, "gaussian": 2}
#: both kernels keep one candidate per thread of one block
MAX_CANDIDATES = 1024

#: launches of the scan and walk kernels since the last
#: :func:`reset_launches`; the plain CPU path does not count
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


def nms_walk_reference(
    mask: torch.Tensor, scores: torch.Tensor, max_out: int, score_threshold: float = 0.0
) -> torch.Tensor:
    """The plain PyTorch walk: ``mask`` (B, N, ceil(N/32)) int32, the packed
    bits of IoU > the IoU threshold (``ops/iou.py`` ``iou_mask``), and
    ``scores`` (B, N) -> picked indices (B, max_out) int64, padded with -1:
    what :func:`nms_scan_reference` picks under hard suppression with
    ``score_threshold >= 0``, for scores in any order.

    Each step picks the first candidate, in score-descending then
    index-ascending order, that is active (score above
    ``score_threshold``), not picked and not suppressed (its bit in no
    picked box's row); with none left the stream is done.  A pick that
    suppresses an active +inf score ends the stream after it (the
    reference's live score there becomes inf * 0 = NaN, which its next
    argmax takes, and fails the threshold)."""
    _check_walk(mask, scores, max_out, score_threshold)
    bsz, n = scores.shape
    s = scores.float()
    active = s > score_threshold
    # the reference's order: score descending, ties by index (a stable sort)
    order = torch.sort(torch.where(active, s, float("-inf")), dim=1, descending=True,
                       stable=True).indices
    removed = ~active  # never active: never picked
    done = torch.zeros(bsz, dtype=torch.bool, device=s.device)
    rows = torch.arange(bsz, device=s.device)
    idxs = []
    for _ in range(min(max_out, n)):
        live = ~removed.gather(1, order)
        done = done | ~live.any(dim=1)
        j = order.gather(1, live.int().argmax(dim=1, keepdim=True))[:, 0]
        idxs.append(torch.where(done, -1, j))
        before = removed.clone()
        before[rows, j] = True
        row = unpack_bits(mask[rows, j], n)
        poisoned = (row & ~before & (s == float("inf"))).any(dim=1)
        removed = torch.where(done[:, None], removed, before | row)
        done = done | poisoned
    out = torch.stack(idxs, dim=1)
    if out.shape[1] < max_out:
        pad = torch.full((bsz, max_out - out.shape[1]), -1, dtype=out.dtype, device=out.device)
        out = torch.cat([out, pad], dim=1)
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_cuda_library("nms")
    lib.adas_nms_scan.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                                  + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    lib.adas_nms_walk.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                                  + [ctypes.c_float, ctypes.c_void_p])
    for fn in (lib.adas_nms_scan, lib.adas_nms_walk):
        fn.restype = ctypes.c_int
    return lib


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
    for t in (per_box, scores):
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"nms runs on cuda or cpu, got {t.device}")


def _check_walk(mask, scores, max_out, score_threshold):
    """What both walks take: the (B, N, ceil(N/32)) mask beside (B, N)
    scores, and a non-negative score threshold (below 0 the walk is not
    the scan: see ``csrc/nms.cu``)."""
    _check(mask, (mask_words(scores.shape[-1]),), scores, max_out, 0)
    if not score_threshold >= 0:
        raise ValueError(f"the walk takes score_threshold >= 0, got {score_threshold}; "
                         "use nms_scan")


def _check_cuda(kernel: str, pairwise: torch.Tensor, scores: torch.Tensor) -> None:
    """What the ``kernel`` ("scan": f32 IoU matrix, "walk": int32 mask)
    takes: contiguous operands on one CUDA device, at most
    :data:`MAX_CANDIDATES` candidates."""
    if pairwise.device != scores.device:
        raise ValueError(f"nms_{kernel} runs on one cuda device or the cpu, got "
                         f"{pairwise.device} and {scores.device}")
    operand = ("iou", torch.float32, "f32") if kernel == "scan" else ("mask", torch.int32, "int32")
    for t, (name, dtype, dtype_name) in ((pairwise, operand),
                                         (scores, ("scores", torch.float32, "f32"))):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"the {kernel} kernel takes contiguous {dtype_name} {name}, "
                             f"got {t.dtype}")
    if scores.shape[1] > MAX_CANDIDATES:
        raise ValueError(f"the {kernel} kernel takes at most {MAX_CANDIDATES} candidates, "
                         f"got {scores.shape[1]}")


def _picks(scores: torch.Tensor, max_out: int) -> torch.Tensor:
    return torch.empty((scores.shape[0], max_out), dtype=torch.int64, device=scores.device)


def _launch(entry, kernel, pairwise, scores, max_out, *args) -> torch.Tensor:
    global launches
    _check_cuda(kernel, pairwise, scores)
    bsz, n = scores.shape
    out = _picks(scores, max_out)
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        rc = entry(pairwise.data_ptr(), scores.data_ptr(), out.data_ptr(), bsz, n, max_out,
                   *args, stream)
    if rc != 0:
        raise RuntimeError(f"nms {kernel} kernel launch failed: cudaError_t {rc}")
    launches += 1
    return out


def _scan_cuda(iou, scores, iou_threshold, max_out, method, sigma, score_threshold):
    return _launch(_lib().adas_nms_scan, "scan", iou, scores, max_out, method, iou_threshold,
                   sigma, score_threshold)


def _walk_cuda(mask, scores, max_out, score_threshold):
    return _launch(_lib().adas_nms_walk, "walk", mask, scores, max_out, score_threshold)


# The two kernels as operators (``ops/library.py``); the CPU
# implementations look the plain versions up at each call, the fake ones
# give the (B, max_out) picks.
_SCAN_OP = define(
    "nms_scan(Tensor iou, Tensor scores, float iou_threshold, int max_out, int method, "
    "float sigma, float score_threshold) -> Tensor",
    cpu=lambda *args: nms_scan_reference(*args), cuda=_scan_cuda,
    fake=lambda iou, scores, iou_threshold, max_out, *_: _picks(scores, max_out))
_WALK_OP = define(
    "nms_walk(Tensor mask, Tensor scores, int max_out, float score_threshold) -> Tensor",
    cpu=lambda *args: nms_walk_reference(*args), cuda=_walk_cuda,
    fake=lambda mask, scores, max_out, score_threshold: _picks(scores, max_out))


def nms_scan(
    iou: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    method: int = 0,
    sigma: float = 0.5,
    score_threshold: float = 0.0,
) -> torch.Tensor:
    """The rescoring scan over a precomputed IoU matrix: the CUDA kernel
    for CUDA tensors (contiguous f32, N <= 1024), :func:`nms_scan_reference`
    for CPU tensors."""
    _check(iou, (scores.shape[-1],), scores, max_out, method)
    return _SCAN_OP(iou, scores, float(iou_threshold), int(max_out), int(method), float(sigma),
                    float(score_threshold))


def nms_walk(
    mask: torch.Tensor, scores: torch.Tensor, max_out: int, score_threshold: float = 0.0
) -> torch.Tensor:
    """Hard suppression over the packed IoU mask (``iou_mask``), for
    ``score_threshold >= 0``: the CUDA kernel for CUDA tensors (contiguous
    int32 mask, f32 scores, N <= 1024), :func:`nms_walk_reference` for CPU
    tensors.  Picks what :func:`nms_scan` picks with ``method=0`` on the
    matrix the mask was made from."""
    _check_walk(mask, scores, max_out, score_threshold)
    return _WALK_OP(mask, scores, int(max_out), float(score_threshold))


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
    -1.  With ``use_iou_matrix`` the pairwise IoU is computed once (the
    only route on the GPU): hard suppression with ``score_threshold >= 0``
    as the packed mask, walked by :func:`nms_walk`; every other case as the
    matrix, whose rows :func:`nms_scan` reads.  Without it, each step
    computes its row with ``iou_row`` (CPU only; the rows are the same to
    the bit, so the picks are too)."""
    boxes = boxes.float().contiguous()
    scores = scores.float().contiguous()
    _check(boxes, (4,), scores, max_out, method)
    if use_iou_matrix:
        if method == 0 and score_threshold >= 0:
            return nms_walk(iou_mask(boxes, iou_threshold, plus_one=plus_one), scores, max_out,
                            score_threshold)
        return nms_scan(iou_matrix(boxes, plus_one=plus_one), scores, iou_threshold, max_out,
                        method, sigma, score_threshold)
    if boxes.device.type != "cpu":
        raise ValueError("on the GPU the scan reads the IoU matrix: use_iou_matrix=True")
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
