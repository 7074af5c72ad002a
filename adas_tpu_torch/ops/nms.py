"""Fixed-shape greedy NMS, batched over streams (port of
``adas_tpu/ops/nms.py::_select_loop``, hard suppression only).

The JAX loop runs per frame under ``vmap``; here the stream batch is a
tensor dimension, so a tick costs ``max_out`` steps whatever the number
of streams.  The pairwise IoU is computed once up front (row ``i``
equals the per-step ``iou_row`` the JAX loop computes) and each step
gathers one row per stream.

Semantics kept from the reference (see the docstring of
``adas_tpu/ops/nms.py``): the reference's effective hard suppression
with VOC ``+1`` box arithmetic; each step picks the first maximum of the
live scores (``argmax`` ties go to the lowest index, as ``jnp.argmax``);
once the best live score falls to ``score_threshold`` the stream stops
selecting.
"""
from __future__ import annotations

import torch

from .boxes import pairwise_iou_rows

NEG_INF = -1e30


def select_loop_hard(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    score_threshold: float,
    plus_one: bool,
) -> torch.Tensor:
    """``boxes`` (B, N, 4), ``scores`` (B, N) -> picked indices (B, max_out)
    int64 in selection order, padded with -1."""
    bsz, n = scores.shape
    boxes = boxes.float()
    live = scores.float()
    iou = pairwise_iou_rows(boxes, plus_one=plus_one)  # (B, N, N)
    active = live > score_threshold
    rows = torch.arange(bsz, device=scores.device)
    cols = torch.arange(n, device=scores.device)
    neg = torch.full_like(live, NEG_INF)
    idxs, oks = [], []
    for _ in range(min(max_out, n)):
        # max over dim returns the first maximal index, as jnp.argmax
        best, i = torch.where(active, live, neg).max(dim=1)
        ok = best > score_threshold
        idxs.append(i)
        oks.append(ok)
        over = iou[rows, i] > iou_threshold  # (B, N)
        # hard suppression rescoring of the boxes still in play; the
        # selected box leaves the pool, and a stream that found nothing
        # above threshold stops
        live = live.masked_fill(active & over, 0.0)
        active = active & (cols != i[:, None]) & ok[:, None]
    out = torch.where(torch.stack(oks, dim=1), torch.stack(idxs, dim=1), -1)
    if out.shape[1] < max_out:
        pad = torch.full((bsz, max_out - out.shape[1]), -1, dtype=out.dtype,
                         device=out.device)
        out = torch.cat([out, pad], dim=1)
    return out
