"""UFLD lane decodes on tensors (port of ``ufld_v2_decode`` /
``_axis_decode`` and ``ufld_v1_decode``, ``adas_tpu/ops/ufld_decode.py:29,
60,86``).

Softmax expectation over a ``±local_width`` window around the argmax
cell; at the grid edges the window shrinks through an additive -inf mask
(clamping would double-count the edge cell), as in the reference.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

NEG_INF = -1e30


def ufld_v2_decode(
    outputs: Dict[str, torch.Tensor], local_width: int = 1
) -> Dict[str, torch.Tensor]:
    """``loc_row`` (B, Gr, R, L), ``loc_col`` (B, Gc, C, L), ``exist_row``
    (B, 2, R, L), ``exist_col`` (B, 2, C, L) -> ``row_x`` (B, R, L) in units
    of image width, ``row_valid`` bool, ``col_y`` (B, C, L) in units of
    image height, ``col_valid`` bool."""
    row_x, row_valid = _axis_decode(outputs["loc_row"], outputs["exist_row"], local_width)
    col_y, col_valid = _axis_decode(outputs["loc_col"], outputs["exist_col"], local_width)
    return {"row_x": row_x, "row_valid": row_valid, "col_y": col_y, "col_valid": col_valid}


def _axis_decode(
    loc: torch.Tensor, exist: torch.Tensor, local_width: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, G, A, L) logits -> (B, A, L) coords and validity."""
    num_grid = loc.shape[1]
    valid = torch.argmax(exist, dim=1) == 1
    max_idx = torch.argmax(loc, dim=1)  # (B, A, L)
    offsets = torch.arange(-local_width, local_width + 1, device=loc.device)
    idx = max_idx[..., None] + offsets  # (B, A, L, W)
    in_range = (idx >= 0) & (idx <= num_grid - 1)
    vals = torch.gather(loc.movedim(1, -1), -1, idx.clamp(0, num_grid - 1))
    vals = torch.where(in_range, vals, torch.full_like(vals, NEG_INF))
    probs = torch.softmax(vals, dim=-1)
    expectation = torch.sum(probs * torch.where(in_range, idx, 0).to(probs.dtype), dim=-1)
    return (expectation + 0.5) / (num_grid - 1), valid


def ufld_v1_decode(output: torch.Tensor) -> torch.Tensor:
    """UFLD v1 logits (B, G+1, R, L) -> grid locations (B, R, L)
    (``ufld_decode.py:86``): rows flipped, the softmax expectation over the
    G lane cells with 1-based indices, 0 (no lane) where the argmax picks
    the background cell."""
    griding_num = output.shape[1] - 1
    flipped = output.flip(2)
    prob = torch.softmax(flipped[:, :-1], dim=1)
    idx = torch.arange(1, griding_num + 1, dtype=prob.dtype, device=prob.device)
    loc = torch.sum(prob * idx.view(1, -1, 1, 1), dim=1)
    background = torch.argmax(flipped, dim=1) == griding_num
    return torch.where(background, torch.zeros_like(loc), loc)
