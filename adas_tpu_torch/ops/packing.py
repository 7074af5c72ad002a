"""Output packing: a tick's per-stream results in ONE tensor, so the host
pays one device→host copy per tick (port of ``adas_tpu/ops/packing.py``).

``pack`` flattens each leaf of a (possibly nested) tuple/dict tree to
f32 along the stream dimension and concatenates; ``unpack`` restores one
stream's tree on the host.  Dict leaves go in sorted key order, as JAX's
tree flattening orders them.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch


def _flatten(tree: Any, leaves: List[torch.Tensor]):
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", keys, [_flatten(tree[k], leaves) for k in keys])
    if isinstance(tree, tuple):
        return ("tuple", None, [_flatten(t, leaves) for t in tree])
    leaves.append(tree)
    return ("leaf", None, None)


def pack(tree: Any) -> Tuple[torch.Tensor, Any]:
    """Tree of (B, ...) tensors -> ((B, total) f32 tensor, spec)."""
    leaves: List[torch.Tensor] = []
    structure = _flatten(tree, leaves)
    shapes = [(tuple(l.shape[1:]), l.dtype) for l in leaves]
    flat = torch.cat([l.float().reshape(l.shape[0], -1) for l in leaves], dim=1)
    return flat, (structure, shapes)


_NP_DTYPES = {torch.bool: np.bool_, torch.float32: np.float32, torch.int64: np.int64}


def unpack(flat: np.ndarray, spec: Any) -> Any:
    """One stream's fetched (total,) vector -> the original tree (numpy)."""
    structure, shapes = spec
    flat = np.asarray(flat)
    leaves = []
    off = 0
    for shape, dtype in shapes:
        n = int(np.prod(shape)) if shape else 1
        leaves.append(flat[off: off + n].reshape(shape).astype(_NP_DTYPES[dtype]))
        off += n
    it = iter(leaves)

    def build(node):
        kind, keys, children = node
        if kind == "leaf":
            return next(it)
        vals = [build(c) for c in children]
        return dict(zip(keys, vals)) if kind == "dict" else tuple(vals)

    return build(structure)
