"""Track-list bookkeeping: dedup joins, subtraction, overlap pruning.

Parity with reference ObjectTracker/byteTrack/utils.py.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from . import matching


def joint_stracks(a: List, b: List) -> List:
    """Union of two track lists, first occurrence wins per track_id."""
    seen = set()
    out = []
    for t in list(a) + list(b):
        if t.track_id not in seen:
            seen.add(t.track_id)
            out.append(t)
    return out


def sub_stracks(a: List, b: List) -> List:
    """Tracks of ``a`` whose id does not appear in ``b`` (order kept)."""
    drop = {t.track_id for t in b}
    return [t for t in a if t.track_id not in drop]


def remove_duplicate_stracks(a: List, b: List) -> Tuple[List, List]:
    """Prune cross-list pairs overlapping with IoU > 0.85, keeping the
    longer-lived track of each pair."""
    dist = matching.iou_distance(a, b)
    pairs = np.where(dist < 0.15)
    dup_a, dup_b = set(), set()
    for ia, ib in zip(*pairs):
        age_a = a[ia].frame_id - a[ia].start_frame
        age_b = b[ib].frame_id - b[ib].start_frame
        if age_a > age_b:
            dup_b.add(ib)
        else:
            dup_a.add(ia)
    return (
        [t for i, t in enumerate(a) if i not in dup_a],
        [t for i, t in enumerate(b) if i not in dup_b],
    )
