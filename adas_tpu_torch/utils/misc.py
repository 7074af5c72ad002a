"""Small shared helpers (the port's copy of ``adas_tpu/utils/misc.py``)."""
from __future__ import annotations


def _norm_frame_hws(frame_hw):
    """Normalize an export geometry argument: one ``(h, w)`` or a list of
    them (a multi-geometry fused artifact, one graph per source shape)."""
    if len(frame_hw) and not hasattr(frame_hw[0], "__len__"):
        return [(int(frame_hw[0]), int(frame_hw[1]))]
    return [(int(h), int(w)) for h, w in frame_hw]
