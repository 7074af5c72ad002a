"""The port's own copies of the value types and the bounded history
container (``adas_tpu/utils/types.py``, ``adas_tpu/utils/limited.py``)."""
from .limited import LimitedList
from .types import (
    LANE_COLORS,
    LANE_KEYS,
    CollisionType,
    CurvatureType,
    LaneInfo,
    LaneModelType,
    ObjectModelType,
    OffsetType,
    RectInfo,
    hex_to_rgb,
)

__all__ = [
    "LimitedList",
    "LANE_COLORS",
    "LANE_KEYS",
    "CollisionType",
    "CurvatureType",
    "LaneInfo",
    "LaneModelType",
    "ObjectModelType",
    "OffsetType",
    "RectInfo",
    "hex_to_rgb",
]
