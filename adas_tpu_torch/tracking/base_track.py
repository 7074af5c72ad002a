"""Track state machine primitives.

Behavior parity with reference ObjectTracker/byteTrack/dtypes/base_track.py:
New/Tracked/Lost/Removed lifecycle, process-global auto-increment id, and a
structured dict export for observability.
"""
from __future__ import annotations

from enum import IntEnum
from typing import Any, Dict


class TrackState(IntEnum):
    New = 0
    Tracked = 1
    Lost = 2
    Removed = 3


class BaseTrack:
    """Shared track bookkeeping: id allocation + lifecycle flags."""

    _count = 0

    def __init__(self) -> None:
        self.track_id = 0
        self.is_activated = False
        self.state = TrackState.New
        self.score = 0.0
        self.start_frame = 0
        self.frame_id = 0
        self.time_since_update = 0

    @property
    def end_frame(self) -> int:
        return self.frame_id

    @staticmethod
    def next_id() -> int:
        BaseTrack._count += 1
        return BaseTrack._count

    @staticmethod
    def reset_counter() -> None:
        BaseTrack._count = 0

    def mark_lost(self) -> None:
        self.state = TrackState.Lost

    def mark_removed(self) -> None:
        self.state = TrackState.Removed

    def get_track_message(self) -> Dict[str, Any]:
        return {
            "track_id": self.track_id,
            "count": BaseTrack._count,
            "is_activated": self.is_activated,
            "state": int(self.state),
            "score": self.score,
            "start_frame_number": self.start_frame,
            "curr_frame_number": self.frame_id,
            "time_since_update": self.time_since_update,
        }
