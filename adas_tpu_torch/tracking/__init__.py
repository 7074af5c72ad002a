"""L2 tracking (the port's copy of ``adas_tpu/tracking``): ByteTrack with
batched Kalman motion + exact C++ LAPJV."""
from .base_track import BaseTrack, TrackState
from .byte_tracker import BYTETracker
from .core import ObjectTrackBase
from .kalman import KalmanFilter, chi2inv95
from .strack import STrack

__all__ = [
    "BYTETracker",
    "ObjectTrackBase",
    "BaseTrack",
    "TrackState",
    "KalmanFilter",
    "STrack",
    "chi2inv95",
]
