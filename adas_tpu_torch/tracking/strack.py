"""Single-track state: Kalman state + score/class history + trajectory ring.

Behavior parity with reference ObjectTracker/byteTrack/dtypes/strack.py:
class-id majority vote, 30-entry trajectory ring, crop capture on
activation, and the zero-vh trick for non-tracked states before predict.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..utils.limited import LimitedList
from .base_track import BaseTrack, TrackState
from .kalman import KalmanFilter


class STrack(BaseTrack):
    shared_kalman = KalmanFilter()

    def __init__(self, tlwh: Sequence[float], score: float, class_id) -> None:
        super().__init__()
        self._tlwh = np.asarray(tlwh, dtype=np.float64)
        self.kalman_filter: Optional[KalmanFilter] = None
        self.mean: Optional[np.ndarray] = None
        self.covariance: Optional[np.ndarray] = None
        self.crops: List[np.ndarray] = []
        self.score = score
        self.tracklet_len = 0
        self.class_id = class_id
        self.class_id_history = {class_id: 1}
        self.trajectories = LimitedList(30)

    # ---- lifecycle ----

    def predict(self) -> None:
        mean_state = self.mean.copy()
        if self.state != TrackState.Tracked:
            mean_state[7] = 0
        self.mean, self.covariance = self.kalman_filter.predict(
            mean_state, self.covariance
        )

    @staticmethod
    def multi_predict(stracks: List["STrack"]) -> None:
        """One batched KF predict across every live track."""
        if not stracks:
            return
        means, covs = STrack.gather_state(stracks)
        means, covs = STrack.shared_kalman.multi_predict(means, covs)
        STrack.apply_predictions(stracks, means, covs)

    @staticmethod
    def gather_state(stracks: List["STrack"]):
        """(N, 8) means / (N, 8, 8) covariances ready for a KF predict —
        the zero-vh trick for non-Tracked states already applied, so a
        batched predict on these tensors is
        exactly the host ``multi_predict`` arithmetic."""
        means = np.stack([st.mean for st in stracks])
        covs = np.stack([st.covariance for st in stracks])
        for i, st in enumerate(stracks):
            if st.state != TrackState.Tracked:
                means[i, 7] = 0
        return means, covs

    @staticmethod
    def apply_predictions(stracks, means, covs) -> None:
        """Write externally-computed KF predictions back onto the tracks
        (counterpart of ``gather_state`` for the device-KF path)."""
        for st, m, c in zip(stracks, means, covs):
            st.mean = np.asarray(m, dtype=np.float64)
            st.covariance = np.asarray(c, dtype=np.float64)

    def activate(self, kalman_filter: KalmanFilter, frame_id: int) -> None:
        self.kalman_filter = kalman_filter
        self.track_id = self.next_id()
        self.mean, self.covariance = self.kalman_filter.initiate(
            self.tlwh_to_xyah(self._tlwh)
        )
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        if frame_id == 1:
            self.is_activated = True
        self.frame_id = frame_id
        self.start_frame = frame_id

    def re_activate(
        self, new_track: "STrack", frame_id: int, new_id: bool = False
    ) -> None:
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self.tlwh_to_xyah(new_track.tlwh)
        )
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = True
        self.frame_id = frame_id
        if new_id:
            self.track_id = self.next_id()
        self.score = new_track.score
        self.update_class_id(new_track.class_id)

    def update(self, new_track: "STrack", frame_id: int) -> None:
        self.frame_id = frame_id
        self.tracklet_len += 1
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self.tlwh_to_xyah(new_track.tlwh)
        )
        self.trajectories.append(new_track.tlbr)
        self.state = TrackState.Tracked
        self.is_activated = True
        self.score = new_track.score
        self.update_class_id(new_track.class_id)

    def update_class_id(self, class_id) -> None:
        """Majority vote over the observed class-id history."""
        self.class_id_history[class_id] = (
            self.class_id_history.get(class_id, 1) + 1
        )
        self.class_id = max(
            self.class_id_history, key=self.class_id_history.get
        )

    def update_crops(self, frame: np.ndarray) -> None:
        tx1, ty1, tw, th = self._tlwh.astype(int)
        x1, y1 = max(0, tx1), max(0, ty1)
        x2 = min(frame.shape[1], tx1 + tw)
        y2 = min(frame.shape[0], ty1 + th)
        self.crops.append(frame[y1:y2, x1:x2, :].copy())

    def filter_trajectories(
        self, frame: np.ndarray, pad: tuple = (0, 0)
    ) -> list:
        """Keep only trajectory boxes fully inside the padded frame."""
        padh, padw = pad
        return [
            b
            for b in list(self.trajectories)
            if b[0] >= padw
            and b[1] >= padh
            and b[2] <= frame.shape[1] - padw
            and b[3] <= frame.shape[0] - padh
        ]

    # ---- geometry ----

    @property
    def tlwh(self) -> np.ndarray:
        if self.mean is None:
            return self._tlwh.copy()
        ret = self.mean[:4].copy()
        ret[2] *= ret[3]
        ret[:2] -= ret[2:] / 2
        return ret

    @property
    def tlbr(self) -> np.ndarray:
        ret = self.tlwh
        ret[2:] += ret[:2]
        return ret

    @property
    def xyah(self) -> np.ndarray:
        return self.tlwh_to_xyah(self.tlwh)

    @staticmethod
    def tlwh_to_xyah(tlwh) -> np.ndarray:
        ret = np.asarray(tlwh, dtype=np.float64).copy()
        ret[:2] += ret[2:] / 2
        ret[2] /= ret[3]
        return ret

    @staticmethod
    def tlbr_to_tlwh(tlbr) -> np.ndarray:
        ret = np.asarray(tlbr, dtype=np.float64).copy()
        ret[2:] -= ret[:2]
        return ret

    @staticmethod
    def tlwh_to_tlbr(tlwh) -> np.ndarray:
        ret = np.asarray(tlwh, dtype=np.float64).copy()
        ret[2:] += ret[:2]
        return ret

    def __repr__(self) -> str:
        return f"OT_{self.track_id}_({self.start_frame}-{self.end_frame})"

    def get_track_message(self):
        msg = super().get_track_message()
        msg.update({"crops": self.crops, "class_id": self.class_id})
        return msg
