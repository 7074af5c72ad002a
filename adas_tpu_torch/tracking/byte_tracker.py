"""ByteTrack two-stage tracking-by-detection.

Algorithm parity with reference ObjectTracker/byteTrack/byteTracker.py:62-216:
high-score detections associate first against tracked+lost tracks using a
score-fused IoU cost; leftover tracked tracks get a second chance against
low-score (0.1 < s < track_thresh) detections; unconfirmed tracks match at
a looser threshold; survivors of neither are lost then removed after
``buffer_size`` frames.  The KF predict runs once, batched, per frame
(tracking/kalman.py); association solves exactly via the in-repo C++ LAPJV.
``DrawTrackedOnFrame`` draws with the port's cv2-free renderer.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from . import matching
from .base_track import BaseTrack, TrackState
from .core import ObjectTrackBase
from .kalman import KalmanFilter
from .strack import STrack
from .track_utils import joint_stracks, remove_duplicate_stracks, sub_stracks


class BYTETracker(ObjectTrackBase):
    """Two-stage IoU association tracker with Kalman motion prediction.

    Args follow the reference defaults: ``track_thresh`` splits high/low
    detections and (plus 0.1) gates new-track creation; ``track_buffer``
    scaled by frame rate bounds how long lost tracks survive;
    ``match_thresh`` is the first-stage assignment cost limit.
    """

    def __init__(
        self,
        track_thresh: float = 0.5,
        track_buffer: int = 30,
        match_thresh: float = 0.8,
        frame_rate: int = 30,
        min_box_area: int = 10,
        **kwargs: Any,
    ):
        super().__init__(**kwargs)
        self.tracked_stracks: List[STrack] = []
        self.lost_stracks: List[STrack] = []
        self.removed_stracks: List[STrack] = []

        self.track_thresh = track_thresh
        self.match_thresh = match_thresh
        self.min_box_area = min_box_area

        self.frame_id = 0
        self.det_thresh = track_thresh + 0.1
        self.buffer_size = int(frame_rate / 30.0 * track_buffer)
        self.max_time_lost = self.buffer_size
        self.kalman_filter = KalmanFilter()

    def _get_tracker_messages(
        self, status: TrackState = TrackState.Tracked
    ) -> List[Dict[str, Any]]:
        pool = {
            TrackState.Lost: self.lost_stracks,
            TrackState.Removed: self.removed_stracks,
        }.get(status, self.tracked_stracks)
        return [t.get_track_message() for t in pool]

    def predict_pool(self) -> List[STrack]:
        """The exact track list whose KF predict runs inside ``update``
        (activated tracked + lost, deduped) — the device-KF path gathers
        this pool's state (``STrack.gather_state``) before the device
        step and hands the predictions back via ``update(predicted=)``."""
        confirmed = [t for t in self.tracked_stracks if t.is_activated]
        return joint_stracks(confirmed, self.lost_stracks)

    def update(
        self, bboxes, scores, class_ids, frame: np.ndarray, predicted=None
    ):
        """Advance one frame: bboxes xyxy, scores, per-box class ids.

        ``predicted``: optional ``(means, covs)`` arrays aligned with
        ``predict_pool()`` as of this call — externally (device-)computed
        KF predictions applied in place of the host ``multi_predict``."""
        self.frame_id += 1
        activated, refind, lost, removed = [], [], [], []

        bboxes = np.asarray(bboxes, dtype=np.float64).reshape(-1, 4)
        scores = np.asarray(scores, dtype=np.float64).reshape(-1)
        class_ids = np.asarray(class_ids)

        high = scores > self.track_thresh
        low = (scores > 0.1) & (scores < self.track_thresh)
        dets_high = [
            STrack(STrack.tlbr_to_tlwh(b), s, c)
            for b, s, c in zip(bboxes[high], scores[high], class_ids[high])
        ]
        dets_low = [
            STrack(STrack.tlbr_to_tlwh(b), s, c)
            for b, s, c in zip(bboxes[low], scores[low], class_ids[low])
        ]

        unconfirmed = [t for t in self.tracked_stracks if not t.is_activated]
        confirmed = [t for t in self.tracked_stracks if t.is_activated]

        # Stage 1: high-score dets vs tracked+lost, score-fused IoU cost.
        pool = joint_stracks(confirmed, self.lost_stracks)
        if predicted is not None and len(predicted[0]) == len(pool):
            STrack.apply_predictions(pool, predicted[0], predicted[1])
        else:
            STrack.multi_predict(pool)
        dists = matching.fuse_score(
            matching.iou_distance(pool, dets_high), dets_high
        )
        matches, u_track, u_det = matching.linear_assignment(
            dists, thresh=self.match_thresh
        )
        for it, idet in matches:
            track, det = pool[it], dets_high[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id, new_id=False)
                refind.append(track)

        # Stage 2: low-score dets vs still-tracked leftovers, IoU only.
        remaining = [
            pool[i] for i in u_track if pool[i].state == TrackState.Tracked
        ]
        dists = matching.iou_distance(remaining, dets_low)
        matches, u_track2, _ = matching.linear_assignment(dists, thresh=0.5)
        for it, idet in matches:
            track, det = remaining[it], dets_low[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id, new_id=False)
                refind.append(track)
        for it in u_track2:
            track = remaining[it]
            if track.state != TrackState.Lost:
                track.mark_lost()
                lost.append(track)

        # Unconfirmed tracks (first-frame tracks) vs leftover high dets.
        dets_left = [dets_high[i] for i in u_det]
        dists = matching.fuse_score(
            matching.iou_distance(unconfirmed, dets_left), dets_left
        )
        matches, u_unconfirmed, u_det = matching.linear_assignment(
            dists, thresh=0.7
        )
        for it, idet in matches:
            unconfirmed[it].update(dets_left[idet], self.frame_id)
            activated.append(unconfirmed[it])
        for it in u_unconfirmed:
            track = unconfirmed[it]
            track.mark_removed()
            removed.append(track)

        # New tracks from confident unmatched detections.
        for idet in u_det:
            det = dets_left[idet]
            if det.score < self.det_thresh:
                continue
            det.activate(self.kalman_filter, self.frame_id)
            det.update_crops(frame)
            activated.append(det)

        # Expire lost tracks past the buffer.
        for track in self.lost_stracks:
            if self.frame_id - track.end_frame > self.max_time_lost:
                track.mark_removed()
                removed.append(track)

        self.tracked_stracks = [
            t for t in self.tracked_stracks if t.state == TrackState.Tracked
        ]
        self.tracked_stracks = joint_stracks(self.tracked_stracks, activated)
        self.tracked_stracks = joint_stracks(self.tracked_stracks, refind)
        self.lost_stracks = sub_stracks(self.lost_stracks, self.tracked_stracks)
        self.lost_stracks.extend(lost)
        # Divergence from the reference (byteTracker.py:180-182): extend
        # removed_stracks BEFORE subtracting, so an expired track leaves
        # lost_stracks the frame it is removed instead of being re-expired
        # (and duplicated in removed_stracks) on the next frame.
        self.removed_stracks.extend(removed)
        self.lost_stracks = sub_stracks(self.lost_stracks, self.removed_stracks)
        self.tracked_stracks, self.lost_stracks = remove_duplicate_stracks(
            self.tracked_stracks, self.lost_stracks
        )
        return self._get_tracker_messages()

    def reset(self) -> None:
        """Clear all state (incl. the global id counter) between videos."""
        self.frame_id = 0
        self.tracked_stracks = []
        self.lost_stracks = []
        self.removed_stracks = []
        BaseTrack.reset_counter()

    def DrawTrackedOnFrame(self, frame: np.ndarray, show_box: bool = True,
                           show_traject: bool = True) -> None:
        """Draw every activated track above the area gate: its tinted box
        (``show_box``), its trajectory dots, ID and direction arrow or
        lock-on box (``show_traject``), ``byte_tracker.py:202-219``."""
        for t in self.tracked_stracks:
            if not t.is_activated:
                continue
            tlwh = t.tlwh
            if tlwh[2] * tlwh[3] <= self.min_box_area:
                continue
            if show_box:
                self.plot_bbox(frame, tlwh, t.class_id, t.track_id)
            if show_traject:
                self.plot_trajectories(frame, list(t.trajectories), t.class_id, t.track_id)
                kept = t.filter_trajectories(frame, (10, 10))
                self.plot_directions(frame, t.xyah, kept, t.class_id)
