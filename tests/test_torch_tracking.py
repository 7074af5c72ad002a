"""The port's ByteTrack copy (``adas_tpu_torch/tracking``, with its own
LAPJV build) against ``adas_tpu.tracking`` on the same detection
sequences: identical track ids, states and boxes, frame by frame."""
from __future__ import annotations

import numpy as np
import pytest

from adas_tpu.native.lapjv import lapjv as jax_pkg_lapjv
from adas_tpu.tracking import BYTETracker as RefTracker
from adas_tpu.tracking.base_track import BaseTrack as RefBaseTrack
from adas_tpu_torch.native.lapjv import lapjv as port_lapjv
from adas_tpu_torch.tracking import BYTETracker as PortTracker
from adas_tpu_torch.tracking.base_track import BaseTrack as PortBaseTrack

FRAMES = 30
FRAME_HW = (360, 640)
LABELS = ("car", "truck", "person")


def detection_sequence(seed: int):
    """Per frame (boxes xyxy, scores, labels) of objects moving at constant
    velocity with jitter: objects are born at staggered frames, vanish for
    a few frames (occlusion), sometimes come back at a low score (0.15-0.45,
    ByteTrack's second stage), and a few low-score clutter boxes appear."""
    rng = np.random.default_rng(seed)
    n_obj = 7
    birth = rng.integers(0, FRAMES // 2, n_obj)
    birth[:2] = 0
    start = rng.uniform([20, 20], [500, 260], (n_obj, 2))
    vel = rng.uniform(-6, 6, (n_obj, 2))
    size = rng.uniform([30, 30], [120, 90], (n_obj, 2))
    occluded = [set(rng.choice(FRAMES, 4, replace=False).tolist()) for _ in range(n_obj)]
    labels = rng.integers(0, len(LABELS), n_obj)
    seq = []
    for t in range(FRAMES):
        boxes, scores, names = [], [], []
        for i in range(n_obj):
            if t < birth[i] or t in occluded[i]:
                continue
            xy = start[i] + vel[i] * (t - birth[i]) + rng.normal(0, 1.5, 2)
            wh = size[i] * rng.uniform(0.95, 1.05, 2)
            boxes.append([*xy, *(xy + wh)])
            low = rng.random() < 0.15
            scores.append(rng.uniform(0.15, 0.45) if low else rng.uniform(0.62, 0.97))
            names.append(LABELS[labels[i]])
        for _ in range(rng.integers(0, 3)):
            xy = rng.uniform([0, 0], [600, 320])
            boxes.append([*xy, *(xy + rng.uniform(10, 40, 2))])
            scores.append(rng.uniform(0.05, 0.3))
            names.append(LABELS[rng.integers(0, len(LABELS))])
        seq.append((np.asarray(boxes, np.float64).reshape(-1, 4), np.asarray(scores), names))
    return seq


def run(tracker_cls, base_cls, seq):
    base_cls.reset_counter()
    tracker = tracker_cls(names={name: (0, 0, 0) for name in LABELS})
    frame = np.zeros((*FRAME_HW, 3), np.uint8)
    history = []
    for boxes, scores, names in seq:
        messages = tracker.update(boxes, scores, names, frame)
        history.append((
            [(m["track_id"], m["state"], m["is_activated"], m["start_frame_number"],
              m["curr_frame_number"]) for m in messages],
            np.array([t.tlbr for t in tracker.tracked_stracks]).reshape(-1, 4),
            sorted(t.track_id for t in tracker.lost_stracks),
            sorted(t.track_id for t in tracker.removed_stracks),
        ))
    return history


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_port_tracker_matches_jax_package(seed):
    seq = detection_sequence(seed)
    ref = run(RefTracker, RefBaseTrack, seq)
    got = run(PortTracker, PortBaseTrack, seq)
    n_ids = set()
    for t, ((rm, rb, rl, rr), (gm, gb, gl, gr)) in enumerate(zip(ref, got)):
        assert gm == rm, f"frame {t}: tracks differ"
        np.testing.assert_array_equal(gb, rb, err_msg=f"frame {t}: boxes differ")
        assert (gl, gr) == (rl, rr), f"frame {t}: lost/removed tracks differ"
        n_ids.update(m[0] for m in gm)
    # the sequence exercises births, losses and re-finds
    assert len(n_ids) >= 5 and any(h[2] for h in ref)


@pytest.mark.parametrize("shape,limit", [((6, 9), 0.8), ((9, 6), 0.5), ((7, 7), np.inf)])
def test_port_lapjv_matches_jax_package(shape, limit):
    cost = np.random.default_rng(shape[0] * 10 + shape[1]).uniform(0, 1, shape)
    want = jax_pkg_lapjv(cost, cost_limit=limit)
    got = port_lapjv(cost, cost_limit=limit)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("show_box", [False, True])
def test_draw_tracked_matches_jax(show_box):
    """``DrawTrackedOnFrame`` on the port's cv2-free renderer against the
    JAX tracker's cv2 drawing, frame by frame over a seeded sequence:
    trajectory dots (radius 0 for the first three), the shadowed ID, the
    lock-on box of a young track and the median-direction arrow of an
    older one, and with ``show_box`` the tinted box and its label."""
    pytest.importorskip("cv2")
    colors = {"car": (40, 200, 250), "truck": (5, 20, 250), "person": (250, 120, 25)}
    trackers = []
    for tracker_cls, base_cls in ((RefTracker, RefBaseTrack), (PortTracker, PortBaseTrack)):
        base_cls.reset_counter()
        trackers.append(tracker_cls(names=dict(colors)))
    background = np.random.default_rng(3).integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8)
    drawn = 0
    for boxes, scores, names in detection_sequence(4):
        frames = []
        for tracker in trackers:
            frame = background.copy()
            tracker.update(boxes, scores, names, frame)
            tracker.DrawTrackedOnFrame(frame, show_box)
            frames.append(frame)
        np.testing.assert_array_equal(frames[1], frames[0])
        drawn += int(np.any(frames[0] != background))
    assert drawn > FRAMES // 2
