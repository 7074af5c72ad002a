"""Port's decode, NMS, lane decode and packing against the JAX ops.

Random raw YOLOv8 outputs with well-separated scores and clusters of
overlapping boxes go through ``decode_predictions`` + ``select_and_nms``
+ ``detections_to_original`` on both sides (the port batches the streams,
JAX runs one frame at a time); random UFLDv2 logits through
``ufld_v2_decode`` (argmax at the grid edges included).  f32; boxes at
atol 1e-3 px, probabilities at 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adas_tpu.ops.preprocess import LetterboxGeometry as JaxGeometry
from adas_tpu.ops.ufld_decode import ufld_v2_decode as jax_ufld_decode
from adas_tpu.ops.yolo_decode import decode_predictions as jax_decode
from adas_tpu.ops.yolo_decode import detections_to_original as jax_to_original
from adas_tpu.ops.yolo_decode import select_and_nms as jax_select_and_nms
from adas_tpu.utils.types import ObjectModelType
from adas_tpu_torch.ops.packing import pack, unpack
from adas_tpu_torch.ops.preprocess import LetterboxGeometry
from adas_tpu_torch.ops.ufld_decode import ufld_v2_decode
from adas_tpu_torch.ops.yolo_decode import (
    decode_predictions,
    detections_to_original,
    select_and_nms,
)


def _raw(b, n, nc, seed):
    """(B, 4+nc, N) v8 raw output: boxes in clusters of near-duplicates
    (so NMS suppresses), distinct class probabilities."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 640, (b, 4, n // 8)).repeat(8, axis=2)
    xywh = centers + rng.normal(0, 6, (b, 4, n))
    xywh[:, 2:] = np.abs(xywh[:, 2:]) * 0.2 + 8
    probs = rng.permutation(b * n * nc).reshape(b, nc, n) / (b * n * nc)
    return np.concatenate([xywh, probs], axis=1).astype(np.float32)


@pytest.mark.parametrize("box_score,max_det", [(0.5, 100), (0.05, 100), (0.9, 20)])
def test_decode_and_nms_match_jax(box_score, max_det):
    raw = _raw(3, 1024, 6, seed=int(box_score * 100))
    geom = LetterboxGeometry(720, 1280, 640, 640)
    jgeom = JaxGeometry(720, 1280, 640, 640)
    boxes, scores, ids = decode_predictions(torch.from_numpy(raw))
    got = detections_to_original(
        select_and_nms(boxes, scores, ids, box_score, 0.45, max_det), geom
    ).numpy()
    assert got.shape == (3, max_det, 6)
    kept = 0
    for i in range(3):
        jb, js, ji = jax_decode(jnp.asarray(raw[i]), ObjectModelType.YOLOV8, 6)
        want = np.asarray(jax_to_original(
            jax_select_and_nms(jb, js, ji, box_score=box_score, iou_threshold=0.45,
                               max_det=max_det), jgeom,
        ))
        np.testing.assert_array_equal(got[i, :, 5], want[:, 5])
        np.testing.assert_allclose(got[i, :, 4], want[:, 4], atol=1e-6)
        np.testing.assert_allclose(got[i, :, :4], want[:, :4], atol=1e-3)
        kept += int((want[:, 4] > 0).sum())
    assert kept > 0


def test_ufld_decode_matches_jax():
    rng = np.random.default_rng(4)
    outs = {
        "loc_row": rng.standard_normal((2, 20, 72, 4)),
        "loc_col": rng.standard_normal((2, 10, 16, 4)),
        "exist_row": rng.standard_normal((2, 2, 72, 4)),
        "exist_col": rng.standard_normal((2, 2, 16, 4)),
    }
    # force argmax onto both grid edges for some anchors
    outs["loc_row"][:, 0, :10] += 10.0
    outs["loc_row"][:, -1, 10:20] += 10.0
    outs = {k: v.astype(np.float32) for k, v in outs.items()}
    got = ufld_v2_decode({k: torch.from_numpy(v) for k, v in outs.items()})
    want = jax_ufld_decode({k: jnp.asarray(v) for k, v in outs.items()})
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6)


def test_pack_roundtrip_one_row_per_stream():
    dets = torch.arange(2 * 5 * 6, dtype=torch.float32).reshape(2, 5, 6)
    lanes = {"row_x": torch.rand(2, 3, 4), "row_valid": torch.rand(2, 3, 4) > 0.5}
    flat, spec = pack((dets, lanes))
    assert flat.shape == (2, 5 * 6 + 2 * 12) and flat.dtype == torch.float32
    for i in range(2):
        d, ln = unpack(flat[i].numpy(), spec)
        np.testing.assert_array_equal(d, dets[i].numpy())
        assert ln["row_valid"].dtype == np.bool_
        np.testing.assert_array_equal(ln["row_valid"], lanes["row_valid"][i].numpy())
        np.testing.assert_array_equal(ln["row_x"], lanes["row_x"][i].numpy())
