"""The port's batched ``_select_loop`` (``adas_tpu_torch/ops/nms.py``, its
CPU side: ``pairwise_iou`` + the plain scan, or ``iou_row`` per step)
against the JAX ``_select_loop`` run per stream, on the same boxes and
scores made with numpy from a seed.  Picked indices must be identical, for
the three methods, ``plus_one`` both ways and ``use_iou_matrix`` both ways
on both sides; also ``nms_padded``, ``soft_nms_padded`` and
``select_and_nms(hard_only=False)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adas_tpu.ops import nms as jax_nms
from adas_tpu.ops import yolo_decode as jax_decode
from adas_tpu_torch.ops import nms as port_nms
from adas_tpu_torch.ops import yolo_decode as port_decode

N_STREAMS = 3


def _inputs(n, seed):
    """(B, N, 4) xyxy boxes in clusters (many overlaps above 0.3-0.5), and
    (B, N) scores in (0, 1) with some exact ties and some zeros."""
    rng = np.random.default_rng(seed)
    cluster = rng.uniform(30, 170, (N_STREAMS, 6, 2))
    pick = rng.integers(0, 6, (N_STREAMS, n))
    centers = np.take_along_axis(cluster, pick[..., None], axis=1)
    centers = centers + rng.normal(0, 6, centers.shape)
    wh = rng.uniform(15, 50, (N_STREAMS, n, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], axis=-1).astype(np.float32)
    scores = rng.uniform(0, 1, (N_STREAMS, n)).astype(np.float32)
    scores[:, 1::9] = scores[:, 0:1]  # exact ties: the lowest index wins
    scores[:, 5::11] = 0.0
    return boxes, scores


def _jax_per_stream(fn, boxes, scores):
    """Run a single-frame JAX function over the streams with vmap."""
    return np.asarray(jax.jit(jax.vmap(fn))(jnp.asarray(boxes), jnp.asarray(scores)))


@pytest.mark.parametrize("use_iou_matrix", [True, False])
@pytest.mark.parametrize("plus_one", [True, False])
@pytest.mark.parametrize("method", [0, 1, 2])
def test_select_loop_matches_jax(method, plus_one, use_iou_matrix):
    boxes, scores = _inputs(96, seed=method + 2 * plus_one)
    args = dict(iou_threshold=0.45, max_out=60, method=method, sigma=0.5,
                score_threshold=0.001, plus_one=plus_one)
    want = _jax_per_stream(
        lambda b, s: jax_nms._select_loop(b, s, use_iou_matrix=use_iou_matrix, **args)[0],
        boxes, scores,
    )
    got = port_nms.select_loop(torch.from_numpy(boxes), torch.from_numpy(scores),
                               use_iou_matrix=use_iou_matrix, **args)
    assert got.dtype == torch.int64 and got.shape == (N_STREAMS, 60)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > N_STREAMS  # the scan selected something


@pytest.mark.parametrize("method", [0, 2])
def test_select_loop_pads_past_n(method):
    """``min(max_out, N)`` steps, then -1 padding up to ``max_out``."""
    boxes, scores = _inputs(20, seed=7)
    args = dict(iou_threshold=0.5, max_out=32, method=method, sigma=0.5,
                score_threshold=0.0, plus_one=False)
    want = _jax_per_stream(lambda b, s: jax_nms._select_loop(b, s, **args)[0], boxes, scores)
    got = port_nms.select_loop(torch.from_numpy(boxes), torch.from_numpy(scores), **args)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(want[:, 20:] == -1)


def test_nms_scan_reference_equals_select_loop():
    """The scan's plain version over the matrix is what ``select_loop``
    runs on the CPU; the wrapper counts no launch there."""
    boxes, scores = _inputs(64, seed=9)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    iou = port_nms.iou_matrix(b, plus_one=True)
    port_nms.reset_launches()
    for method in (0, 1, 2):
        got = port_nms.nms_scan(iou, s, 0.5, 40, method=method, score_threshold=0.001)
        want = port_nms.select_loop(b, s, 0.5, 40, method=method, score_threshold=0.001,
                                    plus_one=True, use_iou_matrix=False)
        assert torch.equal(got, want)
    assert port_nms.launches == 0


def test_nms_padded_matches_jax():
    boxes, scores = _inputs(80, seed=11)
    want_i = _jax_per_stream(lambda b, s: jax_nms.nms_padded(b, s, 0.5, 50)[0], boxes, scores)
    want_c = _jax_per_stream(lambda b, s: jax_nms.nms_padded(b, s, 0.5, 50)[1], boxes, scores)
    got_i, got_c = port_nms.nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, 50)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_c.numpy(), want_c)


@pytest.mark.parametrize("method", ["hard", "linear", "gaussian"])
def test_soft_nms_padded_matches_jax(method):
    boxes, scores = _inputs(80, seed=12)
    kw = dict(iou_threshold=0.3, sigma=0.5, score_threshold=0.001, max_out=70, method=method,
              plus_one=True)
    want_i = _jax_per_stream(lambda b, s: jax_nms.soft_nms_padded(b, s, **kw)[0], boxes, scores)
    want_c = _jax_per_stream(lambda b, s: jax_nms.soft_nms_padded(b, s, **kw)[1], boxes, scores)
    got_i, got_c = port_nms.soft_nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores),
                                            **kw)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_c.numpy(), want_c)


@pytest.mark.parametrize("hard_only", [True, False])
def test_select_and_nms_matches_jax(hard_only):
    """Threshold + stable top-k + NMS (gaussian when not ``hard_only``) ->
    (B, max_det, 6) rows, against JAX ``select_and_nms`` per stream."""
    rng = np.random.default_rng(13)
    boxes, scores = _inputs(700, seed=13)
    ids = rng.integers(0, 80, scores.shape)
    kw = dict(box_score=0.3, iou_threshold=0.45, max_det=100, pre_topk=512, hard_only=hard_only)
    want = np.asarray(jax.jit(jax.vmap(
        lambda b, s, c: jax_decode.select_and_nms(b, s, c, **kw)
    ))(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(ids)))
    got = port_decode.select_and_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                     torch.from_numpy(ids), **kw)
    assert got.shape == want.shape == (N_STREAMS, 100, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[..., 4] > 0).sum() > N_STREAMS


def test_select_loop_rejects_bad_arguments():
    b, s = torch.zeros(2, 8, 4), torch.zeros(2, 8)
    with pytest.raises(ValueError, match="method"):
        port_nms.select_loop(b, s, 0.5, 4, method=3)
    with pytest.raises(ValueError, match="scores"):
        port_nms.nms_scan(torch.zeros(2, 8, 7), s, 0.5, 4)


def test_ab_tool_plain_nms_equals_served_select_loop():
    """``adas_tpu_torch.tools.nms_ab`` swaps the plain versions into
    ``select_and_nms`` for its A/B: they pick the same, and the swap is
    undone on exit."""
    from adas_tpu_torch.tools import nms_ab

    boxes, scores = (torch.from_numpy(a) for a in _inputs(64, seed=21))
    for method in (0, 1, 2):
        args = (boxes, scores, 0.45, 20, method, 0.5, 0.001, True)
        torch.testing.assert_close(nms_ab.plain_select_loop(*args), port_nms.select_loop(*args),
                                   rtol=0, atol=0)
    served = port_decode.select_loop
    with nms_ab.plain_nms():
        assert port_decode.select_loop is nms_ab.plain_select_loop
    assert port_decode.select_loop is served


def _walk_inputs(n, seed, order, with_nan):
    """``_inputs`` with the scores sorted descending (as the top-k hands
    them over: ties keep index order) or left unsorted, optionally with a
    NaN score."""
    boxes, scores = _inputs(n, seed)
    if with_nan:
        scores[:, n // 2] = np.nan
    if order == "sorted":
        scores = -np.sort(-scores, axis=1, kind="stable")
    return boxes, scores


@pytest.mark.parametrize("score_threshold", [0.0, 0.001])
@pytest.mark.parametrize("order,with_nan", [("sorted", False), ("unsorted", False),
                                            ("unsorted", True), ("sorted", True)])
@pytest.mark.parametrize("n,max_out", [(96, 40), (40, 64), (1, 3)])
def test_nms_walk_reference_matches_jax(n, max_out, order, with_nan, score_threshold):
    """The walk over the packed mask picks what the JAX ``_select_loop``
    (hard) and the plain rescoring scan pick: sorted, unsorted and exactly
    tied scores, zeros, a NaN, ``max_out`` above and below N, N = 1."""
    boxes, scores = _walk_inputs(n, seed=n + max_out, order=order, with_nan=with_nan)
    args = dict(iou_threshold=0.45, max_out=max_out, method=0, sigma=0.5,
                score_threshold=score_threshold, plus_one=True)
    want = _jax_per_stream(lambda b, s: jax_nms._select_loop(b, s, **args)[0], boxes, scores)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    mask = port_nms.iou_mask(b, 0.45, plus_one=True)
    got = port_nms.nms_walk_reference(mask, s, max_out, score_threshold)
    assert got.dtype == torch.int64 and got.shape == (N_STREAMS, max_out)
    np.testing.assert_array_equal(got.numpy(), want)
    scan = port_nms.nms_scan_reference(port_nms.iou_matrix(b, plus_one=True), s, 0.45, max_out,
                                       0, 0.5, score_threshold)
    assert torch.equal(got, scan)
    # the walk picked something, except where the one box's score is NaN
    assert (want >= 0).sum() >= N_STREAMS or (n == 1 and with_nan)


def test_nms_walk_reference_stops_at_a_suppressed_inf():
    """A suppressed +inf score turns into NaN in the rescoring scan, whose
    next argmax ends the stream; the walk stops after that pick too."""
    boxes, scores = _inputs(64, seed=31)
    scores[:, 7] = np.inf
    scores[:, 20] = np.inf
    boxes[:, 20] = boxes[:, 7] + 1.0  # box 7, picked first, suppresses box 20
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    mask = port_nms.iou_mask(b, 0.5)
    got = port_nms.nms_walk_reference(mask, s, 30, 0.001)
    want = port_nms.nms_scan_reference(port_nms.iou_matrix(b), s, 0.5, 30, 0, 0.5, 0.001)
    assert torch.equal(got, want)
    assert got[:, 0].tolist() == [7] * N_STREAMS and (got[:, 1:] == -1).all()


def test_select_loop_routes_hard_to_the_walk(monkeypatch):
    """On the CPU ``select_loop`` takes the walk's plain version for hard
    suppression with ``score_threshold >= 0``, and the rescoring scan's
    for the soft methods and a negative threshold."""
    calls = []
    for name in ("nms_walk_reference", "nms_scan_reference"):
        fn = getattr(port_nms, name)
        monkeypatch.setattr(port_nms, name,
                            lambda *a, _fn=fn, _name=name: calls.append(_name) or _fn(*a))
    boxes, scores = (torch.from_numpy(a) for a in _inputs(48, seed=41))
    for method, score_threshold, route in ((0, 0.001, "nms_walk_reference"),
                                           (0, 0.0, "nms_walk_reference"),
                                           (0, -0.5, "nms_scan_reference"),
                                           (1, 0.001, "nms_scan_reference"),
                                           (2, 0.001, "nms_scan_reference")):
        calls.clear()
        got = port_nms.select_loop(boxes, scores, 0.45, 30, method=method,
                                   score_threshold=score_threshold, plus_one=True)
        assert calls == [route]
        want = port_nms.select_loop(boxes, scores, 0.45, 30, method=method,
                                    score_threshold=score_threshold, plus_one=True,
                                    use_iou_matrix=False)
        assert torch.equal(got, want)


def test_nms_walk_rejects_bad_arguments():
    s = torch.zeros(2, 40)
    mask = torch.zeros(2, 40, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="score_threshold >= 0"):
        port_nms.nms_walk(mask, s, 10, score_threshold=-0.1)
    with pytest.raises(ValueError, match="score_threshold >= 0"):
        port_nms.nms_walk_reference(mask, s, 10, score_threshold=float("nan"))
    with pytest.raises(ValueError, match=r"\(B, N, 2\) operand"):
        port_nms.nms_walk(torch.zeros(2, 40, 3, dtype=torch.int32), s, 10)
    with pytest.raises(ValueError, match="max_out"):
        port_nms.nms_walk(mask, s, 0)
