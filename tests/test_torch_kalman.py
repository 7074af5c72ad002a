"""The port's batched Kalman filter ops (``adas_tpu_torch/ops/kalman.py``)
against the JAX package's (``adas_tpu/ops/kalman_jax.py``) and the port's
host tracker filter (``adas_tpu_torch/tracking/kalman.py``), f32 on the
CPU, on tracks seeded with numpy as ``tests/test_tracking.py:340`` seeds
them, with that test's tolerances (initiate rtol 1e-6; predict rtol 1e-5,
atol 1e-6; update means rtol = atol = 1e-4, covariances rtol 1e-3, atol
1e-4; gating rtol 1e-3, atol 1e-4).  Then the batched predict in place of
the host tracker's own (``BYTETracker.update(predicted=)``), as
``tests/test_multistream.py:119-150`` feeds JAX's: the same tracks."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adas_tpu.ops import kalman_jax as kj
from adas_tpu_torch.ops import kalman as kt
from adas_tpu_torch.tracking import BYTETracker
from adas_tpu_torch.tracking.kalman import KalmanFilter
from adas_tpu_torch.tracking.strack import STrack


def tracks(seed=0, n=6):
    rng = np.random.default_rng(seed)
    zs = np.stack([np.array([rng.uniform(0, 100), rng.uniform(0, 100),
                             rng.uniform(0.3, 2.0), rng.uniform(10, 80)]) for _ in range(n)])
    return zs, zs + rng.normal(0, 1, zs.shape)


def f32(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_ops_match_jax_and_the_host_filter(seed):
    zs, z2 = tracks(seed)
    kf = KalmanFilter()
    means_np, covs_np = map(np.stack, zip(*[kf.initiate(z) for z in zs]))
    means_t, covs_t = kt.initiate(f32(zs))
    means_j, covs_j = kj.initiate(jnp.asarray(zs, jnp.float32))
    assert means_t.dtype == covs_t.dtype == torch.float32
    for want in (means_np, np.asarray(means_j)):
        np.testing.assert_allclose(means_t.numpy(), want, rtol=1e-6)
    for want in (covs_np, np.asarray(covs_j)):
        np.testing.assert_allclose(covs_t.numpy(), want, rtol=1e-6)

    pm_np, pc_np = kf.multi_predict(means_np, covs_np)
    pm_t, pc_t = kt.predict(means_t, covs_t)
    pm_j, pc_j = jax.jit(kj.predict)(means_j, covs_j)
    for got, wants in ((pm_t, (pm_np, pm_j)), (pc_t, (pc_np, pc_j))):
        for want in wants:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)

    um_np, uc_np = kf.multi_update(pm_np, pc_np, z2)
    um_t, uc_t = kt.update(pm_t, pc_t, f32(z2))
    um_j, uc_j = jax.jit(kj.update)(pm_j, pc_j, jnp.asarray(z2, jnp.float32))
    for want in (um_np, np.asarray(um_j)):
        np.testing.assert_allclose(um_t.numpy(), want, rtol=1e-4, atol=1e-4)
    for want in (uc_np, np.asarray(uc_j)):
        np.testing.assert_allclose(uc_t.numpy(), want, rtol=1e-3, atol=1e-4)

    g_np = np.stack([kf.gating_distance(pm_np[i], pc_np[i], z2) for i in range(len(zs))])
    g_t = kt.gating_distance(pm_t, pc_t, f32(z2))
    g_j = jax.jit(kj.gating_distance)(pm_j, pc_j, jnp.asarray(z2, jnp.float32))
    assert g_t.shape == (len(zs), len(z2))
    for want in (g_np, np.asarray(g_j)):
        np.testing.assert_allclose(g_t.numpy(), want, rtol=1e-3, atol=1e-4)


def test_batched_predict_feeds_the_tracker():
    """The ops' predict of the tracker's pool (tracked and lost tracks)
    through ``update(predicted=)``: the tracks the host predict gives."""
    tracker = BYTETracker(names={"person": (0, 255, 0)})
    rng = np.random.default_rng(3)
    boxes = np.abs(rng.normal(100, 30, (6, 4)))
    boxes[:, 2:] = boxes[:, :2] + np.abs(rng.normal(40, 10, (6, 2)))
    frame = np.zeros((240, 320, 3), np.uint8)
    tracker.update(boxes, np.full(6, 0.9), np.zeros(6, int), frame)
    tracker.update(boxes + 2, np.full(6, 0.9), np.zeros(6, int), frame)
    tracker.update(boxes[:4] + 4, np.full(4, 0.9), np.zeros(4, int), frame)
    pool = tracker.predict_pool()
    assert len(pool) >= 4 and tracker.lost_stracks

    means, covs = STrack.gather_state(pool)
    pm, pc = kt.predict(f32(means), f32(covs))
    host, dev = copy.deepcopy(tracker), copy.deepcopy(tracker)
    dets = boxes[:4] + 6
    host.update(dets, np.full(4, 0.9), np.zeros(4, int), frame)
    dev.update(dets, np.full(4, 0.9), np.zeros(4, int), frame,
               predicted=(pm.numpy(), pc.numpy()))
    assert len(host.tracked_stracks) == len(dev.tracked_stracks) == 4
    assert len(host.lost_stracks) == len(dev.lost_stracks)
    for a, b in zip(host.tracked_stracks, dev.tracked_stracks):
        assert a.track_id == b.track_id
        np.testing.assert_allclose(a.mean, b.mean, atol=1e-3)
