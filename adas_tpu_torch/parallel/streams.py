"""Multi-stream data-parallel inference: N video feeds, one batched step
per data row (port of ``adas_tpu/parallel/streams.py``).

A batch of streams (one frame per feed) is split over the ``data`` axis;
each data row's replica of the net runs its part on the row's device,
the rows issued in turn (``mesh.in_turn``).  Tracker and analytics state
stays on the host per stream, so data parallelism is exact.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .mesh import Mesh, in_turn
from .sharding import batch_part, shard_ufld_params


def make_sharded_stream_step(
    batched_step: Callable,
    net,
    mesh: Mesh,
    batch_ndim: int = 4,
) -> Callable:
    """Wrap a batched device step ``f(net, frames) -> outputs`` so that the
    frame batch is split over ``data`` and the net follows the TP rules
    (``streams.py:20-45``).  JAX's ``variables`` pytree is the port's
    module ``net``: it is placed on the mesh by
    ``sharding.shard_ufld_params`` (a replica per data row, the UFLD head
    split over ``model``), and ``f`` gets row ``r``'s replica.

    Returns ``step(frames)``: ``frames`` (a tensor or array of
    ``batch_ndim`` dims, on any device; the batch a multiple of the data
    rows) is cut into the rows' parts, each moved to its row's device, and
    ``f`` runs on each under ``torch.inference_mode``.  The result is the list of the rows' outputs, in stream
    order, each on its row's device, so each shard can be fetched on its
    own (a device-to-host copy moves only that shard).  ``step.replicas``
    is the placed net."""
    replicas = shard_ufld_params(net, mesh)
    devices = mesh.row_devices()

    def row(r, frames):
        with torch.inference_mode():
            return batched_step(replicas.replicas[r], frames.to(devices[r]))

    def step(frames):
        if isinstance(frames, np.ndarray):
            frames = torch.from_numpy(frames)
        if frames.dim() != batch_ndim:
            raise ValueError(f"expected a {batch_ndim}-d frame batch, got {tuple(frames.shape)}")
        return in_turn(devices, row, [batch_part(mesh, frames, r) for r in range(len(devices))])

    step.replicas = replicas
    return step
