"""The UFLDv2 training step, on one device or sharded over a (data, model)
mesh (port of ``adas_tpu/parallel/train.py``).

The UFLD row/column-anchor classification loss (cross-entropy over the
grid cells and the existence logits, plus the aux segmentation term when
the net has ``use_aux``), SGD with momentum, and a step that trains the
net in place.  The net trains in its training mode (``module.train()``,
JAX's ``train=True``): the ResNet stem runs as plain ops, not the stem
kernel, and every BatchNorm takes flax's batch statistics
(``models/layers.BatchNorm2d``); JAX serves none of its Pallas kernels
while training either, and none of them has a backward rule.  Training
reaches no kernel of ``csrc/``.

The convolutions run in the precision torch's backend flags give them: on
a GPU cuDNN takes TF32 while ``torch.backends.cudnn.allow_tf32`` is set
(torch's default); clear it for f32 convolutions.

The state is ``{"net": UFLDv2Net, "optimizer": torch.optim.SGD}``; the step
updates both in place and returns the same dict.  On a mesh the net is a
``parallel/sharding.MeshReplicas``: one replica per data row, the MLP
head split over ``model`` (``cls_fc1`` by columns, ``cls_fc2`` by rows),
and one optimizer over every replica's and shard's parameters, so the
momentum follows the shards.  The sharded step is the unsharded step
over the whole (global) batch, as JAX's GSPMD step is: each row's replica
runs its part of the batch on its own thread; every BatchNorm takes the
whole batch's statistics (the rows' ``sum x``, ``sum x^2`` and counts
summed across the rows in one autograd node, :class:`_SumAcrossRows`,
whose backward sums too: the running statistics come out the same in
every replica); the loss is the whole batch's mean; after the backward
each replicated parameter's gradients are summed across the rows, each
head shard's across the rows of its model column
(``MeshReplicas.reduce_gradients``), and one SGD step updates every copy
alike.  A batch holds
``images`` (B, 3, H, W) f32, NCHW, and the integer targets under JAX's
keys: ``row_targets`` / ``col_targets`` (B, rows / cols, lanes) grid
cells, ``row_exist`` / ``col_exist`` (same shapes) in {0, 1}, and with
``use_aux`` ``seg_targets`` (B, H/8, W/8) classes in [0, lanes].
"""
from __future__ import annotations

import functools
import threading
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..models.layers import batch_stats_across
from ..models.ufld import UFLDv2Net, UFLDv2Spec
from ..perception.object_detector import resolve_device
from ..weights import init_params
from .mesh import Mesh, RowThreads, sum_to
from .sharding import MeshReplicas, batch_part, shard_ufld_params


def ufld_loss(outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
              aux_weight: float = 1.0) -> torch.Tensor:
    """The UFLD loss (``train.py:32-51``): the mean cross-entropy of each
    head over its class dim 1 (``_xent``: minus the mean of the picked
    log-softmax), summed, plus ``aux_weight`` times the seg head's when
    the outputs hold ``seg_out`` and the batch ``seg_targets``."""
    loss = F.cross_entropy(outputs["loc_row"], batch["row_targets"].long())
    loss = loss + F.cross_entropy(outputs["loc_col"], batch["col_targets"].long())
    loss = loss + F.cross_entropy(outputs["exist_row"], batch["row_exist"].long())
    loss = loss + F.cross_entropy(outputs["exist_col"], batch["col_exist"].long())
    if "seg_out" in outputs and "seg_targets" in batch:
        loss = loss + aux_weight * F.cross_entropy(outputs["seg_out"],
                                                   batch["seg_targets"].long())
    return loss


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, Mesh):
        raise ValueError(f"mesh must be an adas_tpu_torch.parallel.Mesh (make_mesh), got "
                         f"{type(mesh).__name__}")


def make_ufld_train_state(
    spec: UFLDv2Spec,
    mesh: Optional[Mesh] = None,
    generator: Optional[torch.Generator] = None,
    learning_rate: float = 0.05,
    momentum: float = 0.9,
    use_aux: bool = False,
    device="cuda",
):
    """A seeded net in training mode, its optimizer and the state
    (``train.py:54``).  ``generator`` (on the net's device; default seed 0)
    draws the flax-style init (``weights.init_params``).  Without a mesh
    the net is built on ``device``; on a ``mesh`` it is built on the
    mesh's first device (``device`` is not used) and placed on the mesh
    by ``sharding.shard_ufld_params``: the same init, replicated, with the
    head split over ``model`` (``train.py:62-85``).

    ``torch.optim.SGD(momentum, dampening=0)`` is optax's ``sgd`` with
    momentum: optax keeps ``trace = g + momentum * trace`` (zero at the
    start) and steps ``-lr * trace``; torch keeps ``buf = momentum * buf
    + g`` (``g`` at the first step, which is the same value) and steps
    ``-lr * buf``."""
    _check_mesh(mesh)
    device = resolve_device(device) if mesh is None else mesh.devices[0, 0]
    net = UFLDv2Net(spec, use_aux=use_aux).to(device)
    init_params(net, generator=generator)
    if mesh is not None:
        net = shard_ufld_params(net, mesh)
    net.train()
    optimizer = torch.optim.SGD(net.parameters(), lr=learning_rate, momentum=momentum,
                                dampening=0.0)
    return net, optimizer, {"net": net, "optimizer": optimizer}


class _SumAcrossRows(torch.autograd.Function):
    """Per-row tensors in, their sum out on each row's device (copies and
    adds in row order, ``mesh.sum_to``); the backward sums the rows'
    gradients the same way."""

    @staticmethod
    def forward(ctx, *parts):
        ctx.devices = [p.device for p in parts]
        total = sum_to(parts, parts[0].device)
        return tuple(total.to(d, copy=True) for d in ctx.devices)

    @staticmethod
    def backward(ctx, *grads):
        total = sum_to([g for g in grads if g is not None], ctx.devices[0])
        return tuple(total.to(d, copy=True) for d in ctx.devices)


class _RowSum:
    """The rows' rendezvous for one sum across them at a time: each row
    thread hands its part and gets the sum back; the last to arrive builds
    the one :class:`_SumAcrossRows` node.  A row that fails aborts the
    rendezvous, so the others raise instead of waiting."""

    def __init__(self, n: int):
        self._barrier = threading.Barrier(n)
        self._parts = [None] * n
        self._out = None

    def __call__(self, r: int, part: torch.Tensor, count: int):
        self._parts[r] = (part, count)
        if self._barrier.wait() == 0:
            self._out = (_SumAcrossRows.apply(*[p for p, _ in self._parts]),
                         sum(c for _, c in self._parts))
        self._barrier.wait()
        sums, total = self._out
        return sums[r], total

    def abort(self) -> None:
        self._barrier.abort()


def make_ufld_train_step(net, optimizer: torch.optim.Optimizer, mesh: Optional[Mesh] = None,
                         state: Optional[dict] = None):
    """``step(state, batch) -> (state, loss)`` (``train.py:112``): the net
    in training mode on ``batch["images"]``, :func:`ufld_loss` (with the
    seg term when the net has ``use_aux`` and the batch ``seg_targets``),
    backward, and one optimizer step, on the state that holds ``net`` and
    ``optimizer``.  The loss comes back as a detached scalar tensor.

    With a ``mesh``, ``net`` is the ``MeshReplicas`` of
    :func:`make_ufld_train_state` on that mesh, and the batch (on any
    device; its size a multiple of the data rows) is split over ``data``:
    the step of the module doc.  ``state`` (JAX's ``state_example``) must
    be the state of ``net`` and ``optimizer`` when given."""
    _check_mesh(mesh)
    if state is not None and (state["net"] is not net or state["optimizer"] is not optimizer):
        raise ValueError("state must hold the net and optimizer the step is made for")
    if mesh is not None:
        if not isinstance(net, MeshReplicas) or net.mesh != mesh:
            raise ValueError("a sharded step trains the MeshReplicas of make_ufld_train_state "
                             "on the same mesh")
        return _sharded_step(net, optimizer, mesh)
    if isinstance(net, MeshReplicas):
        raise ValueError("a net placed on a mesh trains with its mesh")

    def step(state: dict, batch: Dict[str, torch.Tensor]):
        if state["net"] is not net or state["optimizer"] is not optimizer:
            raise ValueError("this step trains the state of the net and optimizer it was made for")
        net.train()
        loss = ufld_loss(net(batch["images"]), batch)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return state, loss.detach()

    return step


def _sharded_step(net: MeshReplicas, optimizer: torch.optim.Optimizer, mesh: Mesh):
    devices = mesh.row_devices()
    rows = RowThreads(devices, name="adas-train-row")
    n = len(devices)

    def step(state: dict, batch: Dict[str, torch.Tensor]):
        if state["net"] is not net or state["optimizer"] is not optimizer:
            raise ValueError("this step trains the state of the net and optimizer it was made for")
        parts = [{k: batch_part(mesh, v, r).to(devices[r]) for k, v in batch.items()}
                 for r in range(n)]
        stats = _RowSum(n)
        net.train()

        def row(r, part):
            try:
                with batch_stats_across(functools.partial(stats, r)):
                    outs = net.replicas[r](part["images"])
                # the whole batch's mean: each row's mean over its equal share
                return ufld_loss(outs, part) / n
            except BaseException:
                stats.abort()
                raise

        loss = sum_to(rows.run(row, parts), devices[0])
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        net.reduce_gradients()
        optimizer.step()
        return state, loss.detach()

    return step
