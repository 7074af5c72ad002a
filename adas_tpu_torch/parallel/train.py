"""UFLDv2 training step on one GPU (port of ``adas_tpu/parallel/train.py``).

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
updates both in place and returns the same dict.  A batch holds
``images`` (B, 3, H, W) f32, NCHW, and the integer targets under JAX's
keys: ``row_targets`` / ``col_targets`` (B, rows / cols, lanes) grid
cells, ``row_exist`` / ``col_exist`` (same shapes) in {0, 1}, and with
``use_aux`` ``seg_targets`` (B, H/8, W/8) classes in [0, lanes].
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.ufld import UFLDv2Net, UFLDv2Spec
from ..perception.object_detector import resolve_device
from ..weights import init_params


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


def make_ufld_train_state(
    spec: UFLDv2Spec,
    mesh=None,
    generator: Optional[torch.Generator] = None,
    learning_rate: float = 0.05,
    momentum: float = 0.9,
    use_aux: bool = False,
    device="cuda",
) -> Tuple[UFLDv2Net, torch.optim.SGD, dict]:
    """A seeded net on ``device`` in training mode, its optimizer and the
    state (``train.py:54``).  ``generator`` (on ``device``; default seed
    0) draws the flax-style init (``weights.init_params``).  ``mesh``
    must be None: the port trains on one GPU.

    ``torch.optim.SGD(momentum, dampening=0)`` is optax's ``sgd`` with
    momentum: optax keeps ``trace = g + momentum * trace`` (zero at the
    start) and steps ``-lr * trace``; torch keeps ``buf = momentum * buf
    + g`` (``g`` at the first step, which is the same value) and steps
    ``-lr * buf``."""
    if mesh is not None:
        raise ValueError("the port trains on one GPU: mesh must be None")
    device = resolve_device(device)
    net = UFLDv2Net(spec, use_aux=use_aux).to(device)
    init_params(net, generator=generator)
    net.train()
    optimizer = torch.optim.SGD(net.parameters(), lr=learning_rate, momentum=momentum,
                                dampening=0.0)
    return net, optimizer, {"net": net, "optimizer": optimizer}


def make_ufld_train_step(net: UFLDv2Net, optimizer: torch.optim.Optimizer, mesh=None):
    """``step(state, batch) -> (state, loss)`` (``train.py:112``): the net
    in training mode on ``batch["images"]``, :func:`ufld_loss` (with the
    seg term when the net has ``use_aux`` and the batch ``seg_targets``),
    backward, and one optimizer step, on the state that holds ``net`` and
    ``optimizer``.  The loss comes back as a detached scalar tensor."""
    if mesh is not None:
        raise ValueError("the port trains on one GPU: mesh must be None")

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
