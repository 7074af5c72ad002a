"""Training checkpoint and resume for the UFLDv2 trainer (port of
``adas_tpu/parallel/checkpoint.py``, whose orbax store becomes
``torch.save``).

A checkpoint is a directory ``<path>/step_<8 digits>`` (JAX's layout)
holding ``state.pt``: the net's parameters and buffers (the BatchNorm
statistics) by name, the optimizer's ``state_dict`` (the momentum
buffers) and the step.  Restore copies every value into the given state's
tensors in place, so a resumed run continues as the uninterrupted one
would, to the bit.

A state sharded over a mesh (``parallel/train.py``) is saved as whole
leaves, the head's shards joined, under the unsharded net's names and
its optimizer's ``state_dict`` layout, as orbax saves a sharded array
whole: a checkpoint restores onto a mesh or without one, whichever wrote
it, with the example state's splits in place (``checkpoint.py:39-51``).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.quant import reset_int8_cache
from .sharding import MeshReplicas

_FILE = "state.pt"


def save_train_state(path: str, state: Dict[str, Any], step: int) -> str:
    """Write ``state`` (+ ``step``) under ``path/step_<n>``; returns the
    directory (``checkpoint.py:18``)."""
    path = os.path.abspath(os.path.expanduser(path))
    target = os.path.join(path, f"step_{step:08d}")
    os.makedirs(target, exist_ok=True)
    net, optimizer = state["net"], state["optimizer"]
    if isinstance(net, MeshReplicas):
        leaves = {"params": net.gather(net.whole_params),
                  "batch_stats": net.gather(net.whole_buffers),
                  "opt_state": _whole_opt_state(net, optimizer)}
    else:
        leaves = {"params": {k: v.detach() for k, v in net.named_parameters()},
                  "batch_stats": {k: v.detach() for k, v in net.named_buffers()},
                  "opt_state": optimizer.state_dict()}
    torch.save({**leaves, "step": int(step)}, os.path.join(target, _FILE))
    return target


def _whole_opt_state(net: MeshReplicas, optimizer: torch.optim.Optimizer) -> dict:
    """The sharded optimizer's state as the unsharded net's SGD would hold
    it: the momentum of each whole parameter (by its index in the net's
    order), the hyperparameters of its one group."""
    mom = net.gather(net.whole_params,
                     of=lambda t: optimizer.state.get(t, {}).get("momentum_buffer"))
    group = {k: v for k, v in optimizer.param_groups[0].items() if k != "params"}
    return {"state": {i: {"momentum_buffer": mom[k]} for i, k in enumerate(net.whole_params)
                      if k in mom},
            "param_groups": [{**group, "params": list(range(len(net.whole_params)))}]}


def latest_checkpoint(path: str) -> Optional[str]:
    """The newest ``step_*`` directory under ``path``, or None
    (``checkpoint.py:29``)."""
    path = os.path.abspath(os.path.expanduser(path))
    if not os.path.isdir(path):
        return None
    steps = sorted(
        d for d in os.listdir(path)
        if d.startswith("step_") and os.path.isdir(os.path.join(path, d))
    )
    return os.path.join(path, steps[-1]) if steps else None


def restore_train_state(target: str, example_state: Dict[str, Any]) -> Tuple[Dict[str, Any], int]:
    """Restore ``(state, step)`` into ``example_state`` (a state of
    ``make_ufld_train_state`` of the same spec, on any device or mesh):
    its tensors take the saved values in place, a sharded state's shards
    their pieces (``checkpoint.py:41``).  A name or shape that differs
    raises."""
    net, optimizer = example_state["net"], example_state["optimizer"]
    device = next(net.parameters()).device
    saved = torch.load(os.path.join(target, _FILE), map_location=device, weights_only=True)
    sharded = isinstance(net, MeshReplicas)
    if sharded:
        names = {"params": net.whole_params, "batch_stats": net.whole_buffers}
    else:
        names = {"params": [k for k, _ in net.named_parameters()],
                 "batch_stats": [k for k, _ in net.named_buffers()]}
    for coll, own in names.items():
        if set(saved[coll]) != set(own):
            raise KeyError(f"{target}: {coll} do not match the net: "
                           f"{sorted(set(saved[coll]) ^ set(own))[:8]}")
    if sharded:
        net.scatter({**saved["params"], **saved["batch_stats"]})
        _scatter_opt_state(net, optimizer, saved["opt_state"])
        return example_state, int(saved["step"])
    with torch.no_grad():
        own = {**dict(net.named_parameters()), **dict(net.named_buffers())}
        for coll in names:
            for k, v in saved[coll].items():
                own[k].copy_(v)
    optimizer.load_state_dict(saved["opt_state"])
    reset_int8_cache(net)
    return example_state, int(saved["step"])


def _scatter_opt_state(net: MeshReplicas, optimizer: torch.optim.Optimizer, saved: dict) -> None:
    """An unsharded SGD ``state_dict`` into the sharded optimizer: each
    whole momentum buffer cut as its parameter is, into every copy's
    state; the group's hyperparameters."""
    groups = saved["param_groups"]
    if len(groups) != 1 or len(groups[0]["params"]) != len(net.whole_params):
        raise KeyError("the saved optimizer state does not match the net's parameters")
    hyper = {k: v for k, v in groups[0].items() if k != "params"}
    for g in optimizer.param_groups:
        g.update(hyper)
    optimizer.state.clear()

    def put(t: torch.Tensor, piece: torch.Tensor) -> None:
        optimizer.state[t]["momentum_buffer"] = piece.to(t.device, copy=True).contiguous()

    net.scatter({net.whole_params[int(i)]: s["momentum_buffer"]
                 for i, s in saved["state"].items() if s.get("momentum_buffer") is not None},
                put=put)
