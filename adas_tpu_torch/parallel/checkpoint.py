"""Training checkpoint and resume for the UFLDv2 trainer (port of
``adas_tpu/parallel/checkpoint.py``, whose orbax store becomes
``torch.save``).

A checkpoint is a directory ``<path>/step_<8 digits>`` (JAX's layout)
holding ``state.pt``: the net's parameters and buffers (the BatchNorm
statistics) by name, the optimizer's ``state_dict`` (the momentum
buffers) and the step.  Restore copies every value into the given state's
tensors in place, so a resumed run continues as the uninterrupted one
would, to the bit.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.quant import reset_int8_cache

_FILE = "state.pt"


def save_train_state(path: str, state: Dict[str, Any], step: int) -> str:
    """Write ``state`` (+ ``step``) under ``path/step_<n>``; returns the
    directory (``checkpoint.py:18``)."""
    path = os.path.abspath(os.path.expanduser(path))
    target = os.path.join(path, f"step_{step:08d}")
    os.makedirs(target, exist_ok=True)
    net = state["net"]
    torch.save({
        "params": {k: v.detach() for k, v in net.named_parameters()},
        "batch_stats": {k: v.detach() for k, v in net.named_buffers()},
        "opt_state": state["optimizer"].state_dict(),
        "step": int(step),
    }, os.path.join(target, _FILE))
    return target


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
    ``make_ufld_train_state`` of the same spec, on any device): its
    tensors take the saved values in place (``checkpoint.py:41``).  A
    name or shape that differs raises."""
    net, optimizer = example_state["net"], example_state["optimizer"]
    device = next(net.parameters()).device
    saved = torch.load(os.path.join(target, _FILE), map_location=device, weights_only=True)
    with torch.no_grad():
        for coll, own in (("params", dict(net.named_parameters())),
                          ("batch_stats", dict(net.named_buffers()))):
            if set(saved[coll]) != set(own):
                raise KeyError(f"{target}: {coll} do not match the net: "
                               f"{sorted(set(saved[coll]) ^ set(own))[:8]}")
            for k, v in saved[coll].items():
                own[k].copy_(v)
    optimizer.load_state_dict(saved["opt_state"])
    reset_int8_cache(net)
    return example_state, int(saved["step"])
