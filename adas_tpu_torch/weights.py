"""Weights for the port's nets: the flax variable tree as a state dict, and
the port's own seeded initialization.

The portable checkpoint of the JAX package is the flat ``::``-keyed numpy
dict of ``adas_tpu/tools/params_io.py:17-36`` (``flatten_variables``;
what ``save_params`` writes to ``.npz``).  The port's modules carry the
flax names (``net::stage1::m0::cv1::conv`` is ``net.stage1.m0.cv1.conv``),
so the mapping is by path plus a layout change per leaf:

* conv ``kernel`` HWIO -> ``weight`` OIHW; Dense ``kernel`` (in, out) ->
  Linear ``weight`` (out, in); ``bias`` -> ``bias``;
* BatchNorm / LayerNorm ``scale`` -> ``weight``, ``bias`` -> ``bias``,
  ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``.

The seeded init mirrors flax's initializers, so random-weight nets behave
as the JAX ones do (real detection counts on random frames): conv and
dense kernels are ``lecun_normal`` — a normal truncated to ±2 sigma with
fan-in variance — biases zero, norms scale one and bias zero, BatchNorm
statistics mean 0 and var 1.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_SEP = "::"
# std of a unit normal truncated to [-2, 2] (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978
_LEAF_NAMES = {
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def state_dict_from_flax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat ``::``-keyed flax variables -> torch state dict (CPU, f32 or
    the leaf's own dtype).  Collections other than ``params`` and
    ``batch_stats`` (the int8 ``act_scales``/``wscales``) raise: this port
    serves f32 and bf16 only."""
    out = {}
    for key, value in flat.items():
        coll, *path, leaf = key.split(_SEP)
        arr = np.asarray(value)
        if (coll, leaf) == ("params", "kernel"):
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif arr.ndim == 2:
                arr = arr.T  # (in, out) -> (out, in)
            else:
                raise ValueError(f"{key}: unexpected kernel rank {arr.ndim}")
            name = "weight"
        elif (coll, leaf) in _LEAF_NAMES:
            name = _LEAF_NAMES[(coll, leaf)]
        else:
            raise KeyError(f"{key}: no counterpart in the port (f32/bf16 trees only)")
        out[".".join(path + [name])] = torch.from_numpy(np.array(arr, order="C"))
    return out


def load_flax_variables(module: nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Load a flat flax variable dict into ``module`` (in place, keeping
    the module's device and dtype).  Every parameter and statistic must be
    covered, with the same shape; a missing or extra key raises."""
    sd = state_dict_from_flax(flat)
    own = {
        k: v for k, v in module.state_dict().items()
        if not k.endswith("num_batches_tracked")
    }
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"flax tree does not match the module: missing {missing[:8]}, extra {extra[:8]}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: flax shape {tuple(v.shape)} != module {tuple(own[k].shape)}")
    module.load_state_dict(sd, strict=False)


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """A ``params_io.save_params`` archive as the flat dict."""
    with np.load(path) as archive:
        return {k: archive[k] for k in archive.files}


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, mean=0.0, std=std, a=-2 * std, b=2 * std, generator=gen)


@torch.no_grad()
def init_params(module: nn.Module, seed: int = 0) -> None:
    """Seeded flax-style init of every Conv2d / Linear / norm in
    ``module``, in module order, on the module's own device.  The numbers
    come from that device's generator: one seed gives other weights on the
    CPU than on a GPU."""
    dev = next(module.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
            _lecun_normal_(m.weight, fan_in, gen)
        elif isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, m.in_features, gen)
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()
            continue
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
