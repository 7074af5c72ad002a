"""Weights for the port's nets: the flax variable tree as a state dict, and
the port's own seeded initialization.

The portable checkpoint of the JAX package is the flat ``::``-keyed numpy
dict of ``adas_tpu/tools/params_io.py:17-36`` (``flatten_variables``;
what ``save_params`` writes to ``.npz``).  The port's modules carry the
flax names (``net::stage1::m0::cv1::conv`` is ``net.stage1.m0.cv1.conv``),
so the mapping is by path plus a layout change per leaf:

* conv ``kernel`` HWIO -> ``weight`` OIHW (a depthwise kernel (kh, kw,
  1, C) becomes (C, 1, kh, kw)); Dense ``kernel`` (in, out) -> Linear
  ``weight`` (out, in); ``bias`` -> ``bias``;
* the raw ``params`` leaves of a module, EfficientDet's BiFPN fusion
  weights (``p3_w1`` .. ``p7_w2``), YOLOv7's implicit ``ia{i}_implicit`` /
  ``im{i}_implicit`` and YOLOv6's BottleRep ``alpha`` -> the parameter of
  the same name, in the flax shape;
* a ``ConvTranspose`` kernel with ``transpose_kernel`` (kh, kw, out, in)
  -> ``ConvTranspose2d.weight`` (in, out, kh, kw): the same transpose as a
  conv kernel's;
* BatchNorm / LayerNorm ``scale`` -> ``weight``, ``bias`` -> ``bias``,
  ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``;
* the int8 collections of a calibrated, packed tree: ``act_scales``
  leaves (``xmax``, ``ymax``, ``concat_xmax``, the named groups
  ``neck_a_xmax``, ``elan4_xmax`` ..., ``out_ymax``: ``quant.QUANT_BUFFERS``) and ``wscales`` ``wscale`` keep their
  names as buffers of the module at their path; a packed s8 ``kernel``
  (``tools/quantize.py:117``) becomes ``wq`` (HWIO -> OHWI, Dense (in,
  out) -> (out, in)) and, dequantized with its ``wscale``, the f32
  ``weight``.

:func:`flax_variables` is the inverse: a module's state as the flat dict
:func:`load_flax_variables` takes (``params``, ``batch_stats`` and the
int8 collections), which ``tools/params_io.save_params`` writes as a
``.npz`` the JAX package's ``load_params`` reads.  A tree loaded and
written back comes out equal to the bit.

The seeded init mirrors flax's initializers, so random-weight nets behave
as the JAX ones do (real detection counts on random frames): conv and
dense kernels are ``lecun_normal`` — a normal truncated to ±2 sigma with
fan-in variance — biases zero, norms scale one and bias zero, BatchNorm
statistics mean 0 and var 1; the raw parameters keep what they are built
with (flax's ``ones`` / ``zeros`` initializers).
"""
from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .models.quant import QUANT_BUFFERS, reset_int8_cache
from .tools.params_io import flatten_variables, load_params
from .tools.quantize import BF16_BITS

_SEP = "::"
# std of a unit normal truncated to [-2, 2] (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978
_LEAF_NAMES = {
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}
_RAW_PARAM = re.compile(r"p[3-7]_w[12]|i[am]\d+_implicit|alpha")


def _t(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == BF16_BITS:  # a bfloat16 leaf's raw bits
        return torch.from_numpy(np.array(arr, order="C").view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, order="C"))


def state_dict_from_flax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat ``::``-keyed flax variables -> torch state dict (CPU, f32 or
    the leaf's own dtype).  A leaf with no counterpart raises."""
    out = {}
    for key, value in flat.items():
        coll, *path, leaf = key.split(_SEP)
        arr = np.asarray(value)
        prefix = ".".join(path + [""])
        if (coll, leaf) == ("params", "kernel"):
            if arr.ndim not in (2, 4):
                raise ValueError(f"{key}: unexpected kernel rank {arr.ndim}")
            if arr.dtype == np.int8:
                wkey = _SEP.join(["wscales", *path, "wscale"])
                if wkey not in flat:
                    raise KeyError(f"{key}: a packed s8 kernel needs {wkey}")
                wscale = np.asarray(flat[wkey], np.float32).reshape(-1)
                out[prefix + "wq"] = _t(arr.transpose(3, 0, 1, 2) if arr.ndim == 4 else arr.T)
                arr = arr.astype(np.float32) * wscale
            out[prefix + "weight"] = _t(arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T)
        elif (coll, leaf) in _LEAF_NAMES:
            out[prefix + _LEAF_NAMES[(coll, leaf)]] = _t(arr)
        elif coll == "params" and _RAW_PARAM.fullmatch(leaf):
            out[prefix + leaf] = _t(arr)
        elif coll in ("act_scales", "wscales") and leaf in QUANT_BUFFERS:
            out[prefix + leaf] = _t(arr.astype(np.float32))
        else:
            raise KeyError(f"{key}: no counterpart in the port")
    return out


def _int8_slots(module: nn.Module) -> Dict[str, tuple]:
    """Every int8 buffer slot of ``module`` (``quant.QUANT_BUFFERS``, set or
    not) as {state-dict key: (owner module, buffer name)}."""
    slots = {}
    for prefix, m in module.named_modules():
        for name in getattr(m, "_buffers", {}):
            if name in QUANT_BUFFERS:
                slots[f"{prefix}.{name}" if prefix else name] = (m, name)
    return slots


def load_flax_variables(module: nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Load a flat flax variable dict into ``module`` (in place, keeping
    the module's device and dtype).  Every parameter and statistic must be
    covered, with the same shape; a missing or extra key raises.  The int8
    buffers (packed kernels, weight and activation scales) are optional:
    the tree's set them, and a slot the tree lacks is cleared."""
    sd = state_dict_from_flax(flat)
    slots = _int8_slots(module)
    own = {
        k: v for k, v in module.state_dict().items()
        if not k.endswith("num_batches_tracked") and k not in slots
    }
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own) - set(slots))
    if missing or extra:
        raise KeyError(f"flax tree does not match the module: missing {missing[:8]}, extra {extra[:8]}")
    for k, v in sd.items():
        if k in own and tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: flax shape {tuple(v.shape)} != module {tuple(own[k].shape)}")
    module.load_state_dict({k: v for k, v in sd.items() if k in own}, strict=False)
    device = next(module.parameters()).device
    for key, (owner, name) in slots.items():
        setattr(owner, name, None if key not in sd else sd[key].to(device))
    reset_int8_cache(module)


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """A ``params_io.save_params`` archive as the flat dict."""
    return flatten_variables(load_params(path))


_KERNEL_MODULES = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)
_STAT_NAMES = {"running_mean": "mean", "running_var": "var"}


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # numpy has none: the raw bits, as _t reads them
        return t.view(torch.int16).numpy().view(BF16_BITS).copy()
    return t.numpy().copy()


def flax_variables(module: nn.Module) -> Dict[str, np.ndarray]:
    """``module``'s state as the flat ``::``-keyed flax dict that
    :func:`load_flax_variables` takes: the inverse of
    :func:`state_dict_from_flax`.  A conv or dense ``weight`` becomes its
    ``kernel`` (OIHW -> HWIO, (out, in) -> (in, out)); where the module
    holds packed weights, its ``kernel`` is ``wq`` (s8, as JAX's packer
    stores it) with ``wscales`` ``wscale``, and the f32 ``weight`` derived
    from them is left out; norms give ``scale``/``bias`` and
    ``batch_stats``; the activation absmaxes go under ``act_scales``.  A
    bf16 leaf comes out as its raw bits (``|V2``), as a JAX bf16 array
    lands in an ``.npz``."""
    owners = dict(module.named_modules())
    out = {}
    for key, value in module.state_dict().items():
        prefix, _, name = key.rpartition(".")
        if name == "num_batches_tracked":
            continue
        owner = owners[prefix]
        path = prefix.split(".") if prefix else []
        arr = _np(value)

        def put(coll, leaf, v=arr):
            out[_SEP.join([coll, *path, leaf])] = v

        if name == "weight" and isinstance(owner, _KERNEL_MODULES):
            if getattr(owner, "wq", None) is None:
                put("params", "kernel", arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T)
        elif name == "wq":
            put("params", "kernel", arr.transpose(1, 2, 3, 0) if arr.ndim == 4 else arr.T)
        elif name == "wscale":
            put("wscales", "wscale")
        elif name in QUANT_BUFFERS:
            put("act_scales", name)
        elif name in ("weight", "bias"):
            put("params", "scale" if name == "weight" else "bias")
        elif name in _STAT_NAMES:
            put("batch_stats", _STAT_NAMES[name])
        elif _RAW_PARAM.fullmatch(name):
            put("params", name)
        else:
            raise KeyError(f"{key}: no counterpart in the flax tree")
    return out


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, mean=0.0, std=std, a=-2 * std, b=2 * std, generator=gen)


@torch.no_grad()
def init_params(module: nn.Module, seed: int = 0, generator: Optional[torch.Generator] = None) -> None:
    """Seeded flax-style init of every Conv2d / Linear / norm in
    ``module``, in module order, on the module's own device, from
    ``generator`` (one on that device) or else a generator seeded with
    ``seed``.  The numbers come from that device's generator: one seed
    gives other weights on the CPU than on a GPU.  The tensors cached from
    the old weights are dropped."""
    dev = next(module.parameters()).device
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(seed)
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
            _lecun_normal_(m.weight, fan_in, gen)
        elif isinstance(m, nn.ConvTranspose2d):
            # flax's fan-in of a transposed kernel (kh, kw, out, in) is axis -2's
            _lecun_normal_(m.weight, m.out_channels * m.kernel_size[0] * m.kernel_size[1], gen)
        elif isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, m.in_features, gen)
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()
            continue
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
    reset_int8_cache(module)
