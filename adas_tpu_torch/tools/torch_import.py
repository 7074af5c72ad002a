"""Torch checkpoint ingestion: ``.pth`` state dicts -> flax variables (the
port's copy of ``adas_tpu/tools/torch_import.py``).

The importers return the nested flax tree the JAX package's importers
return (``params`` / ``batch_stats``; conv kernels HWIO, dense kernels
(in, out)), equal to it to the bit on the same state dict; the port's
bridge, ``weights.load_flax_variables``, loads its flat form
(``params_io.flatten_variables``) into a module.  One mapping serves both
packages' archives.

CLI (the reference's pth -> onnx exporter turned pth -> ``.npz``):
    python -m adas_tpu_torch.tools.torch_import -i ckpt.pth -o w.npz --arch ufldv2
"""
from __future__ import annotations

import os
import re
from typing import Dict, Tuple

import numpy as np


def load_state_dict(path: str, allow_pickle: bool = False) -> Dict[str, np.ndarray]:
    """A torch checkpoint file as numpy arrays, ``module.`` prefixes
    stripped and a ``{"model": ...}`` wrapper unwrapped.

    Tries ``weights_only=True`` first (tensors only).  A full-module
    checkpoint (an ultralytics export) needs arbitrary unpickling, which
    runs code from the file: that is allowed only with
    ``allow_pickle=True`` or ``ADAS_TORCH_UNPICKLE=1``, for trusted files.
    """
    import torch

    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        if not (allow_pickle or os.environ.get("ADAS_TORCH_UNPICKLE") == "1"):
            raise ValueError(
                f"{path} is not a plain-tensor checkpoint; loading it "
                "requires unpickling arbitrary code. Pass "
                "allow_pickle=True (or set ADAS_TORCH_UNPICKLE=1) only "
                "if you trust the file."
            )
        blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model" in blob:
        blob = blob["model"]
    if hasattr(blob, "state_dict"):
        blob = blob.state_dict()
    out = {}
    for k, v in blob.items():
        k = k[7:] if k.startswith("module.") else k
        out[k] = v.detach().cpu().numpy()
    return out


def _conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))  # OIHW -> HWIO


def _dense(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))


def _set(tree: dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def _map_resnet_key(name: str):
    """torchvision resnet name -> (collection, path, transform)."""
    m = re.match(r"conv1\.weight$", name)
    if m:
        return "params", ("conv1", "kernel"), _conv
    m = re.match(r"bn1\.(weight|bias|running_mean|running_var)$", name)
    if m:
        return _bn_part("bn1", m.group(1))
    m = re.match(
        r"layer(\d)\.(\d+)\.conv(\d)\.weight$", name
    )
    if m:
        block = f"layer{m.group(1)}_{m.group(2)}"
        return "params", (block, f"conv{m.group(3)}", "kernel"), _conv
    m = re.match(
        r"layer(\d)\.(\d+)\.bn(\d)\.(weight|bias|running_mean|running_var)$",
        name,
    )
    if m:
        block = f"layer{m.group(1)}_{m.group(2)}"
        col, path, t = _bn_part(f"bn{m.group(3)}", m.group(4))
        return col, (block,) + path, t
    m = re.match(r"layer(\d)\.(\d+)\.downsample\.0\.weight$", name)
    if m:
        block = f"layer{m.group(1)}_{m.group(2)}"
        return "params", (block, "downsample_conv", "kernel"), _conv
    m = re.match(
        r"layer(\d)\.(\d+)\.downsample\.1\.(weight|bias|running_mean|running_var)$",
        name,
    )
    if m:
        block = f"layer{m.group(1)}_{m.group(2)}"
        col, path, t = _bn_part("downsample_bn", m.group(3))
        return col, (block,) + path, t
    return None


def _bn_part(bn_name: str, part: str):
    ident = lambda x: x
    if part == "weight":
        return "params", (bn_name, "scale"), ident
    if part == "bias":
        return "params", (bn_name, "bias"), ident
    if part == "running_mean":
        return "batch_stats", (bn_name, "mean"), ident
    return "batch_stats", (bn_name, "var"), ident


def resnet_variables(state: Dict[str, np.ndarray]) -> dict:
    """torchvision ResNet state dict -> flax variables for
    ``ResNetFeatures`` (fc.* entries ignored)."""
    variables = {"params": {}, "batch_stats": {}}
    for name, value in state.items():
        if name.startswith("fc.") or name.endswith("num_batches_tracked"):
            continue
        mapped = _map_resnet_key(name)
        if mapped is None:
            raise KeyError(f"unmapped resnet tensor: {name}")
        col, path, transform = mapped
        _set(variables[col], path, transform(np.asarray(value)))
    return variables


def ufld_variables(
    state: Dict[str, np.ndarray], version: int = 2, fc_norm: bool = True
) -> dict:
    """UFLD v1/v2 torch state dict -> flax variables for UFLDv1Net/UFLDv2Net.

    Reference naming: backbone under ``model.``, pooling conv ``pool.*``,
    classifier MLP ``cls.{i}.*`` where i skips the optional LayerNorm slot
    (model_culane.py:33-39, ultrafastLane/model.py:61-67).
    """
    variables = {"params": {}, "batch_stats": {}}
    # v2's slot 0 is the LayerNorm, or an Identity without fc_norm
    fc1_idx, fc2_idx = (1, 3) if version == 2 else (0, 2)
    for name, value in state.items():
        value = np.asarray(value)
        if name.endswith("num_batches_tracked"):
            continue
        if name.startswith("model."):
            mapped = _map_resnet_key(name[len("model.") :])
            if mapped is None:
                raise KeyError(f"unmapped backbone tensor: {name}")
            col, path, transform = mapped
            _set(variables[col], ("backbone",) + path, transform(value))
        elif name == "pool.weight":
            _set(variables["params"], ("pool", "kernel"), _conv(value))
        elif name == "pool.bias":
            _set(variables["params"], ("pool", "bias"), value)
        elif name == "cls.0.weight" and version == 2 and fc_norm:
            _set(variables["params"], ("cls_norm", "scale"), value)
        elif name == "cls.0.bias" and version == 2 and fc_norm:
            _set(variables["params"], ("cls_norm", "bias"), value)
        elif name == f"cls.{fc1_idx}.weight":
            _set(variables["params"], ("cls_fc1", "kernel"), _dense(value))
        elif name == f"cls.{fc1_idx}.bias":
            _set(variables["params"], ("cls_fc1", "bias"), value)
        elif name == f"cls.{fc2_idx}.weight":
            _set(variables["params"], ("cls_fc2", "kernel"), _dense(value))
        elif name == f"cls.{fc2_idx}.bias":
            _set(variables["params"], ("cls_fc2", "bias"), value)
        elif name.startswith(("seg_head.", "aux_")):
            continue  # training-only aux segmentation head
        else:
            raise KeyError(f"unmapped UFLD tensor: {name}")
    return variables


def ufld_curvelanes_variables(state: Dict[str, np.ndarray]) -> dict:
    """UFLDv2-CurveLanes torch state dict -> flax variables for
    UFLDv2CurveLanesNet (reference model_curvelanes.py:34-75 naming:
    ``cls_distribute.{0,2}``, ``cls.0`` LayerNorm, ``cls.1`` Linear,
    per-direction ``cls_row``/``cls_col`` Linears)."""
    variables = {"params": {}, "batch_stats": {}}
    direct = {
        "pool.weight": ("pool", "kernel", _conv),
        "pool.bias": ("pool", "bias", None),
        "cls_distribute.0.weight": ("cls_distribute0", "kernel", _conv),
        "cls_distribute.0.bias": ("cls_distribute0", "bias", None),
        "cls_distribute.2.weight": ("cls_distribute2", "kernel", _conv),
        "cls_distribute.2.bias": ("cls_distribute2", "bias", None),
        "cls.0.weight": ("cls_norm", "scale", None),
        "cls.0.bias": ("cls_norm", "bias", None),
        "cls.1.weight": ("cls_fc1", "kernel", _dense),
        "cls.1.bias": ("cls_fc1", "bias", None),
        "cls_row.weight": ("cls_row", "kernel", _dense),
        "cls_row.bias": ("cls_row", "bias", None),
        "cls_col.weight": ("cls_col", "kernel", _dense),
        "cls_col.bias": ("cls_col", "bias", None),
    }
    for name, value in state.items():
        value = np.asarray(value)
        if name.endswith("num_batches_tracked"):
            continue
        if name.startswith("model."):
            mapped = _map_resnet_key(name[len("model.") :])
            if mapped is None:
                raise KeyError(f"unmapped backbone tensor: {name}")
            col, path, transform = mapped
            _set(variables[col], ("backbone",) + path, transform(value))
        elif name in direct:
            mod, leaf, transform = direct[name]
            _set(
                variables["params"], (mod, leaf),
                transform(value) if transform else value,
            )
        elif name.startswith(("seg_head.", "aux_")):
            continue  # training-only aux segmentation head
        else:
            raise KeyError(f"unmapped CurveLanes tensor: {name}")
    return variables


_RESNET_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
                  "mean": "running_mean", "var": "running_var"}


def _resnet_name(path: Tuple[str, ...]) -> str:
    """Inverse of :func:`_map_resnet_key`: a trunk leaf's torchvision name."""
    *mods, leaf = path
    parts = []
    for m in mods:
        block = re.fullmatch(r"layer(\d)_(\d+)", m)
        if block:
            parts += [f"layer{block.group(1)}", block.group(2)]
        else:
            parts.append({"downsample_conv": "downsample.0",
                          "downsample_bn": "downsample.1"}.get(m, m))
    return ".".join(parts + [_RESNET_LEAVES[leaf]])


def ufld_state_dict(flat: Dict[str, np.ndarray], version: int = 2,
                    curvelanes: bool = False) -> Dict[str, np.ndarray]:
    """A flat flax tree of a UFLD net (``params_io`` keys) under the
    reference's torch names: the inverse of :func:`ufld_variables` (and,
    with ``curvelanes``, of :func:`ufld_curvelanes_variables`); conv
    kernels HWIO -> OIHW, dense (in, out) -> (out, in).  What a torch
    checkpoint of the same weights holds."""
    heads = {"pool": "pool", "cls_norm": "cls.0", "cls_row": "cls_row", "cls_col": "cls_col",
             "cls_distribute0": "cls_distribute.0", "cls_distribute2": "cls_distribute.2",
             "cls_fc1": "cls.1" if version == 2 else "cls.0",
             "cls_fc2": "cls.3" if version == 2 else "cls.2"}
    out = {}
    for key, value in flat.items():
        _, *path = key.split("::")
        value = np.asarray(value)
        if path[-1] == "kernel":
            value = np.transpose(value, (3, 2, 0, 1)) if value.ndim == 4 else value.T
        if path[0] == "backbone":
            out["model." + _resnet_name(tuple(path[1:]))] = value
        else:
            out[f"{heads[path[0]]}.{_RESNET_LEAVES[path[-1]]}"] = value
    return out


def main(argv=None) -> None:
    """pth -> ``.npz`` weight store (``params_io.save_params``), the JAX
    CLI's arguments and choices."""
    import argparse

    from .params_io import save_params

    ap = argparse.ArgumentParser(description="torch .pth -> flax .npz")
    ap.add_argument("-i", "--input", required=True, help=".pth checkpoint")
    ap.add_argument("-o", "--output", required=True, help=".npz output")
    ap.add_argument(
        "--arch", default="ufldv2",
        choices=["ufldv1", "ufldv2", "resnet", "yolov5", "yolov5lite",
                 "yolov6", "yolov7", "yolov8", "yolov9", "yolov10"],
    )
    ap.add_argument("--no-fc-norm", action="store_true",
                    help="UFLDv2 variant without the LayerNorm slot")
    ap.add_argument("--scale", default="n", help="yolo scale (n/s/m/l/x)")
    ap.add_argument("--num-classes", type=int, default=80)
    args = ap.parse_args(argv)

    state = load_state_dict(args.input)
    if args.arch == "resnet":
        variables = resnet_variables(state)
    elif args.arch.startswith("yolo"):
        from ..models.yolo import YoloSpec
        from .yolo_import import yolo_variables

        spec = YoloSpec(
            family=args.arch.replace("yolo", ""), scale=args.scale,
            num_classes=args.num_classes,
        )
        variables = yolo_variables(state, spec)
    else:
        variables = ufld_variables(
            state,
            version=2 if args.arch == "ufldv2" else 1,
            fc_norm=not args.no_fc_norm,
        )
    save_params(args.output, variables)
    print(f"saved {args.output}")


if __name__ == "__main__":
    main()
