"""Serialized engine artifacts: the ``.adas`` file (port of
``adas_tpu/engine/artifact.py``).

A ``.adas`` file is a zip holding

* ``program.pt2`` (one geometry) or ``graphs/{h}x{w}.pt2`` (one per
  source-frame shape): ``torch.export.save`` of ``torch.export.export(...,
  strict=False)`` of the step, with every weight it reads baked in as a
  constant (the int8 ``s8`` kernels, their scales, the calibrated
  activation scales, the folded BN affines) and the port's five CUDA
  kernels kept as one graph node per call (``adas_tpu_torch::*``,
  registered in ``ops/``);
* ``meta.json``: JAX's keys and layout (I/O shapes and dtypes, model
  identity, the pack spec of a fused step), ``platforms`` naming the
  device type the step was exported on (``["cuda"]`` or ``["cpu"]``).

An export is per device type, as a JAX export is per platform: the
graph's factory ops record the device, so :class:`CompiledEngine` serves
a file only on that device type (another one raises), and on an install
whose operators and ``torch.export`` format match the one that built it.
A JAX ``.adas`` (``graph.bin``, StableHLO) raises a ``ValueError`` that
names its format.  :class:`CompiledEngine` runs the programs through
``ExportedProgram.module()``: nothing is compiled, and each kernel node
launches (and counts) exactly as the eager step does.

Before the export every builder runs the step once eagerly on zeros, so
that each cache a module fills on its first call (``models/quant.py``'s
BN folds, packed and padded int8 weights, activation scales) holds real
tensors that the export lifts as constants.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .base import EngineBase
from .torch_engine import to_numpy, torch_dtype

ENGINE_EXT = ".adas"
FORMAT_VERSION = 1
PROGRAM = "program.pt2"

def dtype_name(dtype) -> str:
    """A torch or numpy dtype by its numpy name (``float32``, ``bool``,
    ``bfloat16`` ...), as JAX's metadata writes it."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def _leaves(outs) -> List[torch.Tensor]:
    """The output tree's tensors in JAX's flattening order (dict keys
    sorted)."""
    if isinstance(outs, dict):
        return [t for k in sorted(outs) for t in _leaves(outs[k])]
    if isinstance(outs, (list, tuple)):
        return [t for o in outs for t in _leaves(o)]
    return [outs]


def _leaf_names(outs) -> List[str]:
    if isinstance(outs, dict):
        return list(outs.keys())
    return [f"output{i}" for i in range(len(_leaves(outs)))]


def _platform(platforms: Optional[Sequence[str]]) -> List[str]:
    """The export's device type: ``platforms`` (one of ``cuda`` and
    ``cpu``), by default the card where there is one."""
    if platforms is None:
        return ["cuda" if torch.cuda.is_available() else "cpu"]
    platforms = list(platforms)
    if len(platforms) != 1 or platforms[0] not in ("cuda", "cpu"):
        raise ValueError(
            f"an export runs on one device type, 'cuda' or 'cpu', got {platforms}"
        )
    return platforms


class _Step(torch.nn.Module):
    """A step as the module ``torch.export`` takes.  The step is held in a
    list, so that the modules it closes over are not registered here: the
    export lifts only the tensors the step reads, as constants."""

    def __init__(self, fn):
        super().__init__()
        self._fn = [fn]

    def forward(self, x):
        return self._fn[0](x)


def _export(fn, example: torch.Tensor):
    """One eager call on ``example`` (fills the modules' caches), then the
    export; returns (the saved program's bytes, the eager outputs)."""
    with torch.inference_mode():
        outs = fn(example)
    program = torch.export.export(_Step(fn), (example,), strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue(), outs


def _example(shape, dtype, platform: str, device) -> torch.Tensor:
    dev = torch.device(platform if device is None else device)
    if dev.type != platform:
        raise ValueError(f"export for {platform} from a step on {dev}")
    return torch.zeros(tuple(int(d) for d in shape), dtype=dtype, device=dev)


def _write(out_path: str, blobs: dict, metadata: dict) -> None:
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_STORED) as zf:
        for name, blob in blobs.items():
            zf.writestr(name, blob)  # a .pt2 is a zip itself
        zf.writestr("meta.json", json.dumps(metadata, indent=2), zipfile.ZIP_DEFLATED)


def build_artifact(
    apply_fn,
    variables,
    input_shape_nchw: Sequence[int],
    out_path: str,
    dtype=torch.float32,
    platforms: Optional[Sequence[str]] = None,
    meta: Optional[dict] = None,
    device=None,
) -> dict:
    """Export ``apply_fn(variables, nhwc)`` with its weights baked in
    (``artifact.py:37``): NCHW shape at the boundary, NHWC graph input.
    Returns the metadata written."""
    n, c, h, w = input_shape_nchw
    platforms = _platform(platforms)
    blob, outs = _export(lambda x: apply_fn(variables, x),
                         _example((n, h, w, c), dtype, platforms[0], device))
    leaves = _leaves(outs)
    metadata = {
        "format_version": FORMAT_VERSION,
        "input_shape_nchw": [int(v) for v in input_shape_nchw],
        "input_dtype": dtype_name(dtype),
        "output_shapes": [[int(d) for d in o.shape] for o in leaves],
        "output_dtypes": [dtype_name(o.dtype) for o in leaves],
        "output_names": _leaf_names(outs),
        "platforms": platforms,
        **(meta or {}),
    }
    _write(out_path, {PROGRAM: blob}, metadata)
    return metadata


def build_fused_artifact(
    step_fn,
    frame_shape: Sequence[int],
    out_path: str,
    frame_dtype=torch.uint8,
    platforms: Optional[Sequence[str]] = None,
    meta: Optional[dict] = None,
    device=None,
) -> dict:
    """Export a detector's fused step, raw uint8 frame in, decoded compact
    tensors out (``artifact.py:84``): one upload and one fetch a frame."""
    return build_fused_artifact_multi(
        lambda hw: step_fn, [tuple(frame_shape)[:2]], out_path, channels=int(frame_shape[2]),
        frame_dtype=frame_dtype, platforms=platforms, meta=meta, device=device,
    )


def build_fused_artifact_multi(
    step_for,
    frame_hws: Sequence[Sequence[int]],
    out_path: str,
    channels: int = 3,
    frame_dtype=torch.uint8,
    platforms: Optional[Sequence[str]] = None,
    meta: Optional[dict] = None,
    meta_for=None,
    device=None,
) -> dict:
    """One ``.adas`` with one program per source-frame shape
    (``artifact.py:117``): ``step_for((h, w))`` is the fused step for that
    geometry; :meth:`CompiledEngine.run_device` picks the program by the
    frame's shape.  ``meta_for((h, w))`` adds per-geometry metadata."""
    platforms = _platform(platforms)
    geoms, blobs = [], {}
    for hw in frame_hws:
        h, w = int(hw[0]), int(hw[1])
        blob, outs = _export(step_for((h, w)),
                             _example((h, w, channels), frame_dtype, platforms[0], device))
        leaves = _leaves(outs)
        entry = {
            "frame_shape": [h, w, channels],
            "output_shapes": [[int(d) for d in o.shape] for o in leaves],
            "output_dtypes": [dtype_name(o.dtype) for o in leaves],
            "output_names": _leaf_names(outs),
        }
        if meta_for is not None:
            entry.update(meta_for((h, w)))
        geoms.append(entry)
        blobs[f"graphs/{h}x{w}.pt2"] = blob
    first = geoms[0]
    h0, w0, c0 = first["frame_shape"]
    metadata = {
        "format_version": FORMAT_VERSION,
        "fused": True,
        # the first geometry's fields at the top level, as JAX writes them
        "frame_shape": first["frame_shape"],
        "input_shape_nchw": [1, c0, h0, w0],
        "input_dtype": dtype_name(frame_dtype),
        "output_shapes": first["output_shapes"],
        "output_dtypes": first["output_dtypes"],
        "output_names": first["output_names"],
        "geometries": geoms,
        "platforms": platforms,
        **(meta or {}),
    }
    _write(out_path, blobs, metadata)
    return metadata


def _structure_leaves(structure) -> int:
    kind, _, children = structure
    return 1 if kind == "leaf" else sum(_structure_leaves(c) for c in children)


def pack_spec_meta(pack_spec) -> dict:
    """A flat-dict pack spec (``ops/packing.pack`` of a dict of tensors) as
    JAX's ``pack`` metadata (``artifact.py:180``)."""
    (kind, keys, _), shapes = pack_spec
    if kind != "dict":
        raise ValueError("pack_spec_meta takes the spec of a flat dict; use pack_tree_meta")
    return {
        "pack": {
            "keys": list(keys),
            "shapes": [[int(d) for d in s] for s, _ in shapes],
            "dtypes": [dtype_name(d) for _, d in shapes],
        }
    }


def _tree_to_json(structure, counter):
    kind, keys, children = structure
    if kind == "leaf":
        counter[0] += 1
        return counter[0] - 1
    parts = [_tree_to_json(c, counter) for c in children]
    return dict(zip(keys, parts)) if kind == "dict" else {"__tuple__": parts}


def _tree_from_json(j):
    if isinstance(j, dict):
        if len(j) == 1 and ("__tuple__" in j or "__list__" in j):
            return ("tuple", None, [_tree_from_json(x) for x in next(iter(j.values()))])
        keys = sorted(j)
        return ("dict", keys, [_tree_from_json(j[k]) for k in keys])
    return ("leaf", None, None)


def pack_tree_meta(pack_spec) -> dict:
    """A pack spec of any tree (nested tuples and dicts) as JAX's
    ``pack_tree`` metadata (``artifact.py:217``): the tree with each leaf
    replaced by its index, tuples tagged ``__tuple__``."""
    structure, shapes = pack_spec
    return {
        "pack_tree": {
            "tree": _tree_to_json(structure, [0]),
            "shapes": [[int(d) for d in s] for s, _ in shapes],
            "dtypes": [dtype_name(d) for _, d in shapes],
        }
    }


def pack_spec_from_meta(meta: dict):
    """The ``ops/packing`` spec of :func:`pack_tree_meta` metadata."""
    m = meta["pack_tree"]
    structure = _tree_from_json(m["tree"])
    if _structure_leaves(structure) != len(m["shapes"]):
        raise ValueError("pack_tree metadata: the tree and the shapes disagree")
    return structure, [(tuple(s), torch_dtype(d)) for s, d in zip(m["shapes"], m["dtypes"])]


def build_step_artifact(
    fn,
    input_spec: Tuple[Sequence[int], torch.dtype],
    out_path: str,
    platforms: Optional[Sequence[str]] = None,
    meta: Optional[dict] = None,
    device=None,
) -> dict:
    """Export any single-input step with its weights baked in
    (``artifact.py:242``): the pipeline-scale artifact (the whole batched
    multi-stream step).  ``input_spec`` is the input's ``(shape, dtype)``;
    ``frame_shape`` in the metadata carries the full shape, on which
    :meth:`CompiledEngine.run_device` dispatches."""
    shape, dtype = input_spec
    platforms = _platform(platforms)
    blob, outs = _export(fn, _example(shape, dtype, platforms[0], device))
    leaves = _leaves(outs)
    metadata = {
        "format_version": FORMAT_VERSION,
        "fused": True,
        "frame_shape": [int(d) for d in shape],
        "input_dtype": dtype_name(dtype),
        "output_shapes": [[int(d) for d in o.shape] for o in leaves],
        "output_dtypes": [dtype_name(o.dtype) for o in leaves],
        "platforms": platforms,
        **(meta or {}),
    }
    _write(out_path, {PROGRAM: blob}, metadata)
    return metadata


def check_fused_frame(engine, srcimg: np.ndarray) -> torch.Tensor:
    """A source frame on the engine's device, after checking its shape
    against the fused artifact's baked shapes (``artifact.py:279``)."""
    from ..ops.preprocess import frame_to_device

    shapes = engine.fused_shapes
    if tuple(srcimg.shape) not in shapes:
        raise ValueError(
            f"fused engine was built for frame shape(s) {sorted(shapes)}, got "
            f"{tuple(srcimg.shape)}; rebuild with "
            f"export_fused(frame_hw=[..., {tuple(srcimg.shape[:2])}])"
        )
    return frame_to_device(srcimg, engine.device)


def unpack_from_meta(flat: np.ndarray, pack_meta: dict) -> dict:
    """Host-side inverse of ``pack`` driven by artifact metadata."""
    flat = np.asarray(flat)
    out, off = {}, 0
    for key, shape, dtype in zip(pack_meta["keys"], pack_meta["shapes"], pack_meta["dtypes"]):
        n = int(np.prod(shape)) if shape else 1
        out[key] = flat[off: off + n].reshape(shape).astype(dtype)
        off += n
    return out


def read_meta(path: str) -> dict:
    """A ``.adas`` file's ``meta.json``, without loading its programs."""
    with zipfile.ZipFile(path) as zf:
        return json.loads(zf.read("meta.json"))


def _jax_graph(names) -> bool:
    return any(n == "graph.bin" or (n.startswith("graphs/") and n.endswith(".bin"))
               for n in names)


class CompiledEngine(EngineBase):
    """Serves a ``.adas`` file the port built (EngineBase protocol), on
    ``device`` (by default the device type it was exported for; another
    type raises)."""

    framework_type = "torch-export"

    def __init__(self, model_path: str, device=None):
        from ..perception.object_detector import resolve_device

        with zipfile.ZipFile(model_path) as zf:
            names = zf.namelist()
            self._meta = json.loads(zf.read("meta.json"))
            if _jax_graph(names):
                raise ValueError(
                    f"{model_path} is a JAX .adas artifact (jax.export StableHLO, graph.bin): "
                    "the port serves the .adas files it builds itself (torch.export "
                    "programs, .pt2); rebuild it with adas_tpu_torch.tools.build_engine"
                )
            platforms = list(self._meta["platforms"])
            self.device = resolve_device(platforms[0] if device is None else device)
            if self.device.type not in platforms:
                raise ValueError(
                    f"{model_path} was exported for {platforms}; it cannot serve on "
                    f"{self.device} (the graph records its device): rebuild it there"
                )
            if PROGRAM in names:
                # a net's artifact keys on the NCHW binding, a fused one on
                # the baked input shape
                shape = self._meta.get("frame_shape")
                if shape is None:
                    n, c, h, w = self._meta["input_shape_nchw"]
                    shape = (h, w, c)
                programs = {tuple(shape): PROGRAM}
            else:
                programs = {tuple(g["frame_shape"]): "graphs/{}x{}.pt2".format(*g["frame_shape"])
                            for g in self._meta.get("geometries", [])}
            self._calls = {
                shape: torch.export.load(io.BytesIO(bytearray(zf.read(name)))).module()
                for shape, name in programs.items()
            }
        self.providers = ",".join(platforms)
        self._call = next(iter(self._calls.values()))

    @property
    def meta(self) -> dict:
        return self._meta

    def get_engine_input_shape(self) -> Sequence[int]:
        return self._meta["input_shape_nchw"]

    def get_engine_output_shape(self) -> Tuple[List[Sequence[int]], List[str]]:
        return self._meta["output_shapes"], self._meta["output_names"]

    @property
    def fused(self) -> bool:
        """True when the artifact holds preprocess + net + decode in one
        program: serve it with one ``run_device(frame)``."""
        return bool(self._meta.get("fused", False))

    @property
    def fused_shapes(self):
        """The input shapes this artifact serves (one program each)."""
        return set(self._calls.keys())

    def geometry_meta(self, frame_shape) -> dict:
        """Per-geometry metadata entry (the artifact-level fields for a
        single-geometry file)."""
        for g in self._meta.get("geometries", []):
            if tuple(g["frame_shape"]) == tuple(frame_shape):
                return g
        return self._meta

    @property
    def engine_dtype(self):
        d = self._meta["input_dtype"]
        if d == "uint8":
            return np.uint8
        return np.float16 if d == "float16" else np.float32

    @torch.inference_mode()
    def run_device(self, x: torch.Tensor):
        """Run on the device; a multi-geometry artifact picks its program
        by the input's shape."""
        return self._calls.get(tuple(x.shape), self._call)(x)

    def device_inference(self, x: torch.Tensor) -> List[torch.Tensor]:
        nhwc = x.permute(0, 2, 3, 1).contiguous()
        dtype = torch_dtype(self._meta["input_dtype"])
        with torch.inference_mode():
            return _leaves(self._call(nhwc.to(self.device, dtype)))

    def engine_inference(self, input_tensor: np.ndarray) -> List[np.ndarray]:
        nhwc = torch.from_numpy(np.ascontiguousarray(np.transpose(input_tensor, (0, 2, 3, 1))))
        dtype = torch_dtype(self._meta["input_dtype"])
        with torch.inference_mode():
            outs = self._call(nhwc.to(self.device, dtype))
        return [to_numpy(o) for o in _leaves(outs)]
