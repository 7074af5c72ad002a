"""Weight-store quantization: fp16/bf16/fp32 casts and the weight-only
int8 store (the port's copy of ``adas_tpu/tools/quantize.py``).

``cast_params`` casts every floating leaf of a variable tree;
``save_int8`` writes the ``_int8.npz`` store: each floating leaf of at
least 1024 elements and two dims as symmetric per-output-channel s8
(``q::<path>``) with its f32 scales (``s::<path>``), every other leaf as
it is (``q::<path>``).  The numpy steps are JAX's, one for one, so both
packages write and read the same files to the bit.  numpy has no
bfloat16: a bf16 leaf is held as its raw 2-byte pattern (``|V2``), as a
JAX bf16 array lands in an ``.npz``; ``weights.load_flax_variables``
reads it as bf16.

The port's W8A8 packing of a net at load (JAX's ``pack_int8_weights``)
and its calibration are ``models/quant.pack_int8_weights`` and
``models/quant.calibrating``.

CLI (the reference's ``python onnxQuantization.py -i model.onnx``):
    python -m adas_tpu_torch.tools.quantize -i weights.npz --mode bf16
    python -m adas_tpu_torch.tools.quantize -i yolov8n.npz --mode int8 --calibrate YOLOV8
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Tuple

import numpy as np

from .params_io import flatten_variables, load_params, save_params, unflatten_variables

_CAST_DTYPES = {"fp16": np.float16, "bf16": "bfloat16", "fp32": np.float32}
#: a bfloat16 leaf as numpy holds it: its raw 2-byte pattern
BF16_BITS = np.dtype("V2")


def to_bf16_bits(arr: np.ndarray) -> np.ndarray:
    """Round to bfloat16 (nearest even, as ``astype(bfloat16)``) and keep
    the bit pattern as ``|V2``."""
    import torch

    t = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(BF16_BITS)


def from_bf16_bits(arr: np.ndarray) -> np.ndarray:
    """A ``|V2`` bfloat16 leaf as f32 (exact)."""
    bits = np.ascontiguousarray(arr).view("<u2").astype(np.uint32) << 16
    return bits.view(np.float32)


def cast_params(variables: dict, mode: str) -> dict:
    """Cast every floating leaf (bf16 ones included) to fp16, bf16 or fp32;
    other leaves stay as they are."""
    target = _CAST_DTYPES[mode]

    def cast(leaf):
        arr = np.asarray(leaf)
        if arr.dtype == BF16_BITS:
            arr = from_bf16_bits(arr)
        elif not np.issubdtype(arr.dtype, np.floating):
            return arr
        return to_bf16_bits(arr) if target == "bfloat16" else arr.astype(target)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else cast(v) for k, v in tree.items()}

    return walk(variables)


def quantize_int8(
    variables: dict, min_size: int = 1024
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Weight-only symmetric int8 over the last axis (output channels).

    Returns (flat_int8_tree, scales); leaves smaller than ``min_size``
    elements (biases, BN stats) stay fp32 — they are bandwidth-irrelevant.
    """
    flat = flatten_variables(variables)
    q: Dict[str, np.ndarray] = {}
    scales: Dict[str, np.ndarray] = {}
    for name, value in flat.items():
        arr = np.asarray(value)
        if (
            np.issubdtype(arr.dtype, np.floating)
            and arr.size >= min_size
            and arr.ndim >= 2
        ):
            absmax = np.abs(arr).max(
                axis=tuple(range(arr.ndim - 1)), keepdims=True
            )
            scale = np.where(absmax > 0, absmax / 127.0, 1.0)
            q[name] = np.clip(
                np.round(arr / scale), -127, 127
            ).astype(np.int8)
            scales[name] = scale.astype(np.float32)
        else:
            q[name] = arr
    return q, scales


def dequantize_int8(
    q: Dict[str, np.ndarray],
    scales: Dict[str, np.ndarray],
    dtype=np.float32,
) -> dict:
    """Inverse of :func:`quantize_int8`, back to a variables tree."""
    flat = {}
    for name, value in q.items():
        if name in scales:
            flat[name] = (value.astype(np.float32) * scales[name]).astype(dtype)
        else:
            flat[name] = value
    return unflatten_variables(flat)


def save_int8(path: str, variables: dict) -> None:
    q, scales = quantize_int8(variables)
    payload = {f"q::{k}": v for k, v in q.items()}
    payload.update({f"s::{k}": v for k, v in scales.items()})
    np.savez_compressed(path, **payload)


def load_int8(path: str, dtype=np.float32) -> dict:
    with np.load(path) as data:
        q = {k[3:]: data[k] for k in data.files if k.startswith("q::")}
        scales = {k[3:]: data[k] for k in data.files if k.startswith("s::")}
    return dequantize_int8(q, scales, dtype=dtype)


def calibrate_store(variables: dict, model: str, scale: str = "n", frames: int = 8,
                    device="cuda", calib_dir: Optional[str] = None) -> dict:
    """``variables`` with the static ``act_scales`` of the registry's
    ``model`` (its int8 net at ``scale``, at the entry's input shape),
    calibrated on ``device`` with the port's ``calibrating()``: a running
    absmax per int8 input, started from the store's own scales where it
    has them (JAX's union max).  The frames: with ``calib_dir``, its first
    ``frames`` image files in sorted order (``.jpg/.jpeg/.png/.bmp``, read
    by ``render/image.imread``), each letterboxed to the entry's input
    through ``yolo_preprocess`` in f32, as JAX's CLI feeds them
    (``quantize.py:256-286``); else ``frames`` seeded N(0,1) frames
    (``default_rng(0)``, the JAX CLI's numbers)."""
    import torch

    from ..engine.registry import build
    from ..models.quant import calibrating
    from ..weights import flax_variables, load_flax_variables

    with torch.device(device):
        entry = build(model, scale=scale, int8=True)
    net = entry.net
    _, _, h, w = entry.input_shape_nchw
    if calib_dir is not None:
        samples = list(calib_dir_frames(calib_dir, frames, (h, w), device))
    else:
        rng = np.random.default_rng(0)
        samples = [torch.from_numpy(rng.standard_normal((1, h, w, 3)).astype(np.float32))
                   .permute(0, 3, 1, 2).contiguous().to(device) for _ in range(frames)]
    flat = flatten_variables(variables)
    load_flax_variables(net, flat)
    net.eval().requires_grad_(False)
    with torch.inference_mode(), calibrating(net):
        for x in samples:
            net(x)
    flat.update({k: v for k, v in flax_variables(net).items() if k.startswith("act_scales::")})
    return unflatten_variables(flat)


def calib_dir_frames(calib_dir: str, frames: int, hw, device="cuda"):
    """The calibration batches of ``--calib-dir`` (``quantize.py:256-286``):
    the first ``frames`` files with an image suffix, sorted, each read as
    BGR and letterboxed to ``hw`` by ``yolo_preprocess`` (NCHW f32)."""
    from ..ops.preprocess import LetterboxGeometry, yolo_preprocess
    from ..render.image import IMAGE_SUFFIXES, imread

    files = sorted(f for f in os.listdir(calib_dir)
                   if f.lower().endswith(IMAGE_SUFFIXES))[:frames]
    if not files:
        raise SystemExit(f"--calib-dir {calib_dir}: no image files")
    h, w = hw
    for f in files:
        img = imread(os.path.join(calib_dir, f))
        if img is None:
            raise ValueError(f"--calib-dir: cannot read {f}")
        yield yolo_preprocess(img, LetterboxGeometry(img.shape[0], img.shape[1], h, w),
                              device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Quantize a .npz weight store")
    ap.add_argument("-i", "--input", required=True, help="input .npz")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument(
        "--mode", choices=["fp16", "bf16", "int8"], default="fp16"
    )
    ap.add_argument(
        "--calibrate", default=None, metavar="MODEL",
        help="int8 only: registry model name (e.g. YOLOV8) to run "
        "calibration frames through, baking static act_scales into the "
        "output (the reference's TRT Calibrator contract).  Pass real "
        "frames with --calib-dir; without it, N(0,1) synthetic frames "
        "are used and the scales are PLACEHOLDERS (a warning is "
        "printed) — real activations may clip at serve time",
    )
    ap.add_argument(
        "--calib-dir", default=None, metavar="DIR",
        help="directory of real image files (.jpg/.png/.bmp) to "
        "calibrate on — preprocessed through the model's own input "
        "path, like TRT's Calibrator batch stream",
    )
    ap.add_argument("--calib-frames", type=int, default=8)
    ap.add_argument("--scale", default="n", help="model scale for --calibrate")
    ap.add_argument("--device", default="cuda",
                    help="where --calibrate runs the net (cuda or cpu)")
    args = ap.parse_args(argv)
    variables = load_params(args.input)
    stem = os.path.splitext(args.input)[0]
    out = args.output or f"{stem}_{args.mode}.npz"
    if args.mode == "int8":
        if args.calibrate:
            if not args.calib_dir:
                print(
                    "WARNING: calibrating on synthetic N(0,1) frames — "
                    "the baked act_scales are placeholders; pass "
                    "--calib-dir with real frames (or use the facade "
                    "calibrate_int8 API) for production scales",
                )
            variables = calibrate_store(variables, args.calibrate, args.scale,
                                        args.calib_frames, args.device, args.calib_dir)
        save_int8(out, variables)
    else:
        save_params(out, cast_params(variables, args.mode))
    print(f"saved {out}")


if __name__ == "__main__":
    main()
