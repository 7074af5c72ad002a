"""Host cost of one kernel call, and of the batch-1 frame paths it adds up
in, on one CUDA GPU, by the route a call takes to its kernel.

Run from the repository root on a machine with an NVIDIA H100 (the
kernels are built for sm_90a):

    python3 -m adas_tpu_torch.tools.dispatch_ab [--rounds 6] [--frames 10] [--calls 1000]
        [--own-route]

Routes, each swapped into the five kernel modules' operator globals in
one process (the same host, the same pipelines):

* ``library``: the operators as shipped (``ops/library.py``:
  ``torch.library.Library`` ``define`` / ``impl``);
* ``custom_op``: the same CUDA implementations registered through
  ``torch.library.custom_op`` (in the namespace ``adas_dispatch_ab``),
  called through ``torch.ops`` as a ``custom_op`` wrapper would;
* ``direct``: the CUDA implementations called as plain functions, no
  operator (what the wrappers did before the kernels were operators).

In a tree whose kernel modules have no operator globals, or with
``--own-route``, the one route is ``tree``: the wrappers as that tree
calls them (here ``library``), for comparing trees.

1. ``[op-call]``: the public ``ops.int8_conv.int8_conv`` on one small
   batch-1 shape (s8 (1, 20, 20, 64) in, 64 3x3 filters, s8 out),
   ``--calls`` calls in a row under ``torch.inference_mode`` then one
   synchronize, per route, the routes taking turns for ``--rounds``
   rounds: the median over rounds of the wall time per call.  The
   kernel's device time at this shape is a few microseconds, so the loop
   is host bound: the time is the host's cost of one call.
2. ``[frame-int8]``: ``ADASPipeline.process_frame(draw=False)`` on
   YOLOv8l-640 + UFLDv2-CULane int8 (calibrated on two seeded 720p
   frames), fused and unfused routes; ``[frame-v5-int8]``: YOLOv5s-640
   int8 + UFLD v1-CULane bf16, unfused: the phases of ``chip_smoke.py``
   by those names.  3 warm-up frames per pipeline and route, then
   ``--rounds`` rounds in which each route serves ``--frames`` seeded
   720p frames in turn: per route the median and the 10th and 90th
   percentiles of the frame times (host clock; ``process_frame`` ends in
   fetches), each stage's median (``pipe.timers``) and the int8 conv
   launches per frame.

It prints the card's name and power limit, a line per measurement, and as
its last line one JSON object with every number.  To compare trees, copy
this file into each and run it from each tree's root on one machine,
alternating (A, B, B, A).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..ops import block, int8_conv, iou, nms, stem
from ..utils.profiling import StageTimers

WARMUP_CALLS = 200
WARMUP_FRAMES = 3
FRAME_HW = (720, 1280)
#: (module, operator global, its CUDA implementation's name)
OPERATORS = ((stem, "_OP", "_stem_cuda"), (int8_conv, "_OP", "_int8_conv_cuda"),
             (block, "_OP", "_block_cuda"), (iou, "_MATRIX_OP", "_matrix_cuda"),
             (iou, "_MASK_OP", "_mask_cuda"), (nms, "_SCAN_OP", "_scan_cuda"),
             (nms, "_WALK_OP", "_walk_cuda"))


def routes(own: bool = False) -> dict:
    """Route name -> {(module, global): callable} to install."""
    if own or not all(hasattr(m, g) and hasattr(m, impl) for m, g, impl in OPERATORS):
        return {"tree": {}}
    library = {(m, g): getattr(m, g) for m, g, _ in OPERATORS}
    direct = {(m, g): getattr(m, impl) for m, g, impl in OPERATORS}
    custom = {}
    for m, g, impl in OPERATORS:
        schema = str(getattr(m, g)._schema)  # "adas_tpu_torch::name(...) -> Tensor"
        name = schema.split("::", 1)[1].split("(", 1)[0]
        torch.library.custom_op(f"adas_dispatch_ab::{name}", getattr(m, impl), mutates_args=(),
                                device_types="cuda", schema=schema[schema.index("("):])
        custom[(m, g)] = getattr(torch.ops.adas_dispatch_ab, name)
    return {"library": library, "custom_op": custom, "direct": direct}


def install(route: dict) -> None:
    for (m, g), fn in route.items():
        setattr(m, g, fn)


def turns(names, r):
    """The routes in round ``r``'s order (each takes every place in turn)."""
    k = r % len(names)
    return names[k:] + names[:k]


def op_call_us(all_routes: dict, rounds: int, calls: int) -> dict:
    rng = np.random.default_rng(0)
    dev = "cuda"
    xq = torch.from_numpy(rng.integers(-127, 128, (1, 20, 20, 64), dtype=np.int8)).to(dev)
    wq = torch.from_numpy(rng.integers(-127, 128, (64, 3, 3, 64), dtype=np.int8)).to(dev)
    scale = torch.full((64,), 1e-3, device=dev)
    bias = torch.zeros(64, device=dev)
    out_scale = torch.tensor(0.02, device=dev)

    def call():
        int8_conv.int8_conv(xq, wq, scale, bias, stride=1, act="silu", out_scale=out_scale)

    names = list(all_routes)
    us = {name: [] for name in names}
    with torch.inference_mode():
        for name in names:
            install(all_routes[name])
            for _ in range(WARMUP_CALLS):
                call()
        for r in range(rounds):
            for name in turns(names, r):
                install(all_routes[name])
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(calls):
                    call()
                torch.cuda.synchronize()
                us[name].append((time.perf_counter() - t) / calls * 1e6)
    install(all_routes[names[0]])
    return {name: {"median_us": float(np.median(v)), "rounds_us": v} for name, v in us.items()}


def build_pipeline(object_config, lane_config, fused: bool):
    from ..pipeline.app import ADASPipeline

    h, w = FRAME_HW
    calib = list(np.random.default_rng(7).integers(0, 256, (2, h, w, 3), dtype=np.uint8))
    pipe = ADASPipeline(frame_size=(w, h), use_fused=fused, device="cuda",
                        object_config=object_config, lane_config=lane_config)
    for facade in (pipe.objectDetector, pipe.laneDetector):
        if getattr(facade, "compute_dtype", None) == "int8":
            facade.calibrate_int8(calib)
    return pipe


def frame_times(tag, pipe, all_routes: dict, rounds: int, frames: int) -> dict:
    h, w = FRAME_HW
    rng = np.random.default_rng(8)
    seq = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(frames)]
    names = list(all_routes)
    ms = {name: [] for name in names}
    timers = {name: StageTimers() for name in names}
    launches = {name: 0 for name in names}
    for name in names:
        install(all_routes[name])
        for f in seq[:WARMUP_FRAMES]:
            pipe.process_frame(f, draw=False)
    torch.cuda.synchronize()
    for r in range(rounds):
        for name in turns(names, r):
            install(all_routes[name])
            pipe.timers = timers[name]
            int8_conv.reset_launches()
            for f in seq:
                t = time.perf_counter()
                pipe.process_frame(f, draw=False)
                ms[name].append((time.perf_counter() - t) * 1e3)
            launches[name] += int8_conv.launches
    install(all_routes[names[0]])
    out = {}
    for name in names:
        p10, p50, p90 = np.percentile(ms[name], [10, 50, 90])
        out[name] = {"p50_ms": float(p50), "p10_ms": float(p10), "p90_ms": float(p90),
                     "stages_p50_ms": {k: v["p50_ms"]
                                       for k, v in timers[name].summary().items()},
                     "int8_conv_per_frame": launches[name] / len(ms[name])}
        r = out[name]
        print(f"[{tag}] {name}: process_frame(draw=False) p50 {p50:.3f} ms (p10 {p10:.3f}, "
              f"p90 {p90:.3f}) over {len(ms[name])} frames; int8 conv launches per frame "
              f"{r['int8_conv_per_frame']:g}; stage p50s "
              f"{json.dumps({k: round(v, 3) for k, v in r['stages_p50_ms'].items()})}",
              flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--calls", type=int, default=1000)
    ap.add_argument("--own-route", action="store_true",
                    help="only the tree's own route (to compare trees)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dispatch_ab: no CUDA GPU visible")
    from ..utils.types import LaneModelType, ObjectModelType

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    all_routes = routes(args.own_route)
    out = {"device": smi, "tree": int8_conv.__file__, "routes": list(all_routes),
           "rounds": args.rounds, "frames": args.frames, "calls": args.calls}
    out["op_call"] = op_call_us(all_routes, args.rounds, args.calls)
    print(f"[op-call] int8_conv at (1, 20, 20, 64) -> 64, 3x3, s8, us per call (median of "
          f"{args.rounds} rounds of {args.calls}): "
          f"{json.dumps({k: round(v['median_us'], 3) for k, v in out['op_call'].items()})}",
          flush=True)
    v8l = ({"scale": "l", "input_size": (640, 640), "box_score": 0.25, "compute_dtype": "int8",
            "seed": 0},
           {"model_type": LaneModelType.UFLDV2_CULANE, "compute_dtype": "int8", "seed": 1})
    v5s = ({"model_type": ObjectModelType.YOLOV5, "scale": "s", "input_size": (640, 640),
            "box_score": 0.2, "compute_dtype": "int8", "seed": 0},
           {"model_type": LaneModelType.UFLD_CULANE, "compute_dtype": "bf16", "seed": 1})
    for tag, route, configs, fused in (("frame-int8", "fused", v8l, True),
                                       ("frame-int8", "unfused", v8l, False),
                                       ("frame-v5-int8", "unfused", v5s, False)):
        pipe = build_pipeline(*configs, fused)
        out[f"{tag} {route}"] = frame_times(f"{tag} {route}", pipe, all_routes, args.rounds,
                                            args.frames)
        del pipe
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
