"""Device-step A/B of the NMS kernels against the plain PyTorch NMS, and
the device busy share of each step, on one CUDA GPU.

Run from the repository root on a machine with an NVIDIA H100 (the
kernels are built for sm_90a):

    python3 -m adas_tpu_torch.tools.nms_ab

It builds the three serving paths that ``chip_smoke.py`` drives, with
seeded random weights and 8 streams of random 720x1280 frames over I420:
YOLOv8l-640 + UFLDv2-CULane calibrated int8 and bf16, and
EfficientDet-D0-512 f32 + UFLDv2-CULane bf16.  For each path:

- **A/B.**  ``ROUNDS`` rounds of ``STEPS`` back-to-back device steps
  (``MultiStreamADAS._step``), CUDA events, order alternating per round.
  "kernels" is the path as served: the IoU kernel's mask mode and the
  walk (hard suppression), one launch each.  "plain" swaps the plain PyTorch NMS into ``select_and_nms``:
  ``iou_matrix_reference`` then ``nms_scan_reference``, a torch loop of
  about 11 launches per pick.  It prints whether both give the same
  packed output.
- **Device busy share, three readings.**
  * graph: the step is captured once in a CUDA graph and replayed.  A
    replay has no host launch cost, so the replay time over the eager
    step time, both unprofiled, is the share of the eager step in which
    the device works (a replay's own gaps are microseconds);
  * profiled: ``torch.profiler``'s kernel time over 3 steps, over that
    window's wall time.  CUPTI slows the host, so this reads low;
  * derived: the profiled kernel time per step over the unprofiled
    eager median.
- The ten kernels with the most device time per step.

The last line is one JSON object with every number printed before it.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..ops import iou as iou_ops
from ..ops import nms as nms_ops
from ..ops import yolo_decode
from ..ops.cuda_build import build_cuda_libraries

KERNELS = ("stem", "int8_conv", "block", "iou", "nms")
N_STREAMS, FRAME_HW = 8, (720, 1280)
ROUNDS, STEPS = 8, 5
PROFILED_STEPS = 3


def plain_select_loop(boxes, scores, iou_threshold, max_out, method=0, sigma=0.5,
                      score_threshold=0.0, plus_one=False):
    """``select_loop`` through the plain versions, on any device."""
    iou = iou_ops.iou_matrix_reference(boxes.float().contiguous(), plus_one=plus_one)
    return nms_ops.nms_scan_reference(iou, scores.float().contiguous(), iou_threshold, max_out,
                                      method, sigma, score_threshold)


@contextlib.contextmanager
def plain_nms():
    served = yolo_decode.select_loop
    yolo_decode.select_loop = plain_select_loop
    try:
        yield
    finally:
        yolo_decode.select_loop = served


def events_ms(fn, n: int) -> float:
    """Mean CUDA-event time of ``n`` back-to-back calls of ``fn``."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def build_paths():
    from ..perception.efficientdet_detector import EfficientdetDetector
    from ..perception.lane_detector import LaneModelType, UltrafastLaneDetectorV2
    from ..perception.object_detector import ObjectModelType, YoloDetector
    from ..pipeline.multistream import MultiStreamADAS

    culane = LaneModelType.UFLDV2_CULANE
    rng = np.random.default_rng(0)
    paths = {}
    for cd in ("int8", "bf16"):
        yolo = YoloDetector(model_type=ObjectModelType.YOLOV8, scale="l", input_size=(640, 640),
                            box_score=0.25, compute_dtype=cd, device="cuda", seed=0)
        lane = UltrafastLaneDetectorV2(model_type=culane, compute_dtype=cd, device="cuda", seed=1)
        if cd == "int8":
            calib = list(rng.integers(0, 256, (2, *FRAME_HW, 3), dtype=np.uint8))
            yolo.calibrate_int8(calib)
            lane.calibrate_int8(calib)
        paths[cd] = MultiStreamADAS(yolo, lane, N_STREAMS, FRAME_HW, transport="i420")
    det = EfficientdetDetector(compound=0, box_score=0.5, device="cuda", seed=0)
    lane = UltrafastLaneDetectorV2(model_type=culane, compute_dtype="bf16", device="cuda", seed=1)
    paths["effdet"] = MultiStreamADAS(det, lane, N_STREAMS, FRAME_HW, transport="i420")
    frames = rng.integers(0, 256, (N_STREAMS, *FRAME_HW, 3), dtype=np.uint8)
    return paths, frames


def ab(ms, x):
    """Rounds of kernels vs plain steps; returns {side: [ms per step]}.
    Prints whether both sides give the same packed output."""
    with plain_nms():
        want = ms._step(x)
    got = ms._step(x)
    torch.cuda.synchronize()
    print(f"  kernels vs plain NMS: packed outputs equal: {torch.equal(got, want)}, "
          f"max abs diff {(got - want).abs().max().item():.3g}", flush=True)
    times = {"kernels": [], "plain": []}
    for r in range(ROUNDS):
        for side in (("kernels", "plain") if r % 2 == 0 else ("plain", "kernels")):
            with plain_nms() if side == "plain" else contextlib.nullcontext():
                times[side].append(events_ms(lambda: ms._step(x), STEPS))
    return times


def graph_ms(ms, x):
    """Replay time of the step captured in a CUDA graph; prints whether a
    replay gives the eager output."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            ms._step(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ms._step(x)
    graph.replay()
    want = ms._step(x)
    torch.cuda.synchronize()
    print(f"  graph replay vs eager step: equal: {torch.equal(out, want)}, "
          f"max abs diff {(out - want).abs().max().item():.3g}", flush=True)
    return events_ms(graph.replay, 2 * STEPS)


def profiled(ms, x):
    """(kernel ms per step, window wall ms, top kernels [(name, ms per
    step)], kernels per step) over ``PROFILED_STEPS`` profiled steps."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(PROFILED_STEPS):
            ms._step(x)
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kern) / 1e3
    rows = sorted(((a.key, a.self_device_time_total / 1e3) for a in prof.key_averages()),
                  key=lambda r: -r[1])[:10]
    return (busy / PROFILED_STEPS, wall, [(k[:90], t / PROFILED_STEPS) for k, t in rows],
            len(kern) / PROFILED_STEPS)


def main() -> int:
    if not torch.cuda.is_available():
        print("nms_ab: no CUDA GPU visible", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build_cuda_libraries(KERNELS)
    paths, frames = build_paths()
    summary = {"card": smi}
    for name, ms in paths.items():
        x = ms._prep_upload(frames)
        for _ in range(3):
            ms._step(x)
        times = ab(ms, x)
        row = {}
        for side, v in times.items():
            q = statistics.quantiles(v, n=4)
            row[side] = {"median_ms": statistics.median(v), "iqr_ms": [q[0], q[2]], "rounds": v}
        wins = sum(k < p for k, p in zip(times["kernels"], times["plain"]))
        print(f"[{name}] step ms, kernels: median {row['kernels']['median_ms']:.3f} "
              f"IQR {row['kernels']['iqr_ms'][0]:.3f}-{row['kernels']['iqr_ms'][1]:.3f}; plain NMS: "
              f"median {row['plain']['median_ms']:.3f} IQR {row['plain']['iqr_ms'][0]:.3f}-"
              f"{row['plain']['iqr_ms'][1]:.3f}; kernels faster in {wins} of {ROUNDS} rounds",
              flush=True)
        eager = events_ms(lambda: ms._step(x), 2 * STEPS)
        try:
            replay = graph_ms(ms, x)
        except RuntimeError as e:  # a step that cannot be captured is itself a finding
            print(f"[{name}] CUDA graph capture failed: {e}", flush=True)
            replay = float("nan")
        kern_ms, wall, top, n_kern = profiled(ms, x)
        row.update({
            "eager_ms": eager, "graph_ms": replay, "busy_graph": replay / eager,
            "kernel_ms_per_step": kern_ms, "kernels_per_step": n_kern,
            "profiled_wall_ms": wall,
            "busy_profiled": kern_ms * PROFILED_STEPS / wall,
            "busy_derived": kern_ms / row["kernels"]["median_ms"],
            "top_kernels": top,
        })
        print(f"[{name}] unprofiled: eager step {eager:.3f} ms, graph replay {replay:.3f} ms -> "
              f"device busy {100 * replay / eager:.1f}% (graph reading)", flush=True)
        print(f"[{name}] profiled {PROFILED_STEPS} steps: {n_kern:.0f} kernels per step, "
              f"{kern_ms:.3f} ms kernel time per step in {wall:.3f} ms of wall time -> busy "
              f"{100 * row['busy_profiled']:.1f}% (profiled reading); over the A/B median "
              f"{100 * row['busy_derived']:.1f}% (derived reading)", flush=True)
        for k, t in top:
            print(f"[{name}]   {t:8.3f} ms  {k}")
        summary[name] = row
        ms.close()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
