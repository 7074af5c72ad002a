"""Host-clock times of ``YoloDetector.DetectFrame`` on one CUDA GPU, per
family, scale and precision, for comparing two trees of the port.

Run from the repository root on a machine with an NVIDIA H100 (the
kernels are built for sm_90a):

    python3 -m adas_tpu_torch.tools.frame_times [--cases v5lite:e,v5lite:s] [--frames 30]

Each case is ``family:scale``; each is built from seeded random weights
in f32 and in int8 (calibrated on two seeded 720x1280 frames), then
``DetectFrame`` runs on one seeded 720x1280 frame: 5 warm-up calls,
then ``--frames`` timed ones (``time.perf_counter``; ``DetectFrame``
ends in a device-to-host copy, so each call is complete).  Then the
net's forward alone on a zero input: the host's time to issue it (mean
over ``--frames`` forwards, before the device is waited for) and the
device time of its kernels (``torch.profiler``, mean of 5).  It prints
the median and the 10th and 90th percentiles of the frame times, those
two, the card's name and power limit, and as its last line one JSON
object with every number.
To compare two trees, run this file from one with ``PYTHONPATH`` set to
each in turn, in one session, in the order A, B, B, A.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..perception.object_detector import YoloDetector
from ..utils.types import ObjectModelType

#: family -> its model type
TYPES = {"v5": ObjectModelType.YOLOV5, "v5lite": ObjectModelType.YOLOV5_LITE,
         "v6": ObjectModelType.YOLOV6, "v7": ObjectModelType.YOLOV7,
         "v8": ObjectModelType.YOLOV8, "v9": ObjectModelType.YOLOV9,
         "v10": ObjectModelType.YOLOV10}
WARMUP = 5
PROFILED = 5


def frame_times(family: str, scale: str, compute_dtype, frames: int) -> dict:
    det = YoloDetector(model_type=TYPES[family], scale=scale, compute_dtype=compute_dtype,
                       device="cuda", seed=0)
    if compute_dtype == "int8":
        det.calibrate_int8(list(np.random.default_rng(10).integers(
            0, 256, (2, 720, 1280, 3), dtype=np.uint8)))
    frame = np.random.default_rng(9).integers(0, 256, (720, 1280, 3), dtype=np.uint8)
    for _ in range(WARMUP):
        det.DetectFrame(frame)
    ms = []
    for _ in range(frames):
        t = time.perf_counter()
        det.DetectFrame(frame)
        ms.append((time.perf_counter() - t) * 1e3)
    p10, p50, p90 = np.percentile(ms, [10, 50, 90])
    # the net's forward alone on a letterboxed-size input: the host's time
    # to issue it (the device follows within microseconds: host bound), and
    # the device time of its kernels (torch.profiler, CUPTI)
    x = torch.zeros(1, 3, *det.spec.input_size, device="cuda",
                    dtype=torch.float32 if compute_dtype is None else torch.bfloat16)
    with torch.inference_mode():
        for _ in range(3):
            det.net(x)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(frames):
            det.net(x)
        issue_ms = (time.perf_counter() - t) * 1e3 / frames
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED):
                det.net(x)
            torch.cuda.synchronize()
    device_ms = sum(e.device_time_total for e in prof.key_averages()) / PROFILED / 1e3
    return {"p50_ms": float(p50), "p10_ms": float(p10), "p90_ms": float(p90),
            "forward_issue_ms": issue_ms, "forward_device_ms": device_ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default="v5lite:e,v5lite:s,v5lite:g")
    ap.add_argument("--frames", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("frame_times: no CUDA GPU visible")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out = {"device": smi, "frames": args.frames, "cases": {}}
    for case in args.cases.split(","):
        family, scale = case.split(":")
        for cd in (None, "int8"):
            r = frame_times(family, scale, cd, args.frames)
            key = f"{family}-{scale} {cd or 'f32'}"
            out["cases"][key] = r
            print(f"[frame_times] {key}: DetectFrame p50 {r['p50_ms']:.3f} ms "
                  f"(p10 {r['p10_ms']:.3f}, p90 {r['p90_ms']:.3f}) over {args.frames} frames; "
                  f"net forward issued in {r['forward_issue_ms']:.3f} ms, its kernels "
                  f"{r['forward_device_ms']:.3f} ms on the device", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
