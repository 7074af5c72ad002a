"""The calibrated int8 serving nets of two trees of the port, compared on
one CUDA GPU.

``dump OUT.npz`` builds YOLOv8l-640 and UFLDv2-CULane in int8 on the card
from seeded random weights (seeds 0 and 1, as ``chip_smoke.py``'s main
path), calibrates both from two seeded 720x1280 frames, and saves every
activation scale, every packed weight and weight scale, the packed
output of one seeded 8-stream I420 tick and the detections per stream.
It uses only what earlier trees of the port have too, so it runs against
another tree unpacked beside this one:

    PYTHONPATH=<tree> python3 adas_tpu_torch/tools/calib_ab.py dump a.npz
    PYTHONPATH=. python3 adas_tpu_torch/tools/calib_ab.py dump b.npz
    python3 adas_tpu_torch/tools/calib_ab.py compare a.npz b.npz

``compare`` counts the values that differ between two dumps, by kind.
"""
from __future__ import annotations

import sys

import numpy as np

FRAME_HW, N_STREAMS = (720, 1280), 8


def dump(path: str) -> None:
    import torch

    from adas_tpu_torch.ops.cuda_build import build_cuda_libraries
    from adas_tpu_torch.perception.lane_detector import LaneModelType, UltrafastLaneDetectorV2
    from adas_tpu_torch.perception.object_detector import ObjectModelType, YoloDetector
    from adas_tpu_torch.pipeline.multistream import MultiStreamADAS

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build_cuda_libraries(("stem", "int8_conv", "block", "iou", "nms"))
    yolo = YoloDetector(model_type=ObjectModelType.YOLOV8, scale="l", input_size=(640, 640),
                        box_score=0.25, compute_dtype="int8", device="cuda", seed=0)
    lane = UltrafastLaneDetectorV2(model_type=LaneModelType.UFLDV2_CULANE, compute_dtype="int8",
                                   device="cuda", seed=1)
    rng = np.random.default_rng(0)
    calib = list(rng.integers(0, 256, (2, *FRAME_HW, 3), dtype=np.uint8))
    yolo.calibrate_int8(calib)
    lane.calibrate_int8(calib)
    out = {}
    for tag, facade in (("yolo", yolo), ("lane", lane)):
        for name, m in facade.net.named_modules():
            for buf, t in m.named_buffers(recurse=False):
                if t is None:
                    continue
                if buf.endswith(("xmax", "ymax")):
                    out[f"act_scale:{tag}.{name}.{buf}"] = m.buffer_scale(buf).cpu().numpy()
                elif buf in ("wq", "wscale"):
                    out[f"{buf}:{tag}.{name}"] = t.cpu().numpy()
    ms = MultiStreamADAS(yolo, lane, N_STREAMS, FRAME_HW, transport="i420")
    tick = rng.integers(0, 256, (N_STREAMS, *FRAME_HW, 3), dtype=np.uint8)
    with torch.inference_mode():
        out["packed"] = ms._step(ms._prep_upload(tick)).cpu().numpy()
    out["detections"] = np.array([len(r["objects"]) for r in ms.process_batch(tick)])
    ms.close()
    np.savez(path, **out)
    print(f"{len(out)} arrays saved to {path} ({torch.cuda.get_device_name(0)})", flush=True)


def compare(path_a: str, path_b: str) -> None:
    a, b = np.load(path_a), np.load(path_b)
    if sorted(a.files) != sorted(b.files):
        raise SystemExit(f"the dumps hold other arrays: {sorted(set(a.files) ^ set(b.files))}")
    kinds = {}
    for key in a.files:
        if ":" not in key:
            continue
        kind = key.split(":")[0]
        n, total, tensors = kinds.get(kind, (0, 0, 0))
        differ = int((a[key] != b[key]).sum())
        kinds[kind] = (n + differ, total + a[key].size, tensors + bool(differ))
    for kind, (n, total, tensors) in sorted(kinds.items()):
        print(f"{kind}: {n} of {total} values differ, in {tensors} tensors")
    p, q = a["packed"], b["packed"]
    print(f"packed I420 tick output {p.shape}: {int((p != q).sum())} of {p.size} values differ, "
          f"max abs {float(np.abs(p - q).max()):.6g}; detections per stream "
          f"{a['detections'].tolist()} and {b['detections'].tolist()}")


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "dump":
        dump(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        compare(sys.argv[2], sys.argv[3])
    else:
        raise SystemExit(__doc__)
