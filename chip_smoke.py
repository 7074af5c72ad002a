"""On-GPU smoke test of the PyTorch/CUDA port (``adas_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU (an H100;
the kernels are built for sm_90a):

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build the stem kernel (``adas_tpu_torch/csrc/stem.cu``) from source;
3. the kernel against its plain PyTorch version ``stem_reference`` at
   both serving shapes — YOLOv8 3x3/2 + SiLU on 8x3x640x640 and ResNet
   7x7/2 + ReLU + max pool on 8x3x320x1600 — in bf16 (atol = rtol = 1e-2)
   and in f32 with TF32 off (atol 2e-4, rtol 1e-4), each side timed with
   CUDA events;
4. the full-width slice on a small input: the port's preprocess and both
   nets (YOLOv8l, UFLDv2 with a ResNet-18 trunk) in f32 on the GPU against
   the same on the CPU (the plain stem), rtol 1e-3 with an atol of 1e-3
   of the output's largest magnitude;
5. the main path: YOLOv8l-640 bf16 + UFLDv2-CULane bf16 with seeded
   random weights, 8 streams of 720x1280 frames over I420 transport,
   ``process_batch`` ticks and ``serve_pipelined`` ticks.  The stem launch
   count is reset just before and must grow by exactly 2 per tick (one
   YOLO stem, one ResNet stem); outputs must be finite and detections
   non-empty.  Prints per-tick times and a per-stage breakdown.

Then one JSON line describing the kernel — ``launches`` from phase 5;
``max_abs_err``, ``ms`` and ``plain_ms`` from phase 3 in bf16, the times
summed over the two serving shapes (one tick's stems) — and last
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when no CUDA GPU is visible.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches, after warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase(S, torch):
    """Stem kernel vs stem_reference at the two serving shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    sites = (
        ("yolo_stem_k3_silu", (8, 3, 640, 640), 3, "silu", False),
        ("resnet_stem_k7_relu_pool", (8, 3, 320, 1600), 7, "relu", True),
    )
    rows = []
    for dtype, atol, rtol in ((torch.bfloat16, 1e-2, 1e-2), (torch.float32, 2e-4, 1e-4)):
        for name, shape, k, act, pool in sites:
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = (torch.randn(64, 3, k, k, generator=gen, device="cuda") * 0.1).to(dtype)
            gain = torch.randn(64, generator=gen, device="cuda")
            bias = torch.randn(64, generator=gen, device="cuda")
            args = dict(act=act, pool=pool)
            got = S.fused_stem(x, w, gain, bias, **args)
            ref = S.stem_reference(x, w, gain, bias, **args)
            torch.cuda.synchronize()
            check(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
            err = (got.float() - ref.float()).abs().max().item()
            ok = torch.allclose(got.float(), ref.float(), atol=atol, rtol=rtol)
            ms = cuda_ms(lambda: S.fused_stem(x, w, gain, bias, **args), 20)
            plain_ms = cuda_ms(lambda: S.stem_reference(x, w, gain, bias, **args), 20)
            print(
                f"[kernel] {name} {str(dtype)[6:]} {tuple(shape)} -> {tuple(got.shape)}: "
                f"max_abs_err {err:.6g} (atol {atol}, rtol {rtol}) kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms", flush=True,
            )
            check(ok, f"{name} {dtype}: kernel disagrees with stem_reference (max abs err {err})")
            rows.append((dtype, err, ms, plain_ms))
    bf16 = [r for r in rows if r[0] == torch.bfloat16]
    return (
        max(r[1] for r in bf16), sum(r[2] for r in bf16), sum(r[3] for r in bf16),
    )


def reference_phase(torch, np):
    """The full-width nets and preprocess in f32 on the GPU vs the CPU."""
    from adas_tpu_torch.models import ufld
    from adas_tpu_torch.models.layers import consume_stem
    from adas_tpu_torch.models.ufld import LaneModelType, UFLDv2Net
    from adas_tpu_torch.models.yolo import YoloSpec, YoloV8
    from adas_tpu_torch.ops.preprocess import (
        LetterboxGeometry,
        bgr_to_i420,
        ufld_v2_preprocess_yuv,
        yolo_preprocess_yuv,
    )
    from adas_tpu_torch.weights import init_params

    lspec = ufld.UFLDV2_SPECS[LaneModelType.UFLDV2_CULANE]
    h, w = 180, 320
    frames = np.random.default_rng(1).integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    yuv = torch.from_numpy(np.stack([bgr_to_i420(f) for f in frames]))
    small_lane = ufld.UFLDv2Spec(64, 160, lspec.crop_ratio, 20, 72, 10, 16, mlp_mid=64)
    ynet, lnet = YoloV8(YoloSpec("l", 80, (160, 160))), UFLDv2Net(small_lane)
    init_params(ynet, 3)  # on the CPU: one set of weights for both sides
    init_params(lnet, 4)
    outs = {}
    for dev in ("cpu", "cuda"):
        ynet, lnet = ynet.to(dev), lnet.to(dev)
        x = yuv.to(dev)
        with torch.inference_mode():
            xy = yolo_preprocess_yuv(x, h, w, LetterboxGeometry(h, w, 160, 160))
            xl = ufld_v2_preprocess_yuv(x, h, w, 64, 160, lspec.crop_ratio)
            res = {
                "yolo_in": xy, "lane_in": xl,
                "yolo_stem": ynet.net.stem(xy),
                "lane_stem": consume_stem(
                    xl, lnet.backbone.conv1, lnet.backbone.bn1, act="relu", pool=True
                ),
                "yolo_raw": ynet.eval()(xy),
            }
            res.update({f"lane_{k}": v for k, v in lnet.eval()(xl).items()})
        outs[dev] = {k: v.cpu().numpy() for k, v in res.items()}
    for k, want in outs["cpu"].items():
        got = outs["cuda"][k]
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        print(f"[reference] {k} {want.shape}: max_abs_err {err:.3g} (scale {scale:.3g})", flush=True)
        check(got.shape == want.shape and np.all(np.isfinite(got)), f"{k}: bad GPU output")
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * scale)


def main_path_phase(S, torch, np):
    """The serving slice at full width; returns the stem launches."""
    from adas_tpu_torch.perception.lane_detector import LaneModelType, UltrafastLaneDetectorV2
    from adas_tpu_torch.perception.object_detector import YoloDetector
    from adas_tpu_torch.pipeline.multistream import MultiStreamADAS

    n_streams, frame_hw = 8, (720, 1280)
    t0 = time.perf_counter()
    yolo = YoloDetector(
        scale="l", input_size=(640, 640), box_score=0.25, compute_dtype="bf16",
        device="cuda", seed=0,
    )
    lane = UltrafastLaneDetectorV2(
        model_type=LaneModelType.UFLDV2_CULANE, compute_dtype="bf16", device="cuda", seed=1,
    )
    ms = MultiStreamADAS(yolo, lane, n_streams, frame_hw)
    torch.cuda.synchronize()
    print(f"[main] built YOLOv8l-640 + UFLDv2-CULane bf16 in {time.perf_counter() - t0:.2f} s",
          flush=True)
    rng = np.random.default_rng(0)
    ticks = [rng.integers(0, 256, (n_streams, *frame_hw, 3), dtype=np.uint8) for _ in range(4)]
    try:
        ms.process_batch(ticks[0])  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()

        S.reset_launches()
        n_sync, n_pipe = 3, 8
        tick_ms, results = [], []
        for i in range(n_sync):
            t = time.perf_counter()
            results.append(ms.process_batch(ticks[1 + i % 3]))
            tick_ms.append((time.perf_counter() - t) * 1e3)
        after_sync = S.launches
        t = time.perf_counter()
        n = ms.serve_pipelined((ticks[i % 4] for i in range(n_pipe)), depth=3)
        pipe_s = time.perf_counter() - t
        launches = S.launches
        check(after_sync == 2 * n_sync, f"stem launches {after_sync} after {n_sync} ticks")
        check(n == n_pipe and launches == 2 * (n_sync + n_pipe),
              f"stem launches {launches} after {n_sync + n_pipe} ticks")
        print(f"[main] stem launches {launches} over {n_sync + n_pipe} ticks (2 per tick)")
        print(f"[main] process_batch per tick ms: {[round(v, 3) for v in tick_ms]} "
              f"-> {n_streams * 1e3 / np.median(tick_ms):.2f} frames/s")
        print(f"[main] serve_pipelined: {n_pipe} ticks in {pipe_s * 1e3:.1f} ms -> "
              f"{pipe_s * 1e3 / n_pipe:.3f} ms/tick, {n_streams * n_pipe / pipe_s:.2f} frames/s")

        # correctness of what comes out: the packed step output, and the
        # per-stream signals
        x = ms._prep_upload(ticks[1])
        flat = ms._step(x)
        torch.cuda.synchronize()
        check(flat.shape[0] == n_streams and bool(torch.isfinite(flat).all()),
              "packed step output not finite")
        n_dets = [len(r["objects"]) for r in results[-1]]
        check(all(k > 0 for k in n_dets), f"empty detections per stream: {n_dets}")
        for r in results[-1]:
            for o in r["objects"]:
                check(np.isfinite([o.x, o.y, o.width, o.height, o.conf]).all() and 0.25 < o.conf <= 1,
                      "bad detection")
            check(len(r["lanes_status"]) == 4, "lane status")
        print(f"[main] detections per stream (last tick): {n_dets}; lanes status "
              f"{[r['lanes_status'] for r in results[-1]][:2]}...")

        # per-stage breakdown of an unpipelined tick (host clock, synced)
        stages = {k: [] for k in ("host_prep", "upload", "device_step", "fetch", "host_analytics")}
        for i in range(3):
            f = ticks[1 + i]
            t = time.perf_counter()
            host = ms._host_prep(f)
            t1 = time.perf_counter()
            xd = torch.from_numpy(host).to("cuda")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            flat = ms._step(xd)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            hflat = flat.cpu().numpy()
            t4 = time.perf_counter()
            ms._analytics(hflat, f)
            t5 = time.perf_counter()
            for k, a, b in zip(stages, (t, t1, t2, t3, t4), (t1, t2, t3, t4, t5)):
                stages[k].append(round((b - a) * 1e3, 3))
        print(f"[main] stages ms (3 unpipelined ticks): {json.dumps(stages)}")
        print(f"[main] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    finally:
        ms.close()
    return launches


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible", file=sys.stderr)
        return 2
    from adas_tpu_torch.ops import stem as S
    from adas_tpu_torch.ops.cuda_build import BUILD_DIR, load_cuda_library

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t = time.perf_counter()
    load_cuda_library("stem")
    print(f"[build] csrc/stem.cu built in {time.perf_counter() - t:.2f} s", flush=True)
    with open(f"{BUILD_DIR}/libstem.ptxas.txt") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print(f"[build] {line.strip()}")

    max_err, ms, plain_ms = kernel_phase(S, torch)
    reference_phase(torch, np)
    launches = main_path_phase(S, torch, np)

    print(json.dumps({"kernels": [{
        "name": "stem",
        "route": "cuda",
        "source": "adas_tpu_torch/csrc/stem.cu",
        "replaces": "adas_tpu/ops/pallas_stem.py:108",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
