"""On-GPU smoke test of the PyTorch/CUDA port (``adas_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU (an H100;
the kernels are built for sm_90a):

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build the five kernels from source, one nvcc per source, all started
   together (``csrc/stem.cu``, ``csrc/int8_conv.cu``, ``csrc/block.cu``,
   ``csrc/iou.cu``, ``csrc/nms.cu``; the int8 conv and the block share
   ``csrc/int8_epilogue.cuh``), and print their ptxas register, shared
   memory and spill lines;
3. each kernel against its plain PyTorch version, beside its bound (the
   longer of its bytes at 3.35 TB/s and its operations at the data-sheet
   peak of their type) and, where one PyTorch call computes the same
   function, that call's time.  The kernel and the library call are timed
   as device time (calls captured in a CUDA graph, one replay between
   CUDA events); the plain version as eager calls between CUDA events:
   * the stem at both serving shapes — YOLOv8 3x3/2 + SiLU on
     8x3x640x640 and ResNet 7x7/2 + ReLU + max pool on 8x3x320x1600 — in
     bf16 (atol = rtol = 1e-2; yardstick: cuDNN ``F.conv2d`` in bf16 with
     the BN folded into its weight and bias) and in f32 with TF32 off
     (atol 2e-4, rtol 1e-4);
   * the int8 conv at the TPU conv kernel's four shapes (3x3/s1 at
     8x160x160x64->64, 8x80x400x64->64, 8x80x80x128->128,
     8x40x40x256->256) plus the path's 3x3/s2 down1 (8x320x320x64->128)
     and a 1x1 (8x80x80x256->256), with s8 output (at most 1 LSB apart on
     fewer than 0.5% of the elements) and bf16 output (within one bf16
     ulp, or 1e-30); yardstick: ``torch._int_mm`` on the same implicit
     GEMM, its im2col operand made outside the timed window;
   * the fused block at its two serving shapes, 8x160x160x64 (SiLU, SiLU,
     residual) and 8x80x400x64 (ReLU, -, residual, ReLU), equal to the bit
     (0 LSB), beside the unfused pair the nets run without the fusion gate
     (two int8 conv launches, the residual and the requantize, device
     time); no one PyTorch call computes the block (``library_ms`` null);
   * the pairwise-IoU kernel in both modes at the serving shape (8
     streams x the 512 boxes of the NMS top-k), ``plus_one`` both ways,
     and at N = 300 and N = 1: the matrix against ``pairwise_iou``, equal
     to the bit, or at worst atol = rtol = 1e-6
     (``tests/test_pallas_iou.py:20``); the mask (IoU > 0.45) against
     ``iou_mask_reference``, 0 bits apart; both timed;
   * the selection kernels at (8, 512), 100 picks, score threshold
     0.001, ``plus_one``: the walk (hard, IoU 0.45 and 0.5, on the mask)
     against the plain walk and the plain scan, and the rescoring scan
     (hard at 0.45 and 0.5, linear, gaussian, on the matrix) against the
     plain scan: identical index tensors; then the served pair
     (``select_loop`` hard: mask + walk) beside the matrix + scan route,
     and an empty kernel through the same timer (the floor of a launch
     in a graph replay);
4. the full-width nets on a small input against the CPU:
   * f32: the port's preprocess and the three nets (YOLOv8l, UFLDv2 with a
     ResNet-18 trunk, EfficientDet-D0 at 128x128 behind the BGR-plane
     preprocess) on the GPU against the same on the CPU (the plain
     stem), rtol 1e-3 with an atol of 1e-3 of the output's largest
     magnitude;
   * int8: YOLOv8l at 320x320 and UFLDv2 (ResNet-18) at 160x640, so that
     both nets' fused bodies pass the gate, packed and calibrated on the
     CPU from two inputs, then moved to the GPU with their scales: the GPU
     kernels against the CPU plain versions, relative L2 error per output
     below 2e-2 for YOLOv8l and 3e-2 for UFLDv2.  The int8 kernels agree
     with their plain versions to the bit at these sizes; the 7x7 stem
     kernel sums in another order than cuDNN's f32 conv, a bf16 output
     moves by one ulp here and there, and the random-weight int8 trunk
     carries that to ~2.4% at the lane outputs (the JAX-vs-port module
     test sees the same from the two frameworks' stems);
5. the int8 main path: YOLOv8l-640 + UFLDv2-CULane, int8, seeded random
   weights, calibrated on the card with the port's calibrator from two
   720x1280 frames, 8 streams of 720x1280 frames over I420 transport.
   First, outside the counted run, one step records every int8 conv call
   by shape; each distinct shape is held against the plain version (as
   in phase 3) and timed beside ``torch._int_mm``, its bound and its
   calls per tick (``[int8-shapes]`` lines, with per-tick sums).  Then
   ``process_batch`` ticks and ``serve_pipelined`` ticks.  Every launch
   count is reset just before and must grow, per tick, by exactly 2 (stem),
   5 (block: YOLOv8l stage1's three bottlenecks, ResNet layer1's two
   blocks), the number of int8 convs the module tree holds outside the
   fused bodies (int8 conv), and 1 each for the IoU kernel (mask mode)
   and the walk of the NMS (hard suppression); outputs must be finite and detections non-empty.  Prints
   per-tick times, a per-stage breakdown, the device step alone and peak
   memory;
6. the EfficientDet main path: EfficientDet-D0 at its paper size (512,
   B0 trunk, 64-channel BiFPN x 3, heads x 3, 80 classes, f32) +
   UFLDv2-CULane bf16, seeded random weights, the same 8 streams; per
   tick stem 1 (the lane stem), IoU 1, walk 1.  The seeded trunk forgets
   its input and every class probability sits a few 1e-6 above 0.5, so
   ``box_score`` is 0.5 here (the facade's default, 0.6, passes nothing);
7. the bf16 main path of the YOLOv8l configuration (fewer ticks), stem 2,
   IoU 1 and walk 1 per tick;
8. the single-frame path in int8 (``[frame-int8]``): ``ADASPipeline`` with
   YOLOv8l-640 + UFLDv2-CULane on the card, one pipeline per route (fused,
   the default, and unfused: object -> tracker -> lane) from the same
   seeds, each calibrated from the same two 720p frames (the two routes'
   weights and scales must be equal); 10 seeded 720x1280 frames through
   ``process_frame(draw=False)`` on each route after a warm-up frame.
   Per frame exactly 2 stem, 105 int8 conv (the module tree's count), 5
   block, 1 IoU and 1 walk launches; every frame's detections non-empty
   and finite; the fused route's detections and lanes equal to the
   unfused route's; the bird-view warp on the card within one level of
   the plain CPU warp, with the pageable upload, the warp and the fetch
   timed; the i420 fused step on one frame against stream 0 of a
   ``MultiStreamADAS`` tick holding it (counts within 2, at least 90%
   matched: same label, IoU > 0.9, confidence within 0.01).  Prints the
   per-frame and per-stage times (p50, p95).  Then every kernel at the
   path's batch-1 shapes against its plain version, beside its bound and
   the library call (``[frame-kernel]`` lines; the int8 conv over every
   distinct shape of the frame, ``[frame-int8-shapes]``);
9. the same path in bf16 (``[frame-bf16]``): stem 2, IoU 1, walk 1 per
   frame.

Then the card's name and power limit again, one JSON line describing
the kernels — ``launches`` summed over the five paths, each counted
from 0 just before it; ``max_abs_err``, ``ms``, ``plain_ms``,
``library_ms`` (null where no PyTorch call computes the function) and the
bound (``bound_ms``, ``bound_by``) from phase 3 (stem: bf16, summed over
its two serving shapes; int8 conv: s8 output, the largest error in LSB,
summed over its six shapes; block: the same over its two shapes, plus
``unfused_ms``, the unfused pair's time summed the same way; IoU: the
largest matrix error or count of differing mask bits over its shapes,
the rest the served mask mode at (8, 512) with ``plus_one``, plus
``matrix_ms`` and ``matrix_bound_ms`` of the matrix mode; nms: the number
of differing indices over both kernels, the rest the served walk, hard at
IoU 0.45, its bound counting this run's picks, plus ``scan_ms``, the
rescoring scan on the same call; and from phase 8 the launches per frame
and the kernel's batch-1 time, bound and library time, summed per frame
as above: ``launches_per_frame``, ``batch1_ms``, ``batch1_bound_ms``,
``batch1_library_ms``) — and last ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, when no CUDA GPU is visible.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

KERNELS = ("stem", "int8_conv", "block", "iou", "nms")
N_STREAMS, FRAME_HW = 8, (720, 1280)
BLOCKS_PER_TICK = 5
#: keys of the kernels line beyond the contract's
EXTRA_KEYS = ("unfused_ms", "matrix_ms", "matrix_bound_ms", "scan_ms")
#: EfficientDet's box score on seeded weights (see phase 6)
EFFDET_BOX_SCORE = 0.5
#: one H100 SXM's dense peaks (operations/s by type) and memory rate
#: (bytes/s), NVIDIA's data sheet, at the full 700 W power limit: the
#: bounds of the kernel lines; a card set below 700 W runs under them
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def bound(nbytes: float, ops: float, kind: str):
    """(least ms, what sets it) for work that moves ``nbytes`` (each input
    read once, each output written once) and does ``ops`` operations of
    ``kind``: the longer of the two at the card's peak rates."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def total_bound(parts):
    """Sum of several shapes' bounds; what sets the larger share of it."""
    ms = sum(b for b, _ in parts)
    share = {}
    for b, by in parts:
        share[by] = share.get(by, 0.0) + b
    return ms, max(share, key=share.get)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def fmt_bound(b, ms: float) -> str:
    return f"bound {b[0]:.4f} ms ({b[1]}), {100 * b[0] / ms:.1f}% of bound"


def device_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()``: ``iters`` calls captured in one CUDA
    graph, then one replay between two CUDA events, so the host's cost of
    each call (the wrapper, the launch) is not counted; after warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()  # the first replay uploads the graph
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms(fn, iters: int) -> float:
    """Mean time of ``fn()`` over ``iters`` back-to-back eager calls between
    two CUDA events, after warm-up (the host's cost of each call counts
    where it exceeds the device's)."""
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


def stem_case(S, torch, gen, name, shape, k, act, pool, dtype, atol, rtol):
    """One stem site: the kernel against ``stem_reference`` (fails beyond
    ``atol``/``rtol``), its device time, the plain version's, its bound
    and, in bf16, cuDNN's ``F.conv2d`` with the BN folded into its weight
    and bias (the conv + BN in one call, full-resolution output); prints
    a ``[kernel]`` line and returns (err, ms, plain_ms, library_ms, bound)."""
    import torch.nn.functional as F

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
    ms = device_ms(lambda: S.fused_stem(x, w, gain, bias, **args), 20)
    eager_ms = cuda_ms(lambda: S.fused_stem(x, w, gain, bias, **args), 20)
    plain_ms = cuda_ms(lambda: S.stem_reference(x, w, gain, bias, **args), 20)
    hc, wc = S.stem_out_hw(shape[2], shape[3], False)
    b = bound(nbytes(x, w, gain, bias, got), 2 * shape[0] * 64 * hc * wc * 3 * k * k,
              "bf16" if dtype == torch.bfloat16 else "f32")
    line = (f"[kernel] {name} {str(dtype)[6:]} {tuple(shape)} -> {tuple(got.shape)}: "
            f"max_abs_err {err:.6g} (atol {atol}, rtol {rtol}) kernel {ms:.4f} ms "
            f"(eager {eager_ms:.4f}), "
            f"plain {plain_ms:.4f} ms, {fmt_bound(b, ms)}")
    lib_ms = None
    if dtype == torch.bfloat16:
        wf = (w.float() * gain.view(-1, 1, 1, 1)).to(dtype)
        bf = bias.to(dtype)
        lib_ms = device_ms(lambda: F.conv2d(x, wf, bf, stride=2, padding=k // 2), 20)
        line += f", cuDNN conv2d + folded BN {lib_ms:.4f} ms"
    print(line, flush=True)
    check(ok, f"{name} {dtype}: kernel disagrees with stem_reference (max abs err {err})")
    return err, ms, plain_ms, lib_ms, b


#: the stem's two sites: (name, input shape at batch 1, k, act, pool)
STEM_SITES = (
    ("yolo_stem_k3_silu", (1, 3, 640, 640), 3, "silu", False),
    ("resnet_stem_k7_relu_pool", (1, 3, 320, 1600), 7, "relu", True),
)


def kernel_phase(S, torch):
    """Stem kernel vs stem_reference at the two serving shapes, in bf16
    and f32 (see :func:`stem_case`)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype, atol, rtol in ((torch.bfloat16, 1e-2, 1e-2), (torch.float32, 2e-4, 1e-4)):
        for name, shape, k, act, pool in STEM_SITES:
            err, ms, plain_ms, lib_ms, b = stem_case(
                S, torch, gen, name, (N_STREAMS, *shape[1:]), k, act, pool, dtype, atol, rtol)
            rows.append((dtype, err, ms, plain_ms, lib_ms, b))
    bf16 = [r for r in rows if r[0] == torch.bfloat16]
    return {
        "max_abs_err": max(r[1] for r in bf16), "ms": sum(r[2] for r in bf16),
        "plain_ms": sum(r[3] for r in bf16), "library_ms": sum(r[4] for r in bf16),
        "bound": total_bound([r[5] for r in bf16]),
    }


def s8_diff(got, want):
    """(max |diff| in LSB, share of differing elements) of two s8 tensors."""
    d = (got.int() - want.int()).abs()
    return int(d.max().item()), float((d != 0).float().mean().item())


def conv_operands(gen, shape, pitch, cout, k, torch, bias=True):
    """Random s8 input (a channel slice when ``pitch`` > Cin) and weights,
    and an f32 epilogue that keeps |y| at a few units."""
    n, h, w, cin = shape
    xq = torch.randint(-127, 128, (n, h, w, pitch), generator=gen, device="cuda",
                       dtype=torch.int8)[..., :cin]
    wq = torch.randint(-127, 128, (cout, k, k, cin), generator=gen, device="cuda",
                       dtype=torch.int8)
    scale = (torch.rand(cout, generator=gen, device="cuda") * 0.5 + 0.75) * 5e-4 / (k * k * cin) ** 0.5
    b = torch.randn(cout, generator=gen, device="cuda") * 0.5 if bias else None
    return xq, wq, scale, b


def conv_against_plain(IC, torch, args, kw):
    """The kernel against int8_conv_reference on ``args``: s8 at most 1
    LSB on fewer than 0.5% of the elements, bf16 within one ulp (or
    1e-30); returns (kernel output, error: LSB for s8, absolute for bf16)."""
    got = IC.int8_conv(*args, **kw)
    want = IC.int8_conv_reference(*args, **kw)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype, "int8 conv shape/dtype")
    if kw.get("out_scale") is not None:
        lsb, share = s8_diff(got, want)
        check(lsb <= 1 and share < 5e-3, f"int8 conv s8 disagrees: {lsb} LSB on {share:.2e}")
        return got, lsb
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    check(bool(torch.all((g - w).abs() <= w.abs() * 2.0 ** -7 + 1e-30)),
          f"int8 conv bf16 disagrees (max abs err {err})")
    return got, err


def conv_yardsticks(IC, torch, args, kw, got, stride):
    """Kernel time, ``torch._int_mm`` time on the same implicit GEMM (the
    im2col operand made outside the timed window; it computes the s32
    product, the whole conv for a 1x1) and the bound of the conv."""
    xq, wq, scale, bias = args
    k, cout = wq.shape[1], wq.shape[0]
    ms = device_ms(lambda: IC.int8_conv(*args, **kw), 20)
    cols = IC.im2col(xq, k, stride).contiguous()
    w2d = wq.reshape(cout, -1)
    lib_ms = device_ms(lambda: torch._int_mm(cols, w2d.t()), 20)
    m, kk = cols.shape
    b = bound(nbytes(xq, wq, scale, bias, kw.get("out_scale"), got), 2 * m * kk * cout, "int8")
    return ms, lib_ms, b


def unfused_pair(IC, args, kw):
    """The block as the nets run it without the fusion gate
    (``models/resnet.py:62-67``, ``models/yolo.py:99-108``): two
    ``int8_conv`` launches (s8 mid, then the second conv's bf16 output), the
    residual in f32, act_post and the requantize to s8."""
    xq, sx, w1q, s1, b1, sm, w2q, s2, b2, so = args
    mid = IC.int8_conv(xq, w1q, s1, b1, stride=1, act=kw["act1"], out_scale=sm)
    y = IC.int8_conv(mid, w2q, s2, b2, stride=1, act=kw["act2"]).float()
    if kw["residual"]:
        y = y + xq.float() * sx
    return IC.requantize(IC.activation(y, kw["act_post"]), so)


#: the fused block's two sites: (name, input shape at batch 1, activations)
BLOCK_SITES = (
    ("yolo_stage1", (1, 160, 160, 64), ("silu", "silu", None)),
    ("resnet_layer1", (1, 80, 400, 64), ("relu", None, "relu")),
)


def block_case(IC, B, torch, gen, name, shape, acts):
    """One block site: the kernel against ``block_reference`` to the bit,
    its device time, the plain version's, the unfused pair's and its
    bound; prints a ``[kernel]`` line and returns (LSB, ms, plain_ms,
    unfused_ms, bound)."""
    def s8(shape, lo=-127, hi=128):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=torch.int8)

    c = shape[3]
    xq = s8(shape, -100, 100)
    w1q, w2q = s8((c, 3, 3, c), -80, 80), s8((c, 3, 3, c), -80, 80)
    s1 = torch.rand(c, generator=gen, device="cuda") * 2e-4 + 1e-4
    s2 = torch.rand(c, generator=gen, device="cuda") * 2e-4 + 1e-4
    b1 = torch.randn(c, generator=gen, device="cuda") * 0.2
    b2 = torch.randn(c, generator=gen, device="cuda") * 0.2
    sx, sm, so = (torch.tensor(v, device="cuda") for v in (0.021, 0.034, 0.027))
    args = (xq, sx, w1q, s1, b1, sm, w2q, s2, b2, so)
    kw = dict(act1=acts[0], act2=acts[1], act_post=acts[2], residual=True)
    got = B.fused_block(*args, **kw)
    want = B.block_reference(*args, **kw)
    torch.cuda.synchronize()
    lsb, share = s8_diff(got, want)
    ms = device_ms(lambda: B.fused_block(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: B.block_reference(*args, **kw), 5)
    unfused_ms = device_ms(lambda: unfused_pair(IC, args, kw), 20)
    b = bound(nbytes(*args, got), 2 * 2 * xq[..., 0].numel() * 9 * c * c, "int8")
    print(f"[kernel] block {name} {shape} {acts}: max diff {lsb} LSB on {share:.2e} of "
          f"elements; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, unfused pair (two "
          f"int8_conv + residual + requantize) {unfused_ms:.4f} ms, {fmt_bound(b, ms)}",
          flush=True)
    check(lsb == 0, f"block {name} disagrees with block_reference ({lsb} LSB on {share:.2e})")
    return lsb, ms, plain_ms, unfused_ms, b


def int8_kernel_phase(IC, B, torch):
    """The int8 conv and the fused block against their plain versions at
    the path's shapes; returns {kernel: row of the kernels line}."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    conv_sites = (
        # (name, (n, h, w, cin), cout, k, stride, act)
        ("stage1_3x3", (8, 160, 160, 64), 64, 3, 1, "silu"),
        ("layer1_3x3", (8, 80, 400, 64), 64, 3, 1, "relu"),
        ("stage2_3x3", (8, 80, 80, 128), 128, 3, 1, "silu"),
        ("stage3_3x3", (8, 40, 40, 256), 256, 3, 1, "silu"),
        ("down1_3x3s2", (8, 320, 320, 64), 128, 3, 2, "silu"),
        ("stage2_cv1_1x1", (8, 80, 80, 256), 256, 1, 1, "silu"),
    )
    conv = {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bounds": []}
    for name, shape, cout, k, stride, act in conv_sites:
        args = conv_operands(gen, shape, shape[3], cout, k, torch)
        for out_scale in (torch.tensor(0.05, device="cuda"), None):
            kw = dict(stride=stride, act=act, out_scale=out_scale)
            got, err = conv_against_plain(IC, torch, args, kw)
            if out_scale is None:
                print(f"[kernel] int8_conv {name} bf16: max_abs_err {err:.4g} (one bf16 ulp)",
                      flush=True)
                continue
            ms, lib_ms, b = conv_yardsticks(IC, torch, args, kw, got, stride)
            plain_ms = cuda_ms(lambda: IC.int8_conv_reference(*args, **kw), 5)
            eager_ms = cuda_ms(lambda: IC.int8_conv(*args, **kw), 20)
            print(f"[kernel] int8_conv {name} {shape}->{cout} k{k}/s{stride} {act} s8: "
                  f"max diff {err} LSB; kernel {ms:.4f} ms (eager {eager_ms:.4f}), "
                  f"plain {plain_ms:.4f} ms, "
                  f"torch._int_mm {lib_ms:.4f} ms, {fmt_bound(b, ms)}", flush=True)
            conv["max_abs_err"] = max(conv["max_abs_err"], err)
            conv["ms"] += ms
            conv["plain_ms"] += plain_ms
            conv["library_ms"] += lib_ms
            conv["bounds"].append(b)
    conv["bound"] = total_bound(conv.pop("bounds"))

    block = {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None,
             "unfused_ms": 0.0, "bounds": []}
    for name, shape, acts in BLOCK_SITES:
        lsb, ms, plain_ms, unfused_ms, b = block_case(
            IC, B, torch, gen, name, (N_STREAMS, *shape[1:]), acts)
        block["max_abs_err"] = max(block["max_abs_err"], lsb)
        block["ms"] += ms
        block["plain_ms"] += plain_ms
        block["unfused_ms"] += unfused_ms
        block["bounds"].append(b)
    block["bound"] = total_bound(block.pop("bounds"))
    return {"int8_conv": conv, "block": block}


def nms_inputs(gen, b, n, torch):
    """(B, N, 4) clustered xyxy boxes in a 512x512 frame and (B, N) scores
    sorted descending, as the NMS top-k hands them over."""
    centers = torch.rand(b, 6, 2, generator=gen, device="cuda") * 400 + 56
    pick = torch.randint(0, 6, (b, n), generator=gen, device="cuda")
    c = torch.gather(centers, 1, pick[..., None].expand(-1, -1, 2))
    c = c + torch.randn(b, n, 2, generator=gen, device="cuda") * 12
    wh = torch.rand(b, n, 2, generator=gen, device="cuda") * 80 + 10
    boxes = torch.cat([c - wh / 2, c + wh / 2], dim=-1).contiguous()
    scores = torch.rand(b, n, generator=gen, device="cuda").sort(dim=1, descending=True)[0]
    return boxes, scores.contiguous()


def nms_kernel_phase(I, S, torch):
    """The IoU kernel's two modes and the two selection kernels against
    their plain versions, and the served pair; returns {kernel: row of the
    kernels line}, the served variants (mask mode, walk) with the matrix
    mode's and the scan's times beside them.  Neither kernel has a one-call
    PyTorch counterpart (``library_ms`` null)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    iou_err, iou_row = 0.0, {}
    for b, n, plus_one in ((8, 512, True), (8, 512, False), (8, 300, True), (8, 1, True)):
        boxes, _ = nms_inputs(gen, b, n, torch)
        got = I.iou_matrix(boxes, plus_one=plus_one)
        want = I.iou_matrix_reference(boxes, plus_one=plus_one)
        got_m = I.iou_mask(boxes, 0.45, plus_one=plus_one)
        want_m = I.iou_mask_reference(boxes, 0.45, plus_one=plus_one)
        torch.cuda.synchronize()
        check(got.shape == want.shape == (b, n, n), f"iou {b}x{n}: shape {tuple(got.shape)}")
        check(got_m.shape == want_m.shape == (b, n, (n + 31) // 32),
              f"iou mask {b}x{n}: shape {tuple(got_m.shape)}")
        err = (got - want).abs().max().item()
        n_diff = int((got != want).sum().item())
        bits = int(I.unpack_bits(got_m ^ want_m, n).sum().item())
        line = f"[kernel] iou ({b}, {n}, 4) plus_one={plus_one}: matrix {n_diff} elements " \
               f"differ, max_abs_err {err:.3g} (0 ulp, at worst atol = rtol = 1e-6); mask " \
               f"(IoU > 0.45) {bits} bits differ (0)"
        if (n, plus_one) == (512, True):
            ms = device_ms(lambda: I.iou_mask(boxes, 0.45, plus_one=True), 50)
            plain_ms = cuda_ms(lambda: I.iou_mask_reference(boxes, 0.45, plus_one=True), 50)
            matrix_ms = device_ms(lambda: I.iou_matrix(boxes, plus_one=True), 50)
            matrix_plain_ms = cuda_ms(lambda: I.iou_matrix_reference(boxes, plus_one=True), 50)
            # per pair: 4 min/max, 4 subtractions (+2 with plus_one), 2 clamps,
            # the intersection product, the union's two adds and the
            # division; the mask mode adds the comparison
            bd = bound(nbytes(boxes, got_m), 16 * b * n * n, "f32")
            matrix_bd = bound(nbytes(boxes, got), 15 * b * n * n, "f32")
            line += (f"; mask kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, {fmt_bound(bd, ms)}; "
                     f"matrix kernel {matrix_ms:.4f} ms, plain {matrix_plain_ms:.4f} ms, "
                     f"{fmt_bound(matrix_bd, matrix_ms)}")
            iou_row = {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound": bd,
                       "matrix_ms": matrix_ms, "matrix_bound_ms": matrix_bd[0]}
        print(line, flush=True)
        check(torch.allclose(got, want, atol=1e-6, rtol=1e-6), f"iou {b}x{n}: kernel disagrees")
        check(bits == 0, f"iou mask {b}x{n}: {bits} bits differ from iou_mask_reference")
        iou_err = max(iou_err, err, bits)
    rows = {"iou": {"max_abs_err": iou_err, **iou_row}}

    boxes, scores = nms_inputs(gen, 8, 512, torch)
    n = boxes.shape[1]
    n_diff, serving = 0, {}
    for iou_t in (0.45, 0.5):  # hard suppression, as served: the mask and the walk
        mask = I.iou_mask(boxes, iou_t, plus_one=True)
        args = (mask, scores, 100, 0.001)
        got = S.nms_walk(*args)
        want = S.nms_walk_reference(*args)
        scan_want = S.nms_scan_reference(I.iou_matrix_reference(boxes, plus_one=True), scores,
                                         iou_t, 100, 0, 0.5, 0.001)
        torch.cuda.synchronize()
        diff = int((got != want).sum().item()) + int((got != scan_want).sum().item())
        ms = device_ms(lambda: S.nms_walk(*args), 20)
        plain_ms = cuda_ms(lambda: S.nms_walk_reference(*args), 5)
        picks = int((got >= 0).sum())
        # what this run's picks need: each pick reads its mask row (N/32
        # words) and ORs it into the removed set; the scores in, the
        # indices out
        words = mask.shape[-1]
        bd = bound(picks * words * 4 + nbytes(scores, got), picks * words, "f32")
        print(f"[kernel] nms walk (hard, mask) iou {iou_t} (8, 512) -> {tuple(got.shape)}: "
              f"{diff} indices differ from the plain walk and scan, {picks} picks; kernel "
              f"{ms:.4f} ms, plain walk {plain_ms:.4f} ms, {fmt_bound(bd, ms)}", flush=True)
        check(got.shape == want.shape and diff == 0, f"nms walk {iou_t}: kernel disagrees")
        check(picks > 0, "nms walk: nothing picked")
        n_diff += diff
        if iou_t == 0.45:
            serving = {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound": bd}
    for method, iou_t, name in ((0, 0.45, "hard"), (0, 0.5, "hard"), (1, 0.45, "linear"),
                                (2, 0.45, "gaussian")):
        iou = I.iou_matrix(boxes, plus_one=True)
        args = (iou, scores, iou_t, 100, method, 0.5, 0.001)
        got = S.nms_scan(*args)
        want = S.nms_scan_reference(*args)
        torch.cuda.synchronize()
        diff = int((got != want).sum().item())
        ms = device_ms(lambda: S.nms_scan(*args), 20)
        plain_ms = cuda_ms(lambda: S.nms_scan_reference(*args), 5)
        picks = int((got >= 0).sum())
        # what this run's picks need: each pick reads one IoU row and
        # compares, masks and rescores every candidate of its stream
        bd = bound(picks * n * 4 + nbytes(scores, got), 4 * picks * n, "f32")
        print(f"[kernel] nms scan (rescoring, matrix) {name} iou {iou_t} (8, 512) -> "
              f"{tuple(got.shape)}: {diff} indices differ, {picks} picks; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, {fmt_bound(bd, ms)}", flush=True)
        check(got.shape == want.shape and diff == 0, f"nms {name} {iou_t}: kernel disagrees")
        check(picks > 0, f"nms {name}: nothing picked")
        n_diff += diff
        if (method, iou_t) == (0, 0.45):
            serving["scan_ms"] = ms

    # the served pair as select_and_nms calls it, against the matrix route
    pair_ms = device_ms(lambda: S.select_loop(boxes, scores, 0.45, 100, 0, 0.5, 0.001, True), 20)
    old_pair_ms = device_ms(lambda: S.nms_scan(I.iou_matrix(boxes, plus_one=True), scores, 0.45,
                                               100, 0, 0.5, 0.001), 20)
    pair_bd = rows["iou"]["bound"][0] + serving["bound"][0]
    print(f"[kernel] served pair select_loop hard iou 0.45 (8, 512): mask + walk {pair_ms:.4f} "
          f"ms (bound {pair_bd:.4f} ms); matrix + scan {old_pair_ms:.4f} ms", flush=True)
    # the latency floor of one launch in a graph replay, which the scan's
    # and the walk's bytes bounds cannot show
    empty_ms = device_ms(lambda: torch.cuda._sleep(0), 50)
    print(f"[kernel] empty kernel (torch.cuda._sleep(0), one thread) through device_ms: "
          f"{empty_ms:.4f} ms per launch", flush=True)
    rows["nms"] = {"max_abs_err": n_diff, **serving}
    return rows


def reference_phase(torch, np):
    """The full-width nets and preprocess in f32 on the GPU vs the CPU."""
    from adas_tpu_torch.models import ufld
    from adas_tpu_torch.models.efficientdet import EfficientDet, EfficientDetSpec
    from adas_tpu_torch.models.layers import consume_stem
    from adas_tpu_torch.models.ufld import LaneModelType, UFLDv2Net
    from adas_tpu_torch.models.yolo import YoloSpec, YoloV8
    from adas_tpu_torch.ops.preprocess import (
        LetterboxGeometry,
        bgr_to_i420,
        i420_to_bgr_planar,
        imagenet_preprocess_planar,
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
    enet = EfficientDet(EfficientDetSpec(compound=0, num_classes=80))
    init_params(ynet, 3)  # on the CPU: one set of weights for both sides
    init_params(lnet, 4)
    init_params(enet, 5)
    outs = {}
    for dev in ("cpu", "cuda"):
        ynet, lnet, enet = ynet.to(dev), lnet.to(dev), enet.to(dev)
        x = yuv.to(dev)
        with torch.inference_mode():
            xy = yolo_preprocess_yuv(x, h, w, LetterboxGeometry(h, w, 160, 160))
            xl = ufld_v2_preprocess_yuv(x, h, w, 64, 160, lspec.crop_ratio)
            xe = imagenet_preprocess_planar(
                i420_to_bgr_planar(x, h, w), LetterboxGeometry(h, w, 128, 128)
            )
            res = {
                "yolo_in": xy, "lane_in": xl, "effdet_in": xe,
                "yolo_stem": ynet.net.stem(xy),
                "lane_stem": consume_stem(
                    xl, lnet.backbone.conv1, lnet.backbone.bn1, act="relu", pool=True
                ),
                "yolo_raw": ynet.eval()(xy),
            }
            res.update({f"lane_{k}": v for k, v in lnet.eval()(xl).items()})
            res.update(zip(("effdet_c3", "effdet_c4", "effdet_c5"), enet.eval().backbone(xe)))
            res.update(zip(("effdet_boxes", "effdet_probs"), enet(xe)))
        outs[dev] = {k: v.cpu().numpy() for k, v in res.items()}
    for k, want in outs["cpu"].items():
        got = outs["cuda"][k]
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        print(f"[reference] {k} {want.shape}: max_abs_err {err:.3g} (scale {scale:.3g})", flush=True)
        check(got.shape == want.shape and np.all(np.isfinite(got)), f"{k}: bad GPU output")
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * scale)


def int8_reference_phase(torch, np, IC, B):
    """Full-width int8 nets, packed and calibrated on the CPU, then the GPU
    kernels against the CPU plain versions on the same input."""
    from adas_tpu_torch.models import ufld
    from adas_tpu_torch.models.quant import pack_int8_weights
    from adas_tpu_torch.models.ufld import LaneModelType, UFLDv2Net
    from adas_tpu_torch.models.yolo import YoloSpec, YoloV8
    from adas_tpu_torch.perception.object_detector import calibrate
    from adas_tpu_torch.weights import init_params

    lspec = ufld.UFLDV2_SPECS[LaneModelType.UFLDV2_CULANE]
    lane_spec = ufld.UFLDv2Spec(160, 640, lspec.crop_ratio, 20, 72, 10, 16, mlp_mid=64)
    rng = np.random.default_rng(5)
    xy = torch.from_numpy(rng.uniform(0, 1, (2, 3, 320, 320)).astype(np.float32))
    xl = torch.from_numpy(rng.standard_normal((2, 3, 160, 640)).astype(np.float32))
    nets = {"yolo": (YoloV8(YoloSpec("l", 80, (320, 320)), int8=True), xy),
            "lane": (UFLDv2Net(lane_spec, int8=True), xl)}
    t = time.perf_counter()
    for seed, (net, x) in enumerate(nets.values()):
        init_params(net, 10 + seed)
        net.eval().requires_grad_(False)
        pack_int8_weights(net)
        calibrate(net, [x[:1], x[1:]])
    print(f"[int8-reference] packed and calibrated YOLOv8l-320 + UFLDv2-160x640 on the CPU "
          f"in {time.perf_counter() - t:.1f} s", flush=True)
    outs = {}
    for dev in ("cpu", "cuda"):
        IC.reset_launches()
        B.reset_launches()
        res = {}
        with torch.inference_mode():
            for name, (net, x) in nets.items():
                net.to(dev)
                y = net(x.to(dev, torch.bfloat16))
                for k, v in (y.items() if isinstance(y, dict) else [("raw", y)]):
                    res[f"{name}_{k}"] = v.float().cpu().numpy()
        outs[dev] = res
        if dev == "cuda":
            print(f"[int8-reference] GPU launches: int8_conv {IC.launches}, block {B.launches}")
            check(IC.launches > 0 and B.launches == BLOCKS_PER_TICK,
                  "int8 reference run did not go through the kernels")
    for k, want in outs["cpu"].items():
        got = outs["cuda"][k]
        check(got.shape == want.shape and np.all(np.isfinite(got)), f"{k}: bad GPU output")
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        bound = 2e-2 if k.startswith("yolo") else 3e-2
        print(f"[int8-reference] {k} {want.shape}: relative L2 error {rel:.3g} (bound {bound})",
              flush=True)
        check(rel < bound, f"int8 {k}: GPU kernels and CPU plain versions disagree ({rel})")


def counts(mods):
    return {k: m.launches for k, m in mods.items()}


def reset(mods):
    for m in mods.values():
        m.reset_launches()


def stage_breakdown(ms, ticks, torch):
    """Per-stage times of three unpipelined ticks (host clock, synced)."""
    stages = {k: [] for k in ("host_prep", "upload", "device_step", "fetch", "host_analytics")}
    for f in ticks[1:4]:
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
    return stages


def serve(tag, ms, mods, per_tick, ticks, n_sync, n_pipe, torch, np):
    """process_batch and serve_pipelined ticks with exact per-tick launch
    counts (every count is set to 0 just before); returns the counts of
    the whole run."""
    ms.process_batch(ticks[0])  # warm-up: allocator, plans
    torch.cuda.synchronize()
    reset(mods)
    tick_ms, results = [], []
    for i in range(n_sync):
        t = time.perf_counter()
        results.append(ms.process_batch(ticks[1 + i % 3]))
        tick_ms.append((time.perf_counter() - t) * 1e3)
    after_sync = counts(mods)
    t = time.perf_counter()
    n = ms.serve_pipelined((ticks[i % 4] for i in range(n_pipe)), depth=3)
    pipe_s = time.perf_counter() - t
    run = counts(mods)
    check(n == n_pipe, "serve_pipelined tick count")
    for k, per in per_tick.items():
        check(after_sync[k] == per * n_sync, f"{tag}: {k} launches {after_sync[k]} after "
                                             f"{n_sync} ticks, expected {per} per tick")
        check(run[k] == per * (n_sync + n_pipe), f"{tag}: {k} launches {run[k]} after "
                                                 f"{n_sync + n_pipe} ticks")
    print(f"[{tag}] launches over {n_sync + n_pipe} ticks: {run} (per tick {per_tick})")
    print(f"[{tag}] process_batch per tick ms: {[round(v, 3) for v in tick_ms]} -> "
          f"{N_STREAMS * 1e3 / np.median(tick_ms):.2f} frames/s")
    print(f"[{tag}] serve_pipelined: {n_pipe} ticks in {pipe_s * 1e3:.1f} ms -> "
          f"{pipe_s * 1e3 / n_pipe:.3f} ms/tick, {N_STREAMS * n_pipe / pipe_s:.2f} frames/s")

    x = ms._prep_upload(ticks[1])
    flat = ms._step(x)
    torch.cuda.synchronize()
    check(flat.shape[0] == N_STREAMS and bool(torch.isfinite(flat).all()),
          "packed step output not finite")
    n_dets = [len(r["objects"]) for r in results[-1]]
    check(all(k > 0 for k in n_dets), f"empty detections per stream: {n_dets}")
    for r in results[-1]:
        for o in r["objects"]:
            check(np.isfinite([o.x, o.y, o.width, o.height, o.conf]).all()
                  and ms.yolo.box_score < o.conf <= 1, "bad detection")
        check(len(r["lanes_status"]) == 4, "lane status")
    print(f"[{tag}] detections per stream (last tick): {n_dets}; lanes status "
          f"{[r['lanes_status'] for r in results[-1]][:2]}...")
    print(f"[{tag}] stages ms (3 unpipelined ticks): {json.dumps(stage_breakdown(ms, ticks, torch))}")
    step_ms = cuda_ms(lambda: ms._step(x), 10)
    print(f"[{tag}] device step alone (back-to-back, CUDA events): {step_ms:.3f} ms")
    print(f"[{tag}] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    return run


def build_main(compute_dtype, torch):
    from adas_tpu_torch.perception.lane_detector import LaneModelType, UltrafastLaneDetectorV2
    from adas_tpu_torch.perception.object_detector import YoloDetector
    from adas_tpu_torch.pipeline.multistream import MultiStreamADAS

    t0 = time.perf_counter()
    yolo = YoloDetector(
        scale="l", input_size=(640, 640), box_score=0.25, compute_dtype=compute_dtype,
        device="cuda", seed=0,
    )
    lane = UltrafastLaneDetectorV2(
        model_type=LaneModelType.UFLDV2_CULANE, compute_dtype=compute_dtype, device="cuda",
        seed=1,
    )
    torch.cuda.synchronize()
    print(f"[main-{compute_dtype}] built YOLOv8l-640 + UFLDv2-CULane in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return yolo, lane, MultiStreamADAS


def main_path_conv_shapes(step, IC, torch):
    """Every int8 conv call of ``step()`` (one int8 step), by shape:
    {(input shape, channel pitch, Cout, k, stride, act, s8 output, bias):
    calls per step}, recorded at the module tree's one call site
    (``models/layers.py``'s ``int8_conv``) on a step outside the counted
    run."""
    from adas_tpu_torch.models import layers

    seen, run = {}, layers.int8_conv

    def record(xq, wq, scale, bias, *, stride, act, out_scale=None):
        key = (tuple(xq.shape), IC.channel_pitch(xq), wq.shape[0], wq.shape[1], stride, act,
               out_scale is not None, bias is not None)
        seen[key] = seen.get(key, 0) + 1
        return run(xq, wq, scale, bias, stride=stride, act=act, out_scale=out_scale)

    layers.int8_conv = record
    try:
        step()
        torch.cuda.synchronize()
    finally:
        layers.int8_conv = run
    return seen


def main_path_conv_phase(IC, shapes, torch, tag="int8-shapes", per="tick"):
    """Each distinct int8 conv shape of a path: the kernel against its
    plain version (to the bit, as at the smoke shapes), its time,
    ``torch._int_mm``'s on the same GEMM, its bound, and the sums per step
    (each shape times its calls per step); returns the sums."""
    from adas_tpu_torch.ops.cuda_build import num_sms

    gen = torch.Generator(device="cuda").manual_seed(3)
    tick = {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    slower = []
    for (shape, pitch, cout, k, stride, act, s8_out, has_bias), calls in sorted(
        shapes.items(), key=lambda kv: -kv[1] * kv[0][0][0] * kv[0][0][1] * kv[0][0][2] * kv[0][2]
    ):
        args = conv_operands(gen, shape, pitch, cout, k, torch, bias=has_bias)
        kw = dict(stride=stride, act=act,
                  out_scale=torch.tensor(0.05, device="cuda") if s8_out else None)
        got, err = conv_against_plain(IC, torch, args, kw)
        ms, lib_ms, b = conv_yardsticks(IC, torch, args, kw, got, stride)
        n, h, w, cin = shape
        ho, wo = IC.conv_out_hw(h, w, k, stride)
        tile = IC.tile_config(n * ho * wo, cout, num_sms(torch.cuda.current_device()))
        print(f"[{tag}] {n}x{h}x{w}x{cin} (pitch {pitch}) -> {cout} k{k}/s{stride} {act} "
              f"{'s8' if s8_out else 'bf16'} x{calls}/{per} tile {tile[0]}x{tile[1]}: "
              f"err {err:.3g}; kernel {ms:.4f} ms, torch._int_mm {lib_ms:.4f} ms, "
              f"{fmt_bound(b, ms)}", flush=True)
        tick["ms"] += calls * ms
        tick["library_ms"] += calls * lib_ms
        tick["bound_ms"] += calls * b[0]
        if ms > lib_ms:
            slower.append(f"{n}x{h}x{w}x{cin}->{cout} k{k}/s{stride}")
    print(f"[{tag}] per {per} over {len(shapes)} shapes, {sum(shapes.values())} launches: "
          f"kernel {tick['ms']:.4f} ms, torch._int_mm {tick['library_ms']:.4f} ms, bound "
          f"{tick['bound_ms']:.4f} ms, {100 * tick['bound_ms'] / tick['ms']:.1f}% of bound; "
          f"slower than torch._int_mm at {len(slower)} shapes: {slower}", flush=True)
    return tick


def int8_main_phase(mods, torch, np):
    """The calibrated int8 serving path at full width."""
    from adas_tpu_torch.models.quant import QConv2d

    yolo, lane, MultiStreamADAS = build_main("int8", torch)
    rng = np.random.default_rng(0)
    calib = rng.integers(0, 256, (2, *FRAME_HW, 3), dtype=np.uint8)
    t = time.perf_counter()
    yolo.calibrate_int8(list(calib))
    lane.calibrate_int8(list(calib))
    torch.cuda.synchronize()
    print(f"[main-int8] calibrated both nets on the card from 2 frames in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    n_conv = {k: sum(isinstance(m, QConv2d) for m in f.net.modules())
              for k, f in (("yolo", yolo), ("lane", lane))}
    per_conv = sum(n_conv.values()) - 2 * BLOCKS_PER_TICK
    print(f"[main-int8] module tree: {n_conv['yolo']} + {n_conv['lane']} int8 convs, "
          f"{BLOCKS_PER_TICK} fused two-conv bodies -> {per_conv} int8 conv launches per tick")
    ms = MultiStreamADAS(yolo, lane, N_STREAMS, FRAME_HW)
    ticks = [rng.integers(0, 256, (N_STREAMS, *FRAME_HW, 3), dtype=np.uint8) for _ in range(4)]
    try:
        shapes = main_path_conv_shapes(lambda: ms._step(ms._prep_upload(ticks[0])),
                                       mods["int8_conv"], torch)
        check(sum(shapes.values()) == per_conv,
              f"recorded {sum(shapes.values())} int8 convs in a step, expected {per_conv}")
        main_path_conv_phase(mods["int8_conv"], shapes, torch)
        return serve("main-int8", ms, mods,
                     {"stem": 2, "int8_conv": per_conv, "block": BLOCKS_PER_TICK,
                      "iou": 1, "nms": 1},
                     ticks, 3, 8, torch, np)
    finally:
        ms.close()


def bf16_main_phase(mods, torch, np):
    """The bf16 serving path at full width (fewer ticks)."""
    yolo, lane, MultiStreamADAS = build_main("bf16", torch)
    rng = np.random.default_rng(0)
    ms = MultiStreamADAS(yolo, lane, N_STREAMS, FRAME_HW)
    ticks = [rng.integers(0, 256, (N_STREAMS, *FRAME_HW, 3), dtype=np.uint8) for _ in range(4)]
    try:
        return serve("main-bf16", ms, mods,
                     {"stem": 2, "int8_conv": 0, "block": 0, "iou": 1, "nms": 1},
                     ticks, 2, 4, torch, np)
    finally:
        ms.close()


def effdet_main_phase(mods, torch, np):
    """EfficientDet-D0 (512, f32) + UFLDv2-CULane (bf16) on the I420 path."""
    from adas_tpu_torch.perception.efficientdet_detector import EfficientdetDetector
    from adas_tpu_torch.perception.lane_detector import LaneModelType, UltrafastLaneDetectorV2
    from adas_tpu_torch.pipeline.multistream import MultiStreamADAS

    t0 = time.perf_counter()
    det = EfficientdetDetector(compound=0, box_score=EFFDET_BOX_SCORE, device="cuda", seed=0)
    lane = UltrafastLaneDetectorV2(
        model_type=LaneModelType.UFLDV2_CULANE, compute_dtype="bf16", device="cuda", seed=1,
    )
    torch.cuda.synchronize()
    check(det.spec.input_size == 512 and det.spec.config[3:] == (64, 3, 3)
          and len(det.class_names) == 80, f"not EfficientDet-D0 at full width: {det.spec}")
    print(f"[main-effdet] built EfficientDet-D0-512 (f32) + UFLDv2-CULane (bf16) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(2)
    ms = MultiStreamADAS(det, lane, N_STREAMS, FRAME_HW)
    ticks = [rng.integers(0, 256, (N_STREAMS, *FRAME_HW, 3), dtype=np.uint8) for _ in range(4)]
    try:
        return serve("main-effdet", ms, mods,
                     {"stem": 1, "int8_conv": 0, "block": 0, "iou": 1, "nms": 1},
                     ticks, 3, 6, torch, np)
    finally:
        ms.close()


#: seeded 720p frames that each route of a single-frame phase runs
N_FRAMES = 10


def frame_digest(pipe):
    """What one ``process_frame`` leaves in the facades: the detections
    (label, confidence, box) and the lanes (status, points)."""
    objs = [(o.label, o.conf, o.x, o.y, o.width, o.height)
            for o in pipe.objectDetector.object_info]
    info = pipe.laneDetector.lane_info
    return objs, list(info.lanes_status), [[tuple(p) for p in pts] for pts in info.lanes_points]


def build_frame_pipelines(cd, torch, np):
    """``ADASPipeline`` on the card for each route (fused, the default, and
    unfused): YOLOv8l-640 + UFLDv2-CULane from the same seeds, under int8
    calibrated from the same two 720p frames.  Fails unless both routes'
    nets hold the same weights and scales."""
    from adas_tpu_torch.pipeline.app import ADASPipeline
    from adas_tpu_torch.utils.types import LaneModelType

    h, w = FRAME_HW
    calib = list(np.random.default_rng(7).integers(0, 256, (2, h, w, 3), dtype=np.uint8))
    pipes = {}
    for route in ("fused", "unfused"):
        t = time.perf_counter()
        pipe = ADASPipeline(
            frame_size=(w, h), use_fused=route == "fused", device="cuda",
            object_config={"scale": "l", "input_size": (640, 640), "box_score": 0.25,
                           "compute_dtype": cd, "seed": 0},
            lane_config={"model_type": LaneModelType.UFLDV2_CULANE, "compute_dtype": cd,
                         "seed": 1},
        )
        if cd == "int8":
            pipe.objectDetector.calibrate_int8(calib)
            pipe.laneDetector.calibrate_int8(calib)
        torch.cuda.synchronize()
        print(f"[frame-{cd}] built the {route} route's ADASPipeline (YOLOv8l-640 + "
              f"UFLDv2-CULane{', calibrated from 2 frames' if cd == 'int8' else ''}) in "
              f"{time.perf_counter() - t:.2f} s", flush=True)
        pipes[route] = pipe
    for side in ("objectDetector", "laneDetector"):
        a, b = (getattr(pipes[r], side).net.state_dict() for r in pipes)
        check(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
              f"frame-{cd}: the two routes' {side} nets differ")
    return pipes


def frame_route(tag, route, pipe, frames, mods, per_frame, torch, np):
    """``process_frame(draw=False)`` on every frame after one warm-up
    frame, with exact per-frame launch counts (every count set to 0 just
    before); checks finite, non-empty results and prints the per-frame
    and per-stage times (host clock; each stage ends in a fetch).
    Returns (digests, launch counts)."""
    from adas_tpu_torch.utils.profiling import StageTimers

    pipe.process_frame(frames[0], draw=False)  # warm-up: allocator, plans
    torch.cuda.synchronize()
    pipe.timers = StageTimers()
    reset(mods)
    digests, frame_ms = [], []
    for f in frames:
        t = time.perf_counter()
        out = pipe.process_frame(f, draw=False)
        frame_ms.append((time.perf_counter() - t) * 1e3)
        check(out.shape == f.shape and out.dtype == f.dtype, f"{tag} {route}: returned frame")
        digests.append(frame_digest(pipe))
    run = counts(mods)
    for k, per in per_frame.items():
        check(run[k] == per * len(frames), f"{tag} {route}: {k} launches {run[k]} over "
                                           f"{len(frames)} frames, expected {per} per frame")
    for objs, status, _ in digests:
        check(len(objs) > 0, f"{tag} {route}: a frame without detections")
        check(all(np.isfinite(o[1:]).all() and pipe.objectDetector.box_score < o[1] <= 1
                  for o in objs), f"{tag} {route}: bad detection")
        check(len(status) == 4, f"{tag} {route}: lane status")
    stages = {k: {q: round(v[q], 3) for q in ("p50_ms", "p95_ms")}
              for k, v in pipe.timers.summary().items()}
    print(f"[{tag}] {route}: launches over {len(frames)} frames {run} (per frame {per_frame}); "
          f"detections per frame {[len(d[0]) for d in digests]}")
    print(f"[{tag}] {route}: process_frame(draw=False) ms p50 "
          f"{np.percentile(frame_ms, 50):.3f}, p95 {np.percentile(frame_ms, 95):.3f}, all "
          f"{[round(v, 3) for v in frame_ms]}; stages {json.dumps(stages)}", flush=True)
    return digests, run


def warp_check(tag, pipe, frame, torch, np):
    """The bird-view warp on the card (``transformToBirdView``, the trapezoid
    as the frames left it) within one level of the plain CPU warp, and its
    times: the pageable upload of the frame, the warp (eager calls between
    CUDA events), the fetch, and the whole call."""
    from adas_tpu_torch.ops.warp import warp_perspective

    h, w = FRAME_HW
    tv = pipe.transformView
    got = tv.transformToBirdView(frame)
    want = warp_perspective(torch.from_numpy(frame), tv.M, (h, w)).numpy()
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    xd = torch.from_numpy(frame).to("cuda")
    out = warp_perspective(xd, tv.M, (h, w))
    times = {"upload": [], "fetch": [], "transformToBirdView": []}
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.from_numpy(frame).to("cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out.cpu()
        t2 = time.perf_counter()
        tv.transformToBirdView(frame)
        t3 = time.perf_counter()
        for k, a, b in zip(times, (t0, t1, t2), (t1, t2, t3)):
            times[k].append((b - a) * 1e3)
    warp_ms = cuda_ms(lambda: warp_perspective(xd, tv.M, (h, w)), 20)
    print(f"[{tag}] warp on the card vs the plain CPU warp: max diff {int(d.max())} level(s), "
          f"{100 * (d == 0).mean():.4f}% equal; {frame.nbytes / 1e6:.2f} MB each way: upload "
          f"{np.median(times['upload']):.3f} ms, warp {warp_ms:.4f} ms (eager), fetch "
          f"{np.median(times['fetch']):.3f} ms, transformToBirdView "
          f"{np.median(times['transformToBirdView']):.3f} ms (medians of 10)", flush=True)
    check(d.max() <= 1, f"{tag}: the card's warp is {int(d.max())} levels off the plain warp")


def i420_vs_multistream(tag, pipe, frames, np):
    """The i420 fused step on one frame against stream 0 of a
    ``MultiStreamADAS`` tick holding that frame, on the same detectors:
    detection counts within 2 and at least 90% of the fused step's
    detections matched (same label, IoU > 0.9, confidence within 0.01)."""
    from adas_tpu_torch.pipeline.fused import FusedADASStep
    from adas_tpu_torch.pipeline.multistream import MultiStreamADAS

    yolo, lane = pipe.objectDetector, pipe.laneDetector
    FusedADASStep(yolo, lane, transport="i420").run(frames[0])
    single = list(yolo.object_info)
    ms = MultiStreamADAS(yolo, lane, N_STREAMS, FRAME_HW)
    try:
        tick = np.stack([frames[i % len(frames)] for i in range(N_STREAMS)])
        batched = ms.process_batch(tick)[0]["objects"]
    finally:
        ms.close()
    wb = np.array([o.tolist(dtype=float) for o in batched]).reshape(-1, 4)
    matched, equal = 0, 0
    for o in single:
        box = np.array(o.tolist(dtype=float))
        lt, rb = np.maximum(box[:2], wb[:, :2]), np.minimum(box[2:], wb[:, 2:])
        inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
        area = (wb[:, 2] - wb[:, 0]) * (wb[:, 3] - wb[:, 1])
        iou = inter / ((box[2] - box[0]) * (box[3] - box[1]) + area - inter)
        j = int(np.argmax(iou)) if len(wb) else None
        if j is not None and iou[j] > 0.9 and batched[j].label == o.label \
                and abs(batched[j].conf - o.conf) <= 0.01:
            matched += 1
            equal += bool(np.array_equal(wb[j], box) and batched[j].conf == o.conf)
    print(f"[{tag}] i420 fused step vs MultiStreamADAS stream 0: {len(single)} vs "
          f"{len(batched)} detections, {matched} matched, {equal} equal to the bit", flush=True)
    check(len(single) > 0 and abs(len(single) - len(batched)) <= 2
          and matched >= 0.9 * len(single), f"{tag}: the i420 step and stream 0 disagree")


def frame_kernel_phase(mods, shapes, torch):
    """Every kernel at the single-frame path's batch-1 shapes, against its
    plain version: device time, bound and the library call's time
    (``[frame-kernel]`` lines); the int8 conv over every distinct shape
    of the frame, summed per frame.  Returns {kernel: batch-1 row}."""
    S, IC, B, I, NMS = (mods[k] for k in KERNELS)
    gen = torch.Generator(device="cuda").manual_seed(4)
    stem = [stem_case(S, torch, gen, name, shape, k, act, pool, torch.bfloat16, 1e-2, 1e-2)
            for name, shape, k, act, pool in STEM_SITES]
    conv = main_path_conv_phase(IC, shapes, torch, tag="frame-int8-shapes", per="frame")
    block = [block_case(IC, B, torch, gen, name, shape, acts) for name, shape, acts in BLOCK_SITES]
    boxes, scores = nms_inputs(gen, 1, 512, torch)
    mask = I.iou_mask(boxes, 0.45, plus_one=True)
    bits = int(I.unpack_bits(mask ^ I.iou_mask_reference(boxes, 0.45, plus_one=True),
                             512).sum().item())
    check(bits == 0, f"iou mask (1, 512): {bits} bits differ")
    keep = NMS.nms_walk(mask, scores, 100, 0.001)
    n_diff = int((keep != NMS.nms_walk_reference(mask, scores, 100, 0.001)).sum().item())
    check(n_diff == 0, f"nms walk (1, 512): {n_diff} indices differ")
    picks = int((keep >= 0).sum())
    rows = {
        "stem": {"ms": sum(r[1] for r in stem), "library_ms": sum(r[3] for r in stem),
                 "bound": total_bound([r[4] for r in stem])},
        "int8_conv": {"ms": conv["ms"], "library_ms": conv["library_ms"],
                      "bound": (conv["bound_ms"], "bytes and operations by shape")},
        "block": {"ms": sum(r[1] for r in block), "library_ms": None,
                  "bound": total_bound([r[4] for r in block]),
                  "unfused_ms": sum(r[3] for r in block)},
        "iou": {"ms": device_ms(lambda: I.iou_mask(boxes, 0.45, plus_one=True), 50),
                "library_ms": None, "bound": bound(nbytes(boxes, mask), 16 * 512 * 512, "f32")},
        "nms": {"ms": device_ms(lambda: NMS.nms_walk(mask, scores, 100, 0.001), 20),
                "library_ms": None,
                "bound": bound(picks * mask.shape[-1] * 4 + nbytes(scores, keep),
                               picks * mask.shape[-1], "f32")},
    }
    for k, r in rows.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"[frame-kernel] {k} at batch 1 (per frame): kernel {r['ms']:.4f} ms, bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), {100 * r['bound'][0] / r['ms']:.1f}% of "
              f"bound, library {lib}", flush=True)
    return rows


def frame_phase(cd, mods, torch, np):
    """The single-frame path (``ADASPipeline.process_frame(draw=False)``)
    under ``cd``: both routes over the same seeded 720p frames, exact
    per-frame launch counts, the fused route's results equal to the
    unfused route's, the warp; under int8 also the i420 fused step
    against a batched tick and every kernel at its batch-1 shapes.
    Returns (launch counts of both routes, batch-1 rows or None)."""
    from adas_tpu_torch.models.quant import QConv2d

    tag = f"frame-{cd}"
    pipes = build_frame_pipelines(cd, torch, np)
    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8) for _ in range(N_FRAMES)]
    per_frame = {"stem": 2, "int8_conv": 0, "block": 0, "iou": 1, "nms": 1}
    if cd == "int8":
        n_conv = sum(isinstance(m, QConv2d) for side in ("objectDetector", "laneDetector")
                     for m in getattr(pipes["fused"], side).net.modules())
        per_frame.update(int8_conv=n_conv - 2 * BLOCKS_PER_TICK, block=BLOCKS_PER_TICK)
    results = {route: frame_route(tag, route, pipe, frames, mods, per_frame, torch, np)
               for route, pipe in pipes.items()}
    same = [a == b for a, b in zip(results["fused"][0], results["unfused"][0])]
    print(f"[{tag}] fused route equal to the unfused route (detections and lanes) on "
          f"{sum(same)} of {len(same)} frames", flush=True)
    check(all(same), f"{tag}: the fused route's results differ from the unfused route's")
    warp_check(tag, pipes["fused"], frames[-1], torch, np)
    run = {k: sum(r[1][k] for r in results.values()) for k in KERNELS}
    if cd != "int8":
        return run, None
    fused = pipes["fused"]
    shapes = main_path_conv_shapes(lambda: fused.fused.run(frames[0]), mods["int8_conv"], torch)
    check(sum(shapes.values()) == per_frame["int8_conv"],
          f"recorded {sum(shapes.values())} int8 convs in a frame, expected "
          f"{per_frame['int8_conv']}")
    i420_vs_multistream(tag, fused, frames, np)
    rows = frame_kernel_phase(mods, shapes, torch)
    for k, r in rows.items():
        r["launches_per_frame"] = per_frame[k]
    return run, rows


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible", file=sys.stderr)
        return 2
    from adas_tpu_torch.ops import block as B
    from adas_tpu_torch.ops import int8_conv as IC
    from adas_tpu_torch.ops import iou as I
    from adas_tpu_torch.ops import nms as NMS
    from adas_tpu_torch.ops import stem as S
    from adas_tpu_torch.ops.cuda_build import BUILD_DIR, build_cuda_libraries

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
    build_cuda_libraries(KERNELS)
    print(f"[build] {', '.join(f'csrc/{k}.cu' for k in KERNELS)} built in parallel in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    for k in KERNELS:
        with open(f"{BUILD_DIR}/lib{k}.ptxas.txt") as f:
            for line in f:
                if "Compiling entry" in line or "registers" in line or "spill" in line:
                    print(f"[build] {k}: {line.strip()}")

    rows = {"stem": kernel_phase(S, torch), **int8_kernel_phase(IC, B, torch),
            **nms_kernel_phase(I, NMS, torch)}
    reference_phase(torch, np)
    int8_reference_phase(torch, np, IC, B)
    mods = {"stem": S, "int8_conv": IC, "block": B, "iou": I, "nms": NMS}
    runs = [
        int8_main_phase(mods, torch, np),
        effdet_main_phase(mods, torch, np),
        bf16_main_phase(mods, torch, np),
    ]
    frame_run, frame_rows = frame_phase("int8", mods, torch, np)
    runs += [frame_run, frame_phase("bf16", mods, torch, np)[0]]
    launches = {k: sum(run[k] for run in runs) for k in KERNELS}

    replaces = {
        "stem": "adas_tpu/ops/pallas_stem.py:108",
        "int8_conv": "adas_tpu/ops/pallas_conv.py:70",
        "block": "adas_tpu/ops/pallas_block.py:109, adas_tpu/ops/pallas_block.py:380",
        "iou": "adas_tpu/ops/pallas_iou.py:28",
        "nms": "adas_tpu/ops/nms.py:111",
    }
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": k,
        "route": "cuda",
        "source": f"adas_tpu_torch/csrc/{k}.cu",
        "replaces": replaces[k],
        "launches": launches[k],
        "max_abs_err": rows[k]["max_abs_err"],
        "ms": rows[k]["ms"],
        "plain_ms": rows[k]["plain_ms"],
        "bound_ms": rows[k]["bound"][0],
        "bound_by": rows[k]["bound"][1],
        "library_ms": rows[k]["library_ms"],
        # a kernel's other variants: the block's unfused pair, the IoU
        # matrix mode, the rescoring scan
        **{key: v for key, v in rows[k].items() if key in EXTRA_KEYS},
        # the single-frame path: launches per frame, and the kernel at
        # its batch-1 shapes (summed per frame as the kernels line sums)
        "launches_per_frame": frame_rows[k]["launches_per_frame"],
        "batch1_ms": frame_rows[k]["ms"],
        "batch1_bound_ms": frame_rows[k]["bound"][0],
        "batch1_library_ms": frame_rows[k]["library_ms"],
    } for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
