"""On-GPU smoke test of the PyTorch/CUDA port (``adas_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU (an H100;
the kernels are built for sm_90a):

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build the five kernels from source, one nvcc per source, all started
   together (``csrc/stem.cu``, ``csrc/int8_conv.cu``, ``csrc/block.cu``,
   ``csrc/iou.cu``, ``csrc/nms.cu``; the int8 conv and the block share
   ``csrc/int8_epilogue.cuh``), beside the HUD's host rasterizer
   (``native/draw.cpp``, g++, ``_build/libdraw.so``), and print the
   kernels' ptxas register, shared memory and spill lines;
3. each kernel against its plain PyTorch version, beside its bound (the
   longer of its bytes at 3.35 TB/s and its operations at the data-sheet
   peak of their type) and, where one PyTorch call computes the same
   function, that call's time.  The kernel and the library call are timed
   as device time (calls captured in a CUDA graph, one replay between
   CUDA events); the plain version as eager calls between CUDA events:
   * the stem at both serving shapes — YOLOv8 3x3/2 + SiLU on
     8x3x640x640 and ResNet 7x7/2 + ReLU + max pool on 8x3x320x1600 — and
     the 3x3 YOLO stem at the other scales' widths (16, 32, 48, 80
     features, 8x3x640x640), in bf16 (atol = rtol = 1e-2) and in f32 with
     TF32 off (atol 2e-4, rtol 1e-4); yardstick: cuDNN ``F.conv2d`` in the
     input's type with the BN folded into its weight and bias;
   * the int8 conv at the TPU conv kernel's four shapes (3x3/s1 at
     8x160x160x64->64, 8x80x400x64->64, 8x80x80x128->128,
     8x40x40x256->256) plus the path's 3x3/s2 down1 (8x320x320x64->128)
     and a 1x1 (8x80x80x256->256), with s8 output (at most 1 LSB apart on
     fewer than 0.5% of the elements) and bf16 output (within one bf16
     ulp, or 1e-30); yardstick: ``torch._int_mm`` on the same implicit
     GEMM, its im2col operand made outside the timed window;
   * the fused block at its two serving shapes, 8x160x160x64 (SiLU, SiLU,
     residual) and 8x80x400x64 (ReLU, -, residual, ReLU), and at YOLOv10s's
     three (8x160x160x32 and 8x80x80x64 with the residual, 8x80x80x64
     without, each the second half of a C2f's cv1 output), equal to the
     bit (0 LSB), beside the unfused pair the nets run without the fusion
     gate (two int8 conv launches, the residual and the requantize, device
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
   * f32: the port's preprocess and the nets (YOLOv8l, YOLOv5s and
     YOLOv10s (both heads) at 160x160, UFLDv2 with a ResNet-18 trunk,
     EfficientDet-D0 at 128x128 behind the BGR-plane preprocess) on the
     GPU against the same on the CPU (the plain stem), rtol 1e-3 with an
     atol of 1e-3 of the output's largest magnitude;
   * int8: YOLOv8l, YOLOv5s and YOLOv10s (both heads, calibrated through
     ``both``) at 320x320 and UFLDv2 (ResNet-18) at 160x640, so that the
     fused bodies pass the gate, packed and calibrated on the CPU from two
     inputs, then moved to the GPU with their scales: the GPU kernels
     against the CPU plain versions, relative L2 error per output below
     2e-2 for the YOLO nets and 3e-2 for UFLDv2, and the GPU run's int8
     conv and block launches exactly what the module trees and the fusion
     gate give.  The int8 kernels agree
     with their plain versions to the bit at these sizes; the operands
     between them do not (the 7x7 stem kernel sums in another order than
     the CPU's conv, and the BN folds' ``rsqrt`` and other f32 ops round
     differently on the card), a value one ulp apart moves s8 values, and
     the random-weight int8 trunk carries that to ~1.7% at the lane
     outputs (the JAX-vs-port module test sees the same from the two
     frameworks' stems);
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
   memory.  Then the JAX bench's two-point compute frames/s
   (``[probe-v8l-int8]``, ``bench.py:252-278``): ``make_compute_probe`` at
   30 and 60 chained steps, each captured in one CUDA graph (exactly
   (1 + steps) x the per-tick launches at capture, none on replay; the
   2-step probe equal to two eager steps), best of 3 replays each; and the
   same nets on JAX's default transport, bgr (``[main-int8-bgr]``: the
   frames uploaded as they are, no host encode), with the same launches;
5a. ``[main-uncal-int8]``: phase 5's nets left uncalibrated, on bgr: every
   int8 conv in its per-image mode (a row of the epilogue scale per
   stream: the dynamic scales), each distinct shape of a tick against
   its plain version and ``torch._int_mm``
   (``[main-uncal-int8-shapes]``); stream 0's packed row equal to the bit
   when streams 1-7 change; the ticks with per tick stem 2, block 0
   (uncalibrated blocks do not fuse), 115 int8 conv, IoU 1, walk 1;
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
   distinct shape of the frame, ``[frame-int8-shapes]``), and the stem at
   the other batch-1 sites of phases 12-15 in bf16 and f32: the 3x3 at
   16/32/48/80 features on 1x3x640x640, the ResNet stem at UFLD v1's
   1x3x288x800 and CurveLanes' 1x3x800x1600, and the serving two in f32;
9. the same path in bf16 (``[frame-bf16]``): stem 2, IoU 1, walk 1 per
   frame;
10. the demo's video path with the HUD (``[render-int8]``): ten seeded
    720p frames written to a temporary ``.y4m`` by the port's writer,
    ``pipeline/app.run_video`` over it on phase 8's calibrated fused
    pipeline (reset to a new pipeline's host state: nothing is calibrated
    twice), ``process_frame(draw=True)`` on the card and the drawn frames
    written to a ``.y4m``.  Fails unless the output holds 10 frames of
    720x1280 under a valid header, each differing from its input in the
    signs panel and the bird-view inset, every frame launched exactly
    2 / 105 / 5 / 1 / 1 kernels, and the track ids and signals equal a
    ``draw=False`` pass over the same frames from the same state.  Prints
    process_frame p50/p95, the ``analytics_render`` stage with drawing and
    of it the panel, the text and the two ``add_weighted`` passes, and the
    Y4M reader's and writer's ms per frame, beside the card's name and
    power limit;
11. config 5 of the JAX bench (``[main-v10-int8]``, ``bench.py:421-470``):
    YOLOv10s-640 calibrated int8 served NMS-free (its one-to-one head and
    top-k, ``box_score`` 0.25) + UFLDv2-CULane int8, both calibrated on the
    card from two frames, 8 streams of 720x1280 on the I420 path; every
    distinct int8 conv shape against its plain version
    (``[v10-int8-shapes]``), then the ticks of phase 5 with per tick stem
    2, block 6 (the fusion gate over the module tree), the other int8
    convs of the trunk and the one-to-one head, IoU 0 and walk 0; finite
    detections, at most ``max_det`` per stream; then the same ticks with
    ``host_downscale=(360, 640)`` as the JAX bench configures config 5
    (``[main-v10-int8-ds360]``) and the compute probe there
    (``[probe-config5]``, the bench's pinned ``compute_fps_fixed`` geometry);
12. ``[frame-v10-bf16]``: phase 9 with YOLOv10s-640 (its one-to-many head
    and NMS, as the fused step serves it) + UFLDv2-CurveLanes (800x1600),
    both routes equal; stem 2, IoU 1, walk 1 per frame;
13. ``[frame-v5-int8]``: YOLOv5s-640 calibrated int8 + UFLD v1-CULane
    bf16 on the unfused route (a v1 pair has no fused route), per frame
    stem 1 (v5's 6x6 stem is a plain conv), the v5 net's int8 convs, IoU
    1, walk 1, p50/p95; then every distinct int8 conv shape of one
    ``DetectFrame`` against its plain version (``[v5-int8-shapes]``);
14. ``[demo-default]``: ``run_synthetic`` with ``ADASPipeline``'s defaults
    (YOLOv8n f32, the f32 stem at 16 features, + UFLDv2-CULane f32, HUD
    drawn) into a ``.y4m`` that must hold its 4 drawn 720p frames; finite,
    non-empty detections; stem 2, IoU 1, walk 1 per frame;
15. ``[main-v9c-int8]``: YOLOv9c-640 (GELAN-C) calibrated int8 +
    UFLDv2-CULane int8, both calibrated on the card, 8 streams of 720p on
    the I420 path: every distinct int8 conv shape of a tick against its
    plain version and ``torch._int_mm`` (``[main-v9c-int8-shapes]``), then
    the ticks of phase 5 with per tick stem 1 and block 2 (the lane
    net's: GELAN has no Pallas stem or fused body in JAX either), the int8
    conv calls of both nets, IoU 1 and walk 1;
16. ``[main-effdet-int8]``: EfficientDet-D0-512 calibrated int8
    (``box_score`` 0.3) + UFLDv2-CULane int8, the JAX bench's
    ``c5_efficientdet_d0_int8_8streams``, as phase 15 (EfficientDet's
    head convs run once per level), at 720p and again with the bench's
    ``host_downscale=(360, 640)`` (``[main-effdet-int8-ds360]``), then
    ``DetectFrame`` on one 720p frame (``c5_efficientdet_d0_int8``) with
    the net's int8 conv calls, IoU 1 and walk 1;
17. ``[families]``: every YOLO family at every scale (v5, v8, v10 at n-x,
    v10s NMS-free; v5-lite e/s/g, v6 n/s/m/l, v7, v9 c in f32 and, each
    calibrated on the card from two frames, in int8) and the UFLD v1
    (TuSimple, CULane) and UFLDv2-CurveLanes facades, built on the card
    by default, one ``DetectFrame`` each with its exact launches (the
    int8 ones: every int8 conv of the net once, no stem; UFLD v1-CULane
    int8, uncalibrated as in JAX, with its stem);
18. ``[lane-res34]``, ``[lane-res50]``: UFLDv2 on the ResNet-34 and
    ResNet-50 trunks at 160x640, GPU against CPU in f32 and int8 (and
    the int8 trunk on the GPU's stem output equal to the bit on the CPU;
    :func:`lane_depth_phase`), with exact launches (int8: ResNet-34's
    three fused ``layer1`` blocks);
19. ``[lane-res34-served]``, ``[lane-res50-served]``: the same trunks in
    their served configuration (``configs/ufldv2/culane_res34.py``:
    320x1600, the published head) through ``UltrafastLaneDetectorV2`` and
    ``MultiStreamADAS`` beside YOLOv8l at 8 streams of 720p, f32 and
    calibrated int8 (:func:`lane_served_phase`): the lane net's int8 conv
    shapes (``[lane-res34-shapes]``) and fused block shapes against their
    plain versions, then the ticks with exact launches;
20. the weights a user brings (``[import-*]``), written as checkpoints
    under the released key names to a temporary directory (seeded trees
    through the importers' inverse mappings; ``torch.save`` for ``.pth``,
    the port's writer for ``.onnx``): ``[import-main-int8]``, YOLOv8l-640
    and UFLDv2-CULane from ``.pth`` through the facades, calibrated on the
    card, written back with ``save_params(path, flax_variables(net))`` and
    loaded into a second pair: equal trees, and one 8-stream 720p I420
    tick of each with exactly stem 2, int8 conv 105, block 5, IoU 1 and
    walk 1 and the same packed output, to the bit, with the load-and-build
    and first-tick times; ``[import-onnx]``, the lane net from an ``.onnx``
    of its initializers: the same tree and tick; ``[import-families]``,
    one f32 ``DetectFrame`` per YOLO family at its smallest scale from
    ``.pth`` (v5-lite-g in RepVGG's training form, v6 fused at load, v10),
    UFLD v1 and EfficientDet-D0 with a 90-way zylo117 head, each equal to
    the ``.npz`` the ``torch_import`` CLI makes of it, and one forward of
    ``UFLDv2CurveLanesNet`` through the registry, finite and equal to its
    ``.npz`` route; ``[import-int8npz]``, ``quantize --mode int8
    --calibrate YOLOV8`` on a YOLOv8n ``.npz`` and the facade serving the
    ``_int8.npz`` with the store's scales and the int8 conv and block
    launches of the same net calibrated by the facade.
21. the engines (``[artifact-*]``, ``[onnx-graph]``, in a temporary
    directory): ``[artifact-main-int8]``, phase 5's calibrated int8 pair
    (the same seeds and calibration frames) exported as one 8-stream I420
    pipeline ``.adas`` (``MultiStreamADAS.export_fused``: a
    ``torch.export`` program whose kernel calls are the registered
    ``adas_tpu_torch::*`` operators), then loaded with
    ``MultiStreamADAS(..., step_artifact=path)`` in a fresh Python process
    (this script with ``--serve-artifact``) that imports nothing of JAX or
    cv2: exactly stem 2, int8 conv 105, block 5, IoU 1 and walk 1 per
    served tick and the packed ticks equal to the native ones to the bit,
    with the export time, file size, load time and the native and served
    ``process_batch`` and device-step times; ``[artifact-frame]``, the
    int8 YOLOv8l facade's fused step at 720p and 1080p in one
    multi-geometry file and the int8 UFLDv2-CULane facade's at 720p,
    served through ``DetectFrame`` with the native launches and outputs
    per frame, to the bit; ``[onnx-graph]``, a hand-built YOLO-format
    graph and EfficientDet's postprocessed graph (``tools/onnx_writer``)
    through ``onnx_mode="graph"`` on the card: IoU 1 and walk 1 per YOLO
    frame, raw outputs within 1e-4 (relative) of the CPU's, and the CPU's
    detections (boxes within 1e-2 px, scores within 1e-5).
22. the last modules (in temporary directories): ``[onnx-export]``, the
    ``onnx_export`` CLI on ``cuda`` writing ``ufldv2_culane`` (320x1600)
    and ``yolov8_l`` (640, the facade's seeded tree, its scores spread by
    ``condition_yolo``, through ``--weights``), each served by ``OnnxGraphEngine`` on the card within
    rtol = atol = 2e-4 of the native net, with export seconds and MiB;
    ``[onnx-multistream]``, that YOLOv8l graph as the object side of the
    8-stream I420 f32 pipeline beside the native UFLDv2-CULane (stem 1,
    IoU 1, walk 1 per tick; the graph inside the step within 2e-4 of the
    native net on the step's own batch; lanes equal to the native
    pipeline's and every detection paired with a native one, label, box
    and score), ``process_batch`` ms of both; ``[transport-parity]``,
    ``measure_transport_drift`` of the calibrated int8 v8l + UFLDv2 pair
    on 4 synthetic 720p frames at the 360x640 rung (stem 4, int8 conv
    210, block 10, IoU 2, walk 2 per frame); ``[codec]``, the committed
    image fixtures decoded equal to their cv2 decodes, the ms of a 720p
    decode, ``run_lane_image`` on a 720p PNG, ``run_lane_video`` over a
    3-frame ``.y4m`` and ``quantize --calib-dir`` on the card;
    ``[video]``, the committed ``mp4v`` fixtures (``tests/data/video``)
    decoded to cv2's Y planes to the bit and within the chroma drift
    bound, ``run_synthetic`` at 720x1280 for 24 frames with the default
    nets to an ``.mp4`` read back equal to the writer's reconstruction at
    30 fps, ``run_video`` (4 frames) and ``run_lane_video`` (3) over it to
    ``.mp4``, the encode and decode ms per frame, the MiB and the launches
    per frame (stem 2, IoU 1, walk 1; the lane demo stem 1); then H.264
    input: the committed H.264 fixtures (``tests/data/video/h264``)
    decoded to cv2's Y digests, the 720p content clip (24 frames, CABAC)
    rebuilt by the stream writer and decoded to its digests with the ms per
    IDR and P picture, and ``run_video`` over it as an ``avc1`` ``.mp4``
    with the defaults (stem 2, IoU 1, walk 1 per frame, 24 frames); then
    AVI and Motion JPEG (``video_avi``): the committed AVI/MOV/MP4 fixtures
    (``tests/data/video/avi``) to cv2's digests, the 720p Motion JPEG clip
    of the committed 4:2:0 and 4:2:2 JPEGs whole and damaged to cv2's
    digests and counts, the decode ms per frame of each sampling, the
    demux ms, the ``mp4v`` encode ms into ``.avi`` and ``.mp4``, and
    ``run_video`` over the clip to an ``.avi`` (stem 2, IoU 1, walk 1 per
    frame, 24 frames), the clip cut in its last chunk with its sizes
    written (the partial chunk decoded) to cv2's digests; then MPEG-4
    Advanced Simple (``video_mpeg4_asp``): the committed ASP fixtures
    (``tests/data/video/mpeg4``: B-VOPs, DivX's packed B-VOPs, N-VOPs,
    4MV, quarter-sample, MPEG matrices, video packets, the XviD IDCT) to
    cv2's digests and counts, the 720p ASP clip (12 frames, IBBP) rebuilt
    by the writer and decoded to its digests with the ms per I, P and B
    VOP, and ``run_video`` over it as an ``XVID`` ``.avi`` (stem 2, IoU 1,
    walk 1 per frame, 12 frames); the damaged clips (``video_conceal``);
    then H.265 input (``video_hevc``): the 720p H.265 content clip (a PCM
    IDR picture, then 59 P pictures of a pan by merge and AMVP, WPP on)
    rebuilt by ``tests/data/video/hevc_writer.py`` and decoded to the
    digests cv2 made of it (``tests/data/video/hevc/sha256.json``) with
    the ms per IRAP and P picture, and ``run_video`` over it as an
    ``hvc1`` ``.mp4`` (stem 2, IoU 1, walk 1 per frame, 60 frames);
    ``[train-ufldv2]``, UFLDv2-CULane res18 with the aux head at
    320x1600, batch 8, 20 SGD steps in f32 (no kernel launches; the loss
    falls; the first step's loss, outputs and gradient within rel 1e-6,
    1e-4 and 2e-2 of the CPU's on the same init and batch, bounds that
    TF32 convolutions exceed, their gaps printed beside; a save/restore
    exact; then one eval forward through the stem kernel), step ms,
    images/s and peak memory, and the step with TF32 convolutions.
23. the mesh (``[mesh-*]``; one process drives every device, as JAX
    does): over every card (``make_mesh()``) where there are several,
    else over meshes that repeat ``cuda:0`` (data 2, model 1 for
    serving; data 2, model 2 for the head split and training), printed
    as such.  ``[mesh-int8]``: phase 5's calibrated int8 pair over the
    mesh beside the unsharded pipeline on the same nets: each row's
    streams equal to the bit to the unsharded step on those streams;
    each row's nets on its part of the unsharded tick's preprocessed
    inputs equal to the tick to the bit, lanes included; the end-to-end
    I420 tick (whose preprocess rounds otherwise at a row's batch) by
    matched detections, counts and lane flags; each row's step alone
    exactly stem 2, int8 conv 105, block 5, IoU 1 and walk 1,
    ``process_batch`` and ``serve_pipelined`` ticks with rows x those per
    tick and every stream's tracker advanced once per tick, the device
    step of each row and of the tick (the rows issued in turn), and the
    compute probe (one CUDA graph per row, the launches of phase 5's
    probe); ``[mesh-bf16]``: the same in bf16 (stem 2, IoU 1, walk 1 per
    row), where cuDNN picks its algorithms by the batch: the stem, IoU
    and walk kernels are held against their plain versions at the row
    batch instead of the bit check; ``[mesh-sharded-step]``: ``make_sharded_stream_step`` of
    the UFLDv2-CULane f32 forward with its head split over ``model``,
    within 1e-5 relative L2 of the unsharded forward per output, the stem
    once per row; ``[mesh-train]``: phase 22's trainer (320x1600, aux,
    batch 8) sharded against the unsharded one on the card from the same
    init: first loss within rel 2e-5, the first update within 2e-2
    relative L2, every replica's running statistics equal, no kernel
    launches, step ms of both, a checkpoint round trip.

Then the card's name and power limit again, one JSON line describing
the kernels — ``launches`` summed over the paths (the ``[families]``
checks among them), each counted from 0 just before it; ``max_abs_err``, ``ms``, ``plain_ms``,
``library_ms`` (null where no PyTorch call computes the function) and the
bound (``bound_ms``, ``bound_by``) from phase 3 (stem: bf16, summed over
its two serving shapes, plus ``widths_ms``, each other width's bf16 time;
int8 conv: s8 output, the largest error in LSB,
summed over its six shapes; block: the same over its two shapes, plus
``unfused_ms``, the unfused pair's time summed the same way, and
``config5_ms``, its time summed over YOLOv10s's three shapes; IoU: the
largest matrix error or count of differing mask bits over its shapes,
the rest the served mask mode at (8, 512) with ``plus_one``, plus
``matrix_ms`` and ``matrix_bound_ms`` of the matrix mode; nms: the number
of differing indices over both kernels, the rest the served walk, hard at
IoU 0.45, its bound counting this run's picks, plus ``scan_ms``, the
rescoring scan on the same call; and from phase 8 the launches per frame
and the kernel's batch-1 time, bound and library time, summed per frame
as above: ``launches_per_frame``, ``batch1_ms``, ``batch1_bound_ms``,
``batch1_library_ms``; stem: ``batch1_sites_ms``, each other batch-1
site's time by dtype; int8 conv: ``config5_tick_{ms,library_ms,bound_ms}``
``v5_frame_{ms,library_ms,bound_ms}``, ``v9c_tick_*`` and
``effdet_int8_tick_*`` and ``uncal_int8_tick_*``, the kernel,
``torch._int_mm`` and the bound summed per tick of phases 11, 15, 16 and
5a and per frame of phase 13; ``lane_res34_tick_*`` and
``lane_res50_tick_*``: the int8 conv's and the block's sums per int8 tick
of phase 19 over the lane net's shapes (the block with its plain
version's), and every kernel's ``..._launches`` per such tick;
``import_main_int8_launches``: every kernel's launches in phase 20's
counted tick; phases 21, 22 and 23's launches are in ``launches``) —
and last ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, when no CUDA GPU is visible.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

KERNELS = ("stem", "int8_conv", "block", "iou", "nms")
N_STREAMS, FRAME_HW = 8, (720, 1280)
BLOCKS_PER_TICK = 5
#: keys of the kernels line beyond the contract's
EXTRA_KEYS = ("unfused_ms", "matrix_ms", "matrix_bound_ms", "scan_ms", "widths_ms",
              "config5_ms", *(f"{path}_{k}" for path in ("config5_tick", "v5_frame", "v9c_tick",
                                                         "effdet_int8_tick", "families_int8_frames",
                                                         "uncal_int8_tick", "lane_res34_tick",
                                                         "lane_res50_tick")
                              for k in ("ms", "library_ms", "bound_ms", "plain_ms", "launches")),
              "import_main_int8_launches")
#: chained steps of the short compute probe (``bench.py``'s COMPUTE_ITERS);
#: the long one runs twice as many
COMPUTE_ITERS = 30
#: the JAX bench's pinned transport geometry (``bench.py:288``, ``:301``)
HOST_DOWNSCALE = (360, 640)
#: EfficientDet's box score on seeded weights (see phase 6); the int8 path
#: serves at 0.3 (phase 16)
EFFDET_BOX_SCORE = 0.5
EFFDET_INT8_BOX_SCORE = 0.3
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


def wall_ms(fn, iters: int) -> float:
    """Mean host-clock time of ``fn()`` over ``iters`` calls after warm-up,
    from a synchronization of every card to one after the last call (work
    that spans cards)."""
    import torch

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    for _ in range(3):
        fn()
    sync()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t) * 1e3 / iters


def stem_case(S, torch, gen, name, shape, k, act, pool, dtype, atol, rtol, feat=64):
    """One stem site: the kernel against ``stem_reference`` (fails beyond
    ``atol``/``rtol``), its device time, the plain version's, its bound
    and cuDNN's ``F.conv2d`` in the input's type with the BN folded into
    its weight and bias (the conv + BN in one call, full-resolution
    output); prints a ``[kernel]`` line and returns (err, ms, plain_ms,
    library_ms, bound)."""
    import torch.nn.functional as F

    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(feat, 3, k, k, generator=gen, device="cuda") * 0.1).to(dtype)
    gain = torch.randn(feat, generator=gen, device="cuda")
    bias = torch.randn(feat, generator=gen, device="cuda")
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
    b = bound(nbytes(x, w, gain, bias, got), 2 * shape[0] * feat * hc * wc * 3 * k * k,
              "bf16" if dtype == torch.bfloat16 else "f32")
    wf = (w.float() * gain.view(-1, 1, 1, 1)).to(dtype)
    bf = bias.to(dtype)
    lib_ms = device_ms(lambda: F.conv2d(x, wf, bf, stride=2, padding=k // 2), 20)
    print(f"[kernel] {name} {str(dtype)[6:]} {tuple(shape)} -> {tuple(got.shape)}: "
          f"max_abs_err {err:.6g} (atol {atol}, rtol {rtol}) kernel {ms:.4f} ms "
          f"(eager {eager_ms:.4f}), plain {plain_ms:.4f} ms, {fmt_bound(b, ms)}, cuDNN conv2d "
          f"+ folded BN {lib_ms:.4f} ms", flush=True)
    check(ok, f"{name} {dtype}: kernel disagrees with stem_reference (max abs err {err})")
    return err, ms, plain_ms, lib_ms, b


#: the stem's two sites: (name, input shape at batch 1, k, act, pool)
STEM_SITES = (
    ("yolo_stem_k3_silu", (1, 3, 640, 640), 3, "silu", False),
    ("resnet_stem_k7_relu_pool", (1, 3, 320, 1600), 7, "relu", True),
)
#: the other YOLO stem widths (v8/v10 n, s, m, x; the l stem is 64 wide)
STEM_WIDTHS = (16, 32, 48, 80)
#: the tolerances of each stem dtype (``tests/test_pallas_stem.py:80`` for f32)
STEM_DTYPES = (("bfloat16", 1e-2, 1e-2), ("float32", 2e-4, 1e-4))
#: the stem's other batch-1 sites of the single-frame paths (name, input
#: shape, k, act, pool, features): the 3x3 at the other YOLO widths
#: (v8n, v10s, m, x) and the ResNet stem at UFLD v1's and CurveLanes' inputs
FRAME_STEM_SITES = (
    *[(f"yolo_stem_k3_silu_f{f}", (1, 3, 640, 640), 3, "silu", False, f) for f in STEM_WIDTHS],
    ("resnet_stem_k7_relu_pool_v1", (1, 3, 288, 800), 7, "relu", True, 64),
    ("resnet_stem_k7_relu_pool_curvelanes", (1, 3, 800, 1600), 7, "relu", True, 64),
)


def kernel_phase(S, torch):
    """Stem kernel vs stem_reference at the two serving shapes, then the
    3x3 YOLO stem at the other widths (8x3x640x640), each in bf16 and f32
    (see :func:`stem_case`).  The kernels line's row: bf16, summed over
    the two serving shapes; ``widths_ms``: each width's bf16 time."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, widths = [], {}
    for dname, atol, rtol in STEM_DTYPES:
        dtype = getattr(torch, dname)
        for name, shape, k, act, pool in STEM_SITES:
            err, ms, plain_ms, lib_ms, b = stem_case(
                S, torch, gen, name, (N_STREAMS, *shape[1:]), k, act, pool, dtype, atol, rtol)
            rows.append((dtype, err, ms, plain_ms, lib_ms, b))
        for feat in STEM_WIDTHS:
            ms = stem_case(S, torch, gen, f"yolo_stem_k3_silu_f{feat}", (N_STREAMS, 3, 640, 640),
                           3, "silu", False, dtype, atol, rtol, feat)[1]
            if dtype == torch.bfloat16:
                widths[feat] = ms
    bf16 = [r for r in rows if r[0] == torch.bfloat16]
    return {
        "max_abs_err": max(r[1] for r in bf16), "ms": sum(r[2] for r in bf16),
        "plain_ms": sum(r[3] for r in bf16), "library_ms": sum(r[4] for r in bf16),
        "bound": total_bound([r[5] for r in bf16]), "widths_ms": widths,
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
    1e-30), f32 (EfficientDet's head) within 2^-20 relative (or 1e-30);
    returns (kernel output, error: LSB for s8, absolute else)."""
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
    rel = 2.0 ** -20 if got.dtype == torch.float32 else 2.0 ** -7
    check(bool(torch.all((g - w).abs() <= w.abs() * rel + 1e-30)),
          f"int8 conv {got.dtype} disagrees (max abs err {err})")
    return got, err


def conv_yardsticks(IC, torch, args, kw, got, stride):
    """Kernel time, ``torch._int_mm`` time on the same implicit GEMM (the
    im2col operand made outside the timed window, K and N zero-padded to
    the multiples of 8 it takes; it computes the s32 product, the whole
    conv for a 1x1) and the bound of the conv (at its own widths, padded
    operands or not)."""
    import torch.nn.functional as F

    xq, wq, scale, bias = args
    k, cout = wq.shape[1], kw.get("cout") or wq.shape[0]
    ms = device_ms(lambda: IC.int8_conv(*args, **kw), 20)
    # the conv's own widths: padded operands (``pad_weight``) sliced back
    wq, scale = wq[:cout, ..., :xq.shape[3]], scale[..., :cout]
    bias = None if bias is None else bias[:cout]
    cols = IC.im2col(xq, k, stride).contiguous()
    w2d = wq.reshape(cout, -1)
    m, kk = cols.shape
    cols_p = F.pad(cols, (0, -kk % 8)).contiguous()
    w2d_p = F.pad(w2d, (0, -kk % 8, 0, -cout % 8)).contiguous()
    lib_ms = device_ms(lambda: torch._int_mm(cols_p, w2d_p.t()), 20)
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
#: its YOLOv10s sites (config 5): (name, input shape at batch 1, C2f
#: part pitch, residual); the second half of cv1's output, as the C2f reads it
V10_BLOCK_SITES = (
    ("v10s_stage1", (1, 160, 160, 32), 64, True),
    ("v10s_stage2", (1, 80, 80, 64), 128, True),
    ("v10s_fpn3", (1, 80, 80, 64), 128, False),
)


def block_case(IC, B, torch, gen, name, shape, acts, pitch=None, residual=True):
    """One block site: the kernel against ``block_reference`` to the bit,
    its device time, the plain version's, the unfused pair's and its
    bound; the input a channel slice of a ``pitch``-wide tensor (a C2f
    part) where ``pitch`` is given; prints a ``[kernel]`` line and returns
    (LSB, ms, plain_ms, unfused_ms, bound)."""
    def s8(shape, lo=-127, hi=128):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=torch.int8)

    c = shape[3]
    xq = s8((*shape[:3], pitch or c), -100, 100)[..., (pitch or c) - c:]
    w1q, w2q = s8((c, 3, 3, c), -80, 80), s8((c, 3, 3, c), -80, 80)
    s1 = torch.rand(c, generator=gen, device="cuda") * 2e-4 + 1e-4
    s2 = torch.rand(c, generator=gen, device="cuda") * 2e-4 + 1e-4
    b1 = torch.randn(c, generator=gen, device="cuda") * 0.2
    b2 = torch.randn(c, generator=gen, device="cuda") * 0.2
    sx, sm, so = (torch.tensor(v, device="cuda") for v in (0.021, 0.034, 0.027))
    args = (xq, sx, w1q, s1, b1, sm, w2q, s2, b2, so)
    kw = dict(act1=acts[0], act2=acts[1], act_post=acts[2], residual=residual)
    got = B.fused_block(*args, **kw)
    want = B.block_reference(*args, **kw)
    torch.cuda.synchronize()
    lsb, share = s8_diff(got, want)
    ms = device_ms(lambda: B.fused_block(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: B.block_reference(*args, **kw), 5)
    unfused_ms = device_ms(lambda: unfused_pair(IC, args, kw), 20)
    b = bound(nbytes(*args, got), 2 * 2 * xq[..., 0].numel() * 9 * c * c, "int8")
    print(f"[kernel] block {name} {shape} pitch {pitch or c} {acts} residual {residual}: max "
          f"diff {lsb} LSB on {share:.2e} of "
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
    block["config5_ms"] = sum(
        block_case(IC, B, torch, gen, name, (N_STREAMS, *shape[1:]), ("silu", "silu", None),
                   pitch, residual)[1]
        for name, shape, pitch, residual in V10_BLOCK_SITES)
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


def yolo_heads(net, x):
    """A YOLO net's raw outputs by name: YOLOv10's two heads before the
    one-to-one head's top-k (whose order of near ties may differ between
    the devices), any other net's single output."""
    import torch

    if not hasattr(net, "head_o2o"):
        return {"raw": net(x)}
    feats = net.net(x)
    return {"o2m": torch.cat(net.head_o2m(feats), 1),
            "o2o_head": torch.cat(net.head_o2o(feats), 1)}


def reference_phase(torch, np):
    """The full-width nets and preprocess in f32 on the GPU vs the CPU:
    YOLOv8l, YOLOv5s, YOLOv10s (both heads), YOLOv9c, YOLOv5-lite-s,
    YOLOv6n (deploy form) and YOLOv7 at 160x160, a narrowed
    UFLDv2 and EfficientDet-D0 (the depthwise convs and PSA's products in
    cuDNN and cuBLAS with TF32 off)."""
    from adas_tpu_torch.models import ufld
    from adas_tpu_torch.models.efficientdet import EfficientDet, EfficientDetSpec
    from adas_tpu_torch.models.layers import consume_stem
    from adas_tpu_torch.models.ufld import LaneModelType, UFLDv2Net
    from adas_tpu_torch.models.yolo import YoloSpec, YoloV8, build_yolo
    from adas_tpu_torch.models.yolov6 import fuse_repvgg
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
    families = {f: build_yolo(YoloSpec(scale, 80, (160, 160), family=f))
                for f, scale in (("v5", "s"), ("v10", "s"), ("v9", "c"), ("v5lite", "s"),
                                 ("v6", "n"), ("v7", "n"))}
    for seed, net in enumerate(families.values()):
        init_params(net, 20 + seed)
    fuse_repvgg(families["v6"])  # the deploy form the facade serves
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
                    xl, lnet.backbone.conv1, lnet.backbone, lnet.backbone.bn1, act="relu",
                    pool=True
                ),
                "yolo_raw": ynet.eval()(xy),
            }
            res.update({f"lane_{k}": v for k, v in lnet.eval()(xl).items()})
            res.update(zip(("effdet_c3", "effdet_c4", "effdet_c5"), enet.eval().backbone(xe)))
            res.update(zip(("effdet_boxes", "effdet_probs"), enet(xe)))
            for f, net in families.items():
                heads = yolo_heads(net.to(dev).eval(), xy)
                res.update({f"yolo_{f}_{k}": v for k, v in heads.items()})
        outs[dev] = {k: v.cpu().numpy() for k, v in res.items()}
    for k, want in outs["cpu"].items():
        got = outs["cuda"][k]
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        print(f"[reference] {k} {want.shape}: max_abs_err {err:.3g} (scale {scale:.3g})", flush=True)
        check(got.shape == want.shape and np.all(np.isfinite(got)), f"{k}: bad GPU output")
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * scale)


def int8_reference_phase(torch, np, IC, B):
    """Full-width int8 nets (YOLOv8l, YOLOv5s, YOLOv10s, YOLOv9c,
    YOLOv5-lite-s, YOLOv6n in its fused deploy form and YOLOv7 at 320x320,
    EfficientDet-D0 with its bf16 depthwise convs at 256x256) and a
    narrowed UFLDv2,
    packed and calibrated on the CPU (YOLOv10 through ``both``), then the
    GPU kernels against the CPU plain versions on the same input, with the
    GPU run's exact launches: the fused bodies the gate passes and every
    other int8 conv call of the trees (EfficientDet's head convs once per
    level)."""
    from adas_tpu_torch.models import ufld
    from adas_tpu_torch.models.efficientdet import EfficientDet, EfficientDetSpec
    from adas_tpu_torch.models.quant import pack_int8_weights
    from adas_tpu_torch.models.ufld import LaneModelType, UFLDv2Net
    from adas_tpu_torch.models.yolo import YoloSpec, YoloV8, build_yolo
    from adas_tpu_torch.models.yolov6 import fuse_repvgg
    from adas_tpu_torch.perception.object_detector import calibrate
    from adas_tpu_torch.weights import init_params

    lspec = ufld.UFLDV2_SPECS[LaneModelType.UFLDV2_CULANE]
    lane_spec = ufld.UFLDv2Spec(160, 640, lspec.crop_ratio, 20, 72, 10, 16, mlp_mid=64)
    rng = np.random.default_rng(5)
    hw = (320, 320)
    xy = torch.from_numpy(rng.uniform(0, 1, (2, 3, *hw)).astype(np.float32))
    xl = torch.from_numpy(rng.standard_normal((2, 3, 160, 640)).astype(np.float32))
    # EfficientDet's BiFPN takes sides that are multiples of its 128 stride
    xe = torch.from_numpy(rng.standard_normal((2, 3, 256, 256)).astype(np.float32))
    families = (("v5", "s"), ("v10", "s"), ("v9", "c"), ("v5lite", "s"), ("v6", "n"),
                ("v7", "n"))
    nets = {"yolo": (YoloV8(YoloSpec("l", 80, hw), int8=True), xy),
            **{f"yolo_{f}": (build_yolo(YoloSpec(scale, 80, hw, family=f), int8=True), xy)
               for f, scale in families},
            "effdet": (EfficientDet(EfficientDetSpec(compound=0, num_classes=80,
                                                     input_size_override=256), int8=True), xe),
            "lane": (UFLDv2Net(lane_spec, int8=True), xl)}
    t = time.perf_counter()
    for seed, (name, (net, x)) in enumerate(nets.items()):
        init_params(net, 10 + seed)
        if name == "yolo_v6":  # served in its deploy form, as the facade loads it
            fuse_repvgg(net)
        net.eval().requires_grad_(False)
        pack_int8_weights(net)
        calibrate(net, [x[:1], x[1:]], getattr(net, "both", None))
    print(f"[int8-reference] packed and calibrated YOLOv8l, v5s, v10s, v9c, v5-lite-s, v6n, v7 "
          f"at 320x320, EfficientDet-D0 at 256x256 + UFLDv2-160x640 on the CPU in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    blocks = sum(yolo_fused_bodies(net, hw) for k, (net, _) in nets.items()
                 if k in ("yolo", "yolo_v5", "yolo_v10")) + LANE_BLOCKS
    per_conv = sum(int8_calls(net) for net, _ in nets.values()) - 2 * blocks
    outs = {}
    for dev in ("cpu", "cuda"):
        IC.reset_launches()
        B.reset_launches()
        res = {}
        with torch.inference_mode():
            for name, (net, x) in nets.items():
                net.to(dev)
                # the serving inputs: bf16 into the YOLO and lane nets,
                # EfficientDet's normalized f32 (``efficientdet_detector``)
                xin = x.to(dev, torch.float32 if name == "effdet" else torch.bfloat16)
                if name.startswith("yolo"):
                    y = yolo_heads(net, xin)
                elif name == "effdet":
                    y = dict(zip(("boxes", "probs"), net(xin)))
                else:
                    y = net(xin)
                res.update({f"{name}_{k}": v.float().cpu().numpy() for k, v in y.items()})
        outs[dev] = res
        if dev == "cuda":
            print(f"[int8-reference] GPU launches: int8_conv {IC.launches}, block {B.launches} "
                  f"(expected {per_conv}, {blocks})")
            check(IC.launches == per_conv and B.launches == blocks,
                  "int8 reference run did not go through the kernels as the module trees say")
    for k, want in outs["cpu"].items():
        got = outs["cuda"][k]
        check(got.shape == want.shape and np.all(np.isfinite(got)), f"{k}: bad GPU output")
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        bound = 3e-2 if k.startswith("lane") else 2e-2
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
    max_det = int(getattr(ms.yolo, "max_det", 100))
    check(all(0 < k <= max_det for k in n_dets), f"detections per stream: {n_dets}")
    # NMS keeps scores above box_score, the NMS-free cut at or above it
    nms_free = bool(getattr(ms.yolo, "nms_free", False))
    for r in results[-1]:
        for o in r["objects"]:
            above = o.conf >= ms.yolo.box_score if nms_free else o.conf > ms.yolo.box_score
            check(np.isfinite([o.x, o.y, o.width, o.height, o.conf]).all() and above
                  and o.conf <= 1, "bad detection")
        check(len(r["lanes_status"]) == 4, "lane status")
    print(f"[{tag}] detections per stream (last tick): {n_dets}; lanes status "
          f"{[r['lanes_status'] for r in results[-1]][:2]}...")
    print(f"[{tag}] stages ms (3 unpipelined ticks): {json.dumps(stage_breakdown(ms, ticks, torch))}")
    step_ms = cuda_ms(lambda: ms._step(x), 10)
    print(f"[{tag}] device step alone (back-to-back, CUDA events): {step_ms:.3f} ms")
    print(f"[{tag}] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    return run


def build_main(compute_dtype, torch, tag=None):
    from adas_tpu_torch.perception.lane_detector import LaneModelType, UltrafastLaneDetectorV2
    from adas_tpu_torch.perception.object_detector import ObjectModelType, YoloDetector
    from adas_tpu_torch.pipeline.multistream import MultiStreamADAS

    t0 = time.perf_counter()
    yolo = YoloDetector(
        model_type=ObjectModelType.YOLOV8, scale="l", input_size=(640, 640), box_score=0.25,
        compute_dtype=compute_dtype, device="cuda", seed=0,
    )
    lane = UltrafastLaneDetectorV2(
        model_type=LaneModelType.UFLDV2_CULANE, compute_dtype=compute_dtype, device="cuda",
        seed=1,
    )
    torch.cuda.synchronize()
    print(f"[{tag or 'main-' + compute_dtype}] built YOLOv8l-640 + UFLDv2-CULane in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return yolo, lane, MultiStreamADAS


def main_path_conv_shapes(step, IC, torch):
    """Every int8 conv call of ``step()`` (one int8 step), by shape:
    {(input shape, channel pitch, Cout, k, stride, act, s8 output, bias,
    per-image scale table): calls per step}, recorded at the module tree's
    one call site
    (``models/layers.py``'s ``int8_conv``) on a step outside the counted
    run."""
    from adas_tpu_torch.models import layers

    seen, run = {}, layers.int8_conv

    def record(xq, wq, scale, bias, *, stride, act, out_scale=None, out_f32=False, cout=None):
        out = "s8" if out_scale is not None else "f32" if out_f32 else "bf16"
        # an uncalibrated net's dynamic scales: a row of the table per image
        per_image = scale.dim() == 2 and scale.shape[0] > 1
        key = (tuple(xq.shape), IC.channel_pitch(xq), cout or wq.shape[0], wq.shape[1], stride,
               act, out, bias is not None, per_image)
        seen[key] = seen.get(key, 0) + 1
        return run(xq, wq, scale, bias, stride=stride, act=act, out_scale=out_scale,
                   out_f32=out_f32, cout=cout)

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
    for (shape, pitch, cout, k, stride, act, out, has_bias, per_image), calls in sorted(
        shapes.items(), key=lambda kv: -kv[1] * kv[0][0][0] * kv[0][0][1] * kv[0][0][2] * kv[0][2]
    ):
        xq, wq, scale, b = conv_operands(gen, shape, pitch, cout, k, torch, bias=has_bias)
        if per_image:  # images at dynamic input scales up to ~12x apart
            scale = scale * (torch.rand(shape[0], generator=gen, device="cuda") * 3 + 0.25)[:, None]
        # as the module tree gives them: widths padded to multiples of 8
        # (``QConv2d.kernel_weight``, ``conv_epilogue``), the conv's own cout
        args = (xq, IC.pad_weight(wq), IC.pad_channels(scale), IC.pad_channels(b))
        kw = dict(stride=stride, act=act, out_f32=out == "f32", cout=cout,
                  out_scale=torch.tensor(0.05, device="cuda") if out == "s8" else None)
        got, err = conv_against_plain(IC, torch, args, kw)
        ms, lib_ms, b = conv_yardsticks(IC, torch, args, kw, got, stride)
        n, h, w, cin = shape
        ho, wo = IC.conv_out_hw(h, w, k, stride)
        tile = IC.tile_config(n * ho * wo, cout, num_sms(torch.cuda.current_device()))
        print(f"[{tag}] {n}x{h}x{w}x{cin} (pitch {pitch}) -> {cout} k{k}/s{stride} {act} "
              f"{out}{' per-image' if per_image else ''} x{calls}/{per} tile {tile[0]}x{tile[1]}: "
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


def probe_phase(tag, ms, frames, per_tick, mods, torch):
    """``[probe-*]``: the JAX bench's two-point compute frames/s
    (``bench.py:252-278``) through ``make_compute_probe``: probes of
    ``COMPUTE_ITERS`` and twice as many chained steps on one uploaded
    tick, each captured in one CUDA graph on its first call (after one
    eager step), then timed as the best of 3 calls, each ending in the
    host fetch of its result; frames/s = iters x streams / (t_2N - t_N).
    Every kernel must be launched exactly (1 + iters) x its per-tick count
    by the first call (the eager step and the capture) and not once by
    the replays; the 2-step probe's value must equal two eager steps'.
    Returns the probe's numbers."""
    x = ms._prep_upload(frames)
    two = ms.make_compute_probe(2)(x)
    # on a mesh the upload and the step are lists of the rows' parts
    x1 = [p + 1 for p in x] if isinstance(x, list) else x + 1
    eager = sum(float(o.sum()) for step in (ms._step(x), ms._step(x1))
                for o in (step if isinstance(step, list) else [step]))
    torch.cuda.synchronize()
    rel = abs(float(two) - eager) / max(abs(eager), 1e-30)
    check(bool(torch.isfinite(two)) and rel < 1e-5,
          f"[{tag}] 2-step probe {float(two)} vs eager steps {eager}")
    out = {}
    for iters in (COMPUTE_ITERS, 2 * COMPUTE_ITERS):
        probe = ms.make_compute_probe(iters)
        reset(mods)
        t = time.perf_counter()
        float(probe(x))
        capture_s = time.perf_counter() - t
        captured = counts(mods)
        for k, per in per_tick.items():
            check(captured[k] == (1 + iters) * per,
                  f"[{tag}] {k}: {captured[k]} launches capturing {iters} steps, expected "
                  f"{(1 + iters) * per}")
        best = float("inf")
        for _ in range(3):
            t = time.perf_counter()
            float(probe(x))
            best = min(best, time.perf_counter() - t)
        check(counts(mods) == captured, f"[{tag}] a replay went through a kernel's wrapper")
        out[iters] = best
        print(f"[{tag}] {iters} chained steps: first call (eager step + capture + replay) "
              f"{capture_s * 1e3:.1f} ms, best of 3 replays {best * 1e3:.3f} ms", flush=True)
        del probe
    t1, t2 = out[COMPUTE_ITERS], out[2 * COMPUTE_ITERS]
    fps = COMPUTE_ITERS * N_STREAMS / max(t2 - t1, 1e-6)
    print(f"[{tag}] compute frames/s (two-point, {COMPUTE_ITERS} and {2 * COMPUTE_ITERS} steps "
          f"of {N_STREAMS} streams): {fps:.2f}; {(t2 - t1) * 1e3 / COMPUTE_ITERS:.3f} ms per "
          f"step; 2-step probe vs eager: relative {rel:.3g}", flush=True)
    return {"fps": fps, "t_n_ms": t1 * 1e3, "t_2n_ms": t2 * 1e3}


def int8_main_phase(mods, torch, np):
    """The calibrated int8 serving path at full width on I420
    (``[main-int8]``), its compute probe (``[probe-v8l-int8]``), then the
    same calibrated nets on JAX's default transport, bgr
    (``[main-int8-bgr]``: the frames uploaded as they are, no host
    encode)."""
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
    per_tick = {"stem": 2, "int8_conv": per_conv, "block": BLOCKS_PER_TICK, "iou": 1, "nms": 1}
    ms = MultiStreamADAS(yolo, lane, N_STREAMS, FRAME_HW, transport="i420")
    ticks = [rng.integers(0, 256, (N_STREAMS, *FRAME_HW, 3), dtype=np.uint8) for _ in range(4)]
    try:
        shapes = main_path_conv_shapes(lambda: ms._step(ms._prep_upload(ticks[0])),
                                       mods["int8_conv"], torch)
        check(sum(shapes.values()) == per_conv,
              f"recorded {sum(shapes.values())} int8 convs in a step, expected {per_conv}")
        main_path_conv_phase(mods["int8_conv"], shapes, torch)
        run = serve("main-int8", ms, mods, per_tick, ticks, 3, 8, torch, np)
        probe_phase("probe-v8l-int8", ms, ticks[0], per_tick, mods, torch)
    finally:
        ms.close()
    bgr = MultiStreamADAS(yolo, lane, N_STREAMS, FRAME_HW)
    check(bgr.transport == "bgr", f"the default transport is {bgr.transport}")
    try:
        run_bgr = serve("main-int8-bgr", bgr, mods, per_tick, ticks, 3, 8, torch, np)
    finally:
        bgr.close()
    return run, run_bgr


def uncal_int8_phase(mods, torch, np):
    """``[main-uncal-int8]``: phase 5's nets (the same seeds) left
    uncalibrated, on the bgr transport: every int8 conv quantizes each
    stream at its own dynamic scale, so the int8 conv runs its per-image
    mode (a row of the epilogue scale per image) and no block fuses.
    Every distinct int8 conv shape of a tick against its plain version
    and ``torch._int_mm`` (``[main-uncal-int8-shapes]``); stream 0's packed
    row equal to the bit whatever stream 1..7's frames are; then the ticks
    of phase 5 with per tick stem 2, block 0, every int8 conv of both
    trees, IoU 1 and walk 1.  Returns (the launch counts, the int8 conv's
    per-tick sums)."""
    tag = "main-uncal-int8"
    yolo, lane, MultiStreamADAS = build_main("int8", torch, tag=tag)
    check(all(m.xmax is None for f in (yolo, lane) for m in f.net.modules()
              if hasattr(m, "xmax")), "the uncalibrated nets hold activation scales")
    per_conv = int8_convs(yolo.net, lane.net)
    rng = np.random.default_rng(0)
    ticks = [rng.integers(0, 256, (N_STREAMS, *FRAME_HW, 3), dtype=np.uint8) for _ in range(4)]
    ms = MultiStreamADAS(yolo, lane, N_STREAMS, FRAME_HW)
    try:
        shapes = main_path_conv_shapes(lambda: ms._step(ms._prep_upload(ticks[0])),
                                       mods["int8_conv"], torch)
        check(sum(shapes.values()) == per_conv and all(key[-1] for key in shapes),
              f"recorded {sum(shapes.values())} int8 convs in a step, expected {per_conv}, "
              f"every one with a per-image scale table")
        conv = main_path_conv_phase(mods["int8_conv"], shapes, torch, tag=f"{tag}-shapes")
        other = ticks[0].copy()
        other[1:] = 255 - other[1:] // 4
        a = ms._step(ms._prep_upload(ticks[0]))
        b = ms._step(ms._prep_upload(other))
        torch.cuda.synchronize()
        check(torch.equal(a[0], b[0]) and not torch.equal(a[1], b[1]),
              f"[{tag}] stream 0's output depends on the other streams' frames")
        print(f"[{tag}] stream 0's packed row equal to the bit with streams 1-7 changed "
              f"(streams 1-7 changed: {not torch.equal(a[1:], b[1:])})", flush=True)
        run = serve(tag, ms, mods, {"stem": 2, "int8_conv": per_conv, "block": 0, "iou": 1,
                                    "nms": 1}, ticks, 3, 8, torch, np)
        return run, conv
    finally:
        ms.close()


def bf16_main_phase(mods, torch, np):
    """The bf16 serving path at full width (fewer ticks)."""
    yolo, lane, MultiStreamADAS = build_main("bf16", torch)
    rng = np.random.default_rng(0)
    ms = MultiStreamADAS(yolo, lane, N_STREAMS, FRAME_HW, transport="i420")
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
    ms = MultiStreamADAS(det, lane, N_STREAMS, FRAME_HW, transport="i420")
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


def build_frame_pipelines(tag, name, object_config, lane_config, torch, np,
                          routes=("fused", "unfused")):
    """``ADASPipeline`` on the card for each route (fused, the default, and
    unfused) from the same configs and seeds; an int8 facade calibrated
    from the same two 720p frames.  Fails unless the routes' nets hold the
    same weights and scales."""
    from adas_tpu_torch.pipeline.app import ADASPipeline

    h, w = FRAME_HW
    calib = list(np.random.default_rng(7).integers(0, 256, (2, h, w, 3), dtype=np.uint8))
    pipes = {}
    for route in routes:
        t = time.perf_counter()
        pipe = ADASPipeline(frame_size=(w, h), use_fused=route == "fused", device="cuda",
                            object_config=object_config, lane_config=lane_config)
        check((pipe.fused is not None) == (route == "fused"), f"{tag}: {route} route not taken")
        int8 = [f for f in (pipe.objectDetector, pipe.laneDetector)
                if getattr(f, "compute_dtype", None) == "int8"]
        for facade in int8:
            facade.calibrate_int8(calib)
        torch.cuda.synchronize()
        print(f"[{tag}] built the {route} route's ADASPipeline ({name}"
              f"{', int8 calibrated from 2 frames' if int8 else ''}) in "
              f"{time.perf_counter() - t:.2f} s", flush=True)
        pipes[route] = pipe
    for side in ("objectDetector", "laneDetector"):
        nets = [getattr(pipes[r], side).net.state_dict() for r in pipes]
        for other in nets[1:]:
            check(nets[0].keys() == other.keys()
                  and all(torch.equal(nets[0][k], other[k]) for k in other),
                  f"{tag}: the routes' {side} nets differ")
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
    ms = MultiStreamADAS(yolo, lane, N_STREAMS, FRAME_HW, transport="i420")
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
    # the stem's other batch-1 sites (the f32 pipelines run the serving two
    # in f32 too): each dtype's time by site
    sites_ms = {}
    for dname, atol, rtol in STEM_DTYPES:
        dtype = getattr(torch, dname)
        others = [(*site, 64) for site in STEM_SITES] if dname == "float32" else []
        for name, shape, k, act, pool, feat in [*others, *FRAME_STEM_SITES]:
            sites_ms[f"{name} {dname}"] = stem_case(S, torch, gen, name, shape, k, act, pool,
                                                    dtype, atol, rtol, feat)[1]
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
                 "bound": total_bound([r[4] for r in stem]), "sites_ms": sites_ms},
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
    Returns (launch counts of both routes, batch-1 rows or None, the
    pipelines by route)."""
    from adas_tpu_torch.models.quant import QConv2d

    from adas_tpu_torch.utils.types import LaneModelType

    tag = f"frame-{cd}"
    pipes = build_frame_pipelines(
        tag, "YOLOv8l-640 + UFLDv2-CULane",
        {"scale": "l", "input_size": (640, 640), "box_score": 0.25, "compute_dtype": cd,
         "seed": 0},
        {"model_type": LaneModelType.UFLDV2_CULANE, "compute_dtype": cd, "seed": 1}, torch, np)
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
        return run, None, pipes
    fused = pipes["fused"]
    shapes = main_path_conv_shapes(lambda: fused.fused.run(frames[0]), mods["int8_conv"], torch)
    check(sum(shapes.values()) == per_frame["int8_conv"],
          f"recorded {sum(shapes.values())} int8 convs in a frame, expected "
          f"{per_frame['int8_conv']}")
    i420_vs_multistream(tag, fused, frames, np)
    rows = frame_kernel_phase(mods, shapes, torch)
    for k, r in rows.items():
        r["launches_per_frame"] = per_frame[k]
    return run, rows, pipes


def reset_pipeline(pipe):
    """Put a pipeline's host state back to that of a new one on the same
    nets: tracker (and the id counter), trapezoid, signals, distances,
    panel, timers."""
    from adas_tpu_torch.analytics import (PerspectiveTransformation, SingleCamDistanceMeasure,
                                          TaskConditions)
    from adas_tpu_torch.pipeline.panel import ControlPanel
    from adas_tpu_torch.utils.profiling import StageTimers

    h, w = FRAME_HW
    pipe.objectTracker.reset()
    pipe.transformView = PerspectiveTransformation((w, h), logger=pipe.logger, device="cuda")
    pipe.distanceDetector = SingleCamDistanceMeasure()
    pipe.analyzeMsg = TaskConditions()
    pipe.displayPanel = ControlPanel()
    pipe.timers = StageTimers()


def signals(pipe):
    """Track ids (tracked, lost) and the three signals after a frame."""
    msg, tr = pipe.analyzeMsg, pipe.objectTracker
    return ([t.track_id for t in tr.tracked_stracks], [t.track_id for t in tr.lost_stracks],
            msg.offset_msg, msg.curvature_msg, msg.collision_msg)


class Timed:
    """Replaces ``owner.name`` with a wrapper that adds each call's host
    time to ``ms[key]`` (undone on exit)."""

    def __init__(self, ms, key, *targets):
        self.ms, self.key, self.targets, self.saved = ms, key, targets, []

    def __enter__(self):
        self.ms.setdefault(self.key, 0.0)
        for owner, name in self.targets:
            fn = getattr(owner, name)

            def timed(*a, _fn=fn, **kw):
                t = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.ms[self.key] += (time.perf_counter() - t) * 1e3

            self.saved.append((owner, name, fn))
            setattr(owner, name, timed)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)


def render_phase(pipe, mods, smi, torch, np):
    """Phase 10 (``[render-int8]``): the demo's video path with the HUD on
    the card.  Ten seeded 720p frames go to a temporary ``.y4m`` through
    the port's writer; ``run_video`` processes them with phase 8's
    calibrated fused pipeline (reset to a new pipeline's host state) and
    writes the drawn frames.  Fails unless the output has 10 frames of
    720x1280 under a valid header, every output frame differs from its
    input in the signs panel and the bird-view inset, every frame
    launched exactly 2 stem / 105 int8 conv / 5 block / 1 IoU / 1 walk
    kernels, and the track ids and signals equal those of a
    ``draw=False`` pass over the same decoded frames from the same reset
    state.  Prints process_frame p50/p95, the ``analytics_render`` stage
    with drawing and of it the panel, the text and the two
    ``add_weighted`` passes, and the reader's and writer's ms per frame.
    Returns the launch counts of the run."""
    import os
    import tempfile

    import adas_tpu_torch.analytics.perspective as persp
    import adas_tpu_torch.perception.object_detector as objdet
    import adas_tpu_torch.pipeline.panel as panel
    import adas_tpu_torch.render.draw as draw
    import adas_tpu_torch.tracking.core as core
    from adas_tpu_torch.models.quant import QConv2d
    from adas_tpu_torch.pipeline import app
    from adas_tpu_torch.render.video import Y4MReader, Y4MWriter

    tag = "render-int8"
    h, w = FRAME_HW
    n_conv = sum(isinstance(m, QConv2d) for side in ("objectDetector", "laneDetector")
                 for m in getattr(pipe, side).net.modules())
    per_frame = {"stem": 2, "int8_conv": n_conv - 2 * BLOCKS_PER_TICK, "block": BLOCKS_PER_TICK,
                 "iou": 1, "nms": 1}
    rng = np.random.default_rng(10)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(N_FRAMES)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    src, out = os.path.join(tmp, "in.y4m"), os.path.join(tmp, "in_out.y4m")
    try:
        t = time.perf_counter()
        with Y4MWriter(src, w, h, 30.0) as vw:
            for f in frames:
                vw.write(f)
        write_ms = (time.perf_counter() - t) * 1e3 / N_FRAMES

        reset_pipeline(pipe)
        drawn_signals, frame_ms, sub = [], [], {}
        serve_frame = pipe.process_frame

        def process_frame(frame, draw=True):
            t0 = time.perf_counter()
            shown = serve_frame(frame, draw)
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            drawn_signals.append(signals(pipe))
            return shown

        pipe.process_frame = process_frame
        panel_targets = [(pipe.displayPanel, m) for m in
                         ("DisplayBirdViewPanel", "DisplaySignsPanel", "DisplayCollisionPanel")]
        text_targets = [(m, "put_text") for m in (panel, core, objdet, persp)]
        factory = app.ADASPipeline
        app.ADASPipeline = lambda frame_size, **kw: pipe
        reset(mods)
        try:
            with Timed(sub, "panel", *panel_targets), Timed(sub, "text", *text_targets), \
                    Timed(sub, "add_weighted", (draw, "add_weighted")):
                n = app.run_video(src, out, device="cuda")
            torch.cuda.synchronize()
        finally:
            app.ADASPipeline = factory
            del pipe.process_frame
        run = counts(mods)
        check(n == N_FRAMES, f"{tag}: run_video processed {n} frames")
        for k, per in per_frame.items():
            check(run[k] == per * N_FRAMES, f"{tag}: {k} launches {run[k]} over {N_FRAMES} "
                                            f"frames, expected {per} per frame")
        stage = pipe.timers.summary()["analytics_render"]

        t = time.perf_counter()
        with Y4MReader(out) as vr:
            check((vr.width, vr.height) == (w, h), f"{tag}: output header {vr.width}x{vr.height}")
            drawn = list(vr)
        read_ms = (time.perf_counter() - t) * 1e3 / max(1, len(drawn))
        with Y4MReader(src) as vr:
            decoded = list(vr)
        check(len(drawn) == N_FRAMES and all(f.shape == (h, w, 3) for f in drawn),
              f"{tag}: the output holds {len(drawn)} frames")
        inset = (slice(0, int(h * 0.25) + 20), slice(w - int(w * 0.25) - 20, w))
        for i, (a, b) in enumerate(zip(decoded, drawn)):
            check(not np.array_equal(a[:365, :400], b[:365, :400]),
                  f"{tag}: frame {i}: the signs panel is not drawn")
            check(not np.array_equal(a[inset], b[inset]), f"{tag}: frame {i}: no bird-view inset")

        reset_pipeline(pipe)
        plain = []
        for f in decoded:
            pipe.process_frame(f, draw=False)
            plain.append(signals(pipe))
        same = sum(a == b for a, b in zip(drawn_signals, plain))
        print(f"[{tag}] run_video over {N_FRAMES} frames of {w}x{h} (.y4m in and out): launches "
              f"{run} (per frame {per_frame}); track ids and signals equal to a draw=False pass "
              f"on {same} of {N_FRAMES} frames; detections on the last frame "
              f"{len(pipe.objectDetector.object_info)}", flush=True)
        check(same == N_FRAMES, f"{tag}: drawing changed the track ids or signals")
        print(f"[{tag}] process_frame(draw=True) ms p50 {np.percentile(frame_ms, 50):.3f}, p95 "
              f"{np.percentile(frame_ms, 95):.3f}, all {[round(v, 3) for v in frame_ms]}; "
              f"analytics_render with drawing p50 {stage['p50_ms']:.3f}, p95 "
              f"{stage['p95_ms']:.3f}; of it per frame: panel "
              f"{sub['panel'] / N_FRAMES:.3f}, text {sub['text'] / N_FRAMES:.3f} (all put_text, "
              f"the panel's included), add_weighted x2 {sub['add_weighted'] / N_FRAMES:.3f}; "
              f"Y4M writer {write_ms:.3f} ms/frame, reader {read_ms:.3f} ms/frame; {smi}",
              flush=True)
        return run
    finally:
        for path in (src, out):
            if os.path.exists(path):
                os.remove(path)
        os.rmdir(tmp)


def families_phase(mods, torch, np):
    """``[families]``: every ported YOLO family at every scale (v5, v8, v10
    at n, s, m, l, x; v10 also NMS-free) and the UFLD v1 (TuSimple,
    CULane) and UFLDv2-CurveLanes lane facades, f32, built on the card by
    default (no ``device`` named) from seeded weights, each through one
    ``DetectFrame`` of a 720p frame after a warm-up.  Per frame: the stem
    kernel once for v8 and v10 (at the scale's 16-80 features; v5's stem is
    a plain conv) and once for every lane net, IoU and walk once for every
    YOLO but the NMS-free one; detections finite and at most ``max_det``.
    The int8 cases' warm-up frames record their int8 conv shapes
    (:func:`main_path_conv_shapes`, one call per int8 conv of the tree).
    Returns (the launch counts, the recorded shapes summed over the int8
    cases)."""
    from adas_tpu_torch.perception.lane_detector import (UltrafastLaneDetector,
                                                         UltrafastLaneDetectorV2)
    from adas_tpu_torch.perception.object_detector import YoloDetector
    from adas_tpu_torch.utils.types import LaneModelType, ObjectModelType

    T = ObjectModelType
    frame = np.random.default_rng(9).integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8)
    calib = list(np.random.default_rng(10).integers(0, 256, (2, *FRAME_HW, 3), dtype=np.uint8))
    total = {k: 0 for k in KERNELS}
    shapes = {}  # the int8 conv shapes of the int8 cases' frames, summed
    cases = [(t, scale, False, None) for t in (T.YOLOV5, T.YOLOV8, T.YOLOV10)
             for scale in ("n", "s", "m", "l", "x")] + [(T.YOLOV10, "s", True, None)]
    # v5-lite, v6, v7, v9 (no Pallas stem in JAX: a plain first conv), f32 and
    # calibrated int8: every int8 conv of the module tree once per frame
    cases += [(t, scale, False, cd) for t, scales in
              ((T.YOLOV5_LITE, "esg"), (T.YOLOV6, "nsml"), (T.YOLOV7, "n"), (T.YOLOV9, "c"))
              for scale in scales for cd in (None, "int8")]
    for model_type, scale, nms_free, cd in cases:
        det = YoloDetector(model_type=model_type, scale=scale, nms_free=nms_free,
                           compute_dtype=cd, seed=0)
        check(det.device.type == "cuda", f"{model_type.name}-{scale} built on {det.device}")
        if cd == "int8":
            det.calibrate_int8(calib)
            # the warm-up, recorded: every int8 conv shape of the frame
            seen = main_path_conv_shapes(lambda: det.DetectFrame(frame), mods["int8_conv"],
                                         torch)
            check(sum(seen.values()) == int8_convs(det.net),
                  f"[families] {model_type.name}-{scale}: recorded {sum(seen.values())} int8 "
                  f"convs in a frame, expected {int8_convs(det.net)}")
            for key, calls in seen.items():
                shapes[key] = shapes.get(key, 0) + calls
        else:
            det.DetectFrame(frame)  # warm-up
        reset(mods)
        t = time.perf_counter()
        det.DetectFrame(frame)
        ms = (time.perf_counter() - t) * 1e3
        run = counts(mods)
        stem = int(det.spec.family in ("v8", "v10"))
        want = {"stem": stem, "int8_conv": int8_convs(det.net) if cd == "int8" else 0,
                "block": 0, "iou": int(not nms_free), "nms": int(not nms_free)}
        objs = det.object_info
        first = det.net.net.stem.conv if det.spec.family in ("v5", "v8", "v10") else None
        print(f"[families] {model_type.name}-{det.spec.scale}{' NMS-free' if nms_free else ''} "
              f"{cd or 'f32'}{f' (stem {first.out_channels} features)' if first else ''}: "
              f"DetectFrame {ms:.2f} ms, {len(objs)} detections, launches {run}", flush=True)
        check(run == want, f"[families] {model_type.name}-{scale}: launches {run}, expected {want}")
        check(len(objs) <= det.max_det and all(np.isfinite([o.x, o.y, o.width, o.height, o.conf])
                                               .all() for o in objs), "bad detections")
        total = {k: total[k] + run[k] for k in KERNELS}
    for cls, lane_type, cd in ((UltrafastLaneDetector, LaneModelType.UFLD_TUSIMPLE, None),
                               (UltrafastLaneDetector, LaneModelType.UFLD_CULANE, "bf16"),
                               (UltrafastLaneDetector, LaneModelType.UFLD_CULANE, "int8"),
                               (UltrafastLaneDetectorV2, LaneModelType.UFLDV2_CURVELANES, None)):
        lane = cls(model_type=lane_type, compute_dtype=cd, seed=1)
        if cd == "int8":  # UFLD v1's int8 is uncalibrated (dynamic scales), as in JAX
            seen = main_path_conv_shapes(lambda: lane.DetectFrame(frame), mods["int8_conv"],
                                         torch)
            for key, calls in seen.items():
                shapes[key] = shapes.get(key, 0) + calls
        else:
            lane.DetectFrame(frame)
        reset(mods)
        t = time.perf_counter()
        lane.DetectFrame(frame)
        ms = (time.perf_counter() - t) * 1e3
        run = counts(mods)
        print(f"[families] {lane_type.name} {cd or 'f32'}: DetectFrame {ms:.2f} ms, lanes "
              f"{lane.lane_info.lanes_status}, launches {run}", flush=True)
        n_int8 = int8_convs(lane.net) if cd == "int8" else 0
        check(run == {"stem": 1, "int8_conv": n_int8, "block": 0, "iou": 0, "nms": 0}
              and len(lane.lane_info.lanes_status) == 4, f"[families] {lane_type.name} {cd}")
        total = {k: total[k] + run[k] for k in KERNELS}
    return total, shapes


#: ResNet-34's fused ``layer1`` blocks per batch (40x160x64 at a 160x640
#: input and 80x400x64 at the served 320x1600 pass the gate); ResNet-50's
#: Bottlenecks never fuse
LANE_RES_BLOCKS = {"34": 3, "50": 0}
#: int8 UFLDv2, GPU kernels against CPU plain versions on the same packed
#: and calibrated net: relative L2 bound of each output (ResNet-18's, phase 4)
LANE_INT8_BOUND = 3e-2


def lane_depth_phase(depth, mods, torch, np):
    """``[lane-res34]`` / ``[lane-res50]``: UFLDv2 on a ResNet-34 or
    ResNet-50 trunk (CULane's crop, a 160x640 input, a 64-wide MLP:
    ``int8_reference_phase``'s narrowed head), GPU against CPU on the same
    seeded weights and two inputs.  f32: the 7x7 stem kernel and cuDNN with
    TF32 off, rtol 1e-3 with an atol of 1e-3 of the largest magnitude.
    int8, packed and calibrated on the CPU: every output within
    ``LANE_INT8_BOUND`` relative L2 of the CPU's (the stem kernel's bf16
    output is one ulp off its plain version on a few values, and a deep
    random int8 trunk spreads each s8 value that moves); and given the
    GPU's stem output, the CPU's trunk must give the GPU's three stage
    outputs to the bit (the int8 conv and the block equal their plain
    versions, the BN folds are the host's).  Exact launches on the GPU:
    stem 1, and in int8 the fused ``layer1`` blocks (3 for ResNet-34,
    none for ResNet-50's Bottlenecks) and every other int8 conv of the
    tree.  Returns the GPU runs' launch counts."""
    from adas_tpu_torch.models import resnet, ufld
    from adas_tpu_torch.models.quant import pack_int8_weights
    from adas_tpu_torch.ops.block import fuse_gate
    from adas_tpu_torch.perception.object_detector import calibrate
    from adas_tpu_torch.weights import init_params

    tag = f"lane-res{depth}"
    culane = ufld.UFLDV2_SPECS[ufld.LaneModelType.UFLDV2_CULANE]
    spec = ufld.UFLDv2Spec(input_height=160, input_width=640, crop_ratio=culane.crop_ratio,
                           num_cell_row=20, num_row=72, num_cell_col=10, num_col=16, mlp_mid=64,
                           backbone=depth)
    check(fuse_gate(40, 160, 64), "ResNet layer1 at 160x640 does not pass the fusion gate")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 3, 160, 640))
                         .astype(np.float32))
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))  # noqa: E731
    total = {k: 0 for k in KERNELS}
    for int8 in (False, True):
        net = ufld.UFLDv2Net(spec, int8=int8)
        init_params(net, 40 + int(depth))  # the same weights in both precisions
        net.eval().requires_grad_(False)
        blocks = LANE_RES_BLOCKS[depth] if int8 else 0
        want_run = {"stem": 1, "int8_conv": int8_convs(net) - 2 * blocks if int8 else 0,
                    "block": blocks, "iou": 0, "nms": 0}
        t = time.perf_counter()
        if int8:
            pack_int8_weights(net)
            calibrate(net, [x[:1], x[1:]])
        xin = x.to(torch.bfloat16 if int8 else torch.float32)
        outs, trunk = {}, {}
        net.backbone.register_forward_hook(lambda m, i, o: trunk.update(
            {str(o[0].device.type): tuple(f.float().cpu() for f in o)}))
        stem_run, stems = resnet.consume_stem, []
        with torch.inference_mode():
            outs["cpu"] = net(xin)
            net.to("cuda")
            reset(mods)
            resnet.consume_stem = lambda *a, **k: stems.append(stem_run(*a, **k)) or stems[-1]
            try:
                outs["cuda"] = net(xin.to("cuda"))
            finally:
                resnet.consume_stem = stem_run
            run = counts(mods)
            if int8:  # the CPU trunk on the GPU's stem output
                net.to("cpu")
                gpu_trunk = trunk["cuda"]
                resnet.consume_stem = lambda *a, **k: stems[0].cpu()
                try:
                    net(xin)
                finally:
                    resnet.consume_stem = stem_run
        outs = {dev: {k: v.float().cpu().numpy() for k, v in y.items()} for dev, y in outs.items()}
        name = "int8" if int8 else "f32"
        n_blocks = sum(isinstance(m, (resnet.BasicBlock, resnet.Bottleneck))
                       for m in net.modules())
        print(f"[{tag}] {name}: {n_blocks} blocks, built{' and calibrated' if int8 else ''} and "
              f"run on both devices in {time.perf_counter() - t:.1f} s; GPU launches {run} "
              f"(expected {want_run})", flush=True)
        check(run == want_run, f"[{tag}] {name}: launches {run}, expected {want_run}")
        for k, want in outs["cpu"].items():
            got = outs["cuda"][k]
            check(got.shape == want.shape and np.all(np.isfinite(got)), f"[{tag}] {k}: bad output")
            if int8:
                err = rel(got, want)
                print(f"[{tag}] int8 {k} {want.shape}: GPU vs CPU relative L2 {err:.3g} (bound "
                      f"{LANE_INT8_BOUND}); against the f32 net GPU {rel(got, f32_out[k]):.3g}, "
                      f"CPU {rel(want, f32_out[k]):.3g}", flush=True)
                check(err < LANE_INT8_BOUND, f"[{tag}] int8 {k}: GPU and CPU disagree ({err})")
            else:
                scale = float(np.abs(want).max())
                print(f"[{tag}] f32 {k} {want.shape}: max_abs_err "
                      f"{float(np.abs(got - want).max()):.3g} (scale {scale:.3g})", flush=True)
                np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * scale)
        if int8:
            same = [torch.equal(a, b) for a, b in zip(gpu_trunk, trunk["cpu"])]
            print(f"[{tag}] int8 trunk on the GPU's stem output: stage outputs "
                  f"{[tuple(f.shape) for f in gpu_trunk]} equal to the bit on the CPU: {same}",
                  flush=True)
            check(all(same), f"[{tag}] int8 trunk: GPU and CPU stage outputs differ")
        f32_out = outs["cpu"]
        total = {k: total[k] + run[k] for k in KERNELS}
        del net
    return total


def lane_served_phase(mods, torch, np):
    """``[lane-res34-served]`` / ``[lane-res50-served]``: each deeper trunk
    in its served configuration: UFLDv2-CULane at the config's 320x1600
    and published head (``configs/ufldv2/culane_res34.py`` read by
    ``Config.fromfile``; ResNet-50 on the same geometry, which no config
    file names), built by ``UltrafastLaneDetectorV2(backbone=...)`` beside
    YOLOv8l-640 in ``MultiStreamADAS`` at 8 streams of 720p on its default
    transport (bgr), in f32 and then calibrated int8 (both nets calibrated
    on the card from 2 frames).  int8: every distinct int8 conv shape of
    the lane net against its plain version and ``torch._int_mm``
    (``[lane-res34-shapes]``), each fused block shape against
    ``block_reference`` to the bit; then the ticks with exact launches:
    per tick stem 2, the fused bodies (YOLOv8l's and ResNet-34's 3
    ``layer1`` blocks), every other int8 conv of both trees, IoU 1 and
    walk 1.  Returns (the launch counts, {path: {kernel: per-tick sums}},
    {path: int8 launches per tick})."""
    import os

    from adas_tpu_torch.models import resnet
    from adas_tpu_torch.perception.lane_detector import LaneModelType, UltrafastLaneDetectorV2
    from adas_tpu_torch.perception.object_detector import ObjectModelType, YoloDetector
    from adas_tpu_torch.pipeline.multistream import MultiStreamADAS
    from adas_tpu_torch.utils.config import CONFIG_DIR, Config

    cfg = Config.fromfile(os.path.join(CONFIG_DIR, "culane_res34.py"))
    check(cfg.backbone == "34", f"culane_res34.py names backbone {cfg.backbone}")
    IC, B = mods["int8_conv"], mods["block"]
    rng = np.random.default_rng(0)
    calib = list(rng.integers(0, 256, (2, *FRAME_HW, 3), dtype=np.uint8))
    ticks = [rng.integers(0, 256, (N_STREAMS, *FRAME_HW, 3), dtype=np.uint8) for _ in range(4)]
    gen = torch.Generator(device="cuda").manual_seed(4)
    total = {k: 0 for k in KERNELS}
    sums, per_ticks = {}, {}
    for cd in (None, "int8"):
        yolo = YoloDetector(model_type=ObjectModelType.YOLOV8, scale="l", input_size=(640, 640),
                            box_score=0.25, compute_dtype=cd, device="cuda", seed=0)
        if cd:
            yolo.calibrate_int8(calib)
        for depth in ("34", "50"):
            tag = f"lane-res{depth}-served"
            t = time.perf_counter()
            lane = UltrafastLaneDetectorV2(model_type=LaneModelType.UFLDV2_CULANE,
                                           compute_dtype=cd, device="cuda", seed=1,
                                           backbone=cfg.backbone if depth == "34" else depth)
            s = lane.spec
            check((s.input_height, s.input_width, s.crop_ratio, s.num_cell_row, s.num_row,
                   s.num_cell_col, s.num_col, s.fc_norm, s.backbone, s.mlp_mid)
                  == (cfg.train_height, cfg.train_width, cfg.crop_ratio, cfg.num_cell_row,
                      cfg.num_row, cfg.num_cell_col, cfg.num_col, cfg.fc_norm, depth, 2048),
                  f"[{tag}] the facade's spec {s} is not the config's")
            if cd:
                lane.calibrate_int8(calib)
            torch.cuda.synchronize()
            lane_blocks = LANE_RES_BLOCKS[depth] if cd else 0
            blocks = lane_blocks + (yolo_fused_bodies(yolo.net, yolo.spec.input_size) if cd else 0)
            lane_conv = int8_convs(lane.net) - 2 * lane_blocks if cd else 0
            per_tick = {"stem": 2, "block": blocks, "iou": 1, "nms": 1,
                        "int8_conv": int8_convs(yolo.net, lane.net) - 2 * blocks if cd else 0}
            n_blocks = sum(isinstance(m, (resnet.BasicBlock, resnet.Bottleneck))
                           for m in lane.net.modules())
            print(f"[{tag}] {cd or 'f32'}: YOLOv8l-640 + UFLDv2-CULane on ResNet-{depth} "
                  f"({n_blocks} blocks, {s.input_height}x{s.input_width}, MLP {s.mlp_mid}) "
                  f"built{' and calibrated' if cd else ''} in {time.perf_counter() - t:.2f} s; "
                  f"per tick {per_tick}", flush=True)
            ms = MultiStreamADAS(yolo, lane, N_STREAMS, FRAME_HW)
            try:
                if cd:
                    path = f"lane_res{depth}_tick"
                    # the lane net's int8 convs and fused blocks on the tick's
                    # input shape (the bgr route feeds it f32)
                    x = torch.randn((N_STREAMS, 3, s.input_height, s.input_width), device="cuda")
                    seen, run_block = {}, resnet.fused_block

                    def record_block(xq, *a, **kw):
                        seen[tuple(xq.shape)] = seen.get(tuple(xq.shape), 0) + 1
                        return run_block(xq, *a, **kw)

                    resnet.fused_block = record_block
                    try:
                        with torch.inference_mode():
                            shapes = main_path_conv_shapes(lambda: lane.net(x), IC, torch)
                    finally:
                        resnet.fused_block = run_block
                    check(sum(shapes.values()) == lane_conv
                          and sum(seen.values()) == lane_blocks,
                          f"[{tag}] recorded {sum(shapes.values())} int8 convs and "
                          f"{sum(seen.values())} blocks in the lane net, expected {lane_conv}, "
                          f"{lane_blocks}")
                    conv = main_path_conv_phase(IC, shapes, torch, tag=f"lane-res{depth}-shapes")
                    blk = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
                    for shape, calls in seen.items():
                        _, bms, plain_ms, _, b = block_case(
                            IC, B, torch, gen, f"lane-res{depth} layer1 x{calls}/tick", shape,
                            ("relu", None, "relu"))
                        blk = {"ms": blk["ms"] + calls * bms,
                               "plain_ms": blk["plain_ms"] + calls * plain_ms,
                               "bound_ms": blk["bound_ms"] + calls * b[0]}
                    sums[path] = {"int8_conv": conv, "block": blk}
                    per_ticks[path] = per_tick
                run = serve(f"{tag}-{cd or 'f32'}", ms, mods, per_tick, ticks, 2, 4, torch, np)
            finally:
                ms.close()
            total = {k: total[k] + run[k] for k in KERNELS}
            del lane, ms
        del yolo
    return total, sums, per_ticks


#: the stride of each C2f of a YOLO neck and backbone (640 input: 160x160
#: at stage1), which decides the fusion gate of its bottlenecks
C2F_STRIDES = {"stage1": 4, "stage2": 8, "stage3": 16, "stage4": 32, "fpn4": 16, "fpn3": 8,
               "pan4": 16, "pan5": 32}
#: UFLDv2-CULane's fused bodies (ResNet layer1's two, 80x400x64)
LANE_BLOCKS = 2


def yolo_fused_bodies(net, hw) -> int:
    """How many bottleneck bodies of a calibrated int8 YOLO net run as one
    fused block at input ``hw``: each C2f's ``n`` where the gate passes at
    its stride and width (C3 bodies are 1x1 -> 3x3 and never fuse)."""
    from adas_tpu_torch.models.yolo import C2f
    from adas_tpu_torch.ops.block import fuse_gate

    return sum(blk.n * fuse_gate(hw[0] // C2F_STRIDES[name], hw[1] // C2F_STRIDES[name],
                                 blk.hidden)
               for name, blk in net.net.named_children() if isinstance(blk, C2f))


def int8_convs(*modules) -> int:
    """The int8 convs (``QConv2d``) the module trees hold."""
    from adas_tpu_torch.models.quant import QConv2d

    return sum(isinstance(m, QConv2d) for mod in modules for m in mod.modules())


def v10_config5_phase(mods, torch, np):
    """``[main-v10-int8]``: the JAX bench's config 5 (``bench.py:421-470``,
    ``c5_v10s_int8_nmsfree_8streams``) on the port's I420 transport: 8
    streams of 720x1280, YOLOv10s-640 calibrated int8 through its
    one-to-one head with no NMS (``nms_free``, box_score 0.25) beside
    UFLDv2-CULane int8, both calibrated on the card from 2 frames; at 720p
    first.  Every distinct int8 conv shape against its plain
    version first (``[v10-int8-shapes]``), then the ticks: per tick stem 2
    (the 32-feature YOLO stem, the lane stem), the fused bodies the gate
    passes, the module tree's other int8 convs (the trunk and the
    one-to-one head: the one-to-many head does not run), IoU 0 and walk 0;
    then the ticks with the bench's ``host_downscale`` and the compute
    probe there (:func:`downscaled_serve`).  Returns (the launch counts,
    the int8 conv's per-tick sums)."""
    from adas_tpu_torch.perception.lane_detector import LaneModelType, UltrafastLaneDetectorV2
    from adas_tpu_torch.perception.object_detector import ObjectModelType, YoloDetector
    from adas_tpu_torch.pipeline.multistream import MultiStreamADAS

    tag = "main-v10-int8"
    t0 = time.perf_counter()
    yolo = YoloDetector(model_type=ObjectModelType.YOLOV10, scale="s", input_size=(640, 640),
                        box_score=0.25, compute_dtype="int8", nms_free=True, device="cuda", seed=0)
    lane = UltrafastLaneDetectorV2(model_type=LaneModelType.UFLDV2_CULANE, compute_dtype="int8",
                                   device="cuda", seed=1)
    check(yolo.spec.channels[0] == 32 and yolo.spec.channels[4] == 512,
          f"not YOLOv10s: {yolo.spec.channels}")
    rng = np.random.default_rng(0)
    calib = list(rng.integers(0, 256, (2, *FRAME_HW, 3), dtype=np.uint8))
    yolo.calibrate_int8(calib)
    lane.calibrate_int8(calib)
    torch.cuda.synchronize()
    blocks = yolo_fused_bodies(yolo.net, yolo.spec.input_size) + LANE_BLOCKS
    per_conv = int8_convs(yolo.net.net, yolo.net.head_o2o, lane.net) - 2 * blocks
    print(f"[{tag}] built and calibrated YOLOv10s-640 (int8, NMS-free) + UFLDv2-CULane (int8) "
          f"in {time.perf_counter() - t0:.2f} s; module tree: {blocks} fused bodies, "
          f"{per_conv} other int8 convs per tick", flush=True)
    ms = MultiStreamADAS(yolo, lane, N_STREAMS, FRAME_HW, transport="i420")
    ticks = [rng.integers(0, 256, (N_STREAMS, *FRAME_HW, 3), dtype=np.uint8) for _ in range(4)]
    try:
        shapes = main_path_conv_shapes(lambda: ms._step(ms._prep_upload(ticks[0])),
                                       mods["int8_conv"], torch)
        check(sum(shapes.values()) == per_conv,
              f"recorded {sum(shapes.values())} int8 convs in a step, expected {per_conv}")
        conv = main_path_conv_phase(mods["int8_conv"], shapes, torch, tag="v10-int8-shapes")
        per_tick = {"stem": 2, "int8_conv": per_conv, "block": blocks, "iou": 0, "nms": 0}
        run = serve(tag, ms, mods, per_tick, ticks, 3, 8, torch, np)
    finally:
        ms.close()
    run_ds, probe = downscaled_serve(tag, yolo, lane, per_tick, ticks, mods, torch, np,
                                     probe_tag="probe-config5")
    return {k: run[k] + run_ds[k] for k in KERNELS}, conv


def downscaled_serve(tag, obj, lane, per_tick, ticks, mods, torch, np, probe_tag=None):
    """The ticks of a path again with ``host_downscale=(360, 640)`` on
    I420, as the JAX bench configures config 5 and
    ``c5_efficientdet_d0_int8_8streams`` (``bench.py:461``, ``:483``; its
    pinned ``compute_fps_fixed`` geometry, ``:288``): each 720p frame
    resized on the host (``render/draw.resize_linear``) before the encode,
    the detections scaled back to 720p; the same launches per tick.  With
    ``probe_tag`` the compute probe at that geometry too.  Returns (the
    launch counts, the probe's numbers or None)."""
    from adas_tpu_torch.pipeline.multistream import MultiStreamADAS

    ms = MultiStreamADAS(obj, lane, N_STREAMS, FRAME_HW, host_downscale=HOST_DOWNSCALE,
                         transport="i420")
    check(ms.dev_hw == HOST_DOWNSCALE and ms._host_prep(ticks[0]).shape
          == (N_STREAMS, HOST_DOWNSCALE[0] * 3 // 2, HOST_DOWNSCALE[1]), "downscaled transport")
    try:
        run = serve(f"{tag}-ds360", ms, mods, per_tick, ticks, 3, 8, torch, np)
        probe = None
        if probe_tag is not None:
            probe = probe_phase(probe_tag, ms, ticks[0], per_tick, mods, torch)
        return run, probe
    finally:
        ms.close()


def int8_calls(net) -> int:
    """The int8 conv launches of one forward of a net: each int8 conv once,
    EfficientDet's head convs once per level (the heads share them across
    the five levels)."""
    from adas_tpu_torch.models.efficientdet import EfficientDet

    if isinstance(net, EfficientDet):
        return int8_convs(net) + 4 * int8_convs(net.regressor, net.classifier)
    return int8_convs(net)


def int8_pair_phase(tag, obj, lane, mods, torch, np, downscale=False):
    """A calibrated int8 object net beside UFLDv2-CULane int8 on the I420
    path, 8 streams of 720x1280 (phases 16-17): both calibrated on the card
    from 2 frames; every distinct int8 conv shape of a tick against its
    plain version (``[<tag>-shapes]``); then the ticks of phase 5 with per
    tick stem 1 and block 2 (the lane net's: the object nets have neither,
    as in JAX), the int8 conv calls of both nets less the fused bodies'
    (:func:`int8_calls`), IoU 1 and walk 1; with ``downscale`` the ticks
    again at ``host_downscale=(360, 640)`` (:func:`downscaled_serve`).
    Returns (the launch counts, the int8 conv's per-tick sums)."""
    from adas_tpu_torch.pipeline.multistream import MultiStreamADAS

    rng = np.random.default_rng(0)
    calib = list(rng.integers(0, 256, (2, *FRAME_HW, 3), dtype=np.uint8))
    t0 = time.perf_counter()
    obj.calibrate_int8(calib)
    lane.calibrate_int8(calib)
    torch.cuda.synchronize()
    per_conv = int8_calls(obj.net) + int8_convs(lane.net) - 2 * LANE_BLOCKS
    print(f"[{tag}] calibrated both nets on the card in {time.perf_counter() - t0:.2f} s; "
          f"module trees: {int8_convs(obj.net)} ({int8_calls(obj.net)} calls) + "
          f"{int8_convs(lane.net)} int8 convs, {LANE_BLOCKS} fused bodies -> {per_conv} int8 "
          f"conv launches per tick", flush=True)
    ms = MultiStreamADAS(obj, lane, N_STREAMS, FRAME_HW, transport="i420")
    ticks = [rng.integers(0, 256, (N_STREAMS, *FRAME_HW, 3), dtype=np.uint8) for _ in range(4)]
    try:
        shapes = main_path_conv_shapes(lambda: ms._step(ms._prep_upload(ticks[0])),
                                       mods["int8_conv"], torch)
        check(sum(shapes.values()) == per_conv,
              f"recorded {sum(shapes.values())} int8 convs in a step, expected {per_conv}")
        conv = main_path_conv_phase(mods["int8_conv"], shapes, torch, tag=f"{tag}-shapes")
        per_tick = {"stem": 1, "int8_conv": per_conv, "block": LANE_BLOCKS, "iou": 1, "nms": 1}
        run = serve(tag, ms, mods, per_tick, ticks, 3, 8, torch, np)
    finally:
        ms.close()
    if downscale:
        run_ds, _ = downscaled_serve(tag, obj, lane, per_tick, ticks, mods, torch, np)
        run = {k: run[k] + run_ds[k] for k in KERNELS}
    return run, conv


def v9c_int8_phase(mods, torch, np):
    """``[main-v9c-int8]``: YOLOv9c-640 (GELAN-C) calibrated int8 +
    UFLDv2-CULane int8 (phase 16)."""
    from adas_tpu_torch.perception.lane_detector import LaneModelType, UltrafastLaneDetectorV2
    from adas_tpu_torch.perception.object_detector import ObjectModelType, YoloDetector

    yolo = YoloDetector(model_type=ObjectModelType.YOLOV9, scale="c", input_size=(640, 640),
                        box_score=0.25, compute_dtype="int8", device="cuda", seed=0)
    lane = UltrafastLaneDetectorV2(model_type=LaneModelType.UFLDV2_CULANE, compute_dtype="int8",
                                   device="cuda", seed=1)
    check(yolo.spec.family == "v9" and yolo.spec.scale == "c", f"not YOLOv9c: {yolo.spec}")
    return int8_pair_phase("main-v9c-int8", yolo, lane, mods, torch, np)


def effdet_int8_phase(mods, torch, np):
    """``[main-effdet-int8]``: EfficientDet-D0-512 calibrated int8
    (``box_score`` 0.3) + UFLDv2-CULane int8, the JAX bench's
    ``c5_efficientdet_d0_int8_8streams`` (phase 16), at 720p and with its
    ``host_downscale``; then ``DetectFrame`` on one 720p frame
    (``c5_efficientdet_d0_int8``): the net's int8 conv calls, IoU 1, walk
    1, no stem.  Returns (the launch counts of both, the int8 conv's
    per-tick sums)."""
    from adas_tpu_torch.perception.efficientdet_detector import EfficientdetDetector
    from adas_tpu_torch.perception.lane_detector import LaneModelType, UltrafastLaneDetectorV2

    tag = "main-effdet-int8"
    det = EfficientdetDetector(compound=0, box_score=EFFDET_INT8_BOX_SCORE, compute_dtype="int8",
                               device="cuda", seed=0)
    lane = UltrafastLaneDetectorV2(model_type=LaneModelType.UFLDV2_CULANE, compute_dtype="int8",
                                   device="cuda", seed=1)
    check(det.spec.input_size == 512 and det.spec.config[3:] == (64, 3, 3),
          f"not EfficientDet-D0 at full width: {det.spec}")
    run, conv = int8_pair_phase(tag, det, lane, mods, torch, np, downscale=True)
    frame = np.random.default_rng(11).integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8)
    det.DetectFrame(frame)  # warm-up
    torch.cuda.synchronize()
    reset(mods)
    t = time.perf_counter()
    det.DetectFrame(frame)
    ms = (time.perf_counter() - t) * 1e3
    frame_run = counts(mods)
    want = {"stem": 0, "int8_conv": int8_calls(det.net), "block": 0, "iou": 1, "nms": 1}
    objs = det.object_info
    print(f"[{tag}] DetectFrame (720p, c5_efficientdet_d0_int8): {ms:.2f} ms, {len(objs)} "
          f"detections, launches {frame_run}", flush=True)
    check(frame_run == want, f"[{tag}] DetectFrame launches {frame_run}, expected {want}")
    check(0 < len(objs) <= det.max_det and all(
        np.isfinite([o.x, o.y, o.width, o.height, o.conf]).all() for o in objs),
        "bad EfficientDet int8 detections")
    return {k: run[k] + frame_run[k] for k in KERNELS}, conv


def frame_pair_phase(tag, name, object_config, lane_config, routes, per_frame, mods, torch, np):
    """A single-frame phase on another model pair: ``process_frame(draw=
    False)`` on each route over the seeded 720p frames, exact per-frame
    launch counts, and with two routes the fused route's results equal to
    the unfused route's.  Returns (the launch counts of all routes, the
    pipelines by route, the frames)."""
    pipes = build_frame_pipelines(tag, name, object_config, lane_config, torch, np, routes)
    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8) for _ in range(N_FRAMES)]
    per = per_frame(pipes[routes[0]])
    results = {route: frame_route(tag, route, pipe, frames, mods, per, torch, np)
               for route, pipe in pipes.items()}
    if len(routes) == 2:
        same = [a == b for a, b in zip(results["fused"][0], results["unfused"][0])]
        print(f"[{tag}] fused route equal to the unfused route (detections and lanes) on "
              f"{sum(same)} of {len(same)} frames", flush=True)
        check(all(same), f"{tag}: the fused route's results differ from the unfused route's")
    return {k: sum(r[1][k] for r in results.values()) for k in KERNELS}, pipes, frames


def v10_frame_phase(mods, torch, np):
    """``[frame-v10-bf16]``: YOLOv10s-640 (the one-to-many head and NMS, as
    the JAX fused step serves it) + UFLDv2-CurveLanes (800x1600), bf16, on
    both routes: per frame stem 2, IoU 1, walk 1."""
    from adas_tpu_torch.utils.types import LaneModelType, ObjectModelType

    return frame_pair_phase(
        "frame-v10-bf16", "YOLOv10s-640 + UFLDv2-CurveLanes",
        {"model_type": ObjectModelType.YOLOV10, "scale": "s", "input_size": (640, 640),
         "box_score": 0.25, "compute_dtype": "bf16", "seed": 0},
        {"model_type": LaneModelType.UFLDV2_CURVELANES, "compute_dtype": "bf16", "seed": 1},
        ("fused", "unfused"),
        lambda pipe: {"stem": 2, "int8_conv": 0, "block": 0, "iou": 1, "nms": 1},
        mods, torch, np)[0]


def v5_frame_phase(mods, torch, np):
    """``[frame-v5-int8]``: YOLOv5s-640 calibrated int8 + UFLD v1-CULane
    bf16 on the unfused route (a v1 pair has no fused route): per frame
    stem 1 (v1's ResNet stem: v5's 6x6 stem is a plain conv), the v5 net's
    int8 convs (its C3 bodies are 1x1 -> 3x3: no fused block), IoU 1, walk
    1.  The seeded net scores most anchors ~0.25 (objectness x class,
    each ~0.5), so ``box_score`` is 0.2 here.  Then, outside the counted
    run, one ``DetectFrame`` records every int8 conv call by shape, and
    each distinct shape is held against the plain version and timed
    (``[v5-int8-shapes]``, summed per frame).  Returns (the launch counts,
    the int8 conv's per-frame sums)."""
    from adas_tpu_torch.utils.types import LaneModelType, ObjectModelType

    run, pipes, frames = frame_pair_phase(
        "frame-v5-int8", "YOLOv5s-640 + UFLD v1-CULane",
        {"model_type": ObjectModelType.YOLOV5, "scale": "s", "input_size": (640, 640),
         "box_score": 0.2, "compute_dtype": "int8", "seed": 0},
        {"model_type": LaneModelType.UFLD_CULANE, "compute_dtype": "bf16", "seed": 1},
        ("unfused",),
        lambda pipe: {"stem": 1, "int8_conv": int8_convs(pipe.objectDetector.net), "block": 0,
                      "iou": 1, "nms": 1},
        mods, torch, np)
    det = pipes["unfused"].objectDetector
    shapes = main_path_conv_shapes(lambda: det.DetectFrame(frames[0]), mods["int8_conv"], torch)
    check(sum(shapes.values()) == int8_convs(det.net),
          f"recorded {sum(shapes.values())} int8 convs in a frame, expected {int8_convs(det.net)}")
    return run, main_path_conv_phase(mods["int8_conv"], shapes, torch, tag="v5-int8-shapes",
                                     per="frame")


#: frames of the demo's synthetic run (``[demo-default]``)
DEMO_FRAMES = 4


def demo_phase(mods, smi, torch, np):
    """``[demo-default]``: ``run_synthetic`` with ``ADASPipeline``'s defaults
    (YOLOv8n f32, whose stem is the f32 kernel at 16 features, +
    UFLDv2-CULane f32, the HUD drawn) on the card, to a temporary
    ``.y4m``.  Fails unless every frame's detections are finite and
    non-empty, the file holds ``DEMO_FRAMES`` frames of 720x1280 that
    differ from the seeded inputs, and every frame launched stem 2, IoU 1
    and walk 1 (the pipeline's construction launches nothing)."""
    import os
    import tempfile

    from adas_tpu_torch.pipeline import app
    from adas_tpu_torch.render.video import Y4MReader

    tag = "demo-default"
    h, w = FRAME_HW
    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"), "demo.y4m")
    serve_frame, frame_ms, n_dets = app.ADASPipeline.process_frame, [], []

    def process_frame(pipe, frame, draw=True):
        t0 = time.perf_counter()
        shown = serve_frame(pipe, frame, draw)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        objs = pipe.objectDetector.object_info
        check(all(np.isfinite([o.x, o.y, o.width, o.height, o.conf]).all()
                  and pipe.objectDetector.box_score < o.conf <= 1 for o in objs),
              f"{tag}: bad detection")
        n_dets.append(len(objs))
        return shown

    try:
        reset(mods)
        app.ADASPipeline.process_frame = process_frame
        t = time.perf_counter()
        n = app.run_synthetic(out, frames=DEMO_FRAMES, device="cuda")
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t
        run = counts(mods)
        per_frame = {"stem": 2, "int8_conv": 0, "block": 0, "iou": 1, "nms": 1}
        for k, per in per_frame.items():
            check(run[k] == per * DEMO_FRAMES, f"{tag}: {k} launches {run[k]} over "
                                               f"{DEMO_FRAMES} frames, expected {per} per frame")
        with Y4MReader(out) as vr:
            drawn = list(vr)
        rng = np.random.default_rng(0)
        inputs = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8) for _ in range(DEMO_FRAMES)]
        check(n_dets and all(n_dets), f"{tag}: a frame without detections: {n_dets}")
        check(n == DEMO_FRAMES and len(drawn) == DEMO_FRAMES
              and all(f.shape == (h, w, 3) for f in drawn)
              and all(not np.array_equal(a, b) for a, b in zip(inputs, drawn)),
              f"{tag}: the .y4m holds {len(drawn)} drawn frames")
        print(f"[{tag}] run_synthetic (YOLOv8n f32 + UFLDv2-CULane f32, HUD) wrote {n} frames of "
              f"{w}x{h} in {total_s:.2f} s with the pipeline's construction; "
              f"process_frame(draw=True) ms {[round(v, 3) for v in frame_ms]} (the first with "
              f"the allocator's warm-up), median of the rest {np.median(frame_ms[1:]):.3f}; "
              f"detections per frame {n_dets}; launches {run} (per frame {per_frame}); {smi}",
              flush=True)
        return run
    finally:
        app.ADASPipeline.process_frame = serve_frame
        if os.path.exists(out):
            os.remove(out)
        os.rmdir(os.path.dirname(out))


def flax_tree(make, seed, torch):
    """The flat flax tree of ``make()``'s module under the port's seeded
    flax-style init, drawn on the card (``weights.init_params``)."""
    from adas_tpu_torch.weights import flax_variables, init_params

    with torch.device("cuda"):
        net = make()
    init_params(net, seed)
    return flax_variables(net)


def save_pth(path, state, torch, np):
    """``state`` (numpy, torch layouts) as a ``torch.save``d ``.pth``."""
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()}, path)
    return path


def same_tree(a, b, np) -> bool:
    """Two flat flax trees with the same keys, dtypes and bits."""
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and np.array_equal(a[k], b[k])
        for k in a)


def repvgg_train_form(state, seed, np):
    """A deploy-form YOLOv5-lite-g state dict (``.fused.*`` blocks) as
    RepVGG's training form, seeded: a 3x3 conv + BN, a 1x1 conv + BN and,
    where the block keeps its width, an identity BN per block (what a
    released training checkpoint holds; ``fuse_repvgg_state`` folds it)."""
    rng = np.random.default_rng(seed)
    out = {k: v for k, v in state.items() if ".fused." not in k}
    for key in [k for k in state if k.endswith(".fused.weight")]:
        p = key[: -len(".fused.weight")]
        o, i = state[key].shape[:2]
        for branch, k in (("rbr_dense", 3), ("rbr_1x1", 1)):
            fan_in = i * k * k
            out[f"{p}.{branch}.conv.weight"] = (rng.standard_normal((o, i, k, k)) /
                                               np.sqrt(fan_in)).astype(np.float32)
        for bn in ["rbr_dense.bn", "rbr_1x1.bn"] + (["rbr_identity"] if o == i else []):
            out[f"{p}.{bn}.weight"] = rng.uniform(0.5, 1.0, o).astype(np.float32)
            out[f"{p}.{bn}.bias"] = (0.1 * rng.standard_normal(o)).astype(np.float32)
            out[f"{p}.{bn}.running_mean"] = (0.1 * rng.standard_normal(o)).astype(np.float32)
            out[f"{p}.{bn}.running_var"] = rng.uniform(0.5, 1.5, o).astype(np.float32)
    return out


def import_main_int8_phase(tmp, mods, smi, torch, np):
    """``[import-main-int8]``: the int8 main path on weights a user brings:
    YOLOv8l-640 and UFLDv2-CULane (ResNet-18) written as ``.pth``
    checkpoints under the released names (seeded trees through the
    importers' inverse mappings), loaded by the facades (the importers,
    then the packing), calibrated on the card from two 720p frames, then
    written back (``save_params(path, flax_variables(net))``, the
    ``act_scales`` kept) and loaded into a second pair.  The two pairs'
    trees equal to the bit; one ``MultiStreamADAS`` tick of each (8
    streams of 720x1280, I420) with the int8 tick's launches (stem 2, int8
    conv 105, block 5, IoU 1, walk 1) and the same packed output, to the
    bit.  Returns (the counted tick's launches, the pair, the lane's state
    dict, the calibration frames, the tick)."""
    from adas_tpu_torch.models.ufld import UFLDV2_SPECS, UFLDv2Net
    from adas_tpu_torch.models.yolo import YoloSpec, build_yolo
    from adas_tpu_torch.perception.lane_detector import LaneModelType, UltrafastLaneDetectorV2
    from adas_tpu_torch.perception.object_detector import ObjectModelType, YoloDetector
    from adas_tpu_torch.pipeline.multistream import MultiStreamADAS
    from adas_tpu_torch.tools.params_io import save_params
    from adas_tpu_torch.tools.torch_import import ufld_state_dict
    from adas_tpu_torch.tools.yolo_import import yolo_state_dict
    from adas_tpu_torch.weights import flax_variables

    tag, culane = "import-main-int8", LaneModelType.UFLDV2_CULANE
    spec = YoloSpec("l", 80, (640, 640), family="v8")
    t = time.perf_counter()
    lane_state = ufld_state_dict(flax_tree(lambda: UFLDv2Net(UFLDV2_SPECS[culane]), 1, torch))
    pth = {"yolo": save_pth(f"{tmp}/yolov8l.pth", yolo_state_dict(
               flax_tree(lambda: build_yolo(spec), 0, torch), spec), torch, np),
           "lane": save_pth(f"{tmp}/ufldv2_culane_res18.pth", lane_state, torch, np)}
    print(f"[{tag}] wrote the YOLOv8l and UFLDv2-CULane .pth checkpoints in "
          f"{time.perf_counter() - t:.2f} s", flush=True)

    def pair(paths):
        yolo = YoloDetector(model_path=paths["yolo"], model_type=ObjectModelType.YOLOV8,
                            scale="l", input_size=(640, 640), box_score=0.25,
                            compute_dtype="int8", device="cuda")
        lane = UltrafastLaneDetectorV2(model_path=paths["lane"], model_type=culane,
                                       compute_dtype="int8", device="cuda")
        return {"yolo": yolo, "lane": lane}

    t = time.perf_counter()
    nets = pair(pth)
    torch.cuda.synchronize()
    print(f"[{tag}] .pth load and build of both nets (import, int8 packing): "
          f"{time.perf_counter() - t:.2f} s on {smi}", flush=True)
    rng = np.random.default_rng(0)
    calib = list(rng.integers(0, 256, (2, *FRAME_HW, 3), dtype=np.uint8))
    for f in nets.values():
        f.calibrate_int8(calib)
    trees = {k: flax_variables(f.net) for k, f in nets.items()}
    check(all(any(k.startswith("act_scales::") for k in tree) for tree in trees.values()),
          f"[{tag}] the written trees lack act_scales")
    t = time.perf_counter()
    npz = {k: f"{tmp}/{k}_calibrated.npz" for k in trees}
    for k, tree in trees.items():
        save_params(npz[k], tree)
    print(f"[{tag}] wrote both calibrated trees (save_params) in {time.perf_counter() - t:.2f} s",
          flush=True)
    again = pair(npz)
    for k, f in again.items():
        check(same_tree(flax_variables(f.net), trees[k], np),
              f"[{tag}] {k}: the .npz route's tree differs from the calibrated net's")
    per_conv = int8_convs(nets["yolo"].net, nets["lane"].net) - 2 * BLOCKS_PER_TICK
    per_tick = {"stem": 2, "int8_conv": per_conv, "block": BLOCKS_PER_TICK, "iou": 1, "nms": 1}
    check(per_conv == 105, f"[{tag}] {per_conv} int8 conv launches per tick, expected 105")
    ticks = [rng.integers(0, 256, (N_STREAMS, *FRAME_HW, 3), dtype=np.uint8) for _ in range(2)]
    outs, run = [], None
    for route, p in (("pth", nets), ("npz", again)):
        ms = MultiStreamADAS(p["yolo"], p["lane"], N_STREAMS, FRAME_HW, transport="i420")
        try:
            t = time.perf_counter()
            ms.process_batch(ticks[0])
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t) * 1e3
            reset(mods)
            results = ms.process_batch(ticks[1])
            torch.cuda.synchronize()
            got = counts(mods)
            check(got == per_tick, f"[{tag}] {route}: launches {got}, expected {per_tick}")
            run = run or got
            outs.append(ms._step(ms._prep_upload(ticks[1])).cpu())
        finally:
            ms.close()
        n_dets = [len(r["objects"]) for r in results]
        check(all(0 < n <= 100 for n in n_dets), f"[{tag}] {route}: detections {n_dets}")
        print(f"[{tag}] {route}: first tick {first_ms:.1f} ms on {smi}; launches per tick {got}; "
              f"detections per stream {n_dets}", flush=True)
    check(bool(torch.isfinite(outs[0]).all()) and torch.equal(outs[0], outs[1]),
          f"[{tag}] the .npz route's packed tick differs from the .pth route's")
    print(f"[{tag}] the .npz route equals the .pth route: trees and the packed tick "
          f"{tuple(outs[0].shape)}, to the bit", flush=True)
    return run, nets, lane_state, calib, ticks[1], outs[0]


def import_onnx_phase(tmp, nets, lane_state, calib, tick, want, mods, torch, np):
    """``[import-onnx]``: UFLDv2-CULane from an ``.onnx`` of the same
    initializers (the port's writer, ``read_onnx_initializers`` in the
    facade), calibrated on the same frames: its tree equals the ``.pth``
    lane's and the tick beside the same YOLOv8l equals the ``.pth`` pair's,
    to the bit.  Returns the tick's launches."""
    from adas_tpu_torch.perception.lane_detector import LaneModelType, UltrafastLaneDetectorV2
    from adas_tpu_torch.pipeline.multistream import MultiStreamADAS
    from adas_tpu_torch.tools.onnx_writer import save_model, simple_model
    from adas_tpu_torch.weights import flax_variables

    path = f"{tmp}/ufldv2_culane_res18.onnx"
    t = time.perf_counter()
    save_model(path, simple_model([], [], [], initializers=lane_state))
    t1 = time.perf_counter()
    lane = UltrafastLaneDetectorV2(model_path=path, model_type=LaneModelType.UFLDV2_CULANE,
                                   compute_dtype="int8", device="cuda")
    torch.cuda.synchronize()
    print(f"[import-onnx] wrote the .onnx of initializers in {t1 - t:.2f} s, loaded and built it "
          f"in {time.perf_counter() - t1:.2f} s", flush=True)
    lane.calibrate_int8(calib)
    check(same_tree(flax_variables(lane.net), flax_variables(nets["lane"].net), np),
          "[import-onnx] the .onnx lane's tree differs from the .pth lane's")
    ms = MultiStreamADAS(nets["yolo"], lane, N_STREAMS, FRAME_HW, transport="i420")
    try:
        ms.process_batch(tick)
        torch.cuda.synchronize()
        reset(mods)
        ms.process_batch(tick)
        torch.cuda.synchronize()
        run = counts(mods)
        got = ms._step(ms._prep_upload(tick)).cpu()
    finally:
        ms.close()
    check(torch.equal(got, want), "[import-onnx] the tick differs from the .pth pair's")
    print(f"[import-onnx] UFLDv2-CULane from .onnx: tree and tick equal to the .pth route's, "
          f"launches {run}", flush=True)
    return run


def import_families_phase(tmp, mods, torch, np):
    """``[import-families]``: one ``DetectFrame`` (720p, f32, after a
    warm-up) per YOLO family at its smallest scale from a ``.pth`` under
    the family's released names (v5-lite at g in RepVGG's training form:
    ``fuse_repvgg_state`` at ingest; v6 fused at load; v10 both heads),
    UFLD v1-TuSimple from a ``.pth`` and EfficientDet-D0 from a zylo117
    ``.pth`` with a 90-way head (the facade takes the width from the
    checkpoint); each equal, to the bit, to the same facade on the ``.npz``
    the port's ``torch_import`` CLI (EfficientDet: ``efficientdet_variables``
    + ``save_params``) makes of the checkpoint.  Then one forward of
    ``UFLDv2CurveLanesNet`` (800x1600) built through the registry and
    filled by ``ufld_curvelanes_variables``, finite and equal to the
    ``.npz`` route.  Returns the counted frames' launches."""
    from adas_tpu_torch.engine import registry
    from adas_tpu_torch.models.efficientdet import EfficientDet, EfficientDetSpec
    from adas_tpu_torch.models.ufld import UFLDV1_SPECS, UFLDv1Net
    from adas_tpu_torch.models.yolo import YoloSpec, build_yolo, resolve_spec
    from adas_tpu_torch.perception.efficientdet_detector import EfficientdetDetector
    from adas_tpu_torch.perception.lane_detector import LaneModelType, UltrafastLaneDetector
    from adas_tpu_torch.perception.object_detector import _FAMILY_OF, YoloDetector
    from adas_tpu_torch.tools import torch_import
    from adas_tpu_torch.tools.efficientdet_import import (efficientdet_state_dict,
                                                          efficientdet_variables)
    from adas_tpu_torch.tools.params_io import flatten_variables, save_params
    from adas_tpu_torch.tools.torch_import import (load_state_dict, ufld_curvelanes_variables,
                                                   ufld_state_dict)
    from adas_tpu_torch.tools.yolo_import import yolo_state_dict
    from adas_tpu_torch.utils.types import ObjectModelType as T
    from adas_tpu_torch.weights import load_flax_variables, load_npz

    frame = np.random.default_rng(12).integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8)
    total = {k: 0 for k in KERNELS}

    def cli(pth, arch, *extra):
        npz = pth[: -len(".pth")] + ".npz"
        torch_import.main(["-i", pth, "-o", npz, "--arch", arch, *extra])
        return npz

    def detect(det):
        nonlocal total
        det.DetectFrame(frame)  # warm-up
        reset(mods)
        det.DetectFrame(frame)
        run = counts(mods)
        total = {k: total[k] + run[k] for k in KERNELS}
        return run

    def rows(det):
        return [(o.label, o.conf, o.tolist()) for o in det.object_info]

    for model_type, scale in ((T.YOLOV5, "n"), (T.YOLOV5_LITE, "g"), (T.YOLOV6, "n"),
                              (T.YOLOV7, "l"), (T.YOLOV8, "n"), (T.YOLOV9, "c"), (T.YOLOV10, "n")):
        t = time.perf_counter()
        family = _FAMILY_OF[model_type]
        spec = resolve_spec(YoloSpec(scale, 80, (640, 640), family=family))
        state = yolo_state_dict(flax_tree(lambda: build_yolo(spec), 0, torch), spec)
        if family == "v5lite":
            state = repvgg_train_form(state, 13, np)
        pth = save_pth(f"{tmp}/yolo{family}{scale}.pth", state, torch, np)
        npz = cli(pth, f"yolo{family}", "--scale", scale)
        dets = [YoloDetector(model_path=path, model_type=model_type, scale=scale,
                             box_score=0.25, device="cuda") for path in (pth, npz)]
        run = detect(dets[0])
        dets[1].DetectFrame(frame)
        objs = dets[0].object_info
        check(rows(dets[0]) == rows(dets[1]), f"[import-families] {model_type.name}-{scale}: "
              "the .pth facade's detections differ from the .npz route's")
        check(run["iou"] == 1 and run["nms"] == 1 and len(objs) <= 100 and all(
              np.isfinite([o.x, o.y, o.width, o.height, o.conf]).all() for o in objs),
              f"[import-families] {model_type.name}-{scale}: launches {run}")
        print(f"[import-families] {model_type.name}-{dets[0].spec.scale} from .pth: "
              f"{len(objs)} detections, equal to the .npz route; launches {run} "
              f"({time.perf_counter() - t:.1f} s with the checkpoints)", flush=True)

    spec = UFLDV1_SPECS[LaneModelType.UFLD_TUSIMPLE]
    pth = save_pth(f"{tmp}/ufld_tusimple.pth", ufld_state_dict(
        flax_tree(lambda: UFLDv1Net(spec), 1, torch), version=1), torch, np)
    lanes = [UltrafastLaneDetector(model_path=path, model_type=LaneModelType.UFLD_TUSIMPLE,
                                   device="cuda") for path in (pth, cli(pth, "ufldv1"))]
    run = detect(lanes[0])
    lanes[1].DetectFrame(frame)
    info = [(lane.lane_info.lanes_status, [np.asarray(p).tolist() for p in
                                           lane.lane_info.lanes_points]) for lane in lanes]
    check(info[0] == info[1] and run["stem"] == 1,
          f"[import-families] UFLD v1-TuSimple: .pth and .npz routes differ ({run})")
    print(f"[import-families] UFLD_TUSIMPLE from .pth: lanes {info[0][0]}, equal to the .npz "
          f"route; launches {run}", flush=True)

    spec = EfficientDetSpec(compound=0, num_classes=90)
    pth = save_pth(f"{tmp}/efficientdet-d0.pth", efficientdet_state_dict(
        flax_tree(lambda: EfficientDet(spec), 2, torch), spec), torch, np)
    npz = f"{tmp}/efficientdet-d0.npz"
    save_params(npz, efficientdet_variables(load_state_dict(pth), spec))
    labels = f"{tmp}/coco90.txt"
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(90)))
    dets = [EfficientdetDetector(model_path=pth, box_score=EFFDET_BOX_SCORE, device="cuda"),
            EfficientdetDetector(model_path=npz, classes_path=labels, box_score=EFFDET_BOX_SCORE,
                                 device="cuda")]
    check(dets[0].spec.num_classes == 90, f"EfficientDet head {dets[0].spec.num_classes}-way")
    run = detect(dets[0])
    dets[1].DetectFrame(frame)
    # the .pth facade names its classes from the 80 COCO labels, the .npz
    # one from 90: the rows compare without the label
    check([r[1:] for r in rows(dets[0])] == [r[1:] for r in rows(dets[1])],
          "[import-families] EfficientDet-D0: .pth and .npz routes differ")
    print(f"[import-families] EfficientDet-D0 (90 classes) from .pth: "
          f"{len(dets[0].object_info)} detections, equal to the .npz route; launches {run}",
          flush=True)

    state = ufld_state_dict(flax_tree(lambda: registry.build("UFLDV2_CURVELANES").net, 3, torch),
                            curvelanes=True)
    pth = save_pth(f"{tmp}/ufldv2_curvelanes.pth", state, torch, np)
    npz = f"{tmp}/ufldv2_curvelanes.npz"
    save_params(npz, ufld_curvelanes_variables(state))
    x = torch.from_numpy(np.random.default_rng(14).standard_normal((1, 3, 800, 1600))
                         .astype(np.float32)).cuda()
    outs = []
    for flat in (flatten_variables(ufld_curvelanes_variables(load_state_dict(pth))),
                 load_npz(npz)):
        with torch.device("cuda"):
            entry = registry.build("UFLDV2_CURVELANES")
        load_flax_variables(entry.net, flat)
        with torch.inference_mode():
            outs.append({k: v.cpu() for k, v in entry.net.eval()(x).items()})
    check(entry.input_shape_nchw == (1, 3, 800, 1600)
          and all(bool(torch.isfinite(v).all()) for v in outs[0].values())
          and all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0]),
          "[import-families] UFLDv2CurveLanesNet: not finite or the routes differ")
    print(f"[import-families] UFLDv2CurveLanesNet through the registry from .pth: "
          f"{ {k: tuple(v.shape) for k, v in outs[0].items()} }, finite, equal to the .npz route",
          flush=True)
    return total


def import_int8npz_phase(tmp, mods, torch, np):
    """``[import-int8npz]``: ``quantize --mode int8 --calibrate YOLOV8`` on a
    seeded YOLOv8n ``.npz`` (8 N(0,1) frames at 640 on the card), then the
    facade serves the ``_int8.npz`` in int8: calibrated (its scales the
    store's), one ``DetectFrame`` with the int8 conv and block launches of
    the same net calibrated by the facade.  Returns that frame's
    launches."""
    from adas_tpu_torch.models.yolo import YoloSpec, build_yolo
    from adas_tpu_torch.perception.object_detector import YoloDetector
    from adas_tpu_torch.tools import quantize
    from adas_tpu_torch.tools.params_io import flatten_variables, save_params
    from adas_tpu_torch.utils.types import ObjectModelType
    from adas_tpu_torch.weights import flax_variables

    spec = YoloSpec("n", 80, (640, 640), family="v8")
    npz = f"{tmp}/yolov8n.npz"
    save_params(npz, flax_tree(lambda: build_yolo(spec), 0, torch))
    t = time.perf_counter()
    quantize.main(["-i", npz, "--mode", "int8", "--calibrate", "YOLOV8", "--scale", "n",
                   "--device", "cuda"])
    print(f"[import-int8npz] quantize --mode int8 --calibrate YOLOV8: "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    store = {k: v for k, v in flatten_variables(quantize.load_int8(f"{tmp}/yolov8n_int8.npz"))
             .items() if k.startswith("act_scales::")}
    args = dict(model_type=ObjectModelType.YOLOV8, scale="n", compute_dtype="int8",
                device="cuda")
    det = YoloDetector(model_path=f"{tmp}/yolov8n_int8.npz", **args)
    ref = YoloDetector(model_path=npz, **args)
    ref.calibrate_int8(list(np.random.default_rng(15).integers(0, 256, (2, *FRAME_HW, 3),
                                                               dtype=np.uint8)))
    served = {k: v for k, v in flax_variables(det.net).items() if k.startswith("act_scales::")}
    check(served and sorted(served) == sorted(store)
          and all(np.array_equal(served[k], store[k]) for k in store)
          and sorted(served) == sorted(k for k in flax_variables(ref.net)
                                       if k.startswith("act_scales::")),
          "[import-int8npz] the facade does not serve the store's static scales")
    frame = np.random.default_rng(16).integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8)
    runs = []
    for d in (det, ref):
        d.DetectFrame(frame)
        reset(mods)
        d.DetectFrame(frame)
        runs.append(counts(mods))
    check(runs[0] == runs[1] and runs[0]["int8_conv"] > 0,
          f"[import-int8npz] launches {runs[0]}, the facade-calibrated net's {runs[1]}")
    objs = det.object_info
    check(len(objs) <= 100 and all(np.isfinite([o.x, o.y, o.width, o.height, o.conf]).all()
                                   for o in objs), "[import-int8npz] bad detections")
    print(f"[import-int8npz] YOLOv8n from the _int8.npz: {len(served)} static scales, "
          f"{len(objs)} detections, launches {runs[0]} (as the facade-calibrated net's)",
          flush=True)
    return runs[0]


def import_phases(mods, smi, torch, np):
    """The ``[import-*]`` phases in one temporary directory; returns their
    launch counts (each counted from 0) and the main path's per tick."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_import_")
    t = time.perf_counter()
    try:
        main_run, nets, lane_state, calib, tick, want = import_main_int8_phase(
            tmp, mods, smi, torch, np)
        runs = [main_run, import_onnx_phase(tmp, nets, lane_state, calib, tick, want, mods,
                                            torch, np)]
        del nets, lane_state
        t1 = time.perf_counter()
        runs.append(import_families_phase(tmp, mods, torch, np))
        t2 = time.perf_counter()
        runs.append(import_int8npz_phase(tmp, mods, torch, np))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[import] phase seconds: main-int8 + onnx {t1 - t:.1f}, families {t2 - t1:.1f}, "
          f"int8npz {time.perf_counter() - t2:.1f}", flush=True)
    return runs, main_run


# ---- the engines: .adas artifacts and the ONNX graph executor ----

#: the modules a fresh process serving an artifact must not hold
FOREIGN = ("jax", "jaxlib", "flax", "adas_tpu", "cv2", "onnx")


def build_int8_pair(torch, np, tag):
    """The first item's pair, calibrated as ``[main-int8]`` calibrates it
    (the same seeds and frames, so the same scales)."""
    yolo, lane, MultiStreamADAS = build_main("int8", torch, tag)
    calib = np.random.default_rng(0).integers(0, 256, (2, *FRAME_HW, 3), dtype=np.uint8)
    yolo.calibrate_int8(list(calib))
    lane.calibrate_int8(list(calib))
    return yolo, lane, MultiStreamADAS


def bits(a):
    """An f32 array's bits, to compare two of them to the bit."""
    return a.view(a.dtype.str.replace("f", "u"))


def serve_artifact_child(arg: str) -> int:
    """``chip_smoke.py --serve-artifact <json>``: the fresh process of
    ``[artifact-main-int8]``.  It imports ``adas_tpu_torch`` and nothing of
    JAX, builds the facades (their weights unused: the artifact carries
    every weight), loads the pipeline from the ``.adas`` file with
    ``step_artifact=``, serves ticks with exact launches and prints one
    JSON line of its measurements."""
    import numpy as np
    import torch

    from adas_tpu_torch.ops import block, int8_conv, iou, nms, stem

    a = json.loads(arg)
    mods = {"stem": stem, "int8_conv": int8_conv, "block": block, "iou": iou, "nms": nms}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    yolo, lane, MultiStreamADAS = build_main("int8", torch, "artifact-main-int8 child")
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    ms = MultiStreamADAS(yolo, lane, N_STREAMS, FRAME_HW, transport="i420",
                         step_artifact=a["path"])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    with np.load(a["ticks"]) as z:
        ticks, want = list(z["frames"]), z["flat"]
    t = time.perf_counter()
    ms.process_batch(ticks[0])
    first_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    reset(mods)
    tick_ms = []
    for i in range(a["n_ticks"]):
        t = time.perf_counter()
        ms.process_batch(ticks[1 + i % 3])
        tick_ms.append((time.perf_counter() - t) * 1e3)
    run = counts(mods)
    equal = [bool(np.array_equal(bits(ms._step(ms._prep_upload(f)).cpu().numpy()), bits(w)))
             for f, w in zip(ticks, want)]
    x = ms._prep_upload(ticks[1])
    step_ms = cuda_ms(lambda: ms._step(x), 10)
    ms.close()
    foreign = sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))
    print(json.dumps({"build_s": build_s, "load_s": load_s, "first_ms": first_ms,
                      "tick_ms": tick_ms, "step_ms": step_ms, "launches": run, "equal": equal,
                      "foreign": foreign}), flush=True)
    return 0


def program_audit(path, torch):
    """The exported programs of a ``.adas`` file on the card, node by node.
    Returns (call nodes, ``int8_conv`` nodes, copy nodes, what puts a
    tensor on the host): a node whose output lies off the card, a scalar
    read back (``item``), a lifted weight or constant off the card.  A
    host BN fold or any other device-to-host round trip left in the graph
    shows there; bits equal to the native step's cannot show it, since the
    native step folds on the host too."""
    import io
    import operator
    import zipfile

    with zipfile.ZipFile(path) as zf:
        programs = [torch.export.load(io.BytesIO(bytearray(zf.read(n))))
                    for n in zf.namelist() if n.endswith(".pt2")]
    nodes = int8 = copies = 0
    host = []
    for program in programs:
        for n in program.graph.nodes:
            if n.op != "call_function" or n.target is operator.getitem:
                continue  # a getitem's output is its producer's, checked there
            name = str(n.target)
            nodes += 1
            int8 += name == "adas_tpu_torch.int8_conv.default"
            copies += any(k in name for k in ("copy", "aten.to.", "aten.cpu", "aten.cuda"))
            vals = n.meta.get("val")
            vals = vals if isinstance(vals, (list, tuple)) else [vals]
            off = [str(v.device) for v in vals
                   if isinstance(v, torch.Tensor) and v.device.type != "cuda"]
            if "_local_scalar_dense" in name or "item" in name or off:
                host.append(f"{name} {off}")
        host += [k for k, t in {**program.state_dict, **program.constants}.items()
                 if isinstance(t, torch.Tensor) and t.device.type != "cuda"]
    return nodes, int8, copies, host


def artifact_main_phase(tmp, yolo, lane, MultiStreamADAS, mods, torch, np):
    """``[artifact-main-int8]``: the calibrated int8 pair's 8-stream I420
    pipeline exported as one ``.adas`` (``MultiStreamADAS.export_fused``),
    then loaded and served in a fresh process (``--serve-artifact``):
    launches per tick as the native step's, the packed ticks equal to the
    native ones to the bit; the export, size and load beside the native
    and the served ``process_batch`` and device-step times.  Returns the
    served run's launches."""
    tag = "artifact-main-int8"
    per_tick = {"stem": 2, "int8_conv": 105, "block": BLOCKS_PER_TICK, "iou": 1, "nms": 1}
    rng = np.random.default_rng(11)
    ticks = [rng.integers(0, 256, (N_STREAMS, *FRAME_HW, 3), dtype=np.uint8) for _ in range(4)]
    ms = MultiStreamADAS(yolo, lane, N_STREAMS, FRAME_HW, transport="i420")
    path = os.path.join(tmp, "pipeline.adas")
    try:
        t = time.perf_counter()
        meta = ms.export_fused(path)
        export_s = time.perf_counter() - t
        ms.process_batch(ticks[0])
        torch.cuda.synchronize()
        reset(mods)
        native_ms = []
        for i in range(6):
            t = time.perf_counter()
            ms.process_batch(ticks[1 + i % 3])
            native_ms.append((time.perf_counter() - t) * 1e3)
        native_run = counts(mods)
        check(all(native_run[k] == 6 * v for k, v in per_tick.items()),
              f"{tag}: native launches {native_run} over 6 ticks, expected {per_tick} per tick")
        flat = np.stack([ms._step(ms._prep_upload(f)).cpu().numpy() for f in ticks])
        x = ms._prep_upload(ticks[1])
        native_step_ms = cuda_ms(lambda: ms._step(x), 10)
    finally:
        ms.close()
    check(meta["platforms"] == ["cuda"] and meta["kind"] == "multistream"
          and meta["frame_shape"] == [N_STREAMS, FRAME_HW[0] * 3 // 2, FRAME_HW[1]],
          f"{tag}: meta {({k: meta[k] for k in ('platforms', 'kind', 'frame_shape')})}")
    size = os.path.getsize(path)
    print(f"[{tag}] exported the 8-stream I420 pipeline in {export_s:.2f} s: "
          f"{size / 2**20:.1f} MiB, output {meta['output_shapes']}", flush=True)
    nodes, int8, copies, host = program_audit(path, torch)
    check(not host, f"{tag}: the program puts tensors on the host: {host[:20]}")
    check(int8 == per_tick["int8_conv"],
          f"{tag}: {int8} int8_conv nodes in the program, expected {per_tick['int8_conv']}")
    print(f"[{tag}] the program: {nodes} call nodes, {int8} int8_conv nodes, {copies} to/copy "
          f"nodes, none of them to the host; no scalar read back, every weight and constant "
          f"on the card", flush=True)
    np.savez(os.path.join(tmp, "ticks.npz"), frames=np.stack(ticks), flat=flat)
    arg = json.dumps({"path": path, "ticks": os.path.join(tmp, "ticks.npz"), "n_ticks": 6})
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--serve-artifact", arg],
                          capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t
    check(proc.returncode == 0, f"{tag}: the serving process failed:\n{proc.stdout[-4000:]}\n"
                                f"{proc.stderr[-4000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    check(not got["foreign"], f"{tag}: the serving process imported {got['foreign']}")
    check(all(got["launches"][k] == 6 * v for k, v in per_tick.items()),
          f"{tag}: served launches {got['launches']} over 6 ticks, expected {per_tick} per tick")
    check(all(got["equal"]), f"{tag}: served ticks equal to the native ones: {got['equal']}")
    print(f"[{tag}] a fresh process ({child_s:.1f} s, imports only adas_tpu_torch): facades "
          f"built in {got['build_s']:.2f} s, artifact loaded in {got['load_s']:.2f} s, first "
          f"tick {got['first_ms']:.1f} ms; launches over 6 ticks {got['launches']} (per tick "
          f"{per_tick}); {len(got['equal'])} packed ticks equal to the native ones to the bit")
    print(f"[{tag}] process_batch ms per tick, native {[round(v, 3) for v in native_ms]} "
          f"(median {np.median(native_ms):.3f}) / served {[round(v, 3) for v in got['tick_ms']]} "
          f"(median {np.median(got['tick_ms']):.3f}); device step back-to-back (CUDA events) "
          f"native {native_step_ms:.3f} / served {got['step_ms']:.3f} ms", flush=True)
    return got["launches"]


def detect_counts(det, frame, mods, torch):
    reset(mods)
    det.DetectFrame(frame)
    torch.cuda.synchronize()
    return counts(mods)


def artifact_frame_phase(tmp, yolo, lane, mods, torch, np):
    """``[artifact-frame]``: the calibrated int8 YOLOv8l facade's fused step
    at 720p and 1080p in one multi-geometry ``.adas`` and the UFLDv2-CULane
    int8 facade's at 720p (``export_fused``), served through
    ``DetectFrame``: per frame the native launches and the native
    detections and lanes, to the bit.  Returns the served frames'
    launches."""
    from adas_tpu_torch.perception.lane_detector import LaneModelType, UltrafastLaneDetectorV2
    from adas_tpu_torch.perception.object_detector import ObjectModelType, YoloDetector

    tag = "artifact-frame"
    geoms = [(720, 1280), (1080, 1920)]
    ypath, lpath = os.path.join(tmp, "yolo.adas"), os.path.join(tmp, "lane.adas")
    t = time.perf_counter()
    yolo.export_fused(ypath, geoms)
    t1 = time.perf_counter()
    lane.export_fused(lpath, geoms[0])
    t2 = time.perf_counter()
    served_yolo = YoloDetector(model_type=ObjectModelType.YOLOV8, scale="l",
                               input_size=(640, 640), box_score=0.25, model_path=ypath,
                               device="cuda")
    served_lane = UltrafastLaneDetectorV2(model_path=lpath, model_type=LaneModelType.UFLDV2_CULANE,
                                          device="cuda")
    t3 = time.perf_counter()
    print(f"[{tag}] exported YOLOv8l int8 at {geoms} in {t1 - t:.2f} s "
          f"({os.path.getsize(ypath) / 2**20:.1f} MiB) and UFLDv2-CULane int8 at 720p in "
          f"{t2 - t1:.2f} s ({os.path.getsize(lpath) / 2**20:.1f} MiB); loaded both in "
          f"{t3 - t2:.2f} s", flush=True)
    rng = np.random.default_rng(12)
    total = {k: 0 for k in KERNELS}
    for hw in geoms:
        frame = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        for native, served, what in ((yolo, served_yolo, "YOLOv8l"),
                                     (lane, served_lane, "UFLDv2")):
            if served is served_lane and hw != geoms[0]:
                continue
            detect_counts(native, frame, mods, torch)  # warm-up: plans, maps
            detect_counts(served, frame, mods, torch)
            want = detect_counts(native, frame, mods, torch)
            got = detect_counts(served, frame, mods, torch)
            total = {k: total[k] + got[k] for k in KERNELS}
            check(got == want, f"{tag}: {what} {hw} launches served {got}, native {want}")
            if served is served_yolo:
                a = [(o.label, o.conf, o.tolist()) for o in native.object_info]
                b = [(o.label, o.conf, o.tolist()) for o in served.object_info]
                check(a == b and len(a) > 0, f"{tag}: {what} {hw}: {len(b)} served detections, "
                                             f"{len(a)} native, equal {a == b}")
                res = f"{len(a)} detections"
            else:
                a = ([list(p) for p in native.lane_info.lanes_points],
                     native.lane_info.lanes_status)
                b = ([list(p) for p in served.lane_info.lanes_points],
                     served.lane_info.lanes_status)
                check(a == b, f"{tag}: {what} lanes served {b[1]}, native {a[1]}")
                res = f"lanes {b[1]}"
            ms = {}
            for name, det in (("native", native), ("served", served)):
                times = []
                for _ in range(5):
                    t = time.perf_counter()
                    det.DetectFrame(frame)
                    times.append((time.perf_counter() - t) * 1e3)
                ms[name] = float(np.median(times))
            print(f"[{tag}] {what} {hw[0]}p DetectFrame: launches {got} as native, {res} equal "
                  f"to the native ones; ms median of 5 native {ms['native']:.3f} / served "
                  f"{ms['served']:.3f}", flush=True)
    return total


def yolo_graph(W, rng, np):
    """A hand-built YOLOv8-format graph (NCHW 1x3x640x640 in, (1, 84, 6400)
    out): three 3x3/2 convs with SiLU (``Sigmoid`` x ``Mul``), a 1x1 head to
    84 channels, ``Reshape``, ``Sigmoid``, then the boxes scaled to pixels
    around each cell's centre (a constant grid); the class logits are the
    head's class rows (the input's, through every conv) plus a constant of
    spread logits, which keeps the candidates apart in score."""
    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))).astype(np.float32)

    head = w(84, 64, 1, 1)
    head[4:] *= 4.0
    inits = {"w1": w(16, 3, 3, 3), "b1": np.zeros(16, np.float32),
             "w2": w(32, 16, 3, 3), "b2": np.zeros(32, np.float32),
             "w3": w(64, 32, 3, 3), "b3": np.zeros(64, np.float32),
             "wh": head, "bh": np.zeros(84, np.float32),
             "tgt": np.array([1, 84, 6400], np.int64),
             "logits": np.concatenate([np.zeros((1, 4, 6400), np.float32),
                                       rng.uniform(-9, 1.5, (1, 80, 6400)).astype(np.float32)], 1),
             "scale": np.array([16, 16, 64, 64] + [1] * 80, np.float32).reshape(1, 84, 1),
             "grid": np.zeros((1, 84, 6400), np.float32)}
    cells = (np.arange(80, dtype=np.float32) + 0.5) * 8 - 8
    inits["grid"][0, 0] = np.tile(cells, 80)
    inits["grid"][0, 1] = np.repeat(cells, 80)
    nodes = []
    x = "images"
    for i in (1, 2, 3):
        nodes += [W.make_node("Conv", [x, f"w{i}", f"b{i}"], [f"c{i}"], kernel_shape=[3, 3],
                              strides=[2, 2], pads=[1, 1, 1, 1]),
                  W.make_node("Sigmoid", [f"c{i}"], [f"s{i}"]),
                  W.make_node("Mul", [f"c{i}", f"s{i}"], [f"a{i}"])]
        x = f"a{i}"
    nodes += [W.make_node("Conv", [x, "wh", "bh"], ["h"], kernel_shape=[1, 1]),
              W.make_node("Reshape", ["h", "tgt"], ["r"]),
              W.make_node("Add", ["r", "logits"], ["z"]),
              W.make_node("Sigmoid", ["z"], ["p"]),
              W.make_node("Mul", ["p", "scale"], ["q"]),
              W.make_node("Add", ["q", "grid"], ["output0"])]
    return W.simple_model(nodes, [("images", np.float32, (1, 3, 640, 640))],
                          [("output0", np.float32, (1, 84, 6400))], initializers=inits)


def effdet_graph(W, rng, np):
    """EfficientDet's postprocessed export contract: (boxes, class ids,
    scores) of already-selected detections (here planted, plus the input's
    mean times zero, so the graph reads its input)."""
    boxes = np.sort(rng.uniform(0, 512, (12, 2, 2)), axis=1).reshape(12, 4)  # x1 y1 x2 y2
    nodes = [W.make_node("ReduceMean", ["input"], ["m"], keepdims=0),
             W.make_node("Mul", ["m", "zero"], ["z"]),
             W.make_node("Add", ["b0", "z"], ["boxes"]),
             W.make_node("Identity", ["i0"], ["ids"]),
             W.make_node("Add", ["c0", "z"], ["confs"])]
    inits = {"zero": np.float32(0.0), "b0": boxes.astype(np.float32),
             "i0": rng.integers(0, 80, 12).astype(np.int64),
             "c0": rng.uniform(0, 1, 12).astype(np.float32)}
    return W.simple_model(nodes, [("input", np.float32, (1, 3, 512, 512))],
                          [("boxes", np.float32, (12, 4)), ("ids", np.int64, (12,)),
                           ("confs", np.float32, (12,))], initializers=inits)


def onnx_graph_phase(tmp, mods, torch, np):
    """``[onnx-graph]``: a hand-built YOLO-format graph and EfficientDet's
    postprocessed graph (written with ``tools/onnx_writer``) through the
    facades with ``onnx_mode="graph"`` on the card: per YOLO frame IoU 1 and
    walk 1 (the decode's ``select_and_nms``) and nothing else; the graph's
    raw outputs against the same graph on the CPU, each row group on its own
    scale: the box rows (pixels) within 1e-4 of their largest, the score
    rows (sigmoids) within 1e-5, and the same detections as the CPU's facades (labels, boxes
    within 1e-2 px, scores within 1e-5; EfficientDet's exactly).  Returns
    the card's launches."""
    from adas_tpu_torch.perception.efficientdet_detector import EfficientdetDetector
    from adas_tpu_torch.perception.object_detector import ObjectModelType, YoloDetector
    from adas_tpu_torch.tools import onnx_writer as W

    tag = "onnx-graph"
    rng = np.random.default_rng(13)
    ypath, epath = os.path.join(tmp, "yolo_graph.onnx"), os.path.join(tmp, "effdet.onnx")
    W.save_model(ypath, yolo_graph(W, rng, np))
    W.save_model(epath, effdet_graph(W, rng, np))
    kw = dict(model_path=ypath, model_type=ObjectModelType.YOLOV8, onnx_mode="graph",
              box_score=0.25)
    gpu, cpu = YoloDetector(device="cuda", **kw), YoloDetector(device="cpu", **kw)
    egpu = EfficientdetDetector(model_path=epath, box_score=0.3, device="cuda")
    ecpu = EfficientdetDetector(model_path=epath, box_score=0.3, device="cpu")
    total = {k: 0 for k in KERNELS}
    per_frame = {"stem": 0, "int8_conv": 0, "block": 0, "iou": 1, "nms": 1}
    x = rng.uniform(0, 1, (1, 3, 640, 640)).astype(np.float32)
    raw_gpu, raw_cpu = gpu.engine.engine_inference(x)[0], cpu.engine.engine_inference(x)[0]
    box_diff = float(np.abs(raw_gpu[:, :4] - raw_cpu[:, :4]).max())
    box_max = float(np.abs(raw_cpu[:, :4]).max())
    score_diff = float(np.abs(raw_gpu[:, 4:] - raw_cpu[:, 4:]).max())
    check(box_diff <= 1e-4 * box_max and score_diff <= 1e-5,
          f"{tag}: raw outputs cuda vs cpu: box rows max diff {box_diff} (largest {box_max}), "
          f"score rows {score_diff}")
    n = 0
    for i in range(3):
        frame = rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8)
        run = detect_counts(gpu, frame, mods, torch)
        if i:
            check(run == per_frame, f"{tag}: YOLO graph launches per frame {run}")
            total = {k: total[k] + run[k] for k in KERNELS}
        cpu.DetectFrame(frame)
        a, b = cpu.object_info, gpu.object_info
        same = [p.label for p in a] == [q.label for q in b] and len(b) > 0
        box = max((abs(u - v) for p, q in zip(a, b) for u, v in
                   zip((p.x, p.y, p.width, p.height), (q.x, q.y, q.width, q.height))), default=0.0)
        conf = max((abs(p.conf - q.conf) for p, q in zip(a, b)), default=0.0)
        check(same and box <= 1e-2 and conf <= 1e-5,
              f"{tag}: YOLO graph detections cuda {len(b)} / cpu {len(a)}, labels equal "
              f"{same}, boxes max diff {box}, scores max diff {conf}")
        n += len(b)
        egpu.DetectFrame(frame)
        ecpu.DetectFrame(frame)
        a = [(o.label, o.tolist(), o.conf) for o in ecpu.object_info]
        b = [(o.label, o.tolist(), o.conf) for o in egpu.object_info]
        check(a == b and len(b) > 0, f"{tag}: EfficientDet graph detections {b} / {a}")
    ms = cuda_ms(lambda: gpu.engine.run_device(torch.from_numpy(x).cuda()), 10)
    print(f"[{tag}] YOLO-format graph on the card: box rows within {box_diff:.3g} of the CPU's "
          f"(largest {box_max:.1f}), score rows within {score_diff:.3g}; {n} detections over 3 720p frames equal "
          f"to the CPU's; launches over the last 2 frames {total} (per frame {per_frame}); the "
          f"graph back-to-back {ms:.3f} ms; EfficientDet's postprocessed graph: "
          f"{len(egpu.object_info)} detections equal to the CPU's", flush=True)
    return total


def artifact_phases(mods, torch, np):
    """``[artifact-main-int8]``, ``[artifact-frame]`` and ``[onnx-graph]`` in
    one temporary directory; returns their launch counts."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_artifact_")
    t = time.perf_counter()
    try:
        yolo, lane, MultiStreamADAS = build_int8_pair(torch, np, "artifact-main-int8")
        runs = [artifact_main_phase(tmp, yolo, lane, MultiStreamADAS, mods, torch, np)]
        t1 = time.perf_counter()
        runs.append(artifact_frame_phase(tmp, yolo, lane, mods, torch, np))
        del yolo, lane
        t2 = time.perf_counter()
        runs.append(onnx_graph_phase(tmp, mods, torch, np))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[artifact] phase seconds: main-int8 {t1 - t:.1f}, frame {t2 - t1:.1f}, "
          f"onnx-graph {time.perf_counter() - t2:.1f}", flush=True)
    return runs


# ---- PR: ONNX export, ONNX-served MultiStreamADAS, transport parity, the
# image codec, the lane demo and --calib-dir, training --------------------

#: an exported graph's outputs against the native net on the same weights
#: (JAX's bound, ``tests/test_onnx_export.py:118``)
EXPORT_RTOL = EXPORT_ATOL = 2e-4
#: the trainer's first step on the card against the CPU's, same init and
#: batch, the convolutions in f32 (TF32 off, as this script sets it):
#: relative gaps of the loss, of the forward's outputs (all heads as one
#: vector, the norm of the difference) and of the gradient (every
#: parameter's).  Each bound lies between the f32 and the TF32 readings
#: on an H100 80GB HBM3 at 700 W: loss 6.9e-8 / 7.0e-6, outputs 1.2e-5 /
#: 6.6e-3, gradient 4.4e-3 / 0.12 (f32's BatchNorm backward cancels on a
#: few leaves, on either device)
TRAIN_LOSS_RTOL = 1e-6
TRAIN_OUT_RTOL = 1e-4
TRAIN_GRAD_RTOL = 2e-2
TRAIN_STEPS, TRAIN_BATCH = 20, 8
#: a served detection pairs a native one of the same label with every box
#: edge and the score within what the graph's bound allows: raw box
#: coordinates up to 640 at rtol = atol = 2e-4, twice that in a 720p
#: frame's pixels (the letterbox scale); scores up to 1
PAIR_BOX_ATOL = 2 * (EXPORT_ATOL + EXPORT_RTOL * 640)
PAIR_SCORE_ATOL = EXPORT_ATOL + EXPORT_RTOL


def condition_yolo(net, hw, seed, keep, torch, np, gain=1.4):
    """Spread a seeded YOLOv8's scores so that its detections are not near
    ties: a random deep SiLU net forgets its input (each layer halves the
    signal) and scores every anchor alike.  Every convolution's kernel
    outside the head is scaled by ``gain``: at 1.4 the scores stay driven
    by the frame without turning chaotic (a larger gain saturates the
    scores; normalizing each BatchNorm on a batch instead made the net so
    sensitive that the served graph left the 2e-4 bound).  Then one
    shift of the class predictors' biases leaves the fraction ``keep`` of
    a seeded uniform batch's anchors above a score of 0.25."""
    from torch import nn

    with torch.no_grad():
        for name, m in net.named_modules():
            if isinstance(m, nn.Conv2d) and not name.startswith("head."):
                m.weight.mul_(gain)
        x = torch.from_numpy(np.random.default_rng(seed).uniform(0, 1, (4, 3, *hw))
                             .astype(np.float32)).to(next(net.parameters()).device)
        score = net(x)[:, 4:].amax(1).clamp(1e-7, 1 - 1e-7)
        q = float(torch.quantile(torch.log(score / (1 - score)).flatten(), 1 - keep))
        for name, m in net.named_modules():
            if name.startswith("head.cls") and name.endswith("_2"):
                m.bias.add_(float(np.log(0.25 / 0.75)) - q)


def pair_detections(got, want, np):
    """Pairs of ``got`` and ``want`` (``RectInfo`` lists): the same label,
    box edges within ``PAIR_BOX_ATOL`` px, scores within
    ``PAIR_SCORE_ATOL``.  Returns (pairs, unpaired got, unpaired want,
    max box diff, max score diff)."""
    def rows(objs):
        return [(o.label, np.array([o.x, o.y, o.x + o.width, o.y + o.height]), o.conf)
                for o in objs]

    want_rows, used = rows(want), set()
    pairs, lone, box_d, score_d = 0, [], 0.0, 0.0
    for label, box, conf in sorted(rows(got), key=lambda r: -r[2]):
        for j, (wl, wb, wc) in enumerate(want_rows):
            if j not in used and wl == label and np.abs(wb - box).max() <= PAIR_BOX_ATOL \
                    and abs(wc - conf) <= PAIR_SCORE_ATOL:
                used.add(j)
                pairs += 1
                box_d = max(box_d, float(np.abs(wb - box).max()))
                score_d = max(score_d, abs(wc - conf))
                break
        else:
            lone.append((label, box.round(2).tolist(), conf))
    lone_want = [(r[0], r[1].round(2).tolist(), r[2]) for j, r in enumerate(want_rows)
                 if j not in used]
    return pairs, lone, lone_want, box_d, score_d


def onnx_export_phase(tmp, smi, torch, np):
    """``[onnx-export]``: ``python -m adas_tpu_torch.tools.onnx_export`` (its
    ``main``, on ``cuda``) writes ``ufldv2_culane`` (320x1600, seeded) and
    ``yolov8_l`` (640, the facade's seeded tree with its scores spread by
    :func:`condition_yolo`, through ``--weights``);
    ``OnnxGraphEngine`` on the card serves each file, held to the native
    net on the same weights within rtol = atol = 2e-4.  Returns the paths
    ({"lane", "yolo", "weights"})."""
    from adas_tpu_torch.engine.onnx_engine import OnnxGraphEngine
    from adas_tpu_torch.perception.object_detector import ObjectModelType, YoloDetector
    from adas_tpu_torch.tools import onnx_export as OE
    from adas_tpu_torch.weights import flax_variables

    tag = "onnx-export"
    seeded = YoloDetector(model_type=ObjectModelType.YOLOV8, scale="l", input_size=(640, 640),
                          device="cuda", seed=0)
    # about 840 of a frame's 8400 anchors above box_score 0.25, spread apart
    condition_yolo(seeded.net, (640, 640), 20, 0.1, torch, np)
    weights = os.path.join(tmp, "v8l.npz")
    np.savez(weights, **flax_variables(seeded.net))
    del seeded
    paths = {"weights": weights}
    rng = np.random.default_rng(21)
    for key, model, argv in (("lane", "ufldv2_culane", []), ("yolo", "yolov8_l", ["--weights", weights])):
        path = os.path.join(tmp, f"{model}.onnx")
        t = time.perf_counter()
        OE.main(["--model", model, "--device", "cuda", "-o", path, *argv])
        export_s = time.perf_counter() - t
        t = time.perf_counter()
        engine = OnnxGraphEngine(path, device="cuda")
        load_s = time.perf_counter() - t
        fn, ex, names = OE._build_export(model, argv[1] if argv else None, "cuda")
        x = torch.from_numpy(rng.uniform(0, 1, tuple(ex.shape)).astype(np.float32)).cuda()
        with torch.no_grad():
            want = fn(x)
        want = want if isinstance(want, tuple) else (want,)
        got = engine.run_device(x)
        errs = []
        for name, g, w in zip(names, got, want):
            check(tuple(g.shape) == tuple(w.shape), f"{tag}: {model} {name} shape {tuple(g.shape)}")
            err = float((g - w).abs().max())
            check(bool(torch.allclose(g, w, rtol=EXPORT_RTOL, atol=EXPORT_ATOL)),
                  f"{tag}: {model} {name} served vs native max diff {err}")
            errs.append(err)
        served_ms = cuda_ms(lambda: engine.run_device(x), 5)
        native_ms = cuda_ms(lambda: fn(x), 5)
        print(f"[{tag}] {model}: exported on the card in {export_s:.2f} s, "
              f"{os.path.getsize(path) / 2**20:.1f} MiB, {len(names)} outputs {names}; loaded "
              f"in {load_s:.2f} s; served by OnnxGraphEngine vs the native net: max abs diff "
              f"{max(errs):.3g} (rtol = atol = {EXPORT_RTOL}); one batch-1 call: served "
              f"{served_ms:.3f} ms, native {native_ms:.3f} ms ({smi})", flush=True)
        paths[key] = path
        del engine, fn
        torch.cuda.empty_cache()
    return paths


def onnx_multistream_phase(paths, mods, smi, torch, np):
    """``[onnx-multistream]``: the exported YOLOv8l-640 f32 as the object
    side of ``MultiStreamADAS`` (``_ExecutorNet``: the graph once per
    stream inside the step) beside the native UFLDv2-CULane f32, 8 I420 720p
    streams, per tick stem 1 (the lane net's), IoU 1, walk 1; then the
    native f32 pipeline on the same weights and ticks, its YOLO routed
    through the BGR planes as the graph is (``stem_takes_planes = False``).
    Inside one served step the graph's output on the step's own
    preprocessed batch equals the native net's on it within rtol = atol =
    2e-4; on every tick each stream's lanes are equal and its detections
    (the served decode and NMS after the graph) pair the native ones one
    to one (:func:`pair_detections`: label, box within 0.26 px, score
    within 4e-4), on weights whose scores are spread apart
    (:func:`condition_yolo`).  Returns the served run's launches."""
    from adas_tpu_torch.perception.lane_detector import LaneModelType, UltrafastLaneDetectorV2
    from adas_tpu_torch.perception.object_detector import ObjectModelType, YoloDetector
    from adas_tpu_torch.pipeline.multistream import MultiStreamADAS, _ExecutorNet

    tag = "onnx-multistream"
    lane = UltrafastLaneDetectorV2(model_type=LaneModelType.UFLDV2_CULANE, device="cuda", seed=1)
    kw = dict(model_type=ObjectModelType.YOLOV8, box_score=0.25, device="cuda")
    served = YoloDetector(model_path=paths["yolo"], onnx_mode="graph", **kw)
    native = YoloDetector(model_path=paths["weights"], scale="l", input_size=(640, 640), **kw)
    native.net.stem_takes_planes = False
    ms = MultiStreamADAS(served, lane, N_STREAMS, FRAME_HW, transport="i420")
    check(isinstance(served.net, _ExecutorNet), f"{tag}: the served facade's net")
    ms_native = MultiStreamADAS(native, lane, N_STREAMS, FRAME_HW, transport="i420")
    rng = np.random.default_rng(22)
    ticks = [rng.integers(0, 256, (N_STREAMS, *FRAME_HW, 3), dtype=np.uint8) for _ in range(4)]
    per_tick = {"stem": 1, "int8_conv": 0, "block": 0, "iou": 1, "nms": 1}
    run = serve(tag, ms, mods, per_tick, ticks, 3, 4, torch, np)
    # the graph inside one step, against the native net on its input
    inner, seen = served.net, {}

    class Recorder:
        stem_takes_planes = False

        def __call__(self, x):
            seen["x"], seen["y"] = x, inner(x)
            return seen["y"]

    served.net = Recorder()
    try:
        ms._step(ms._prep_upload(ticks[1]))
    finally:
        served.net = inner
    with torch.no_grad():
        want = native.net(seen["x"])
    err = float((seen["y"] - want).abs().max())
    check(tuple(seen["y"].shape) == tuple(want.shape) == (N_STREAMS, 84, 8400) and
          bool(torch.allclose(seen["y"], want, rtol=EXPORT_RTOL, atol=EXPORT_ATOL)),
          f"{tag}: the graph in the step vs the native net: max abs diff {err}")
    tick_ms = {"served": [], "native": []}
    dets = {"served": [], "native": []}
    pair_box_d = pair_score_d = 0.0
    for f in ticks[1:4]:
        outs = {}
        for key, pipe in (("served", ms), ("native", ms_native)):
            t = time.perf_counter()
            outs[key] = pipe.process_batch(f)
            tick_ms[key].append((time.perf_counter() - t) * 1e3)
            dets[key].append(sum(len(r["objects"]) for r in outs[key]))
        for i, (a, b) in enumerate(zip(outs["served"], outs["native"])):
            check([np.asarray(p).tolist() for p in a["lanes_points"]]
                  == [np.asarray(p).tolist() for p in b["lanes_points"]], f"{tag}: lanes differ")
            n, lone, lone_native, box_d, score_d = pair_detections(a["objects"], b["objects"], np)
            check(n > 0 and not lone and not lone_native,
                  f"{tag}: stream {i}: {n} detections paired; served only {lone[:5]}, native "
                  f"only {lone_native[:5]}")
            pair_box_d, pair_score_d = max(pair_box_d, box_d), max(pair_score_d, score_d)
    ms.close()
    ms_native.close()
    print(f"[{tag}] the graph inside the served step vs the native net on the step's batch "
          f"{tuple(want.shape)}: max abs diff {err:.3g} (rtol = atol = {EXPORT_RTOL}); lanes "
          f"equal on 3 ticks; detections per tick served {dets['served']}, native "
          f"{dets['native']}, every one paired (max box diff {pair_box_d:.3g} px, score "
          f"{pair_score_d:.3g}); process_batch ms served "
          f"{[round(v, 2) for v in tick_ms['served']]}, native "
          f"{[round(v, 2) for v in tick_ms['native']]} ({smi})", flush=True)
    return run


def transport_parity_phase(mods, smi, torch, np):
    """``[transport-parity]``: ``measure_transport_drift`` of the calibrated
    int8 YOLOv8l + UFLDv2-CULane facades on 4 synthetic 720p frames at the
    360x640 rung; each frame runs both facades' ``DetectFrame`` on the frame
    and on its transport view: per frame exactly twice the single-frame
    path's launches (stem 4, int8 conv 210, block 10, IoU 2, walk 2)."""
    from adas_tpu_torch.pipeline.transport_parity import measure_transport_drift

    tag = "transport-parity"
    yolo, lane, _ = build_int8_pair(torch, np, tag)
    rng = np.random.default_rng(23)
    frames = [rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8) for _ in range(4)]
    measure_transport_drift(yolo, lane, frames[:1], (360, 640))  # warm-up
    torch.cuda.synchronize()
    reset(mods)
    t = time.perf_counter()
    drift = measure_transport_drift(yolo, lane, frames, (360, 640))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    run = counts(mods)
    per_frame = {"stem": 4, "int8_conv": 210, "block": 10, "iou": 2, "nms": 2}
    check(run == {k: v * len(frames) for k, v in per_frame.items()},
          f"{tag}: launches {run} over {len(frames)} frames, expected {per_frame} per frame")
    check(drift["rung"] == [360, 640] and 0.0 <= drift["box_miss_rate"] <= 1.0
          and np.isfinite(drift["lane_x_err_px"]), f"{tag}: {drift}")
    print(f"[{tag}] {json.dumps(drift)}; {len(frames)} frames in {secs:.2f} s; launches {run} "
          f"(per frame {per_frame}) ({smi})", flush=True)
    return run


def ufld_batch(spec, b, seed, torch, np):
    rng = np.random.default_rng(seed)
    h, w = spec.input_height, spec.input_width
    lanes = spec.num_lanes
    return {
        "images": torch.from_numpy(rng.normal(size=(b, 3, h, w)).astype(np.float32)),
        "row_targets": torch.from_numpy(rng.integers(0, spec.num_cell_row, (b, spec.num_row, lanes))),
        "col_targets": torch.from_numpy(rng.integers(0, spec.num_cell_col, (b, spec.num_col, lanes))),
        "row_exist": torch.from_numpy(rng.integers(0, 2, (b, spec.num_row, lanes))),
        "col_exist": torch.from_numpy(rng.integers(0, 2, (b, spec.num_col, lanes))),
        "seg_targets": torch.from_numpy(rng.integers(0, lanes + 1, (b, h // 8, w // 8))),
    }


def first_step_probe(net, batch, torch):
    """(loss, every output as one vector, every parameter's gradient as
    one vector) of one forward and backward of a copy of ``net`` in
    training mode, the trainer's first step before its update."""
    import copy

    from adas_tpu_torch.parallel import ufld_loss

    probe = copy.deepcopy(net).train()
    outs = probe(batch["images"])
    loss = ufld_loss(outs, batch)
    loss.backward()
    grad = torch.cat([p.grad.flatten() for p in probe.parameters()])
    flat = torch.cat([v.detach().flatten() for v in outs.values()])
    return float(loss.detach()), flat, grad


def train_phase(mods, smi, torch, np):
    """``[train-ufldv2]``: UFLDv2-CULane, ResNet-18, f32, at the 320x1600 of
    ``configs/ufldv2/culane_res18.py``, the aux head on, batch 8, seeded
    synthetic targets, 20 SGD steps (lr 0.05, momentum 0.9) on the card,
    the convolutions in f32 (TF32 off).  The loss falls; no kernel
    launches in training mode; the first step's loss, outputs and
    gradient equal the CPU's on the same init and batch within rel 1e-6,
    1e-4 and 2e-2 (bounds that TF32 convolutions exceed: their gaps are
    printed beside them); a save/restore on the card is exact;
    the trained net then serves in eval mode through the stem kernel (one
    launch per forward).  Prints step ms (median), images/s and peak
    memory, and the same steps' ms with TF32 on."""
    import copy
    import shutil
    import tempfile

    from adas_tpu_torch.models.ufld import UFLDv2Spec
    from adas_tpu_torch.parallel import (latest_checkpoint, make_ufld_train_state,
                                         make_ufld_train_step, restore_train_state,
                                         save_train_state)
    from adas_tpu_torch.utils.config import CONFIG_DIR, Config

    tag = "train-ufldv2"
    cfg = Config.fromfile(os.path.join(CONFIG_DIR, "culane_res18.py"))
    spec = UFLDv2Spec(input_height=cfg.train_height, input_width=cfg.train_width,
                      crop_ratio=cfg.crop_ratio, num_cell_row=cfg.num_cell_row,
                      num_row=cfg.num_row, num_cell_col=cfg.num_cell_col, num_col=cfg.num_col,
                      fc_norm=cfg.fc_norm, backbone=cfg.backbone)
    # init on the CPU (the CPU's generator), the same tree moved to the card
    cpu_net, _, _ = make_ufld_train_state(spec, learning_rate=cfg.learning_rate,
                                          momentum=cfg.momentum, use_aux=True, device="cpu")
    net = copy.deepcopy(cpu_net).to("cuda")
    opt = torch.optim.SGD(net.parameters(), lr=cfg.learning_rate, momentum=cfg.momentum,
                          dampening=0.0)
    state = {"net": net, "optimizer": opt}
    step = make_ufld_train_step(net, opt)
    batch = ufld_batch(spec, TRAIN_BATCH, 24, torch, np)
    cpu_loss, cpu_out, cpu_grad = first_step_probe(cpu_net, batch, torch)
    del cpu_net
    gbatch = {k: v.cuda() for k, v in batch.items()}
    # the first step's loss, outputs and gradient on the card, in f32 and
    # with TF32 convolutions, against the CPU's: relative gaps
    probes = {}
    for name, tf32 in (("f32", False), ("tf32", True)):
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            loss, out, grad = first_step_probe(net, gbatch, torch)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        probes[name] = (abs(loss - cpu_loss) / abs(cpu_loss),
                        float((out.cpu() - cpu_out).norm() / cpu_out.norm()),
                        float((grad.cpu() - cpu_grad).norm() / cpu_grad.norm()))
        del out, grad
    torch.cuda.empty_cache()
    gaps = {k: [float(f"{v:.3g}") for v in p] for k, p in probes.items()}
    print(f"[{tag}] the first step on the card against the CPU's, relative gaps of the loss, "
          f"the outputs and the gradient: f32 {gaps['f32']} (bounds {TRAIN_LOSS_RTOL}, "
          f"{TRAIN_OUT_RTOL}, {TRAIN_GRAD_RTOL}), TF32 convolutions {gaps['tf32']} ({smi})", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(mods)
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        _, loss = step(state, gbatch)
        losses.append(float(loss))  # the fetch ends the step
        step_ms.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launched = counts(mods)
    check(all(v == 0 for v in launched.values()), f"{tag}: kernel launches in training {launched}")
    check(np.isfinite(losses).all() and losses[-1] < losses[0], f"{tag}: losses {losses}")
    rel = abs(losses[0] - cpu_loss) / abs(cpu_loss)
    check(rel < TRAIN_LOSS_RTOL and probes["f32"][0] < TRAIN_LOSS_RTOL,
          f"{tag}: first loss {losses[0]} on the card vs {cpu_loss} on the CPU (rel {rel})")
    check(probes["f32"][1] < TRAIN_OUT_RTOL and probes["f32"][2] < TRAIN_GRAD_RTOL,
          f"{tag}: the first step's outputs and gradient on the card vs the CPU's: rel "
          f"{probes['f32'][1]}, {probes['f32'][2]}")
    med = float(np.median(step_ms[2:]))
    # TF32 convolutions, for comparison (a copy of the trained state)
    net32 = copy.deepcopy(net)
    opt32 = torch.optim.SGD(net32.parameters(), lr=cfg.learning_rate, momentum=cfg.momentum)
    opt32.load_state_dict(opt.state_dict())
    step32 = make_ufld_train_step(net32, opt32)
    tf32_ms = []
    torch.backends.cudnn.allow_tf32 = True
    try:
        for _ in range(6):
            t = time.perf_counter()
            float(step32({"net": net32, "optimizer": opt32}, gbatch)[1])
            tf32_ms.append((time.perf_counter() - t) * 1e3)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    del net32, opt32, step32
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        target = save_train_state(tmp, state, step=TRAIN_STEPS)
        check(latest_checkpoint(tmp) == target, f"{tag}: latest checkpoint")
        _, fresh_opt, fresh = make_ufld_train_state(spec, use_aux=True, device="cuda",
                                                    generator=torch.Generator("cuda").manual_seed(5))
        restored, n = restore_train_state(target, fresh)
        mom = {id(p): s["momentum_buffer"] for p, s in opt.state.items()}
        same = n == TRAIN_STEPS and all(
            torch.equal(a, b) for a, b in zip(net.state_dict().values(),
                                              restored["net"].state_dict().values()))
        names = {n_: p for n_, p in net.named_parameters()}
        same = same and all(torch.equal(mom[id(names[k])], fresh_opt.state[p]["momentum_buffer"])
                            for k, p in restored["net"].named_parameters())
        check(same, f"{tag}: save/restore on the card is not exact")
        ckpt_mib = os.path.getsize(os.path.join(target, "state.pt")) / 2**20
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    net.eval()
    reset(mods)
    with torch.no_grad():
        out = net(gbatch["images"])
    torch.cuda.synchronize()
    served = counts(mods)
    check(served["stem"] == 1 and sum(served.values()) == 1 and
          all(bool(torch.isfinite(v).all()) for v in out.values()),
          f"{tag}: the trained net in eval mode launched {served}")
    print(f"[{tag}] UFLDv2-CULane res18 + aux head, 320x1600, batch {TRAIN_BATCH}, f32 (TF32 "
          f"off): losses {[round(v, 4) for v in losses]}; first loss {losses[0]:.6f} vs the CPU's "
          f"{cpu_loss:.6f} (rel {rel:.3g}); step ms median {med:.2f} (all "
          f"{[round(v, 1) for v in step_ms]}), {TRAIN_BATCH * 1e3 / med:.1f} images/s, peak "
          f"device memory {peak:.2f} GiB; with TF32 convolutions: step ms "
          f"{[round(v, 1) for v in tf32_ms]} (median of the last 4 "
          f"{float(np.median(tf32_ms[2:])):.2f}); no kernel launches in training; save/restore "
          f"exact ({ckpt_mib:.1f} MiB); eval mode after training: {served} ({smi})", flush=True)
    return served


def codec_phase(mods, smi, torch, np):
    """``[codec]``: the committed fixtures (``tests/data/images``: PNGs of
    every colour type and depth, plain and Adam7; every BMP kind cv2 reads;
    JPEGs gray, 4:4:4, 4:2:2, 4:4:0, 4:2:0, with restart intervals,
    baseline and progressive; EXIF-oriented JPEGs and PNGs) decoded on this
    host by ``render/image.py`` (``native/image.cpp``, g++) equal to the cv2
    decodes committed beside them (``.npy``; sha256 for the 720p frames,
    one of them a progressive JPEG with Orientation 6), the ms of each 720p
    decode; a progressive file without its last scan refused by name; the
    720p frame's JPEG encode held to cv2's bytes (its sha256) and timed;
    then ``run_lane_image`` on the 720p PNG and ``run_lane_video`` over a
    3-frame ``.y4m`` (seeded UFLDv2-CULane f32 on the card, one stem launch
    per image), ``run_lane_image`` from the progressive Orientation-6 JPEG
    to a ``.jpg`` (one stem launch, 1280x720 upright, the file the port's
    encode of the output), and ``quantize --calibrate YOLOV8 --calib-dir``
    on a directory of a PNG, a BMP, a JPEG, a progressive JPEG and cv2's
    paletted gray BMP on the card (every int8 conv and dense layer gets its
    scale).  Returns the launches."""
    import glob
    import hashlib
    import shutil
    import tempfile

    from adas_tpu_torch.perception.object_detector import ObjectModelType, YoloDetector
    from adas_tpu_torch.pipeline import lane_demo
    from adas_tpu_torch.render import image
    from adas_tpu_torch.render.video import Y4MReader, Y4MWriter
    from adas_tpu_torch.tools import quantize
    from adas_tpu_torch.tools.params_io import flatten_variables
    from adas_tpu_torch.weights import flax_variables

    tag = "codec"
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "images")
    t = time.perf_counter()
    image.imread(os.path.join(data, "frame_720p.png"))  # builds _build/libimage.so
    build_s = time.perf_counter() - t
    n = 0
    for npy in sorted(glob.glob(os.path.join(data, "*.npy"))):
        src = [p for p in glob.glob(npy[:-4] + ".*") if not p.endswith(".npy")][0]
        got = image.imread(src)
        check(got is not None and np.array_equal(got, np.load(npy)),
              f"{tag}: {os.path.basename(src)} differs from cv2's decode")
        n += 1
    check(n >= 110, f"{tag}: {n} fixtures")
    with open(os.path.join(data, "sha256.json")) as f:
        digests = json.load(f)
    decode_ms = {}
    for name, want in digests.items():
        path = os.path.join(data, name)
        got = image.imread(path)
        check(list(got.shape) == want["shape"] and
              hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"],
              f"{tag}: {name} differs from cv2's decode")
        times = []
        for _ in range(7):
            t = time.perf_counter()
            image.imread(path)
            times.append((time.perf_counter() - t) * 1e3)
        decode_ms[name] = float(np.median(times))
    with open(os.path.join(data, "progressive.jpg"), "rb") as f:
        progressive = f.read()
    try:  # without its last scan (a refinement): libjpeg-turbo would smooth
        image.imdecode(progressive[:progressive.rfind(b"\xff\xda")] + b"\xff\xd9")
        refused = ""
    except ValueError as e:
        refused = str(e)
    check("progressive JPEG whose scans leave" in refused,
          f"{tag}: an incomplete progressive JPEG was not refused by name: {refused!r}")
    with open(os.path.join(data, "encode_sha256.json")) as f:
        want_jpg = json.load(f)["frame_720p.png"]["jpg"]
    frame = image.imread(os.path.join(data, "frame_720p.png"))
    encode_times = []
    for _ in range(7):
        t = time.perf_counter()
        encoded = image.imencode(".jpg", frame)
        encode_times.append((time.perf_counter() - t) * 1e3)
    check(hashlib.sha256(encoded).hexdigest() == want_jpg,
          f"{tag}: the 720p JPEG encode differs from cv2.imencode's bytes")
    encode_ms = float(np.median(encode_times))
    print(f"[{tag}] native/image.cpp built in {build_s:.2f} s; {n} fixtures (PNG, BMP of every "
          f"kind, JPEG baseline and progressive, EXIF-oriented) equal to cv2's decodes, the "
          f"720p frames to their sha256; a progressive JPEG without its last scan refused; "
          f"ms per 720p decode (median of 7, host): "
          f"{json.dumps({k: round(v, 3) for k, v in decode_ms.items()})}; 720p JPEG encode "
          f"(quality 95, 4:2:0) equal to cv2's bytes, {len(encoded)} bytes in "
          f"{encode_ms:.3f} ms (median of 7, host) ({smi})", flush=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_codec_")
    try:
        frame = image.imread(os.path.join(data, "frame_720p.png"))
        reset(mods)
        t = time.perf_counter()
        out = lane_demo.run_lane_image(os.path.join(data, "frame_720p.png"),
                                       os.path.join(tmp, "lanes.png"))
        image_s = time.perf_counter() - t
        check(out.shape == frame.shape and
              np.array_equal(image.imread(os.path.join(tmp, "lanes.png")), out),
              f"{tag}: run_lane_image output")
        video_in, video_out = os.path.join(tmp, "in.y4m"), os.path.join(tmp, "out.y4m")
        with Y4MWriter(video_in, 1280, 720, 30.0) as vw:
            for i in range(3):
                vw.write(np.roll(frame, 40 * i, axis=1))
        t = time.perf_counter()
        frames = lane_demo.run_lane_video(video_in, video_out)
        video_s = time.perf_counter() - t
        with Y4MReader(video_out) as r:
            written = len(list(r))
        torch.cuda.synchronize()
        lanes_run = counts(mods)
        check(frames == written == 3 and lanes_run["stem"] == 4 and
              sum(lanes_run.values()) == 4, f"{tag}: lane demo launches {lanes_run}, {frames} "
                                            f"frames, {written} written")
        # the progressive Orientation-6 JPEG (stored 720x1280) to a .jpg
        reset(mods)
        t = time.perf_counter()
        turned = lane_demo.run_lane_image(os.path.join(data, "frame_720p_prog_exif6.jpg"),
                                          os.path.join(tmp, "lanes.jpg"))
        turned_s = time.perf_counter() - t
        torch.cuda.synchronize()
        turned_run = counts(mods)
        with open(os.path.join(tmp, "lanes.jpg"), "rb") as f:
            written = f.read()
        back = image.imread(os.path.join(tmp, "lanes.jpg"))
        check(turned.shape == (720, 1280, 3) and written == image.imencode(".jpg", turned) and
              back is not None and back.shape == (720, 1280, 3),
              f"{tag}: run_lane_image from the progressive Orientation-6 JPEG: "
              f"{turned.shape}, {len(written)} bytes written")
        check(turned_run["stem"] == 1 and sum(turned_run.values()) == 1,
              f"{tag}: run_lane_image (progressive JPEG) launches {turned_run}")
        calib = os.path.join(tmp, "calib")
        os.makedirs(calib)
        for name in ("frame_720p.png", "frame_720p_420.jpg", "bmp_24_bu.bmp",
                     "frame_720p_prog_exif6.jpg", "bmp_8_gray.bmp"):
            shutil.copy(os.path.join(data, name), calib)
        seeded = YoloDetector(model_type=ObjectModelType.YOLOV8, scale="n", device="cuda", seed=0)
        npz = os.path.join(tmp, "yolov8n.npz")
        np.savez(npz, **flax_variables(seeded.net))
        reset(mods)
        t = time.perf_counter()
        quantize.main(["-i", npz, "-o", os.path.join(tmp, "yolov8n_int8.npz"), "--mode", "int8",
                       "--calibrate", "YOLOV8", "--scale", "n", "--calib-dir", calib])
        calib_s = time.perf_counter() - t
        torch.cuda.synchronize()
        calib_run = counts(mods)
        store = quantize.load_int8(os.path.join(tmp, "yolov8n_int8.npz"))
        scales = list(flatten_variables({"a": store["act_scales"]}).values())
        check(len(scales) > 50 and all(np.isfinite(v).all() and (v > 0).all() for v in scales),
              f"{tag}: {len(scales)} calibrated scales")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[{tag}] run_lane_image on the 720p PNG (UFLDv2-CULane f32, seeded, on the card) in "
          f"{image_s:.2f} s, the annotated PNG read back equal; run_lane_video: {frames} of 3 "
          f"frames of a 720p .y4m in {video_s:.2f} s; launches {lanes_run}; run_lane_image "
          f"from the progressive Orientation-6 JPEG to a .jpg in {turned_s:.2f} s, "
          f"{turned.shape[1]}x{turned.shape[0]}, launches {turned_run}; quantize --calibrate "
          f"YOLOV8 --calib-dir (a PNG, a JPEG, a progressive JPEG, a 24-bit and a paletted "
          f"BMP) on the card in {calib_s:.2f} s: {len(scales)} activation scales, launches "
          f"{calib_run} ({smi})", flush=True)
    return {k: lanes_run[k] + turned_run[k] + calib_run[k] for k in KERNELS}


#: ``[video]``: frames of ``run_synthetic`` (two GOPs of the writer), of
#: ``run_video`` over its output and of ``run_lane_video``
VIDEO_FRAMES, VIDEO_RERUN_FRAMES, VIDEO_LANE_FRAMES = 24, 4, 3


def video_phase(mods, smi, torch, np):
    """``[video]``: the MP4 / ``mp4v`` codec on this host
    (``render/{mp4,mpeg4,video}.py``, ``native/mpeg4.cpp`` built by g++).
    Every committed fixture (``tests/data/video``) decodes to cv2's Y
    planes to the bit (their sha256, and the ``.npy`` where committed),
    and the chroma of ``cv2_fast_100x58.mp4`` keeps the tests' drift bound
    against cv2's committed BGR decode (the p99 gap of every P-VOP within
    1 level of its GOP's I-VOP).  Then ``run_synthetic`` at 720x1280 for
    ``VIDEO_FRAMES`` frames with the default nets on the card to an
    ``.mp4``: read back, every frame equals the writer's reconstruction,
    30 fps; ``run_video`` over that file and ``run_lane_video``, both to
    ``.mp4``.  Prints the encode and decode ms per 720p frame (host), the
    file's MiB per second of video and the launches per frame (stem 2,
    IoU 1, walk 1 for the pipeline; stem 1 for the lane demo).  Returns
    the launches."""
    import glob
    import hashlib
    import shutil
    import tempfile
    from unittest import mock

    from adas_tpu_torch.native.draw import i420_to_bgr
    from adas_tpu_torch.pipeline import app, lane_demo
    from adas_tpu_torch.render import mpeg4, video

    tag = "video"
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "video")
    with open(os.path.join(data, "sha256.json")) as f:
        digests = json.load(f)
    t = time.perf_counter()
    mpeg4._native()  # builds _build/libmpeg4.so
    build_s = time.perf_counter() - t
    n_frames = 0
    for name, want in digests.items():
        path = os.path.join(data, name)
        planes, types = [], []
        with video.MP4Reader(path) as r:
            check((r.width, r.height, r.fps) == (want["width"], want["height"], 30.0),
                  f"{tag}: {name} is {r.width}x{r.height} at {r.fps}")
            for p in r.i420_frames():
                planes.append(p)
                types.append(r._decoder.last_type)
        ys = [p[:want["height"]] for p in planes]
        check([hashlib.sha256(y.tobytes()).hexdigest() for y in ys] == want["y_sha256"],
              f"{tag}: {name}'s Y planes differ from cv2's decode")
        npy = path[:-4] + "_y.npy"
        if os.path.exists(npy):
            check(np.array_equal(np.stack(ys), np.load(npy)), f"{tag}: {name} against {npy}")
        bgr = path[:-4] + "_bgr.npy"
        if os.path.exists(bgr):
            gaps = [float(np.percentile(np.abs(i420_to_bgr(p, want["height"], want["width"])
                                               .astype(int) - ref), 99))
                    for p, ref in zip(planes, np.load(bgr))]
            start = None
            for k, (kind, gap) in enumerate(zip(types, gaps)):
                start = gap if kind == "I" else start
                check(gap <= start + 1, f"{tag}: {name} chroma drift at frame {k}: {gaps}")
        n_frames += len(ys)
    check(n_frames >= 80, f"{tag}: {n_frames} fixture frames")
    print(f"[{tag}] native/mpeg4.cpp built in {build_s:.2f} s; {len(digests)} fixtures, "
          f"{n_frames} frames, Y equal to cv2's decodes; cv2_fast_100x58 chroma p99 gaps "
          f"{sorted(set(gaps))} (bound: its GOP's I-VOP + 1)", flush=True)

    h, w = FRAME_HW
    tmp = tempfile.mkdtemp(prefix="chip_smoke_video_")
    recon, encode_ms = [], []

    class RecordingWriter(video.MP4Writer):
        """``run_synthetic``'s writer (an MP4 path: ``open_writer``'s
        arguments), keeping each frame's reconstruction and encode time."""

        def write_i420(self, yuv):
            t0 = time.perf_counter()
            out = super().write_i420(yuv)
            encode_ms.append((time.perf_counter() - t0) * 1e3)
            recon.append(out)
            return out

    try:
        synthetic = os.path.join(tmp, "synthetic_out.mp4")
        reset(mods)
        t = time.perf_counter()
        with mock.patch.object(app, "open_writer", RecordingWriter):
            n = app.run_synthetic(synthetic, frames=VIDEO_FRAMES, device="cuda")
        torch.cuda.synchronize()
        synthetic_s = time.perf_counter() - t
        synthetic_run = counts(mods)
        per_frame = {"stem": 2, "int8_conv": 0, "block": 0, "iou": 1, "nms": 1}
        for k, per in per_frame.items():
            check(synthetic_run[k] == per * VIDEO_FRAMES,
                  f"{tag}: run_synthetic {k} launches {synthetic_run[k]} over {VIDEO_FRAMES} "
                  f"frames, expected {per} per frame")
        decode_ms = []
        with video.MP4Reader(synthetic) as r:
            check((r.width, r.height, r.fps, len(r)) == (w, h, 30.0, VIDEO_FRAMES),
                  f"{tag}: {synthetic} is {r.width}x{r.height} at {r.fps}, {len(r)} frames")
            got = []
            while True:
                t0 = time.perf_counter()
                p = r.read_i420()
                if p is None:
                    break
                decode_ms.append((time.perf_counter() - t0) * 1e3)
                got.append(p)
            stats = r.stats()
        check(n == len(got) == len(recon) == VIDEO_FRAMES and
              all(np.array_equal(a, b) for a, b in zip(got, recon)),
              f"{tag}: the .mp4's frames differ from the writer's reconstruction")
        mib = os.path.getsize(synthetic) / 2 ** 20
        again = os.path.join(tmp, "again.mp4")
        reset(mods)
        t = time.perf_counter()
        n_video = app.run_video(synthetic, again, max_frames=VIDEO_RERUN_FRAMES, device="cuda")
        torch.cuda.synchronize()
        video_s = time.perf_counter() - t
        video_run = counts(mods)
        for k, per in per_frame.items():
            check(video_run[k] == per * VIDEO_RERUN_FRAMES,
                  f"{tag}: run_video {k} launches {video_run[k]}, expected {per} per frame")
        lanes = os.path.join(tmp, "lanes.mp4")
        reset(mods)
        t = time.perf_counter()
        n_lanes = lane_demo.run_lane_video(synthetic, lanes, max_frames=VIDEO_LANE_FRAMES)
        torch.cuda.synchronize()
        lanes_s = time.perf_counter() - t
        lanes_run = counts(mods)
        check(lanes_run["stem"] == VIDEO_LANE_FRAMES and
              sum(lanes_run.values()) == VIDEO_LANE_FRAMES,
              f"{tag}: run_lane_video launches {lanes_run}")
        for path, frames in ((again, VIDEO_RERUN_FRAMES), (lanes, VIDEO_LANE_FRAMES)):
            with video.MP4Reader(path) as r:
                drawn = list(r)
                check(r.fps == 30.0 and len(drawn) == frames and
                      all(f.shape == (h, w, 3) for f in drawn),
                      f"{tag}: {path} holds {len(drawn)} frames at {r.fps}")
        check(n_video == VIDEO_RERUN_FRAMES and n_lanes == VIDEO_LANE_FRAMES,
              f"{tag}: {n_video} and {n_lanes} frames processed")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    p_ms = [v for i, v in enumerate(encode_ms) if i % mpeg4.GOP]
    i_ms = [v for i, v in enumerate(encode_ms) if not i % mpeg4.GOP]
    print(f"[{tag}] run_synthetic (YOLOv8n f32 + UFLDv2-CULane f32, HUD) to an .mp4: "
          f"{VIDEO_FRAMES} frames of {w}x{h} in {synthetic_s:.2f} s, read back equal to the "
          f"writer's reconstruction at 30 fps; encode ms per 720p frame (host, vop_quant "
          f"{mpeg4.QUANT}): I-VOP median {np.median(i_ms):.2f}, P-VOP median "
          f"{np.median(p_ms):.2f} (max {max(p_ms):.2f}); decode ms per frame median "
          f"{np.median(decode_ms):.2f} (max {max(decode_ms):.2f}); file {mib:.3f} MiB = "
          f"{mib * 30 / VIDEO_FRAMES:.3f} MiB per second of video; decoder counts {stats}; "
          f"launches {synthetic_run} (per frame {per_frame}); run_video over it: "
          f"{VIDEO_RERUN_FRAMES} frames in {video_s:.2f} s, launches {video_run}; "
          f"run_lane_video: {VIDEO_LANE_FRAMES} frames in {lanes_s:.2f} s, launches "
          f"{lanes_run} ({smi})", flush=True)
    h264_run = video_h264(mods, smi, torch, np)
    avi_run = video_avi(mods, smi, torch, np)
    rotated_run = video_rotated(mods, smi, torch, np)
    asp_run = video_mpeg4_asp(mods, smi, torch, np)
    conceal_run = video_conceal(mods, smi, torch, np)
    hevc_run = video_hevc(mods, smi, torch, np)
    return {k: synthetic_run[k] + video_run[k] + lanes_run[k] + h264_run[k] + avi_run[k] +
            rotated_run[k] + asp_run[k] + conceal_run[k] + hevc_run[k] for k in KERNELS}


def video_hevc(mods, smi, torch, np):
    """``[video]``, H.265 input (``render/hevc.py``, ``native/hevc.cpp``
    built by g++): the 720p content clip (``tests/data/video/hevc_writer.py``'s
    ``content_720p``: a PCM IDR picture of ``tests/data/images/frame_720p.png``,
    then 59 P pictures of a quarter-sample pan by merge and AMVP, 64x64 CTBs,
    WPP, TMVP and deblocking on) is rebuilt by the stream writer and decodes
    to the digests cv2 made of it (``tests/data/video/hevc/sha256.json``),
    timed per access unit; then ``run_video`` over it as an ``hvc1``
    ``.mp4`` with ``ADASPipeline``'s defaults to an ``.mp4``: stem 2, IoU 1
    and walk 1 per frame, every frame written.  The decoder and the writer
    build at once.  Prints the g++ build times and the host ms per IRAP and
    P picture (p50 and max).  Returns the launches."""
    import hashlib
    import shutil
    import tempfile
    import threading

    from adas_tpu_torch.pipeline import app
    from adas_tpu_torch.render import hevc, video

    tag = "video"
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "video")
    sys.path.insert(0, data)
    import hevc_writer

    with open(os.path.join(data, "hevc", "sha256.json")) as f:
        want = json.load(f)["content_720p"]
    built = {}

    def build(name, fn):
        t0 = time.perf_counter()
        fn()
        built[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=build, args=("decoder", hevc._native)),
               threading.Thread(target=build, args=("writer", hevc_writer._native))]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    build_s = time.perf_counter() - t
    check(set(built) == {"decoder", "writer"}, f"{tag}: an H.265 library did not build")
    t = time.perf_counter()
    stream = hevc_writer.content_720p()
    write_s = time.perf_counter() - t
    decoder = hevc.Decoder(None)
    frames, ms, irap = [], [], []
    for au in hevc.access_units(hevc.nal_units(stream)):
        t0 = time.perf_counter()
        frames += decoder.decode(hevc.annexb(au))
        ms.append((time.perf_counter() - t0) * 1e3)
        irap.append(any(16 <= hevc.nal_type(n) <= 23 for n in au))
    frames += decoder.flush()
    clip_stats = decoder.stats()
    decoder.close()
    check(len(frames) == want["frames"] and
          [hashlib.sha256(p[:720].tobytes()).hexdigest() for p in frames] == want["y_sha256"],
          f"{tag}: the 720p H.265 content clip's Y planes differ from cv2's decode")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hevc_")
    try:
        clip = os.path.join(tmp, "clip.mp4")
        hevc_writer.to_mp4(stream, clip, b"hvc1")
        out = os.path.join(tmp, "clip_out.mp4")
        reset(mods)
        t = time.perf_counter()
        n = app.run_video(clip, out, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        run = counts(mods)
        per_frame = {"stem": 2, "int8_conv": 0, "block": 0, "iou": 1, "nms": 1}
        for k, per in per_frame.items():
            check(run[k] == per * want["frames"],
                  f"{tag}: run_video over H.265 {k} launches {run[k]}, expected {per} per frame")
        with video.MP4Reader(out) as r:
            drawn = list(r)
        check(n == len(drawn) == want["frames"] and all(f.shape == (720, 1280, 3) for f in drawn),
              f"{tag}: run_video over H.265 wrote {len(drawn)} of {n} frames")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    i_ms = [v for v, k in zip(ms, irap) if k]
    p_ms = [v for v, k in zip(ms, irap) if not k]
    print(f"[{tag}] H.265: native/hevc.cpp and the stream writer built at once in {build_s:.2f} s "
          f"(decoder {built['decoder']:.2f} s, writer {built['writer']:.2f} s); the 720p content "
          f"clip ({want['frames']} frames, pan {want['pan']} quarter samples) rebuilt in "
          f"{write_s:.2f} s and decoded to cv2's digests: decode ms per 720p picture (host) IRAP "
          f"(PCM) p50 {np.median(i_ms):.2f} max {max(i_ms):.2f}, P p50 {np.median(p_ms):.2f} max "
          f"{max(p_ms):.2f}; non-zero counts { {k: v for k, v in clip_stats.items() if v} }; "
          f"run_video over it as hvc1 .mp4 (ADASPipeline defaults) to .mp4: {n} frames in "
          f"{run_s:.2f} s, launches {run} (per frame {per_frame}) ({smi})", flush=True)
    return run


def video_conceal(mods, smi, torch, np):
    """``[video]``, damaged video (``native/error_resilience.h``, FFmpeg's
    error concealment in the ``mp4v`` and H.264 decoders): the damaged
    720p clips of ``tests/data/video/conceal_clips.py`` -- the H.264 IBBBP
    clip and the ASP IBBP clip, each in slices or video packets of 9
    macroblock rows, 20 bytes replaced in a P and a B picture, a slice or
    packet of another P dropped, the last chunk cut -- rebuilt by the
    writers, read by ``open_reader`` to the committed digests and count
    of FFmpeg's one-thread decode, each sample's decode and its
    concealment timed on the damaged pictures; then ``run_video`` over the
    damaged H.264 clip with ``ADASPipeline``'s defaults: stem 2, IoU 1 and
    walk 1 per frame, every frame written.  Returns the launches."""
    import hashlib
    import shutil
    import tempfile

    from adas_tpu_torch.pipeline import app
    from adas_tpu_torch.render import video

    tag = "video"
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "video")
    sys.path.insert(0, data)
    import conceal_clips

    with open(os.path.join(data, "conceal_sha256.json")) as f:
        digests = json.load(f)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_conceal_")
    lines, run, n_run, run_s = [], {k: 0 for k in KERNELS}, 0, 0.0
    per_frame = {"stem": 2, "int8_conv": 0, "block": 0, "iou": 1, "nms": 1}
    try:
        for name, build in conceal_clips.CLIPS.items():
            want = digests[name]
            path = os.path.join(tmp, name)
            t = time.perf_counter()
            hit = build(path)
            build_s = time.perf_counter() - t
            check(hit == want["damaged"], f"{tag}: {name} damaged {hit}, expected {want['damaged']}")
            frames, decode_ms, conceal_ms = [], [], []
            with video.open_reader(path) as r:
                dec = r._decoder
                plain = dec.decode

                def timed(sample, plain=plain, dec=dec):
                    before = dec.stats()["conceal_us"]
                    t0 = time.perf_counter()
                    out = plain(sample)
                    dt = (time.perf_counter() - t0) * 1e3
                    spent = dec.stats()["conceal_us"] - before
                    if spent:  # a damaged picture: its decode and the concealment in it
                        decode_ms.append(dt)
                        conceal_ms.append(spent / 1e3)
                    return out

                dec.decode = timed
                while (planes := r.read_planes()) is not None:
                    frames.append(planes[:r.height])
                stats = r.stats()
            check(len(frames) == want["frames"],
                  f"{tag}: {name} gave {len(frames)} frames, FFmpeg {want['frames']}")
            check([hashlib.sha256(np.ascontiguousarray(y).tobytes()).hexdigest() for y in frames]
                  == want["y_sha256"], f"{tag}: {name}'s Y planes differ from FFmpeg's decode")
            check(stats["concealed_mbs"] > 0 and len(decode_ms) >= 4,
                  f"{tag}: {name} concealed {stats['concealed_mbs']} macroblocks in "
                  f"{len(decode_ms)} pictures")
            lines.append(
                f"{name}: rebuilt in {build_s:.2f} s, {len(frames)} frames to FFmpeg's digests, "
                f"{stats['concealed_mbs']} macroblocks concealed in {len(decode_ms)} damaged "
                f"pictures; ms per damaged 720p picture (host): decode p50 "
                f"{np.median(decode_ms):.2f} max {max(decode_ms):.2f}, of it concealment p50 "
                f"{np.median(conceal_ms):.2f} max {max(conceal_ms):.2f}; counts "
                f"{ {k: v for k, v in stats.items() if v and k != 'conceal_us'} }")
            if "h264" in name:
                out = os.path.join(tmp, "conceal_out.avi")
                reset(mods)
                t = time.perf_counter()
                n_run = app.run_video(path, out, device="cuda")
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t
                run = counts(mods)
                for k, per in per_frame.items():
                    check(run[k] == per * want["frames"],
                          f"{tag}: run_video over {name} {k} launches {run[k]}, expected {per} "
                          f"per frame")
                with video.open_reader(out) as r:
                    drawn = list(r)
                check(n_run == len(drawn) == want["frames"]
                      and all(f.shape == (720, 1280, 3) for f in drawn),
                      f"{tag}: run_video over {name} wrote {len(drawn)} of {n_run} frames")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[{tag}] damaged video, concealed as FFmpeg conceals it: " + "; ".join(lines) +
          f"; run_video over the damaged H.264 clip (ADASPipeline defaults) to .avi: {n_run} "
          f"frames in {run_s:.2f} s, launches {run} (per frame {per_frame}) ({smi})", flush=True)
    return run


def video_mpeg4_asp(mods, smi, torch, np):
    """``[video]``, MPEG-4 Advanced Simple (``native/mpeg4.cpp``'s B-VOPs,
    4MV, quarter-sample, MPEG quantisation, video packets, N-VOPs, DivX's
    packed B-VOPs, the XviD IDCT and interlace): the committed fixtures
    (``tests/data/video/mpeg4``) to cv2's Y digests and counts (the
    interlaced ones, whose frames cv2 returns blank, every plane to its
    libavcodec's digests); the 720p
    content clip (``mpeg4_writer.content_720p``: an intra VOP, then a pan
    as IBBP with 4MV, quarter-sample vectors and MPEG matrices, XviD's user
    data) rebuilt by the writer (g++), decoded sample by sample to cv2's
    digests and count, each VOP's decode timed by its kind (I, P, B); then
    ``run_video`` over it as an ``XVID`` AVI with ``ADASPipeline``'s
    defaults to an ``.avi``: stem 2, IoU 1 and walk 1 per frame, every
    frame written.  Returns the launches."""
    import hashlib
    import shutil
    import tempfile

    from adas_tpu_torch.pipeline import app
    from adas_tpu_torch.render import mpeg4, video

    tag = "video"
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "video")
    sys.path.insert(0, data)
    import mpeg4_writer

    with open(os.path.join(data, "mpeg4", "sha256.json")) as f:
        digests = json.load(f)
    n_fixtures = n_frames = 0
    totals = {}
    for name, want in digests.items():
        if name == "content_720p":
            continue
        path = os.path.join(data, "mpeg4", name)
        got = []
        with video.open_reader(path) as r:
            while (planes := r.read_planes()) is not None:
                # cv2's Y, or every plane of libavcodec's decode (interlaced)
                got.append(planes if "yuv_sha256" in want else planes[:r.height])
            for k, v in r.stats().items():
                totals[k] = totals.get(k, 0) + v
        check([hashlib.sha256(p.tobytes()).hexdigest() for p in got] ==
              want.get("yuv_sha256", want.get("y_sha256")),
              f"{tag}: {name} gave {len(got)} frames or planes other than the reference's "
              f"({want['frames']} frames)")
        n_fixtures += 1
        n_frames += len(got)
    for k in ("b_vops", "n_vops", "inter4v_mbs", "direct_8x8_mbs", "qpel_vops",
              "mpeg_quant_vops", "custom_matrices", "video_packets", "packed_b_vops",
              "xvid_idct_vops", "interlaced_vops", "field_mbs", "field_direct_mbs"):
        check(totals.get(k, 0) > 0, f"{tag}: the ASP fixtures lack {k}: {totals}")
    want = digests["content_720p"]
    t = time.perf_counter()
    stream = mpeg4_writer.content_720p()
    write_s = time.perf_counter() - t
    decoder = mpeg4.Decoder(stream.header, b"XVID")
    frames, ms = [], {"I": [], "P": [], "B": []}
    for sample, kind in zip(stream.samples, stream.types):
        t0 = time.perf_counter()
        frames += decoder.decode(sample)
        ms["IPB"[kind]].append((time.perf_counter() - t0) * 1e3)
    frames += decoder.flush()
    stats = decoder.stats()
    decoder.close()
    w, h = want["width"], want["height"]
    check(len(frames) == want["frames"] and
          [hashlib.sha256(p[:w * h].tobytes()).hexdigest() for p in frames] == want["y_sha256"],
          f"{tag}: the 720p ASP clip gave {len(frames)} frames or Y planes other than cv2's")
    check(stats["b_vops"] > 0 and stats["inter4v_mbs"] > 0 and stats["direct_8x8_mbs"] > 0 and
          stats["qpel_vops"] == stats["mpeg_quant_vops"] == stats["xvid_idct_vops"] ==
          want["frames"], f"{tag}: the 720p ASP clip lacks a tool: {stats}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_asp_")
    try:
        clip = os.path.join(tmp, "clip_asp.avi")
        mpeg4_writer.to_avi(stream, clip, b"XVID")
        out = os.path.join(tmp, "clip_asp_out.avi")
        reset(mods)
        t = time.perf_counter()
        n = app.run_video(clip, out, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        run = counts(mods)
        per_frame = {"stem": 2, "int8_conv": 0, "block": 0, "iou": 1, "nms": 1}
        for k, per in per_frame.items():
            check(run[k] == per * want["frames"],
                  f"{tag}: run_video over the ASP clip {k} launches {run[k]}, expected {per} "
                  f"per frame")
        with video.AVIReader(out) as r:
            drawn = list(r)
        check(n == len(drawn) == want["frames"] and all(f.shape == (h, w, 3) for f in drawn),
              f"{tag}: run_video over the ASP clip wrote {len(drawn)} of {n} frames")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary = {k: (f"median {np.median(v):.2f} (max {max(v):.2f}, {len(v)} VOPs)" if v else "none")
               for k, v in ms.items()}
    print(f"[{tag}] MPEG-4 Advanced Simple: {n_fixtures} fixtures, {n_frames} frames, Y equal "
          f"to cv2's digests and counts (B-VOPs, DivX packed, N-VOPs, 4MV, quarter-sample, MPEG "
          f"matrices, video packets, the XviD IDCT; interlaced ones every plane to libavcodec's); "
          f"the 720p clip ({want['frames']} frames, "
          f"IBBP, 4MV, quarter-sample, MPEG quantisation, pan {want['pan']} quarter samples) "
          f"rebuilt in {write_s:.2f} s and decoded to cv2's digests: decode ms per 720p VOP "
          f"(host) I {summary['I']}, P {summary['P']}, B {summary['B']}; non-zero counts "
          f"{ {k: v for k, v in stats.items() if v} }; run_video over it as an XVID .avi "
          f"(ADASPipeline defaults) to .avi: {n} frames in {run_s:.2f} s, launches {run} (per "
          f"frame {per_frame}) ({smi})", flush=True)
    return run


#: ``[video]``: frames of ``run_video`` over the quarter-turned fixture
VIDEO_ROTATED_FRAMES = 6


def video_rotated(mods, smi, torch, np):
    """``[video]``, MP4 display matrices (``render/mp4.display_rotation``,
    ``MP4Reader``): each fixture of ``tests/data/video/rotated`` (cv2's
    ``mp4v`` files with ``tkhd`` turned 90, 180, 270 degrees, mirrored,
    turned 30 degrees, and under a turned ``mvhd``) gives cv2's reported
    size and cv2's Y planes of the turned frames (their sha256); then
    ``run_video`` with the default nets on the card over the quarter-turned
    176x144 clip to an ``.mp4``: ``VIDEO_ROTATED_FRAMES`` frames of 144x176,
    stem 2, IoU 1, walk 1 per frame.  Returns the launches."""
    import hashlib
    import shutil
    import tempfile

    from adas_tpu_torch.pipeline import app
    from adas_tpu_torch.render import video

    tag = "video"
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "video",
                        "rotated")
    with open(os.path.join(data, "sha256.json")) as f:
        digests = json.load(f)
    seen = {}
    for name, want in digests.items():
        with video.MP4Reader(os.path.join(data, name)) as r:
            check((r.width, r.height) == (want["width"], want["height"]),
                  f"{tag}: {name} reports {r.width}x{r.height}, cv2 "
                  f"{want['width']}x{want['height']}")
            ys = [p[:r.height] for p in r.i420_frames()]
            seen[name] = r.rotation
        check([hashlib.sha256(y.tobytes()).hexdigest() for y in ys] == want["y_sha256"],
              f"{tag}: {name}'s turned Y planes differ from cv2's decode")
    src = os.path.join(data, "smooth_176x144_rot90.mp4")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rotated_")
    try:
        out = os.path.join(tmp, "rotated_out.mp4")
        reset(mods)
        t = time.perf_counter()
        n = app.run_video(src, out, max_frames=VIDEO_ROTATED_FRAMES, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        run = counts(mods)
        per_frame = {"stem": 2, "int8_conv": 0, "block": 0, "iou": 1, "nms": 1}
        for k, per in per_frame.items():
            check(run[k] == per * VIDEO_ROTATED_FRAMES,
                  f"{tag}: run_video over the turned clip: {k} launches {run[k]}, expected "
                  f"{per} per frame")
        with video.MP4Reader(out) as r:
            drawn = list(r)
        check(n == len(drawn) == VIDEO_ROTATED_FRAMES and
              all(f.shape == (176, 144, 3) for f in drawn),
              f"{tag}: run_video over the turned clip wrote {len(drawn)} frames of "
              f"{drawn[0].shape if drawn else None}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[{tag}] display matrices: {len(digests)} turned fixtures at cv2's size and Y planes "
          f"(turns {seen}); run_video over the quarter-turned 176x144 clip: {n} frames of 144x176 "
          f"in {run_s:.2f} s, launches {run} (per frame {per_frame}) ({smi})", flush=True)
    return run


def video_h264(mods, smi, torch, np):
    """``[video]``, H.264 input (``render/h264.py``, ``native/h264.cpp``
    built by g++): the committed H.264 fixtures (``tests/data/video/h264``:
    CAVLC and CABAC, Annex B, ``avc1`` and ``avc3``) decode to cv2's Y
    digests; the 720p content clip (``tests/data/video/h264_writer.py``'s
    ``content_720p``: an I_PCM IDR of ``tests/data/images/frame_720p.png``,
    then 23 CABAC P pictures of a quarter-sample pan, deblocking on) is
    rebuilt by the stream writer and decodes to cv2's digests, timed per
    access unit; then ``run_video`` over it as an ``avc1`` ``.mp4`` with
    ``ADASPipeline``'s defaults to an ``.mp4``: stem 2, IoU 1 and walk 1 per
    frame, every frame written.  The same for the 720p B clip
    (``content_720p_b``: the pan as IBBBP with a B pyramid, CABAC,
    deblocking on, spatial and temporal direct), its ``.mp4`` with ``ctts``
    and ``elst``.  Prints the g++ build times and the decode ms per 720p
    IDR, P and B picture (host).  Returns the launches of both runs."""
    import hashlib
    import shutil
    import tempfile

    from adas_tpu_torch.pipeline import app
    from adas_tpu_torch.render import h264, video

    tag = "video"
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "video")
    sys.path.insert(0, data)
    import h264_writer

    with open(os.path.join(data, "h264", "sha256.json")) as f:
        digests = json.load(f)
    t = time.perf_counter()
    h264._native()  # builds _build/libh264.so
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    h264_writer._native()  # builds _build/libh264_writer.so (the decoder's source included)
    writer_build_s = time.perf_counter() - t
    n_frames = 0
    for name, want in digests.items():
        if name.startswith("content_720p"):  # the clips the writer rebuilds
            continue
        with video.open_reader(os.path.join(data, "h264", name)) as r:
            check((r.width, r.height) == (want["width"], want["height"]),
                  f"{tag}: {name} is {r.width}x{r.height}")
            ys = [p[:r.height] for p in r.i420_frames()]
            stats = r.stats()
        check([hashlib.sha256(y.tobytes()).hexdigest() for y in ys] == want["y_sha256"],
              f"{tag}: {name}'s Y planes differ from cv2's decode")
        n_frames += len(ys)
    t = time.perf_counter()
    stream = h264_writer.content_720p()
    write_s = time.perf_counter() - t
    want = digests["content_720p"]
    decoder = h264.Decoder(None)
    frames, ms = [], []
    for au in h264.access_units(h264.nal_units(stream)):
        t0 = time.perf_counter()
        frames += decoder.decode(h264.annexb(au))
        ms.append((time.perf_counter() - t0) * 1e3)
    frames += decoder.flush()
    clip_stats = decoder.stats()
    decoder.close()
    check([hashlib.sha256(p[:720].tobytes()).hexdigest() for p in frames] == want["y_sha256"],
          f"{tag}: the 720p content clip's Y planes differ from cv2's decode")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_h264_")
    try:
        clip = os.path.join(tmp, "clip.mp4")
        h264_writer.to_mp4(stream, clip, b"avc1")
        out = os.path.join(tmp, "clip_out.mp4")
        reset(mods)
        t = time.perf_counter()
        n = app.run_video(clip, out, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        run = counts(mods)
        per_frame = {"stem": 2, "int8_conv": 0, "block": 0, "iou": 1, "nms": 1}
        for k, per in per_frame.items():
            check(run[k] == per * want["frames"],
                  f"{tag}: run_video over H.264 {k} launches {run[k]}, expected {per} per frame")
        with video.MP4Reader(out) as r:
            drawn = list(r)
        check(n == len(drawn) == want["frames"] and all(f.shape == (720, 1280, 3) for f in drawn),
              f"{tag}: run_video over H.264 wrote {len(drawn)} of {n} frames")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    b_run = video_h264_b(mods, smi, torch, np, digests["content_720p_b"])
    p_ms = ms[1:]
    print(f"[{tag}] H.264: native/h264.cpp built in {build_s:.2f} s, the stream writer in "
          f"{writer_build_s:.2f} s; {len(digests) - 2} fixtures, {n_frames} frames, Y equal to "
          f"cv2's decodes (the last's non-zero counts "
          f"{ {k: v for k, v in stats.items() if v} }); the 720p content clip ({want['frames']} "
          f"frames, CABAC, pan {want['pan']} quarter samples) rebuilt in {write_s:.2f} s and "
          f"decoded to cv2's digests: decode ms per 720p picture (host) IDR (I_PCM) {ms[0]:.2f}, "
          f"P median {np.median(p_ms):.2f} (max {max(p_ms):.2f}); non-zero counts "
          f"{ {k: v for k, v in clip_stats.items() if v} }; run_video "
          f"over it as avc1 .mp4 (ADASPipeline defaults) to .mp4: {n} frames in {run_s:.2f} s, "
          f"launches {run} (per frame {per_frame}) ({smi})", flush=True)
    return {k: run[k] + b_run[k] for k in KERNELS}


def video_h264_b(mods, smi, torch, np, want):
    """``[video]``'s 720p B clip (``h264_writer.content_720p_b``): rebuilt
    by the writer, decoded from FFmpeg's probed reorder delay to cv2's
    digests and count, each access unit timed by its picture's kind (IDR,
    P, B); then ``run_video`` over it as an ``avc1`` ``.mp4`` (``ctts``,
    ``elst``) with ``ADASPipeline``'s defaults: stem 2, IoU 1 and walk 1 per
    frame, every frame written.  Returns the launches."""
    import hashlib
    import shutil
    import tempfile

    import h264_writer

    from adas_tpu_torch.pipeline import app
    from adas_tpu_torch.render import h264, mp4, video

    tag = "video"
    t = time.perf_counter()
    stream = h264_writer.content_720p_b()
    write_s = time.perf_counter() - t
    aus = [h264.annexb(au) for au in h264.access_units(h264.nal_units(stream))]
    t = time.perf_counter()
    delay = h264.probe_delay(aus)
    probe_s = time.perf_counter() - t
    decoder = h264.Decoder(None, delay)
    frames, ms = [], {"IDR": [], "P": [], "B": []}
    before = decoder.stats()
    for au in aus:
        t0 = time.perf_counter()
        frames += decoder.decode(au)
        dt = (time.perf_counter() - t0) * 1e3
        after = decoder.stats()
        kind = ("IDR" if after["idr_pictures"] > before["idr_pictures"]
                else "B" if after["b_slices"] > before["b_slices"] else "P")
        ms[kind].append(dt)
        before = after
    frames += decoder.flush()
    stats = decoder.stats()
    decoder.close()
    check(len(frames) == want["frames"] and stats["dropped_pictures"] == 0,
          f"{tag}: the 720p B clip gave {len(frames)} frames, cv2 {want['frames']}")
    check([hashlib.sha256(p[:720].tobytes()).hexdigest() for p in frames] == want["y_sha256"],
          f"{tag}: the 720p B clip's Y planes differ from cv2's decode")
    check(stats["b_slices"] > 0 and stats["reference_b_pictures"] > 0
          and stats["spatial_direct_slices"] > 0 and stats["temporal_direct_slices"] > 0,
          f"{tag}: the 720p B clip lacks a B tool: {stats}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_h264b_")
    try:
        clip = os.path.join(tmp, "clip_b.mp4")
        h264_writer.to_mp4(stream, clip, b"avc1")
        demux = mp4.Demuxer(clip)
        track = demux.track
        demux.close()
        check(track.cts is not None and track.video_delay == 2,
              f"{tag}: the B clip's MP4 has no ctts of depth 2")
        out = os.path.join(tmp, "clip_b_out.mp4")
        reset(mods)
        t = time.perf_counter()
        n = app.run_video(clip, out, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        run = counts(mods)
        per_frame = {"stem": 2, "int8_conv": 0, "block": 0, "iou": 1, "nms": 1}
        for k, per in per_frame.items():
            check(run[k] == per * want["frames"],
                  f"{tag}: run_video over the H.264 B clip {k} launches {run[k]}, expected "
                  f"{per} per frame")
        with video.MP4Reader(out) as r:
            drawn = list(r)
        check(n == len(drawn) == want["frames"] and all(f.shape == (720, 1280, 3) for f in drawn),
              f"{tag}: run_video over the H.264 B clip wrote {len(drawn)} of {n} frames")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary = {k: (f"median {np.median(v):.2f} (max {max(v):.2f}, {len(v)} pictures)" if v else "none")
               for k, v in ms.items()}
    print(f"[{tag}] H.264 B pictures: the 720p B clip ({want['frames']} frames, IBBBP with a "
          f"reference B, CABAC, pan {want['pan']} quarter samples) rebuilt in {write_s:.2f} s, "
          f"probed in {probe_s:.2f} s (reorder delay {delay}), decoded to cv2's digests and "
          f"count: decode ms per 720p picture (host) IDR {summary['IDR']}, P {summary['P']}, "
          f"B {summary['B']}; non-zero counts { {k: v for k, v in stats.items() if v} }; "
          f"run_video over it as avc1 .mp4 with ctts (ADASPipeline defaults) to .mp4: {n} "
          f"frames in {run_s:.2f} s, launches {run} (per frame {per_frame}) ({smi})", flush=True)
    return run


def video_avi(mods, smi, torch, np):
    """``[video]``, AVI and Motion JPEG (``render/{avi,mjpeg}.py``,
    ``native/mjpeg.cpp`` built by g++): the committed fixtures
    (``tests/data/video/avi``: cv2's ``mp4v``, ``XVID`` and ``MJPG`` AVIs,
    ``MJPG`` in a ``.mov`` and an ``.mp4``) held to their sha256 and to
    cv2's Y digests, count and rate; the 720p Motion JPEG clip
    (``tests/data/video/avi_clips.py``: the committed 4:2:0 and 4:2:2 720p
    JPEGs alternating, 24 frames) written by the port's muxer whole and as
    a power cut leaves it (no ``idx1``, the last chunk cut, the sizes never
    written) and cut after its sizes were written (FFmpeg hands the
    decoder the partial chunk: its scan stops at the overread), each held
    to cv2's digests and counts; the decode ms per 720p
    frame of each sampling (p50, max), the demux ms of the clip, and the
    ``mp4v`` encode ms per 720p frame into an ``.avi`` beside the MP4
    writer's on the same frames; then ``run_video`` over the clip with
    ``ADASPipeline``'s defaults to an ``.avi``, read back whole at 30 fps:
    stem 2, IoU 1 and walk 1 per frame.  Returns the launches."""
    import hashlib
    import shutil
    import tempfile

    from adas_tpu_torch.pipeline import app
    from adas_tpu_torch.render import avi, mjpeg, video

    tag = "video"
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "video")
    sys.path.insert(0, data)
    import avi_clips

    with open(os.path.join(data, "avi", "sha256.json")) as f:
        digests = json.load(f)
    with open(os.path.join(data, "avi", "cut_sha256.json")) as f:
        cut_digests = json.load(f)
    t = time.perf_counter()
    mjpeg._native()  # builds _build/libmjpeg.so
    build_s = time.perf_counter() - t

    def y_digests(path):
        ys = []
        with video.open_reader(path) as r:
            while (planes := r.read_planes()) is not None:
                ys.append(planes[0] if isinstance(planes, tuple) else planes[:r.height])
            fps, codec = r.fps, r.codec
        return [hashlib.sha256(y.tobytes()).hexdigest() for y in ys], fps, codec

    n_frames, codecs = 0, []
    for name, want in digests.items():
        if name.startswith("clip_"):  # the clips the muxer rebuilds
            continue
        path = os.path.join(data, "avi", name)
        with open(path, "rb") as f:
            check(hashlib.sha256(f.read()).hexdigest() == want["sha256"],
                  f"{tag}: {name} differs from the committed fixture")
        got, fps, codec = y_digests(path)
        check(got == want["y_sha256"] and fps == want["fps"],
              f"{tag}: {name}'s Y planes, count or rate differ from cv2's decode")
        n_frames += len(got)
        codecs.append(f"{name}: {codec}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_avi_")
    try:
        clip, damaged = os.path.join(tmp, "clip.avi"), os.path.join(tmp, "damaged.avi")
        cut = os.path.join(tmp, "cut.avi")
        avi_clips.mjpeg_720p(clip)
        avi_clips.mjpeg_720p(damaged, damaged=True)
        avi_clips.mjpeg_720p(cut, cut=True)
        for path, name in ((clip, "clip_720p_mjpg.avi"), (damaged, "clip_720p_mjpg_damaged.avi"),
                           (cut, "clip_720p_mjpg_cut.avi")):
            want = {**digests, **cut_digests}[name]
            got, fps, codec = y_digests(path)
            check(got == want["y_sha256"] and fps == 30.0 and codec == "mjpeg",
                  f"{tag}: {name} gave {len(got)} frames, Y or rate other than cv2's "
                  f"({want['frames']} frames)")
        t = time.perf_counter()
        demux = avi.Demuxer(clip)
        demux_ms = (time.perf_counter() - t) * 1e3
        samples = [demux.read(i) for i in range(len(demux))]
        demux.close()
        t = time.perf_counter()
        bare = avi.Demuxer(damaged)
        bare_ms = (time.perf_counter() - t) * 1e3
        check(len(bare) == avi_clips.FRAMES - 1 and not bare.indexed and bare.truncated > 0,
              f"{tag}: the damaged clip demuxed to {len(bare)} frames")
        bare.close()
        decoder = mjpeg.Decoder(720)
        ms, frames = {}, []
        for sample in samples:
            t0 = time.perf_counter()
            decoder.decode(sample)
            bgr = decoder.bgr()
            ms.setdefault(decoder.format, []).append((time.perf_counter() - t0) * 1e3)
            frames.append(bgr)
        decoder.close()
        check(sorted(ms) == ["yuvj420p", "yuvj422p"], f"{tag}: the clip's samplings {sorted(ms)}")
        enc_ms = {}
        for suffix, writer in ((".avi", video.AVIWriter), (".mp4", video.MP4Writer)):
            with writer(os.path.join(tmp, "enc" + suffix), 1280, 720) as w:
                for f in frames:
                    t0 = time.perf_counter()
                    w.write(f)
                    enc_ms.setdefault(suffix, []).append((time.perf_counter() - t0) * 1e3)
        out = os.path.join(tmp, "clip_out.avi")
        reset(mods)
        t = time.perf_counter()
        n = app.run_video(clip, out, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        run = counts(mods)
        per_frame = {"stem": 2, "int8_conv": 0, "block": 0, "iou": 1, "nms": 1}
        for k, per in per_frame.items():
            check(run[k] == per * avi_clips.FRAMES,
                  f"{tag}: run_video over the Motion JPEG AVI {k} launches {run[k]}, expected "
                  f"{per} per frame")
        with video.AVIReader(out) as r:
            drawn = list(r)
            check(r.fps == 30.0 and r.codec == "mp4v", f"{tag}: {out} at {r.fps} ({r.codec})")
        check(n == len(drawn) == avi_clips.FRAMES and
              all(f.shape == (720, 1280, 3) for f in drawn),
              f"{tag}: run_video over the Motion JPEG AVI wrote {len(drawn)} of {n} frames")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def p50_max(v):
        return f"p50 {np.median(v):.2f} (max {max(v):.2f}, {len(v)} frames)"

    print(f"[{tag}] AVI and Motion JPEG: native/mjpeg.cpp built in {build_s:.2f} s; "
          f"{len(codecs)} fixtures ({'; '.join(codecs)}), {n_frames} frames, Y equal to cv2's "
          f"digests; the 720p Motion JPEG clip ({avi_clips.FRAMES} frames) whole, damaged "
          f"(no idx1, the last chunk cut, sizes 0) and cut with its sizes written (the partial "
          f"chunk decoded to its overread) decoded to cv2's digests and counts; demux ms "
          f"{demux_ms:.2f} indexed, {bare_ms:.2f} scanned; decode ms per 720p frame (host, "
          f"planes + BGR) 4:2:0 {p50_max(ms['yuvj420p'])}, 4:2:2 {p50_max(ms['yuvj422p'])}; "
          f"mp4v encode ms per 720p frame (host) into .avi {p50_max(enc_ms['.avi'])}, into .mp4 "
          f"{p50_max(enc_ms['.mp4'])}; run_video over the clip (ADASPipeline defaults) to "
          f".avi: {n} frames in {run_s:.2f} s, launches {run} (per frame {per_frame}) ({smi})",
          flush=True)
    return run


def onnx_phases(mods, smi, torch, np):
    """``[onnx-export]`` and ``[onnx-multistream]`` in one temporary
    directory; returns the launch counts."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_onnx_")
    t = time.perf_counter()
    try:
        paths = onnx_export_phase(tmp, smi, torch, np)
        t1 = time.perf_counter()
        run = onnx_multistream_phase(paths, mods, smi, torch, np)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[onnx] phase seconds: export {t1 - t:.1f}, multistream "
          f"{time.perf_counter() - t1:.1f}", flush=True)
    return run


MESH_TRAIN_STEPS = 6
#: the first step's parameter update (the gradient, times the learning
#: rate) of the sharded trainer against the unsharded one on the card,
#: relative L2 over every parameter: the GPU-vs-CPU gradient bound of
#: ``[train-ufldv2]`` (the BatchNorm backward's cancellation moves a few
#: leaves by more than rounding)
MESH_UPDATE_RTOL = TRAIN_GRAD_RTOL
#: the sharded UFLDv2 forward against the unsharded one, relative L2 per
#: output (f32, TF32 off: the split head sums ``cls_fc2`` in two halves)
MESH_STEP_RTOL = 1e-5
#: what rounds otherwise at a row's batch than at the whole tick's (found
#: on the card: the int8 nets themselves are batch-invariant to the bit)
BATCH_ROUNDING = ("the I420 preprocess's f32 resize matmuls (ops/preprocess.py:221-222: "
                  "cuBLAS picks its GEMM by the batch) put a few bf16 inputs one ulp off, "
                  "and in bf16 cuDNN's convolutions of the lane trunk too")
#: the mesh's end-to-end I420 tick against the 8-stream tick, per stream
#: (their inputs differ by BATCH_ROUNDING): the least share of detections
#: matched, the most detections by which the counts may differ, and the
#: least share of lane anchors whose validity flags agree (measured on one
#: H100: 0.947, 0, 0.9853 at worst)
MESH_MATCH_MIN = 0.9
MESH_COUNT_SLACK = 2
MESH_LANE_FLAGS_MIN = 0.97


def chip_meshes(torch):
    """The meshes of the mesh phases: over every card (``make_mesh()``)
    where there are several, else meshes that repeat ``cuda:0``: (2, 1)
    for the serving phases and (2, 2) for the head split and training."""
    from adas_tpu_torch.parallel import Mesh, make_mesh

    if torch.cuda.device_count() > 1:
        mesh = make_mesh()
        return mesh, mesh
    return Mesh([["cuda:0"], ["cuda:0"]]), Mesh([["cuda:0", "cuda:0"], ["cuda:0", "cuda:0"]])


def mesh_note(mesh) -> str:
    rows = [[str(d) for d in r] for r in mesh.devices]
    return (f"mesh {dict(mesh.shape)} {rows}"
            + (" (the devices repeat: one card)" if mesh.repeats else ""))


def unpacked_dets(flat, spec, np):
    from adas_tpu_torch.ops.packing import unpack

    return [np.asarray(unpack(row, spec)[0]) for row in flat]


def matched_share(got, want, np) -> float:
    """The share of ``got``'s detections (rows x1 y1 x2 y2 score label,
    score > 0) that have one in ``want`` with the same label, IoU > 0.5
    and a score within 0.05: the int8 slice's yardstick
    (``tests/test_torch_int8_slice.py``)."""
    g, w = got[got[:, 4] > 0], want[want[:, 4] > 0]
    if not len(g):
        return 1.0 if not len(w) else 0.0
    hits = 0
    for d in g:
        lt, rb = np.maximum(d[:2], w[:, :2]), np.minimum(d[2:4], w[:, 2:4])
        inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
        area = (w[:, 2] - w[:, 0]) * (w[:, 3] - w[:, 1])
        iou = inter / ((d[2] - d[0]) * (d[3] - d[1]) + area - inter)
        hits += bool(np.any((iou > 0.5) & (w[:, 5] == d[5]) & (np.abs(w[:, 4] - d[4]) < 0.05)))
    return hits / len(g)


def mesh_serve_phase(tag, compute_dtype, mesh, mods, smi, torch, np, per_row, n_sync, n_pipe,
                     probe=False):
    """``[mesh-int8]`` / ``[mesh-bf16]``: phase 5's (or 7's) pipeline,
    YOLOv8l-640 + UFLDv2-CULane from the same seeds (int8 calibrated on the
    card from the same two frames), 8 I420 streams of 720p, over ``mesh``
    beside the unsharded pipeline on the same nets.  Each row's streams
    equal to the bit to the unsharded step on those streams; the rows'
    kernels at their batch held by :func:`mesh_rows_against_tick`; the
    end-to-end tick against the 8-stream tick by matched detections
    (``MESH_MATCH_MIN``, ``MESH_COUNT_SLACK``), the lanes' agreement
    printed; each row's step alone with exactly ``per_row`` launches; then
    ``process_batch`` and ``serve_pipelined`` ticks with exactly rows x
    ``per_row`` per tick; the device step of each row (CUDA events on its
    device) and the whole tick's step beside the unsharded step; with
    ``probe`` the compute probe (one CUDA graph per row).  Returns the
    counts of the run."""
    yolo, lane, MultiStreamADAS = build_main(compute_dtype, torch, tag=tag)
    rng = np.random.default_rng(0)
    if compute_dtype == "int8":
        calib = rng.integers(0, 256, (2, *FRAME_HW, 3), dtype=np.uint8)
        yolo.calibrate_int8(list(calib))
        lane.calibrate_int8(list(calib))
    ticks = [rng.integers(0, 256, (N_STREAMS, *FRAME_HW, 3), dtype=np.uint8) for _ in range(4)]
    rows = mesh.axis_size("data")
    print(f"[{tag}] {mesh_note(mesh)}: {rows} data rows of {N_STREAMS // rows} streams, one "
          f"replica of both nets per row", flush=True)
    ms0 = MultiStreamADAS(yolo, lane, N_STREAMS, FRAME_HW, transport="i420")
    ms = MultiStreamADAS(yolo, lane, N_STREAMS, FRAME_HW, mesh=mesh, transport="i420")
    try:
        t = time.perf_counter()
        x = ms._prep_upload(ticks[0])
        got = ms._step(x)
        torch.cuda.synchronize()
        print(f"[{tag}] first mesh tick (replicas' plans and maps) "
              f"{(time.perf_counter() - t) * 1e3:.1f} ms", flush=True)
        x0 = ms0._prep_upload(ticks[0])
        want = ms0._step(x0)
        got = torch.cat([g.to(want.device) for g in got])
        k = N_STREAMS // rows
        # the unsharded pipeline on each row's streams: the same batch a row runs
        per_rows = torch.cat([ms0._step(x0[r * k:(r + 1) * k]) for r in range(rows)])
        check(bool(torch.equal(got, per_rows)),
              f"[{tag}] a row's streams differ from the unsharded step on the same streams")
        mesh_rows_against_tick(tag, compute_dtype, ms, ms0, x0, want, mods, torch)
        # the end-to-end I420 tick: the rows' own preprocess rounds otherwise
        g_dets = unpacked_dets(got.cpu().numpy(), ms._pack_spec, np)
        w_dets = unpacked_dets(want.cpu().numpy(), ms0._pack_spec, np)
        shares = [matched_share(a, b, np) for a, b in zip(g_dets, w_dets)]
        counts_ = [(int((a[:, 4] > 0).sum()), int((b[:, 4] > 0).sum()))
                   for a, b in zip(g_dets, w_dets)]
        g_lanes = unpacked_lanes(got.cpu().numpy(), ms._pack_spec, np)
        w_lanes = unpacked_lanes(want.cpu().numpy(), ms0._pack_spec, np)
        lanes = [lane_agreement(a, b, np) for a, b in zip(g_lanes, w_lanes)]
        print(f"[{tag}] the end-to-end I420 tick against the 8-stream tick: streams equal to "
              f"the bit {[bool(torch.equal(got[i], want[i])) for i in range(N_STREAMS)]} (max "
              f"|diff| {float((got - want).abs().max()):.3g}: {BATCH_ROUNDING}); matched shares "
              f"{[round(v, 3) for v in shares]} (least {MESH_MATCH_MIN}); detections (mesh, "
              f"unsharded) {counts_} (apart by {MESH_COUNT_SLACK} at most); lanes (share of "
              f"validity flags equal, least {MESH_LANE_FLAGS_MIN}; most |diff| of a point valid "
              f"on both) {[(round(a, 4), float(f'{b:.3g}')) for a, b in lanes]}", flush=True)
        check(all(v >= MESH_MATCH_MIN for v in shares)
              and all(abs(a - b) <= MESH_COUNT_SLACK for a, b in counts_)
              and all(a >= MESH_LANE_FLAGS_MIN for a, _ in lanes),
              f"[{tag}] the mesh tick misses the unsharded tick's detections or lanes")
        x = ms._prep_upload(ticks[1])
        for r in range(rows):
            reset(mods)
            with torch.cuda.device(x[r].device):
                ms._row_step(r, x[r])
            torch.cuda.synchronize()
            got_r = counts(mods)
            check(got_r == per_row, f"[{tag}] row {r}: launches {got_r}, expected {per_row}")
        print(f"[{tag}] launches of each row's step alone: {per_row} (exact, {rows} rows)",
              flush=True)
        per_tick = {k: rows * v for k, v in per_row.items()}
        ms.process_batch(ticks[0])
        torch.cuda.synchronize()
        reset(mods)
        tick_ms, results = [], []
        for i in range(n_sync):
            t = time.perf_counter()
            results.append(ms.process_batch(ticks[1 + i % 3]))
            tick_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        n = ms.serve_pipelined((ticks[i % 4] for i in range(n_pipe)), depth=3)
        pipe_s = time.perf_counter() - t
        run = counts(mods)
        check(n == n_pipe, f"[{tag}] serve_pipelined tick count")
        for k, per in per_tick.items():
            check(run[k] == per * (n_sync + n_pipe),
                  f"[{tag}] {k} launches {run[k]} after {n_sync + n_pipe} ticks, expected {per} "
                  f"per tick")
        n_dets = [len(r["objects"]) for r in results[-1]]
        check(all(0 < k <= int(yolo.max_det) for k in n_dets)
              and all(np.isfinite([o.x, o.y, o.width, o.height, o.conf]).all()
                      for r in results[-1] for o in r["objects"]),
              f"[{tag}] detections per stream: {n_dets}")
        check([st.tracker.frame_id for st in ms.streams] == [n_sync + n_pipe + 1] * N_STREAMS,
              f"[{tag}] the streams' trackers did not advance once per tick")
        print(f"[{tag}] launches over {n_sync + n_pipe} ticks: {run} (per tick {per_tick}); "
              f"detections per stream (last tick) {n_dets}", flush=True)
        x = ms._prep_upload(ticks[1])
        row_ms = []
        for r in range(rows):
            with torch.cuda.device(x[r].device):
                row_ms.append(cuda_ms(lambda: ms._row_step(r, x[r]), 10))
        x0 = ms0._prep_upload(ticks[1])
        steps = {"mesh, rows in turn": lambda: ms._step(x), "unsharded": lambda: ms0._step(x0)}
        step_ms = {name: wall_ms(fn, 10) for name, fn in steps.items()}
        print(f"[{tag}] process_batch per tick ms {[round(v, 3) for v in tick_ms]} -> "
              f"{N_STREAMS * 1e3 / np.median(tick_ms):.2f} frames/s; serve_pipelined "
              f"{pipe_s * 1e3 / n_pipe:.3f} ms/tick; device step per row (alone, CUDA events) "
              f"{[round(v, 3) for v in row_ms]} ms of {N_STREAMS // rows} streams; the step of "
              f"a tick (host clock, every card synced): "
              f"{ {k: round(v, 3) for k, v in step_ms.items()} } ({smi})", flush=True)
        if probe:
            probe_phase(f"{tag}-probe", ms, ticks[0], per_tick, mods, torch)
        return run
    finally:
        ms.close()
        ms0.close()


def unpacked_lanes(flat, spec, np):
    from adas_tpu_torch.ops.packing import unpack

    return [{k: np.asarray(v) for k, v in unpack(row, spec)[1].items()} for row in flat]


def lane_agreement(got, want, np):
    """(the share of lane anchors whose validity flags agree, the largest
    |difference| of a normalized lane coordinate valid on both sides)."""
    flags = equal = 0
    worst = 0.0
    for pos, valid in (("row_x", "row_valid"), ("col_y", "col_valid")):
        a, b = got[valid] > 0.5, want[valid] > 0.5
        flags += a.size
        equal += int((a == b).sum())
        both = a & b
        if both.any():
            worst = max(worst, float(np.abs(got[pos] - want[pos])[both].max()))
    return equal / flags, worst


def mesh_rows_against_tick(tag, compute_dtype, ms, ms0, x0, want, mods, torch):
    """The rows' kernels at the row batch, against the 8-stream tick that
    the earlier phases hold against the plain versions.  Each row's
    replicas run the second half of the step (``pipeline/fused.py``: both
    nets, the decode, the NMS) on its part of the 8-stream tick's own
    preprocessed inputs.  The int8 nets take the same integer kernels at
    any batch: every stream's packed output, detections and lanes, must
    equal the tick's to the bit.  In bf16 cuDNN's convolutions of the
    trunks pick their algorithms by the batch, so the kernels that path
    launches (the two stem sites, the IoU mask, the walk) are held against
    their plain versions at the row batch instead, and the outputs'
    agreement is printed."""
    from adas_tpu_torch.parallel.sharding import batch_part
    from adas_tpu_torch.pipeline.fused import fused_inputs, fused_outputs

    yolo, lane = ms0.yolo, ms0.lane
    nms_free = bool(getattr(yolo, "nms_free", False))
    with torch.inference_mode():
        xo, lx = fused_inputs(yolo, lane, x0, ms0.dev_hw, ms0.transport)
        whole = fused_outputs(yolo, lane, xo, lx, ms0.dev_hw, nms_free)[0]
        check(bool(torch.equal(whole, want)), f"[{tag}] the step's two halves differ from the step")
        parts = []
        for r, dev in enumerate(ms._rows):
            ry, rl = ms._views[r]
            with torch.cuda.device(dev):
                parts.append(fused_outputs(ry, rl, batch_part(ms.mesh, xo, r).to(dev),
                                           batch_part(ms.mesh, lx, r).to(dev), ms.dev_hw,
                                           nms_free)[0].to(want.device))
    got = torch.cat(parts)
    same = [bool(torch.equal(got[i], want[i])) for i in range(got.shape[0])]
    k = got.shape[0] // len(parts)
    print(f"[{tag}] the rows' nets on their parts of the 8-stream tick's preprocessed inputs "
          f"({k} streams a row) against the tick: streams equal to the bit {same} (max |diff| "
          f"{float((got - want).abs().max()):.3g})", flush=True)
    if compute_dtype == "int8":
        check(all(same), f"[{tag}] a row's int8 kernels at {k} streams differ from the 8-stream "
                         f"tick's on the same inputs")
        return
    S, I, NMS = mods["stem"], mods["iou"], mods["nms"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    dname, atol, rtol = STEM_DTYPES[0]
    for name, shape, kk, act, pool in STEM_SITES:
        stem_case(S, torch, gen, f"{name} (a row's batch)", (k, *shape[1:]), kk, act, pool,
                  getattr(torch, dname), atol, rtol)
    boxes, scores = nms_inputs(gen, k, 512, torch)
    mask = I.iou_mask(boxes, 0.45, plus_one=True)
    bits = int(I.unpack_bits(mask ^ I.iou_mask_reference(boxes, 0.45, plus_one=True),
                             512).sum().item())
    keep = NMS.nms_walk(mask, scores, 300, 0.001)
    n_diff = int((keep != NMS.nms_walk_reference(mask, scores, 300, 0.001)).sum().item())
    print(f"[{tag}] at a row's batch ({k}, 512): iou mask {bits} bits differ, walk {n_diff} "
          f"indices differ (0 each)", flush=True)
    check(bits == 0 and n_diff == 0, f"[{tag}] iou mask / walk at ({k}, 512) disagree with "
                                     f"their plain versions")


def mesh_sharded_step_phase(mesh, mods, smi, torch, np):
    """``[mesh-sharded-step]``: ``make_sharded_stream_step`` of the
    UFLDv2-CULane f32 forward (320x1600, the published head: ``cls_fc2``
    2048 x 91,224) over ``mesh`` with the head split over ``model``, on 8
    images, against the unsharded forward (relative L2 per output within
    ``MESH_STEP_RTOL``); the stem kernel once per row.  Returns the counts."""
    from adas_tpu_torch.parallel import make_sharded_stream_step
    from adas_tpu_torch.perception.lane_detector import LaneModelType, UltrafastLaneDetectorV2

    tag = "mesh-sharded-step"
    lane = UltrafastLaneDetectorV2(model_type=LaneModelType.UFLDV2_CULANE, device="cuda", seed=1)
    net = lane.net.eval()
    rows = mesh.axis_size("data")
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(N_STREAMS, 3, 320, 1600))
                         .astype(np.float32)).cuda()
    with torch.no_grad():
        want = net(x)
    step = make_sharded_stream_step(lambda n, f: n(f), net, mesh)
    head = step.replicas.replicas[0].mlp
    step(x)
    torch.cuda.synchronize()
    reset(mods)
    out = step(x)
    torch.cuda.synchronize()
    run = counts(mods)
    check(run == {"stem": rows, "int8_conv": 0, "block": 0, "iou": 0, "nms": 0},
          f"[{tag}] launches {run}, expected the stem once per row")
    rel = {k: float((torch.cat([o[k].to(v.device) for o in out]) - v).norm() / v.norm())
           for k, v in want.items()}
    check(all(v < MESH_STEP_RTOL for v in rel.values()),
          f"[{tag}] the sharded forward vs the unsharded: relative L2 {rel}")
    ms_sharded = wall_ms(lambda: step(x), 5)
    with torch.no_grad():
        ms_plain = wall_ms(lambda: net(x), 5)
    print(f"[{tag}] UFLDv2-CULane f32 on {mesh_note(mesh)}: cls_fc1 shards "
          f"{tuple(head.fc1[0].weight.shape)}, cls_fc2 shards {tuple(head.fc2[0].weight.shape)}; "
          f"relative L2 to the unsharded forward "
          f"{ {k: float(f'{v:.3g}') for k, v in rel.items()} } (bound {MESH_STEP_RTOL}); "
          f"launches {run}; sharded step {ms_sharded:.3f} ms, unsharded forward {ms_plain:.3f} "
          f"ms ({smi})", flush=True)
    return run


def mesh_train_phase(mesh, mods, smi, torch, np):
    """``[mesh-train]``: phase 22's UFLDv2-CULane res18 + aux head at
    320x1600, batch 8, f32 (TF32 off), on ``mesh`` (the head split over
    ``model``), against the unsharded trainer on the card from the same
    init and batch: the first loss within rel 2e-5 (JAX's bound between
    meshes, ``tests/test_parallel.py:83``), the first update (every
    parameter, relative L2) within ``MESH_UPDATE_RTOL``, every replica's
    running statistics equal to the bit; no kernel launches; step ms
    beside the unsharded step's; a checkpoint round trip on the mesh.
    Returns the counts."""
    import shutil
    import tempfile

    from adas_tpu_torch.models.ufld import UFLDv2Spec
    from adas_tpu_torch.parallel import (make_ufld_train_state, make_ufld_train_step,
                                         restore_train_state, save_train_state)
    from adas_tpu_torch.utils.config import CONFIG_DIR, Config

    tag = "mesh-train"
    cfg = Config.fromfile(os.path.join(CONFIG_DIR, "culane_res18.py"))
    spec = UFLDv2Spec(input_height=cfg.train_height, input_width=cfg.train_width,
                      crop_ratio=cfg.crop_ratio, num_cell_row=cfg.num_cell_row,
                      num_row=cfg.num_row, num_cell_col=cfg.num_cell_col, num_col=cfg.num_col,
                      fc_norm=cfg.fc_norm, backbone=cfg.backbone)
    kw = dict(learning_rate=cfg.learning_rate, momentum=cfg.momentum, use_aux=True)
    net, opt, state = make_ufld_train_state(
        spec, None, torch.Generator("cuda").manual_seed(11), device="cuda", **kw)
    snet, sopt, sstate = make_ufld_train_state(
        spec, mesh, torch.Generator(mesh.devices[0, 0]).manual_seed(11), **kw)
    step = make_ufld_train_step(net, opt)
    sstep = make_ufld_train_step(snet, sopt, mesh, sstate)
    batch = {k: v.cuda() for k, v in ufld_batch(spec, TRAIN_BATCH, 24, torch, np).items()}
    names = [k for k, _ in net.named_parameters()]
    w0 = torch.cat([v.flatten() for v in snet.gather(names).values()])
    check(bool(torch.equal(w0, torch.cat([p.detach().flatten() for p in net.parameters()]))),
          f"[{tag}] the sharded init differs from the unsharded one")
    reset(mods)
    loss = float(step(state, batch)[1])
    sloss = float(sstep(sstate, batch)[1])
    torch.cuda.synchronize()
    launched = counts(mods)
    rel = abs(sloss - loss) / abs(loss)
    upd = torch.cat([p.detach().flatten() for p in net.parameters()]) - w0
    supd = torch.cat([v.flatten() for v in snet.gather(names).values()]) - w0
    urel = float((supd - upd).norm() / upd.norm())
    first = snet.replicas[0].state_dict()
    stats_equal = all(torch.equal(v, first[k].to(v.device)) for rep in snet.replicas[1:]
                      for k, v in rep.state_dict().items() if "running" in k)
    print(f"[{tag}] {mesh_note(mesh)}: first loss {sloss:.7f} vs the unsharded {loss:.7f} (rel "
          f"{rel:.3g}, bound 2e-5); first update rel L2 {urel:.3g} (bound {MESH_UPDATE_RTOL}); "
          f"replicas' running statistics equal: {stats_equal}", flush=True)
    check(rel < 2e-5 and urel < MESH_UPDATE_RTOL and stats_equal,
          f"[{tag}] the sharded step vs the unsharded: loss rel {rel}, update rel {urel}, "
          f"statistics equal {stats_equal}")
    check(all(v == 0 for v in launched.values()), f"[{tag}] kernel launches in training {launched}")
    times = {}
    for name, fn, st in (("sharded", sstep, sstate), ("unsharded", step, state)):
        ms_ = []
        for _ in range(MESH_TRAIN_STEPS):
            t = time.perf_counter()
            float(fn(st, batch)[1])
            ms_.append((time.perf_counter() - t) * 1e3)
        times[name] = (float(np.median(ms_[2:])), ms_)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_train_")
    try:
        target = save_train_state(tmp, sstate, step=1 + MESH_TRAIN_STEPS)
        _, _, fresh = make_ufld_train_state(spec, mesh, **kw)
        restore_train_state(target, fresh)
        a, b = snet.gather(), fresh["net"].gather()
        check(all(torch.equal(a[k], b[k]) for k in a), f"[{tag}] checkpoint round trip")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # where a sharded step's time goes: a replica's forward and backward
    # on its part of the batch against the unsharded net's on all of it
    # (last: these passes move the replicas' running statistics apart)
    from adas_tpu_torch.parallel import ufld_loss

    rows = mesh.axis_size("data")
    half = {k: v[:TRAIN_BATCH // rows] for k, v in batch.items()}
    fb = {}
    for name, model, b in (("replica on its part", snet.replicas[0], half),
                           ("unsharded on the part", net, half),
                           ("unsharded on the batch", net, batch)):
        fb[name] = wall_ms(lambda: ufld_loss(model(b["images"]), b).backward(), 3)
    print(f"[{tag}] step ms median: sharded {times['sharded'][0]:.2f} (all "
          f"{[round(v, 1) for v in times['sharded'][1]]}), unsharded {times['unsharded'][0]:.2f} "
          f"(the same net and batch on one card; [train-ufldv2]'s step above); "
          f"{TRAIN_BATCH * 1e3 / times['sharded'][0]:.1f} images/s sharded; forward and "
          f"backward ms: { {k: round(v, 2) for k, v in fb.items()} }; checkpoint round "
          f"trip exact; no kernel launches ({smi})", flush=True)
    return launched


def mesh_phases(mods, smi, torch, np):
    """The mesh phases (23): ``[mesh-int8]``, ``[mesh-bf16]``,
    ``[mesh-sharded-step]``, ``[mesh-train]``; returns their counts."""
    serve_mesh, split_mesh = chip_meshes(torch)
    print(f"[mesh] {torch.cuda.device_count()} card(s): serving on {mesh_note(serve_mesh)}; "
          f"head split and training on {mesh_note(split_mesh)}", flush=True)
    t = time.perf_counter()
    int8_row = {"stem": 2, "int8_conv": 105, "block": BLOCKS_PER_TICK, "iou": 1, "nms": 1}
    runs = [mesh_serve_phase("mesh-int8", "int8", serve_mesh, mods, smi, torch, np, int8_row,
                             3, 6, probe=True)]
    torch.cuda.empty_cache()
    runs.append(mesh_serve_phase("mesh-bf16", "bf16", serve_mesh, mods, smi, torch, np,
                                 {"stem": 2, "int8_conv": 0, "block": 0, "iou": 1, "nms": 1},
                                 2, 3))
    torch.cuda.empty_cache()
    runs.append(mesh_sharded_step_phase(split_mesh, mods, smi, torch, np))
    torch.cuda.empty_cache()
    runs.append(mesh_train_phase(split_mesh, mods, smi, torch, np))
    print(f"[mesh] the mesh phases in {time.perf_counter() - t:.1f} s", flush=True)
    return runs


def main() -> int:
    if sys.argv[1:2] == ["--serve-artifact"]:
        return serve_artifact_child(sys.argv[2])
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
    from adas_tpu_torch.native import draw as native_draw
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
    with ThreadPoolExecutor(1) as pool:  # the HUD's rasterizer (g++) beside the kernels
        draw_build = pool.submit(native_draw._native)
        build_cuda_libraries(KERNELS)
        print(f"[build] {', '.join(f'csrc/{k}.cu' for k in KERNELS)} built in parallel in "
              f"{time.perf_counter() - t:.2f} s", flush=True)
        draw_build.result()
    print("[build] native/draw.cpp -> _build/libdraw.so (g++) built beside them", flush=True)
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
    runs = [*int8_main_phase(mods, torch, np)]
    uncal_run, uncal_conv = uncal_int8_phase(mods, torch, np)
    runs += [
        uncal_run,
        effdet_main_phase(mods, torch, np),
        bf16_main_phase(mods, torch, np),
    ]
    frame_run, frame_rows, int8_pipes = frame_phase("int8", mods, torch, np)
    runs += [frame_run, frame_phase("bf16", mods, torch, np)[0]]
    runs.append(render_phase(int8_pipes["fused"], mods, smi, torch, np))
    del int8_pipes
    config5_run, config5_conv = v10_config5_phase(mods, torch, np)
    runs += [config5_run, v10_frame_phase(mods, torch, np)]
    v5_run, v5_conv = v5_frame_phase(mods, torch, np)
    runs += [v5_run, demo_phase(mods, smi, torch, np)]
    v9c_run, v9c_conv = v9c_int8_phase(mods, torch, np)
    effdet_run, effdet_conv = effdet_int8_phase(mods, torch, np)
    families_run, families_shapes = families_phase(mods, torch, np)
    runs += [v9c_run, effdet_run, families_run,
             lane_depth_phase("34", mods, torch, np), lane_depth_phase("50", mods, torch, np)]
    served_run, served_sums, served_per_tick = lane_served_phase(mods, torch, np)
    runs.append(served_run)
    import_runs, import_per_tick = import_phases(mods, smi, torch, np)
    runs += import_runs
    runs += artifact_phases(mods, torch, np)
    t = time.perf_counter()
    runs.append(onnx_phases(mods, smi, torch, np))
    runs.append(transport_parity_phase(mods, smi, torch, np))
    runs.append(codec_phase(mods, smi, torch, np))
    runs.append(video_phase(mods, smi, torch, np))
    runs.append(train_phase(mods, smi, torch, np))
    print(f"[new-phases] onnx, transport parity, codec, video and training in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    runs += mesh_phases(mods, smi, torch, np)
    # every int8 conv shape of the [families] int8 frames against its plain
    # version (v5-lite's padded widths at their 640 shapes included)
    families_conv = main_path_conv_phase(IC, families_shapes, torch, tag="families-int8-shapes",
                                         per="frame of each int8 family")
    # the int8 conv summed over each new int8 path's distinct shapes
    rows["int8_conv"].update({f"{path}_{k}": v for path, sums in
                              (("config5_tick", config5_conv), ("v5_frame", v5_conv),
                               ("uncal_int8_tick", uncal_conv),
                               ("v9c_tick", v9c_conv), ("effdet_int8_tick", effdet_conv),
                               ("families_int8_frames", families_conv))
                              for k, v in sums.items()})
    # the served ResNet-34/50 lane ticks: the int8 conv and block sums per
    # tick over the lane net's shapes, and every kernel's launches per tick
    for path, by_kernel in served_sums.items():
        for k, tick in by_kernel.items():
            rows[k].update({f"{path}_{key}": v for key, v in tick.items()})
        for k in KERNELS:
            rows[k][f"{path}_launches"] = served_per_tick[path][k]
    for k in KERNELS:
        rows[k]["import_main_int8_launches"] = import_per_tick[k]
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
        **({"batch1_sites_ms": frame_rows[k]["sites_ms"]} if "sites_ms" in frame_rows[k] else {}),
    } for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
