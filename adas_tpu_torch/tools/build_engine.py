"""Engine-builder CLI: model + weights -> a ``.adas`` artifact (port of
``adas_tpu/tools/build_engine.py``), in three modes:

* a net (the registry's, ``engine/registry.py``): NHWC input -> the net's
  outputs, weights baked in (``engine/artifact.build_artifact``);
* ``--fused``: a YOLO or UFLD facade's fused step, uint8 frame in, decoded
  outputs out (``export_fused``);
* ``--multistream N``: the whole N-stream pipeline, both nets, the
  preprocess, the decode and the NMS (``MultiStreamADAS.export_fused``).

``--platforms cuda`` or ``cpu`` picks the device the step is exported on
and served from (default: the card where there is one).  ``--fp16`` is the
port's reduced precision, bf16 (as JAX's fused mode builds it).

    python -m adas_tpu_torch.tools.build_engine \\
        -t YOLOV8 --scale n --height 640 --width 640 \\
        -w yolov8n.npz -o yolov8n.adas --platforms cuda
"""
from __future__ import annotations

import argparse


def _device(args) -> str:
    from ..engine.artifact import _platform

    return _platform(args.platforms)[0]


def _build_net(args) -> dict:
    """The registry's net with the weights of ``-w`` (else the seeded
    init), exported at its canonical input shape."""
    import torch

    from ..engine.artifact import build_artifact
    from ..engine.registry import build
    from ..perception.object_detector import build_net, resolve_device

    def make():
        return build(args.type, scale=args.scale, height=args.height, width=args.width,
                     num_classes=args.num_classes)

    entry = make()
    device = resolve_device(_device(args))
    cd = "bf16" if args.fp16 else None
    net = build_net(lambda: make().net, device, cd, args.weights, 0)
    return build_artifact(
        lambda m, x: m(x.permute(0, 3, 1, 2)), net, entry.input_shape_nchw, args.output,
        dtype=torch.bfloat16 if args.fp16 else torch.float32, platforms=[device.type],
        meta=entry.meta, device=device,
    )


def _build_fused(args) -> dict:
    """The detector facade's fused step (``build_engine.py:33``)."""
    frame_hw = (args.frame_height, args.frame_width)
    device = _device(args)
    kind = args.type.upper()
    if kind.startswith("YOLO"):
        from ..perception.object_detector import YoloDetector
        from ..utils.types import ObjectModelType

        det = YoloDetector(model_path=args.weights, model_type=ObjectModelType[kind],
                           scale=args.scale, input_size=(args.height, args.width),
                           compute_dtype="bf16" if args.fp16 else None, device=device)
        return det.export_fused(args.output, frame_hw, platforms=[device])
    if kind.startswith("UFLD"):
        from ..perception.lane_detector import UltrafastLaneDetector, UltrafastLaneDetectorV2
        from ..utils.types import LaneModelType

        cls = UltrafastLaneDetectorV2 if "V2" in kind else UltrafastLaneDetector
        det = cls(model_path=args.weights, model_type=LaneModelType[kind], device=device)
        return det.export_fused(args.output, frame_hw, platforms=[device])
    raise SystemExit(f"--fused supports YOLO*/UFLD* types, not {args.type}")


def _build_multistream(args) -> dict:
    """The whole N-stream pipeline as one ``.adas`` (``build_engine.py:76``)."""
    from ..perception.lane_detector import UltrafastLaneDetectorV2
    from ..perception.object_detector import YoloDetector
    from ..pipeline.multistream import MultiStreamADAS
    from ..utils.types import LaneModelType, ObjectModelType

    device = _device(args)
    mtype = {m.name.upper(): m for m in ObjectModelType}[args.type.upper()]
    if mtype is ObjectModelType.EfficientDet:
        from ..perception.efficientdet_detector import EfficientdetDetector

        yolo = EfficientdetDetector(
            model_path=args.weights, device=device,
            compound=int(args.scale[-1]) if args.scale and args.scale[-1].isdigit() else 0,
        )
    else:
        yolo = YoloDetector(model_path=args.weights, model_type=mtype, scale=args.scale,
                            input_size=(args.height, args.width),
                            compute_dtype="bf16" if args.fp16 else None, device=device)
    lane = UltrafastLaneDetectorV2(model_path=args.lane_weights,
                                   model_type=LaneModelType[args.lane_type.upper()],
                                   device=device)
    ms = MultiStreamADAS(yolo, lane, args.multistream,
                         frame_hw=(args.frame_height, args.frame_width),
                         host_downscale=tuple(args.downscale) if args.downscale else None,
                         transport=args.transport)
    try:
        return ms.export_fused(args.output, platforms=[device])
    finally:
        ms.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Build a serialized engine artifact (.adas)")
    ap.add_argument("-t", "--type", required=True,
                    help="model type enum name, e.g. YOLOV8 / UFLDV2_CULANE")
    ap.add_argument("--scale", default="n", help="yolo scale or d-compound")
    ap.add_argument("--height", type=int, default=640)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--num-classes", type=int, default=80)
    ap.add_argument("-w", "--weights", default=None, help=".npz weights")
    ap.add_argument("-o", "--output", required=True, help=".adas output")
    ap.add_argument("--fp16", action="store_true",
                    help="build in reduced precision (bf16 on the port)")
    ap.add_argument("--platforms", nargs="*", default=None,
                    help="the export device: cuda or cpu")
    ap.add_argument("--fused", action="store_true",
                    help="export the detector's FUSED step (uint8 frame in,"
                         " decoded outputs out; single round-trip serving)")
    ap.add_argument("--frame-height", type=int, default=720,
                    help="source frame height baked into a fused engine")
    ap.add_argument("--frame-width", type=int, default=1280,
                    help="source frame width baked into a fused engine")
    ap.add_argument("--multistream", type=int, default=0, metavar="N",
                    help="export the WHOLE N-stream pipeline (object + "
                         "lane + decode + NMS) as one engine")
    ap.add_argument("--lane-type", default="UFLDV2_CULANE",
                    help="lane model enum for --multistream")
    ap.add_argument("--lane-weights", default=None,
                    help="lane .npz weights for --multistream")
    ap.add_argument("--transport", default="i420", choices=["i420", "bgr"],
                    help="frame transport baked into a --multistream engine")
    ap.add_argument("--downscale", type=int, nargs=2, default=None, metavar=("H", "W"),
                    help="host pre-resize baked into a --multistream engine")
    args = ap.parse_args(argv)

    if args.multistream:
        meta = _build_multistream(args)
        print(f"=== multistream pipeline engine: {args.output}")
        print(f"  input  {meta['frame_shape']} {meta['input_dtype']} "
              f"({meta['n_streams']} streams, {meta['transport']})")
        print(f"  packed outputs: {meta['output_shapes']}")
        print(f"  platforms: {meta['platforms']}")
        return
    if args.fused:
        meta = _build_fused(args)
        print(f"=== fused engine: {args.output}")
        print(f"  frame  {meta['frame_shape']} {meta['input_dtype']}")
    else:
        meta = _build_net(args)
        print(f"=== engine: {args.output}")
        print(f"  input  {meta['input_shape_nchw']} {meta['input_dtype']}")
    for name, shape, dt in zip(meta["output_names"], meta["output_shapes"],
                               meta["output_dtypes"]):
        print(f"  output {name}: {shape} {dt}")
    print(f"  platforms: {meta['platforms']}")


if __name__ == "__main__":
    main()
