"""YOLO checkpoint ingestion: torch/ONNX tensors -> flax variables (the
port's copy of ``adas_tpu/tools/yolo_import.py``).

Maps the public module-index layouts (ultralytics ``model.{i}.*`` for
v5/v8/v9/v10, meituan's for v6, WongKinYiu's for v7, ppogg's for
v5-lite; their ONNX exports keep the same names) onto the flax tree of
each family's graph, as the JAX package's importer does, so the port's
``weights.load_flax_variables`` loads the result.  The mappings read the
port's own ``YoloSpec`` (``models/yolo.py``).  ONNX files go through
``onnx_import.read_onnx_initializers`` first.

The DFL conv (``model.22.dfl.conv.weight``, a frozen arange kernel) is
skipped: the nets compute the distribution's expectation directly.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

from ..models.yolo import YoloSpec
from .torch_import import _conv, _set  # OIHW -> HWIO


def _convbn_entries(src: str, dst: Tuple[str, ...]):
    """Ultralytics ``Conv`` (conv+bn+act) -> ConvBN params/batch_stats."""
    return [
        (f"{src}.conv.weight", "params", dst + ("conv", "kernel"), _conv),
        (f"{src}.bn.weight", "params", dst + ("bn", "scale"), None),
        (f"{src}.bn.bias", "params", dst + ("bn", "bias"), None),
        (f"{src}.bn.running_mean", "batch_stats", dst + ("bn", "mean"), None),
        (f"{src}.bn.running_var", "batch_stats", dst + ("bn", "var"), None),
    ]


def _plain_conv_entries(src: str, dst: Tuple[str, ...]):
    """Bare nn.Conv2d with bias -> flax nn.Conv."""
    return [
        (f"{src}.weight", "params", dst + ("kernel",), _conv),
        (f"{src}.bias", "params", dst + ("bias",), None),
    ]


def _c2f_entries(src: str, dst: str, n: int):
    out = _convbn_entries(f"{src}.cv1", (dst, "cv1"))
    out += _convbn_entries(f"{src}.cv2", (dst, "cv2"))
    for i in range(n):
        out += _convbn_entries(f"{src}.m.{i}.cv1", (dst, f"m{i}", "cv1"))
        out += _convbn_entries(f"{src}.m.{i}.cv2", (dst, f"m{i}", "cv2"))
    return out


def _c3_entries(src: str, dst: str, n: int):
    out = _convbn_entries(f"{src}.cv1", (dst, "cv1"))
    out += _convbn_entries(f"{src}.cv2", (dst, "cv2"))
    out += _convbn_entries(f"{src}.cv3", (dst, "cv3"))
    for i in range(n):
        out += _convbn_entries(f"{src}.m.{i}.cv1", (dst, f"m{i}", "cv1"))
        out += _convbn_entries(f"{src}.m.{i}.cv2", (dst, f"m{i}", "cv2"))
    return out


def _sppf_entries(src: str, dst: str):
    return _convbn_entries(f"{src}.cv1", (dst, "cv1")) + _convbn_entries(
        f"{src}.cv2", (dst, "cv2")
    )


def yolov8_mapping(spec: YoloSpec) -> List[tuple]:
    """(src_key, collection, dst_path, transform) table for YOLOv8."""
    d = spec.depths
    m = []
    net = lambda *p: ("net",) + p  # noqa: E731
    m += _convbn_entries("model.0", net("stem"))
    m += _convbn_entries("model.1", net("down1"))
    m += [
        (s, c, net(*p), t)
        for s, c, p, t in _c2f_entries("model.2", "stage1", d[0])
    ]
    m += _convbn_entries("model.3", net("down2"))
    m += [
        (s, c, net(*p), t)
        for s, c, p, t in _c2f_entries("model.4", "stage2", d[1])
    ]
    m += _convbn_entries("model.5", net("down3"))
    m += [
        (s, c, net(*p), t)
        for s, c, p, t in _c2f_entries("model.6", "stage3", d[2])
    ]
    m += _convbn_entries("model.7", net("down4"))
    m += [
        (s, c, net(*p), t)
        for s, c, p, t in _c2f_entries("model.8", "stage4", d[3])
    ]
    m += [
        (s, c, net(*p), t) for s, c, p, t in _sppf_entries("model.9", "sppf")
    ]
    # PAN neck (10/13 upsample, 11/14/17/20 concat: no params)
    m += [
        (s, c, net(*p), t)
        for s, c, p, t in _c2f_entries("model.12", "fpn4", d[0])
    ]
    m += [
        (s, c, net(*p), t)
        for s, c, p, t in _c2f_entries("model.15", "fpn3", d[0])
    ]
    m += _convbn_entries("model.16", net("pan3"))
    m += [
        (s, c, net(*p), t)
        for s, c, p, t in _c2f_entries("model.18", "pan4", d[0])
    ]
    m += _convbn_entries("model.19", net("pan5_down"))
    m += [
        (s, c, net(*p), t)
        for s, c, p, t in _c2f_entries("model.21", "pan5", d[0])
    ]
    # Detect head 22: cv2 = box branch, cv3 = cls branch, per level
    for li in range(3):
        m += _convbn_entries(
            f"model.22.cv2.{li}.0", ("head", f"box{li}_0")
        )
        m += _convbn_entries(
            f"model.22.cv2.{li}.1", ("head", f"box{li}_1")
        )
        m += _plain_conv_entries(
            f"model.22.cv2.{li}.2", ("head", f"box{li}_2")
        )
        m += _convbn_entries(
            f"model.22.cv3.{li}.0", ("head", f"cls{li}_0")
        )
        m += _convbn_entries(
            f"model.22.cv3.{li}.1", ("head", f"cls{li}_1")
        )
        m += _plain_conv_entries(
            f"model.22.cv3.{li}.2", ("head", f"cls{li}_2")
        )
    return m


def yolov5_mapping(spec: YoloSpec) -> List[tuple]:
    """(src_key, collection, dst_path, transform) table for YOLOv5 (v6.x
    layout: SPPF at 9, Detect at 24)."""
    d = spec.depths
    m = []
    net = lambda *p: ("net",) + p  # noqa: E731
    m += _convbn_entries("model.0", net("stem"))
    m += _convbn_entries("model.1", net("down1"))
    m += [(s, c, net(*p), t) for s, c, p, t in _c3_entries("model.2", "stage1", d[0])]
    m += _convbn_entries("model.3", net("down2"))
    m += [(s, c, net(*p), t) for s, c, p, t in _c3_entries("model.4", "stage2", d[1])]
    m += _convbn_entries("model.5", net("down3"))
    m += [(s, c, net(*p), t) for s, c, p, t in _c3_entries("model.6", "stage3", d[2])]
    m += _convbn_entries("model.7", net("down4"))
    m += [(s, c, net(*p), t) for s, c, p, t in _c3_entries("model.8", "stage4", d[3])]
    m += [(s, c, net(*p), t) for s, c, p, t in _sppf_entries("model.9", "sppf")]
    m += _convbn_entries("model.10", net("lat5"))
    m += [(s, c, net(*p), t) for s, c, p, t in _c3_entries("model.13", "fpn4", d[0])]
    m += _convbn_entries("model.14", net("lat4"))
    m += [(s, c, net(*p), t) for s, c, p, t in _c3_entries("model.17", "fpn3", d[0])]
    m += _convbn_entries("model.18", net("pan3"))
    m += [(s, c, net(*p), t) for s, c, p, t in _c3_entries("model.20", "pan4", d[0])]
    m += _convbn_entries("model.21", net("pan5_down"))
    m += [(s, c, net(*p), t) for s, c, p, t in _c3_entries("model.23", "pan5", d[0])]
    for li in range(3):
        m += _plain_conv_entries(f"model.24.m.{li}", (f"head{li}",))
    return m


_SKIP_SUFFIXES = (
    "num_batches_tracked", "anchors", "anchor_grid", "dfl.conv.weight",
    "stride", "proj_conv.weight", "proj",
)


# --- YOLOv6 (meituan EfficientRep) ----------------------------------------


def _repvgg_entries(src: str, dst: Tuple[str, ...], identity: bool):
    """meituan RepVGGBlock (training form): rbr_dense/rbr_1x1 conv_bn
    Sequentials (+ rbr_identity BatchNorm when in==out, stride 1)."""
    out = _convbn_entries(f"{src}.rbr_dense", dst + ("rbr_dense",))
    out += _convbn_entries(f"{src}.rbr_1x1", dst + ("rbr_1x1",))
    if identity:
        out += [
            (f"{src}.rbr_identity.weight", "params",
             dst + ("rbr_identity", "scale"), None),
            (f"{src}.rbr_identity.bias", "params",
             dst + ("rbr_identity", "bias"), None),
            (f"{src}.rbr_identity.running_mean", "batch_stats",
             dst + ("rbr_identity", "mean"), None),
            (f"{src}.rbr_identity.running_var", "batch_stats",
             dst + ("rbr_identity", "var"), None),
        ]
    return out


def _repblock_entries(
    src: str, dst: Tuple[str, ...], n: int, conv1_identity: bool
):
    """RepBlock = conv1 + block.{0..n-2}; inner blocks are in==out so
    they always carry the identity BN."""
    out = _repvgg_entries(f"{src}.conv1", dst + ("conv1",), conv1_identity)
    for i in range(n - 1):
        out += _repvgg_entries(f"{src}.block.{i}", dst + (f"block{i}",), True)
    return out


def _bottlerep_entries(src: str, dst: Tuple[str, ...]):
    """meituan BottleRep (m/l CSPBep unit): conv1/conv2 RepVGG blocks
    (in==out inside BepC3, so identity BN always present) + the
    weighted-residual ``alpha``."""
    out = _repvgg_entries(f"{src}.conv1", dst + ("conv1",), True)
    out += _repvgg_entries(f"{src}.conv2", dst + ("conv2",), True)
    out += [(f"{src}.alpha", "params", dst + ("alpha",), None)]
    return out


def _bepc3_entries(src: str, dst: Tuple[str, ...], n: int):
    """meituan BepC3: cv1/cv2/cv3 Conv_C3 (conv+bn) + the BottleRep
    chain ``m.conv1`` / ``m.block.{i}`` of n//2 units."""
    out = _convbn_entries(f"{src}.cv1", dst + ("cv1",))
    out += _convbn_entries(f"{src}.cv2", dst + ("cv2",))
    out += _convbn_entries(f"{src}.cv3", dst + ("cv3",))
    out += _bottlerep_entries(f"{src}.m.conv1", dst + ("m_conv1",))
    for i in range(n // 2 - 1):
        out += _bottlerep_entries(
            f"{src}.m.block.{i}", dst + (f"m_block{i}",)
        )
    return out


def _deconv(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d (in, out, kh, kw) -> flax
    ``transpose_kernel=True`` layout (kh, kw, out, in) — bit-exact with
    torch (models/yolov6.TransposeUp docstring)."""
    return np.transpose(w, (2, 3, 1, 0))


def yolov6_mapping(spec: YoloSpec) -> List[tuple]:
    """(src, collection, dst, transform) for meituan YOLOv6 2.x
    training checkpoints (models/yolov6.py graph): n/s EfficientRep
    RepBlock stages, m/l CSPBep BepC3 stages."""
    from ..models.yolov6 import _V6_CSP_SCALES, v6_plan

    scale = spec.scale if spec.scale in ("n", "s", "m", "l") else "s"
    csp = scale in _V6_CSP_SCALES
    chans, reps = v6_plan(scale)

    def stage(src, dst, n, conv1_identity):
        if csp:
            return _bepc3_entries(src, dst, n)
        return _repblock_entries(src, dst, n, conv1_identity)

    bb = lambda *p: ("backbone",) + p  # noqa: E731
    nk = lambda *p: ("neck",) + p  # noqa: E731
    m = []
    m += _repvgg_entries("backbone.stem", bb("stem"), False)
    for k, rep_n in ((2, reps[1]), (3, reps[2]), (4, reps[3]), (5, reps[4])):
        m += _repvgg_entries(
            f"backbone.ERBlock_{k}.0", bb(f"ERBlock_{k}_0"), False
        )
        m += stage(
            f"backbone.ERBlock_{k}.1", bb(f"ERBlock_{k}_1"), rep_n, True
        )
    m += _convbn_entries(
        "backbone.ERBlock_5.2.cv1", bb("ERBlock_5_2", "cv1")
    )
    m += _convbn_entries(
        "backbone.ERBlock_5.2.cv2", bb("ERBlock_5_2", "cv2")
    )

    m += _convbn_entries("neck.reduce_layer0", nk("reduce_layer0"))
    m += [
        ("neck.upsample0.upsample_transpose.weight", "params",
         nk("upsample0", "upsample_transpose", "kernel"), _deconv),
        ("neck.upsample0.upsample_transpose.bias", "params",
         nk("upsample0", "upsample_transpose", "bias"), None),
    ]
    # conv1 identity flags follow the channel plan: Rep_p4/Rep_p3 fuse a
    # concat wider than their output (no identity); Rep_n3/Rep_n4 input
    # widths equal their outputs by design (identity present)
    m += stage("neck.Rep_p4", nk("Rep_p4"), reps[5], False)
    m += _convbn_entries("neck.reduce_layer1", nk("reduce_layer1"))
    m += [
        ("neck.upsample1.upsample_transpose.weight", "params",
         nk("upsample1", "upsample_transpose", "kernel"), _deconv),
        ("neck.upsample1.upsample_transpose.bias", "params",
         nk("upsample1", "upsample_transpose", "bias"), None),
    ]
    m += stage("neck.Rep_p3", nk("Rep_p3"), reps[6], False)
    m += _convbn_entries("neck.downsample2", nk("downsample2"))
    m += stage(
        "neck.Rep_n3", nk("Rep_n3"), reps[7],
        chans[7] + chans[6] == chans[8],
    )
    m += _convbn_entries("neck.downsample1", nk("downsample1"))
    m += stage(
        "neck.Rep_n4", nk("Rep_n4"), reps[8],
        chans[9] + chans[5] == chans[10],
    )

    for li in range(3):
        m += _convbn_entries(
            f"detect.stems.{li}", ("detect", f"stem{li}")
        )
        m += _convbn_entries(
            f"detect.cls_convs.{li}", ("detect", f"cls_conv{li}")
        )
        m += _convbn_entries(
            f"detect.reg_convs.{li}", ("detect", f"reg_conv{li}")
        )
        m += _plain_conv_entries(
            f"detect.cls_preds.{li}", ("detect", f"cls_pred{li}")
        )
        m += _plain_conv_entries(
            f"detect.reg_preds.{li}", ("detect", f"reg_pred{li}")
        )
    return m


# --- YOLOv7 (WongKinYiu E-ELAN) --------------------------------------------

#: yaml layer indices that are plain Conv modules (cfg/deploy/yolov7.yaml)
_V7_CONV_IDX = (
    list(range(0, 10)) + [11] + [13, 14, 15] + list(range(17, 23)) + [24]
    + [26, 27, 28] + list(range(30, 36)) + [37] + [39, 40, 41]
    + list(range(43, 49)) + [50]
    + [52, 54] + list(range(56, 62)) + [63, 64, 66]
    + list(range(68, 74)) + [75] + [77, 78, 79] + list(range(81, 87))
    + [88] + [90, 91, 92] + list(range(94, 100)) + [101]
)


def _seq_convbn_entries(src: str, dst: Tuple[str, ...]):
    """Unnamed Sequential(conv, bn) (v7 RepConv branches)."""
    return [
        (f"{src}.0.weight", "params", dst + ("conv", "kernel"), _conv),
        (f"{src}.1.weight", "params", dst + ("bn", "scale"), None),
        (f"{src}.1.bias", "params", dst + ("bn", "bias"), None),
        (f"{src}.1.running_mean", "batch_stats", dst + ("bn", "mean"), None),
        (f"{src}.1.running_var", "batch_stats", dst + ("bn", "var"), None),
    ]


def _implicit(w: np.ndarray) -> np.ndarray:
    """(1, C, 1, 1) -> (1, 1, 1, C)."""
    return np.transpose(w, (0, 2, 3, 1))


def yolov7_mapping(spec: YoloSpec) -> List[tuple]:
    """(src, collection, dst, transform) for official yolov7 (base 640)
    training checkpoints — module indices mirror cfg/deploy/yolov7.yaml
    exactly (models/yolov7.py names modules m{i})."""
    m = []
    for i in _V7_CONV_IDX:
        m += _convbn_entries(f"model.{i}", (f"m{i}",))
    for k in range(1, 8):  # SPPCSPC at 51: cv1..cv7
        m += _convbn_entries(f"model.51.cv{k}", ("m51", f"cv{k}"))
    for i in (102, 103, 104):  # RepConv pre-heads
        m += _seq_convbn_entries(f"model.{i}.rbr_dense", (f"m{i}", "rbr_dense"))
        m += _seq_convbn_entries(f"model.{i}.rbr_1x1", (f"m{i}", "rbr_1x1"))
    for li in range(3):  # IDetect at 105
        m += _plain_conv_entries(f"model.105.m.{li}", (f"head{li}",))
        m += [
            (f"model.105.ia.{li}.implicit", "params",
             (f"ia{li}_implicit",), _implicit),
            (f"model.105.im.{li}.implicit", "params",
             (f"im{li}_implicit",), _implicit),
        ]
    return m


# --- YOLOv9 (ultralytics yolov9c / GELAN-C) --------------------------------


def _repconvn_entries(src: str, dst: Tuple[str, ...]):
    return _convbn_entries(f"{src}.conv1", dst + ("conv1",)) + \
        _convbn_entries(f"{src}.conv2", dst + ("conv2",))


def _repncsp_entries(src: str, dst: Tuple[str, ...], n: int):
    out = _convbn_entries(f"{src}.cv1", dst + ("cv1",))
    out += _convbn_entries(f"{src}.cv2", dst + ("cv2",))
    out += _convbn_entries(f"{src}.cv3", dst + ("cv3",))
    for i in range(n):
        out += _repconvn_entries(f"{src}.m.{i}.cv1", dst + (f"m{i}", "cv1"))
        out += _convbn_entries(f"{src}.m.{i}.cv2", dst + (f"m{i}", "cv2"))
    return out


def _repncspelan_entries(src: str, dst: str, n: int):
    out = _convbn_entries(f"{src}.cv1", (dst, "cv1"))
    out += _repncsp_entries(f"{src}.cv2.0", (dst, "cv2_csp"), n)
    out += _convbn_entries(f"{src}.cv2.1", (dst, "cv2_conv"))
    out += _repncsp_entries(f"{src}.cv3.0", (dst, "cv3_csp"), n)
    out += _convbn_entries(f"{src}.cv3.1", (dst, "cv3_conv"))
    out += _convbn_entries(f"{src}.cv4", (dst, "cv4"))
    return out


def _adown_entries(src: str, dst: str):
    return _convbn_entries(f"{src}.cv1", (dst, "cv1")) + _convbn_entries(
        f"{src}.cv2", (dst, "cv2")
    )


def yolov9_mapping(spec: YoloSpec) -> List[tuple]:
    """(src, collection, dst, transform) for ultralytics yolov9c
    checkpoints (GELAN-C trunk, models/yolov9.py graph)."""
    m = []
    m += _convbn_entries("model.0", ("stem",))
    m += _convbn_entries("model.1", ("down1",))
    m += _repncspelan_entries("model.2", "stage1", 1)
    m += _adown_entries("model.3", "down2")
    m += _repncspelan_entries("model.4", "stage2", 1)
    m += _adown_entries("model.5", "down3")
    m += _repncspelan_entries("model.6", "stage3", 1)
    m += _adown_entries("model.7", "down4")
    m += _repncspelan_entries("model.8", "stage4", 1)
    m += _convbn_entries("model.9.cv1", ("sppelan", "cv1"))
    m += _convbn_entries("model.9.cv5", ("sppelan", "cv5"))
    m += _repncspelan_entries("model.12", "fpn4", 1)
    m += _repncspelan_entries("model.15", "fpn3", 1)
    m += _adown_entries("model.16", "pan3")
    m += _repncspelan_entries("model.18", "pan4", 1)
    m += _adown_entries("model.19", "pan5_down")
    m += _repncspelan_entries("model.21", "pan5", 1)
    for li in range(3):
        m += _convbn_entries(f"model.22.cv2.{li}.0", ("head", f"box{li}_0"))
        m += _convbn_entries(f"model.22.cv2.{li}.1", ("head", f"box{li}_1"))
        m += _plain_conv_entries(
            f"model.22.cv2.{li}.2", ("head", f"box{li}_2")
        )
        m += _convbn_entries(f"model.22.cv3.{li}.0", ("head", f"cls{li}_0"))
        m += _convbn_entries(f"model.22.cv3.{li}.1", ("head", f"cls{li}_1"))
        m += _plain_conv_entries(
            f"model.22.cv3.{li}.2", ("head", f"cls{li}_2")
        )
    return m


# --- YOLOv5-Lite (ppogg ShuffleNetV2 e/s) ---------------------------------


def _seqcb_entries(src: str, ci: int, bi: int, dst: Tuple[str, ...]):
    """torch ``Sequential(Conv2d@ci, BatchNorm2d@bi, ...)`` -> ConvBN."""
    return [
        (f"{src}.{ci}.weight", "params", dst + ("conv", "kernel"), _conv),
        (f"{src}.{bi}.weight", "params", dst + ("bn", "scale"), None),
        (f"{src}.{bi}.bias", "params", dst + ("bn", "bias"), None),
        (f"{src}.{bi}.running_mean", "batch_stats",
         dst + ("bn", "mean"), None),
        (f"{src}.{bi}.running_var", "batch_stats",
         dst + ("bn", "var"), None),
    ]


def _shuffle_entries(src: str, dst: Tuple[str, ...], down: bool):
    """ppogg ``Shuffle_Block``: branch1 = Sequential(dw, bn, pw, bn,
    relu) (stride-2 form only), branch2 = Sequential(pw, bn, relu, dw,
    bn, pw, bn, relu) -> models/yolov5lite.ShuffleV2Block."""
    out = []
    if down:
        out += _seqcb_entries(f"{src}.branch1", 0, 1, dst + ("b1_dw",))
        out += _seqcb_entries(f"{src}.branch1", 2, 3, dst + ("b1_pw",))
    out += _seqcb_entries(f"{src}.branch2", 0, 1, dst + ("b2_pw1",))
    out += _seqcb_entries(f"{src}.branch2", 3, 4, dst + ("b2_dw",))
    out += _seqcb_entries(f"{src}.branch2", 5, 6, dst + ("b2_pw2",))
    return out


_REPVGG_BN_EPS = 1e-5  # torch BatchNorm2d default, used by RepVGGBlock


def _bn_fold_conv(kernel: np.ndarray, state: dict, bn: str):
    """Fold torch BN stats (child prefix ``bn``) following a bias-free
    conv into (kernel, bias) — OIHW in, OIHW out."""
    gamma = state[f"{bn}.weight"]
    beta = state[f"{bn}.bias"]
    mean = state[f"{bn}.running_mean"]
    var = state[f"{bn}.running_var"]
    t = gamma / np.sqrt(var + _REPVGG_BN_EPS)
    return (
        kernel * t[:, None, None, None],
        (beta - mean * t).astype(np.float32),
    )


def fuse_repvgg_state(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Structural re-parameterization at ingest (RepVGG
    ``switch_to_deploy``, arXiv:2101.03697): every train-form block
    (``rbr_dense`` 3×3 conv+BN, ``rbr_1x1`` 1×1 conv+BN, optional
    ``rbr_identity`` BN) collapses EXACTLY into one 3×3 conv + bias.

    Emits synthetic ``{block}.fused.*`` tensors consumed by
    ``_repvgg_fused_entries`` and drops the branch tensors; blocks whose
    checkpoints are already deploy-form (``.fused.*`` present) pass
    through untouched.  The fused bias rides the flax BN bias with
    identity stats (scale=1, mean=0, var=1-eps) so the target module is
    a standard ConvBN and the int8 machinery applies unchanged."""
    out = dict(state)
    suffix = ".rbr_dense.conv.weight"
    for key in sorted(state):
        if not key.endswith(suffix):
            continue
        p = key[: -len(suffix)]
        w3 = np.asarray(state[f"{p}.rbr_dense.conv.weight"], np.float32)
        kern, bias = _bn_fold_conv(w3, state, f"{p}.rbr_dense.bn")
        w1 = np.asarray(state[f"{p}.rbr_1x1.conv.weight"], np.float32)
        k1, b1 = _bn_fold_conv(
            np.pad(w1, ((0, 0), (0, 0), (1, 1), (1, 1))),
            state, f"{p}.rbr_1x1.bn",
        )
        kern, bias = kern + k1, bias + b1
        consumed = [
            f"{p}.rbr_dense.conv.weight", f"{p}.rbr_1x1.conv.weight",
        ]
        for br in ("rbr_dense.bn", "rbr_1x1.bn"):
            consumed += [
                f"{p}.{br}.{s}" for s in
                ("weight", "bias", "running_mean", "running_var",
                 "num_batches_tracked")
            ]
        if f"{p}.rbr_identity.weight" in state:
            o = w3.shape[0]
            wid = np.zeros_like(w3)
            wid[np.arange(o), np.arange(o), 1, 1] = 1.0
            kid, bid = _bn_fold_conv(wid, state, f"{p}.rbr_identity")
            kern, bias = kern + kid, bias + bid
            consumed += [
                f"{p}.rbr_identity.{s}" for s in
                ("weight", "bias", "running_mean", "running_var",
                 "num_batches_tracked")
            ]
        o = kern.shape[0]
        out[f"{p}.fused.weight"] = kern.astype(np.float32)
        out[f"{p}.fused.bias"] = bias
        out[f"{p}.fused.bn_scale"] = np.ones(o, np.float32)
        out[f"{p}.fused.bn_mean"] = np.zeros(o, np.float32)
        out[f"{p}.fused.bn_var"] = np.full(o, 1.0 - _REPVGG_BN_EPS, np.float32)
        for k in consumed:
            out.pop(k, None)
    return out


def _repvgg_fused_entries(src: str, dst: Tuple[str, ...]):
    """Deploy-form (ingest-fused) RepVGG block -> ConvBN leaves.  The
    ``.fused.*`` keys come from fuse_repvgg_state (train-form
    checkpoints) or directly from a deploy-form export."""
    return [
        (f"{src}.fused.weight", "params", dst + ("conv", "kernel"), _conv),
        (f"{src}.fused.bn_scale", "params", dst + ("bn", "scale"), None),
        (f"{src}.fused.bias", "params", dst + ("bn", "bias"), None),
        (f"{src}.fused.bn_mean", "batch_stats", dst + ("bn", "mean"), None),
        (f"{src}.fused.bn_var", "batch_stats", dst + ("bn", "var"), None),
    ]


def yolov5lite_g_mapping(spec: YoloSpec) -> List[tuple]:
    """v5lite-g (RepVGG trunk, reconstructed v5lite-g.yaml layout —
    see models/yolov5lite.V5LITE_G_PLAN): RepVGG down-blocks at module
    indices 0/1/3/5/7 with repeat Sequentials at 2/4/6, SPP at 8,
    single-width PAN at 9-22, Detect at 23.  Ultralytics parse_model
    materializes number==1 repeats as a bare module (no ``.0.``)."""
    from ..models.yolov5lite import V5LITE_G_PLAN

    blocks = V5LITE_G_PLAN["blocks"]
    bb = lambda *p: ("backbone",) + p  # noqa: E731
    nk = lambda *p: ("neck",) + p  # noqa: E731
    m = []
    idx = 0
    for si, n in enumerate(blocks):
        m += _repvgg_fused_entries(f"model.{idx}", bb(f"rep{si}_0"))
        idx += 1
        if n > 1:
            for bi in range(1, n):
                src = f"model.{idx}" if n == 2 else f"model.{idx}.{bi - 1}"
                m += _repvgg_fused_entries(src, bb(f"rep{si}_{bi}"))
            idx += 1
    # idx == 8: SPP
    m += _convbn_entries("model.8.cv1", bb("spp", "cv1"))
    m += _convbn_entries("model.8.cv2", bb("spp", "cv2"))
    m += _convbn_entries("model.9", nk("lat5"))
    m += [(s, c, nk(*p), t) for s, c, p, t in _c3_entries("model.12", "fpn4", 1)]
    m += _convbn_entries("model.13", nk("lat4"))
    m += [(s, c, nk(*p), t) for s, c, p, t in _c3_entries("model.16", "fpn3", 1)]
    m += _convbn_entries("model.17", nk("pan3"))
    m += [(s, c, nk(*p), t) for s, c, p, t in _c3_entries("model.19", "pan4", 1)]
    m += _convbn_entries("model.20", nk("pan5_down"))
    m += [(s, c, nk(*p), t) for s, c, p, t in _c3_entries("model.22", "pan5", 1)]
    for li in range(3):
        m += _plain_conv_entries(f"model.23.m.{li}", (f"head{li}",))
    return m


def yolov5lite_mapping(spec: YoloSpec) -> List[tuple]:
    """(src, collection, dst, transform) for ppogg/YOLOv5-Lite e/s
    checkpoints (v5lite-{e,s}.yaml module-index layout: StemBlock at 0,
    three Shuffle_Block stages, single-width PAN, Detect at 21).  The g
    scale (RepVGG trunk) dispatches to yolov5lite_g_mapping."""
    from ..models.yolov5lite import V5LITE_PLANS

    if spec.scale == "g":
        return yolov5lite_g_mapping(spec)

    scale = spec.scale if spec.scale in V5LITE_PLANS else "s"
    repeats = V5LITE_PLANS[scale][2]
    bb = lambda *p: ("backbone",) + p  # noqa: E731
    nk = lambda *p: ("neck",) + p  # noqa: E731
    m = []
    for part in ("stem_1", "stem_2a", "stem_2b", "stem_3"):
        m += _convbn_entries(f"model.0.{part}", bb("stem", part))
    idx = 1
    for si, reps in enumerate(repeats):
        m += _shuffle_entries(
            f"model.{idx}", bb(f"stage{si}_down"), down=True
        )
        idx += 1
        for ri in range(reps):
            m += _shuffle_entries(
                f"model.{idx}.{ri}", bb(f"stage{si}_{ri}"), down=False
            )
        idx += 1
    m += _convbn_entries("model.7", nk("lat5"))
    m += [(s, c, nk(*p), t) for s, c, p, t in _c3_entries("model.10", "fpn4", 1)]
    m += _convbn_entries("model.11", nk("lat4"))
    m += [(s, c, nk(*p), t) for s, c, p, t in _c3_entries("model.14", "fpn3", 1)]
    m += _convbn_entries("model.15", nk("pan3"))
    m += [(s, c, nk(*p), t) for s, c, p, t in _c3_entries("model.17", "pan4", 1)]
    m += _convbn_entries("model.18", nk("pan5_down"))
    m += [(s, c, nk(*p), t) for s, c, p, t in _c3_entries("model.20", "pan5", 1)]
    for li in range(3):
        m += _plain_conv_entries(f"model.21.m.{li}", (f"head{li}",))
    return m


def yolo_variables(
    state: Dict[str, np.ndarray], spec: YoloSpec
) -> dict:
    """torch/ONNX state tensors -> flax variables for build_yolo(spec).

    Accepts keys with or without a leading ``model.`` wrapper prefix
    (ultralytics full checkpoints nest the detection model once more).
    """
    mapping = yolo_mapping(spec)
    # normalize double-model prefix: "model.model.3..." -> "model.3..."
    norm = {}
    for k, v in state.items():
        if k.startswith("model.model."):
            k = k[len("model.") :]
        norm[k] = np.asarray(v)
    if spec.family == "v5lite" and spec.scale == "g":
        # RepVGG switch_to_deploy at ingest: train-form branch tensors
        # collapse into the single-conv deploy form the native graph
        # serves (models/yolov5lite.RepBackbone)
        norm = fuse_repvgg_state(norm)

    variables: dict = {"params": {}, "batch_stats": {}}
    used = set()
    for src, collection, dst, transform in mapping:
        if src not in norm:
            raise KeyError(f"checkpoint missing tensor {src}")
        value = norm[src]
        if transform is not None:
            value = transform(value)
        _set(variables[collection], dst, value)
        used.add(src)
    leftover = [
        k for k in norm
        if k not in used and not k.endswith(_SKIP_SUFFIXES)
    ]
    if leftover:
        raise KeyError(f"unmapped checkpoint tensors: {leftover[:8]} ...")
    return variables


def yolo_mapping(spec: YoloSpec) -> List[tuple]:
    """The (src, collection, dst, transform) table of ``spec.family``."""
    tables = {
        "v5": yolov5_mapping, "v5lite": yolov5lite_mapping, "v6": yolov6_mapping,
        "v7": yolov7_mapping, "v8": yolov8_mapping, "v9": yolov9_mapping,
        "v10": yolov10_mapping,
    }
    if spec.family not in tables:
        raise NotImplementedError(
            f"no checkpoint mapping for family {spec.family!r} yet"
        )
    return tables[spec.family](spec)


def inverse_mapping(spec: YoloSpec) -> Iterator[tuple]:
    """The mapping table of ``spec.family``, to write a flax tree back under
    the checkpoint's names.  (The JAX package's returns v5's table for
    every family but v8; this one follows :func:`yolo_mapping`.)"""
    return iter(yolo_mapping(spec))


def _inverse(transform):
    """The torch layout of a mapped leaf (the inverse of its transform)."""
    if transform is None:
        return lambda v: v
    if transform is _implicit:  # (1, 1, 1, C) -> (1, C, 1, 1)
        return lambda v: np.transpose(v, (0, 3, 1, 2))
    # _conv and _deconv: HWIO -> OIHW, (kh, kw, out, in) -> (in, out, kh, kw)
    return lambda v: np.transpose(v, (3, 2, 0, 1))


def mapped_state_dict(flat: Dict[str, np.ndarray], mapping) -> Dict[str, np.ndarray]:
    """A flat flax tree (``params_io`` keys) under the checkpoint's names of
    ``mapping`` ((src, collection, dst, transform) rows): the inverse of
    the importer that reads that mapping."""
    return {src: _inverse(t)(np.asarray(flat["::".join((coll,) + tuple(dst))]))
            for src, coll, dst, t in mapping}


def yolo_state_dict(flat: Dict[str, np.ndarray], spec: YoloSpec) -> Dict[str, np.ndarray]:
    """The inverse of :func:`yolo_variables`: a flat flax tree of
    ``spec``'s graph as the checkpoint of the same weights holds it
    (v5-lite-g in its deploy form, ``.fused.*``)."""
    return mapped_state_dict(flat, inverse_mapping(spec))


def _scdown_entries(src: str, dst: Tuple[str, ...]):
    return _convbn_entries(f"{src}.cv1", dst + ("cv1",)) + _convbn_entries(
        f"{src}.cv2", dst + ("cv2",)
    )


def _cib_entries(src: str, dst: Tuple[str, ...], lk: bool = False):
    """CIB = 5-conv inverted block; ultralytics nests them under cv1.{j}.
    With ``lk`` the middle slot is RepVGGDW (conv=7×7-dw, conv1=3×3-dw,
    each a Conv(act=False) with conv/bn children)."""
    out = []
    for j in range(5):
        if j == 2 and lk:
            out += _convbn_entries(
                f"{src}.cv1.2.conv", dst + ("cv2", "conv")
            )
            out += _convbn_entries(
                f"{src}.cv1.2.conv1", dst + ("cv2", "conv1")
            )
        else:
            out += _convbn_entries(f"{src}.cv1.{j}", dst + (f"cv{j}",))
    return out


def _c2fcib_entries(src: str, dst: str, n: int, lk: bool = False):
    out = _convbn_entries(f"{src}.cv1", (dst, "cv1"))
    out += _convbn_entries(f"{src}.cv2", (dst, "cv2"))
    for i in range(n):
        out += _cib_entries(f"{src}.m.{i}", (dst, f"m{i}"), lk=lk)
    return out


def _psa_entries(src: str, dst: Tuple[str, ...]):
    pairs = [
        ("cv1", "cv1"), ("cv2", "cv2"),
        ("attn.qkv", "attn_qkv"), ("attn.proj", "attn_proj"),
        ("attn.pe", "attn_pe"), ("ffn.0", "ffn1"), ("ffn.1", "ffn2"),
    ]
    out = []
    for s_name, d_name in pairs:
        out += _convbn_entries(f"{src}.{s_name}", dst + (d_name,))
    return out


def _v10_cls_entries(src: str, head: str, suffix: str, li: int):
    """v10Detect depthwise cls branch: {0,1} are Sequential(dw, pw)."""
    out = _convbn_entries(
        f"{src}.0.0", (head, f"cls{suffix}{li}_0a")
    )
    out += _convbn_entries(f"{src}.0.1", (head, f"cls{suffix}{li}_0b"))
    out += _convbn_entries(f"{src}.1.0", (head, f"cls{suffix}{li}_1a"))
    out += _convbn_entries(f"{src}.1.1", (head, f"cls{suffix}{li}_1b"))
    out += _plain_conv_entries(f"{src}.2", (head, f"cls{suffix}{li}_2"))
    return out


def yolov10_mapping(spec: YoloSpec) -> List[tuple]:
    """(src, collection, dst, transform) table for YOLOv10, all scales.

    RepVGGDW placement follows models/yolo.py's V10_LK table
    (``YoloSpec.lk``); where a checkpoint disagrees, the leftover and
    missing-tensor errors name the block."""
    lk = spec.lk
    d = spec.depths
    m = []
    net = lambda *p: ("net",) + p  # noqa: E731
    m += _convbn_entries("model.0", net("stem"))
    m += _convbn_entries("model.1", net("down1"))
    m += [(s, c, net(*p), t) for s, c, p, t in _c2f_entries("model.2", "stage1", d[0])]
    m += _convbn_entries("model.3", net("down2"))
    m += [(s, c, net(*p), t) for s, c, p, t in _c2f_entries("model.4", "stage2", d[1])]
    m += _scdown_entries("model.5", net("down3"))
    m += [(s, c, net(*p), t) for s, c, p, t in _c2f_entries("model.6", "stage3", d[2])]
    m += _scdown_entries("model.7", net("down4"))
    if spec.scale == "n":
        m += [(s, c, net(*p), t) for s, c, p, t in _c2f_entries("model.8", "stage4", d[3])]
    else:
        m += [(s, c, net(*p), t) for s, c, p, t in _c2fcib_entries("model.8", "stage4", d[3], lk=lk[0])]
    m += [(s, c, net(*p), t) for s, c, p, t in _sppf_entries("model.9", "sppf")]
    m += _psa_entries("model.10", net("psa"))
    m += [(s, c, net(*p), t) for s, c, p, t in _c2f_entries("model.13", "fpn4", d[0])]
    m += [(s, c, net(*p), t) for s, c, p, t in _c2f_entries("model.16", "fpn3", d[0])]
    m += _convbn_entries("model.17", net("pan3"))
    if spec.scale in ("n", "s"):
        m += [(s, c, net(*p), t) for s, c, p, t in _c2f_entries("model.19", "pan4", d[0])]
    else:
        m += [(s, c, net(*p), t) for s, c, p, t in _c2fcib_entries("model.19", "pan4", d[0], lk=lk[1])]
    m += _scdown_entries("model.20", net("pan5_down"))
    m += [(s, c, net(*p), t) for s, c, p, t in _c2fcib_entries("model.22", "pan5", d[0], lk=lk[2])]
    for li in range(3):
        for src_head, head, suffix in (
            ("model.23.cv2", "head_o2m", "m"),
            ("model.23.one2one_cv2", "head_o2o", "o"),
        ):
            m += _convbn_entries(
                f"{src_head}.{li}.0", (head, f"box{suffix}{li}_0")
            )
            m += _convbn_entries(
                f"{src_head}.{li}.1", (head, f"box{suffix}{li}_1")
            )
            m += _plain_conv_entries(
                f"{src_head}.{li}.2", (head, f"box{suffix}{li}_2")
            )
        m += _v10_cls_entries(f"model.23.cv3.{li}", "head_o2m", "m", li)
        m += _v10_cls_entries(
            f"model.23.one2one_cv3.{li}", "head_o2o", "o", li
        )
    return m
