"""zylo117 EfficientDet checkpoint ingestion -> flax variables (the port's
copy of ``adas_tpu/tools/efficientdet_import.py``).

Maps the released Yet-Another-EfficientDet-Pytorch ``efficientdet-d*.pth``
state-dict layout onto the flax tree of ``models/efficientdet.py``'s
graph, over the port's ``mbconv_plan`` / ``EfficientDetSpec``.

Name conventions in the source checkpoints:
- backbone (lukemelas EfficientNet): ``backbone_net.model._conv_stem.
  weight``, ``_blocks.{i}._expand_conv/_bn0/_depthwise_conv/_bn1/
  _se_reduce/_se_expand/_project_conv/_bn2``
- BiFPN: ``bifpn.{i}.conv{6,5,4,3}_up`` / ``conv{4..7}_down`` separable
  blocks (``depthwise_conv.conv`` / ``pointwise_conv.conv`` / ``bn``),
  fast-attention weights ``p{l}_w{1,2}``, and on the first layer the
  channel-reduction Sequentials ``p{3,4,5}_down_channel[_2]``/``p5_to_p6``
- heads: ``regressor``/``classifier`` with shared ``conv_list.{i}``,
  per-level ``bn_list.{level}.{layer}`` and biased ``header``
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..models.efficientdet import EfficientDetSpec, mbconv_plan
from .torch_import import _conv, _set  # OIHW -> HWIO


def _bn_entries(src: str, dst: Tuple[str, ...]):
    return [
        (f"{src}.weight", "params", dst + ("scale",), None),
        (f"{src}.bias", "params", dst + ("bias",), None),
        (f"{src}.running_mean", "batch_stats", dst + ("mean",), None),
        (f"{src}.running_var", "batch_stats", dst + ("var",), None),
    ]


def _sep_entries(src: str, dst: Tuple[str, ...], bn: bool = True):
    out = [
        (f"{src}.depthwise_conv.conv.weight", "params",
         dst + ("dw", "kernel"), _conv),
        (f"{src}.pointwise_conv.conv.weight", "params",
         dst + ("pw", "kernel"), _conv),
        (f"{src}.pointwise_conv.conv.bias", "params",
         dst + ("pw", "bias"), None),
    ]
    if bn:
        out += _bn_entries(f"{src}.bn", dst + ("bn",))
    return out


def _down_channel_entries(src: str, dst: Tuple[str, ...]):
    return [
        (f"{src}.0.conv.weight", "params", dst + ("conv", "kernel"), _conv),
        (f"{src}.0.conv.bias", "params", dst + ("conv", "bias"), None),
    ] + _bn_entries(f"{src}.1", dst + ("bn",))


def efficientdet_mapping(spec: EfficientDetSpec) -> List[tuple]:
    width, depth, _size, _fpn_ch, fpn_layers, head_layers = spec.config
    m: List[tuple] = []
    bb = "backbone_net.model"
    m += [
        (f"{bb}._conv_stem.weight", "params",
         ("backbone", "stem_conv", "kernel"), _conv),
    ]
    m += _bn_entries(f"{bb}._bn0", ("backbone", "stem_bn"))
    for i, (expand, _k, _s, _c) in enumerate(mbconv_plan(width, depth)):
        src = f"{bb}._blocks.{i}"
        dst = ("backbone", f"block{i}")
        if expand != 1:
            m += [
                (f"{src}._expand_conv.weight", "params",
                 dst + ("expand_conv", "kernel"), _conv),
            ]
            m += _bn_entries(f"{src}._bn0", dst + ("bn0",))
        m += [
            (f"{src}._depthwise_conv.weight", "params",
             dst + ("dw_conv", "kernel"), _conv),
        ]
        m += _bn_entries(f"{src}._bn1", dst + ("bn1",))
        m += [
            (f"{src}._se_reduce.weight", "params",
             dst + ("se_reduce", "kernel"), _conv),
            (f"{src}._se_reduce.bias", "params",
             dst + ("se_reduce", "bias"), None),
            (f"{src}._se_expand.weight", "params",
             dst + ("se_expand", "kernel"), _conv),
            (f"{src}._se_expand.bias", "params",
             dst + ("se_expand", "bias"), None),
            (f"{src}._project_conv.weight", "params",
             dst + ("project_conv", "kernel"), _conv),
        ]
        m += _bn_entries(f"{src}._bn2", dst + ("bn2",))

    for li in range(fpn_layers):
        src = f"bifpn.{li}"
        dst0 = f"bifpn{li}"
        for name in (
            "conv6_up", "conv5_up", "conv4_up", "conv3_up",
            "conv4_down", "conv5_down", "conv6_down", "conv7_down",
        ):
            m += _sep_entries(f"{src}.{name}", (dst0, name))
        if spec.compound < 6:  # d6/d7 BiFPN is plain-sum (no attention
            # weights on either side — zylo117 use_attention=False)
            for w in (
                "p6_w1", "p5_w1", "p4_w1", "p3_w1",
                "p4_w2", "p5_w2", "p6_w2", "p7_w2",
            ):
                m += [(f"{src}.{w}", "params", (dst0, w), None)]
        if li == 0:
            for name in (
                "p3_down_channel", "p4_down_channel", "p5_down_channel",
                "p4_down_channel_2", "p5_down_channel_2", "p5_to_p6",
            ):
                m += _down_channel_entries(f"{src}.{name}", (dst0, name))

    for head_src, head_dst in (
        ("regressor", "regressor"), ("classifier", "classifier")
    ):
        for ci in range(head_layers):
            m += _sep_entries(
                f"{head_src}.conv_list.{ci}", (head_dst, f"conv{ci}"),
                bn=False,
            )
        for li in range(5):
            for ci in range(head_layers):
                m += _bn_entries(
                    f"{head_src}.bn_list.{li}.{ci}",
                    (head_dst, f"bn_l{li}_c{ci}"),
                )
        m += _sep_entries(
            f"{head_src}.header", (head_dst, "header"), bn=False
        )
    return m


_SKIP_SUFFIXES = (
    "num_batches_tracked",
    # classification tail lukemelas keeps but detection never uses
    "_conv_head.weight", "_fc.weight", "_fc.bias",
    "anchors.last_anchors", "last_anchors",
)
_SKIP_PREFIXES = (
    "backbone_net.model._conv_head", "backbone_net.model._bn1.",
    "backbone_net.model._fc",
)


def efficientdet_variables(
    state: Dict[str, np.ndarray], spec: EfficientDetSpec
) -> dict:
    """zylo117 state dict -> flax variables for EfficientDet(spec)."""
    mapping = efficientdet_mapping(spec)
    variables: dict = {"params": {}, "batch_stats": {}}
    used = set()
    norm = {k: np.asarray(v) for k, v in state.items()}
    for src, collection, dst, transform in mapping:
        if src not in norm:
            raise KeyError(f"checkpoint missing tensor {src}")
        value = norm[src]
        if transform is not None:
            value = transform(value)
        _set(variables[collection], dst, value)
        used.add(src)
    leftover = [
        k
        for k in norm
        if k not in used
        and not k.endswith(_SKIP_SUFFIXES)
        and not any(k.startswith(p) for p in _SKIP_PREFIXES)
    ]
    if leftover:
        raise KeyError(
            f"unmapped checkpoint tensors: {leftover[:8]} ..."
        )
    return variables


def efficientdet_state_dict(flat: Dict[str, np.ndarray], spec: EfficientDetSpec) -> Dict[str, np.ndarray]:
    """The inverse of :func:`efficientdet_variables`: a flat flax tree of
    ``EfficientDet(spec)`` under the zylo117 names."""
    from .yolo_import import mapped_state_dict

    return mapped_state_dict(flat, efficientdet_mapping(spec))
