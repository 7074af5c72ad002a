"""The five CUDA kernels as registered operators (``torch.library``).

Each kernel's wrapper calls ``torch.ops.adas_tpu_torch.<name>``, whose CPU
implementation is the kernel's plain version, whose CUDA one is the
launch and whose fake one gives the output's shape.  Here, on the CPU:

* each public wrapper equals its plain version to the bit and counts no
  launch;
* ``torch.library.opcheck`` passes for each operator (schema, fake
  implementation, dispatch);
* a module exported with ``torch.export`` keeps each call as one graph
  node, and the exported program gives the eager bits.

The launches of the CUDA implementations are held to the native path's on
the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from adas_tpu_torch.ops import block as B
from adas_tpu_torch.ops import int8_conv as IC
from adas_tpu_torch.ops import iou as I
from adas_tpu_torch.ops import nms as N
from adas_tpu_torch.ops import stem as S


def _s8(rng, *shape):
    return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))


def _f32(rng, *shape, lo=0.5, hi=1.5):
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))


def _boxes(rng, b, n):
    xy = rng.uniform(0, 100, (b, n, 2))
    wh = rng.uniform(5, 40, (b, n, 2))
    return torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32))


def _cases():
    """(name, public call, plain call, operator, its arguments) per op."""
    rng = np.random.default_rng(0)
    boxes = _boxes(rng, 2, 70)
    scores = torch.from_numpy(rng.uniform(0, 1, (2, 70)).astype(np.float32))
    iou = I.iou_matrix_reference(boxes, True)
    mask = I.iou_mask_reference(boxes, 0.45, True)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 3, 17, 22)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 3, 3, 3)).astype(np.float32))
    gain, bias = _f32(rng, 16), _f32(rng, 16, lo=-0.1, hi=0.1)
    xq, wq = _s8(rng, 2, 9, 11, 16), _s8(rng, 24, 3, 3, 16)
    scale, cbias = _f32(rng, 24, lo=1e-4, hi=2e-4), _f32(rng, 24, lo=-0.1, hi=0.1)
    out_scale = torch.tensor(0.02)
    w1, w2 = _s8(rng, 16, 3, 3, 16), _s8(rng, 16, 3, 3, 16)
    s1, s2 = _f32(rng, 16, lo=1e-4, hi=2e-4), _f32(rng, 16, lo=1e-4, hi=2e-4)
    b1, b2 = _f32(rng, 16, lo=-0.1, hi=0.1), _f32(rng, 16, lo=-0.1, hi=0.1)
    xs, ms = torch.tensor(0.03), torch.tensor(0.05)
    block_args = (xq, xs, w1, s1, b1, ms, w2, s2, b2, out_scale)
    return [
        ("iou_matrix", lambda: I.iou_matrix(boxes, True),
         lambda: I.iou_matrix_reference(boxes, True), (boxes, True)),
        ("iou_mask", lambda: I.iou_mask(boxes, 0.45, True),
         lambda: I.iou_mask_reference(boxes, 0.45, True), (boxes, 0.45, True)),
        ("nms_scan", lambda: N.nms_scan(iou, scores, 0.45, 30, 2, 0.5, 0.001),
         lambda: N.nms_scan_reference(iou, scores, 0.45, 30, 2, 0.5, 0.001),
         (iou, scores, 0.45, 30, 2, 0.5, 0.001)),
        ("nms_walk", lambda: N.nms_walk(mask, scores, 30, 0.001),
         lambda: N.nms_walk_reference(mask, scores, 30, 0.001), (mask, scores, 30, 0.001)),
        ("fused_stem", lambda: S.fused_stem(x, w, gain, bias, act="silu", pool=False),
         lambda: S.stem_reference(x, w, gain, bias, act="silu", pool=False),
         (x, w, gain, bias, "silu", False)),
        ("int8_conv", lambda: IC.int8_conv(xq, wq, scale, cbias, stride=2, act="silu",
                                           out_scale=out_scale),
         lambda: IC.int8_conv_reference(xq, wq, scale, cbias, stride=2, act="silu",
                                        out_scale=out_scale),
         (xq, wq, scale, cbias, 2, "silu", out_scale, False, None)),
        ("fused_block", lambda: B.fused_block(*block_args, act1="silu", act2="silu",
                                              act_post=None, residual=True),
         lambda: B.block_reference(*block_args, act1="silu", act2="silu", act_post=None,
                                   residual=True),
         (*block_args, "silu", "silu", None, True)),
    ]


CASES = {c[0]: c for c in _cases()}
MODULES = {"iou_matrix": I, "iou_mask": I, "nms_scan": N, "nms_walk": N, "fused_stem": S,
           "int8_conv": IC, "fused_block": B}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_implementation_is_the_plain_version(name):
    _, public, plain, _ = CASES[name]
    mod = MODULES[name]
    mod.reset_launches()
    got, want = public(), plain()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert mod.launches == 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_opcheck(name):
    args = CASES[name][3]
    torch.library.opcheck(getattr(torch.ops.adas_tpu_torch, name).default, args)


@pytest.mark.parametrize("name", sorted(CASES))
def test_export_keeps_one_node(name):
    """An exported module calling the operator twice holds two nodes of it
    (the kernel is not traced into), and the exported program gives the
    eager bits."""
    _, public, _, args = CASES[name]
    op = getattr(torch.ops.adas_tpu_torch, name)

    class Twice(torch.nn.Module):
        def forward(self, t):
            return op(t, *args[1:]), op(t, *args[1:])

    program = torch.export.export(Twice(), (args[0],), strict=False)
    nodes = [n for n in program.graph.nodes if n.op == "call_function"
             and str(n.target) == f"adas_tpu_torch.{name}.default"]
    assert len(nodes) == 2
    a, b = program.module()(args[0])
    assert torch.equal(a, public()) and torch.equal(b, public())


def test_wrappers_on_a_channel_slice():
    """The int8 conv takes a channel slice of a wider NHWC tensor in place
    through the operator (its strides reach the implementation)."""
    rng = np.random.default_rng(3)
    wide = _s8(rng, 1, 6, 7, 32)
    xq = wide[..., 8:24]
    wq = _s8(rng, 8, 1, 1, 16)
    scale = _f32(rng, 8, lo=1e-3, hi=2e-3)
    got = IC.int8_conv(xq, wq, scale, None, stride=1, act=None)
    want = IC.int8_conv_reference(xq.contiguous(), wq, scale, None, stride=1, act=None)
    assert torch.equal(got, want)
