"""The int8 conv and fused block CUDA kernels against their plain PyTorch
versions, on the GPU.

Needs an NVIDIA GPU with nvcc (the kernels are built for sm_90a); each
test skips where there is none.  This file imports no JAX, so it runs on
the GPU machine without the repository's conftest:

    python -m pytest tests/test_torch_int8_cuda.py -q --noconftest -p no:cacheprovider

Yardsticks (``tests/test_pallas_block.py:110-111``, ``ROADMAP.md``): the
fused block equals its plain version to the bit (0 LSB: exact s32 sums and
the same roundings and exp); for the int8 conv, the s32 accumulators are
bit-identical (checked with unit scale, zero bias, no
activation: an exactly representable f32 epilogue); s8 outputs differ by
at most 1 LSB on fewer than 0.5% of the elements (the kernel and the plain
version evaluate exp in silu with different instructions, which can move a
value across a .5 boundary); bf16 outputs within one bf16 ulp (2^-7
relative) or 1e-30 absolute (a far-negative SiLU underflows to -0 on one
side and to ~1e-37 on the other); f32 outputs within 2^-20 relative with
SiLU and to the bit without.  The int8 conv's per-image mode (a row of the
epilogue scale per image, an uncalibrated net's dynamic scales) is held to
the same bounds, and each of its images to the per-channel mode on that
image alone, to the bit.
"""
import pytest
import torch

from adas_tpu_torch.ops import block as B
from adas_tpu_torch.ops import int8_conv as IC

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU build)")
    return torch.Generator(device="cuda").manual_seed(0)


def _s8(gen, shape, lo=-127, hi=128):
    return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=torch.int8)


def _assert_s8_close(got, want):
    assert got.dtype == want.dtype == torch.int8 and got.shape == want.shape
    diff = (got.int() - want.int()).abs()
    assert diff.max().item() <= 1
    assert (diff != 0).float().mean().item() < 5e-3


def _assert_bf16_close(got, want):
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    g, w = got.float(), want.float()
    assert torch.all((g - w).abs() <= w.abs() * 2.0 ** -7 + 1e-30)


CONV_CASES = [
    # (n, h, w, cin, cout, k, stride)
    (2, 16, 24, 64, 64, 3, 1),
    (2, 17, 23, 32, 48, 3, 2),    # odd sizes, ragged tiles
    (1, 9, 13, 24, 40, 3, 1),     # Cin % 16 != 0: 8-byte copies
    (2, 12, 20, 128, 136, 1, 1),  # Cout not a multiple of the 64-wide tile
    (2, 15, 15, 64, 128, 1, 2),
    (1, 8, 8, 512, 64, 3, 1),     # deep K
]


@pytest.mark.parametrize("n,h,w,cin,cout,k,stride", CONV_CASES)
def test_conv_accumulator_is_exact(gpu, n, h, w, cin, cout, k, stride):
    """Unit scale, zero bias, no activation, bf16 output: the kernel's
    bf16 value is the s32 accumulator rounded once, exactly as the plain
    version's (|acc| < 2^24, so its f32 image is exact)."""
    xq = _s8(gpu, (n, h, w, cin), -8, 8)
    wq = _s8(gpu, (cout, k, k, cin), -8, 8)
    one = torch.ones(cout, device="cuda")
    got = IC.int8_conv(xq, wq, one, None, stride=stride, act=None)
    acc = IC.int8_conv_accumulate(xq, wq, stride)
    torch.cuda.synchronize()
    assert torch.equal(got, acc.float().to(torch.bfloat16))


@pytest.mark.parametrize("act", [None, "relu", "silu"])
@pytest.mark.parametrize("requant", [False, True])
@pytest.mark.parametrize("n,h,w,cin,cout,k,stride", CONV_CASES)
def test_conv_matches_reference(gpu, n, h, w, cin, cout, k, stride, act, requant):
    xq = _s8(gpu, (n, h, w, cin))
    wq = _s8(gpu, (cout, k, k, cin))
    # |y| of a few units: an s32 sum of K products has a spread of ~5400 sqrt(K)
    scale = (torch.rand(cout, generator=gpu, device="cuda") * 0.5 + 0.75) * 5e-4 / (k * k * cin) ** 0.5
    bias = torch.randn(cout, generator=gpu, device="cuda") * 0.5
    os_ = torch.tensor(0.05, device="cuda") if requant else None
    before = IC.launches
    got = IC.int8_conv(xq, wq, scale, bias, stride=stride, act=act, out_scale=os_)
    want = IC.int8_conv_reference(xq, wq, scale, bias, stride=stride, act=act, out_scale=os_)
    torch.cuda.synchronize()
    assert IC.launches == before + 1
    (_assert_s8_close if requant else _assert_bf16_close)(got, want)


#: the edges of every tile class: (n, h, w, cin, cout, k, stride)
TILE_EDGE_CASES = [
    (1, 7, 9, 64, 128, 3, 1),      # M = 63: a single ragged M tile
    (2, 10, 10, 256, 80, 1, 1),    # Cout = 80, the class head
    (2, 9, 11, 8, 16, 3, 1),       # Cin = 8: 8-byte copies, K = 72 (padded weight rows)
    (1, 6, 5, 8, 24, 1, 1),        # Cin = 8 at 1x1: K = 8
    (2, 17, 23, 64, 128, 3, 2),    # stride 2, ragged output (gathered activations)
    (2, 17, 23, 128, 64, 3, 2),    # stride 2 through the im2col TMA
    (1, 20, 20, 512, 512, 3, 1),   # fewer tiles than SMs, K = 4,608
    (2, 33, 31, 128, 256, 3, 1),   # several tiles per block of the persistent grid
]


@pytest.mark.parametrize("tile", IC.TILES)
@pytest.mark.parametrize("n,h,w,cin,cout,k,stride", TILE_EDGE_CASES)
def test_conv_tile_class_is_exact(gpu, monkeypatch, tile, n, h, w, cin, cout, k, stride):
    """Every tile the wrapper can pick, forced, at each edge: the s32
    accumulator to the bit (unit scale, no bias, no activation, bf16 of an
    exactly representable sum), then the full epilogue to s8."""
    monkeypatch.setattr(IC, "tile_config", lambda m, c, sms: tile)
    monkeypatch.setattr(IC, "_PLANS", {})  # plans cached under another tile
    xq = _s8(gpu, (n, h, w, cin), -8, 8)
    wq = _s8(gpu, (cout, k, k, cin), -8, 8)
    one = torch.ones(cout, device="cuda")
    got = IC.int8_conv(xq, wq, one, None, stride=stride, act=None)
    acc = IC.int8_conv_accumulate(xq, wq, stride)
    torch.cuda.synchronize()
    assert torch.equal(got, acc.float().to(torch.bfloat16))
    xq, wq = _s8(gpu, (n, h, w, cin)), _s8(gpu, (cout, k, k, cin))
    scale = torch.rand(cout, generator=gpu, device="cuda") * 2e-4 / (k * k * cin) ** 0.5 + 1e-5
    bias = torch.randn(cout, generator=gpu, device="cuda") * 0.5
    os_ = torch.tensor(0.02, device="cuda")
    got = IC.int8_conv(xq, wq, scale, bias, stride=stride, act="silu", out_scale=os_)
    want = IC.int8_conv_reference(xq, wq, scale, bias, stride=stride, act="silu", out_scale=os_)
    torch.cuda.synchronize()
    _assert_s8_close(got, want)


@pytest.mark.parametrize("tile", IC.TILES)
@pytest.mark.parametrize("k,c_total,c0", [(3, 256, 128), (1, 384, 128), (3, 192, 64)])
def test_conv_channel_slice_every_tile(gpu, monkeypatch, tile, k, c_total, c0):
    """A channel pitch wider than Cin (C2f's split half) under every tile,
    through the im2col TMA (3x3 at Cin 128, 1x1 at Cin 256) and the
    gather (3x3 at Cin 128 from a 64-byte offset)."""
    monkeypatch.setattr(IC, "tile_config", lambda m, c, sms: tile)
    monkeypatch.setattr(IC, "_PLANS", {})
    y = _s8(gpu, (2, 13, 21, c_total), -8, 8)
    part = y[..., c0:]
    cin = c_total - c0
    wq = _s8(gpu, (128, k, k, cin), -8, 8)
    one = torch.ones(128, device="cuda")
    got = IC.int8_conv(part, wq, one, None, stride=1, act=None)
    acc = IC.int8_conv_accumulate(part.contiguous(), wq, 1)
    torch.cuda.synchronize()
    assert torch.equal(got, acc.float().to(torch.bfloat16))


def test_conv_weight_map_follows_the_weights(gpu):
    """The weights' TMA map is cached by address and extents: new weights
    in place of freed ones of the same shape, and a second call on the
    same weights, still give the exact accumulator."""
    xq = _s8(gpu, (2, 12, 12, 64), -8, 8)
    one = torch.ones(128, device="cuda")
    for _ in range(3):
        wq = _s8(gpu, (128, 3, 3, 64), -8, 8)
        for _ in range(2):
            got = IC.int8_conv(xq, wq, one, None, stride=1, act=None)
            acc = IC.int8_conv_accumulate(xq, wq, 1)
            torch.cuda.synchronize()
            assert torch.equal(got, acc.float().to(torch.bfloat16))
        del wq


def test_conv_reads_a_channel_slice_in_place(gpu):
    """C2f's split half: a channel slice with pitch 2C, read with no copy."""
    y = _s8(gpu, (2, 10, 14, 128))
    part = y[..., 64:]
    wq = _s8(gpu, (64, 3, 3, 64))
    scale = torch.full((64,), 2e-4, device="cuda")
    os_ = torch.tensor(0.1, device="cuda")
    got = IC.int8_conv(part, wq, scale, None, stride=1, act="silu", out_scale=os_)
    want = IC.int8_conv_reference(part.contiguous(), wq, scale, None, stride=1, act="silu",
                                  out_scale=os_)
    torch.cuda.synchronize()
    _assert_s8_close(got, want)


#: the int8 convs of YOLOv5-lite, v6, v9 and EfficientDet at small maps:
#: (n, h, w, c_total, c0, cin, cout, k, stride) with the input a channel
#: slice [c0, c0 + cin) of a c_total-wide tensor
FAMILY_CONV_CASES = [
    # YOLOv5-lite-s ShuffleNet units: 58/116-wide halves read at their
    # offset (pitch 116 / 232), the stride-2 units' 1x1s from 32 and 116
    (2, 20, 20, 116, 58, 58, 58, 1, 1),
    (2, 10, 10, 232, 116, 116, 116, 1, 1),
    (2, 20, 20, 32, 0, 32, 58, 1, 1),
    (2, 10, 10, 116, 0, 116, 116, 1, 1),
    (2, 9, 9, 58, 0, 58, 58, 1, 1),       # the 58-wide 1x1 after a depthwise conv
    (2, 20, 20, 116, 0, 116, 58, 1, 1),
    # YOLOv6n: the 16-wide stem output into ERBlock_2_0 (3x3/2), its 32s
    (2, 32, 32, 16, 0, 16, 32, 3, 2),
    (2, 16, 16, 32, 0, 32, 32, 3, 1),
    # YOLOv9c ADown: 3x3/2 on half of the (H-1) x (W-1) average-pooled map
    (1, 31, 31, 256, 0, 128, 128, 3, 2),
    (1, 15, 15, 512, 0, 256, 256, 3, 2),
    # EfficientDet-D0's 1x1s (expand, project, BiFPN laterals, separable pw)
    (2, 16, 16, 96, 0, 96, 24, 1, 1),
    (2, 16, 16, 24, 0, 24, 144, 1, 1),
    (2, 8, 8, 240, 0, 240, 40, 1, 1),
    (2, 4, 4, 1152, 0, 1152, 320, 1, 1),
    (2, 8, 8, 40, 0, 40, 64, 1, 1),
    (2, 16, 16, 64, 0, 64, 64, 1, 1),
]


@pytest.mark.parametrize("out", ["acc", "s8", "bf16", "f32"])
@pytest.mark.parametrize("n,h,w,c_total,c0,cin,cout,k,stride", FAMILY_CONV_CASES)
def test_conv_family_shapes_match_reference(gpu, n, h, w, c_total, c0, cin, cout, k, stride,
                                            out):
    """The new families' int8 conv shapes against the plain version, the
    kernel given the operands as the module tree gives them (weights,
    scale and bias padded to multiples of 8 once, ``pad_weight`` /
    ``pad_channels``, and the conv's own ``cout``; the plain version
    takes the same): the s32
    accumulator to the bit (``acc``: unit scale, bf16 of an exact sum), s8
    within 1 LSB on < 0.5%, bf16 within one ulp, f32 (EfficientDet's head:
    no folded BN) to the bit without an activation and within 2^-20
    relative with SiLU.  One launch each."""
    y = _s8(gpu, (n, h, w, c_total), -8, 8) if out == "acc" else _s8(gpu, (n, h, w, c_total))
    xq = y[..., c0:c0 + cin]
    if out == "acc":
        wq = _s8(gpu, (cout, k, k, cin), -8, 8)
        one = IC.pad_channels(torch.ones(cout, device="cuda"))
        got = IC.int8_conv(xq, IC.pad_weight(wq), one, None, stride=stride, act=None, cout=cout)
        acc = IC.int8_conv_accumulate(xq.contiguous(), wq, stride)
        torch.cuda.synchronize()
        assert got.is_contiguous() and torch.equal(got, acc.float().to(torch.bfloat16))
        return
    wq = _s8(gpu, (cout, k, k, cin))
    scale = (torch.rand(cout, generator=gpu, device="cuda") * 0.5 + 0.75) * 5e-4 / (k * k * cin) ** 0.5
    bias = torch.randn(cout, generator=gpu, device="cuda") * 0.5
    os_ = torch.tensor(0.05, device="cuda") if out == "s8" else None
    kw = dict(stride=stride, out_scale=os_, out_f32=out == "f32", cout=cout)
    wp, sp, bp = IC.pad_weight(wq), IC.pad_channels(scale), IC.pad_channels(bias)
    for act in (None, "silu"):
        before = IC.launches
        got = IC.int8_conv(xq, wp, sp, bp, act=act, **kw)
        want = IC.int8_conv_reference(xq.contiguous(), wq, scale, bias, act=act, **kw)
        torch.cuda.synchronize()
        assert IC.launches == before + 1
        if out == "s8":
            _assert_s8_close(got, want)
        elif out == "bf16":
            _assert_bf16_close(got, want)
        else:
            assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
            if act is None:
                assert torch.equal(got, want)
            else:
                assert torch.all((got - want).abs() <= want.abs() * 2.0 ** -20 + 1e-30)


#: per-image scale tables: (n, h, w, cin, cout, k, stride, cout of the
#: module, None = cout), each image's output rows ending inside an M tile
PER_IMAGE_CASES = [
    (3, 7, 9, 64, 128, 3, 1, None),    # 63 rows an image: every tile straddles
    (4, 10, 10, 256, 80, 1, 1, None),  # 100 rows an image, 1x1 through the im2col TMA
    (3, 17, 23, 128, 64, 3, 2, None),  # stride 2, 108 rows an image
    (2, 20, 20, 32, 58, 1, 1, 58),     # padded operands (58 -> 64 channels)
    (8, 10, 50, 512, 256, 3, 1, None),  # the lane trunk's 10x50 map at batch 8
]


def _per_image_operands(gpu, n, cout, k, cin, cout_mod):
    """A (n, Cout) scale table as ``conv_epilogue`` builds it for n images
    at their own dynamic input scales (``wscale * xs[:, None] * gain``),
    padded as the module tree pads it; and the bias."""
    c = cout_mod or cout
    wscale = (torch.rand(c, generator=gpu, device="cuda") * 0.5 + 0.75) * 5e-4 / (k * k * cin) ** 0.5
    xs = torch.rand(n, generator=gpu, device="cuda") * 3 + 0.25  # images ~12x apart
    gain = torch.rand(c, generator=gpu, device="cuda") + 0.5
    table = wscale * xs[:, None] * gain
    bias = torch.randn(c, generator=gpu, device="cuda") * 0.5
    return table, bias


@pytest.mark.parametrize("tile", IC.TILES)
@pytest.mark.parametrize("n,h,w,cin,cout,k,stride,cout_mod", PER_IMAGE_CASES)
def test_conv_per_image_scale_matches_reference(gpu, monkeypatch, tile, n, h, w, cin, cout, k,
                                                stride, cout_mod):
    """The per-image mode (an uncalibrated net's dynamic scales, one row
    per image) under every tile, forced, against the plain version: s8
    within 1 LSB on < 0.5%, bf16 within one ulp, f32 within 2^-20
    relative (SiLU) and to the bit without an activation.  One launch
    each."""
    monkeypatch.setattr(IC, "tile_config", lambda m, c, sms: tile)
    monkeypatch.setattr(IC, "_PLANS", {})
    c = cout_mod or cout
    xq = _s8(gpu, (n, h, w, cin))
    wq = _s8(gpu, (c, k, k, cin))
    table, bias = _per_image_operands(gpu, n, cout, k, cin, cout_mod)
    wp, tp, bp = IC.pad_weight(wq), IC.pad_channels(table), IC.pad_channels(bias)
    for out in ("s8", "bf16", "f32"):
        os_ = torch.tensor(0.05, device="cuda") if out == "s8" else None
        kw = dict(stride=stride, out_scale=os_, out_f32=out == "f32", cout=cout_mod)
        for act in ("silu", None):
            before = IC.launches
            got = IC.int8_conv(xq, wp, tp, bp, act=act, **kw)
            want = IC.int8_conv_reference(xq, wq, table, bias, act=act, **kw)
            torch.cuda.synchronize()
            assert IC.launches == before + 1 and got.shape == want.shape
            if out == "s8":
                _assert_s8_close(got, want)
            elif out == "bf16":
                _assert_bf16_close(got, want)
            elif act is None:
                assert torch.equal(got, want)
            else:
                assert torch.all((got - want).abs() <= want.abs() * 2.0 ** -20 + 1e-30)


@pytest.mark.parametrize("n,h,w,cin,cout,k,stride,cout_mod", PER_IMAGE_CASES)
def test_conv_per_image_rows_are_the_per_channel_launches(gpu, n, h, w, cin, cout, k, stride,
                                                          cout_mod):
    """Image i of a per-image launch equals, to the bit, a per-channel
    launch of image i alone at row i of the table; and a table whose rows
    are all one vector gives the per-channel launch's output to the bit."""
    c = cout_mod or cout
    xq = _s8(gpu, (n, h, w, cin))
    wp = IC.pad_weight(_s8(gpu, (c, k, k, cin)))
    table, bias = _per_image_operands(gpu, n, cout, k, cin, cout_mod)
    tp, bp = IC.pad_channels(table), IC.pad_channels(bias)
    os_ = torch.tensor(0.05, device="cuda")
    for kw in (dict(out_scale=os_), dict(), dict(out_f32=True)):
        kw.update(stride=stride, act="silu", cout=cout_mod)
        got = IC.int8_conv(xq, wp, tp, bp, **kw)
        for i in range(n):
            one = IC.int8_conv(xq[i:i + 1].clone(), wp, tp[i].contiguous(), bp, **kw)
            assert torch.equal(got[i:i + 1], one), (kw, i)
        same = IC.int8_conv(xq, wp, tp[:1].expand(n, -1).contiguous(), bp, **kw)
        assert torch.equal(same, IC.int8_conv(xq, wp, tp[0].contiguous(), bp, **kw))
    torch.cuda.synchronize()


def test_padded_layer_keeps_one_plan(gpu, monkeypatch):
    """A conv of widths that are not multiples of 8 (YOLOv5-lite-s's
    58-wide 1x1 read at offset 58 of 116), given its weights padded once
    as the module tree gives them, takes one launch plan whatever input
    it sees: only the input is copied per call."""
    monkeypatch.setattr(IC, "_PLANS", {})
    wp = IC.pad_weight(_s8(gpu, (58, 1, 1, 58)))
    sp = IC.pad_channels(torch.full((58,), 1e-3, device="cuda"))
    for i in range(4):
        y = _s8(gpu, (2, 20, 20, 116))
        out = IC.int8_conv(y[..., 58:], wp, sp, None, stride=1, act=None, cout=58)
        assert out.shape == (2, 20, 20, 58) and out.is_contiguous()
        assert len(IC._PLANS) == 1, i


SILU, RELU = ("silu", "silu", None), ("relu", None, "relu")

BLOCK_CASES = [
    # (n, h, w, c, acts, residual)
    (2, 16, 40, 64, RELU, True),       # ResNet BasicBlock body
    (2, 19, 37, 64, SILU, True),       # YOLO bottleneck body, ragged
    (1, 8, 130, 32, SILU, False),      # no shortcut
    (1, 12, 20, 48, SILU, True),
    (2, 9, 33, 16, RELU, True),
    (1, 8, 20, 64, SILU, False),       # W below one 62-column tile
    (1, 10, 61, 64, RELU, True),       # W = 62 - 1
    (1, 10, 63, 64, SILU, True),       # W = 62 + 1
    (2, 11, 123, 32, SILU, True),      # W = 2 * 62 - 1
    (1, 9, 125, 16, RELU, False),      # W = 2 * 62 + 1
    (1, 3, 70, 64, SILU, True),        # H below a tile's rows
    (2, 1, 1, 48, RELU, True),         # one pixel
    (1, 5, 64, 48, RELU, False),
    (1, 17, 80, 16, SILU, True),
    (3, 7, 62, 32, RELU, True),
    (8, 160, 160, 64, SILU, True),     # YOLOv8l stage1 at full size
    (8, 80, 400, 64, RELU, True),      # ResNet-18 layer1 at full size
]


def _block_operands(gpu, c):
    w1q, w2q = _s8(gpu, (c, 3, 3, c), -80, 80), _s8(gpu, (c, 3, 3, c), -80, 80)
    s1 = torch.rand(c, generator=gpu, device="cuda") * 2e-4 + 1e-4
    s2 = torch.rand(c, generator=gpu, device="cuda") * 2e-4 + 1e-4
    b1 = torch.randn(c, generator=gpu, device="cuda") * 0.2
    b2 = torch.randn(c, generator=gpu, device="cuda") * 0.2
    sx, sm, so = (torch.tensor(v, device="cuda") for v in (0.021, 0.034, 0.027))
    return sx, w1q, s1, b1, sm, w2q, s2, b2, so


@pytest.mark.parametrize("n,h,w,c,acts,residual", BLOCK_CASES)
def test_block_matches_reference(gpu, n, h, w, c, acts, residual):
    """The kernel equals the plain version to the bit (0 LSB): exact s32
    sums and the same roundings in both epilogues."""
    xq = _s8(gpu, (n, h, w, c), -100, 100)
    args = (xq, *_block_operands(gpu, c))
    kw = dict(act1=acts[0], act2=acts[1], act_post=acts[2], residual=residual)
    before = B.launches
    got = B.fused_block(*args, **kw)
    want = B.block_reference(*args, **kw)
    torch.cuda.synchronize()
    assert B.launches == before + 1
    assert torch.equal(got, want)


#: every epilogue the kernel dispatches, at both of its widths (the 64-wide
#: instance serves C = 64 and 48, the 32-wide one C = 32 and 16): conv1's
#: with and without silu, conv2's with each of silu / not as act2 and as
#: act_post, relu and no activation on the non-silu side, and no biases
EPILOGUE_CASES = [
    # (n, h, w, c, (act1, act2, act_post), residual, biases)
    (1, 13, 70, 64, (None, None, None), True, False),
    (1, 13, 70, 64, ("silu", "silu", "silu"), True, False),
    (2, 7, 40, 64, ("relu", None, "silu"), False, True),
    (1, 9, 65, 48, (None, "silu", "silu"), True, True),
    (1, 13, 70, 64, ("silu", None, "silu"), True, False),
    (2, 6, 62, 64, (None, "silu", None), False, False),
    (1, 8, 33, 64, ("relu", "relu", "relu"), True, False),
    (1, 13, 70, 32, (None, None, "silu"), True, False),
    (2, 7, 40, 16, ("silu", "silu", "silu"), False, False),
    (1, 9, 65, 32, ("relu", "silu", "silu"), True, True),
    (1, 13, 70, 32, ("silu", None, None), True, False),
    (2, 6, 62, 16, (None, "silu", "relu"), True, False),
]


@pytest.mark.parametrize("n,h,w,c,acts,residual,biases", EPILOGUE_CASES)
def test_block_every_epilogue_matches_reference(gpu, n, h, w, c, acts, residual, biases):
    """Each epilogue instance of the kernel, with biases and with None
    (the kernel stages zeros), equals the plain version to the bit."""
    xq = _s8(gpu, (n, h, w, c), -100, 100)
    sx, w1q, s1, b1, sm, w2q, s2, b2, so = _block_operands(gpu, c)
    if not biases:
        b1 = b2 = None
    args = (xq, sx, w1q, s1, b1, sm, w2q, s2, b2, so)
    kw = dict(act1=acts[0], act2=acts[1], act_post=acts[2], residual=residual)
    before = B.launches
    got = B.fused_block(*args, **kw)
    want = B.block_reference(*args, **kw)
    torch.cuda.synchronize()
    assert B.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("biases", [True, False])
@pytest.mark.parametrize("n,h,w", [(2, 16, 32), (8, 160, 160)])
def test_block_reads_a_channel_slice_in_place(gpu, n, h, w, biases):
    """C2f's split half: channels 64..127 of a pitch-128 tensor, read in
    place through the input's TMA map; with biases and with None."""
    y = _s8(gpu, (n, h, w, 128), -100, 100)
    part = y[..., 64:]
    sx, w1q, s1, b1, sm, w2q, s2, b2, so = _block_operands(gpu, 64)
    if not biases:
        b1 = b2 = None
    kw = dict(act1="silu", act2="silu", act_post=None, residual=True)
    before = B.launches
    got = B.fused_block(part, sx, w1q, s1, b1, sm, w2q, s2, b2, so, **kw)
    want = B.block_reference(part.contiguous(), sx, w1q, s1, b1, sm, w2q, s2, b2, so, **kw)
    torch.cuda.synchronize()
    assert B.launches == before + 1
    assert torch.equal(got, want)


def test_kernels_reject_what_they_do_not_take(gpu):
    """The int8 conv takes weights of Cin and Cout in multiples of 8 (other
    widths come padded, ``pad_weight``: the tests above), k 1/3, stride 1/2
    and one output type; the block takes 16/32/48/64 channels."""
    xq = _s8(gpu, (1, 8, 8, 12))
    one = torch.ones(16, device="cuda")
    with pytest.raises(ValueError, match="multiples of 8"):
        IC.int8_conv(xq, _s8(gpu, (16, 3, 3, 12)), one, None, stride=1, act=None)
    with pytest.raises(ValueError, match="k in"):
        IC.int8_conv(xq, _s8(gpu, (16, 5, 5, 12)), one, None, stride=1, act=None)
    with pytest.raises(ValueError, match="stride"):
        IC.int8_conv(xq, _s8(gpu, (16, 3, 3, 12)), one, None, stride=3, act=None)
    with pytest.raises(ValueError, match="not both"):
        IC.int8_conv(xq, _s8(gpu, (16, 3, 3, 12)), one, None, stride=1, act=None,
                     out_scale=torch.tensor(1.0, device="cuda"), out_f32=True)
    with pytest.raises(ValueError, match="a row per image"):  # 2 rows for 1 image
        IC.int8_conv(_s8(gpu, (1, 8, 8, 16)), _s8(gpu, (16, 3, 3, 16)),
                     torch.ones(2, 16, device="cuda"), None, stride=1, act=None)
    x24 = _s8(gpu, (1, 8, 8, 24))
    s = torch.ones(24, device="cuda")
    t = torch.tensor(1.0, device="cuda")
    w = _s8(gpu, (24, 3, 3, 24))
    with pytest.raises(ValueError, match="block kernel takes"):
        B.fused_block(x24, t, w, s, None, t, w, s, None, t, act1=None, act2=None,
                      act_post=None, residual=True)
