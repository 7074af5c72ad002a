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
side and to ~1e-37 on the other).
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
    xq = _s8(gpu, (1, 8, 8, 12))
    one = torch.ones(16, device="cuda")
    with pytest.raises(ValueError, match="multiples of 8"):
        IC.int8_conv(xq, _s8(gpu, (16, 3, 3, 12)), one, None, stride=1, act=None)
    x24 = _s8(gpu, (1, 8, 8, 24))
    s = torch.ones(24, device="cuda")
    t = torch.tensor(1.0, device="cuda")
    w = _s8(gpu, (24, 3, 3, 24))
    with pytest.raises(ValueError, match="block kernel takes"):
        B.fused_block(x24, t, w, s, None, t, w, s, None, t, act1=None, act2=None,
                      act_post=None, residual=True)
