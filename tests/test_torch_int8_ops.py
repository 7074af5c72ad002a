"""The port's int8 ops (plain CPU versions of the two int8 kernels and the
quant core) against the JAX package on the same s8 data.

* ``ops/int8_conv.py``: against ``adas_tpu.models.layers.int8_conv_apply``
  (the XLA int8 conv + fused epilogue) over k1/k3 x s1/s2 x relu/silu/none
  x bf16/s8 output x QTensor/float input, and against the TPU kernel
  ``pallas_conv.int8_conv3x3`` in interpret mode at
  ``tests/test_pallas_conv.py``'s shapes.
* ``ops/block.py``: against ``pallas_block.fused_block_nhwc`` (interpret
  mode) and ``xla_block_ref`` for the three ``CASES`` and both shapes of
  ``tests/test_pallas_block.py``; against ``xla_block_ref`` for every
  epilogue pattern of the CUDA kernel, with and without biases; the
  wrapper's operand checks.
* ``models/quant.py``: quantize, dequant, the s8 max pool and upsample,
  the weight quantize, Int8Dense.

Yardsticks (``tests/test_pallas_block.py:110-111``): s32 accumulators
bit-identical (unit epilogue scale, zero bias, no activation, so the bf16
output is the accumulator rounded once on both sides); s8 outputs within
1 LSB on fewer than 0.5% of the elements (the f32 epilogues round alike,
but silu's exp differs between the frameworks by an ulp, which can move a
value across a .5 boundary); bf16 outputs within one bf16 ulp (2^-7
relative) or 1e-30 absolute (a far-negative SiLU underflows to -0 on one
side and to ~1e-37 on the other).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adas_tpu.models import layers as L
from adas_tpu.ops import pallas_block as PB
from adas_tpu.ops.pallas_conv import int8_conv3x3
from adas_tpu_torch.models import quant as Q
from adas_tpu_torch.ops.block import block_reference, fused_block
from adas_tpu_torch.ops.int8_conv import (
    int8_conv,
    int8_conv_accumulate,
    pad_channels,
    pad_weight,
)
from test_pallas_block import CASES, _mk, xla_block_ref

JAX_ACTS = {None: None, "relu": jax.nn.relu, "silu": jax.nn.silu}


def assert_s8_close(got, want):
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1, diff.max()
    assert (diff != 0).mean() < 5e-3


def assert_bf16_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= np.abs(want) * 2.0 ** -7 + 1e-30)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_np(t):
    return t.float().numpy()


def _case(rng, k, n=2, h=9, w=11, cin=16, cout=24):
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32) * 2
    kern = (rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    wq, wscale = Q.quantize_weight(_t(kern.transpose(3, 0, 1, 2)))  # OHWI
    gain = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return x, wq, wscale, gain, bias


@pytest.mark.parametrize("qin", [False, True])
@pytest.mark.parametrize("requant", [False, True])
@pytest.mark.parametrize("act", [None, "relu", "silu"])
@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_plain_conv_matches_int8_conv_apply(rng, k, stride, act, requant, qin):
    x, wq, wscale, gain, bias = _case(rng, k)
    xs = np.float32(np.abs(x).max() / 127.0)
    out_scale = np.float32(0.03) if requant else None
    wq_hwio = jnp.asarray(wq.permute(1, 2, 3, 0).numpy())
    xq = Q.quantize_to(_t(x), torch.tensor(xs))
    jx = L.QTensor(jnp.asarray(xq.data.numpy()), jnp.float32(xs)) if qin else jnp.asarray(x)
    want = L.int8_conv_apply(
        jx, None, (stride, stride), [(k // 2, k // 2)] * 2, xscale=jnp.float32(xs),
        wqparams=(wq_hwio, jnp.asarray(wscale.numpy())),
        fold=(jnp.asarray(gain), jnp.asarray(bias)), act=JAX_ACTS[act],
        out_scale=None if out_scale is None else jnp.float32(out_scale),
    )
    scale = wscale * xq.scale * _t(gain)
    got = int8_conv(xq.data, wq, scale, _t(bias), stride=stride, act=act,
                    out_scale=None if out_scale is None else torch.tensor(out_scale))
    if requant:
        assert isinstance(want, L.QTensor) and got.dtype == torch.int8
        assert_s8_close(got.numpy(), want.data)
    else:
        assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
        assert_bf16_close(_bf16_np(got), want)


@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_accumulator_bit_identical(rng, k, stride):
    """Unit scales, zero bias, no activation: both sides' bf16 output is
    the s32 accumulator rounded once."""
    _, wq, _, _, _ = _case(rng, k)
    xq = rng.integers(-127, 128, (2, 9, 11, 16)).astype(np.int8)
    cout = wq.shape[0]
    want = L.int8_conv_apply(
        L.QTensor(jnp.asarray(xq), jnp.float32(1)), None, (stride, stride),
        [(k // 2, k // 2)] * 2, wqparams=(jnp.asarray(wq.permute(1, 2, 3, 0).numpy()),
                                          jnp.ones(cout, jnp.float32)),
        fold=(jnp.ones(cout, jnp.float32), jnp.zeros(cout, jnp.float32)),
    )
    got = int8_conv(_t(xq), wq, torch.ones(cout), None, stride=stride, act=None)
    np.testing.assert_array_equal(_bf16_np(got), np.asarray(want, np.float32))
    acc = int8_conv_accumulate(_t(xq), wq, stride)
    want_acc = jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq.permute(1, 2, 3, 0).numpy()), (stride, stride),
        [(k // 2, k // 2)] * 2, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32,
    )
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))


@pytest.mark.parametrize("k,stride", [(1, 1), (3, 2)])
def test_padded_operands_give_the_conv_at_its_widths(rng, k, stride):
    """The operands the module tree hands the kernel (weights, scale and
    bias padded with zeros to multiples of 8, ``pad_weight`` /
    ``pad_channels``, and the conv's own ``cout``) give the unpadded
    conv's output to the bit, at a YOLOv5-lite-s width: 58 channels read
    at offset 58 of 116, out to 58."""
    xq = _t(rng.integers(-127, 128, (2, 9, 11, 116)).astype(np.int8))[..., 58:]
    wq = _t(rng.integers(-127, 128, (58, k, k, 58)).astype(np.int8))
    scale = _t(rng.uniform(1e-4, 2e-3, 58).astype(np.float32))
    bias = _t(rng.normal(0, 0.5, 58).astype(np.float32))
    wp = pad_weight(wq)
    assert wp.shape == (64, k, k, 64) and not wp[58:].any() and not wp[..., 58:].any()
    assert pad_weight(wp) is wp and pad_channels(pad_channels(scale)).shape == (64,)
    for out_scale in (None, torch.tensor(np.float32(0.05))):
        kw = dict(stride=stride, act="silu", out_scale=out_scale)
        want = int8_conv(xq, wq, scale, bias, **kw)
        got = int8_conv(xq, wp, pad_channels(scale), pad_channels(bias), cout=58, **kw)
        assert got.shape == want.shape == (2, *want.shape[1:3], 58)
        assert torch.equal(got, want)


def test_qconv_kernel_weight_is_padded_once(rng):
    """``QConv2d.kernel_weight``: the packed ``wq`` padded to multiples of
    8 and to rows of 16 bytes (``pad_weight``), made once per packing (the
    same tensor call after call), ``wq`` itself where nothing needs
    padding."""
    conv = Q.QConv2d(58, 29, 1, bias=False)
    Q.pack_int8_weights(conv)
    w = conv.kernel_weight()
    assert w is conv.kernel_weight() and w.shape == (32, 1, 1, 64)
    assert torch.equal(w[:29, ..., :58], conv.wq) and w.data_ptr() != conv.wq.data_ptr()
    wide = Q.QConv2d(64, 32, 3, padding=1, bias=False)
    Q.pack_int8_weights(wide)
    assert wide.kernel_weight() is wide.wq
    # K = 24 bytes a row: rows spaced to 32 bytes, the view keeps (16, 1, 1, 24)
    rows = Q.QConv2d(24, 16, 1, bias=False)
    Q.pack_int8_weights(rows)
    w = rows.kernel_weight()
    assert w.shape == (16, 1, 1, 24) and w.stride(0) == 32 and torch.equal(w, rows.wq)


@pytest.mark.parametrize("act", [None, "relu", "silu"])
def test_plain_conv_matches_pallas_conv_bf16(rng, act):
    """The TPU kernel (interpret mode) at test_pallas_conv.py's shape."""
    xq = rng.integers(-127, 128, (2, 8, 12, 16)).astype(np.int8)
    wq = rng.integers(-127, 128, (3, 3, 16, 24)).astype(np.int8)
    scale = rng.uniform(1e-4, 2e-3, 24).astype(np.float32)
    bias = rng.normal(0, 0.5, 24).astype(np.float32)
    want = int8_conv3x3(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale),
                        jnp.asarray(bias), act, interpret=True)
    got = int8_conv(_t(xq), _t(wq.transpose(3, 0, 1, 2)), _t(scale), _t(bias), stride=1,
                    act=act)
    # the Pallas kernel's K-packed dots give the same s32; its epilogue is
    # the same f32 chain
    assert_bf16_close(_bf16_np(got), want)


def test_plain_conv_matches_pallas_conv_requant(rng):
    xq = rng.integers(-127, 128, (2, 8, 12, 32)).astype(np.int8)
    wq = rng.integers(-127, 128, (3, 3, 32, 16)).astype(np.int8)
    scale = rng.uniform(1e-4, 2e-3, 16).astype(np.float32)
    bias = rng.normal(0, 0.5, 16).astype(np.float32)
    want = int8_conv3x3(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale),
                        jnp.asarray(bias), "silu", out_scale=jnp.float32(0.07), interpret=True)
    got = int8_conv(_t(xq), _t(wq.transpose(3, 0, 1, 2)), _t(scale), _t(bias), stride=1,
                    act="silu", out_scale=torch.tensor(np.float32(0.07)))
    assert_s8_close(got.numpy(), want)


@pytest.mark.parametrize("acts,residual", CASES)
@pytest.mark.parametrize("shape", [(2, 16, 40, 8, 8), (1, 8, 130, 32, 32)])
def test_plain_block_matches_pallas_and_xla(rng, acts, residual, shape):
    n, h, w, cin, cmid = shape
    xq, sx, w1q, s1, b1, sm, w2q, s2, b2, so = _mk(rng, n, h, w, cin, cmid, cin)
    kw = dict(act1=acts[0], act2=acts[1], act_post=acts[2], residual=residual)
    ref = xla_block_ref(xq, sx, w1q, s1, b1, sm, w2q, s2, b2, so, *acts, residual)
    pallas = PB.fused_block_nhwc(xq, sx, w1q, s1, b1, sm, w2q, s2, b2, so, interpret=True,
                                 **kw)

    def ohwi(wt):
        return _t(np.asarray(wt).transpose(3, 0, 1, 2))

    def sc(v):
        return torch.tensor(np.float32(v))

    got = fused_block(_t(np.asarray(xq)), sc(sx), ohwi(w1q), _t(s1), _t(b1), sc(sm), ohwi(w2q),
                      _t(s2), _t(b2), sc(so), **kw)
    assert got.dtype == torch.int8 and got.is_contiguous()
    assert_s8_close(got.numpy(), ref)
    assert_s8_close(got.numpy(), pallas)


def test_block_reads_a_channel_slice(rng):
    """The port's NHWC block takes a channel view (a C2f split half)."""
    xq, sx, w1q, s1, b1, sm, w2q, s2, b2, so = (
        _t(np.asarray(a)) for a in _mk(rng, 1, 8, 20, 16, 16, 16)
    )
    w1q, w2q = w1q.permute(3, 0, 1, 2).contiguous(), w2q.permute(3, 0, 1, 2).contiguous()
    wide = torch.cat([torch.zeros_like(xq), xq], dim=-1)
    kw = dict(act1="silu", act2="silu", act_post=None, residual=True)
    got = fused_block(wide[..., 16:], sx, w1q, s1, b1, sm, w2q, s2, b2, so, **kw)
    want = block_reference(xq, sx, w1q, s1, b1, sm, w2q, s2, b2, so, **kw)
    assert torch.equal(got, want)


def test_quant_core_matches_layers(rng):
    """quantize_to / dequant / max_pool_q / 2x upsample / weight quantize /
    Int8Dense against layers.py (exact where the math is elementwise)."""
    x = (rng.standard_normal((2, 6, 7, 16)) * 3).astype(np.float32)
    s = np.float32(0.05)
    want = L.quantize_to(jnp.asarray(x), jnp.float32(s))
    # a permuted NCHW view: the transpose rides the cast
    xv = _t(x.transpose(0, 3, 1, 2)).permute(0, 2, 3, 1)
    got = Q.quantize_to(xv, torch.tensor(s))
    assert got.data.is_contiguous()
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(_bf16_np(got.dequant()), np.asarray(want.dequant(), np.float32))
    np.testing.assert_array_equal(
        Q.max_pool_q(got, 5, 1, 2).data.numpy(), np.asarray(L.max_pool_q(want, 5, 1, 2).data))
    np.testing.assert_array_equal(
        Q.upsample2x_nhwc(got).data.numpy(), np.asarray(L.resize_nearest_2x(want).data))
    kern = rng.standard_normal((3, 3, 16, 8)).astype(np.float32)
    k = jnp.asarray(kern)
    wmax = jnp.max(jnp.abs(k), axis=(0, 1, 2))
    ws = jnp.maximum(wmax, 1e-8) / 127.0
    wq = jnp.clip(jnp.round(k / ws), -127, 127).astype(jnp.int8)
    pq, pws = Q.quantize_weight(_t(kern.transpose(3, 0, 1, 2)))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(wq).transpose(3, 0, 1, 2))
    np.testing.assert_array_equal(pws.numpy(), np.asarray(ws))
    with pytest.raises(ValueError, match="scale objects"):
        Q.qconcat([got, Q.QTensor(got.data, torch.tensor(s))])


def test_int8_dense_matches_layers(rng):
    x = rng.standard_normal((3, 40)).astype(np.float32)
    kern = (rng.standard_normal((40, 24)) / 6).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    dense = L.Int8Dense(24)
    variables = {"params": {"kernel": jnp.asarray(kern), "bias": jnp.asarray(bias)}}
    # a dynamic scale per row: the port's batch is JAX's vmapped streams
    want = jax.vmap(lambda xi: dense.apply(variables, xi[None])[0])(jnp.asarray(x))
    port = Q.QLinear(40, 24)
    with torch.no_grad():
        port.weight.copy_(_t(kern.T))
        port.bias.copy_(_t(bias))
    got = port(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


#: the activation patterns of the CUDA kernel's epilogues (conv1's with and
#: without silu; conv2's with each of silu / not as act2 and as act_post)
EPILOGUE_CASES = [
    # ((act1, act2, act_post), residual)
    ((None, None, None), True),
    (("silu", "silu", "silu"), True),
    (("relu", None, "silu"), False),
    ((None, "silu", "silu"), True),
    (("silu", None, "silu"), True),
    ((None, "silu", None), False),
    (("relu", "relu", "relu"), True),
    (("silu", None, None), True),
]


@pytest.mark.parametrize("biases", [True, False])
@pytest.mark.parametrize("acts,residual", EPILOGUE_CASES)
def test_plain_block_every_epilogue_matches_xla(rng, acts, residual, biases):
    """The plain block, the CUDA kernel's yardstick, against the XLA block
    for every epilogue pattern the kernel takes; a None bias is the XLA
    block's zero bias."""
    xq, sx, w1q, s1, b1, sm, w2q, s2, b2, so = _mk(rng, 2, 7, 13, 16, 16, 16)
    if not biases:
        b1, b2 = jnp.zeros_like(b1), jnp.zeros_like(b2)
    ref = xla_block_ref(xq, sx, w1q, s1, b1, sm, w2q, s2, b2, so, *acts, residual)
    t = {k: _t(np.asarray(v)) for k, v in dict(x=xq, sx=sx, s1=s1, b1=b1, sm=sm, s2=s2, b2=b2,
                                                so=so).items()}
    w1, w2 = (_t(np.asarray(wt).transpose(3, 0, 1, 2)) for wt in (w1q, w2q))
    got = fused_block(t["x"], t["sx"], w1, t["s1"], t["b1"] if biases else None, t["sm"], w2,
                      t["s2"], t["b2"] if biases else None, t["so"],
                      act1=acts[0], act2=acts[1], act_post=acts[2], residual=residual)
    assert got.dtype == torch.int8 and got.shape == xq.shape
    assert_s8_close(got.numpy(), ref)


_X16 = torch.zeros(1, 4, 5, 16, dtype=torch.int8)
_W16 = torch.zeros(16, 3, 3, 16, dtype=torch.int8)


@pytest.mark.parametrize("bad", [
    pytest.param(dict(xq=_X16.float()), id="float input"),
    pytest.param(dict(xq=_X16[0]), id="3-D input"),
    pytest.param(dict(w1q=torch.zeros(16, 3, 3, 8, dtype=torch.int8)), id="w1 of other width"),
    pytest.param(dict(w2q=torch.zeros(32, 3, 3, 16, dtype=torch.int8), scale2=torch.ones(32)),
                 id="residual across widths"),
    pytest.param(dict(scale1=torch.ones(16, dtype=torch.float64)), id="f64 scale"),
    pytest.param(dict(bias2=torch.ones(8)), id="bias of other width"),
    pytest.param(dict(out_scale=torch.ones(2)), id="two-value scalar"),
    pytest.param(dict(act2="gelu"), id="unknown activation"),
    pytest.param(dict(bias1=torch.ones(16, dtype=torch.float64)), id="f64 bias"),
    pytest.param(dict(xq=_X16.to("meta")), id="neither cpu nor cuda"),
])
def test_block_rejects_what_it_does_not_take(bad):
    """The wrapper checks its operands before either path runs."""
    v, one = torch.ones(16), torch.tensor(1.0)
    args = dict(xq=_X16, x_scale=one, w1q=_W16, scale1=v, bias1=None, mid_scale=one, w2q=_W16,
                scale2=v, bias2=None, out_scale=one, act1="relu", act2=None, act_post="relu",
                residual=True)
    with pytest.raises(ValueError):
        fused_block(**{**args, **bad})
