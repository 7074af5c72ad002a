"""Port's fused stem (adas_tpu_torch/ops/stem.py) against the JAX stem.

On the CPU the port's wrapper runs its plain version, ``stem_reference``;
the JAX side runs ``fused_stem`` as ``tests/test_pallas_stem.py`` does:
through its parity-pinned XLA chain (``ADAS_DISABLE_PALLAS_STEM=1``,
``pallas_stem._xla_stem_chain``), and once in Pallas interpret mode at a
tiny shape.  f32, at the yardstick of ``test_pallas_stem.py:80`` (atol
2e-4, rtol 1e-4).  The CUDA kernel itself is compared with
``stem_reference`` on the GPU by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adas_tpu.ops.pallas_stem import fused_stem as jax_fused_stem
from adas_tpu.ops.pallas_stem import stem_margins
from adas_tpu_torch.ops import stem as S


def _planes(x_nhwc, margins):
    """NHWC -> the S2DPlanes data layout (n, i, (r, t, c), j) with zero
    halo margins (``test_pallas_stem._planes_from_nhwc``)."""
    n, h, w, c = x_nhwc.shape
    xs = (
        x_nhwc.reshape(n, h // 2, 2, w // 2, 2, c)
        .transpose(0, 1, 2, 4, 5, 3)
        .reshape(n, h // 2, 4 * c, w // 2)
    )
    (mt, mb), (ml, mr) = margins
    return np.pad(xs, ((0, 0), (mt, mb), (0, 0), (ml, mr)))


def _inputs(kk, hw, seed, feat=64):
    rng = np.random.default_rng(seed)
    h, w = hw
    x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    k = (rng.standard_normal((kk, kk, 3, feat)) * 0.1).astype(np.float32)
    gain = rng.standard_normal(feat).astype(np.float32)
    bias = rng.standard_normal(feat).astype(np.float32)
    return x, k, gain, bias


def _jax_stem(x, k, gain, bias, act, pool):
    h, w = x.shape[1:3]
    planes = _planes(x, stem_margins(k.shape[0], k.shape[1], pool))
    return np.asarray(
        jax_fused_stem(
            jnp.asarray(planes), jnp.asarray(k), gain, bias, logical_hw=(h, w),
            pool=pool, act=act, out_dtype=jnp.float32,
        )
    )


def _port_stem(x, k, gain, bias, act, pool):
    out = S.fused_stem(
        torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
        torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(gain), torch.from_numpy(bias), act=act, pool=pool,
    )
    return out.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize(
    "kk,pool,act,hw",
    [
        (3, False, "silu", (64, 96)),  # the YOLO stem
        (7, True, "relu", (64, 160)),  # the ResNet stem chain
        (7, True, "relu", (66, 160)),  # odd hs = 33: pools to ceil(hs/2)
        (7, True, "silu", (64, 160)),  # non-ReLU pool: real -inf padding
        (3, False, None, (32, 64)),
    ],
)
def test_stem_matches_jax(monkeypatch, kk, pool, act, hw):
    monkeypatch.setenv("ADAS_DISABLE_PALLAS_STEM", "1")
    x, k, gain, bias = _inputs(kk, hw, seed=kk + hw[0])
    ref = _jax_stem(x, k, gain, bias, act, pool)
    got = _port_stem(x, k, gain, bias, act, pool)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)


def test_stem_matches_jax_pallas_interpret():
    """The JAX side through the Pallas kernel itself (interpret mode on
    the CPU), one band, tiny shape."""
    x, k, gain, bias = _inputs(3, (16, 256), seed=5)
    ref = _jax_stem(x, k, gain, bias, "silu", False)
    got = _port_stem(x, k, gain, bias, "silu", False)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("feat", [16, 32, 48, 80])
def test_stem_widths_match_jax_pallas_interpret(feat):
    """The YOLO 3x3 stem at the other widths the kernel is instantiated for
    (the n/s/m/x scales' 16/32/48/80 features): the plain version against
    the Pallas kernel in interpret mode."""
    x, k, gain, bias = _inputs(3, (16, 128), seed=feat, feat=feat)
    ref = _jax_stem(x, k, gain, bias, "silu", False)
    got = _port_stem(x, k, gain, bias, "silu", False)
    assert got.shape == ref.shape == (2, 8, 64, feat)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)


def test_cpu_tensor_takes_plain_path_without_launch():
    x, k, gain, bias = _inputs(7, (32, 64), seed=1)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    kt = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    gt, bt = torch.from_numpy(gain), torch.from_numpy(bias)
    before = S.launches
    got = S.fused_stem(xt, kt, gt, bt, act="relu", pool=True)
    assert S.launches == before
    want = S.stem_reference(xt, kt, gt, bt, act="relu", pool=True)
    assert torch.equal(got, want)
    assert tuple(got.shape[2:]) == S.stem_out_hw(32, 64, pool=True) == (8, 16)


def test_stem_rejects_what_it_does_not_take():
    x = torch.zeros(1, 3, 16, 16)
    g = torch.ones(64)
    with pytest.raises(ValueError, match="odd"):
        S.fused_stem(x, torch.zeros(64, 3, 4, 4), g, g, act=None, pool=False)
    with pytest.raises(TypeError):
        S.fused_stem(x, torch.zeros(64, 3, 3, 3, dtype=torch.bfloat16), g, g,
                     act=None, pool=False)
    with pytest.raises(ValueError, match="activation"):
        S.fused_stem(x, torch.zeros(64, 3, 3, 3), g, g, act="gelu", pool=False)
    with pytest.raises(ValueError, match="gain"):
        S.fused_stem(x, torch.zeros(64, 3, 3, 3), g.double(), g, act=None, pool=False)
