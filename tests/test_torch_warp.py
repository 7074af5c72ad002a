"""The port's bird-view warp (``ops/warp.warp_perspective``,
``PerspectiveTransformation.transformToBirdView`` /
``transformToFrontalView``) against the JAX package's on the same 720p
frames, in uint8 and f32, on the CPU.

Both invert the homography in f32 and sample with four clamped taps, and
the port evaluates the source coordinates as XLA evaluates the
reference's three-term dot (two fused multiply-adds).  Given the same f32
inverse the two warps agree to 5e-5 in f32 (XLA also fuses the bilinear
sum) and on all but a few uint8 pixels in 1e6.  The identity is exact.
The frontal-view homography's f32 inverse comes out the same from both
LU implementations, so the whole warp holds the stated bounds: uint8 at
most one level apart everywhere and equal on at least 99.9% of the
pixels, f32 within 1e-3.

The bird-view homography's does not: its two f32 inverses differ by up
to 8e-7 relative (each about 1e-6 from the exact one; LAPACK's LU here,
OpenBLAS's in JAX), and the far rows of the bird view carry that into
source coordinates a few thousandths of a pixel apart, which pixel noise
turns into up to 0.11 of a level (0.47% of the uint8 pixels one level
off, measured over three seeds).  That test states those bounds, and
shows the cause: with JAX's inverse handed in, the port's sampling meets
the tight ones.
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adas_tpu.analytics.perspective import PerspectiveTransformation as JaxPerspective
from adas_tpu.ops.warp import warp_perspective as jax_warp
from adas_tpu_torch.analytics.perspective import NO_RENDERER, PerspectiveTransformation
from adas_tpu_torch.ops.warp import _fma_f32, warp_inverse, warp_perspective

H, W = 720, 1280


def _frame(dtype, seed=0):
    """A 720p frame of pixel noise (the hardest content for a warp)."""
    f = np.random.default_rng(seed).uniform(0, 255, (H, W, 3)).astype(np.float32)
    return np.round(f).astype(np.uint8) if dtype == np.uint8 else f


def _gap(want, got):
    """(largest difference, share of equal pixels), NaN outputs (where the
    homography's denominator is 0) required in the same places."""
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert np.array_equal(np.isnan(want), np.isnan(got))
    d = np.abs(want - got)[~np.isnan(want)]
    return d.max(), (d == 0).mean()


def _jax(img, matrix):
    return np.asarray(jax_warp(jnp.asarray(img), jnp.asarray(matrix, jnp.float32), (H, W)))


def _port(img, matrix):
    return warp_perspective(torch.from_numpy(img), matrix, (H, W)).numpy()


def _check_tight(want, got, dtype):
    gap, equal = _gap(want, got)
    if dtype == np.uint8:
        assert gap <= 1 and equal >= 0.999, (gap, equal)
    else:
        assert gap <= 1e-3, gap


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_identity_is_exact(dtype):
    img = _frame(dtype)
    got = _port(img, np.eye(3))
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, _jax(img, np.eye(3)))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_frontal_view_matches_jax(dtype):
    m = JaxPerspective((W, H)).M_inv
    img = _frame(dtype, seed=1)
    _check_tight(_jax(img, m), _port(img, m), dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_bird_view_matches_jax(dtype):
    m = JaxPerspective((W, H)).M
    img = _frame(dtype, seed=2)
    want = _jax(img, m)
    gap, equal = _gap(want, _port(img, m))
    if dtype == np.uint8:
        assert gap <= 1 and equal >= 0.99, (gap, equal)
    else:
        assert gap <= 0.15, gap
    # the cause: the f32 inverses (within 1e-6 of the largest entry) ...
    m32 = torch.as_tensor(m).float()
    jax_inv = torch.from_numpy(np.array(jnp.linalg.inv(jnp.asarray(m, jnp.float32))))
    port_inv = torch.linalg.inv_ex(m32)[0]
    assert (port_inv - jax_inv).abs().max() <= 1e-6 * jax_inv.abs().max()
    # ... for with JAX's inverse the sampling meets the tight bounds
    _check_tight(want, warp_inverse(torch.from_numpy(img), jax_inv, (H, W)).numpy(), dtype)


def test_warp_rejects_a_flat_image():
    with pytest.raises(ValueError, match=r"\(H, W, C\)"):
        warp_perspective(torch.zeros(H, W), np.eye(3), (H, W))


@pytest.mark.parametrize("view", ["transformToBirdView", "transformToFrontalView"])
def test_transform_views_match_jax(view):
    """The image warps of ``PerspectiveTransformation`` after a re-fit of
    the trapezoid: shape, dtype, a writable host copy, and the bounds of
    the warp tests (bird view: those of :func:`test_bird_view_matches_jax`)."""
    left = np.array([[420, 700], [470, 600], [520, 520]])
    right = np.array([[900, 700], [850, 600], [800, 520]])
    jpt, pt = JaxPerspective((W, H)), PerspectiveTransformation((W, H), device="cpu")
    for p in (jpt, pt):
        p.updateTransformParams(left, right, "Default")
    np.testing.assert_array_equal(pt.M, jpt.M)
    img = _frame(np.uint8, seed=3)
    want = getattr(jpt, view)(img)
    got = getattr(pt, view)(img)
    assert got.shape == want.shape and got.dtype == np.uint8 and got.flags.writeable
    gap, equal = _gap(want, got)
    assert gap <= 1 and equal >= (0.99 if view == "transformToBirdView" else 0.999), (gap, equal)


def test_calc_curve_draw_raises():
    """Drawing is not ported: ``draw=True`` (the JAX default) raises, and
    ``draw=False`` gives the JAX method's numbers."""
    left = np.array([[400.0, 719], [410, 500], [430, 300], [460, 100]])
    right = np.array([[900.0, 719], [905, 500], [915, 300], [930, 100]])
    canvas = np.zeros((H, W, 3), np.uint8)
    pt = PerspectiveTransformation((W, H), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt.calcCurveAndOffset(canvas, left, right)
    assert "renderer" in NO_RENDERER
    got = pt.calcCurveAndOffset(canvas, left, right, draw=False)
    want = JaxPerspective((W, H)).calcCurveAndOffset(canvas, left, right, draw=False)
    assert got == want


def _round_f32(q: Fraction) -> np.float32:
    """An exact rational rounded to the nearest f32, ties to even."""
    r = np.float32(float(q))
    below = np.nextafter(r, np.float32(-np.inf))
    above = np.nextafter(r, np.float32(np.inf))
    best = min((below, r, above), key=lambda c: (abs(Fraction(float(c)) - q),
                                                 int(c.view(np.uint32)) & 1))
    return np.float32(best)


def test_fma_emulation_is_exact():
    """``_fma_f32(m * y, acc)`` is ``m * y + acc`` rounded once to f32 (a
    fused multiply-add) for f32 ``m`` and ``acc`` and pixel rows ``y``,
    ties included: random operands, and operands built so that the f64 sum
    lands halfway between two f32 values with a tiny ``acc`` deciding."""
    rng = np.random.default_rng(0)
    m = (rng.standard_normal(4000) * 10.0 ** rng.integers(-4, 2, 4000)).astype(np.float32)
    y = rng.integers(0, 1080, 4000).astype(np.float64)
    acc = (rng.standard_normal(4000) * 10.0 ** rng.integers(-18, 3, 4000)).astype(np.float32)
    # ties: m = 1 + k ulp with k odd times y = 3 lies halfway between two
    # f32 values of [2, 4); a tiny acc of either sign decides
    m_tie = (1.0 + (2 * rng.integers(0, 2 ** 20, 200) + 1) * 2.0 ** -23).astype(np.float32)
    m = np.concatenate([m, m_tie, m_tie])
    y = np.concatenate([y, np.full(400, 3.0)])
    acc = np.concatenate([acc, np.full(200, 1e-30, np.float32), np.full(200, -1e-30, np.float32)])
    got = _fma_f32(torch.from_numpy(m.astype(np.float64) * y),
                   torch.from_numpy(acc.astype(np.float64))).numpy()
    want = [_round_f32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))
            for a, b, c in zip(m, y, acc)]
    np.testing.assert_array_equal(got, np.array(want, np.float32))
