"""The port's bird-view warp (``ops/warp.warp_perspective``,
``PerspectiveTransformation.transformToBirdView`` /
``transformToFrontalView``) against the JAX package's on the same 720p
frames, in uint8 and f32, on the CPU.

Both invert the homography in f32 with the same LAPACK calls (XLA's CPU
lowering of ``jnp.linalg.inv`` is ``sgetrf`` + two ``strsm``, taken from
scipy; the port calls them through scipy: equal to the bit, held below
on both homographies and 300 re-fits) and sample with four clamped taps,
and the port evaluates the source coordinates as XLA evaluates the
reference's three-term dot (two fused multiply-adds).  The two warps
then agree to 5e-5 in f32 (XLA also fuses the bilinear sum) and on all
but a few uint8 pixels in 1e6, so every view holds the stated bounds:
uint8 at most one level apart everywhere and equal on at least 99.9% of
the pixels, f32 within 1e-3.  The identity is exact.
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adas_tpu.analytics.perspective import PerspectiveTransformation as JaxPerspective
from adas_tpu.ops.warp import warp_perspective as jax_warp
from adas_tpu_torch.analytics.perspective import PerspectiveTransformation
from adas_tpu_torch.ops.warp import _fma_f32, inverse_f32, warp_perspective

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
    _check_tight(_jax(img, m), _port(img, m), dtype)


def _refits(n, seed=0):
    """``n`` seeded re-fits of the trapezoid through ``updateTransformParams``
    (lane points jittered by up to 40 px): their bird-view and frontal
    homographies."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        left = np.array([[420, 700], [470, 600], [520, 520]]) + rng.integers(-40, 41, (3, 2))
        right = np.array([[900, 700], [850, 600], [800, 520]]) + rng.integers(-40, 41, (3, 2))
        p = JaxPerspective((W, H))
        p.updateTransformParams(left, right, "Default")
        out += [p.M, p.M_inv]
    return out


def test_inverse_is_jax_to_the_bit():
    """The port's f32 inverse of the homography equals ``jnp.linalg.inv`` of
    the f32 matrix bit for bit: both default homographies and 300 seeded
    re-fits (600 matrices)."""
    p = JaxPerspective((W, H))
    for m in [p.M, p.M_inv] + _refits(300):
        want = np.asarray(jnp.linalg.inv(jnp.asarray(m, jnp.float32)))
        got = inverse_f32(m)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_warp_rejects_a_flat_image():
    with pytest.raises(ValueError, match=r"\(H, W, C\)"):
        warp_perspective(torch.zeros(H, W), np.eye(3), (H, W))


@pytest.mark.parametrize("view", ["transformToBirdView", "transformToFrontalView"])
def test_transform_views_match_jax(view):
    """The image warps of ``PerspectiveTransformation`` after a re-fit of
    the trapezoid: shape, dtype, a writable host copy, and the bounds of
    the warp tests."""
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
    assert gap <= 1 and equal >= 0.999, (gap, equal)


@pytest.mark.parametrize("lanes", ["curved", "degenerate"])
def test_calc_curve_draw_matches_jax(lanes):
    """``calcCurveAndOffset(draw=True)`` (the JAX default) draws the
    vehicle and centre arrows and the offset and radius readings on the
    canvas as the JAX method does, to the pixel, and returns its numbers;
    ``draw=False`` returns the same numbers and leaves the canvas alone.
    The degenerate lanes put the vehicle position far off the canvas
    (the JAX method's ``_cx`` clamp)."""
    if lanes == "curved":
        left = np.array([[400.0, 719], [410, 500], [430, 300], [460, 100]])
        right = np.array([[900.0, 719], [905, 500], [915, 300], [930, 100]])
    else:
        left = np.array([[400.0, 719], [400, 718], [4e6, 717]])
        right = np.array([[900.0, 719], [900, 718], [9e6, 717]])
    canvas = _frame(np.uint8, seed=4)
    want_img, got_img, plain = canvas.copy(), canvas.copy(), canvas.copy()
    pt = PerspectiveTransformation((W, H), device="cpu")
    want = JaxPerspective((W, H)).calcCurveAndOffset(want_img, left, right)
    got = pt.calcCurveAndOffset(got_img, left, right)
    assert got == want or (np.isnan(got[1]).all() and np.isnan(want[1]).all())
    assert not np.array_equal(got_img, canvas)
    np.testing.assert_array_equal(got_img, want_img)
    assert pt.calcCurveAndOffset(plain, left, right, draw=False) == got
    np.testing.assert_array_equal(plain, canvas)


def test_calc_curve_draw_raises():
    """Drawing on a canvas the renderer cannot write (read-only) raises
    rather than drawing nothing; ``draw=False`` gives the JAX method's
    numbers on it."""
    left = np.array([[400.0, 719], [410, 500], [430, 300], [460, 100]])
    right = np.array([[900.0, 719], [905, 500], [915, 300], [930, 100]])
    canvas = np.zeros((H, W, 3), np.uint8)
    canvas.flags.writeable = False
    pt = PerspectiveTransformation((W, H), device="cpu")
    with pytest.raises(ValueError, match="writable"):
        pt.calcCurveAndOffset(canvas, left, right)
    got = pt.calcCurveAndOffset(canvas, left, right, draw=False)
    want = JaxPerspective((W, H)).calcCurveAndOffset(canvas, left, right, draw=False)
    assert got == want


def test_bird_view_drawing_matches_jax():
    """``DrawDetectedOnBirdView`` (the departing ego lane in red, points
    far outside the canvas or not finite skipped as the JAX method skips
    them) and ``DrawTransformFrontalViewArea`` draw the JAX methods'
    pixels."""
    from adas_tpu_torch.utils.types import OffsetType
    from adas_tpu.utils.types import OffsetType as JaxOffsetType

    rng = np.random.default_rng(5)
    lanes = [rng.integers(-2 * W, 3 * W, (40, 2)) for _ in range(4)]
    lanes[1][:3] = [[2 ** 30, 5], [-(2 ** 30), 7], [W - 1, 2 * H]]
    for offset, jax_offset in ((OffsetType.RIGHT, JaxOffsetType.RIGHT),
                               (OffsetType.LEFT, JaxOffsetType.LEFT)):
        jpt, pt = JaxPerspective((W, H)), PerspectiveTransformation((W, H), device="cpu")
        want, got = _frame(np.uint8, seed=6), _frame(np.uint8, seed=6)
        jpt.DrawDetectedOnBirdView(want, lanes, jax_offset)
        pt.DrawDetectedOnBirdView(got, lanes, offset)
        jpt.DrawTransformFrontalViewArea(want)
        pt.DrawTransformFrontalViewArea(got)
        np.testing.assert_array_equal(got, want)


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
