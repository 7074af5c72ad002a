"""The port's pairwise IoU (``adas_tpu_torch/ops/boxes.py``, and the CPU
side of ``ops/iou.py``) against the JAX package: the Pallas kernel
``pallas_iou.iou_matrix`` in interpret mode and the XLA
``boxes.pairwise_iou`` / ``iou_row``, on the same boxes made with numpy
from a seed.  Tolerance atol = rtol = 1e-6 (``tests/test_pallas_iou.py``);
the port evaluates the reference's expressions operand for operand, so
against the XLA version it is checked to the bit as well.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adas_tpu.ops import boxes as jax_boxes
from adas_tpu.ops.pallas_iou import iou_matrix as pallas_iou_matrix
from adas_tpu_torch.ops import iou as port_iou
from adas_tpu_torch.ops.boxes import iou_row, pairwise_iou


def _boxes(n, seed, batch=None):
    """xyxy boxes in a 200x200 frame, clustered so that many overlap, with
    a few degenerate (zero-width) boxes."""
    rng = np.random.default_rng(seed)
    shape = (n,) if batch is None else (batch, n)
    centers = rng.uniform(20, 180, (*shape, 2))
    wh = rng.uniform(0, 60, (*shape, 2))
    wh[..., ::7, 0] = 0.0
    return np.concatenate([centers - wh / 2, centers + wh / 2], axis=-1).astype(np.float32)


@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("n", [1, 5, 128, 300])
def test_pairwise_iou_matches_pallas_and_xla(n, plus_one):
    b = _boxes(n, seed=n)
    got = pairwise_iou(torch.from_numpy(b), torch.from_numpy(b), plus_one=plus_one).numpy()
    pallas = np.asarray(pallas_iou_matrix(jnp.asarray(b), plus_one=plus_one, interpret=True))
    xla = np.asarray(jax_boxes.pairwise_iou(jnp.asarray(b), jnp.asarray(b), plus_one=plus_one))
    assert got.shape == pallas.shape == (n, n)
    np.testing.assert_allclose(got, pallas, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got, xla, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, got.T)  # symmetric to the bit


@pytest.mark.parametrize("plus_one", [False, True])
def test_pairwise_iou_rectangular_and_rows(plus_one):
    """(N, 4) x (M, 4) with N != M, and ``iou_row`` equal to the rows of
    the square matrix, as the JAX ``iou_row`` is."""
    a, b = _boxes(37, seed=1), _boxes(53, seed=2)
    got = pairwise_iou(torch.from_numpy(a), torch.from_numpy(b), plus_one=plus_one).numpy()
    want = np.asarray(jax_boxes.pairwise_iou(jnp.asarray(a), jnp.asarray(b), plus_one=plus_one))
    np.testing.assert_array_equal(got, want)
    full = pairwise_iou(torch.from_numpy(b), torch.from_numpy(b), plus_one=plus_one).numpy()
    for i in (0, 17, 52):
        row = iou_row(torch.from_numpy(b), torch.from_numpy(b[i]), plus_one=plus_one).numpy()
        jrow = np.asarray(jax_boxes.iou_row(jnp.asarray(b), jnp.asarray(b[i]), plus_one=plus_one))
        np.testing.assert_array_equal(row, jrow)
        np.testing.assert_array_equal(row, full[i])


@pytest.mark.parametrize("plus_one", [False, True])
def test_iou_matrix_batched_cpu_is_the_plain_version(plus_one):
    """On a CPU tensor the kernel wrapper takes the plain version, batched
    over streams, and counts no launch."""
    b = _boxes(300, seed=3, batch=3)
    port_iou.reset_launches()
    got = port_iou.iou_matrix(torch.from_numpy(b), plus_one=plus_one).numpy()
    assert port_iou.launches == 0 and got.shape == (3, 300, 300)
    for s in range(3):
        want = np.asarray(pallas_iou_matrix(jnp.asarray(b[s]), plus_one=plus_one, interpret=True))
        np.testing.assert_allclose(got[s], want, atol=1e-6, rtol=1e-6)


def test_iou_matrix_rejects_bad_shapes():
    with pytest.raises(ValueError, match=r"\(B, N, 4\)"):
        port_iou.iou_matrix(torch.zeros(5, 4))
