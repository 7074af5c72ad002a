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


def _packed_jax_bits(boxes, iou_threshold, plus_one):
    """numpy packing of the JAX ``pairwise_iou(...) > thr`` bits, written
    apart from the port's: element 32 w + k is bit k of int32 word w."""
    over = np.asarray(jax_boxes.pairwise_iou(jnp.asarray(boxes), jnp.asarray(boxes),
                                             plus_one=plus_one) > iou_threshold)
    n = over.shape[-1]
    words = -(-n // 32)
    padded = np.zeros((*over.shape[:-1], 32 * words), dtype=bool)
    padded[..., :n] = over
    return np.packbits(padded, axis=-1, bitorder="little").view("<u4").view(np.int32)


@pytest.mark.parametrize("iou_threshold", [0.45, 0.5])
@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("n", [1, 31, 300, 512])
def test_iou_mask_reference_matches_jax_bits(n, plus_one, iou_threshold):
    """The mask mode's plain version (and the wrapper on a CPU tensor, which
    counts no launch) equals the packed bits of the JAX comparison."""
    b = _boxes(n, seed=n + 1, batch=2)
    want = np.stack([_packed_jax_bits(b[s], iou_threshold, plus_one) for s in range(2)])
    got = port_iou.iou_mask_reference(torch.from_numpy(b), iou_threshold, plus_one=plus_one)
    assert got.dtype == torch.int32 and got.shape == (2, n, -(-n // 32))
    np.testing.assert_array_equal(got.numpy(), want)
    port_iou.reset_launches()
    wrapped = port_iou.iou_mask(torch.from_numpy(b), iou_threshold, plus_one=plus_one)
    assert port_iou.launches == 0
    assert torch.equal(wrapped, got)
    bits = port_iou.unpack_bits(got, n)
    assert torch.equal(port_iou.pack_bits(bits), got)
    assert int(bits.sum()) > 0 or n == 1  # box 0 is degenerate: IoU(0, 0) = 0


def test_iou_mask_rejects_bad_shapes():
    with pytest.raises(ValueError, match=r"\(B, N, 4\)"):
        port_iou.iou_mask(torch.zeros(2, 5, 5), 0.5)
