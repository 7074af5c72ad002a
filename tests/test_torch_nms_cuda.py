"""The pairwise-IoU and NMS-scan CUDA kernels against their plain PyTorch
versions, on the GPU.

Needs an NVIDIA GPU with nvcc (the kernels are built for sm_90a); each test
skips where there is none.  This file imports no JAX, so it runs on the
GPU machine without the repository's conftest:

    python -m pytest tests/test_torch_nms_cuda.py -q --noconftest -p no:cacheprovider

Yardsticks: the IoU kernel rounds every operation as the plain version
does, so the two matrices are equal to the bit (and symmetric); the scan
kernel picks exactly the indices of the plain loop, for the hard, linear
and gaussian methods.  Shapes: the serving one (8 streams, N = 512, the
top-k of ``select_and_nms``) and ragged ones (N not a multiple of the IoU
tile or of a warp).
"""
import pytest
import torch

from adas_tpu_torch.ops import iou as I
from adas_tpu_torch.ops import nms as S

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU build)")
    return torch.Generator(device="cuda").manual_seed(0)


def _boxes(gen, b, n):
    """Clustered xyxy boxes in a 512x512 frame (many overlaps), a few of
    them degenerate."""
    centers = torch.rand(b, 6, 2, generator=gen, device="cuda") * 400 + 56
    pick = torch.randint(0, 6, (b, n), generator=gen, device="cuda")
    c = torch.gather(centers, 1, pick[..., None].expand(-1, -1, 2))
    c = c + torch.randn(b, n, 2, generator=gen, device="cuda") * 12
    wh = torch.rand(b, n, 2, generator=gen, device="cuda") * 80 + 10
    wh[:, ::13, 0] = 0.0
    return torch.cat([c - wh / 2, c + wh / 2], dim=-1).contiguous()


def _scores(gen, b, n):
    s = torch.rand(b, n, generator=gen, device="cuda")
    s[:, 1::9] = s[:, :1]  # exact ties: the lowest index wins
    s[:, 5::11] = 0.0
    return s.contiguous()


@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("b,n", [(8, 512), (3, 300), (2, 1), (1, 65), (2, 1000)])
def test_iou_kernel_equals_plain(gpu, b, n, plus_one):
    boxes = _boxes(gpu, b, n)
    before = I.launches
    got = I.iou_matrix(boxes, plus_one=plus_one)
    want = I.iou_matrix_reference(boxes, plus_one=plus_one)
    torch.cuda.synchronize()
    assert I.launches == before + 1
    assert got.shape == want.shape == (b, n, n) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(got, got.transpose(1, 2))


@pytest.mark.parametrize("method,iou_threshold,score_threshold,plus_one", [
    (0, 0.45, 0.001, True),  # select_and_nms, hard
    (0, 0.5, 0.001, True),
    (0, 0.5, 0.0, False),  # nms_padded
    (1, 0.3, 0.001, True),  # soft_nms_padded, linear
    (2, 0.3, 0.001, True),  # gaussian (select_and_nms with hard_only=False)
])
@pytest.mark.parametrize("b,n,max_out", [(8, 512, 100), (3, 300, 300), (2, 33, 64), (1, 1, 4)])
def test_scan_kernel_equals_plain(gpu, method, iou_threshold, score_threshold, plus_one, b, n,
                                  max_out):
    boxes, scores = _boxes(gpu, b, n), _scores(gpu, b, n)
    iou = I.iou_matrix(boxes, plus_one=plus_one)
    args = (iou_threshold, max_out, method, 0.5, score_threshold)
    before = S.launches
    got = S.nms_scan(iou, scores, *args)
    want = S.nms_scan_reference(iou, scores, *args)
    torch.cuda.synchronize()
    assert S.launches == before + 1
    assert got.dtype == torch.int64 and got.shape == (b, max_out)
    assert torch.equal(got, want)
    assert (got >= 0).sum() > 0


def test_select_loop_runs_both_kernels(gpu):
    """On CUDA tensors ``select_loop`` is one IoU launch and one scan
    launch, whatever the method."""
    boxes, scores = _boxes(gpu, 8, 512), _scores(gpu, 8, 512)
    i0, s0 = I.launches, S.launches
    got = S.select_loop(boxes, scores, 0.45, 100, method=2, score_threshold=0.001, plus_one=True)
    assert (I.launches, S.launches) == (i0 + 1, s0 + 1)
    iou = I.iou_matrix_reference(boxes, plus_one=True)
    assert torch.equal(got, S.nms_scan_reference(iou, scores, 0.45, 100, 2, 0.5, 0.001))


def test_kernels_reject_what_they_do_not_take(gpu):
    boxes = _boxes(gpu, 2, 64)
    with pytest.raises(ValueError, match="contiguous f32"):
        I.iou_matrix(boxes.half())
    with pytest.raises(ValueError, match="contiguous f32"):
        I.iou_matrix(boxes.transpose(0, 1).contiguous().transpose(0, 1))
    iou = I.iou_matrix(boxes)
    scores = _scores(gpu, 2, 64)
    with pytest.raises(ValueError, match="one cuda device"):
        S.nms_scan(iou, scores.cpu(), 0.5, 10)
    with pytest.raises(ValueError, match="contiguous f32"):
        S.nms_scan(iou.double(), scores, 0.5, 10)
    big = _boxes(gpu, 1, 1100)
    with pytest.raises(ValueError, match="at most 1024"):
        S.nms_scan(I.iou_matrix(big), _scores(gpu, 1, 1100), 0.5, 10)
    with pytest.raises(ValueError, match="use_iou_matrix"):
        S.select_loop(boxes, scores, 0.5, 10, use_iou_matrix=False)
