"""The stem's CUDA kernel against its plain PyTorch version, on the GPU.

Needs an NVIDIA GPU with nvcc (the kernel is built for sm_90a); each test
skips where there is none.  This file imports no JAX, so it runs on the
GPU machine without the repository's conftest:

    python -m pytest tests/test_torch_stem_cuda.py -q --noconftest -p no:cacheprovider

Tolerances: f32 with TF32 off at atol 2e-4 / rtol 1e-4 (the yardstick of
``tests/test_pallas_stem.py:80``); bf16 at atol = rtol = 1e-2 (both sides
sum in f32 and round once, so they differ by at most one bf16 step,
2^-8 relative).
"""
import pytest
import torch

from adas_tpu_torch.ops import stem as S

pytestmark = pytest.mark.cuda

CASES = [
    # (n, h, w, k, act, pool, features)
    (8, 640, 640, 3, "silu", False, 64),  # the YOLOv8l stem at its serving shape
    (8, 320, 1600, 7, "relu", True, 64),  # the ResNet stem chain at UFLDv2-CULane's
    (2, 64, 96, 3, "silu", False, 64),  # the YOLO stem
    (2, 64, 160, 7, "relu", True, 64),  # the ResNet stem chain
    (2, 66, 160, 7, "relu", True, 64),  # odd conv rows: pools to ceil(hc/2)
    (2, 65, 97, 7, "silu", True, 64),  # odd input, non-ReLU pool (-inf padding)
    (1, 33, 31, 7, None, True, 64),  # odd sizes, no activation
    (3, 17, 300, 3, "relu", False, 64),  # ragged tiles in both directions
    # the other YOLO widths (n/s/m/x: 16/32/48/80 features): the serving
    # shape and ragged tiles
    *[(8, 640, 640, 3, "silu", False, f) for f in (16, 32, 48, 80)],
    *[(3, 17, 300, 3, "relu", False, f) for f in (16, 32, 48, 80)],
]


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU build)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,k,act,pool,feat", CASES)
def test_kernel_matches_reference(gpu, dtype, n, h, w, k, act, pool, feat):
    x = torch.randn(n, 3, h, w, generator=gpu, device="cuda").to(dtype)
    wt = (torch.randn(feat, 3, k, k, generator=gpu, device="cuda") * 0.1).to(dtype)
    gain = torch.randn(feat, generator=gpu, device="cuda")
    bias = torch.randn(feat, generator=gpu, device="cuda")
    before = S.launches
    got = S.fused_stem(x, wt, gain, bias, act=act, pool=pool)
    want = S.stem_reference(x, wt, gain, bias, act=act, pool=pool)
    torch.cuda.synchronize()
    assert S.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype and got.shape[1] == feat
    tol = dict(atol=2e-4, rtol=1e-4) if dtype == torch.float32 else dict(atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_kernel_rejects_what_it_does_not_take(gpu):
    """Only the served (k, pool, features) combinations are instantiated."""
    x = torch.randn(1, 3, 32, 32, device="cuda")
    g = torch.ones(64, device="cuda")
    for feat, k, pool in ((24, 3, False), (32, 7, True), (64, 3, True), (64, 7, False)):
        with pytest.raises(ValueError, match="not instantiated"):
            S.fused_stem(x, torch.zeros(feat, 3, k, k, device="cuda"), g[:feat], g[:feat],
                         act=None, pool=pool)
    with pytest.raises(ValueError, match="contiguous"):
        S.fused_stem(x.transpose(2, 3), torch.zeros(64, 3, 3, 3, device="cuda"), g, g,
                     act=None, pool=False)


def test_listed_configs_are_the_instantiated_ones(gpu):
    """``kernel_configs()`` (the library's own list) holds the served
    combinations; each launches in both dtypes, and the C entry refuses a
    neighbour of each (the feature count one n-tile off, the other pool)."""
    served = S.kernel_configs()
    assert served == frozenset([(3, False, f) for f in (16, 32, 48, 64, 80)] + [(7, True, 64)])
    entry = S._entry()
    for k, pool, feat in sorted(served):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(1, 3, 34, 46, generator=gpu, device="cuda").to(dtype)
            wt = (torch.randn(feat, 3, k, k, generator=gpu, device="cuda") * 0.1).to(dtype)
            g = torch.randn(feat, generator=gpu, device="cuda")
            got = S.fused_stem(x, wt, g, g, act="relu", pool=pool)
            want = S.stem_reference(x, wt, g, g, act="relu", pool=pool)
            assert got.shape[1] == feat
            torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)
        out = torch.empty(1 << 20, device="cuda")
        for nk, npool, nfeat in ((k, not pool, feat), (k, pool, feat + 8)):
            if (nk, npool, nfeat) in served:
                continue
            rc = entry(out.data_ptr(), out.data_ptr(), out.data_ptr(), out.data_ptr(),
                       out.data_ptr(), 1, 34, 46, nk, int(npool), nfeat, 1, 0, 132, None)
            assert rc != 0, (nk, npool, nfeat)
    torch.cuda.synchronize()
