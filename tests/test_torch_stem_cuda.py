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
    # (n, h, w, k, act, pool)
    (8, 640, 640, 3, "silu", False),  # the YOLOv8 stem at its serving shape
    (8, 320, 1600, 7, "relu", True),  # the ResNet stem chain at UFLDv2-CULane's
    (2, 64, 96, 3, "silu", False),  # the YOLO stem
    (2, 64, 160, 7, "relu", True),  # the ResNet stem chain
    (2, 66, 160, 7, "relu", True),  # odd conv rows: pools to ceil(hc/2)
    (2, 65, 97, 7, "silu", True),  # odd input, non-ReLU pool (-inf padding)
    (1, 33, 31, 3, None, True),
    (3, 17, 300, 3, "relu", False),  # ragged tiles in both directions
]


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU build)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,k,act,pool", CASES)
def test_kernel_matches_reference(gpu, dtype, n, h, w, k, act, pool):
    x = torch.randn(n, 3, h, w, generator=gpu, device="cuda").to(dtype)
    wt = (torch.randn(64, 3, k, k, generator=gpu, device="cuda") * 0.1).to(dtype)
    gain = torch.randn(64, generator=gpu, device="cuda")
    bias = torch.randn(64, generator=gpu, device="cuda")
    before = S.launches
    got = S.fused_stem(x, wt, gain, bias, act=act, pool=pool)
    want = S.stem_reference(x, wt, gain, bias, act=act, pool=pool)
    torch.cuda.synchronize()
    assert S.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    tol = dict(atol=2e-4, rtol=1e-4) if dtype == torch.float32 else dict(atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_kernel_rejects_what_it_does_not_take(gpu):
    x = torch.randn(1, 3, 32, 32, device="cuda")
    g = torch.ones(64, device="cuda")
    with pytest.raises(ValueError, match="64 features"):
        S.fused_stem(x, torch.zeros(32, 3, 3, 3, device="cuda"), g[:32], g[:32],
                     act=None, pool=False)
    with pytest.raises(ValueError, match="contiguous"):
        S.fused_stem(x.transpose(2, 3), torch.zeros(64, 3, 3, 3, device="cuda"), g, g,
                     act=None, pool=False)
