"""The Hopper LRN kernels (znicz_tpu_torch/ops/kernels/lrn.py) and their
plain versions, without JAX, so the file runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

On the CPU the plain versions are checked against an independent formula,
PyTorch's ``F.local_response_norm`` (its ``alpha`` is divided by ``n``, so it
gets ``alpha * n``; its window is the same, ``n//2`` before and
``(n-1)//2`` after) and its autograd gradient, rtol 1e-5 / 1e-4.  The
``cuda``-marked tests compare each kernel with its plain version on the
card: f32 within rtol 1e-5 / atol 1e-6, bf16 within 2e-2 (about one bf16
rounding of the output).
"""

import pytest
import torch
import torch.nn.functional as F

from znicz_tpu_torch.ops.kernels import lrn as lrn_kernel

torch.set_float32_matmul_precision("highest")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

CASES = [  # (NHWC shape, alpha, beta, k, n)
    ((2, 5, 5, 96), 1e-4, 0.75, 2.0, 5),
    ((3, 4, 4, 64), 2e-3, 0.5, 1.0, 3),
    ((2, 3, 4, 32), 1e-3, 0.6, 1.5, 4),
    ((1, 3, 7, 40), 5e-3, 0.25, 1.0, 5),
    ((2, 2, 3, 33), 5e-3, 1.0, 1.0, 2),
    ((4, 3, 3, 7), 1e-2, 0.75, 1.0, 6),
    ((2, 3, 3, 256), 5e-3, 0.75, 2.0, 5),  # AlexNet norm2's channel tile
]
IDS = [f"C{c[0][-1]}_n{c[4]}_b{c[2]}" for c in CASES]


def _x(shape, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return (3.0 * torch.randn(shape, generator=gen)).to(device)


def _torch_lrn(x, alpha, beta, k, n):
    """PyTorch's own LRN on the NCHW view of an NHWC tensor."""
    y = F.local_response_norm(x.permute(0, 3, 1, 2), n, alpha=alpha * n, beta=beta, k=k)
    return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_forward_matches_torch_lrn(case):
    shape, alpha, beta, k, n = case
    x = _x(shape, 0)
    torch.testing.assert_close(
        lrn_kernel.lrn_reference(x, alpha, beta, k, n),
        _torch_lrn(x, alpha, beta, k, n), rtol=1e-5, atol=1e-6,
    )


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_autograd(case):
    shape, alpha, beta, k, n = case
    x = _x(shape, 1).requires_grad_(True)
    g = _x(shape, 2)
    (want,) = torch.autograd.grad(_torch_lrn(x, alpha, beta, k, n), x, g)
    got = lrn_kernel.lrn_bwd_reference(x.detach(), g, alpha, beta, k, n)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_tile_covers_the_channel_axis():
    for c, tile in ((1, 4096), (7, 4096), (96, 4096), (256, 2048), (384, 2048)):
        block_r, block_c = lrn_kernel._blocks(c, tile)
        assert block_c >= c and block_c & (block_c - 1) == 0
        assert block_r >= 1 and block_r * block_c <= max(tile, block_c)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernels_match_plain_versions(card, case, dtype):
    shape, alpha, beta, k, n = case
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    atol = 1e-6 if dtype == torch.float32 else 2e-2
    x = _x(shape, 3, card).to(dtype)
    g = _x(shape, 4, card).to(dtype)
    args = (alpha, beta, k, n)
    torch.testing.assert_close(
        lrn_kernel.lrn_forward(x, *args), lrn_kernel.lrn_reference(x, *args),
        rtol=tol, atol=atol,
    )
    torch.testing.assert_close(
        lrn_kernel.lrn_backward(x, g, *args), lrn_kernel.lrn_bwd_reference(x, g, *args),
        rtol=tol, atol=atol,
    )


@pytest.mark.cuda
def test_autograd_on_the_card_launches_both_kernels(card):
    x = _x((2, 5, 5, 96), 5, card).requires_grad_(True)
    f0, b0 = lrn_kernel.lrn_forward.launches, lrn_kernel.lrn_backward.launches
    y = lrn_kernel.lrn(x)
    (dx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    assert (lrn_kernel.lrn_forward.launches - f0, lrn_kernel.lrn_backward.launches - b0) == (1, 1)
    xc = x.detach().cpu().requires_grad_(True)
    yc = lrn_kernel.lrn(xc)
    (dxc,) = torch.autograd.grad(yc, xc, torch.ones_like(yc))
    torch.testing.assert_close(y.detach().cpu(), yc.detach(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dx.cpu(), dxc, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    x = _x((2, 3, 3, 16), 6, card)
    with pytest.raises(ValueError, match="dtype"):
        lrn_kernel.lrn_forward(x.half(), 1e-4, 0.75, 2.0, 5)
    with pytest.raises(ValueError, match="contiguous"):
        lrn_kernel.lrn_forward(x.transpose(1, 2), 1e-4, 0.75, 2.0, 5)
    with pytest.raises(ValueError, match="differ"):
        lrn_kernel.lrn_backward(x, x.bfloat16(), 1e-4, 0.75, 2.0, 5)
