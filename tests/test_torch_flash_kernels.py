"""The Hopper flash-attention kernels (znicz_tpu_torch/ops/kernels/attention.py,
csrc/flash_attention.cu) and their plain versions, without JAX, so the file
runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flash_kernels.py

On the CPU the plain versions are checked against independent formulas:
PyTorch's ``F.scaled_dot_product_attention`` (math path) for the output, a
dense logsumexp for ``lse``, and autograd through a naive softmax attention
for the gradients of ``sum(sin(out)) + sum(w * lse)`` (rtol 1e-5 / 1e-4).
The ``cuda``-marked tests compare each kernel with its plain version on the
same CUDA tensors, with ``dout`` and ``dlse`` drawn at O(1) so that a zero
or misplaced gradient fails: f32 within 1e-4 of the reference's largest
magnitude (the sums run in another order), bf16 within 2e-2 of it (about
one bf16 rounding of ``p`` and ``ds`` before their products).
"""

import math

import pytest
import torch
import torch.nn.functional as F

from znicz_tpu_torch.ops.kernels import attention as fa, cuda_build

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _qkv(b, t, h, d, seed, device="cpu", dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((b, t, h, d), generator=gen).to(device, dtype) for _ in range(3)]


def _naive(q, k, v, causal, scale):
    """Softmax attention written out, differentiable, f64 on the CPU."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        t = q.shape[1]
        s = s.masked_fill(~torch.ones((t, t), dtype=torch.bool).tril(), -torch.inf)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]), v)
    return out, lse.permute(0, 2, 1)


# -- the plain versions, on the CPU -------------------------------------------

@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("t,d", [(48, 16), (37, 32), (20, 64)], ids=["T48", "T37", "T20"])
def test_plain_forward_matches_sdpa(causal, t, d):
    q, k, v = _qkv(2, t, 3, d, seed=t + d)
    scale = 1.0 / math.sqrt(d)
    out, lse = fa.flash_fwd_reference(q, k, v, causal=causal, scale=scale)
    want = F.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in (q, k, v)), is_causal=causal
    ).transpose(1, 2)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scale
    if causal:
        s = s.masked_fill(~torch.ones((t, t), dtype=torch.bool).tril(), -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1).permute(0, 2, 1).float(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("t", [32, 23])
def test_plain_backward_matches_autograd(causal, t):
    """Gradients through the autograd Function (plain versions on the CPU)
    of sum(sin(out)) + sum(w * lse): the lse cotangent folds into delta."""
    q, k, v = _qkv(2, t, 2, 16, seed=t)
    w = torch.randn((2, t, 2), generator=torch.Generator().manual_seed(99))
    scale = 0.25

    def loss(fn, *args):
        out, lse = fn(*args)
        return torch.sin(out).sum() + (w.to(lse.dtype) * lse).sum()

    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(
        loss(lambda *a: fa.flash_attention_lse(*a, causal=causal, scale=scale), *xs), xs
    )
    xd = [x.double().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(loss(lambda *a: _naive(*a, causal, scale), *xd), xd)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r.float(), rtol=1e-4, atol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    q, k, v = _qkv(1, 16, 2, 16, seed=1)
    before = (fa.flash_fwd.launches, fa.flash_dq.launches, fa.flash_dkv.launches)
    xs = [x.requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention(*xs, causal=True, block_q=8, block_k=8)
    torch.autograd.grad(out.sum(), xs)
    assert (fa.flash_fwd.launches, fa.flash_dq.launches, fa.flash_dkv.launches) == before


def test_other_devices_are_refused():
    q = torch.empty((1, 8, 1, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd(q, q, q, causal=True, scale=0.25)


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("flash_attention", build_dir=tmp_path / "kernels")
    assert not (tmp_path / "kernels").exists()


# -- the kernels, on the card -------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_near(name, got, ref, tol):
    scale = float(ref.float().abs().max())
    err = float((got.float() - ref.float()).abs().max())
    assert math.isfinite(err) and err <= tol * max(scale, 1e-6), (name, err, scale)


def _check_all(card, b, t, h, d, causal, dtype, seed):
    q, k, v = _qkv(b, t, h, d, seed, card, dtype)
    gen = torch.Generator().manual_seed(seed + 1)
    dout = torch.randn((b, t, h, d), generator=gen).to(card, dtype)
    dlse = torch.randn((b, t, h), generator=gen).to(card)
    scale = 1.0 / math.sqrt(d)
    out, lse = fa.flash_fwd(q, k, v, causal=causal, scale=scale)
    out_r, lse_r = fa.flash_fwd_reference(q, k, v, causal=causal, scale=scale)
    # both backward passes from the same residuals and delta
    delta = ((dout.float() * out_r.float()).sum(-1) - dlse).contiguous()
    dq = fa.flash_dq(q, k, v, dout, lse_r, delta, causal=causal, scale=scale)
    dk, dv = fa.flash_dkv(q, k, v, dout, lse_r, delta, causal=causal, scale=scale)
    torch.cuda.synchronize()
    refs = (
        fa.flash_dq_reference(q, k, v, dout, lse_r, delta, causal=causal, scale=scale),
        *fa.flash_dkv_reference(q, k, v, dout, lse_r, delta, causal=causal, scale=scale),
    )
    tol = TOL[dtype]
    assert out.dtype == dtype and lse.dtype == torch.float32
    _assert_near("out", out, out_r, tol)
    _assert_near("lse", lse, lse_r, TOL[torch.float32])
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert got.dtype == dtype
        _assert_near(name, got, ref, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_kernels_match_plain_versions(card, d, causal, dtype):
    _check_all(card, 2, 256, 3, d, causal, dtype, seed=d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [1, 37, 200], ids=["T1", "T37", "T200"])
def test_kernels_mask_a_ragged_length(card, t, dtype):
    _check_all(card, 1, t, 2, 64, True, dtype, seed=t)


@pytest.mark.cuda
def test_autograd_on_the_card_launches_all_three_kernels(card):
    q, k, v = _qkv(2, 96, 2, 32, seed=7, device=card)
    w = torch.randn((2, 96, 2), device=card)
    before = (fa.flash_fwd.launches, fa.flash_dq.launches, fa.flash_dkv.launches)

    def grads(xs):
        xs = [x.detach().clone().requires_grad_(True) for x in xs]
        out, lse = fa.flash_attention_lse(*xs, causal=True)
        loss = torch.sin(out).sum() + (w.to(lse.device) * lse).sum()
        return torch.autograd.grad(loss, xs)

    got = grads((q, k, v))
    after = (fa.flash_fwd.launches, fa.flash_dq.launches, fa.flash_dkv.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)
    want = grads([x.cpu() for x in (q, k, v)])
    for g, r in zip(got, want):
        _assert_near("grad", g.cpu(), r, TOL[torch.float32])


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernels_do_not_take(card):
    q, k, v = _qkv(1, 32, 2, 16, seed=3, device=card)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_fwd(q.half(), k.half(), v.half(), causal=True, scale=0.25)
    with pytest.raises(ValueError, match="differ"):
        fa.flash_fwd(q, k.bfloat16(), v, causal=True, scale=0.25)
    with pytest.raises(ValueError, match="head dim"):
        x = torch.randn((1, 32, 2, 48), device=card)
        fa.flash_fwd(x, x, x, causal=True, scale=0.25)
    with pytest.raises(ValueError, match="contiguous"):
        x = q.transpose(1, 2)
        fa.flash_fwd(x, x, x, causal=True, scale=0.25)
    with pytest.raises(ValueError, match="float32"):
        lse = torch.zeros((1, 32, 2), device=card, dtype=torch.bfloat16)
        fa.flash_dq(q, k, v, q, lse, lse, causal=True, scale=0.25)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd(q, k.cpu(), v, causal=True, scale=0.25)
