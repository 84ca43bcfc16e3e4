"""The Hopper flash-attention kernels (znicz_tpu_torch/ops/kernels/attention.py,
csrc/flash_attention.cu) and their plain versions, without JAX, so the file
runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flash_kernels.py

On the CPU the plain versions are checked against independent formulas:
PyTorch's ``F.scaled_dot_product_attention`` (math path) for the output, a
dense logsumexp for ``lse``, and autograd through a naive softmax attention
for the gradients of ``sum(sin(out)) + sum(w * lse)`` (rtol 1e-5 / 1e-4),
and ``chip_smoke.py``'s rates and bounds at the LM slice's shape.
The ``cuda``-marked tests compare each kernel with its plain version on the
same CUDA tensors, with ``dout`` and ``dlse`` drawn at O(1) so that a zero
or misplaced gradient fails: f32 within 1e-4 of the reference's largest
magnitude (the sums run in another order), bf16 within 2e-2 of it (about
one bf16 rounding of ``p`` and ``ds`` before their products).  They also
hold the bf16 kernels and the f32 ones (3xTF32), forward, dQ and dK/dV, all
on the tensor cores, to bitwise-equal repeat launches, ragged lengths at the
narrowest and the register-heavy head dims (16, 128, 256), the forwards to a
negative scale, and the refusal of a view whose data is not 16-byte aligned.
The f32 forward, dQ and dK/dV are also held against float64: their error
within 10 times the f32 plain version's.  The autograd layer's
zero-padding of a head dim between the kernels' is checked on the CPU and
on the card, as are the batch slices of a B*H above the grid's 65535, the
flash path that ``attention="auto"`` takes at head dim 256 and the dense
one above it.
"""

import importlib.util
import math
import pathlib

import numpy as np
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
    """Softmax attention written out, differentiable, in the inputs' dtype
    (f64 in these tests) and on their device."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        t = q.shape[1]
        s = s.masked_fill(~torch.ones((t, t), dtype=torch.bool, device=s.device).tril(),
                          -torch.inf)
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


def test_autograd_layer_pads_the_head_dim_and_slices_back(monkeypatch):
    """A head dim between the kernels' reaches the wrappers zero-padded to
    the next one, contiguous; the caller gets its own head dim back, with
    the scale of the true head dim, equal to the unpadded plain version."""
    seen = []
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        real = getattr(fa, name)

        def spy(*args, _real=real, _name=name, **kw):
            seen.append((_name, tuple(args[0].shape), all(a.is_contiguous() for a in args)))
            return _real(*args, **kw)

        monkeypatch.setattr(fa, name, spy)
    q, k, v = _qkv(2, 24, 3, 48, seed=4)
    xs = [x.transpose(1, 2).contiguous().transpose(1, 2).requires_grad_(True) for x in (q, k, v)]
    assert not xs[0].is_contiguous()
    out, lse = fa.flash_attention_lse(*xs, causal=True)
    w = torch.randn((2, 24, 3), generator=torch.Generator().manual_seed(5))
    got = torch.autograd.grad(torch.sin(out).sum() + (w * lse).sum(), xs)
    assert [s[0] for s in seen] == ["flash_fwd", "flash_dq", "flash_dkv"]
    assert all(shape == (2, 24, 3, 64) and contiguous for _, shape, contiguous in seen)
    assert out.shape == (2, 24, 3, 48) and all(g.shape == (2, 24, 3, 48) for g in got)
    xd = [x.detach().double().requires_grad_(True) for x in (q, k, v)]
    want_out, want_lse = _naive(*xd, True, 1.0 / math.sqrt(48))
    want = torch.autograd.grad(torch.sin(want_out).sum() + (w.double() * want_lse).sum(), xd)
    torch.testing.assert_close(out, want_out.float(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, want_lse.float(), rtol=1e-5, atol=1e-5)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r.float(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("d,want", [(8, 16), (16, 16), (48, 64), (96, 128), (128, 128), (192, 256),
                                    (256, 256), (257, None)])
def test_kernel_head_dim(d, want):
    assert fa.kernel_head_dim(d) == want


@pytest.mark.parametrize("b,h", [(1, 8), (8192, 8), (8193, 8), (3, 30000), (70000, 1)])
def test_batch_slices_keep_each_launch_inside_the_grid(b, h):
    """A launch holds at most 65535 (batch, head) pairs; the slices cover the
    batch once, in order."""
    slices = fa._batch_slices(torch.empty((b, 1, h, 16), device="meta"))
    assert slices[0].start == 0 and slices[-1].stop == b
    assert all(a.stop == c.start for a, c in zip(slices, slices[1:]))
    assert all((sl.stop - sl.start) * h <= fa.MAX_GRID_Y for sl in slices)
    assert len(slices) == -(-b * h // (fa.MAX_GRID_Y // h * h))


# -- chip_smoke.py's bounds, on the CPU ----------------------------------------

@pytest.fixture(scope="module")
def chip_smoke():
    """chip_smoke.py as a module (its top level imports no torch or card)."""
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_bounds", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dname,rate", [("float32", 495e12 / 3), ("bfloat16", 989e12)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["flash_fwd", "flash_dq", "flash_dkv"])
def test_flash_rate_is_the_rate_of_each_kernels_products(chip_smoke, name, dname, rate):
    """Every f32 flash kernel, the forward too, takes its products in 3xTF32:
    three TF32 products for one; the bf16 ones in bf16."""
    assert chip_smoke._flash_rate(name, dname) == rate


@pytest.mark.parametrize("name,dname,fma,want", [
    ("flash_fwd", "float32", False, 0.4167),
    ("flash_dq", "float32", False, 0.6250),
    ("flash_dkv", "float32", False, 0.8334),
    ("flash_fwd", "float32", True, 1.0262),
    ("flash_dq", "float32", True, 1.5392),
    ("flash_dkv", "float32", True, 2.0523),
    ("flash_fwd", "bfloat16", False, 0.0695),
    ("flash_dq", "bfloat16", False, 0.1043),
    ("flash_dkv", "bfloat16", False, 0.1390),
], ids=lambda x: str(x))
def test_flash_bounds_at_the_lm_slice(chip_smoke, name, dname, fma, want):
    """At [16, 2048, 8, 64] causal, 268,566,528 live (q, k) pairs: the f32
    kernels' bounds at the 3xTF32 rate (the forward's 68.75 GFLOP in 0.4167
    ms), their f32-FMA bounds beside them, and the bf16 ones; all bound by
    operations."""
    esize = 4 if dname == "float32" else 2
    rate = (lambda kernel, dtype: chip_smoke.PEAK_FLOPS[dtype]) if fma else chip_smoke._flash_rate
    ms, by = chip_smoke._flash_bounds(16, 2048, 8, 64, True, esize, dname, rate=rate)[name]
    assert round(ms, 4) == want and by == "operations"


@pytest.mark.parametrize("name,dname,want", [
    ("flash_fwd", "float32", 0.4167),
    ("flash_dq", "float32", 0.6250),
    ("flash_dkv", "float32", 0.8334),
    ("flash_fwd", "bfloat16", 0.0695),
    ("flash_dq", "bfloat16", 0.1043),
    ("flash_dkv", "bfloat16", 0.1390),
], ids=lambda x: str(x))
def test_flash_bounds_at_head_dim_256(chip_smoke, name, dname, want):
    """[16, 2048, 2, 256] causal has the LM slice's B*H*D (and so its live
    pairs times D and its bytes): the same bounds, by operations."""
    esize = 4 if dname == "float32" else 2
    ms, by = chip_smoke._flash_bounds(16, 2048, 2, 256, True, esize, dname)[name]
    assert round(ms, 4) == want and by == "operations"
    assert chip_smoke.FLASH_TIMED == ("slice", "d256")
    cases = {case[0]: case[1:] for case in chip_smoke.FLASH_CASES}
    assert cases["d256"] == (16, 2048, 2, 256, True)


def test_lm_bigram_memo_serves_the_same_draws(chip_smoke, monkeypatch):
    """Phase 35 builds the LM at phase 8's seed and lengths: the memo serves
    the same chain and sequences as drawing them, and leaves the "datasets"
    stream where drawing would."""
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.models import transformer_lm as lm

    monkeypatch.setattr(lm, "_bigram_chain", lm._bigram_chain)  # restored after the test
    monkeypatch.setattr(lm, "_bigram_sequences", lm._bigram_sequences)

    def draw():
        prng.seed_all(7)
        chain = lm._bigram_chain(16)
        out = (chain, lm._bigram_sequences(chain, 5, 12), lm._bigram_sequences(chain, 3, 12))
        return out, prng.get("datasets").integers(0, 1 << 30, (4,))

    try:
        want = draw()
        tally = chip_smoke._memoize_bigrams(prng, lm)
        got = [draw(), draw()]
    finally:
        prng.reset()
    assert (tally["draws"], tally["reuses"]) == (3, 3)
    for arrays, after in got:
        for a, b in zip(arrays, want[0]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(after, want[1])


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
@pytest.mark.parametrize("t", [77, 200], ids=["T77", "T200"])
def test_kernels_mask_a_ragged_length_at_head_dim_128(card, t):
    _check_all(card, 1, t, 2, 128, True, torch.bfloat16, seed=t + 128)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("t", [77, 200], ids=["T77", "T200"])
@pytest.mark.parametrize("d", [16, 128])
def test_bf16_forward_masks_a_ragged_length(card, d, t, causal):
    """The tensor-core forward at a ragged T: ``out`` within the bf16
    tolerance, ``lse`` within the f32 one of the reference's largest magnitude."""
    q, k, v = _qkv(2, t, 3, d, seed=t + d, device=card, dtype=torch.bfloat16)
    kw = dict(causal=causal, scale=1.0 / math.sqrt(d))
    out, lse = fa.flash_fwd(q, k, v, **kw)
    out_r, lse_r = fa.flash_fwd_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_near("out", out, out_r, TOL[torch.bfloat16])
    _assert_near("lse", lse, lse_r, TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [64, 256])
def test_bf16_forward_takes_a_negative_scale(card, causal, d):
    """The kernel's row max is taken on q.k with q's signs flipped when the
    scale is negative (in Q's held fragments at D 64, in its shared-memory
    rows at D 256): the softmax must still be the reference's."""
    q, k, v = _qkv(1, 130, 2, d, seed=8, device=card, dtype=torch.bfloat16)
    kw = dict(causal=causal, scale=-1.0 / math.sqrt(d))
    out, lse = fa.flash_fwd(q, k, v, **kw)
    out_r, lse_r = fa.flash_fwd_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_near("out", out, out_r, TOL[torch.bfloat16])
    _assert_near("lse", lse, lse_r, TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_bf16_forward_launches_are_bitwise_repeatable(card, causal):
    """One owner per q tile and no atomics: two launches on the same inputs
    give the same bits."""
    q, k, v = _qkv(2, 200, 3, 64, seed=6, device=card, dtype=torch.bfloat16)
    runs = [fa.flash_fwd(q, k, v, causal=causal, scale=0.125) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    assert float(runs[0][0].float().abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_bf16_backward_launches_are_bitwise_repeatable(card, causal):
    """One owner per output tile and no atomics: two launches on the same
    inputs give the same bits."""
    q, k, v = _qkv(2, 200, 3, 64, seed=5, device=card, dtype=torch.bfloat16)
    dout = torch.randn((2, 200, 3, 64), device=card).to(torch.bfloat16)
    lse = torch.randn((2, 200, 3), device=card) + 5.0
    delta = torch.randn((2, 200, 3), device=card)
    kw = dict(causal=causal, scale=0.125)
    dq = [fa.flash_dq(q, k, v, dout, lse, delta, **kw) for _ in range(2)]
    dkv = [fa.flash_dkv(q, k, v, dout, lse, delta, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(dq[0], dq[1])
    assert torch.equal(dkv[0][0], dkv[1][0]) and torch.equal(dkv[0][1], dkv[1][1])
    assert float(dq[0].float().abs().max()) > 0 and float(dkv[0][0].float().abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_a_misaligned_view_is_refused(card, kernel):
    """A contiguous view 2 bytes into its storage cannot feed 16-byte copies."""
    b, t, h, d = 1, 32, 2, 64
    n = b * t * h * d
    q, k, v = _qkv(b, t, h, d, seed=9, device=card, dtype=torch.bfloat16)
    storage = torch.zeros((n + 1,), device=card, dtype=torch.bfloat16)
    shifted = storage[1:].view(b, t, h, d)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    lse = torch.zeros((b, t, h), device=card)
    kw = dict(causal=True, scale=0.125)
    call = {  # the view as the first and as the last of the kernel's tensors
        "fwd": lambda first, last: fa.flash_fwd(first, k, last, **kw),
        "dq": lambda first, last: fa.flash_dq(first, k, v, last, lse, lse, **kw),
        "dkv": lambda first, last: fa.flash_dkv(first, k, v, last, lse, lse, **kw),
    }[kernel]
    for args in ((shifted, q), (q, shifted)):
        with pytest.raises(ValueError, match="16-byte"):
            call(*args)


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


def _flash_bwd_float64(q, k, v, dout, lse, delta, causal, scale):
    """dq, dk, dv in float64 from the same (f32) inputs: the answer that the
    f32 kernels and the f32 plain versions both approximate."""
    q, k, v, dout, lse, delta = (x.double() for x in (q, k, v, dout, lse, delta))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.exp(s - lse.permute(0, 2, 1)[..., None])
    if causal:
        p = p.tril()
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dout, v) - delta.permute(0, 2, 1)[..., None])
    return (scale * torch.einsum("bhqk,bkhd->bqhd", ds, k),
            scale * torch.einsum("bhqk,bqhd->bkhd", ds, q),
            torch.einsum("bhqk,bqhd->bkhd", p, dout))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [37, 77, 200], ids=["T37", "T77", "T200"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_f32_backward_keeps_f32_accuracy(card, d, causal, t):
    """The 3xTF32 dQ and dK/dV against float64, beside the f32 plain version
    (full f32 products) on the same inputs: within 10 times its error (one
    TF32 product would be ~1000 times), and within the f32 tolerance of the
    plain version."""
    q, k, v = _qkv(2, t, 3, d, seed=t + d, device=card)
    gen = torch.Generator().manual_seed(t)
    dout = torch.randn((2, t, 3, d), generator=gen).to(card)
    kw = dict(causal=causal, scale=1.0 / math.sqrt(d))
    out_r, lse_r = fa.flash_fwd_reference(q, k, v, **kw)
    delta = ((dout * out_r).sum(-1) - torch.randn((2, t, 3), generator=gen).to(card)).contiguous()
    args = (q, k, v, dout, lse_r, delta)
    got = (fa.flash_dq(*args, **kw), *fa.flash_dkv(*args, **kw))
    plain = (fa.flash_dq_reference(*args, **kw), *fa.flash_dkv_reference(*args, **kw))
    exact = _flash_bwd_float64(*args, **kw)
    torch.cuda.synchronize()
    for name, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact):
        err_kernel = float((g.double() - e).abs().max())
        err_plain = float((p.double() - e).abs().max())
        assert err_kernel <= 10 * err_plain, (name, err_kernel, err_plain)
        _assert_near(name, g, p, TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_f32_backward_launches_are_bitwise_repeatable(card, causal):
    q, k, v = _qkv(2, 200, 3, 64, seed=15, device=card)
    dout = torch.randn((2, 200, 3, 64), device=card)
    lse = torch.randn((2, 200, 3), device=card) + 5.0
    delta = torch.randn((2, 200, 3), device=card)
    kw = dict(causal=causal, scale=0.125)
    dq = [fa.flash_dq(q, k, v, dout, lse, delta, **kw) for _ in range(2)]
    dkv = [fa.flash_dkv(q, k, v, dout, lse, delta, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(dq[0], dq[1])
    assert torch.equal(dkv[0][0], dkv[1][0]) and torch.equal(dkv[0][1], dkv[1][1])
    assert float(dq[0].abs().max()) > 0 and float(dkv[0][0].abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 37, 65, 77, 200], ids=["T1", "T37", "T65", "T77", "T200"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_f32_forward_keeps_f32_accuracy(card, d, causal, t):
    """The 3xTF32 forward's out and lse against float64, beside the f32
    plain version on the same inputs: within 10 times its error (or 10 f32
    ulps of the largest magnitude where the plain version is exact, as at
    T 1: one key a row, p = 1), and within the f32 tolerance of the plain
    version.  T 1 and T 65 leave all but one row of the last q tile wholly
    masked (rows past T: zero mass, never written), T 37 and 77 a ragged
    tile, T 200 several."""
    q, k, v = _qkv(2, t, 3, d, seed=t + 3 * d, device=card)
    kw = dict(causal=causal, scale=1.0 / math.sqrt(d))
    got = fa.flash_fwd(q, k, v, **kw)
    plain = fa.flash_fwd_reference(q, k, v, **kw)
    exact = _naive(q.double(), k.double(), v.double(), **kw)  # float64
    torch.cuda.synchronize()
    for name, g, p, e in zip(("out", "lse"), got, plain, exact):
        assert g.shape == p.shape and g.dtype == torch.float32
        err_kernel = float((g.double() - e).abs().max())
        err_plain = float((p.double() - e).abs().max())
        ulp = 2.0**-23 * float(e.abs().max())
        assert err_kernel <= 10 * max(err_plain, ulp), (name, err_kernel, err_plain)
        _assert_near(name, g, p, TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [64, 256])
def test_f32_forward_takes_a_negative_scale(card, causal, d):
    """The row max is taken over s.scale: with a negative scale it is the
    scaled minimum of the products, and the softmax must still be the
    reference's (on 64-row tiles at D 64, 32-row ones at D 256)."""
    q, k, v = _qkv(1, 130, 2, d, seed=18, device=card)
    kw = dict(causal=causal, scale=-1.0 / math.sqrt(d))
    out, lse = fa.flash_fwd(q, k, v, **kw)
    out_r, lse_r = fa.flash_fwd_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_near("out", out, out_r, TOL[torch.float32])
    _assert_near("lse", lse, lse_r, TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_f32_forward_launches_are_bitwise_repeatable(card, causal, d):
    """One owner per q tile and no atomics: two launches on the same inputs
    give the same bits (the split K and V at D 64, raw ones at D 128)."""
    q, k, v = _qkv(2, 200, 3, d, seed=16, device=card)
    runs = [fa.flash_fwd(q, k, v, causal=causal, scale=0.125) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    assert float(runs[0][0].abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [48, 96])
def test_a_padded_head_dim_runs_the_kernels(card, d, dtype):
    """flash_attention_lse at a head dim between the kernels' (and on
    non-contiguous views) launches each kernel once and matches autograd
    through the plain forward on the same tensors."""
    q, k, v = _qkv(2, 200, 3, d, seed=d, device=card, dtype=dtype)
    w = torch.randn((2, 200, 3), device=card)
    before = (fa.flash_fwd.launches, fa.flash_dq.launches, fa.flash_dkv.launches)

    def grads(fn, xs):
        xs = [x.detach().transpose(1, 2).contiguous().transpose(1, 2).requires_grad_(True)
              for x in xs]
        out, lse = fn(*xs)
        loss = torch.sin(out.float()).sum() + (w * lse).sum()
        return (out.detach(), lse.detach(), *torch.autograd.grad(loss, xs))

    got = grads(lambda *xs: fa.flash_attention_lse(*xs, causal=True), (q, k, v))
    after = (fa.flash_fwd.launches, fa.flash_dq.launches, fa.flash_dkv.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)
    scale = 1.0 / math.sqrt(d)
    want = grads(lambda *xs: fa.flash_fwd_reference(*xs, causal=True, scale=scale), (q, k, v))
    for name, g, r in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        assert g.shape == r.shape
        _assert_near(name, g, r, TOL[torch.float32] if name == "lse" else TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_b_h_above_the_grid_is_split_over_the_batch(card, dtype):
    """B*H = 65600 (> 65535): each wrapper launches its kernel twice, on two
    batch slices, and matches its plain version."""
    b, t, h, d = 4100, 24, 16, 16
    q, k, v = _qkv(b, t, h, d, seed=11, device=card, dtype=dtype)
    dout = torch.randn((b, t, h, d), device=card).to(dtype)
    kw = dict(causal=True, scale=0.25)
    before = (fa.flash_fwd.launches, fa.flash_dq.launches, fa.flash_dkv.launches)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = ((dout.float() * out.float()).sum(-1)).contiguous()
    dq = fa.flash_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = fa.flash_dkv(q, k, v, dout, lse, delta, **kw)
    torch.cuda.synchronize()
    after = (fa.flash_fwd.launches, fa.flash_dq.launches, fa.flash_dkv.launches)
    assert tuple(a - c for a, c in zip(after, before)) == (2, 2, 2)
    out_r, lse_r = fa.flash_fwd_reference(q, k, v, **kw)
    _assert_near("out", out, out_r, TOL[dtype])
    _assert_near("lse", lse, lse_r, TOL[torch.float32])
    refs = (fa.flash_dq_reference(q, k, v, dout, lse, delta, **kw),
            *fa.flash_dkv_reference(q, k, v, dout, lse, delta, **kw))
    for name, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        _assert_near(name, g, r, TOL[dtype])


@pytest.mark.cuda
def test_head_dims_above_128_take_the_dense_path_under_auto(card):
    """On the card, attention="auto" resolves to flash at head dims 256 and
    64 and to the dense path at 512, above the kernels; flash attention at
    512 raises, naming its ROADMAP item."""
    from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
    from znicz_tpu_torch.workflow.transformer import TransformerLMWorkflow

    loader = FullBatchLoader({"train": torch.zeros((2, 512), dtype=torch.int32).numpy()},
                             minibatch_size=2)
    for n_heads, resolved in ((1, None), (2, fa.flash_attention), (8, fa.flash_attention)):
        wf = TransformerLMWorkflow(loader, vocab=8, d_model=512, n_heads=n_heads,
                                   attention="auto", device=card)  # head dim 512, 256, 64
        assert wf._attention_fn_base() is resolved
    x = torch.zeros((1, 64, 1, 512), device=card)
    with pytest.raises(NotImplementedError, match="ROADMAP.md B7"):
        fa.flash_attention(x, x, x, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [1, 33, 77, 200], ids=["T1", "T33", "T77", "T200"])
def test_head_dim_256_masks_a_ragged_length_and_repeats_bitwise(card, t, dtype):
    """The D-256 kernels (the bf16 ones on 64-row tiles, the f32 ones on
    32-row tiles, dK/dV over two column halves) at ragged lengths, causal:
    within the tolerances of their plain versions, and a second launch of
    each bitwise equal to the first."""
    _check_all(card, 2, t, 2, 256, True, dtype, seed=t + 256)
    q, k, v = _qkv(2, t, 2, 256, seed=t, device=card, dtype=dtype)
    dout = torch.randn((2, t, 2, 256), device=card).to(dtype)
    lse = torch.randn((2, t, 2), device=card) + 5.0
    delta = torch.randn((2, t, 2), device=card)
    kw = dict(causal=True, scale=0.0625)
    fwd = [fa.flash_fwd(q, k, v, **kw) for _ in range(2)]
    dq = [fa.flash_dq(q, k, v, dout, lse, delta, **kw) for _ in range(2)]
    dkv = [fa.flash_dkv(q, k, v, dout, lse, delta, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(fwd[0][0], fwd[1][0]) and torch.equal(fwd[0][1], fwd[1][1])
    assert torch.equal(dq[0], dq[1])
    assert torch.equal(dkv[0][0], dkv[1][0]) and torch.equal(dkv[0][1], dkv[1][1])
    assert float(dkv[0][1].float().abs().max()) > 0

