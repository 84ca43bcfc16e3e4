"""The Hopper Kohonen and RBM kernels (znicz_tpu_torch/ops/kernels/kohonen.py
and rbm.py, csrc/kohonen.cu and rbm.cu) and their plain versions, without
JAX, so the file runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_unsupervised_kernels.py

On the CPU: the PyTorch twin of the kernels' counter-based generator
(Philox4x32-10 known answers, determinism, the 24-bit grid, moments) and
the plain versions against formulas written out in float64 numpy (rtol
1e-5 of the largest magnitude: float32 sums in another order).

The ``cuda``-marked tests compare each kernel with its plain version on the
same CUDA tensors:

- Kohonen: ``num``, ``den`` and the updated weights within 1e-5 of the
  largest magnitude (f32 sums in another order), the plain version run with
  the kernel's winners where a near-tie picked another unit (the count of
  such samples is asserted small); two launches are bitwise equal.
- RBM: with injected uniforms, the statistics within 1e-4 of the largest
  magnitude when no sampled unit flipped, and the flips (a draw ``u`` that
  lands between the kernel's and cuBLAS's ``p``) at most 1e-5 of the draws;
  the in-kernel generator bitwise equal to the twin; the same seed gives
  bitwise-equal outputs and another seed other ones; the saturated regime
  exact; Bernoulli frequencies within 5 sigma.
"""

import math

import numpy as np
import pytest
import torch

from znicz_tpu_torch.ops import kohonen as kh
from znicz_tpu_torch.ops.kernels import cuda_build, kohonen as khk, rbm as rbk

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False


def _near(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max()
    assert math.isfinite(err) and err <= rtol * scale, (err, scale)


# -- the generator's PyTorch twin, on the CPU ----------------------------------

@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
], ids=["zeros", "ones", "pi"])
def test_philox_known_answers(ctr, key, want):
    """The Random123 known-answer vectors of Philox4x32-10."""
    words = rbk.philox4x32_10([torch.tensor([c], dtype=torch.int64) for c in ctr], key)
    assert tuple(int(w) for w in words) == want


def test_twin_uniforms_are_deterministic_on_the_24_bit_grid():
    a = rbk.philox_uniforms(11, 0, (3, 50, 40))
    assert a.dtype == torch.float32 and a.shape == (3, 50, 40)
    assert torch.equal(a, rbk.philox_uniforms(11, 0, (3, 50, 40)))
    assert not torch.equal(a, rbk.philox_uniforms(12, 0, (3, 50, 40)))
    assert not torch.equal(a, rbk.philox_uniforms(11, 1, (3, 50, 40)))
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    assert torch.equal(a * 2**24, torch.floor(a * 2**24))
    # the flat index is the counter: a prefix of a longer draw is the same
    assert torch.equal(rbk.philox_uniforms(11, 0, (600,)), a.reshape(-1)[:600])


def test_twin_uniform_moments():
    n = 200_000
    u = rbk.philox_uniforms(3, 1, (n,)).double()
    assert abs(float(u.mean()) - 0.5) < 5 * math.sqrt(1 / 12 / n)
    assert abs(float(u.var()) - 1 / 12) < 5 * math.sqrt(1 / 180 / n)
    # neighbouring counters are uncorrelated
    c = float(((u[1:] - 0.5) * (u[:-1] - 0.5)).mean()) * 12
    assert abs(c) < 5 / math.sqrt(n)


def test_chain_uniforms_streams_and_shapes():
    uh, uv = rbk.chain_uniforms(9, 4, 7, 5, 2)
    assert uh.shape == (3, 4, 5) and uv.shape == (2, 4, 7)
    assert torch.equal(uh, rbk.philox_uniforms(9, rbk.HIDDEN, (3, 4, 5)))
    assert torch.equal(uv, rbk.philox_uniforms(9, rbk.VISIBLE, (2, 4, 7)))


# -- the plain versions against formulas written out ----------------------------

def _kohonen_case(b, side, f, n_valid, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(side * side, f)) * 0.1).astype(np.float32)
    x = rng.normal(size=(b, f)).astype(np.float32)
    mask = (np.arange(b) < n_valid).astype(np.float32)
    coords = kh.grid_coords(side, side, device="cpu")
    d2m = khk.pairwise_d2(coords)
    return [torch.from_numpy(a).to(device) for a in (w, x, mask)] + [d2m.to(device), coords]


def test_kohonen_plain_version_matches_numpy():
    w, x, mask, d2m, coords = _kohonen_case(70, 3, 20, 61, 1)
    sigma, lr = 1.2, 0.4
    wn, xn, mn = (t.double().numpy() for t in (w, x, mask))
    win = np.argmax(xn @ wn.T - 0.5 * (wn * wn).sum(1), axis=1)
    d2 = ((coords.numpy()[win][:, None, :] - coords.numpy()[None, :, :]) ** 2).sum(-1)
    h = np.exp(-d2 / (2 * sigma**2)) * mn[:, None]
    num, den = h.T @ xn, h.sum(0)[:, None]
    got_num, got_den = khk.accumulate_reference(w, x, mask, d2m, sigma)
    _near(got_num.numpy(), num, 1e-5)
    _near(got_den.numpy(), den, 1e-5)
    new = khk.train_step({"weights": w}, x, coords, learning_rate=lr, sigma=sigma, mask=mask)
    want = np.where(den > 1e-8, wn + lr * (num / np.maximum(den, 1e-12) - wn), wn)
    _near(new["weights"].numpy(), want, 1e-5)
    # the winners are the closest units
    dist = ((xn[:, None, :] - wn[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(win, dist.argmin(1))


def _rbm_case(b, v, h, n_valid, seed, device="cpu", bias=0.1):
    rng = np.random.default_rng(seed)
    params = {"weights": rng.normal(0, 0.5 / math.sqrt(v), (v, h)).astype(np.float32),
              "vbias": rng.normal(0, bias, v).astype(np.float32),
              "hbias": rng.normal(0, bias, h).astype(np.float32)}
    v0 = (rng.uniform(size=(b, v)) > 0.5).astype(np.float32)
    mask = (np.arange(b) < n_valid).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return {k: to(a) for k, a in params.items()}, to(v0), to(mask)


def test_rbm_plain_version_matches_numpy():
    params, v0, mask = _rbm_case(30, 40, 12, 26, 2)
    cd_k, seed = 2, 4
    uh, uv = rbk.chain_uniforms(seed, 30, 40, 12, cd_k)
    w, vb, hb = (params[k].double().numpy() for k in ("weights", "vbias", "hbias"))
    vn, mn = v0.double().numpy(), mask.double().numpy()
    sig = lambda z: 1 / (1 + np.exp(-z))  # noqa: E731
    h0p = sig(vn @ w + hb)
    hs = (uh[0].double().numpy() < h0p).astype(float)
    for k in range(cd_k):
        vp = sig(hs @ w.T + vb)
        vs = (uv[k].double().numpy() < vp).astype(float)
        hp = sig(vs @ w + hb)
        hs = (uh[k + 1].double().numpy() < hp).astype(float)
    m = mn[:, None]
    want = ((vn * m).T @ h0p - (vp * m).T @ hp, ((vn - vp) * m).sum(0), ((h0p - hp) * m).sum(0),
            np.array([(((vn - vp) ** 2).mean(1) * mn).sum(), mn.sum()]))
    got = rbk.statistics(params, v0, mask, seed, cd_k=cd_k)
    for g, w_ in zip(got, want):
        _near(g.numpy(), w_, 1e-5)
    new, err = rbk.cd_step(params, v0, seed, learning_rate=0.3, cd_k=cd_k, mask=mask)
    _near(new["weights"].numpy(), w + 0.3 / mn.sum() * want[0], 1e-5)
    np.testing.assert_allclose(float(err), want[3][0] / mn.sum(), rtol=1e-5)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    before = (khk.accumulate.launches, rbk.statistics.launches)
    w, x, mask, d2m, coords = _kohonen_case(20, 2, 8, 20, 3)
    khk.train_step({"weights": w}, x, coords, learning_rate=0.5, sigma=1.0)
    params, v0, mask = _rbm_case(10, 12, 5, 10, 3)
    rbk.cd_step(params, v0, 0, learning_rate=0.1)
    assert (khk.accumulate.launches, rbk.statistics.launches) == before


def test_other_devices_are_refused():
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        khk.accumulate(torch.empty((4, 8), device="meta"), x, torch.empty(4, device="meta"),
                       torch.empty((4, 4), device="meta"), 1.0)
    params = {"weights": torch.empty((8, 3), device="meta"),
              "vbias": torch.empty(8, device="meta"), "hbias": torch.empty(3, device="meta")}
    with pytest.raises(ValueError, match="CUDA"):
        rbk.statistics(params, x, torch.empty(4, device="meta"), 0, cd_k=1)


@pytest.mark.parametrize("name", ["kohonen", "rbm"])
def test_missing_nvcc_raises(tmp_path, monkeypatch, name):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build(name, build_dir=tmp_path / "kernels")
    assert not (tmp_path / "kernels").exists()


# -- the kernels, on the card -------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


KOHONEN_CASES = [  # (B, map side, F, valid rows)
    (100, 8, 784, 93),   # the model's shape, a masked tail
    (600, 6, 256, 500),  # several batch chunks, masked
    (300, 6, 64, 300),   # no multiple of any tile
    (33, 5, 50, 33),     # one ragged tile everywhere
    (256, 32, 96, 250),  # a 32 x 32 map
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,side,f,n_valid", KOHONEN_CASES,
                         ids=[f"b{c[0]}_m{c[1]}x{c[1]}_f{c[2]}" for c in KOHONEN_CASES])
def test_kohonen_kernel_matches_plain_version(card, b, side, f, n_valid):
    w, x, mask, d2m, coords = _kohonen_case(b, side, f, n_valid, b + f, card)
    sigma, lr = 1.7, 0.35
    win = torch.empty((b,), dtype=torch.int32, device=card)
    before = khk.accumulate.launches
    num, den = khk.accumulate(w, x, mask, d2m, sigma, winners_out=win)
    num2, den2 = khk.accumulate(w, x, mask, d2m, sigma)
    torch.cuda.synchronize()
    assert khk.accumulate.launches - before == 2
    assert torch.equal(num, num2) and torch.equal(den, den2)  # no atomics: the same bits
    plain_win = kh.winners({"weights": w}, x)
    assert int((plain_win != win).sum()) <= max(1, b // 1000)  # near-ties only
    ref_num, ref_den = khk.accumulate_reference(w, x, mask, d2m, sigma, win=win)
    _near(num.cpu(), ref_num.cpu(), 1e-5)
    _near(den.cpu(), ref_den.cpu(), 1e-5)
    new = khk._apply_update(w, num, den, lr)
    ref = khk._apply_update(w, ref_num, ref_den, lr)
    _near(new.cpu(), ref.cpu(), 1e-5)


@pytest.mark.cuda
def test_kohonen_kernel_refuses_what_it_does_not_take(card):
    w, x, mask, d2m, _ = _kohonen_case(10, 2, 8, 10, 0, card)
    with pytest.raises(ValueError, match="float32"):
        khk.accumulate(w.double(), x.double(), mask, d2m, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        khk.accumulate(w, x.t().contiguous().t(), mask, d2m, 1.0)
    with pytest.raises(ValueError, match="d2m"):
        khk.accumulate(w, x, mask, d2m[:2, :2].contiguous(), 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        khk.accumulate(w, x.cpu(), mask, d2m, 1.0)


def _flips(got, ref, u):
    """Sampled units whose draw differs between two probability tensors."""
    return int(((u < got) != (u < ref)).sum())


RBM_CASES = [  # (B, V, H, cd_k, valid rows)
    (100, 784, 128, 1, 93),  # the model's shape, a masked tail
    (70, 50, 33, 3, 64),     # ragged tiles, k 3
    (300, 200, 1024, 2, 300),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,v,h,cd_k,n_valid", RBM_CASES,
                         ids=[f"b{c[0]}_{c[1]}x{c[2]}_k{c[3]}" for c in RBM_CASES])
def test_rbm_kernel_matches_plain_version(card, b, v, h, cd_k, n_valid):
    params, v0, mask = _rbm_case(b, v, h, n_valid, b + v, card)
    seed = 17
    uh, uv = rbk.chain_uniforms(seed, b, v, h, cd_k, card)
    draws = uh[:1].numel() + uv.numel() + (cd_k - 1) * uh[0].numel()
    for uniforms in ((uh, uv), None):  # injected, then the kernel's own draws
        chain, ref_chain = {}, {}
        before = rbk.statistics.launches
        got = rbk.statistics(params, v0, mask, seed, cd_k=cd_k, uniforms=uniforms, chain=chain)
        torch.cuda.synchronize()
        assert rbk.statistics.launches - before == 1
        ref = rbk.statistics_reference(params, v0, mask, uh, uv, cd_k=cd_k, chain=ref_chain)
        flips = (_flips(chain["h0p"], ref_chain["h0p"], uh[0])
                 + _flips(chain["vp"], ref_chain["vp"], uv[cd_k - 1]))
        assert flips <= 1e-5 * draws + 1
        if flips == 0:
            for g, r in zip(got, ref):
                _near(g.cpu(), r.cpu(), 1e-4)


@pytest.mark.cuda
def test_rbm_in_kernel_generator_is_the_twin(card):
    for seed, stream, shape in ((0, 0, (5000,)), (123456, 1, (3, 70, 33)), (2**31 + 5, 0, (77,))):
        got = rbk.uniforms_cuda(seed, stream, shape, card)
        assert torch.equal(got.cpu(), rbk.philox_uniforms(seed, stream, shape))


@pytest.mark.cuda
def test_rbm_kernel_seeds(card):
    params, v0, mask = _rbm_case(64, 100, 48, 64, 5, card)
    a = rbk.statistics(params, v0, mask, 7, cd_k=1)
    b = rbk.statistics(params, v0, mask, 7, cd_k=1)
    c = rbk.statistics(params, v0, mask, 8, cd_k=1)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


@pytest.mark.cuda
def test_rbm_kernel_saturated_regime_is_exact(card):
    v, h = 128, 64
    params = {"weights": torch.zeros((v, h), device=card),
              "vbias": torch.full((v,), -20.0, device=card),
              "hbias": torch.full((h,), 20.0, device=card)}
    v0 = (torch.rand((32, v), generator=torch.Generator().manual_seed(0)) > 0.5).float().to(card)
    mask = (torch.arange(32, device=card) < 30).float()
    for cd_k in (1, 2):
        got = rbk.statistics(params, v0, mask, 5, cd_k=cd_k)
        uh, uv = rbk.chain_uniforms(5, 32, v, h, cd_k, card)
        ref = rbk.statistics_reference(params, v0, mask, uh, uv, cd_k=cd_k)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


def bernoulli_probe(p: float, b: int, device):
    """Params and inputs whose CD-1 statistics count the chain's first hidden
    draws: one visible and one hidden unit, ``h0p = sigmoid(hbias) = p``,
    and a weight of 40 under a visible bias of -20, so that ``vp`` is 1 for
    a drawn hidden unit and 2e-9 for an undrawn one; with ``v0 = 0``,
    ``-dvb / B`` is the frequency of the draws."""
    params = {"weights": torch.full((1, 1), 40.0, device=device),
              "vbias": torch.full((1,), -20.0, device=device),
              "hbias": torch.full((1,), math.log(p / (1 - p)), device=device)}
    return params, torch.zeros((b, 1), device=device), torch.ones((b,), device=device)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_bernoulli_probe_on_the_plain_version(p):
    b = 1 << 15
    params, v0, mask = bernoulli_probe(p, b, "cpu")
    _, dvb, _, _ = rbk.statistics(params, v0, mask, 99, cd_k=1)
    assert abs(-float(dvb[0]) / b - p) < 5 * math.sqrt(p * (1 - p) / b)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_rbm_kernel_bernoulli_frequency(card, p):
    b = 1 << 17
    params, v0, mask = bernoulli_probe(p, b, card)
    chain = {}
    _, dvb, _, _ = rbk.statistics(params, v0, mask, 99, cd_k=1, chain=chain)
    p_exact = float(chain["h0p"][0, 0])
    freq = -float(dvb[0]) / b
    assert abs(freq - p_exact) < 5 * math.sqrt(p_exact * (1 - p_exact) / b)
