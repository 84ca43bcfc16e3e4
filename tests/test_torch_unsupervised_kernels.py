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
  such samples is asserted small); two launches are bitwise equal; a map
  with duplicated units gives the first of them; ``num`` and ``den``
  against a float64 plain version along the kernel's winners within 10
  times the f32 plain version's error; nothing written past any output or
  scratch buffer (each taken from the front of a NaN-filled larger one).
- RBM: with injected uniforms and with the kernel's own draws, every
  draw of the chain counted as a flip where the plain version, led along
  the kernel's own samples, would have drawn the other way (a draw ``u``
  that lands between the kernel's and cuBLAS's ``p``): at most 1e-5 of the
  draws; the statistics within 1e-4 of the largest magnitude when no draw
  flipped, and always (along the kernel's samples) within 10 times the f32
  plain version's error against a float64 plain version; one launch count
  a call; the in-kernel generator bitwise equal to the twin; the same seed
  gives bitwise-equal outputs and another seed other ones; the saturated
  regime exact; Bernoulli frequencies within 5 sigma; nothing written past
  any output or scratch buffer (each taken from the front of a NaN-filled
  larger one); V 784 with H 14,000 (above what one block's shared memory
  held before the kernel became a GEMM).
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


@pytest.mark.parametrize("b,m,f,want", [
    (100, 64, 784, 13),   # the model's shape: 2 tiles, so F's 13 chunks split 13 ways
    (4096, 1024, 784, 1),  # the large check shape: 1024 tiles fill the card
    (600, 36, 256, 4),    # 10 tiles, 4 chunks
    (33, 25, 50, 1),      # one chunk: nothing to split
    (10, 9, 700, 11),     # 11 chunks, 1 tile
    (64, 64, 64 * 40, 40),
    (64 * 60, 64, 64 * 40, 5),  # 60 tiles: 5 pieces of 8 chunks
])
def test_kohonen_split_count(b, m, f, want):
    nch = -(-f // khk.KC)
    got = khk.split_count(b, m, f)
    assert got == want
    # the C entry's rule: pieces of ceil(nch / nsplit) chunks, none empty
    cps = -(-nch // got)
    assert 1 <= got <= nch and -(-nch // cps) == got and (got - 1) * cps < nch
    blocks = -(-b // khk.TILE) * -(-m // khk.TILE)
    assert got == 1 or blocks * got >= min(khk.TARGET_BLOCKS, blocks * nch) // 2


def test_kohonen_buffer_shapes():
    assert khk.buffer_shapes(100, 64, 784) == {
        "neigh": (64, 64), "scores": (13, 100, 64), "sq": (13, 64), "win": (100,),
        "num": (64, 784), "den": (64, 1)}
    assert khk.buffer_shapes(4096, 1024, 784)["scores"] == (1, 4096, 1024)
    shapes = khk.buffer_shapes(33, 25, 50)
    num, den, ptr = khk._buffers(33, 25, 50, "cpu")
    # one block, laid out in order, the table first
    assert list(ptr) == list(shapes)
    sizes = [math.prod(s) for s in shapes.values()]
    assert [p - ptr["neigh"] for p in ptr.values()] == [4 * o for o in np.cumsum([0] + sizes[:-1])]
    assert num.dtype == den.dtype == torch.float32
    assert num.shape == (25, 50) and den.shape == (25, 1)
    assert num.is_contiguous() and den.is_contiguous()
    assert (num.data_ptr(), den.data_ptr()) == (ptr["num"], ptr["den"])
    assert num.untyped_storage().nbytes() == 4 * sum(sizes)


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


@pytest.mark.parametrize("cd_k", [1, 3])
def test_rbm_plain_version_led_by_its_own_samples_is_bitwise_the_same(cd_k):
    params, v0, mask = _rbm_case(33, 50, 21, 30, 6)
    uh, uv = rbk.chain_uniforms(8, 33, 50, 21, cd_k)
    chain, led = {}, {}
    want = rbk.statistics_reference(params, v0, mask, uh, uv, cd_k=cd_k, chain=chain)
    samples = (chain["hidden_samples"], chain["visible_samples"])
    got = rbk.statistics_reference(params, v0, mask, None, None, cd_k=cd_k, chain=led,
                                   samples=samples)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for key in ("h0p", "vp", "hp", "hidden_samples", "visible_samples", "hidden_probs",
                "visible_probs"):
        assert torch.equal(led[key], chain[key]), key
    # the draws are its own thresholds: nothing flips
    assert rbk.count_flips(chain, led, uh, uv) == 0
    # a draw turned over is counted, and the chain then follows it
    turned = (samples[0].clone(), samples[1].clone())
    turned[1][cd_k - 1, 0, 0] = 1.0 - turned[1][cd_k - 1, 0, 0]
    other = {}
    got = rbk.statistics_reference(params, v0, mask, None, None, cd_k=cd_k, chain=other,
                                   samples=turned)
    assert rbk.count_flips({"hidden_samples": turned[0], "visible_samples": turned[1]},
                           other, uh, uv) >= 1
    assert not torch.equal(got[0], want[0])


@pytest.mark.parametrize("cd_k", [1, 2])
def test_rbm_plain_version_in_float64_along_the_same_samples(cd_k):
    """The oracle of the kernel's float64 check: the f32 plain version and a
    float64 one led along one sample path agree to f32 rounding (1e-5 of
    the largest magnitude: sums of B terms in f32)."""
    params, v0, mask = _rbm_case(40, 96, 24, 35, 7)
    uh, uv = rbk.chain_uniforms(3, 40, 96, 24, cd_k)
    chain = {}
    got = rbk.statistics_reference(params, v0, mask, uh, uv, cd_k=cd_k, chain=chain)
    p64 = {k: t.double() for k, t in params.items()}
    exact = rbk.statistics_reference(
        p64, v0.double(), mask.double(), None, None, cd_k=cd_k,
        samples=(chain["hidden_samples"], chain["visible_samples"]))
    for g, e in zip(got, exact):
        assert e.dtype == torch.float64
        _near(g.numpy(), e.numpy(), 1e-5)


def test_rbm_cpu_path_chain_holds_the_samples():
    b, v, h, cd_k = 12, 20, 7, 3
    params, v0, mask = _rbm_case(b, v, h, b, 4)
    chain = {}
    rbk.statistics(params, v0, mask, 5, cd_k=cd_k, chain=chain)
    want = {"h0p": (b, h), "vp": (b, v), "hp": (b, h), "hidden_samples": (cd_k, b, h),
            "visible_samples": (cd_k, b, v), "hidden_probs": (cd_k, b, h),
            "visible_probs": (cd_k, b, v)}
    assert {k: tuple(t.shape) for k, t in chain.items()} == want
    for key in ("hidden_samples", "visible_samples"):
        assert chain[key].dtype == torch.float32
        assert bool(((chain[key] == 0) | (chain[key] == 1)).all())
    uh, uv = rbk.chain_uniforms(5, b, v, h, cd_k)
    assert torch.equal(chain["hidden_samples"][0], (uh[0] < chain["h0p"]).float())
    assert torch.equal(chain["hidden_probs"][0], chain["h0p"])
    assert torch.equal(chain["visible_probs"][-1], chain["vp"])
    # the kernel's buffers cover what the chain holds
    shapes = rbk.buffer_shapes(b, v, h, cd_k)
    for key in ("h0p", "vp", "hp", "hidden_samples", "visible_samples"):
        assert shapes[key] == want[key]


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
    (100, 8, 781, 90),   # F not a multiple of 4: 4-byte copies
    (10, 9, 784, 10),    # B below one tile, M 81 not a multiple of the tile
    (128, 8, 128, 120),  # F a multiple of the tile: den's ones column in a tile of its own
    (1100, 10, 200, 1000),  # several batch tiles, F split 4 ways, 4-byte copies
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


# the 3xTF32 kernel against float64: within this factor of the f32 plain
# version's error (one TF32 product would be ~1000 times it)
FLOAT64_FACTOR = 10


@pytest.mark.cuda
def test_kohonen_kernel_takes_the_first_of_duplicated_units(card):
    """Units 5, 70 and 99 of a 10x10 map are one vector, in other tiles of
    the scores launch: the samples next to it take unit 5."""
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(100, 96)) * 0.5).astype(np.float32)
    w[70] = w[99] = w[5]
    x = rng.normal(size=(300, 96)).astype(np.float32)
    x[:150] = w[5] + 0.01 * rng.normal(size=(150, 96)).astype(np.float32)
    w, x = torch.from_numpy(w).to(card), torch.from_numpy(x).to(card)
    mask = torch.ones(300, device=card)
    d2m = khk.pairwise_d2(kh.grid_coords(10, 10, device=card))
    win = torch.empty((300,), dtype=torch.int32, device=card)
    num, den = khk.accumulate(w, x, mask, d2m, 1.5, winners_out=win)
    torch.cuda.synchronize()
    assert bool((win[:150] == 5).all()), win[:150].unique()
    assert int((kh.winners({"weights": w}, x) != win).sum()) <= 1
    ref_num, ref_den = khk.accumulate_reference(w, x, mask, d2m, 1.5, win=win)
    _near(num.cpu(), ref_num.cpu(), 1e-5)
    _near(den.cpu(), ref_den.cpu(), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,side,f,n_valid", [(100, 8, 784, 93), (1100, 10, 200, 1000)],
                         ids=["b100_m8x8_f784", "b1100_m10x10_f200"])
def test_kohonen_kernel_against_float64(card, b, side, f, n_valid):
    """num and den of the 3xTF32 kernel against a float64 plain version along
    the kernel's own winners: within FLOAT64_FACTOR of the f32 plain
    version's error (one TF32 product would be ~1000 times it)."""
    w, x, mask, d2m, _ = _kohonen_case(b, side, f, n_valid, 5, card)
    win = torch.empty((b,), dtype=torch.int32, device=card)
    got = khk.accumulate(w, x, mask, d2m, 2.0, winners_out=win)
    plain = khk.accumulate_reference(w, x, mask, d2m, 2.0, win=win)
    exact = khk.accumulate_reference(w.double(), x.double(), mask.double(), d2m.double(), 2.0,
                                     win=win)
    for g, p, e in zip(got, plain, exact):
        ek = float((g.double() - e).abs().max())
        ep = float((p.double() - e).abs().max())
        assert math.isfinite(ek) and ek <= FLOAT64_FACTOR * ep, (ek, ep)


@pytest.mark.cuda
@pytest.mark.parametrize("b,side,f", [(100, 8, 784), (70, 5, 50)],
                         ids=["b100_m8x8_f784", "b70_m5x5_f50"])
def test_kohonen_kernel_writes_nothing_past_its_buffers(card, monkeypatch, b, side, f):
    """The canary: every output and scratch buffer taken from the front of a
    NaN-filled larger one; what lies past it stays NaN, and the results are
    the wrapper's own, bit for bit."""
    w, x, mask, d2m, _ = _kohonen_case(b, side, f, b - 3, 8, card)
    want = khk.accumulate(w, x, mask, d2m, 1.1)
    carved = {}

    def canary_buffers(b_, m_, f_, device):
        ptr = {}
        for name, shape in khk.buffer_shapes(b_, m_, f_).items():
            n = math.prod(shape)
            full = torch.full((n + 4096,), float("nan"), device=device)
            carved[name] = (full, n)
            ptr[name] = full.data_ptr()
        return (carved["num"][0][:m_ * f_].view(m_, f_), carved["den"][0][:m_].view(m_, 1),
                ptr)

    monkeypatch.setattr(khk, "_buffers", canary_buffers)
    got = khk.accumulate(w, x, mask, d2m, 1.1)
    torch.cuda.synchronize()
    assert set(carved) == set(khk.buffer_shapes(b, side * side, f))
    for name, (full, n) in carved.items():
        assert bool(torch.isnan(full[n:]).all()), f"written past {name}"
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))


@pytest.mark.cuda
def test_kohonen_kernel_refuses_a_grid_past_its_y_extent(card):
    b = khk.MAX_GRID_Y * khk.TILE + 1
    with pytest.raises(ValueError, match="65535"):
        khk.accumulate(torch.zeros((4, 1), device=card), torch.zeros((b, 1), device=card),
                       torch.ones(b, device=card), torch.zeros((4, 4), device=card), 1.0)

RBM_CASES = [  # (B, V, H, cd_k, valid rows)
    (100, 784, 128, 1, 93),  # the model's shape, a masked tail
    (70, 50, 33, 3, 64),     # ragged tiles, 4-byte copies, k 3
    (300, 200, 1024, 2, 300),
]


def _check_rbm_kernel(params, v0, mask, seed, cd_k, uniforms, uh, uv):
    """The kernel's statistics against the plain version's: flips over every
    draw, 1e-4 where none flipped, float64 along the kernel's samples."""
    chain, led = {}, {}
    before = rbk.statistics.launches
    got = rbk.statistics(params, v0, mask, seed, cd_k=cd_k, uniforms=uniforms, chain=chain)
    torch.cuda.synchronize()
    assert rbk.statistics.launches - before == 1
    samples = (chain["hidden_samples"], chain["visible_samples"])
    assert samples[0].shape == uh[:cd_k].shape and samples[1].shape == uv.shape
    plain = rbk.statistics_reference(params, v0, mask, uh, uv, cd_k=cd_k, chain=led,
                                     samples=samples)
    flips = rbk.count_flips(chain, led, uh, uv)
    assert flips <= 1e-5 * (samples[0].numel() + samples[1].numel()) + 1
    if flips == 0:
        ref = rbk.statistics_reference(params, v0, mask, uh, uv, cd_k=cd_k)
        for g, r in zip(got, ref):
            _near(g.cpu(), r.cpu(), 1e-4)
    p64 = {k: t.double() for k, t in params.items()}
    exact = rbk.statistics_reference(p64, v0.double(), mask.double(), None, None, cd_k=cd_k,
                                     samples=samples)
    for g, p, e in list(zip(got, plain, exact))[:3]:  # dW, dvb, dhb
        ek = float((g.double() - e).abs().max())
        ep = float((p.double() - e).abs().max())
        assert math.isfinite(ek) and ek <= FLOAT64_FACTOR * ep, (ek, ep)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("b,v,h,cd_k,n_valid", RBM_CASES,
                         ids=[f"b{c[0]}_{c[1]}x{c[2]}_k{c[3]}" for c in RBM_CASES])
def test_rbm_kernel_matches_plain_version(card, b, v, h, cd_k, n_valid):
    params, v0, mask = _rbm_case(b, v, h, n_valid, b + v, card)
    seed = 17
    uh, uv = rbk.chain_uniforms(seed, b, v, h, cd_k, card)
    for uniforms in ((uh, uv), None):  # injected, then the kernel's own draws
        _check_rbm_kernel(params, v0, mask, seed, cd_k, uniforms, uh, uv)


@pytest.mark.cuda
def test_rbm_kernel_takes_a_wide_hidden_layer(card):
    """V 784 with H 14,000: beyond what one block's shared memory held when a
    block ran a row's whole chain."""
    b, v, h = 8, 784, 14_000
    params, v0, mask = _rbm_case(b, v, h, 7, 3, card)
    uh, uv = rbk.chain_uniforms(4, b, v, h, 1, card)
    _check_rbm_kernel(params, v0, mask, 4, 1, (uh, uv), uh, uv)


@pytest.mark.cuda
@pytest.mark.parametrize("b,v,h,cd_k", [(100, 784, 128, 1), (70, 50, 33, 3)],
                         ids=["b100_784x128_k1", "b70_50x33_k3"])
def test_rbm_kernel_writes_nothing_past_its_buffers(card, monkeypatch, b, v, h, cd_k):
    """The canary: every output and scratch buffer taken from the front of a
    NaN-filled larger one; what lies past them stays NaN, and the results
    are the wrapper's own, bit for bit."""
    params, v0, mask = _rbm_case(b, v, h, b - 3, 9, card)
    want = rbk.statistics(params, v0, mask, 21, cd_k=cd_k)
    carved = {}

    def canary_buffers(b_, v_, h_, k_, device):
        out = {}
        for name, shape in rbk.buffer_shapes(b_, v_, h_, k_).items():
            n = math.prod(shape)
            full = torch.full((n + 4096,), float("nan"), device=device)
            carved[name] = (full, n)
            out[name] = full[:n].view(shape)
        return out

    monkeypatch.setattr(rbk, "_buffers", canary_buffers)
    got = rbk.statistics(params, v0, mask, 21, cd_k=cd_k)
    torch.cuda.synchronize()
    assert set(carved) == set(rbk.buffer_shapes(b, v, h, cd_k))
    for name, (full, n) in carved.items():
        assert bool(torch.isnan(full[n:]).all()), f"written past {name}"
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_rbm_kernel_refuses_a_grid_past_its_y_extent(card):
    b = rbk.MAX_GRID_Y * rbk.TILE + 1
    params = {"weights": torch.zeros((1, 1), device=card), "vbias": torch.zeros(1, device=card),
              "hbias": torch.zeros(1, device=card)}
    with pytest.raises(ValueError, match="65535"):
        rbk.statistics(params, torch.zeros((b, 1), device=card), torch.ones(b, device=card), 0,
                       cd_k=1)


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
