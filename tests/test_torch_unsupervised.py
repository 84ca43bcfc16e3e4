"""The port's unsupervised slice (Kohonen SOM, RBM) against the JAX package,
on the CPU.

Inputs come from numpy seeds (or the shared named numpy streams), so both
frameworks start from the same bits.  The JAX side's Pallas kernels run in
interpret mode, as the JAX package's own tests run them here; the port's
CPU path is each kernel's plain version.  Tolerances, each with its reason:

- normalizers, MNIST data, initial params, the lr/sigma schedule: exact
  (the same numpy or float32 scalar arithmetic);
- single ops and one kernel call: 1e-5 of the largest magnitude for sums
  that run in another order (oneDNN vs XLA), 1e-6 for elementwise ops;
- whole workflows over 2-3 epochs: per-epoch loss and final params at
  rtol 1e-4 (atol 1e-5 for entries near 0), the same sums in another order
  compounded over the steps.

The RBM chain draws its uniforms from a counter-based generator in the
port and from the TPU's hardware PRNG in JAX (threefry-derived uniforms in
interpret mode); the comparisons feed both the JAX interpret recipe
(``ops/pallas/rbm.py:148-157``).
"""

import gzip
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu.core import prng as jprng
from znicz_tpu.loader import datasets as jdatasets, normalizers as jnorm
from znicz_tpu.ops import kohonen as jkh, rbm as jrbm
from znicz_tpu.ops.pallas import kohonen as jpkh, rbm as jprbm
from znicz_tpu.workflow import KohonenWorkflow as JaxKohonen, RBMWorkflow as JaxRBM
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.loader import datasets as tdatasets, normalizers as tnorm
from znicz_tpu_torch.ops import kohonen as tkh, rbm as trbm
from znicz_tpu_torch.ops.kernels import kohonen as kh_kernel, rbm as rbm_kernel
from znicz_tpu_torch.workflow import unsupervised
from znicz_tpu_torch.workflow.snapshotter import Snapshotter
from znicz_tpu_torch.workflow.unsupervised import KohonenWorkflow, RBMWorkflow

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False

SEED = 2024
RTOL_EPOCH = 1e-4
RTOL_W, ATOL_W = 1e-4, 1e-5


def _seed_both(seed=SEED):
    for reg in (jprng, tprng):
        reg.reset()
        reg.seed_all(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _near(got, want, rtol):
    """Within ``rtol`` of the reference's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, (err, scale)


# -- loader -------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["none", "linear", "mean_disp", "range", "external_mean"])
def test_normalizers_exact(kind):
    rng = np.random.default_rng(1)
    data = rng.normal(2.0, 3.0, (40, 12)).astype(np.float32)
    data[:, 3] = 7.0  # a constant feature: span and dispersion fall back to 1
    kw = {"range": {"scale": 127.5, "shift": -1.0},
          "external_mean": {"mean": rng.normal(size=12).astype(np.float32)}}.get(kind, {})
    sj, st = jnorm.fit(kind, data, **kw), tnorm.fit(kind, data, **kw)
    assert sj.keys() == st.keys()
    for k in sj:
        np.testing.assert_array_equal(np.asarray(st[k]), np.asarray(sj[k]))
    test = rng.normal(size=(9, 12)).astype(np.float32)
    np.testing.assert_array_equal(tnorm.apply(st, test), jnorm.apply(sj, test))
    with pytest.raises(ValueError, match="unknown normalizer"):
        tnorm.fit("bogus", data)


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "28x28x1"])
@pytest.mark.parametrize("normalization", ["mean_disp", "linear"])
def test_mnist_stand_in_is_bit_identical(flat, normalization):
    kw = dict(n_train=120, n_test=30, minibatch_size=50, validation_ratio=0.25, flat=flat,
              normalization=normalization)
    _seed_both()
    lj = jdatasets.mnist(**kw)
    lt = tdatasets.mnist(**kw)
    assert set(lt.data) == set(lj.data) == {"train", "valid", "test"}
    for split in lj.data:
        assert lt.data[split].dtype == np.float32
        np.testing.assert_array_equal(lt.data[split], lj.data[split])
        np.testing.assert_array_equal(lt.labels[split], lj.labels[split])
    assert lt.sample_shape == lj.sample_shape == ((784,) if flat else (28, 28, 1))


def test_fitted_normalization_needs_a_train_split():
    data = {"test": np.zeros((4, 3), np.float32)}
    with pytest.raises(ValueError, match="train"):
        tdatasets.FullBatchLoader(data, normalization="mean_disp")


def _write_idx(path, arr, gz):
    header = (0x0800 | arr.ndim).to_bytes(4, "big") + b"".join(
        d.to_bytes(4, "big") for d in arr.shape
    )
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
def test_idx_files_read_back(tmp_path, gz):
    rng = np.random.default_rng(5)
    sfx = ".gz" if gz else ""
    arrays = {
        "train-images-idx3-ubyte": rng.integers(0, 256, (6, 28, 28)),
        "train-labels-idx1-ubyte": rng.integers(0, 10, (6,)),
        "t10k-images-idx3-ubyte": rng.integers(0, 256, (3, 28, 28)),
        "t10k-labels-idx1-ubyte": rng.integers(0, 10, (3,)),
    }
    for name, arr in arrays.items():
        _write_idx(str(tmp_path / (name + sfx)), arr, gz)
    got = tdatasets._read_idx(str(tmp_path / ("train-images-idx3-ubyte" + sfx)))
    assert got.dtype == np.uint8 and got.shape == (6, 28, 28)
    np.testing.assert_array_equal(got, arrays["train-images-idx3-ubyte"])
    for kw in ({}, {"normalization": "mean_disp"}):
        lt = tdatasets.mnist(str(tmp_path), minibatch_size=4, **kw)
        lj = jdatasets.mnist(str(tmp_path), minibatch_size=4, **kw)
        for split in ("train", "test"):
            # under the default "range" the JAX loader keeps real images
            # uint8 and converts each minibatch in its native gather, which
            # multiplies by 1/255 where the port divides once per split:
            # one float32 rounding of values in [-0.5, 0.5] apart
            bj = next(lj.batches(split, shuffle=False))
            bt = next(lt.batches(split, shuffle=False))
            np.testing.assert_allclose(bt.data, bj.data, rtol=0, atol=0 if kw else 6e-8)
            np.testing.assert_array_equal(lt.labels[split], arrays[
                ("train" if split == "train" else "t10k") + "-labels-idx1-ubyte"])
    (tmp_path / ("t10k-images-idx3-ubyte" + sfx)).unlink()
    with pytest.raises(FileNotFoundError, match="t10k"):
        tdatasets.mnist(str(tmp_path))


# -- ops ----------------------------------------------------------------------

def test_kohonen_init_and_grid_exact():
    _seed_both()
    pj = jkh.init_params(5, 4, 30)
    pt = tkh.init_params(5, 4, 30, device="cpu")
    np.testing.assert_array_equal(pt["weights"].numpy(), np.asarray(pj["weights"]))
    np.testing.assert_array_equal(tkh.grid_coords(5, 4, device="cpu").numpy(),
                                  np.asarray(jkh.grid_coords(5, 4)))


def test_kohonen_winners_and_twin_step():
    rng = np.random.default_rng(2)
    w = rng.normal(0, 0.3, (16, 24)).astype(np.float32)
    x = rng.normal(0, 1, (40, 24)).astype(np.float32)
    mask = (np.arange(40) < 33).astype(np.float32)
    coords = jkh.grid_coords(4, 4)
    np.testing.assert_array_equal(tkh.winners({"weights": _t(w)}, _t(x)).numpy(),
                                  np.asarray(jkh.winners({"weights": w}, x)))
    pj, wj = jkh.train_step({"weights": w}, x, coords, learning_rate=jnp.float32(0.3),
                            sigma=jnp.float32(1.3), mask=mask)
    pt, wt = tkh.train_step({"weights": _t(w)}, _t(x), _t(coords), learning_rate=0.3,
                            sigma=1.3, mask=_t(mask))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    _near(pt["weights"].numpy(), pj["weights"], 1e-6)


@pytest.mark.parametrize("steps,total", [([0, 1, 5, 17, 299, 300, 301], 300),
                                         ([0, 3, 11, 12000, 12001], 12000),
                                         ([0, 1, 2, 9], 7)])
def test_decay_schedule_exact_in_f32(steps, total):
    kw = dict(lr0=0.5, lr1=0.01, sigma1=1.0, sx=8, sy=8)
    fj = jax.jit(lambda s: jkh.decay_schedule(s, total, **kw))
    for s in steps:
        lj, sj = fj(jnp.int32(s))
        lt, st = tkh.decay_schedule(s, total, **kw)
        assert lt.dtype == st.dtype == np.float32
        assert (lt, st) == (np.float32(lj), np.float32(sj)), s


def test_rbm_init_and_probs():
    _seed_both()
    pj = jrbm.init_params(30, 8)
    pt = trbm.init_params(30, 8, device="cpu")
    for k in ("weights", "vbias", "hbias"):
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]))
    rng = np.random.default_rng(3)
    pj = {k: np.asarray(v) + rng.normal(0, 0.1, np.shape(v)).astype(np.float32)
          for k, v in pj.items()}
    pt = {k: _t(v) for k, v in pj.items()}
    v = rng.uniform(0, 1, (7, 30)).astype(np.float32)
    h = rng.uniform(0, 1, (7, 8)).astype(np.float32)
    _near(trbm.hidden_probs(pt, _t(v)).numpy(), jrbm.hidden_probs(pj, v), 1e-6)
    _near(trbm.visible_probs(pt, _t(h)).numpy(), jrbm.visible_probs(pj, h), 1e-6)
    p = torch.full((4000,), 0.3)
    s = trbm.sample(torch.Generator().manual_seed(1), p)
    assert set(s.unique().tolist()) <= {0.0, 1.0} and abs(float(s.mean()) - 0.3) < 5 * (0.21 / 4000) ** 0.5


def _saturated(v=128, h=64):
    return {"weights": np.zeros((v, h), np.float32), "vbias": np.full((v,), -20.0, np.float32),
            "hbias": np.full((h,), 20.0, np.float32)}


def test_saturated_cd_steps_match_the_jax_twin():
    """Biases at +-20 drive every sigmoid to 0/1: sampling no longer depends
    on the random numbers, so the plain twin, the port's kernel path (its
    generator's draws) and the JAX twin agree."""
    params = _saturated()
    v0 = (np.random.default_rng(0).uniform(size=(32, 128)) > 0.5).astype(np.float32)
    mask = (np.arange(32) < 30).astype(np.float32)
    ref, ref_err = jrbm.cd_step(params, v0, jax.random.key(1), learning_rate=0.2, cd_k=2,
                                mask=mask)
    pt = {k: _t(v) for k, v in params.items()}
    fused, err = rbm_kernel.cd_step(pt, _t(v0), rbm_kernel.seed_tensor(5, "cpu"),
                                    learning_rate=0.2, cd_k=2, mask=_t(mask))
    twin, twin_err = trbm.cd_step(pt, _t(v0), torch.Generator().manual_seed(1),
                                  learning_rate=0.2, cd_k=2, mask=_t(mask))
    for got, got_err in ((fused, err), (twin, twin_err)):
        np.testing.assert_allclose(float(got_err), float(ref_err), rtol=1e-5)
        for k in ("weights", "vbias", "hbias"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-6)


# -- the plain versions of the two kernels vs the JAX Pallas kernels ----------------

@pytest.mark.parametrize("b,side,f,n_valid,lr,sigma,seed", [
    (100, 6, 784, 100, 0.5, 1.5, 0),  # tests/test_pallas.py: 6x6x784, B 100
    (600, 6, 256, 500, 0.3, 2.0, 3),  # masked, several batch tiles
    (300, 6, 64, 300, 0.2, 1.0, 5),   # not a multiple of the tile
], ids=["b100_f784", "b600_masked", "b300_ragged"])
def test_kohonen_plain_accumulate_matches_pallas(b, side, f, n_valid, lr, sigma, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(side * side, f)) * 0.1).astype(np.float32)
    x = rng.normal(size=(b, f)).astype(np.float32)
    mask = (np.arange(b) < n_valid).astype(np.float32)
    coords = jkh.grid_coords(side, side)
    d2m = jnp.sum(jnp.square(coords[:, None, :] - coords[None, :, :]), axis=-1)
    nj, dj = jpkh._accumulate(w, x, mask, d2m, jnp.float32(sigma))
    tcoords = tkh.grid_coords(side, side, device="cpu")
    td2m = kh_kernel.pairwise_d2(tcoords)
    np.testing.assert_array_equal(td2m.numpy(), np.asarray(d2m))
    nt, dt = kh_kernel.accumulate(_t(w), _t(x), _t(mask), td2m,
                                  kh_kernel.sigma_tensor(sigma, "cpu"))
    _near(nt.numpy(), nj, 1e-5)
    _near(dt.numpy(), dj, 1e-5)
    pj = jpkh.train_step({"weights": w}, x, coords, learning_rate=lr, sigma=sigma, mask=mask)
    pt = kh_kernel.train_step({"weights": _t(w)}, _t(x), tcoords, learning_rate=lr,
                              tss=kh_kernel.sigma_tensor(sigma, "cpu"), mask=_t(mask))
    _near(pt["weights"].numpy(), pj["weights"], 1e-5)


def _jax_uniforms(seed, b, v, h, cd_k):
    """The JAX kernel's interpret-mode uniforms (ops/pallas/rbm.py:148-157)."""
    key = jax.random.fold_in(jax.random.key(0), jnp.asarray(seed, jnp.int32))
    kh, kv = jax.random.split(key)
    return (np.asarray(jax.random.uniform(kh, (1 + cd_k, b, h), jnp.float32)),
            np.asarray(jax.random.uniform(kv, (cd_k, b, v), jnp.float32)))


@pytest.mark.parametrize("cd_k", [1, 3])
def test_rbm_plain_statistics_match_pallas(cd_k):
    rng = np.random.default_rng(10 + cd_k)
    b, v, h, seed = 40, 96, 24, 7
    params = {"weights": rng.normal(0, 0.2, (v, h)).astype(np.float32),
              "vbias": rng.normal(0, 0.1, v).astype(np.float32),
              "hbias": rng.normal(0, 0.1, h).astype(np.float32)}
    v0 = (rng.uniform(size=(b, v)) > 0.6).astype(np.float32)
    mask = (np.arange(b) < 33).astype(np.float32)  # a masked tail
    want = jprbm._statistics(params, v0, mask, seed, cd_k=cd_k)
    uh, uv = _jax_uniforms(seed, b, v, h, cd_k)
    got = rbm_kernel.statistics_reference({k: _t(a) for k, a in params.items()}, _t(v0),
                                          _t(mask), _t(uh), _t(uv), cd_k=cd_k)
    for g, w_ in zip(got, want):
        _near(g.numpy(), np.asarray(w_).reshape(g.shape), 1e-5)
    # the same through the wrapper's CPU path with the uniforms given
    got2 = rbm_kernel.statistics({k: _t(a) for k, a in params.items()}, _t(v0), _t(mask),
                                 rbm_kernel.seed_tensor(seed, "cpu"), cd_k=cd_k,
                                 uniforms=(_t(uh), _t(uv)))
    for g, g2 in zip(got, got2):
        assert torch.equal(g, g2)


@pytest.mark.parametrize("cd_k", [1, 2])
def test_rbm_plain_statistics_led_by_samples_match_pallas(cd_k):
    """The plain version led along a given sample path (how the card checks
    hold the kernel to float64): the draws JAX's interpret-mode uniforms
    make, given as samples, reproduce the Pallas kernel's statistics."""
    rng = np.random.default_rng(20 + cd_k)
    b, v, h, seed = 36, 80, 20, 5
    params = {"weights": rng.normal(0, 0.2, (v, h)).astype(np.float32),
              "vbias": rng.normal(0, 0.1, v).astype(np.float32),
              "hbias": rng.normal(0, 0.1, h).astype(np.float32)}
    v0 = (rng.uniform(size=(b, v)) > 0.5).astype(np.float32)
    mask = (np.arange(b) < 30).astype(np.float32)
    want = jprbm._statistics(params, v0, mask, seed, cd_k=cd_k)
    uh, uv = _jax_uniforms(seed, b, v, h, cd_k)
    tparams = {k: _t(a) for k, a in params.items()}
    chain = {}
    rbm_kernel.statistics_reference(tparams, _t(v0), _t(mask), _t(uh), _t(uv), cd_k=cd_k,
                                    chain=chain)
    got = rbm_kernel.statistics_reference(
        {k: t.double() for k, t in tparams.items()}, _t(v0).double(), _t(mask).double(),
        None, None, cd_k=cd_k, samples=(chain["hidden_samples"], chain["visible_samples"]))
    for g, w_ in zip(got, want):
        _near(g.numpy(), np.asarray(w_).reshape(g.shape), 1e-5)


# -- the workflows over whole epochs ------------------------------------------

def _kohonen_runs(impl):
    kw = dict(n_train=250, n_test=60, minibatch_size=100, normalization="mean_disp")
    wkw = dict(sx=4, sy=4, total_epochs=3, lr0=0.5, lr1=0.05, sigma1=0.7)
    _seed_both()
    jwf = JaxKohonen(jdatasets.mnist(**kw), impl=impl, prefetch_batches=0, **wkw)
    twf = KohonenWorkflow(tdatasets.mnist(**kw), impl=impl, device="cpu", **wkw)
    jwf.initialize(seed=SEED)
    twf.initialize(seed=SEED)
    np.testing.assert_array_equal(twf.state.params["weights"].numpy(),
                                  np.asarray(jwf.state.params["weights"]))
    epochs = [(jwf.run_epoch()["summary"], twf.run_epoch()["summary"]) for _ in range(3)]
    return jwf, twf, epochs


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_kohonen_workflow_matches_jax(impl):
    jwf, twf, epochs = _kohonen_runs(impl)
    for mj, mt in epochs:
        for split in ("train", "test"):
            assert mt[split]["n_samples"] == mj[split]["n_samples"]
            np.testing.assert_allclose(mt[split]["loss"], mj[split]["loss"], rtol=RTOL_EPOCH)
    assert epochs[0][1]["train"]["n_samples"] == 250
    assert epochs[-1][1]["train"]["loss"] < epochs[0][1]["train"]["loss"]
    np.testing.assert_allclose(twf.state.params["weights"].numpy(),
                               np.asarray(jwf.state.params["weights"]), rtol=RTOL_W, atol=ATOL_W)
    assert twf.state.step == 9
    assert twf.weights_map().shape == (4, 4, 784)
    np.testing.assert_array_equal(twf.weights_map()[1, 2],
                                  twf.state.params["weights"][1 * 4 + 2].numpy())
    assert twf.decision.epoch == 3


def test_rbm_workflow_matches_jax(monkeypatch):
    """The port's chain draws swapped for the JAX interpret recipe, so both
    frameworks follow the same chain step for step."""
    def jax_recipe(seed, b, v, h, cd_k, device="cpu"):
        return tuple(_t(u).to(device) for u in _jax_uniforms(seed, b, v, h, cd_k))

    monkeypatch.setattr(rbm_kernel, "chain_uniforms", jax_recipe)
    kw = dict(n_train=250, n_test=60, minibatch_size=100, normalization="linear")
    wkw = dict(n_hidden=16, learning_rate=0.1, cd_k=1, max_epochs=2)
    _seed_both()
    jl, tl = jdatasets.mnist(**kw), tdatasets.mnist(**kw)
    for ld in (jl, tl):
        for split, arr in ld.data.items():
            ld.data[split] = (arr + 1.0) / 2.0
    jwf = JaxRBM(jl, impl="pallas", prefetch_batches=0, **wkw)
    twf = RBMWorkflow(tl, impl="pallas", device="cpu", **wkw)
    jwf.initialize(seed=SEED)
    twf.initialize(seed=SEED)
    for _ in range(2):
        mj, mt = jwf.run_epoch()["summary"], twf.run_epoch()["summary"]
        for split in ("train", "test"):
            assert mt[split]["n_samples"] == mj[split]["n_samples"]
            np.testing.assert_allclose(mt[split]["loss"], mj[split]["loss"], rtol=RTOL_EPOCH)
    for k in ("weights", "vbias", "hbias"):
        np.testing.assert_allclose(twf.state.params[k].numpy(), np.asarray(jwf.state.params[k]),
                                   rtol=RTOL_W, atol=ATOL_W, err_msg=k)
    assert twf.state.step == 6


def test_params_from_jax_round_trip():
    _seed_both()
    pj = {k: np.asarray(v) for k, v in jrbm.init_params(20, 6).items()}
    pt = unsupervised.params_from_jax(pj, "cpu")
    back = unsupervised.params_to_numpy(pt)
    for k in pj:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], pj[k])
    pt["weights"].add_(1.0)  # a copy: the numpy source is untouched
    np.testing.assert_array_equal(back["weights"], pj["weights"])


@pytest.mark.parametrize("option", ["snapshotter", "snapshot", "epoch_sync"])
@pytest.mark.parametrize("cls", [KohonenWorkflow, RBMWorkflow], ids=["kohonen", "rbm"])
def test_lifted_options_are_honoured(cls, option, tmp_path):
    """The snapshotter, resuming and deferred sync, refused until the port
    had them: a snapshot written at an epoch end, a resume from it, a
    verdict one epoch late."""
    loader = tdatasets.mnist(n_train=10, n_test=0, minibatch_size=5)
    snap = Snapshotter(str(tmp_path), "u", interval=1, compress=False)
    if option == "epoch_sync":
        wf = cls(loader, epoch_sync="deferred", device="cpu")
        wf.initialize()
        assert wf.run_epoch() is None
        assert wf.sync_epoch()["summary"]["train"]["n_samples"] == 10
        return
    wf = cls(loader, snapshotter=snap, device="cpu")
    wf.initialize()
    wf.run_epoch()
    path = snap._path("epoch0")
    assert os.path.exists(path)
    if option == "snapshot":
        resumed = cls(loader, device="cpu")
        resumed.initialize(snapshot=path)
        assert resumed.state.step == wf.state.step == 2
        assert resumed.decision.epoch == 1
        for k, v in wf.state.params.items():
            assert torch.equal(resumed.state.params[k], v)
            assert not resumed.state.params[k].requires_grad


def test_refused_options_name_their_roadmap_item():
    """A tensor-parallel policy is refused naming ROADMAP.md A6; a
    data-parallel one is taken, and the kernels' psum rules over a world of
    one process (``mesh=``) give the step without a mesh bitwise (two
    processes: ``tests/test_torch_multihost_models.py``)."""
    from znicz_tpu_torch.parallel import DataParallel, make_mesh

    loader = tdatasets.mnist(n_train=10, n_test=0, minibatch_size=5)
    for cls in (KohonenWorkflow, RBMWorkflow):
        with pytest.raises(NotImplementedError, match="ROADMAP.md A6"):
            cls(loader, parallel=DataParallel(tp=True), device="cpu")
        dp = DataParallel(make_mesh())
        assert cls(loader, parallel=dp, device="cpu").parallel is dp
        # the base loop's prefetch depth is honoured, not refused
        assert cls(loader, prefetch_batches=0, device="cpu").prefetch_batches == 0
        with pytest.raises(ValueError, match="impl"):
            cls(loader, impl="cudnn", device="cpu")
    x = (torch.arange(24.0).reshape(4, 6) % 5) / 5
    args = ({"weights": torch.rand((4, 6), generator=torch.Generator().manual_seed(1))}, x,
            tkh.grid_coords(2, 2, device="cpu"))
    kw = dict(learning_rate=0.1, tss=kh_kernel.sigma_tensor(1.0, "cpu"))
    assert torch.equal(kh_kernel.train_step(*args, **kw, mesh=make_mesh())["weights"],
                       kh_kernel.train_step(*args, **kw)["weights"])
    params = trbm.init_params(6, 3, device="cpu")
    got = rbm_kernel.cd_step(params, x, rbm_kernel.seed_tensor(7, "cpu"), learning_rate=0.1,
                             mesh=make_mesh())
    want = rbm_kernel.cd_step(params, x, rbm_kernel.seed_tensor(7, "cpu"), learning_rate=0.1)
    assert torch.equal(got[1], want[1])
    for k in params:
        assert torch.equal(got[0][k], want[0][k])
