"""Two-process data parallelism of the port's models on the CPU, against
the JAX package (the runner and its timeouts: ``tests/test_torch_multihost.py``).

- The pool-sharded resident pool: each rank's pool holds half the rows,
  and the training losses are the JAX package's in-process ``make_mesh(2,
  1)`` pool-sharded run's within rtol 1e-4.
- The SOM (4x4 map, 120 rows at batch 64: a padded last batch) against the
  JAX package's single-device run (``tests/test_parallel.py``): losses
  within rtol 1e-4, final weights within rtol 1e-4 / atol 1e-6.
- The RBM's psum rule: on the JAX package's saturated parameters (the
  draws cannot matter) the two ranks' update equals the JAX kernel's
  full-batch step (``tests/test_pallas.py``) within rtol 1e-4 (atol 1e-6),
  its error within 1e-5; on drawn parameters it equals, within 1e-5, the
  update built in one process from the two shards' statistics with seeds
  ``2s`` and ``2s + 1``, summed.
- The small LM with flash attention (``tests/test_transformer.py``'s
  flash-under-DP case, 20 sequences at batch 16: a padded batch) against
  the JAX package's single-device run: losses within rtol 1e-4.
"""

import numpy as np
import torch

from test_torch_multihost import RTOL, run_ranks

POOL_WORKER = r'''
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.loader import FullBatchLoader
from znicz_tpu_torch.workflow import StandardWorkflow
gen = np.random.default_rng(3)
imgs = gen.integers(0, 256, (128, 8, 8, 1), dtype=np.uint8)
labels = (imgs.mean(axis=(1, 2, 3)) > 127).astype(np.int32)
prng.seed_all(67)
loader = FullBatchLoader({"train": imgs}, {"train": labels}, minibatch_size=32,
                         normalization="range",
                         normalization_kwargs={"scale": 255.0, "shift": -0.5},
                         device_resident=True, pool_sharded=True)
wf = StandardWorkflow(loader,
    [{"type": "all2all_tanh", "->": {"output_sample_shape": 8}},
     {"type": "softmax", "->": {"output_sample_shape": 2}}],
    decision_config={"max_epochs": 3},
    default_hyper={"learning_rate": 0.1, "gradient_moment": 0.9}, device="cpu",
    parallel=DataParallel(make_mesh()))
wf.initialize(seed=67)
pool = wf._ctx["pool"]
# this rank's pool block only: shard RANK's 64 rows
assert torch.equal(pool, torch.from_numpy(imgs[RANK * 64:(RANK + 1) * 64])), RANK
report(rows=pool.shape[0], hist=[e["train"]["loss"] for e in wf.run().history])
'''


def test_two_process_pool_sharded_matches_jax_mesh_of_two():
    import jax

    from znicz_tpu.core import prng
    from znicz_tpu.loader import FullBatchLoader
    from znicz_tpu.parallel import DataParallel, make_mesh
    from znicz_tpu.workflow import StandardWorkflow

    reports = run_ranks(POOL_WORKER)
    assert [r["rows"] for r in reports] == [64, 64]
    assert reports[0]["hist"] == reports[1]["hist"]
    gen = np.random.default_rng(3)
    imgs = gen.integers(0, 256, (128, 8, 8, 1), dtype=np.uint8)
    labels = (imgs.mean(axis=(1, 2, 3)) > 127).astype(np.int32)
    prng.reset()
    prng.seed_all(67)
    loader = FullBatchLoader({"train": imgs}, {"train": labels}, minibatch_size=32,
                             normalization="range",
                             normalization_kwargs={"scale": 255.0, "shift": -0.5},
                             device_resident=True, pool_sharded=True)
    wf = StandardWorkflow(
        loader,
        [{"type": "all2all_tanh", "->": {"output_sample_shape": 8}},
         {"type": "softmax", "->": {"output_sample_shape": 2}}],
        decision_config={"max_epochs": 3},
        default_hyper={"learning_rate": 0.1, "gradient_moment": 0.9},
        parallel=DataParallel(make_mesh(2, 1, devices=jax.devices()[:2])),
        prefetch_batches=0,
    )
    wf.initialize(seed=67)
    base = [e["train"]["loss"] for e in wf.run().history]
    np.testing.assert_allclose(reports[0]["hist"], base, rtol=RTOL)


SOM_WORKER = r'''
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.loader import datasets
from znicz_tpu_torch.workflow import KohonenWorkflow
prng.seed_all(31)
loader = datasets.mnist(n_train=120, n_test=0, minibatch_size=64, normalization="mean_disp")
wf = KohonenWorkflow(loader, sx=4, sy=4, total_epochs=2, device="cpu",
                     parallel=DataParallel(make_mesh()))
wf.initialize(seed=31)
hist = [e["train"]["loss"] for e in wf.run().history]
report(hist=hist, weights=wf.state.params["weights"].tolist())
'''


def test_two_process_som_matches_jax():
    from znicz_tpu.core import prng
    from znicz_tpu.loader import datasets
    from znicz_tpu.workflow import KohonenWorkflow

    reports = run_ranks(SOM_WORKER)
    assert reports[0] == reports[1]
    prng.reset()
    prng.seed_all(31)
    loader = datasets.mnist(n_train=120, n_test=0, minibatch_size=64, normalization="mean_disp")
    wf = KohonenWorkflow(loader, sx=4, sy=4, total_epochs=2, prefetch_batches=0)
    wf.initialize(seed=31)
    base = [e["train"]["loss"] for e in wf.run().history]
    np.testing.assert_allclose(reports[0]["hist"], base, rtol=RTOL)
    np.testing.assert_allclose(np.asarray(reports[0]["weights"]),
                               np.asarray(wf.state.params["weights"]), rtol=1e-4, atol=1e-6)


RBM_WORKER = r'''
from znicz_tpu_torch.ops.kernels import rbm as rbk
case = np.load(ARGS[0])
rows = slice(RANK * 24, (RANK + 1) * 24)  # this rank's half of a batch of 48
out = {}
for name in ("saturated", "drawn"):
    params = {k: torch.from_numpy(case[f"{name}_{k}"]) for k in ("weights", "vbias", "hbias")}
    new, err = rbk.cd_step(params, torch.from_numpy(case["v0"][rows]), rbk.seed_tensor(9, "cpu"),
                           learning_rate=0.3, mask=torch.from_numpy(case["mask"][rows]),
                           mesh=make_mesh())
    out[name] = {"err": float(err), **{k: v.tolist() for k, v in new.items()}}
report(**out)
'''


def _rbm_case(path):
    gen = np.random.default_rng(4)
    v, h = 64, 32
    case = {
        "v0": (gen.random((48, v)) > 0.5).astype(np.float32),
        "mask": (np.arange(48) < 40).astype(np.float32),  # rank 1: 16 valid of 24
        "saturated_weights": np.zeros((v, h), np.float32),
        "saturated_vbias": np.full((v,), -20.0, np.float32),
        "saturated_hbias": np.full((h,), 20.0, np.float32),
        "drawn_weights": gen.normal(0.0, 0.1, (v, h)).astype(np.float32),
        "drawn_vbias": gen.normal(0.0, 0.1, (v,)).astype(np.float32),
        "drawn_hbias": gen.normal(0.0, 0.1, (h,)).astype(np.float32),
    }
    np.savez(path, **case)
    return case


def test_two_process_rbm_psum_rule(tmp_path):
    import jax.numpy as jnp

    from znicz_tpu.ops.pallas import rbm as pallas_rbm
    from znicz_tpu_torch.ops.kernels import rbm as rbk

    case = _rbm_case(tmp_path / "rbm.npz")
    reports = run_ranks(RBM_WORKER, tmp_path / "rbm.npz")
    assert reports[0] == reports[1]
    got = reports[0]
    # saturated: the JAX kernel's full-batch step (interpret mode)
    params = {k: jnp.asarray(case[f"saturated_{k}"]) for k in ("weights", "vbias", "hbias")}
    ref, ref_err = pallas_rbm.cd_step(params, jnp.asarray(case["v0"]), 9, learning_rate=0.3,
                                      mask=jnp.asarray(case["mask"]))
    np.testing.assert_allclose(got["saturated"]["err"], float(ref_err), rtol=1e-5)
    for k in ("weights", "vbias", "hbias"):
        np.testing.assert_allclose(np.asarray(got["saturated"][k]), np.asarray(ref[k]),
                                   rtol=1e-4, atol=1e-6)
    # drawn: the shards' statistics with seeds 2s and 2s + 1, summed
    params = {k: torch.from_numpy(case[f"drawn_{k}"]) for k in ("weights", "vbias", "hbias")}
    parts = [rbk.statistics(params, torch.from_numpy(case["v0"][r * 24:(r + 1) * 24]),
                            torch.from_numpy(case["mask"][r * 24:(r + 1) * 24]),
                            rbk.seed_tensor(2 * 9 + r, "cpu"), cd_k=1) for r in (0, 1)]
    summed = [a + b for a, b in zip(*parts)]
    want, want_err = rbk._apply_update(params, *summed, 0.3)
    np.testing.assert_allclose(got["drawn"]["err"], float(want_err), rtol=1e-5)
    for k in ("weights", "vbias", "hbias"):
        np.testing.assert_allclose(np.asarray(got["drawn"][k]), want[k].numpy(),
                                   rtol=1e-5, atol=1e-7)


LM_WORKER = r'''
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.loader import FullBatchLoader
from znicz_tpu_torch.workflow import TransformerLMWorkflow
tokens = np.asarray(np.random.default_rng(7).integers(0, 16, (20, 24)), np.int32)
prng.seed_all(12)
wf = TransformerLMWorkflow(FullBatchLoader({"train": tokens}, minibatch_size=16), vocab=16,
                           d_model=32, n_layers=1, n_heads=2, max_epochs=2, attention="flash",
                           device="cpu", parallel=DataParallel(make_mesh()))
wf.initialize(seed=12)
report(hist=[e["train"]["loss"] for e in wf.run().history])
'''


def test_two_process_lm_with_flash_matches_jax():
    from znicz_tpu.core import prng
    from znicz_tpu.loader import FullBatchLoader
    from znicz_tpu.workflow import TransformerLMWorkflow

    reports = run_ranks(LM_WORKER)
    assert reports[0] == reports[1]
    tokens = np.asarray(np.random.default_rng(7).integers(0, 16, (20, 24)), np.int32)
    prng.reset()
    prng.seed_all(12)
    wf = TransformerLMWorkflow(FullBatchLoader({"train": tokens}, minibatch_size=16), vocab=16,
                               d_model=32, n_layers=1, n_heads=2, max_epochs=2,
                               attention="flash", prefetch_batches=0)
    wf.initialize(seed=12)
    base = [e["train"]["loss"] for e in wf.run().history]
    np.testing.assert_allclose(reports[0]["hist"], base, rtol=RTOL)
