"""Scan dispatch (one split function a split) in the port against the JAX
package's ``lax.scan`` epochs, on the CPU.

Every workflow family with a device-resident loader: the Standard MLP, the
autoencoder (``target="input"``, a u8 pool converted in the step), the
Transformer LM (``attention="dot"``), the Kohonen SOM and the RBM.  On the
CPU the port's split function runs eagerly (on the card it is a CUDA graph
replay of the same step code, checked by ``chip_smoke.py``).  Inputs come
from numpy seeds and the shared named numpy streams, so both frameworks
start from the same bits.  Tolerances, each with its reason:

- the port's scan against its own step dispatch: bitwise (the same step
  code on the same inputs in the same order; only the dispatch differs);
- the port against JAX's scanned epochs: per-epoch loss rtol 1e-4,
  ``n_err`` equal, final weights rtol 1e-4 (atol 1e-5 near 0): the same
  sums in another order (oneDNN vs XLA), compounded over the steps;
- watch rows against JAX's: rtol 1e-5, one step's loss and global norm.

The RBM's chain draws follow the JAX interpret-mode recipe on both sides
(as ``tests/test_torch_unsupervised.py`` does), since the TPU's hardware
generator has no CPU twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu.core import prng as jprng
from znicz_tpu.loader.fullbatch import FullBatchLoader as JaxLoader
from znicz_tpu.utils import faults as jfaults
from znicz_tpu.workflow import (
    KohonenWorkflow as JaxKohonen,
    RBMWorkflow as JaxRBM,
    RecoveryPolicy as JaxPolicy,
    StandardWorkflow as JaxStandard,
    TransformerLMWorkflow as JaxLM,
)
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
from znicz_tpu_torch.ops.kernels import rbm as rbm_kernel
from znicz_tpu_torch.utils import faults
from znicz_tpu_torch.workflow.recovery import RecoveryPolicy
from znicz_tpu_torch.workflow.snapshotter import load_snapshot
from znicz_tpu_torch.workflow.standard import StandardWorkflow
from znicz_tpu_torch.workflow.transformer import TransformerLMWorkflow
from znicz_tpu_torch.workflow.unsupervised import KohonenWorkflow, RBMWorkflow

torch.set_float32_matmul_precision("highest")

SEED = 91
RTOL_EPOCH = 1e-4
RTOL_W, ATOL_W = 1e-4, 1e-5
RTOL_WATCH = 1e-5
EPOCHS = 3
MLP = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 12}},
    {"type": "softmax", "->": {"output_sample_shape": 3}},
]
AE = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 8}},
    {"type": "all2all", "->": {"output_sample_shape": (6, 6, 1)}},
]


@pytest.fixture(autouse=True)
def _clean():
    for f in (faults, jfaults):
        f.clear()
    yield
    for f in (faults, jfaults):
        f.clear()
    tprng.reset()


def _seed(jax_side):
    reg = jprng if jax_side else tprng
    reg.reset()
    reg.seed_all(SEED)


def _jax_uniforms(seed, b, v, h, cd_k):
    """The JAX kernel's interpret-mode uniforms (ops/pallas/rbm.py:148-157)."""
    key = jax.random.fold_in(jax.random.key(0), jnp.asarray(seed, jnp.int32))
    kh, kv = jax.random.split(key)
    return (np.asarray(jax.random.uniform(kh, (1 + cd_k, b, h), jnp.float32)),
            np.asarray(jax.random.uniform(kv, (cd_k, b, v), jnp.float32)))


@pytest.fixture
def jax_rbm_draws(monkeypatch):
    def recipe(seed, b, v, h, cd_k, device="cpu"):
        return tuple(torch.from_numpy(u.copy()).to(device) for u in _jax_uniforms(seed, b, v, h, cd_k))

    monkeypatch.setattr(rbm_kernel, "chain_uniforms", recipe)


# -- the families ---------------------------------------------------------------

def _mlp(jax_side, dispatch="scan", resident=True, loader_kw=None, **kw):
    _seed(jax_side)
    rng = np.random.default_rng(5)
    x = rng.normal(0.0, 1.0, (74, 10)).astype(np.float32)
    y = (x[:, :3].argmax(axis=1)).astype(np.int32)
    data = {"train": x[:50], "valid": x[50:62], "test": x[62:]}
    labels = {"train": y[:50], "valid": y[50:62], "test": y[62:]}
    cls, lcls = (JaxStandard, JaxLoader) if jax_side else (StandardWorkflow, FullBatchLoader)
    ld = lcls(data, labels, minibatch_size=16, normalization="mean_disp",
              device_resident=resident, **(loader_kw or {}))
    extra = {} if jax_side else {"device": "cpu", "epoch_dispatch": dispatch}
    if jax_side:
        extra["epoch_dispatch"] = "step" if dispatch == "step" else "auto"
    return cls(ld, MLP, decision_config={"max_epochs": EPOCHS},
               default_hyper={"learning_rate": 0.1, "gradient_moment": 0.9},
               lr_policy={"name": "step", "step_size": 4, "gamma": 0.5}, **extra, **kw)


def _ae(jax_side, dispatch="scan", resident=True):
    _seed(jax_side)
    images = np.random.default_rng(11).integers(0, 256, (72, 6, 6, 1), dtype=np.uint8)
    cls, lcls = (JaxStandard, JaxLoader) if jax_side else (StandardWorkflow, FullBatchLoader)
    ld = lcls({"train": images[:56], "test": images[56:]}, minibatch_size=16,
              normalization="range", normalization_kwargs={"scale": 255.0, "shift": -0.5},
              device_resident=resident)
    extra = {} if jax_side else {"device": "cpu", "epoch_dispatch": dispatch}
    return cls(ld, AE, loss_function="mse", target="input", decision_config={"max_epochs": EPOCHS},
               default_hyper={"learning_rate": 0.05, "gradient_moment": 0.9}, **extra)


def _lm(jax_side, dispatch="scan", resident=True):
    _seed(jax_side)
    gen = np.random.default_rng(5)
    tokens = np.cumsum(gen.integers(0, 3, (80, 12)), axis=1, dtype=np.int64) % 17
    cls, lcls = (JaxLM, JaxLoader) if jax_side else (TransformerLMWorkflow, FullBatchLoader)
    ld = lcls({"train": tokens[:64], "test": tokens[64:]}, minibatch_size=16,
              device_resident=resident)
    extra = {} if jax_side else {"device": "cpu", "epoch_dispatch": dispatch}
    return cls(ld, vocab=17, d_model=16, n_layers=1, n_heads=2, max_epochs=EPOCHS,
               attention="dot", **extra)


def _kohonen(jax_side, dispatch="scan", resident=True):
    _seed(jax_side)
    data = np.random.default_rng(7).normal(0.0, 1.0, (100, 12)).astype(np.float32)
    cls, lcls = (JaxKohonen, JaxLoader) if jax_side else (KohonenWorkflow, FullBatchLoader)
    ld = lcls({"train": data[:80], "test": data[80:]}, minibatch_size=32,
              device_resident=resident)
    extra = {"impl": "pallas"} if jax_side else {"device": "cpu", "epoch_dispatch": dispatch}
    return cls(ld, sx=3, sy=3, total_epochs=EPOCHS, lr0=0.5, lr1=0.05, sigma1=0.7, **extra)


def _rbm(jax_side, dispatch="scan", resident=True):
    _seed(jax_side)
    data = (np.random.default_rng(9).uniform(0, 1, (100, 24)) > 0.5).astype(np.float32)
    cls, lcls = (JaxRBM, JaxLoader) if jax_side else (RBMWorkflow, FullBatchLoader)
    ld = lcls({"train": data[:80], "test": data[80:]}, minibatch_size=32,
              device_resident=resident)
    extra = {"impl": "pallas"} if jax_side else {"device": "cpu", "epoch_dispatch": dispatch}
    return cls(ld, n_hidden=8, learning_rate=0.1, cd_k=1, max_epochs=EPOCHS, **extra)


FAMILIES = {"mlp": _mlp, "autoencoder": _ae, "lm": _lm, "kohonen": _kohonen, "rbm": _rbm}


def _weights(wf):
    """Either framework's params as flat host arrays."""
    def host(v):
        return np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor) else v)

    p = wf.state.params
    if isinstance(p, dict):
        return {k: host(v) for k, v in p.items()}
    return {f"{i}.{k}": host(v) for i, layer in enumerate(p) for k, v in layer.items()}


def _run(wf):
    wf.initialize(seed=SEED)
    dec = wf.run()
    return dec.history, _weights(wf)


def _bitwise(a, b):
    (ha, wa), (hb, wb) = a, b
    assert ha == hb
    assert wa.keys() == wb.keys()
    for k in wa:
        np.testing.assert_array_equal(wa[k], wb[k], err_msg=k)


def _near_jax(port, jax_run):
    (ht, wt), (hj, wj) = port, jax_run
    assert len(ht) == len(hj)
    for et, ej in zip(ht, hj):
        assert et.keys() == ej.keys()
        for split in et:
            assert et[split]["n_samples"] == ej[split]["n_samples"]
            if "n_err" in ej[split]:
                assert et[split]["n_err"] == ej[split]["n_err"]
            np.testing.assert_allclose(et[split]["loss"], ej[split]["loss"], rtol=RTOL_EPOCH)
    for k in wj:
        np.testing.assert_allclose(wt[k], wj[k], rtol=RTOL_W, atol=ATOL_W, err_msg=k)


# -- scan against JAX's scan, and against the port's own step dispatch -----------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_scan_matches_jax_scan_and_own_steps(family, jax_rbm_draws):
    make = FAMILIES[family]
    jwf = make(True)
    jwf.initialize(seed=SEED)
    assert jwf._use_epoch_scan()  # JAX takes its scan for this loader
    jax_run = (jwf.run().history, _weights(jwf))
    scan = make(False, "scan")
    scan_run = _run(scan)
    assert scan._ctx is not None and scan._use_epoch_scan()
    _near_jax(scan_run, jax_run)
    # the port's own step dispatch over the same pool: bitwise
    step = make(False, "step")
    step_run = _run(step)
    assert not step._use_epoch_scan()
    _bitwise(scan_run, step_run)
    assert scan.state.step == step.state.step == int(jwf.state.step)
    # "auto" takes the scan for a device-resident loader
    auto = make(False, "auto")
    _bitwise(_run(auto), scan_run)
    assert auto._use_epoch_scan()
    history = scan_run[0]
    assert history[-1]["train"]["loss"] < history[0]["train"]["loss"]  # it learns


def test_scan_needs_a_scan_friendly_loader():
    wf = _mlp(False, "scan", resident=False)
    wf.initialize(seed=SEED)
    with pytest.raises(ValueError, match="scan-friendly"):
        wf.run_epoch()
    # "auto" with a streaming loader dispatches step by step
    auto = _mlp(False, "auto", resident=False)
    auto.initialize(seed=SEED)
    assert auto._ctx is None and not auto._use_epoch_scan()


def test_one_split_run_a_split_and_shape():
    """Each split keeps its static state across epochs: one run for each of
    train, valid and test, reused epoch after epoch, the stacked inputs in
    one buffer, the step counter at the split's length after it."""
    wf = _mlp(False)
    wf.initialize(seed=SEED)
    wf.run_epoch()
    runs = dict(wf._splits)
    assert sorted(k[0] for k in runs) == ["test", "train", "valid"]
    wf.run_epoch()
    assert wf._splits == runs
    for (split, _), run in runs.items():
        n = wf.loader.n_minibatches(split)
        assert int(run.counter) == n
        assert run.rows["x"].shape == (n, 16) and run.rows["x"].dtype == torch.int32
        assert (run.watch is not None) == (split == "train")
    train = next(r for (s, _), r in runs.items() if s == "train")
    assert train.watch.shape == (4, 1 + 4)  # loss and the 4 param tensors' norms
    assert train.rows["scal"].shape == (4, 1)


# -- the pool and the host loop --------------------------------------------------

def test_evaluate_with_confusion_on_the_pool_matches_jax():
    jwf, twf = _mlp(True), _mlp(False)
    jwf.initialize(seed=SEED)
    twf.initialize(seed=SEED)
    jwf.run_epoch()
    twf.run_epoch()
    for split in ("valid", "test"):
        got = twf.evaluate(split, confusion=True)
        want = jwf.evaluate(split, confusion=True)
        np.testing.assert_array_equal(got["confusion"], np.asarray(want["confusion"]))
        assert got["n_err"] == want["n_err"] and got["n_samples"] == want["n_samples"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL_EPOCH)
    # the step dispatch's evaluate over the same pool gives the same bits
    step = _mlp(False, "step")
    step.initialize(seed=SEED)
    step.run_epoch()
    a, b = twf.evaluate("test", confusion=True), step.evaluate("test", confusion=True)
    np.testing.assert_array_equal(a.pop("confusion"), b.pop("confusion"))
    assert a == b


def test_deferred_sync_with_scan():
    """Deferred sync over scanned epochs: each verdict one epoch late, the
    history bitwise sync mode's and near JAX's deferred scan."""
    def run(jax_side, sync):
        wf = _mlp(jax_side, epoch_sync=sync)
        wf.initialize(seed=SEED)
        verdicts = [wf.run_epoch() for _ in range(EPOCHS)]
        verdicts.append(wf.sync_epoch())
        return wf, verdicts

    wf, vd = run(False, "deferred")
    assert vd[0] is None and all(v is not None for v in vd[1:])
    sync, _ = run(False, "sync")
    jwf, _ = run(True, "deferred")
    _bitwise((wf.decision.history, _weights(wf)), (sync.decision.history, _weights(sync)))
    _near_jax((wf.decision.history, _weights(wf)),
              (jwf.decision.history, _weights(jwf)))


class _Recorder:
    """A detector that records every ``(step, loss, grad_norm)`` fed."""

    def __init__(self):
        self.rows = []

    def observe_step(self, step, *, loss, grad_norm, step_seconds=None):
        self.rows.append((int(step), loss, grad_norm))
        return []


@pytest.mark.parametrize("family", ["mlp", "kohonen"])
def test_drained_watch_rows_match_jax(family):
    """Each scanned train step's watch row, drained at the epoch's sync:
    JAX's ``(loss, grad_norm)`` within rtol 1e-5, and bitwise what the
    port's step dispatch feeds two steps late."""
    make = FAMILIES[family]
    got = {}
    for key, (jax_side, dispatch) in {"jax": (True, "scan"), "scan": (False, "scan"),
                                      "step": (False, "step")}.items():
        wf = make(jax_side, dispatch)
        rec = _Recorder()
        wf.anomaly = rec
        wf.initialize(seed=SEED)
        for _ in range(2):
            wf.run_epoch()
        got[key] = rec.rows
    assert [r[0] for r in got["scan"]] == [r[0] for r in got["jax"]] == list(range(len(got["jax"])))
    np.testing.assert_allclose(np.array([r[1:] for r in got["scan"]]),
                               np.array([r[1:] for r in got["jax"]]), rtol=RTOL_WATCH)
    assert got["scan"] == got["step"]


def test_scan_path_rollback_matches_jax(tmp_path):
    """A NaN injected into one drained row of epoch 1 (after epoch 0's 4
    rows): the verdict surfaces at the epoch's sync, the rollback discards
    the epoch and replays it; the faulted run is bitwise the unfaulted one,
    as in the JAX package's own scan rollback test, and its events are
    JAX's."""
    def run(jax_side, fault, out=None):
        pol = (JaxPolicy if jax_side else RecoveryPolicy)(
            max_rollbacks=2, perturb=False, lr_backoff=1.0) if fault else None
        wf = _mlp(jax_side, recovery=pol, snapshot_dir=out,
                  snapshot_config={"interval": 1} if out else None)
        wf.initialize(seed=SEED)
        if fault:
            (jfaults if jax_side else faults).inject("train.step_nan", flag=True, times=1,
                                                     after=5)
        dec = wf.run()
        return wf, dec, pol

    wf, dec, pol = run(False, True, str(tmp_path / "port"))
    clean, cdec, _ = run(False, False)
    jwf, jdec, jpol = run(True, True, str(tmp_path / "jax"))
    assert pol.rollbacks_used == jpol.rollbacks_used == 1
    assert [(e["kind"], e["reason"], e["step"]) for e in pol.events] == [
        (e["kind"], e["reason"], e["step"]) for e in jpol.events]
    _bitwise((dec.history, _weights(wf)), (cdec.history, _weights(clean)))
    _near_jax((dec.history, _weights(wf)),
              (jdec.history, _weights(jwf)))


def test_skipped_batch_changes_the_step_count():
    """A batch the retry ladder skips makes a split of one step fewer: a
    new split run (as a jit retraces), the same numbers as the step
    dispatch with the same skip and as JAX's scan."""
    kw = {"loader_kw": {"fetch_retries": 0, "skip_bad_batches": True}}
    out = {}
    for key, (jax_side, dispatch) in {"jax": (True, "scan"), "scan": (False, "scan"),
                                      "step": (False, "step")}.items():
        wf = _mlp(jax_side, dispatch, **kw)
        wf.initialize(seed=SEED)
        wf.run_epoch()
        # the second epoch's first train fetch fails and is skipped
        (jfaults if jax_side else faults).inject("loader.fetch_flaky", times=1)
        wf.run_epoch()
        wf.run_epoch()
        out[key] = wf
    scan = out["scan"]
    hist = scan.decision.history
    assert [h["train"]["n_samples"] for h in hist] == [50.0, 34.0, 50.0]
    trains = sorted(int(r.rows["x"].shape[0]) for (s, _), r in scan._splits.items()
                    if s == "train")
    assert trains == [3, 4]
    assert scan.state.step == out["step"].state.step == 11
    _bitwise((hist, _weights(scan)), (out["step"].decision.history, _weights(out["step"])))
    _near_jax((hist, _weights(scan)),
              (out["jax"].decision.history, _weights(out["jax"])))


def test_snapshot_holds_no_pool_and_resumes_the_scan_exactly(tmp_path):
    wf = _mlp(False, snapshot_dir=str(tmp_path), snapshot_config={"interval": 1,
                                                                   "compress": False})
    full = _run(wf)
    path = wf.snapshotter._path("epoch0")
    state, host = load_snapshot(path)
    assert set(host) == {"decision", "loader", "prng"}
    assert "pool" not in str(sorted(host["loader"]))
    resumed = _mlp(False)
    resumed.initialize(snapshot=path)
    assert resumed._ctx is not None and resumed._splits == {}
    resumed.run()
    _bitwise((resumed.decision.history, _weights(resumed)), full)
