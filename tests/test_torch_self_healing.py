"""Self-healing training in the port against the JAX package, on the CPU.

The per-step anomaly watch (``[loss, grad_norm]`` read two steps late), the
rollback to the last good state under a ``RecoveryPolicy``, the graceful
stop with its emergency snapshot, deferred epoch sync, snapshots and exact
resume of the SOM, the RBM and the LM, and the loader's retry and skip
ladder.  Inputs come from numpy seeds and the shared named numpy streams, so
both frameworks start from the same bits.  Tolerances, each with its reason:

- the port against itself (a faulted, stopped or resumed run against the
  unfaulted one; deferred against sync): bitwise, since the same ops run
  on the same inputs in the same order;
- the watch vectors against JAX's: rtol 1e-5, one step's loss and global
  norm, the same sums in another order (oneDNN vs XLA);
- whole runs against JAX's: per-epoch loss and final weights rtol 1e-4
  (atol 1e-5 for weights near 0) and ``n_err`` equal, the tolerance every
  ported model meets: the same sums in another order over the steps.
"""

import os

import jax
import numpy as np
import pytest
import torch

from znicz_tpu import observability as jobs
from znicz_tpu.core import prng as jprng
from znicz_tpu.loader import datasets as jdatasets
from znicz_tpu.loader.fullbatch import FullBatchLoader as JaxLoader
from znicz_tpu.observability import pipeline as jpipeline
from znicz_tpu.observability.anomaly import StepAnomalyDetector as JaxDetector
from znicz_tpu.utils import faults as jfaults
from znicz_tpu.workflow import (
    KohonenWorkflow as JaxKohonen,
    RBMWorkflow as JaxRBM,
    RecoveryPolicy as JaxPolicy,
    Snapshotter as JaxSnapshotter,
    StandardWorkflow as JaxStandard,
    TransformerLMWorkflow as JaxLM,
)
from znicz_tpu.workflow.workflow import _global_norm as jax_global_norm
from znicz_tpu_torch import observability as tobs
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.loader import LoaderFetchError, datasets as tdatasets
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
from znicz_tpu_torch.observability import pipeline as tpipeline
from znicz_tpu_torch.observability.anomaly import StepAnomalyDetector
from znicz_tpu_torch.utils import faults
from znicz_tpu_torch.workflow import model as model_lib, unsupervised
from znicz_tpu_torch.workflow.recovery import (
    EXIT_PREEMPTED,
    NON_FINITE_TYPES,
    RecoveryPolicy,
    RollbackExhaustedError,
    TrainingPreempted,
)
from znicz_tpu_torch.workflow.snapshotter import (
    Snapshotter,
    find_latest_valid,
    load_snapshot,
    verify_snapshot,
)
from znicz_tpu_torch.workflow.standard import StandardWorkflow
from znicz_tpu_torch.workflow.transformer import TransformerLMWorkflow
from znicz_tpu_torch.workflow.unsupervised import KohonenWorkflow, RBMWorkflow

torch.set_float32_matmul_precision("highest")

SEED = 77
RTOL_WATCH = 1e-5
RTOL_EPOCH = 1e-4
RTOL_W, ATOL_W = 1e-4, 1e-5
MLP = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 16}},
    {"type": "softmax", "->": {"output_sample_shape": 10}},
]
HYPER = {"learning_rate": 0.1, "gradient_moment": 0.9}


@pytest.fixture(autouse=True)
def _clean():
    for f in (faults, jfaults):
        f.clear()
    tprng.reset()
    yield
    for f in (faults, jfaults):
        f.clear()
    # the give-up gauges are process-global
    tobs.gauge(tpipeline.ROLLBACK_GIVE_UP_METRIC).set(0.0)
    jobs.gauge(jpipeline.ROLLBACK_GIVE_UP_METRIC).set(0.0)
    tprng.reset()


def _seed_both(seed=SEED):
    for reg in (jprng, tprng):
        reg.reset()
        reg.seed_all(seed)


def _counter(name, *labels):
    """A counter's total, or its series with ``labels``."""
    fam = tobs.get_registry().metrics().get(name)
    if fam is None:
        return 0.0
    return sum(c.value for key, c in fam.children().items() if not labels or key == labels)


def _mnist(out=None, *, jax_side=False, max_epochs=4, loader_kwargs=None, prefetch=2, **kw):
    """The JAX package's self-healing fixture model: the MNIST stand-in
    (192 train, 32 test, batches of 64), a 16-unit tanh layer."""
    if jax_side:
        jprng.reset()
        jprng.seed_all(SEED)
        ld = jdatasets.mnist(n_train=192, n_test=32, minibatch_size=64, **(loader_kwargs or {}))
        cls, extra = JaxStandard, {}
    else:
        tprng.reset()
        tprng.seed_all(SEED)
        ld = tdatasets.mnist(n_train=192, n_test=32, minibatch_size=64, **(loader_kwargs or {}))
        cls, extra = StandardWorkflow, {"device": "cpu"}
    kw.setdefault("decision_config", {"max_epochs": max_epochs})
    return cls(ld, MLP, default_hyper=HYPER, snapshot_dir=str(out) if out else None,
               prefetch_batches=prefetch, **extra, **kw)


def _history(dec):
    return [(h["train"]["n_err"], h["train"]["loss"], h.get("test", {}).get("loss"))
            for h in dec.history]


def _weights(wf):
    if isinstance(wf.state.params, dict):
        return [{k: v.detach().numpy() for k, v in wf.state.params.items()}]
    return model_lib.params_to_numpy(wf.state.params)


def _jweights(jwf):
    p = jax.device_get(jwf.state.params)
    return [p] if isinstance(p, dict) else p


def _bitwise(a, b):
    assert _history(a.decision) == _history(b.decision)
    for la, lb in zip(_weights(a), _weights(b)):
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k])


def _near_jax(wf, jwf):
    """A port run against a JAX run: per-epoch loss rtol 1e-4, n_err equal,
    final weights rtol 1e-4."""
    got, want = _history(wf.decision), _history(jwf.decision)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        np.testing.assert_allclose(g[1:], w[1:], rtol=RTOL_EPOCH)
    for lt, lj in zip(_weights(wf), _jweights(jwf)):
        for k in lt:
            np.testing.assert_allclose(lt[k], np.asarray(lj[k]), rtol=RTOL_W, atol=ATOL_W)


@pytest.fixture(scope="module")
def jax_unfaulted():
    """The JAX package's unfaulted MNIST run (4 epochs)."""
    jwf = _mnist(jax_side=True)
    jwf.initialize(seed=SEED)
    jwf.run()
    tprng.reset()
    return jwf


@pytest.fixture(scope="module")
def port_unfaulted():
    wf = _mnist()
    wf.initialize(seed=SEED)
    wf.run()
    tprng.reset()
    return wf


def test_port_unfaulted_run_matches_jax(port_unfaulted, jax_unfaulted):
    _near_jax(port_unfaulted, jax_unfaulted)


# -- the watch vector ------------------------------------------------------------


def _recorders():
    class Recorder(StepAnomalyDetector):
        def __init__(self):
            super().__init__()
            self.seen = []

        def observe_step(self, step, *, loss, grad_norm=None, step_seconds=None):
            self.seen.append((step, loss, grad_norm))
            return super().observe_step(step, loss=loss, grad_norm=grad_norm,
                                        step_seconds=step_seconds)

    class JaxRecorder(JaxDetector):
        def __init__(self):
            super().__init__()
            self.seen = []

        def observe_step(self, step, *, loss, grad_norm=None, step_seconds=None):
            self.seen.append((step, loss, grad_norm))
            return super().observe_step(step, loss=loss, grad_norm=grad_norm,
                                        step_seconds=step_seconds)

    return Recorder(), JaxRecorder()


def _alexnet_shaped(jax_side):
    gd = {"learning_rate": 0.05, "gradient_moment": 0.9, "weights_decay": 0.0005}
    layers = [
        {"type": "conv_relu", "->": {"n_kernels": 8, "kx": 5, "ky": 5, "sliding": (2, 2)}, "<-": gd},
        {"type": "norm", "->": {"n": 5}},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"type": "all2all_relu", "->": {"output_sample_shape": 16}, "<-": gd},
        {"type": "softmax", "->": {"output_sample_shape": 10}, "<-": gd},
    ]
    rng = np.random.default_rng(4321)
    x = rng.integers(0, 256, (40, 24, 24, 3), dtype=np.uint8)
    y = rng.integers(0, 10, 40).astype(np.int32)
    kw = dict(minibatch_size=8, normalization="range",
              normalization_kwargs={"scale": 255.0, "shift": -0.5})
    if jax_side:
        return JaxStandard(JaxLoader({"train": x}, {"train": y}, **kw), layers,
                           decision_config={"max_epochs": 2})
    return StandardWorkflow(FullBatchLoader({"train": x}, {"train": y}, **kw), layers,
                            decision_config={"max_epochs": 2}, device="cpu")


def _lm(jax_side, tokens, snapshotter=None, **kw):
    cls, extra = (JaxLM, {}) if jax_side else (TransformerLMWorkflow, {"device": "cpu"})
    loader = (JaxLoader if jax_side else FullBatchLoader)({"train": tokens.copy()}, minibatch_size=8)
    return cls(loader, vocab=16, d_model=32, n_layers=1, n_heads=2, max_epochs=4,
               snapshotter=snapshotter, **extra, **kw)


def _tokens():
    return np.random.default_rng(7).integers(0, 16, (16, 24)).astype(np.int32)


@pytest.mark.parametrize("model", ["mnist", "alexnet_norm", "lm", "kohonen"])
def test_watch_vectors_match_jax(model):
    """The ``(step, loss, grad_norm)`` each detector is fed: the port's and
    the JAX package's within rtol 1e-5 (for the SOM the update norm
    ``||params' - params||``, which JAX takes with ``_global_norm``)."""
    rec, jrec = _recorders()
    _seed_both()
    if model == "mnist":
        wf, jwf = _mnist(), _mnist(jax_side=True)
    elif model == "alexnet_norm":
        wf, jwf = _alexnet_shaped(False), _alexnet_shaped(True)
    elif model == "lm":
        wf, jwf = _lm(False, _tokens()), _lm(True, _tokens())
    else:
        kw = dict(n_train=250, n_test=0, minibatch_size=100, normalization="mean_disp")
        wkw = dict(sx=4, sy=4, total_epochs=2, lr0=0.5, lr1=0.05, sigma1=0.7)
        wf = KohonenWorkflow(tdatasets.mnist(**kw), device="cpu", **wkw)
        jwf = JaxKohonen(jdatasets.mnist(**kw), **wkw)
    wf.anomaly, jwf.anomaly = rec, jrec
    wf.initialize(seed=SEED)
    jwf.initialize(seed=SEED)
    for _ in range(2):
        wf.run_epoch()
        jwf.run_epoch()
    assert len(rec.seen) == len(jrec.seen) == 2 * wf.loader.n_minibatches("train")
    assert [s for s, _, _ in rec.seen] == [s for s, _, _ in jrec.seen] == list(range(len(rec.seen)))
    np.testing.assert_allclose([v[1:] for v in rec.seen], [v[1:] for v in jrec.seen],
                               rtol=RTOL_WATCH)
    assert all(np.isfinite(v[2]) and v[2] > 0 for v in rec.seen)


def test_som_update_norm_at_step_one_is_jax_global_norm():
    """One SOM step by hand: the watch's second entry is
    ``_global_norm(params' - params)`` of the JAX package."""
    kw = dict(n_train=100, n_test=0, minibatch_size=100, normalization="mean_disp")
    _seed_both()
    wf = KohonenWorkflow(tdatasets.mnist(**kw), sx=4, sy=4, device="cpu")
    wf.initialize(seed=SEED)
    before = {k: v.numpy().copy() for k, v in wf.state.params.items()}
    mb = next(wf.loader.batches("train"))
    wf.train_step(torch.as_tensor(mb.data), torch.as_tensor(mb.labels), torch.as_tensor(mb.mask))
    vec, event = wf._last_watch
    assert event is None and vec.dtype == torch.float32 and vec.shape == (2,)
    after = {k: v.numpy() for k, v in wf.state.params.items()}
    want = float(jax_global_norm({k: after[k] - before[k] for k in after}))
    np.testing.assert_allclose(float(vec[1]), want, rtol=RTOL_WATCH)


@pytest.mark.parametrize("anomaly", [False, None])
def test_watch_off_adds_no_work(anomaly):
    wf = _mnist(anomaly=anomaly)
    wf.initialize(seed=SEED)

    def no_vector(*_):
        raise AssertionError("a watch vector was made with the watch off")

    wf._watch_vector = no_vector
    wf.run_epoch()
    assert wf.anomaly is None and wf._last_watch is None


def test_watch_reads_lag_two_steps():
    wf = _mnist()
    lags = []

    class Lag(StepAnomalyDetector):
        def observe_step(self, step, **kw):
            lags.append((step, wf.state.step - 1 - step))
            return super().observe_step(step, **kw)

    wf.anomaly = Lag()
    wf.initialize(seed=SEED)
    wf.run_epoch()
    # 3 train steps: the first read two steps late, the last two drained at
    # the epoch's end (one and zero steps late)
    assert lags == [(0, 2), (1, 1), (2, 0)]


def test_grad_norm_overflows_in_float32_as_jax():
    """Per-tensor norms whose squares fit float32 but whose total does not:
    JAX's ``_global_norm`` sums in float32 and reads inf, and so does the
    watch, which then raises ``non_finite_grad_norm``."""
    big = np.float32(1.5e19)  # big**2 = 2.25e38 < float32's 3.4e38
    jax_norm = float(jax_global_norm([np.array([big], np.float32)] * 2))
    wf = _mnist()
    wf.initialize(seed=SEED)
    verdicts = wf._feed_watch(0, (torch.tensor([1.0, big, big], dtype=torch.float32), None))
    assert np.isinf(jax_norm)
    assert [v["type"] for v in verdicts] == ["non_finite_grad_norm"]
    # one tensor alone stays finite, in both
    assert np.isfinite(float(jax_global_norm([np.array([big], np.float32)])))
    assert wf._feed_watch(1, (torch.tensor([1.0, big], dtype=torch.float32), None)) == []


# -- rollback ----------------------------------------------------------------------


def _faulted(jax_side, out=None, *, pol_kw=None, after=7, prefetch=2, **kw):
    policy = (JaxPolicy if jax_side else RecoveryPolicy)(
        **(pol_kw or {"max_rollbacks": 2, "lr_backoff": 1.0, "perturb": False}))
    wf = _mnist(out, jax_side=jax_side, recovery=policy, prefetch=prefetch, **kw)
    wf.initialize(seed=SEED)
    (jfaults if jax_side else faults).inject("train.step_nan", flag=True, times=1, after=after)
    wf.run()
    return wf, policy


def _event_key(e):
    src = "epoch-start buffer" if e["source"] == "epoch-start buffer" else "snapshot file"
    return e["kind"], e["reason"], e["step"], src, e["lr_scale"]


@pytest.fixture(scope="module")
def jax_faulted(tmp_path_factory):
    """JAX's faulted runs: with and without a snapshot directory, and
    deferred (its rollback source is the newest snapshot file)."""
    out = {}
    for case in ("snapshots", "buffer", "deferred"):
        jfaults.clear()
        d = tmp_path_factory.mktemp(f"jax_{case}")
        kw = {"epoch_sync": "deferred"} if case == "deferred" else {}
        out[case] = _faulted(True, None if case == "buffer" else d,
                             snapshot_config=None if case == "buffer" else {"interval": 1}, **kw)
    jfaults.clear()
    tprng.reset()
    return out


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("case", ["snapshots", "buffer", "deferred"])
def test_nan_rollback_golden_matches_unfaulted(tmp_path, port_unfaulted, jax_faulted, case,
                                               prefetch):
    """An injected NaN at step 7 (mid epoch 2): the detector raises
    ``non_finite_loss`` two steps later, the run rolls back (the epoch-start
    buffer in sync mode, with or without a snapshot directory; the newest
    snapshot file in deferred mode) and replays.  The port's faulted run is
    bitwise its unfaulted run, at prefetch depth 0 and 2, and matches JAX's
    faulted run and its events."""
    before = _counter(tpipeline.ROLLBACKS_METRIC, "non_finite_loss")
    kw = {"epoch_sync": "deferred"} if case == "deferred" else {}
    wf, pol = _faulted(False, None if case == "buffer" else tmp_path, prefetch=prefetch,
                       snapshot_config=None if case == "buffer" else {"interval": 1}, **kw)
    jwf, jpol = jax_faulted[case]
    assert pol.rollbacks_used == jpol.rollbacks_used == 1
    assert [_event_key(e) for e in pol.events] == [_event_key(e) for e in jpol.events]
    assert pol.events[0]["reason"] == "non_finite_loss"
    # detected within 3 steps of the poisoned step 7
    assert 7 < pol.events[0]["step"] <= 7 + 3
    want_src = "snapshot file" if case == "deferred" else "epoch-start buffer"
    assert _event_key(pol.events[0])[3] == want_src
    _bitwise(wf, port_unfaulted)
    _near_jax(wf, jwf)
    assert _counter(tpipeline.ROLLBACKS_METRIC, "non_finite_loss") == before + 1


def test_rollback_restores_the_epoch_start_buffer_bitwise():
    """The restored params, momentum, step and generator are the buffer's,
    bit for bit, and the buffer is a copy the replay never touches."""
    pol = RecoveryPolicy(max_rollbacks=2, lr_backoff=1.0, perturb=False)
    wf = _mnist(recovery=pol)
    wf.initialize(seed=SEED)
    wf.run_epoch()
    seen = {}
    real = wf._execute_rollback

    def spy(reason):
        buf_state, _ = wf._epoch_start
        seen["buffer"] = [{k: v.clone() for k, v in layer.items()} for layer in buf_state[0]]
        real(reason)
        seen["restored"] = [{k: v.detach().clone() for k, v in layer.items()}
                            for layer in wf.state.params]
        seen["aliases"] = any(a.data_ptr() == b.data_ptr()
                              for la, lb in zip(buf_state[0], wf.state.params)
                              for a, b in zip(la.values(), lb.values()))
        seen["step"] = (wf.state.step, int(buf_state[2]))
        seen["gen"] = torch.equal(wf.state.generator.get_state(),
                                  torch.from_numpy(buf_state[3]))

    wf._execute_rollback = spy
    faults.inject("train.step_nan", flag=True, times=1, after=1)  # step 4
    assert wf.run_epoch() is None  # the aborted epoch has no verdict
    for la, lb in zip(seen["buffer"], seen["restored"]):
        for k in la:
            assert torch.equal(la[k], lb[k])
    assert not seen["aliases"] and seen["gen"]
    assert seen["step"] == (3, 3)
    assert all(w.requires_grad for layer in wf.state.params for w in layer.values())


class _PoisonOnce:
    """``fill`` that returns NaN data on the k-th train batch, once."""

    def __init__(self, loader, k):
        self.fill, self.k, self.n, self.done = loader.fill, k, 0, False
        loader.fill = self

    def __call__(self, idx, split):
        mb = self.fill(idx, split)
        if split == "train":
            if self.n == self.k and not self.done:
                self.done = True
                mb = mb._replace(data=np.full_like(mb.data, np.nan))
            self.n += 1
        return mb


@pytest.mark.parametrize("prefetch", [0, 2])
def test_poisoned_batch_rolls_back_golden(port_unfaulted, prefetch):
    """A real NaN batch (train batch 7, once), not an injected reading: the
    state is poisoned, the detector raises within 3 steps, the rollback
    replays the epoch from its start, and the run ends bitwise equal to the
    unfaulted one; JAX's does the same, within rtol 1e-4."""
    runs = []
    for jax_side in (False, True):
        pol = (JaxPolicy if jax_side else RecoveryPolicy)(lr_backoff=1.0, perturb=False)
        wf = _mnist(jax_side=jax_side, recovery=pol, prefetch=prefetch)
        poison = _PoisonOnce(wf.loader, 7)
        wf.initialize(seed=SEED)
        wf.run()
        assert poison.done and pol.rollbacks_used == 1
        assert pol.events[0]["reason"] == "non_finite_loss"
        assert 7 < pol.events[0]["step"] <= 7 + 3
        runs.append((wf, pol))
    (wf, pol), (jwf, jpol) = runs
    assert [_event_key(e) for e in pol.events] == [_event_key(e) for e in jpol.events]
    _bitwise(wf, port_unfaulted)
    _near_jax(wf, jwf)


def test_budget_exhaustion_is_a_typed_give_up():
    pol = RecoveryPolicy(max_rollbacks=1, perturb=False, lr_backoff=1.0)
    wf = _mnist(recovery=pol)
    wf.initialize(seed=SEED)
    faults.inject("train.step_nan", flag=True)  # every step reads NaN
    with pytest.raises(RollbackExhaustedError, match="budget"):
        wf.run()
    assert pol.gave_up and pol.rollbacks_used == 1
    assert [e["kind"] for e in pol.events] == ["rollback", "give_up"]
    gauge = tobs.get_registry().metrics()[tpipeline.ROLLBACK_GIVE_UP_METRIC]
    assert any(c.value == 1.0 for c in gauge.children().values())
    assert pol.report()["gave_up"] is True


def test_no_restore_point_is_a_typed_give_up():
    """Deferred mode retains no epoch start; without a snapshot file there is
    nothing to roll back to."""
    pol = RecoveryPolicy()
    wf = _mnist(recovery=pol, epoch_sync="deferred")
    wf.initialize(seed=SEED)
    faults.inject("train.step_nan", flag=True, times=1)
    with pytest.raises(RollbackExhaustedError, match="no valid snapshot"):
        wf.run()
    assert pol.events[-1]["kind"] == "give_up"


def test_recovery_requires_the_detector():
    with pytest.raises(ValueError, match="anomaly"):
        _mnist(anomaly=False, recovery=RecoveryPolicy())


def test_policy_validation_and_constants():
    for bad in ({"max_rollbacks": 0}, {"lr_backoff": 0.0}, {"lr_backoff": 1.5},
                {"rollback_on_spike": -1}):
        with pytest.raises(ValueError):
            RecoveryPolicy(**bad)
    assert EXIT_PREEMPTED == 75
    assert NON_FINITE_TYPES == ("non_finite_loss", "non_finite_grad_norm")
    pol = RecoveryPolicy(rollback_on_spike=2)
    assert pol.should_rollback([{"type": "loss_spike"}]) is None
    assert pol.should_rollback([{"type": "loss_spike"}]) == "loss_spike"
    assert pol.should_rollback([{"type": "step_time_regression"}]) is None


def test_perturbed_rollback_replays_jax_order(tmp_path):
    """``perturb=True`` advances the shuffle stream by one permutation after
    the restore and ``lr_backoff`` halves the rate: the replayed order is
    JAX's exactly, the run matches JAX's within rtol 1e-4."""
    kw = dict(pol_kw={"max_rollbacks": 2, "lr_backoff": 0.5, "perturb": True})
    jwf, jpol = _faulted(True, **kw)
    jorder = jwf.loader._order["train"].copy()
    wf, pol = _faulted(False, **kw)
    assert pol.lr_scale == jpol.lr_scale == 0.5
    np.testing.assert_array_equal(wf.loader._order["train"], jorder)
    _near_jax(wf, jwf)


# -- the graceful stop ---------------------------------------------------------------


@pytest.mark.parametrize("epoch_sync", ["sync", "deferred"])
def test_stop_between_epochs_writes_an_emergency_snapshot(tmp_path, port_unfaulted,
                                                         epoch_sync):
    wf = _mnist(tmp_path, epoch_sync=epoch_sync)
    wf.initialize(seed=SEED)
    wf.run_epoch()
    wf.run_epoch()
    wf.request_stop()
    with pytest.raises(TrainingPreempted) as info:
        wf.run_epoch()
    path = info.value.snapshot_path
    assert path and "emergency" in path
    verify_snapshot(path)
    assert find_latest_valid(str(tmp_path)) == path
    resumed = _mnist()
    resumed.initialize(snapshot=path)
    assert resumed.decision.epoch == 2  # deferred flushed its pending epoch
    resumed.run()
    _bitwise(resumed, port_unfaulted)


@pytest.mark.parametrize("epoch_sync,stop_step,epoch", [("sync", 4, 1), ("deferred", 7, 2)])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_mid_epoch_stop_resumes_golden(tmp_path, port_unfaulted, jax_unfaulted, epoch_sync,
                                       stop_step, epoch, prefetch):
    """A stop in mid-epoch: the emergency snapshot is the aborted epoch's
    start (sync: the epoch-start buffer; deferred: the retained end of the
    pending epoch with its flushed decision), so the resumed run replays
    that epoch and finishes bitwise equal to the uninterrupted one."""
    wf = _mnist(tmp_path / "b", epoch_sync=epoch_sync, prefetch=prefetch)
    if epoch_sync == "sync":
        wf.enable_emergency_snapshots()
    wf.initialize(seed=SEED)

    def stop_at(base, step):
        if step == stop_step:
            wf.request_stop()
        return base

    wf.lr_policy = stop_at
    with pytest.raises(TrainingPreempted) as info:
        wf.run()
    snap = info.value.snapshot_path
    assert snap == find_latest_valid(str(tmp_path / "b")) and "emergency" in snap
    # the step whose lr asked for the stop ran; the next did not dispatch
    assert wf.state.step == stop_step + 1
    resumed = _mnist(tmp_path / "c", prefetch=prefetch)
    resumed.initialize(snapshot=snap)
    assert resumed.decision.epoch == epoch
    resumed.run()
    _bitwise(resumed, port_unfaulted)
    _near_jax(resumed, jax_unfaulted)


def test_stop_without_a_snapshotter_is_still_typed():
    wf = _mnist()
    wf.initialize(seed=SEED)
    wf.request_stop()
    with pytest.raises(TrainingPreempted) as info:
        wf.run_epoch()
    assert info.value.snapshot_path is None


# -- deferred epoch sync ---------------------------------------------------------------


def _small(epoch_sync, *, seed=81, max_epochs=4, fail_iterations=100, snapshotter=None):
    tprng.reset()
    tprng.seed_all(seed)
    gen = np.random.default_rng(19 if seed != 85 else 21)
    images = gen.integers(0, 256, (96, 8, 8, 1), dtype=np.uint8)
    labels = (images.mean(axis=(1, 2, 3)) > 127).astype(np.int32)
    loader = FullBatchLoader({"train": images}, {"train": labels}, minibatch_size=32,
                             normalization="range",
                             normalization_kwargs={"scale": 255.0, "shift": -0.5})
    wf = StandardWorkflow(
        loader,
        [{"type": "all2all_tanh", "->": {"output_sample_shape": 8}},
         {"type": "softmax", "->": {"output_sample_shape": 2}}],
        decision_config={"max_epochs": max_epochs, "fail_iterations": fail_iterations},
        default_hyper=HYPER, epoch_sync=epoch_sync, device="cpu", name="workflow",
    )
    wf.snapshotter = snapshotter
    wf.initialize(seed=seed)
    return wf


def test_deferred_history_equals_sync():
    a = _small("sync")
    da = a.run()  # the streams are global: one run after the other
    b = _small("deferred")
    db = b.run()
    assert len(da.history) == len(db.history) == 4  # the exact stop
    assert da.history == db.history
    _bitwise(a, b)


def test_deferred_patience_stop_runs_no_extra_epoch():
    da = _small("sync", max_epochs=50, fail_iterations=2, seed=83).run()
    db = _small("deferred", max_epochs=50, fail_iterations=2, seed=83).run()
    assert len(da.history) == len(db.history) < 50
    assert da.best_epoch == db.best_epoch


def test_deferred_run_epoch_lags_one_verdict():
    wf = _small("deferred")
    assert wf.run_epoch() is None  # epoch 0 dispatched, nothing done
    v0 = wf.run_epoch()  # epoch 1 dispatched, epoch 0 reported
    assert v0 is not None and not v0["stop"]
    assert wf.decision.epoch == 1
    assert wf.sync_epoch() is not None  # flush epoch 1
    assert wf.sync_epoch() is None
    assert wf.decision.epoch == 2


@pytest.mark.parametrize("save_best", [True, False], ids=["best", "interval"])
def test_deferred_snapshots_are_the_bytes_of_sync(tmp_path, save_best):
    """Deferred sync with ``save_best`` writes each best snapshot from the
    epoch's retained state; interval epochs flush before the next dispatch.
    The files are byte-identical to sync mode's (uncompressed: gzip
    headers hold an mtime)."""
    for mode in ("sync", "deferred"):
        snap = Snapshotter(str(tmp_path / mode), compress=False, interval=2,
                           save_best=save_best)
        _small(mode, seed=85, max_epochs=5, snapshotter=snap).run()
    tags = ("best", "epoch1", "epoch3") if save_best else ("epoch1", "epoch3")
    for tag in tags:
        s = (tmp_path / "sync" / f"workflow_{tag}.pickle").read_bytes()
        d = (tmp_path / "deferred" / f"workflow_{tag}.pickle").read_bytes()
        assert s == d, tag


def test_snapshotter_assigned_after_dispatch_raises(tmp_path):
    wf = _small("deferred")
    assert wf.run_epoch() is None
    wf.snapshotter = Snapshotter(str(tmp_path), compress=False)
    with pytest.raises(ValueError, match="assigned after"):
        wf.run_epoch()


# -- snapshots of the SOM, the RBM and the LM ---------------------------------------------


def _unsup(kind, jax_side=False, snapshotter=None):
    ld_kw = dict(n_train=250, n_test=60, minibatch_size=100,
                 normalization="mean_disp" if kind == "kohonen" else "linear")
    ld = (jdatasets if jax_side else tdatasets).mnist(**ld_kw)
    if kind == "rbm":
        for split, arr in ld.data.items():
            ld.data[split] = (arr + 1.0) / 2.0
        cls = JaxRBM if jax_side else RBMWorkflow
        kw = dict(n_hidden=16, learning_rate=0.1, cd_k=1, max_epochs=4)
    else:
        cls = JaxKohonen if jax_side else KohonenWorkflow
        kw = dict(sx=4, sy=4, total_epochs=4, lr0=0.5, lr1=0.05, sigma1=0.7)
    if jax_side:
        return cls(ld, snapshotter=snapshotter, prefetch_batches=0, **kw)
    return cls(ld, snapshotter=snapshotter, device="cpu", **kw)


def _build(kind, jax_side=False, snap_dir=None):
    snapshotter = None
    if snap_dir:
        snapshotter = (JaxSnapshotter if jax_side else Snapshotter)(
            str(snap_dir), kind, interval=1, compress=False)
    if kind == "lm":
        return _lm(jax_side, _tokens(), snapshotter)
    return _unsup(kind, jax_side, snapshotter)


@pytest.mark.parametrize("kind", ["lm", "kohonen", "rbm"])
def test_crash_at_epoch_k_resumes_golden(tmp_path, kind):
    """``train.crash`` entering epoch 2, then ``find_latest_valid`` and a
    fresh workflow resumed from it: bitwise the uninterrupted run (the
    RBM's Philox chain is keyed by the restored step)."""
    _seed_both(13)
    ref = _build(kind)
    ref.initialize(seed=13)
    ref.run()
    _seed_both(13)
    crashed = _build(kind, snap_dir=tmp_path)
    crashed.initialize(seed=13)
    faults.inject("train.crash", after=2, times=1)
    with pytest.raises(faults.FaultInjected):
        crashed.run()
    faults.clear()
    snap = find_latest_valid(str(tmp_path), prefix=kind)
    assert snap is not None
    _seed_both(13)
    resumed = _build(kind)
    tprng.get("loader").permutation(50)  # other draws, overwritten by the resume
    resumed.initialize(snapshot=snap)
    assert resumed.decision.epoch == 2
    assert resumed.state.step == crashed.state.step
    resumed.run()
    assert resumed.decision.history == ref.decision.history
    for la, lb in zip(_weights(resumed), _weights(ref)):
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k])


@pytest.mark.parametrize("kind", ["lm", "kohonen", "rbm"])
def test_jax_snapshot_loads_into_the_port(tmp_path, kind):
    """A snapshot the JAX package wrote after epoch 1 loads into the port.
    The SOM and the LM continue within rtol 1e-4 of JAX's continuation; the
    RBM's draws differ by design (Philox against threefry), so its check is
    the resumed params and step, equal to the snapshot's."""
    _seed_both(13)
    jwf = _build(kind, jax_side=True, snap_dir=tmp_path)
    jwf.initialize(seed=13)
    jwf.run_epoch()
    jwf.run_epoch()
    path = os.path.join(str(tmp_path), f"{kind}_epoch1.pickle")
    jstate, _ = load_snapshot(path)
    wf = _build(kind)
    wf.initialize(snapshot=path)
    assert wf.state.step == int(np.asarray(jstate.step)) == int(jax.device_get(jwf.state.step))
    assert wf.decision.epoch == 2
    want = [jstate.params] if isinstance(jstate.params, dict) else jstate.params
    for lt, lj in zip(_weights(wf), want):
        for k in lj:
            np.testing.assert_array_equal(lt[k], np.asarray(lj[k]))
    if isinstance(wf.state.params, dict):
        assert not any(v.requires_grad for v in wf.state.params.values())
    if kind == "rbm":
        return
    for _ in range(2):
        got, want = wf.run_epoch()["summary"], jwf.run_epoch()["summary"]
        for split, m in want.items():
            np.testing.assert_allclose(got[split]["loss"], m["loss"], rtol=RTOL_EPOCH)
    _near_jax_params(wf, jwf)


def _near_jax_params(wf, jwf):
    for lt, lj in zip(_weights(wf), _jweights(jwf)):
        for k in lt:
            np.testing.assert_allclose(lt[k], np.asarray(lj[k]), rtol=RTOL_W, atol=ATOL_W)


def test_update_norms_are_the_norms_of_the_delta():
    params = {"weights": torch.arange(6.0).reshape(2, 3), "bias": torch.zeros(2)}
    new = {"weights": params["weights"] + 1.0, "bias": torch.tensor([3.0, 4.0])}
    got = [float(n) for n in unsupervised.update_norms(params, new)]
    assert got == pytest.approx([6.0 ** 0.5, 5.0])


# -- the loader's retry and skip ladder -----------------------------------------------------


def test_flaky_fetch_retries_transparently(port_unfaulted):
    before = _counter(tpipeline.LOADER_RETRIES_METRIC)
    wf = _mnist(loader_kwargs={"fetch_retries": 3, "fetch_backoff_s": 0.0})
    wf.initialize(seed=SEED)
    faults.inject("loader.fetch_flaky", times=2)
    wf.run()
    _bitwise(wf, port_unfaulted)  # the retries are invisible to the run
    assert _counter(tpipeline.LOADER_RETRIES_METRIC) == before + 2


@pytest.mark.parametrize("prefetch", [0, 2])
def test_retry_budget_exhaustion_is_typed(prefetch):
    wf = _mnist(loader_kwargs={"fetch_retries": 1, "fetch_backoff_s": 0.0}, prefetch=prefetch)
    wf.initialize(seed=SEED)
    faults.inject("loader.fetch_flaky")  # every attempt fails
    with pytest.raises(LoaderFetchError, match="2 time"):
        wf.run()


def test_skipped_bad_batch_is_counted():
    before = _counter(tpipeline.LOADER_SKIPPED_METRIC)
    wf = _mnist(max_epochs=1, loader_kwargs={"fetch_retries": 0, "skip_bad_batches": True})
    wf.initialize(seed=SEED)
    faults.inject("loader.fetch_flaky", times=1)
    dec = wf.run()
    assert _counter(tpipeline.LOADER_SKIPPED_METRIC) == before + 1
    # one 64-row train batch dropped from the 192-sample epoch
    assert dec.history[0]["train"]["n_samples"] == 128.0


def test_balanced_shuffling_matches_jax():
    """Class-balanced shuffling, refused until the device pool slice: the
    MNIST stand-in's train order equals the JAX package's, epoch by
    epoch, from the same seed, and every minibatch of 20 holds each
    class of the 100 samples in proportion within two samples."""
    _seed_both()
    tl = tdatasets.mnist(n_train=100, n_test=0, minibatch_size=20, balanced=True)
    jl = jdatasets.mnist(n_train=100, n_test=0, minibatch_size=20, balanced=True)
    for _ in range(3):
        got = [mb.indices for _, mb in tl.epoch()]
        want = [mb.indices for _, mb in jl.epoch()]
        np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    counts = np.bincount(tl.labels["train"], minlength=10)
    for idx in got:
        per = np.bincount(tl.labels["train"][idx], minlength=10)
        assert np.all(np.abs(per - counts / 5) <= 2.0), (per, counts)


@pytest.mark.parametrize("name", ["mnist", "wine", "cifar", "mnist_ae", "video_ae", "kanji",
                                  "yale_faces"])
def test_every_layer_list_model_takes_the_self_healing_keywords(name):
    """``build_workflow`` passes ``epoch_sync``, ``anomaly`` and ``recovery``
    through ``StandardWorkflow`` to the loop."""
    import importlib

    mod = importlib.import_module(f"znicz_tpu_torch.models.{name}")
    pol, det = RecoveryPolicy(), StepAnomalyDetector()
    wf = mod.build_workflow(device="cpu", epoch_sync="deferred", anomaly=det, recovery=pol)
    assert (wf.epoch_sync, wf.anomaly, wf.recovery) == ("deferred", det, pol)
