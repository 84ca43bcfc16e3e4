"""Snapshots and exact resume in the port, on the CPU.

The atomic write and its sha256 sidecar; a truncated file and a flipped
byte raise ``SnapshotCorruptError`` and ``find_latest_valid`` skips them;
3 uninterrupted epochs equal 1 epoch + a snapshot + a fresh workflow
resumed from it + 2 epochs, bitwise, with the prefetch thread on and a
dropout layer drawing from the train state's generator; a snapshot that
the JAX package's ``StandardWorkflow`` wrote loads into the port: its
evaluation within rtol 1e-5 and one further epoch within rtol 1e-4 of the
JAX package's own further epoch.
"""

import gzip
import hashlib
import os
import pickle

import numpy as np
import pytest
import torch

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
from znicz_tpu_torch.observability import get_registry, pipeline as t_pipeline
from znicz_tpu_torch.utils import faults
from znicz_tpu_torch.workflow import model as model_lib
from znicz_tpu_torch.workflow.snapshotter import (
    FORMAT_VERSION,
    JaxKeyLeaf,
    Snapshotter,
    SnapshotCorruptError,
    SnapshotWriteError,
    find_latest_valid,
    is_valid_snapshot,
    load_snapshot,
    verify_snapshot,
)
from znicz_tpu_torch.workflow.standard import StandardWorkflow

LAYERS = [
    {"type": "conv_relu", "->": {"n_kernels": 3, "kx": 3, "ky": 3},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "all2all_tanh", "->": {"output_sample_shape": 8},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 3},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
]
DROPOUT = LAYERS[:3] + [{"type": "dropout", "->": {"dropout_ratio": 0.3}}] + LAYERS[3:]
LR_POLICY = {"name": "step", "step_size": 4, "gamma": 0.5}


def _data():
    rng = np.random.default_rng(7)
    return (
        {"train": rng.random((30, 8, 8, 1), np.float32),
         "valid": rng.random((12, 8, 8, 1), np.float32)},
        {"train": rng.integers(0, 3, 30), "valid": rng.integers(0, 3, 12)},
    )


def _port(layers=LAYERS, seed=11, **kw):
    prng.reset()
    prng.seed_all(seed)
    data, labels = _data()
    loader = FullBatchLoader(data, labels, minibatch_size=7)
    wf = StandardWorkflow(loader, layers, device="cpu", lr_policy=LR_POLICY,
                          decision_config={"max_epochs": 20}, **kw)
    return wf


def _params(wf):
    return model_lib.params_to_numpy(wf.state.params)


def _bitwise(a, b):
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        assert la.keys() == lb.keys()
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k])


def _snapshotter(tmp_path, **kw):
    return Snapshotter(str(tmp_path / "snaps"), prefix="wf", **kw)


def _state():
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    return ([{"weights": w, "bias": torch.ones(3)}], [{"weights": w * 0, "bias": torch.zeros(3)}],
            np.asarray(5, np.int32), np.arange(16, dtype=np.uint8))


@pytest.mark.parametrize("compress", [True, False], ids=["gzip", "plain"])
def test_atomic_write_with_sidecar_after_the_data_file(tmp_path, compress):
    snap = _snapshotter(tmp_path, compress=compress)
    path = snap.save(_state(), {"decision": {"epoch": 3}}, tag="best")
    assert path == snap.best_path and path.endswith(".pickle.gz" if compress else ".pickle")
    names = sorted(os.listdir(snap.directory))
    assert names == sorted([os.path.basename(path), os.path.basename(path) + ".sha256"])
    digest, base, version = open(path + ".sha256").read().split()
    assert digest == hashlib.sha256(open(path, "rb").read()).hexdigest()
    assert (base, version) == (os.path.basename(path), f"v{FORMAT_VERSION}")
    opener = gzip.open if compress else open
    with opener(path, "rb") as f:
        payload = pickle.load(f)  # plain containers and numpy arrays only
    assert sorted(payload) == ["format_version", "host_state", "train_state"]
    params, velocity, step, key = payload["train_state"]
    assert type(payload["train_state"]) is tuple and type(params) is list
    assert isinstance(params[0]["weights"], np.ndarray) and params[0]["weights"].dtype == np.float32
    state, host = load_snapshot(path)
    np.testing.assert_array_equal(state[0][0]["weights"], np.arange(6).reshape(2, 3))
    assert int(state[2]) == 5 and host == {"decision": {"epoch": 3}}
    verify_snapshot(path)


def test_failed_write_keeps_the_previous_snapshot_and_is_counted(tmp_path):
    snap = _snapshotter(tmp_path, interval=1)
    first = snap.save(_state(), {"n": 1}, tag="best")
    before = open(first, "rb").read()
    failures = get_registry().counter(t_pipeline.SNAPSHOT_FAILURES_METRIC)
    n0 = failures.value
    with faults.injected("snapshot.write", times=1):
        with pytest.raises(SnapshotWriteError):
            snap.save(_state(), {"n": 2}, tag="best")
    assert open(first, "rb").read() == before
    assert not [n for n in os.listdir(snap.directory) if n.endswith(".tmp")]
    with faults.injected("snapshot.write"):
        assert snap.maybe_save(_state(), {"n": 3}, epoch=0, improved=True) is None
    assert failures.value - n0 == 2  # the best and the interval write, both counted
    assert load_snapshot(first)[1] == {"n": 1}


def _corrupt(path, how):
    data = bytearray(open(path, "rb").read())
    if how == "truncated":
        data = data[: len(data) // 2]
    else:
        data[len(data) // 2] ^= 0x01
    open(path, "wb").write(bytes(data))


@pytest.mark.parametrize("how", ["truncated", "flipped"])
@pytest.mark.parametrize("sidecar", [True, False], ids=["sidecar", "no_sidecar"])
def test_corrupt_snapshots_raise_and_are_skipped(tmp_path, how, sidecar):
    snap = _snapshotter(tmp_path, interval=1, keep=5)
    good = snap.maybe_save(_state(), {"epoch": 0}, epoch=0, improved=False)
    bad = snap.maybe_save(_state(), {"epoch": 1}, epoch=1, improved=False)
    os.utime(good, (1_000_000, 1_000_000))  # the corrupt one is the newest
    _corrupt(bad, how)
    if not sidecar:
        os.remove(bad + ".sha256")
    with pytest.raises(SnapshotCorruptError):
        load_snapshot(bad)
    assert not is_valid_snapshot(bad)
    assert find_latest_valid(snap.directory, prefix="wf") == good
    assert find_latest_valid(snap.directory, prefix="wf", exclude=[good]) is None
    assert find_latest_valid(str(tmp_path / "absent")) is None


def test_load_fault_point_and_unknown_classes_are_typed(tmp_path):
    snap = _snapshotter(tmp_path)
    path = snap.save(_state(), {}, tag="best")
    with faults.injected("snapshot.load", times=1):
        with pytest.raises(SnapshotCorruptError, match="injected"):
            load_snapshot(path)
    evil = str(tmp_path / "evil.pickle")
    with open(evil, "wb") as f:
        pickle.dump({"format_version": FORMAT_VERSION, "train_state": os.getcwd,
                     "host_state": {}}, f)
    with pytest.raises(SnapshotCorruptError, match="posix.getcwd"):
        load_snapshot(evil)
    other = str(tmp_path / "v2.pickle")
    with open(other, "wb") as f:
        pickle.dump({"format_version": 2, "train_state": (), "host_state": {}}, f)
    with pytest.raises(ValueError, match="format 2"):
        load_snapshot(other)


def test_bf16_leaves_are_refused_by_name(tmp_path):
    params, velocity, step, key = _state()
    params[0]["weights"] = params[0]["weights"].to(torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        _snapshotter(tmp_path).save((params, velocity, step, key), {}, tag="best")


def test_keep_prunes_periodic_snapshots(tmp_path):
    snap = _snapshotter(tmp_path, interval=1, keep=2)
    for epoch in range(4):
        snap.maybe_save(_state(), {"epoch": epoch}, epoch=epoch, improved=False)
    kept = sorted(n for n in os.listdir(snap.directory) if n.endswith(".gz"))
    assert kept == ["wf_epoch2.pickle.gz", "wf_epoch3.pickle.gz"]
    assert Snapshotter(snap.directory, prefix="wf", interval=1, keep=2)._kept == [
        os.path.join(snap.directory, n) for n in kept]


@pytest.mark.parametrize("layers", [LAYERS, DROPOUT], ids=["plain", "dropout"])
def test_resume_is_bitwise_with_prefetch_on(tmp_path, layers):
    ref = _port(layers)
    assert ref.prefetch_batches == 2
    ref.initialize()
    for _ in range(3):
        ref.run_epoch()
    first = _port(layers, snapshot_dir=str(tmp_path / "snaps"),
                  snapshot_config={"interval": 1})
    first.initialize()
    first.run_epoch()
    path = os.path.join(str(tmp_path / "snaps"), "StandardWorkflow_epoch0.pickle.gz")
    assert is_valid_snapshot(path)
    _, host = load_snapshot(path)
    assert host["loader"]["epoch_number"] == 1 and host["decision"]["epoch"] == 1
    # a fresh process's view: other streams drawn, then resumed
    prng.reset()
    prng.get("loader").permutation(50)
    resumed = _port(layers, seed=999)
    resumed.initialize(snapshot=path)
    assert resumed.state.step == first.state.step == 5
    for _ in range(2):
        resumed.run_epoch()
    _bitwise(_params(resumed), _params(ref))
    for a, b in zip(resumed.state.velocity, ref.state.velocity):
        for k in a:
            assert torch.equal(a[k], b[k])
    assert resumed.decision.history == ref.decision.history
    assert resumed.decision.epoch == ref.decision.epoch == 3
    assert resumed.loader.epoch_number == 3


def test_prng_round_trip_keeps_generator_identity():
    prng.reset()
    gen = prng.get("workflow")
    t = gen.generator("cpu")
    torch.rand(4, generator=t)
    state = prng.state_dict()
    want = torch.rand(4, generator=t)
    perm = gen.permutation(9)
    prng.load_state_dict(state)
    assert prng.get("workflow").generator("cpu") is t
    assert torch.equal(torch.rand(4, generator=t), want)
    np.testing.assert_array_equal(gen.permutation(9), perm)
    assert state["generators"]["workflow"]["torch_states"]["cpu"].dtype == np.uint8


# -- a JAX-written snapshot loads into the port ---------------------------------


def _jax_workflow(tmp_path):
    from znicz_tpu.core import prng as jprng
    from znicz_tpu.loader.fullbatch import FullBatchLoader as JaxLoader
    from znicz_tpu.workflow import StandardWorkflow as JaxStandard

    jprng.reset()
    jprng.seed_all(11)
    data, labels = _data()
    wf = JaxStandard(JaxLoader(data, labels, minibatch_size=7), LAYERS, lr_policy=LR_POLICY,
                     decision_config={"max_epochs": 20}, snapshot_dir=str(tmp_path / "jax"),
                     snapshot_config={"interval": 1}, prefetch_batches=0)
    wf.initialize()
    return wf


def test_jax_snapshot_loads_into_the_port(tmp_path):
    import jax

    jwf = _jax_workflow(tmp_path)
    jwf.run_epoch()
    jwf.run_epoch()
    # the JAX run's state after its second epoch
    path = os.path.join(str(tmp_path / "jax"), "StandardWorkflow_epoch1.pickle.gz")
    jstate, jhost = load_snapshot(path)
    assert type(jstate).__name__ == "JaxTrainState" and isinstance(jstate.key, JaxKeyLeaf)
    assert jhost["decision"]["epoch"] == jwf.decision.epoch == 2
    jeval = jwf.evaluate("valid")
    wf = _port(seed=123)
    wf.initialize(snapshot=path)
    assert wf.state.step == int(jax.device_get(jwf.state.step))
    assert wf.decision.history == jwf.decision.history
    got = wf.evaluate("valid")
    assert got["n_err"] == jeval["n_err"] and got["n_samples"] == jeval["n_samples"]
    np.testing.assert_allclose(got["loss"], jeval["loss"], rtol=1e-5)
    jverdict = jwf.run_epoch()
    verdict = wf.run_epoch()
    for split, m in jverdict["summary"].items():
        np.testing.assert_allclose(verdict["summary"][split]["loss"], m["loss"], rtol=1e-4)
        assert abs(verdict["summary"][split]["n_err"] - m["n_err"]) <= 1
    jparams = jax.device_get(jwf.state.params)
    for a, b in zip(_params(wf), jparams):
        for k in a:
            np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=1e-4, atol=1e-6)
    # the threefry key stays data and rides along into the port's snapshots
    st = prng.get("workflow").state_dict()
    assert "key" in st and st["seed"] == jhost["prng"]["generators"]["workflow"]["seed"]
