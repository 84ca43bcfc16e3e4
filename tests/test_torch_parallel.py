"""The port's data-parallel layer against the JAX package's, in one process
on the CPU.

The mesh's spec parser, its errors and the row-ownership check give the JAX
package's outputs and messages; ``make_mesh`` in a world of one process
builds a 1x1 mesh and refuses what needs more ranks (one process a device:
the JAX package's 8-device single-process meshes have no counterpart) or a
model or pipe axis (ROADMAP.md A6, A7).  The loader's process shards
(R = 2, 4) and pool shards (D = 2, 4) serve the JAX loader's indices,
masks, orders and local addresses exactly, padded last batch included, and
the ranks' batches put together are the unsharded loader's.  A
``DataParallel`` over a world of one trains bitwise as the workflow with no
policy.  The two-process runs are in ``tests/test_torch_multihost.py``.
"""

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from znicz_tpu.core import prng as jprng
from znicz_tpu.loader import base as jbase
from znicz_tpu.loader import FullBatchLoader as JaxFullBatch
from znicz_tpu.parallel import mesh as jmesh
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.loader import FullBatchLoader, base as tbase, datasets as tdatasets
from znicz_tpu_torch.parallel import DataParallel, make_mesh, mesh as tmesh
from znicz_tpu_torch.parallel import data_parallel as tdp
from znicz_tpu_torch.workflow import StandardWorkflow

MLP = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 32}},
    {"type": "softmax", "->": {"output_sample_shape": 10}},
]


def _seed_both(seed):
    for reg in (jprng, tprng):
        reg.reset()
        reg.seed_all(seed)


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as exc:  # the type and message are what is compared
        return (type(exc).__name__, str(exc))


@pytest.mark.parametrize("spec", [
    "data=4,model=2", "data=4, model=2, pipe=1", "model=2", "", "data=8,",
    "data", "batch=2", "data=0", "pipe=3,data=2",
])
def test_parse_mesh_spec_is_jax(spec):
    assert _outcome(tmesh.parse_mesh_spec, spec) == _outcome(jmesh.parse_mesh_spec, spec)


def test_make_mesh_in_a_world_of_one():
    for mesh in (make_mesh(), make_mesh(1), make_mesh(1, 1), tmesh.mesh_from_spec("data=1")):
        assert isinstance(mesh, DeviceMesh)
        assert mesh.mesh_dim_names == (tmesh.DATA_AXIS, tmesh.MODEL_AXIS)
        assert tuple(mesh.mesh.shape) == (1, 1) and mesh.device_type == "cpu"
        assert tmesh.batch_divisible(7, mesh)
    mesh = make_mesh()
    placements = tmesh.data_sharding(mesh, 2)
    assert [type(p).__name__ for p in placements] == ["Shard", "Replicate"]
    assert placements[0].dim == 0
    assert [type(p).__name__ for p in tmesh.replicated(mesh)] == ["Replicate", "Replicate"]


@pytest.mark.parametrize("args,err,match", [
    ((8,), ValueError, "mesh 8x1x1 needs 8 devices, have 1"),
    ((2, 1), ValueError, "mesh 2x1x1 needs 2 devices, have 1"),
    ((0,), ValueError, "mesh 0x1x1 needs 0 devices"),
    ((1, 2), NotImplementedError, "ROADMAP.md A6, cnn_tp_rules"),
    ((1, 1, 2), NotImplementedError, "ROADMAP.md A7, parallel/pipeline.py"),
])
def test_make_mesh_errors(args, err, match):
    with pytest.raises(err, match=match):
        make_mesh(*args)
    if err is ValueError:  # the JAX package's message for the same shortfall
        with pytest.raises(ValueError, match=match.replace("have 1", "have")):
            jmesh.make_mesh(*args, devices=[object()])


class _Proc:
    def __init__(self, p):
        self.process_index = p


@pytest.mark.parametrize("grid,names", [
    ([[0], [1], [2], [3]], ("data", "model")),
    ([[1], [0], [2], [3]], ("data", "model")),
    ([[0, 1], [2, 3]], ("data", "model")),
    ([0, 1, 2, 3], ("data",)),
    ([2, 3, 0, 1], ("data",)),
    ([[0, 2], [1, 3]], ("model", "data")),
    ([[0, 1], [2, 3]], ("model", "data")),
])
def test_row_ownership_check_is_jax(grid, names):
    """One process a device: a rank is a process, so the check runs on the
    mesh's rank tensor where the JAX package reads each device's process."""
    ours = DeviceMesh("cpu", torch.tensor(grid), mesh_dim_names=names, _init_backend=False,
                      _rank=0)
    procs = np.vectorize(_Proc)(np.asarray(grid))
    fake = type("FakeMesh", (), {"axis_names": names, "devices": procs})()
    a = _outcome(tmesh.verify_process_contiguous_data_axis, ours)
    b = _outcome(jmesh.verify_process_contiguous_data_axis, fake)
    assert a[0] == b[0]
    if a[0] == "ValueError":
        assert a[1].split("; order")[0] == b[1].split("; order")[0]


def test_data_parallel_refuses_tensor_parallelism_by_name():
    for kw in ({"tp": True}, {"param_rules": lambda path, leaf: None}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md A6, cnn_tp_rules"):
            DataParallel(**kw)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A6, cnn_tp_rules"):
        tdp.cnn_tp_rules(None, 2)


def test_data_parallel_in_a_world_of_one():
    dp = DataParallel(make_mesh())
    assert (dp.n_data, dp.index, dp.device.type, dp.group, dp.tp) == (1, 0, "cpu", None, False)
    assert not dp.host_collectives
    x = dp.shard_batch(np.arange(6.0).reshape(3, 2))
    assert x.device.type == "cpu" and x.shape == (3, 2)
    assert torch.equal(dp.put_replicated(np.ones(3)), torch.ones(3, dtype=torch.float64))
    a, b = torch.arange(4.0), torch.arange(3, dtype=torch.int32)
    assert dp.all_reduce([a, b])[0] is a  # no group: the identity
    with pytest.raises(ValueError, match="needs a process group of 2"):
        DataParallel(DeviceMesh("cpu", torch.tensor([[0], [1]]),
                                mesh_dim_names=("data", "model"), _init_backend=False, _rank=0))


def test_batch_rand_takes_the_ranks_rows_of_the_global_draw():
    whole = torch.rand((8, 3, 2), generator=torch.Generator().manual_seed(5))
    for r in range(4):
        with tdp.batch_shard(r, 4):
            got = tdp.batch_rand((2, 3, 2), generator=torch.Generator().manual_seed(5),
                                 device="cpu")
        assert torch.equal(got, whole[2 * r:2 * r + 2])
    plain = tdp.batch_rand((8, 3, 2), generator=torch.Generator().manual_seed(5), device="cpu")
    assert torch.equal(plain, whole)


def _jax_and_port_loaders(n, bs, seed=11, **kw):
    """Both frameworks' FullBatchLoader over one split layout, their named
    streams seeded alike."""
    rng = np.random.default_rng(seed)
    data = {"train": rng.integers(0, 256, (n, 6), dtype=np.uint8),
            "valid": rng.integers(0, 256, (n // 3, 6), dtype=np.uint8)}
    labels = {k: rng.integers(0, 3, len(v)).astype(np.int32) for k, v in data.items()}
    _seed_both(seed)
    return (JaxFullBatch(data, labels, minibatch_size=bs, **kw),
            FullBatchLoader(data, labels, minibatch_size=bs, **kw))


def _epoch(loader):
    return [(split, np.asarray(mb.data), np.asarray(mb.indices), np.asarray(mb.mask))
            for split, mb in loader.epoch()]


@pytest.mark.parametrize("count", [2, 4])
def test_process_shards_are_jax_and_cover_the_global_batch(count):
    n, bs = 70, 16  # a padded last batch in both splits (70 % 16, 23 % 16)
    whole = None
    for index in range(count):
        jl, tl = _jax_and_port_loaders(n, bs)
        jl.set_process_shard(index, count)
        tl.set_process_shard(index, count)
        ours = [_epoch(tl) for _ in range(2)]
        theirs = [_epoch(jl) for _ in range(2)]
        for e_ours, e_theirs in zip(ours, theirs):
            assert len(e_ours) == len(e_theirs)
            for (s, d, i, m), (sj, dj, ij, mj) in zip(e_ours, e_theirs):
                assert s == sj
                np.testing.assert_array_equal(i, ij)
                np.testing.assert_array_equal(m, mj)
                np.testing.assert_array_equal(d, dj)
                assert len(i) == bs // count
        if whole is None:
            whole = [[[] for _ in e] for e in ours]
        for e, (w, e_ours) in enumerate(zip(whole, ours)):
            for b, row in enumerate(e_ours):
                w[b].append(row)
    _, tl = _jax_and_port_loaders(n, bs)
    for w, e_whole in zip(whole, [_epoch(tl) for _ in range(2)]):
        for parts, (s, d, i, m) in zip(w, e_whole):
            np.testing.assert_array_equal(np.concatenate([p[2] for p in parts]), i)
            np.testing.assert_array_equal(np.concatenate([p[3] for p in parts]), m)
            np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]), d)


@pytest.mark.parametrize("kw,match", [
    (dict(index=2, count=2), r"process 2 outside \[0, 2\)"),
    (dict(index=0, count=3), "minibatch_size 16 not divisible by process_count 3"),
    (dict(index=0, count=2, skip=True), "skip_bad_batches=True cannot combine"),
])
def test_process_shard_errors_are_jax(kw, match):
    skip = kw.pop("skip", False)
    for cls in (JaxFullBatch, FullBatchLoader):
        loader = cls({"train": np.zeros((32, 2))}, minibatch_size=16, skip_bad_batches=skip)
        with pytest.raises(ValueError, match=match):
            loader.set_process_shard(kw["index"], kw["count"])


@pytest.mark.parametrize("shards", [2, 4])
def test_pool_shards_are_jax(shards):
    """Per-shard sampling orders, local addresses and each process's pool
    block equal the JAX package's, epoch after epoch (the train split
    reshuffled from the named stream), for every process of a one
    process-a-device job."""
    n, bs = 64, 16
    for p in range(shards):
        jl, tl = _jax_and_port_loaders(n * 3 // 2, bs, device_resident=True, pool_sharded=True)
        for loader in (jl, tl):
            loader.set_data_shards(shards)
            loader.set_process_shard(p, shards)
        np.testing.assert_array_equal(tl.device_context()["pool"],
                                      jl.device_context()["pool"])
        assert len(tl.device_context()["pool"]) == (96 + 32) // shards
        for _ in range(2):
            for (s, d, i, m), (sj, dj, ij, mj) in zip(_epoch(tl), _epoch(jl)):
                assert s == sj
                np.testing.assert_array_equal(i, ij)
                np.testing.assert_array_equal(d, dj)
                np.testing.assert_array_equal(m, mj)


@pytest.mark.parametrize("kw,n,match", [
    (dict(balanced=True), 64, "incompatible with balanced=True"),
    (dict(), 72, "has 72 rows, not a multiple of minibatch_size 16"),
])
def test_pool_shard_errors_are_jax(kw, n, match):
    for cls in (JaxFullBatch, FullBatchLoader):
        loader = cls({"train": np.zeros((n, 2), np.float32)}, {"train": np.zeros(n, np.int32)},
                     minibatch_size=16, device_resident=True, pool_sharded=True, **kw)
        with pytest.raises(ValueError, match=match):
            loader.set_data_shards(2)
        loader = cls({"train": np.zeros((64, 2), np.float32)}, minibatch_size=16,
                     device_resident=True, pool_sharded=True)
        with pytest.raises(ValueError, match="minibatch_size 16 not divisible by the data axis 3"):
            loader.set_data_shards(3)
    for cls in (JaxFullBatch, FullBatchLoader):
        with pytest.raises(ValueError, match="pool_sharded=True requires device_resident"):
            cls({"train": np.zeros((4, 2))}, pool_sharded=True)


@pytest.mark.parametrize("n,fractions", [(100, (0.1, 0.2)), (7, (0.5,)), (10, ()),
                                         (1000, (0.15, 0.0))])
def test_split_sizes_is_jax(n, fractions):
    assert tbase.split_sizes(n, fractions) == jbase.split_sizes(n, fractions)


def _mnist_run(parallel, **kw):
    tprng.reset()
    tprng.seed_all(99)
    loader = tdatasets.mnist(n_train=250, n_test=70, minibatch_size=64, **kw)
    wf = StandardWorkflow(loader, MLP, decision_config={"max_epochs": 2},
                          default_hyper={"learning_rate": 0.1, "gradient_moment": 0.9},
                          device="cpu", parallel=parallel)
    wf.initialize(seed=99)
    hist = [(e["train"]["loss"], e["train"]["n_err"], e["test"]["loss"]) for e in wf.run().history]
    return hist, [w.detach().clone() for layer in wf.state.params for w in layer.values()]


def test_a_world_of_one_trains_as_no_policy_bitwise():
    """The data-parallel step (the count, the scaled loss, the flattened
    gradients, the epoch's accumulators) over one process equals the step
    without a policy, bit for bit."""
    a_hist, a_w = _mnist_run(None)
    b_hist, b_w = _mnist_run(DataParallel(make_mesh()))
    assert a_hist == b_hist
    for a, b in zip(a_w, b_w):
        assert torch.equal(a, b)


def test_pool_sharded_loader_needs_a_policy():
    loader = FullBatchLoader({"train": np.zeros((64, 4), np.float32)},
                             {"train": np.zeros(64, np.int32)}, minibatch_size=16,
                             device_resident=True, pool_sharded=True)
    wf = StandardWorkflow(loader, MLP, device="cpu")
    with pytest.raises(ValueError, match="shards its device pool over the data axis"):
        wf.initialize(seed=1)
    wf.parallel = DataParallel(make_mesh())
    wf.initialize(seed=1)
    assert loader.data_shards == 1 and wf._ctx["pool"].shape == (64, 4)
    assert np.isfinite(wf.run_epoch()["summary"]["train"]["loss"])


def test_multihost_without_a_group(monkeypatch):
    """One process, no group: the coordinator, of a job of one, as the JAX
    package's single process answers; ``initialize()`` off a launcher
    names what it lacks."""
    from znicz_tpu_torch.parallel import multihost

    assert (multihost.is_coordinator(), multihost.process_count(),
            multihost.process_index()) == (True, 1, 0)
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="missing MASTER_ADDR, MASTER_PORT"):
        multihost.initialize()
