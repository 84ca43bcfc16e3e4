"""The port's tensor- and expert-parallel placement against the JAX
package's, in one process on the CPU.

The placement spec is a tuple equal to JAX's ``PartitionSpec`` of the same
entries.  ``lm_tp_rules`` gives JAX's spec for every leaf of the dense and
the MoE LM (``tests/test_declarative_parallel.py``'s table included);
``cnn_tp_rules`` gives JAX's for the conv net of ``tests/test_parallel.py``
and for AlexNet at 2 and 4 model ranks; the size heuristic (``tp=True``,
no rules) gives JAX's ``DataParallel._param_spec``.  Expert parallelism:
each shard's ``apply_local_shard`` equals JAX's and the shards sum to the
dense dispatch within rtol 1e-5 and atol 1e-6; capacity dispatch split
over D data ranks and n expert shards (the ranks' all-gather of the top-k
expert ids played by the test) gives, summed over the shards and put
together over the ranks, JAX's ``_capacity_apply`` on the concatenated
batch.  The multi-process runs are in ``tests/test_torch_multihost_tp.py``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu.core import prng as jprng
from znicz_tpu.models import alexnet as jalexnet
from znicz_tpu.ops import moe as jmoe
from znicz_tpu.parallel import DataParallel as JaxDataParallel, data_parallel as jdp
from znicz_tpu.parallel import make_mesh as jmake_mesh
from znicz_tpu.workflow import model as jmodel, transformer as jtf
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.ops import moe as tmoe
from znicz_tpu_torch.parallel import data_parallel as tdp, tensor_parallel as tp_ops
from znicz_tpu_torch.parallel.tensor_parallel import P
from znicz_tpu_torch.workflow import model as tmodel, transformer as ttf

torch.set_float32_matmul_precision("highest")


def _seed_both(seed):
    for reg in (jprng, tprng):
        reg.reset()
        reg.seed_all(seed)


def _paths(params):
    return [(f"[{i}][{k!r}]", v) for i, layer in enumerate(params) for k, v in layer.items()]


def test_partition_spec_is_jax_and_names_one_model_dim():
    from jax.sharding import PartitionSpec

    assert P() == PartitionSpec() and P(None, "model") == PartitionSpec(None, "model")
    assert [tp_ops.sharded_dim(s) for s in (P(), P(None), P(None, "model"), P("model"))] == [
        None, None, 1, 0]
    for bad in (P("data"), P("model", "model")):
        with pytest.raises(ValueError, match="one dim over the 'model' axis"):
            tp_ops.sharded_dim(bad)
    x = torch.arange(6.0)
    for op in (tp_ops.copy_to_model, tp_ops.reduce_from_model):
        assert op(x, None) is x  # a model axis of 1: the identity
    for op in (tp_ops.gather_from_model, tp_ops.scatter_to_model):
        assert op(x, 0, None) is x


@pytest.mark.parametrize("moe_experts", [0, 4])
def test_lm_tp_rules_are_jax(moe_experts):
    _seed_both(3)
    jp = jtf.init_lm_params(16, 32, 2, 4, 8, moe_experts=moe_experts)
    tp = ttf.init_lm_params(16, 32, 2, 4, 8, moe_experts=moe_experts, device="cpu")
    jpaths = dict(_paths(jp))
    for path, leaf in _paths(tp):
        assert tuple(ttf.lm_tp_rules(path, leaf)) == tuple(jtf.lm_tp_rules(path, jpaths[path])), path
    for path, want in [("[1]['wq']", (None, "model")), ("[1]['wo']", ("model", None)),
                       ("[1]['w_up']", (None, "model")), ("[1]['w_down']", ("model", None)),
                       ("[1]['up_bias']", ("model",)), ("[2]['head']", (None, "model")),
                       ("[0]['embed']", ()), ("[1]['ln1_scale']", ())]:
        assert tuple(ttf.lm_tp_rules(path, None)) == want


TEST_PARALLEL_CONV = [
    {"type": "conv_relu", "->": {"n_kernels": 8, "kx": 5, "ky": 5}},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "conv_relu", "->": {"n_kernels": 16, "kx": 3, "ky": 3}},
    {"type": "all2all_relu", "->": {"output_sample_shape": 64}},
    {"type": "softmax", "->": {"output_sample_shape": 10}},
]


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("net", ["conv", "alexnet"])
def test_cnn_tp_rules_are_jax(net, n_model):
    if net == "conv":
        layers, shape = TEST_PARALLEL_CONV, (28, 28, 1)
    else:
        layers, shape = copy.deepcopy(jalexnet.DEFAULTS["layers"]), (227, 227, 3)
        layers[-1]["->"]["output_sample_shape"] = 1000
    _seed_both(1)
    jm = jmodel.build(layers, shape)
    tm = tmodel.build(layers, shape, device="cpu")
    ours, theirs = tdp.cnn_tp_rules(tm, n_model), jdp.cnn_tp_rules(jm, n_model)
    sharded = []
    for path, leaf in _paths(tm.params):
        spec = ours(path, leaf)
        assert tuple(spec) == tuple(theirs(path, None)), path
        if tp_ops.sharded_dim(spec) is not None:
            sharded.append(path)
    if net == "conv":  # conv1 column, conv2 row, the FC layers whole
        assert sharded == ["[0]['weights']", "[0]['bias']", "[2]['weights']"]
    else:  # conv1/3/5 and fc6/7 column, conv2/4 row, fc8 (1000 < 1024) whole
        cols = [f"[{i}]['{k}']" for i in (0, 6, 8, 10, 12) for k in ("weights", "bias")]
        assert sorted(sharded) == sorted(cols + ["[3]['weights']", "[7]['weights']"])


@pytest.mark.parametrize("min_features", [32, 4096])
def test_size_heuristic_is_jax(min_features):
    """``tp=True`` without rules: a leaf whose last dim is at least
    ``tp_min_features`` and divides the model axis is column-sharded."""
    leaves = {"w": np.zeros((784, 64)), "b": np.zeros(64), "h": np.zeros((64, 10)),
              "odd": np.zeros((4, 33)), "s": np.zeros(())}
    jax_dp = JaxDataParallel(jmake_mesh(4, 2), tp=True, tp_min_features=min_features)
    ours = type("Policy", (), {"param_rules": None, "tp": True, "tp_min_features": min_features,
                               "n_model": 2})()
    for name, leaf in leaves.items():
        got = tdp.DataParallel._param_spec(ours, f"[0][{name!r}]", leaf)
        assert tuple(got) == tuple(jax_dp._param_spec(f"[0][{name!r}]", leaf)), name


def _moe_params(e, f=8, h=12, seed=11):
    _seed_both(seed)
    jp = jmoe.init_params(f, h, e)
    tp = tmoe.init_params(f, h, e, device="cpu")
    return jp, tp


def _local(tp, shard, n):
    e_local = tp["w1"].shape[0] // n
    return {"router": tp["router"],
            **{k: tp[k][shard * e_local:(shard + 1) * e_local] for k in ("w1", "b1", "w2", "b2")}}


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_local_shards_sum_to_dense(top_k, n_shards):
    jp, tp = _moe_params(8)
    x = np.random.default_rng(5).standard_normal((12, 8)).astype(np.float32)
    ref = np.asarray(jmoe.apply(jp, jnp.asarray(x), top_k=top_k))
    total = torch.zeros(12, 8)
    for s in range(n_shards):
        local = _local(tp, s, n_shards)
        got = tmoe.apply_local_shard(local, torch.from_numpy(x), top_k=top_k, shard_index=s)
        jlocal = {k: jnp.asarray(v.numpy()) for k, v in local.items()}
        want = jmoe.apply_local_shard(jlocal, jnp.asarray(x), top_k=top_k, shard_index=s)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        total += got
    np.testing.assert_allclose(total.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_data,n_shards,top_k,cf", [
    (1, 2, 2, 1.25), (2, 1, 2, 1.25), (2, 2, 2, 1.0), (4, 2, 1, 1.25), (2, 4, 2, 0.5),
])
def test_capacity_over_data_ranks_and_expert_shards_is_jax(monkeypatch, n_data, n_shards, top_k,
                                                           cf):
    """Capacity dispatch of a batch split over ``n_data`` ranks and experts
    split over ``n_shards``: each rank's top-k expert ids all-gathered (the
    test hands each rank the others' ids, as the collective would), the
    slots over the global batch, and the shards' outputs summed, put
    together over the ranks, equal JAX's ``_capacity_apply`` on the whole
    batch (low capacity factors drop tokens)."""
    jp, tp = _moe_params(8, seed=13)
    b = 12
    x = np.random.default_rng(6).standard_normal((n_data * b, 8)).astype(np.float32)
    x[5] = 0.0  # router logits tie
    want = np.asarray(jmoe.apply(jp, jnp.asarray(x), top_k=top_k, dispatch="capacity",
                                 capacity_factor=cf))
    xt = torch.from_numpy(x)
    ids = [tmoe._top_k(xt[d * b:(d + 1) * b] @ tp["router"], top_k)[1].t().contiguous()
           for d in range(n_data)]
    rank = {"d": 0}
    monkeypatch.setattr(tp_ops, "group_size", lambda g: 1 if g is None else n_data)
    monkeypatch.setattr(tp_ops, "group_rank", lambda g: 0 if g is None else rank["d"])
    monkeypatch.setattr(tp_ops, "all_gather", lambda t, dim, g: torch.cat(ids, dim=dim))
    rows = []
    for d in range(n_data):
        rank["d"] = d
        out = sum(tmoe.apply_parallel(_local(tp, s, n_shards), xt[d * b:(d + 1) * b],
                                      top_k=top_k, dispatch="capacity", capacity_factor=cf,
                                      shard_index=s, data_group="data" if n_data > 1 else None)
                  for s in range(n_shards))
        rows.append(out)
    np.testing.assert_allclose(torch.cat(rows).numpy(), want, rtol=1e-5, atol=1e-6)
