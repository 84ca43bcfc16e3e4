"""Tensor and expert parallelism of the port on the CPU, over gloo process
groups, against the JAX package on the same ``(data, model)`` mesh of its
virtual devices.

One job of two ranks as ``make_mesh(1, 2)`` and one of four as
``make_mesh(2, 2)`` (``python -c`` workers, as ``tests/test_torch_multihost.py``
starts them; each job runs every workload once, module-scoped) train: the
MNIST MLP under the size heuristic (``tp_min_features=32``), a conv net
under ``cnn_tp_rules``, AlexNet's paths in small (an LRN on a column
conv's gathered output, a column conv pooled and flattened into a column
FC, a column FC into a column FC; each param's change over the run is
held to JAX's too), the LM with ``tensor_parallel`` over dense and over
flash attention (the kernels' plain twins here; the JAX side runs its
Pallas kernels in interpret mode), the MoE LM (4 experts, 2 a rank) in
dense and capacity dispatch, and the LM under a ``tp=True`` policy
without ``tensor_parallel`` (its params whole on every rank); the
four-rank job's capacity run takes its slots over two data ranks.
Per-epoch loss within rtol 1e-4 of the JAX package's run, ``n_err`` equal
and token accuracy within rtol 1e-4; every rank's history is the same.  The operators' forward and backward against
the unsharded function; the coordinator's TP snapshot holds JAX's whole
layout and resumes a run without TP; ``generate()`` after TP training
gives the JAX package's tokens on the same params; a NaN read at one
step rolls both ranks back (the epoch-start buffer or the snapshot,
gathered whole and sliced again) and the run ends as one process's with
the same fault.
"""

import os

import numpy as np
import pytest

from test_torch_multihost import RTOL, run_ranks, same_history

CONV_FC = [
    {"type": "conv_relu", "->": {"n_kernels": 8, "kx": 5, "ky": 5}},
    {"type": "norm", "->": {"n": 5, "alpha": 1e-4, "beta": 0.75, "k": 2.0}},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "conv_relu", "->": {"n_kernels": 16, "kx": 3, "ky": 3}},
    {"type": "conv_relu", "->": {"n_kernels": 16, "kx": 3, "ky": 3}},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "all2all_relu", "->": {"output_sample_shape": 64}},
    {"type": "all2all_relu", "->": {"output_sample_shape": 64}},
    {"type": "softmax", "->": {"output_sample_shape": 10}},
]

WORK = f"CONV_FC = {CONV_FC!r}\n" + r'''
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.loader import FullBatchLoader, datasets
from znicz_tpu_torch.parallel import tensor_parallel as tp_ops
from znicz_tpu_torch.workflow import StandardWorkflow, TransformerLMWorkflow
from znicz_tpu_torch.workflow.snapshotter import Snapshotter
nd, nm, out_dir = int(ARGS[0]), int(ARGS[1]), ARGS[2]
mesh = make_mesh(nd, nm)
out = {}

def hist(dec, keys):
    return [{k: e["train"][k] for k in keys} for e in dec.history]

# the operators against the unsharded function: forward and input gradient
dp = DataParallel(mesh)
g, m = dp.model_group, dp.model_index
gen = torch.Generator().manual_seed(7)
x, w = torch.randn(4, 6, generator=gen), torch.randn(6, 4 * nm, generator=gen)
xa = x.clone().requires_grad_(True)
wl = w[:, 4 * m:4 * m + 4]
y = tp_ops.reduce_from_model(tp_ops.copy_to_model(xa, g) @ wl @ wl.t(), g)
(y * y).sum().backward()
xb = x.clone().requires_grad_(True)
yb = xb @ w @ w.t()
(yb * yb).sum().backward()
xs = torch.randn(4, 4 * nm, generator=gen)
xc = xs.clone().requires_grad_(True)
z = tp_ops.gather_from_model(tp_ops.scatter_to_model(xc, -1, g) * (m + 1.0), -1, g)
(z * z).sum().backward()
scale = torch.arange(1.0, nm + 1.0).repeat_interleave(4)

def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())

out["ops"] = [rel(y, yb), rel(xa.grad, xb.grad), rel(z, xs * scale),
              rel(xc.grad, 2 * xs * scale ** 2)]

prng.seed_all(5)
wf = StandardWorkflow(datasets.mnist(n_train=128, n_test=64, minibatch_size=32),
    [{"type": "all2all_tanh", "->": {"output_sample_shape": 64}},
     {"type": "all2all_relu", "->": {"output_sample_shape": 32}},
     {"type": "softmax", "->": {"output_sample_shape": 10}}],
    decision_config={"max_epochs": 2}, default_hyper={"learning_rate": 0.1, "gradient_moment": 0.9},
    device="cpu", parallel=DataParallel(mesh, tp=True, tp_min_features=32))
wf.initialize(seed=5)
out["fc"] = hist(wf.run(), ("loss", "n_err"))
out["fc_sharded"] = sorted(wf.parallel.sharded)

prng.seed_all(77)
wf = StandardWorkflow(datasets.mnist(n_train=128, n_test=0, minibatch_size=32, flat=False),
    [{"type": "conv_relu", "->": {"n_kernels": 8, "kx": 5, "ky": 5}},
     {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
     {"type": "conv_relu", "->": {"n_kernels": 16, "kx": 3, "ky": 3}},
     {"type": "all2all_relu", "->": {"output_sample_shape": 64}},
     {"type": "softmax", "->": {"output_sample_shape": 10}}],
    decision_config={"max_epochs": 2}, default_hyper={"learning_rate": 0.05, "gradient_moment": 0.9},
    device="cpu", parallel=DataParallel(mesh, tp=True))
wf.snapshotter = Snapshotter(os.path.join(out_dir, "snaps"), interval=1)
wf.initialize(seed=77)
out["conv"] = hist(wf.run(), ("loss", "n_err"))
out["conv_sharded"] = {p: list(v.shape) for p, v in
                       ((f"[{i}][{k!r}]", v) for i, layer in enumerate(wf.state.params)
                        for k, v in layer.items()) if p in wf.parallel.sharded}

# AlexNet's paths in small: a column conv's output gathered into the LRN,
# row and column convs, a column conv pooled and flattened into a column
# FC, a column FC into a column FC, a whole head
prng.seed_all(78)
wf = StandardWorkflow(datasets.mnist(n_train=128, n_test=0, minibatch_size=32, flat=False),
    CONV_FC, decision_config={"max_epochs": 2},
    default_hyper={"learning_rate": 0.05, "gradient_moment": 0.9},
    device="cpu", parallel=DataParallel(mesh, tp=True, tp_min_features=32))
wf.initialize(seed=78)

def save_whole(name):
    whole = wf.parallel.gather_state(wf.state.params)
    if RANK == 0:
        np.savez(os.path.join(out_dir, name), **{f"{i}.{k}": v.detach().numpy()
                 for i, layer in enumerate(whole) for k, v in layer.items()})

save_whole("conv_fc_start.npz")
out["conv_fc"] = hist(wf.run(), ("loss", "n_err"))
out["conv_fc_sharded"] = sorted(wf.parallel.sharded)
save_whole("conv_fc.npz")

tokens = np.cumsum(np.random.default_rng(7).integers(0, 3, (32, 16)), axis=1) % 16
for kind in ("dot", "flash", "dense", "capacity"):
    moe = {} if kind in ("dot", "flash") else dict(moe_experts=4, moe_top_k=2, moe_dispatch=kind)
    prng.seed_all(51)
    wf = TransformerLMWorkflow(FullBatchLoader({"train": tokens.copy()}, minibatch_size=16),
        vocab=16, d_model=32, n_layers=2, n_heads=4, max_epochs=2, attention=kind if kind in ("dot", "flash") else "dot",
        device="cpu", tensor_parallel=True, parallel=DataParallel(mesh), **moe)
    wf.initialize(seed=51)
    out[f"lm_{kind}"] = hist(wf.run(), ("loss", "token_accuracy"))
    out[f"lm_{kind}_wq"] = list(wf.state.params[1]["wq"].shape)
    if kind == "dot":
        out["generate"] = wf.generate(tokens[:2, :5], max_new_tokens=6).tolist()
        whole = wf.parallel.gather_state(wf.state.params)
        if RANK == 0:
            np.savez(os.path.join(out_dir, "lm.npz"), **{f"{i}.{k}": v.detach().numpy()
                     for i, layer in enumerate(whole) for k, v in layer.items()})
# a tp=True policy without tensor_parallel: the LM keeps its params whole
prng.seed_all(51)
wf = TransformerLMWorkflow(FullBatchLoader({"train": tokens.copy()}, minibatch_size=16),
    vocab=16, d_model=32, n_layers=2, n_heads=4, max_epochs=2, attention="dot", device="cpu",
    parallel=DataParallel(mesh, tp=True, tp_min_features=16))
wf.initialize(seed=51)
out["lm_whole"] = hist(wf.run(), ("loss", "token_accuracy"))
out["lm_whole_wq"] = list(wf.state.params[1]["wq"].shape)
out["lm_whole_sharded"] = sorted(wf.parallel.sharded)
if nd * nm == 2:
    # capacity over two data ranks without a model axis: the global slots
    prng.seed_all(51)
    wf = TransformerLMWorkflow(FullBatchLoader({"train": tokens.copy()}, minibatch_size=16),
        vocab=16, d_model=32, n_layers=2, n_heads=4, max_epochs=2, attention="dot",
        device="cpu", parallel=DataParallel(make_mesh(2, 1)), moe_experts=4, moe_top_k=2,
        moe_dispatch="capacity")
    wf.initialize(seed=51)
    out["lm_capacity_dp"] = hist(wf.run(), ("loss", "token_accuracy"))
report(**out)
'''

MNIST_FC = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 64}},
    {"type": "all2all_relu", "->": {"output_sample_shape": 32}},
    {"type": "softmax", "->": {"output_sample_shape": 10}},
]
CONV = [
    {"type": "conv_relu", "->": {"n_kernels": 8, "kx": 5, "ky": 5}},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "conv_relu", "->": {"n_kernels": 16, "kx": 3, "ky": 3}},
    {"type": "all2all_relu", "->": {"output_sample_shape": 64}},
    {"type": "softmax", "->": {"output_sample_shape": 10}},
]
MESHES = {"2": (1, 2), "4": (2, 2)}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Each mesh's job, run once: ``{ranks: (reports, its directory)}``."""
    out = {}
    for key, (nd, nm) in MESHES.items():
        d = tmp_path_factory.mktemp(f"tp{key}")
        out[key] = (run_ranks(WORK, nd, nm, d, world=nd * nm, timeout=300), d)
    return out


def _tokens():
    return np.cumsum(np.random.default_rng(7).integers(0, 3, (32, 16)), axis=1) % 16


def _jax_run(kind, nd, nm, changes=None):
    """The JAX package's run of workload ``kind`` on a ``(nd, nm)`` mesh of
    its virtual devices: the per-epoch train metrics.  A dict ``changes``
    receives each param's change over a conv/FC run by its
    ``"<layer>.<name>"`` key."""
    import jax

    from znicz_tpu.core import prng
    from znicz_tpu.loader import FullBatchLoader, datasets
    from znicz_tpu.parallel import DataParallel, make_mesh
    from znicz_tpu.workflow import StandardWorkflow, TransformerLMWorkflow

    mesh = make_mesh(nd, nm, devices=jax.devices()[:nd * nm])
    prng.reset()
    if kind in ("fc", "conv", "conv_fc"):
        seed = {"fc": 5, "conv": 77, "conv_fc": 78}[kind]
        prng.seed_all(seed)
        loader = (datasets.mnist(n_train=128, n_test=64, minibatch_size=32) if kind == "fc" else
                  datasets.mnist(n_train=128, n_test=0, minibatch_size=32, flat=False))
        wf = StandardWorkflow(
            loader, {"fc": MNIST_FC, "conv": CONV, "conv_fc": CONV_FC}[kind],
            decision_config={"max_epochs": 2},
            default_hyper={"learning_rate": 0.1 if kind == "fc" else 0.05,
                           "gradient_moment": 0.9},
            prefetch_batches=0,
            parallel=DataParallel(mesh, tp=True, **({} if kind == "conv"
                                                    else {"tp_min_features": 32})))
        wf.initialize(seed=seed)
        start = [{k: np.asarray(v) for k, v in layer.items()} for layer in wf.state.params]
        hist = [{k: e["train"][k] for k in ("loss", "n_err")} for e in wf.run().history]
        if changes is not None:
            changes.update({f"{i}.{k}": np.asarray(v) - start[i][k]
                            for i, layer in enumerate(wf.state.params) for k, v in layer.items()})
        return hist
    tp = kind not in ("capacity_dp", "whole")
    # "whole": JAX shards the leaves of >= 16 features and GSPMD gathers them
    policy = (DataParallel(mesh, tp=True, tp_min_features=16) if kind == "whole"
              else DataParallel(mesh))
    kind = kind.replace("_dp", "")
    moe = ({} if kind in ("dot", "flash", "whole")
           else dict(moe_experts=4, moe_top_k=2, moe_dispatch=kind))
    prng.seed_all(51)
    wf = TransformerLMWorkflow(
        FullBatchLoader({"train": _tokens()}, minibatch_size=16), vocab=16, d_model=32,
        n_layers=2, n_heads=4, max_epochs=2,
        attention=kind if kind in ("dot", "flash") else "dot", tensor_parallel=tp,
        parallel=policy, prefetch_batches=0, **moe)
    wf.initialize(seed=51)
    return [{k: e["train"][k] for k in ("loss", "token_accuracy")} for e in wf.run().history]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            if k == "n_err":
                assert g[k] == w[k], (k, g, w)
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("ranks", sorted(MESHES))
def test_operators_are_the_unsharded_function(jobs, ranks):
    """copy/reduce around a column-then-row product and scatter/gather
    around a per-block scale: the forward and the input's gradient equal
    the unsharded function's within 1e-5 of its largest magnitude, on
    every rank."""
    for r in jobs[ranks][0]:
        assert max(r["ops"]) <= 1e-5, r["ops"]


@pytest.mark.parametrize("ranks", sorted(MESHES))
@pytest.mark.parametrize("kind", ["fc", "conv", "conv_fc", "lm_dot", "lm_flash", "lm_dense",
                                  "lm_capacity", "lm_whole"])
def test_runs_match_jax_on_the_same_mesh(jobs, ranks, kind):
    reports = jobs[ranks][0]
    for r in reports[1:]:
        assert r[kind] == reports[0][kind]  # one history
    nd, nm = MESHES[ranks]
    changes = {}
    _same(reports[0][kind], _jax_run(kind.replace("lm_", ""), nd, nm, changes))
    if kind == "fc":  # the size heuristic: every leaf of >= 32 features
        assert reports[0]["fc_sharded"] == ["[0]['bias']", "[0]['weights']", "[1]['bias']",
                                            "[1]['weights']"]
    if kind == "conv_fc":  # conv1, conv3 and both FCs column, conv2 row, the head whole
        assert reports[0]["conv_fc_sharded"] == [
            "[0]['bias']", "[0]['weights']", "[3]['weights']", "[4]['bias']",
            "[4]['weights']", "[6]['bias']", "[6]['weights']", "[7]['bias']", "[7]['weights']"]
        # each param's change over the run, gathered whole, against JAX's:
        # a partial sum missed or doubled would move it by O(1)
        final = np.load(os.path.join(jobs[ranks][1], "conv_fc.npz"))
        start = np.load(os.path.join(jobs[ranks][1], "conv_fc_start.npz"))
        assert sorted(final.files) == sorted(changes)
        for key, want in changes.items():
            got = final[key] - start[key]
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= RTOL, (key, rel)
    if kind == "lm_whole":  # tp=True without tensor_parallel: nothing sharded
        assert reports[0]["lm_whole_sharded"] == [] and reports[0]["lm_whole_wq"] == [32, 32]
    elif kind.startswith("lm_"):  # 4 heads: this rank's 2 (wq's columns)
        assert reports[0][f"{kind}_wq"] == [32, 16]


def test_capacity_over_two_data_ranks_is_jax(jobs):
    """The MoE LM in capacity dispatch on a (data=2, model=1) mesh: the
    slots and the capacity over the global batch, as the JAX package's
    sort over it."""
    reports = jobs["2"][0]
    assert reports[0]["lm_capacity_dp"] == reports[1]["lm_capacity_dp"]
    _same(reports[0]["lm_capacity_dp"], _jax_run("capacity_dp", 2, 1))


def test_conv_placement_and_snapshot(jobs):
    """cnn_tp_rules: conv1 column, conv2 row (its bias whole), the FC head
    whole.  The coordinator's snapshot holds the whole kernels in the JAX
    package's layout, loads in the JAX package, and resumes a run without
    TP, which trains on from it."""
    from znicz_tpu.workflow.snapshotter import load_snapshot as jload
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.loader import datasets
    from znicz_tpu_torch.workflow import StandardWorkflow

    reports, d = jobs["4"]
    assert reports[0]["conv_sharded"] == {"[0]['weights']": [5, 5, 1, 4], "[0]['bias']": [4],
                                          "[2]['weights']": [3, 3, 4, 16]}
    path = os.path.join(d, "snaps", "workflow_epoch1.pickle.gz")
    state, _ = jload(path)
    shapes = [{k: np.asarray(v).shape for k, v in layer.items()} for layer in state[0]]
    assert shapes[0] == {"weights": (5, 5, 1, 8), "bias": (8,)}
    assert shapes[2] == {"weights": (3, 3, 8, 16), "bias": (16,)}
    prng.reset()
    prng.seed_all(77)
    wf = StandardWorkflow(datasets.mnist(n_train=128, n_test=0, minibatch_size=32, flat=False),
                          CONV, decision_config={"max_epochs": 3},
                          default_hyper={"learning_rate": 0.05, "gradient_moment": 0.9},
                          device="cpu")
    wf.initialize(snapshot=path)
    assert wf.decision.epoch == 2
    for layer, want in zip(wf.state.params, state[0]):
        for k, v in layer.items():
            np.testing.assert_array_equal(v.detach().numpy(), np.asarray(want[k]))
    assert np.isfinite(wf.run_epoch()["summary"]["train"]["loss"])


def test_generate_after_tp_training_is_jax(jobs):
    """Every rank decodes on the gathered whole params: the tokens equal
    the JAX package's ``generate`` on the params the coordinator gathered."""
    import jax.numpy as jnp

    from znicz_tpu.workflow import generate as JG

    reports, d = jobs["2"]
    assert reports[0]["generate"] == reports[1]["generate"]
    saved = np.load(os.path.join(d, "lm.npz"))
    params = [{} for _ in range(4)]
    for key in saved.files:
        i, k = key.split(".")
        params[int(i)][k] = jnp.asarray(saved[key])
    want = np.asarray(JG.generate(params, jnp.asarray(_tokens()[:2, :5]), n_heads=4,
                                  max_new_tokens=6))
    np.testing.assert_array_equal(np.asarray(reports[0]["generate"]), want)


ROLLBACK = r'''
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.loader import datasets
from znicz_tpu_torch.utils import faults
from znicz_tpu_torch.workflow import StandardWorkflow
from znicz_tpu_torch.workflow.recovery import RecoveryPolicy
from znicz_tpu_torch.workflow.snapshotter import Snapshotter
sync = ARGS[0]
prng.seed_all(99)
policy = RecoveryPolicy(max_rollbacks=2, lr_backoff=1.0, perturb=False)
wf = StandardWorkflow(datasets.mnist(n_train=250, n_test=70, minibatch_size=64),
    [{"type": "all2all_tanh", "->": {"output_sample_shape": 64}},
     {"type": "softmax", "->": {"output_sample_shape": 10}}],
    decision_config={"max_epochs": 3}, default_hyper={"learning_rate": 0.1, "gradient_moment": 0.9},
    device="cpu", epoch_sync=sync, recovery=policy,
    parallel=DataParallel(make_mesh(1, 2), tp=True, tp_min_features=32))
if sync == "deferred":
    wf.snapshotter = Snapshotter(ARGS[1], interval=1)
wf.initialize(seed=99)
faults.inject("train.step_nan", flag=True, times=1, after=5)
dec = wf.run()
report(hist=history(dec, "train"), rollbacks=policy.rollbacks_used,
       sharded=sorted(wf.parallel.sharded))
'''


@pytest.mark.parametrize("sync", ["sync", "deferred"])
def test_rollback_under_tp_matches_one_process(tmp_path, sync):
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.loader import datasets
    from znicz_tpu_torch.utils import faults
    from znicz_tpu_torch.workflow import StandardWorkflow
    from znicz_tpu_torch.workflow.recovery import RecoveryPolicy

    reports = run_ranks(ROLLBACK, sync, tmp_path)
    assert reports[0] == reports[1] and reports[0]["rollbacks"] == 1
    assert reports[0]["sharded"] == ["[0]['bias']", "[0]['weights']"]
    prng.reset()
    prng.seed_all(99)
    policy = RecoveryPolicy(max_rollbacks=2, lr_backoff=1.0, perturb=False)
    wf = StandardWorkflow(datasets.mnist(n_train=250, n_test=70, minibatch_size=64),
                          MNIST_FC[:1] + MNIST_FC[2:], decision_config={"max_epochs": 3},
                          default_hyper={"learning_rate": 0.1, "gradient_moment": 0.9},
                          device="cpu", recovery=policy)
    wf.initialize(seed=99)
    faults.inject("train.step_nan", flag=True, times=1, after=5)
    try:
        dec = wf.run()
    finally:
        faults.clear()
    assert policy.rollbacks_used == 1
    same_history(reports[0]["hist"], dec.history, ("train",))
