"""The port's workflows take every keyword of the JAX package's, on the CPU.

Each JAX keyword of the base ``Workflow``, ``StandardWorkflow`` and
``TransformerLMWorkflow`` is in the port's signature with the JAX default,
so a JAX call site never gets a ``TypeError``.  At its default each is
accepted; the snapshotter, the prefetch depth, deferred epoch sync, the
anomaly watch's switch and rollback recovery are honoured at any value;
the LM's MoE keywords are honoured; off its default, a keyword whose path
the port does not have yet (tensor-parallel placement, pipelines, the LM's
sequence-parallel mesh) raises ``NotImplementedError`` naming its
``ROADMAP.md`` item.
"""

import inspect
import os

import numpy as np
import pytest

from znicz_tpu.workflow import StandardWorkflow as JaxStandard
from znicz_tpu.workflow.transformer import TransformerLMWorkflow as JaxLM
from znicz_tpu.workflow.workflow import Workflow as JaxWorkflow
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
from znicz_tpu_torch.parallel import DataParallel, make_mesh
from znicz_tpu_torch.workflow import model as model_lib
from znicz_tpu_torch.workflow.recovery import RecoveryPolicy
from znicz_tpu_torch.workflow.snapshotter import Snapshotter
from znicz_tpu_torch.workflow.standard import StandardWorkflow
from znicz_tpu_torch.workflow.transformer import TransformerLMWorkflow
from znicz_tpu_torch.workflow.workflow import Workflow

LAYERS = [{"type": "softmax", "->": {"output_sample_shape": 2}}]
PAIRS = [(JaxStandard, StandardWorkflow), (JaxLM, TransformerLMWorkflow), (JaxWorkflow, Workflow)]


def _keywords(cls):
    return {
        n: p.default
        for n, p in inspect.signature(cls.__init__).parameters.items()
        if p.kind is inspect.Parameter.KEYWORD_ONLY
    }


def _standard(resident=False, **kw):
    loader = FullBatchLoader({"train": np.zeros((4, 3), np.float32)},
                             {"train": np.zeros(4, np.int32)}, minibatch_size=2,
                             device_resident=resident)
    return StandardWorkflow(loader, LAYERS, device="cpu", **kw)


def _base(resident=False, **kw):
    loader = FullBatchLoader({"train": np.zeros((4, 3), np.float32)},
                             {"train": np.zeros(4, np.int32)}, minibatch_size=2,
                             device_resident=resident)
    model = model_lib.build(LAYERS, (3,), device="cpu")
    return Workflow(loader, model, device="cpu", **kw)


def _lm(**kw):
    loader = FullBatchLoader({"train": np.zeros((2, 8), np.int32)}, minibatch_size=2)
    return TransformerLMWorkflow(loader, vocab=8, device="cpu", **kw)


@pytest.mark.parametrize("jax_cls,port_cls", PAIRS, ids=["standard", "lm", "base"])
def test_every_jax_keyword_is_in_the_port_with_its_default(jax_cls, port_cls):
    jax_kw, port_kw = _keywords(jax_cls), _keywords(port_cls)
    assert set(jax_kw) <= set(port_kw), sorted(set(jax_kw) - set(port_kw))
    for name, default in jax_kw.items():
        assert port_kw[name] == default, (name, port_kw[name], default)


@pytest.mark.parametrize("make,jax_cls",
                         [(_standard, JaxStandard), (_lm, JaxLM), (_base, JaxWorkflow)],
                         ids=["standard", "lm", "base"])
def test_jax_keywords_at_their_defaults_are_taken(make, jax_cls):
    """Every JAX keyword passed explicitly at its JAX default (``anomaly=True``
    builds the default detector)."""
    skip = {"name", "rand_name", "vocab"}
    kw = {n: d for n, d in _keywords(jax_cls).items()
          if d is not inspect.Parameter.empty and n not in skip}
    wf = make(**kw)
    assert wf.device.type == "cpu"


@pytest.mark.parametrize(
    "make,kwargs,item",
    [
        (_standard, {"parallel": "tp"}, "A6"),
        (_lm, {"pipeline_microbatches": 4}, "A7"),
        (_lm, {"mesh": object()}, "A7"),
        (_base, {"parallel": "tp"}, "A6"),
    ],
    ids=lambda v: v.__name__.strip("_") if callable(v) else (next(iter(v)) if isinstance(v, dict) else v),
)
def test_jax_keywords_off_their_defaults_are_refused_by_name(make, kwargs, item):
    """Every keyword off its default is taken now that A6 and A7 are done.
    ``parallel="tp"`` stands for a tensor-parallel placement policy
    (``DataParallel(tp=True)``): the workflow keeps it as given (in a world
    of one its model axis is 1).  The pipeline's ``pipeline_microbatches``
    and ``mesh=`` are taken and kept, as the JAX package keeps them, and
    read only under pipeline or sequence parallelism."""
    if kwargs.get("parallel") == "tp":
        dp = DataParallel(tp=True, tp_min_features=4)
        assert make(parallel=dp).parallel is dp
        return
    wf = make(**kwargs)
    if "mesh" in kwargs:
        assert wf.mesh is kwargs["mesh"]
    assert wf.state is None and not wf.pipeline_parallel


@pytest.mark.parametrize("make", [_standard, _lm, _base], ids=["standard", "lm", "base"])
def test_a_data_parallel_policy_is_taken(make):
    """``parallel=DataParallel(make_mesh())`` over a world of one process:
    taken at construction or assigned before ``initialize``, as the JAX
    package's tests assign it."""
    dp = DataParallel(make_mesh())
    wf = make(parallel=dp)
    assert wf.parallel is dp
    wf = make()
    wf.parallel = dp
    wf.initialize(seed=3)
    assert wf.state is not None and np.isfinite(wf.run_epoch()["summary"]["train"]["loss"])


@pytest.mark.parametrize(
    "kwargs",
    [{"moe_experts": 4, "moe_top_k": 2}, {"moe_experts": 4, "moe_dispatch": "capacity"}],
    ids=["moe_top_k", "moe_dispatch"],
)
def test_lm_moe_keywords_are_honoured(kwargs):
    """Refused until the MoE slice: the blocks carry experts and a step
    runs through the routing asked for."""
    wf = _lm(**kwargs)
    assert (wf.moe_top_k, wf.moe_dispatch) == (kwargs.get("moe_top_k", 1),
                                                kwargs.get("moe_dispatch", "dense"))
    wf.initialize()
    assert wf.state.params[1]["moe_w_up"].shape[0] == 4
    assert np.isfinite(wf.run_epoch()["summary"]["train"]["loss"])


@pytest.mark.parametrize(
    "make,kwargs",
    [
        (_standard, {"prefetch_batches": 0}),
        (_standard, {"prefetch_batches": 5}),
        (_lm, {"prefetch_batches": 0}),
        (_base, {"prefetch_batches": 0}),
        (_base, {"epoch_dispatch": "step"}),
        (_standard, {"epoch_dispatch": "scan", "resident": True}),
        (_base, {"epoch_dispatch": "scan", "resident": True}),
    ],
    ids=lambda v: v.__name__.strip("_") if callable(v) else "-".join(f"{k}={w}" for k, w in v.items()),
)
def test_loop_keywords_are_honoured(make, kwargs):
    wf = make(**kwargs)
    if "prefetch_batches" in kwargs:
        assert wf.prefetch_batches == kwargs["prefetch_batches"]
    wf.initialize()
    # scan dispatch, refused until the device pool slice, runs the epoch
    # as one split function over the device-resident pool
    assert wf._use_epoch_scan() == (kwargs.get("epoch_dispatch") == "scan")
    n = wf.loader.class_lengths["train"]
    assert wf.run_epoch()["summary"]["train"]["n_samples"] == n


@pytest.mark.parametrize(
    "make,kwargs",
    [
        (_standard, {"epoch_sync": "deferred"}),
        (_standard, {"anomaly": False}),
        (_standard, {"recovery": "policy"}),
        (_lm, {"epoch_sync": "deferred"}),
        (_lm, {"recovery": "policy"}),
        (_lm, {"snapshotter": "snapshotter"}),
        (_base, {"epoch_sync": "deferred"}),
        (_base, {"anomaly": False}),
        (_base, {"anomaly": None}),
        (_base, {"recovery": "policy"}),
    ],
    ids=lambda v: v.__name__.strip("_") if callable(v) else next(iter(v)),
)
def test_lifted_keywords_are_honoured(make, kwargs, tmp_path):
    """The self-healing keywords that the port refused until it had the
    anomaly watch, rollback, deferred sync and the LM's snapshots: each
    changes what an epoch does."""
    (name, value), = kwargs.items()
    value = {"policy": RecoveryPolicy(), "snapshotter": Snapshotter(str(tmp_path), "lm")}.get(
        value, value) if isinstance(value, str) else value
    wf = make(**{name: value})
    wf.initialize()
    n = wf.loader.class_lengths["train"]
    if name == "epoch_sync":
        assert wf.run_epoch() is None  # the verdict lags one epoch
        assert wf.sync_epoch()["summary"]["train"]["n_samples"] == n
        assert wf.sync_epoch() is None
        return
    fed = []
    if wf.anomaly is not None:
        observe = wf.anomaly.observe_step
        wf.anomaly.observe_step = lambda step, **kw: fed.append(step) or observe(step, **kw)
    assert wf.run_epoch()["summary"]["train"]["n_samples"] == n
    if name == "anomaly":
        assert wf.anomaly is None and wf._last_watch is None
    elif name == "recovery":
        assert wf.recovery is value and wf.anomaly is not None
        assert wf._epoch_start is not None  # the rollback's restore point
        # every train step watched
        assert fed == list(range(wf.loader.n_minibatches("train")))
    else:
        assert os.path.exists(value.best_path)


def test_snapshot_dir_and_config_build_the_jax_snapshotter(tmp_path):
    wf = _standard(snapshot_dir=str(tmp_path / "snaps"),
                   snapshot_config={"interval": 1, "keep": 2, "compress": False})
    snap = wf.snapshotter
    assert isinstance(snap, Snapshotter)
    assert (snap.directory, snap.prefix, snap.interval, snap.keep, snap.compress) == (
        str(tmp_path / "snaps"), "StandardWorkflow", 1, 2, False)
    wf.initialize()
    wf.run_epoch()
    assert sorted(p.name for p in (tmp_path / "snaps").iterdir()) == [
        "StandardWorkflow_best.pickle", "StandardWorkflow_best.pickle.sha256",
        "StandardWorkflow_epoch0.pickle", "StandardWorkflow_epoch0.pickle.sha256"]
    with pytest.raises(TypeError):
        _standard(snapshot_dir=str(tmp_path / "x"), snapshot_config={"every": 1})


@pytest.mark.parametrize("make", [_standard, _base], ids=["standard", "base"])
def test_bad_loop_values_raise_as_in_jax(make):
    with pytest.raises(ValueError, match="epoch_dispatch"):
        make(epoch_dispatch="scanned")
    with pytest.raises(ValueError, match="epoch_sync"):
        make(epoch_sync="lazy")


@pytest.mark.parametrize("op", ["all2all", "conv", "deconv"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_init_params_honours_dtype_as_jax(op, dtype):
    import importlib

    import jax.numpy as jnp
    import torch

    from znicz_tpu.core import prng as jprng
    from znicz_tpu_torch.core import prng as tprng

    args = {"all2all": (5, 3), "conv": (2, 3, 3, 3), "deconv": (2, 3, 3, 3)}[op]
    jop = importlib.import_module(f"znicz_tpu.ops.{op}")
    top = importlib.import_module(f"znicz_tpu_torch.ops.{op}")
    jprng.reset()
    tprng.reset()
    jp = jop.init_params(*args, dtype=jnp.dtype(dtype))
    tp = top.init_params(*args, dtype=dtype, device="cpu")
    assert set(tp) == set(jp)
    for k in jp:
        assert tp[k].dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(tp[k].float().numpy(), np.asarray(jp[k], np.float32))
    with pytest.raises(ValueError, match="not a torch dtype"):
        top.init_params(*args, dtype="complex_fp4", device="cpu")
