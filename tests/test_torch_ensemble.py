"""The port's ensembles (``ensemble/``) against the JAX package's, on the
CPU.

With JAX's ``_build`` of ``tests/test_extras.py`` (an MNIST MLP, 128/64
samples, two epochs) and its seeds, each in-process member's params are
within rtol 1e-4 of JAX's, the members share one dataset, ``predict_proba``
is within rtol 1e-5 of JAX's and the soft and hard votes and the
``evaluate`` dict are equal.  ``train_from_module`` over Wine (two members,
two epochs, spawned workers at ``device="cpu"``) gives bitwise equal
results for one and two workers, each member within rtol 1e-4 of JAX's
``_run_workflow_module`` run in this process with the same seed.
"""

import sys

import jax
import numpy as np
import pytest
import torch

from znicz_tpu.core import prng as jprng
from znicz_tpu.core import subproc as jsubproc
from znicz_tpu.ensemble import Ensemble as JaxEnsemble
from znicz_tpu.loader import datasets as jdatasets
from znicz_tpu.workflow import StandardWorkflow as JaxStandard
from znicz_tpu_torch import Ensemble
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.ensemble import train_from_module
from znicz_tpu_torch.loader import datasets as tdatasets
from znicz_tpu_torch.workflow import StandardWorkflow

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL = 1e-4
MLP_LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 16}},
    {"type": "softmax", "->": {"output_sample_shape": 10}},
]
WF_KW = dict(decision_config={"max_epochs": 2},
             default_hyper={"learning_rate": 0.1, "gradient_moment": 0.9})


def _jax_build():
    loader = jdatasets.mnist(n_train=128, n_test=64, minibatch_size=64)
    return JaxStandard(loader, MLP_LAYERS, **WF_KW)


def _build():
    loader = tdatasets.mnist(n_train=128, n_test=64, minibatch_size=64)
    return StandardWorkflow(loader, MLP_LAYERS, device="cpu", **WF_KW)


def _params(wf):
    return [{k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
             for k, v in layer.items()} for layer in wf.state.params]


@pytest.fixture(scope="module")
def trained():
    """Three members a side, trained from fresh registries with base seed
    50 (JAX's test's)."""
    jprng.reset()
    tprng.reset()
    want = JaxEnsemble(_jax_build, n_models=3, base_seed=50)
    want.train()
    got = Ensemble(_build, n_models=3, base_seed=50)
    got.train()
    return got, want


def test_members_params_are_jaxs(trained):
    got, want = trained
    assert len(got.workflows) == len(want.workflows) == 3
    for g, w in zip(got.workflows, want.workflows):
        for gl, wl in zip(_params(g), _params(w)):
            assert sorted(gl) == sorted(wl)
            for k in wl:
                np.testing.assert_allclose(gl[k], wl[k], rtol=RTOL, atol=1e-6, err_msg=k)
    for g, w in zip(got.decisions, want.decisions):
        np.testing.assert_allclose(g.best_value, w.best_value, rtol=RTOL)
    # members differ by init (different seeds)
    w0, w1 = (_params(wf)[0]["weights"] for wf in got.workflows[:2])
    assert not np.allclose(w0, w1)


def test_members_share_one_dataset(trained):
    got, want = trained
    for split in ("train", "test"):
        d0, d1 = (wf.loader.data[split] for wf in got.workflows[:2])
        np.testing.assert_array_equal(d0, d1)
        np.testing.assert_array_equal(got.workflows[0].loader.labels[split],
                                      got.workflows[2].loader.labels[split])
        np.testing.assert_array_equal(d0, want.workflows[0].loader.data[split])


def test_probabilities_votes_and_evaluation_are_jaxs(trained):
    got, want = trained
    x = got.workflows[0].loader.data["test"][:20]
    probs = got.predict_proba(x)
    assert isinstance(probs, torch.Tensor) and probs.device.type == "cpu"
    np.testing.assert_allclose(probs.numpy(), np.asarray(want.predict_proba(x)), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(probs.sum(1).numpy(), 1.0, rtol=1e-5)
    for vote in ("soft", "hard"):
        np.testing.assert_array_equal(got.predict(x, vote=vote), want.predict(x, vote=vote))
        assert got.predict(x, vote=vote).shape == (20,)
    assert got.evaluate("test") == want.evaluate("test")
    assert got.evaluate("train") == want.evaluate("train")


def test_predict_before_train_raises():
    with pytest.raises(RuntimeError, match="train\\(\\) first"):
        Ensemble(_build, n_models=1).predict_proba(np.zeros((1, 784), np.float32))


def _jax_member(path, seed):
    """JAX's in-process member: a fresh registry, as a worker's."""
    jprng.reset()
    sys.modules.pop("__znicz_workflow__", None)
    launcher, dec = jsubproc._run_workflow_module(path, None, seed=seed, stop_after=2)
    return dec.best_value, [{k: np.asarray(v) for k, v in layer.items()}
                            for layer in jax.device_get(launcher.workflow.state.params)]


def test_train_from_module_is_worker_count_invariant_and_jaxs(tmp_path):
    """Four spawns: two members in two workers, then in one."""
    port_py, jax_py = tmp_path / "wf_port.py", tmp_path / "wf_jax.py"
    port_py.write_text("from znicz_tpu_torch.models.wine import run  # noqa: F401\n")
    jax_py.write_text("from znicz_tpu.models.wine import run  # noqa: F401\n")
    kw = dict(n_models=2, base_seed=90, stop_after=2, device="cpu")
    try:
        ens2 = train_from_module(str(port_py), n_workers=2, **kw)
        ens1 = train_from_module(str(port_py), n_workers=1, **kw)
    finally:
        sys.modules.pop("__znicz_workflow__", None)
        sys.path[:] = [p for p in sys.path if p != str(tmp_path)]
    b2 = [d.best_value for d in ens2.decisions]
    assert b2 == [d.best_value for d in ens1.decisions]
    assert all(np.isfinite(v) for v in b2)
    for m2, m1 in zip(ens2.workflows, ens1.workflows):
        for l2, l1 in zip(m2.state.params, m1.state.params):
            for k in l2:
                assert l2[k].device.type == "cpu"
                assert torch.equal(l2[k], l1[k]), k
    for i, member in enumerate(ens2.workflows):
        best, params = _jax_member(str(jax_py), 90 + 1000 * i)
        np.testing.assert_allclose(b2[i], best, rtol=RTOL)
        for gl, wl in zip(_params(member), params):
            for k in wl:
                np.testing.assert_allclose(gl[k], wl[k], rtol=RTOL, atol=1e-6, err_msg=k)
    w0, w1 = (_params(m)[0]["weights"] for m in ens2.workflows)
    assert not np.allclose(w0, w1)
    # aggregation runs on the grafted member params
    x = ens2.workflows[0].loader.data["train"][:8]
    assert ens2.predict(x, vote="soft").shape == (8,)
    result = ens2.evaluate("train")
    assert result["n_samples"] == 178
    assert 0.0 <= result["ensemble_err_pct"] <= 100.0
    with pytest.raises(RuntimeError, match="trained out-of-process"):
        ens2.train()
