"""The port's transformer LM slice against the JAX package, on the CPU.

``init_lm_params`` and the bigram data of ``transformer_lm.build_workflow``
are equal exactly (shared numpy streams); ``lm_apply`` logits agree within
rtol/atol 1e-5 for dense attention, flash attention (JAX's Pallas kernels in
interpret mode, the port's plain version) and remat, and within rtol 1e-4
at d_model 512 over 2 heads (head dim 256) with flash.  The slice:
``TransformerLMWorkflow`` at vocab 16, d_model 32, 2 layers, 2 heads, T 24,
``attention="flash"``, trains 2 epochs from one seed in both frameworks;
per-epoch loss and token accuracy and the final weights agree within rtol
1e-4 (f32, matmul precision "highest": 8 SGD steps whose sums run in
another order).  With ``attention_dtype="bf16"`` the per-epoch loss agrees
within rtol 1e-3 (q, k, v, p and ds rounded to bf16 in both; the rounding
can fall on either side of a tie once the f32 sums differ).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu.core import prng as jprng
from znicz_tpu.core.config import root as jroot
from znicz_tpu.models import transformer_lm as jlm
from znicz_tpu.ops.pallas import attention as jflash
from znicz_tpu.workflow import transformer as jtf
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.config import root as troot
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
from znicz_tpu_torch.models import transformer_lm as tlm
from znicz_tpu_torch.ops.kernels import attention as tflash
from znicz_tpu_torch.workflow import model as model_lib, transformer as ttf
from znicz_tpu_torch.workflow.snapshotter import Snapshotter

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False

SEED = 2024
SMALL = {
    "vocab": 16, "d_model": 32, "n_layers": 2, "n_heads": 2,
    "loader": {"seq_len": 24, "n_train": 32, "n_test": 8, "minibatch_size": 8},
}
RTOL_EPOCH = 1e-4
RTOL_W, ATOL_W = 1e-4, 1e-5
RTOL_BF16 = 1e-3


def _seed_both(seed=SEED):
    for reg in (jprng, tprng):
        reg.reset()
        reg.seed_all(seed)


@pytest.fixture
def small_config():
    """Both roots set to the small LM; the port's restored after (the JAX
    one is restored by tests/conftest.py)."""
    saved = troot.to_dict()
    for r in (jroot, troot):
        r.transformer_lm.update(SMALL)
    yield
    troot.clear()
    troot.update(saved)


def test_init_lm_params_equal_exactly():
    _seed_both()
    jp = jax.device_get(jtf.init_lm_params(16, 32, 2, 2, 24, d_ff=48))
    tp = model_lib.params_to_numpy(ttf.init_lm_params(16, 32, 2, 2, 24, d_ff=48, device="cpu"))
    tprng.reset()
    assert len(tp) == len(jp) == 4
    for lj, lt in zip(jp, tp):
        assert sorted(lt) == sorted(lj)  # device_get sorts a dict's keys
        for k in lj:
            assert lt[k].dtype == np.float32
            np.testing.assert_array_equal(lt[k], np.asarray(lj[k]))
    # the JAX params cross unchanged and come back equal
    for lj, lt in zip(jp, model_lib.params_to_numpy(model_lib.params_from_jax(jp, "cpu"))):
        for k in lj:
            np.testing.assert_array_equal(lt[k], np.asarray(lj[k]))


def test_params_to_numpy_is_a_snapshot():
    """The update runs in place: a numpy copy taken before a step must not
    follow the live CPU params."""
    params = [{"w": torch.ones(3)}]
    host = model_lib.params_to_numpy(params)
    params[0]["w"].add_(1.0)
    np.testing.assert_array_equal(host[0]["w"], np.ones(3, np.float32))


def _jax_flash(q, k, v, causal):
    return jflash.flash_attention(q, k, v, causal=causal, block_q=8, block_k=8)


@pytest.mark.parametrize("mode", ["dot", "flash", "remat"])
def test_lm_apply_matches_jax(mode):
    _seed_both()
    jp = jtf.init_lm_params(16, 32, 2, 2, 24)
    tp = model_lib.params_from_jax(jax.device_get(jp), "cpu")
    tprng.reset()
    tokens = np.random.default_rng(3).integers(0, 16, (3, 20)).astype(np.int32)
    jfn = _jax_flash if mode == "flash" else None
    tfn = tflash.flash_attention if mode == "flash" else None
    want = jtf.lm_apply(jp, jnp.asarray(tokens), n_heads=2, attention_fn=jfn,
                        remat=mode == "remat")
    got = ttf.lm_apply(tp, torch.from_numpy(tokens).long(), n_heads=2, attention_fn=tfn,
                       remat=mode == "remat")
    assert got.shape == (3, 20, 16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_lm_apply_matches_jax_at_head_dim_256():
    """The mid LM's width at 2 heads (head dim 256, the widest the port's
    kernels take; they run it through the same wrapper on the card) through
    one layer with flash attention, against JAX's lm_apply with its flash
    function (interpret mode)."""
    _seed_both()
    jp = jtf.init_lm_params(16, 512, 1, 2, 24)
    tp = model_lib.params_from_jax(jax.device_get(jp), "cpu")
    tprng.reset()
    tokens = np.random.default_rng(5).integers(0, 16, (2, 20)).astype(np.int32)
    want = jtf.lm_apply(jp, jnp.asarray(tokens), n_heads=2, attention_fn=_jax_flash)
    got = ttf.lm_apply(tp, torch.from_numpy(tokens).long(), n_heads=2,
                       attention_fn=tflash.flash_attention)
    assert got.shape == (2, 20, 16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_remat_gives_the_same_gradients():
    _seed_both()
    params = ttf.init_lm_params(16, 32, 2, 2, 24, device="cpu")
    tprng.reset()
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 16, (2, 24)))
    leaves = [w.requires_grad_(True) for layer in params for w in layer.values()]
    grads = []
    for remat in (False, True):
        out = ttf.lm_apply(params, tokens, n_heads=2, attention_fn=tflash.flash_attention,
                           remat=remat)
        grads.append(torch.autograd.grad(torch.sin(out).sum(), leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_bigram_data_equal_exactly(small_config):
    _seed_both()
    jwf = jlm.build_workflow(prefetch_batches=0)
    twf = tlm.build_workflow(device="cpu")
    tprng.reset()
    for split in ("train", "test"):
        assert twf.loader.data[split].dtype == np.int32
        assert twf.loader.data[split].shape == (32 if split == "train" else 8, 24)
        np.testing.assert_array_equal(twf.loader.data[split], jwf.loader.data[split])
    assert twf.max_seq == jwf.max_seq == 24


def _run_both(epochs, **kw):
    """Both LM workflows from one seed, ``epochs`` epochs each."""
    _seed_both()
    jwf = jlm.build_workflow(prefetch_batches=0, **kw)
    twf = tlm.build_workflow(device="cpu", **kw)
    jwf.initialize()
    twf.initialize()
    out = {
        "jax_init": jax.device_get(jwf.state.params),
        "torch_init": model_lib.params_to_numpy(twf.state.params),
        "jax": [], "torch": [], "jax_order": [], "torch_order": [],
    }
    for _ in range(epochs):
        out["jax"].append(jwf.run_epoch()["summary"])
        out["torch"].append(twf.run_epoch()["summary"])
        out["jax_order"].append(jwf.loader._order["train"].copy())
        out["torch_order"].append(twf.loader._order["train"].copy())
    out["jax_final"] = jax.device_get(jwf.state.params)
    out["torch_final"] = model_lib.params_to_numpy(twf.state.params)
    out["torch_wf"] = twf
    tprng.reset()
    return out


@pytest.fixture(scope="module")
def flash_runs():
    saved = troot.to_dict()
    saved_j = jroot.to_dict()
    for r in (jroot, troot):
        r.transformer_lm.update(SMALL)
    try:
        return _run_both(2, attention="flash")
    finally:
        troot.clear()
        troot.update(saved)
        jroot.clear()
        jroot.update(saved_j)


def test_slice_initial_weights_and_order_equal(flash_runs):
    for lj, lt in zip(flash_runs["jax_init"], flash_runs["torch_init"]):
        for k in lj:
            np.testing.assert_array_equal(lt[k], np.asarray(lj[k]))
    for oj, ot in zip(flash_runs["jax_order"], flash_runs["torch_order"]):
        np.testing.assert_array_equal(ot, oj)


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("split", ["train", "test"])
def test_slice_epoch_metrics_match(flash_runs, epoch, split):
    mj = flash_runs["jax"][epoch][split]
    mt = flash_runs["torch"][epoch][split]
    assert mt["n_samples"] == mj["n_samples"] == (32 if split == "train" else 8)
    assert mt["n_err"] == mj["n_err"] == 0
    for k in ("loss", "token_accuracy"):
        np.testing.assert_allclose(mt[k], mj[k], rtol=RTOL_EPOCH, err_msg=k)


def test_slice_final_params_match(flash_runs):
    twf = flash_runs["torch_wf"]
    assert twf.state.step == 8 and twf.decision.epoch == 2
    assert twf._attention_fn_base() is tflash.flash_attention
    for lj, lt, l0 in zip(flash_runs["jax_final"], flash_runs["torch_final"],
                          flash_runs["torch_init"]):
        for k in lj:
            assert not np.array_equal(lt[k], l0[k]), k  # training moved them
            np.testing.assert_allclose(lt[k], np.asarray(lj[k]), rtol=RTOL_W, atol=ATOL_W)


def test_slice_bf16_attention_matches_jax(small_config):
    runs = _run_both(1, attention="flash", attention_dtype="bf16")
    for split in ("train", "test"):
        mj, mt = runs["jax"][0][split], runs["torch"][0][split]
        np.testing.assert_allclose(mt["loss"], mj["loss"], rtol=RTOL_BF16)
    assert runs["torch_wf"].attention_dtype == "bf16"


def test_decision_config_override_matches_jax(small_config):
    _seed_both()
    jwf = jlm.build_workflow(prefetch_batches=0, decision_config={"max_epochs": 3})
    twf = tlm.build_workflow(device="cpu", decision_config={"max_epochs": 3})
    tprng.reset()
    assert twf.decision.max_epochs == jwf.decision.max_epochs == 3
    assert twf.decision.metric == jwf.decision.metric == "loss"


def _loader(t):
    return FullBatchLoader({"train": np.zeros((2, t), np.int32)}, minibatch_size=2)


@pytest.mark.parametrize("t", [24, 512])
def test_auto_resolves_to_dot_on_the_cpu(t):
    wf = ttf.TransformerLMWorkflow(_loader(t), vocab=8, attention="auto", device="cpu")
    assert wf._attention_fn_base() is None
    assert wf._attention_fn() is None
    flash = ttf.TransformerLMWorkflow(_loader(t), vocab=8, attention="flash", device="cpu")
    assert flash._attention_fn_base() is tflash.flash_attention


@pytest.mark.parametrize(
    "kwargs",
    [
        {"sequence_parallel": True},
        {"tensor_parallel": True},
        {"pipeline_parallel": True},
        {"parallel": "tp"},
    ],
    ids=lambda kw: next(iter(kw)),
)
def test_paths_not_ported_raise(kwargs):
    """Every path is ported.  ``tensor_parallel=True`` raises the JAX
    package's checks (a policy with a model axis above 1 is needed; the
    runs are in ``tests/test_torch_multihost_tp.py``), and
    ``parallel="tp"``, a ``DataParallel(tp=True)`` in a world of one (its
    model axis 1, so ``tp`` is off), is taken and trains.
    ``sequence_parallel`` over a world of one (a ring of one) trains as
    the run without it, and ``pipeline_parallel`` without a pipe mesh
    raises the JAX package's ValueError (the multi-rank runs are in
    ``tests/test_torch_multihost_sp_pp.py``)."""
    from znicz_tpu_torch.parallel import DataParallel, make_mesh

    if "tensor_parallel" in kwargs:
        with pytest.raises(ValueError, match="needs parallel=DataParallel"):
            ttf.TransformerLMWorkflow(_loader(8), vocab=8, device="cpu", **kwargs)
        with pytest.raises(ValueError, match="model axis is 1"):
            ttf.TransformerLMWorkflow(_loader(8), vocab=8, device="cpu",
                                      parallel=DataParallel(make_mesh()), **kwargs)
        return
    if kwargs.get("parallel") == "tp":
        wf = ttf.TransformerLMWorkflow(_loader(8), vocab=8, d_model=8, n_heads=2, n_layers=1,
                                       max_epochs=1, device="cpu",
                                       parallel=DataParallel(tp=True))
        wf.initialize(seed=1)
        assert wf.parallel.tp is False and not wf.parallel.sharded
        assert np.isfinite(wf.run_epoch()["summary"]["train"]["loss"])
        return
    if "pipeline_parallel" in kwargs:
        from znicz_tpu.loader import FullBatchLoader as JLoader
        from znicz_tpu.workflow.transformer import TransformerLMWorkflow as JLM

        with pytest.raises(ValueError) as want:
            JLM(JLoader({"train": np.zeros((8, 8), np.int32)}, minibatch_size=4), vocab=8,
                **kwargs)
        with pytest.raises(ValueError) as got:
            ttf.TransformerLMWorkflow(_loader(8), vocab=8, device="cpu", **kwargs)
        assert str(got.value) == str(want.value)
        return
    losses = []
    for sp in ({}, dict(kwargs, mesh=make_mesh())):
        wf = ttf.TransformerLMWorkflow(_loader(8), vocab=8, d_model=8, n_heads=2, n_layers=1,
                                       max_epochs=1, device="cpu", **sp)
        wf.initialize(seed=1)
        losses.append(wf.run_epoch()["summary"]["train"]["loss"])
    assert np.isfinite(losses[0]) and losses[0] == losses[1]


@pytest.mark.parametrize("how", ["snapshotter", "snapshot_dir"])
def test_lm_snapshots_are_honoured(small_config, tmp_path, how):
    """The LM's snapshotter and the model module's ``snapshot_dir``, refused
    until the LM's resume was held against the JAX package's
    (``tests/test_torch_self_healing.py``)."""
    if how == "snapshotter":
        snap = Snapshotter(str(tmp_path), "lm")
        wf = ttf.TransformerLMWorkflow(_loader(8), vocab=8, device="cpu", snapshotter=snap)
    else:
        wf = tlm.build_workflow(device="cpu", snapshot_dir=str(tmp_path))
        snap = wf.snapshotter
        assert (snap.directory, snap.prefix) == (str(tmp_path), "TransformerLMWorkflow")
    wf.initialize()
    wf.run_epoch()
    assert os.path.exists(snap.best_path)


def test_entry_points_not_ported_raise(small_config):
    # generate() and MoE blocks run since their slice
    # (tests/test_torch_generate.py, tests/test_torch_moe.py)
    # two stages in a world of one process: make_mesh's shortfall, as the
    # JAX package's mesh raises on a host with fewer devices
    troot.transformer_lm.update({"pipeline_stages": 2})
    with pytest.raises(ValueError, match="mesh 1x1x2 needs 2 devices, have 1"):
        tlm.build_workflow(device="cpu")
    with pytest.raises(ValueError, match="attention="):
        ttf.TransformerLMWorkflow(_loader(8), vocab=8, attention="ring", device="cpu")
    with pytest.raises(ValueError, match="attention_dtype"):
        ttf.TransformerLMWorkflow(_loader(8), vocab=8, attention_dtype="f16", device="cpu")
