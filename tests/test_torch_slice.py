"""The port's training slice against the JAX StandardWorkflow, on the CPU.

A small AlexNet-shaped layer list (conv -> LRN -> max-pool twice, then FC
and softmax) trains for 2 epochs in both frameworks from the same seed, on
the same 32x32x3 uint8 data through the on-device convert path, with the
JAX side's LRN running its Pallas kernel (interpret mode).  Initial weights
and shuffle order are equal exactly (shared numpy streams); per-epoch loss
and n_err, and the final weights, agree within the tolerances below (f32,
matmul precision "highest", TF32 off).

Dropout draws its masks from a torch.Generator and cannot reproduce JAX's
threefry masks, so it is left out of the training comparison and checked
on its own.
"""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu.core import prng as jprng
from znicz_tpu.loader import FullBatchLoader as JaxLoader
from znicz_tpu.models import alexnet as jax_alexnet
from znicz_tpu.workflow import StandardWorkflow as JaxWorkflow, model as jax_model
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.config import root as troot
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
from znicz_tpu_torch.loader.imagenet import ImageNetLoader
from znicz_tpu_torch.models import alexnet
from znicz_tpu_torch.ops import dropout, moe as moe_op
from znicz_tpu_torch.workflow import model as model_lib
from znicz_tpu_torch.workflow.standard import StandardWorkflow

torch.set_float32_matmul_precision("highest")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

SEED = 4321
GD = {
    "learning_rate": 0.05,
    "gradient_moment": 0.9,
    "weights_decay": 0.0005,
    "learning_rate_bias": 0.1,
    "weights_decay_bias": 0.0,
}
LAYERS = [
    {"type": "conv_relu", "->": {"n_kernels": 8, "kx": 5, "ky": 5, "sliding": (2, 2)}, "<-": GD},
    {"type": "norm", "->": {"n": 5, "impl": "pallas"}},
    {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
    {"type": "conv_relu", "->": {"n_kernels": 16, "kx": 3, "ky": 3, "padding": (1, 1, 1, 1)}, "<-": GD},
    {"type": "norm", "->": {"n": 4, "alpha": 1e-3, "impl": "pallas"}},
    {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
    {"type": "all2all_relu", "->": {"output_sample_shape": 32}, "<-": GD},
    {"type": "softmax", "->": {"output_sample_shape": 10}, "<-": GD},
]
WF_KW = dict(
    decision_config={"max_epochs": 2},
    lr_policy={"name": "step", "step_size": 6, "gamma": 0.5},
)
# per-epoch metrics and final weights: 8 SGD steps of f32 arithmetic whose
# sums run in another order in each framework (oneDNN vs XLA convs)
RTOL_EPOCH = 1e-4
RTOL_W, ATOL_W = 1e-4, 1e-5


def _data():
    rng = np.random.default_rng(SEED)
    x = rng.integers(0, 256, (48, 32, 32, 3), dtype=np.uint8)
    y = rng.integers(0, 10, 48).astype(np.int32)
    return (
        {"train": x[:32], "valid": x[32:]},
        {"train": y[:32], "valid": y[32:]},
    )


def _loader(cls):
    data, labels = _data()
    return cls(
        data, labels, minibatch_size=8, normalization="range",
        normalization_kwargs={"scale": 255.0, "shift": -0.5}, device_convert=True,
    )


def _seed_both():
    for reg in (jprng, tprng):
        reg.reset()
        reg.seed_all(SEED)


@pytest.fixture(scope="module")
def runs():
    """Both workflows, 2 epochs each; what the tests below compare."""
    _seed_both()
    jwf = JaxWorkflow(_loader(JaxLoader), LAYERS, prefetch_batches=0, **WF_KW)
    twf = StandardWorkflow(_loader(FullBatchLoader), LAYERS, device="cpu", **WF_KW)
    out = {
        "jax_init": jax.device_get(jwf.model.params),
        "torch_init": model_lib.params_to_numpy(twf.model.params),
        "jax_order": [], "torch_order": [], "jax_epochs": [], "torch_epochs": [],
    }
    jwf.initialize()
    twf.initialize()
    for _ in range(2):
        out["jax_epochs"].append(jwf.run_epoch()["summary"])
        out["torch_epochs"].append(twf.run_epoch()["summary"])
        out["jax_order"].append(jwf.loader._order["train"].copy())
        out["torch_order"].append(twf.loader._order["train"].copy())
    out["jax_final"] = jax.device_get(jwf.state.params)
    out["torch_final"] = model_lib.params_to_numpy(twf.state.params)
    out["torch_wf"] = twf
    tprng.reset()
    return out


def test_init_params_equal_exactly(runs):
    assert len(runs["jax_init"]) == len(runs["torch_init"]) == len(LAYERS)
    for lj, lt in zip(runs["jax_init"], runs["torch_init"]):
        assert lj.keys() == lt.keys()
        for k in lj:
            np.testing.assert_array_equal(lt[k], np.asarray(lj[k]))


def test_params_from_jax_round_trip(runs):
    params = model_lib.params_from_jax(runs["jax_init"], "cpu")
    for lj, lt in zip(runs["jax_init"], model_lib.params_to_numpy(params)):
        for k in lj:
            assert lt[k].dtype == np.float32
            np.testing.assert_array_equal(lt[k], np.asarray(lj[k]))


def test_shuffle_order_identical(runs):
    for oj, ot in zip(runs["jax_order"], runs["torch_order"]):
        np.testing.assert_array_equal(ot, oj)
    assert not np.array_equal(runs["torch_order"][0], runs["torch_order"][1])


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("split", ["train", "valid"])
def test_epoch_metrics_match(runs, epoch, split):
    mj = runs["jax_epochs"][epoch][split]
    mt = runs["torch_epochs"][epoch][split]
    assert mt["n_samples"] == mj["n_samples"]
    assert mt["n_err"] == mj["n_err"]
    for k in ("loss", "max_err_y_sum"):
        np.testing.assert_allclose(mt[k], mj[k], rtol=RTOL_EPOCH, err_msg=k)


def test_final_params_match(runs):
    for lj, lt, l0 in zip(runs["jax_final"], runs["torch_final"], runs["torch_init"]):
        for k in lj:
            assert not np.array_equal(lt[k], l0[k])  # training moved them
            np.testing.assert_allclose(lt[k], np.asarray(lj[k]), rtol=RTOL_W, atol=ATOL_W)


def test_state_step_and_decision(runs):
    twf = runs["torch_wf"]
    assert twf.state.step == 8
    assert twf.decision.epoch == 2


# -- dropout: in the model, out of the training comparison ------------------

DROPOUT_LAYERS = LAYERS[:-1] + [
    {"type": "dropout", "->": {"dropout_ratio": 0.4}},
    LAYERS[-1],
]


def test_dropout_model_eval_forward_matches_jax():
    _seed_both()
    jm = jax_model.build(DROPOUT_LAYERS, (32, 32, 3))
    tm = model_lib.build(DROPOUT_LAYERS, (32, 32, 3), device="cpu")
    x = np.random.default_rng(1).uniform(-0.5, 0.5, (4, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(jm.params, x, train=False))
    got = tm.apply(tm.params, torch.from_numpy(x), train=False).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="Generator"):
        tm.apply(tm.params, torch.from_numpy(x), train=True)


def test_dropout_keep_fraction_and_scaling():
    ratio = 0.3
    gen = torch.Generator().manual_seed(11)
    y = dropout.dropout(torch.ones(200_000), dropout_ratio=ratio, generator=gen)
    kept = y != 0
    frac = float(kept.float().mean())
    sigma = (ratio * (1 - ratio) / y.numel()) ** 0.5
    assert abs(frac - (1 - ratio)) < 5 * sigma
    np.testing.assert_allclose(y[kept].numpy(), 1 / (1 - ratio), rtol=1e-6)
    x = torch.randn(10)
    assert torch.equal(dropout.dropout(x, dropout_ratio=ratio, train=False), x)
    assert torch.equal(dropout.dropout(x, dropout_ratio=0.0, generator=gen), x)


def test_dropout_same_mask_from_same_seed():
    x = torch.randn(64, 32)
    a = dropout.dropout(x, dropout_ratio=0.5, generator=torch.Generator().manual_seed(3))
    b = dropout.dropout(x, dropout_ratio=0.5, generator=torch.Generator().manual_seed(3))
    c = dropout.dropout(x, dropout_ratio=0.5, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_dropout_workflow_trains_on_cpu():
    """With dropout in the list the port's workflow still trains (the
    masks come from the "workflow" generator's stream)."""
    _seed_both()
    twf = StandardWorkflow(_loader(FullBatchLoader), DROPOUT_LAYERS, device="cpu", **WF_KW)
    summary = twf.run_epoch()["summary"]
    assert np.isfinite(summary["train"]["loss"]) and summary["train"]["n_samples"] == 32


# -- full-size AlexNet: shapes only -------------------------------------------

ALEXNET_SHAPES = [
    (55, 55, 96), (55, 55, 96), (27, 27, 96),
    (27, 27, 256), (27, 27, 256), (13, 13, 256),
    (13, 13, 384), (13, 13, 384), (13, 13, 256), (6, 6, 256),
    (4096,), (4096,), (4096,), (4096,), (1000,),
]


@pytest.fixture
def small_alexnet_data():
    saved = troot.to_dict()
    troot.alexnet.loader.update({"n_train": 8, "n_valid": 8})  # geometry unchanged
    yield
    troot.clear()
    troot.update(saved)


def test_full_alexnet_build_matches_jax_shapes(small_alexnet_data):
    _seed_both()
    wf = alexnet.build_workflow(device="cpu")
    jm = jax_model.build(jax_alexnet.DEFAULTS["layers"], (227, 227, 3))
    tm = wf.model
    assert wf.loader.sample_shape == (227, 227, 3)
    assert wf.loader.max_minibatch_size == 128
    assert tm.compute_dtype == torch.bfloat16
    assert list(tm.layer_shapes) == ALEXNET_SHAPES
    assert tm.layer_types == jm.layer_types
    assert tm.output_shape == jm.output_shape == (1000,)
    for lj, lt in zip(jm.params, tm.params):
        assert {k: tuple(v.shape) for k, v in lt.items()} == {
            k: tuple(v.shape) for k, v in lj.items()
        }
    out = jax.eval_shape(
        lambda p, x: jm.apply(p, x, train=False),
        jm.params, jax.ShapeDtypeStruct((2, 227, 227, 3), np.float32),
    )
    assert out.shape == (2,) + tm.output_shape
    # the u8 -> device convert path, as in the JAX package
    assert wf.loader.device_preproc() is not None


@pytest.mark.parametrize("spec", [{"type": "moe", "n_experts": 2}], ids=["moe"])
def test_layer_types_of_later_slices_raise(spec):
    """The last layer type of a later slice, ``moe``, builds since its slice
    (``tests/test_torch_moe.py``); an unknown type still raises."""
    model = model_lib.build([spec], (4, 4, 2), device="cpu")
    assert model.layer_types == (spec["type"],) and model.output_shape == (32,)
    with pytest.raises(ValueError, match="unknown layer type"):
        model_lib.build([{"type": "bogus"}], (4, 4, 2), device="cpu")


_ROADMAP = (Path(__file__).resolve().parents[1] / "ROADMAP.md").read_text()
_ITEM = re.compile(r"ROADMAP\.md (A\d+), ([\w/]+\.py)")


def _names_its_item(message: str) -> None:
    """The refusal names a queue-A item of ROADMAP.md whose entry mentions
    the module it names."""
    found = _ITEM.search(message)
    assert found, message
    item, module = found.groups()
    entry = re.search(rf"^{item}\. \*\*.*?(?=^A\d+\. \*\*|^### )", _ROADMAP, re.M | re.S)
    assert entry, f"ROADMAP.md has no item {item}"
    assert module in entry.group(0), f"ROADMAP.md {item} does not mention {module}"


@pytest.mark.parametrize("kind", ["moe"])
def test_later_layer_types_name_their_roadmap_item(kind):
    """What the ``moe`` layer's op still refuses, expert parallelism, names
    its queue-A item."""
    for fn in (moe_op.apply_local_shard, moe_op.expert_sharding):
        with pytest.raises(NotImplementedError, match="not ported") as err:
            fn({}, None)
        _names_its_item(str(err.value))


# the mnist_ae encoder and decoder, then an asymmetric strided pair
DECONV_LAYERS = [
    {"type": "conv_tanh", "->": {"n_kernels": 12, "kx": 10, "ky": 10, "sliding": (3, 3),
                                 "weights_filling": "gaussian", "weights_stddev": 0.05}},
    {"type": "deconv", "->": {"n_channels": 1, "kx": 10, "ky": 10, "sliding": (3, 3),
                              "weights_filling": "gaussian", "weights_stddev": 0.05}},
    {"type": "conv", "->": {"n_kernels": 5, "kx": 4, "ky": 3, "sliding": (2, 1),
                            "padding": (1, 0, 2, 1)}},
    {"type": "deconv", "->": {"n_channels": 2, "kx": 4, "ky": 3, "sliding": (2, 1),
                              "padding": (1, 0, 2, 1)}},
]


def test_deconv_layer_builds_with_jax_shapes():
    _seed_both()
    jm = jax_model.build(DECONV_LAYERS, (28, 28, 1))
    tm = model_lib.build(DECONV_LAYERS, (28, 28, 1), device="cpu")
    assert tm.layer_types == jm.layer_types
    assert tm.layer_shapes == ((7, 7, 12), (28, 28, 1), (27, 14, 5), (28, 27, 2))
    assert tm.output_shape == jm.output_shape == (28, 27, 2)
    for lj, lt in zip(jm.params, tm.params):
        assert {k: tuple(v.shape) for k, v in lt.items()} == {
            k: tuple(v.shape) for k, v in lj.items()
        }
        for k in lj:
            np.testing.assert_array_equal(lt[k].numpy(), np.asarray(lj[k]))
    x = np.random.default_rng(0).standard_normal((2, 28, 28, 1)).astype(np.float32)
    want = np.asarray(jm.apply(jm.params, jnp.asarray(x)))
    got = tm.apply(tm.params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_alexnet_data_dir_builds_on_the_imagenet_loader(small_alexnet_data, tmp_path):
    """The published geometry from packed 256x256 images with 1000 classes:
    the ImageNet loader, its crops at 227 and a 1000-class head."""
    rng = np.random.default_rng(5)
    np.save(tmp_path / "train_images.npy", rng.integers(0, 256, (3, 256, 256, 3), dtype=np.uint8))
    np.save(tmp_path / "train_labels.npy", np.array([0, 998, 999], np.int32))
    (tmp_path / "classes.json").write_text(json.dumps([f"n{i:08d}" for i in range(1000)]))
    (tmp_path / "mean_rgb.json").write_text(json.dumps([0.485, 0.456, 0.406]))
    troot.alexnet.loader.update({"data_dir": str(tmp_path)})
    _seed_both()
    wf = alexnet.build_workflow(device="cpu")
    assert isinstance(wf.loader, ImageNetLoader)
    assert wf.loader.n_classes() == 1000
    assert wf.loader.sample_shape == (227, 227, 3)
    assert wf.loader.max_minibatch_size == 128
    assert list(wf.model.layer_shapes) == ALEXNET_SHAPES
    assert wf.model.output_shape == (1000,)
    assert wf.model.compute_dtype == torch.bfloat16
    mb = next(iter(wf.loader.batches("train")))
    assert mb.data.dtype == np.uint8 and mb.data.shape == (128, 227, 227, 3)
    assert mb.mask.sum() == 3
    x = wf.loader.device_preproc()(torch.from_numpy(mb.data[:1]))
    assert x.dtype == torch.float32
    np.testing.assert_allclose(x.mean(dim=(0, 1, 2)).numpy(),
                               mb.data[0].reshape(-1, 3).mean(0) / 255 - [0.485, 0.456, 0.406],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("device_convert", [True, False], ids=["u8_to_device", "host_f32"])
def test_loader_batches_match_jax(device_convert):
    """Padding, masks, shuffle and normalization of the minibatch state
    machine against the JAX loader, over two epochs of a ragged split."""
    _seed_both()
    rng = np.random.default_rng(3)
    data = {"train": rng.integers(0, 256, (21, 4, 4, 3), dtype=np.uint8),
            "valid": rng.integers(0, 256, (5, 4, 4, 3), dtype=np.uint8)}
    labels = {k: rng.integers(0, 3, len(v)).astype(np.int32) for k, v in data.items()}
    kw = dict(minibatch_size=8, normalization="range", device_convert=device_convert,
              normalization_kwargs={"scale": 255.0, "shift": -0.5})
    jl, tl = JaxLoader(data, labels, **kw), FullBatchLoader(data, labels, **kw)
    for _ in range(2):
        got, want = list(tl.epoch()), list(jl.epoch())
        assert [s for s, _ in got] == [s for s, _ in want] == ["train"] * 3 + ["valid"]
        for (_, mt), (_, mj) in zip(got, want):
            for field in ("labels", "mask", "indices"):
                np.testing.assert_array_equal(getattr(mt, field), getattr(mj, field))
            assert mt.data.dtype == mj.data.dtype
            # host f32: the JAX loader's native gather rounds x/255 - 0.5
            # one ulp apart from its numpy formula, which the port uses
            np.testing.assert_allclose(mt.data, mj.data, rtol=0, atol=1e-7)
    assert (tl.device_preproc() is None) == (not device_convert)


def test_imagenet_synthetic_matches_jax():
    from znicz_tpu.loader import datasets as jax_datasets
    from znicz_tpu_torch.loader import datasets

    _seed_both()
    kw = dict(image_size=9, n_classes=5, n_train=6, n_valid=3, minibatch_size=4)
    jl, tl = jax_datasets.imagenet_synthetic(**kw), datasets.imagenet_synthetic(**kw)
    for split in ("train", "valid"):
        assert tl.data[split].dtype == np.uint8
        np.testing.assert_array_equal(tl.data[split], jl.data[split])
        np.testing.assert_array_equal(tl.labels[split], jl.labels[split])
    x = torch.from_numpy(tl.data["train"])
    np.testing.assert_allclose(
        tl.device_preproc()(x).numpy(),
        np.asarray(jl.device_preproc()(jnp.asarray(jl.data["train"]), None)),
        rtol=1e-6, atol=1e-7,
    )


# -- the declarative attention layer -----------------------------------------

ATTENTION_LAYERS = [  # tests/test_declarative_parallel.py's model
    {"type": "attention", "->": {"n_heads": 2, "causal": False}},
    {"type": "attention", "->": {"n_heads": 2, "causal": False}},
    {"type": "softmax", "->": {"output_sample_shape": 2}},
]


@pytest.fixture(scope="module")
def attention_runs():
    """A [T 8, D 16] sequence model in both frameworks from one seed: the
    forward on weights carried by ``params_from_jax``, then 3 epochs."""
    rng = np.random.default_rng(SEED + 1)
    n, t, d = 96, 8, 16
    labels = rng.integers(0, 2, n).astype(np.int32)
    x = rng.normal(0, 0.1, (n, t, d)).astype(np.float32)
    x[np.arange(n), labels * (t // 2) + rng.integers(0, t // 2, n)] += 2.0
    data = ({"train": x[:64], "test": x[64:]}, {"train": labels[:64], "test": labels[64:]})
    kw = dict(decision_config={"max_epochs": 3},
              default_hyper={"learning_rate": 0.05, "gradient_moment": 0.9})
    _seed_both()
    jwf = JaxWorkflow(JaxLoader(*data, minibatch_size=32), ATTENTION_LAYERS,
                      prefetch_batches=0, **kw)
    twf = StandardWorkflow(FullBatchLoader(*data, minibatch_size=32), ATTENTION_LAYERS,
                           device="cpu", **kw)
    jinit = jax.device_get(jwf.model.params)
    carried = model_lib.params_from_jax(jinit, "cpu")
    out = {
        "jax_init": jinit,
        "torch_init": model_lib.params_to_numpy(twf.model.params),
        "jax_fwd": np.asarray(jwf.model.apply(jwf.model.params, jnp.asarray(x[:16]), train=False)),
        "torch_fwd": twf.model.apply(carried, torch.from_numpy(x[:16])).numpy(),
        "shapes": (jwf.model.output_shape, twf.model.layer_shapes),
        "jax_epochs": [], "torch_epochs": [],
    }
    jwf.initialize()
    twf.initialize()
    for _ in range(3):
        out["jax_epochs"].append(jwf.run_epoch()["summary"])
        out["torch_epochs"].append(twf.run_epoch()["summary"])
    out["jax_final"] = jax.device_get(jwf.state.params)
    out["torch_final"] = model_lib.params_to_numpy(twf.state.params)
    tprng.reset()
    return out


def test_attention_layer_init_and_forward_match_jax(attention_runs):
    r = attention_runs
    assert tuple(r["shapes"][1]) == ((8, 16), (8, 16), (2,))
    assert tuple(r["shapes"][0]) == (2,)
    for lj, lt in zip(r["jax_init"], r["torch_init"]):
        assert lj.keys() == lt.keys()
        for k in lj:
            np.testing.assert_array_equal(lt[k], np.asarray(lj[k]))
    np.testing.assert_allclose(r["torch_fwd"], r["jax_fwd"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("epoch", [0, 1, 2])
def test_attention_layer_epochs_match_jax(attention_runs, epoch):
    for split in ("train", "test"):
        mj = attention_runs["jax_epochs"][epoch][split]
        mt = attention_runs["torch_epochs"][epoch][split]
        assert mt["n_samples"] == mj["n_samples"] and mt["n_err"] == mj["n_err"]
        np.testing.assert_allclose(mt["loss"], mj["loss"], rtol=RTOL_EPOCH, err_msg=split)


def test_attention_layer_final_weights_match_jax(attention_runs):
    r = attention_runs
    for lj, lt, l0 in zip(r["jax_final"], r["torch_final"], r["torch_init"]):
        for k in lj:
            assert not np.array_equal(lt[k], l0[k])  # training moved them
            np.testing.assert_allclose(lt[k], np.asarray(lj[k]), rtol=RTOL_W, atol=ATOL_W)


def test_attention_layer_needs_sequence_input():
    with pytest.raises(ValueError, match="attention"):
        model_lib.build([{"type": "attention", "->": {"n_heads": 2}}], (16,), device="cpu")
