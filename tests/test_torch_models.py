"""The MNIST MLP, Wine and CIFAR-10 models of the port against the JAX
package's, on the CPU.

Each model trains from the same seed in both frameworks at a cut size
(MNIST n_train 300 / n_test 100 and Wine's 178 samples over 3 epochs;
CIFAR-10 n_train 200 / n_test 100 over 2 epochs, through ``root`` overrides
on both sides; the published widths).  Initial weights and shuffle order are
equal exactly (shared numpy streams).  Per-epoch loss and n_err agree within
rtol 1e-4, final weights within rtol 1e-4 / atol 1e-5 (f32, matmul precision
"highest", TF32 off; the sums run in another order in each framework).
``evaluate(confusion=True)`` from the same weights gives JAX's confusion
matrix exactly and its loss within rtol 1e-5; ``predict`` agrees within
rtol 1e-5 (atol 1e-7).
"""

import jax
import numpy as np
import pytest
import torch

from znicz_tpu.core import prng as jprng
from znicz_tpu.core.config import root as jroot
from znicz_tpu.models import cifar as jax_cifar, mnist as jax_mnist, wine as jax_wine
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.config import root as troot
from znicz_tpu_torch.models import cifar, mnist, wine
from znicz_tpu_torch.workflow import model as model_lib

torch.set_float32_matmul_precision("highest")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

SEED = 4321
RTOL_EPOCH = 1e-4
RTOL_W, ATOL_W = 1e-4, 1e-5
RTOL_EVAL = 1e-5
MODELS = {  # name: (port module, JAX module, loader overrides, epochs, evaluated split)
    "mnist": (mnist, jax_mnist, {"n_train": 300, "n_test": 100}, 3, "test"),
    "wine": (wine, jax_wine, {}, 3, "train"),
    "cifar": (cifar, jax_cifar, {"n_train": 200, "n_test": 100}, 2, "test"),
}


def _seed_both():
    for reg in (jprng, tprng):
        reg.reset()
        reg.seed_all(SEED)


def _build_both(name):
    """Both workflows of ``name`` from one seed, the roots restored after."""
    tmod, jmod, sizes, epochs, _ = MODELS[name]
    saved = (jroot.to_dict(), troot.to_dict())
    getattr(jroot, name).loader.update(sizes)
    getattr(troot, name).loader.update(sizes)
    _seed_both()
    try:
        dc = {"max_epochs": epochs}
        jwf = jmod.build_workflow(prefetch_batches=0, decision_config=dc)
        twf = tmod.build_workflow(device="cpu", decision_config=dc)
    finally:
        for root, tree in zip((jroot, troot), saved):
            root.clear()
            root.update(tree)
    return jwf, twf


@pytest.fixture(scope="module", params=sorted(MODELS))
def runs(request):
    """Both workflows trained side by side; what the tests below compare."""
    name = request.param
    jwf, twf = _build_both(name)
    out = {
        "name": name,
        "jax_init": jax.device_get(jwf.model.params),
        "torch_init": model_lib.params_to_numpy(twf.model.params),
        "jax_order": [], "torch_order": [], "jax_epochs": [], "torch_epochs": [],
    }
    jwf.initialize()
    twf.initialize()
    for _ in range(MODELS[name][3]):
        out["jax_epochs"].append(jwf.run_epoch()["summary"])
        out["torch_epochs"].append(twf.run_epoch()["summary"])
        out["jax_order"].append(jwf.loader._order["train"].copy())
        out["torch_order"].append(twf.loader._order["train"].copy())
    out["jax_final"] = jax.device_get(jwf.state.params)
    out["torch_final"] = model_lib.params_to_numpy(twf.state.params)
    out["jax_wf"], out["torch_wf"] = jwf, twf
    tprng.reset()
    return out


def test_init_params_and_shuffle_order_equal_exactly(runs):
    assert len(runs["jax_init"]) == len(runs["torch_init"])
    for lj, lt in zip(runs["jax_init"], runs["torch_init"]):
        assert lj.keys() == lt.keys()
        for k in lj:
            np.testing.assert_array_equal(lt[k], np.asarray(lj[k]))
    for oj, ot in zip(runs["jax_order"], runs["torch_order"]):
        np.testing.assert_array_equal(ot, oj)
    assert not np.array_equal(runs["torch_order"][0], runs["torch_order"][1])


def test_epoch_metrics_match(runs):
    for ej, et in zip(runs["jax_epochs"], runs["torch_epochs"]):
        assert et.keys() == ej.keys()
        for split in ej:
            assert et[split]["n_samples"] == ej[split]["n_samples"]
            for key in ("loss", "n_err"):
                np.testing.assert_allclose(
                    et[split][key], ej[split][key], rtol=RTOL_EPOCH,
                    err_msg=f"{runs['name']} {split} {key}",
                )


def test_final_params_match(runs):
    for lj, lt in zip(runs["jax_final"], runs["torch_final"]):
        for k in lj:
            np.testing.assert_allclose(lt[k], np.asarray(lj[k]), rtol=RTOL_W, atol=ATOL_W)


def test_params_from_jax_round_trip(runs):
    params = model_lib.params_from_jax(runs["jax_final"], "cpu")
    for lj, lt in zip(runs["jax_final"], model_lib.params_to_numpy(params)):
        assert lj.keys() == lt.keys()
        for k in lj:
            assert lt[k].dtype == np.float32
            np.testing.assert_array_equal(lt[k], np.asarray(lj[k]))


def _same_weights(runs):
    """The port's train state set to the JAX run's final weights."""
    twf = runs["torch_wf"]
    with torch.no_grad():
        for lt, lj in zip(twf.state.params, runs["jax_final"]):
            for k in lt:
                lt[k].copy_(torch.from_numpy(np.array(lj[k])))
    return runs["jax_wf"], twf


def test_evaluate_with_confusion_matches_jax(runs):
    jwf, twf = _same_weights(runs)
    split = MODELS[runs["name"]][4]
    order = twf.loader._order["train"].copy()
    want = jwf.evaluate(split, confusion=True)
    got = twf.evaluate(split, confusion=True)
    assert got.keys() == want.keys() == {"n_samples", "n_err", "err_pct", "loss", "confusion"}
    assert got["confusion"].dtype == np.int32
    np.testing.assert_array_equal(got["confusion"], np.asarray(want["confusion"]))
    assert got["confusion"].sum() == got["n_samples"]
    assert np.trace(got["confusion"]) == got["n_samples"] - got["n_err"]
    for key in ("n_samples", "n_err", "err_pct"):
        assert got[key] == want[key]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL_EVAL)
    # evaluation reads the split in its stored order: the shuffle stream
    # does not move
    np.testing.assert_array_equal(twf.loader._order["train"], order)
    plain = twf.evaluate(split)
    assert "confusion" not in plain and plain["n_err"] == got["n_err"]


def test_evaluate_of_an_empty_split_raises_as_jax_does(runs):
    jwf, twf = runs["jax_wf"], runs["torch_wf"]
    # Wine has only "train", CIFAR-10 no "valid"; MNIST has all three
    missing = {"wine": "test", "cifar": "valid", "mnist": "unknown"}[runs["name"]]
    with pytest.raises(ValueError, match="no samples") as want:
        jwf.evaluate(missing)
    with pytest.raises(ValueError, match="no samples") as got:
        twf.evaluate(missing)
    assert str(got.value) == str(want.value)


def test_predict_and_layer_specs_match_jax(runs):
    jwf, twf = _same_weights(runs)
    assert twf.model.layer_specs == jwf.model.layer_specs
    mb = next(iter(twf.loader.batches(MODELS[runs["name"]][4], shuffle=False)))
    x = mb.data[:8].astype(np.float32)
    want = np.asarray(jwf.model.predict(jwf.state.params, x))
    with torch.no_grad():
        got = twf.model.predict(twf.state.params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL_EVAL, atol=1e-7)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-5)


def test_models_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    for mod in (mnist, wine, cifar):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.build_workflow()


def test_cifar_inv_policy_counts_steps_from_zero():
    """Step 0 runs at the base lr, as in the JAX package."""
    _, twf = _build_both("cifar")
    assert twf.lr_policy(1.0, 0) == 1.0
    np.testing.assert_allclose(twf.lr_policy(1.0, 10), (1 + 1e-4 * 10) ** -0.75)
