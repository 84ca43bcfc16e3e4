"""The port's per-epoch services against the JAX package's, on the CPU.

Both sides train the MNIST MLP (the published widths, n_train 300 /
n_test 100, 2 epochs) from one seed with every service attached:
``MetricsCSVWriter`` (rows within rtol 1e-4), ``StatusWriter``
(``status.json``'s keys and the summary's keys equal; ``devices`` is
torch's list, a documented divergence), ``ImageSaver`` (the same file
names: the same worst and best samples), the plotters (their PNGs here,
where matplotlib is installed) and ``MarkdownReporter`` (the same report
keys and epochs).  The service loop runs after the snapshotter, on the
coordinator only, in both epoch-sync modes and in every workflow family; a
service that raises is logged with its traceback and training finishes.
The small names of the slice (``clip_gradients``, ``softmax_apply``,
``log_softmax``, ``mul``, ``prng.names``, ``native.available``) agree
with JAX's (rtol 1e-6).
"""

import csv
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu import services as jservices
from znicz_tpu.core import prng as jprng
from znicz_tpu.core.config import root as jroot
from znicz_tpu.loader import native as jnative
from znicz_tpu.models import mnist as jax_mnist
from znicz_tpu.nn import optimizer as joptimizer
from znicz_tpu.ops import activation as jact, all2all as jall2all
from znicz_tpu_torch import services as tservices
from znicz_tpu_torch.core import Logger, prng as tprng
from znicz_tpu_torch.core.config import root as troot
from znicz_tpu_torch.loader import FullBatchLoader, datasets, native as tnative
from znicz_tpu_torch.models import mnist
from znicz_tpu_torch.nn import optimizer as toptimizer
from znicz_tpu_torch.ops import activation as tact, all2all as tall2all
from znicz_tpu_torch.workflow import (
    KohonenWorkflow,
    RBMWorkflow,
    TransformerLMWorkflow,
    Workflow,
)

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False

SEED = 4321
EPOCHS = 2
SIZES = {"n_train": 300, "n_test": 100}


def _services(pkg, out):
    return [
        pkg.MetricsCSVWriter(out),
        pkg.StatusWriter(out),
        pkg.ImageSaver(os.path.join(out, "images"), split="train", n_images=3),
        pkg.AccumulatingPlotter(out),
        pkg.Weights2D(out),
        pkg.MarkdownReporter(out),
    ]


SIDES = {
    "jax": (jroot, jprng, jax_mnist, jservices, {"prefetch_batches": 0}),
    "torch": (troot, tprng, mnist, tservices, {"device": "cpu"}),
}


def _build(side):
    """The MNIST MLP of ``side`` from the shared seed, its root restored."""
    root, reg, mod, _, kw = SIDES[side]
    saved = root.to_dict()
    try:
        root.mnist.loader.update(SIZES)
        reg.reset()
        reg.seed_all(SEED)
        wf = mod.build_workflow(decision_config={"max_epochs": EPOCHS}, **kw)
    finally:
        root.clear()
        root.update(saved)
    wf.initialize()
    return wf


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The MNIST MLP trained on both sides from one seed, every service on."""
    out = {}
    for side in SIDES:
        wf = _build(side)
        d = str(tmp_path_factory.mktemp(side))
        wf.services += _services(SIDES[side][3], d)
        wf.run()
        out[side] = (wf, d)
    return out


def _saved(root):
    return sorted(os.path.join(e, n) for e in os.listdir(root)
                  for n in os.listdir(os.path.join(root, e)))


def _csv(path):
    with open(os.path.join(path, "metrics.csv"), newline="") as f:
        return list(csv.DictReader(f))


def test_metrics_csv_rows_agree(runs):
    want, got = _csv(runs["jax"][1]), _csv(runs["torch"][1])
    assert len(got) == len(want) == EPOCHS
    for g, w in zip(got, want):
        assert list(g) == list(w)
        np.testing.assert_allclose([float(v) for v in g.values()],
                                   [float(v) for v in w.values()], rtol=1e-4)


def test_status_json_has_jaxs_keys(runs):
    want, got = (json.load(open(os.path.join(runs[s][1], "status.json"))) for s in ("jax", "torch"))
    assert list(got) == list(want)
    assert {k: list(v) for k, v in got["summary"].items()} == {
        k: list(v) for k, v in want["summary"].items()}
    assert got["epoch"] == want["epoch"] == EPOCHS - 1
    assert got["devices"] == ["cpu"]
    for name in ("status.html", "metrics.prom"):
        assert os.path.getsize(os.path.join(runs["torch"][1], name)) > 0


def test_image_saver_names_the_same_samples(runs, tmp_path):
    """The trained runs' dumps, and a dump from the initial weights (where
    many samples are wrong), name the same samples on both sides."""
    assert _saved(os.path.join(runs["torch"][1], "images")) == _saved(
        os.path.join(runs["jax"][1], "images"))
    for side in SIDES:
        wf = _build(side)
        SIDES[side][3].ImageSaver(str(tmp_path / side), split="test", n_images=4).on_epoch(
            wf, None)
    names = _saved(str(tmp_path / "torch"))
    assert names == _saved(str(tmp_path / "jax"))
    assert sum("worst" in n for n in names) == 4 and any("best" in n for n in names)


def test_image_saver_leaves_the_shuffle_stream(tmp_path):
    """A service pass reads the split in its stored order: the loader's
    stream is where the run without the service leaves it."""
    states = []
    for with_saver in (False, True):
        tprng.reset()
        tprng.seed_all(3)
        wf = mnist.build_workflow(device="cpu", decision_config={"max_epochs": 1})
        if with_saver:
            wf.services.append(tservices.ImageSaver(str(tmp_path), n_images=1))
        wf.initialize()
        wf.run()
        states.append(tprng.get(wf.loader.rand_name).state_dict())
    assert repr(states[0]) == repr(states[1])


def test_plotters_and_report_write_their_files(runs):
    d = runs["torch"][1]
    for name in ("loss.png", "weights0.png", "report.md"):
        assert os.path.getsize(os.path.join(d, name)) > 0
    want, got = (json.load(open(os.path.join(runs[s][1], "report.json"))) for s in ("jax", "torch"))
    assert list(got) == list(want) and got["epochs"] == want["epochs"] == EPOCHS
    assert open(os.path.join(d, "report.md")).read().count("\n| ") >= 2 + EPOCHS


class _Count:
    def __init__(self, snapshot_dir=None):
        self.epochs, self.snapshot_dir = [], snapshot_dir

    def on_epoch(self, workflow, verdict):
        # the snapshotter wrote this epoch's interval snapshot before us
        if self.snapshot_dir is not None:
            n = workflow.decision.epoch - 1
            assert any(f"epoch{n}" in f for f in os.listdir(self.snapshot_dir))
        self.epochs.append(workflow.decision.epoch - 1)


class _Boom:
    def on_epoch(self, workflow, verdict):
        raise RuntimeError("service broke")


def _mnist_wf(**kw):
    tprng.reset()
    tprng.seed_all(SEED)
    loader = datasets.mnist(n_train=200, n_test=0, minibatch_size=100)
    layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": 16}},
              {"type": "softmax", "->": {"output_sample_shape": 10}}]
    return mnist.StandardWorkflow(loader, layers, device="cpu",
                                  decision_config={"max_epochs": 3}, **kw)


@pytest.mark.parametrize("sync", ["sync", "deferred"])
def test_services_run_after_the_snapshotter_every_epoch(sync, tmp_path):
    snaps = str(tmp_path / "snaps")
    wf = _mnist_wf(epoch_sync=sync, snapshot_dir=snaps, snapshot_config={"interval": 1})
    count = _Count(snaps)
    wf.services.append(count)
    wf.run()
    assert count.epochs == [0, 1, 2]


def test_a_raising_service_is_logged_and_training_finishes(caplog):
    wf = _mnist_wf()
    count = _Count()
    wf.services += [_Boom(), count]
    with caplog.at_level(logging.ERROR):
        dec = wf.run()
    assert dec.epoch == 3 and count.epochs == [0, 1, 2]
    failed = [r for r in caplog.records if r.getMessage() == "service _Boom failed"]
    assert len(failed) == 3 and all(r.exc_info and "service broke" in str(r.exc_info[1])
                                    for r in failed)
    assert failed[0].name == "StandardWorkflow"


def test_services_run_on_the_coordinator_only():
    wf = _mnist_wf()
    count = _Count()
    wf.services.append(count)
    wf.initialize()
    wf._coordinator = False  # a rank other than 0
    wf.run()
    assert wf.decision.epoch == 3 and count.epochs == []


def _family(kind):
    tprng.reset()
    tprng.seed_all(7)
    if kind == "lm":
        tokens = np.random.default_rng(7).integers(0, 16, (16, 12)).astype(np.int32)
        return TransformerLMWorkflow(FullBatchLoader({"train": tokens}, minibatch_size=8),
                                     vocab=16, d_model=16, n_layers=1, n_heads=2, max_epochs=2,
                                     device="cpu")
    loader = datasets.mnist(n_train=100, n_test=0, minibatch_size=50, normalization="mean_disp")
    if kind == "kohonen":
        return KohonenWorkflow(loader, sx=3, sy=3, total_epochs=2, device="cpu")
    return RBMWorkflow(loader, n_hidden=8, max_epochs=2, device="cpu")


@pytest.mark.parametrize("kind", ["kohonen", "rbm", "lm"])
def test_every_family_reaches_the_service_loop(kind):
    wf = _family(kind)
    assert isinstance(wf, Workflow) and isinstance(wf, Logger)
    count = _Count()
    wf.services.append(count)
    wf.run()
    assert count.epochs == [0, 1]


def test_workflow_logs_as_jaxs_does(caplog):
    wf = _mnist_wf()
    with caplog.at_level(logging.INFO):
        wf.info("epoch %d", 4)
        wf.warning("careful")
    assert [(r.name, r.levelname, r.getMessage()) for r in caplog.records] == [
        ("StandardWorkflow", "INFO", "epoch 4"), ("StandardWorkflow", "WARNING", "careful")]
    assert wf.logger.name == "StandardWorkflow"


def test_small_names_agree_with_jax():
    rng = np.random.default_rng(11)
    grads = [{"weights": rng.standard_normal((5, 3)).astype(np.float32),
              "bias": rng.standard_normal(3).astype(np.float32)},
             {"weights": rng.standard_normal((3, 2)).astype(np.float32)}]
    for max_norm in (None, 0.5, 100.0):
        want = jax.device_get(joptimizer.clip_gradients(
            [{k: jnp.asarray(v) for k, v in g.items()} for g in grads], max_norm))
        got = toptimizer.clip_gradients(
            [{k: torch.from_numpy(v) for k, v in g.items()} for g in grads], max_norm)
        for w, g in zip(want, got):
            assert sorted(g) == sorted(w)  # a jax tree map sorts the keys
            for k in w:
                np.testing.assert_allclose(g[k].numpy(), w[k], rtol=1e-6)
    params = {"weights": rng.standard_normal((6, 4)).astype(np.float32),
              "bias": rng.standard_normal(4).astype(np.float32)}
    x = rng.standard_normal((3, 6)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    np.testing.assert_allclose(tall2all.softmax_apply(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jall2all.softmax_apply(jp, jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(tall2all.log_softmax(torch.from_numpy(x)).numpy(),
                               np.asarray(jall2all.log_softmax(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_array_equal(tact.mul(torch.from_numpy(x), torch.from_numpy(x)).numpy(),
                                  np.asarray(jact.mul(jnp.asarray(x), jnp.asarray(x))))
    for reg in (jprng, tprng):
        reg.reset()
        reg.get("b"), reg.get("a")
    assert tprng.names() == jprng.names() == ["b", "a"]
    assert tnative.available() is jnative.available() is True
