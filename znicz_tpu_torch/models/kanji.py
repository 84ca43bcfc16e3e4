"""Kanji classifier (port of ``znicz_tpu/models/kanji.py``).

A deeper MLP (tanh 250 -> tanh 100 -> softmax) over 24x24 grey glyphs with
many classes: the ``train/<kanji>/*.png`` tree of ``data_dir`` when given
(the head takes its class count), else the JAX package's synthetic
stand-in of the same geometry (1500 / 300, 24 classes).
"""

from znicz_tpu_torch.core import device as device_lib
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader import datasets
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
from znicz_tpu_torch.models import (
    effective_config, grayscale_image_dir_loader, merge_workflow_kwargs,
)
from znicz_tpu_torch.workflow.standard import StandardWorkflow

_GD = {"learning_rate": 0.02, "gradient_moment": 0.9, "weights_decay": 0.0005}

DEFAULTS = {
    "loader": {
        "data_dir": None,  # train/<kanji>/*.png tree; synthetic when None
        "minibatch_size": 50,
        "n_train": 1500,
        "n_test": 300,
        "n_classes": 24,
        "side": 24,
    },
    "layers": [
        {"type": "all2all_tanh", "->": {"output_sample_shape": 250}, "<-": _GD},
        {"type": "all2all_tanh", "->": {"output_sample_shape": 100}, "<-": _GD},
        {"type": "softmax", "->": {"output_sample_shape": 24}, "<-": _GD},
    ],
    "decision": {"max_epochs": 15, "fail_iterations": 20},
}
root.kanji.update(DEFAULTS)


def build_workflow(**overrides) -> StandardWorkflow:
    """The Kanji workflow; ``device=`` picks the device (default: the card,
    raising without one), other overrides go to StandardWorkflow."""
    overrides["device"] = device_lib.resolve(overrides.get("device"))
    cfg = effective_config(root.kanji, DEFAULTS)
    lcfg = cfg.loader
    side = lcfg.get("side", 24)
    n_classes = lcfg.get("n_classes", 24)
    data_dir = lcfg.get("data_dir") or root.common.get("data_dir")
    if data_dir:
        loader = grayscale_image_dir_loader(
            data_dir, side=side, minibatch_size=lcfg.get("minibatch_size", 50)
        )
        n_classes = len(loader.classes)
    else:
        data, labels = datasets._synthetic_split(
            lcfg.get("n_train", 1500), lcfg.get("n_test", 300), (side * side,), n_classes
        )
        loader = FullBatchLoader(data, labels, minibatch_size=lcfg.get("minibatch_size", 50))
    layers = cfg.get("layers")
    layers[-1]["->"]["output_sample_shape"] = n_classes
    kwargs = merge_workflow_kwargs(
        {"decision_config": cfg.decision.to_dict(), "name": "KanjiWorkflow"}, overrides
    )
    return StandardWorkflow(loader, layers, **kwargs)


def run(load, main):
    load(build_workflow)
    main()
