"""Kohonen self-organizing map on MNIST-shaped data (port of
``znicz_tpu/models/kohonen.py``; BASELINE.json configs[4]).

An 8x8 map over 784 features, batch 100, lr 0.5 -> 0.01 and sigma 4 -> 1,
on mean-dispersion normalized input: the MNIST IDX files of ``data_dir``
when given, else the synthetic stand-in drawn as the JAX package draws it.
"""

from znicz_tpu_torch.core import device as device_lib
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader import datasets
from znicz_tpu_torch.models import (
    effective_config,
    merge_workflow_kwargs,
    translate_unsupervised_overrides,
)
from znicz_tpu_torch.workflow.unsupervised import KohonenWorkflow

DEFAULTS = {
    "loader": {
        "data_dir": None,
        "minibatch_size": 100,
        "n_train": 1000,
        "n_test": 200,
    },
    "sx": 8,
    "sy": 8,
    "total_epochs": 20,
    "lr0": 0.5,
    "lr1": 0.01,
    "sigma1": 1.0,
}
root.kohonen.update(DEFAULTS)


def build_workflow(device=None, **overrides) -> KohonenWorkflow:
    """The SOM workflow; ``device`` defaults to the card (raising without
    one), other overrides go to :class:`KohonenWorkflow`."""
    # pick the device first: without a card this raises before any data is made
    device = device_lib.resolve(device)
    cfg = effective_config(root.kohonen, DEFAULTS)
    lcfg = cfg.loader
    loader = datasets.mnist(
        lcfg.get("data_dir") or root.common.get("data_dir"),
        minibatch_size=lcfg.get("minibatch_size", 100),
        n_train=lcfg.get("n_train", 1000),
        n_test=lcfg.get("n_test", 200),
        normalization="mean_disp",
    )
    kwargs = merge_workflow_kwargs(
        {
            "sx": cfg.get("sx", 8),
            "sy": cfg.get("sy", 8),
            "total_epochs": cfg.get("total_epochs", 20),
            "lr0": cfg.get("lr0", 0.5),
            "lr1": cfg.get("lr1", 0.01),
            "sigma1": cfg.get("sigma1", 1.0),
            "name": "KohonenWorkflow",
        },
        overrides,
    )
    kwargs = translate_unsupervised_overrides(kwargs, "total_epochs")
    return KohonenWorkflow(loader, device=device, **kwargs)
