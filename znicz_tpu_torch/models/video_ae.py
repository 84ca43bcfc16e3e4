"""Video autoencoder (port of ``znicz_tpu/models/video_ae.py``).

An MLP autoencoder over flattened 16x16 grey frames (tanh 64 -> linear
256, MSE against the input): the ``train/<sequence>/*.png`` frame tree of
``data_dir`` when given (its directory labels unused), else the JAX
package's synthetic frame sequences (a prototype a sequence with a
temporal drift), drawn from the "datasets" stream in the JAX package's
order.
"""

import numpy as np

from znicz_tpu_torch.core import device as device_lib, prng
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
from znicz_tpu_torch.models import (
    effective_config, grayscale_image_dir_loader, merge_workflow_kwargs,
)
from znicz_tpu_torch.workflow.standard import StandardWorkflow

_GD = {"learning_rate": 0.05, "gradient_moment": 0.9}

DEFAULTS = {
    "loader": {
        # train/<seq>/*.png frame tree (labels unused); synthetic when None
        "data_dir": None,
        "minibatch_size": 50,
        "n_sequences": 20,
        "frames_per_seq": 30,
        "side": 16,
    },
    "layers": [
        {"type": "all2all_tanh", "->": {"output_sample_shape": 64}, "<-": _GD},
        {"type": "all2all", "->": {"output_sample_shape": 256}, "<-": _GD},
    ],
    "decision": {"max_epochs": 15, "fail_iterations": 15},
}
root.video_ae.update(DEFAULTS)


def _synthetic_frames(n_seq: int, frames: int, side: int) -> np.ndarray:
    """Smoothly drifting frame sequences: a base, a drift and per-frame
    noise a sequence, in that order of draws."""
    gen = prng.get("datasets")
    dim = side * side
    out = np.zeros((n_seq * frames, dim), np.float32)
    for s in range(n_seq):
        base = gen.normal((dim,), 0.0, 1.0)
        drift = gen.normal((dim,), 0.0, 0.05)
        for t in range(frames):
            noise = gen.normal((dim,), 0.0, 0.1)
            out[s * frames + t] = base + t * drift + noise
    return out


def build_workflow(**overrides) -> StandardWorkflow:
    """The video autoencoder workflow; ``device=`` picks the device
    (default: the card, raising without one), other overrides go to
    StandardWorkflow."""
    overrides["device"] = device_lib.resolve(overrides.get("device"))
    cfg = effective_config(root.video_ae, DEFAULTS)
    lcfg = cfg.loader
    side = lcfg.get("side", 16)
    data_dir = lcfg.get("data_dir") or root.common.get("data_dir")
    if data_dir:
        loader = grayscale_image_dir_loader(
            data_dir, side=side, minibatch_size=lcfg.get("minibatch_size", 50)
        )
    else:
        frames = _synthetic_frames(
            lcfg.get("n_sequences", 20), lcfg.get("frames_per_seq", 30), side
        )
        n_test = len(frames) // 5
        loader = FullBatchLoader(
            {"train": frames[n_test:], "test": frames[:n_test]},
            minibatch_size=lcfg.get("minibatch_size", 50),
            normalization="mean_disp",
        )
    layers = cfg.get("layers")
    layers[-1]["->"]["output_sample_shape"] = side * side
    kwargs = merge_workflow_kwargs(
        {
            "decision_config": cfg.decision.to_dict(),
            "loss_function": "mse",
            "target": "input",
            "name": "VideoAEWorkflow",
        },
        overrides,
    )
    return StandardWorkflow(loader, layers, **kwargs)


def run(load, main):
    load(build_workflow)
    main()
