"""StandardWorkflow: declarative config -> complete training workflow
(port of ``znicz_tpu/workflow/standard.py``).

The same ``layers=[{"type": ..., "->": {...}, "<-": {...}}, ...]`` list
compiles the model (:mod:`znicz_tpu_torch.workflow.model`) and assembles a
:class:`Workflow`; the gradient chain is autograd.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from znicz_tpu_torch.core import device as device_lib
from znicz_tpu_torch.loader.base import Loader
from znicz_tpu_torch.nn import lr_adjust, optimizer
from znicz_tpu_torch.nn.decision import Decision
from znicz_tpu_torch.workflow import model as model_lib
from znicz_tpu_torch.workflow.snapshotter import Snapshotter
from znicz_tpu_torch.workflow.workflow import Workflow


class StandardWorkflow(Workflow):
    """Build a full workflow from a layer list.

    ``layers``: reference-style layer specs (the last layer's type picks the
    loss when ``loss_function`` is not given: "softmax" -> cross-entropy,
    anything else -> mse).  ``decision_config``: kwargs for
    :class:`Decision`.  ``lr_policy``: name + kwargs, e.g.
    ``{"name": "step", "step_size": 100, "gamma": 0.1}``.
    ``compute_dtype``: e.g. "bfloat16" for mixed precision.  ``device``:
    None means the card (raises without one); "cpu" runs on the CPU.

    ``snapshot_dir``: a :class:`Snapshotter` there (prefix ``name``, its
    knobs from ``snapshot_config``), as in the JAX package.
    ``prefetch_batches``: the prefetch thread's depth (0: in series).  The
    JAX package's other loop keywords go to :class:`Workflow`, which takes
    them at their defaults and refuses the rest by name.
    """

    def __init__(
        self,
        loader: Loader,
        layers: Sequence[Dict[str, Any]],
        *,
        loss_function: Optional[str] = None,
        target: Optional[str] = None,
        decision_config: Optional[Dict[str, Any]] = None,
        snapshot_dir: Optional[str] = None,
        snapshot_config: Optional[Dict[str, Any]] = None,
        lr_policy: Optional[Dict[str, Any]] = None,
        default_hyper: Optional[Dict[str, Any]] = None,
        compute_dtype: Optional[Any] = None,
        prefetch_batches: int = 2,
        parallel=None,
        epoch_dispatch: str = "auto",
        epoch_sync: str = "sync",
        anomaly=True,
        recovery=None,
        rand_name: str = "default",
        device=None,
        name: str = "StandardWorkflow",
    ):
        dev = device_lib.resolve(device)
        if isinstance(compute_dtype, str):
            compute_dtype = getattr(torch, compute_dtype)
        hyper = optimizer.HyperParams(**(default_hyper or {}))
        # the initial weights stay on the host; initialize() places the
        # train state's one copy on ``dev``
        mdl = model_lib.build(
            layers,
            loader.sample_shape,
            rand_name=rand_name,
            default_hyper=hyper,
            compute_dtype=compute_dtype,
            device="cpu",
        )
        if loss_function is None:
            loss_function = "softmax" if mdl.returns_logits else "mse"
        if target is None:
            target = "labels" if loss_function == "softmax" else "input"
        decision = Decision(
            metric="n_err" if loss_function == "softmax" else "loss",
            **(decision_config or {}),
        )
        snapshotter = None
        if snapshot_dir:
            snapshotter = Snapshotter(snapshot_dir, prefix=name, **(snapshot_config or {}))
        policy = None
        if lr_policy:
            kw = dict(lr_policy)
            policy = lr_adjust.get(kw.pop("name"), **kw)
        super().__init__(
            loader,
            mdl,
            loss_function=loss_function,
            target=target,
            decision=decision,
            snapshotter=snapshotter,
            lr_policy=policy,
            parallel=parallel,
            prefetch_batches=prefetch_batches,
            epoch_dispatch=epoch_dispatch,
            epoch_sync=epoch_sync,
            anomaly=anomaly,
            recovery=recovery,
            device=dev,
            name=name,
        )

    def _default_param_rules(self):
        """Conv models get channel-aware TP rules (Megatron column/row
        alternation, ``parallel.data_parallel.cnn_tp_rules``) instead of
        the last-dim size heuristic: conv kernels carry the FLOPs, so
        keeping them whole wastes the model axis.  Pure-FC models keep the
        heuristic."""
        if not any(isinstance(p, dict) and getattr(p.get("weights"), "ndim", 0) == 4
                   for p in self.model.params):
            return None
        from znicz_tpu_torch.parallel.data_parallel import cnn_tp_rules

        return cnn_tp_rules(self.model, self.parallel.n_model,
                            tp_min_features=self.parallel.tp_min_features)
