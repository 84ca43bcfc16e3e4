"""The Workflow: a host loop around the train and eval steps (port of
``znicz_tpu/workflow/workflow.py``).

    loader -> [forward + loss + autograd + update + metrics] -> decision

Each step folds its metrics into one small per-split accumulator tensor on
the device, so an epoch costs one device->host fetch per split, as in the
JAX package.  The step runs eagerly; the learning rate of each step comes
from the lr policy on the host.

This slice leaves out, for later slices: the whole-split scan dispatch,
deferred epoch sync, the step anomaly watch, rollback recovery, the
snapshotter, the prefetch thread and the parallel placement policies.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from znicz_tpu_torch.core import device as device_lib, prng
from znicz_tpu_torch.loader.base import TRAIN, Loader
from znicz_tpu_torch.nn import evaluator, optimizer
from znicz_tpu_torch.nn.decision import Decision
from znicz_tpu_torch.nn.train_state import TrainState
from znicz_tpu_torch.workflow.model import Model

logger = logging.getLogger(__name__)


def refuse_unported(cases) -> None:
    """Raise ``NotImplementedError`` for the first ``(on, what, item)`` of
    ``cases`` that is on, naming its ``ROADMAP.md`` item: a JAX keyword the
    port takes at its default and refuses by name otherwise."""
    for on, what, item in cases:
        if on:
            raise NotImplementedError(
                f"{what} is not ported to znicz_tpu_torch yet (ROADMAP.md {item})"
            )


def _is_additive(name: str) -> bool:
    return not name.startswith("max_")


def _decode_metrics(acc: np.ndarray, names) -> Dict[str, float]:
    """Accumulator vector -> one aggregated metrics dict whose
    ``EpochMetrics.add`` outcome equals adding every minibatch."""
    d = dict(zip(names, np.asarray(acc, np.float64)))
    n = max(float(d.get("n_samples", 0.0)), 1.0)
    return {
        k: float(v)
        if k in ("n_samples", "n_err") or not _is_additive(k)
        else float(v) / n
        for k, v in d.items()
    }


class Workflow:
    """Owns loader + model + decision; runs training on ``device``.

    ``loss_function``: "softmax" (cross-entropy on integer labels) or "mse"
    (against ``target`` = "targets" from the loader, or "input" for
    autoencoders).  ``device``: None means the card (raises without one).
    ``metric_names``: the keys a subclass's steps report (default: the
    loss function's); ``max_*`` combine by maximum, ``n_samples`` and
    ``n_err`` add, the rest are sample-weighted means.
    """

    def __init__(
        self,
        loader: Loader,
        model: Model,
        *,
        loss_function: str = "softmax",
        target: str = "labels",
        decision: Optional[Decision] = None,
        lr_policy: Optional[Callable[[float, int], float]] = None,
        device=None,
        metric_names: Optional[Sequence[str]] = None,
        name: str = "workflow",
    ):
        self.loader = loader
        self.model = model
        self.loss_function = loss_function
        self.target = target
        self.decision = decision or Decision(
            metric="n_err" if loss_function == "softmax" else "loss"
        )
        self.lr_policy = lr_policy
        self.device = device_lib.resolve(device)
        self.name = name
        self.state: Optional[TrainState] = None
        if metric_names is None:
            metric_names = (
                ["loss", "max_err_y_sum", "n_err", "n_samples"]
                if loss_function == "softmax"
                else ["loss", "max_diff", "n_samples"]
            )
        self._metric_names = sorted(metric_names)
        self._additive = np.array([_is_additive(k) for k in self._metric_names])
        self._pre = loader.device_preproc()

    # ------------------------------------------------------------------
    def initialize(self, *, seed: Optional[int] = None, device=None) -> None:
        """Create the train state on ``device`` (default: the workflow's)
        from a copy of the model's initial params, which the in-place
        updates leave untouched.  ``seed`` reseeds every named generator
        first (``prng.seed_all``)."""
        if seed is not None:
            prng.seed_all(seed)
        if device is not None:
            self.device = device_lib.resolve(device)
        self.state = self._create_initial_state()
        self._add_mask = torch.as_tensor(self._additive, device=self.device)

    def _create_initial_state(self) -> TrainState:
        """A fresh train state on the workflow's device (subclasses that
        draw their params at initialize time override this)."""
        params = [
            {
                k: w.detach().to(self.device, copy=True).requires_grad_(True)
                for k, w in layer.items()
            }
            for layer in self.model.params
        ]
        return TrainState.create(params, prng.get("workflow").generator(self.device))

    def _metrics(self, out, y, mask):
        if self.loss_function == "softmax":
            return evaluator.softmax(out, y, mask=mask)
        return evaluator.mse(out, y, mask=mask)

    def _acc_init(self) -> torch.Tensor:
        return torch.as_tensor(
            np.where(self._additive, 0.0, -np.inf).astype(np.float32),
            device=self.device,
        )

    def _combine(self, acc: torch.Tensor, m: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Fold one step's metrics into the epoch accumulator, on the
        device: counts add, means add sample-weighted, ``max_*`` take the
        maximum."""
        n = torch.as_tensor(m["n_samples"], dtype=torch.float32, device=self.device)
        vals = []
        for k in self._metric_names:
            v = torch.as_tensor(m[k], device=self.device).detach().float()
            vals.append(v if k in ("n_samples", "n_err") or not _is_additive(k) else v * n)
        vec = torch.stack(vals)
        return torch.where(self._add_mask, acc + vec, torch.maximum(acc, vec))

    def _prep(self, x: torch.Tensor, y: torch.Tensor):
        if self._pre is None:
            return x, y
        x = self._pre(x)
        return x, (x if self.target == "input" else y)

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.device)

    def _batch_target(self, mb):
        if self.target == "labels":
            return mb.labels
        if self.target == "targets":
            return mb.targets
        if self.target == "input":
            return mb.data
        raise ValueError(f"unknown target {self.target!r}")

    def _forward_metrics(self, params, x, y, mask, *, train: bool) -> Dict[str, Any]:
        """The step's forward: the metrics dict, whose ``"loss"`` the train
        step differentiates (subclasses with their own loss override this)."""
        gen = self.state.generator if train else None
        out = self.model.apply(params, x, train=train, generator=gen)
        return self._metrics(out, y, mask)

    def _hyper(self):
        """The update rule's knobs, one HyperParams per layer of params."""
        return self.model.hyper

    # ------------------------------------------------------------------
    def train_step(self, x, y, mask, lr_scale: float = 1.0, acc=None) -> torch.Tensor:
        """One train step on device tensors (the loader's raw payload:
        the device preprocessing runs here): forward, loss, autograd, the
        in-place update.  Returns ``acc`` with this step's metrics folded in
        (a fresh accumulator when ``acc`` is None)."""
        st = self.state
        x, y = self._prep(x, y)
        leaves = [w for layer in st.params for w in layer.values()]
        with torch.enable_grad():
            m = self._forward_metrics(st.params, x, y, mask, train=True)
            flat = torch.autograd.grad(m["loss"], leaves)
        it = iter(flat)
        grads = [{k: next(it) for k in layer} for layer in st.params]
        # the lr scale multiplies in float32, as in the JAX package's step
        scale = np.float32(lr_scale)
        hyper = [
            h._replace(
                learning_rate=float(np.float32(h.learning_rate) * scale),
                learning_rate_bias=(
                    None
                    if h.learning_rate_bias is None
                    else float(np.float32(h.learning_rate_bias) * scale)
                ),
            )
            for h in self._hyper()
        ]
        optimizer.update(st.params, grads, st.velocity, hyper)
        st.step += 1
        return self._combine(self._acc_init() if acc is None else acc, m)

    @torch.no_grad()
    def eval_step(self, x, y, mask, acc=None) -> torch.Tensor:
        """One evaluation step; returns the updated accumulator."""
        x, y = self._prep(x, y)
        m = self._forward_metrics(self.state.params, x, y, mask, train=False)
        return self._combine(self._acc_init() if acc is None else acc, m)

    def _run_epoch_stepwise(self) -> Dict[str, torch.Tensor]:
        accs: Dict[str, torch.Tensor] = {}  # per-split device accumulators
        for split, mb in self.loader.epoch():
            x = self._put(mb.data)
            y = x if self.target == "input" else self._put(self._batch_target(mb))
            mask = self._put(mb.mask)
            acc = accs.get(split)
            if split == TRAIN:
                lr_scale = (
                    self.lr_policy(1.0, self.state.step) if self.lr_policy else 1.0
                )
                accs[split] = self.train_step(x, y, mask, lr_scale, acc)
            else:
                accs[split] = self.eval_step(x, y, mask, acc)
        return accs

    def _finish_epoch(self, accs: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        for split, acc in accs.items():  # one small fetch per split
            self.decision.add_minibatch(
                split, _decode_metrics(acc.cpu().numpy(), self._metric_names)
            )
        return self.decision.on_epoch_end()

    def run_epoch(self) -> Dict[str, Any]:
        """One full epoch over all splits; returns the Decision verdict."""
        if self.state is None:
            self.initialize()
        return self._finish_epoch(self._run_epoch_stepwise())

    @torch.no_grad()
    def _eval_conf_step(self, x, y, mask, acc, conf):
        """One evaluation step that also adds the minibatch's confusion
        counts into ``conf`` (the softmax loss only)."""
        x, y = self._prep(x, y)
        out = self.model.apply(self.state.params, x, train=False)
        m = evaluator.softmax(out, y, mask=mask, compute_confusion=True)
        return self._combine(acc, m), conf + m.pop("confusion")

    def evaluate(self, split: str = "test", *, confusion: bool = False) -> Dict[str, Any]:
        """One evaluation pass over ``split``, read in its stored order (the
        shuffle stream does not move).  Returns ``n_samples``, ``n_err``,
        ``err_pct`` and ``loss``, plus ``confusion`` (a numpy int32
        ``[n_classes, n_classes]`` array, rows the truth) when asked for and
        the loss is "softmax".  The metrics and the confusion are summed on
        the device: one fetch at the end, two with the confusion."""
        if self.state is None:
            self.initialize()
        if self.loader.class_lengths.get(split, 0) == 0:
            # evaluating zero samples would report a silent perfect score
            raise ValueError(
                f"evaluate({split!r}): the loader has no samples in that "
                "split (available: "
                f"{sorted(k for k, n in self.loader.class_lengths.items() if n)})"
            )
        use_conf = confusion and self.loss_function == "softmax"
        acc = self._acc_init()
        conf = None
        if use_conf:
            nc = int(np.prod(self.model.output_shape))
            conf = torch.zeros((nc, nc), dtype=torch.int32, device=self.device)
        for mb in self.loader.batches(split, shuffle=False):
            x = self._put(mb.data)
            y = x if self.target == "input" else self._put(self._batch_target(mb))
            mask = self._put(mb.mask)
            if use_conf:
                acc, conf = self._eval_conf_step(x, y, mask, acc, conf)
            else:
                acc = self.eval_step(x, y, mask, acc)
        m = _decode_metrics(acc.cpu().numpy(), self._metric_names)
        n = m.get("n_samples", 0.0)
        n_err = m.get("n_err", 0.0)
        result = {
            "n_samples": n,
            "n_err": n_err,
            "err_pct": 100.0 * n_err / max(n, 1.0),
            "loss": m.get("loss", 0.0),
        }
        if conf is not None:
            result["confusion"] = conf.cpu().numpy()
        return result

    def run(self) -> Decision:
        """Train until the Decision stops; returns it (history, best)."""
        if self.state is None:
            self.initialize()
        t0 = time.perf_counter()
        while True:
            verdict = self.run_epoch()
            parts = [
                f"{split} err={m['err_pct']:.2f}% loss={m['loss']:.4f}"
                if self.loss_function == "softmax"
                else f"{split} loss={m['loss']:.6f}"
                for split, m in verdict["summary"].items()
            ]
            logger.info(
                "%s epoch %d [%.1fs]: %s%s",
                self.name,
                self.decision.epoch - 1,
                time.perf_counter() - t0,
                "; ".join(parts),
                " *" if verdict["improved"] else "",
            )
            if verdict["stop"]:
                return self.decision
