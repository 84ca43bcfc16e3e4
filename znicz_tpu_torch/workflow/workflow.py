"""The Workflow: a host loop around the train and eval steps (port of
``znicz_tpu/workflow/workflow.py``).

    loader -> [forward + loss + autograd + update + metrics] -> decision

Each step folds its metrics into one small per-split accumulator tensor on
the device, so an epoch costs one device->host fetch per split, as in the
JAX package.  The step runs eagerly; the learning rate of each step comes
from the lr policy on the host.

The host loop around the step is the JAX package's: a prefetch thread
(``prefetch_batches``, default 2) fills the next batches and stages their
host-to-device copies while the step runs (on the card the producer copies each
batch into pinned memory and the consumer issues its ``non_blocking``
copies on the step's stream); every
dispatch is a ``train/dispatch/<split>`` phase and every step's consumer
wall an observation of ``znicz_train_step_wall_seconds``, so the JAX
package's ``PipelineAttribution`` reads a port run; a ``Snapshotter``
writes the train and host state at epoch ends and ``initialize(snapshot=)``
resumes from it exactly.

Left for later slices, refused by name: the whole-split scan dispatch,
deferred epoch sync, the step anomaly watch's settings, rollback recovery
and the parallel placement policies.
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
from znicz_tpu_torch.observability import PhaseTimer, pipeline as pipeline_obs
from znicz_tpu_torch.utils import faults
from znicz_tpu_torch.workflow.model import Model
from znicz_tpu_torch.workflow.snapshotter import Snapshotter, load_snapshot

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


def _on_device(tree, device, grad: bool):
    """A snapshot's numpy leaves as float tensors on ``device`` (copies),
    in the same lists and dicts; ``grad`` marks them for autograd."""
    if isinstance(tree, dict):
        return {k: _on_device(v, device, grad) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_on_device(v, device, grad) for v in tree]
    t = torch.tensor(np.asarray(tree), device=device)
    return t.requires_grad_(True) if grad and t.is_floating_point() else t


def _pinned(a: np.ndarray) -> torch.Tensor:
    """A copy of ``a`` in page-locked memory (one numpy copy, no torch op).
    The block comes from PyTorch's caching host allocator, which hands it
    out again only after the copies that read it (their recorded events)
    have completed, so a batch's copy to the card never reads a buffer the
    next batch refills."""
    t = torch.empty(a.shape, dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype,
                    pin_memory=True)
    np.copyto(t.numpy(), a)
    return t


class Workflow:
    """Owns loader + model + decision + snapshotter; runs training on
    ``device``.

    ``loss_function``: "softmax" (cross-entropy on integer labels) or "mse"
    (against ``target`` = "targets" from the loader, or "input" for
    autoencoders).  ``device``: None means the card (raises without one).
    ``metric_names``: the keys a subclass's steps report (default: the
    loss function's); ``max_*`` combine by maximum, ``n_samples`` and
    ``n_err`` add, the rest are sample-weighted means.
    ``prefetch_batches``: the prefetch thread's queue depth (0: fill, copy
    and step in series).  ``snapshotter``: written at every epoch end by its
    policy.  The JAX package's other keywords are taken at their defaults
    (``epoch_dispatch="step"`` too: the port dispatches step by step) and
    refused otherwise, naming their ``ROADMAP.md`` item.
    """

    def __init__(
        self,
        loader: Loader,
        model: Model,
        *,
        loss_function: str = "softmax",
        target: str = "labels",
        decision: Optional[Decision] = None,
        snapshotter: Optional[Snapshotter] = None,
        lr_policy: Optional[Callable[[float, int], float]] = None,
        parallel=None,
        prefetch_batches: int = 2,
        epoch_dispatch: str = "auto",
        epoch_sync: str = "sync",
        anomaly=True,
        recovery=None,
        device=None,
        metric_names: Optional[Sequence[str]] = None,
        name: str = "workflow",
    ):
        if epoch_dispatch not in ("auto", "scan", "step"):
            raise ValueError(
                f"epoch_dispatch={epoch_dispatch!r}: want 'auto', 'scan' or 'step'"
            )
        if epoch_sync not in ("sync", "deferred"):
            raise ValueError(f"epoch_sync={epoch_sync!r}: want 'sync' or 'deferred'")
        refuse_unported((
            (parallel is not None, "a parallel= placement policy", "A6, parallel/data_parallel.py"),
            (epoch_dispatch == "scan", "scan dispatch (epoch_dispatch='scan')",
             "A4, workflow/workflow.py"),
            (epoch_sync != "sync", "deferred epoch sync (epoch_sync != 'sync')",
             "A4, workflow/workflow.py"),
            (anomaly is not True, "the anomaly watch's settings (anomaly != True)",
             "A4, workflow/workflow.py"),
            (recovery is not None, "rollback recovery", "A4, workflow/recovery.py"),
        ))
        self.loader = loader
        self.model = model
        self.loss_function = loss_function
        self.target = target
        self.decision = decision or Decision(
            metric="n_err" if loss_function == "softmax" else "loss"
        )
        self.snapshotter = snapshotter
        self.lr_policy = lr_policy
        self.prefetch_batches = prefetch_batches  # 0 disables the loader thread
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
        # every phase is a tracer span and an observation of the
        # registry's znicz_train_phase_seconds histogram
        self.timer = PhaseTimer(
            "znicz_train_phase_seconds",
            help="training host phase seconds (dispatch, stack, sync)",
            span_prefix="train/",
        )
        # the h2d stage (bytes and seconds) of the batch path, and the
        # consumer-side step wall it is read against
        self._h2d_probe = pipeline_obs.H2DProbe()
        self._step_wall = pipeline_obs.step_wall_seconds()

    # ------------------------------------------------------------------
    def initialize(
        self, *, seed: Optional[int] = None, snapshot: Optional[str] = None, device=None
    ) -> None:
        """Create the train state on ``device`` (default: the workflow's)
        from a copy of the model's initial params, which the in-place
        updates leave untouched, or resume it from ``snapshot`` (a file of
        this port or of the JAX package): the train state, the decision,
        the loader's order and epoch, and every named generator's stream.
        ``seed`` reseeds every named generator first (``prng.seed_all``)."""
        if seed is not None:
            prng.seed_all(seed)
        if device is not None:
            self.device = device_lib.resolve(device)
        if snapshot:
            self._restore_from(*load_snapshot(snapshot))
            logger.info("%s resumed from %s at epoch %d", self.name, snapshot,
                        self.decision.epoch)
        else:
            self.state = self._create_initial_state()
        self._add_mask = torch.as_tensor(self._additive, device=self.device)

    def host_state(self) -> Dict[str, Any]:
        """The host half of a snapshot, in the JAX package's keys."""
        return {
            "decision": self.decision.state_dict(),
            "loader": self.loader.state_dict(),
            "prng": prng.state_dict(),
        }

    def snapshot_state(self) -> tuple:
        """The train half of a snapshot, ``(params, velocity, step,
        key)`` as the JAX package orders its ``TrainState``; ``key`` is the
        train state's generator state (uint8)."""
        st = self.state
        return (st.params, st.velocity, np.asarray(st.step, np.int32),
                st.generator.get_state().numpy().copy())

    def _restore_from(self, state, host: Optional[Dict[str, Any]]) -> None:
        """The exact-resume contract: the host state first (the decision,
        the loader, every named stream), then the train state on the
        workflow's device.  A JAX snapshot's threefry key stays data: the
        train state's generator restarts from its stream's seed."""
        params, velocity, step, key = state
        host = host or {}
        if "decision" in host:
            self.decision.load_state_dict(host["decision"])
        if "loader" in host:
            self.loader.load_state_dict(host["loader"])
        if "prng" in host:
            prng.load_state_dict(host["prng"])
        gen = prng.get("workflow").generator(self.device)
        if isinstance(key, np.ndarray) and key.dtype == np.uint8:
            gen.set_state(torch.from_numpy(key.copy()))
        trainable = isinstance(params, list)  # the autograd workflows' layers
        self.state = TrainState(
            params=_on_device(params, self.device, trainable),
            velocity=_on_device(velocity, self.device, False),
            step=int(np.asarray(step)),
            generator=gen,
        )

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

    def _stage(self, item):
        """One batch's arrays staged for the step, inside the H2D probe:
        on the producer thread when prefetching.  There, on the card, each
        array is copied into pinned memory (:func:`_pinned`) and the
        consumer issues the copies to the card (:meth:`_batches`); in series
        (``prefetch_batches=0``) or on the CPU they are tensors on the
        workflow's device here.  Returns ``(split, tensors)``: the data, the
        target unless the autoencoder's target reuses the data, the mask."""
        split, mb = item
        arrays = [mb.data]
        if self.target != "input":
            arrays.append(self._batch_target(mb))
        arrays.append(mb.mask)
        with self._h2d_probe.measure(sum(a.nbytes for a in arrays)):
            if self.prefetch_batches and self.device.type == "cuda":
                return split, [_pinned(a) for a in arrays]
            return split, [self._put(a) for a in arrays]

    def _batches(self):
        """The epoch's ``(split, x, y, mask)`` on the workflow's device:
        through the prefetch thread unless ``prefetch_batches`` is 0.  The
        pinned arrays go to the card with ``non_blocking`` on the step's own
        stream, so the step's kernels are ordered after the copies and no
        thread waits for them."""
        epoch_iter = self.loader.epoch()
        if not self.prefetch_batches:
            staged = map(self._stage, epoch_iter)
        else:
            from znicz_tpu_torch.loader.prefetch import prefetch

            # transform_stage=None: the H2D probe observes the h2d stage
            staged = prefetch(epoch_iter, self.prefetch_batches, transform=self._stage,
                              transform_stage=None)
        for split, tensors in staged:
            if tensors[0].device.type != self.device.type:
                tensors = [t.to(self.device, non_blocking=True) for t in tensors]
            # [-2] is the target, or the data itself for the autoencoder
            yield split, tensors[0], tensors[-2], tensors[-1]

    def _run_epoch_stepwise(self) -> Dict[str, torch.Tensor]:
        accs: Dict[str, torch.Tensor] = {}  # per-split device accumulators
        t_prev = time.perf_counter()
        for split, x, y, mask in self._batches():
            with self.timer.phase(f"dispatch/{split}"):
                acc = accs.get(split)
                if split == TRAIN:
                    lr_scale = (
                        self.lr_policy(1.0, self.state.step) if self.lr_policy else 1.0
                    )
                    accs[split] = self.train_step(x, y, mask, lr_scale, acc)
                else:
                    accs[split] = self.eval_step(x, y, mask, acc)
            # the consumer's step wall (prefetch wait + dispatch + host
            # bookkeeping): the denominator of the pipeline attribution
            now = time.perf_counter()
            self._step_wall.observe(now - t_prev)
            t_prev = now
        return accs

    def _finish_epoch(self, accs: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        with self.timer.phase("metrics_sync"):
            for split, acc in accs.items():  # one small fetch per split
                self.decision.add_minibatch(
                    split, _decode_metrics(acc.cpu().numpy(), self._metric_names)
                )
        verdict = self.decision.on_epoch_end()
        if self.snapshotter is not None:
            # at the epoch boundary: the prefetch producer has drained
            self.snapshotter.maybe_save(
                self.snapshot_state(),
                self.host_state(),
                epoch=self.decision.epoch - 1,
                improved=verdict["improved"],
            )
        return verdict

    def run_epoch(self) -> Dict[str, Any]:
        """One full epoch over all splits; returns the Decision verdict."""
        if self.state is None:
            self.initialize()
        # chaos point: a crash at an epoch boundary (arm with after=k)
        faults.fire("train.crash")
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
