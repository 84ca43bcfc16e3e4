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

Self-healing, as in the JAX package: each train step stacks its loss and
its gradients' per-tensor norms on the device and copies them,
``non_blocking``, into pinned host memory; two steps later
(``WATCH_LAG``) the host combines the norms into ``grad_norm`` and feeds
``(loss, grad_norm)`` to the :class:`StepAnomalyDetector`, so no step waits
on the card.  A :class:`RecoveryPolicy`
turns a non-finite verdict into a rollback to the epoch-start buffer (a
clone of the train state and the host state, taken when recovery or
emergency snapshots are on) or to the newest valid snapshot.
:meth:`Workflow.request_stop` stops at the next step boundary, writes an
emergency snapshot and raises :class:`TrainingPreempted`.
``epoch_sync="deferred"`` reads an epoch's accumulators (pinned copies) one
epoch later; an epoch whose verdict could stop training, or that is due for
an interval snapshot, is read before anything new is dispatched.

Left for later slices, refused by name: the whole-split scan dispatch and
the parallel placement policies.
"""

from __future__ import annotations

import copy
import logging
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from znicz_tpu_torch.core import device as device_lib, prng
from znicz_tpu_torch.loader.base import TRAIN, Loader
from znicz_tpu_torch.nn import evaluator, optimizer
from znicz_tpu_torch.nn.decision import Decision
from znicz_tpu_torch.nn.train_state import TrainState
from znicz_tpu_torch.observability import PhaseTimer, pipeline as pipeline_obs
from znicz_tpu_torch.observability.anomaly import StepAnomalyDetector
from znicz_tpu_torch.utils import faults
from znicz_tpu_torch.workflow.model import Model
from znicz_tpu_torch.workflow.recovery import (
    RecoveryPolicy,
    RollbackExhaustedError,
    TrainingPreempted,
)
from znicz_tpu_torch.workflow.snapshotter import (
    SnapshotCorruptError,
    Snapshotter,
    SnapshotWriteError,
    find_latest_valid,
    load_snapshot,
)

logger = logging.getLogger(__name__)

# train steps between a watch vector's dispatch and its read by the detector
WATCH_LAG = 2


class _RollbackSignal(Exception):
    """An anomaly verdict asked for a rollback: raised at the watch's feed
    point, caught by :meth:`Workflow.run_epoch`."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class _PreemptSignal(Exception):
    """A requested stop reached a step boundary mid-epoch."""


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
    """A snapshot's numpy leaves, or a retained buffer's tensors, as tensors
    on ``device`` (copies), in the same lists and dicts; ``grad`` marks them
    for autograd."""
    if isinstance(tree, dict):
        return {k: _on_device(v, device, grad) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_on_device(v, device, grad) for v in tree]
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to(device, copy=True)
    else:
        t = torch.tensor(np.asarray(tree), device=device)
    return t.requires_grad_(True) if grad and t.is_floating_point() else t


def _clone(tree):
    """Fresh copies of a train state's tensors, in the same lists and dicts
    (the in-place updates never reach them)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_clone(v) for v in tree]
    return tree.detach().clone()


def tensor_norms(tensors) -> list:
    """Each tensor's L2 norm in float32, by one fused multi-tensor norm; the
    watch combines them on the host into the global norm (the JAX package's
    ``_global_norm``)."""
    return torch._foreach_norm([t.detach().float() for t in tensors])


def _fetch_async(tensors) -> tuple:
    """``non_blocking`` copies of the card's ``tensors`` into fresh pinned
    host tensors, and an event recorded after them: ``(host tensors,
    event)``.  The blocks come from PyTorch's caching host allocator, which
    hands a block out again only after the copies that read it."""
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


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
    policy.  ``epoch_sync``: "sync" or "deferred" (the verdict of epoch N
    returned by the call that runs epoch N+1; :meth:`sync_epoch` flushes the
    last).  ``anomaly``: True for the default :class:`StepAnomalyDetector`,
    an instance to use as given, False or None for no watch (and no work).
    ``recovery``: a :class:`RecoveryPolicy` that acts on the detector's
    verdicts.  ``parallel`` and ``epoch_dispatch="scan"`` are refused,
    naming their ``ROADMAP.md`` item (``epoch_dispatch="step"`` is taken:
    the port dispatches step by step).
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
        ))
        self.anomaly: Optional[StepAnomalyDetector] = (
            StepAnomalyDetector() if anomaly is True else (anomaly or None)
        )
        if recovery is not None and self.anomaly is None:
            raise ValueError(
                "recovery=... consumes the step anomaly detector's verdicts; "
                "it cannot combine with anomaly=False"
            )
        self.recovery: Optional[RecoveryPolicy] = recovery
        self.epoch_sync = epoch_sync
        # deferred sync: the dispatched epoch's accumulators (pinned copies)
        # and, with a save_best snapshotter, a clone of its end state
        self._pending_accs = None
        self._retained = None
        # request_stop() sets the flag; the loop acts at the next step
        self._preempt_requested = False
        # sync mode with recovery or emergency snapshots: the epoch-start
        # clone of (train state, host state)
        self._emergency_capture = False
        self._epoch_start = None
        # the last train step's watch vector on its way to the host
        self._last_watch = None
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
        the device preprocessing runs here): the learning rule
        (:meth:`_learn`), then, with the anomaly watch on, the step's watch
        vector on its way to the host.  Returns
        ``acc`` with this step's metrics folded in (a fresh accumulator when
        ``acc`` is None)."""
        x, y = self._prep(x, y)
        m, norms = self._learn(x, y, mask, lr_scale)
        self.state.step += 1
        self._last_watch = None if norms is None else self._watch_vector(m["loss"], norms)
        return self._combine(self._acc_init() if acc is None else acc, m)

    def _learn(self, x, y, mask, lr_scale: float):
        """Forward, loss, autograd and the in-place update.  Returns the
        step's metrics and, with the anomaly watch on, the gradients'
        per-tensor norms (else None)."""
        st = self.state
        leaves = [w for layer in st.params for w in layer.values()]
        with torch.enable_grad():
            m = self._forward_metrics(st.params, x, y, mask, train=True)
            flat = torch.autograd.grad(m["loss"], leaves)
        norms = tensor_norms(flat) if self.anomaly is not None else None
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
        return m, norms

    def _watch_vector(self, loss, norms):
        """``[loss, norm_1, ..., norm_n]`` in float32 on its way to the host
        (one stack; on the card a ``non_blocking`` copy into pinned memory
        and an event after it, so reading it later waits for nothing but
        that copy).  Returns ``(host or CPU tensor, event or None)``."""
        vec = torch.stack([torch.as_tensor(loss).detach().float().reshape(()), *norms])
        if not vec.is_cuda:
            return vec, None
        (row,), event = _fetch_async([vec])
        return row, event

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
        try:
            for split, tensors in staged:
                if tensors[0].device.type != self.device.type:
                    tensors = [t.to(self.device, non_blocking=True) for t in tensors]
                # [-2] is the target, or the data itself for the autoencoder
                yield split, tensors[0], tensors[-2], tensors[-1]
        finally:
            # closing the prefetch generator joins its producer, so a
            # restore after an aborted epoch never races a reshuffle
            close = getattr(staged, "close", None)
            if close is not None:
                close()

    def _run_epoch_stepwise(self) -> Dict[str, torch.Tensor]:
        accs: Dict[str, torch.Tensor] = {}  # per-split device accumulators
        # the lagged watch: (step, vector, step wall), read WATCH_LAG train
        # steps after its dispatch
        watch_q: deque = deque()
        t_prev = time.perf_counter()
        batches = self._batches()
        try:
            for split, x, y, mask in batches:
                if self._preempt_requested:
                    # stop before dispatching another step
                    raise _PreemptSignal()
                with self.timer.phase(f"dispatch/{split}"):
                    acc = accs.get(split)
                    watch = None
                    if split == TRAIN:
                        lr_scale = (
                            self.lr_policy(1.0, self.state.step) if self.lr_policy else 1.0
                        )
                        if self.recovery is not None:
                            # the rollback backoff composes with the policy
                            lr_scale *= self.recovery.lr_scale
                        accs[split] = self.train_step(x, y, mask, lr_scale, acc)
                        watch = self._last_watch
                    else:
                        accs[split] = self.eval_step(x, y, mask, acc)
                # the consumer's step wall (prefetch wait + dispatch + host
                # bookkeeping): the denominator of the pipeline attribution
                now = time.perf_counter()
                step_wall = now - t_prev
                t_prev = now
                self._step_wall.observe(step_wall)
                if watch is not None:
                    watch_q.append((self.state.step - 1, watch, step_wall))
                    if len(watch_q) > WATCH_LAG:
                        self._check_recovery(self._feed_watch(*watch_q.popleft()))
            while watch_q:
                self._check_recovery(self._feed_watch(*watch_q.popleft()))
        finally:
            batches.close()
        return accs

    def _feed_watch(self, step: int, watch, step_seconds: Optional[float] = None) -> list:
        """Hand one lagged watch vector to the detector as ``(loss,
        grad_norm)``, the norm the global one of its per-tensor norms;
        returns the verdicts it raised.  The vector's copy was issued
        ``WATCH_LAG`` steps ago, so its event has as a rule completed; a
        failure to read it is logged, never fatal (only a verdict acts,
        through the policy)."""
        if self.anomaly is None:
            return []
        row, event = watch
        try:
            if event is not None and not event.query():
                event.synchronize()
            vec = row.numpy()
            loss = float(vec[0])
            # a float32 dot, as the JAX package's _global_norm sums in
            # float32: a total past float32's range reads inf in both
            grad_norm = float(np.sqrt(np.dot(vec[1:], vec[1:])))
        except Exception:
            logger.exception("anomaly watch feed failed")
            return []
        if faults.fire("train.step_nan"):
            # the detector sees a NaN loss; the state is not poisoned
            loss = float("nan")
        try:
            return self.anomaly.observe_step(
                int(step), loss=loss, grad_norm=grad_norm, step_seconds=step_seconds
            )
        except Exception:
            logger.exception("anomaly watch feed failed")
            return []

    def _check_recovery(self, anomalies: list) -> None:
        """Route fresh verdicts through the recovery policy; a rollback
        aborts the epoch (:class:`_RollbackSignal`, caught in
        :meth:`run_epoch`)."""
        if not anomalies or self.recovery is None:
            return
        reason = self.recovery.should_rollback(anomalies)
        if reason is not None:
            raise _RollbackSignal(reason)

    def _start_fetch(self, accs: Dict[str, torch.Tensor]):
        """Deferred sync: the accumulators' ``non_blocking`` copies into
        pinned host memory and an event after them, read one epoch later.
        On the CPU the accumulators are already on the host."""
        if self.device.type != "cuda":
            return accs, None
        host, event = _fetch_async(list(accs.values()))
        return dict(zip(accs, host)), event

    def _finish_epoch(self, accs: Dict[str, torch.Tensor], retained=None,
                      ready=None) -> Dict[str, Any]:
        """Read the epoch's accumulators (after ``ready``, the event of their
        pinned copies), close the decision's epoch and save by the
        snapshotter's policy: from ``retained``, the epoch's retained end
        state, when ``self.state`` has moved on (deferred sync)."""
        with self.timer.phase("metrics_sync"):
            if ready is not None:
                ready.synchronize()
            for split, acc in accs.items():  # one small fetch per split
                self.decision.add_minibatch(
                    split, _decode_metrics(acc.cpu().numpy(), self._metric_names)
                )
        verdict = self.decision.on_epoch_end()
        if self.snapshotter is not None:
            if retained is not None:
                snap_state, extra = retained
                # host_state()'s key order: files equal to sync mode's
                snap_host = {"decision": self.decision.state_dict(),
                             "loader": extra["loader"], "prng": extra["prng"]}
            else:
                snap_state, snap_host = self.snapshot_state(), self.host_state()
            self.snapshotter.maybe_save(
                snap_state,
                snap_host,
                epoch=self.decision.epoch - 1,
                improved=verdict["improved"],
            )
        return verdict

    def run_epoch(self) -> Optional[Dict[str, Any]]:
        """One full epoch over all splits; returns the Decision verdict.

        ``epoch_sync="deferred"``: the verdict lags one epoch (None on the
        first call); an epoch whose verdict could stop training is flushed
        before anything new is dispatched, so training stops where sync mode
        does.  A rollback aborts the epoch, restores the last good state and
        returns None; a requested stop writes the emergency snapshot and
        raises :class:`TrainingPreempted`."""
        if self.state is None:
            self.initialize()
        # chaos point: a crash at an epoch boundary (arm with after=k)
        faults.fire("train.crash")
        if self._preempt_requested:
            self._graceful_exit(mid_epoch=False)
        try:
            return self._run_epoch_inner()
        except _PreemptSignal:
            self._graceful_exit(mid_epoch=True)
        except _RollbackSignal as sig:
            self._execute_rollback(sig.reason)
            return None

    def _run_epoch_inner(self) -> Optional[Dict[str, Any]]:
        deferred = self.epoch_sync == "deferred"
        flushed = None
        # the pending epoch resolves before the next dispatch when its
        # verdict could stop training or it is due for an interval
        # snapshot (self.state is still that epoch's now)
        interval_due = bool(
            self.snapshotter is not None
            and self.snapshotter.interval
            and (self.decision.epoch + 1) % self.snapshotter.interval == 0
        )
        if (deferred and self._pending_accs is not None
                and (self.decision.can_stop_next_epoch() or interval_due)):
            (accs, ready), self._pending_accs = self._pending_accs, None
            self._retained = None  # self.state is the pending epoch's
            flushed = self._finish_epoch(accs, ready=ready)
            if flushed["stop"]:
                return flushed  # nothing new dispatched
        if (self.recovery is not None or self._emergency_capture) and not deferred:
            # the one point where (state, loader, streams, decision) agree:
            # the rollback's first source and a mid-epoch stop's snapshot
            self._epoch_start = self._retain_epoch_start()
        accs = self._run_epoch_stepwise()
        if not deferred:
            return self._finish_epoch(accs)
        prev, self._pending_accs = self._pending_accs, self._start_fetch(accs)
        prev_retained, self._retained = self._retained, (
            self._retain_state()
            if self.snapshotter is not None and self.snapshotter.save_best
            else None
        )
        if prev is not None:
            if (self.snapshotter is not None and self.snapshotter.save_best
                    and prev_retained is None):
                # self.state is one epoch ahead of the pending epoch: saving
                # it as that epoch's "best" would be silently wrong
                raise ValueError(
                    "snapshotter with save_best was assigned after an epoch "
                    "dispatched under epoch_sync='deferred'; assign it before "
                    "training starts (the retained state is captured at dispatch)"
                )
            # the flush above guarantees this verdict cannot be a stop
            return self._finish_epoch(prev[0], retained=prev_retained, ready=prev[1])
        return flushed

    def sync_epoch(self) -> Optional[Dict[str, Any]]:
        """Flush a deferred epoch's metrics: its verdict, or None when
        nothing is pending.  Call after a ``run_epoch`` loop in deferred
        mode to observe the last epoch."""
        if self._pending_accs is None:
            return None
        (accs, ready), self._pending_accs = self._pending_accs, None
        self._retained = None  # nothing dispatched since: self.state is it
        return self._finish_epoch(accs, ready=ready)

    def _clone_state(self) -> tuple:
        """A copy of :meth:`snapshot_state` whose tensors the in-place
        updates never reach (``clone()``), the generator's bytes included."""
        params, velocity, step, key = self.snapshot_state()
        return _clone(params), _clone(velocity), step, key

    def _retain_state(self):
        """Deferred sync with ``save_best``: the dispatched epoch's end
        state, held until its verdict; the decision is merged in when the
        verdict resolves (:meth:`_finish_epoch`)."""
        return self._clone_state(), {
            "loader": self.loader.state_dict(),
            "prng": prng.state_dict(),
        }

    # -- self-healing ----------------------------------------------------------
    def request_stop(self) -> None:
        """Stop at the next step boundary: the in-flight step drains, an
        emergency snapshot is written (with a snapshotter) and
        :class:`TrainingPreempted` raises out of ``run``/``run_epoch``.
        Safe to call from a signal handler (one bool store)."""
        self._preempt_requested = True

    def enable_emergency_snapshots(self) -> None:
        """Retain each sync-mode epoch's start (a clone of the train state
        on the device and of the host state), so a mid-epoch stop writes a
        snapshot that resumes the aborted epoch exactly; without it, a
        mid-epoch stop saves the current, mid-epoch params."""
        self._emergency_capture = True

    def _retain_epoch_start(self):
        """Fresh copies of the epoch-start restore point: the train state
        (``clone()``) and the decision, loader and stream state."""
        return self._clone_state(), copy.deepcopy(self.host_state())

    def _execute_rollback(self, reason: str) -> None:
        """Roll back to the last good restore point: the epoch-start buffer
        when one was captured (never older than a snapshot file), else the
        newest valid snapshot.  Past the policy's budget, or with nothing to
        restore, :class:`RollbackExhaustedError` raises and the give-up
        gauge reads 1.  The epoch's prefetch producer has been joined (the
        epoch loop closed its iterator)."""
        pol = self.recovery
        step = self.state.step
        # the aborted epoch's bookkeeping dies with it
        self._pending_accs = None
        self._retained = None
        if not pol.budget_left():
            pol.note_give_up(reason, step=step, why="rollback budget spent")
            raise RollbackExhaustedError(
                f"anomaly {reason!r} at step {step}: rollback budget "
                f"({pol.max_rollbacks}) spent — giving up"
            )
        state = host = source = None
        if self._epoch_start is not None:
            state, host = self._epoch_start
            source = "epoch-start buffer"
        if source is None and self.snapshotter is not None:
            path = find_latest_valid(self.snapshotter.directory, prefix=self.snapshotter.prefix)
            if path is not None:
                try:
                    state, host = load_snapshot(path)
                    source = path
                except (SnapshotCorruptError, ValueError):
                    logger.exception("rollback snapshot %s unreadable", path)
        if source is None:
            pol.note_give_up(reason, step=step,
                             why="no valid snapshot or retained epoch-start state")
            raise RollbackExhaustedError(
                f"anomaly {reason!r} at step {step}: no valid snapshot or "
                "retained epoch-start state to roll back to"
            )
        # a copy: the buffer stays intact for a second rollback
        self._restore_from(state, copy.deepcopy(host))
        if pol.perturb:
            # a different permutation for the replayed epoch
            prng.get(self.loader.rand_name).permutation(
                max(self.loader.class_lengths.get(TRAIN, 1), 1)
            )
        pol.note_rollback(reason, step=step, source=str(source))
        logger.info("%s rolled back to %s after %s at step %d (rollback %d/%d, "
                    "lr_scale %.4g)", self.name, source, reason, step,
                    pol.rollbacks_used, pol.max_rollbacks, pol.lr_scale)

    def _graceful_exit(self, *, mid_epoch: bool) -> None:
        """Finish a requested stop: write the emergency snapshot (the
        epoch-start buffer mid-epoch, so the resume is exact; the current
        state between epochs) and raise :class:`TrainingPreempted`."""
        path = None
        if self.snapshotter is not None:
            if mid_epoch and self._epoch_start is not None:
                state, host = self._epoch_start
            else:
                # deferred: flush the pending epoch first, from its
                # retained state (mid-epoch, self.state is already the next
                # epoch's partial state)
                retained, self._retained = self._retained, None
                if self._pending_accs is not None:
                    (accs, ready), self._pending_accs = self._pending_accs, None
                    try:
                        self._finish_epoch(accs, retained=retained, ready=ready)
                    except Exception:
                        logger.exception("pending-epoch flush failed during graceful stop")
                if mid_epoch and retained is not None:
                    # the flushed epoch's end state and the current decision:
                    # the aborted epoch's start
                    r_state, r_host = retained
                    state, host = r_state, {"decision": self.decision.state_dict(),
                                            "loader": r_host["loader"],
                                            "prng": r_host["prng"]}
                else:
                    state, host = self.snapshot_state(), self.host_state()
            try:
                path = self.snapshotter.save(state, host, tag="emergency")
                logger.info("%s graceful stop: emergency snapshot %s", self.name, path)
            except SnapshotWriteError:
                logger.exception("emergency snapshot write failed")
        raise TrainingPreempted(
            "training stopped on request; resume from the emergency snapshot",
            snapshot_path=path,
        )

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
            if verdict is None:  # deferred sync's first epoch, or a rollback
                continue
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
