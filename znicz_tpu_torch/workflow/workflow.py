"""The Workflow: a host loop around the train and eval steps (port of
``znicz_tpu/workflow/workflow.py``).

    loader -> [forward + loss + autograd + update + metrics] -> decision

Each step folds its metrics into one small per-split accumulator tensor on
the device, so an epoch costs one device->host fetch per split, as in the
JAX package.  The per-step values the host decides (the lr policy's scale,
the SOM's lr and ``2 sigma^2``, the RBM's chain seed: :meth:`Workflow.
_step_scalars`) reach the step as one float32 row on the device, never as
host numbers, so one step code serves both dispatches below.

The loader's device context (the device-resident pool) is copied to the
device once, at ``initialize``, and every family's step hands it to the
loader's ``device_preproc``, so bare pool indices never reach a model.

Two dispatches (``epoch_dispatch``), as in the JAX package:

- **step**: one dispatch a minibatch, through the host loop below;
- **scan** (``"auto"`` takes it for an ``epoch_scan_friendly`` loader with a
  device context): each split's stacked payloads, targets, masks and step
  rows go to the device in one copy, and one split function runs the
  split's steps with no host read in between: each step reads its row
  through a step counter held on the device, folds its metrics into a
  static accumulator and writes its watch row into a ``[n_steps, 1 +
  n_norms]`` buffer, which goes to pinned memory by one ``non_blocking``
  copy after the split and is fed to the detector at the epoch's sync.  On
  the CPU the function runs eagerly.  On the card its first step runs
  eagerly (the warm-up that builds the kernels and picks the libraries'
  algorithms), the step is then captured once into a ``torch.cuda.
  CUDAGraph`` for each split and shape (the step count included: a skipped
  batch makes another key, as a jit retraces) and replayed back to back.
  A capture that fails raises; nothing falls back to the step dispatch.
  A restore (``initialize``, a rollback) drops the captured graphs, whose
  pointers it invalidates.  A replay goes through no kernel wrapper, so
  the wrappers' launch counts hold the warm-up's and the capture's calls
  only; what the replays launch shows in a device trace.

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

Data parallelism (``parallel=DataParallel(mesh)``, ``parallel/``): one
process a device, each rank serving its contiguous ``1/R`` of every global
minibatch (the loader's process shard).  A train step all-reduces the
count of valid rows first, scales the rank's loss by its share of them
(so the summed gradient is the global batch's: the loss's denominator is
the global count) and then sums the gradients, flattened into one buffer
a dtype, with one all-reduce; the watch's loss and the gradient norms are
the reduced ones, so every rank's detector decides alike and a rollback
happens on all ranks.  The epoch's accumulators are reduced once, at the
epoch's end (counts and sample-weighted sums add, ``max_*`` take the
maximum).  Only the coordinator writes snapshots; every rank gathers
them.  Under NCCL the scan dispatch's captured step holds the
collectives; a gloo group on the card stages them through the host,
which no CUDA graph can capture, so there ``"scan"`` raises and ``"auto"``
takes the step dispatch.

Tensor parallelism (a policy whose mesh has a ``model`` axis above 1):
``initialize`` gives a ``tp=True`` policy without rules the workflow's
:meth:`Workflow._default_param_rules` (on a copy; the caller's is kept),
and the train state holds each model-sharded leaf as this rank's block.
Every rank of a data row serves the row's block of each batch; the
collectives above reduce over the rank's data column only, the forward's
over its model row (``workflow/model.py``), and a sharded leaf's gradient
norm is summed over the model row.  :meth:`Workflow.snapshot_state`
gathers the whole tensors (every rank takes part; the coordinator
writes) and a restore slices them again.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from znicz_tpu_torch.core import device as device_lib, prng
from znicz_tpu_torch.core.logger import Logger
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
# the metrics key under which a data-parallel step hands the watch its
# global loss (never reaches the accumulator)
WATCH_LOSS = "_watch_loss"


class _RollbackSignal(Exception):
    """An anomaly verdict asked for a rollback: raised at the watch's feed
    point, caught by :meth:`Workflow.run_epoch`."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class _PreemptSignal(Exception):
    """A requested stop reached a step boundary mid-epoch."""


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


def param_paths(tree, prefix: str = ""):
    """``(keystr path, leaf)`` of a train state's params in their own order
    (a list of layer dicts: layer by layer, each in insertion order; the
    pipelined LM's ``{"embed", "stages", "head"}`` likewise)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from param_paths(v, f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from param_paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _refill(tree, leaves):
    """``tree``'s lists and dicts holding the next of ``leaves`` (an
    iterator) at each leaf, in :func:`param_paths` order."""
    if isinstance(tree, dict):
        return {k: _refill(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_refill(v, leaves) for v in tree]
    return next(leaves)


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


def _torch_dtype(dt) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dt)).dtype


def int_bits(value: int) -> np.float32:
    """The low 32 bits of ``value`` as the float32 whose bits they are: how
    an integer rides in a step's float32 row (read back by
    ``row[i:i+1].view(torch.int32)``, never by arithmetic)."""
    return np.array([value & 0xFFFFFFFF], np.uint32).view(np.float32)[0]


def _pinned(a: np.ndarray) -> torch.Tensor:
    """A copy of ``a`` in page-locked memory (one numpy copy, no torch op).
    The block comes from PyTorch's caching host allocator, which hands it
    out again only after the copies that read it (their recorded events)
    have completed, so a batch's copy to the card never reads a buffer the
    next batch refills."""
    t = torch.empty(a.shape, dtype=_torch_dtype(a.dtype), pin_memory=True)
    np.copyto(t.numpy(), a)
    return t


class _SplitRun:
    """One split function's static state on the device: the stacked inputs
    (views of one byte buffer, filled by one copy a dispatch), the step
    counter, the accumulator, the watch rows and, on the card, the captured
    step."""

    ALIGN = 16  # bytes: every stacked array starts on a 16-byte boundary

    def __init__(self, layout, nbytes: int, acc: torch.Tensor, n_watch: int, device):
        self.layout = layout  # [(name, offset, shape, numpy dtype)]
        self.buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
        self.rows = {
            name: self.buf[off:off + int(np.prod(shape)) * np.dtype(dt).itemsize]
            .view(_torch_dtype(dt)).view(shape)
            for name, off, shape, dt in layout
        }
        n = layout[0][2][0]
        self.counter = torch.zeros((1,), dtype=torch.int64, device=device)
        self.acc = acc
        self.watch = (torch.empty((n, n_watch), dtype=torch.float32, device=device)
                      if n_watch else None)
        self.graph = None

    @classmethod
    def pack(cls, arrays: Dict[str, np.ndarray]):
        """``(layout, host bytes)``: the arrays laid out in one byte buffer."""
        layout, off = [], 0
        for name, a in arrays.items():
            off = -(-off // cls.ALIGN) * cls.ALIGN
            layout.append((name, off, a.shape, a.dtype))
            off += a.nbytes
        host = np.empty(off, np.uint8)
        for (name, o, _, _), a in zip(layout, arrays.values()):
            host[o:o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        return tuple(layout), host

    def row(self, name: str) -> torch.Tensor:
        """The current step's row of a stacked input, read through the
        device counter."""
        return self.rows[name].index_select(0, self.counter)[0]


class Workflow(Logger):
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
    verdicts.  ``epoch_dispatch``: "step", "scan" (whole splits through
    the split function; needs an ``epoch_scan_friendly`` loader) or "auto"
    (scan for such a loader with a device context).  ``parallel``: a
    :class:`~znicz_tpu_torch.parallel.DataParallel` placement policy, or
    None (it may also be assigned before ``initialize``).  ``services``:
    per-epoch observers (plotters, status, image saver), each called as
    ``on_epoch(workflow, verdict)`` on the coordinator after the
    snapshotter; one that raises is logged and training goes on.
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
        self.parallel = parallel  # DataParallel placement policy, or None
        self.epoch_dispatch = epoch_dispatch
        # the loader's device context on the workflow's device (initialize)
        self._ctx = None
        # the split functions' static state and graphs, by split and shape
        self._splits: Dict[tuple, _SplitRun] = {}
        # scanned train splits' watch rows on their way to the host:
        # (first step, pinned rows, event), fed at the epoch's sync
        self._pending_watch: list = []
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
        self.services = []  # per-epoch observers: plotters, status, image saver
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
        if self.parallel is not None:
            self._setup_parallel()
        if snapshot:
            # placed (and sharded) by _restore_from
            self._restore_from(*load_snapshot(snapshot))
            logger.info("%s resumed from %s at epoch %d", self.name, snapshot,
                        self.decision.epoch)
        else:
            self.state = self._create_initial_state()
            if self.parallel is not None:
                self.state = self.parallel.shard_state(self.state)
        self._add_mask = torch.as_tensor(self._additive, device=self.device)
        self._acc_start = torch.as_tensor(
            np.where(self._additive, 0.0, -np.inf).astype(np.float32), device=self.device)
        # multi-process: every process runs this same loop; the loader
        # serves per-process sample shards, and snapshots are written on
        # exactly one process (the reference's master-does-bookkeeping role)
        from znicz_tpu_torch.parallel import multihost

        self._coordinator = multihost.is_coordinator()
        if multihost.process_count() > 1 and not self._whole_batch_ranks():
            if self.parallel is None:
                raise ValueError(
                    "multi-host training needs a DataParallel placement "
                    "policy (parallel=...) so batches span the global mesh"
                )
            # every rank of a data row serves the row's block of each
            # global minibatch (its model peers serve the same rows)
            self.loader.set_process_shard(self.parallel.index, self.parallel.n_data)
        if self.snapshotter is not None:
            self.snapshotter.writer = self._coordinator
        # data-axis pool sharding: each rank's device holds 1/D of the rows
        if self.loader.wants_data_shards:
            if self.parallel is None:
                raise ValueError(
                    "this loader shards its device pool over the data "
                    "axis; pass parallel=DataParallel(mesh)"
                )
            self.loader.set_data_shards(self.parallel.n_data)
        # one copy of the loader's device context (the device-resident pool)
        self._ctx = self.loader.place_device_context(self.parallel, self.device)
        self._splits.clear()

    def _whole_batch_ranks(self) -> bool:
        """Whether the ranks of a multi-process job each take the whole
        batch without a placement policy (a mesh of the workflow's own, as
        the LM's sequence-parallel ring over ``mesh=``)."""
        return False

    def _default_param_rules(self):
        """Template hook: model-aware tensor-parallel placement rules used
        when the placement policy has ``tp=True`` but no explicit
        ``param_rules`` (None keeps DataParallel's size heuristic)."""
        return None

    def _setup_parallel(self) -> None:
        """Check the placement policy and, under ``tp=True`` with no
        ``param_rules``, replace it with a copy carrying
        :meth:`_default_param_rules` (the caller's policy may be shared,
        so it is never changed)."""
        self._check_parallel()
        dp = self.parallel
        rules = self._default_param_rules() if dp.tp and dp.param_rules is None else None
        if rules is not None:
            from znicz_tpu_torch.parallel import DataParallel

            self.parallel = DataParallel(dp.mesh, tp=True, tp_min_features=dp.tp_min_features,
                                         param_rules=rules)

    def _check_parallel(self) -> None:
        """The placement policy fits this workflow: it places on the
        workflow's device type (subclasses refuse what they cannot run
        under data parallelism)."""
        if self.parallel.device.type != self.device.type:
            raise ValueError(
                f"parallel= places on {self.parallel.device} but the workflow runs on "
                f"{self.device}: build the mesh on the workflow's device"
            )

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
        train state's generator state (uint8).  Model-sharded leaves are
        gathered whole (a collective: every rank calls this alike)."""
        st = self.state
        params, velocity = st.params, st.velocity
        if self.parallel is not None:
            # whole tensors in the JAX package's layout (every rank takes
            # part in the gather; the coordinator writes)
            params = self.parallel.gather_state(params)
            velocity = self.parallel.gather_state(velocity)
        return (params, velocity, np.asarray(st.step, np.int32),
                st.generator.get_state().numpy().copy())

    def _restore_from(self, state, host: Optional[Dict[str, Any]]) -> None:
        """The exact-resume contract: the host state first (the decision,
        the loader, every named stream), then the train state on the
        workflow's device (whole tensors, each rank then keeping its blocks
        of the model-sharded ones).  A JAX snapshot's threefry key stays
        data: the train state's generator restarts from its stream's
        seed."""
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
        trainable = self._trainable(params)
        # the captured graphs hold the pointers of the state replaced here
        self._splits.clear()
        self.state = TrainState(
            params=_on_device(params, self.device, trainable),
            velocity=_on_device(velocity, self.device, False),
            step=int(np.asarray(step)),
            generator=gen,
        )
        if self.parallel is not None:
            self.state = self.parallel.shard_state(self.state)

    def _trainable(self, params) -> bool:
        """Whether a restored state's params are autograd leaves (the
        autograd workflows' list of layers)."""
        return isinstance(params, list)

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
        return self._acc_start.clone()

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
        """The loader's device preprocessing with its device context, for
        every family's steps; an autoencoder's target is the preprocessed
        input."""
        if self._pre is None:
            return x, y
        x = self._pre(x, self._ctx)
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
        return self._metrics(self._apply(params, x, train=train, generator=gen), y, mask)

    def _apply(self, params, x, *, train: bool, generator=None):
        """The model's forward, over this rank's blocks under tensor
        parallelism."""
        return self.model.apply(params, x, train=train, generator=generator,
                                placement=self._placement(params))

    def _placement(self, params):
        """``(model group, per-layer dims)`` of the sharded params, or None
        when nothing is sharded."""
        dp = self.parallel
        if dp is None or not dp.sharded:
            return None
        return dp.model_group, [{k: dp.sharded.get(f"[{i}][{k!r}]") for k in layer}
                                for i, layer in enumerate(params)]

    def _hyper(self):
        """The update rule's knobs, one HyperParams per top-level entry of
        the params (here a layer)."""
        return self.model.hyper

    def _lr_scale(self, step: int) -> float:
        """Train step ``step``'s lr scale: the lr policy's, times the
        rollback backoff's."""
        scale = self.lr_policy(1.0, step) if self.lr_policy else 1.0
        if self.recovery is not None:
            scale *= self.recovery.lr_scale
        return scale

    def _step_scalars(self, step: int, lr_scale: float) -> np.ndarray:
        """The float32 row of the values the host decides for train step
        ``step`` (here the lr scale; the unsupervised rules add theirs)."""
        return np.array([lr_scale], np.float32)

    def _put_scalars(self, row: np.ndarray) -> torch.Tensor:
        """One step's row on the workflow's device (on the card a
        ``non_blocking`` copy from pinned memory: no wait)."""
        if self.device.type == "cuda":
            return _pinned(row).to(self.device, non_blocking=True)
        return torch.from_numpy(row)

    def _n_watch(self) -> int:
        """The watch vector's length, ``1 + n_norms`` (0 with the watch
        off)."""
        if self.anomaly is None:
            return 0
        return 1 + sum(1 for _ in param_paths(self.state.params))

    # ------------------------------------------------------------------
    def train_step(self, x, y, mask, lr_scale: float = 1.0, acc=None) -> torch.Tensor:
        """One train step on device tensors (the loader's raw payload:
        the device preprocessing runs here): the step's row of host values
        (:meth:`_step_scalars`) on the device, the step (:meth:`_train_core`)
        and, with the anomaly watch on, the step's watch vector on its way
        to the host.  Returns ``acc`` with this step's metrics folded in (a
        fresh accumulator when ``acc`` is None)."""
        scal = self._put_scalars(self._step_scalars(self.state.step, lr_scale))
        acc, self._last_watch = self._train_core(
            x, y, mask, scal, self._acc_init() if acc is None else acc, self._watch_vector)
        self.state.step += 1
        return acc

    def _train_core(self, x, y, mask, scal, acc, watch):
        """The train step's device work, shared by both dispatches: the
        preprocessing, the learning rule (:meth:`_learn`) and the metrics
        folded into ``acc``; with the anomaly watch on, ``watch(loss,
        norms)`` routes the watch vector.  Returns ``(acc, what watch
        returned or None)``."""
        x, y = self._prep(x, y)
        m, norms = self._learn(x, y, mask, scal)
        m = self._rank_counts(m, mask)
        watch_loss = m.pop(WATCH_LOSS, None)
        if norms is None:
            return self._combine(acc, m), None
        if watch_loss is None:
            watch_loss = self._global_loss(m)
        return self._combine(acc, m), watch(watch_loss, norms)

    # -- data parallelism: the collectives of a step --------------------------
    def _rank_counts(self, m: Dict[str, Any], mask) -> Dict[str, Any]:
        """Under data parallelism a rank's ``n_samples`` is its count of
        valid rows, unclamped (a rank may hold only a padded batch's
        padding), so the ranks' accumulators add up to the global batch's."""
        if self.parallel is None:
            return m
        return dict(m, n_samples=mask.float().sum())

    def _global_loss(self, m: Dict[str, Any]):
        """The step's loss over the global batch (one all-reduce of the
        rank's sample-weighted loss and its count); the rank's own without
        data parallelism."""
        if self.parallel is None:
            return m["loss"]
        n = m["n_samples"]
        total, count = self.parallel.all_reduce(
            [torch.as_tensor(m["loss"]).detach().float().reshape(1) * n, n.reshape(1)])
        return (total / count.clamp_min(1.0))[0]

    def _reduce_accs(self, accs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The ranks' epoch accumulators combined over the data axis, split
        by split in name order on every rank: additive entries summed,
        ``max_*`` ones maximized."""
        if self.parallel is None or self.parallel.group is None or not accs:
            return accs
        names = sorted(accs)
        stacked = torch.stack([accs[k] for k in names])
        (total,) = self.parallel.all_reduce([stacked], "sum")
        (peak,) = self.parallel.all_reduce([stacked], "max")
        reduced = torch.where(self._add_mask, total, peak)
        return {k: reduced[i] for i, k in enumerate(names)}

    def _draws(self):
        """The block in which the step's per-sample draws (dropout,
        stochastic pooling) are made for the global batch, this rank
        taking its rows, so R ranks draw what one process draws."""
        if self.parallel is None:
            return contextlib.nullcontext()
        from znicz_tpu_torch.parallel.data_parallel import batch_shard

        return batch_shard(self.parallel.index, self.parallel.n_data)

    def _learn(self, x, y, mask, scal):
        """Forward, loss, autograd and the in-place update, the lr scale
        ``scal[0]`` (a tensor on the device).  Returns the step's metrics
        and, with the anomaly watch on, the gradients' per-tensor norms
        (else None).  Under data parallelism the gradients are the global
        batch's (the class docstring says how) and the metrics carry the
        global loss for the watch under :data:`WATCH_LOSS`."""
        st = self.state
        dp = self.parallel
        leaves = [w for _, w in param_paths(st.params)]
        with torch.enable_grad(), self._draws():
            m = self._forward_metrics(st.params, x, y, mask, train=True)
            objective = m["loss"]
            if dp is not None:
                # the loss's denominator becomes the global count of valid
                # rows: exactly 1.0 a factor on one rank
                n_rank = mask.float().sum()
                (n_all,) = dp.all_reduce([n_rank.reshape(1)])
                objective = objective * (n_rank.clamp_min(1.0) / n_all[0].clamp_min(1.0))
            flat = torch.autograd.grad(objective, leaves)
        if dp is not None:
            weighted = (m["loss"].detach().float() * n_rank).reshape(1)
            *flat, total = dp.all_reduce([*flat, weighted])
            m = dict(m, **{WATCH_LOSS: total[0] / n_all[0].clamp_min(1.0)})
        norms = self._norms(flat) if self.anomaly is not None else None
        grads = _refill(st.params, iter(flat))
        # each distinct lr times the scale in float32 on the device, once,
        # as the JAX package's step multiplies them
        scale = scal[0]
        lrs: Dict[float, torch.Tensor] = {}

        def scaled(lr):
            if lr is None:
                return None
            v = float(np.float32(lr))
            if v not in lrs:
                lrs[v] = scale * v
            return lrs[v]

        hyper = [
            h._replace(learning_rate=scaled(h.learning_rate),
                       learning_rate_bias=scaled(h.learning_rate_bias))
            for h in self._hyper()
        ]
        optimizer.update(st.params, grads, st.velocity, hyper)
        return m, norms

    def _norms(self, grads) -> list:
        """The gradients' per-tensor norms, a sharded leaf's over all its
        blocks (its squared norm summed over the model group, then over the
        pipe group for a stacked stage leaf, one all-reduce each); in the
        order of the params' leaves."""
        norms = tensor_norms(grads)
        dp = self.parallel
        if dp is None or not (dp.sharded or dp.staged):
            return norms
        from znicz_tpu_torch.parallel.tensor_parallel import all_reduce

        paths = [path for path, _ in param_paths(self.state.params)]
        norms = list(norms)
        for placed, group in ((dp.sharded, dp.model_group), (dp.staged, dp.pipe_group)):
            idx = [i for i, path in enumerate(paths) if path in placed]
            if not idx or group is None:
                continue
            sq = all_reduce(torch.stack([norms[i] for i in idx]) ** 2, group)
            for j, i in enumerate(idx):
                norms[i] = sq[j].sqrt()
        return norms

    @staticmethod
    def _watch_stack(loss, norms) -> torch.Tensor:
        """``[loss, norm_1, ..., norm_n]`` in float32, on the device."""
        return torch.stack([torch.as_tensor(loss).detach().float().reshape(()), *norms])

    def _watch_vector(self, loss, norms):
        """The step dispatch's watch vector on its way to the host (one
        stack; on the card a ``non_blocking`` copy into pinned memory and an
        event after it, so reading it later waits for nothing but that
        copy).  Returns ``(host or CPU tensor, event or None)``."""
        vec = self._watch_stack(loss, norms)
        if not vec.is_cuda:
            return vec, None
        (row,), event = _fetch_async([vec])
        return row, event

    @torch.no_grad()
    def eval_step(self, x, y, mask, acc=None) -> torch.Tensor:
        """One evaluation step; returns the updated accumulator."""
        x, y = self._prep(x, y)
        m = self._forward_metrics(self.state.params, x, y, mask, train=False)
        return self._combine(self._acc_init() if acc is None else acc, self._rank_counts(m, mask))

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
                        accs[split] = self.train_step(x, y, mask, self._lr_scale(self.state.step),
                                                      acc)
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

    # -- scan dispatch: one split function a split ------------------------------
    def _use_epoch_scan(self) -> bool:
        """Scan dispatch: ``"scan"`` needs an ``epoch_scan_friendly``
        loader (a streaming loader's stacked split would sit whole in host
        memory); ``"auto"`` takes it for such a loader with a device
        context."""
        friendly = getattr(self.loader, "epoch_scan_friendly", False)
        host_collectives = (self.parallel is not None and self.device.type == "cuda"
                            and self.parallel.host_collectives)
        if self.epoch_dispatch == "scan":
            if host_collectives:
                raise ValueError(
                    "epoch_dispatch='scan' captures the step into a CUDA graph, but this "
                    "process group's collectives stage the card's tensors through the "
                    "host (gloo), which no graph can capture; use an NCCL group or "
                    "epoch_dispatch='step'"
                )
            if not friendly:
                raise ValueError(
                    "epoch_dispatch='scan' needs a scan-friendly loader (per-batch "
                    "host payloads must be small, e.g. FullBatchLoader("
                    "device_resident=True)); a streaming loader would materialize "
                    "the whole epoch in host RAM"
                )
            return True
        return (self.epoch_dispatch == "auto" and self._ctx is not None and friendly
                and not host_collectives)

    def _put_stacked(self, split: str, arrays: Dict[str, np.ndarray]) -> _SplitRun:
        """The split's stacked arrays in its :class:`_SplitRun` (made for a
        new split, kind and shape): one copy, from pinned memory on the
        card."""
        layout, host = _SplitRun.pack(arrays)
        key = (split, layout)
        run = self._splits.get(key)
        if run is None:
            acc = self._acc_init()
            n_watch = self._n_watch() if split == TRAIN else 0
            run = self._splits[key] = _SplitRun(layout, host.nbytes, acc, n_watch, self.device)
        if self.device.type == "cuda":
            run.buf.copy_(_pinned(host), non_blocking=True)
        else:
            run.buf.copy_(torch.from_numpy(host))
        return run

    def _split_step(self, run: _SplitRun, train: bool) -> None:
        """One step of the split function: row ``counter`` of every stacked
        input, the step (the step dispatch's code), the metrics into the
        static accumulator, the watch vector into its row, the counter on
        by one.  Nothing here reads the device from the host."""
        x = run.row("x")
        y = x if "y" not in run.rows else run.row("y")
        mask = run.row("mask")
        if train:
            def watch(loss, norms):
                run.watch.index_copy_(0, run.counter, self._watch_stack(loss, norms)[None])

            acc, _ = self._train_core(x, y, mask, run.row("scal"), run.acc, watch)
        else:
            acc = self.eval_step(x, y, mask, run.acc)
        run.acc.copy_(acc)
        run.counter.add_(1)

    def _run_split(self, split: str, run: _SplitRun, n: int) -> None:
        """Run the split function over its ``n`` steps: eagerly on the CPU;
        on the card, replays of the captured step (captured at the key's
        first dispatch, after its first step ran eagerly as the warm-up)."""
        train = split == TRAIN
        run.counter.zero_()
        run.acc.copy_(self._acc_start)
        if self.device.type != "cuda":
            for _ in range(n):
                self._split_step(run, train)
            return
        done = 0
        if run.graph is None:
            self._capture(split, run, train)
            done = 1
        for _ in range(n - done):
            run.graph.replay()

    def _capture(self, split: str, run: _SplitRun, train: bool) -> None:
        """The split's first step, eagerly on a side stream (it builds the
        kernels, compiles the Triton forward and picks cuDNN's and
        cuBLAS's algorithms, none of which a capture may do), then the
        step captured into ``run.graph`` with the train state's generator
        registered (its draws go on from its offset at each replay, as
        eager steps' do).  A failed capture raises."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._split_step(run, train)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        gen = getattr(self.state, "generator", None)
        if gen is not None and gen.device.type == "cuda":
            graph.register_generator_state(gen)
        try:
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                self._split_step(run, train)
        except Exception as exc:
            raise RuntimeError(
                f"{self.name}: capturing the {split} step into a CUDA graph failed "
                f"({type(exc).__name__}: {exc}); the step must launch work on its "
                "stream only, with no host read, host copy or data-sized allocation"
            ) from exc
        run.graph = graph

    def _run_epoch_scanned(self) -> Dict[str, torch.Tensor]:
        """One dispatch a split: the epoch's host payloads stacked (the
        ``loader_epoch`` and ``stack/<split>`` phases), then the split
        function (``dispatch/<split>``), in the step dispatch's split
        order.  Each split's accumulator comes back as a copy, so a later
        dispatch never overwrites a pending epoch's."""
        with self.timer.phase("loader_epoch"):
            per_split: Dict[str, list] = {}
            for split, mb in self.loader.epoch():
                per_split.setdefault(split, []).append(mb)
        accs: Dict[str, torch.Tensor] = {}
        for split, mbs in per_split.items():
            train = split == TRAIN
            with self.timer.phase(f"stack/{split}"):
                arrays = {"x": np.stack([mb.data for mb in mbs])}
                if self.target != "input":
                    arrays["y"] = np.stack([self._batch_target(mb) for mb in mbs])
                arrays["mask"] = np.stack([mb.mask for mb in mbs])
                if train:
                    step0 = self.state.step
                    arrays["scal"] = np.stack([
                        self._step_scalars(step0 + i, self._lr_scale(step0 + i))
                        for i in range(len(mbs))
                    ])
                run = self._put_stacked(split, arrays)
            with self.timer.phase(f"dispatch/{split}"):
                self._run_split(split, run, len(mbs))
                if train:
                    self.state.step += len(mbs)
                    if run.watch is not None:
                        rows, event = self._watch_rows(run)
                        self._pending_watch.append((step0, rows, event))
                accs[split] = run.acc.clone()
        return accs

    def _watch_rows(self, run: _SplitRun):
        """The split's watch rows on their way to the host: one
        ``non_blocking`` copy into pinned memory and an event (a copy on
        the CPU)."""
        if self.device.type != "cuda":
            return run.watch.clone(), None
        (rows,), event = _fetch_async([run.watch])
        return rows, event

    def _drain_watches(self) -> list:
        """Feed the scanned splits' pending watch rows to the detector, at
        the epoch's sync; returns the verdicts raised."""
        pending, self._pending_watch = self._pending_watch, []
        raised: list = []
        for start, rows, event in pending:
            for i, row in enumerate(rows):
                raised.extend(self._feed_watch(start + i, (row, event)))
        return raised

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
        # the scanned splits' watch rows resolve here; a rollback verdict
        # aborts before the poisoned metrics reach the decision
        self._check_recovery(self._drain_watches())
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
        if not getattr(self, "_coordinator", True):
            return verdict  # services are host-side: coordinator-only
        for service in self.services:
            try:
                service.on_epoch(self, verdict)
            except Exception:  # services must never kill training
                self.logger.exception("service %s failed", type(service).__name__)
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
        accs = self._run_epoch_scanned() if self._use_epoch_scan() else self._run_epoch_stepwise()
        accs = self._reduce_accs(accs)
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
        self._pending_watch = []
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
        out = self._apply(self.state.params, x, train=False)
        m = evaluator.softmax(out, y, mask=mask, compute_confusion=True)
        conf = conf + m.pop("confusion")
        return self._combine(acc, self._rank_counts(m, mask)), conf

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
        acc = self._reduce_accs({split: acc})[split]
        if conf is not None and self.parallel is not None:
            (conf,) = self.parallel.all_reduce([conf])
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
