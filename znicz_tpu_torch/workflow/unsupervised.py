"""Non-backprop workflows: Kohonen SOM and RBM (port of
``znicz_tpu/workflow/unsupervised.py``).

The learning rule is the trainer: each workflow's ``train_step`` runs its
update function (the batch-SOM rule, CD-k) in place of autograd and SGD,
and reuses the base loop's preprocessing, on-device metric accumulators and
Decision.  A CUDA tensor always takes the hand kernel
(``ops/kernels/kohonen.py``, ``ops/kernels/rbm.py``) and a CPU tensor its
plain version; ``impl`` is accepted so JAX call sites load unchanged.
Per-step host values (Kohonen's lr and ``2 sigma^2``, the RBM's lr and
chain seed) are computed from the host step counter into the step's
float32 row (:meth:`~Workflow._step_scalars`), which reaches the step on
the device: the kernels read ``2 sigma^2`` and the seed through a pointer,
so a captured step replays with each step's own values.  The rules write
the new params into the state's tensors in place.

The base loop's host machinery runs here too: the prefetch thread
(``prefetch_batches``), the snapshotter and ``initialize(snapshot=)`` (the
params come back as a dict, not marked for autograd; the SOM rebuilds its
grid), ``epoch_sync`` and the anomaly watch.  A step has no gradients, so
the watch's second entry is the update's norm ``||params' - params||``, as
in the JAX package, taken before the new params are copied in.  Both
``epoch_dispatch`` modes run, the scan for a device-resident loader.

Under ``parallel=`` each rank runs the kernel on its shard of the batch
and the kernels' psum rules sum the rank's statistics over the data axis
before the update (the SOM's ``(num, den)``; the RBM's ``(dW, dvb, dhb,
stats)``, its chain drawn from ``seed * n_shards + rank``), so every rank
applies the full batch's update.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from znicz_tpu_torch.core import device as device_lib, prng
from znicz_tpu_torch.loader.base import TRAIN, Loader
from znicz_tpu_torch.nn.decision import Decision
from znicz_tpu_torch.nn.train_state import TrainState
from znicz_tpu_torch.ops import kohonen as kh, rbm as rbm_op
from znicz_tpu_torch.ops.kernels import kohonen as kh_kernel, rbm as rbm_kernel
from znicz_tpu_torch.workflow.workflow import Workflow, int_bits, tensor_norms

METRICS = ["loss", "n_samples", "n_err"]
IMPLS = ("auto", "pallas", "xla")


class _NoModel:
    """Placeholder for Workflow's model attribute: these workflows have no
    layer list, their params are one dict."""

    params: list = []
    hyper: list = []


def params_from_jax(params_np: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The JAX package's dict-shaped unsupervised params (as numpy) as the
    port's tensors on ``device``, copied."""
    dev = device_lib.resolve(device)
    return {k: torch.tensor(np.asarray(v), device=dev) for k, v in params_np.items()}


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The params as host numpy copies."""
    return {k: v.detach().cpu().numpy().copy() for k, v in params.items()}


def _check_impl(impl) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}: want one of {IMPLS}")


def update_norms(old: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]) -> list:
    """Each param's ``||new - old||`` in float32; their global norm is the
    JAX package's ``_global_norm`` of the update."""
    return tensor_norms(torch._foreach_sub([new[k] for k in old], [old[k] for k in old]))


class _Unsupervised(Workflow):
    """The shared part: dict params, a custom train step, no autograd."""

    def __init__(self, loader: Loader, *, decision, device, name, **loop):
        super().__init__(
            loader,
            _NoModel(),
            loss_function="mse",
            target="labels",
            decision=decision,
            device=device,
            metric_names=METRICS,
            name=name,
            **loop,
        )

    def _batch_target(self, mb):
        return np.zeros(len(mb.mask), np.int32)  # unused host-side dummy

    def _state(self, params) -> TrainState:
        return TrainState(params=params, velocity=[], step=0,
                          generator=prng.get("workflow").generator(self.device))

    def _update(self, params, x, mask, scal):
        """One learning-rule step on the flattened batch, its host values in
        the row ``scal``; returns (new params, the step's metrics)."""
        raise NotImplementedError

    def _mesh(self):
        """The mesh the kernels' psum rules reduce over (None without data
        parallelism)."""
        return None if self.parallel is None else self.parallel.mesh

    @torch.no_grad()
    def _learn(self, x, y, mask, scal):
        """The learning rule in place of the autograd update, the new params
        copied into the state's tensors; returns the step's metrics and,
        with the anomaly watch on, the update's per-param norms."""
        params = self.state.params
        new, m = self._update(params, x.reshape(x.shape[0], -1), mask, scal)
        norms = update_norms(params, new) if self.anomaly is not None else None
        for k, v in new.items():
            params[k].copy_(v)
        return m, norms


class KohonenWorkflow(_Unsupervised):
    """Batch-SOM training (BASELINE configs[4]).  Metric: the quantization
    error (mean squared distance to the winning unit) as ``loss``."""

    def __init__(
        self,
        loader: Loader,
        *,
        sx: int = 8,
        sy: int = 8,
        total_epochs: int = 20,
        lr0: float = 0.1,
        lr1: float = 0.01,
        sigma1: float = 1.0,
        decision: Optional[Decision] = None,
        snapshotter=None,
        parallel=None,
        prefetch_batches: int = 2,
        epoch_sync: str = "sync",
        rand_name: str = "default",
        impl: str = "auto",
        epoch_dispatch: str = "auto",
        device=None,
        name: str = "KohonenWorkflow",
    ):
        _check_impl(impl)
        super().__init__(
            loader,
            decision=decision or Decision(metric="loss", max_epochs=total_epochs),
            device=device,
            name=name,
            snapshotter=snapshotter,
            parallel=parallel,
            prefetch_batches=prefetch_batches,
            epoch_sync=epoch_sync,
            epoch_dispatch=epoch_dispatch,
        )
        self.sx, self.sy = sx, sy
        self.total_epochs = total_epochs
        self.lr0, self.lr1, self.sigma1 = lr0, lr1, sigma1
        self.rand_name = rand_name
        self.impl = impl
        self._n_input = int(np.prod(loader.sample_shape))
        self._total_steps = total_epochs * max(loader.n_minibatches(TRAIN), 1)

    def _create_initial_state(self) -> TrainState:
        params = kh.init_params(self.sx, self.sy, self._n_input, rand_name=self.rand_name,
                                device=self.device)
        self._build_grid()
        return self._state(params)

    def _restore_from(self, state, host) -> None:
        super()._restore_from(state, host)
        self._build_grid()

    def _build_grid(self) -> None:
        self._coords = kh.grid_coords(self.sx, self.sy, device=self.device)
        self._d2m = kh_kernel.pairwise_d2(self._coords)  # fixed for the map

    def _step_scalars(self, step: int, lr_scale: float) -> np.ndarray:
        """``[lr, 2 sigma^2]`` of step ``step``: the decay schedule in
        float32, the lr times the scale in float32."""
        lr, sigma = kh.decay_schedule(
            step, self._total_steps, lr0=self.lr0, lr1=self.lr1,
            sigma1=self.sigma1, sx=self.sx, sy=self.sy,
        )
        return np.array([lr * np.float32(lr_scale), kh.two_sigma_sq(sigma)], np.float32)

    def _update(self, params, x, mask, scal):
        # the metric pairs the updated params with the pre-update winners,
        # as the JAX step does
        win = kh.winners(params, x)
        new = kh_kernel.train_step(
            params, x, self._coords, learning_rate=scal[0], tss=scal[1], mask=mask,
            d2m=self._d2m, mesh=self._mesh(),
        )
        return new, self._qe(new, x, win, mask)

    def _forward_metrics(self, params, x, y, mask, *, train: bool):
        x = x.reshape(x.shape[0], -1)
        return self._qe(params, x, kh.winners(params, x), mask)

    @staticmethod
    def _qe(params, x, win, mask):
        d2 = torch.sum(torch.square(x - params["weights"][win.long()]), dim=1)
        n = torch.clamp_min(torch.sum(mask), 1.0)
        return {
            "loss": torch.sum(d2 * mask) / n,
            "n_samples": n,
            "n_err": torch.zeros((), dtype=torch.int32, device=x.device),
        }

    def weights_map(self) -> np.ndarray:
        """``[sy, sx, features]`` view of the trained map (for plotting)."""
        w = self.state.params["weights"].detach().cpu().numpy()
        return w.reshape(self.sy, self.sx, -1)


class RBMWorkflow(_Unsupervised):
    """Bernoulli RBM with CD-k (BASELINE configs[2]).  Metric: the masked
    reconstruction error as ``loss``.  The chain of step ``s`` draws from
    seed ``s`` (the train state's step), as the JAX kernel path does."""

    def __init__(
        self,
        loader: Loader,
        *,
        n_hidden: int = 64,
        learning_rate: float = 0.1,
        cd_k: int = 1,
        max_epochs: int = 20,
        decision: Optional[Decision] = None,
        snapshotter=None,
        parallel=None,
        prefetch_batches: int = 2,
        epoch_sync: str = "sync",
        rand_name: str = "default",
        impl: str = "auto",
        epoch_dispatch: str = "auto",
        device=None,
        name: str = "RBMWorkflow",
    ):
        _check_impl(impl)
        super().__init__(
            loader,
            decision=decision or Decision(metric="loss", max_epochs=max_epochs),
            device=device,
            name=name,
            snapshotter=snapshotter,
            parallel=parallel,
            prefetch_batches=prefetch_batches,
            epoch_sync=epoch_sync,
            epoch_dispatch=epoch_dispatch,
        )
        self.n_hidden = n_hidden
        self.learning_rate = learning_rate
        self.cd_k = cd_k
        self.rand_name = rand_name
        self.impl = impl
        self._n_visible = int(np.prod(loader.sample_shape))

    def _create_initial_state(self) -> TrainState:
        params = rbm_op.init_params(self._n_visible, self.n_hidden, rand_name=self.rand_name,
                                    device=self.device)
        return self._state(params)

    def _step_scalars(self, step: int, lr_scale: float) -> np.ndarray:
        """``[lr, seed]``: the lr times the scale in float32, and the chain's
        seed, the step, by its bits (:func:`int_bits`)."""
        return np.array([np.float32(self.learning_rate) * np.float32(lr_scale),
                         int_bits(step)], np.float32)

    def _update(self, params, x, mask, scal):
        new, err = rbm_kernel.cd_step(params, x, scal[1:2].view(torch.int32),
                                      learning_rate=scal[0], cd_k=self.cd_k, mask=mask,
                                      mesh=self._mesh())
        return new, {
            "loss": err,
            "n_samples": torch.clamp_min(torch.sum(mask), 1.0),
            "n_err": torch.zeros((), dtype=torch.int32, device=x.device),
        }

    def _forward_metrics(self, params, x, y, mask, *, train: bool):
        v0 = x.reshape(x.shape[0], -1)
        v_probs = rbm_op.visible_probs(params, rbm_op.hidden_probs(params, v0))
        per = torch.mean(torch.square(v0 - v_probs), dim=1)
        n = torch.clamp_min(torch.sum(mask), 1.0)
        return {
            "loss": torch.sum(per * mask) / n,
            "n_samples": n,
            "n_err": torch.zeros((), dtype=torch.int32, device=x.device),
        }
