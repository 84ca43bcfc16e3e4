"""Decision: epoch bookkeeping, best-model tracking, stop conditions
(port of ``znicz_tpu/nn/decision.py``, framework-free host code).

Accumulates per-split metrics across an epoch, tracks the best validation
result and decides when training stops (``max_epochs`` reached, or
``fail_iterations`` epochs without validation improvement).
"""

from __future__ import annotations

from typing import Dict, List, Optional

TRAIN, VALID, TEST = "train", "valid", "test"


class EpochMetrics:
    """Accumulates additive metrics (n_err, loss*n, n_samples) over an epoch."""

    def __init__(self):
        self.n_samples = 0.0
        self.n_err = 0.0
        self.loss_sum = 0.0
        self.extras: Dict[str, float] = {}

    def add(self, metrics: Dict[str, float]) -> None:
        n = float(metrics.get("n_samples", 0.0))
        self.n_samples += n
        self.n_err += float(metrics.get("n_err", 0.0))
        self.loss_sum += float(metrics.get("loss", 0.0)) * n
        for k, v in metrics.items():
            if k in ("n_samples", "n_err", "loss"):
                continue
            try:
                v = float(v)
            # type filter: non-scalar extras are not reduced here
            except (TypeError, ValueError):  # znicz-check: disable=ZNC008
                continue
            if k.startswith("max_"):  # peak-style metrics keep the max
                self.extras[k] = max(self.extras.get(k, float("-inf")), v)
            else:  # everything else is a sample-weighted epoch mean
                self.extras[k] = self.extras.get(k, 0.0) + v * n

    @property
    def loss(self) -> float:
        return self.loss_sum / max(self.n_samples, 1.0)

    def extras_summary(self) -> Dict[str, float]:
        return {
            k: v if k.startswith("max_") else v / max(self.n_samples, 1.0)
            for k, v in self.extras.items()
        }

    @property
    def err_pct(self) -> float:
        return 100.0 * self.n_err / max(self.n_samples, 1.0)


class Decision:
    """Stopping/bookkeeping policy driven by epoch-end metric reports.

    Usage per epoch: ``add_minibatch(split, metrics)`` for every step, then
    ``on_epoch_end(epoch)`` once — it returns a dict with ``improved`` (bool:
    validation got better; snapshot now) and ``stop`` (bool: training done).
    When there is no validation split, the train split drives improvement.
    """

    def __init__(
        self,
        *,
        max_epochs: Optional[int] = None,
        fail_iterations: int = 100,
        metric: str = "n_err",  # "n_err" (classification) or "loss" (MSE)
    ):
        self.max_epochs = max_epochs
        self.fail_iterations = fail_iterations
        self.metric = metric
        self.epoch = 0
        self.best_value: Optional[float] = None
        self.best_epoch = -1
        self.epochs_since_best = 0
        self.history: List[Dict[str, Dict[str, float]]] = []
        self._current: Dict[str, EpochMetrics] = {}

    def add_minibatch(self, split: str, metrics: Dict[str, float]) -> None:
        self._current.setdefault(split, EpochMetrics()).add(metrics)

    def _epoch_value(self) -> Optional[float]:
        src = self._current.get(VALID) or self._current.get(TRAIN)
        if src is None:
            return None
        return src.n_err if self.metric == "n_err" else src.loss

    def on_epoch_end(self, epoch: Optional[int] = None) -> Dict[str, object]:
        if epoch is not None:
            self.epoch = epoch
        summary = {
            split: {
                "n_samples": m.n_samples,
                "n_err": m.n_err,
                "err_pct": m.err_pct,
                "loss": m.loss,
                **m.extras_summary(),
            }
            for split, m in self._current.items()
        }
        self.history.append(summary)
        value = self._epoch_value()
        improved = False
        if value is not None and (
            self.best_value is None or value < self.best_value
        ):
            self.best_value = value
            self.best_epoch = self.epoch
            self.epochs_since_best = 0
            improved = True
        else:
            self.epochs_since_best += 1
        stop = self._would_stop(self.epoch, self.epochs_since_best)
        self._current = {}
        self.epoch += 1
        return {
            "improved": improved,
            "stop": stop,
            "summary": summary,
            "best_value": self.best_value,
            "best_epoch": self.best_epoch,
        }

    def _would_stop(self, epoch: int, epochs_since_best: int) -> bool:
        """The stop predicate, shared by ``on_epoch_end`` and
        ``can_stop_next_epoch`` so deferred epoch sync stays exact."""
        return (
            self.max_epochs is not None and epoch + 1 >= self.max_epochs
        ) or (epochs_since_best >= self.fail_iterations)

    def can_stop_next_epoch(self) -> bool:
        """Whether the next ``on_epoch_end`` could return ``stop=True`` for
        any metric values (worst case: no improvement).  The workflow's
        deferred epoch sync flushes such an epoch before dispatching
        another, so training ends where it would in sync mode."""
        return self._would_stop(self.epoch, self.epochs_since_best + 1)

    # -- checkpointable state (the host side of snapshot and resume) ---------
    def state_dict(self) -> Dict[str, object]:
        return {
            "epoch": self.epoch,
            "best_value": self.best_value,
            "best_epoch": self.best_epoch,
            "epochs_since_best": self.epochs_since_best,
            "history": self.history,
        }

    def load_state_dict(self, state: Dict[str, object]) -> None:
        self.epoch = state["epoch"]
        self.best_value = state["best_value"]
        self.best_epoch = state["best_epoch"]
        self.epochs_since_best = state["epochs_since_best"]
        self.history = list(state["history"])
