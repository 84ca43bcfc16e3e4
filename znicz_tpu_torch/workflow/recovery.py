"""Training self-healing policy: anomaly-triggered rollback and typed exits
(port of ``znicz_tpu/workflow/recovery.py``).

* :class:`RecoveryPolicy` consumes the step anomaly detector's typed
  verdicts and decides when the workflow rolls back to its last good state,
  how the replay is perturbed (the shuffle stream advanced, the learning
  rate scaled down) and when to give up (a bounded rollback budget, then
  the typed :class:`RollbackExhaustedError`).
* :class:`TrainingPreempted` is the exception a graceful stop
  (``Workflow.request_stop``) raises once the in-flight step has drained and
  the emergency snapshot is written; :data:`EXIT_PREEMPTED` is the process
  exit code a launcher maps it to.

The policy is host bookkeeping only.  The rollback mechanics (restoring the
train state, the loader, the streams and the decision) live in
:class:`~znicz_tpu_torch.workflow.workflow.Workflow`.  Its counter and gauge
carry the JAX package's metric names, so ``znicz-doctor`` reads a port run.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from znicz_tpu_torch import observability
from znicz_tpu_torch.observability import anomaly as _anomaly, pipeline as _pipeline

# "interrupted, an emergency snapshot exists, resume me": EX_TEMPFAIL,
# distinct from 0 (done) and 1 (crash)
EXIT_PREEMPTED = 75

# verdicts that mean the train state itself is poisoned: only a rollback
# fixes them
NON_FINITE_TYPES = (
    _anomaly.NON_FINITE_LOSS,
    _anomaly.NON_FINITE_GRAD,
)


class RollbackExhaustedError(RuntimeError):
    """The recovery policy gave up: its rollback budget is spent, or there
    is no valid state to roll back to."""


class TrainingPreempted(Exception):
    """A requested stop finished: the in-flight step drained and the
    emergency snapshot was written.  ``snapshot_path`` is None when no
    snapshotter was configured."""

    def __init__(self, message: str, snapshot_path: Optional[str] = None):
        super().__init__(message)
        self.snapshot_path = snapshot_path


class RecoveryPolicy:
    """When and how training rolls back to its last good state.

    ``max_rollbacks``: the run's rollback budget; past it
    :class:`RollbackExhaustedError` raises and the
    ``znicz_train_rollback_give_up`` gauge reads 1.
    ``lr_backoff``: the learning-rate scale is multiplied by this at every
    rollback (1.0 keeps the schedule; the scale composes with the
    workflow's ``lr_policy``).
    ``perturb``: advance the loader's shuffle stream after the restore so
    the replayed data order differs.  ``perturb=False`` with
    ``lr_backoff=1.0`` replays the run exactly.
    ``rollback_on_spike``: 0 disables; N > 0 also rolls back after N
    ``loss_spike`` verdicts since the last rollback (non-finite verdicts
    always do).
    """

    def __init__(
        self,
        *,
        max_rollbacks: int = 2,
        lr_backoff: float = 0.5,
        perturb: bool = True,
        rollback_on_spike: int = 0,
    ):
        if max_rollbacks < 1:
            raise ValueError("max_rollbacks must be >= 1")
        if not 0.0 < lr_backoff <= 1.0:
            raise ValueError("lr_backoff must be in (0, 1]")
        if rollback_on_spike < 0:
            raise ValueError("rollback_on_spike must be >= 0")
        self.max_rollbacks = int(max_rollbacks)
        self.lr_backoff = float(lr_backoff)
        self.perturb = bool(perturb)
        self.rollback_on_spike = int(rollback_on_spike)
        self.rollbacks_used = 0
        self.lr_scale = 1.0
        self.gave_up = False
        self.events: List[dict] = []
        self._spikes_since_rollback = 0
        self._m_rollbacks = observability.counter(
            _pipeline.ROLLBACKS_METRIC,
            "anomaly-triggered training rollbacks by verdict reason",
            ("reason",),
        )
        self._m_give_up = observability.gauge(
            _pipeline.ROLLBACK_GIVE_UP_METRIC,
            "1 once the recovery policy gave up (rollback budget spent "
            "or no valid snapshot) — znicz-doctor's exit-1 gate",
        )

    def should_rollback(self, anomalies: List[dict]) -> Optional[str]:
        """The rollback reason (the verdict type that triggered) for a batch
        of detector verdicts, or None to keep training."""
        for a in anomalies:
            if a.get("type") in NON_FINITE_TYPES:
                return a["type"]
        if self.rollback_on_spike:
            spikes = sum(1 for a in anomalies if a.get("type") == _anomaly.LOSS_SPIKE)
            if spikes:
                self._spikes_since_rollback += spikes
                if self._spikes_since_rollback >= self.rollback_on_spike:
                    return _anomaly.LOSS_SPIKE
        return None

    def budget_left(self) -> bool:
        return self.rollbacks_used < self.max_rollbacks

    def note_rollback(self, reason: str, *, step: int, source: str) -> dict:
        """Record one executed rollback: the budget, the counter, the lr
        backoff."""
        self.rollbacks_used += 1
        self.lr_scale *= self.lr_backoff
        self._spikes_since_rollback = 0
        self._m_rollbacks.labels(reason=reason).inc()
        event = {
            "kind": "rollback",
            "reason": reason,
            "step": int(step),
            "source": source,
            "rollbacks_used": self.rollbacks_used,
            "lr_scale": self.lr_scale,
            "unix": time.time(),
        }
        self.events.append(event)
        return event

    def note_give_up(self, reason: str, *, step: int, why: str) -> None:
        self.gave_up = True
        self._m_give_up.set(1.0)
        self.events.append({
            "kind": "give_up",
            "reason": reason,
            "step": int(step),
            "why": why,
            "unix": time.time(),
        })

    def report(self) -> Dict[str, object]:
        """A JSON-able readout for status surfaces."""
        return {
            "rollbacks_used": self.rollbacks_used,
            "max_rollbacks": self.max_rollbacks,
            "lr_scale": self.lr_scale,
            "gave_up": self.gave_up,
            "events": [dict(e) for e in self.events],
        }
