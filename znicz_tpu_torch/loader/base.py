"""Loader protocol: split bookkeeping, shuffling, fixed-shape minibatches
(port of ``znicz_tpu/loader/base.py``).

Three splits (train/valid/test); train is reshuffled every epoch from the
named "loader" stream, which is bit-identical to the JAX package's, so both
frameworks see the same sample order.  Every minibatch has the same shape:
the last one is padded by repeating its first index and a float mask marks
the valid rows.

``state_dict`` holds the epoch count, the split orders and the shuffle
stream's position, as in the JAX package, so a resumed run draws the same
permutations.  ``fill`` runs behind the JAX package's retry and skip
ladder: a failed fetch is retried ``fetch_retries`` times with doubling
backoff, then the batch is skipped (``skip_bad_batches``) or the typed
:class:`LoaderFetchError` raises; both are counted.  Not ported yet:
class-balanced shuffling (``balanced=True`` is refused, naming its
``ROADMAP.md`` item), multi-host sample shards and the device-resident pool.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Iterator, NamedTuple, Optional

import numpy as np

from znicz_tpu_torch import observability
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.observability import pipeline as _pipeline
from znicz_tpu_torch.utils import faults

logger = logging.getLogger(__name__)

TRAIN, VALID, TEST = "train", "valid", "test"
SPLITS = (TRAIN, VALID, TEST)


class LoaderFetchError(RuntimeError):
    """A minibatch fetch (``Loader.fill``) kept failing past the retry
    budget: the typed form of a flaky data source."""


def _loader_retry_counter():
    return observability.counter(
        _pipeline.LOADER_RETRIES_METRIC,
        "minibatch fetch attempts retried after a transient failure",
    )


def _loader_skipped_counter():
    return observability.counter(
        _pipeline.LOADER_SKIPPED_METRIC,
        "minibatches dropped after exhausting fetch retries "
        "(skip_bad_batches=True)",
    )


class Minibatch(NamedTuple):
    data: np.ndarray  # [max_minibatch_size, ...]  padded
    labels: Optional[np.ndarray]  # [max_minibatch_size] int32, or None
    targets: Optional[np.ndarray]  # regression/AE targets, or None
    mask: Optional[np.ndarray]  # [max_minibatch_size] float32, 1.0 = valid row
    indices: np.ndarray  # dataset indices backing each row (padding repeats)


class Loader:
    """Abstract loader. Subclasses implement ``fill(indices, split)``."""

    def __init__(
        self,
        *,
        minibatch_size: int = 100,
        shuffle: bool = True,
        balanced: bool = False,
        rand_name: str = "loader",
        fetch_retries: int = 2,
        fetch_backoff_s: float = 0.05,
        skip_bad_batches: bool = False,
    ):
        if balanced:
            raise NotImplementedError(
                "class-balanced shuffling (balanced=True) is not ported to "
                "znicz_tpu_torch yet (ROADMAP.md A3, loader/base.py)"
            )
        self.max_minibatch_size = int(minibatch_size)
        self.shuffle = shuffle
        self.rand_name = rand_name
        # fill(indices, split) is a pure function of its indices, so a
        # transient failure is retried; the loader.fetch_flaky fault point
        # fires before each attempt
        self.fetch_retries = int(fetch_retries)
        self.fetch_backoff_s = float(fetch_backoff_s)
        self.skip_bad_batches = bool(skip_bad_batches)
        self.epoch_number = 0
        self._order: Dict[str, np.ndarray] = {}

    # -- subclass interface ------------------------------------------------
    @property
    def class_lengths(self) -> Dict[str, int]:
        raise NotImplementedError

    @property
    def sample_shape(self) -> tuple:
        """Per-sample data shape (no batch dim): drives shape inference."""
        raise NotImplementedError

    def fill(self, indices: np.ndarray, split: str) -> Minibatch:
        """Materialize the samples at ``indices`` of ``split``."""
        raise NotImplementedError

    def device_preproc(self):
        """Optional callable ``pre(x)`` the workflow applies to each batch
        on the device (e.g. u8 -> f32 affine); None = batches arrive ready."""
        return None

    # -- serving -----------------------------------------------------------
    def n_minibatches(self, split: str) -> int:
        n = self.class_lengths.get(split, 0)
        return -(-n // self.max_minibatch_size) if n else 0

    def _split_order(self, split: str) -> np.ndarray:
        n = self.class_lengths[split]
        order = self._order.get(split)
        if order is None or len(order) != n:
            order = np.arange(n)
            self._order[split] = order
        return order

    def reshuffle(self, split: str = TRAIN) -> None:
        n = self.class_lengths.get(split, 0)
        if n:
            self._order[split] = prng.get(self.rand_name).permutation(n)

    def batches(
        self, split: str, *, shuffle: Optional[bool] = None
    ) -> Iterator[Minibatch]:
        """Yield padded fixed-shape minibatches covering the split once.
        ``shuffle=False`` serves the current order without drawing from the
        shuffle stream."""
        n = self.class_lengths.get(split, 0)
        if not n:
            return
        if shuffle is None:
            shuffle = split == TRAIN and self.shuffle
        if shuffle:
            self.reshuffle(split)
        order = self._split_order(split)
        bs = self.max_minibatch_size
        for start in range(0, n, bs):
            idx = order[start : start + bs]
            n_valid = len(idx)
            if n_valid < bs:  # pad by repeating the first index; mask it out
                idx = np.concatenate([idx, np.full(bs - n_valid, idx[0])])
            mask = np.zeros(bs, np.float32)
            mask[:n_valid] = 1.0
            mb = self._fill_with_retry(idx, split)
            if mb is None:  # a skipped bad batch (counted)
                continue
            yield mb._replace(mask=mask, indices=idx)

    def _fill_with_retry(self, idx: np.ndarray, split: str) -> Optional[Minibatch]:
        """``fill`` behind the retry and skip ladder: None for a skipped
        batch (``skip_bad_batches``), else the batch; raises
        :class:`LoaderFetchError` once the retry budget is spent."""
        attempt = 0
        while True:
            try:
                faults.fire("loader.fetch_flaky")
                return self.fill(idx, split)
            except Exception as exc:
                if attempt >= self.fetch_retries:
                    if self.skip_bad_batches:
                        _loader_skipped_counter().inc()
                        logger.warning("skipping bad %s batch after %d attempt(s): %s",
                                       split, attempt + 1, exc)
                        return None
                    raise LoaderFetchError(
                        f"fetching a {split} minibatch failed {attempt + 1} time(s): {exc}"
                    ) from exc
                attempt += 1
                _loader_retry_counter().inc()
                logger.warning("%s minibatch fetch failed (attempt %d/%d): %s; retrying",
                               split, attempt, self.fetch_retries + 1, exc)
                if self.fetch_backoff_s > 0:
                    time.sleep(self.fetch_backoff_s * (2 ** (attempt - 1)))

    def epoch(self) -> Iterator[tuple]:
        """One full epoch: train batches then valid then test, tagged."""
        for split in SPLITS:
            for mb in self.batches(split):
                yield split, mb
        self.epoch_number += 1

    # -- snapshot support ----------------------------------------------------
    def state_dict(self) -> dict:
        return {
            "epoch_number": self.epoch_number,
            "order": {k: v.copy() for k, v in self._order.items()},
            # the shuffle stream's position
            "prng": prng.get(self.rand_name).state_dict(),
        }

    def load_state_dict(self, state: dict) -> None:
        self.epoch_number = state["epoch_number"]
        self._order = {k: np.asarray(v) for k, v in state["order"].items()}
        if "prng" in state:
            prng.get(self.rand_name).load_state_dict(state["prng"])
