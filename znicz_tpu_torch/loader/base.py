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
:class:`LoaderFetchError` raises; both are counted.  ``balanced=True``
spreads the classes evenly over the minibatches, drawing from the shuffle
stream as the JAX package does.  A device-resident loader lays its splits
out in one pool on the device by :func:`pool_offsets` and
:func:`pool_concat`.

Multi-process sample shards (:meth:`Loader.set_process_shard`): every
process computes the same global epoch order and serves only its
contiguous rows of each global minibatch, the mask computed globally and
then sliced, as in the JAX package.  Data-axis pool sharding is
``loader/pool_sharded.py``'s.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Iterator, NamedTuple, Optional, Sequence

import numpy as np
import torch

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
        self.max_minibatch_size = int(minibatch_size)
        self.shuffle = shuffle
        self.balanced = balanced  # spread the classes evenly over minibatches
        self.rand_name = rand_name
        # fill(indices, split) is a pure function of its indices, so a
        # transient failure is retried; the loader.fetch_flaky fault point
        # fires before each attempt
        self.fetch_retries = int(fetch_retries)
        self.fetch_backoff_s = float(fetch_backoff_s)
        self.skip_bad_batches = bool(skip_bad_batches)
        self.epoch_number = 0
        self._order: Dict[str, np.ndarray] = {}
        # the multi-process sample shard (set_process_shard): this process
        # serves only its contiguous row range of every global minibatch
        self.process_index = 0
        self.process_count = 1

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

    def split_labels(self, split: str) -> Optional[np.ndarray]:
        """All labels of a split (what ``balanced`` needs); None if unknown."""
        return None

    def device_preproc(self):
        """Optional callable ``pre(x, ctx)`` the workflow applies to each
        batch on the device inside the step (a u8 -> f32 affine, a gather
        from the device-resident pool); ``ctx`` is :meth:`device_context`
        placed on the workflow's device.  None = batches arrive ready."""
        return None

    def device_context(self) -> Optional[Dict[str, Any]]:
        """Host arrays the preprocessing needs on the device (the
        device-resident pool), or None.  The workflow copies them to its
        device once, at ``initialize``, and hands them to every step."""
        return None

    # the per-batch payloads are small (index vectors), so a whole split of
    # them can be stacked and run as one dispatch (Workflow epoch_dispatch)
    epoch_scan_friendly = False

    # data-axis pool sharding (loaders that support it set this True and
    # implement set_data_shards; Workflow.initialize calls it with the
    # mesh's data-axis size before placing the device context)
    wants_data_shards = False

    def set_data_shards(self, n: int) -> None:
        raise NotImplementedError

    def place_device_context(self, parallel, device=None):
        """:meth:`device_context` on the device (None when there is none):
        through ``parallel.put_replicated`` (the same arrays on every
        rank), or onto ``device`` without a placement policy.  Loaders
        whose context is sharded (the data-axis pool) override this."""
        ctx = self.device_context()
        if ctx is None:
            return None
        if parallel is not None:
            return {k: parallel.put_replicated(v) for k, v in ctx.items()}
        return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in ctx.items()}

    def set_process_shard(self, index: int, count: int) -> None:
        """Multi-process sample sharding: every process computes the same
        global epoch order (the named stream is seeded alike everywhere)
        and serves only rows ``[index*B/count, (index+1)*B/count)`` of
        every global minibatch, the rows its data-axis position owns."""
        if not 0 <= index < count:
            raise ValueError(f"process {index} outside [0, {count})")
        if self.max_minibatch_size % count:
            raise ValueError(
                f"minibatch_size {self.max_minibatch_size} not divisible "
                f"by process_count {count}"
            )
        if count > 1 and self.skip_bad_batches:
            # a skip is per-process: one process dropping a batch while
            # its peers dispatch the step desynchronizes the collective
            raise ValueError(
                "skip_bad_batches=True cannot combine with multi-host "
                "training (a per-process skip desynchronizes step "
                "counts across processes); use fetch_retries instead"
            )
        self.process_index = int(index)
        self.process_count = int(count)

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
        if not n:
            return
        gen = prng.get(self.rand_name)
        labels = self.split_labels(split) if self.balanced else None
        if labels is None:
            self._order[split] = gen.permutation(n)
            return
        # class-balanced: shuffle within each class, then place the sample
        # ranked r of a class of m at (r + jitter) / m, so that every
        # minibatch sees a near-proportional mix of the classes
        labels = np.asarray(labels)
        keys = np.empty(n, np.float64)
        for cls in np.unique(labels):
            idx = np.flatnonzero(labels == cls)
            perm = idx[gen.permutation(len(idx))]
            jitter = gen.uniform((len(idx),), 0.0, 1.0)
            keys[perm] = (np.arange(len(idx)) + jitter) / len(idx)
        self._order[split] = np.argsort(keys, kind="stable")

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
        # multi-process: this process fills only its rows of each global
        # minibatch (the mask is computed globally, then sliced, so padding
        # rows stay masked whichever process holds them)
        lo = self.process_index * bs // self.process_count
        hi = (self.process_index + 1) * bs // self.process_count
        for start in range(0, n, bs):
            idx = order[start : start + bs]
            n_valid = len(idx)
            if n_valid < bs:  # pad by repeating the first index; mask it out
                idx = np.concatenate([idx, np.full(bs - n_valid, idx[0])])
            mask = np.zeros(bs, np.float32)
            mask[:n_valid] = 1.0
            self._validate_batch_indices(idx, split)
            if self.process_count > 1:
                idx, mask = idx[lo:hi], mask[lo:hi]
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

    def _validate_batch_indices(self, idx: np.ndarray, split: str) -> None:
        """Hook: loaders with placement invariants on the whole batch's
        indices (before the process slice) check them here (the
        pool-sharded alignment of batch blocks to data-axis shards)."""

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


def pool_offsets(splits: Dict[str, np.ndarray]) -> Dict[str, int]:
    """Row offset of each split inside the device-resident pool: the one
    ordering contract shared with :func:`pool_concat` (splits in sorted
    order)."""
    offsets, off = {}, 0
    for s in sorted(splits):
        offsets[s] = off
        off += len(splits[s])
    return offsets


def pool_concat(splits: Dict[str, np.ndarray]) -> np.ndarray:
    """The split arrays concatenated in :func:`pool_offsets` order (a
    transient host copy: the workflow copies it to the device and drops
    it)."""
    return np.concatenate([np.asarray(splits[s]) for s in sorted(splits)])


def split_sizes(n: int, fractions: Sequence[float]) -> Dict[str, int]:
    """Partition ``n`` samples into train/valid/test by fractions (train
    gets the remainder)."""
    valid = int(n * fractions[0]) if len(fractions) > 0 else 0
    test = int(n * fractions[1]) if len(fractions) > 1 else 0
    return {TRAIN: n - valid - test, VALID: valid, TEST: test}
