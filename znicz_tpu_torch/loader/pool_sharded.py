"""Data-axis pool sharding for device-resident loaders (port of
``znicz_tpu/loader/pool_sharded.py``).

The device-resident pool shards over the mesh's ``data`` axis: each rank's
device holds ``1/D`` of every split, so the pool's capacity is ``D`` cards'
free memory, not one card's.  Locality is by construction, so no
collective ever moves pool data:

- **Per-shard sampling.**  Each split is partitioned into D equal row
  blocks; batch position block ``s`` draws only from shard ``s``'s rows
  (every sample still appears once an epoch; a minibatch mixes within
  shards instead of globally).  The orders equal the JAX package's.
- **Local addresses.**  Minibatch payloads carry addresses into the
  owning device's pool block.  With one process a device, the rank's
  process shard of a batch is exactly its data-axis block, so the rank's
  own preprocessing gathers from its local pool (the JAX package's
  ``shard_map`` over the data axis).
- **Per-process placement.**  Each rank copies only its shard's rows to
  its device.

Mixin contract (``FullBatchLoader``, ``ImageNetLoader``): subclasses set
``self.wants_data_shards`` when the mode is on, implement
``_pool_split_arrays() -> {split: [n, ...] array}`` and build payloads
with ``_local_addr``.  ``Workflow.initialize`` calls ``set_data_shards``
with the mesh's data-axis size before placing the device context.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from znicz_tpu_torch.loader.base import TRAIN, pool_offsets


class PoolShardedMixin:
    """Per-shard sampling and sharded pool placement (see the module
    docstring)."""

    data_shards = 1

    def _pool_split_arrays(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    # -- shard layout --------------------------------------------------------
    def set_data_shards(self, n: int) -> None:
        """Partition every split into ``n`` equal row blocks (shard s of a
        split owns rows [s*len/n, (s+1)*len/n)); sampling becomes
        per-shard so batch position block s only references shard s."""
        if self.balanced:
            raise ValueError(
                "pool sharding is incompatible with balanced=True (the "
                "class-balanced shuffle is a global permutation; per-shard "
                "sampling owns the batch layout)"
            )
        bs = self.max_minibatch_size
        if bs % n:
            raise ValueError(
                f"pool sharding: minibatch_size {bs} not divisible by the "
                f"data axis {n}"
            )
        arrays = self._pool_split_arrays()
        for split, arr in arrays.items():
            if len(arr) % bs:
                raise ValueError(
                    f"pool sharding: split {split!r} has {len(arr)} rows, "
                    f"not a multiple of minibatch_size {bs} (static equal "
                    "per-shard chunks need full batches; pad or trim the "
                    "split)"
                )
        self.data_shards = int(n)
        self._order.clear()  # orders must be rebuilt in blocked layout
        # one device's block = the shared pool ordering contract applied
        # to one shard's chunk of each split
        self._local_split_offset = pool_offsets(
            {s: arr[: len(arr) // n] for s, arr in arrays.items()}
        )

    def _blocked_order(self, per_shard_rows: np.ndarray) -> np.ndarray:
        """[D, c] per-shard row ids -> epoch order where batch b's position
        block s holds shard s's rows [b*B/D, (b+1)*B/D)."""
        d, c = per_shard_rows.shape
        rows_per = self.max_minibatch_size // d
        steps = c // rows_per
        return per_shard_rows.reshape(d, steps, rows_per).transpose(1, 0, 2).reshape(-1)

    def _split_order(self, split: str) -> np.ndarray:
        if self.data_shards <= 1:
            return super()._split_order(split)
        n = self.class_lengths[split]
        order = self._order.get(split)
        if order is None or len(order) != n:
            c = n // self.data_shards
            order = self._blocked_order(np.arange(n).reshape(self.data_shards, c))
            self._order[split] = order
        return order

    def reshuffle(self, split: str = TRAIN) -> None:
        if self.data_shards <= 1:
            return super().reshuffle(split)
        n = self.class_lengths.get(split, 0)
        if not n:
            return
        from znicz_tpu_torch.core import prng

        gen = prng.get(self.rand_name)
        c = n // self.data_shards
        per_shard = np.stack([s * c + gen.permutation(c) for s in range(self.data_shards)])
        self._order[split] = self._blocked_order(per_shard)

    def _validate_batch_indices(self, idx: np.ndarray, split: str) -> None:
        if self.data_shards <= 1:
            return
        c = self.class_lengths[split] // self.data_shards
        rows_per = len(idx) // self.data_shards
        expected = np.repeat(np.arange(self.data_shards), rows_per)
        if not np.array_equal(idx // c, expected):
            raise AssertionError(
                "pool-sharded alignment violated: batch position block s "
                "must only reference data-axis shard s (a local gather "
                "would silently fetch wrong rows)"
            )

    def _local_addr(self, indices: np.ndarray, split: str) -> np.ndarray:
        """Dataset indices -> addresses within the owning device's pool
        block (split-chunk offset + position inside shard s's chunk)."""
        idx = np.asarray(indices, np.int64)
        c = self.class_lengths[split] // self.data_shards
        return (self._local_split_offset[split] + idx % c).astype(np.int32)

    # -- placement -----------------------------------------------------------
    def _local_pool(self) -> np.ndarray:
        """Shard-major pool rows owned by THIS process: for each of its
        data-axis shards, each split's chunk in the shared pool order (one
        allocation, filled in place)."""
        d = self.data_shards
        arrays = self._pool_split_arrays()
        lo = self.process_index * d // self.process_count
        hi = (self.process_index + 1) * d // self.process_count
        names = sorted(arrays)  # the pool_offsets / pool_concat ordering contract
        chunk = {name: len(arrays[name]) // d for name in names}
        block = sum(chunk.values())
        first = arrays[names[0]]
        out = np.empty(((hi - lo) * block,) + tuple(first.shape[1:]), first.dtype)
        row = 0
        for s in range(lo, hi):
            for name in names:
                c = chunk[name]
                out[row: row + c] = arrays[name][s * c:(s + 1) * c]
                row += c
        return out

    def place_device_context(self, parallel, device=None):
        if not self.wants_data_shards:
            return super().place_device_context(parallel, device)
        if parallel is None:
            raise ValueError("pool-sharded loaders need parallel=DataParallel(mesh)")
        if self.data_shards != parallel.n_data:
            raise ValueError(
                f"pool sharding: set_data_shards({parallel.n_data}) was "
                f"not applied (have {self.data_shards}); initialize the "
                "workflow instead of placing the context by hand"
            )
        # device_context() returns ONLY this process's shard's rows: the
        # rank's device holds its block of the pool and nothing else
        return {"pool": parallel.shard_batch(self.device_context()["pool"])}
