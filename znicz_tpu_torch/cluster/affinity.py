"""Router-side prefix-affinity index: which replica is warm for what (port
of ``znicz_tpu/cluster/affinity.py``, the same names and gauge).

The paged engine's prefix cache made a prompt's chained block-hash keys
(:func:`~znicz_tpu_torch.services.engine.prefix_block_keys`) a pure function
of token content — so the ROUTER can compute the same keys a replica's
cache is organized around without ever talking to it.  This index is
the router's learned guess of each replica's cache contents: every
routed request records its prompt's full-block keys under the replica
it was sent to (the replica will publish exactly those blocks at
retirement), and lookups walk a candidate prompt's chain until the
first unknown key — the longest-cached-prefix descent, mirrored
router-side (SGLang cache-aware routing lineage).

The index TRACKS replica state, it never trusts it: entries DECAY in
sync with how replica caches actually lose blocks —

* **TTL** (``ttl_s``): replicas evict LRU cache-only blocks under
  allocation pressure; an affinity entry nobody has re-used within the
  TTL is assumed evicted and dropped at the next touch.
* **capacity** (``max_keys_per_replica``): the index is bounded like
  the pool it mirrors — inserting past the cap evicts the
  least-recently-used keys, the same order the replica itself evicts.
* **flush on ejection**: a replica the registry declares dead loses
  its whole entry set (:meth:`drop`) — a restarted process comes back
  with an empty pool, and a re-admitted one simply re-learns.

A stale optimistic entry costs one prefill the replica would have done
anyway (a miss is the cold-path price, not an error); a stale missing
entry costs one routing opportunity.  Both are self-healing, which is
why tracking beats probing.

Thread-safe: routing threads learn/rank concurrently with the registry
thread dropping ejected replicas.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, Iterable, List, Sequence

from znicz_tpu_torch import observability


class PrefixAffinityIndex:
    """Bounded, decaying map of prefix block keys -> replicas."""

    def __init__(
        self,
        *,
        ttl_s: float = 600.0,
        max_keys_per_replica: int = 4096,
    ):
        if ttl_s <= 0:
            raise ValueError(f"want ttl_s > 0; got {ttl_s}")
        if max_keys_per_replica < 1:
            raise ValueError(
                f"want max_keys_per_replica >= 1; got "
                f"{max_keys_per_replica}"
            )
        self.ttl_s = float(ttl_s)
        self.max_keys_per_replica = int(max_keys_per_replica)
        self._lock = threading.Lock()
        # per replica: key -> last-touch monotonic time, LRU-ordered
        # (oldest first) — the same shape as the replica's own LRU
        self._keys: Dict[str, "OrderedDict[str, float]"] = {}
        self._m_keys = observability.gauge(
            "znicz_router_affinity_keys",
            "prefix block keys the router's affinity index currently holds",
        )

    def _now(self) -> float:
        return time.monotonic()

    def learn(self, instance: str, keys: Sequence[str]) -> None:
        """Record that ``instance`` is (about to be) warm for ``keys``
        — called when a request is routed there, BEFORE its completion:
        concurrent requests sharing the prefix must co-locate
        immediately, not after the first one retires."""
        if not keys:
            return
        now = self._now()
        with self._lock:
            d = self._keys.setdefault(str(instance), OrderedDict())
            for k in keys:
                d.pop(k, None)  # re-touch moves to the MRU end
                d[k] = now
            while len(d) > self.max_keys_per_replica:
                d.popitem(last=False)
            self._update_gauge()

    def _overlap_locked(self, instance: str, keys: Sequence[str],
                        now: float) -> int:
        """Longest known-cached chain prefix (lock held by caller):
        walks until the first unknown/expired key, exactly like
        replica admission walks its cache; expired entries are dropped
        on the way."""
        d = self._keys.get(str(instance))
        if not d:
            return 0
        n = 0
        for k in keys:
            t = d.get(k)
            if t is None:
                break
            if now - t > self.ttl_s:
                del d[k]
                break
            n += 1
        return n

    def overlap(self, instance: str, keys: Sequence[str]) -> int:
        """Longest known-cached CHAIN PREFIX of ``keys`` at
        ``instance`` (block count) — the routing score."""
        with self._lock:
            return self._overlap_locked(instance, keys, self._now())

    def rank(
        self, keys: Sequence[str], instances: Iterable[str]
    ) -> Dict[str, int]:
        """Overlap per candidate instance under ONE lock acquisition,
        so a concurrent learn/drop cannot land between per-replica
        walks and hand the router scores from two different index
        states."""
        now = self._now()
        with self._lock:
            return {
                i: self._overlap_locked(i, keys, now) for i in instances
            }

    def drop(self, instance: str) -> int:
        """Forget everything about ``instance`` (ejection flush);
        returns the number of keys dropped."""
        with self._lock:
            d = self._keys.pop(str(instance), None)
            self._update_gauge()
            return len(d) if d else 0

    def prune(self) -> int:
        """Drop every expired entry (the heartbeat thread calls this on
        its own cadence so an idle index still decays); returns the
        number dropped."""
        now = self._now()
        dropped = 0
        with self._lock:
            for d in self._keys.values():
                stale = [k for k, t in d.items() if now - t > self.ttl_s]
                for k in stale:
                    del d[k]
                dropped += len(stale)
            self._update_gauge()
        return dropped

    def stats(self) -> Dict:
        with self._lock:
            return {
                "ttl_s": self.ttl_s,
                "max_keys_per_replica": self.max_keys_per_replica,
                "keys_per_replica": {
                    i: len(d) for i, d in sorted(self._keys.items())
                },
            }

    def _update_gauge(self) -> None:
        """Total held keys (lock held by the caller)."""
        self._m_keys.set(sum(len(d) for d in self._keys.values()))


__all__: List[str] = ["PrefixAffinityIndex"]
