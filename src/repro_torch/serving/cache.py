"""LRU result cache for served oracle answers.

The serving twin of :class:`repro_torch.api.cache.MeasurementCache`, one level up:
that cache makes each unique configuration *measured* at most once per
campaign; this one makes each unique query *predicted* at most once per
server, keyed by the same canonical identities —
:func:`repro_torch.api.cache.batch_keys` tuples for single-layer predictions and
:meth:`repro_torch.api.PerfOracle.network_keys` (block fingerprints + kind/repeat)
for whole networks.  Unlike the measurement cache it is **bounded**: a
long-lived server sees an unbounded stream of distinct queries, so entries
are evicted least-recently-used at ``capacity``.

Cached values are the float64 bits the forest produced, so a cache hit is
bitwise identical to recomputing (asserted in tests/test_serving.py).  That
invariant must hold **per predict backend**: a key may be shared between the
numpy and jax engines only where their answers are bitwise-identical (layer
predictions always; network predictions except jax + log-target, see
``OracleServer._network_key_scope``, which scopes exactly that combination
into its own key space — asserted in tests/test_jax_predict.py).  All
operations take one lock; ``get_many`` refreshes recency for hits.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Hashable, Sequence


class ResultCache:
    """Thread-safe LRU of canonical query key -> predicted seconds."""

    def __init__(self, capacity: int = 65536) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._data: OrderedDict[Hashable, float] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._data)

    # ------------------------------------------------------------- lookup
    def get_many(self, keys: Sequence[Hashable]) -> list[float | None]:
        """Cached value per key (None = miss), refreshing hit recency.

        Unhashable/None keys (unfingerprintable queries) count as misses —
        the caller predicts them directly and never stores them.
        """
        out: list[float | None] = []
        with self._lock:
            for k in keys:
                if k is None:
                    out.append(None)
                    self.misses += 1
                    continue
                v = self._data.get(k)
                if v is None:
                    self.misses += 1
                else:
                    self._data.move_to_end(k)
                    self.hits += 1
                out.append(v)
        return out

    # ------------------------------------------------------------- insert
    def put_many(self, keys: Sequence[Hashable], values: Sequence[float]) -> None:
        """Insert computed answers; evicts least-recently-used past capacity."""
        with self._lock:
            for k, v in zip(keys, values):
                if k is None:
                    continue
                if k in self._data:
                    self._data.move_to_end(k)
                self._data[k] = float(v)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self.evictions += 1

    def clear(self) -> None:
        """Drop all entries and reset the hit/miss/eviction counters."""
        with self._lock:
            self._data.clear()
            self.hits = self.misses = self.evictions = 0

    # ------------------------------------------------------------- reporting
    def stats(self) -> dict[str, float]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "capacity": self.capacity,
                "size": len(self._data),
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
                "evictions": self.evictions,
            }
