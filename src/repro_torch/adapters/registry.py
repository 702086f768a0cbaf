"""On-disk adapter store + in-memory LRU cache with serving ref-counts.

Layout (one directory per adapter, committed atomically — the same
manifest+npz+DONE contract as checkpoints):

    <root>/
      <adapter_id>/
        manifest.json   (leaf entries + meta: base_fingerprint, nbytes…)
        arrays.npz      (row indices + replacement rows per edited leaf)
        DONE            (commit marker, written last)

``put`` never exposes a half-written adapter: readers only list
directories with DONE.  ``put`` onto an existing id replaces it
atomically (rename) and invalidates the cache entry.

Cache policy: ``capacity`` bounds resident deltas; eviction is LRU over
entries with refcount 0.  ``acquire``/``release`` bracket an adapter
while a serving loop has its rows swapped into the live model — a pinned
(refcount > 0) delta is never evicted even when the cache is over
capacity (correctness first: the server may still need its row values;
the overflow drains on release).
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.adapters import delta as delta_lib
from repro_torch.adapters.delta import AdapterCorruptError, SparseDelta


class AdapterReadError(RuntimeError):
    """Transient adapter read failure — an injected fault
    (``FaultPlan`` adapter_read_error legs, runtime/elastic.py) or a
    real I/O error that survived the bounded retry-with-backoff."""


# error classes the read path retries: injected transients, checksum
# corruption (a concurrent re-put presents the same way mid-replace),
# and real filesystem errors
_RETRYABLE = (AdapterReadError, AdapterCorruptError, OSError)


def read_with_retry(read_fn, adapter_id: str, *, retries: int = 3,
                    backoff_ms: float = 5.0, fault_hook=None,
                    on_retry=None):
    """Run ``read_fn()`` with bounded exponential-backoff retry around
    transient failures.  ``fault_hook(adapter_id)`` (if set) runs before
    every attempt — the FaultPlan injection point; ``on_retry(attempt,
    exc)`` observes each failed attempt (metrics).  The last error is
    re-raised typed when every attempt fails — persistent corruption
    surfaces as ``AdapterCorruptError``, not a generic wrapper."""
    last = None
    for attempt in range(max(1, retries)):
        if attempt and backoff_ms > 0:
            time.sleep(backoff_ms * (2 ** (attempt - 1)) / 1000.0)
        try:
            if fault_hook is not None:
                fault_hook(adapter_id)
            return read_fn()
        except _RETRYABLE as e:
            last = e
            if on_retry is not None:
                on_retry(attempt, e)
    raise last


class AdapterRegistry:
    def __init__(self, root, *, capacity: int = 4,
                 read_retries: int = 3, retry_backoff_ms: float = 5.0):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.capacity = capacity
        self._lock = threading.RLock()
        self._cache: "OrderedDict[str, SparseDelta]" = OrderedDict()
        self._refs: Dict[str, int] = {}
        self._versions: Dict[str, int] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # fault-tolerant read path: FaultPlan injection + bounded
        # retry-with-backoff (knobs mirrored from FleetConfig by Router)
        self.fault_hook = None            # callable(adapter_id) or None
        self.read_retries = int(read_retries)
        self.retry_backoff_ms = float(retry_backoff_ms)
        self.retried_reads = 0

    # ------------------------------------------------------------------ #
    # disk
    # ------------------------------------------------------------------ #

    def path(self, adapter_id: str) -> Path:
        # a real exception (not assert): an id like "" or "x/../../y"
        # would make put() target — and replace-delete — arbitrary
        # directories including the registry root itself
        if (not adapter_id or "/" in adapter_id or "\\" in adapter_id
                or adapter_id in (".", "..")):
            raise ValueError(f"bad adapter id {adapter_id!r}")
        return self.root / adapter_id

    def put(self, adapter_id: str, delta: SparseDelta) -> Path:
        """Atomically persist ``delta`` under ``adapter_id``."""
        meta = dict(delta.meta)
        meta["adapter_id"] = adapter_id
        meta["nbytes"] = delta.nbytes
        out = delta_lib.save_delta(self.path(adapter_id),
                                   SparseDelta(delta.entries, meta))
        with self._lock:
            self._cache.pop(adapter_id, None)  # invalidate stale copy
            self._versions[adapter_id] = \
                self._versions.get(adapter_id, 0) + 1
        return out

    def version(self, adapter_id: str) -> int:
        """Monotonic in-process publish counter — bumped by every
        ``put``.  Device caches (``AdapterCache``) compare it to drop
        HBM copies of re-published adapters, the same way ``put``
        invalidates this registry's own host LRU."""
        with self._lock:
            return self._versions.get(adapter_id, 0)

    def exists(self, adapter_id: str) -> bool:
        return (self.path(adapter_id) / "DONE").exists()

    def list_adapters(self) -> List[str]:
        return sorted(p.name for p in self.root.iterdir()
                      if p.is_dir() and (p / "DONE").exists()
                      and not p.name.endswith((".tmp", ".old")))

    # ------------------------------------------------------------------ #
    # cache + ref-counting
    # ------------------------------------------------------------------ #

    def _load_locked(self, adapter_id: str) -> SparseDelta:
        if adapter_id in self._cache:
            self.hits += 1
            self._cache.move_to_end(adapter_id)
            return self._cache[adapter_id]
        self.misses += 1

        # a concurrent re-put replaces the directory with two renames;
        # raising AdapterReadError for the missing-DONE instant makes
        # that window retryable like any other transient, and checksum
        # corruption (AdapterCorruptError) retries the same way
        def _read():
            if not self.exists(adapter_id):
                raise AdapterReadError(
                    f"adapter {adapter_id!r} has no committed payload "
                    f"under {self.root}")
            return delta_lib.load_delta(self.path(adapter_id))

        def _count(attempt, exc):
            self.retried_reads += 1

        try:
            d = read_with_retry(_read, adapter_id,
                                retries=self.read_retries,
                                backoff_ms=self.retry_backoff_ms,
                                fault_hook=self.fault_hook,
                                on_retry=_count)
        except AdapterReadError:
            if not self.exists(adapter_id):   # genuinely absent, not torn
                raise KeyError(f"adapter {adapter_id!r} not in registry "
                               f"{self.root}") from None
            raise
        self._cache[adapter_id] = d
        self._evict_locked()
        return d

    def _evict_locked(self):
        while len(self._cache) > self.capacity:
            victim = next((k for k in self._cache
                           if self._refs.get(k, 0) == 0), None)
            if victim is None:  # everything pinned: keep over capacity
                return
            del self._cache[victim]
            self.evictions += 1

    def get(self, adapter_id: str) -> SparseDelta:
        """Load (cached) without pinning — for offline inspection."""
        with self._lock:
            return self._load_locked(adapter_id)

    def acquire(self, adapter_id: str) -> SparseDelta:
        """Load + pin: the delta stays resident until ``release``."""
        with self._lock:
            d = self._load_locked(adapter_id)
            self._refs[adapter_id] = self._refs.get(adapter_id, 0) + 1
            return d

    def release(self, adapter_id: str):
        with self._lock:
            n = self._refs.get(adapter_id, 0)
            assert n > 0, f"release of un-acquired adapter {adapter_id!r}"
            if n == 1:
                self._refs.pop(adapter_id)
            else:
                self._refs[adapter_id] = n - 1
            self._evict_locked()

    def refcount(self, adapter_id: str) -> int:
        with self._lock:
            return self._refs.get(adapter_id, 0)

    def cached_ids(self) -> List[str]:
        with self._lock:
            return list(self._cache)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "resident": len(self._cache),
                    "retried_reads": self.retried_reads,
                    "pinned": sum(1 for v in self._refs.values() if v)}


class InMemoryRegistry:
    """Registry-shaped wrapper over a plain ``{id: SparseDelta}`` dict —
    lets tests and examples drive the multi-tenant server without disk.
    Carries the same fault-injectable, retrying read path as
    ``AdapterRegistry`` (no backoff sleep by default — tests stay fast)
    so FaultPlan ``adapter_read_error`` legs work against it too."""

    def __init__(self, deltas: Optional[Dict[str, SparseDelta]] = None,
                 *, read_retries: int = 3,
                 retry_backoff_ms: float = 0.0):
        self._deltas = dict(deltas or {})
        self._refs: Dict[str, int] = {}
        self._versions: Dict[str, int] = {}
        self.fault_hook = None
        self.read_retries = int(read_retries)
        self.retry_backoff_ms = float(retry_backoff_ms)
        self.retried_reads = 0

    def _read(self, adapter_id: str) -> SparseDelta:
        if adapter_id not in self._deltas:
            raise KeyError(adapter_id)        # real absence: no retry

        def _count(attempt, exc):
            self.retried_reads += 1

        return read_with_retry(
            lambda: self._deltas[adapter_id], adapter_id,
            retries=self.read_retries,
            backoff_ms=self.retry_backoff_ms,
            fault_hook=self.fault_hook, on_retry=_count)

    def put(self, adapter_id: str, d: SparseDelta):
        self._deltas[adapter_id] = d
        self._versions[adapter_id] = self._versions.get(adapter_id, 0) + 1

    def version(self, adapter_id: str) -> int:
        return self._versions.get(adapter_id, 0)

    def exists(self, adapter_id: str) -> bool:
        return adapter_id in self._deltas

    def list_adapters(self) -> List[str]:
        return sorted(self._deltas)

    def get(self, adapter_id: str) -> SparseDelta:
        return self._read(adapter_id)

    def acquire(self, adapter_id: str) -> SparseDelta:
        d = self._read(adapter_id)
        self._refs[adapter_id] = self._refs.get(adapter_id, 0) + 1
        return d

    def release(self, adapter_id: str):
        assert self._refs.get(adapter_id, 0) > 0
        self._refs[adapter_id] -= 1

    def refcount(self, adapter_id: str) -> int:
        return self._refs.get(adapter_id, 0)

    def stats(self) -> Dict[str, int]:
        return {"resident": len(self._deltas),
                "retried_reads": self.retried_reads,
                "pinned": sum(1 for v in self._refs.values() if v)}
