"""AdapterCache: a device-resident LRU of hot adapters' delta rows
(counterpart of ``repro.adapters.device_cache``).

Three tiers of adapter storage for multi-tenant serving:

1. **Device memory (this module)**: the delta rows of hot adapters stay
   on the serving device inside a byte budget.  A tenant flip whose
   delta is cached is a device-to-device row scatter-swap: no host to
   device transfer.
2. **Host RAM**: the registry's LRU of deserialized host deltas.
3. **Disk**: the atomic ``blockdelta.v1`` payload directories.

Promotion (the miss path) pays the host to device upload once: q8
payloads travel as int8 rows + f32 block scales and are **dequantized
once, on the device** (``DeltaEntry.materialize_rows``), so the applied
values are identical whether they came from a hit, a fresh promotion or
the uncached path, and cached serving gives the token streams of
uncached serving.

Capture: when the serving loop reverts an adapter, the displaced rows of
the revert ARE that adapter's resident rows, already on the device;
``put_back`` admits them with no transfer.

Eviction is LRU over whole adapters and only drops cache copies: the
displaced base rows that make revert bit-exact belong to the serving
loop, never to this cache.

Cached rows are never written in place: the serving loop's swaps copy
them into the live leaves, and a whole-leaf entry is applied as a copy
(``apply_delta``).  So a fleet's replicas may share cached tensors
(``directory`` peer hits take a peer's entries without a copy): no
tensor that one replica's swaps write in place is reachable from
another replica.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict

from repro_torch.adapters.delta import DeltaEntry, SparseDelta
from repro_torch.models.model import resolve_device


class AdapterCache:
    """LRU of device-resident SparseDeltas under a byte budget.

    ``registry`` is the host tier (``AdapterRegistry`` or
    ``InMemoryRegistry``).  ``cache_bytes`` bounds the summed device
    bytes of cached deltas; a delta larger than the whole budget is
    served but not retained (``bypasses``).  ``device``: where promoted
    rows live (default: the CUDA device; raises without one unless the
    caller asks for the CPU).  ``directory`` / ``owner``: a shared
    directory of which replica holds which adapter resident (a fleet),
    consulted on a miss before promoting.
    """

    def __init__(self, registry, *, cache_bytes: int = 64 * 2 ** 20,
                 tracer=None, directory=None, owner: str = "server",
                 device=None):
        if cache_bytes <= 0:
            raise ValueError("cache_bytes must be > 0 (use cache=None to "
                             "disable caching)")
        self.registry = registry
        self.cache_bytes = int(cache_bytes)
        self.device = resolve_device(device)
        # promote / evict / capture events land on the "cache" lane
        self.tracer = tracer
        self.directory = directory
        self.owner = owner
        self._slots: "OrderedDict[str, SparseDelta]" = OrderedDict()
        self._nbytes: Dict[str, int] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.captures = 0          # put_back admissions (no h2d paid)
        self.bypasses = 0          # deltas too large to retain
        self.stale_drops = 0       # re-published adapters invalidated
        self.h2d_bytes = 0         # host->device promotion traffic
        self.d2d_bytes = 0         # flip bytes served from the device
        self.peer_hits = 0         # misses served from a peer replica
        self.xrep_bytes = 0        # device bytes captured cross-replica

    def _registry_version(self, adapter_id: str) -> int:
        ver = getattr(self.registry, "version", None)
        return 0 if ver is None else ver(adapter_id)

    # ------------------------------------------------------------------ #
    # promotion
    # ------------------------------------------------------------------ #

    def _promote(self, host: SparseDelta) -> SparseDelta:
        """Device copy of a host delta: rows uploaded (q8 payloads
        dequantized there, once); row indices stay host int32 tensors —
        the swap takes them from the host."""
        entries: Dict[str, DeltaEntry] = {}
        for name, e in host.entries.items():
            entries[name] = DeltaEntry(idx=e.idx,
                                       rows=e.materialize_rows(self.device))
        meta = dict(host.meta)
        meta["hbm_resident"] = True
        return SparseDelta(entries, meta)

    def _admit(self, adapter_id: str, delta: SparseDelta) -> bool:
        nb = delta.nbytes
        if nb > self.cache_bytes:
            self.bypasses += 1
            return False
        self._slots[adapter_id] = delta
        self._nbytes[adapter_id] = nb
        self._slots.move_to_end(adapter_id)
        if self.directory is not None:
            self.directory.publish(self.owner, adapter_id, delta)
        while self.resident_bytes() > self.cache_bytes:
            victim = next(iter(self._slots))
            nb_v = self._nbytes.pop(victim)
            del self._slots[victim]
            self.evictions += 1
            if self.directory is not None:
                self.directory.unpublish(self.owner, victim)
            if self.tracer is not None:
                self.tracer.instant("cache_evict", lane="cache",
                                    adapter=str(victim), bytes=nb_v)
        return True

    # ------------------------------------------------------------------ #
    # serving API
    # ------------------------------------------------------------------ #

    def get(self, adapter_id: str) -> SparseDelta:
        """Device delta for ``adapter_id``: from the cache on a hit,
        promoted through the host tier on a miss.  A hit whose registry
        publish counter moved (the adapter was re-``put``) is dropped and
        promoted again."""
        if adapter_id in self._slots:
            d = self._slots[adapter_id]
            if (d.meta.get("registry_version", 0)
                    == self._registry_version(adapter_id)):
                self.hits += 1
                self._slots.move_to_end(adapter_id)
                self.d2d_bytes += self._nbytes[adapter_id]
                if self.tracer is not None:
                    self.tracer.instant("cache_hit", lane="cache",
                                        adapter=str(adapter_id),
                                        bytes=self._nbytes[adapter_id])
                return d
            self.drop(adapter_id)
            self.stale_drops += 1
        self.misses += 1
        version = self._registry_version(adapter_id)
        if self.directory is not None:
            # another replica's device copy IS the promoted value
            # (promotion is deterministic): share it, no transfer
            peer = self.directory.lookup(adapter_id, version,
                                         exclude=self.owner)
            if peer is not None:
                dev = SparseDelta(dict(peer.entries), dict(peer.meta))
                self.peer_hits += 1
                self.xrep_bytes += dev.nbytes
                self._admit(adapter_id, dev)
                if self.tracer is not None:
                    self.tracer.instant("cache_peer_hit", lane="cache",
                                        adapter=str(adapter_id),
                                        bytes=dev.nbytes)
                return dev
        t0 = time.monotonic_ns() if self.tracer is not None else 0
        host = self.registry.get(adapter_id)
        self.h2d_bytes += host.nbytes      # q8 payloads upload quantized
        dev = self._promote(host)
        dev.meta["registry_version"] = version
        self._admit(adapter_id, dev)
        if self.tracer is not None:
            self.tracer.add_span("cache_promote", t0, time.monotonic_ns(),
                                 lane="cache", adapter=str(adapter_id),
                                 h2d_bytes=host.nbytes)
        return dev

    def put_back(self, adapter_id: str, displaced_of_revert: SparseDelta):
        """Capture an adapter's rows as they leave the live model.

        ``displaced_of_revert`` is the displaced-rows delta of a revert:
        its rows are exactly the adapter's resident device values, so
        admitting them costs no transfer.  An already cached adapter only
        moves to the LRU end.  A capture whose rows predate a re-``put``
        (the version moved while it was applied) is skipped."""
        if adapter_id in self._slots:
            self._slots.move_to_end(adapter_id)
            return
        # meta chains through apply -> revert, so the promotion's version
        # stamp (if any) describes these rows
        version = displaced_of_revert.meta.get("registry_version", 0)
        if version != self._registry_version(adapter_id):
            return
        entries = {name: DeltaEntry(idx=e.idx, rows=e.rows)
                   for name, e in displaced_of_revert.entries.items()}
        meta = {"adapter_id": adapter_id, "hbm_resident": True,
                "captured": True, "registry_version": version}
        if self._admit(adapter_id, SparseDelta(entries, meta)):
            self.captures += 1
            if self.tracer is not None:
                self.tracer.instant("cache_capture", lane="cache",
                                    adapter=str(adapter_id))

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #

    def __contains__(self, adapter_id: str) -> bool:
        return adapter_id in self._slots

    def cached_ids(self):
        return list(self._slots)

    def resident_bytes(self) -> int:
        return sum(self._nbytes.values())

    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def drop(self, adapter_id: str):
        """Release one adapter's device rows."""
        if self._slots.pop(adapter_id, None) is not None:
            del self._nbytes[adapter_id]
            if self.directory is not None:
                self.directory.unpublish(self.owner, adapter_id)

    def stats(self) -> Dict[str, float]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "captures": self.captures,
                "bypasses": self.bypasses,
                "stale_drops": self.stale_drops,
                "resident": len(self._slots),
                "resident_bytes": self.resident_bytes(),
                "cache_bytes": self.cache_bytes,
                "h2d_bytes": self.h2d_bytes,
                "d2d_bytes": self.d2d_bytes,
                "peer_hits": self.peer_hits,
                "xrep_bytes": self.xrep_bytes,
                "hit_rate": self.hit_rate()}
