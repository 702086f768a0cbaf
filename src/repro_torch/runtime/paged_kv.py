"""PagedKV: block-paged KV cache bookkeeping for the serving stack.

A copy of ``repro.runtime.paged_kv`` (host-side numpy only, kept so: the
same sequence of calls gives the same page tables, refcounts, copy-on-
write pairs and ``kv/*`` counters in both packages).  In the port the
device side is ``models/model.py`` (pools, in-place scatter/gather,
``copy_cache_pages``) and ``kernels/decode_attention.py`` with
``csrc/decode_attention.cu`` (the fused write+attend kernel); there the
fused kernel writes nothing for inactive slots, so the null page is
never written by a decode step.

The dense serving cache pays ``slots * max_seq`` rows of HBM per
attention layer no matter how long each request actually is.  PagedKV
splits the per-layer cache into fixed-size *pages* of ``page_size``
token rows living in a single pool ``[num_pages, page_size, KV, hd]``
and gives every slot a *page table* mapping logical page index
(``position // page_size``) to a physical page.  Memory is then paid
per live token (rounded up to a page), so the same HBM admits far more
concurrent requests on mixed-length workloads.

This module is the host-side brain: a free-list allocator with
refcounts, copy-on-write splits, and a prefix registry so tenants with
a common system prompt share physical pages until they diverge.  The
server (``runtime/serve_loop.py``) calls into this class every step.

Invariants the allocator maintains:

* Physical page 0 is the *null page*: never allocated, the target of
  every unmapped page-table entry.  Its contents are always finite
  (zeros at init); nothing ever reads it unmasked.
* A page-table entry is writable only while its page's refcount is
  exactly 1.  Sharing (a second slot mapping the page, or the prefix
  registry pinning it) bumps the refcount; ``ensure_range`` splits
  shared pages copy-on-write *before* the device ever writes them, so
  the fused write+attend kernel never needs a read-modify-write on a
  shared page.
* Admission is reserved worst-case: ``plan()`` computes the maximum
  number of fresh pages a request can ever allocate (prompt + max new
  tokens, minus fully-shared prompt pages, plus one for the
  copy-on-write split of a registered partial prompt page) and
  ``can_admit`` only says yes while ``free + evictable registry pages
  >= outstanding reservations + need``.  A mid-flight allocation can
  therefore always be satisfied — continuous batching never wedges on
  page exhaustion.
* Registered prefix pages are immutable: the registry pin keeps their
  refcount above 1, so even the *donor* slot copy-on-writes before its
  first decode token lands in a registered partial prompt page.
  Registry entries are LRU-evicted (pin dropped, page freed once no
  slot maps it) when the free list runs dry.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_CHAIN_SEED = 0x9E3779B97F4A7C15  # arbitrary non-zero hash-chain seed


def pages_for(tokens: int, page_size: int) -> int:
    """Number of pages covering ``tokens`` rows (ceil div)."""
    return -(-int(tokens) // int(page_size))


@dataclass
class AdmitPlan:
    """What ``plan()`` decided for one request: which registered pages
    it can map instead of prefilling, and the worst-case number of
    fresh pages it may still allocate."""
    matched_len: int                 # prompt tokens served from shared pages
    full_pages: List[int] = field(default_factory=list)   # phys, logical 0..
    partial_page: int = 0            # phys page holding the matched tail, or 0
    need_pages: int = 0              # worst-case future allocations


class PageAllocator:
    """Free-list page allocator + page tables + COW prefix sharing.

    Pure host-side numpy/dict bookkeeping — nothing here touches the
    device.  The server applies the returned (src, dst) copy pairs to
    the device pools and ships ``table()`` into the decode step.
    """

    NULL_PAGE = 0

    def __init__(self, num_pages: int, page_size: int, slots: int,
                 max_seq: int, *, share_prefix: bool = True,
                 metrics=None, tracer=None):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (one is the null page)")
        if max_seq % page_size:
            raise ValueError(f"max_seq={max_seq} must be a multiple of "
                             f"page_size={page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.slots = int(slots)
        self.max_seq = int(max_seq)
        self.pages_per_slot = max_seq // page_size
        self.share_prefix = bool(share_prefix)

        # phys page per (slot, logical page); 0 = unmapped (null page)
        self._table = np.zeros((slots, self.pages_per_slot), np.int32)
        self._ref = np.zeros(self.num_pages, np.int32)
        self._ref[self.NULL_PAGE] = 1          # pinned forever
        # LIFO free list; pop() hands out low page ids first
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._resv = np.zeros(slots, np.int64)  # outstanding worst-case pages
        self._live = np.zeros(slots, bool)

        # prefix registry: hash-chain over full prompt pages, plus
        # partial-tail entries keyed by (chain hash, tail tokens)
        self._chain: Dict[tuple, int] = {}            # key -> phys (pinned)
        self._parts: Dict[tuple, Dict[tuple, int]] = {}  # (ad, h) -> tail -> phys
        self._lru: "OrderedDict[tuple, int]" = OrderedDict()

        self.metrics = metrics
        self.tracer = tracer
        # plain counters so benches/tests work without a registry
        self.n_alloc = 0
        self.n_free = 0
        self.n_cow = 0
        self.n_prefix_pages = 0
        self.n_prefix_tokens = 0
        self.n_evict = 0
        self.n_rollback = 0
        if metrics is not None:
            for n in ("kv/page_alloc", "kv/page_free", "kv/cow_split",
                      "kv/prefix_hit_pages", "kv/prefix_hit_tokens",
                      "kv/registry_evictions", "kv/spec_rollback_pages"):
                metrics.counter(n)
            metrics.gauge("kv/pages_in_use")
            metrics.gauge("kv/pages_free")
            metrics.gauge("kv/shared_pages")

    # -- capacity ------------------------------------------------------ #

    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1

    @property
    def pages_in_use(self) -> int:
        return self.usable_pages - len(self._free)

    def live_mapped_tokens(self) -> int:
        """Distinct mapped logical rows across live slots (shared pages
        counted once per mapping slot — this is *logical* occupancy)."""
        return int((self._table > 0).sum()) * self.page_size

    def _evictable(self) -> int:
        return sum(1 for key in self._lru
                   if self._ref[self._chain[key]] == 1)

    def can_admit(self, need_pages: int) -> bool:
        budget = len(self._free) + self._evictable()
        return budget >= int(self._resv.sum()) + need_pages

    def fits_ever(self, total_tokens: int) -> bool:
        """Can a request of this worst-case length run alone?  Used by
        ``submit`` to reject requests that could never be admitted."""
        need = pages_for(total_tokens, self.page_size) + 1
        return need <= self.usable_pages

    # -- prefix matching / planning ------------------------------------ #

    def plan(self, adapter_id, prompt: Sequence[int],
             total_tokens: int) -> AdmitPlan:
        """Match ``prompt`` against the registry and compute the
        worst-case page reservation for a request that will occupy
        ``total_tokens`` rows (prompt + max new tokens, capped at
        max_seq)."""
        prompt = [int(t) for t in prompt]
        plen = len(prompt)
        ps = self.page_size
        full: List[int] = []
        partial = 0
        matched = 0
        if self.share_prefix:
            # cap so the last prompt token is always computed locally —
            # its logits produce the first output token
            limit = plen - 1
            h = _CHAIN_SEED
            i = 0
            while (i + 1) * ps <= limit:
                h2 = hash((h, tuple(prompt[i * ps:(i + 1) * ps])))
                key = ("full", adapter_id, h2)
                phys = self._chain.get(key)
                if phys is None:
                    break
                full.append(phys)
                h = h2
                i += 1
            matched = i * ps
            tails = self._parts.get((adapter_id, h), {})
            best: Optional[tuple] = None
            for tail in tails:
                if (len(tail) <= limit - matched
                        and tuple(prompt[matched:matched + len(tail)]) == tail
                        and (best is None or len(tail) > len(best))):
                    best = tail
            if best is not None:
                partial = tails[best]
                matched += len(best)
        need = pages_for(total_tokens, ps) - len(full)
        if self.share_prefix and plen % ps:
            # the partial prompt page gets registered (pinned) after
            # prefill; the first decode write then splits it COW
            need += 1
        return AdmitPlan(matched_len=matched, full_pages=full,
                         partial_page=partial, need_pages=need)

    # -- admission / release ------------------------------------------- #

    def admit(self, slot: int, plan: AdmitPlan) -> None:
        """Map the plan's shared pages into ``slot`` and commit its
        worst-case reservation.  Caller must have checked
        ``can_admit(plan.need_pages)``."""
        if self._live[slot]:
            raise RuntimeError(f"slot {slot} already live")
        self._table[slot] = self.NULL_PAGE
        for i, phys in enumerate(plan.full_pages):
            self._table[slot, i] = phys
            self._ref[phys] += 1
        if plan.partial_page:
            self._table[slot, len(plan.full_pages)] = plan.partial_page
            self._ref[plan.partial_page] += 1
        self._resv[slot] = plan.need_pages
        self._live[slot] = True
        shared = len(plan.full_pages) + (1 if plan.partial_page else 0)
        if shared:
            self.n_prefix_pages += shared
            self.n_prefix_tokens += plan.matched_len
            if self.metrics is not None:
                self.metrics.counter("kv/prefix_hit_pages").inc(shared)
                self.metrics.counter("kv/prefix_hit_tokens").inc(
                    plan.matched_len)
            if self.tracer is not None:
                self.tracer.instant("prefix_share", lane="kv", slot=slot,
                                    pages=shared, tokens=plan.matched_len)
        self._update_gauges()

    def release_slot(self, slot: int) -> None:
        """Unmap every page of ``slot`` (freeing pages whose refcount
        drops to zero) and return its reservation to the pool."""
        for l in range(self.pages_per_slot):
            phys = int(self._table[slot, l])
            if phys != self.NULL_PAGE:
                self._unref(phys)
        self._table[slot] = self.NULL_PAGE
        self._resv[slot] = 0
        self._live[slot] = False
        self._update_gauges()

    # -- write preparation (alloc + COW) -------------------------------- #

    def ensure_range(self, slot: int, begin: int,
                     end: int) -> List[Tuple[int, int]]:
        """Make token rows ``[begin, end)`` of ``slot`` writable:
        allocate unmapped pages and copy-on-write shared ones.  Returns
        ``(src_phys, dst_phys)`` pairs the caller must apply to the
        device pools *before* dispatching the write."""
        if end <= begin:
            return []
        if end > self.max_seq:
            raise ValueError(f"write range [{begin},{end}) exceeds "
                             f"max_seq={self.max_seq}")
        copies: List[Tuple[int, int]] = []
        ps = self.page_size
        for l in range(begin // ps, (end - 1) // ps + 1):
            phys = int(self._table[slot, l])
            if phys == self.NULL_PAGE:
                self._table[slot, l] = self._alloc(slot)
            elif self._ref[phys] > 1:
                new = self._alloc(slot)
                copies.append((phys, new))
                self._table[slot, l] = new
                self._unref(phys)
                self.n_cow += 1
                if self.metrics is not None:
                    self.metrics.counter("kv/cow_split").inc()
                if self.tracer is not None:
                    self.tracer.instant("cow_split", lane="kv", slot=slot,
                                        src=phys, dst=new)
        self._update_gauges()
        return copies

    def rollback_to(self, slot: int, keep_rows: int) -> int:
        """Roll ``slot``'s page table back to its first ``keep_rows``
        token rows — the speculative-decode rejection path: pages that
        ``ensure_range`` allocated for draft rows beyond the accepted
        prefix are unmapped (freed once nothing else holds them) and
        each returns +1 to the slot's worst-case reservation, so a
        rejected speculation never strands pages the admission
        invariant already promised to this slot.  Returns the number of
        pages unmapped."""
        first = pages_for(max(0, keep_rows), self.page_size)
        dropped = 0
        for l in range(first, self.pages_per_slot):
            phys = int(self._table[slot, l])
            if phys == self.NULL_PAGE:
                continue
            self._unref(phys)
            self._table[slot, l] = self.NULL_PAGE
            self._resv[slot] += 1
            dropped += 1
        if dropped:
            self.n_rollback += dropped
            if self.metrics is not None:
                self.metrics.counter("kv/spec_rollback_pages").inc(dropped)
            if self.tracer is not None:
                self.tracer.instant("spec_rollback", lane="kv", slot=slot,
                                    keep_rows=keep_rows, pages=dropped)
        self._update_gauges()
        return dropped

    # -- prefix registration -------------------------------------------- #

    def register(self, slot: int, adapter_id, prompt: Sequence[int]) -> None:
        """Pin ``slot``'s freshly-prefilled prompt pages into the
        prefix registry so later requests with the same prefix can map
        them.  Call once, after prefill and before the first decode
        write."""
        if not self.share_prefix:
            return
        prompt = [int(t) for t in prompt]
        plen = len(prompt)
        ps = self.page_size
        h = _CHAIN_SEED
        for i in range(plen // ps):
            h = hash((h, tuple(prompt[i * ps:(i + 1) * ps])))
            key = ("full", adapter_id, h)
            if key in self._chain:
                self._lru.move_to_end(key)
                continue
            phys = int(self._table[slot, i])
            self._pin(key, phys)
        t = plen % ps
        if t:
            tail = tuple(prompt[plen - t:])
            key = ("part", adapter_id, h, tail)
            if key in self._chain:
                self._lru.move_to_end(key)
            else:
                phys = int(self._table[slot, plen // ps])
                self._pin(key, phys)
                self._parts.setdefault((adapter_id, h), {})[tail] = phys
        self._update_gauges()

    # -- device-facing views -------------------------------------------- #

    def table(self, order: Optional[Sequence[int]] = None) -> np.ndarray:
        """The int32 page table ``[slots, pages_per_slot]`` (optionally
        row-reordered) — copied to the device once per step."""
        if order is None:
            return self._table.copy()
        return self._table[list(order)].copy()

    # -- internals ------------------------------------------------------ #

    def _alloc(self, slot: int) -> int:
        if not self._free:
            self._evict_one()
        if not self._free:
            raise RuntimeError(
                "KV page pool exhausted — reservation invariant violated "
                f"(slot={slot}, resv={self._resv.tolist()})")
        page = self._free.pop()
        self._ref[page] = 1
        if self._resv[slot] > 0:
            self._resv[slot] -= 1
        self.n_alloc += 1
        if self.metrics is not None:
            self.metrics.counter("kv/page_alloc").inc()
        if self.tracer is not None:
            self.tracer.instant("page_alloc", lane="kv", slot=slot, page=page)
        return page

    def _unref(self, phys: int) -> None:
        self._ref[phys] -= 1
        if self._ref[phys] == 0:
            self._free.append(phys)
            self.n_free += 1
            if self.metrics is not None:
                self.metrics.counter("kv/page_free").inc()
            if self.tracer is not None:
                self.tracer.instant("page_free", lane="kv", page=phys)

    def _pin(self, key: tuple, phys: int) -> None:
        self._chain[key] = phys
        self._ref[phys] += 1
        self._lru[key] = phys
        self._lru.move_to_end(key)

    def _evict_one(self) -> None:
        """Drop the least-recently-used registry entry whose page is
        pinned-only (refcount 1) — unpinning it frees a page."""
        for key in list(self._lru):
            phys = self._chain[key]
            if self._ref[phys] == 1:
                self._drop_entry(key)
                self.n_evict += 1
                if self.metrics is not None:
                    self.metrics.counter("kv/registry_evictions").inc()
                return

    def _drop_entry(self, key: tuple) -> None:
        phys = self._chain.pop(key)
        self._lru.pop(key, None)
        if key[0] == "part":
            _, adapter_id, h, tail = key
            group = self._parts.get((adapter_id, h))
            if group is not None:
                group.pop(tail, None)
                if not group:
                    del self._parts[(adapter_id, h)]
        self._unref(phys)

    def _update_gauges(self) -> None:
        if self.metrics is None:
            return
        self.metrics.gauge("kv/pages_in_use").set(self.pages_in_use)
        self.metrics.gauge("kv/pages_free").set(len(self._free))
        self.metrics.gauge("kv/shared_pages").set(
            int((self._ref[1:] > 1).sum()))
