"""Batched decode serving loop, multi-tenant (counterpart of
``repro.runtime.serve_loop`` for the dense KV layout).

A request queue feeds fixed-size decode batches; finished sequences are
swapped out slot-wise while the rest keep decoding:

- one decode step with **per-slot positions** and an **active-slot
  mask**: the model writes each active slot's new K/V row in place and
  leaves inactive slots' rows bit-exact (the JAX server blends the whole
  cache under the mask inside its jitted step);
- **chunked batched prefill**: a whole admitted group's prompts run
  through ``model.prefill_into_slots`` in chunks of ``prefill_chunk``
  positions on a fixed grid (the JAX server buckets tail chunks to
  powers of two; on the card a chunk's shape changes the bits of its
  K/V rows, so a fixed grid keeps a request's rows, and its stream,
  independent of what it was admitted with); ``prefill_chunk=0``
  restores per-token priming through the decode step, which recurrent
  (RG-LRU) models always use;
- at admission a slot's recurrent state is zeroed on the device, so a
  request in a reused slot decodes as in a fresh server (the JAX server
  primes on the state the slot's last request left, ROADMAP C).

Multi-tenant (BlockDelta) serving: requests may carry an ``adapter_id``
resolved against an adapter registry.  One base model stays resident;
the scheduler groups slots by adapter and runs each group for a
micro-batch of decode steps, hot-swapping the delta rows between turns
(the row scatter-swap kernel — O(delta) bytes, not O(params)).  A slot
only ever decodes under its own adapter's weights, so per-request
outputs equal a single-tenant server's regardless of scheduling.

The scheduler is the JAX package's: adapter-aware admission (fill free
slots with the resident adapter's queue first), per-adapter turn budgets
scaled by queue depth and truncated by SLO deadlines, and an aging bound
against starvation (``adapter_aware=False`` restores round-robin).

**PagedKV** (``kv.layout="paged"``, ``runtime/paged_kv.py``): the KV
cache is a pool of fixed-size pages addressed through per-slot page
tables, admission is continuous (every step retires finished requests,
freeing their pages, and admits queued ones against a worst-case page
reservation, FIFO per group), and requests of one tenant with a common
prompt prefix map the same pages copy-on-write.  Before each dispatch
the allocator makes the rows it writes writable (fresh pages, COW
splits, copied on the device first) and the page table goes to the
device once.  Streams equal the dense layout's.

**Self-speculative decoding** (``spec.draft > 0``): the resident base
model drafts N tokens per round through the plain decode path (the
tenant's rows flipped out and back by ``adapters.flip_delta``), the
tenant scores all N + 1 positions through ``model.verify_into_slots``
(each position through the decode path, so the logits are bitwise plain
decoding's), and the longest greedy-agreeing prefix is accepted
(``spec_accept``): streams equal plain greedy decoding.  A round costs
2N + 1 decode passes (``stats()["spec"]["passes"]``) for at most N + 1
tokens per slot, so it is slower than plain decoding until the verify
runs in one pass (ROADMAP C).  Paged slots roll rejected pages back
(``PageAllocator.rollback_to``).  The draft length adapts per group on
an acceptance EMA.

**AdapterCache** (``adapters/device_cache.py``): with ``sched.cache_bytes
> 0`` (or an ``AdapterCache`` passed as ``cache=``) hot adapters' delta
rows stay resident on the device, so a flip to a cached tenant is a
device-to-device row swap with no host transfer; a reverted tenant's
rows are captured into the cache from the revert's displaced rows, and
q8 payloads are dequantized once, on promotion.  Streams equal uncached
serving.

There is no jit: the ``sched/compiles`` counter counts the lazy kernel
builds (1 on the first kernel use in the process, 0 after), and the one
host sync per decode dispatch is the argmax of the logits.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.adapters import delta as delta_lib
from repro_torch.adapters.device_cache import AdapterCache
from repro_torch.checkpoint.checkpointer import tree_map
from repro_torch.kernels import ops
from repro_torch.models import model as model_lib
from repro_torch.obs import MetricsRegistry
from repro_torch.runtime import paged_kv
from repro_torch.runtime.serve_config import ServeConfig

STATS_VERSION = 2

BASE = None  # adapter id of the un-adapted base model


@dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [P] int32
    max_new_tokens: int = 16
    adapter_id: Optional[str] = BASE   # None => base model
    slo_ms: Optional[float] = None     # per-request deadline budget
    on_token: Optional[Callable[[int], None]] = None  # streaming callback
    out: List[int] = field(default_factory=list)
    done: bool = False
    submit_step: int = -1       # decode-step clock at submit()
    first_token_step: int = -1  # decode-step clock at first output token
    finish_step: int = -1       # decode-step clock at completion
    submit_ns: int = -1         # monotonic clock at submit() (tracing)
    # trailing prompt tokens an interrupted stream decoded one at a time
    # (a failover replay): primed through the decode step, as they were
    decoded_tail: int = 0

    def replay_clone(self, rid: int) -> "Request":
        """Failover replay of this in-flight request on a peer replica
        (``runtime/fleet.py``): the clone's prompt is the retained prompt
        plus every token already streamed, its budget the tokens left.
        Greedy decoding is a function of the prefix, so the clone goes on
        where an uninterrupted run would have.

        The clone's ``on_token`` forwards each token into this request's
        ``out`` / ``on_token``, deduplicated at the emitted-token
        watermark: the clone's k-th token is stream position ``watermark
        + k`` and is dropped when this request already holds it.  The
        Router marks this request done when the clone finishes.

        The streamed tokens' K/V rows were written by decode steps, so
        the clone primes them through the decode step too
        (``decoded_tail``), and only the original prompt through chunked
        prefill: in bf16 on the card a prefill chunk rounds those rows
        differently from the decode step, and the continuation would
        part from the uninterrupted one (the JAX package primes the whole
        clone prompt in chunks)."""
        watermark = len(self.out)
        remaining = self.max_new_tokens - watermark
        assert remaining > 0, \
            f"request {self.rid} already emitted its full budget"
        prompt = np.asarray(self.prompt).ravel()
        if watermark:
            prompt = np.concatenate(
                [prompt, np.asarray(self.out, prompt.dtype)])
        clone = Request(rid=rid, prompt=prompt, max_new_tokens=remaining,
                        adapter_id=self.adapter_id, slo_ms=self.slo_ms,
                        decoded_tail=watermark)

        def _forward(tok: int, _orig=self, _clone=clone,
                     _base=watermark) -> None:
            pos = _base + len(_clone.out) - 1   # out appended pre-callback
            if len(_orig.out) == pos:           # watermark dedup
                _orig.out.append(tok)
                if _orig.on_token is not None:
                    _orig.on_token(tok)

        clone.on_token = _forward
        return clone


def _lane(adapter_id: Optional[str]) -> str:
    """One trace lane per tenant; the base model gets its own."""
    return f"tenant:{adapter_id}" if adapter_id is not BASE else "tenant:base"


def spec_accept(draft: Sequence[int], verify: Sequence[int]
                ) -> Tuple[int, List[int]]:
    """The speculative acceptance rule (greedy / longest-prefix).

    ``draft`` — N proposed tokens; ``verify`` — the N + 1 greedy
    argmaxes of the verifying model at positions ``pos .. pos + N``.
    Returns ``(accepted, emitted)``: the longest agreeing prefix length
    and ``verify[:accepted + 1]`` (every emitted token is a verifier
    argmax, so streams equal non-speculative greedy decoding)."""
    n = len(draft)
    if len(verify) != n + 1:
        raise ValueError(f"verify must score n+1 positions "
                         f"(n={n}, got {len(verify)})")
    a = 0
    while a < n and draft[a] == verify[a]:
        a += 1
    return a, [int(t) for t in verify[:a + 1]]


class DecodeServer:
    def __init__(self, cfg, params, config: Optional[ServeConfig] = None,
                 *, registry=None, cache=None, tracer=None, metrics=None,
                 device=None):
        """``params``: a tensor tree (``model.init_params`` layout).
        ``device=None`` means the CUDA device (raises without one);
        pass ``device="cpu"`` to serve on the CPU.  ``cache``: an
        ``AdapterCache`` to serve adapters through (else one is built
        when ``config.sched.cache_bytes > 0``)."""
        config = config if config is not None else ServeConfig()
        model_lib.check_supported(cfg)
        if cfg.is_encoder_decoder:
            # requests carry no frames: an encoder-decoder model decodes
            # at model level (``prefill``'s cross_kv, then decode_step)
            raise NotImplementedError(
                f"{cfg.name}: the server takes token-only models; decode "
                f"an encoder-decoder model with model.prefill and "
                f"model.decode_step")
        self.config = config
        self.device = model_lib.resolve_device(device)
        self.cfg = cfg
        self.tracer = tracer
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # the server owns its resident weights: hot swaps edit the leaves
        # in place, so they must not alias the caller's tensors
        params = tree_map(lambda a: a.to(self.device), params)
        if registry is not None:
            params = delta_lib.copy_tree(params)
        self.params = params            # live tree (current adapter applied)
        self.slots = config.batch_slots
        self.max_seq = config.max_seq
        self.registry = registry
        sched = config.sched
        self.steps_per_turn = max(1, sched.steps_per_turn)
        self.swap_mode = sched.swap_mode
        self.adapter_aware = sched.adapter_aware
        self.aging_steps = (3 * self.steps_per_turn if not sched.aging_steps
                            else max(1, sched.aging_steps))
        self._ms_auto = sched.ms_per_step == "auto"
        self._ms_samples = 0
        self.ms_per_step = 1.0 if self._ms_auto else float(sched.ms_per_step)
        self.cache = cache
        if self.cache is None and sched.cache_bytes > 0:
            if registry is None:
                raise ValueError("cache_bytes needs an adapter registry")
            self.cache = AdapterCache(registry, cache_bytes=sched.cache_bytes,
                                      tracer=tracer, device=self.device)
        elif self.cache is not None and tracer is not None \
                and self.cache.tracer is None:
            self.cache.tracer = tracer
        self.queue: List[Request] = []
        self.active: List[Optional[Request]] = [None] * self.slots
        self.pos = np.zeros(self.slots, np.int32)   # next write index
        # KV layout: dense [slots, max_seq] rows, or a page pool + per-slot
        # page tables + the host-side allocator
        self.alloc: Optional[paged_kv.PageAllocator] = None
        self._plans: Dict[int, paged_kv.AdmitPlan] = {}
        if config.kv.layout == "paged":
            if not model_lib.supports_paged_kv(cfg):
                raise ValueError(
                    "kv layout 'paged' needs an all-attention, token-only "
                    "architecture")
            ps = int(config.kv.page_size)
            # 0 = auto: every slot can hold max_seq tokens, + the null page
            npages = (int(config.kv.pages)
                      or self.slots * (self.max_seq // ps) + 1)
            self.alloc = paged_kv.PageAllocator(
                npages, ps, self.slots, self.max_seq,
                share_prefix=(config.kv.prefix_share
                              and model_lib.supports_prefix_share(cfg)),
                metrics=self.metrics, tracer=tracer)
            self.cache_state = model_lib.init_paged_cache(
                cfg, self.slots, npages, ps, self.max_seq,
                device=self.device)
        else:
            self.cache_state = model_lib.init_cache(
                cfg, self.slots, self.max_seq, device=self.device)
        # self-speculative decoding: the base drafts, the tenant verifies
        self.speculate = max(0, int(config.spec.draft))
        self.spec_adaptive = bool(config.spec.adaptive)
        if self.speculate and not model_lib.supports_spec_decode(cfg):
            raise ValueError(
                "speculate > 0 needs an all-global-attention, token-only "
                "architecture: rejected draft rows roll back by position "
                "masking, which ring-buffer local-attention rows do not "
                "support (see model.supports_spec_decode)")
        self._spec_len: Dict[Optional[str], int] = {}
        self._spec_ema: Dict[Optional[str], float] = {}
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        self.tokens = np.zeros((self.slots, 1), np.int32)
        self.steps = 0
        # adapter swap state
        self._applied: Optional[str] = BASE
        self._displaced = None          # SparseDelta restoring the base
        self._turn_group: Optional[str] = BASE
        self._turn_left = 0
        self._last_served: Dict[Optional[str], int] = {}
        self.swaps = 0
        self.swap_bytes = 0
        self.attn_impl = config.attn_impl
        self.prefill_chunk = max(0, config.prefill_chunk)
        self._slot_prefill = (self.prefill_chunk > 0
                              and model_lib.supports_slot_prefill(cfg))
        self.prefill_dispatches = 0      # model dispatches spent priming
        self.prefill_prompt_tokens = 0   # prompt tokens primed
        m = self.metrics
        for c in ("decode/steps", "decode/tokens", "prefill/dispatches",
                  "prefill/prompt_tokens", "sched/swaps",
                  "sched/swap_bytes", "sched/compiles", "sched/submitted",
                  "sched/finished"):
            m.counter(c)
        if self.speculate:
            for c in ("spec/rounds", "spec/passes", "spec/drafted",
                      "spec/accepted", "spec/rollbacks", "spec/flips"):
                m.counter(c)
            m.gauge("spec/draft_len")
            m.gauge("spec/acceptance_rate")
        for g in ("decode/ms_per_step", "sched/queue_depth",
                  "sched/swap_rate"):
            m.gauge(g)
        for h in ("decode/step_ms", "sched/request_ms",
                  "sched/queue_wait_ms"):
            m.histogram(h)

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _table(self) -> Optional[torch.Tensor]:
        """The page table on the device (paged layout), else None."""
        if self.alloc is None:
            return None
        return self._dev(self.alloc.table())

    def _decode(self, tokens, pos, mask, table=None):
        """One decode dispatch; ``table``: the device page table (paged)."""
        return model_lib.decode_step(
            self.params, self.cfg, self.cache_state, self._dev(tokens),
            self._dev(pos), attn_impl=self.attn_impl,
            active=self._dev(mask), page_table=table)[0]

    def submit(self, req: Request):
        if req.adapter_id is not BASE:
            # reject up front: an unknown adapter discovered at schedule
            # time would wedge the queue
            if self.registry is None:
                raise ValueError(f"request {req.rid} wants adapter "
                                 f"{req.adapter_id!r} but no registry is "
                                 f"set")
            if not self.registry.exists(req.adapter_id):
                raise ValueError(f"request {req.rid}: adapter "
                                 f"{req.adapter_id!r} not in registry")
        if self.alloc is not None:
            # a request whose worst case exceeds the whole pool could
            # never be admitted and would wedge the queue behind it
            total = min(len(req.prompt) + req.max_new_tokens, self.max_seq)
            if not self.alloc.fits_ever(total):
                raise ValueError(
                    f"request {req.rid}: worst case {total} tokens needs "
                    f"more KV pages than the pool holds "
                    f"({self.alloc.usable_pages} x "
                    f"{self.alloc.page_size} rows)")
        req.submit_step = self.steps
        req.submit_ns = time.monotonic_ns()
        self.queue.append(req)
        self.metrics.counter("sched/submitted").inc()
        if self.tracer is not None:
            self.tracer.instant("submit", lane=_lane(req.adapter_id),
                                rid=req.rid, adapter=str(req.adapter_id),
                                prompt_len=len(req.prompt))

    # ------------------------------------------------------------------ #
    # adapter swapping
    # ------------------------------------------------------------------ #

    def _ensure_adapter(self, adapter_id: Optional[str]):
        """Make ``self.params`` carry ``adapter_id`` (no-op when it
        already does).  Swap = revert the current delta rows, apply the
        new ones; both are exact row swaps, in place on the device.  With
        an AdapterCache the delta rows come from (and return to) it."""
        if adapter_id == self._applied:
            return
        tr = self.tracer
        if self._applied is not BASE:
            t0 = time.monotonic_ns() if tr is not None else 0
            disp, self._displaced = self._displaced, None
            # the revert's displaced rows are the leaving adapter's exact
            # resident values: the cache captures them (no transfer)
            self.params, back = delta_lib.apply_delta(
                self.params, disp, mode=self.swap_mode, donate=True,
                check_fingerprint=False)
            if self.cache is not None:
                self.cache.put_back(self._applied, back)
            else:
                self.registry.release(self._applied)
            # committed per half-swap: if the apply below fails the
            # server is consistently back on the base model
            if tr is not None:
                tr.add_span("swap_revert", t0, time.monotonic_ns(),
                            lane="sched", adapter=str(self._applied),
                            bytes=disp.nbytes)
            self._applied = BASE
            self.swap_bytes += disp.nbytes
            self.swaps += 1
            self.metrics.counter("sched/swaps").inc()
            self.metrics.counter("sched/swap_bytes").inc(disp.nbytes)
        if adapter_id is not BASE:
            t0 = time.monotonic_ns() if tr is not None else 0
            if self.cache is not None:
                d = self.cache.get(adapter_id)
            else:
                d = self.registry.acquire(adapter_id)
            try:
                self.params, self._displaced = delta_lib.apply_delta(
                    self.params, d, mode=self.swap_mode, donate=True)
            except Exception:
                if self.cache is None:
                    self.registry.release(adapter_id)
                raise
            if tr is not None:
                tr.add_span("swap_apply", t0, time.monotonic_ns(),
                            lane="sched", adapter=str(adapter_id),
                            bytes=d.nbytes)
            self._applied = adapter_id
            self.swap_bytes += d.nbytes
            self.swaps += 1
            self.metrics.counter("sched/swaps").inc()
            self.metrics.counter("sched/swap_bytes").inc(d.nbytes)

    def restore_base(self):
        """Revert any applied adapter — ``self.params`` is the pristine
        base again (bit-exact)."""
        self._ensure_adapter(BASE)

    # ------------------------------------------------------------------ #
    # scheduling
    # ------------------------------------------------------------------ #

    def _present_groups(self) -> List[Optional[str]]:
        """Adapter ids that can make progress now, in deterministic
        order: a group with an active slot can decode; a queue-only group
        needs a free slot to admit into."""
        free = any(r is None for r in self.active)
        active_groups = {r.adapter_id for r in self.active if r is not None}
        seen, out = set(), []
        for r in list(self.active) + self.queue:
            if r is None or r.adapter_id in seen:
                continue
            seen.add(r.adapter_id)
            if r.adapter_id in active_groups or free:
                out.append(r.adapter_id)
        return out

    def _group_reqs(self, g) -> List[Request]:
        return [r for r in list(self.active) + self.queue
                if r is not None and r.adapter_id == g]

    def _group_has_work(self, g) -> bool:
        return bool(self._group_reqs(g))

    def _waited(self, g) -> int:
        """Decode steps since ``g`` last made progress while having
        work (anchored at the later of its last served step and its
        earliest pending submit)."""
        reqs = self._group_reqs(g)
        if not reqs:
            return 0
        earliest = min(r.submit_step for r in reqs)
        last = self._last_served.get(g)
        return self.steps - (earliest if last is None
                             else max(last, earliest))

    def _min_slack(self, g) -> Optional[float]:
        """Tightest remaining deadline (in decode steps) among ``g``'s
        pending SLO-carrying requests; None when none has one."""
        slacks = [r.submit_step + r.slo_ms / self.ms_per_step - self.steps
                  for r in self._group_reqs(g) if r.slo_ms is not None]
        return min(slacks, default=None)

    def _turn_budget(self, g, groups) -> int:
        """Per-adapter SLO-aware turn length (see the JAX package)."""
        if not self.adapter_aware:
            return self.steps_per_turn
        cap = 4 * self.steps_per_turn
        depths = {h: max(1, len(self._group_reqs(h))) for h in groups}
        mean = sum(depths.values()) / len(depths)
        b = math.ceil(self.steps_per_turn * depths.get(g, 1) / mean)
        b = max(self.steps_per_turn, min(b, cap))
        reqs = self._group_reqs(g)
        if 0 < len(reqs) <= self.slots:
            need = max(r.max_new_tokens - len(r.out) for r in reqs)
            b = max(b, min(need, cap))
        for h in groups:
            if h == g:
                continue
            slack = self._min_slack(h)
            if slack is not None:
                b = max(1, min(b, int(slack)))
        return b

    def _pick_next(self, groups) -> Optional[str]:
        """Starved groups past the aging bound, then tight SLO
        deadlines, then the resident adapter, then round-robin."""
        if self.adapter_aware:
            starved = [g for g in groups
                       if self._waited(g) >= self.aging_steps]
            if starved:
                return min(starved,
                           key=lambda g: (-self._waited(g), groups.index(g)))
            slacks = {g: self._min_slack(g) for g in groups}
            urgent = [(slacks[g], i, g) for i, g in enumerate(groups)
                      if slacks[g] is not None
                      and slacks[g] <= self.steps_per_turn]
            if urgent:
                return min(urgent)[2]
            if self._applied in groups:
                return self._applied
        try:
            i = groups.index(self._turn_group)
            return groups[(i + 1) % len(groups)]
        except ValueError:
            return groups[0]

    def _schedule(self) -> Optional[str]:
        """Stay on the current group while its turn budget lasts, then
        pick the next (the budget is recomputed at every boundary)."""
        groups = self._present_groups()
        if not groups:
            return self._turn_group
        if self._turn_left > 0 and self._turn_group in groups:
            return self._turn_group
        nxt = self._pick_next(groups)
        self._turn_group = nxt
        self._turn_left = self._turn_budget(nxt, groups)
        return nxt

    def _mask(self, only: Optional[int] = None,
              group: Optional[str] = BASE) -> np.ndarray:
        if only is not None:
            m = np.zeros(self.slots, bool)
            m[only] = True
            return m
        return np.asarray([r is not None and r.adapter_id == group
                           for r in self.active])

    def _emit(self, req: Request, slot: int, tok: int):
        req.out.append(tok)
        self.tokens[slot, 0] = tok
        if req.on_token is not None:
            req.on_token(tok)

    def _retire(self, req: Request, slot: int):
        """Free a finished request's slot (and, paged, its KV pages: the
        same step can admit against them)."""
        req.done = True
        req.finish_step = self.steps
        self.active[slot] = None
        if self.alloc is not None:
            self.alloc.release_slot(slot)
            self._plans.pop(slot, None)
        self._finish(req)

    def _apply_copies(self, copies):
        """The device half of copy-on-write splits: copy each ``(src,
        dst)`` page in every pool, in place, on the current stream (so
        before the dispatch that writes ``dst``)."""
        if copies:
            src, dst = zip(*copies)
            model_lib.copy_cache_pages(self.cache_state, src, dst)

    def _ensure_rows(self, slots, begin, end):
        """Make rows ``[begin[s], end[s])`` of each slot writable (fresh
        pages, COW splits applied on the device).  Reservations guarantee
        the allocations succeed (see paged_kv.py)."""
        copies = []
        for s in slots:
            copies.extend(self.alloc.ensure_range(s, int(begin[s]),
                                                  int(end[s])))
        self._apply_copies(copies)

    def _admit(self, group: Optional[str] = BASE):
        """Fill free slots with queued requests of ``group`` (its delta
        is already applied) and prime their prompts together.  Paged:
        admission is also gated on page capacity (each request reserves
        its worst case), FIFO per group — a request that does not fit
        blocks later ones, so big requests are not starved by small
        ones."""
        admitted = []
        for slot in range(self.slots):
            if self.active[slot] is not None:
                continue
            qi = next((i for i, r in enumerate(self.queue)
                       if r.adapter_id == group), None)
            if qi is None:
                break
            req = self.queue[qi]
            if self.alloc is not None:
                total = min(len(req.prompt) + req.max_new_tokens,
                            self.max_seq)
                plan = self.alloc.plan(group, req.prompt, total)
                if not self.alloc.can_admit(plan.need_pages):
                    break           # pages free as active requests retire
                self.alloc.admit(slot, plan)
                self._plans[slot] = plan
            self.queue.pop(qi)
            self.active[slot] = req
            admitted.append((slot, req))
        if not admitted:
            return
        tr = self.tracer
        now = time.monotonic_ns()
        for _, req in admitted:
            if req.submit_ns >= 0:
                if tr is not None:
                    tr.add_span("queue_wait", req.submit_ns, now,
                                lane=_lane(req.adapter_id), rid=req.rid)
                self.metrics.histogram("sched/queue_wait_ms").observe(
                    (now - req.submit_ns) / 1e6)
        admit_t0 = time.monotonic_ns() if tr is not None else 0
        # a reused slot's recurrent state is its last request's: start
        # each admitted request from a fresh state, as a fresh server
        # would (attention rows are masked by position and need no reset)
        model_lib.reset_recurrent_state(self.cache_state,
                                        [slot for slot, _ in admitted])
        firsts = (self._prime_chunked(admitted) if self._slot_prefill
                  else self._prime_tokenwise(admitted))
        if tr is not None:
            tr.add_span("admit", admit_t0, time.monotonic_ns(),
                        lane="sched", group=str(group), count=len(admitted))
        for (slot, req), first in zip(admitted, firsts):
            if self.alloc is not None:
                # pin the freshly primed prompt pages before the first
                # decode write: the pin keeps them immutable (that write
                # splits them), and later requests map them
                self.alloc.register(slot, group, req.prompt)
            req.first_token_step = self.steps
            self._emit(req, slot, first)
            self.pos[slot] = len(req.prompt)
            self.prefill_prompt_tokens += len(req.prompt)
            self.metrics.counter("prefill/prompt_tokens").inc(
                len(req.prompt))
            if len(req.out) >= req.max_new_tokens:
                self._retire(req, slot)

    def _prime_begins(self, admitted) -> np.ndarray:
        """Paged priming: make every admitted slot's own prompt rows
        writable and return each slot's first self-computed position (its
        shared-prefix match length; 0 where nothing matched)."""
        begins = np.zeros(self.slots, np.int32)
        ends = np.zeros(self.slots, np.int32)
        for slot, req in admitted:
            begins[slot] = self._plans[slot].matched_len
            ends[slot] = len(req.prompt)
        self._ensure_rows([s for s, _ in admitted], begins, ends)
        return begins

    def _prime_tokenwise(self, admitted) -> List[int]:
        """Per-token priming: teacher-force each prompt through the
        decode step, one token at a time, one request at a time.  Paged
        slots start at their shared-prefix match."""
        paged = self.alloc is not None
        begins = (self._prime_begins(admitted) if paged
                  else np.zeros(self.slots, np.int32))
        table = self._table()
        return [self._prime_by_decode(slot, req, int(begins[slot]), table)
                for slot, req in admitted]

    def _prime_by_decode(self, slot: int, req: Request, b0: int,
                         table) -> int:
        """Teacher-force ``req.prompt[b0:]`` through the decode step into
        ``slot``; returns the first new token (the final step's argmax)."""
        tr = self.tracer
        logits = None
        toks = self.tokens.copy()
        t0 = time.monotonic_ns() if tr is not None else 0
        for t in range(b0, len(req.prompt)):
            toks[slot, 0] = int(req.prompt[t])
            pos = self.pos.copy()
            pos[slot] = t
            logits = self._decode(toks, pos, self._mask(slot), table)
            self.prefill_dispatches += 1
        self.metrics.counter("prefill/dispatches").inc(len(req.prompt) - b0)
        if tr is not None:
            tr.add_span("prefill", t0, time.monotonic_ns(), lane="sched",
                        kind="tokenwise", rid=req.rid,
                        tokens=len(req.prompt) - b0)
        return int(logits[slot].argmax())

    def _prime_chunked(self, admitted) -> List[int]:
        """Chunked batched prefill: every admitted prompt runs through
        ``model.prefill_into_slots`` together, ``prefill_chunk`` positions
        per dispatch, full chunks at aligned starts (a fixed grid: a K/V
        row's bits then depend only on the token prefix, never on this
        batch's chunk layout, so streams do not depend on what a request
        was admitted with, and paged rows one request wrote can be mapped
        by another).  The chunk covering each prompt's last token yields
        its first new token.  Paged with prefix sharing skips the chunks
        below every slot's match.  A replay's ``decoded_tail`` is primed
        through the decode step after the chunks."""
        tr = self.tracer
        paged = self.alloc is not None
        begins = (self._prime_begins(admitted) if paged
                  else np.zeros(self.slots, np.int32))
        table = self.alloc.table() if paged else None
        skip_shared = paged and self.alloc.share_prefix
        lengths = np.zeros(self.slots, np.int32)
        for slot, req in admitted:
            lengths[slot] = len(req.prompt) - req.decoded_tail
        longest = int(lengths.max())
        firsts: Dict[int, int] = {}
        start = 0
        if skip_shared:
            start = (int(min(begins[s] for s, _ in admitted))
                     // self.prefill_chunk) * self.prefill_chunk
        while start < longest:
            k = self.prefill_chunk
            toks = np.zeros((self.slots, k), np.int32)
            for slot, req in admitted:
                hi = min(len(req.prompt), start + k)
                if hi > start:
                    toks[slot, :hi - start] = np.asarray(
                        req.prompt[start:hi], np.int32)
            t0 = time.monotonic_ns() if tr is not None else 0
            logits, _ = model_lib.prefill_into_slots(
                self.params, self.cfg, self.cache_state, self._dev(toks),
                lengths, chunk_start=start, attn_impl=self.attn_impl,
                page_table=table, begin=begins if paged else None)
            if tr is not None:
                tr.add_span("prefill", t0, time.monotonic_ns(),
                            lane="sched", kind="chunk", start=start,
                            chunk=k, compiled=False)
            self.metrics.counter("prefill/dispatches").inc()
            self.prefill_dispatches += 1
            nxt = None
            for slot, req in admitted:
                if start < len(req.prompt) <= start + k:
                    if nxt is None:
                        nxt = logits.argmax(-1).cpu()
                    firsts[slot] = int(nxt[slot])
            start += k
        tails = [(slot, req) for slot, req in admitted if req.decoded_tail]
        if tails:
            dev_table = self._table()
            for slot, req in tails:
                firsts[slot] = self._prime_by_decode(
                    slot, req, max(int(lengths[slot]), int(begins[slot])),
                    dev_table)
        return [firsts[slot] for slot, _ in admitted]

    def _finish(self, req: Request):
        self.metrics.counter("sched/finished").inc()
        if req.submit_ns >= 0:
            now = time.monotonic_ns()
            self.metrics.histogram("sched/request_ms").observe(
                (now - req.submit_ns) / 1e6)
            if self.tracer is not None:
                self.tracer.add_span(
                    "request", req.submit_ns, now,
                    lane=_lane(req.adapter_id), rid=req.rid,
                    adapter=str(req.adapter_id), tokens=len(req.out))

    def step(self) -> int:
        """One decode micro-step (a speculative round when ``spec.draft >
        0``) for the scheduled adapter group; returns #finished
        requests."""
        builds0 = ops.builds()
        group = self._schedule()
        self._ensure_adapter(group)
        self._admit(group)
        self.metrics.gauge("sched/queue_depth").set(len(self.queue))
        mask = self._mask(group=group)
        if not mask.any():
            self._turn_left = 0  # group drained during admission: rotate
            return 0
        if self.speculate:
            n = self._spec_round_len(group, mask)
            if n >= 1:
                return self._spec_step(group, mask, n, builds0)
        table = None
        if self.alloc is not None:
            # this step's write rows made writable before the dispatch: a
            # fresh page at a page boundary, a COW split at the first
            # write into a shared page
            live = np.flatnonzero(mask)
            self._ensure_rows(live, self.pos, self.pos + 1)
            table = self._table()
        t0_ns = time.monotonic_ns()
        logits = self._decode(self.tokens, self.pos, mask, table)
        nxt = logits.argmax(-1).cpu()    # the host sync point
        t1_ns = time.monotonic_ns()
        self._record_step(group, t0_ns, t1_ns, int(mask.sum()), builds0,
                          fn="decode")
        finished = 0
        self.steps += 1
        self.metrics.counter("decode/steps").inc()
        self.metrics.counter("decode/tokens").inc(int(mask.sum()))
        self._turn_left -= 1
        self._last_served[group] = self.steps
        for slot, req in enumerate(self.active):
            if req is None or not mask[slot]:
                continue
            self._emit(req, slot, int(nxt[slot]))
            self.pos[slot] += 1
            if (len(req.out) >= req.max_new_tokens
                    or self.pos[slot] >= self.max_seq - 1):
                self._retire(req, slot)
                finished += 1
        if not self._group_has_work(group):
            self._turn_left = 0
        return finished

    def _record_step(self, group, t0_ns, t1_ns, batch, builds0, fn):
        """Step time and trace span of one scheduler step.  A lazy kernel
        build during the step (the port's analogue of a jit compile) is
        kept out of the step-time samples and the ms/step EMA."""
        compiled = ops.builds() > builds0
        dt = (t1_ns - t0_ns) / 1e6
        if compiled:
            self.metrics.counter("sched/compiles").inc()
        if self.tracer is not None:
            if fn == "decode":
                self.tracer.add_span("decode_step", t0_ns, t1_ns,
                                     lane=_lane(group), step=self.steps,
                                     batch=batch, compiled=compiled)
            if compiled:
                self.tracer.instant("jit_compile", lane="sched",
                                    fn=fn, step=self.steps)
        if not compiled:
            self.metrics.histogram("decode/step_ms").observe(dt)
        if self._ms_auto and not compiled:
            # EMA over build-free samples only; the first one seeds it
            self._ms_samples += 1
            self.ms_per_step = (dt if self._ms_samples == 1
                                else 0.2 * dt + 0.8 * self.ms_per_step)

    # ------------------------------------------------------------------ #
    # self-speculative decoding
    # ------------------------------------------------------------------ #

    def _spec_round_len(self, group, mask) -> int:
        """Draft length of this round: the group's adaptive length,
        clamped so no active slot writes past its budget (the verify
        chunk writes rows up to ``pos + n``; paged slots reserved exactly
        ``prompt + max_new_tokens`` rows) or its max_seq headroom."""
        n = self._spec_len.get(group, self.speculate)
        for slot in np.flatnonzero(mask):
            req = self.active[slot]
            n = min(n, req.max_new_tokens - len(req.out),
                    self.max_seq - 1 - int(self.pos[slot]))
        return max(0, n)

    def _flip_to_base(self):
        """Drop to the base model for drafting: swap the displaced base
        rows back in (a device scatter-swap; ``_applied`` unchanged).
        Returns the adapter's rows for ``_flip_back``; None when the base
        group is live (drafter == verifier)."""
        if self._displaced is None:
            return None
        disp, self._displaced = self._displaced, None
        self.params, adapter_rows = delta_lib.flip_delta(
            self.params, disp, mode=self.swap_mode)
        return adapter_rows

    def _flip_back(self, adapter_rows):
        if adapter_rows is None:
            return
        self.params, self._displaced = delta_lib.flip_delta(
            self.params, adapter_rows, mode=self.swap_mode)
        self.metrics.counter("spec/flips").inc(2)

    def _spec_step(self, group, mask, n: int, builds0) -> int:
        """One speculative round: the base model drafts ``n`` tokens per
        active slot through the plain decode path, the tenant scores all
        n + 1 positions (overwriting the draft K/V rows with its own),
        and the longest greedy-agreeing prefix is accepted.  Emits 1 to
        n + 1 tokens per slot; returns #finished."""
        tr = self.tracer
        m = self.metrics
        paged = self.alloc is not None
        pos0 = self.pos.copy()
        slots_idx = [int(s) for s in np.flatnonzero(mask)]
        table = None
        if paged:
            # every row of the round (n draft writes + the verify chunk's
            # n + 1 rows) made writable up front; the table then stays
            # the same for the whole round
            self._ensure_rows(slots_idx, pos0, pos0 + n + 1)
            table = self._table()
        t0_ns = time.monotonic_ns()
        # ---- draft: n plain decode steps under the base model --------- #
        saved = self._flip_to_base()
        toks = self.tokens.copy()
        dpos = pos0.copy()
        drafts = np.zeros((n, self.slots), np.int64)
        for i in range(n):
            d0 = time.monotonic_ns()
            logits = self._decode(toks, dpos, mask, table)
            drafts[i] = logits.argmax(-1).cpu().numpy()
            if tr is not None:
                tr.add_span("decode_step", d0, time.monotonic_ns(),
                            lane=_lane(group), step=self.steps,
                            batch=len(slots_idx), draft=True)
            for s in slots_idx:
                toks[s, 0] = drafts[i, s]
            dpos[mask] += 1
        self._flip_back(saved)
        t1_ns = time.monotonic_ns()
        if tr is not None:
            tr.add_span("spec_draft", t0_ns, t1_ns, lane=_lane(group),
                        step=self.steps, n=n, batch=len(slots_idx))
        # ---- verify: n + 1 decode passes under the tenant ------------ #
        vt = np.zeros((self.slots, n + 1), np.int32)
        for s in slots_idx:
            vt[s, 0] = self.tokens[s, 0]   # last emitted token
            vt[s, 1:] = drafts[:, s]
        vlogits, _ = model_lib.verify_into_slots(
            self.params, self.cfg, self.cache_state, self._dev(vt), pos0,
            mask, page_table=self.alloc.table() if paged else None,
            attn_impl=self.attn_impl)
        greedy = vlogits.argmax(-1).cpu().numpy()     # [slots, n + 1]
        t2_ns = time.monotonic_ns()
        if tr is not None:
            tr.add_span("spec_verify", t1_ns, t2_ns, lane=_lane(group),
                        step=self.steps, n=n + 1, batch=len(slots_idx))
        self._record_step(group, t0_ns, t2_ns, len(slots_idx), builds0,
                          fn="spec")
        # ---- accept / emit / roll back -------------------------------- #
        finished = emitted_total = accepted_total = rollbacks = 0
        self.steps += 1
        m.counter("decode/steps").inc()
        self._turn_left -= 1
        self._last_served[group] = self.steps
        for s in slots_idx:
            req = self.active[s]
            a, emit = spec_accept(drafts[:, s], greedy[s])
            accepted_total += a
            if a < n:
                rollbacks += 1
            for t in emit:
                self._emit(req, s, t)
                self.pos[s] += 1
                emitted_total += 1
                if (len(req.out) >= req.max_new_tokens
                        or self.pos[s] >= self.max_seq - 1):
                    break
            if (len(req.out) >= req.max_new_tokens
                    or self.pos[s] >= self.max_seq - 1):
                self._retire(req, s)
                finished += 1
            elif paged:
                # return the pages the rejected suffix no longer needs
                self.alloc.rollback_to(s, int(self.pos[s]))
        self.spec_drafted += n * len(slots_idx)
        self.spec_accepted += accepted_total
        self.spec_emitted += emitted_total
        m.counter("spec/rounds").inc()
        m.counter("spec/passes").inc(2 * n + 1)
        m.counter("spec/drafted").inc(n * len(slots_idx))
        m.counter("spec/accepted").inc(accepted_total)
        m.counter("spec/rollbacks").inc(rollbacks)
        m.counter("decode/tokens").inc(emitted_total)
        # ---- adaptive draft length ------------------------------------ #
        rate = accepted_total / (n * len(slots_idx))
        prev = self._spec_ema.get(group)
        ema = rate if prev is None else 0.5 * rate + 0.5 * prev
        self._spec_ema[group] = ema
        if self.spec_adaptive:
            cur = self._spec_len.get(group, self.speculate)
            if ema < 0.4 and cur > 1:
                cur = max(1, cur // 2)
            elif ema > 0.8 and cur < self.speculate:
                cur += 1
            self._spec_len[group] = cur
            m.gauge("spec/draft_len").set(cur)
        if not self._group_has_work(group):
            self._turn_left = 0
        return finished

    def _progress_key(self):
        return (self.steps, len(self.queue),
                sum(r is not None for r in self.active),
                sum(len(r.out) for r in self.active if r is not None))

    def run_until_drained(self, max_steps=10_000,
                          on_step=None) -> List[Request]:
        """Step until queue and slots are empty.  A step that changes
        nothing raises (a wedged queue), and so does running out of
        ``max_steps`` with work left.  ``on_step(server)`` runs after
        every scheduler step."""
        all_reqs = list(self.queue)
        for _ in range(max_steps):
            before = self._progress_key()
            self.step()
            if on_step is not None:
                on_step(self)
            if not self.queue and all(r is None for r in self.active):
                return all_reqs
            if self._progress_key() == before:
                raise RuntimeError(
                    f"DecodeServer wedged at step {self.steps}: "
                    f"{len(self.queue)} queued / "
                    f"{sum(r is not None for r in self.active)} active "
                    f"requests but a scheduler step made no progress")
        if not self.queue and all(r is None for r in self.active):
            return all_reqs
        undone = [r.rid for r in all_reqs if not r.done]
        raise RuntimeError(
            f"run_until_drained: {len(undone)} request(s) undone after "
            f"max_steps={max_steps} (rids {undone[:8]}...)")

    def stats(self) -> Dict[str, object]:
        """Nested ``prefill`` / ``decode`` / ``sched`` (and ``cache`` /
        ``kv`` / ``spec`` when enabled) sections from the metrics
        registry, stamped ``stats_version`` 2 (the JAX schema)."""
        swap_rate = self.swaps / self.steps if self.steps else 0.0
        self.metrics.gauge("decode/ms_per_step").set(self.ms_per_step)
        self.metrics.gauge("sched/swap_rate").set(swap_rate)
        if self.speculate:
            self.metrics.gauge("spec/acceptance_rate").set(
                self.spec_accepted / self.spec_drafted
                if self.spec_drafted else 0.0)
        nested = self.metrics.nested()
        sched = dict(nested.get("sched", {}))
        sched["applied"] = self._applied
        out: Dict[str, object] = {
            "stats_version": STATS_VERSION,
            "decode": dict(nested.get("decode", {})),
            "prefill": dict(nested.get("prefill", {})),
            "sched": sched,
        }
        if self.speculate:
            spec = dict(nested.get("spec", {}))
            spec["tokens_per_step"] = (self.spec_emitted / spec["rounds"]
                                       if spec.get("rounds") else 0.0)
            out["spec"] = spec
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        if self.alloc is not None:
            kv = dict(nested.get("kv", {}))
            kv["page_size"] = self.alloc.page_size
            kv["num_pages"] = self.alloc.num_pages
            out["kv"] = kv
        return out
