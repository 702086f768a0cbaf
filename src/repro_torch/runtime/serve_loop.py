"""Batched decode serving loop, multi-tenant (counterpart of
``repro.runtime.serve_loop`` for the dense KV layout).

A request queue feeds fixed-size decode batches; finished sequences are
swapped out slot-wise while the rest keep decoding:

- one decode step with **per-slot positions** and an **active-slot
  mask**: the model writes each active slot's new K/V row in place and
  leaves inactive slots' rows bit-exact (the JAX server blends the whole
  cache under the mask inside its jitted step);
- **chunked batched prefill**: a whole admitted group's prompts run
  through ``model.prefill_into_slots`` in prompt chunks (tail chunks
  bucketed to powers of two); ``prefill_chunk=0`` restores per-token
  priming through the decode step.

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

Not ported yet (ROADMAP queue A): the paged KV layout, speculative
decoding and the device AdapterCache — configs asking for them raise
``NotImplementedError``.  There is no jit: the ``sched/compiles``
counter counts the lazy kernel builds (1 on the first kernel use in the
process, 0 after), and the one host sync per step is the argmax of the
logits.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.adapters import delta as delta_lib
from repro_torch.checkpoint.checkpointer import tree_map
from repro_torch.kernels import ops
from repro_torch.models import model as model_lib
from repro_torch.obs import MetricsRegistry
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


def _chunk_bucket(k: int, cap: int) -> int:
    """Round a ragged tail-chunk length up to the next power of two
    (capped at the configured chunk)."""
    b = 1
    while b < k:
        b <<= 1
    return min(b, cap)


class DecodeServer:
    def __init__(self, cfg, params, config: Optional[ServeConfig] = None,
                 *, registry=None, tracer=None, metrics=None, device=None):
        """``params``: a tensor tree (``model.init_params`` layout).
        ``device=None`` means the CUDA device (raises without one);
        pass ``device="cpu"`` to serve on the CPU."""
        config = config if config is not None else ServeConfig()
        if config.kv.layout != "dense":
            raise NotImplementedError(
                "kv layout 'paged' is not ported yet (ROADMAP queue A: "
                "paged KV)")
        if config.spec.draft > 0:
            raise NotImplementedError(
                "speculative decoding is not ported yet (ROADMAP queue A: "
                "spec decode)")
        if config.sched.cache_bytes > 0:
            raise NotImplementedError(
                "the device AdapterCache is not ported yet (ROADMAP queue "
                "A: AdapterCache)")
        model_lib.check_supported(cfg)
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
        self.queue: List[Request] = []
        self.active: List[Optional[Request]] = [None] * self.slots
        self.pos = np.zeros(self.slots, np.int32)   # next write index
        self.cache_state = model_lib.init_cache(cfg, self.slots, self.max_seq,
                                                device=self.device)
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
        for g in ("decode/ms_per_step", "sched/queue_depth",
                  "sched/swap_rate"):
            m.gauge(g)
        for h in ("decode/step_ms", "sched/request_ms",
                  "sched/queue_wait_ms"):
            m.histogram(h)

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _decode(self, tokens, pos, mask):
        return model_lib.decode_step(
            self.params, self.cfg, self.cache_state, self._dev(tokens),
            self._dev(pos), attn_impl=self.attn_impl,
            active=self._dev(mask))[0]

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
        new ones; both are exact row swaps, in place on the device."""
        if adapter_id == self._applied:
            return
        tr = self.tracer
        if self._applied is not BASE:
            t0 = time.monotonic_ns() if tr is not None else 0
            disp, self._displaced = self._displaced, None
            self.params, _ = delta_lib.apply_delta(
                self.params, disp, mode=self.swap_mode, donate=True,
                check_fingerprint=False)
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
            d = self.registry.acquire(adapter_id)
            try:
                self.params, self._displaced = delta_lib.apply_delta(
                    self.params, d, mode=self.swap_mode, donate=True)
            except Exception:
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
        req.done = True
        req.finish_step = self.steps
        self.active[slot] = None
        self._finish(req)

    def _admit(self, group: Optional[str] = BASE):
        """Fill free slots with queued requests of ``group`` (its delta
        is already applied) and prime their prompts together."""
        admitted = []
        for slot in range(self.slots):
            if self.active[slot] is not None:
                continue
            qi = next((i for i, r in enumerate(self.queue)
                       if r.adapter_id == group), None)
            if qi is None:
                break
            req = self.queue.pop(qi)
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
        firsts = (self._prime_chunked(admitted) if self._slot_prefill
                  else self._prime_tokenwise(admitted))
        if tr is not None:
            tr.add_span("admit", admit_t0, time.monotonic_ns(),
                        lane="sched", group=str(group), count=len(admitted))
        for (slot, req), first in zip(admitted, firsts):
            req.first_token_step = self.steps
            self._emit(req, slot, first)
            self.pos[slot] = len(req.prompt)
            self.prefill_prompt_tokens += len(req.prompt)
            self.metrics.counter("prefill/prompt_tokens").inc(
                len(req.prompt))
            if len(req.out) >= req.max_new_tokens:
                self._retire(req, slot)

    def _prime_tokenwise(self, admitted) -> List[int]:
        """Per-token priming: teacher-force each prompt through the
        decode step, one token at a time, one request at a time."""
        tr = self.tracer
        firsts = []
        for slot, req in admitted:
            logits = None
            toks = self.tokens.copy()
            t0 = time.monotonic_ns() if tr is not None else 0
            for t in range(len(req.prompt)):
                toks[slot, 0] = int(req.prompt[t])
                pos = self.pos.copy()
                pos[slot] = t
                logits = self._decode(toks, pos, self._mask(slot))
                self.prefill_dispatches += 1
            self.metrics.counter("prefill/dispatches").inc(len(req.prompt))
            if tr is not None:
                tr.add_span("prefill", t0, time.monotonic_ns(),
                            lane="sched", kind="tokenwise", rid=req.rid,
                            tokens=len(req.prompt))
            # the final prime logits predict the first new token
            firsts.append(int(logits[slot].argmax()))
        return firsts

    def _prime_chunked(self, admitted) -> List[int]:
        """Chunked batched prefill: every admitted prompt runs through
        ``model.prefill_into_slots`` together, ``prefill_chunk`` positions
        per dispatch (tail chunks bucketed to powers of two).  The chunk
        covering each prompt's last token yields its first new token."""
        tr = self.tracer
        lengths = np.zeros(self.slots, np.int32)
        for slot, req in admitted:
            lengths[slot] = len(req.prompt)
        longest = int(lengths.max())
        firsts: Dict[int, int] = {}
        start = 0
        while start < longest:
            k = _chunk_bucket(min(self.prefill_chunk, longest - start),
                              self.prefill_chunk)
            toks = np.zeros((self.slots, k), np.int32)
            for slot, req in admitted:
                hi = min(len(req.prompt), start + k)
                if hi > start:
                    toks[slot, :hi - start] = np.asarray(
                        req.prompt[start:hi], np.int32)
            t0 = time.monotonic_ns() if tr is not None else 0
            logits, _ = model_lib.prefill_into_slots(
                self.params, self.cfg, self.cache_state, self._dev(toks),
                lengths, chunk_start=start, attn_impl=self.attn_impl)
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
        """One decode micro-step for the scheduled adapter group;
        returns #finished requests."""
        builds0 = ops.builds()
        group = self._schedule()
        self._ensure_adapter(group)
        self._admit(group)
        self.metrics.gauge("sched/queue_depth").set(len(self.queue))
        mask = self._mask(group=group)
        if not mask.any():
            self._turn_left = 0  # group drained during admission: rotate
            return 0
        t0_ns = time.monotonic_ns()
        logits = self._decode(self.tokens, self.pos, mask)
        nxt = logits.argmax(-1).cpu()    # the host sync point
        t1_ns = time.monotonic_ns()
        # a lazy kernel build during this step (the port's analogue of a
        # jit compile): keep it out of the step-time samples
        compiled = ops.builds() > builds0
        dt = (t1_ns - t0_ns) / 1e6
        if compiled:
            self.metrics.counter("sched/compiles").inc()
        if self.tracer is not None:
            self.tracer.add_span("decode_step", t0_ns, t1_ns,
                                 lane=_lane(group), step=self.steps,
                                 batch=int(mask.sum()), compiled=compiled)
            if compiled:
                self.tracer.instant("jit_compile", lane="sched",
                                    fn="decode", step=self.steps)
        if not compiled:
            self.metrics.histogram("decode/step_ms").observe(dt)
        if self._ms_auto and not compiled:
            # EMA over build-free samples only; the first one seeds it
            self._ms_samples += 1
            self.ms_per_step = (dt if self._ms_samples == 1
                                else 0.2 * dt + 0.8 * self.ms_per_step)
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
        """Nested ``prefill`` / ``decode`` / ``sched`` sections from the
        metrics registry, stamped ``stats_version`` 2 (the JAX schema)."""
        swap_rate = self.swaps / self.steps if self.steps else 0.0
        self.metrics.gauge("decode/ms_per_step").set(self.ms_per_step)
        self.metrics.gauge("sched/swap_rate").set(swap_rate)
        nested = self.metrics.nested()
        sched = dict(nested.get("sched", {}))
        sched["applied"] = self._applied
        return {
            "stats_version": STATS_VERSION,
            "decode": dict(nested.get("decode", {})),
            "prefill": dict(nested.get("prefill", {})),
            "sched": sched,
        }
